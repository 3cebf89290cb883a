"""Scatter-adds over a fixed index that give the same bits on every run.

`index_add` with an index that repeats a target is an atomic add on the
card: the order in which a target's addends arrive changes from run to
run, and so do the last bits of its sum. Here the entries are split once,
on the host, into groups of distinct targets (group k holds the k-th entry
of every target, in entry order); adding one group at a time is a
scatter-add without repeated indices. Every target receives its addends
in entry order, as the sequential `index_add` of the CPU does, so the CPU
bits do not move and the card repeats its own.

An index without repeats is a single group: one `index_add`, as before.
"""

from __future__ import annotations

import numpy as np
import torch


def occurrence_groups(cells: np.ndarray) -> list:
    """Split the entries of `cells` into groups of distinct cells: group k
    holds the k-th entry of every cell, in entry order."""
    cells = np.asarray(cells).reshape(-1)
    if cells.size == 0:
        return []
    order = np.argsort(cells, kind="stable")
    sc = cells[order]
    start = np.r_[0, np.flatnonzero(np.diff(sc)) + 1]
    counts = np.diff(np.r_[start, len(sc)])
    rank = np.empty(len(sc), dtype=np.int64)
    rank[order] = np.arange(len(sc)) - np.repeat(start, counts)
    return [np.flatnonzero(rank == k) for k in range(int(rank.max()) + 1)]


class GroupedScatter:
    """out[index[i]] += src[i] for the fixed flat `index` into `n` targets,
    one group of distinct targets at a time (module docstring). The
    sources are permuted once so that each group is a contiguous slice."""

    def __init__(self, index: np.ndarray, n: int, device=None):
        index = np.asarray(index, dtype=np.int64).reshape(-1)
        self.n = int(n)
        groups = occurrence_groups(index)
        i64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        dtype=torch.int64, device=device)
        self.n_groups = len(groups)
        if len(groups) <= 1:
            self.perm = None
            self.targets = [i64(index)] if index.size else []
            self.bounds = [(0, index.size)] if index.size else []
        else:
            self.perm = i64(np.concatenate(groups))
            self.targets = [i64(index[g]) for g in groups]
            ends = np.cumsum([len(g) for g in groups])
            self.bounds = list(zip(np.r_[0, ends[:-1]].tolist(),
                                   ends.tolist()))

    def add_(self, out: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """Add the rows of `src` (leading axis: the index's entries, any
        trailing shape of `out`) into `out` in place; returns `out`."""
        src = src.reshape((-1,) + tuple(out.shape[1:]))
        if self.perm is not None:
            src = src.index_select(0, self.perm)
        for (a, b), t in zip(self.bounds, self.targets):
            out.index_add_(0, t, src[a:b])
        return out

    def __call__(self, src: torch.Tensor, trailing: tuple = ()) -> torch.Tensor:
        """The (n, *trailing) sums of the rows of `src`, from zero."""
        out = torch.zeros((self.n,) + tuple(trailing), dtype=src.dtype,
                          device=src.device)
        return self.add_(out, src)
