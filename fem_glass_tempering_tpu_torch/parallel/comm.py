"""The collectives of the port's distributed strategies.

In the JAX package the collectives of cell-axis sharding are the ones XLA
inserts around sharded arrays (parallel/sharding.py), and those of the CG
domain decomposition are the explicit `psum` / `all_gather` of a
`shard_map` body (parallel/domain_cg.py). Here every rank is one process of
a torch.distributed group, and every collective is a sum over the ranks:

- `all_reduce_sum` is an autograd Function with a forward-mode rule. The
  Newton loop takes its Jacobian action as `torch.func.jvp` of a residual
  that holds the reduction; a plain `dist.all_reduce` there raises nothing
  and leaves each rank's own tangent in place of the reduced one.
- `all_gather` places each rank's rows in its own block of a buffer of
  -0.0 and sums it: every slot has one contributor, and -0.0 is the
  identity of the sum (x + -0.0 == x bit for bit, signed zeros included),
  so the result equals an all-gather exactly. `gather_rows` does the same
  for rows scattered over a global vector.
- `halo_exchange` gives each rank of a grid split along axis 0 its
  neighbours' adjacent planes through that all-gather.
- `Repartition` moves windows of a tensor split along axis 0 from one
  split to another (the DG-1 cell grid's and the CG-1 node grid's of
  the grid-sharded step), through one such all-gather of the rows that
  other ranks need.
- `all_reduce_max` is the one collective that is not a sum (a bound taken
  over the ranks); a max is exact in any order.

`all_reduce_sum.count` and `all_reduce_max.count` count the collectives
a process has made (a halo exchange or an all-gather is one sum).

The backend follows the device (NCCL for CUDA, gloo for the CPU) unless
the caller names one: two ranks can share one GPU over gloo, which NCCL
refuses. A backend that fails to start raises.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class DeviceMesh:
    """This process's place among the ranks: its rank, the world size, the
    device it computes on (several ranks may share one) and the process
    group of the collectives."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    owns_group: bool = False         # started the group: close() ends it
    store_dir: str | None = None     # a one-rank group's file store

    def close(self) -> None:
        """End the process group if this mesh started it (and remove a
        one-rank group's store)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_device_mesh(device=None, *, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> DeviceMesh:
    """The device mesh of this process (JAX's `make_device_mesh`). Starts
    the default process group unless one is running: from `init_method`,
    `rank` and `world_size` where given; else from torchrun's environment
    (RANK and WORLD_SIZE set); else as a group of one rank, through a file
    store in a new temporary directory (never a fixed port, so that
    concurrent processes cannot collide). `device` None is the GPU."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    store_dir = None
    owns_group = not dist.is_initialized()
    if owns_group:
        if init_method is None:
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                init_method = "env://"
            else:
                store_dir = tempfile.mkdtemp(prefix="fgt_group_")
                init_method = "file://" + os.path.join(store_dir, "store")
                rank, world_size = 0, 1
        if device.type == "cuda":
            torch.cuda.set_device(device)
        where = {} if rank is None else dict(rank=rank,
                                             world_size=world_size)
        dist.init_process_group(backend, init_method=init_method, **where)
    elif dist.get_backend() != backend:
        raise ValueError(f"the running process group uses "
                         f"{dist.get_backend()!r}, not {backend!r}")
    return DeviceMesh(rank=dist.get_rank(), size=dist.get_world_size(),
                      device=device, backend=dist.get_backend(),
                      group=dist.group.WORLD, owns_group=owns_group,
                      store_dir=store_dir)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, linear: its tangent is the sum of the
    tangents."""

    @staticmethod
    def forward(x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _group_t):
        t = x_t.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
        return t


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank; differentiable in
    forward mode (torch.func.jvp)."""
    all_reduce_sum.count += 1
    return _AllReduceSum.apply(x, mesh.group)


all_reduce_sum.count = 0


def all_reduce_max(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The elementwise max of `x` over the ranks, on every rank (exact: a
    max does not depend on the order it is taken in)."""
    all_reduce_max.count += 1
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group)
    return y


all_reduce_max.count = 0


def all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(n, ...) on every rank -> (P * n, ...), rank r's rows in block r:
    JAX's `all_gather(x).reshape(-1, ...)`, bit for bit (module
    docstring). Every rank must pass the same n."""
    n = x.shape[0]
    pad = [0, 0] * (x.dim() - 1) + [mesh.rank * n,
                                    (mesh.size - 1 - mesh.rank) * n]
    return all_reduce_sum(F.pad(x, pad, value=-0.0), mesh)


def gather_rows(values: torch.Tensor, rows: torch.Tensor, n: int,
                mesh: DeviceMesh) -> torch.Tensor:
    """The (n, ...) global array whose `rows` hold this rank's `values`,
    on every rank. Each row must have exactly one contributing rank (rows
    no rank holds are -0.0)."""
    out = torch.full((n,) + tuple(values.shape[1:]), -0.0,
                     dtype=values.dtype, device=values.device)
    out[rows] = values
    return all_reduce_sum(out, mesh)


def halo_exchange(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """x (L, ...), this rank's planes of a tensor split along axis 0 in
    rank order -> (L + 2, ...): x between the last plane of rank - 1 and
    the first plane of rank + 1, zeros where there is no such rank. One
    summed all-gather of every rank's first and last plane (exact, as
    `all_gather`), counted in `halo_exchange.count`; none at world size 1.
    Every rank must call it, each with at least one plane and the same
    trailing shape."""
    zero = torch.zeros_like(x[:1])
    if mesh.size == 1:
        return torch.cat([zero, x, zero])
    ends = all_gather(torch.stack([x[0], x[-1]]), mesh)   # rank r: 2r, 2r+1
    p = mesh.rank
    lower = ends[2 * p - 1:2 * p] if p > 0 else zero
    upper = ends[2 * p + 2:2 * p + 3] if p < mesh.size - 1 else zero
    halo_exchange.count += 1
    return torch.cat([lower, x, upper])


halo_exchange.count = 0


class Repartition:
    """Rows of a tensor split along axis 0 in one layout -> windows of it
    in another: rank p holds global rows `src_rows[p]` = [a, b) (every
    rank's, in rank order, contiguous) and receives rows `windows[p]` =
    [c, d) (empty where c >= d), on every rank. Each rank contributes the
    hull of the rows that the other ranks need from it to one summed
    all-gather of those slots (exact, as `all_gather`); none where no rank
    needs another's rows, or at world size 1. Counted in
    `Repartition.count`. Every rank must apply it together, with the same
    plan."""

    count = 0

    def __init__(self, src_rows, windows, mesh: DeviceMesh):
        self.src_rows = [tuple(r) for r in src_rows]
        self.windows = [tuple(w) for w in windows]
        self.mesh = mesh
        # (source rank, first row, last row + 1, offset in the buffer)
        self.slots, off = [], 0
        for q, (a, b) in enumerate(self.src_rows):
            need = [(max(a, c), min(b, d))
                    for p, (c, d) in enumerate(self.windows)
                    if p != q and max(a, c) < min(b, d)]
            if need:
                lo = min(x for x, _ in need)
                hi = max(y for _, y in need)
                self.slots.append((q, lo, hi, off))
                off += hi - lo
        self.total = off

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: this rank's rows (b - a, ...) -> its window (d - c, ...)."""
        r = self.mesh.rank
        a, _ = self.src_rows[r]
        c, d = self.windows[r]
        buf = None
        if self.total:
            Repartition.count += 1
            buf = torch.full((self.total,) + tuple(x.shape[1:]), -0.0,
                             dtype=x.dtype, device=x.device)
            for q, lo, hi, off in self.slots:
                if q == r:
                    buf[off:off + hi - lo] = x[lo - a:hi - a]
            buf = all_reduce_sum(buf, self.mesh)
        parts = []
        for q, (qa, qb) in enumerate(self.src_rows):
            lo, hi = max(qa, c), min(qb, d)
            if lo >= hi:
                continue
            if q == r:
                parts.append(x[lo - a:hi - a])
                continue
            s = next(s for s in self.slots if s[0] == q)
            parts.append(buf[s[3] + lo - s[1]:s[3] + hi - s[1]])
        if not parts:
            return x[:0]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _rank_main(fn, rank, world_size, init_method, device, backend, threads,
               results, args):
    if threads is not None:
        torch.set_num_threads(threads)
    mesh = None
    try:
        mesh = make_device_mesh(device, backend=backend,
                                init_method=init_method, rank=rank,
                                world_size=world_size)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def run_ranks(fn, world_size: int, device, *args, backend: str | None = None,
              threads: int | None = None, timeout: float = 600.0) -> list:
    """fn(mesh, *args) in `world_size` new processes (the spawn start
    method), one rank each, all on `device`, grouped through a file store
    in a new temporary directory; returns the ranks' results in rank order.
    `fn` must be importable by name and return picklable data (numpy, not
    tensors). Raises, with the rank's traceback, as soon as a rank fails;
    raises TimeoutError after `timeout` seconds. Every process is gone when
    it returns or raises."""
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="fgt_ranks_")
    init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, str(device),
                               backend, threads, results, args))
             for r in range(world_size)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size - len(out)} of "
                                   f"{world_size} ranks still running "
                                   f"after {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and "
                                       f"no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]
