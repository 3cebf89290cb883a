"""Per-rank streaming output and checkpoints of a grid-sharded state.

Counterpart of fem_glass_tempering_tpu/io/sharded.py, and the same files:
each snapshot writes one .npz piece per rank and field holding only that
rank's slab (one device-to-host copy of its rows, no collective), plus a
JSON index; a checkpoint writes one piece per rank and field plus
meta.json. A piece is named `piece_{field}_{step:06d}_o{offset:06d}.npz`
and holds `data`, `offset` (and `t` in a series); its `data` is
grid-shaped, (L,) + grid[1:] + the field's own axes, and `offset` counts
planes of the padded grid, so either package reads what the other wrote.

The ranks hold flat rows (parallel/grid_shard.py): rank r of P holds
planes [r L, (r + 1) L) of the padded grid, L = G0 / P, as the C-order
rows of those planes (`PlaneLayout`). The writer reshapes a rank's rows
into its planes; the loader reads only the pieces that cover the rank's
planes and never builds a global array.

`read_sharded_series` reassembles a series (analysis, tests): pieces
concatenated along axis 0, the ghost planes trimmed, reshaped to the flat
dof-vector layout.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device, resolve_dtype
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState


def _piece_name(field: str, step: int, off: int) -> str:
    return f"piece_{field}_{step:06d}_o{off:06d}.npz"


def _piece_offset(name: str) -> int:
    return int(name[name.rindex("_o") + 2:-len(".npz")])


@dataclass(frozen=True)
class PlaneLayout:
    """This rank's share of grid-shaped fields split along axis 0: each
    field's padded grid in `world_size` equal slabs of planes, rank `rank`
    holding slab `rank` as flat rows (the C-order dofs of its planes, a
    row each, the field's own axes after). Node-grid fields live on
    `grid`, `cell_fields` on `cell_grid`, which for DG carries a trailing
    local-dof axis (`cell_local_axis`) and for a Q2 lattice does not.
    With `grid` None a field's rows are written as they are."""

    grid: tuple | None
    rank: int = 0
    world_size: int = 1
    cell_grid: tuple | None = None
    cell_fields: frozenset = frozenset()
    cell_local_axis: bool = True

    def field_grid(self, name: str) -> tuple[tuple | None, int]:
        """The padded grid of field `name`, and how many leading axes of
        its grid-shaped array that grid spans (a local-dof axis counts)."""
        if name in self.cell_fields and self.cell_grid is not None:
            return self.cell_grid, len(self.cell_grid) + self.cell_local_axis
        if self.grid is None:
            return None, 0
        return self.grid, len(self.grid)

    def planes(self, name: str, rows: int | None = None) -> tuple[int, int]:
        """This rank's planes [lo, hi) of field `name` (with no grid: its
        rows, `rows` a rank)."""
        g, _ = self.field_grid(name)
        if g is None:
            return self.rank * rows, (self.rank + 1) * rows
        if g[0] % self.world_size:
            raise ValueError(f"{name}: {g[0]} planes do not split into "
                             f"{self.world_size} equal slabs")
        L = g[0] // self.world_size
        return self.rank * L, (self.rank + 1) * L

    def to_planes(self, name: str, rows: torch.Tensor) -> np.ndarray:
        """This rank's rows of `name` -> its planes on the host, (L,) +
        grid[1:] (+ the local-dof axis) + the field's axes: one
        device-to-host copy."""
        a = rows.detach().cpu().numpy()
        g, _ = self.field_grid(name)
        if g is None:
            return a
        lo, hi = self.planes(name)
        loc = (-1,) if (name in self.cell_fields
                        and self.cell_local_axis) else ()
        return a.reshape((hi - lo,) + tuple(g[1:]) + loc + a.shape[1:])

    def to_rows(self, name: str, planes: np.ndarray) -> np.ndarray:
        """The inverse of `to_planes` (on the host)."""
        _, n = self.field_grid(name)
        if not n:
            return planes
        return planes.reshape((-1,) + planes.shape[n:])


class ShardedSeriesWriter:
    """Streaming per-rank snapshot writer (JAX's arguments; `rank` and
    `world_size` place this rank's rows). `grid` and `cell_grid` are the
    padded grids, `pad0` / `cell_pad0` their ghost planes, which the
    reader trims."""

    def __init__(self, out_dir: str, fields: tuple = ("T", "Tf", "sigma"),
                 grid: tuple | None = None, pad0: int = 0,
                 cell_grid: tuple | None = None, cell_pad0: int = 0,
                 cell_fields: tuple = (), cell_local_axis: bool = True, *,
                 rank: int = 0, world_size: int = 1):
        self.dir = out_dir
        self.fields = tuple(fields)
        self.grid = tuple(grid) if grid is not None else None
        self.pad0 = int(pad0)
        self.cell_grid = tuple(cell_grid) if cell_grid is not None else None
        self.cell_pad0 = int(cell_pad0)
        self.cell_fields = tuple(cell_fields)
        self.cell_local_axis = bool(cell_local_axis)
        self.layout = PlaneLayout(self.grid, rank, world_size,
                                  self.cell_grid, frozenset(cell_fields),
                                  self.cell_local_axis)
        self.times: list[float] = []
        os.makedirs(out_dir, exist_ok=True)

    def write(self, t: float, state: ViscoState) -> None:
        k = len(self.times)
        self.times.append(float(t))
        for f in self.fields:
            data = self.layout.to_planes(f, getattr(state, f))
            off, _ = self.layout.planes(f, data.shape[0])
            np.savez(os.path.join(self.dir, _piece_name(f, k, off)),
                     data=data, offset=off, t=float(t))

    def close(self) -> None:
        idx = {"fields": list(self.fields), "times": self.times,
               "n_steps": len(self.times), "grid": self.grid,
               "pad0": self.pad0,
               "cell_grid": self.cell_grid,
               "cell_pad0": self.cell_pad0,
               "cell_fields": list(self.cell_fields),
               "cell_local_axis": self.cell_local_axis,
               "process_count": self.layout.world_size}
        # one index a rank; rank 0's is authoritative for times
        rank = self.layout.rank
        name = "index.json" if rank == 0 else f"index_p{rank}.json"
        with open(os.path.join(self.dir, name), "w") as fh:
            json.dump(idx, fh)


def read_sharded_series(out_dir: str, flat: bool = True) -> dict:
    """Reassemble a sharded series directory -> {'times': (k,),
    '<field>': (k, n, ...)} (numpy): pieces concatenated along grid axis
    0, the ghost planes trimmed, and (with flat=True) reshaped to the flat
    dof-vector layout of the single-device writers."""
    with open(os.path.join(out_dir, "index.json")) as fh:
        idx = json.load(fh)
    grid = tuple(idx["grid"]) if idx["grid"] else None
    cell_grid = tuple(idx["cell_grid"]) if idx.get("cell_grid") else None
    cell_fields = set(idx.get("cell_fields", ()))
    loc = 1 if idx.get("cell_local_axis", True) else 0
    names = sorted(os.listdir(out_dir))
    out = {"times": np.asarray(idx["times"])}
    for f in idx["fields"]:
        is_cell = f in cell_fields
        f_grid = cell_grid if is_cell else grid
        f_pad = idx.get("cell_pad0", 0) if is_cell else idx["pad0"]
        f_glen = None
        if f_grid is not None:
            f_glen = len(f_grid) + (loc if is_cell else 0)
        steps = []
        for k in range(idx["n_steps"]):
            pieces = []
            for n in names:
                if n.startswith(f"piece_{f}_{k:06d}_"):
                    with np.load(os.path.join(out_dir, n)) as z:
                        pieces.append(z["data"])
            g = np.concatenate(pieces, axis=0)
            if f_pad:
                g = g[:-f_pad]
            if flat and f_glen is not None:
                g = g.reshape((-1,) + g.shape[f_glen:])
            steps.append(g)
        out[f] = np.stack(steps)
    return out


# ---------------------------------------------------------------------
def save_sharded_checkpoint(out_dir: str, state: ViscoState,
                            layout: PlaneLayout,
                            extra: dict | None = None) -> None:
    """This rank's piece of every field; rank 0 also writes the 0-d `t`
    and meta.json (`shapes`: the padded global shapes). No collective:
    a caller that reads it back on other ranks syncs first."""
    os.makedirs(out_dir, exist_ok=True)
    shapes = {}
    for f in ViscoState._fields:
        arr = getattr(state, f)
        if arr is None:
            continue
        if f == "t":
            shapes[f] = []
            if layout.rank == 0:
                np.savez(os.path.join(out_dir, _piece_name(f, 0, 0)),
                         data=arr.detach().cpu().numpy(), offset=0)
            continue
        data = layout.to_planes(f, arr)
        off, _ = layout.planes(f, data.shape[0])
        shapes[f] = [data.shape[0] * layout.world_size] + list(data.shape[1:])
        np.savez(os.path.join(out_dir, _piece_name(f, 0, off)),
                 data=data, offset=off)
    if layout.rank == 0:
        meta = {"fields": list(shapes), "shapes": shapes,
                "extra": extra or {}}
        with open(os.path.join(out_dir, "meta.json"), "w") as fh:
            json.dump(meta, fh)


def load_sharded_checkpoint(out_dir: str, layout: PlaneLayout, device=None,
                            dtype=None) -> tuple[ViscoState, dict]:
    """This rank's rows of a sharded checkpoint (either package's) ->
    (state on `device` (None = the GPU), cast to `dtype` if given, meta).
    Reads only the pieces that cover the rank's planes. Raises ValueError
    where the checkpoint's padded grid is not the layout's: it loads only
    onto a rank count that pads the grid to as many planes."""
    dev = resolve_device(device)
    dt = None if dtype is None else resolve_dtype(dtype)
    with open(os.path.join(out_dir, "meta.json")) as fh:
        meta = json.load(fh)
    names = os.listdir(out_dir)
    fields = {}
    for f, shape in meta["shapes"].items():
        shape = tuple(shape)
        pieces = sorted((_piece_offset(n), n) for n in names
                        if n.startswith(f"piece_{f}_000000_"))
        if not shape:
            with np.load(os.path.join(out_dir, _piece_name(f, 0, 0))) as z:
                fields[f] = torch.as_tensor(z["data"], dtype=dt, device=dev)
            continue
        g, n = layout.field_grid(f)
        if g is not None and tuple(shape[:len(g)]) != tuple(g):
            raise ValueError(
                f"checkpoint {out_dir}: {f} was saved on the padded grid "
                f"{shape[:len(g)]}, this layout's is {tuple(g)}: load it "
                f"on a rank count that pads the grid alike")
        lo, hi = layout.planes(f, shape[0] // layout.world_size)
        ends = [off for off, _ in pieces[1:]] + [shape[0]]
        parts = []
        for (off, name), end in zip(pieces, ends):
            if end <= lo or off >= hi:
                continue
            with np.load(os.path.join(out_dir, name)) as z:
                parts.append(z["data"][max(lo - off, 0):hi - off])
        if sum(p.shape[0] for p in parts) != hi - lo:
            raise ValueError(f"checkpoint {out_dir}: the pieces of {f} do "
                             f"not cover planes [{lo}, {hi})")
        planes = parts[0] if len(parts) == 1 else np.concatenate(parts)
        fields[f] = torch.as_tensor(layout.to_rows(f, planes), dtype=dt,
                                    device=dev)
    return ViscoState(**fields), meta
