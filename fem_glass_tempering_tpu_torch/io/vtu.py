"""VTU (VTK XML unstructured grid) output + time-series (.pvd) writer.

Counterpart of fem_glass_tempering_tpu/io/vtu.py, whose files it equals
byte for byte on equal arrays. It replaces the reference's ADIOS2
VTXWriter streams (ThermoViscoProblem.py:246-266): scalar / vector /
tensor fields on the SoA meshes, written as self-contained ParaView files
with base64-encoded binary data. Tensor fields are written directly (the
reference had to fall back to XDMF for sigma,
ThermoViscoProblem.py:269-273).

Fields may arrive as tensors on the GPU: they are copied to the host
here, at the output cadence only.
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np
import torch

_VTK_TYPE = {"interval": 3, "triangle": 5, "quad": 9, "tet": 10, "hex": 12}
# our tensor-product vertex order -> VTK order
_VTK_PERM = {
    "interval": [0, 1],
    "triangle": [0, 1, 2],
    "quad": [0, 1, 3, 2],
    "tet": [0, 1, 2, 3],
    "hex": [0, 1, 3, 2, 4, 5, 7, 6],
}


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def host_array(values) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _point_values(fs, dofs) -> np.ndarray:
    """Map a dof array of `fs` to per-mesh-node values for visualization.

    CG-1: identity. Other spaces: average the incident cells' values at
    each cell vertex (vertex lattice points are the first nloc entries in
    vertex order for any degree)."""
    mesh = fs.mesh
    vals = host_array(dofs)
    comp_shape = vals.shape[1:]
    if fs.family == "CG" and fs.degree == 1:
        return vals
    nv = mesh.ref_cell.n_vertices
    # cell vertex dofs: first nv local points are the cell vertices
    cell_vert_dofs = fs.dofmap[:, :nv]                    # (c, nv)
    cell_vert_vals = vals[cell_vert_dofs]                 # (c, nv, *comp)
    acc = np.zeros((mesh.n_nodes,) + comp_shape)
    cnt = np.zeros(mesh.n_nodes)
    np.add.at(acc, mesh.cells.ravel(),
              cell_vert_vals.reshape(-1, *comp_shape))
    np.add.at(cnt, mesh.cells.ravel(), 1.0)
    return acc / cnt.reshape(-1, *([1] * len(comp_shape)))


def write_vtu(path: str, mesh, fields: dict | None = None) -> None:
    """Write mesh + named point-data fields. fields: name -> (fs, dofs) or
    name -> per-node values; dofs and values are arrays or tensors."""
    fields = fields or {}
    n_pts = mesh.n_nodes
    n_cells = mesh.n_cells
    pts3 = np.zeros((n_pts, 3))
    pts3[:, : mesh.gdim] = mesh.nodes
    perm = _VTK_PERM[mesh.cell_type]
    conn = mesh.cells[:, perm].astype(np.int64)
    nv = conn.shape[1]
    offsets = np.arange(1, n_cells + 1, dtype=np.int64) * nv
    types = np.full(n_cells, _VTK_TYPE[mesh.cell_type], dtype=np.uint8)

    pieces = []
    pieces.append('<?xml version="1.0"?>')
    pieces.append('<VTKFile type="UnstructuredGrid" version="0.1" '
                  'byte_order="LittleEndian">')
    pieces.append("<UnstructuredGrid>")
    pieces.append(f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">')
    pieces.append("<Points>")
    pieces.append('<DataArray type="Float64" NumberOfComponents="3" '
                  f'format="binary">{_b64(pts3)}</DataArray>')
    pieces.append("</Points>")
    pieces.append("<Cells>")
    pieces.append('<DataArray type="Int64" Name="connectivity" '
                  f'format="binary">{_b64(conn)}</DataArray>')
    pieces.append('<DataArray type="Int64" Name="offsets" '
                  f'format="binary">{_b64(offsets)}</DataArray>')
    pieces.append('<DataArray type="UInt8" Name="types" '
                  f'format="binary">{_b64(types)}</DataArray>')
    pieces.append("</Cells>")
    pieces.append("<PointData>")
    for name, val in fields.items():
        if isinstance(val, tuple):
            fs, dofs = val
            pv = _point_values(fs, dofs)
        else:
            pv = host_array(val)
        ncomp = int(np.prod(pv.shape[1:])) if pv.ndim > 1 else 1
        flat = np.ascontiguousarray(pv.reshape(n_pts, ncomp).astype(np.float64))
        pieces.append(f'<DataArray type="Float64" Name="{name}" '
                      f'NumberOfComponents="{ncomp}" format="binary">'
                      f"{_b64(flat)}</DataArray>")
    pieces.append("</PointData>")
    pieces.append("</Piece></UnstructuredGrid></VTKFile>")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(pieces))


class VTUSeriesWriter:
    """Time series of VTU files + a ParaView .pvd index."""

    def __init__(self, directory: str, name: str, mesh):
        self.dir = directory
        self.name = name
        self.mesh = mesh
        self.entries: list[tuple[float, str]] = []
        os.makedirs(directory, exist_ok=True)

    def write(self, t: float, fields: dict) -> None:
        fname = f"{self.name}_{len(self.entries):05d}.vtu"
        write_vtu(os.path.join(self.dir, fname), self.mesh, fields)
        self.entries.append((t, fname))
        self._write_pvd()

    def _write_pvd(self) -> None:
        lines = ['<?xml version="1.0"?>',
                 '<VTKFile type="Collection" version="0.1">', "<Collection>"]
        for t, fname in self.entries:
            lines.append(f'<DataSet timestep="{t}" file="{fname}"/>')
        lines += ["</Collection>", "</VTKFile>"]
        with open(os.path.join(self.dir, f"{self.name}.pvd"), "w") as f:
            f.write("\n".join(lines))

    def close(self) -> None:
        self._write_pvd()
