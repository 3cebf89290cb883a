"""XDMF + HDF5 time-series writer.

Counterpart of fem_glass_tempering_tpu/io/xdmf.py, whose files and
datasets it equals on equal arrays: the reference's tensor-stress output
(XDMFFile, ThermoViscoProblem.py:269-273), heavy data in one HDF5 file and
a light XML index into it, readable by ParaView. It needs h5py: without it
the module imports and the writer raises.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import h5py
    _HAS_H5 = True
except ImportError:
    _HAS_H5 = False

from fem_glass_tempering_tpu_torch.io.vtu import _point_values

_XDMF_TOPO = {
    "interval": "Polyline", "triangle": "Triangle", "quad": "Quadrilateral",
    "tet": "Tetrahedron", "hex": "Hexahedron",
}
# our tensor-product order -> XDMF (VTK-like) order
_XDMF_PERM = {
    "interval": [0, 1], "triangle": [0, 1, 2], "quad": [0, 1, 3, 2],
    "tet": [0, 1, 2, 3], "hex": [0, 1, 3, 2, 4, 5, 7, 6],
}


class XDMFWriter:
    def __init__(self, path: str, mesh):
        if not _HAS_H5:
            raise RuntimeError("XDMFWriter requires h5py; use VTUSeriesWriter")
        self.path = path
        self.h5_path = os.path.splitext(path)[0] + ".h5"
        self.mesh = mesh
        self.steps: list[tuple[float, dict]] = []
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.h5 = h5py.File(self.h5_path, "w")
        pts = np.zeros((mesh.n_nodes, 3))
        pts[:, : mesh.gdim] = mesh.nodes
        self.h5.create_dataset("mesh/geometry", data=pts)
        self.h5.create_dataset(
            "mesh/topology",
            data=mesh.cells[:, _XDMF_PERM[mesh.cell_type]].astype(np.int64))

    def write_function(self, name: str, fs, dofs, t: float) -> None:
        """Append `dofs` (an array or a tensor on any device) of space
        `fs` at time t."""
        pv = _point_values(fs, dofs)
        key = f"fields/{name}/{len(self.steps)}"
        self.h5.create_dataset(key, data=pv.reshape(self.mesh.n_nodes, -1))
        self.steps.append((t, {name: key}))
        self._write_xml()

    def _write_xml(self) -> None:
        m = self.mesh
        h5name = os.path.basename(self.h5_path)
        topo = _XDMF_TOPO[m.cell_type]
        nv = m.cells.shape[1]
        lines = ['<?xml version="1.0"?>', '<Xdmf Version="3.0">', "<Domain>",
                 '<Grid Name="series" GridType="Collection" '
                 'CollectionType="Temporal">']
        for i, (t, fields) in enumerate(self.steps):
            lines.append(f'<Grid Name="step{i}"><Time Value="{t}"/>')
            lines.append(
                f'<Topology TopologyType="{topo}" '
                f'NumberOfElements="{m.n_cells}" NodesPerElement="{nv}">')
            lines.append(
                f'<DataItem Dimensions="{m.n_cells} {nv}" Format="HDF">'
                f"{h5name}:/mesh/topology</DataItem></Topology>")
            lines.append('<Geometry GeometryType="XYZ">')
            lines.append(
                f'<DataItem Dimensions="{m.n_nodes} 3" Format="HDF">'
                f"{h5name}:/mesh/geometry</DataItem></Geometry>")
            for name, key in fields.items():
                ds = self.h5[key]
                ncomp = ds.shape[1]
                atype = {1: "Scalar", 3: "Vector", 9: "Tensor"}.get(ncomp, "Matrix")
                lines.append(
                    f'<Attribute Name="{name}" AttributeType="{atype}" '
                    'Center="Node">')
                lines.append(
                    f'<DataItem Dimensions="{ds.shape[0]} {ncomp}" '
                    f'Format="HDF">{h5name}:/{key}</DataItem></Attribute>')
            lines.append("</Grid>")
        lines += ["</Grid>", "</Domain>", "</Xdmf>"]
        with open(self.path, "w") as f:
            f.write("\n".join(lines))

    def close(self) -> None:
        self._write_xml()
        self.h5.close()
