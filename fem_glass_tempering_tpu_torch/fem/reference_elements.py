"""Reference cells: geometry of the unit interval/triangle/quad/tet/hex.

This is the replacement for the cell-topology part of Basix
(reference dependency, SURVEY.md §2b): each cell type carries its reference
vertices, its facets (as local vertex index lists), and an affine embedding
from facet reference coordinates into cell reference coordinates so that
facet quadrature rules can be pulled into the cell for boundary/interface
integrals (reference weak form: ThermoViscoProblem.py:280-326).

All arrays are small numpy constants used at setup time only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ReferenceCell:
    name: str                 # 'interval' | 'triangle' | 'quad' | 'tet' | 'hex'
    tdim: int                 # topological dimension
    vertices: np.ndarray      # (n_vertices, tdim) reference coordinates
    facets: tuple             # tuple of tuples: local vertex indices per facet
    facet_cell: str           # cell type of a facet ('point'|'interval'|'triangle'|'quad')
    simplex: bool

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_facets(self) -> int:
        return len(self.facets)

    def facet_vertex_coords(self, local_facet: int) -> np.ndarray:
        """Reference coordinates of a facet's vertices, shape (nfv, tdim)."""
        return self.vertices[list(self.facets[local_facet])]

    def map_facet_points(self, local_facet: int, fpoints: np.ndarray) -> np.ndarray:
        """Affinely embed facet reference points into cell reference coords.

        fpoints: (nq, tdim-1) points on the reference facet cell
        (for tdim==1 facets are points; fpoints has shape (1, 0)).
        Returns (nq, tdim).
        """
        verts = self.facet_vertex_coords(local_facet).astype(np.float64)
        if self.tdim == 1:
            return verts.reshape(1, 1)
        v0 = verts[0]
        if self.facet_cell == "interval":
            # x(s) = v0 + s*(v1-v0)
            return v0 + fpoints[:, :1] * (verts[1] - v0)
        if self.facet_cell == "triangle":
            return v0 + fpoints[:, :1] * (verts[1] - v0) + fpoints[:, 1:2] * (verts[2] - v0)
        if self.facet_cell == "quad":
            # bilinear embedding of the unit square onto the (planar) face
            s, t = fpoints[:, :1], fpoints[:, 1:2]
            return (
                (1 - s) * (1 - t) * verts[0]
                + s * (1 - t) * verts[1]
                + (1 - s) * t * verts[2]
                + s * t * verts[3]
            )
        raise ValueError(self.facet_cell)


def _interval() -> ReferenceCell:
    return ReferenceCell(
        name="interval",
        tdim=1,
        vertices=np.array([[0.0], [1.0]]),
        facets=((0,), (1,)),
        facet_cell="point",
        simplex=True,
    )


def _triangle() -> ReferenceCell:
    return ReferenceCell(
        name="triangle",
        tdim=2,
        vertices=np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
        facets=((0, 1), (1, 2), (0, 2)),
        facet_cell="interval",
        simplex=True,
    )


def _quad() -> ReferenceCell:
    # vertex ordering: tensor-product (x fastest): (0,0),(1,0),(0,1),(1,1)
    return ReferenceCell(
        name="quad",
        tdim=2,
        vertices=np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
        facets=((0, 1), (2, 3), (0, 2), (1, 3)),
        facet_cell="interval",
        simplex=False,
    )


def _tet() -> ReferenceCell:
    return ReferenceCell(
        name="tet",
        tdim=3,
        vertices=np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        ),
        facets=((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)),
        facet_cell="triangle",
        simplex=True,
    )


def _hex() -> ReferenceCell:
    # tensor-product ordering: index = ix + 2*iy + 4*iz
    verts = np.array(
        [
            [x, y, z]
            for z in (0.0, 1.0)
            for y in (0.0, 1.0)
            for x in (0.0, 1.0)
        ]
    )
    return ReferenceCell(
        name="hex",
        tdim=3,
        vertices=verts,
        facets=(
            (0, 1, 2, 3),  # z=0
            (4, 5, 6, 7),  # z=1
            (0, 1, 4, 5),  # y=0
            (2, 3, 6, 7),  # y=1
            (0, 2, 4, 6),  # x=0
            (1, 3, 5, 7),  # x=1
        ),
        facet_cell="quad",
        simplex=False,
    )


_CELLS = {
    "interval": _interval(),
    "triangle": _triangle(),
    "quad": _quad(),
    "tet": _tet(),
    "hex": _hex(),
}


def get_cell(name: str) -> ReferenceCell:
    try:
        return _CELLS[name]
    except KeyError:
        raise ValueError(f"unknown cell type {name!r}; valid: {sorted(_CELLS)}")
