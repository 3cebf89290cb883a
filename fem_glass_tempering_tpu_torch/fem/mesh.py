"""Structure-of-arrays meshes: builders and facet connectivity (numpy).

Meshes are plain numpy arrays at setup time; the operators copy what they
need onto the device as torch tensors. Connectivity (boundary / interior
facets) is derived once, fully vectorised: the facet enumeration of a
1M-cell plate is 6M (cell, local facet) pairs, which a per-pair Python
loop takes minutes over.

Builders:
  - interval_mesh / graded_interval_mesh / reference_glass_mesh_1d: the
    reference's 1D graded glass slab (reference geometry.py:7-14).
  - box_mesh_2d / box_mesh_3d: structured quad/triangle and hex/tet plates.

The gmsh reader waits for a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from fem_glass_tempering_tpu_torch.fem.reference_elements import (
    ReferenceCell,
    get_cell,
)


@dataclass
class Mesh:
    cell_type: str
    nodes: np.ndarray   # (n_nodes, gdim) float64
    cells: np.ndarray   # (n_cells, n_cell_vertices) int32
    # derived connectivity (filled by _build_facets)
    boundary_cell: np.ndarray = field(default=None)        # (n_bf,) cell index
    boundary_local_facet: np.ndarray = field(default=None)  # (n_bf,)
    interior_cell_p: np.ndarray = field(default=None)       # (n_if,) '+' cell (lower index)
    interior_local_facet_p: np.ndarray = field(default=None)
    interior_cell_m: np.ndarray = field(default=None)       # (n_if,) '-' cell
    interior_local_facet_m: np.ndarray = field(default=None)
    # structured-grid metadata (set by the box/interval builders): enables
    # geometric-multigrid coarsening. {'dims': (...), 'lengths': (...),
    # 'origin': (...)} or None for unstructured meshes.
    structured: dict = field(default=None, compare=False)
    # gmsh physical groups: per-boundary-facet tags aligned with the facet
    # enumeration above, and group name -> (dim, tag)
    boundary_facet_tags: np.ndarray = field(default=None, compare=False)
    physical_names: dict = field(default=None, compare=False)

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=np.float64)
        if self.nodes.ndim == 1:
            self.nodes = self.nodes[:, None]
        self.cells = np.asarray(self.cells, dtype=np.int32)
        if self.boundary_cell is None:
            self._build_facets()

    # ------------------------------------------------------------------
    @property
    def ref_cell(self) -> ReferenceCell:
        return get_cell(self.cell_type)

    @property
    def tdim(self) -> int:
        return self.ref_cell.tdim

    @property
    def gdim(self) -> int:
        return self.nodes.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_boundary_facets(self) -> int:
        return len(self.boundary_cell)

    @property
    def n_interior_facets(self) -> int:
        return len(self.interior_cell_p)

    def cell_vertex_coords(self) -> np.ndarray:
        """(n_cells, n_vertices, gdim)"""
        return self.nodes[self.cells]

    def boundary_facets_with_tag(self, tag) -> np.ndarray:
        """Bool mask (n_boundary_facets,) of the boundary facets in the
        physical group `tag` (int or group name)."""
        if self.boundary_facet_tags is None:
            raise ValueError("mesh carries no facet tags")
        if isinstance(tag, str):
            if not self.physical_names or tag not in self.physical_names:
                raise KeyError(f"no physical group named {tag!r}")
            tag = self.physical_names[tag][1]
        return self.boundary_facet_tags == int(tag)

    # ------------------------------------------------------------------
    def _build_facets(self) -> None:
        """Enumerate facets; classify boundary (1 incident cell) vs interior
        (2 incident cells). '+' restriction = lower cell index. Output is
        normalised: boundary sorted by (cell, local_facet), interior by
        (cell_p, local_facet_p).

        Every (cell, local facet) pair gets the sorted vertex list of its
        facet as a key; one stable lexicographic sort brings equal keys
        together while keeping them in (cell, local_facet) order, so each
        group of one is a boundary facet and each group of two an interior
        facet whose first member is the '+' side."""
        rc = self.ref_cell
        cells = self.cells
        nc, nlf = len(cells), rc.n_facets
        keys = np.sort(np.stack([cells[:, list(fv)] for fv in rc.facets],
                                axis=1), axis=2).reshape(nc * nlf, -1)
        # flat pair id = cell * nlf + local_facet, i.e. (cell, lf) order
        order = np.lexsort(keys.T[::-1])
        sk = keys[order]
        new = np.ones(len(sk), dtype=bool)
        if len(sk) > 1:
            new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
        starts = np.flatnonzero(new)
        sizes = np.diff(np.append(starts, len(sk)))
        if np.any(sizes > 2):
            bad = keys[order[starts[np.argmax(sizes > 2)]]]
            raise ValueError(f"facet {tuple(bad)} has {sizes.max()} "
                             f"incident cells")
        b_pair = np.sort(order[starts[sizes == 1]])
        two = starts[sizes == 2]
        first, second = order[two], order[two + 1]
        srt = np.argsort(first, kind="stable")
        first, second = first[srt], second[srt]
        i32 = lambda a: a.astype(np.int32)
        self.boundary_cell = i32(b_pair // nlf)
        self.boundary_local_facet = i32(b_pair % nlf)
        self.interior_cell_p = i32(first // nlf)
        self.interior_local_facet_p = i32(first % nlf)
        self.interior_cell_m = i32(second // nlf)
        self.interior_local_facet_m = i32(second % nlf)


# ======================================================================
# builders
# ======================================================================

def interval_mesh(n_cells: int, a: float = 0.0, b: float = 1.0) -> Mesh:
    """Uniform 1D mesh on [a, b]."""
    nodes = np.linspace(a, b, n_cells + 1)[:, None]
    cells = np.stack([np.arange(n_cells), np.arange(1, n_cells + 1)], axis=1)
    m = Mesh("interval", nodes, cells)
    m.structured = {"dims": (n_cells,), "lengths": (b - a,), "origin": (a,)}
    return m


def _graded_segment(a: float, b: float, h0: float, h1: float) -> np.ndarray:
    """Node coordinates on [a, b] with element size grading h0 -> h1
    (geometric progression), excluding the endpoint b.

    Cell count follows the size-field integral n ≈ ∫ dx/h(x) for h linear
    in x, matching gmsh's density for the reference sizing
    (reference geometry.py:7-14) without depending on the gmsh kernel.
    """
    L = b - a
    if abs(h1 - h0) < 1e-14:
        n = max(1, int(round(L / h0)))
        return a + L * np.arange(n) / n
    n = max(1, int(round(L * np.log(h1 / h0) / (h1 - h0))))
    if n == 1:
        return np.array([a])
    r = (h1 / h0) ** (1.0 / (n - 1))
    steps = h0 * r ** np.arange(n)
    x = np.concatenate([[0.0], np.cumsum(steps)])
    x *= L / x[-1]
    return a + x[:-1]


def graded_interval_mesh(breakpoints, sizes) -> Mesh:
    """1D mesh over piecewise segments with target element sizes at the
    breakpoints, geometrically graded within each segment."""
    breakpoints = np.asarray(breakpoints, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    if not len(breakpoints) == len(sizes) >= 2:
        raise ValueError("need >= 2 breakpoints with one size each")
    xs = [
        _graded_segment(breakpoints[i], breakpoints[i + 1], sizes[i], sizes[i + 1])
        for i in range(len(breakpoints) - 1)
    ]
    nodes = np.concatenate(xs + [breakpoints[-1:]])
    n = len(nodes) - 1
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh("interval", nodes[:, None], cells)


def reference_glass_mesh_1d() -> Mesh:
    """The reference's default 1D glass-slab mesh: [0, 50] with resolution
    0.1 at both surfaces, 1.0 at x=5/45, 3.0 in the core (geometry.py:7-14)."""
    return graded_interval_mesh(
        breakpoints=[0.0, 5.0, 25.0, 45.0, 50.0],
        sizes=[0.1, 1.0, 3.0, 1.0, 0.1],
    )


def box_mesh_2d(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
                cell_type: str = "quad", origin=(0.0, 0.0)) -> Mesh:
    """Structured 2D plate mesh (quad or triangle)."""
    ox, oy = origin
    xs = ox + lx * np.arange(nx + 1) / nx
    ys = oy + ly * np.arange(ny + 1) / ny
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    ci, cj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ci, cj = ci.ravel(), cj.ravel()
    nid = lambda i, j: i * (ny + 1) + j
    # tensor-product vertex order: (0,0),(1,0),(0,1),(1,1)
    quads = np.stack([nid(ci, cj), nid(ci + 1, cj), nid(ci, cj + 1),
                      nid(ci + 1, cj + 1)], axis=1).astype(np.int32)
    if cell_type == "quad":
        m = Mesh("quad", nodes, quads)
        m.structured = {"dims": (nx, ny), "lengths": (lx, ly), "origin": (ox, oy)}
        return m
    if cell_type == "triangle":
        v00, v10, v01, v11 = quads.T
        tris = np.stack([np.stack([v00, v10, v11], axis=1),
                         np.stack([v00, v11, v01], axis=1)],
                        axis=1).reshape(-1, 3)
        return Mesh("triangle", nodes, tris)
    raise ValueError(cell_type)


def box_mesh_3d(nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0,
                lz: float = 1.0, cell_type: str = "hex", origin=(0.0, 0.0, 0.0)) -> Mesh:
    """Structured 3D plate mesh (hex or tet) — the 3D float-glass plate."""
    ox, oy, oz = origin
    xs = ox + lx * np.arange(nx + 1) / nx
    ys = oy + ly * np.arange(ny + 1) / ny
    zs = oz + lz * np.arange(nz + 1) / nz
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # tensor-product corner order: index = ix + 2*iy + 4*iz
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    corners = [nid(ci + (l & 1), cj + ((l >> 1) & 1), ck + ((l >> 2) & 1))
               for l in range(8)]
    hexes = np.stack(corners, axis=1).astype(np.int32)
    if cell_type == "hex":
        m = Mesh("hex", nodes, hexes)
        m.structured = {"dims": (nx, ny, nz), "lengths": (lx, ly, lz),
                        "origin": (ox, oy, oz)}
        return m
    if cell_type == "tet":
        # 6-tet (Kuhn) subdivision of each hex, consistent across faces
        paths = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                 (2, 1, 0)]
        tets = []
        for perm in paths:
            idx = [0, 0, 0]
            verts = [hexes[:, 0]]
            for ax in perm:
                idx[ax] = 1
                verts.append(hexes[:, idx[0] + 2 * idx[1] + 4 * idx[2]])
            tets.append(np.stack(verts, axis=1))
        tets = np.stack(tets, axis=1).reshape(-1, 4)
        return Mesh("tet", nodes, tets)
    raise ValueError(cell_type)
