"""Structure-of-arrays meshes: builders and facet connectivity (numpy).

Meshes are plain numpy arrays at setup time; the operators copy what they
need onto the device as torch tensors. Connectivity (boundary / interior
facets) is derived once, by the native runtime (utils/native.py) where its
library builds, else fully vectorised in numpy: the facet enumeration of a
1M-cell plate is 6M (cell, local facet) pairs, which a per-pair Python
loop takes minutes over.

Builders:
  - interval_mesh / graded_interval_mesh / reference_glass_mesh_1d: the
    reference's 1D graded glass slab (reference geometry.py:7-14).
  - box_mesh_2d / box_mesh_3d: structured quad/triangle and hex/tet plates.
  - read_msh: the gmsh 4.1 ASCII reader (native, with a pure-Python
    twin), with the physical groups as cell and facet tags.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from fem_glass_tempering_tpu_torch.fem.reference_elements import (
    ReferenceCell,
    get_cell,
)

_GMSH_CELLS = {
    1: ("interval", 2),
    2: ("triangle", 3),
    3: ("quad", 4),
    4: ("tet", 4),
    5: ("hex", 8),
}
# gmsh vertex order -> our tensor-product order
_GMSH_PERM = {
    "interval": [0, 1],
    "triangle": [0, 1, 2],
    "quad": [0, 1, 3, 2],
    "tet": [0, 1, 2, 3],
    "hex": [0, 1, 3, 2, 4, 5, 7, 6],
}


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
    # gmsh physical groups: per-cell physical tag (-1 = untagged),
    # per-boundary / interior-facet tags aligned with the facet enumeration
    # above, and group name -> (dim, tag) as declared in $PhysicalNames
    cell_tags: np.ndarray = field(default=None, compare=False)
    boundary_facet_tags: np.ndarray = field(default=None, compare=False)
    interior_facet_tags: np.ndarray = field(default=None, compare=False)
    physical_names: dict = field(default=None, compare=False)
    # which facet builder ran: "native" (utils/native.py) or "numpy"; and
    # for a mesh read from gmsh, which parser: "native" or "python"
    facet_builder: str = field(default=None, compare=False)
    msh_reader: str = field(default=None, compare=False)

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

    def _resolve_tag(self, tag) -> int:
        """Accept an int physical tag or a $PhysicalNames group name."""
        if isinstance(tag, str):
            if not self.physical_names or tag not in self.physical_names:
                raise KeyError(f"no physical group named {tag!r}")
            return int(self.physical_names[tag][1])
        return int(tag)

    def cells_with_tag(self, tag) -> np.ndarray:
        """Bool mask (n_cells,) of the cells in the physical group `tag`
        (int or group name)."""
        if self.cell_tags is None:
            raise ValueError("mesh carries no cell tags")
        return self.cell_tags == self._resolve_tag(tag)

    def boundary_facets_with_tag(self, tag) -> np.ndarray:
        """Bool mask (n_boundary_facets,) of the boundary facets in the
        physical group `tag` (int or group name): a flux / BC selector."""
        if self.boundary_facet_tags is None:
            raise ValueError("mesh carries no facet tags")
        return self.boundary_facet_tags == self._resolve_tag(tag)

    def _facet_keys(self, cell, local_facet) -> np.ndarray:
        """(n, n_facet_vertices) sorted vertex lists of the given facets."""
        rc = self.ref_cell
        fv = np.asarray([rc.facets[lf] for lf in range(rc.n_facets)])
        return np.sort(self.cells[cell[:, None], fv[local_facet]], axis=1)

    def attach_facet_tags(self, facet_verts, facet_tags: np.ndarray) -> None:
        """Map raw tagged facet elements (vertex lists in mesh-local node
        indices) onto the boundary / interior facet enumerations; a facet
        listed twice keeps its last tag, one that is no facet of the mesh
        is dropped."""
        nb = self.n_boundary_facets
        keys = np.concatenate([
            self._facet_keys(self.boundary_cell, self.boundary_local_facet),
            self._facet_keys(self.interior_cell_p,
                             self.interior_local_facet_p)])
        tags = np.asarray(facet_tags)
        tagged = np.sort(np.asarray(facet_verts, dtype=keys.dtype).reshape(
            len(tags), keys.shape[1]), axis=1)
        # one id per distinct vertex list: the mesh's facets first, so a
        # tagged list's id below len(keys) names the facet it lies on
        _, first, inv = np.unique(np.concatenate([keys, tagged]), axis=0,
                                  return_index=True, return_inverse=True)
        where = first[inv.reshape(-1)[len(keys):]]
        # the last listing of a facet wins: keep each id's last occurrence
        _, last_rev = np.unique(where[::-1], return_index=True)
        keep = len(where) - 1 - last_rev
        keep = keep[where[keep] < len(keys)]
        all_tags = np.full(len(keys), -1, dtype=np.int32)
        all_tags[where[keep]] = tags[keep]
        self.boundary_facet_tags = all_tags[:nb]
        self.interior_facet_tags = all_tags[nb:]

    def cell_diameters(self) -> np.ndarray:
        """Max vertex-to-vertex distance per cell (dolfinx CellDiameter)."""
        xc = self.cell_vertex_coords()
        d = np.linalg.norm(xc[:, :, None, :] - xc[:, None, :, :], axis=-1)
        return d.max(axis=(1, 2))

    # ------------------------------------------------------------------
    def _build_facets(self) -> None:
        """Enumerate facets; classify boundary (1 incident cell) vs interior
        (2 incident cells). '+' restriction = lower cell index. Output is
        normalised: boundary sorted by (cell, local_facet), interior by
        (cell_p, local_facet_p). The native runtime (utils/native.py)
        builds them where its library is available, else the numpy twin
        `_build_facets_numpy`, with equal arrays; `facet_builder` says
        which ran."""
        from fem_glass_tempering_tpu_torch.utils.native import (
            native_build_facets,
        )
        res = native_build_facets(self.cells, self.ref_cell)
        self.facet_builder = "native" if res is not None else "numpy"
        if res is None:
            res = self._build_facets_numpy()
        (self.boundary_cell, self.boundary_local_facet,
         self.interior_cell_p, self.interior_local_facet_p,
         self.interior_cell_m, self.interior_local_facet_m) = res

    def _build_facets_numpy(self):
        """The six facet arrays of `_build_facets`, in numpy.

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
        return (i32(b_pair // nlf), i32(b_pair % nlf), i32(first // nlf),
                i32(first % nlf), i32(second // nlf), i32(second % nlf))


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


# ======================================================================
# gmsh 4.1 ASCII reader
# ======================================================================

_ETYPE_NAME = {1: "interval", 2: "triangle", 3: "quad", 4: "tet", 5: "hex"}
# gmsh element type -> (topological dim, n vertices); 15 = point
_ETYPE_DIM_NV = {15: (0, 1), 1: (1, 2), 2: (2, 3), 3: (2, 4), 4: (3, 4),
                 5: (3, 8)}


def read_msh(path: str, gdim: int | None = None) -> Mesh:
    """gmsh 4.1 ASCII `.msh` reader: nodes + highest-dimension cells +
    physical groups (cell / facet tags + $PhysicalNames).

    dolfinx's `gmshio.read_from_msh` returns `(mesh, cell_tags,
    facet_tags)` (reference ThermoViscoProblem.py:27-28); here the tags
    live on the Mesh (`cell_tags`, `boundary_facet_tags`,
    `interior_facet_tags`, `physical_names`). `gdim` keeps that many
    coordinates (default: the cells' topological dimension).

    The native parser (utils/native.py `native_parse_msh2`) reads the file
    where its library is available; this Python reader is its twin, with
    equal arrays. `msh_reader` on the mesh says which ran.
    """
    from fem_glass_tempering_tpu_torch.utils.native import native_parse_msh2

    names = _read_physical_names(path)
    nat = native_parse_msh2(path)
    if nat is not None:
        coords, raw_cells, etype, cell_tags, f_verts, f_tags = nat
        name = _ETYPE_NAME[etype]
        cells = np.ascontiguousarray(raw_cells[:, _GMSH_PERM[name]],
                                     dtype=np.int32)
        g = gdim if gdim is not None else get_cell(name).tdim
        m = Mesh(name, coords[:, :g], cells)
        if cell_tags is not None and (cell_tags >= 0).any():
            m.cell_tags = cell_tags
        if f_verts is not None and len(f_verts):
            m.attach_facet_tags(list(f_verts), f_tags)
        m.physical_names = names
        m.msh_reader = "native"
        return m
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0

    def section(name):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i == len(lines):
            raise ValueError(f"section {name} not found in {path}")
        i += 1

    def optional_section(name):
        nonlocal i
        i = 0
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i == len(lines):
            return False
        i += 1
        return True

    section("MeshFormat")
    version = lines[i].split()[0]
    if not version.startswith("4"):
        raise ValueError(f"only msh 4.x supported, got {version}")

    # entity (dim, tag) -> physical tag (first listed), from $Entities
    ent_phys: dict[tuple, int] = {}
    if optional_section("Entities"):
        counts = [int(v) for v in lines[i].split()]
        i += 1
        for dim, n_ent in enumerate(counts):
            for _ in range(n_ent):
                parts = lines[i].split()
                i += 1
                etag = int(parts[0])
                # points: tag x y z nPhys phys...; higher dims: tag + 6
                # bbox floats + nPhys phys... (+ bounding entities)
                off = 4 if dim == 0 else 7
                n_phys = int(parts[off])
                if n_phys > 0:
                    ent_phys[(dim, etag)] = int(parts[off + 1])

    i = 0
    section("Nodes")
    header = lines[i].split()
    num_blocks, num_nodes = int(header[0]), int(header[1])
    i += 1
    tags, coords = [], []
    for _ in range(num_blocks):
        _, _, _, n_in_block = (int(v) for v in lines[i].split())
        i += 1
        block_tags = [int(lines[i + k]) for k in range(n_in_block)]
        i += n_in_block
        for k in range(n_in_block):
            coords.append([float(v) for v in lines[i + k].split()[:3]])
        i += n_in_block
        tags.extend(block_tags)
    tag_to_idx = {t: k for k, t in enumerate(tags)}
    coords = np.asarray(coords)

    i = 0
    section("Elements")
    header = lines[i].split()
    num_blocks = int(header[0])
    i += 1
    cells_by_type: dict[str, list] = {}
    tags_by_type: dict[str, list] = {}
    elems_by_dim: dict[int, list] = {}   # dim -> [(verts, phys_tag)]
    for _ in range(num_blocks):
        edim, etag, etype, n_in_block = (int(v) for v in lines[i].split())
        i += 1
        phys = ent_phys.get((edim, etag), -1)
        if etype in _GMSH_CELLS:
            name, nv = _GMSH_CELLS[etype]
            perm = _GMSH_PERM[name]
            for k in range(n_in_block):
                parts = [int(v) for v in lines[i + k].split()]
                verts = [tag_to_idx[t] for t in parts[1 : 1 + nv]]
                cells_by_type.setdefault(name, []).append(
                    [verts[p] for p in perm])
                tags_by_type.setdefault(name, []).append(phys)
                elems_by_dim.setdefault(edim, []).append((verts, phys))
        elif etype in _ETYPE_DIM_NV:
            _, nv = _ETYPE_DIM_NV[etype]
            for k in range(n_in_block):
                parts = [int(v) for v in lines[i + k].split()]
                verts = [tag_to_idx[t] for t in parts[1 : 1 + nv]]
                elems_by_dim.setdefault(edim, []).append((verts, phys))
        i += n_in_block

    if not cells_by_type:
        raise ValueError(f"no supported cells in {path}")
    # keep the highest-dimensional cell type present
    order = ["hex", "tet", "quad", "triangle", "interval"]
    name = next(n for n in order if n in cells_by_type)
    cells = np.asarray(cells_by_type[name], dtype=np.int32)
    tdim = get_cell(name).tdim
    g = gdim if gdim is not None else tdim
    m = Mesh(name, coords[:, :g], cells)
    ct = np.asarray(tags_by_type[name], dtype=np.int32)
    if (ct >= 0).any():
        m.cell_tags = ct
    facet_elems = elems_by_dim.get(tdim - 1, [])
    tagged = [(v, t) for v, t in facet_elems if t >= 0]
    if tagged:
        m.attach_facet_tags([v for v, _ in tagged],
                            np.asarray([t for _, t in tagged],
                                       dtype=np.int32))
    m.physical_names = names
    m.msh_reader = "python"
    return m


def _read_physical_names(path: str) -> dict:
    """Parse $PhysicalNames -> {name: (dim, tag)}."""
    names: dict[str, tuple] = {}
    with open(path) as f:
        in_sec = False
        first = True
        for line in f:
            s = line.strip()
            if s == "$PhysicalNames":
                in_sec = True
                first = True
                continue
            if s == "$EndPhysicalNames":
                break
            if in_sec:
                if first:
                    first = False
                    continue
                parts = s.split(maxsplit=2)
                if len(parts) == 3:
                    names[parts[2].strip('"')] = (int(parts[0]),
                                                  int(parts[1]))
    return names
