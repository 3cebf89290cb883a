"""ctypes bindings of the native host runtime (csrc/runtime.cpp).

Counterpart of fem_glass_tempering_tpu/utils/native.py, over the port's
own copy of the runtime's source: facet connectivity, the gmsh 4.1
parser (with physical groups) and the greedy BFS partitioner, the
setup-time work the reference leaves to the dolfinx C++ core. The library
is built on first use by ops/kernel_lib.py (`host_library`, into
`build/torch_native/` at the root of the checkout) and never at import.

Each entry point returns None where the library cannot be built or
loaded; its callers then take the numpy twin (fem/mesh.py
`Mesh._build_facets_numpy`, the Python `read_msh`), whose arrays the
native ones equal bit for bit. `native_error()` says why the library is
missing, and a mesh records which facet builder ran (`facet_builder`).
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_TRIED = False
_ERROR: str | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)


class _FacetResult(ctypes.Structure):
    _fields_ = [
        ("boundary", _I32P),
        ("n_boundary", ctypes.c_int64),
        ("interior", _I32P),
        ("n_interior", ctypes.c_int64),
        ("status", ctypes.c_int32),
    ]


class _MshResult(ctypes.Structure):
    _fields_ = [
        ("nodes", ctypes.POINTER(ctypes.c_double)),
        ("n_nodes", ctypes.c_int64),
        ("cells", _I32P),
        ("n_cells", ctypes.c_int64),
        ("etype", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]


class _MshResult2(ctypes.Structure):
    _fields_ = [
        ("nodes", ctypes.POINTER(ctypes.c_double)),
        ("n_nodes", ctypes.c_int64),
        ("cells", _I32P),
        ("n_cells", ctypes.c_int64),
        ("etype", ctypes.c_int32),
        ("cell_tags", _I32P),
        ("facet_verts", _I32P),
        ("facet_tags", _I32P),
        ("n_facet_elems", ctypes.c_int64),
        ("facet_nv", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]

# gmsh element type -> vertices of its cells
_ETYPE_NV = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8}


def _bind(lib) -> None:
    lib.build_facets.restype = ctypes.POINTER(_FacetResult)
    lib.build_facets.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int32,
                                 _I32P, ctypes.c_int32, ctypes.c_int32]
    lib.free_facet_result.argtypes = [ctypes.POINTER(_FacetResult)]
    lib.free_facet_result.restype = None
    lib.parse_msh.restype = ctypes.POINTER(_MshResult)
    lib.parse_msh.argtypes = [ctypes.c_char_p]
    lib.free_msh_result.argtypes = [ctypes.POINTER(_MshResult)]
    lib.free_msh_result.restype = None
    lib.parse_msh2.restype = ctypes.POINTER(_MshResult2)
    lib.parse_msh2.argtypes = [ctypes.c_char_p]
    lib.free_msh_result2.argtypes = [ctypes.POINTER(_MshResult2)]
    lib.free_msh_result2.restype = None
    lib.partition_bfs.restype = ctypes.c_int32
    lib.partition_bfs.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, _I32P]


def _load():
    """The bound library, built on the first call; None (and the reason
    in `native_error()`) where it cannot be built or loaded."""
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    try:
        lib = kernel_lib.host_library().cdll
    except (RuntimeError, OSError, FileNotFoundError) as e:
        _ERROR = f"{type(e).__name__}: {e}"
        return None
    _bind(lib)
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_error() -> str | None:
    """Why the library is unavailable (None while it is, or untried)."""
    return _ERROR


def native_library_path():
    """Path of the loaded library (None where it is unavailable)."""
    if _load() is None:
        return None
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    return kernel_lib.host_library().path


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def native_build_facets(cells: np.ndarray, ref_cell):
    """Native facet connectivity: the six arrays of Mesh._build_facets
    (boundary cell / local facet, interior '+' cell / local facet, '-'
    cell / local facet), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nfv = len(ref_cell.facets[0])
    if nfv > 4:
        return None
    cells = _i32(cells)
    fdef = _i32(np.array(ref_cell.facets))
    res = lib.build_facets(cells.ctypes.data_as(_I32P), cells.shape[0],
                           cells.shape[1], fdef.ctypes.data_as(_I32P),
                           fdef.shape[0], fdef.shape[1])
    try:
        r = res.contents
        if r.status != 0:
            raise ValueError("facet with more than 2 incident cells")
        nb, ni = int(r.n_boundary), int(r.n_interior)
        b = np.ctypeslib.as_array(r.boundary,
                                  shape=(max(nb, 1), 2))[:nb].copy()
        i = np.ctypeslib.as_array(r.interior,
                                  shape=(max(ni, 1), 4))[:ni].copy()
    finally:
        lib.free_facet_result(res)
    return (b[:, 0], b[:, 1], i[:, 0], i[:, 1], i[:, 2], i[:, 3])


def native_parse_msh(path: str):
    """Native gmsh 4.1 parser: (nodes (n, 3), cells, gmsh element type),
    or None."""
    lib = _load()
    if lib is None:
        return None
    res = lib.parse_msh(str(path).encode())
    try:
        r = res.contents
        if r.status != 0:
            return None
        nn, nc = int(r.n_nodes), int(r.n_cells)
        etype = int(r.etype)
        nodes = np.ctypeslib.as_array(r.nodes, shape=(nn, 3)).copy()
        cells = np.ctypeslib.as_array(
            r.cells, shape=(nc, _ETYPE_NV[etype])).copy()
    finally:
        lib.free_msh_result(res)
    return nodes, cells, etype


def native_parse_msh2(path: str):
    """Native gmsh 4.1 parser with physical groups: (nodes (n, 3), cells,
    gmsh element type, cell_tags (n_cells,) or None, facet_verts
    (n_fel, fnv) or None, facet_tags (n_fel,) or None), or None. Facet
    elements without a physical group are dropped, as the Python reader
    drops them."""
    lib = _load()
    if lib is None:
        return None
    res = lib.parse_msh2(str(path).encode())
    try:
        r = res.contents
        if r.status != 0:
            return None
        nn, nc = int(r.n_nodes), int(r.n_cells)
        etype = int(r.etype)
        nodes = np.ctypeslib.as_array(r.nodes, shape=(nn, 3)).copy()
        cells = np.ctypeslib.as_array(
            r.cells, shape=(nc, _ETYPE_NV[etype])).copy()
        cell_tags = (np.ctypeslib.as_array(r.cell_tags, shape=(nc,)).copy()
                     if nc else None)
        nfe, fnv = int(r.n_facet_elems), int(r.facet_nv)
        if nfe > 0:
            f_verts = np.ctypeslib.as_array(r.facet_verts,
                                            shape=(nfe, fnv)).copy()
            f_tags = np.ctypeslib.as_array(r.facet_tags,
                                           shape=(nfe,)).copy()
            keep = f_tags >= 0
            f_verts, f_tags = f_verts[keep], f_tags[keep]
        else:
            f_verts = f_tags = None
    finally:
        lib.free_msh_result2(res)
    return nodes, cells, etype, cell_tags, f_verts, f_tags


def native_partition_bfs(mesh, n_parts: int):
    """Greedy-BFS contiguous partition of the cells over the facet
    adjacency: (n_cells,) part ids, or None."""
    lib = _load()
    if lib is None:
        return None
    inter = _i32(np.stack([mesh.interior_cell_p, mesh.interior_local_facet_p,
                           mesh.interior_cell_m, mesh.interior_local_facet_m],
                          axis=1))
    out = np.empty(mesh.n_cells, dtype=np.int32)
    rc = lib.partition_bfs(inter.ctypes.data_as(_I32P), inter.shape[0],
                           mesh.n_cells, n_parts, out.ctypes.data_as(_I32P))
    if rc != 0:
        return None
    return out
