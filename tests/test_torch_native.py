"""The port's native host runtime (its own copy of csrc/runtime.cpp, built
with the host C++ compiler into build/torch_native/) against the numpy
twins and the JAX package, on the CPU.

Mirrors tests/test_native.py (facets of five meshes bit-equal to
`_build_facets_numpy`, the gmsh parser against the Python reader, the
BFS partition) and tests/test_mesh.py from :167 (the tagged file read by
the native parser equal to the Python reader's read), plus
tests/test_mesh.py:22's cell diameters. Every array is held to the JAX
package's bit for bit: JAX's numpy facet builder, JAX's parser and JAX's
partitioner.
"""

from pathlib import Path

import numpy as np
import pytest

from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem import mshio as jmshio
from fem_glass_tempering_tpu.utils import native as jnative
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem import mshio as tmshio
from fem_glass_tempering_tpu_torch.ops import kernel_lib
from fem_glass_tempering_tpu_torch.utils import native as tnative

ROOT = Path(__file__).resolve().parents[1]
MESHERS = {
    "ref1d": lambda m: m.reference_glass_mesh_1d(),
    "quad5x4": lambda m: m.box_mesh_2d(5, 4),
    "tri4x4": lambda m: m.box_mesh_2d(4, 4, cell_type="triangle"),
    "hex3x2x2": lambda m: m.box_mesh_3d(3, 2, 2),
    "tet2x2x2": lambda m: m.box_mesh_3d(2, 2, 2, cell_type="tet"),
}
FACETS = ("boundary_cell", "boundary_local_facet", "interior_cell_p",
          "interior_local_facet_p", "interior_cell_m",
          "interior_local_facet_m")


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_the_port_builds_its_own_library():
    """The library is the port's build of its own source, under
    build/torch_native/ at the root of the checkout, and its source is a
    copy of the JAX package's runtime but for `build_facets`, which
    buckets on each facet's smallest vertex where the JAX package's
    hashes (the facet tests hold both to the numpy builder)."""
    assert tnative.native_available(), tnative.native_error()
    lib = kernel_lib.host_library()
    assert lib.path == ROOT / "build" / "torch_native" / kernel_lib.HOST_LIB_NAME
    assert lib.path.exists()
    mine = (kernel_lib.CSRC / "runtime.cpp").read_text()
    theirs = (ROOT / "csrc" / "runtime.cpp").read_text()
    tail = "void free_facet_result"
    assert mine[mine.index(tail):] == theirs[theirs.index(tail):]
    assert "unordered_map<Key128" not in mine
    assert (lib.path.parent / "stamp").read_text() == kernel_lib._host_digest()


@pytest.mark.parametrize("name", list(MESHERS))
def test_native_facets_bitwise_match(name):
    tm, jm = MESHERS[name](tmesh), MESHERS[name](jmesh)
    assert tm.facet_builder == "native"
    nat = tnative.native_build_facets(tm.cells, tm.ref_cell)
    for a, b, c, f in zip(nat, tm._build_facets_numpy(),
                          jm._build_facets_numpy(), FACETS):
        _equal(a, c)
        _equal(b, c)
        _equal(getattr(tm, f), c)


def test_native_facets_reject_nonmanifold():
    cells = np.array([[0, 1], [0, 2], [0, 3]], dtype=np.int32)
    with pytest.raises(ValueError, match="incident cells"):
        tnative.native_build_facets(cells, tmesh.get_cell("interval"))


MSH = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 4 1 4
1 1 0 4
1
2
3
4
0 0 0
1 0 0
2 0 0
3.5 0 0
$EndNodes
$Elements
1 3 1 3
1 1 1 3
1 1 2
2 2 3
3 3 4
$EndElements
"""


def test_native_msh_parser_matches_python(tmp_path):
    """A small msh 4.1 file: the native and the Python reader agree, and
    equal JAX's parser."""
    p = tmp_path / "test.msh"
    p.write_text(MSH)
    m = tmesh.read_msh(str(p))
    assert m.msh_reader == "native"
    assert m.cell_type == "interval"
    assert m.n_cells == 3 and m.n_nodes == 4
    np.testing.assert_allclose(m.nodes[:, 0], [0, 1, 2, 3.5])
    np.testing.assert_array_equal(m.cells, [[0, 1], [1, 2], [2, 3]])
    nat = tnative.native_parse_msh(str(p))
    assert nat is not None and nat[2] == 1
    jnat = jnative.native_parse_msh(str(p))
    for a, b in zip(nat, jnat):
        _equal(a, b)


def _tagged_files(tmp_path):
    """tests/test_mesh.py:134's tagged quad plate, and a hex plate with
    three cell groups and tagged top and bottom faces, written by the
    port's writer (byte-equal to JAX's: tests/test_torch_mesh_io.py)."""
    out = []
    m = tmesh.box_mesh_2d(4, 3)
    ct = np.where(m.nodes[m.cells].mean(axis=1)[:, 0] < 0.5, 1, 2).astype(
        np.int32)
    rc = m.ref_cell
    fmids = np.array([m.nodes[m.cells[c][list(rc.facets[lf])]].mean(axis=0)
                      for c, lf in zip(m.boundary_cell,
                                       m.boundary_local_facet)])
    ftags = np.where(fmids[:, 0] < 1e-12, 7, -1).astype(np.int32)
    path = str(tmp_path / "tagged.msh")
    tmshio.write_msh(path, m, cell_tags=ct, facet_tags=ftags,
                     physical_names={"left_half": (2, 1),
                                     "right_half": (2, 2), "west": (1, 7)})
    out.append(path)
    b = tmesh.box_mesh_3d(3, 2, 2, 1.0, 1.0, 0.1)
    cx = b.nodes[b.cells].mean(axis=1)
    ct = (1 + (cx[:, 0] > 0.34) + (cx[:, 0] > 0.67)).astype(np.int32)
    rc = b.ref_cell
    fz = np.array([b.nodes[b.cells[c][list(rc.facets[lf])]].mean(axis=0)[2]
                   for c, lf in zip(b.boundary_cell,
                                    b.boundary_local_facet)])
    ftags = np.where(fz < 1e-12, 4, np.where(fz > 0.1 - 1e-12, 5, -1))
    path = str(tmp_path / "box.msh")
    tmshio.write_msh(path, b, cell_tags=ct, facet_tags=ftags.astype(np.int32),
                     physical_names={"bottom": (2, 4), "top": (2, 5)})
    out.append(path)
    path = str(tmp_path / "ref1d.msh")
    tmshio.write_msh(path, tmesh.reference_glass_mesh_1d())
    out.append(path)
    return out


MESH_FIELDS = ("nodes", "cells") + FACETS + (
    "cell_tags", "boundary_facet_tags", "interior_facet_tags")


def test_msh_tags_native_python_and_jax_identical(tmp_path, monkeypatch):
    """Each file read by the native parser equals the Python reader's read
    and JAX's (native) read, field by field."""
    for path in _tagged_files(tmp_path):
        m_nat = tmesh.read_msh(path)
        assert m_nat.msh_reader == "native"
        # gmsh's vertex order permuted into a C-ordered cell table, as the
        # cell kernels' gathers need
        assert m_nat.cells.flags.c_contiguous
        with monkeypatch.context() as mp:
            mp.setattr(tnative, "_LIB", None)
            mp.setattr(tnative, "_TRIED", True)      # the Python twin
            m_py = tmesh.read_msh(path)
        assert m_py.msh_reader == "python"
        assert m_py.facet_builder == "numpy"
        m_j = jmesh.read_msh(path)
        assert m_nat.cell_type == m_py.cell_type == m_j.cell_type
        for f in MESH_FIELDS:
            a, b, c = (getattr(x, f) for x in (m_nat, m_py, m_j))
            if c is None:
                assert a is None and b is None, f
                continue
            _equal(a, c)
            _equal(b, c)
        assert m_nat.physical_names == m_py.physical_names
        assert m_nat.physical_names == m_j.physical_names


def test_native_parse_msh2_equals_jax(tmp_path):
    for path in _tagged_files(tmp_path):
        for a, b in zip(tnative.native_parse_msh2(path),
                        jnative.native_parse_msh2(path)):
            if b is None:
                assert a is None
            else:
                _equal(a, b)


def test_native_bfs_partition_contiguous():
    m = tmesh.box_mesh_2d(8, 8)
    part = tnative.native_partition_bfs(m, 4)
    assert part is not None
    counts = np.bincount(part, minlength=4)
    assert counts.min() >= 12 and counts.max() <= 20
    assert set(part) == {0, 1, 2, 3}
    _equal(part, jnative.native_partition_bfs(jmesh.box_mesh_2d(8, 8), 4))


def test_cell_diameters():
    """tests/test_mesh.py:22, and equal to JAX's on a hex and a tet
    mesh."""
    m = tmesh.interval_mesh(10, 0.0, 2.0)
    np.testing.assert_allclose(m.cell_diameters(), 0.2)
    for mk in (lambda mod: mod.box_mesh_3d(3, 2, 2, 1.0, 1.0, 0.1),
               lambda mod: mod.box_mesh_3d(2, 2, 2, cell_type="tet")):
        _equal(mk(tmesh).cell_diameters(), mk(jmesh).cell_diameters())


def test_write_mesh_round_trip_through_the_native_reader(tmp_path):
    """`write_msh` then `read_msh` (native) gives back the built mesh, as
    chip_smoke.py checks at 1,024,000 hexes; here a 6x5x4 plate, and JAX's
    writer makes the same bytes."""
    m = tmesh.box_mesh_3d(6, 5, 4, 1.0, 1.0, 0.01)
    p = str(tmp_path / "plate.msh")
    tmshio.write_msh(p, m)
    jp = str(tmp_path / "plate_jax.msh")
    jmshio.write_msh(jp, jmesh.box_mesh_3d(6, 5, 4, 1.0, 1.0, 0.01))
    assert Path(p).read_bytes() == Path(jp).read_bytes()
    r = tmesh.read_msh(p)
    assert r.msh_reader == "native" and r.facet_builder == "native"
    np.testing.assert_array_equal(r.cells, m.cells)
    np.testing.assert_array_equal(r.nodes, m.nodes)
    for f in FACETS:
        _equal(getattr(r, f), getattr(m, f))


def test_unavailable_library_falls_back_to_the_twins(monkeypatch):
    """Where the library cannot be built the entry points say so (None,
    with the reason) and the mesh takes the numpy facet builder."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(kernel_lib, "_host_loaded", None)
    monkeypatch.setattr(kernel_lib, "_cxx", lambda: (_ for _ in ()).throw(
        RuntimeError("no host C++ compiler found")))
    monkeypatch.setattr(kernel_lib, "HOST_BUILD_DIR",
                        ROOT / "build" / "torch_native_missing")
    assert not tnative.native_available()
    assert "no host C++ compiler" in tnative.native_error()
    m = tmesh.box_mesh_2d(3, 2)
    assert m.facet_builder == "numpy"
    for f, c in zip(FACETS, jmesh.box_mesh_2d(3, 2)._build_facets_numpy()):
        _equal(getattr(m, f), c)
