"""gmsh input and output of the PyTorch port against the JAX package's.

`write_msh` and `create_mesh` write the same bytes as the JAX package's
for the same mesh; `read_msh` returns exactly the arrays JAX's reader
returns (nodes, cells, the facet enumeration, every tag array and the
physical names), whether JAX reads through its native parser or its
pure-Python one; the port's vectorised `attach_facet_tags` tags the same
facets as JAX's loop. The round trips and physical-group cases mirror
tests/test_cli_and_misc.py:24-47,155-175 and tests/test_mesh.py:152-165,
and the tag-selected flux and Dirichlet runs (tests/test_mesh.py:188)
take the same Newton and CG counts as JAX's on the read mesh.
"""

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

import fem_glass_tempering_tpu.utils.native as jnative
from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem import mshio as jmshio
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem import mshio as tmshio
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP

MESHERS = {
    "ref1d": lambda m: m.reference_glass_mesh_1d(),
    "tri3x2": lambda m: m.box_mesh_2d(3, 2, cell_type="triangle"),
    "box2x2x2": lambda m: m.box_mesh_3d(2, 2, 2),
}
MESH_ARRAYS = ("nodes", "cells", "boundary_cell", "boundary_local_facet",
               "interior_cell_p", "interior_local_facet_p",
               "interior_cell_m", "interior_local_facet_m")
TAG_ARRAYS = ("cell_tags", "boundary_facet_tags", "interior_facet_tags")


def _assert_meshes_equal(a, b):
    assert a.cell_type == b.cell_type
    for f in MESH_ARRAYS + TAG_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.physical_names == b.physical_names


@pytest.mark.parametrize("name", MESHERS)
def test_msh_roundtrip(tmp_path, name):
    m = MESHERS[name](tmesh)
    p = str(tmp_path / "m.msh")
    tmshio.write_msh(p, m)
    m2 = tmesh.read_msh(p, gdim=m.gdim)
    assert m2.cell_type == m.cell_type
    np.testing.assert_allclose(m2.nodes, m.nodes, atol=1e-12)
    np.testing.assert_array_equal(m2.cells, m.cells)


@pytest.mark.parametrize("name", MESHERS)
def test_write_msh_bytes_equal_jax(tmp_path, name):
    tmshio.write_msh(str(tmp_path / "t.msh"), MESHERS[name](tmesh))
    jmshio.write_msh(str(tmp_path / "j.msh"), MESHERS[name](jmesh))
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


def test_create_mesh_reference_parity(tmp_path):
    """create_mesh(path) writes the graded 1D glass mesh (the reference's
    geometry.py:3-29), byte for byte as JAX's."""
    p = str(tmp_path / "mesh1d.msh")
    tmshio.create_mesh(p)
    jmshio.create_mesh(str(tmp_path / "j.msh"))
    assert (tmp_path / "mesh1d.msh").read_bytes() == (
        tmp_path / "j.msh").read_bytes()
    m = tmesh.read_msh(p, gdim=1)
    assert m.cell_type == "interval"
    assert m.nodes[:, 0].min() == 0.0 and m.nodes[:, 0].max() == 50.0


def test_msh_fuzz_roundtrip(tmp_path):
    """Random structured meshes round-trip through write_msh / read_msh."""
    rng = np.random.default_rng(0)
    for i in range(4):
        dims = rng.integers(1, 5, size=3)
        ct = rng.choice(["quad", "triangle"])
        m = tmesh.box_mesh_2d(int(dims[0]), int(dims[1]), cell_type=ct)
        p = str(tmp_path / f"m{i}.msh")
        tmshio.write_msh(p, m)
        m2 = tmesh.read_msh(p, gdim=2)
        np.testing.assert_array_equal(m2.cells, m.cells)
    m = tmesh.box_mesh_3d(2, 3, 2, cell_type="tet")
    p = str(tmp_path / "t.msh")
    tmshio.write_msh(p, m)
    m2 = tmesh.read_msh(p, gdim=3)
    np.testing.assert_array_equal(m2.cells, m.cells)


# ----------------------------------------------------------------------
# gmsh physical groups (reference geometry.py:23-24 writes the group;
# dolfinx gmshio.read_from_msh returns (mesh, cell_tags, facet_tags))
# ----------------------------------------------------------------------

def _tagged_mesh_file(tmp_path, mod=tmesh, wmod=tmshio, name="tagged.msh"):
    """tests/test_mesh.py:134's file: two cell groups and the west edge."""
    m = mod.box_mesh_2d(4, 3)
    ct = np.where(m.nodes[m.cells].mean(axis=1)[:, 0] < 0.5, 1, 2).astype(
        np.int32)
    rc = m.ref_cell
    fmids = np.array([
        m.nodes[m.cells[c][list(rc.facets[lf])]].mean(axis=0)
        for c, lf in zip(m.boundary_cell, m.boundary_local_facet)])
    ftags = np.where(fmids[:, 0] < 1e-12, 7, -1).astype(np.int32)
    path = str(tmp_path / name)
    wmod.write_msh(path, m, cell_tags=ct, facet_tags=ftags,
                   physical_names={"left_half": (2, 1), "right_half": (2, 2),
                                   "west": (1, 7)})
    return path, m, ct, ftags


def _tagged_box_file(tmp_path, mod=tmesh, wmod=tmshio, name="box.msh"):
    """A hex plate with three cell groups and the top and bottom faces
    tagged apart."""
    m = mod.box_mesh_3d(3, 2, 2, 1.0, 1.0, 0.1)
    ct = (np.arange(m.n_cells) % 3 + 1).astype(np.int32)
    rc = m.ref_cell
    fz = np.array([
        m.nodes[m.cells[c][list(rc.facets[lf])]].mean(axis=0)[2]
        for c, lf in zip(m.boundary_cell, m.boundary_local_facet)])
    ftags = np.select([fz < 1e-12, fz > 0.1 - 1e-12], [4, 5], -1).astype(
        np.int32)
    path = str(tmp_path / name)
    wmod.write_msh(path, m, cell_tags=ct, facet_tags=ftags,
                   physical_names={"bottom": (2, 4), "top": (2, 5)})
    return path


@pytest.mark.parametrize("make", [_tagged_mesh_file, _tagged_box_file],
                         ids=["quad", "hex"])
def test_tagged_msh_bytes_equal_jax(tmp_path, make):
    a = make(tmp_path, tmesh, tmshio, "t.msh")
    b = make(tmp_path, jmesh, jmshio, "j.msh")
    a, b = (x[0] if isinstance(x, tuple) else x for x in (a, b))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("jax_reader", ["native", "python"])
@pytest.mark.parametrize("make", [_tagged_mesh_file, _tagged_box_file,
                                  lambda p: _write_plain(p)],
                         ids=["quad", "hex", "ref1d"])
def test_read_msh_equals_jax(tmp_path, make, jax_reader):
    """The port's reader returns JAX's arrays, through either of JAX's
    readers."""
    path = make(tmp_path)
    path = path[0] if isinstance(path, tuple) else path
    if jax_reader == "native":
        if not jnative.native_available():
            pytest.skip("the JAX package's native library is unavailable")
        jm = jmesh.read_msh(path)
    else:
        lib, tried = jnative._LIB, jnative._TRIED
        try:
            jnative._LIB, jnative._TRIED = None, True
            jm = jmesh.read_msh(path)
        finally:
            jnative._LIB, jnative._TRIED = lib, tried
    _assert_meshes_equal(tmesh.read_msh(path), jm)


def _write_plain(tmp_path):
    path = str(tmp_path / "mesh1d.msh")
    tmshio.create_mesh(path)
    return path


def test_msh_physical_groups_roundtrip(tmp_path):
    path, m, ct, ftags = _tagged_mesh_file(tmp_path)
    m2 = tmesh.read_msh(path)
    assert m2.cell_tags is not None
    assert int((m2.cell_tags == 1).sum()) == int((ct == 1).sum())
    assert m2.physical_names["west"] == (1, 7)
    # the facet enumeration is normalised identically on write / read
    west = m2.boundary_facets_with_tag("west")
    assert int(west.sum()) == int((ftags == 7).sum())
    np.testing.assert_array_equal(west, ftags == 7)
    # name-based cell selection
    assert int(m2.cells_with_tag("right_half").sum()) == int((ct == 2).sum())
    with pytest.raises(KeyError, match="no physical group"):
        m2.cells_with_tag("east")
    with pytest.raises(ValueError, match="no cell tags"):
        tmesh.box_mesh_2d(2, 2).cells_with_tag(1)


@pytest.mark.parametrize("name", ["tri3x2", "box2x2x2"])
def test_attach_facet_tags_equals_jax(name):
    """Boundary and interior facets, a facet listed twice (the last tag
    wins), vertex lists in any order and one that is no facet of the mesh:
    the vectorised attach tags what JAX's loop tags."""
    tm, jm = MESHERS[name](tmesh), MESHERS[name](jmesh)
    rc = tm.ref_cell
    rng = np.random.default_rng(1)
    cells = np.concatenate([tm.boundary_cell, tm.interior_cell_p])
    lfs = np.concatenate([tm.boundary_local_facet, tm.interior_local_facet_p])
    pick = rng.choice(len(cells), size=len(cells) // 2 + 3, replace=True)
    verts = [list(rng.permutation(tm.cells[cells[k]][list(rc.facets[lfs[k]])]))
             for k in pick]
    verts.append([tm.n_nodes - 1] * len(verts[0]))      # no facet
    tags = rng.integers(1, 9, size=len(verts)).astype(np.int32)
    tm.attach_facet_tags(verts, tags)
    jm.attach_facet_tags(verts, tags)
    for f in ("boundary_facet_tags", "interior_facet_tags"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
        assert getattr(tm, f).dtype == getattr(jm, f).dtype
    assert (tm.interior_facet_tags >= 0).any()
    assert (tm.boundary_facet_tags >= 0).any()


def _tag_cfg(m):
    return m.RunConfig(
        fe=m.FEConfig(T_family="CG", T_degree=1,
                      sigma_family="CG", sigma_degree=1),
        time=m.TimeConfig(0.0, 0.2, 0.1),
        solver=m.SolverConfig(preconditioner="jacobi"),
        output=m.OutputConfig(write_every=0, formats=()))


def test_tag_selected_flux_and_dirichlet(tmp_path):
    """setup(flux_tag=...) applies the flux on exactly the tagged facets
    (the coordinate flux_marker's residual, bit for bit) and
    dirichlet_tag clamps exactly the tagged facets' dofs; both runs, from
    the mesh read with mesh_path=, take JAX's Newton and CG counts."""
    path, *_ = _tagged_mesh_file(tmp_path)
    mesh = tmesh.read_msh(path)
    p1 = TP(mesh=mesh, config=_tag_cfg(tc), device="cpu")
    p1.setup(flux_tag="west")
    p2 = TP(mesh=mesh, config=_tag_cfg(tc), device="cpu")
    p2.setup(flux_marker=lambda x: x[:, 0] < 1e-12)
    rng = np.random.default_rng(5)
    T = torch.tensor(700 + 100 * rng.random(p1.fs_T.n_scalar_dofs))
    Tp = torch.tensor(700 + 100 * rng.random(p1.fs_T.n_scalar_dofs))
    assert torch.equal(p1.heat.residual(T, Tp), p2.heat.residual(T, Tp))

    p3 = TP(mesh=mesh, config=_tag_cfg(tc), device="cpu")
    p3.setup(dirichlet_tag="west")
    bd = np.where(p3.heat.bc_mask.numpy())[0]
    assert len(bd) == 4                     # ny=3 -> 4 nodes on x=0
    assert np.all(p3.fs_T.dof_coords[bd, 0] < 1e-12)

    for kw in (dict(flux_tag="west"), dict(dirichlet_tag="west")):
        pt = TP(mesh_path=path, config=_tag_cfg(tc), device="cpu")
        pt.setup(**kw)
        st = pt.solve()
        pj = JP(mesh_path=path, config=_tag_cfg(jc))
        pj.setup(**kw)
        sj = pj.solve()
        dt, dj = pt.diagnostics, pj.diagnostics
        assert (dt.newton_iters, dt.krylov_iters) == (
            dj.newton_iters, dj.krylov_iters), kw
        a, b = np.asarray(sj.T), st.T.numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-9, kw
