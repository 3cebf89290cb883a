"""The DG p-multigrid of the PyTorch port (solver/multigrid.py DGMultigrid)
and the DG-1 plate through preconditioner="auto" against the JAX package,
on the CPU in f64.

- freeze() runs on the host in numpy on both sides: the column-type count
  (9 on the 8x8x4 plate), the type mask exactly, the dense per-type column
  inverses at rtol 1e-12 and the frozen spectral radius at 1e-12 relative.
- One preconditioner apply on a seeded vector matches JAX's at rtol 1e-11
  of max|value|, frozen (column, block, Chebyshev) and unfrozen.
- The dense column solve equals the Thomas recurrence (1e-10 relative, the
  JAX test's bound), and the slice p-transfers equal the gather/scatter
  pair.
- The grid route of the grid-sharded step (coarse_kind="grid" over a
  padded GridMG, the grid-shaped transfers, smoother solve and apply)
  against JAX's: prolong_g bit for bit, the restrictions at 1e-14, the
  rest at 1e-12.
- The 8x8x4 DG-1 plate, "auto" + "stencil", 2 steps at rtol 1e-12: T and
  Tf within 1e-12 relative of JAX's, with equal Newton and CG counts; and
  the p-multigrid cuts CG more than 8x against Jacobi with the same
  solution at rtol 1e-11 (the JAX package's test_multigrid.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.solver.multigrid import DGMultigrid as JDGMG
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat
from fem_glass_tempering_tpu_torch.solver.multigrid import DGMultigrid

DT = 0.1
PLATE = (8, 8, 4)


def _close(a, b, what, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300),
        err_msg=what)


def _mesh(mod, dims):
    if len(dims) == 2:
        return mod.box_mesh_2d(*dims, 1.0, 0.02, cell_type="quad")
    return mod.box_mesh_3d(*dims, 1.0, 1.0, 0.01)


def _port_mg(dims=PLATE, dtype=torch.float64, **kw):
    mesh = _mesh(tmesh, dims)
    p = tc.ModelParams()
    op = THeat(TFS(mesh, "DG", 1), p, DT, dtype=dtype, device="cpu")
    make_cg = lambda m: THeat(TFS(m, "CG", 1), p, DT, dtype=dtype,
                              device="cpu")
    return DGMultigrid(op, make_cg, dtype=dtype, **kw)


def _jax_mg(dims=PLATE, **kw):
    mesh = _mesh(jmesh, dims)
    p = jc.ModelParams()
    op = JHeat(JFS(mesh, "DG", 1), p, DT, dtype=jnp.float64)
    make_cg = lambda m: JHeat(JFS(m, "CG", 1), p, DT, dtype=jnp.float64)
    return JDGMG(op, make_cg, dtype=jnp.float64, **kw)


@pytest.fixture(scope="module")
def column_pair():
    jm, tm = _jax_mg(smoother="column"), _port_mg(smoother="column")
    jm.freeze(None, DT)
    tm.freeze(None, DT)
    return jm, tm


def test_frozen_column_data_matches_jax(column_pair):
    jm, tm = column_pair
    jd, td = jm._frozen_smoother_data, tm._frozen_smoother_data
    assert td["colinv"].shape[0] == jd["colinv"].shape[0] == 9
    np.testing.assert_array_equal(td["colmask"].numpy(),
                                  np.asarray(jd["colmask"]))
    _close(td["colinv"], jd["colinv"], "colinv", 1e-12)
    assert tm._frozen_rho == pytest.approx(jm._frozen_rho, rel=1e-12)
    assert tm.cg_mg._frozen_rhos == pytest.approx(jm.cg_mg._frozen_rhos,
                                                  rel=1e-12)


@pytest.mark.parametrize("smoother", ["block", "chebyshev"])
def test_frozen_point_and_block_data_match_jax(smoother):
    jm, tm = _jax_mg(smoother=smoother), _port_mg(smoother=smoother)
    jm.freeze(None, DT)
    tm.freeze(None, DT)
    (key,) = tm._frozen_smoother_data
    _close(tm._frozen_smoother_data[key], jm._frozen_smoother_data[key],
           key, 1e-12)
    assert tm._frozen_rho == pytest.approx(jm._frozen_rho, rel=1e-12)


def _seeded(n, seed):
    rng = np.random.default_rng(seed)
    return 700 + 100 * rng.random(n), rng.standard_normal(n)


@pytest.mark.parametrize("smoother,frozen", [
    ("column", True), ("block", True), ("chebyshev", True),
    ("block", False)])
def test_preconditioner_apply_matches_jax(column_pair, smoother, frozen):
    if smoother == "column":
        jm, tm = column_pair
    else:
        jm, tm = _jax_mg(smoother=smoother), _port_mg(smoother=smoother)
        if frozen:
            jm.freeze(None, DT)
            tm.freeze(None, DT)
    T, r = _seeded(tm.stencil.n, 5)
    got = tm.preconditioner(torch.tensor(T), DT)(torch.tensor(r))
    want = jm.preconditioner(jnp.asarray(T), DT)(jnp.asarray(r))
    _close(got, want, f"{smoother} apply", 1e-11)


def test_dense_column_solve_matches_thomas(column_pair):
    _, tm = column_pair
    data = tm._frozen_smoother_data
    assert "colinv" in data, "dense column path not engaged"
    T0 = torch.full((tm.stencil.n,), tm.dg_op.params.T_0,
                    dtype=torch.float64)
    r = torch.tensor(np.random.default_rng(0).standard_normal(tm.stencil.n))
    x_dense = tm._colinv_apply(data, r)
    x_thomas = tm._zsolve_apply(tm._zsolve_data(T0, DT), r)
    err = float(torch.linalg.norm(x_dense - x_thomas)
                / torch.linalg.norm(x_thomas))
    assert err < 1e-10, err
    # the opt-out keeps the Thomas factors
    mg2 = _port_mg(smoother="column", column_dense=False)
    mg2.freeze(None, DT)
    assert "invD" in mg2._frozen_smoother_data
    x2 = mg2._zsolve_apply(mg2._frozen_smoother_data, r)
    assert float(torch.linalg.norm(x2 - x_thomas)
                 / torch.linalg.norm(x_thomas)) < 1e-12


@pytest.mark.parametrize("dims", [(6, 5, 4), (5, 4)])
def test_slice_transfers_match_gather(dims):
    mg = _port_mg(dims, smoother="block")
    assert mg._vert_offs is not None
    rng = np.random.default_rng(1)
    xc = torch.tensor(rng.standard_normal(mg.n_nodes))
    rd = torch.tensor(rng.standard_normal(mg.stencil.n))
    torch.testing.assert_close(mg.prolong(xc), xc[mg.cells_flat],
                               rtol=0, atol=0)
    scatter = torch.zeros(mg.n_nodes, dtype=rd.dtype).index_add_(
        0, mg.cells_flat, rd)
    torch.testing.assert_close(mg.restrict(rd), scatter, rtol=1e-13,
                               atol=1e-13)
    # the gather fallback (a mesh whose cells are not translates)
    mg._vert_offs = None
    torch.testing.assert_close(mg.prolong(xc), xc[mg.cells_flat])
    torch.testing.assert_close(mg.restrict(rd), scatter)


def test_f32_factors_are_f64_factorisations():
    """In f32 the smoother factors are computed in f64 from the f32 self
    blocks and cast to f32."""
    tm = _port_mg(dtype=torch.float32, smoother="block")
    T = torch.full((tm.stencil.n,), 800.0, dtype=torch.float32)
    inv = tm._zsolve_data(T, DT)["inv_self"]
    vals = tm.stencil.values_at(T, DT)
    assert inv.dtype == torch.float32
    torch.testing.assert_close(
        inv, torch.linalg.inv(vals.double()).float(), rtol=0, atol=0)
    tc_ = _port_mg(dtype=torch.float32, smoother="column")
    data = tc_._zsolve_data(T, DT)
    assert all(m.dtype == torch.float32 for m in data["invD"] + data["Ls"])


@pytest.mark.parametrize("dims,smoother,axis", [
    (PLATE, "column", 2), ((4, 4, 4), "block", None), ((6, 6), "column", 1)])
def test_auto_smoother_rule(dims, smoother, axis):
    """Column smoothing along the finest axis where max h / min h > 3."""
    if dims == (4, 4, 4):
        mesh = tmesh.box_mesh_3d(4, 4, 4, 1.0, 1.0, 1.0)
        p = tc.ModelParams()
        mg = DGMultigrid(THeat(TFS(mesh, "DG", 1), p, DT, device="cpu"),
                         lambda m: THeat(TFS(m, "CG", 1), p, DT,
                                         device="cpu"))
    else:
        mg = _port_mg(dims)
    assert mg.smoother == smoother and mg.col_axis == axis


@pytest.fixture(scope="module")
def grid_pair():
    """DGMultigrid's grid route (coarse_kind="grid", the CG correction's
    node grid padded with 2 ghost planes) on the 4x4x2 plate, frozen, in
    both packages, with JAX's GridDGOperator for the apply's action."""
    from fem_glass_tempering_tpu.solver.grid_dg import GridDGOperator as JG

    from fem_glass_tempering_tpu_torch.solver.grid_dg import GridDGOperator
    dims, kw = (4, 4, 2), dict(coarse_kind="grid", grid_pad0=2)
    jm, tm = _jax_mg(dims, **kw), _port_mg(dims, **kw)
    jm.freeze(None, DT)
    tm.freeze(None, DT)
    return jm, tm, JG(jm.dg_op), GridDGOperator(tm.dg_op)


@pytest.mark.parametrize("what", [
    "coarse_kind", "grid_pad0", "prolong_g", "restrict_g",
    "restrict_state_g", "_zsolve_apply_g", "preconditioner_g"])
def test_sharded_route_raises(grid_pair, what):
    """The grid-shaped (sharded DG) route, which raised until the port's
    slice 7e, against JAX's on the 4x4x2 plate: GridMG's hierarchy
    (coarse_kind), the padded fine node grid (grid_pad0), prolong_g bit
    for bit, restrict_g and restrict_state_g at 1e-14, the frozen
    smoother solve and one preconditioner_g apply at 1e-12."""
    jm, tm, jop, top = grid_pair
    shape = tm.stencil.cell_dims + (tm.stencil.nloc,)
    T, r = (a.reshape(shape) for a in _seeded(tm.stencil.n, 7))
    t, j = torch.tensor, jnp.asarray
    if what == "coarse_kind":
        assert [op.dims for op in tm.cg_mg.ops] == [
            tuple(op.dims) for op in jm.cg_mg.ops]
        assert tm.cg_mg.axes == [None if a is None else tuple(a)
                                 for a in jm.cg_mg.axes]
        assert tm.cg_mg._frozen_rhos == pytest.approx(
            jm.cg_mg._frozen_rhos, rel=1e-12)
    elif what == "grid_pad0":
        assert tm.cg_mg.ops[0].grid == tuple(jm.cg_mg.ops[0].grid) == (
            7, 5, 3)
        assert tm.cg_mg.pad0 == jm.cg_mg.pad0 == 2
    elif what == "prolong_g":
        x = np.random.default_rng(8).standard_normal(tm._node_grid)
        np.testing.assert_array_equal(tm.prolong_g(t(x)).numpy(),
                                      np.asarray(jm.prolong_g(j(x))))
    elif what == "restrict_g":
        _close(tm.restrict_g(t(r)), jm.restrict_g(j(r)), what, 1e-14)
    elif what == "restrict_state_g":
        _close(tm.restrict_state_g(t(T)), jm.restrict_state_g(j(T)), what,
               1e-14)
    elif what == "_zsolve_apply_g":
        got = tm._zsolve_apply_g(tm._frozen_smoother_data, t(r))
        _close(got, jm._zsolve_apply_g(jm._frozen_smoother_data, j(r)),
               what, 1e-12)
    else:
        got = tm.preconditioner_g(t(T), DT, top.make_matvec_g(t(T), DT))(
            t(r))
        want = jax.jit(lambda T, r: jm.preconditioner_g(
            T, DT, jop.make_matvec_g(T, DT))(r))(j(T), j(r))
        _close(got, want, what, 1e-12)


# ----------------------------------------------------------------------
# the DG-1 plate through "auto"
# ----------------------------------------------------------------------

def _plate_cfg(m, steps=2, **solver):
    kw = dict(preconditioner="auto", linear_operator="stencil")
    kw.update(solver)
    return m.RunConfig(fe=m.FEConfig(T_family="DG", T_degree=1),
                       time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                       solver=m.SolverConfig(**kw),
                       output=m.OutputConfig(write_every=0, formats=()),
                       dtype="float64")


def test_auto_plate_matches_jax():
    pj = JP(mesh=_mesh(jmesh, PLATE), config=_plate_cfg(jc))
    pj.setup()
    sj = pj.solve()
    pt = TP(mesh=_mesh(tmesh, PLATE), config=_plate_cfg(tc), device="cpu")
    pt.setup()
    assert pt.config.solver.preconditioner == "mg"
    assert isinstance(pt._dg_mg, DGMultigrid)
    assert pt._dg_mg.smoother == "column"
    assert pt._ell is pt._dg_mg.stencil
    # the block stencil carries the residual: no facet table on the device
    assert pt.heat.i_qw is None
    st = pt.solve()
    for f in ("T", "Tf"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() <= 1e-12, f
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    assert pt.diagnostics.krylov_iters == pj.diagnostics.krylov_iters


@pytest.mark.parametrize("dims,op", [((4, 4, 2), "matrix_free"),
                                     ((5, 4), "stencil")])
def test_other_dg_mg_paths_match_jax(dims, op):
    """'mg' with the jvp Jacobian action, and a 2D plate."""
    cfg = lambda m: _plate_cfg(m, preconditioner="mg", linear_operator=op)
    pj = JP(mesh=_mesh(jmesh, dims), config=cfg(jc))
    pj.setup()
    sj = pj.solve()
    pt = TP(mesh=_mesh(tmesh, dims), config=cfg(tc), device="cpu")
    pt.setup()
    st = pt.solve()
    a, b = np.asarray(sj.T), st.T.numpy()
    assert np.abs(a - b).max() / np.abs(a).max() <= 1e-12
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    assert abs(pt.diagnostics.krylov_iters
               - pj.diagnostics.krylov_iters) <= 2


def test_pmg_cuts_cg_against_jacobi():
    res = {}
    for pc in ("jacobi", "mg"):
        pt = TP(mesh=_mesh(tmesh, PLATE),
                config=_plate_cfg(tc, preconditioner=pc, cg_max_it=50000),
                device="cpu")
        pt.setup()
        res[pc] = (pt.solve().T.numpy(), pt.diagnostics.krylov_iters)
    np.testing.assert_allclose(res["mg"][0], res["jacobi"][0], rtol=1e-11)
    cut = res["jacobi"][1] / max(res["mg"][1], 1)
    assert cut > 8.0, f"DG p-MG iteration cut only {cut:.1f}x"
