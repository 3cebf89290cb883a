"""The CG-2 lattice operator and its p-multigrid in the PyTorch port
(ops/grid2.py GridHeatOperator2, Q2MG) against the JAX package's, on the
CPU in f64.

Inputs come from np.random.default_rng(seed) and go to both packages.
Held:
- the residual, the Jacobi diagonal and the kron Jacobian action against
  JAX's GridHeatOperator2 and against the port's gather HeatOperator
  (residual, diagonal, torch.func.jvp) at 1e-12 relative, on the 1D, 2D
  and 3D meshes of tests/test_grid2.py, with and without Dirichlet rows;
- the exact annihilation of constants by the difference-form stiffness;
- the Gershgorin statistics and the line solver's LDL^T factors (1e-13);
- the line bands against the exact Jacobian restricted to one lattice
  line: the diagonal and the mass part exact, and the gap of JAX's alpha
  (the cross-axis stiffness without its dt factor) as its closed form;
- the Q2MG-preconditioned Newton on the 6x6x3 plate (line smoother): equal
  Newton and CG counts to JAX's; with the corrected alpha the same
  solution in fewer CG iterations (measured, not adopted);
- the table form (the materialised 5^d-offset value table) against the
  kron form and against JAX's table form at 1e-12, with and without
  Dirichlet rows (tests/test_grid2.py:62,82);
- the degree-2 configurations off the lattice stencil path set up with the
  operators JAX's dispatch picks and take a converged step; a ghost-padded
  coarse chain (coarse_pad0) takes the grid route (coarse_kind="grid").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.grid2 import GridHeatOperator2 as JG2
from fem_glass_tempering_tpu.ops.grid2 import Q2MG as JQ2MG
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.solver.newton import newton_solve as jnewton
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
from fem_glass_tempering_tpu_torch.ops.grid2 import GridHeatOperator2, Q2MG
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

DT = 0.1
F64 = torch.float64
MESHES = {
    "3d": lambda m: m.box_mesh_3d(4, 3, 2, lx=1.0, ly=0.8, lz=0.05),
    "2d": lambda m: m.box_mesh_2d(5, 3, 1.0, 0.5),
    "1d": lambda m: m.interval_mesh(6, 0.0, 50.0),
}
PLATE = lambda m: m.box_mesh_3d(6, 6, 3, lx=1.0, ly=1.0, lz=0.01)  # noqa: E731
T = lambda a: torch.tensor(np.asarray(a), dtype=F64)  # noqa: E731


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ops(mk, bc=False, order=2):
    """The port's and JAX's heat operator of one CG space, and the port's
    and JAX's lattice operators of it (CG-2)."""
    tfs, jfs = FunctionSpace(mk(tmesh), "CG", order), JFS(mk(jmesh), "CG",
                                                          order)
    kw = {}
    if bc:
        kw = dict(bc_dofs=tfs.boundary_scalar_dofs(), bc_value=600.0)
    th = HeatOperator(tfs, ModelParams(), DT, dtype=F64, device="cpu", **kw)
    jh = JHeat(jfs, JParams(), DT, dtype=jnp.float64, **kw)
    return th, jh


def _level_op(m, jax_side=False):
    if jax_side:
        return JHeat(JFS(m, "CG", 1), JParams(), DT, dtype=jnp.float64)
    return HeatOperator(FunctionSpace(m, "CG", 1), ModelParams(), DT,
                        dtype=F64, device="cpu")


@pytest.mark.parametrize("bc", [False, True], ids=["free", "dirichlet"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_operator_matches_jax_and_the_gather_operator(name, bc):
    th, jh = _ops(MESHES[name], bc)
    tg, jg = GridHeatOperator2(th), JG2(jh)
    n = tg.n
    rng = np.random.default_rng(0)
    Tn = 800.0 + 10 * rng.standard_normal(n)
    Tp = 800.0 + 10 * rng.standard_normal(n)
    v = rng.standard_normal(n)

    r = tg.residual(T(Tn), T(Tp))
    assert _rel(r, jg.residual(jnp.asarray(Tn), jnp.asarray(Tp))) <= 1e-12
    assert _rel(r, th.residual(T(Tn), T(Tp))) <= 1e-12
    dg = tg.jacobian_diag(T(Tn))
    assert _rel(dg, jg.jacobian_diag(jnp.asarray(Tn))) <= 1e-12
    assert _rel(dg, th.jacobian_diag(T(Tn))) <= 1e-12
    mv = tg.make_matvec(T(Tn), DT)(T(v))
    assert _rel(mv, jg.make_matvec(jnp.asarray(Tn), DT, form="kron")(
        jnp.asarray(v))) <= 1e-12
    jv = torch.func.jvp(lambda u: th.residual(u, T(Tp)), (T(Tn),),
                        (T(v),))[1]
    assert _rel(mv, jv) <= 1e-12
    for key, val in jg.gersh.items():
        np.testing.assert_allclose(tg.gersh[key], val, rtol=1e-14,
                                   atol=0.0, err_msg=key)


def test_stiffness_annihilates_constants_exactly():
    th, _ = _ops(MESHES["3d"])
    tg = GridHeatOperator2(th)
    c = torch.full(tg.grid, 800.0, dtype=F64)
    assert float(tg._stiff3(c).abs().max()) == 0.0


@pytest.mark.parametrize("bc", [False, True], ids=["free", "dirichlet"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_table_form_matches_kron_and_jax(name, bc):
    """The materialised table, its flat and grid-shaped Jacobian actions
    (tests/test_grid2.py:62,82), and a GridHeatOperator2 built with
    matvec_form="table", against the kron form and JAX's table form."""
    th, jh = _ops(MESHES[name], bc)
    tg, jg = GridHeatOperator2(th), JG2(jh)
    tt = GridHeatOperator2(th, matvec_form="table")
    rng = np.random.default_rng(5)
    Tn = 800.0 + 10 * rng.standard_normal(tg.n)
    v = rng.standard_normal(tg.n)
    vals = tg.stencil_values_g(T(Tn).reshape(tg.grid), DT)
    jvals = jg.stencil_values_g(jnp.asarray(Tn).reshape(jg.grid), DT)
    assert vals.shape == (5 ** tg.d,) + tg.grid
    assert _rel(vals, jvals) <= 1e-12
    kron = tg.make_matvec(T(Tn), DT, form="kron")(T(v))
    jtable = jg.make_matvec(jnp.asarray(Tn), DT, form="table")(
        jnp.asarray(v))
    for got in (tg.make_matvec(T(Tn), DT, form="table")(T(v)),
                tt.make_matvec(T(Tn), DT)(T(v)),
                tt.make_matvec_g(T(Tn).reshape(tg.grid), DT)(
                    T(v).reshape(tg.grid)).reshape(-1)):
        assert _rel(got, kron) <= 1e-12
        assert _rel(got, jtable) <= 1e-12


def test_padded_coarse_chain_waits_for_slice7():
    """A ghost-padded coarse chain (coarse_pad0, slice 7f) is JAX's GridMG
    route, coarse_kind="grid" (tests/test_torch_grid_shard_q2.py holds it
    to JAX's); the default GeometricMG route refuses the padding."""
    th, _ = _ops(MESHES["3d"])
    tg = GridHeatOperator2(th)
    with pytest.raises(ValueError, match="coarse_kind='grid'"):
        Q2MG(tg, _level_op, coarse_pad0=1)
    q = Q2MG(tg, _level_op, coarse_pad0=1, coarse_kind="grid")
    assert q.gmg.pad0 == 1 and q.gmg.ops[0].grid[0] == tg.dims[0] + 2
    with pytest.raises(ValueError):
        GridHeatOperator2(th, matvec_form="dense")


@pytest.fixture(scope="module")
def plate():
    th, jh = _ops(PLATE)
    tq = Q2MG(GridHeatOperator2(th), _level_op)
    jq = JQ2MG(JG2(jh), lambda m: _level_op(m, jax_side=True))
    tq.freeze_rhos(DT)
    jq.freeze_rhos(DT)
    rng = np.random.default_rng(3)
    Tn = 700.0 + 100.0 * rng.random(tq.fine.n)
    return tq, jq, Tn


def _jax_line_factors(jq, Tn):
    """JAX's LDL^T factors, read from the cells of the zsolve closure
    that its _line_solver returns."""
    zs = jq._line_solver(jnp.asarray(Tn).reshape(jq.fine.grid), DT)
    cells = {name: c.cell_contents for name, c in zip(
        zs.__code__.co_freevars, zs.__closure__)}
    return cells["d0"], cells["l1"], cells["l2"]


def test_line_factors_match_jax(plate):
    tq, jq, Tn = plate
    assert tq.smoother == jq.smoother == "line"
    assert tq.line_axis == jq.line_axis == 2
    assert tq._rho2 == pytest.approx(jq._rho2, rel=1e-14)
    assert tq.gmg._frozen_rhos == pytest.approx(jq.gmg._frozen_rhos,
                                                rel=1e-14)
    d0, l1, l2 = tq._ldl(*tq._line_bands(T(Tn).reshape(tq.fine.grid), DT))
    jd0, jl1, jl2 = _jax_line_factors(jq, Tn)
    for mine, theirs in ((d0, jd0), (l1, jl1), (l2, jl2)):
        assert len(mine) == len(theirs)
        assert _rel(torch.stack(mine), np.stack(theirs)) <= 1e-13
    # the line solve and the power-iteration bound built on them
    r = np.random.default_rng(4).standard_normal(tq.fine.grid)
    zs = tq._line_solver(T(Tn).reshape(tq.fine.grid), DT)
    jzs = jq._line_solver(jnp.asarray(Tn).reshape(jq.fine.grid), DT)
    assert _rel(zs(T(r)), jzs(jnp.asarray(r))) <= 1e-13
    mv = tq.fine.make_matvec_g(T(Tn).reshape(tq.fine.grid), DT)
    jmv = jq.fine.make_matvec_g(jnp.asarray(Tn).reshape(jq.fine.grid), DT)
    rho = tq._power_rho(mv, zs, tq.fine.grid, F64, torch.device("cpu"))
    jrho = jq._power_rho(jmv, jzs, jq.fine.grid, jnp.float64)
    assert float(rho) == pytest.approx(float(jrho), rel=1e-12)


def test_line_bands_against_the_exact_jacobian_line(plate):
    """The watch-list item of JAX ops/grid2.py:821-827: the line matrix
    of one lattice line along z, read off the exact Jacobian action,
    against the line bands. The diagonal is the exact one; the couplings
    differ by JAX's alpha, whose cross-axis stiffness lacks the dt factor:
    a1 - exact = (1 - dt) * c_diff * sum_a K_a M_b (off-line diagonals) *
    M_z band. The port keeps JAX's form (its counts equal JAX's); the
    measured gap and the CG counts are in ROADMAP.md Queue 3."""
    tq, _, Tn = plate
    fine = tq.fine
    Tg = T(Tn).reshape(fine.grid)
    a0, a1, a2 = tq._line_bands(Tg, DT)
    mv = fine.make_matvec_g(Tg, DT)
    # an interior line (i, j) and its exact line matrix by unit vectors
    i, j = 5, 6
    nz = fine.grid[2]
    A = np.zeros((nz, nz))
    for k in range(nz):
        e = torch.zeros(fine.grid, dtype=F64)
        e[i, j, k] = 1.0
        A[:, k] = mv(e)[i, j, :].numpy()
    col = i * fine.grid[1] + j
    np.testing.assert_allclose(a0[col].numpy(), np.diag(A), rtol=1e-14)
    ex1, ex2 = np.diag(A, -1), np.diag(A, -2)
    # the corrected alpha (with dt) reproduces the exact couplings
    (mx, kx), (my, ky), (mz, kz) = fine.np_bands
    cm, ck = fine.op.c_mass, fine.op.c_diff
    alpha_ok = cm * mx[2, i] * my[2, j] + DT * ck * (
        kx[2, i] * my[2, j] + mx[2, i] * ky[2, j])
    beta = ck * mx[2, i] * my[2, j]
    for b, ex in ((3, ex1), (4, ex2)):
        ok = alpha_ok * mz[b, :len(ex)] + DT * beta * kz[b, :len(ex)]
        np.testing.assert_allclose(ok, ex, rtol=1e-12,
                                   atol=1e-14 * np.abs(ex).max())
    # JAX's alpha: the gap is the cross stiffness's missing (1 - dt)
    cross = ck * (kx[2, i] * my[2, j] + mx[2, i] * ky[2, j])
    for got, ex, b in ((a1[col, :nz - 1], ex1, 3), (a2[col, :nz - 2],
                                                    ex2, 4)):
        gap = got.numpy() - ex
        np.testing.assert_allclose(gap, (1.0 - DT) * cross * mz[b, :len(ex)],
                                   rtol=1e-10,
                                   atol=1e-13 * np.abs(ex).max())
    # the relative gap of the first off-diagonal on this line: 0.25%
    rel_gap = float(np.abs(a1[col, :nz - 1].numpy() - ex1).max()
                    / np.abs(ex1).max())
    assert rel_gap > 1e-3, rel_gap


class _CorrectedAlphaQ2MG(Q2MG):
    """Q2MG with the cross-axis stiffness of alpha scaled by dt (the
    exact line couplings), built here only to measure the CG counts of
    that form; the port keeps JAX's."""

    def _line_bands(self, T_lin, dt):
        a0, a1, a2 = super()._line_bands(T_lin, dt)
        fine, az = self.fine, self.line_axis
        (mx, kx), (my, ky) = [fine.np_bands[t] for t in range(3) if t != az]
        cross = fine.op.c_diff * (np.multiply.outer(kx[2], my[2])
                                  + np.multiply.outer(mx[2], ky[2]))
        cross = T(cross).reshape(-1, 1)
        Mb = fine.bands_m[az]
        return (a0, a1 - (1.0 - dt) * cross * Mb[3],
                a2 - (1.0 - dt) * cross * Mb[4])


def test_corrected_alpha_counts_on_the_plate():
    """The first Newton solve of the 6x6x3 plate from 800 K at rtol 1e-12
    with JAX's alpha (the port's form) and with the corrected one: the
    same solution, CG 46 against 41 (ROADMAP.md Queue 3)."""
    th, _ = _ops(PLATE)
    tg = GridHeatOperator2(th)
    T0 = torch.full((tg.n,), 800.0, dtype=F64)
    out = []
    for cls in (Q2MG, _CorrectedAlphaQ2MG):
        q = cls(tg, _level_op)
        q.freeze_rhos(DT)
        res = newton_solve(
            lambda u: tg.residual(u, T0, DT), T0,
            matvec_fn=lambda u: tg.make_matvec(u, DT),
            precond_fn=lambda u: q.preconditioner(q.linearization_states(u),
                                                  DT),
            rtol=1e-12, atol=1e-10, cg_rtol=1e-12, cg_max_it=400)
        assert res.converged
        out.append(res)
    (a, b) = out
    assert (a.iters, a.krylov_iters) == (5, 46)
    assert (b.iters, b.krylov_iters) == (5, 41)
    assert _rel(b.x, a.x) <= 1e-12


def _newton_counts(mk, smoother, T0=800.0):
    """The Q2MG-preconditioned Newton solve from the uniform T0 in the
    port and in JAX -> (port result, JAX result)."""
    th, jh = _ops(mk)
    tg, jg = GridHeatOperator2(th), JG2(jh)
    tq = Q2MG(tg, _level_op)
    jq = JQ2MG(jg, lambda m: _level_op(m, jax_side=True))
    assert tq.smoother == jq.smoother == smoother
    tq.freeze_rhos(DT)
    jq.freeze_rhos(DT)
    T0 = np.full(tg.n, T0)
    kw = dict(rtol=1e-12, atol=1e-10, cg_rtol=1e-12, cg_max_it=400)
    res = newton_solve(
        lambda u: tg.residual(u, T(T0), DT), T(T0),
        matvec_fn=lambda u: tg.make_matvec(u, DT),
        precond_fn=lambda u: tq.preconditioner(tq.linearization_states(u),
                                               DT), **kw)
    jres = jnewton(
        lambda u: jg.residual(u, jnp.asarray(T0), DT), jnp.asarray(T0),
        matvec_fn=lambda u: jg.make_matvec(u, DT),
        precond_fn=lambda u: jq.preconditioner(jq.linearization_states(u),
                                               DT), **kw)
    return res, jres


def test_q2mg_newton_counts_equal_jax_on_the_plate():
    """The line-smoothed Q2MG on the 6x6x3 plate (the isotropic box,
    point Chebyshev, is in tests/test_torch_grid_mg.py)."""
    res, jres = _newton_counts(PLATE, "line")
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert res.krylov_iters == int(jres.krylov_iters)
    assert _rel(res.x, jres.x) <= 1e-12


def _cg2_cfg(**solver):
    kw = dict(linear_operator="stencil", preconditioner="auto",
              mg_smoother="chebyshev")
    kw.update(solver)
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=2, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, 0.1, 0.1),
        solver=tc.SolverConfig(**kw),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


@pytest.mark.parametrize("change", [
    dict(solver=dict(linear_operator="matrix_free")),
    dict(solver=dict(linear_operator="assembled")),
    dict(solver=dict(preconditioner="amg")),
    dict(solver=dict(cg_dtype="float32")),
    dict(mechanics="equilibrium"),
    dict(mesh="unstructured"),
])
def test_degree_two_off_the_lattice_path_waits(change):
    """The configurations that waited for Slice 4b now take the path JAX's
    dispatch picks: on the box the lattice operator carries the residual
    and Q2MG (or its f32 twin) serves "auto", and one step converges; on
    an unstructured mesh "stencil" has no operator, and setup raises
    JAX's ValueError (the gather HeatOperator with SA-AMG runs there with
    the other Krylov operators: tests/test_torch_degree2_gather.py)."""
    solver = change.pop("solver", {})
    mesh = tmesh.box_mesh_3d(2, 2, 1, 1.0, 1.0, 0.01)
    unstructured = bool(change.pop("mesh", None))
    if unstructured:
        mesh = dataclasses.replace(mesh, structured=None)
    cfg = dataclasses.replace(_cg2_cfg(**solver), **change)
    pt = ThermoViscoProblem(mesh=mesh, config=cfg, device="cpu")
    if unstructured:
        with pytest.raises(ValueError, match="structured box mesh"):
            pt.setup()
        assert pt._grid2 is None and pt._amg is not None
        return
    pt.setup()
    pc = pt.config.solver.preconditioner
    assert isinstance(pt._grid2, GridHeatOperator2)
    assert pc == solver.get("preconditioner", "mg")
    assert isinstance(pt._mg if pt._mg32 is None else pt._mg32,
                      Q2MG) == (pc == "mg")
    st, ok, ni, _ = pt.step(pt.state)
    assert ok and ni > 0 and bool(torch.isfinite(st.T).all())


@pytest.mark.parametrize("preconditioner", ["jacobi", "none", "mg"])
def test_lattice_path_preconditioners_step(preconditioner):
    """Jacobi and no preconditioner ride GridHeatOperator2's diagonal;
    "mg" is Q2MG. One converged step each."""
    pt = ThermoViscoProblem(mesh=tmesh.box_mesh_3d(2, 2, 1, 1.0, 1.0, 0.01),
                            config=_cg2_cfg(preconditioner=preconditioner),
                            device="cpu")
    pt.setup()
    assert isinstance(pt._grid2, GridHeatOperator2)
    assert isinstance(pt._mg, Q2MG) == (preconditioner == "mg")
    st, ok, ni, _ = pt.step(pt.state)
    assert ok and ni > 0 and bool(torch.isfinite(st.T).all())
