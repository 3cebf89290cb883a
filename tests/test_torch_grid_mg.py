"""The CG-1 coarse V-cycle of the port's CG-2 path against the JAX
package's GridMG, the K2 route of its level matvec, and the CG-2 lattice
path end to end, on the CPU in f64.

The JAX package's Q2MG takes GridMG, a grid-shaped V-cycle; the port's
takes GeometricMG (solver/multigrid.py) on the flattened coarse residual:
without the sharded padding the two compute the same cycle. Held:
- the coarse V-cycle that the port's Q2MG builds against JAX's GridMG on
  the 12x6x4 plate of tests/test_grid_mg.py (single device), with
  coarse="auto" (one dense level) and "smooth" (a hierarchy to the
  floor), and on the 32x32x4 plate (5,445 CG-1 nodes: one smoothed level
  over a dense one, the shape of the full-width chain): level dims, axes,
  frozen rhos, the dense coarse inverse, and one V-cycle apply on a
  seeded vector at 1e-12;
- the level matvec's route (the flat stencil apply, K2's plain twin on
  the CPU) bit for bit against the grid-shaped `matvec_vals`, the function
  the JAX version applies, and against JAX's matvec_vals at 1e-15;
- the Q2MG-preconditioned Newton on a 3x3x3 box (point Chebyshev): equal
  Newton counts, and CG counts that JAX itself reaches from a start one
  ulp away (the solve stops on its last bits at rtol 1e-12);
- the 5x5x3 CG-2 plate through preconditioner="auto" (Q2MG with the line
  smoother + one dense coarse level), f64, rtol 1e-12, 3 steps, against
  JAX's ThermoViscoProblem: equal per-step Newton and CG counts, T, Tf and
  sigma within 1e-10 of their max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu.ops.grid import GridHeatOperator as JGrid
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.solver.grid_mg import GridMG as JGridMG
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.ops.grid2 import GridHeatOperator2, Q2MG
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

from test_torch_grid2 import _newton_counts, _rel

DT = 0.1
F64 = torch.float64
PLATE = lambda m: m.box_mesh_3d(12, 6, 4, 1.0, 1.0, 0.01)  # noqa: E731
PLATES = {
    "12x6x4": PLATE,
    "32x32x4": lambda m: m.box_mesh_3d(32, 32, 4, 1.0, 1.0, 0.01),
}
T = lambda a: torch.tensor(np.asarray(a), dtype=F64)  # noqa: E731


def _theat(m):
    return HeatOperator(FunctionSpace(m, "CG", 1), ModelParams(), DT,
                        dtype=F64, device="cpu")


def _jheat(m):
    return JHeat(JFS(m, "CG", 1), JParams(), DT, dtype=jnp.float64)


@pytest.fixture(scope="module", params=[("12x6x4", "auto"),
                                        ("12x6x4", "smooth"),
                                        ("32x32x4", "auto")],
                ids=lambda p: "-".join(p))
def pair(request):
    plate, coarse = request.param
    mk = PLATES[plate]
    heat2 = HeatOperator(FunctionSpace(mk(tmesh), "CG", 2), ModelParams(),
                         DT, dtype=F64, device="cpu")
    q2 = Q2MG(GridHeatOperator2(heat2), _theat,
              mg_kwargs={"coarse": coarse})
    jmg = JGridMG(JGrid(_jheat(mk(jmesh)), allow_const=False), _jheat,
                  coarse=coarse)
    q2.freeze_rhos(DT)
    jmg.freeze_rhos(DT)
    return plate, coarse, q2.gmg, jmg


def test_hierarchy_matches_jax(pair):
    plate, coarse, tmg, jmg = pair
    assert tmg.smoother == jmg.smoother == "chebyshev"
    assert [tuple(n + 1 for n in lv.fine_dims)
            for lv in tmg.levels] == jmg.grids()
    assert [lv.axes for lv in tmg.levels] == jmg.axes
    assert tmg._frozen_rhos == pytest.approx(jmg._frozen_rhos, rel=1e-14)
    smoothed = sum(lv.axes is not None for lv in tmg.levels)
    if coarse == "auto":
        assert smoothed == (1 if plate == "32x32x4" else 0)
        assert tmg.coarse_inv is not None
        np.testing.assert_allclose(tmg.coarse_inv.numpy(),
                                   np.asarray(jmg.coarse_inv), rtol=0,
                                   atol=1e-13 * float(
                                       np.abs(jmg.coarse_inv).max()))
    else:
        assert smoothed >= 1 and tmg.coarse_inv is None


def test_one_vcycle_apply_matches_jax(pair):
    _, _, tmg, jmg = pair
    grid = tuple(n + 1 for n in tmg.levels[0].fine_dims)
    rng = np.random.default_rng(7)
    Tg = 700.0 + 100.0 * rng.random(grid)
    r = rng.standard_normal(grid)
    got = tmg.preconditioner(tmg.linearization_states(T(Tg).reshape(-1)),
                             DT)(T(r).reshape(-1))
    want = jmg.preconditioner_g(jmg.linearization_states_g(
        jnp.asarray(Tg)), DT)(jnp.asarray(r))
    assert _rel(got.reshape(grid), want) <= 1e-12


@pytest.mark.parametrize("bc", [False, True], ids=["free", "dirichlet"])
def test_level_matvec_route_is_matvec_vals(bc):
    """The level matvec goes through the flat stencil apply (K2 on the
    GPU); on the CPU its plain twin gives the bits of the grid-shaped
    matvec_vals, JAX's level matvec."""
    kw = {}
    if bc:
        fs = FunctionSpace(PLATE(tmesh), "CG", 1)
        kw = dict(bc_dofs=fs.boundary_scalar_dofs(), bc_value=600.0)
    heat = HeatOperator(FunctionSpace(PLATE(tmesh), "CG", 1), ModelParams(),
                        DT, dtype=F64, device="cpu", **kw)
    jheat = JHeat(JFS(PLATE(jmesh), "CG", 1), JParams(), DT,
                  dtype=jnp.float64, **kw)
    op, jop = GridHeatOperator(heat), JGrid(jheat, allow_const=False)
    rng = np.random.default_rng(8)
    Tg = 700.0 + 100.0 * rng.random(op.grid)
    x = rng.standard_normal(op.grid)
    vals = op.stencil_values_g(T(Tg), DT)
    got = op.make_matvec(T(Tg).reshape(-1), DT)(T(x).reshape(-1)).reshape(
        op.grid)
    if bc:
        mask = op.bc_mask_g
        want = torch.where(mask, T(x), op.matvec_vals(
            vals, torch.where(mask, torch.zeros_like(T(x)), T(x))))
    else:
        want = op.matvec_vals(vals, T(x))
    assert torch.equal(got, want)
    jvals = jop.stencil_values_g(jnp.asarray(Tg), DT)
    jx = jnp.asarray(x)
    if bc:
        jw = jnp.where(jop.bc_mask_g, jx,
                       jop.matvec_vals(jvals, jnp.where(jop.bc_mask_g, 0.0,
                                                        jx)))
    else:
        jw = jop.matvec_vals(jvals, jx)
    assert _rel(got, jw) <= 1e-15


def test_q2mg_newton_on_the_isotropic_box():
    """Point Chebyshev on a 3x3x3 box. Newton counts equal; the CG total
    is 52 in the port and 53 in JAX, and JAX started one ulp above 800 K
    takes 52: the last CG solve stops on its last bits (rtol 1e-12), so
    the count is held to JAX's pair."""
    iso = lambda m: m.box_mesh_3d(3, 3, 3, lx=1.0, ly=1.0, lz=1.0)  # noqa
    res, jres = _newton_counts(iso, "chebyshev")
    _, jres_ulp = _newton_counts(iso, "chebyshev",
                                 T0=float(np.nextafter(800.0, 1e9)))
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters) == int(jres_ulp.iters)
    assert res.krylov_iters in (int(jres.krylov_iters),
                                int(jres_ulp.krylov_iters))
    assert _rel(res.x, jres.x) <= 1e-12


def _cg2_cfg(m, steps):
    return m.RunConfig(
        fe=m.FEConfig(T_family="CG", T_degree=2, sigma_family="CG",
                      sigma_degree=1),
        time=m.TimeConfig(0.0, 0.1 * steps, 0.1),
        solver=m.SolverConfig(newton_rtol=1e-12, newton_atol=1e-10,
                              cg_rtol=1e-12, cg_max_it=500,
                              linear_operator="stencil",
                              preconditioner="auto",
                              mg_smoother="chebyshev"),
        output=m.OutputConfig(write_every=0, formats=()), dtype="float64")


def test_cg2_plate_through_auto_matches_jax():
    """The configuration of tests/test_grid2.py:173-205, 3 steps."""
    steps = 3
    pj = JP(mesh=jmesh.box_mesh_3d(5, 5, 3, lx=1.0, ly=1.0, lz=0.01),
            config=_cg2_cfg(jc, steps))
    pj.setup()
    counts_j = []
    for _ in range(steps):
        n0, k0 = pj.diagnostics.newton_iters, pj.diagnostics.krylov_iters
        sj = pj.solve_timestep()
        counts_j.append((pj.diagnostics.newton_iters - n0,
                         pj.diagnostics.krylov_iters - k0))
    pt = ThermoViscoProblem(
        mesh=tmesh.box_mesh_3d(5, 5, 3, lx=1.0, ly=1.0, lz=0.01),
        config=_cg2_cfg(tc, steps), device="cpu")
    pt.setup()
    assert pt.config.solver.preconditioner == "mg"
    assert isinstance(pt._mg, Q2MG) and pt._mg.smoother == "line"
    assert pt._grid is None and pt._ell is pt._grid2
    counts_t = []
    for _ in range(steps):
        n0, k0 = pt.diagnostics.newton_iters, pt.diagnostics.krylov_iters
        st = pt.solve_timestep()
        counts_t.append((pt.diagnostics.newton_iters - n0,
                         pt.diagnostics.krylov_iters - k0))
    assert counts_t == counts_j
    for f in ("T", "Tf", "sigma"):
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), f
