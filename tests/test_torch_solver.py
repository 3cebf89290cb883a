"""The PyTorch port's Krylov, Newton and geometric-multigrid solvers
against the JAX package, on the CPU in f64.

pcg and newton_solve must take the same number of iterations as JAX on a
fixed SPD system and a fixed nonlinear residual, and return the same
iterate to 1e-10 relative (the solves stop at rtol 1e-10; the two
libraries sum dot products in different orders). The V-cycle apply of
GeometricMG is held at rtol 1e-10 at 16x16x8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.fem.mesh import box_mesh_3d as jbox
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.solver.krylov import pcg as jpcg
from fem_glass_tempering_tpu.solver.multigrid import GeometricMG as JMG
from fem_glass_tempering_tpu.solver.newton import newton_solve as jnewton
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d as tbox
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat
from fem_glass_tempering_tpu_torch.solver.krylov import pcg as tpcg
from fem_glass_tempering_tpu_torch.solver.multigrid import GeometricMG as TMG
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve as tnewton


def _spd(n=200, seed=0, cond=10.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.logspace(0, np.log10(cond), n)
    A = (Q * ev) @ Q.T
    return 0.5 * (A + A.T), rng.standard_normal(n)


@pytest.mark.parametrize("opts", [
    {},
    {"diag": True},
    {"precond": True},
    {"diag": True, "replace_every": 7},
    {"stall_window": 2, "cond": 1e4},
    {"x0": True, "rtol_r0": 0.1},
])
def test_pcg_matches_jax(opts):
    opts = dict(opts)
    A, b = _spd(cond=opts.pop("cond", 10.0))
    kw = dict(rtol=opts.pop("rtol", 1e-10), max_it=opts.pop("max_it", 500),
              replace_every=opts.pop("replace_every", 0),
              stall_window=opts.pop("stall_window", 0),
              rtol_r0=opts.pop("rtol_r0", 0.0))
    jkw, tkw = dict(kw), dict(kw)
    if opts.pop("diag", False):
        jkw["diag"], tkw["diag"] = jnp.asarray(np.diag(A)), torch.tensor(np.diag(A))
    if opts.pop("precond", False):
        M = np.linalg.inv(A + 0.3 * np.diag(np.diag(A)))
        jkw["precond"] = lambda r: jnp.asarray(M) @ r
        tkw["precond"] = lambda r: torch.tensor(M) @ r
    if opts.pop("x0", False):
        x0 = np.linalg.solve(A, b) + 1e-3 * np.ones(len(b))
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), torch.tensor(x0)
    assert not opts
    jr = jpcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), **jkw)
    tr = tpcg(lambda v: torch.tensor(A) @ v, torch.tensor(b), **tkw)
    assert tr.iters == int(jr.iters)
    assert tr.converged == bool(jr.converged)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jr.x)).max())


def _nonlinear(lib, A, c):
    return lambda x: A @ x + 0.1 * x ** 3 - c


@pytest.mark.parametrize("opts", [
    {},
    {"diag": True, "inc_forcing": 0.05},
    {"matvec": True, "noise": 1e-30},
    {"cg_cast": True},
])
def test_newton_matches_jax(opts):
    A, c = _spd(seed=1)
    c = 5 * c
    x0 = np.zeros(len(c))
    kw = dict(rtol=1e-10, atol=1e-12, cg_rtol=1e-10, cg_max_it=400)
    jkw, tkw = dict(kw), dict(kw)
    jA, tA = jnp.asarray(A), torch.tensor(A)
    if opts.get("diag"):
        jkw["jac_diag_fn"] = lambda x: jnp.diag(jA) + 0.3 * x ** 2
        tkw["jac_diag_fn"] = lambda x: torch.diag(tA) + 0.3 * x ** 2
        jkw["inc_forcing"] = tkw["inc_forcing"] = opts["inc_forcing"]
    if opts.get("matvec"):
        jkw["matvec_fn"] = lambda x: (lambda v: jA @ v + 0.3 * x ** 2 * v)
        tkw["matvec_fn"] = lambda x: (lambda v: tA @ v + 0.3 * x ** 2 * v)
        jkw["noise_fn"] = lambda x: opts["noise"]
        tkw["noise_fn"] = lambda x: torch.tensor(opts["noise"],
                                                 dtype=torch.float64)
    if opts.get("cg_cast"):
        # the inner operator must come in the cast dtype
        jkw["cg_cast"], tkw["cg_cast"] = jnp.float32, torch.float32
        jkw["rtol"] = tkw["rtol"] = 1e-8
        jA32, tA32 = jA.astype(jnp.float32), tA.float()
        jkw["matvec_fn"] = lambda x: (
            lambda v: jA32 @ v + 0.3 * x.astype(jnp.float32) ** 2 * v)
        tkw["matvec_fn"] = lambda x: (
            lambda v: tA32 @ v + 0.3 * x.float() ** 2 * v)
    jr = jnewton(_nonlinear(jnp, jA, jnp.asarray(c)), jnp.asarray(x0), **jkw)
    tr = tnewton(_nonlinear(torch, tA, torch.tensor(c)), torch.tensor(x0),
                 **tkw)
    assert bool(jr.converged) and tr.converged
    assert tr.iters == int(jr.iters)
    assert tr.krylov_iters == int(jr.krylov_iters)
    rtol = 1e-6 if opts.get("cg_cast") else 1e-10
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=rtol)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_matches_jax(smoother):
    dims = (16, 16, 8)
    dt = 0.1

    def jmake(m):
        return JHeat(JFS(m, "CG", 1), JParams(), dt)

    def tmake(m):
        return THeat(TFS(m, "CG", 1), ModelParams(), dt, device="cpu")

    jmg = JMG(jbox(*dims, 1.0, 1.0, 0.01), jmake, smoother=smoother)
    tmg = TMG(tbox(*dims, 1.0, 1.0, 0.01), tmake, smoother=smoother)
    assert [lv.fine_dims for lv in jmg.levels] == \
        [lv.fine_dims for lv in tmg.levels]
    np.testing.assert_array_equal(tmg.coarse_inv.numpy(),
                                  np.asarray(jmg.coarse_inv))
    jmg.freeze_omegas(None, dt)
    tmg.freeze_omegas(None, dt)
    assert jmg._frozen_rhos == tmg._frozen_rhos
    rng = np.random.default_rng(4)
    n = jmg.levels[0].op.n_dofs
    T = 700 + 50 * rng.random(n)
    r = rng.standard_normal(n)
    jpc = jmg.preconditioner(jmg.linearization_states(jnp.asarray(T)), dt)
    tpc = tmg.preconditioner(tmg.linearization_states(torch.tensor(T)), dt)
    z_j = np.asarray(jax.jit(jpc)(jnp.asarray(r)))
    z_t = tpc(torch.tensor(r)).numpy()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-10,
                               atol=1e-10 * np.abs(z_j).max())


def test_vcycle_power_iteration_fallback_matches_jax():
    """Without freeze_omegas the smoother bounds come from a power
    iteration on each level (8x8x4, two levels)."""
    dt = 0.1
    jmg = JMG(jbox(8, 8, 4, 1.0, 1.0, 0.01),
              lambda m: JHeat(JFS(m, "CG", 1), JParams(), dt))
    tmg = TMG(tbox(8, 8, 4, 1.0, 1.0, 0.01),
              lambda m: THeat(TFS(m, "CG", 1), ModelParams(), dt,
                              device="cpu"))
    n = jmg.levels[0].op.n_dofs
    T = np.full(n, 750.0)
    r = np.random.default_rng(5).standard_normal(n)
    z_j = np.asarray(jmg.preconditioner(
        jmg.linearization_states(jnp.asarray(T)), dt)(jnp.asarray(r)))
    z_t = tmg.preconditioner(
        tmg.linearization_states(torch.tensor(T)), dt)(torch.tensor(r))
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-9,
                               atol=1e-9 * np.abs(z_j).max())
