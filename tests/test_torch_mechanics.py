"""Equilibrium mechanics in the PyTorch port (models/mechanics.py and the
wiring of models/problem.py) against the JAX package, on the CPU in f64.

`ThermoViscoProblem(mechanics="equilibrium")` for a few steps on the three
couplings the problem picks:
- a CG-1 8x8x4 plate: the grid coupling with the vector V-cycle, with
  jac_every 1 and with "auto" at the slice's loose tolerances (= 5: the
  V-cycle lagged over the chunk), corrected physics, trapezoid xi;
- a DG-1 8x8x4 plate through "auto": the grid coupling behind the DG
  adapter (T -> sigma cross-eval);
- a CG-1 box with grid_native="off": the flat gather coupling, Jacobi-CG.
T and Tf at rtol 1e-9, sigma and du within 1e-9 of their max (1e-7 with
the trapezoid xi: see _compare), and Newton, heat-CG and per-step
elasticity-CG counts equal. The JAX
counts of the elasticity solves are read through jax.debug.callback from a
wrapper around the JAX problem's coupling (the JAX package is not edited).
One case starts both from a JAX state that holds a displacement
(convert.state_from_numpy), so the warm start is compared too. Then the
warm start and the increment tolerance of tests/test_mechanics.py:182-267
on the port, and the cross-eval of the DG adapter against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu.models.viscoelastic import (
    ViscoelasticEngine as JEngine,
)
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.convert import state_from_numpy
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.models.mechanics import (
    DGNodeMechAdapter,
    GridMechanicsCoupling,
    MechanicsCoupling,
)
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine,
)

F64 = torch.float64
LOOSE = dict(newton_rtol=1e-5, newton_atol=1e-6, cg_rtol=1e-5,
             cg_max_it=2000, linear_operator="stencil", preconditioner="mg",
             mg_smoother="chebyshev", jac_every="auto")
# name: (mesh, T family, solver, xi formula, steps, coupling)
CASES = {
    "grid": ((8, 8, 4, 1.0, 1.0, 0.01), "CG", dict(linear_operator="stencil"),
             "trapezoid", 3, GridMechanicsCoupling),
    "grid_lagged": ((8, 8, 4, 1.0, 1.0, 0.01), "CG", LOOSE, "trapezoid", 4,
                    GridMechanicsCoupling),
    "dg_adapter": ((8, 8, 4, 1.0, 1.0, 0.01), "DG",
                   dict(preconditioner="auto", linear_operator="stencil"),
                   "trapezoid", 3, DGNodeMechAdapter),
    "flat": ((4, 4, 4, 1.0, 1.0, 1.0), "CG",
             dict(grid_native="off", preconditioner="jacobi"), "reference",
             3, MechanicsCoupling),
}


def _cfg(mod, name, steps=None):
    dims, fam, solver, xi, n, _ = CASES[name]
    n = steps or n
    return mod.RunConfig(
        fe=mod.FEConfig(T_family=fam, T_degree=1),
        time=mod.TimeConfig(0.0, n * 0.1, 0.1),
        solver=mod.SolverConfig(**solver),
        output=mod.OutputConfig(write_every=0, formats=()),
        physics_mode="corrected", mechanics="equilibrium", xi_formula=xi)


def _jax_problem(name):
    """The JAX problem, its coupling wrapped to log the elasticity CG count
    of every call (the step functions rebuilt around the wrapper)."""
    dims = CASES[name][0]
    p = JP(mesh=jmesh.box_mesh_3d(*dims), config=_cfg(jc, name))
    p.setup()
    inner = p._mech
    coupling = getattr(inner, "inner", inner)
    log = []

    class Logged:
        def build_precond(self, state):
            return inner.build_precond(state)

        def __call__(self, *args, **kw):
            out = inner(*args, **kw)
            jax.debug.callback(lambda it: log.append(int(it)),
                               coupling.last_cg_iters, ordered=True)
            return out

    p._mech = Logged()
    p._build_step()
    return p, log


def _port_problem(name):
    dims = CASES[name][0]
    p = TP(mesh=tmesh.box_mesh_3d(*dims), config=_cfg(tc, name),
           device="cpu")
    p.setup()
    assert type(p._mech) is CASES[name][5]
    return p


def _jax_run(p, log, state, n):
    log.clear()
    st, ok, ni, ki = p._multi_step_jit(state, n)
    jax.block_until_ready(st.T)
    assert bool(ok)
    return st, int(ni), int(ki), list(log)


def _compare(ts, js, what, xi):
    """T and Tf at rtol 1e-9; sigma and du within 1e-9 of their max, or
    1e-7 with the trapezoid xi, whose relax factor (1 - e^-y)/y amplifies
    a one-ulp exp difference between the libraries (the tolerance
    tests/test_torch_material.py holds those fields to; measured here
    3e-9 to 7e-9 of max|sigma|)."""
    tol = 1e-7 if xi == "trapezoid" else 1e-9
    for f in ("T", "Tf", "sigma", "du"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        scale = float(np.abs(b).max())
        if f in ("T", "Tf"):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * scale,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=0.0, atol=tol * scale,
                                       err_msg=f"{what}: {f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_problem_matches_jax(name):
    jp, log = _jax_problem(name)
    tp = _port_problem(name)
    n = CASES[name][4]
    js, jn, jk, jm = _jax_run(jp, log, jp.engine.init_state(), n)
    if name == "flat":
        # through solve(): the elasticity CG total in the diagnostics
        ts = tp.solve()
        d = tp.diagnostics
        tn, tk, tm = d.newton_iters, d.krylov_iters, tp.last_mech_iters
        assert d.mech_krylov_iters == sum(jm)
    else:
        ts, ok, tn, tk = tp.multi_step(tp.state, n)
        tm = tp.last_mech_iters
        assert ok
    assert (tn, tk, tm) == (jn, jk, jm) and len(tm) == n and min(tm) > 0
    _compare(ts, js, name, CASES[name][3])
    assert float(np.abs(np.asarray(js.du)).max()) > 0


def test_steps_from_a_jax_state_with_a_displacement():
    """Two JAX steps, then two more on each side from that JAX state: the
    port's elasticity CG starts warm from the JAX displacement."""
    jp, log = _jax_problem("grid")
    tp = _port_problem("grid")
    js0, *_ = _jax_run(jp, log, jp.engine.init_state(), 2)
    start = state_from_numpy(
        {k: np.asarray(v) for k, v in js0._asdict().items()}, device="cpu")
    assert float(start.du.abs().max()) > 0
    js, jn, jk, jm = _jax_run(jp, log, js0, 2)
    ts, ok, tn, tk = tp.multi_step(start, 2)
    assert ok and (tn, tk, tp.last_mech_iters) == (jn, jk, jm)
    _compare(ts, js, "from a JAX state", "trapezoid")


def test_solve_timestep_counts_the_elasticity_solve():
    tp = _port_problem("grid")
    tp.solve_timestep()
    assert len(tp.last_mech_iters) == 1
    assert tp.diagnostics.mech_krylov_iters == tp.last_mech_iters[0] > 0


def test_dg_adapter_cross_eval_matches_jax():
    """The adapter's T -> sigma map is the engine's cross-eval: each node
    takes the value of its owner cell (the highest cell index)."""
    tm, jm = tmesh.box_mesh_3d(3, 2, 2), jmesh.box_mesh_3d(3, 2, 2)
    te = ViscoelasticEngine(TFS(tm, "DG", 1), TFS(tm, "CG", 1,
                                                  value_shape=(3, 3)),
                            tc.ModelParams(), 0.1, dtype=F64, device="cpu")
    je = JEngine(JFS(jm, "DG", 1), JFS(jm, "CG", 1, value_shape=(3, 3)),
                 jc.ModelParams(), 0.1, dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(te.fs_T.n_scalar_dofs)
    got = te.to_sigma.eval("T", torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(je.to_sigma.eval(
        "T", jnp.asarray(x))))
    # the highest cell index owns every vertex
    cells = te.fs_T.mesh.cells
    owner = np.zeros(tm.n_nodes, dtype=int)
    for c in range(len(cells)):
        owner[cells[c]] = c
    want = np.array([x[owner[v] * 8 + list(cells[owner[v]]).index(v)]
                     for v in range(tm.n_nodes)])
    np.testing.assert_array_equal(got, want)


def _coupling_inputs(inc_rtol=0.0, cg_rtol=1e-10):
    mesh = tmesh.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01)
    fs_T = TFS(mesh, "CG", 1)
    fs_S = TFS(mesh, "CG", 1, value_shape=(3, 3))
    eng = ViscoelasticEngine(fs_T, fs_S, tc.ModelParams(), 0.1, dtype=F64,
                             xi_formula="trapezoid", device="cpu")
    n = fs_T.n_scalar_dofs
    return eng, fs_S, n


def test_warm_start_cuts_iterations_and_matches():
    """tests/test_mechanics.py:182-223 on the port (with the trapezoid xi,
    whose frozen moduli give the V-cycle its dense coarse solve): a warm
    start from the previous displacement takes fewer MG-CG iterations to
    the same solution."""
    eng, fs_S, n = _coupling_inputs()
    mech = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-10,
                                 cg_max_it=2000)
    state = eng.init_state()._replace(du=None)
    rng = np.random.default_rng(3)
    xi = torch.tensor(0.05 + 0.01 * rng.random(n))
    th = torch.tensor(-5e-5 * (1.0 + 0.3 * rng.random(n)))
    _, du = mech(state, xi, th)
    eps_ref, _ = mech(state, xi * 1.02, th * 1.01)
    ref_iters = mech.last_cg_iters
    eps_warm, du2 = mech(state._replace(du=du), xi * 1.02, th * 1.01)
    assert mech.last_cg_iters < ref_iters
    torch.testing.assert_close(eps_warm, eps_ref, rtol=0.0, atol=1e-12)
    assert du2.shape == (n, 3)


def test_increment_tolerance_cuts_iterations_bounded_error():
    """tests/test_mechanics.py:226-267 on the port: inc_rtol relaxes a
    warm solve to a fixed cut of its start residual, with the error a
    fraction of the step's change."""
    eng, fs_S, n = _coupling_inputs()
    tight = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-12,
                                  cg_max_it=2000)
    sched = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-12,
                                  cg_max_it=2000, inc_rtol=1e-2)
    state = eng.init_state()._replace(du=None)
    rng = np.random.default_rng(7)
    xi = torch.tensor(0.05 + 0.01 * rng.random(n))
    th = torch.tensor(-5e-5 * (1.0 + 0.3 * rng.random(n)))
    eps1, du1 = tight(state, xi, th)
    state2 = state._replace(du=du1)
    eps_t, _ = tight(state2, xi * 1.02, th * 1.01)
    eps_s, _ = sched(state2, xi * 1.02, th * 1.01)
    assert sched.last_cg_iters < tight.last_cg_iters
    change = float((eps_t - eps1).abs().max())
    err = float((eps_s - eps_t).abs().max())
    assert err <= 0.5 * change
    assert err <= 1e-2 * float(eps_t.abs().max())


def test_mechanics_tolerances_follow_the_jax_rules():
    """mech_rtol = min(cg_rtol, 1e-8), at least 2e-6 in f32;
    mech_inc_rtol None -> 1e-2; at least 2000 iterations."""
    for dtype, cg_rtol, inc, want in (("float64", 1e-12, None, (1e-12, 1e-2)),
                                      ("float64", 1e-6, 0.1, (1e-8, 0.1)),
                                      ("float32", 1e-5, 0.0, (2e-6, 0.0))):
        cfg = dataclasses.replace(
            _cfg(tc, "grid"), dtype=dtype,
            solver=tc.SolverConfig(cg_rtol=cg_rtol, cg_max_it=50,
                                   mech_inc_rtol=inc))
        p = TP(mesh=tmesh.box_mesh_3d(4, 4, 2, 1.0, 1.0, 0.01), config=cfg,
               device="cpu")
        p.setup()
        assert (p._mech.cg_rtol, p._mech.inc_rtol) == want
        assert p._mech.cg_max_it == 2000
        assert p.setup_seconds["mechanics"] > 0
