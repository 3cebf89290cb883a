"""Degree 2 on the CG-2 lattice operator in the PyTorch port beyond the
stencil path: the matrix-free jvp of the lattice residual (BASELINE config
2, the 2D CG-2 plate with CG-2 sigma, and the 3D plate), the f32 twins of
GridHeatOperator2 and Q2MG under mixed precision, and equilibrium mechanics
with a CG-2 temperature space (the flat coupling), against the JAX package
on the CPU in f64.

Inputs come from the configuration alone and go to both packages. Held:
- 2 steps of dt 0.1 at rtol 1e-12: equal Newton and CG counts in every
  step, T, Tf and sigma within 1e-10 of their max;
- with mechanics, sigma within 1e-9 of its max: the elasticity CG stops at
  1e-2 of its warm start and keeps that start's rounding, and the port
  started one ulp above T_0 moves its own sigma by ~8e-11 of max and its
  elasticity count by one (the witness; the tolerance of
  tests/test_torch_mechanics.py);
- the mirrors of tests/test_multidim_e2e.py:38-49 and :66-71 (the field
  invariants of the 2D CG-2 plate and the CG-2 tet plate) and of
  tests/test_grid2.py:205-229 (the 5x5x3 CG-2 plate in mixed precision
  builds the Q2 twins and converges; T equals the f64 run's at 1e-10);
- JAX's refusals: "mg" (and "auto", which resolves to it) on a CG-2 box
  with grid_native="off" raises ValueError in both packages.
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.grid2 import GridHeatOperator2, Q2MG

STEPS = 2
CG2 = dict(T_family="CG", T_degree=2)
PLATE = lambda m: m.box_mesh_3d(3, 3, 2, 1, 1, 0.01)  # noqa: E731
# name: (mesh, FE choice, solver settings, mechanics)
CASES = {
    "plate2d_sigma_cg2": (lambda m: m.box_mesh_2d(6, 3, 2.0, 1.0),
                          dict(CG2, sigma_family="CG", sigma_degree=2), {},
                          "none"),
    "plate_matrix_free": (PLATE, CG2, {}, "none"),
    "plate_mixed": (PLATE, CG2, dict(linear_operator="stencil",
                                     cg_dtype="float32"), "none"),
    "mechanics": (lambda m: m.box_mesh_3d(3, 3, 2, 1, 1, 0.1), CG2,
                  dict(linear_operator="stencil"), "equilibrium"),
}


def _cfg(m, fe, solver, mechanics="none", steps=STEPS, T_0=None):
    cfg = m.RunConfig(fe=m.FEConfig(**fe),
                      time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                      solver=m.SolverConfig(**solver),
                      output=m.OutputConfig(write_every=0, formats=()),
                      dtype="float64", mechanics=mechanics)
    if T_0 is not None:
        cfg = dataclasses.replace(
            cfg, params=dataclasses.replace(cfg.params, T_0=T_0))
    return cfg


def _run(p, steps=STEPS):
    """`steps` steps of a set-up problem -> (state, per-step (Newton, CG))."""
    counts = []
    for _ in range(steps):
        n0, k0 = p.diagnostics.newton_iters, p.diagnostics.krylov_iters
        st = p.solve_timestep()
        counts.append((p.diagnostics.newton_iters - n0,
                       p.diagnostics.krylov_iters - k0))
    return st, counts


def _port(mk, fe, solver, mechanics="none", steps=STEPS, T_0=None):
    p = TP(mesh=mk(tmesh), config=_cfg(tc, fe, solver, mechanics, steps,
                                       T_0), device="cpu")
    p.setup()
    return (p, *_run(p, steps))


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_configuration_matches_jax(name):
    mk, fe, solver, mechanics = CASES[name]
    pt, st, ct = _port(mk, fe, solver, mechanics)
    assert isinstance(pt._grid2, GridHeatOperator2)
    assert pt.config.solver.preconditioner == "mg"
    if solver.get("cg_dtype") == "float32":
        assert pt._mg is None and isinstance(pt._mg32, Q2MG)
        assert pt._grid2_32.dtype == torch.float32
        assert pt._ell32 is pt._grid2_32
        assert "twins" in pt.setup_seconds
    else:
        assert isinstance(pt._mg, Q2MG) and pt._grid2_32 is None
    pj = JP(mesh=mk(jmesh), config=_cfg(jc, fe, solver, mechanics))
    pj.setup()
    sj, cj = _run(pj)
    assert ct == cj
    for f in ("T", "Tf", "sigma"):
        lim = 1e-9 if (f == "sigma" and mechanics != "none") else 1e-10
        assert _rel(getattr(st, f), getattr(sj, f)) <= lim, f
    if mechanics != "none":
        # the witness: the port started one ulp above T_0
        T_up = float(np.nextafter(pt.params.T_0, np.inf))
        pu, su, cu = _port(mk, fe, solver, mechanics, T_0=T_up)
        assert cu == ct
        moved = _rel(su.sigma, st.sigma)
        assert 1e-12 < moved <= 1e-9, moved


def _check_invariants(prob, st):
    """tests/test_multidim_e2e.py:22-35."""
    p = prob.params
    T, Tf, sig = st.T.numpy(), st.Tf.numpy(), st.sigma.numpy()
    assert np.all(np.isfinite(T)) and np.all(np.isfinite(sig))
    assert T.min() > p.T_ambient and T.max() <= p.T_0 + 0.5
    assert Tf.min() >= T.min() - 1e-9
    np.testing.assert_allclose(sig, np.swapaxes(sig, -1, -2), atol=1e-12)
    np.testing.assert_allclose(st.s_partial.numpy(), 0.0, atol=1e-14)


def test_2d_plate_cg2_invariants():
    """tests/test_multidim_e2e.py:38-49: BASELINE config 2, 5 steps; the
    corner cools fastest."""
    prob, st, _ = _port(lambda m: m.box_mesh_2d(12, 6, 2.0, 1.0),
                        dict(CG2, sigma_family="CG", sigma_degree=2), {},
                        steps=5)
    assert isinstance(prob._grid2, GridHeatOperator2)
    _check_invariants(prob, st)
    T = st.T.numpy()
    x = prob.fs_T.dof_coords
    corner = np.argmin(np.linalg.norm(x, axis=1))
    center = np.argmin(np.linalg.norm(x - [1.0, 0.5], axis=1))
    assert T[corner] < T[center]


def test_3d_plate_tet_cg2_invariants():
    """tests/test_multidim_e2e.py:66-71: the tet plate on the gather path
    (matrix-free CG, SA-AMG)."""
    prob, st, _ = _port(lambda m: m.box_mesh_3d(3, 3, 2, cell_type="tet"),
                        CG2, {})
    assert prob._grid2 is None and prob._amg is not None
    _check_invariants(prob, st)


def test_mixed_precision_5x5x3_plate():
    """tests/test_grid2.py:205-229: f64 Newton over the f32 Q2 twins at
    rtol 1e-12, 2 steps; T equals the f64 run's at 1e-10 (both solve the
    f64 residual to rtol 1e-12)."""
    mk = lambda m: m.box_mesh_3d(5, 5, 3, lx=1.0, ly=1.0, lz=0.01)  # noqa
    solver = dict(newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-12,
                  cg_max_it=500, linear_operator="stencil",
                  preconditioner="mg", mg_smoother="chebyshev")
    pm, sm, _ = _port(mk, CG2, dict(solver, cg_dtype="float32"))
    assert pm._grid2_32 is not None and type(pm._mg32).__name__ == "Q2MG"
    assert bool(torch.isfinite(sm.T).all())
    _, s64, _ = _port(mk, CG2, solver)
    assert _rel(sm.T, s64.T) <= 1e-10


@pytest.mark.parametrize("preconditioner", ["mg", "auto"])
@pytest.mark.parametrize("cg_dtype", ["same", "float32"])
def test_cg2_multigrid_needs_the_lattice_operator(preconditioner, cg_dtype):
    """JAX models/problem.py:320-329, :344-350: Q2MG needs the lattice
    operator, so "mg" (and "auto", which a CG-2 box resolves to "mg")
    with grid_native="off" raises, in both packages."""
    solver = dict(grid_native="off", preconditioner=preconditioner,
                  cg_dtype=cg_dtype)
    for m, kw in ((tmesh, dict(device="cpu")), (jmesh, {})):
        P = TP if m is tmesh else JP
        p = P(mesh=PLATE(m), config=_cfg(tc if m is tmesh else jc, CG2,
                                         solver), **kw)
        with pytest.raises(ValueError, match="lattice-native operator"):
            p.setup()
