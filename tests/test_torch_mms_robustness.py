"""Mirrors of tests/test_mms_convergence.py and tests/test_robustness.py on
the port, on the CPU.

MMS: steady -Laplace(u) = f with homogeneous Dirichlet BCs through one
huge implicit step of the port's HeatOperator, u_exact = prod sin(pi x);
the L2 error converges at order p + 1 (the JAX test's cases, sizes and
bars, each case under 5 s).

Robustness: SIPG at degree 2 converges to the CG-2 solution (JAX's
sizes); two runs of the default configuration give equal bits (2 steps,
cut from the JAX test's 20); f32 against f64 on the default
configuration at the JAX test's 5e-2 K bar, cut from its 50 steps (slow
tier there) to 5, to keep these CPU mirrors short.
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

NOFLUX = dict(epsilon=0.0, htc=0.0, sigma=0.0, alpha=1.0)


def _solve_mms(mesh, family, degree):
    fs = FunctionSpace(mesh, family, degree)
    u_exact_dofs = np.prod(np.sin(np.pi * fs.dof_coords), axis=1)
    p = dataclasses.replace(ModelParams(), **NOFLUX)
    op = HeatOperator(fs, p, dt=1e8, device="cpu",
                      bc_dofs=fs.boundary_scalar_dofs(), bc_value=0.0,
                      source=mesh.gdim * np.pi**2 * u_exact_dofs)
    T0 = torch.zeros(fs.n_scalar_dofs, dtype=torch.float64)
    res = newton_solve(lambda T: op.residual(T, T0), T0,
                       jac_diag_fn=op.jacobian_diag, rtol=1e-13,
                       cg_rtol=1e-13, cg_max_it=4000)
    assert res.converged
    # L2 error by high-order quadrature
    cg = build_cell_geometry(mesh, fs, quad_degree=2 * degree + 3)
    u_q = np.einsum("ql,cl->cq", cg.phi, res.x.numpy()[fs.dofmap])
    u_ex_q = np.prod(np.sin(np.pi * cg.qpoints_phys), axis=-1)
    return np.sqrt(np.sum(cg.qweights * (u_q - u_ex_q) ** 2))


def _order(errs, hs):
    return np.polyfit(np.log(hs), np.log(errs), 1)[0]


@pytest.mark.parametrize("family,degree,expected", [
    ("CG", 1, 2.0), ("CG", 2, 3.0), ("CG", 3, 4.0),
])
def test_convergence_1d(family, degree, expected):
    ns = [8, 16, 32]
    errs = [_solve_mms(tmesh.interval_mesh(n), family, degree) for n in ns]
    order = _order(errs, [1.0 / n for n in ns])
    assert order > expected - 0.3, (order, errs)


@pytest.mark.parametrize("cell,family,degree,expected", [
    ("quad", "CG", 1, 2.0),
    ("quad", "CG", 2, 3.0),
    ("triangle", "CG", 1, 2.0),
    ("triangle", "CG", 2, 3.0),
])
def test_convergence_2d(cell, family, degree, expected):
    ns = [4, 8, 16]
    errs = [_solve_mms(tmesh.box_mesh_2d(n, n, cell_type=cell), family,
                       degree) for n in ns]
    order = _order(errs, [1.0 / n for n in ns])
    assert order > expected - 0.35, (order, errs)


def test_dg2_sipg_consistent_with_cg2():
    """SIPG at degree 2 (penalty 5.0 as in the reference) converges to the
    CG-2 solution under refinement."""
    p = ModelParams()
    errs = {}
    for n in (32, 64):
        m = tmesh.interval_mesh(n, 0.0, 50.0)
        sols = {}
        for fam in ("CG", "DG"):
            fs = FunctionSpace(m, fam, 2)
            op = HeatOperator(fs, p, dt=0.1, device="cpu")
            T_prev = torch.full((fs.n_scalar_dofs,), p.T_0,
                                dtype=torch.float64)
            res = newton_solve(lambda T: op.residual(T, T_prev), T_prev,
                               jac_diag_fn=op.jacobian_diag)
            assert res.converged, fam
            sols[fam] = res.x.numpy()[fs.dofmap].mean(axis=1)
        errs[n] = np.abs(sols["CG"] - sols["DG"]).max()
    assert errs[64] < errs[32] / 2.0, errs


def _default_cfg(steps, dtype="float64"):
    return tc.RunConfig(time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
                        output=tc.OutputConfig(write_every=0, formats=()),
                        dtype=dtype)


def test_run_determinism_bitwise():
    """Two identical runs of the default configuration give equal bits
    (the scatter-adds are grouped and sequential on the CPU)."""
    results = []
    for _ in range(2):
        prob = TP(config=_default_cfg(2), device="cpu")
        prob.setup()
        st = prob.solve()
        results.append((st.T, st.sigma, st.Tf_partial))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_f32_error_tracking():
    """f32 against f64 on the default configuration: T agrees to 5e-2 K
    out of ~800 K (5 steps here; 50 in the JAX test's slow tier)."""
    sols = {}
    for dtype, rtol in (("float64", 1e-12), ("float32", 1e-5)):
        cfg = _default_cfg(5, dtype)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, newton_rtol=rtol,
            newton_atol=1e-6 if dtype == "float32" else 1e-10,
            cg_rtol=rtol))
        prob = TP(config=cfg, device="cpu")
        prob.setup()
        st = prob.solve()
        assert st.T.dtype == getattr(torch, dtype)
        sols[dtype] = st.T.double().numpy()
    err = np.abs(sols["float32"] - sols["float64"]).max()
    assert err < 5e-2, err
