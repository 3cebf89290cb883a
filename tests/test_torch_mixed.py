"""Mixed precision in the PyTorch port: cg_dtype="float32" under an f64
Newton loop (an f32 inner CG on f32 twins of the Krylov operator and the
preconditioner, with the f64 residual and incremental test), on the CPU.

Tolerances mirror the JAX package's test_multigrid.py:
- CG-1 8x8x4 plate, geometric MG: mixed equals f64 at rtol 1e-12;
- DG-1 8x8x4 plate, column-smoothed p-multigrid: mixed equals f64 at
  rtol 1e-10;
- the port's mixed runs equal the JAX package's at rtol 1e-10, with CG
  counts within 10%;
- DG-1 16x16x8 at rtol 1e-12: converges without spinning, and lands within
  the mixed-precision floor of the f64 solution (5e-3 K).
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
from fem_glass_tempering_tpu_torch.solver.multigrid import DGMultigrid


def _cfg(m, fam, cg_dtype, steps=2, **solver):
    kw = dict(preconditioner="mg", linear_operator="stencil",
              cg_dtype=cg_dtype)
    kw.update(solver)
    return m.RunConfig(fe=m.FEConfig(T_family=fam, T_degree=1),
                       time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                       solver=m.SolverConfig(**kw),
                       output=m.OutputConfig(write_every=0, formats=()),
                       dtype="float64")


def _mesh(mod, dims):
    if len(dims) == 2:
        return mod.box_mesh_2d(*dims, 1.0, 1.0)
    return mod.box_mesh_3d(*dims, 1.0, 1.0, 0.01)


def _port(dims, fam, cg_dtype, **solver):
    pt = TP(mesh=_mesh(tmesh, dims), config=_cfg(tc, fam, cg_dtype, **solver),
            device="cpu")
    pt.setup()
    st = pt.solve()
    return pt, st


def _jax(dims, fam, cg_dtype, **solver):
    pj = JP(mesh=_mesh(jmesh, dims), config=_cfg(jc, fam, cg_dtype, **solver))
    pj.setup()
    sj = pj.solve()
    return pj, sj


def test_cg1_mixed_equals_f64():
    kw = dict(newton_rtol=1e-12, newton_atol=1e-12, cg_rtol=1e-12,
              cg_max_it=20000, mg_smoother="chebyshev")
    res = {}
    for cgd in ("same", "float32"):
        pt, st = _port((8, 8, 4), "CG", cgd, **kw)
        res[cgd] = st.T.numpy()
    assert pt._mixed and pt._mg is None and pt._mg32.dtype == torch.float32
    assert pt._ell32.op.dtype == torch.float32
    np.testing.assert_allclose(res["float32"], res["same"], rtol=1e-12)


def test_dg_mixed_equals_f64():
    kw = dict(newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-10,
              cg_max_it=20000)
    res = {}
    for cgd in ("same", "float32"):
        pt, st = _port((8, 8, 4), "DG", cgd, **kw)
        res[cgd] = st.T.numpy()
    # mixed precision builds the f32 p-multigrid alone, and its block
    # stencil is the inner CG's operator
    assert pt._dg_mg is None and isinstance(pt._dg_mg32, DGMultigrid)
    assert pt._dg_mg32.smoother == "column"
    assert pt._ell32 is pt._dg_mg32.stencil
    np.testing.assert_allclose(res["float32"], res["same"], rtol=1e-10)


@pytest.mark.parametrize("dims,fam,solver", [
    ((8, 8, 4), "DG", dict(preconditioner="auto")),
    ((4, 4, 2), "DG", dict(linear_operator="matrix_free")),
    ((6, 6), "CG", dict(preconditioner="amg", linear_operator="matrix_free")),
    ((6, 6), "CG", dict(preconditioner="jacobi")),
])
def test_mixed_matches_jax(dims, fam, solver):
    """The same mixed-precision runs in both packages: T and Tf at rtol
    1e-10, Newton counts equal, CG counts within 10%."""
    pj, sj = _jax(dims, fam, "float32", **solver)
    pt, st = _port(dims, fam, "float32", **solver)
    assert pt._mixed
    for f in ("T", "Tf"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-10, err_msg=f)
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    kj, kt = pj.diagnostics.krylov_iters, pt.diagnostics.krylov_iters
    assert abs(kt - kj) <= 0.1 * kj, (kt, kj)


def test_dg_mixed_floor_16x16x8():
    """DG-1 mixed precision at rtol 1e-12 on the 50:1 plate: the f32 SIPG
    matvec floors each inner solve near eps32 * kappa, the f64 Newton
    loop refines; the run converges without spinning and lands within
    the floor of the f64 solution."""
    kw = dict(newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-12,
              cg_max_it=2000)
    res = {}
    for cgd in ("same", "float32"):
        pt, st = _port((16, 16, 8), "DG", cgd, **kw)
        d = pt.diagnostics
        res[cgd] = (st.T.numpy(), d.newton_iters, d.krylov_iters)
    T32, newton32, cg32 = res["float32"]
    assert newton32 <= 26, f"Newton spun: {newton32} iterations for 2 steps"
    assert cg32 <= 4000, f"inner CG burned {cg32} iterations"
    np.testing.assert_allclose(T32, res["same"][0], atol=5e-3)


def test_f32_run_is_not_mixed():
    """cg_dtype='float32' in an f32 run changes nothing: no twins."""
    cfg = dataclasses.replace(
        _cfg(tc, "CG", "float32", newton_rtol=1e-5, newton_atol=1e-6,
             cg_rtol=1e-5), dtype="float32")
    pt = TP(mesh=_mesh(tmesh, (6, 6)), config=cfg, device="cpu")
    pt.setup()
    assert not pt._mixed and pt._heat32 is None and pt._mg is not None
    _, ok, _, _ = pt.multi_step(pt.state, 1)
    assert ok
