"""Kernel K1 (the fused T-space material chain) and the viscoelastic
engine of the PyTorch port against the JAX package, on the CPU in f64.

The port's wrapper takes its plain PyTorch version for CPU tensors; it is
held against the JAX reference and the Pallas kernel run in interpret
mode. Tolerance: rtol 1e-12, with an absolute floor of 1e-12 times the
field's largest magnitude for fields that are differences of nearly equal
terms (xi, strains, stresses), where a last-bit difference in exp becomes
a larger relative one; see _RELAXED for the one looser bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.fem.mesh import box_mesh_3d as jbox
from fem_glass_tempering_tpu.models.viscoelastic import (
    LAMBDA_M_N,
    M_N,
    ViscoelasticEngine as JEngine,
    ViscoState as JState,
)
from fem_glass_tempering_tpu.ops.pallas_kernels import (
    material_tspace_pallas,
    material_tspace_reference,
)
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.convert import state_from_numpy, state_to_numpy
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d as tbox
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine as TEngine,
)
from fem_glass_tempering_tpu_torch.ops.cuda_kernels import material_tspace

P = ModelParams()


def _close(a, b, what, rtol=1e-12, scale=None):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = b if scale is None else np.asarray(scale)
    atol = rtol * max(float(np.abs(scale).max()), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def test_material_tspace_plain_matches_jax_and_pallas():
    rng = np.random.default_rng(0)
    n = 1000
    T = 700.0 + 100 * rng.random(n)
    T_prev = T + rng.normal(0, 5, n)
    Tfp = 750.0 + 50 * rng.random((n, 6))
    kw = dict(dt=0.1, H_over_Rg=P.H / P.Rg, Tb=P.Tb)
    jkw = dict(kw, m_n=jnp.asarray(M_N), lambda_m_n=jnp.asarray(LAMBDA_M_N))
    ref = material_tspace_reference(jnp.asarray(T), jnp.asarray(T_prev),
                                    jnp.asarray(Tfp), **jkw)
    pal = material_tspace_pallas(jnp.asarray(T), jnp.asarray(T_prev),
                                 jnp.asarray(Tfp), interpret=True, **jkw)
    out = material_tspace(torch.tensor(T), torch.tensor(T_prev),
                          torch.tensor(Tfp), m_n=M_N, lambda_m_n=LAMBDA_M_N,
                          **kw)
    assert material_tspace.launches == 0          # CPU: plain version
    for name, o, r, p in zip(("phi", "Tf_partial", "Tf", "xi"), out, ref, pal):
        assert o.dtype == torch.float64
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=1e-12,
                                   err_msg=name)


def test_material_tspace_rejects_bad_inputs():
    T = torch.full((4,), 700.0)
    kw = dict(dt=0.1, H_over_Rg=P.H / P.Rg, Tb=P.Tb, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        material_tspace(T.to("meta"), T.to("meta"),
                        torch.empty((4, 6), device="meta"), **kw)


# trapezoid xi: the increment factor (1 - e^{-y})/y just above its 1e-8
# series cutoff loses up to eps/1e-8 ~ 2.2e-8 relative when exp differs by
# one ulp between XLA and PyTorch; the fields downstream of it are held to
# 1e-7 of their largest magnitude
_RELAXED = ("s_partial", "sigma_partial", "sigma")

_ENGINE_CASES = [(mode, shift, xi, mech)
                 for mode in ("reference", "corrected")
                 for shift in ("eq5", "eq25")
                 for xi in ("reference", "trapezoid")
                 for mech in (False,)] + [("corrected", "eq5", "reference",
                                           True)]


def _mech(lib):
    """A fixed linear stand-in for the equilibrium-mechanics hook:
    eps(du) = 0.4 * scalar_th * I at the sigma points, du = scalar_th."""
    def mech(state, xi, scalar_th):
        d = state.sigma.shape[-1]
        eye = lib.eye(d, dtype=scalar_th.dtype)
        return 0.4 * scalar_th[:, None, None] * eye, \
            lib.stack([scalar_th] * d, -1)
    return mech


@pytest.mark.parametrize("mode,shift,xi_formula,mech", _ENGINE_CASES)
def test_material_step_matches_jax(mode, shift, xi_formula, mech):
    rng = np.random.default_rng(1)
    jm, tm = jbox(8, 8, 4, 1.0, 1.0, 0.01), tbox(8, 8, 4, 1.0, 1.0, 0.01)
    kw = dict(physics_mode=mode, shift_function=shift, xi_formula=xi_formula)
    je = JEngine(JFS(jm, "CG", 1), JFS(jm, "CG", 1, value_shape=(3, 3)),
                 JParams(), 0.1, dtype=jnp.float64, **kw)
    te = TEngine(TFS(tm, "CG", 1), TFS(tm, "CG", 1, value_shape=(3, 3)),
                 ModelParams(), 0.1, dtype=torch.float64, device="cpu", **kw)
    n = je.fs_T.n_scalar_dofs
    arrays = {
        "t": np.asarray(0.3),
        "T": 600 + 200 * rng.random(n), "T_prev": 600 + 200 * rng.random(n),
        "Tf": 600 + 200 * rng.random(n), "Tf_prev": 600 + 200 * rng.random(n),
        "Tf_partial": 600 + 200 * rng.random((n, 6)),
        "phi": rng.random(n), "xi": rng.random(n),
    }
    for f in ("thermal_strain", "total_strain", "deviatoric_strain", "sigma"):
        arrays[f] = 1e-3 * rng.standard_normal((n, 3, 3))
    for f in ("s_tilde", "sigma_tilde", "s_partial", "sigma_partial"):
        arrays[f] = 1e-3 * rng.standard_normal((n, 6, 3, 3))
    arrays["du"] = 1e-3 * rng.standard_normal((n, 3))
    T_new = 600 + 200 * rng.random(n)
    jst = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    jout = je.material_step(jst, jnp.asarray(T_new),
                            mech=_mech(jnp) if mech else None)
    tout = te.material_step(tst, torch.tensor(T_new),
                            mech=_mech(torch) if mech else None)
    got = state_to_numpy(tout)
    ref = {f: np.asarray(v) for f, v in jout._asdict().items()}
    for f, v in ref.items():
        rtol = 1e-12
        if xi_formula == "trapezoid" and f in _RELAXED:
            rtol = 1e-7
        # the deviator of an isotropic strain is rounding noise: scale it
        # by the strain it is taken from
        scale = ref["total_strain"] if f == "deviatoric_strain" else v
        _close(got[f], v, f, rtol=rtol, scale=scale)


def test_init_state_matches_jax():
    jm, tm = jbox(4, 3, 2, 1.0, 1.0, 0.01), tbox(4, 3, 2, 1.0, 1.0, 0.01)
    je = JEngine(JFS(jm, "CG", 1), JFS(jm, "CG", 1, value_shape=(3, 3)),
                 JParams(), 0.1, dtype=jnp.float64)
    te = TEngine(TFS(tm, "CG", 1), TFS(tm, "CG", 1, value_shape=(3, 3)),
                 ModelParams(), 0.1, device="cpu")
    got = state_to_numpy(te.init_state())
    for f, v in je.init_state()._asdict().items():
        assert np.array_equal(got[f], np.asarray(v)), f
