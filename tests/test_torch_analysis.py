"""The PyTorch port's temper analysis against the JAX package's.

Mirrors tests/test_analysis.py on one module-scoped port run (the default
workload, 50 steps, on the CPU), and holds the port's through-thickness
profile, temper metrics and stress L2 norm to JAX's functions on the same
arrays at 1e-12 (relative to the largest value), on that run's fields and
on random fields over a CG-1 hex plate and a DG-1 quad plate. The port's
functions take tensors; JAX's take numpy arrays.
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.fem import functionspace as jfs
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.models import analysis as jan
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import functionspace as tfs
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.models import analysis as tan
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP


@pytest.fixture(scope="module")
def run():
    cfg = tc.RunConfig(time=tc.TimeConfig(0.0, 50 * 0.1, 0.1),
                       output=tc.OutputConfig(write_every=0, formats=()))
    prob = TP(config=cfg, device="cpu")
    prob.setup()
    return prob, prob.solve()


def test_profile_extraction_and_metrics(run):
    prob, st = run
    prof = tan.through_thickness_profile(prob.fs_sigma, st.sigma, axis=0,
                                         T_fs=prob.fs_T, T=st.T)
    assert prof.coordinate[0] == 0.0 and prof.coordinate[-1] == 50.0
    assert np.all(np.diff(prof.coordinate) > 0)
    assert prof.temperature is not None
    # surfaces are cooler than the core
    assert prof.temperature[0] < prof.temperature[len(prof.temperature) // 2]
    m = tan.temper_metrics(prof)
    assert m["thickness"] == 50.0
    assert np.isfinite(m["surface_compression"])
    # symmetric slab: symmetric up to the last-cell-wins asymmetry of the
    # DG -> CG interpolation (~1e-4 relative, tests/test_analysis.py:40-45)
    scale = np.abs(prof.stress).max()
    np.testing.assert_allclose(prof.stress, prof.stress[::-1],
                               atol=2e-3 * scale)


def test_stress_l2_norm_positive(run):
    prob, st = run
    assert tan.stress_l2_norm(prob.fs_sigma, st.sigma) > 0
    assert tan.stress_l2_norm(prob.fs_sigma, torch.zeros_like(st.sigma)) == 0.0


def _close(a, b, what):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= 1e-12 * max(np.abs(a).max(), 1e-300), what


def _hold_to_jax(jf_sig, tf_sig, sigma, axis, jf_T=None, tf_T=None, T=None):
    kw = dict(T_fs=jf_T, T=T) if T is not None else {}
    tkw = dict(T_fs=tf_T, T=torch.tensor(T)) if T is not None else {}
    pj = jan.through_thickness_profile(jf_sig, sigma, axis=axis, **kw)
    pt = tan.through_thickness_profile(tf_sig, torch.tensor(sigma),
                                       axis=axis, **tkw)
    for f in dataclasses.fields(pj):
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            _close(a, b, f.name)
    mj, mt = jan.temper_metrics(pj), tan.temper_metrics(pt)
    assert sorted(mj) == sorted(mt)
    scale = np.abs(pj.stress).max()
    for k in mj:
        ref = np.ptp(pj.coordinate) if k == "thickness" else scale
        assert abs(mj[k] - mt[k]) <= 1e-12 * ref, k
    _close(jan.stress_l2_norm(jf_sig, sigma),
           tan.stress_l2_norm(tf_sig, torch.tensor(sigma)), "L2")


def test_analysis_equals_jax_on_the_run(run):
    prob, st = run
    jm = jmesh.reference_glass_mesh_1d()
    fe = prob.config.fe
    _hold_to_jax(jfs.FunctionSpace(jm, fe.sigma_family, fe.sigma_degree,
                                   value_shape=(1, 1)),
                 prob.fs_sigma, st.sigma.numpy(), 0,
                 jfs.FunctionSpace(jm, fe.T_family, fe.T_degree), prob.fs_T,
                 st.T.numpy())


@pytest.mark.parametrize("case", ["hex-CG1-axis2", "quad-DG1-axis1"])
def test_analysis_equals_jax_on_random_fields(case):
    if case.startswith("hex"):
        make = lambda m: m.box_mesh_3d(3, 3, 4, 1.0, 1.0, 0.01)
        fam, dim, axis = "CG", 3, 2
    else:
        make = lambda m: m.box_mesh_2d(3, 4, 1.0, 0.1)
        fam, dim, axis = "DG", 2, 1
    jm, tm = make(jmesh), make(tmesh)
    jsig = jfs.FunctionSpace(jm, fam, 1, value_shape=(dim, dim))
    tsig = tfs.FunctionSpace(tm, fam, 1, value_shape=(dim, dim))
    rng = np.random.default_rng(7)
    sigma = rng.standard_normal((jsig.n_scalar_dofs, dim, dim)) * 1e7
    T = 600 + 200 * rng.random(jsig.n_scalar_dofs)
    _hold_to_jax(jsig, tsig, sigma, axis, jfs.FunctionSpace(jm, fam, 1),
                 tfs.FunctionSpace(tm, fam, 1), T)
