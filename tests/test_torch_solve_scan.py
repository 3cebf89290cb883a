"""ThermoViscoProblem.solve_scan in the port against the JAX package's and
against the port's own solve(), on the CPU.

The default slab (DG-1 T on the graded 1D glass mesh, f64, rtol 1e-12,
matrix-free CG, SA-AMG) cut to 10 steps with write_every 5: against JAX's
solve_scan the snapshot times are equal, the stacked T, Tf and sigma
within max-rel 1e-12 (2.8e-16, 4.3e-16 and 2.7e-14 on one x86
CPU), and the Newton and CG counts equal.
Against the port's solve() with an on_snapshot hook the stacks are equal
bit for bit (the same multi_step chunks).
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP

FIELDS = ("T", "Tf", "sigma")


def _cfg(m, steps, write_every, **solver):
    return m.RunConfig(time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                       solver=m.SolverConfig(**solver),
                       output=m.OutputConfig(write_every=write_every,
                                             formats=()))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_solve_scan_matches_jax():
    pj = JP(config=_cfg(jc, 10, 5))
    pj.setup()
    sj, rj = pj.solve_scan()
    pt = TP(config=_cfg(tc, 10, 5), device="cpu")
    pt.setup()
    st, rt = pt.solve_scan()
    assert set(rt) == {"times", *FIELDS}
    np.testing.assert_array_equal(rt["times"].numpy(), rj["times"])
    assert rt["T"].shape == (2, pt.fs_T.n_scalar_dofs)
    assert rt["sigma"].shape == rj["sigma"].shape
    for f in FIELDS:
        assert _rel(rt[f], rj[f]) < 1e-12, f
        assert _rel(getattr(st, f), getattr(sj, f)) < 1e-12, f
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    assert pt.diagnostics.krylov_iters == pj.diagnostics.krylov_iters
    assert pt.t == pytest.approx(pj.t) and pt.state is st


@pytest.mark.parametrize("steps,write_every", [(4, 2), (3, 2)],
                         ids=["chunks", "remainder"])
def test_solve_scan_equals_solve(steps, write_every):
    """The stacks equal solve()'s snapshots bit for bit; 3 steps in chunks
    of 2 snapshot after step 2 and run step 3 unsnapshotted, as JAX's
    does."""
    pa = TP(config=_cfg(tc, steps, write_every), device="cpu")
    pa.setup()
    st, res = pa.solve_scan()
    pb = TP(config=_cfg(tc, steps, write_every), device="cpu")
    pb.setup()
    snaps = []
    pb.solve(on_snapshot=lambda t, s: snaps.append(s))
    n_chunks = steps // write_every
    assert len(res["times"]) == n_chunks
    for k in range(n_chunks):
        assert float(res["times"][k]) == float(snaps[k].t)
        for f in FIELDS:
            assert torch.equal(res[f][k], getattr(snaps[k], f)), (k, f)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(pb.state, f)), f
    assert pa.diagnostics.newton_iters == pb.diagnostics.newton_iters
    assert pa.diagnostics.krylov_iters == pb.diagnostics.krylov_iters
    assert pa.t == pytest.approx(pb.t)


def test_solve_scan_raises_on_non_convergence():
    cfg = _cfg(tc, 2, 1)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, newton_max_it=1))
    pt = TP(config=cfg, device="cpu")
    pt.setup()
    with pytest.raises(RuntimeError, match="solve_scan"):
        pt.solve_scan()
