"""The JAX package's quenching plate (tests/test_mechanics.py:60-77) with
equilibrium mechanics in the PyTorch port against the JAX package, on the
CPU in f64: box_mesh_3d(4, 4, 16, 50, 50, 10), CG-1, corrected physics,
the reference xi (the config default), flux through the z faces only.

This is the grid coupling's default case: with the reference xi the
vector V-cycle has no dense coarse solve (its frozen moduli need the
trapezoid relax factor), and the elasticity CG runs at rtol 1e-12 with the
increment tolerance 1e-2. Both sides take one step per call, so the JAX
step compiles once.

- Over the steps before the first tie, the per-step Newton, heat-CG and
  elasticity-CG counts are equal. The first tie is the fifth step: a cold
  solve of ~51 iterations that ends on the rtol 1e-12 test, where the
  port takes one iteration more than JAX.
- A warm solve stops at 1e-2 of its start residual after ~12 iterations,
  and then carries the rounding of its start: sigma and du agree to
  ~1e-5 of their max, not 1e-9. The second test shows that JAX moves by
  as much against itself under a change that only affects rounding (the
  warm start moved by one ulp), with the same counts.
"""

import jax
import numpy as np
import pytest

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.convert import state_from_numpy
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.models.mechanics import (
    GridMechanicsCoupling,
)
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP

PLATE = (4, 4, 16, 50.0, 50.0, 10.0)
STEPS_BEFORE_TIE = 4
FIELDS = ("T", "Tf", "sigma", "du")


def _cfg(mod):
    return mod.RunConfig(
        fe=mod.FEConfig(T_family="CG", T_degree=1),
        time=mod.TimeConfig(0.0, STEPS_BEFORE_TIE * 0.1, 0.1),
        solver=mod.SolverConfig(),
        output=mod.OutputConfig(write_every=0, formats=()),
        physics_mode="corrected", mechanics="equilibrium")


def _z_faces(mids):
    return (mids[:, 2] < 1e-9) | (mids[:, 2] > 10.0 - 1e-9)


class _JaxPlate:
    """The JAX problem, its coupling wrapped to log the elasticity CG count
    of every call (the step rebuilt around the wrapper), stepped one step
    per call from numpy states."""

    def __init__(self):
        p = JP(mesh=jmesh.box_mesh_3d(*PLATE), config=_cfg(jc))
        p.setup(flux_marker=_z_faces)
        inner = p._mech
        self.log = log = []

        class Logged:
            def build_precond(self, state):
                return inner.build_precond(state)

            def __call__(self, *args, **kw):
                out = inner(*args, **kw)
                jax.debug.callback(lambda it: log.append(int(it)),
                                   inner.last_cg_iters, ordered=True)
                return out

        p._mech = Logged()
        p._build_step()
        self.p = p
        self.state0 = self._numpy(p.engine.init_state())

    @staticmethod
    def _numpy(state):
        return {f: None if v is None else np.array(v)
                for f, v in state._asdict().items()}

    def step(self, arrays):
        """One step from numpy arrays -> (numpy arrays, (newton, cg,
        elasticity cg))."""
        st = self.p.engine.init_state()._replace(
            **{f: None if v is None else jax.numpy.asarray(v)
               for f, v in arrays.items()})
        self.log.clear()
        st, ok, ni, ki = self.p._multi_step_jit(st, 1)
        jax.block_until_ready(st.T)
        assert bool(ok)
        assert len(self.log) == 1
        return self._numpy(st), (int(ni), int(ki), self.log[0])


@pytest.fixture(scope="module")
def plates():
    jp = _JaxPlate()
    tp = TP(mesh=tmesh.box_mesh_3d(*PLATE), config=_cfg(tc), device="cpu")
    tp.setup(flux_marker=_z_faces)
    assert type(tp._mech) is GridMechanicsCoupling
    assert tp._mech.mg.coarse_inv is None        # no dense coarse solve
    assert (tp._mech.cg_rtol, tp._mech.inc_rtol) == (1e-12, 1e-2)
    return jp, tp


def _port_step(tp, state):
    st, ok, ni, ki = tp.multi_step(state, 1)
    assert ok and len(tp.last_mech_iters) == 1
    return st, (ni, ki, tp.last_mech_iters[0])


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_reference_xi_plate_counts_match_jax(plates):
    """Four steps from the initial state: per-step Newton, heat-CG and
    elasticity-CG counts equal; T and Tf at rtol 1e-9; sigma and du within
    1e-4 of their max (measured 1.1e-5 and 1.7e-6: the warm solves'
    rounding, the next test)."""
    jp, tp = plates
    js, ts = jp.state0, tp.state
    for k in range(STEPS_BEFORE_TIE):
        js, jc_ = jp.step(js)
        ts, tc_ = _port_step(tp, ts)
        assert tc_ == jc_, f"step {k}: port {tc_}, JAX {jc_}"
        for f in FIELDS:
            a, b = getattr(ts, f).numpy(), js[f]
            scale = float(np.abs(b).max())
            tol = (dict(rtol=1e-9, atol=1e-9 * scale) if f in ("T", "Tf")
                   else dict(rtol=0.0, atol=1e-4 * scale))
            np.testing.assert_allclose(a, b, err_msg=f"step {k}: {f}",
                                       **tol)


def test_port_differs_from_jax_as_jax_from_itself(plates):
    """From JAX's state after two steps, the third step (a warm solve of
    12 iterations): JAX from that state and from the same state with its
    warm start `du` moved by one ulp take the same counts as the port, and
    the port's sigma and du lie no further from JAX than JAX's own moved
    run does, within a factor 10 (measured: JAX against itself 5.1e-6 of
    max|sigma| and 7.8e-7 of max|du|, the port against JAX 3.8e-6 and
    5.8e-7)."""
    jp, tp = plates
    js = jp.state0
    for _ in range(2):
        js, _ = jp.step(js)
    moved = dict(js, du=js["du"] * (1.0 + 2.0 ** -52))
    assert np.any(moved["du"] != js["du"])
    j1, jcount = jp.step(js)
    j2, mcount = jp.step(moved)
    t1, tcount = _port_step(tp, state_from_numpy(js, device="cpu"))
    assert tcount == jcount == mcount
    assert jcount[2] < 20                       # a warm, early-stopped solve
    for f in ("sigma", "du"):
        own = _rel(j2[f], j1[f])
        port = _rel(getattr(t1, f).numpy(), j1[f])
        assert 0.0 < own < 1e-3, (f, own)
        assert port <= 10.0 * own, (f, port, own)
    np.testing.assert_allclose(t1.T.numpy(), j1["T"], rtol=1e-12)
