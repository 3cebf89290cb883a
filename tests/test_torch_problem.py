"""The whole slice: the PyTorch port's ThermoViscoProblem against the JAX
package's, on the CPU in f64.

Configuration of tests/test_problem_e2e.py::test_jac_every_chunked_rebuild_matches
(8x8x4 CG-1 plate, stencil operator, geometric MG, Newton/CG rtol 1e-10,
8 steps), with jac_every 1 and 4. T and Tf agree at max-rel 1e-9; sigma at
1e-6 of max|sigma|, because the thermal-strain chain amplifies CG-level T
differences about 1e3x (tests/test_problem_e2e.py:261-263). Newton totals
are equal and CG totals differ by at most 2 (ties at the tolerance).
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.mesh import box_mesh_3d as jbox
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.convert import state_from_numpy
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d as tbox
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP


def _cfg(m, steps=8, **solver):
    kw = dict(newton_rtol=1e-10, newton_atol=1e-9, cg_rtol=1e-10,
              cg_max_it=2000, linear_operator="stencil", preconditioner="mg")
    kw.update(solver)
    return m.RunConfig(fe=m.FEConfig(T_family="CG", T_degree=1),
                       time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                       solver=m.SolverConfig(**kw),
                       output=m.OutputConfig(write_every=0, formats=()))


def _mesh(mod, dims):
    if len(dims) == 2:       # an isotropic square: short CG solves
        return mod.box_mesh_2d(*dims, 1.0, 1.0)
    return mod.box_mesh_3d(*dims, 1.0, 1.0, 0.01)


def _problems(dims=(8, 8, 4), steps=8, dirichlet=False, **solver):
    pj = JP(mesh=_mesh(jmesh, dims), config=_cfg(jc, steps, **solver))
    pj.setup(dirichlet_bc=dirichlet)
    pt = TP(mesh=_mesh(tmesh, dims), config=_cfg(tc, steps, **solver),
            device="cpu")
    pt.setup(dirichlet_bc=dirichlet)
    return pj, pt


def _assert_states_agree(sj, st):
    for f in ("T", "Tf"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-9, f
    a, b = np.asarray(sj.sigma), st.sigma.numpy()
    assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("jac_every", [1, 4])
def test_slice_matches_jax(jac_every):
    pj, pt = _problems(jac_every=jac_every)
    sj, okj, nij, kij = pj._multi_step_jit(pj.state, 8)
    st, okt, nit, kit = pt.multi_step(pt.state, 8)
    assert bool(okj) and okt
    _assert_states_agree(sj, st)
    assert nit == int(nij)
    assert abs(kit - int(kij)) <= 2, (kit, int(kij))
    assert float(st.t) == pytest.approx(float(sj.t), rel=1e-14)


def test_one_step_from_a_jax_state():
    """A JAX state after 3 steps, carried over by state_from_numpy, then
    one port step against JAX's fourth."""
    pj, pt = _problems(steps=4)
    s3, ok, _, _ = pj._multi_step_jit(pj.state, 3)
    assert bool(ok)
    s3_np = jax.device_get(s3)._asdict()
    s4j, okj, nij, kij = pj._step_jit(s3)
    s4t, okt, nit, kit = pt.step(state_from_numpy(s3_np, device="cpu"))
    assert bool(okj) and okt
    _assert_states_agree(s4j, s4t)
    assert nit == int(nij) and abs(kit - int(kij)) <= 2


@pytest.mark.parametrize("dims,pc,op,dirichlet", [
    ((6, 6), "jacobi", "stencil", False),
    ((6, 6), "none", "matrix_free", False),
    ((6, 6), "mg", "stencil", False),
    ((4, 4, 2), "mg", "stencil", True),
])
def test_other_paths_match_jax(dims, pc, op, dirichlet):
    pj, pt = _problems(dims=dims, steps=3, dirichlet=dirichlet,
                       preconditioner=pc, linear_operator=op)
    sj, okj, nij, kij = pj._multi_step_jit(pj.state, 3)
    st, okt, nit, kit = pt.multi_step(pt.state, 3)
    assert bool(okj) and okt
    _assert_states_agree(sj, st)
    assert nit == int(nij) and abs(kit - int(kij)) <= 2


def test_solve_writes_the_same_series(tmp_path):
    cfgs = []
    for m in (jc, tc):
        c = _cfg(m, steps=4, preconditioner="auto")
        cfgs.append(dataclasses.replace(
            c, output=m.OutputConfig(write_every=2, formats=("npz",))))
    pj = JP(mesh=jbox(4, 4, 2, 1.0, 1.0, 0.01), config=cfgs[0])
    pj.setup(output_dir=str(tmp_path / "jax"))
    pj.solve()
    pt = TP(mesh=tbox(4, 4, 2, 1.0, 1.0, 0.01), config=cfgs[1], device="cpu")
    pt.setup(output_dir=str(tmp_path / "torch"))
    pt.solve()
    assert pt.config.solver.preconditioner == "mg"
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    a = np.load(tmp_path / "jax" / "series.npz")
    b = np.load(tmp_path / "torch" / "series.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["times"], b["times"])
    for f in ("T", "Tf"):
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9)
    assert pt.t == pytest.approx(0.4)


def test_solve_timestep_and_reference_dict_api():
    fe = {"T": {"element": "CG", "degree": 1},
          "sigma": {"element": "CG", "degree": 1}}
    pt = TP(mesh=tbox(4, 3, 2, 1.0, 1.0, 0.01), config=fe, time=(0.0, 0.2),
            dt=0.1, model_parameters={"T_0": 790.0, "unknown": 1.0},
            device="cpu")
    assert pt.params.T_0 == 790.0 and pt.n_steps == 2
    pt.setup()
    st = pt.solve_timestep()
    assert pt.t == pytest.approx(0.1) and torch.isfinite(st.T).all()
    assert pt.diagnostics.newton_iters > 0


def test_failed_chunk_is_retried_then_raises():
    pt = TP(mesh=tbox(4, 3, 2, 1.0, 1.0, 0.01),
            config=_cfg(tc, steps=1, newton_max_it=1, on_failure="halve_dt",
                        max_dt_halvings=1), device="cpu")
    pt.setup()
    with pytest.raises(RuntimeError, match="dt halvings"):
        pt.solve()


@pytest.mark.parametrize("change,match", [
    (dict(fe=tc.FEConfig(T_family="DG")), "Slice 2"),
    (dict(fe=tc.FEConfig(T_family="CG", T_degree=2)), "Slice 4"),
    (dict(mechanics="equilibrium"), "Slice 5"),
    (dict(solver=tc.SolverConfig(cg_dtype="float32")), "Slice 1 deferrals"),
    (dict(solver=tc.SolverConfig(linear_operator="assembled")), "Slice 2"),
])
def test_later_slices_raise(change, match):
    cfg = dataclasses.replace(_cfg(tc), **change)
    with pytest.raises(NotImplementedError, match=match):
        TP(mesh=tbox(2, 2, 1, 1.0, 1.0, 0.01), config=cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(solver=tc.SolverConfig(mg_table_dtype="bfloat16",
                                 preconditioner="mg")), "Slice 1 deferrals"),
    (dict(output=tc.OutputConfig(formats=("vtu",))), "Slice 6"),
])
def test_later_slices_raise_at_setup(change, match):
    cfg = dataclasses.replace(_cfg(tc), **change)
    pt = TP(mesh=tbox(2, 2, 1, 1.0, 1.0, 0.01), config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        pt.setup()


def test_amg_waits_for_slice_2():
    from fem_glass_tempering_tpu_torch.fem.mesh import reference_glass_mesh_1d
    cfg = dataclasses.replace(
        _cfg(tc), fe=tc.FEConfig(T_family="CG"),
        solver=tc.SolverConfig(preconditioner="auto"))
    pt = TP(mesh=reference_glass_mesh_1d(), config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Slice 2"):
        pt.setup()
