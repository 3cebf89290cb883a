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


@pytest.mark.parametrize("change,refusal", [
    # Q2MG needs the lattice operator, which grid_native="off" turns off
    (dict(fe=tc.FEConfig(T_family="CG", T_degree=2),
          solver=tc.SolverConfig(linear_operator="stencil",
                                 preconditioner="mg", grid_native="off")),
     "lattice-native operator"),
    # no multigrid for DG-2 ("auto" takes SA-AMG there)
    (dict(fe=tc.FEConfig(T_family="DG", T_degree=2)), "or DG-1 temperature"),
], ids=["change0-Slice 4b", "change1-Slice 4b"])
def test_later_slices_raise(change, refusal):
    """The two configurations that waited for Slice 4b: the port now
    constructs both and, like JAX, refuses their "mg" at setup with JAX's
    ValueError (the degree-2 paths that run:
    tests/test_torch_degree2_gather.py, tests/test_torch_degree2_twins.py)."""
    cfg = dataclasses.replace(_cfg(tc), **change)
    pt = TP(mesh=tbox(2, 2, 1, 1.0, 1.0, 0.01), config=cfg, device="cpu")
    with pytest.raises(ValueError, match=refusal):
        pt.setup()


@pytest.mark.parametrize("change,match", [
    (dict(solver=tc.SolverConfig(mg_table_dtype="bfloat16",
                                 preconditioner="mg", mg_coarse="dense",
                                 mg_max_levels=2)), "Slice 1 deferrals"),
    (dict(output=tc.OutputConfig(formats=("vtu",))), None),
], ids=["change0-Slice 1 deferrals", "change1-Slice 6"])
def test_later_slices_raise_at_setup(change, match, tmp_path):
    """The two configurations that once waited now set up: bf16 V-cycle
    tables (the Slice 1 deferral; here the f64 cycle, whose fine level
    streams bf16 tables under the f64 vector, the dense solve below it)
    take one step equal to JAX's in counts and T, and the VTU output sets
    up its writer (its files: tests/test_torch_output.py)."""
    from fem_glass_tempering_tpu_torch.io.vtu import VTUSeriesWriter
    cfg = dataclasses.replace(_cfg(tc), **change)
    cfg = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, output_dir=str(tmp_path)))
    if match is None:
        pt = TP(mesh=tbox(2, 2, 1, 1.0, 1.0, 0.01), config=cfg, device="cpu")
        pt.setup()
        assert [type(w) for w in pt._writers] == [VTUSeriesWriter]
        return
    jcfg = dataclasses.replace(_cfg(jc), solver=jc.SolverConfig(
        **dataclasses.asdict(cfg.solver)), output=jc.OutputConfig(
            write_every=0, formats=()))
    cfg = dataclasses.replace(cfg, output=tc.OutputConfig(write_every=0,
                                                          formats=()))
    pj = JP(mesh=jbox(8, 8, 4, 1.0, 1.0, 0.01), config=jcfg)
    pj.setup()
    pt = TP(mesh=tbox(8, 8, 4, 1.0, 1.0, 0.01), config=cfg, device="cpu")
    pt.setup()
    assert pt._mg.table_dtype == torch.bfloat16
    assert pt._mg.coarse_inv is not None and len(pt._mg.levels) == 2
    sj, okj, nij, kij = pj._multi_step_jit(pj.state, 1)
    st, okt, nit, kit = pt.multi_step(pt.state, 1)
    assert bool(okj) and okt
    assert nit == int(nij) and abs(kit - int(kij)) <= 2, (nit, kit, nij, kij)
    _assert_states_agree(sj, st)


@pytest.mark.parametrize("change,dg_smoother", [
    (dict(fe=tc.FEConfig(T_family="DG"),
          solver=tc.SolverConfig(linear_operator="stencil")), None),
    (dict(solver=tc.SolverConfig(cg_dtype="float32")), None),
    # a DG-1 space on a structured box: "mg" (asked for, or what "auto"
    # resolves to) is the DG multigrid, column-smoothed on this 50:1 plate
    (dict(fe=tc.FEConfig(T_family="DG"),
          solver=tc.SolverConfig(preconditioner="mg")), "column"),
    (dict(fe=tc.FEConfig(T_family="DG"),
          solver=tc.SolverConfig(preconditioner="auto")), "column"),
])
def test_slice3_configurations_set_up_and_step(change, dg_smoother):
    """The DG block stencil, mixed precision and the DG multigrid set up
    and take one converged step."""
    from fem_glass_tempering_tpu_torch.solver.multigrid import DGMultigrid
    cfg = dataclasses.replace(_cfg(tc), **change)
    pt = TP(mesh=tbox(2, 2, 1, 1.0, 1.0, 0.01), config=cfg, device="cpu")
    pt.setup()
    if dg_smoother is not None:
        assert pt.config.solver.preconditioner == "mg"
        assert isinstance(pt._dg_mg, DGMultigrid)
        assert pt._dg_mg.smoother == dg_smoother
    st, ok, ni, _ = pt.step(pt.state)
    assert ok and ni > 0 and bool(torch.isfinite(st.T).all())



# ----------------------------------------------------------------------
# The default workload: DG-1 temperature / CG-1 stress on the graded 1D
# glass slab, f64, Newton and CG rtol 1e-12, matrix-free CG, SA-AMG.
# ----------------------------------------------------------------------

def _default_cfg(m, steps, **solver):
    return m.RunConfig(time=m.TimeConfig(0.0, steps * 0.1, 0.1),
                       solver=m.SolverConfig(**solver),
                       output=m.OutputConfig(write_every=0, formats=()))


def _probe(prob, st):
    x = prob.fs_T.dof_coords[:, 0]
    T, Tf = st.T.numpy(), st.Tf.numpy()
    sig = st.sigma.numpy()[:, 0, 0]
    return dict(T_surf=T[np.argmin(x)],
                T_core=T[np.argmin(np.abs(x - 25.0))],
                Tf_surf=Tf[np.argmin(x)],
                sig_l2=float(np.linalg.norm(sig)))


@pytest.fixture(scope="module")
def default_run():
    """ThermoViscoProblem with no argument but the device: 500 steps."""
    prob = TP(device="cpu")
    prob.setup()
    return prob, prob.solve()


def test_auto_preconditioner_follows_the_jax_rule():
    """'auto' is geometric MG only for a structured box with a degree-1
    (or CG-2) space, SA-AMG elsewhere: the 1D slab is graded, so AMG."""
    for fam in ("DG", "CG"):
        pt = TP(config=dataclasses.replace(_default_cfg(tc, 1),
                                           fe=tc.FEConfig(T_family=fam)),
                device="cpu")
        pt.setup()
        assert pt.config.solver.preconditioner == "amg"
        assert pt._amg is not None and pt._mg is None
    pj = JP(config=_default_cfg(jc, 1))
    pj.setup()
    assert pj.config.solver.preconditioner == "amg"


def test_golden_regression_default_config(default_run):
    """The golden values of tests/test_problem_e2e.py for the full default
    run, Newton count included."""
    prob, st = default_run
    assert prob.fs_T.family == "DG" and prob.fs_T.n_scalar_dofs == 96
    assert prob.n_steps == 500 and prob.dtype == torch.float64
    assert prob.config.solver.preconditioner == "amg"
    assert prob.config.solver.linear_operator == "matrix_free"
    g = _probe(prob, st)
    assert g["T_surf"] == pytest.approx(644.5809518419135, rel=1e-8)
    assert g["T_core"] == pytest.approx(797.5500316300408, rel=1e-8)
    assert g["Tf_surf"] == pytest.approx(799.8808751898703, rel=1e-8)
    assert g["sig_l2"] == pytest.approx(0.00013725924857443605, rel=1e-6)
    assert prob.diagnostics.newton_iters == 1501
    assert prob.t == pytest.approx(50.0)


def test_default_run_agrees_with_the_1d_oracle(default_run):
    """Mirror of tests/test_differential_oracle.py (default forcing): the
    independent numpy/scipy implementation of the reference's algorithm,
    over the same 500 steps."""
    from fem_glass_tempering_tpu.validation.oracle_1d import run_oracle

    prob, st = default_run
    o = run_oracle(prob.mesh.nodes[:, 0], 500, 0.1, T_family="DG")
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    assert rel(st.T.numpy(), o["T"]) < 1e-11
    assert rel(st.Tf.numpy(), o["Tf"]) < 1e-12
    assert rel(st.sigma.numpy()[:, 0, 0], o["sigma"]) < 1e-9
    assert prob.diagnostics.krylov_iters < 0.7 * 12_008


@pytest.mark.slow
def test_golden_corrected_mode():
    """Corrected physics mode, full default run (a second 500-step solve:
    in the slow tier for its CPU time)."""
    prob = TP(physics_mode="corrected", device="cpu")
    prob.setup()
    st = prob.solve()
    g = _probe(prob, st)
    assert g["T_surf"] == pytest.approx(644.5809518419135, rel=1e-8)
    assert g["sig_l2"] == pytest.approx(0.23035427599341113, rel=1e-6)


@pytest.mark.parametrize("mode", ["reference", "corrected"])
def test_default_config_matches_jax_over_20_steps(mode):
    """Port vs JAX on the default configuration: equal Newton and CG
    counts, T and Tf at max-rel 1e-12, sigma at 1e-9 of max|sigma| (the
    thermal-strain chain amplifies T differences about 1e3x)."""
    pj = JP(config=_default_cfg(jc, 20), physics_mode=mode)
    pj.setup()
    sj = pj.solve()
    pt = TP(config=_default_cfg(tc, 20), physics_mode=mode, device="cpu")
    pt.setup()
    st = pt.solve()
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    assert pt.diagnostics.krylov_iters == pj.diagnostics.krylov_iters
    for f in ("T", "Tf"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-12, f
    a, b = np.asarray(sj.sigma), st.sigma.numpy()
    assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max()


@pytest.mark.parametrize("dims,fam", [((3, 3, 2), "DG"), ((4, 3), "DG")])
def test_dg_box_with_amg_matches_jax(dims, fam):
    """A DG-1 space on a structured box, SA-AMG and matrix-free CG stated
    explicitly ('auto' resolves to the DG multigrid there)."""
    def cfg(m):
        return dataclasses.replace(
            _default_cfg(m, 3, preconditioner="amg"),
            fe=m.FEConfig(T_family=fam))
    pj = JP(mesh=_mesh(jmesh, dims), config=cfg(jc))
    pj.setup()
    sj = pj.solve()
    pt = TP(mesh=_mesh(tmesh, dims), config=cfg(tc), device="cpu")
    pt.setup()
    st = pt.solve()
    _assert_states_agree(sj, st)
    assert pt.diagnostics.newton_iters == pj.diagnostics.newton_iters
    assert abs(pt.diagnostics.krylov_iters
               - pj.diagnostics.krylov_iters) <= 2


def test_assembled_solve_matches_matrix_free():
    """Mirror of tests/test_spmv.py: linear_operator='assembled' (ELL
    SpMV) reproduces the matrix-free solution on the default mesh."""
    sols = {}
    for lo in ("matrix_free", "assembled"):
        prob = TP(config=_default_cfg(tc, 10, linear_operator=lo),
                  device="cpu")
        prob.setup()
        sols[lo] = prob.solve().T.numpy()
    np.testing.assert_allclose(sols["assembled"], sols["matrix_free"],
                               rtol=1e-11)


def _run_to(prob, steps):
    prob.setup()
    prob.state, ok, _, _ = prob.multi_step(prob.state, steps)
    assert ok
    prob.t = steps * prob.dt


def test_checkpoint_round_trip(tmp_path):
    """Save at step 5, resume in a fresh problem, run to step 10: the same
    final state as the uninterrupted run, bit for bit."""
    whole = TP(config=_default_cfg(tc, 10), device="cpu")
    whole.setup()
    want = whole.solve()
    first = TP(config=_default_cfg(tc, 10), device="cpu")
    _run_to(first, 5)
    path = str(tmp_path / "ckpt" / "step5.npz")
    first.save_checkpoint(path)
    second = TP(config=_default_cfg(tc, 10), device="cpu")
    second.setup()
    second.resume_from(path)
    assert second.t == pytest.approx(0.5)
    got, ok, _, _ = second.multi_step(second.state, 5)
    assert ok
    for f, v in want._asdict().items():
        if v is not None:
            assert torch.equal(getattr(got, f), v), f


def test_checkpoint_every_writes_files(tmp_path):
    cfg = dataclasses.replace(
        _default_cfg(tc, 4),
        output=tc.OutputConfig(output_dir=str(tmp_path), write_every=2,
                               formats=(), checkpoint_every=2))
    prob = TP(config=cfg, device="cpu")
    prob.setup()
    prob.solve()
    names = sorted(p.name for p in tmp_path.glob("checkpoint_*.npz"))
    assert names == ["checkpoint_000002.npz", "checkpoint_000004.npz"]
    from fem_glass_tempering_tpu_torch.io.checkpoint import load_checkpoint
    st, meta = load_checkpoint(str(tmp_path / names[-1]), device="cpu")
    assert meta["extra"]["t"] == pytest.approx(0.4)
    assert meta["config"]["fe"]["T_family"] == "DG"
    assert torch.equal(st.T, prob.state.T)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The two packages write one format: a checkpoint written by the JAX
    package after 5 steps resumes in the port, whose 6th step agrees with
    JAX's; and the port's checkpoint loads in the JAX package."""
    from fem_glass_tempering_tpu.io.checkpoint import (
        load_checkpoint as jload,
    )

    pj = JP(config=_default_cfg(jc, 6))
    pj.setup()
    pj.state, ok, _, _ = pj._multi_step_jit(pj.state, 5)
    assert bool(ok)
    pj.t = 0.5
    path = str(tmp_path / "jax5.npz")
    pj.save_checkpoint(path)
    T5 = np.asarray(pj.state.T)          # the jitted step donates its input
    s6j, okj, nij, kij = pj._step_jit(pj.state)
    pt = TP(config=_default_cfg(tc, 6), device="cpu")
    pt.setup()
    pt.resume_from(path)
    assert pt.t == pytest.approx(0.5)
    np.testing.assert_array_equal(pt.state.T.numpy(), T5)
    s6t, okt, nit, kit = pt.step(pt.state)
    assert bool(okj) and okt and nit == int(nij) and kit == int(kij)
    for f in ("T", "Tf"):
        a, b = np.asarray(getattr(s6j, f)), getattr(s6t, f).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-12, f
    back = str(tmp_path / "torch5.npz")
    pt.save_checkpoint(back)
    sj, meta = jload(back)
    np.testing.assert_array_equal(np.asarray(sj.Tf_partial),
                                  pt.state.Tf_partial.numpy())
    assert meta["extra"]["t"] == pytest.approx(0.5)


def _one_big_step(dt, max_it, on_failure):
    return tc.RunConfig(
        time=tc.TimeConfig(0.0, dt, dt),
        solver=tc.SolverConfig(newton_max_it=max_it, on_failure=on_failure),
        output=tc.OutputConfig(write_every=0, formats=()))


def test_dg_raise_on_failure():
    """Mirror of tests/test_failure_recovery.py on the DG default mesh."""
    prob = TP(config=_one_big_step(40.0, 4, "raise"), device="cpu")
    prob.setup()
    with pytest.raises(RuntimeError, match="failed to converge"):
        prob.solve()


def test_dg_halve_dt_recovers():
    prob = TP(config=_one_big_step(40.0, 4, "halve_dt"), device="cpu")
    prob.setup()
    st = prob.solve()
    assert prob.diagnostics.dt_halvings >= 1
    assert float(st.t) == pytest.approx(40.0, rel=1e-12)
    pj = JP(config=jc.RunConfig(
        time=jc.TimeConfig(0.0, 40.0, 40.0),
        solver=jc.SolverConfig(newton_max_it=4, on_failure="halve_dt"),
        output=jc.OutputConfig(write_every=0, formats=())))
    pj.setup()
    sj = pj.solve()
    assert prob.diagnostics.dt_halvings == pj.diagnostics.dt_halvings
    a, b = np.asarray(sj.T), st.T.numpy()
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-11


def test_dg_halve_dt_exhausts():
    prob = TP(config=_one_big_step(40.0, 1, "halve_dt"), device="cpu")
    prob.setup()
    with pytest.raises(RuntimeError, match="dt halvings"):
        prob.solve()
