"""bf16 V-cycle tables (SolverConfig.mg_table_dtype="bfloat16") in the
port against the JAX package, on the CPU.

The plain twin of K2 on bf16 tables against JAX's
StencilMatrix.matvec_flat(vals.astype(bfloat16), v): both widen each
table value to the vector's dtype (exactly) and round every product and
sum in that dtype, in the same offset order, so the two agree bit for bit
in f64 and in f32 (asserted as equality, not as a tolerance). Then the
8x8x4 mixed-precision plate (f64 Newton at rtol 1e-12 over an f32 CG and
the f32 V-cycle twin, two levels: the 8x8x4 level smoothed with its
tables, the 4x4x2 level the dense coarse solve; with the default "auto"
this plate's single level is the dense solve, which streams no table)
with bf16 tables against JAX: Newton equal, CG
within 2% (the f32 CG stops on its last bits), T within max-rel 1e-11;
and the port's bf16 arm against its "same" arm at the bar of JAX's
tests/test_multigrid.py::test_mg_bf16_tables_equivalent_solve (T rtol
1e-11, CG at most 2x), at 8x8x4 rather than that test's 16x16x8, which is
in the slow tier.
"""

import dataclasses
import gc
import weakref

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.stencil import StencilMatrix as JStencil
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec
from fem_glass_tempering_tpu_torch.solver.multigrid import GeometricMG


def _bf16_to_jax(t: torch.Tensor):
    """The same bf16 bits as a JAX array."""
    bits = t.contiguous().view(torch.int16).numpy()
    return jnp.asarray(bits.view(ml_dtypes.bfloat16))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_twin_on_bf16_tables_equals_jax(dtype):
    """Real value tables of the 6x5x4 plate (with the boundary
    linearisation at a random T), cast to bf16, against a random vector:
    the twin's y equals JAX's bit for bit."""
    jm = jmesh.box_mesh_3d(6, 5, 4, 1.0, 1.0, 0.01)
    jst = JStencil(JHeat(JFS(jm, "CG", 1), JParams(), 0.1))
    rng = np.random.default_rng(11)
    T = 700.0 + 100.0 * rng.random(jst.n)
    vals = np.asarray(jst.values_at(jnp.asarray(T), 0.1))
    vals2 = torch.tensor(vals).reshape(27, jst.grid[0], -1)
    v = rng.standard_normal(jst.n).astype(dtype)
    t_bf = vals2.to(getattr(torch, dtype)).to(torch.bfloat16)
    assert t_bf.dtype == torch.bfloat16
    y = stencil_matvec(t_bf, torch.tensor(v), jst.grid)
    assert y.dtype == getattr(torch, dtype)
    y_j = np.asarray(jst.matvec_flat(_bf16_to_jax(t_bf), jnp.asarray(v)))
    assert y_j.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(y.numpy(), y_j)
    # JAX's own cast from the operator dtype gives the same bf16 bits
    j_bf = np.asarray(jnp.asarray(vals.astype(dtype)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(
        t_bf.view(torch.int16).numpy().reshape(-1),
        j_bf.view(np.int16).reshape(-1))
    # and bf16 tables are a different operator from the f64 ones
    y64 = stencil_matvec(vals2, torch.tensor(v, dtype=torch.float64),
                         jst.grid)
    assert not np.array_equal(y.numpy().astype(np.float64), y64.numpy())


def _mixed_cfg(m, tdt, steps=2):
    return m.RunConfig(
        fe=m.FEConfig(T_family="CG", T_degree=1),
        time=m.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=m.SolverConfig(preconditioner="mg", linear_operator="stencil",
                              newton_rtol=1e-12, newton_atol=1e-12,
                              cg_rtol=1e-12, cg_max_it=20000,
                              cg_dtype="float32", mg_smoother="chebyshev",
                              mg_coarse="dense", mg_max_levels=2,
                              mg_table_dtype=tdt),
        output=m.OutputConfig(write_every=0, formats=()),
        dtype="float64")


@pytest.fixture(scope="module")
def mixed_runs():
    """The 8x8x4 mixed plate, 2 steps: JAX with bf16 tables, the port
    with bf16 tables and with "same"."""
    out = {}
    pj = JP(mesh=jmesh.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
            config=_mixed_cfg(jc, "bfloat16"))
    pj.setup()
    sj = pj.solve()
    out["jax"] = (np.asarray(sj.T), pj.diagnostics.newton_iters,
                  pj.diagnostics.krylov_iters)
    for tdt in ("bfloat16", "same"):
        pt = TP(mesh=tmesh.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                config=_mixed_cfg(tc, tdt), device="cpu")
        pt.setup()
        assert isinstance(pt._mg32, GeometricMG) and pt._mg is None
        want = torch.bfloat16 if tdt == "bfloat16" else None
        assert pt._mg32.table_dtype == want
        assert pt._mg32.coarse_inv is not None and len(pt._mg32.levels) == 2
        st = pt.solve()
        out[tdt] = (st.T.numpy(), pt.diagnostics.newton_iters,
                    pt.diagnostics.krylov_iters)
    return out


def test_mixed_plate_with_bf16_tables_matches_jax(mixed_runs):
    Tj, nj, kj = mixed_runs["jax"]
    Tt, nt, kt = mixed_runs["bfloat16"]
    assert nt == nj
    assert abs(kt - kj) <= 0.02 * kj, (kt, kj)
    assert np.abs(Tt - Tj).max() / np.abs(Tj).max() < 1e-11


def test_bf16_arm_against_the_same_arm(mixed_runs):
    """The bf16 tables perturb the preconditioner alone: the f64 Newton
    loop reaches the same field at the same tolerance."""
    Tb, _, kb = mixed_runs["bfloat16"]
    Tf, _, kf = mixed_runs["same"]
    np.testing.assert_allclose(Tb, Tf, rtol=1e-11)
    assert kb <= 2 * kf, (kb, kf)


def test_table_dtype_reaches_only_the_grid_levels():
    """GeometricMG streams bf16 on its grid levels: the levels' value
    tables stay in the cycle's dtype, a V-cycle apply differs from the
    f64 one by the bf16 rounding of the tables alone (above 1e-6 and
    below 5e-2 of the correction), and equals the plain bf16 apply of
    those tables."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    def t_op(level_mesh):
        return HeatOperator(FunctionSpace(level_mesh, "CG", 1),
                            ModelParams(), 0.1, device="cpu")

    tm = tmesh.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01)
    rng = np.random.default_rng(5)
    T = torch.tensor(700.0 + 100.0 * rng.random(tm.n_nodes))
    r = torch.tensor(rng.standard_normal(tm.n_nodes))
    ys = {}
    for tdt in (None, torch.bfloat16):
        mg = GeometricMG(tm, t_op, smoother="chebyshev", coarse="dense",
                         max_levels=2, table_dtype=tdt)
        mg.freeze_omegas(None, 0.1)
        ys[tdt] = mg.preconditioner(mg.linearization_states(T), 0.1)(r)
        fine = mg._grid_for(mg.levels[0])
        assert fine.vals_mass.dtype == torch.float64
        v = r.clone()
        vals2 = fine.stencil_values(T, 0.1).reshape(27, fine.grid[0], -1)
        want = stencil_matvec(vals2 if tdt is None else vals2.to(tdt), v,
                              fine.grid)
        assert torch.equal(fine.make_matvec(T, 0.1, stream_dtype=tdt)(v),
                           want)
    scale = ys[None].abs().max()
    diff = float((ys[torch.bfloat16] - ys[None]).abs().max() / scale)
    assert 1e-6 < diff < 5e-2, diff


def test_bf16_config_sets_up_on_the_dg_box():
    """Under the DG p-multigrid the CG-1 correction's GeometricMG takes
    the table dtype, as JAX's DGMultigrid mg_kwargs pass it."""
    cfg = dataclasses.replace(
        _mixed_cfg(tc, "bfloat16", steps=1),
        fe=tc.FEConfig(T_family="DG"))
    pt = TP(mesh=tmesh.box_mesh_3d(2, 2, 1, 1.0, 1.0, 0.01), config=cfg,
            device="cpu")
    pt.setup()
    assert pt._dg_mg32.cg_mg.table_dtype == torch.bfloat16
    st, ok, ni, _ = pt.step(pt.state)
    assert ok and ni > 0 and bool(torch.isfinite(st.T).all())


def test_vcycle_apply_holds_no_reference_to_itself():
    """Dropping a V-cycle apply frees its level matvecs (and with them
    the streamed tables) at once, with the cyclic collector off: the
    apply is no reference cycle, so a solve that rebuilds it per Newton
    step does not pile up each build's tables."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    tm = tmesh.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01)
    mg = GeometricMG(tm, lambda m: HeatOperator(
        FunctionSpace(m, "CG", 1), ModelParams(), 0.1, device="cpu"),
        smoother="chebyshev", coarse="dense", max_levels=2,
        table_dtype=torch.bfloat16)
    mg.freeze_omegas(None, 0.1)
    T = torch.full((tm.n_nodes,), 800.0, dtype=torch.float64)
    gc.collect()
    gc.disable()
    try:
        pc = mg.preconditioner(mg.linearization_states(T), 0.1)
        cells = dict(zip(pc.__code__.co_freevars,
                         (c.cell_contents for c in pc.__closure__)))
        mv = weakref.ref(cells["matvecs"][0])
        assert bool(torch.isfinite(pc(T)).all())
        del pc, cells
        assert mv() is None
    finally:
        gc.enable()
