"""Kernel K2 (the 3^d-point stencil matvec) and the grid-native heat
operator of the PyTorch port against the JAX package, on the CPU.

On CPU tensors the wrapper takes its plain PyTorch version. It is held
against the Pallas kernel in interpret mode in f32 (the JAX test's
rtol/atol 2e-5) and against StencilMatrix.matvec_flat in f64 at 1e-12.
GridHeatOperator's residual, diagonal, value tables and Jacobian action
are held against JAX's in f64 at rtol 1e-12, with an absolute floor of
1e-12 times the largest magnitude (the residual is a sum of terms of
either sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.fem.mesh import box_mesh_3d as jbox
from fem_glass_tempering_tpu.ops.grid import GridHeatOperator as JGrid
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.pallas_stencil import stencil_matvec_pallas
from fem_glass_tempering_tpu.ops.stencil import StencilMatrix as JStencil
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d as tbox
from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
    stencil_matvec,
    stencil_matvec_reference,
)
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator as TGrid
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat

GRIDS = [(9, 7, 5), (12, 6, 3), (10, 8)]


def _close(a, b, what, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300),
        err_msg=what)


def _stencil_case(grid, dtype, seed=0):
    """Random values with zeros wherever a lattice neighbour is missing,
    as an assembled operator has them."""
    rng = np.random.default_rng(seed)
    d = len(grid)
    vals = rng.standard_normal((3 ** d,) + grid).astype(dtype)
    for o, off in enumerate(np.ndindex(*([3] * d))):
        for a, da in enumerate(off):
            sl = [slice(None)] * d
            if da == 0:
                sl[a] = slice(0, 1)
            elif da == 2:
                sl[a] = slice(grid[a] - 1, grid[a])
            else:
                continue
            vals[(o,) + tuple(sl)] = 0.0
    x = rng.standard_normal(int(np.prod(grid))).astype(dtype)
    return vals, x


@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_plain_matches_pallas_f32(grid):
    vals, x = _stencil_case(grid, np.float32)
    y_pl = np.asarray(stencil_matvec_pallas(
        jnp.asarray(vals), jnp.asarray(x), grid, block_x=8, interpret=True))
    v2 = torch.tensor(vals).reshape(vals.shape[0], grid[0], -1)
    y = stencil_matvec(v2, torch.tensor(x), grid)
    assert y.dtype == torch.float32
    assert stencil_matvec.launches == 0          # CPU: plain version
    np.testing.assert_allclose(y.numpy(), y_pl, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_plain_matches_matvec_flat_f64(grid):
    vals, x = _stencil_case(grid, np.float64, seed=1)
    st = JStencil.__new__(JStencil)          # matvec_flat reads grid and d
    st.grid, st.d = grid, len(grid)
    v2 = vals.reshape(vals.shape[0], grid[0], -1)
    y_ref = np.asarray(st.matvec_flat(jnp.asarray(v2), jnp.asarray(x)))
    y = stencil_matvec_reference(torch.tensor(v2), torch.tensor(x), grid)
    _close(y.numpy(), y_ref, "y")


def test_stencil_matvec_rejects_bad_shapes():
    vals, x = _stencil_case((4, 3, 2), np.float64)
    v2 = torch.tensor(vals).reshape(27, 4, 6)
    with pytest.raises(ValueError, match="needs vals"):
        stencil_matvec(v2, torch.tensor(x[:-1]), (4, 3, 2))
    with pytest.raises(ValueError, match="CUDA device or both on the CPU"):
        stencil_matvec(v2.to("meta"), torch.tensor(x).to("meta"), (4, 3, 2))


def _operators(dims, dirichlet):
    jm, tm = jbox(*dims, 1.0, 1.0, 0.01), tbox(*dims, 1.0, 1.0, 0.01)
    jf, tf = JFS(jm, "CG", 1), TFS(tm, "CG", 1)
    kw = {}
    if dirichlet:
        kw = dict(bc_dofs=jf.boundary_scalar_dofs(), bc_value=600.0)
    jg = JGrid(JHeat(jf, JParams(), 0.1, **kw), allow_const=False)
    tg = TGrid(THeat(tf, ModelParams(), 0.1, device="cpu", **kw))
    return jg, tg


@pytest.mark.parametrize("dims,dirichlet", [((8, 8, 4), False),
                                            ((16, 16, 8), False),
                                            ((8, 8, 4), True)])
def test_grid_operator_matches_jax(dims, dirichlet):
    jg, tg = _operators(dims, dirichlet)
    rng = np.random.default_rng(2)
    n = jg.n
    T = 700 + 100 * rng.random(n)
    Tp = T + rng.normal(0, 3, n)
    v = rng.standard_normal(n)
    dt = 0.1
    jT, tT = jnp.asarray(T), torch.tensor(T)
    _close(tg.residual(tT, torch.tensor(Tp), dt).numpy(),
           jg.residual(jT, jnp.asarray(Tp), dt), "residual")
    _close(tg.jacobian_diag(tT, dt).numpy(), jg.jacobian_diag(jT, dt), "diag")
    _close(tg.stencil_values(tT, dt).numpy(), jg.stencil_values(jT, dt),
           "stencil_values")
    _close(tg.make_matvec(tT, dt)(torch.tensor(v)).numpy(),
           jg.make_matvec(jT, dt)(jnp.asarray(v)), "matvec")
    # the table matvec is the Jacobian of the residual
    jvp = torch.func.jvp(lambda u: tg.residual(u, torch.tensor(Tp), dt),
                         (tT,), (torch.tensor(v),))[1]
    _close(tg.make_matvec(tT, dt)(torch.tensor(v)).numpy(), jvp.numpy(),
           "matvec vs jvp", rtol=1e-9)


def test_grid_operator_deferred_forms_raise():
    tm = tbox(4, 3, 2, 1.0, 1.0, 0.01)
    op = THeat(TFS(tm, "CG", 1), ModelParams(), 0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="constant-row"):
        TGrid(op, allow_const=True)
    g = TGrid(op)
    with pytest.raises(NotImplementedError, match="bf16"):
        g.make_matvec(torch.full((g.n,), 800.0, dtype=torch.float64), 0.1,
                      stream_dtype=torch.bfloat16)
    # a DG space builds (ops/heat.py), but is no grid-native operator
    with pytest.raises(ValueError, match="CG-1"):
        TGrid(THeat(TFS(tm, "DG", 1), ModelParams(), 0.1, device="cpu"))


def test_heat_operator_matches_jax():
    """The gather assembly (the path of meshes the grid operator does not
    take) against JAX, with a flux marker that keeps only the z faces."""
    jm, tm = jbox(4, 3, 2, 1.0, 1.0, 0.01), tbox(4, 3, 2, 1.0, 1.0, 0.01)
    marker = lambda mids: np.abs(mids[:, 2] - 0.005) > 0.004  # noqa: E731
    jh = JHeat(JFS(jm, "CG", 1), JParams(), 0.1, flux_marker=marker)
    th = THeat(TFS(tm, "CG", 1), ModelParams(), 0.1, device="cpu",
               flux_marker=marker)
    rng = np.random.default_rng(3)
    T = 700 + 100 * rng.random(jh.n_dofs)
    Tp = T + rng.normal(0, 3, jh.n_dofs)
    _close(th.residual(torch.tensor(T), torch.tensor(Tp)).numpy(),
           jh.residual(jnp.asarray(T), jnp.asarray(Tp)), "residual")
    _close(th.jacobian_diag(torch.tensor(T)).numpy(),
           jh.jacobian_diag(jnp.asarray(T)), "diag")
    v = rng.standard_normal(jh.n_dofs)
    jj = jax.jvp(lambda u: jh.residual(u, jnp.asarray(Tp)),
                 (jnp.asarray(T),), (jnp.asarray(v),))[1]
    tj = torch.func.jvp(lambda u: th.residual(u, torch.tensor(Tp)),
                        (torch.tensor(T),), (torch.tensor(v),))[1]
    _close(tj.numpy(), jj, "jvp")
