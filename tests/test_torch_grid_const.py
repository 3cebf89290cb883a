"""The constant-row form of the port's GridHeatOperator (allow_const=True)
against its table form and against the JAX package's
constant-row form, on the CPU.

Mirrors tests/test_grid_ops.py::test_constant_row_form_matches_table_form
case for case (the 6x4x3 plate with and without a z-face flux marker, a
7x5 2D plate): the Jacobian action, the residual and the diagonal of the
two forms agree at 1e-12 (bit for bit where the form keeps the table
form's order: the matvec and the diagonal), and the stiffness in
difference form annihilates a constant field exactly. Each is held to the
JAX package's constant-row form at 1e-12.
"""

import jax  # JAX on the CPU, x64, via tests/conftest.py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.grid import GridHeatOperator as JGrid
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

CASES = {
    "3d": (lambda m: m.box_mesh_3d(6, 4, 3, 1.0, 1.0, 0.01), False),
    "3d-zfaces": (lambda m: m.box_mesh_3d(6, 4, 3, 1.0, 1.0, 0.01), True),
    "2d": (lambda m: m.box_mesh_2d(7, 5, 1.0, 0.5), False),
}


def _zmark(m):
    return (m[:, 2] < 1e-12) | (m[:, 2] > 0.01 - 1e-12)


def _ops(name):
    mesher, marker = CASES[name]
    mark = _zmark if marker else None
    top = HeatOperator(FunctionSpace(mesher(tmesh), "CG", 1), ModelParams(),
                       0.1, flux_marker=mark, device="cpu")
    jop = JHeat(JFS(mesher(jmesh), "CG", 1), JParams(), 0.1,
                flux_marker=mark)
    return top, jop, mark


def _inputs(n):
    rng = np.random.default_rng(2)
    return (700 + 100 * rng.random(n), 700 + 100 * rng.random(n),
            rng.standard_normal(n))


def _close(a, b, rtol, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, (what, np.abs(a - b).max())


@pytest.mark.parametrize("name", list(CASES))
def test_constant_row_form_matches_table_form(name):
    top, _, mark = _ops(name)
    g = GridHeatOperator(top, flux_marker=mark, allow_const=True)
    assert g.const_ok
    gt = GridHeatOperator(top, flux_marker=mark)
    assert not gt.const_ok
    T, Tp, v = (torch.tensor(a) for a in _inputs(g.n))
    # the table form's matvec, as K2's plain twin computes it
    vals = gt.stencil_values(T, 0.1)
    ref_mv = gt._mv_flat(vals)(v)
    const_mv = g.make_matvec(T, 0.1)(v)
    _close(const_mv, ref_mv, 1e-12, "matvec")
    _close(g.residual(T, Tp, 0.1), gt.residual(T, Tp, 0.1), 1e-12,
           "residual")
    _close(g.jacobian_diag(T, 0.1), gt.jacobian_diag(T, 0.1), 1e-13, "diag")
    # constant-field annihilation of the stiffness difference form
    c = torch.full((g.n,), 811.0, dtype=g.dtype)
    z = g._crow_conv(g.crow_stiff, g.crow_dstiff, c, diff=True)
    assert float(z.abs().max()) == 0.0
    # the rows of the form are the table form's mass-and-stiffness tables
    gx = g.grid[0]
    vm = gt.vals_mass.reshape(27 if g.d == 3 else 9, gx, -1)
    assert torch.equal(g.crow_mass, vm[:, 1])
    assert torch.equal(g.crow_dmass[:, 0], vm[:, 0])
    assert torch.equal(g.crow_dmass[:, 1], vm[:, -1])


@pytest.mark.parametrize("name", list(CASES))
def test_constant_row_form_matches_jax(name):
    top, jop, mark = _ops(name)
    g = GridHeatOperator(top, flux_marker=mark, allow_const=True)
    jg = JGrid(jop, flux_marker=mark)
    assert g.const_ok and jg.const_ok
    T, Tp, v = _inputs(g.n)
    tT, jT = torch.tensor(T), jnp.asarray(T)
    # one jit per JAX function: its eager dispatch compiles every op
    j_mv = jax.jit(lambda u, x: jg.make_matvec(u, 0.1)(x))
    j_res = jax.jit(lambda u, up: jg.residual(u, up, 0.1))
    j_diag = jax.jit(lambda u: jg.jacobian_diag(u, 0.1))
    _close(g.make_matvec(tT, 0.1)(torch.tensor(v)),
           j_mv(jT, jnp.asarray(v)), 1e-12, "matvec")
    _close(g.residual(tT, torch.tensor(Tp), 0.1),
           j_res(jT, jnp.asarray(Tp)), 1e-12, "residual")
    _close(g.jacobian_diag(tT, 0.1), j_diag(jT), 1e-12, "diag")
    _close(g.crow_stiff, jg.crow_stiff, 0.0, "rows")
    _close(g.crow_dstiff, jg.crow_dstiff, 0.0, "boundary rows")


def test_constant_row_matvec_is_the_jacobian_of_its_residual():
    """The constant-row matvec with its per-apply flux blocks equals the
    forward-mode derivative of the constant-row residual."""
    top, _, _ = _ops("3d")
    g = GridHeatOperator(top, allow_const=True)
    T, Tp, v = (torch.tensor(a) for a in _inputs(g.n))
    jvp = torch.func.jvp(lambda u: g.residual(u, Tp, 0.1), (T,), (v,))[1]
    _close(g.make_matvec(T, 0.1)(v), jvp, 1e-9, "matvec vs jvp")


def test_const_form_dispatch():
    """The table form is the default (what every solver site builds); with
    allow_const a bf16 stream (a table consumer) still takes the table
    path through K2's twin; a grid that is too short along axis 0, or 1D,
    keeps the table form."""
    top, _, _ = _ops("3d")
    assert not GridHeatOperator(top).const_ok
    g = GridHeatOperator(top, allow_const=True)
    assert g.const_ok
    T, _, v = (torch.tensor(a) for a in _inputs(g.n))
    y = g.make_matvec(T, 0.1, stream_dtype=torch.bfloat16)(v)
    vals2 = g.stencil_values(T, 0.1).reshape(27, g.grid[0], -1)
    y_ref = stencil_matvec(vals2.to(torch.bfloat16), v, g.grid)
    assert not bool(g.bc_mask.any())
    assert torch.equal(y, y_ref)
    short = HeatOperator(FunctionSpace(tmesh.box_mesh_3d(2, 4, 3, 1.0, 1.0,
                                                         0.01), "CG", 1),
                         ModelParams(), 0.1, device="cpu")
    assert not GridHeatOperator(short, allow_const=True).const_ok
    line = HeatOperator(FunctionSpace(tmesh.interval_mesh(8), "CG", 1),
                        ModelParams(), 0.1, device="cpu")
    assert not GridHeatOperator(line, allow_const=True).const_ok
