"""The DG block stencil of the PyTorch port (ops/stencil.py DGStencilMatrix)
against the JAX package's, on the CPU in f64.

Both forms are held to JAX's at rtol 1e-12 of max|value| per array: the
table form (allow_const=False, what the DG multigrid and the "mg" path
use) and the constant-block form (allow_const=True, what
linear_operator="stencil" builds under any other preconditioner). Cases:
DG-1 on a 4x3x2 hex plate (with and without a Dirichlet mask), DG-1 and
DG-2 on a 5x4 quad box. The Jacobian action is also held to
torch.func.jvp of the port's own HeatOperator.residual at rtol 1e-10 (the
JAX package's test_spmv.py tolerance), the residual and diagonal to the
heat operator's, and the per-cell cross-block fallback to the constant
blocks. Both sides run the same formulas on numpy-identical tables; what
differs is the order of a few short sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.stencil import DGStencilMatrix as JDG
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat
from fem_glass_tempering_tpu_torch.ops.stencil import (
    DGStencilMatrix,
    StencilMatrix,
    make_stencil_operator,
)
from fem_glass_tempering_tpu_torch.ops.scatter import occurrence_groups

MESHES = {
    "hex3d": (lambda m: m.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01), 1),
    "quad2d": (lambda m: m.box_mesh_2d(5, 4, 1.0, 0.5), 1),
    "quad2d_p2": (lambda m: m.box_mesh_2d(5, 4, 1.0, 0.5), 2),
}
CASES = [("hex3d", False), ("hex3d", True), ("quad2d", False),
         ("quad2d_p2", False)]
DT = 0.1


def _close(a, b, what, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300),
        err_msg=what)


def _ops(name, dirichlet=False):
    """JAX and port heat operators of one case, and seeded inputs."""
    build, deg = MESHES[name]
    jm, tm = build(jmesh), build(tmesh)
    jfs, tfs = JFS(jm, "DG", deg), TFS(tm, "DG", deg)
    kw = {}
    if dirichlet:
        bd = tfs.boundary_scalar_dofs()
        kw = dict(bc_dofs=bd, bc_value=500.0)
    jop = JHeat(jfs, JParams(), DT, dtype=jnp.float64, **kw)
    top = THeat(tfs, ModelParams(), DT, dtype=torch.float64, device="cpu",
                **kw)
    rng = np.random.default_rng(3)
    n = tfs.n_scalar_dofs
    inputs = dict(T=700 + 100 * rng.random(n), Tp=700 + 100 * rng.random(n),
                  v=rng.standard_normal(n))
    return jop, top, inputs


@pytest.mark.parametrize("allow_const", [False, True],
                         ids=["tables", "const"])
@pytest.mark.parametrize("name,dirichlet", CASES)
def test_block_stencil_matches_jax(name, dirichlet, allow_const):
    jop, top, x = _ops(name, dirichlet)
    js = JDG(jop, allow_const=allow_const)
    ts = DGStencilMatrix(top, allow_const=allow_const)
    assert ts.cross_const and js.cross_const
    assert ts.self_const == js.self_const == allow_const
    assert (ts.self_mass is None) == allow_const
    T, Tp, v = (torch.tensor(x[k]) for k in ("T", "Tp", "v"))
    jT, jTp, jv = (jnp.asarray(x[k]) for k in ("T", "Tp", "v"))
    _close(ts.make_matvec(T, DT)(v), js.make_matvec(jT, DT)(jv), "matvec")
    _close(ts.residual(T, Tp, DT), js.residual(jT, jTp, DT), "residual")
    _close(ts.jacobian_diag(T, DT), js.jacobian_diag(jT, DT), "diag")
    _close(ts.values_at(T, DT), js.values_at(jT, DT), "values_at")
    # the host copies DGMultigrid.freeze reads
    _close(ts.np_self_mass, js.np_self_mass, "np_self_mass")
    _close(ts.np_self_stiff, js.np_self_stiff, "np_self_stiff")
    for a in range(ts.d):
        _close(ts.np_Bp[a], js.np_Bp[a], f"np_Bp[{a}]")
        _close(ts.np_Bm[a], js.np_Bm[a], f"np_Bm[{a}]")


@pytest.mark.parametrize("allow_const", [False, True],
                         ids=["tables", "const"])
@pytest.mark.parametrize("name,dirichlet", CASES)
def test_block_stencil_matches_the_heat_operator(name, dirichlet,
                                                 allow_const):
    """Jacobian action against jvp of HeatOperator.residual (rtol 1e-10),
    residual and diagonal against the heat operator's (rtol 1e-10 of
    max|value|: the stencil's residual applies the stiffness to T - mean
    T, a different rounding of the same sum)."""
    _, top, x = _ops(name, dirichlet)
    ts = DGStencilMatrix(top, allow_const=allow_const)
    T, Tp, v = (torch.tensor(x[k]) for k in ("T", "Tp", "v"))
    jv = torch.func.jvp(lambda u: top.residual(u, Tp, DT), (T,), (v,))[1]
    np.testing.assert_allclose(ts.make_matvec(T, DT)(v).numpy(), jv.numpy(),
                               rtol=1e-10, atol=1e-12)
    _close(ts.residual(T, Tp, DT), top.residual(T, Tp, DT), "residual",
           rtol=1e-10)
    _close(ts.jacobian_diag(T, DT), top.jacobian_diag(T, DT), "diag",
           rtol=1e-10)


def test_per_cell_cross_blocks_match_the_constant_ones():
    """The fallback for meshes whose facets differ (cross_const False):
    per-cell cross blocks, zero where a cell has no neighbour, give the
    constant blocks' matvec and residual."""
    _, top, x = _ops("hex3d")
    ts = DGStencilMatrix(top, allow_const=False)
    tw = DGStencilMatrix(top, allow_const=False)
    C, nloc, d, dims = tw.C, tw.nloc, tw.d, tw.cell_dims
    idx = np.stack(np.unravel_index(np.arange(C), dims), axis=-1)
    Bp = np.zeros((d, C, nloc, nloc))
    Bm = np.zeros((d, C, nloc, nloc))
    for a in range(d):
        Bp[a, idx[:, a] < dims[a] - 1] = tw.np_Bp[a]
        Bm[a, idx[:, a] > 0] = tw.np_Bm[a]
    tw.cross_const = False
    tw.Bp_cells, tw.Bm_cells = torch.tensor(Bp), torch.tensor(Bm)
    T, Tp, v = (torch.tensor(x[k]) for k in ("T", "Tp", "v"))
    _close(tw.make_matvec(T, DT)(v), ts.make_matvec(T, DT)(v), "matvec")
    _close(tw.residual(T, Tp, DT), ts.residual(T, Tp, DT), "residual")


@pytest.mark.parametrize("name", ["hex3d", "quad2d"])
def test_boundary_groups_hold_distinct_cells(name):
    """The boundary facets split into at most 2d groups of distinct cells
    that cover every facet once, each group in facet order."""
    _, top, _ = _ops(name)
    ts = DGStencilMatrix(top)
    cells = top.np_b_dofmap[:, 0] // ts.nloc
    groups = occurrence_groups(cells)
    assert 1 < len(groups) <= 2 * ts.d
    seen = np.concatenate(groups)
    assert sorted(seen.tolist()) == list(range(len(cells)))
    for g in groups:
        assert len(np.unique(cells[g])) == len(g)
        assert np.all(np.diff(g) > 0)
    assert [b - a for a, b in ts._sc_b.bounds] == [len(g) for g in groups]


def test_make_stencil_operator_picks_the_space():
    _, top, _ = _ops("hex3d")
    assert isinstance(make_stencil_operator(top), DGStencilMatrix)
    assert make_stencil_operator(top).self_const
    assert not make_stencil_operator(top, allow_const=False).self_const
    cg = THeat(TFS(tmesh.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01), "CG", 1),
               ModelParams(), DT, dtype=torch.float64, device="cpu")
    assert isinstance(make_stencil_operator(cg), StencilMatrix)
    with pytest.raises(ValueError, match="DG space"):
        DGStencilMatrix(cg)
