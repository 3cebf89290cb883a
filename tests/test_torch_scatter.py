"""The grouped scatter-add of the PyTorch port (ops/scatter.py) against
the sequential `index_add` it replaces, on the CPU: equal bit for bit on
the index maps the port scatters over, since every target receives its
addends in entry order either way. (On the card the groups make the sums
repeat from run to run: tests/test_torch_cuda_kernels.py.)"""

import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.scatter import (
    GroupedScatter,
    occurrence_groups,
)
from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
from fem_glass_tempering_tpu_torch.ops.stencil import (
    DGStencilMatrix,
    StencilMatrix,
)


def _maps():
    """name -> (flat index, number of targets)."""
    hex3 = FunctionSpace(tmesh.box_mesh_3d(5, 4, 3), "CG", 1)
    quad = FunctionSpace(tmesh.box_mesh_2d(6, 5), "CG", 1)
    dg = HeatOperator(FunctionSpace(tmesh.box_mesh_3d(3, 3, 2, 1.0, 1.0,
                                                      0.1), "DG", 1),
                      ModelParams(), 0.1, device="cpu")
    cg_op = HeatOperator(quad, ModelParams(), 0.1, device="cpu")
    ell = EllMatrix(cg_op)
    st = StencilMatrix(cg_op, make_tables=False)
    dgs = DGStencilMatrix(dg)
    return {
        "cg1_hex_dofmap": (hex3.dofmap, hex3.n_scalar_dofs),
        "cg1_quad_dofmap": (quad.dofmap, quad.n_scalar_dofs),
        "cg1_boundary_dofmap": (cg_op.np_b_dofmap, cg_op.n_dofs),
        "sipg_plus": (dg.np_i["dofmap_p"], dg.n_dofs),
        "sipg_minus": (dg.np_i["dofmap_m"], dg.n_dofs),
        "dg_cell_dofmap": (dg.np_dofmap, dg.n_dofs),
        "ell_boundary_blocks": (ell.np_b_flat_idx, ell.n * ell.K),
        "stencil_boundary_blocks": (st.np_b_st_idx, st.n_off * st.n),
        "dg_stencil_boundary_cells": (dgs.b_cell.numpy(), dgs.C),
    }


MAPS = _maps()


@pytest.mark.parametrize("trailing", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_grouped_scatter_equals_sequential_index_add(name, dtype, trailing):
    index, n = MAPS[name]
    flat = np.asarray(index, dtype=np.int64).reshape(-1)
    rng = np.random.default_rng(len(flat))
    src = torch.tensor(rng.standard_normal((len(flat),) + trailing) * 10.0
                       ** rng.integers(-8, 8, (len(flat),) + trailing),
                       dtype=dtype)
    sc = GroupedScatter(index, n, "cpu")
    want = torch.zeros((n,) + trailing, dtype=dtype).index_add_(
        0, torch.as_tensor(flat), src)
    assert torch.equal(sc(src, trailing), want)
    base = torch.tensor(rng.standard_normal((n,) + trailing), dtype=dtype)
    assert torch.equal(sc.add_(base.clone(), src),
                       base.clone().index_add_(0, torch.as_tensor(flat), src))
    repeats = np.bincount(flat).max()
    assert sc.n_groups == (repeats if repeats > 1 else 1)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_groups_hold_distinct_targets_in_entry_order(name):
    flat = np.asarray(MAPS[name][0]).reshape(-1)
    groups = occurrence_groups(flat)
    assert sorted(np.concatenate(groups).tolist()) == list(range(len(flat)))
    for k, g in enumerate(groups):
        assert len(np.unique(flat[g])) == len(g)
        assert np.all(np.diff(g) > 0)
        if k:
            # an entry of group k follows its target's entry in group k-1
            prev = dict(zip(flat[groups[k - 1]], groups[k - 1]))
            assert all(prev[flat[i]] < i for i in g)


def test_jvp_through_the_grouped_scatter():
    """The heat residual runs under torch.func.jvp: the grouped adds carry
    the tangent like index_add does."""
    index, n = MAPS["cg1_hex_dofmap"]
    flat = torch.as_tensor(np.asarray(index).reshape(-1))
    sc = GroupedScatter(index, n, "cpu")
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(len(flat)))
    v = torch.tensor(rng.standard_normal(len(flat)))
    got = torch.func.jvp(lambda u: sc(u * u), (x,), (v,))
    want = torch.func.jvp(lambda u: torch.zeros(n, dtype=u.dtype).index_add(
        0, flat, u * u), (x,), (v,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
