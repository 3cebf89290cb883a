"""Cell-axis sharding of a ThermoViscoProblem over torch.distributed ranks.

Counterpart of fem_glass_tempering_tpu/parallel/sharding.py. There GSPMD
places the heat operator's per-cell and per-facet arrays across a 1-axis
device mesh, keeps dof vectors replicated, and XLA turns the segment-sum
partials of the assembly into a psum. Here each rank is a process that
holds the same rows JAX's device r holds (contiguous blocks of ceil(n/P)
cells, boundary facets and interior facets in index order, the last
blocks shorter), assembles its partials over them, and sums the residual
and the boundary part of the Jacobi diagonal with `all_reduce_sum`
(parallel/comm.py), which carries the Newton loop's torch.func.jvp.

Nothing is padded: each process has shapes of its own, so uniform tables
stay uniform and the cell kernel (K3) keeps its by-value path on each
rank's cells. Dof vectors, the state, the constant diagonal, the Dirichlet
data and everything the solver holds (grid operators, ELL, stencils,
multigrid hierarchies, the f32 twin of mixed precision) stay whole and
replicated, as in the JAX version: every rank runs the same solve on the
same numbers, so all ranks take the same iteration counts (a rank that
took another would leave the others waiting in a collective).

Usage:
    mesh_dev = make_device_mesh(device)     # parallel/comm.py
    shard_problem(prob, mesh_dev)           # after setup()
    prob.solve()
"""

from __future__ import annotations

from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState
from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
    PreparedDGCellResidual,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.parallel.comm import (  # noqa: F401
    DeviceMesh,
    all_reduce_sum,
    make_device_mesh,
)

_INTERIOR = ("i_dofmap_p", "i_dofmap_m", "i_qw", "i_phi_p", "i_phi_m",
             "i_dnphi_p", "i_dnphi_m", "i_h_p")


def block_rows(n: int, mesh: DeviceMesh) -> tuple[int, int]:
    """Rows [lo, hi) of this rank on an axis of n rows: JAX's shard of the
    axis zero-padded to a multiple of P (ceil(n/P) rows a rank)."""
    m = -(-n // mesh.size)
    lo = min(mesh.rank * m, n)
    return lo, min(lo + m, n)


class ShardedHeatOperator(HeatOperator):
    """A HeatOperator restricted to this rank's cells and facets, whose
    residual and boundary diagonal are summed over the ranks. It shares
    every other attribute with the whole operator `whole`, which the
    solver's own operators keep reading."""

    def __init__(self, op: HeatOperator, mesh: DeviceMesh):
        if isinstance(op, ShardedHeatOperator):
            raise ValueError("the heat operator is sharded already")
        if op.device != mesh.device:
            raise ValueError(f"the operator lies on {op.device}, the device "
                             f"mesh's rank on {mesh.device}")
        self.__dict__.update(op.__dict__)
        self.whole = op
        self.comm = mesh
        n_cells = op.np_dofmap.shape[0]
        c0, c1 = block_rows(n_cells, mesh)
        b0, b1 = block_rows(op.np_b_dofmap.shape[0], mesh)
        self.rows = {"cells": (c0, c1), "boundary": (b0, b1)}
        self.dofmap = op.dofmap[c0:c1]
        self._sc_cell = GroupedScatter(op.np_dofmap[c0:c1], self.n_dofs,
                                       self.device)
        if not self.uniform:
            self.qw, self.gphi = op.qw[c0:c1], op.gphi[c0:c1]
        if op.source_q is not None:
            self.source_q = op.source_q[c0:c1]
        self._cell_term = PreparedDGCellResidual(
            self.qw, self.gphi, self.phi, self.source_q)
        self.b_dofmap = op.b_dofmap[b0:b1]
        self.b_qw, self.b_phi = op.b_qw[b0:b1], op.b_phi[b0:b1]
        self._sc_b = GroupedScatter(op.np_b_dofmap[b0:b1], self.n_dofs,
                                    self.device)
        if self.is_dg:
            self.rows["interior"] = block_rows(
                op.np_i["dofmap_p"].shape[0], mesh)
            for name in _INTERIOR:
                setattr(self, name, None)
            if op.i_qw is not None:
                self.ensure_interior_tables()

    def ensure_interior_tables(self) -> None:
        """This rank's rows of the whole operator's interior-facet tables."""
        if not self.is_dg or self.i_qw is not None:
            return
        self.whole.ensure_interior_tables()
        lo, hi = self.rows["interior"]
        for name in _INTERIOR:
            setattr(self, name, getattr(self.whole, name)[lo:hi])
        self._sc_p = GroupedScatter(self.np_i["dofmap_p"][lo:hi],
                                    self.n_dofs, self.device)
        self._sc_m = GroupedScatter(self.np_i["dofmap_m"][lo:hi],
                                    self.n_dofs, self.device)

    def _reduce(self, partial):
        return all_reduce_sum(partial, self.comm)


def shard_heat_operator(op: HeatOperator, mesh: DeviceMesh
                        ) -> ShardedHeatOperator:
    """This rank's share of `op` (JAX's shard_heat_operator, which moves
    the arrays of `op` itself; here `op` stays whole for the operators
    that the solver built from it)."""
    return ShardedHeatOperator(op, mesh)


def shard_state(state: ViscoState, mesh: DeviceMesh) -> ViscoState:
    """The state, replicated: every rank holds all of it on its device."""
    return ViscoState(*(None if t is None else t.to(mesh.device)
                        for t in state))


def shard_problem(prob, mesh: DeviceMesh) -> None:
    """Shard a ThermoViscoProblem in place (after setup()): its heat
    operator becomes this rank's ShardedHeatOperator and the step is built
    again. The material chain stays replicated."""
    if prob.heat is None:
        raise RuntimeError("call setup() first")
    if (prob.heat.is_dg
            and prob.config.solver.linear_operator != "stencil"):
        # the matrix-free / assembled DG step reads the interior facet
        # tables on the device
        prob.heat.ensure_interior_tables()
    prob.heat = shard_heat_operator(prob.heat, mesh)
    prob.state = shard_state(prob.state, mesh)
    prob._build_step()

