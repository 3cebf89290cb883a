"""Cross-space pointwise interpolation engine.

Counterpart of fem_glass_tempering_tpu/ops/interpolation.py: evaluating a
source-space field at the target space's interpolation points (the
reference's `Function.interpolate(Expression)`, ThermoViscoProblem.py:455-595).
Every target scalar dof has a unique owner (cell, local interpolation
point) — FunctionSpace.owner_cell/owner_lpoint — so interpolation is a
gather plus a small contraction, with no scatter. When source and target
share the space, nodal interpolation is the identity on dof arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace


@dataclass
class CrossEval:
    """Evaluator of source-space fields at a target space's owned
    interpolation points."""

    target: FunctionSpace
    sources: dict                       # name -> FunctionSpace
    _tab: dict = field(default_factory=dict)        # name -> (n_t, nloc_s)
    _src_cells: dict = field(default_factory=dict)  # name -> (n_t, nloc_s) dofs

    def same_space(self, name: str) -> bool:
        src = self.sources[name]
        t = self.target
        return (src.mesh is t.mesh and src.family == t.family
                and src.degree == t.degree)

    def eval(self, name: str, dofs: torch.Tensor) -> torch.Tensor:
        """Evaluate source field `dofs` ((n_src_sdofs, *vshape)) at the
        target's owned points -> (n_target_sdofs, *vshape)."""
        if self.same_space(name):
            return dofs
        src_vals = dofs[self._src_cells[name]]     # (n_t, nloc_s, *v)
        tab = self._tab[name].to(dofs.dtype)       # (n_t, nloc_s)
        return torch.einsum("tl,tl...->t...", tab, src_vals)


def build_cross_eval(target: FunctionSpace, sources: dict,
                     device=None) -> CrossEval:
    device = resolve_device(device)
    ce = CrossEval(target=target, sources=dict(sources))
    ipts = target.element.interpolation_points()   # (nloc_t, tdim)
    oc = target.owner_cell                         # (n_t,)
    olp = target.owner_lpoint
    for name, src in sources.items():
        if ce.same_space(name):
            continue
        tab_full = src.element.tabulate(ipts)      # (nloc_t, nloc_s)
        ce._tab[name] = torch.as_tensor(tab_full[olp], device=device)
        ce._src_cells[name] = torch.as_tensor(
            src.dofmap[oc].astype(np.int64), device=device)
    return ce
