"""Generic weak forms: the custom-PDE surface.

Counterpart of fem_glass_tempering_tpu/ops/forms.py. A weak form is a few
plain PyTorch callables in residual form: for trial / test functions u, v

  F(u; v) = ∫_cells [ a(u, ∇u, x) · v + b(u, ∇u, x) · ∇v ] dx
          + ∫_boundary c(u, x, n) · v ds  (+ interior-facet terms)

with a, b, c vectorised over quadrature-point tensors. The Jacobian is
`torch.func.jvp` of `residual`, as everywhere in the port, so `residual`
plugs into solver/newton.py `newton_solve` (and solver/direct.py
`newton_direct`) as it is.

The geometry tables are the port's ops/assembly.py builders; the sums
into the dofs are the grouped scatter of ops/scatter.py, which adds each
dof's entries in entry order on the CPU and the card alike.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.assembly import (
    build_boundary_geometry,
    build_cell_geometry,
    build_interior_geometry,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter


def jump(u_p, u_m):
    """UFL jump([[u]]) across an interior facet, '+' minus '-' side."""
    return u_p - u_m


def avg(u_p, u_m):
    """UFL avg({u}) across an interior facet."""
    return 0.5 * (u_p + u_m)


class _FormTables:
    """Quadrature tables of a form on `fs`, as device tensors, and the
    grouped scatters of its cell, boundary and interior-facet sums."""

    def __init__(self, fs: FunctionSpace, with_interior: bool,
                 quad_degree, dtype, device):
        self.fs = fs
        self.n_dofs = fs.n_scalar_dofs
        self.dtype = dtype
        self.device = resolve_device(device)
        cg = build_cell_geometry(fs.mesh, fs, quad_degree)
        bg = build_boundary_geometry(fs.mesh, fs, quad_degree,
                                     with_grad=False)
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        i = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64,
                                      device=self.device)
        dm = np.asarray(fs.dofmap)
        self.dofmap = i(dm)
        self.qw = f(cg.qweights)
        self.phi = f(cg.phi)
        self.gphi = f(cg.grad_phys)
        self.xq = f(cg.qpoints_phys)
        self.cell_sum = GroupedScatter(dm, self.n_dofs, self.device)
        b_dm = dm[bg.cell]
        self.b_dofmap = i(b_dm)
        self.b_qw = f(bg.qweights)
        self.b_phi = f(bg.phi)
        self.b_xq = f(bg.qpoints_phys)
        self.b_n = f(bg.normal)
        self.b_sum = GroupedScatter(b_dm, self.n_dofs, self.device)
        if with_interior:
            ig = build_interior_geometry(fs.mesh, fs, quad_degree)
            dm_p, dm_m = dm[ig.cell_p], dm[ig.cell_m]
            self.i_dofmap_p = i(dm_p)
            self.i_dofmap_m = i(dm_m)
            self.i_qw = f(ig.qweights)
            self.i_phi_p = f(ig.phi_p)
            self.i_phi_m = f(ig.phi_m)
            self.i_dn_p = f(np.einsum("fqlg,fqg->fql", ig.grad_p,
                                      ig.normal_p))
            self.i_dn_m = f(np.einsum("fqlg,fqg->fql", ig.grad_m,
                                      ig.normal_p))
            self.i_n = f(ig.normal_p)
            self.i_h = f(ig.h_p)
            self.i_xq = f(ig.qpoints_phys)
            self.i_sum_p = GroupedScatter(dm_p, self.n_dofs, self.device)
            self.i_sum_m = GroupedScatter(dm_m, self.n_dofs, self.device)


class ScalarResidualForm(_FormTables):
    """Assembled residual of a generic scalar weak form on a CG/DG space.

    Arguments are vectorised over quadrature points:
      cell_source   a(u, grad_u, x, **p) -> (c, q)        [multiplies v]
      cell_flux     b(u, grad_u, x, **p) -> (c, q, gdim)  [dotted with grad v]
      boundary_flux c(u, x, n, **p)      -> (f, q)        [multiplies v on ds]
      interior_flux d(u_p, u_m, dn_u_p, dn_u_m, x, n, h, **p)
                    -> (a_p, a_m, b_p, b_m), each (f, q)
    Each may be None; keyword parameters of `residual` reach every
    callable. On an interior facet u_p / u_m are the '+' / '-' traces,
    dn_u_* = grad(u_*) . n with n the '+'-outward unit normal for both
    sides, h (f,) the penalty length vol(K+)/area(F), and

      r_p += sum_q w [ a_p v_p + b_p dn_v_p ],  r_m likewise,

    which spans SIPG, upwind fluxes and Nitsche couplings (the JAX
    version's docstring). `bc_dofs` are held at `bc_values` (rows
    u - bc_values)."""

    def __init__(self, fs: FunctionSpace,
                 cell_source: Callable | None = None,
                 cell_flux: Callable | None = None,
                 boundary_flux: Callable | None = None,
                 interior_flux: Callable | None = None,
                 quad_degree: int | None = None,
                 dtype=torch.float64,
                 bc_dofs: np.ndarray | None = None,
                 bc_values: np.ndarray | float | None = None,
                 device=None):
        super().__init__(fs, interior_flux is not None, quad_degree, dtype,
                         device)
        self.cell_source = cell_source
        self.cell_flux = cell_flux
        self.boundary_flux = boundary_flux
        self.interior_flux = interior_flux
        mask = np.zeros(self.n_dofs, dtype=bool)
        vals = np.zeros(self.n_dofs)
        if bc_dofs is not None and len(bc_dofs):
            mask[np.asarray(bc_dofs)] = True
            vals[np.asarray(bc_dofs)] = (bc_values if bc_values is not None
                                         else 0.0)
        self.bc_mask = torch.as_tensor(mask, device=self.device)
        self.has_bc = bool(mask.any())
        self.bc_values = torch.as_tensor(vals, dtype=dtype,
                                         device=self.device)

    def _base_residual(self, u: torch.Tensor, **params) -> torch.Tensor:
        uc = u[self.dofmap]                                    # (c, l)
        uq = uc @ self.phi.T                                   # (c, q)
        guq = torch.einsum("cl,cqlg->cqg", uc, self.gphi)      # (c, q, g)
        r = torch.zeros(self.n_dofs, dtype=u.dtype, device=u.device)
        r_cell = None
        if self.cell_source is not None:
            a = self.cell_source(uq, guq, self.xq, **params)
            r_cell = torch.einsum("cq,ql->cl", self.qw * a, self.phi)
        if self.cell_flux is not None:
            b = self.cell_flux(uq, guq, self.xq, **params)
            term = torch.einsum("cqg,cqlg->cl", self.qw[..., None] * b,
                                self.gphi)
            r_cell = term if r_cell is None else r_cell + term
        if r_cell is not None:
            r = r + self.cell_sum(r_cell)
        if self.boundary_flux is not None and self.b_dofmap.shape[0]:
            ub = torch.einsum("fql,fl->fq", self.b_phi, u[self.b_dofmap])
            c = self.boundary_flux(ub, self.b_xq, self.b_n, **params)
            r_b = torch.einsum("fq,fql->fl", self.b_qw * c, self.b_phi)
            r = r + self.b_sum(r_b)
        if self.interior_flux is not None and self.i_dofmap_p.shape[0]:
            u_p, u_m = u[self.i_dofmap_p], u[self.i_dofmap_m]
            up = torch.einsum("fql,fl->fq", self.i_phi_p, u_p)
            um = torch.einsum("fql,fl->fq", self.i_phi_m, u_m)
            dup = torch.einsum("fql,fl->fq", self.i_dn_p, u_p)
            dum = torch.einsum("fql,fl->fq", self.i_dn_m, u_m)
            a_p, a_m, b_p, b_m = self.interior_flux(
                up, um, dup, dum, self.i_xq, self.i_n, self.i_h, **params)
            r_p = (torch.einsum("fq,fql->fl", self.i_qw * a_p, self.i_phi_p)
                   + torch.einsum("fq,fql->fl", self.i_qw * b_p, self.i_dn_p))
            r_m = (torch.einsum("fq,fql->fl", self.i_qw * a_m, self.i_phi_m)
                   + torch.einsum("fq,fql->fl", self.i_qw * b_m, self.i_dn_m))
            r = r + self.i_sum_p(r_p)
            r = r + self.i_sum_m(r_m)
        return r

    def residual(self, u: torch.Tensor, **params) -> torch.Tensor:
        if not self.has_bc:
            return self._base_residual(u, **params)
        u_eff = torch.where(self.bc_mask, self.bc_values, u)
        r = self._base_residual(u_eff, **params)
        return torch.where(self.bc_mask, u - self.bc_values, r)


class VectorResidualForm(_FormTables):
    """Generic weak form for vector / tensor-valued fields. For a field u
    of value shape V (e.g. (d,) displacement):

      F(u; v) = ∫ [ a(u, ∇u, x) · v + b(u, ∇u, x) : ∇v ] dx
              + ∫_∂ c(u, x, n) · v ds  (+ interior-facet terms)

      cell_source   a(uq, guq, xq, **p) -> (c, q, *V)
      cell_flux     b(uq, guq, xq, **p) -> (c, q, *V, gdim)   [:: ∇v]
      boundary_flux c(ub, xb, n, **p)   -> (f, q, *V)
      interior_flux as ScalarResidualForm's, each output (f, q, *V)

    with uq (c, q, *V) and guq (c, q, *V, gdim). `pin_mask` (broadcastable
    to (n_dofs, *V), nonzero = held at `pin_values`) imposes component-wise
    point constraints."""

    def __init__(self, fs: FunctionSpace, value_shape: tuple,
                 cell_source: Callable | None = None,
                 cell_flux: Callable | None = None,
                 boundary_flux: Callable | None = None,
                 interior_flux: Callable | None = None,
                 quad_degree: int | None = None,
                 dtype=torch.float64,
                 pin_mask: np.ndarray | None = None,
                 pin_values: np.ndarray | float = 0.0,
                 device=None):
        super().__init__(fs, interior_flux is not None, quad_degree, dtype,
                         device)
        self.value_shape = tuple(value_shape)
        self.cell_source = cell_source
        self.cell_flux = cell_flux
        self.boundary_flux = boundary_flux
        self.interior_flux = interior_flux
        self.has_pins = pin_mask is not None
        if self.has_pins:
            shape = (self.n_dofs,) + self.value_shape
            self.pin_mask = torch.as_tensor(
                np.broadcast_to(np.asarray(pin_mask), shape).copy(),
                dtype=dtype, device=self.device)
            self.pin_values = torch.as_tensor(
                np.broadcast_to(np.asarray(pin_values), shape).copy(),
                dtype=dtype, device=self.device)

    def _base_residual(self, u: torch.Tensor, **params) -> torch.Tensor:
        V = self.value_shape
        uc = u[self.dofmap]                                    # (c, l, *V)
        uq = torch.einsum("ql,cl...->cq...", self.phi, uc)     # (c, q, *V)
        guq = torch.einsum("cqlg,cl...->cq...g", self.gphi, uc)
        r = torch.zeros((self.n_dofs,) + V, dtype=u.dtype, device=u.device)
        r_cell = None
        if self.cell_source is not None:
            a = self.cell_source(uq, guq, self.xq, **params)
            r_cell = torch.einsum("cq,cq...,ql->cl...", self.qw, a, self.phi)
        if self.cell_flux is not None:
            b = self.cell_flux(uq, guq, self.xq, **params)
            term = torch.einsum("cq,cq...g,cqlg->cl...", self.qw, b,
                                self.gphi)
            r_cell = term if r_cell is None else r_cell + term
        if r_cell is not None:
            r = r + self.cell_sum(r_cell, V)
        if self.boundary_flux is not None and self.b_dofmap.shape[0]:
            ub = torch.einsum("fql,fl...->fq...", self.b_phi,
                              u[self.b_dofmap])
            c = self.boundary_flux(ub, self.b_xq, self.b_n, **params)
            r_b = torch.einsum("fq,fq...,fql->fl...", self.b_qw, c,
                               self.b_phi)
            r = r + self.b_sum(r_b, V)
        if self.interior_flux is not None and self.i_dofmap_p.shape[0]:
            u_p, u_m = u[self.i_dofmap_p], u[self.i_dofmap_m]
            up = torch.einsum("fql,fl...->fq...", self.i_phi_p, u_p)
            um = torch.einsum("fql,fl...->fq...", self.i_phi_m, u_m)
            dup = torch.einsum("fql,fl...->fq...", self.i_dn_p, u_p)
            dum = torch.einsum("fql,fl...->fq...", self.i_dn_m, u_m)
            a_p, a_m, b_p, b_m = self.interior_flux(
                up, um, dup, dum, self.i_xq, self.i_n, self.i_h, **params)
            r_p = (torch.einsum("fq,fq...,fql->fl...", self.i_qw, a_p,
                                self.i_phi_p)
                   + torch.einsum("fq,fq...,fql->fl...", self.i_qw, b_p,
                                  self.i_dn_p))
            r_m = (torch.einsum("fq,fq...,fql->fl...", self.i_qw, a_m,
                                self.i_phi_m)
                   + torch.einsum("fq,fq...,fql->fl...", self.i_qw, b_m,
                                  self.i_dn_m))
            r = r + self.i_sum_p(r_p, V)
            r = r + self.i_sum_m(r_m, V)
        return r

    def residual(self, u: torch.Tensor, **params) -> torch.Tensor:
        if not self.has_pins:
            return self._base_residual(u, **params)
        u_eff = torch.where(self.pin_mask > 0, self.pin_values, u)
        r = self._base_residual(u_eff, **params)
        return torch.where(self.pin_mask > 0, u - self.pin_values, r)
