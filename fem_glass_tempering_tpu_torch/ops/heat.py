"""The nonlinear heat operator: residual + exact Jacobi diagonal (CG).

Counterpart of fem_glass_tempering_tpu/ops/heat.py. Implements the
reference's weak form (ThermoViscoProblem.py:293-306):

  F(T) = (T - T_prev) v dx
       + dt * ( alpha grad(T).grad(v) dx - f v dx
              + s*(sigma_SB*eps)*(T^4 - T_amb^4) v ds
              + s*htc*(T - T_amb) v ds )

with s = 0.001 the reference's boundary scale. Geometry factors are
setup-time numpy copied to the device; assembly is gather -> einsum ->
`index_add_`. The Jacobian action is `torch.func.jvp` of `residual`
(solver/newton.py); `jacobian_diag` is exact.

This slice ports the CG path. The SIPG terms of a DG temperature space
wait for Slice 2 of the port (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.thermal import ThermalModel
from fem_glass_tempering_tpu_torch.ops.assembly import (
    build_boundary_geometry,
    build_cell_geometry,
)


class HeatOperator:
    def __init__(self, fs: FunctionSpace, params: ModelParams, dt: float,
                 dtype=torch.float64, device=None,
                 quad_degree: int | None = None,
                 bc_dofs: np.ndarray | None = None,
                 bc_value: float | None = None,
                 source: np.ndarray | None = None,
                 flux_marker=None, form: str = "reference"):
        if fs.family == "DG":
            raise NotImplementedError(
                "the DG-1/SIPG heat operator waits for Slice 2 of the port "
                "(ROADMAP.md)")
        self.fs = fs
        self.params = params
        self.dt = float(dt)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.form = form
        self.c_mass, self.c_diff = ThermalModel.from_params(
            params).coefficients(form)
        mesh = fs.mesh
        self.n_dofs = fs.n_scalar_dofs

        cg = build_cell_geometry(mesh, fs, quad_degree)
        # boundary default degree 5p: the T^4 radiation integrand
        bq = quad_degree if quad_degree is not None else 5 * fs.degree
        bg = build_boundary_geometry(mesh, fs, bq)
        # optional selective flux boundary: marker(midpoints) -> bool mask
        if flux_marker is not None and len(bg.cell):
            mids = bg.qpoints_phys.mean(axis=1)
            keep = np.asarray(flux_marker(mids), dtype=bool)
            bg = type(bg)(
                cell=bg.cell[keep], qweights=bg.qweights[keep],
                phi=bg.phi[keep], grad_phys=bg.grad_phys[keep],
                normal=bg.normal[keep], qpoints_phys=bg.qpoints_phys[keep])
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=self.device)

        # numpy sources retained for setup-time consumers
        # (StencilMatrix, GridHeatOperator)
        self.np_dofmap = fs.dofmap
        self.np_phi = np.asarray(cg.phi)
        self.np_b_dofmap = fs.dofmap[bg.cell]
        self.np_b_qw = np.asarray(bg.qweights)
        self.np_b_phi = np.asarray(bg.phi)

        self.dofmap = i64(fs.dofmap)                      # (c, l)
        # uniform box meshes: all cells congruent -> single-cell tables
        self.uniform = mesh.structured is not None
        if self.uniform:
            self.np_qw = np.asarray(cg.qweights[0])
            self.np_gphi = np.asarray(cg.grad_phys[0])
        else:
            self.np_qw = np.asarray(cg.qweights)
            self.np_gphi = np.asarray(cg.grad_phys)
        self.qw = f(self.np_qw)
        self.gphi = f(self.np_gphi)
        self.phi = f(cg.phi)                              # (q, l)

        self.b_dofmap = i64(self.np_b_dofmap)             # (f, l)
        self.b_qw = f(bg.qweights)                        # (f, q)
        self.b_phi = f(bg.phi)                            # (f, q, l)

        # optional spatially varying source field (dof array of fs)
        if source is not None:
            self.source_q = f(np.einsum("ql,cl->cq", np.asarray(cg.phi),
                                        np.asarray(source)[fs.dofmap]))
        else:
            self.source_q = None

        # Dirichlet lifting
        mask = np.zeros(self.n_dofs, dtype=bool)
        vals = np.zeros(self.n_dofs)
        if bc_dofs is not None and len(bc_dofs):
            mask[np.asarray(bc_dofs)] = True
            vals[np.asarray(bc_dofs)] = bc_value if bc_value is not None else 0.0
        self.np_bc_mask = mask
        self.bc_mask = torch.as_tensor(mask, device=self.device)
        self.has_bc = bool(mask.any())
        self.bc_values = f(vals)

        self._const_diag = self._build_constant_diag()

    # ------------------------------------------------------------------
    def _scatter(self, vals_cell: torch.Tensor,
                 dofmap: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n_dofs, dtype=vals_cell.dtype,
                          device=vals_cell.device)
        return out.index_add(0, dofmap.reshape(-1), vals_cell.reshape(-1))

    def _base_residual(self, T, T_prev, dt=None):
        p = self.params
        dt = self.dt if dt is None else dt
        # ---- cell integrals ----
        Tc = T[self.dofmap]                                # (c, l)
        Tpc = T_prev[self.dofmap]
        Tq = Tc @ self.phi.T                               # (c, q)
        Tpq = Tpc @ self.phi.T
        if self.uniform:
            gTq = torch.einsum("cl,qlg->cqg", Tc, self.gphi)
        else:
            gTq = torch.einsum("cl,cqlg->cqg", Tc, self.gphi)
        f_q = p.f if self.source_q is None else p.f + self.source_q
        mass_src = self.qw * (self.c_mass * (Tq - Tpq) - dt * f_q)
        r_cell = torch.einsum("cq,ql->cl", mass_src, self.phi)
        if self.uniform:
            r_cell = r_cell + dt * self.c_diff * torch.einsum(
                "cqg,qlg->cl", self.qw[None, :, None] * gTq, self.gphi)
        else:
            r_cell = r_cell + dt * self.c_diff * torch.einsum(
                "cqg,cqlg->cl", self.qw[..., None] * gTq, self.gphi)
        r = self._scatter(r_cell, self.dofmap)

        # ---- boundary (radiation + convection, Robin-type) ----
        Tb = torch.einsum("fql,fl->fq", self.b_phi, T[self.b_dofmap])
        gflux = p.boundary_scale * (
            (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
            + p.htc * (Tb - p.T_ambient)
        )
        r_b = torch.einsum("fq,fql->fl", self.b_qw * dt * gflux, self.b_phi)
        return r + self._scatter(r_b, self.b_dofmap)

    def residual(self, T, T_prev, dt=None):
        """Assembled residual, with Dirichlet lifting if configured."""
        if not self.has_bc:
            return self._base_residual(T, T_prev, dt)
        T_eff = torch.where(self.bc_mask, self.bc_values, T)
        r = self._base_residual(T_eff, T_prev, dt)
        return torch.where(self.bc_mask, T - self.bc_values, r)

    # ------------------------------------------------------------------
    def _build_constant_diag(self) -> tuple:
        """T-independent parts of diag(J) as (mass_diag, stiff_diag), with
        diag = mass + dt * stiff; assembled in numpy."""
        c = self.np_dofmap.shape[0]
        n = self.n_dofs
        phi = self.np_phi

        def scat(vals_cell, dofmap):
            return np.bincount(dofmap.reshape(-1),
                               weights=vals_cell.reshape(-1), minlength=n)

        if self.uniform:
            dm_row = self.c_mass * np.einsum(
                "q,ql,ql->l", self.np_qw, phi, phi)
            ds_row = self.c_diff * np.einsum(
                "q,qlg,qlg->l", self.np_qw, self.np_gphi, self.np_gphi)
            d_mass = scat(np.broadcast_to(dm_row, (c,) + dm_row.shape),
                          self.np_dofmap)
            d_stiff = scat(np.broadcast_to(ds_row, (c,) + ds_row.shape),
                           self.np_dofmap)
        else:
            d_mass = scat(self.c_mass * np.einsum(
                "cq,ql,ql->cl", self.np_qw, phi, phi), self.np_dofmap)
            d_stiff = scat(self.c_diff * np.einsum(
                "cq,cqlg,cqlg->cl", self.np_qw, self.np_gphi, self.np_gphi),
                self.np_dofmap)
        f = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        return f(d_mass), f(d_stiff)

    def jacobian_diag(self, T, dt=None):
        """Exact diag(dF/dT) at T — Jacobi preconditioner for CG."""
        p = self.params
        dt = self.dt if dt is None else dt
        Tb = torch.einsum("fql,fl->fq", self.b_phi, T[self.b_dofmap])
        dflux = p.boundary_scale * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
        d_b = torch.einsum(
            "fq,fql,fql->fl", self.b_qw * dt * dflux, self.b_phi, self.b_phi)
        d_mass, d_stiff = self._const_diag
        d = d_mass + dt * d_stiff + self._scatter(d_b, self.b_dofmap)
        if self.has_bc:
            d = torch.where(self.bc_mask, torch.ones_like(d), d)
        return d
