"""The nonlinear heat operator: residual + exact Jacobi diagonal.

Counterpart of fem_glass_tempering_tpu/ops/heat.py. Implements the
reference's weak form (ThermoViscoProblem.py:293-306):

  F(T) = (T - T_prev) v dx
       + dt * ( alpha grad(T).grad(v) dx - f v dx
              + s*(sigma_SB*eps)*(T^4 - T_amb^4) v ds
              + s*htc*(T - T_amb) v ds )
       [+ dt * alpha * SIPG interior-penalty terms when T is DG]

with s = 0.001 the reference's boundary scale. The SIPG terms are

  (penalty/h+) <[[v n]],[[T n]]> - <{grad v},[[T n]]> - <[[v n]],{grad T}>

(ThermoViscoProblem.py:318-325) with penalty = 5.0 and h = the '+' cell's
measure over the facet's (ops/assembly.py build_interior_geometry).
Geometry factors are setup-time numpy copied to the device; assembly is
gather -> cell kernel / einsum -> grouped `index_add` (ops/scatter.py: the
same bits on every run of the card). The cell term (mass, source,
diffusion) is the hand-written kernel of ops/cuda_dg_cell.py on CUDA
tensors and its plain version on CPU tensors, for DG and CG spaces alike;
its tables are fixed, so the operator prepares the call once.
The Jacobian action is `torch.func.jvp` of `residual` (solver/newton.py);
`jacobian_diag` is exact.
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
    build_interior_geometry,
)
from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
    PreparedDGCellResidual,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter


class HeatOperator:
    def __init__(self, fs: FunctionSpace, params: ModelParams, dt: float,
                 dtype=torch.float64, device=None,
                 quad_degree: int | None = None,
                 bc_dofs: np.ndarray | None = None,
                 bc_value: float | None = None,
                 source: np.ndarray | None = None,
                 flux_marker=None, form: str = "reference",
                 interior_device_tables: bool = True):
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
        self.is_dg = fs.family == "DG"

        cg = build_cell_geometry(mesh, fs, quad_degree)
        # boundary default degree 5p: the T^4 radiation integrand
        bq = quad_degree if quad_degree is not None else 5 * fs.degree
        bg = build_boundary_geometry(mesh, fs, bq, with_grad=False)
        self._boundary = (bq, bg)
        # optional selective flux boundary: marker(midpoints) -> bool mask
        if flux_marker is not None and len(bg.cell):
            mids = bg.qpoints_phys.mean(axis=1)
            keep = np.asarray(flux_marker(mids), dtype=bool)
            bg = type(bg)(
                cell=bg.cell[keep], qweights=bg.qweights[keep],
                phi=bg.phi[keep], grad_phys=None,
                normal=bg.normal[keep], qpoints_phys=bg.qpoints_phys[keep])
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=self.device)

        # numpy sources retained for setup-time consumers
        # (StencilMatrix, EllMatrix, GridHeatOperator)
        self.np_dofmap = fs.dofmap
        self.np_phi = np.asarray(cg.phi)
        self.np_b_dofmap = fs.dofmap[bg.cell]
        self.np_b_qw = np.asarray(bg.qweights)
        self.np_b_phi = np.asarray(bg.phi)

        self.dofmap = i64(fs.dofmap)                      # (c, l)
        self._sc_cell = GroupedScatter(fs.dofmap, self.n_dofs, self.device)
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
        self._sc_b = GroupedScatter(self.np_b_dofmap, self.n_dofs,
                                    self.device)
        self.b_qw = f(bg.qweights)                        # (f, q)
        self.b_phi = f(bg.phi)                            # (f, q, l)

        # optional spatially varying source field (dof array of fs)
        if source is not None:
            self.source_q = f(np.einsum("ql,cl->cq", np.asarray(cg.phi),
                                        np.asarray(source)[fs.dofmap]))
        else:
            self.source_q = None
        # the cell kernel's static tables, checked (and, for a uniform box
        # on the card, packed for the kernel's parameters) once
        self._cell_term = PreparedDGCellResidual(
            self.qw, self.gphi, self.phi, self.source_q)

        if self.is_dg:
            ig = build_interior_geometry(mesh, fs, quad_degree)
            self.np_i = {
                "dofmap_p": fs.dofmap[ig.cell_p],
                "dofmap_m": fs.dofmap[ig.cell_m],
                "qw": np.asarray(ig.qweights),
                "phi_p": np.asarray(ig.phi_p),
                "phi_m": np.asarray(ig.phi_m),
                "dnphi_p": np.einsum("fqlg,fqg->fql", ig.grad_p, ig.normal_p),
                "dnphi_m": np.einsum("fqlg,fqg->fql", ig.grad_m, ig.normal_p),
                "h_p": np.asarray(ig.h_p),
            }
            # the device copies are read only by the SIPG residual; an
            # operator that never evaluates it (a DG block stencil carrying
            # the whole outer loop) passes interior_device_tables=False and
            # keeps np_i alone
            self.i_dofmap_p = self.i_dofmap_m = None
            self.i_qw = self.i_phi_p = self.i_phi_m = None
            self.i_dnphi_p = self.i_dnphi_m = self.i_h_p = None
            if interior_device_tables:
                self.ensure_interior_tables()

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
    def take_boundary_geometry(self, quad_degree: int):
        """The whole boundary's facet tables at `quad_degree`, without the
        basis gradients. The ones this operator was built from are handed
        over once (GridHeatOperator reads them at setup: building them again
        took a third of the CG-1 plate's setup) and then released; any
        other call builds them anew."""
        held, self._boundary = self._boundary, None
        if held is not None and held[0] == quad_degree:
            return held[1]
        return build_boundary_geometry(self.fs.mesh, self.fs, quad_degree,
                                       with_grad=False)

    def ensure_interior_tables(self) -> None:
        """Copy the interior-facet tables to the device from the retained
        numpy sources (idempotent; a no-op for a CG space)."""
        if not self.is_dg or self.i_qw is not None:
            return
        f = lambda a: torch.as_tensor(np.array(a), dtype=self.dtype,
                                      device=self.device)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=self.device)
        self.i_dofmap_p = i64(self.np_i["dofmap_p"])
        self.i_dofmap_m = i64(self.np_i["dofmap_m"])
        self.i_qw = f(self.np_i["qw"])
        self.i_phi_p = f(self.np_i["phi_p"])
        self.i_phi_m = f(self.np_i["phi_m"])
        # normal derivative tables: grad(phi) . n+  -> (f, q, l)
        self.i_dnphi_p = f(self.np_i["dnphi_p"])
        self.i_dnphi_m = f(self.np_i["dnphi_m"])
        self.i_h_p = f(self.np_i["h_p"])                  # (f,)
        self._sc_p = GroupedScatter(self.np_i["dofmap_p"], self.n_dofs,
                                    self.device)
        self._sc_m = GroupedScatter(self.np_i["dofmap_m"], self.n_dofs,
                                    self.device)

    def _base_residual(self, T, T_prev, dt=None):
        p = self.params
        dt = self.dt if dt is None else dt
        # ---- cell integrals (mass + source + diffusion) ----
        r_cell = self._cell_term(
            T[self.dofmap], T_prev[self.dofmap], dt=dt, c_mass=self.c_mass,
            c_diff=self.c_diff, f_src=p.f)
        r = self._sc_cell(r_cell)

        # ---- boundary (radiation + convection, Robin-type) ----
        Tb = torch.einsum("fql,fl->fq", self.b_phi, T[self.b_dofmap])
        gflux = p.boundary_scale * (
            (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
            + p.htc * (Tb - p.T_ambient)
        )
        r_b = torch.einsum("fq,fql->fl", self.b_qw * dt * gflux, self.b_phi)
        r = r + self._sc_b(r_b)

        # ---- SIPG interior facets (DG only) ----
        if self.is_dg:
            ein = torch.einsum
            T_p, T_m = T[self.i_dofmap_p], T[self.i_dofmap_m]
            Tp = ein("fql,fl->fq", self.i_phi_p, T_p)
            Tm = ein("fql,fl->fq", self.i_phi_m, T_m)
            dTp = ein("fql,fl->fq", self.i_dnphi_p, T_p)
            dTm = ein("fql,fl->fq", self.i_dnphi_m, T_m)
            jumpT = Tp - Tm
            avg_dT = 0.5 * (dTp + dTm)
            coef = dt * self.c_diff * self.i_qw            # (f, q)
            pen_h = (p.dg_penalty / self.i_h_p)[:, None]   # (f, 1)
            r_p = (ein("fq,fql->fl", coef * pen_h * jumpT, self.i_phi_p)
                   - ein("fq,fql->fl", coef * 0.5 * jumpT, self.i_dnphi_p)
                   - ein("fq,fql->fl", coef * avg_dT, self.i_phi_p))
            r_m = (-ein("fq,fql->fl", coef * pen_h * jumpT, self.i_phi_m)
                   - ein("fq,fql->fl", coef * 0.5 * jumpT, self.i_dnphi_m)
                   + ein("fq,fql->fl", coef * avg_dT, self.i_phi_m))
            r = r + self._sc_p(r_p)
            r = r + self._sc_m(r_m)
        return self._reduce(r)

    def _reduce(self, partial):
        """The sum of a partial assembly over the ranks that hold this
        operator's cells: the identity here, an all-reduce in the sharded
        operator (parallel/sharding.py)."""
        return partial

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
        if self.is_dg:
            coef = self.c_diff * self.np_i["qw"]
            pen_h = (self.params.dg_penalty / self.np_i["h_p"])[:, None]
            phi_p, phi_m = self.np_i["phi_p"], self.np_i["phi_m"]
            dn_p, dn_m = self.np_i["dnphi_p"], self.np_i["dnphi_m"]
            d_p = np.einsum("fq,fql,fql->fl", coef * pen_h, phi_p, phi_p) \
                - np.einsum("fq,fql,fql->fl", coef, phi_p, dn_p)
            d_m = np.einsum("fq,fql,fql->fl", coef * pen_h, phi_m, phi_m) \
                + np.einsum("fq,fql,fql->fl", coef, phi_m, dn_m)
            d_stiff += scat(d_p, self.np_i["dofmap_p"])
            d_stiff += scat(d_m, self.np_i["dofmap_m"])
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
        d = d_mass + dt * d_stiff + self._reduce(self._sc_b(d_b))
        if self.has_bc:
            d = torch.where(self.bc_mask, torch.ones_like(d), d)
        return d
