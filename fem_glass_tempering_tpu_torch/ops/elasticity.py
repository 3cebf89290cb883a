"""Incremental linear-elastic equilibrium operator (vector displacement).

Counterpart of fem_glass_tempering_tpu/ops/elasticity.py. The reference
never solves mechanical equilibrium (its total strain is minus the thermal
strain, ViscoelasticModel.py:136-139); `RunConfig.mechanics='equilibrium'`
solves, each step, the quasi-static balance

  div( sigma_hist + C_eff : (eps(du) - d_eps_th) ) = 0,   traction-free,

for the displacement increment du, with C_eff the isotropic effective
Prony tangent (G_eff, K_eff) at the step's scaled time and sigma_hist the
decayed accumulated stress. One SPD CG (Jacobi-preconditioned) solves it;
3-2-1 point constraints remove the rigid-body modes.

Assembly is gather -> einsum -> scatter-add over the dofmap, vectorized
over the displacement components; the scatter adds one group of distinct
dofs at a time (ops/scatter.py), so the card repeats its bits.
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.assembly import (
    _jacobians,
    build_cell_geometry,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.solver.krylov import pcg


def _rigid_body_pins(fs: FunctionSpace) -> np.ndarray:
    """(n_pins, 2) [scalar_dof, component] pairs pinning all rigid modes:
    3-2-1 in 3D, 2-1 in 2D, 1 in 1D, at extremal nodes."""
    x = fs.dof_coords
    d = x.shape[1]
    origin = int(np.argmin(np.sum((x - x.min(axis=0)) ** 2, axis=1)))
    pins = [(origin, a) for a in range(d)]
    if d >= 2:
        # farthest node along x: pin the transverse components (kills the
        # rotations about axes orthogonal to x)
        px = int(np.argmax(x[:, 0] - x[origin, 0] + 1e-12 * x[:, 1]))
        for a in range(1, d):
            pins.append((px, a))
    if d == 3:
        py = int(np.argmax(x[:, 1]))
        pins.append((py, 2))
    return np.asarray(pins, dtype=np.int64)


class ElasticityOperator:
    """Vector space of the sigma space's family and degree (scalar
    structure shared); solves for du. Fields are (n, d) tensors."""

    def __init__(self, fs_sigma: FunctionSpace, dtype=torch.float64,
                 device=None):
        mesh = fs_sigma.mesh
        self.d = mesh.tdim
        self.device = resolve_device(device)
        self.fs = FunctionSpace(mesh, fs_sigma.family, fs_sigma.degree)
        cg = build_cell_geometry(mesh, self.fs)
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=self.device)
        self.dofmap = i64(self.fs.dofmap)                 # (c, l)
        self.qw = f(cg.qweights)                          # (c, q)
        self.gphi = f(cg.grad_phys)                       # (c, q, l, g)
        self.n = self.fs.n_scalar_dofs
        self.dtype = dtype
        pins = _rigid_body_pins(self.fs)
        mask = np.zeros((self.n, self.d), dtype=bool)
        mask[pins[:, 0], pins[:, 1]] = True
        self.pin_mask = torch.as_tensor(mask, device=self.device)  # (n, d)
        self._scatter = GroupedScatter(self.fs.dofmap, self.n, self.device)
        # strains at the sigma-space dofs: the owner cell's basis gradients
        # at its own interpolation points
        self.owner_cell = i64(self.fs.owner_cell)
        self.owner_lp = i64(self.fs.owner_lpoint)
        ipts = self.fs.element.interpolation_points()
        dphi_ip = self.fs.element.tabulate_grad(ipts)     # (p, l, t)
        _, _, invJ = _jacobians(mesh, ipts, np.arange(mesh.n_cells))
        self.gphi_ip = f(np.einsum("cptg,plt->cplg", invJ, dphi_ip))

    # ------------------------------------------------------------------
    def _strain_at_q(self, u: torch.Tensor) -> torch.Tensor:
        """eps(u) at the quadrature points: (c, q, d, d)."""
        uc = u[self.dofmap]                                       # (c, l, d)
        gu = torch.einsum("cla,cqlg->cqag", uc, self.gphi)
        return 0.5 * (gu + gu.transpose(-1, -2))

    def _stress(self, eps, sigma_hist_q, G_eff_q, K_eff_q):
        d = self.d
        tr = torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)
        I = torch.eye(d, dtype=eps.dtype, device=eps.device)
        dev = eps - (tr / d)[..., None, None] * I
        return (sigma_hist_q + 2.0 * G_eff_q[..., None, None] * dev
                + K_eff_q[..., None, None] * tr[..., None, None] * I)

    def residual(self, u, sigma_hist_q, eps0_q, G_eff_q, K_eff_q):
        """Weak-form residual of equilibrium at displacement u (n, d).
        sigma_hist_q, eps0_q: (c, q, d, d); G_eff_q, K_eff_q: (c, q).
        Pinned components are zero rows."""
        u = torch.where(self.pin_mask, torch.zeros_like(u), u)
        eps = self._strain_at_q(u) - eps0_q
        sig = self._stress(eps, sigma_hist_q, G_eff_q, K_eff_q)
        # r[i, a] = sum_q w sig[a, :] . grad(phi_i)   (sigma symmetric)
        r_cell = torch.einsum("cq,cqag,cqlg->cla", self.qw, sig, self.gphi)
        r = self._scatter(r_cell, (self.d,))
        return torch.where(self.pin_mask, u, r)

    def jacobian_diag(self, G_eff_q, K_eff_q) -> torch.Tensor:
        """Exact diagonal of the elastic stiffness (Jacobi-CG):
        K(ia, ia) = sum_q w [G (|grad phi_i|^2 + (d_a phi_i)^2 (1 - 2/d))
                             + K (d_a phi_i)^2]."""
        d = self.d
        g2 = torch.einsum("cqlg,cqlg->cql", self.gphi, self.gphi)
        ga2 = self.gphi ** 2                                      # (c,q,l,g)
        coefG = torch.einsum("cq,cql->cl", self.qw * G_eff_q, g2)
        diag = (coefG[..., None]
                + torch.einsum("cq,cqlg->clg",
                               self.qw * G_eff_q * (1.0 - 2.0 / d)
                               + self.qw * K_eff_q, ga2))
        dd = self._scatter(diag, (d,))
        return torch.where(self.pin_mask, torch.ones_like(dd), dd)

    # ------------------------------------------------------------------
    def solve_increment(self, sigma_hist_q, eps0_q, G_eff_q, K_eff_q, *,
                        rtol=1e-10, atol=0.0, max_it=2000, x0=None,
                        rtol_r0=0.0):
        """Solve the linear equilibrium for du -> (du (n, d), iters). `x0`
        warm-starts CG; the test stays relative to ||b|| (and, with
        rtol_r0, to the warm start's residual: solver/krylov.py pcg)."""
        zero = torch.zeros((self.n, self.d), dtype=self.dtype,
                           device=self.device)
        b = -self.residual(zero, sigma_hist_q, eps0_q, G_eff_q, K_eff_q)
        zs = torch.zeros_like(sigma_hist_q)
        ze = eps0_q * 0.0

        def matvec(v):
            # the linear part: the residual at v minus the residual at 0
            return self.residual(v, zs, ze, G_eff_q, K_eff_q)

        diag = self.jacobian_diag(G_eff_q, K_eff_q)
        if x0 is not None:
            x0 = x0.to(b.dtype)
        res = pcg(matvec, b, x0=x0, diag=diag, rtol=rtol, atol=atol,
                  max_it=max_it, rtol_r0=rtol_r0)
        return res.x, res.iters

    # ------------------------------------------------------------------
    def strain_at_sigma_dofs(self, u: torch.Tensor) -> torch.Tensor:
        """eps(u) at the sigma-space interpolation points (owner-cell
        gather, as ops/interpolation.py evaluates): (n, d, d)."""
        uc = u[self.dofmap[self.owner_cell]]                      # (n, l, d)
        g = self.gphi_ip[self.owner_cell, self.owner_lp]          # (n, l, g)
        gu = torch.einsum("nla,nlg->nag", uc, g)
        return 0.5 * (gu + gu.transpose(-1, -2))
