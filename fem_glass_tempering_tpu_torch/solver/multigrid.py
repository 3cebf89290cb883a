"""Geometric multigrid preconditioner for structured box meshes (CG-1).

Counterpart of fem_glass_tempering_tpu/solver/multigrid.py (GeometricMG),
the matrix-free stand-in for the reference's PETSc GAMG
(ThermoViscoProblem.py:344): a V-cycle over rediscretised heat operators on
semi-coarsened box meshes, Jacobi or Chebyshev smoothing over D^{-1}A with
each level's exact diagonal, multilinear prolongation and its exact
transpose as strided-slice lattice ops, and a dense inverse of the
coarsest level built on the host at setup.

Every level's Jacobian action is GridHeatOperator.make_matvec, i.e. the
hand-written CUDA stencil kernel on the GPU. The DG p-multigrid
(DGMultigrid) waits for Slice 3 of the port (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.fem.mesh import (
    Mesh,
    box_mesh_2d,
    box_mesh_3d,
    interval_mesh,
)


def _next_dims(dims, lengths):
    """Semi-coarsening toward isotropy: halve the axes whose cell size is
    strictly finer than the coarsest axis; when the grid is isotropic,
    halve every halvable axis. None when nothing can coarsen."""
    h = [ln / d for ln, d in zip(lengths, dims)]
    halvable = [i for i, d in enumerate(dims) if d % 2 == 0 and d >= 2]
    if not halvable:
        return None
    hmax = max(h)
    strong = [i for i in halvable if h[i] < hmax / 1.9]
    axes = strong if strong else halvable
    out = list(dims)
    for i in axes:
        out[i] //= 2
    return tuple(out)


def _build_level_mesh(structured: dict, dims) -> Mesh:
    o, ln = structured["origin"], structured["lengths"]
    if len(dims) == 1:
        return interval_mesh(dims[0], o[0], o[0] + ln[0])
    if len(dims) == 2:
        return box_mesh_2d(dims[0], dims[1], ln[0], ln[1], origin=o)
    return box_mesh_3d(dims[0], dims[1], dims[2], ln[0], ln[1], ln[2], origin=o)


@dataclass
class MGLevel:
    op: object                    # HeatOperator at this level
    fine_dims: tuple              # this level's cell dims
    coarse_dims: tuple | None     # next (coarser) level's cell dims
    axes: tuple | None            # axes halved by the transfer


def _sl(axis, s):
    """Index tuple applying slice `s` along `axis`."""
    return (slice(None),) * axis + (s,)


class GeometricMG:
    """V-cycle preconditioner factory.

    Usage:
        mg = GeometricMG(mesh, make_operator)   # make_operator(mesh) -> HeatOperator
        precond = mg.preconditioner(mg.linearization_states(T), dt)
    """

    def __init__(self, mesh: Mesh, make_operator, *, nu_pre: int = 2,
                 nu_post: int = 2, coarse_iters: int = 24, min_level_nodes: int = 27,
                 use_stencil: bool = True, smoother: str = "jacobi",
                 max_levels: int = 0, coarse: str = "auto",
                 dtype=torch.float64, table_dtype=None):
        if mesh.structured is None:
            raise ValueError("geometric MG needs a structured box mesh")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(smoother)
        if coarse not in ("auto", "smooth", "dense"):
            raise ValueError(coarse)
        if table_dtype is not None:
            raise NotImplementedError(
                "bf16 table streaming waits (ROADMAP.md, Slice 1 deferrals)")
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.coarse_iters = coarse_iters
        self.smoother = smoother
        self.use_stencil = use_stencil
        self.dtype = dtype
        self.table_dtype = table_dtype
        self.levels: list[MGLevel] = []
        dims = tuple(mesh.structured["dims"])
        lengths = tuple(mesh.structured["lengths"])
        meta = mesh.structured
        cur_mesh = mesh
        # 'auto': stop coarsening at the first level small enough for the
        # frozen dense direct solve and use it as an exact coarse solve
        dense_stop = 4096 if coarse == "auto" else 0
        while True:
            op = make_operator(cur_mesh)
            cdims = _next_dims(dims, lengths)
            if max_levels and len(self.levels) + 1 >= max_levels:
                cdims = None
            if dense_stop and int(np.prod(
                    tuple(d + 1 for d in dims))) <= dense_stop:
                cdims = None
            if cdims is not None and int(np.prod(
                    tuple(d + 1 for d in cdims))) >= min_level_nodes:
                self.levels.append(MGLevel(
                    op=op, fine_dims=dims, coarse_dims=cdims,
                    axes=tuple(a for a in range(len(dims))
                               if cdims[a] != dims[a])))
                dims = cdims
                cur_mesh = _build_level_mesh(meta, dims)
            else:
                self.levels.append(MGLevel(op=op, fine_dims=dims,
                                           coarse_dims=None, axes=None))
                break
        self.device = self.levels[0].op.device
        # frozen direct coarse solve: dense inverse of the coarsest-level
        # Jacobian linearised at (T_0, the operator's dt), assembled and
        # inverted on the host, applied as one dense product
        self.coarse_inv = None
        if coarse in ("auto", "dense"):
            lvl = self.levels[-1]
            n_c = int(np.prod(tuple(d + 1 for d in lvl.fine_dims)))
            st = None
            if n_c <= 4096:
                st = self._stencil_for(lvl)
            if st is not None:
                A = st.np_dense(lvl.op.params.T_0, lvl.op.dt)
                self.coarse_inv = torch.as_tensor(
                    np.linalg.inv(A), dtype=dtype, device=self.device)
            elif coarse == "dense":
                if n_c > 4096:
                    raise ValueError(
                        f"coarse='dense' needs a coarsest level <= 4096 "
                        f"nodes (got {n_c}); lower max_levels less or "
                        f"keep 'smooth'")
                raise ValueError("coarse='dense' needs a stencil-capable "
                                 "coarsest level")

    # ------------------------------------------------------------------
    # Lattice transfers as strided slices:
    #   prolong (per halved axis):  out[2i] = xc[i],
    #                               out[2i+1] = (xc[i] + xc[i+1]) / 2
    #   restrict = exact transpose: rc[i] = rf[2i] + (rf[2i-1]+rf[2i+1])/2
    #   inject:                     xc[i] = xf[2i]
    @staticmethod
    def _prolong_axis(xg, axis):
        n = xg.shape[axis]                 # coarse count gc
        lo = xg[_sl(axis, slice(0, n - 1))]
        hi = xg[_sl(axis, slice(1, n))]
        odd = 0.5 * (lo + hi)
        pairs = torch.stack([lo, odd], dim=axis + 1)
        shp = list(xg.shape)
        shp[axis] = 2 * (n - 1)
        pairs = pairs.reshape(shp)
        last = xg[_sl(axis, slice(n - 1, n))]
        return torch.cat([pairs, last], dim=axis)

    @staticmethod
    def _restrict_axis(rg, axis):
        even = rg[_sl(axis, slice(0, None, 2))]
        odd = rg[_sl(axis, slice(1, None, 2))]
        zshape = list(odd.shape)
        zshape[axis] = 1
        z = torch.zeros(zshape, dtype=rg.dtype, device=rg.device)
        return even + 0.5 * (torch.cat([odd, z], dim=axis)
                             + torch.cat([z, odd], dim=axis))

    def _prolong(self, lvl: MGLevel, xc):
        g = xc.reshape(tuple(n + 1 for n in lvl.coarse_dims))
        for a in lvl.axes:
            g = self._prolong_axis(g, a)
        return g.reshape(-1)

    def _restrict(self, lvl: MGLevel, rf):
        g = rf.reshape(tuple(n + 1 for n in lvl.fine_dims))
        for a in lvl.axes:
            g = self._restrict_axis(g, a)
        return g.reshape(-1)

    def preconditioner(self, T_levels, dt):
        """Build the V-cycle apply for the Jacobian frozen at the per-level
        linearisation states T_levels (from `linearization_states`)."""
        levels = self.levels

        matvecs = []
        diags = []
        rhos = []
        frozen = getattr(self, "_frozen_rhos", None)
        for i, (lvl, T) in enumerate(zip(levels, T_levels)):
            g = self._grid_for(lvl)
            if g is not None:
                f = g.make_matvec(T, dt)
                d = g.jacobian_diag(T, dt)
            else:
                st = self._stencil_for(lvl)
                if st is not None:
                    f = st.make_matvec(T, dt)
                else:
                    f = (lambda op, T: lambda v: torch.func.jvp(
                        lambda u: op.residual(u, T, dt), (T,), (v,))[1])(
                            lvl.op, T)
                d = lvl.op.jacobian_diag(T, dt)
            matvecs.append(f)
            diags.append(d)
            if frozen is not None:
                rhos.append(frozen[i])
                continue
            # spectral radius of D^{-1}A by power iteration (fallback when
            # freeze_omegas was not called), with a wide safety margin
            v = torch.sin(torch.arange(T.shape[0], dtype=T.dtype,
                                       device=T.device) * 0.7) + 0.01
            rho = torch.ones((), dtype=T.dtype, device=T.device)
            for _ in range(10):
                w = f(v) / d
                rho = torch.linalg.norm(w) / torch.linalg.norm(v)
                v = w / torch.linalg.norm(w)
            rhos.append(rho * 1.4)

        def smooth_jacobi(i, x, b, nu):
            # omega = 4/(3 rho): optimal damped Jacobi for a spectrum (0, rho]
            omega = 4.0 / (3.0 * rhos[i])
            for _ in range(nu):
                x = x + omega * (b - matvecs[i](x)) / diags[i]
            return x

        def smooth_cheb(i, x, b, nu):
            # Chebyshev over D^{-1}A on [rho/4, rho], three-term recurrence
            lmax = rhos[i]
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b - matvecs[i](x)
            z = r / diags[i]
            p = z / theta
            x = x + p
            for _ in range(max(nu - 1, 0)):
                r = b - matvecs[i](x)
                z = r / diags[i]
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        smooth = smooth_jacobi if self.smoother == "jacobi" else smooth_cheb

        def cycle(i, b):
            if levels[i].coarse_dims is None:
                if self.coarse_inv is not None:
                    # frozen direct solve: one (n_c, n_c) product
                    return (self.coarse_inv @ b.to(self.dtype)).to(b.dtype)
                x = torch.zeros_like(b)
                return smooth(i, x, b, self.coarse_iters)
            x = smooth(i, torch.zeros_like(b), b, self.nu_pre)
            r = b - matvecs[i](x)
            rc = self._restrict(levels[i], r)
            xc = cycle(i + 1, rc)
            x = x + self._prolong(levels[i], xc)
            return smooth(i, x, b, self.nu_post)

        return lambda r: cycle(0, r)

    def _grid_for(self, lvl: MGLevel):
        """Cached per-level GridHeatOperator (None if the level does not
        qualify); its StencilMatrix is shared with `_stencil_for`."""
        if not self.use_stencil:
            return None
        if not hasattr(lvl, "_gridop"):
            from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
            try:
                lvl._gridop = GridHeatOperator(lvl.op)
                lvl._stencil = lvl._gridop.st
            except ValueError:
                lvl._gridop = None
        return lvl._gridop

    def _stencil_for(self, lvl: MGLevel):
        """Cached per-level StencilMatrix (None if not applicable)."""
        if not self.use_stencil:
            return None
        if not hasattr(lvl, "_stencil"):
            if self._grid_for(lvl) is not None:
                return lvl._stencil
            from fem_glass_tempering_tpu_torch.ops.stencil import StencilMatrix
            try:
                lvl._stencil = StencilMatrix(lvl.op)
            except ValueError:
                lvl._stencil = None
        return lvl._stencil

    def freeze_omegas(self, T_fine, dt) -> None:
        """Fix per-level smoother spectrum bounds once at setup, from the
        Gershgorin bound rho(D^{-1}A) <= max_i sum_j|a_ij|/a_ii evaluated
        on the host from each level's numpy row statistics (boundary
        linearisation at T_0)."""
        del T_fine
        vals = []
        for lvl in self.levels:
            st = self._stencil_for(lvl)
            if st is not None and getattr(st, "gersh", None) is not None:
                g = st.gersh
                num = g["mass_abs"] + dt * (g["stiff_abs"] + g["b_abs"])
                den = g["mass_diag"] + dt * (g["stiff_diag"] + g["b_diag"])
                rho = float(np.max(num / den))
            else:
                # fallback: power iteration via jvp (unstencilled level)
                op = lvl.op
                T = torch.full((op.n_dofs,), op.params.T_0, dtype=self.dtype,
                               device=self.device)
                f = lambda v: torch.func.jvp(
                    lambda u: op.residual(u, T, dt), (T,), (v,))[1]
                d = op.jacobian_diag(T, dt)
                v = torch.sin(torch.arange(T.shape[0], dtype=T.dtype,
                                           device=T.device) * 0.7) + 0.01
                rho = 1.0
                for _ in range(12):
                    w = f(v) / d
                    rho = float(torch.linalg.norm(w) / torch.linalg.norm(v))
                    v = w / torch.linalg.norm(w)
                rho *= 1.05
            vals.append(rho)
        self._frozen_rhos = vals

    def linearization_states(self, T_fine):
        """Per-level temperature states: injection (even-node sampling) of
        the fine solution, for freezing the radiation linearisation."""
        states = [T_fine]
        cur = T_fine
        for lvl in self.levels[:-1]:
            cur = self._inject(lvl, cur)
            states.append(cur)
        return states

    def _inject(self, lvl: MGLevel, xf):
        g = xf.reshape(tuple(n + 1 for n in lvl.fine_dims))
        for a in lvl.axes:
            g = g[_sl(a, slice(0, None, 2))]
        return g.contiguous().reshape(-1)
