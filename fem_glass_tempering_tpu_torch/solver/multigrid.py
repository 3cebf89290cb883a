"""Geometric multigrid preconditioner for structured box meshes (CG-1).

Counterpart of fem_glass_tempering_tpu/solver/multigrid.py (GeometricMG),
the matrix-free stand-in for the reference's PETSc GAMG
(ThermoViscoProblem.py:344): a V-cycle over rediscretised heat operators on
semi-coarsened box meshes, Jacobi or Chebyshev smoothing over D^{-1}A with
each level's exact diagonal, multilinear prolongation and its exact
transpose as strided-slice lattice ops, and a dense inverse of the
coarsest level built on the host at setup.

Every level's Jacobian action is GridHeatOperator.make_matvec, i.e. the
hand-written CUDA stencil kernel on the GPU.

DGMultigrid is the p-multigrid of an SIPG DG-1 space on a box: Chebyshev
smoothing over a block, column or point solve with the DG block stencil
(ops/stencil.py DGStencilMatrix), and a correction through the CG-1 space
of the same mesh, i.e. through GeometricMG, or (coarse_kind="grid", the
grid-sharded step's route) through GridMG on a node grid padded along
axis 0, with grid-shaped transfers, smoother solve and apply.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.fem.mesh import (
    Mesh,
    box_mesh_2d,
    box_mesh_3d,
    interval_mesh,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.ops.stencil import (
    DGStencilMatrix,
    StencilMatrix,
    _bmv,
)
from fem_glass_tempering_tpu_torch.solver.grid_dg import (
    _prolong_window,
    _restrict_window,
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
                # the grid levels stream their tables in `table_dtype`
                # (None: the cycle's dtype); the stencil and jvp levels
                # keep the cycle's dtype, as in the JAX version
                f = g.make_matvec(T, dt, stream_dtype=self.table_dtype)
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

        def cycle(b):
            # a loop down the levels and back up: a recursive closure would
            # hold itself, so each build's level tables would wait for the
            # cyclic collector
            bs, xs = [], []
            i = 0
            while levels[i].coarse_dims is not None:
                x = smooth(i, torch.zeros_like(b), b, self.nu_pre)
                r = b - matvecs[i](x)
                bs.append(b)
                xs.append(x)
                b = self._restrict(levels[i], r)
                i += 1
            if self.coarse_inv is not None:
                # frozen direct solve: one (n_c, n_c) product
                xc = (self.coarse_inv @ b.to(self.dtype)).to(b.dtype)
            else:
                xc = smooth(i, torch.zeros_like(b), b, self.coarse_iters)
            for i in reversed(range(len(xs))):
                x = xs[i] + self._prolong(levels[i], xc)
                xc = smooth(i, x, bs[i], self.nu_post)
            return xc

        return cycle

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


class DGMultigrid:
    """p-multigrid preconditioner for SIPG DG-1 on structured box meshes.

    Counterpart of the JAX package's DGMultigrid, the stand-in for the
    reference's PETSc GAMG on its DG-1 default (ThermoViscoProblem.py:344,
    main.py:25): smooth on the DG level (Chebyshev over Z^{-1}A with the
    DG block stencil), correct through the CG-1 nodal space on the same
    mesh, and recurse into the geometric hierarchy (GeometricMG).

    The p-transfer is exact Galerkin: the prolongation maps CG nodal
    values to the DG cell-local dofs (DG-1 nodes are the cell vertices),
    so P^T A_dg P is the rediscretised CG-1 operator for the mass,
    stiffness and boundary terms.

    coarse_kind="grid" is the route of the grid-sharded step
    (parallel/grid_shard.py): the CG-1 correction runs through GridMG
    (solver/grid_mg.py) on a node grid whose axis 0 carries `grid_pad0`
    ghost planes, and the grid-shaped methods (`*_g`) take (cx, cy, cz,
    nloc) cell grids and (gx, gy, gz) node grids; solver/grid_dg.py
    RankDGMultigrid runs it on one rank's cells.
    """

    def __init__(self, dg_op, make_cg_operator, *, nu: int = 1,
                 smoother: str = "auto", dtype=torch.float64,
                 mg_kwargs: dict | None = None, column_dense: bool = True,
                 coarse_kind: str = "geometric", grid_pad0: int = 0):
        fs = dg_op.fs
        mesh = fs.mesh
        if fs.family != "DG" or fs.degree != 1:
            raise ValueError("DGMultigrid needs a DG-1 space (p-transfer "
                             "to CG-1 is vertex-based)")
        if mesh.structured is None:
            raise ValueError("DGMultigrid needs a structured box mesh")
        if coarse_kind not in ("geometric", "grid"):
            raise ValueError(coarse_kind)
        self.dg_op = dg_op
        # the table form: the cycle applies it twice per V-cycle, and the
        # smoother factors read its per-cell self blocks
        self.stencil = DGStencilMatrix(dg_op, allow_const=False)
        self.nu = nu
        dims = tuple(mesh.structured["dims"])
        lengths = tuple(mesh.structured["lengths"])
        h = [ln / dd for ln, dd in zip(lengths, dims)]
        if smoother == "auto":
            # anisotropic plates: point/cell-block smoothers cannot damp
            # jump modes along the strongly coupled (small-h) axis; a line
            # (column) solve along it keeps the V-cycle mesh-robust
            smoother = ("column" if (len(dims) >= 2 and max(h) / min(h) > 3.0
                                     and self.stencil.cross_const)
                        else "block")
        if smoother not in ("jacobi", "chebyshev", "block", "column"):
            raise ValueError(smoother)
        if smoother == "column" and not self.stencil.cross_const:
            raise ValueError("column smoother needs constant cross blocks")
        self.smoother = smoother
        self.column_dense = column_dense
        self.col_axis = int(np.argmin(h)) if smoother == "column" else None
        self.dtype = dtype
        self.coarse_kind = coarse_kind
        dev = dg_op.device
        # DG-1 local nodes are the cell vertices in the builders' order and
        # the DG dofmap is arange(C*nloc), so cells.ravel() is the CG-node
        # id of each DG dof
        self.cells_flat = torch.as_tensor(
            mesh.cells.reshape(-1).astype(np.int64), device=dev)
        # the gather fallback's DG-to-CG sum, one group of distinct nodes
        # at a time (the same bits on every run of the card)
        self._sc_cells = GroupedScatter(mesh.cells.reshape(-1),
                                        mesh.n_nodes, dev)
        self.n_nodes = mesh.n_nodes
        counts = np.bincount(mesh.cells.reshape(-1), minlength=mesh.n_nodes)
        self.inv_counts = torch.as_tensor(1.0 / counts, dtype=dtype,
                                          device=dev)
        # p-transfers as slices of the lexicographic node lattice: prolong
        # = 2^d slices of the node grid, restrict = 2^d slice-adds
        self._node_grid = tuple(n + 1 for n in dims)
        nstr = [int(np.prod(self._node_grid[i + 1:]))
                for i in range(len(dims))]
        cells_np = mesh.cells
        offs = []
        for l in range(cells_np.shape[1]):
            nid = int(cells_np[0, l])
            o = []
            for s in nstr:
                o.append(nid // s)
                nid %= s
            offs.append(tuple(o))
        # the slices hold only if every cell is the first one translated
        cc = np.stack(np.unravel_index(np.arange(mesh.n_cells), dims),
                      axis=-1)
        rec = np.stack([
            sum((cc[:, i] + o[i]) * nstr[i] for i in range(len(dims)))
            for o in offs], axis=-1)
        self._vert_offs = offs if np.array_equal(rec, cells_np) else None
        # grid_pad0: the ghost planes that a sharded caller appends to the
        # CG correction's node grid along axis 0 (identity rows, the
        # grid-sharded step's fine-level pad); the grid-shaped p-transfers
        # pad and slice between the cell grid and that padded node grid
        self._grid_pad0 = int(grid_pad0)
        if coarse_kind == "grid":
            # imported here: grid_mg imports this module
            from fem_glass_tempering_tpu_torch.ops.grid import (
                GridHeatOperator,
            )
            from fem_glass_tempering_tpu_torch.solver.grid_mg import GridMG
            kw = dict(mg_kwargs or {})
            kw.pop("max_levels", None)      # GridMG: automatic depth only
            kw.pop("table_dtype", None)
            if kw.get("coarse") == "dense":
                kw["coarse"] = "auto"
            # the whole grid's device tables wait for a whole-grid method:
            # the sharded step reads its rank's slabs'
            self.cg_mg = GridMG(
                GridHeatOperator(make_cg_operator(mesh), pad_axis0=grid_pad0,
                                 allow_const=False, tables=False),
                make_cg_operator, **kw)
        else:
            self.cg_mg = GeometricMG(mesh, make_cg_operator, dtype=dtype,
                                     **(mg_kwargs or {}))
        self._frozen_rho = None
        self._frozen_smoother_data = None

    # ---- p-transfers -------------------------------------------------
    def prolong(self, x_cg):
        if self._vert_offs is None:
            return x_cg[self.cells_flat]
        dims = self.stencil.cell_dims
        xg = x_cg.reshape(self._node_grid)
        parts = [xg[tuple(slice(oi, oi + di) for oi, di in zip(o, dims))]
                 for o in self._vert_offs]
        return torch.stack(parts, dim=-1).reshape(-1)

    def restrict(self, r_dg):
        if self._vert_offs is None:
            return self._sc_cells(r_dg)
        dims = self.stencil.cell_dims
        rg = r_dg.reshape(dims + (self.stencil.nloc,))
        out = torch.zeros(self._node_grid, dtype=r_dg.dtype,
                          device=r_dg.device)
        for l, o in enumerate(self._vert_offs):
            sl = tuple(slice(oi, oi + di) for oi, di in zip(o, dims))
            out[sl] += rg[..., l]
        return out.reshape(-1)

    def restrict_state(self, T_dg):
        """Vertex-averaged CG representation of a DG iterate: the
        linearization state of the coarse hierarchy."""
        return self.restrict(T_dg) * self.inv_counts

    # ---- grid-shaped p-transfers (the grid-sharded route) -------------
    def prolong_g(self, x_cg):
        """(gx, gy, gz) node grid -> (cx, cy, cz, nloc) cell grid."""
        assert self._vert_offs is not None
        return _prolong_window(x_cg, self._vert_offs, self.stencil.cell_dims)

    def restrict_g(self, r_dg):
        """(cx, cy, cz, nloc) -> (gx, gy, gz): the transposed prolongation
        as 2^d zero pads added in vertex order."""
        assert self._vert_offs is not None
        return _restrict_window(r_dg, self._vert_offs)

    def restrict_state_g(self, T_dg):
        return self.restrict_g(T_dg) * self.inv_counts.reshape(
            self._node_grid)

    # ---- block/line solvers -------------------------------------------
    def _zsolve_data(self, T_dg, dt):
        """'jacobi'/'chebyshev' -> pointwise diagonal; 'block' -> exact
        per-cell (nloc x nloc) self-block inverse; 'column' -> exact
        block-tridiagonal (Thomas) factors of every cell column along the
        strongly coupled axis."""
        if self.smoother in ("jacobi", "chebyshev"):
            return {"diag": self.dg_op.jacobian_diag(T_dg, dt)}
        vals_self = self.stencil.values_at(T_dg, dt)      # (C, nloc, nloc)
        # factorise in f64 and apply in the cycle's dtype: the SIPG self
        # blocks carry the penalty terms' large dynamic range, and f32
        # factors lose enough of it to weaken the cycle badly
        up = self.dtype == torch.float32
        vals_f = vals_self.to(torch.float64) if up else vals_self
        if self.smoother == "block":
            inv = torch.linalg.inv(vals_f)
            return {"inv_self": inv.to(self.dtype)}
        data = self._column_factorize(vals_f, dt)
        return {k: ([m.to(self.dtype) for m in v] if isinstance(v, list)
                    else v.to(self.dtype)) for k, v in data.items()}

    def _column_perm(self):
        st = self.stencil
        a = self.col_axis
        dims = st.cell_dims
        d = len(dims)
        perm = tuple(i for i in range(d) if i != a) + (a,)
        inv_perm = tuple(int(i) for i in np.argsort(perm))
        return dims, d, dims[a], st.C // dims[a], perm, inv_perm

    def _column_factorize(self, vals_self, dt):
        st = self.stencil
        a = self.col_axis
        nloc = st.nloc
        dims, d, nzc, ncol, perm, _ = self._column_perm()
        Bp = st.Bp[a].to(vals_self.dtype) * dt             # k -> k+1
        Bm = st.Bm[a].to(vals_self.dtype) * dt             # k -> k-1
        A = vals_self.reshape(dims + (nloc, nloc))
        A = A.permute(perm + (d, d + 1)).reshape(ncol, nzc, nloc, nloc)
        # block Thomas: D'_0 = A_0; L_k = Bm D'_{k-1}^{-1}, D'_k = A_k - L_k Bp
        invD = [torch.linalg.inv(A[:, 0])]
        Ls = []
        for k in range(1, nzc):
            Lk = torch.matmul(Bm, invD[-1])
            Dk = A[:, k] - torch.matmul(Lk, Bp)
            invD.append(torch.linalg.inv(Dk))
            Ls.append(Lk)
        return {"invD": invD, "Ls": Ls, "BpT": Bp.T}

    def _zsolve_apply(self, data, r):
        if "diag" in data:
            return r / data["diag"]
        if "inv_self" in data:
            C, nloc = self.stencil.C, self.stencil.nloc
            return _bmv(data["inv_self"],
                             r.reshape(C, nloc)).reshape(-1)
        if "colinv" in data:
            return self._colinv_apply(data, r)
        nloc = self.stencil.nloc
        dims, d, nzc, ncol, perm, inv_perm = self._column_perm()
        invD, Ls, BpT = data["invD"], data["Ls"], data["BpT"]
        rg = r.reshape(dims + (nloc,)).permute(perm + (d,))
        rg = rg.reshape(ncol, nzc, nloc)
        y = [rg[:, 0]]
        for k in range(1, nzc):
            y.append(rg[:, k] - _bmv(Ls[k - 1], y[-1]))
        x = [None] * nzc
        x[-1] = _bmv(invD[-1], y[-1])
        for k in range(nzc - 2, -1, -1):
            x[k] = _bmv(invD[k], y[k] - _bmv(BpT.T, x[k + 1]))
        xg = torch.stack(x, dim=1)                        # (ncol, nzc, nloc)
        xg = xg.reshape(tuple(dims[i] for i in perm) + (nloc,))
        return xg.permute(inv_perm + (d,)).reshape(-1)

    def _colinv_apply(self, data, r):
        """Exact column solve through the frozen dense per-type column
        inverses: on a uniform box the block-tridiagonal column matrix
        takes a handful of distinct values (interior / boundary layers /
        corners), so the solve is one (ncol, nb) x (nb, t*nb) product plus
        a masked combine."""
        nloc = self.stencil.nloc
        dims, d, nzc, ncol, perm, inv_perm = self._column_perm()
        nb = nzc * nloc
        Minv = data["colinv"]                       # (t, nb, nb)
        mask = data["colmask"]                      # (ncol, t)
        t = Minv.shape[0]
        rg = r.reshape(dims + (nloc,)).permute(perm + (d,)).reshape(ncol, nb)
        ys = (rg @ Minv.reshape(t * nb, nb).T).reshape(ncol, t, nb)
        xg = (ys * mask[:, :, None]).sum(dim=1)     # (ncol, nb)
        xg = xg.reshape(tuple(dims[i] for i in perm) + (nloc,))
        return xg.permute(inv_perm + (d,)).reshape(-1)

    def _zsolve_apply_g(self, data, rg):
        """The smoother solve on a cell grid rg (n, cy, cz, nloc), in and
        out: the whole grid, or a run of whole cell layers with the
        layers' slice of the data (solver/grid_dg.py RankDGMultigrid)."""
        if "diag" in data:
            return rg / data["diag"].reshape(rg.shape)
        if "inv_self" in data:
            return _bmv(data["inv_self"].reshape(
                rg.shape[:-1] + data["inv_self"].shape[-2:]), rg)
        if "colinv" not in data:
            raise ValueError("grid-shaped smoother needs the dense column "
                             "form (column_dense=True) or block/jacobi")
        _, d, _, _, perm, inv_perm = self._column_perm()
        nb = rg.shape[self.col_axis] * rg.shape[-1]
        Minv = data["colinv"]                       # (t, nb, nb)
        mask = data["colmask"]                      # (ncol, t)
        t = Minv.shape[0]
        rt = rg.permute(perm + (d,)).reshape(-1, nb)
        ys = (rt @ Minv.reshape(t * nb, nb).T).reshape(-1, t, nb)
        xg = (ys * mask[:, :, None]).sum(dim=1)     # (ncol, nb)
        xg = xg.reshape(tuple(rg.shape[i] for i in perm) + rg.shape[-1:])
        # contiguous: a product over a strided view may sum in another
        # order than over the same values laid out densely
        return xg.permute(inv_perm + (d,)).contiguous()

    # ---- setup -------------------------------------------------------
    def freeze(self, T_dg0, dt) -> None:
        """Build the smoother factors once at the initial state, estimate
        rho(Z^{-1}A) by power iteration, and freeze both (plus the coarse
        hierarchy's smoother spectra). Everything runs on the host in
        numpy from the stencil's numpy sources; only the final factors go
        to the device. A tensor T_dg0 is never read: the frozen boundary
        linearization takes the operator's T_0 for it (a float or a numpy
        array gives its first value)."""
        st = self.stencil
        p = st.op.params
        C, nloc, d = st.C, st.nloc, st.d
        dev = st.op.device
        if isinstance(T_dg0, (int, float, np.floating)):
            T0 = float(T_dg0)
        elif isinstance(T_dg0, np.ndarray):
            T0 = float(T_dg0.reshape(-1)[0])
        else:                       # None or a tensor (= full(T_0))
            T0 = float(p.T_0)
        put = lambda a: torch.as_tensor(a, dtype=self.dtype, device=dev)

        # values_at at a constant initial temperature, in numpy
        vals = st.np_self_mass + dt * st.np_self_stiff
        bdm = st.op.np_b_dofmap
        if len(bdm):
            dflux0 = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * T0**3 + p.htc)
            blocks = dflux0 * dt * np.einsum(
                "fq,fql,fqm->flm", st.op.np_b_qw, st.op.np_b_phi,
                st.op.np_b_phi)
            b_cell = bdm[:, 0] // nloc
            base = np.arange(nloc * nloc)
            flat = (b_cell[:, None] * (nloc * nloc) + base).reshape(-1)
            vals = (vals.reshape(-1) + np.bincount(
                flat, weights=blocks.reshape(-1),
                minlength=C * nloc * nloc)).reshape(C, nloc, nloc)

        Bp = [b * dt for b in st.np_Bp]
        Bm = [b * dt for b in st.np_Bm]

        def np_matvec(x):
            xg = x.reshape(st.cell_dims + (nloc,))
            y = np.einsum("clm,cm->cl", vals,
                          x.reshape(C, nloc)).reshape(xg.shape)
            for a in range(d):
                for B, sign in ((Bp[a], +1), (Bm[a], -1)):
                    padc = [(0, 0)] * (d + 1)
                    padc[a] = (0, 1) if sign > 0 else (1, 0)
                    xp = np.pad(xg, padc)
                    sl = [slice(None)] * (d + 1)
                    sl[a] = (slice(1, None) if sign > 0
                             else slice(0, xg.shape[a]))
                    y = y + xp[tuple(sl)] @ B.T
            return y.reshape(-1)

        if self.smoother in ("jacobi", "chebyshev"):
            diag = np.einsum("cll->cl", vals).reshape(-1)
            zsolve = lambda r: r / diag
            data = {"diag": put(diag)}
        elif self.smoother == "block":
            inv_self = np.linalg.inv(vals)
            zsolve = lambda r: np.einsum(
                "clm,cm->cl", inv_self, r.reshape(C, nloc)).reshape(-1)
            data = {"inv_self": put(inv_self)}
        else:
            a = self.col_axis
            dims, _, nzc, ncol, perm, inv_perm = self._column_perm()
            A = vals.reshape(dims + (nloc, nloc))
            A = np.transpose(A, perm + (d, d + 1)).reshape(
                ncol, nzc, nloc, nloc)
            nb = nzc * nloc
            # dense per-type column inverses (see _colinv_apply): group
            # matching columns and invert each dense block-tridiagonal
            # column matrix once. Grouping keys are rounded to 12 digits:
            # assembly order leaves ~1e-12 relative noise between columns
            # of one type, and a frozen preconditioner may take any one
            keys = A.reshape(ncol, -1)
            kscale = max(float(np.abs(keys).max()), 1e-300)
            uniq, first, inv_idx = np.unique(
                np.round(keys / kscale, 12), axis=0, return_index=True,
                return_inverse=True)
            inv_idx = np.asarray(inv_idx).reshape(-1)
            if self.column_dense and nb <= 512 and len(uniq) <= 32:
                nt = len(uniq)
                Ms = np.zeros((nt, nb, nb))
                for t, At in enumerate(A[first]):
                    M = np.zeros((nb, nb))
                    for k in range(nzc):
                        M[k * nloc:(k + 1) * nloc,
                          k * nloc:(k + 1) * nloc] = At[k]
                        if k + 1 < nzc:
                            M[k * nloc:(k + 1) * nloc,
                              (k + 1) * nloc:(k + 2) * nloc] = Bp[a]
                            M[(k + 1) * nloc:(k + 2) * nloc,
                              k * nloc:(k + 1) * nloc] = Bm[a]
                    Ms[t] = np.linalg.inv(M)
                mask = np.zeros((ncol, nt))
                mask[np.arange(ncol), inv_idx] = 1.0

                def zsolve(r):
                    rg = r.reshape(dims + (nloc,))
                    rg = np.transpose(rg, perm + (d,)).reshape(ncol, nb)
                    x = np.empty_like(rg)
                    for t in range(nt):
                        sel = inv_idx == t
                        x[sel] = rg[sel] @ Ms[t].T
                    shape_perm = tuple(dims[i] for i in perm) + (nloc,)
                    xg = x.reshape(shape_perm)
                    return np.transpose(xg, inv_perm + (d,)).reshape(-1)

                data = {"colinv": put(Ms), "colmask": put(mask)}
            else:
                invD = [np.linalg.inv(A[:, 0])]
                Ls = []
                for k in range(1, nzc):
                    Lk = np.einsum("lm,cmk->clk", Bm[a], invD[-1])
                    Dk = A[:, k] - np.einsum("clk,km->clm", Lk, Bp[a])
                    invD.append(np.linalg.inv(Dk))
                    Ls.append(Lk)

                def zsolve(r):
                    rg = r.reshape(dims + (nloc,))
                    rg = np.transpose(rg, perm + (d,)).reshape(
                        ncol, nzc, nloc)
                    y = [rg[:, 0]]
                    for k in range(1, nzc):
                        y.append(rg[:, k] - np.einsum(
                            "clk,ck->cl", Ls[k - 1], y[-1]))
                    x = [None] * nzc
                    x[-1] = np.einsum("clm,cm->cl", invD[-1], y[-1])
                    for k in range(nzc - 2, -1, -1):
                        x[k] = np.einsum("clm,cm->cl", invD[k],
                                         y[k] - x[k + 1] @ Bp[a].T)
                    xg = np.stack(x, axis=1)
                    shape_perm = tuple(dims[i] for i in perm) + (nloc,)
                    xg = xg.reshape(shape_perm)
                    xg = np.transpose(xg, inv_perm + (d,))
                    return xg.reshape(-1)

                data = {"invD": [put(m) for m in invD],
                        "Ls": [put(m) for m in Ls],
                        "BpT": put(Bp[a].T)}

        n = C * nloc
        # rho(Z^-1 A), an upper estimate: the Chebyshev window [rho/4, rho]
        # must cover lambda_max, or the V-cycle amplifies the modes left
        # out. Power iteration from a seeded random start until the
        # Rayleigh estimate stalls, then a 15% margin (overestimating
        # weakens smoothing mildly; underestimating diverges)
        rng_pi = np.random.default_rng(12345)
        v = rng_pi.standard_normal(n)
        rho = 1.0
        for i in range(200):
            w = zsolve(np_matvec(v))
            rho_new = float(np.linalg.norm(w) / np.linalg.norm(v))
            v = w / np.linalg.norm(w)
            if i >= 30 and abs(rho_new - rho) < 1e-3 * rho:
                rho = rho_new
                break
            rho = rho_new
        self._frozen_rho = rho * 1.15
        self._frozen_smoother_data = data
        if self.coarse_kind == "grid":
            self.cg_mg.freeze_rhos(dt)
        else:
            self.cg_mg.freeze_omegas(None, dt)

    # ---- apply -------------------------------------------------------
    def preconditioner(self, T_dg, dt):
        """The p-MG V-cycle apply r -> ~A^{-1} r for the Jacobian frozen
        at T_dg: with frozen smoother data and rho (freeze), or else
        factors built here and rho from a short power iteration."""
        mv = self.stencil.make_matvec(T_dg, dt)
        T_cg = self.restrict_state(T_dg)
        inner = self.cg_mg.preconditioner(
            self.cg_mg.linearization_states(T_cg), dt)
        data = self._frozen_smoother_data
        rho = self._frozen_rho
        if data is None:
            data = self._zsolve_data(T_dg, dt)
        zsolve = lambda r: self._zsolve_apply(data, r)
        if rho is None:
            # fallback: a few power iterations from a deterministic start
            # underestimate, so take a wide margin
            v = torch.sin(torch.arange(T_dg.shape[0], dtype=T_dg.dtype,
                                       device=T_dg.device) * 0.7) + 0.01
            r = torch.ones((), dtype=T_dg.dtype, device=T_dg.device)
            for _ in range(10):
                w = zsolve(mv(v))
                r = torch.linalg.norm(w) / torch.linalg.norm(v)
                v = w / torch.linalg.norm(w)
            rho = r * 2.0

        smooth = self._make_smooth(mv, zsolve, rho)
        return self._pmg_apply(smooth, mv,
                               lambda rr: inner(self.restrict(rr)),
                               self.prolong)

    def preconditioner_g(self, T_dg_g, dt, matvec_g):
        """The grid-shaped apply for the grid-sharded step over the whole
        grid: `matvec_g` is the caller's Jacobian action (solver/grid_dg.py
        GridDGOperator.make_matvec_g at the frozen state); needs
        coarse_kind="grid" and freeze()."""
        assert self.coarse_kind == "grid", \
            "preconditioner_g needs coarse_kind='grid'"
        data = self._frozen_smoother_data
        rho = self._frozen_rho
        assert data is not None and rho is not None, "call freeze() first"
        pad = self._grid_pad0
        gx = self._node_grid[0]

        def pad0(a, mode="constant"):
            if not pad:
                return a
            if mode == "edge":
                return torch.cat([a, a[-1:].expand(
                    (pad,) + tuple(a.shape[1:]))])
            return F.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))

        T_cg = pad0(self.restrict_state_g(T_dg_g), mode="edge")
        inner = self.cg_mg.preconditioner_g(
            self.cg_mg.linearization_states_g(T_cg), dt)
        smooth = self._make_smooth(
            matvec_g, lambda r: self._zsolve_apply_g(data, r), rho)
        return self._pmg_apply(
            smooth, matvec_g,
            lambda rr: inner(pad0(self.restrict_g(rr)))[:gx], self.prolong_g)

    def _make_smooth(self, mv, zsolve, rho):
        """smooth(x, b): Chebyshev acceleration of `zsolve` over [rho/4,
        rho] ('jacobi': damped sweeps), nu steps. x None is the zero
        start, whose residual is b itself: no matvec is spent on it (the
        same bits as b - mv(0))."""
        nu = self.nu

        def smooth(x, b):
            res = lambda x: b if x is None else b - mv(x)  # noqa: E731
            if self.smoother == "jacobi":
                omega = 4.0 / (3.0 * rho)
                for _ in range(nu):
                    step = omega * zsolve(res(x))
                    x = step if x is None else x + step
                return x
            lmax = rho
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            z = zsolve(res(x))
            p = z / theta
            x = p if x is None else x + p
            for _ in range(max(nu - 1, 0)):
                z = zsolve(b - mv(x))
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        return smooth

    @staticmethod
    def _pmg_apply(smooth, mv, coarse, prolong):
        """The p-multigrid cycle: pre-smooth, the CG-1 correction
        `coarse(residual)` prolonged, post-smooth."""
        def apply(r):
            x = smooth(None, r)
            rr = r - mv(x)
            x = x + prolong(coarse(rr))
            return smooth(x, r)

        return apply
