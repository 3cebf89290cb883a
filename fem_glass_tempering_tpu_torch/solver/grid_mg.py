"""Grid-shaped geometric V-cycle for the vector elasticity operator.

Counterpart of `GridElastMG` in fem_glass_tempering_tpu/solver/grid_mg.py,
the preconditioner of the equilibrium-mechanics solve (models/mechanics.py;
Jacobi-CG stalls on thin tempering plates). The V-cycle keeps the
displacement grid-shaped (*grid, d) end to end:

  - the levels are GridElasticityOperators on the semi-coarsened box
    meshes of the heat multigrid's rule (solver/multigrid.py), down to the
    first level of at most 4,096 components, whose operator at the frozen
    instantaneous moduli is inverted densely on the host (numpy);
  - the per-level coefficients are the fine G/K fields averaged down the
    hierarchy cell by cell;
  - each level smooths by Chebyshev acceleration of a line solve along the
    strongly coupled axis (a batched block-Thomas factorisation of every
    column, where the cells are more than 3x anisotropic) or of the point
    diagonal, over [rho/4, rho] with rho a power-iteration estimate
    (lines) or a Gershgorin bound (points) computed at every build;
  - the transfers are the strided-slice lattice ops of GeometricMG with
    the vector component riding along.

Everything is plain PyTorch, as it is plain XLA in the JAX package. The
small-block algebra is written as multiply + reduce and the 3x3 inverse as
the closed-form adjugate, in the JAX version's order of operations.

The JAX version's `GridMG`, the grid-shaped heat V-cycle, differs from its
`GeometricMG` only by the ghost-padded fine level of the sharded step
(`pad0`). The port maps it to `GeometricMG` (solver/multigrid.py): the
CG-2 path's Q2MG (ops/grid2.py) runs that cycle on the flattened coarse
residual. The padded cycle waits for Slice 7 of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.solver.multigrid import (
    GeometricMG,
    _build_level_mesh,
    _next_dims,
    _sl,
)


class GridElastMG:
    """Usage: mg = GridElastMG(fine_op, make_level_op, frozen_moduli=(G0,
    K0)); apply = mg.preconditioner_g(G_q, K_q) -> r_grid -> ~A^{-1} r."""

    def __init__(self, fine, make_level_op, *, nu_pre: int = 2,
                 nu_post: int = 2, coarse_iters: int = 24,
                 min_level_nodes: int = 27,
                 frozen_moduli: tuple | None = None,
                 use_tables: bool = True):
        # materialized block-stencil tables for the cycle's matvecs
        # (ops/grid_elasticity.py stencil_table_g) or the cell recompute
        self.use_tables = use_tables
        meta = fine.fs.mesh.structured
        dims = tuple(meta["dims"])
        lengths = tuple(meta["lengths"])
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.coarse_iters = coarse_iters
        self.ops = [fine]
        self.axes: list[tuple | None] = []
        # with frozen moduli: stop at the first level whose component
        # count (nodes x d) fits the dense direct solve, which damps the
        # near-singular rigid-rotation modes of the free plate; without,
        # coarsen on and smooth the coarsest level
        dense_stop = 4096 if frozen_moduli is not None else 0

        def n_comp(dd):
            return fine.d * int(np.prod(tuple(n + 1 for n in dd)))

        while True:
            cdims = _next_dims(dims, lengths)
            if dense_stop and n_comp(dims) <= dense_stop:
                cdims = None
            if cdims is None or int(np.prod(
                    tuple(n + 1 for n in cdims))) < min_level_nodes:
                self.axes.append(None)
                break
            self.axes.append(tuple(a for a in range(len(dims))
                                   if cdims[a] != dims[a]))
            dims = cdims
            self.ops.append(make_level_op(_build_level_mesh(meta, dims)))
        self._dense_coarse = bool(dense_stop and n_comp(dims) <= dense_stop)
        self._frozen_moduli = frozen_moduli
        # constant element tables per level (uniform cells):
        #   A[(l,a),(m,b)] = G*EG + K*EK with
        #   EG = sum_q w [d_ab grad(phi_l).grad(phi_m) + d_b phi_l d_a phi_m
        #                 - (2/d) d_a phi_l d_b phi_m]
        #   EK = sum_q w d_a phi_l d_b phi_m
        self._tables = []       # Gershgorin row stats (SG, SK, DG, DK)
        self._EGK = []          # full (l, a, m, b) element tensors
        self._np_EGK = []       # numpy sources (dense coarse assembly)
        self._smoothers = []    # 'column' | 'point' per level
        self._col_axis = []
        for op in self.ops:
            qw, gp = op.np_qw1, op.np_gphi1
            d = op.d
            gg = np.einsum("q,qlg,qmg->lm", qw, gp, gp)
            cross = np.einsum("q,qlb,qma->lamb", qw, gp, gp)
            EK = np.einsum("q,qla,qmb->lamb", qw, gp, gp)
            EG = (np.einsum("lm,ab->lamb", gg, np.eye(d))
                  + cross - (2.0 / d) * EK)
            SG = np.abs(EG).sum(axis=(2, 3))
            SK = np.abs(EK).sum(axis=(2, 3))
            DG = np.einsum("lala->la", EG)
            DK = np.einsum("lala->la", EK)
            f = (lambda o: lambda a: torch.as_tensor(
                a, dtype=o.dtype, device=o.device))(op)
            self._tables.append((f(SG), f(SK), f(DG), f(DK)))
            self._EGK.append((f(EG), f(EK)))
            self._np_EGK.append((EG, EK))
            # line smoothing along the strongly coupled (small-h) axis:
            # point smoothers cannot damp the through-thickness modes of a
            # thin plate
            h = [ln / dd for ln, dd in zip(
                op.fs.mesh.structured["lengths"], op.dims)]
            aniso = max(h) / min(h) > 3.0 and d >= 2
            ax = int(np.argmin(h))
            if aniso and op.dims[ax] >= 1:
                self._smoothers.append("column")
                self._col_axis.append(ax)
            else:
                self._smoothers.append("point")
                self._col_axis.append(None)
        # frozen dense inverse of the coarsest level at the instantaneous
        # moduli (xi = 0), assembled and inverted on the host in f64 and
        # cast to the level's dtype
        self.coarse_inv = None
        if self._dense_coarse:
            G0, K0 = self._frozen_moduli
            A = self._np_dense_coarse(float(G0), float(K0))
            last = self.ops[-1]
            self.coarse_inv = torch.as_tensor(
                np.linalg.inv(A), dtype=last.dtype, device=last.device)

    # ------------------------------------------------------------------
    def _np_dense_coarse(self, G0: float, K0: float) -> np.ndarray:
        """Host-assembled dense matrix of the coarsest level at constant
        moduli, pinned components as identity rows and columns."""
        op = self.ops[-1]
        EG, EK = self._np_EGK[-1]
        E = G0 * EG + K0 * EK                 # (l, a, m, b)
        base = op.grid
        d = op.d
        nn = int(np.prod(base))
        A = np.zeros((nn * d, nn * d))
        dims = op.dims
        cells = np.stack(np.meshgrid(
            *[np.arange(n) for n in dims], indexing="ij"),
            axis=-1).reshape(-1, len(dims))   # (C, ndim)
        strides = np.array([int(np.prod(base[i + 1:]))
                            for i in range(len(base))])
        node = {l: (cells + np.array(op.loffs[l])) @ strides
                for l in range(op.nloc)}
        for l in range(op.nloc):
            for m in range(op.nloc):
                for a in range(d):
                    for b in range(d):
                        np.add.at(A, (node[l] * d + a, node[m] * d + b),
                                  E[l, a, m, b])
        pin = op.np_pin_mask.reshape(-1) > 0
        A[pin, :] = 0.0
        A[:, pin] = 0.0
        A[pin, pin] = 1.0
        return A

    # ---- transfers (vector trailing dim) ------------------------------
    def _restrict(self, i, rg):
        for a in self.axes[i]:
            rg = GeometricMG._restrict_axis(rg, a)
        return rg

    def _prolong(self, i, xc):
        for a in self.axes[i]:
            xc = GeometricMG._prolong_axis(xc, a)
        return xc

    @staticmethod
    def _coarsen_cells(arr, axes):
        """Cell coefficients one level down: the mean of the 2 children
        along each halved axis."""
        for a in axes:
            even = arr[_sl(a, slice(0, None, 2))]
            odd = arr[_sl(a, slice(1, None, 2))]
            arr = 0.5 * (even + odd)
        return arr

    def _rho_bound(self, op, tbl, Gc, Kc):
        """Gershgorin bound on rho(D^{-1}A) from per-cell scalar
        coefficients (the max over q): scattered abs-row-sums over the
        scattered diagonal."""
        SG, SK, DG, DK = tbl
        num_cell = Gc[..., None, None] * SG + Kc[..., None, None] * SK
        den_cell = Gc[..., None, None] * DG + Kc[..., None, None] * DK
        num = op._scatter(num_cell, op.grid + (op.d,), Gc.dtype)
        den = op._scatter(den_cell, op.grid + (op.d,), Gc.dtype)
        ratio = torch.where(
            op.pin_mask_g, torch.ones_like(num),
            num / torch.where(den == 0, torch.ones_like(den), den))
        return torch.max(ratio) * 1.01

    # ---- block-tridiagonal column smoother ---------------------------
    def _column_blocks(self, i, Gc, Kc):
        """The line matrix along the strongly coupled axis: Dg (*grid, d, d)
        nodal diagonal blocks and Ug (*grid, d, d), Ug[n] coupling node n
        to n + e_ax (zero at the last plane), from per-cell scalar
        coefficients. Pinned components: identity rows, couplings cut."""
        op = self.ops[i]
        EG, EK = self._EGK[i]
        ax = self._col_axis[i]
        d = op.d
        Dg = torch.zeros(op.grid + (d, d), dtype=Gc.dtype, device=Gc.device)
        Ug = torch.zeros_like(Dg)
        for l in range(op.nloc):
            sl = op._corner_slice(l)
            Dg[sl] += (Gc[..., None, None] * EG[l, :, l, :]
                       + Kc[..., None, None] * EK[l, :, l, :])
            if op.loffs[l][ax] == 0:
                m = l + (1 << ax)
                Ug[sl] += (Gc[..., None, None] * EG[l, :, m, :]
                           + Kc[..., None, None] * EK[l, :, m, :])
        free = 1.0 - op.pin_mask_g.to(Gc.dtype)              # (*grid, d)
        pin = 1.0 - free
        Dg = (Dg * free[..., :, None] * free[..., None, :]
              + torch.eye(d, dtype=Gc.dtype, device=Gc.device)
              * pin[..., :, None])
        n_ax = free.shape[ax]
        free_next = torch.cat([free.narrow(ax, 1, n_ax - 1),
                               torch.zeros_like(free.narrow(ax, 0, 1))],
                              dim=ax)
        Ug = Ug * free[..., :, None] * free_next[..., None, :]
        return Dg, Ug

    @staticmethod
    def _bmv(M, v):
        """(..., a, b) x (..., b) -> (..., a), as multiply + reduce."""
        return (M * v[..., None, :]).sum(-1)

    @staticmethod
    def _bmm(A, B):
        """(..., a, b) x (..., b, e) -> (..., a, e), as multiply + reduce."""
        return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)

    @staticmethod
    def _inv_small(M):
        """Closed-form batched inverse of 1x1 / 2x2 / 3x3 blocks (the
        adjugate over the determinant)."""
        d = M.shape[-1]
        if d == 1:
            return 1.0 / M
        if d == 2:
            a, b = M[..., 0, 0], M[..., 0, 1]
            c, e = M[..., 1, 0], M[..., 1, 1]
            det = a * e - b * c
            return torch.stack([
                torch.stack([e, -b], dim=-1),
                torch.stack([-c, a], dim=-1)], dim=-2) / det[..., None, None]
        if d == 3:
            m = M
            c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
            c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
            c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
            c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
            c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
            c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
            c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
            c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
            c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
            det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01
                   + m[..., 0, 2] * c02)
            adj = torch.stack([
                torch.stack([c00, c10, c20], dim=-1),
                torch.stack([c01, c11, c21], dim=-1),
                torch.stack([c02, c12, c22], dim=-1)], dim=-2)
            return adj / det[..., None, None]
        return torch.linalg.inv(M)

    def _column_solver(self, i, Dg, Ug):
        """Batched block-Thomas factorisation of every line along the
        level's column axis -> zsolve(r) over (*grid, d) tensors."""
        op = self.ops[i]
        ax = self._col_axis[i]
        d = op.d
        grid = op.grid
        nsp = len(grid)
        nzc = grid[ax]
        ncol = int(np.prod(grid)) // nzc
        perm = tuple(j for j in range(nsp) if j != ax) + (ax,)
        inv_perm = tuple(int(j) for j in np.argsort(perm))

        def to_cols(a, trail):
            a = a.permute(perm + tuple(nsp + t for t in range(trail)))
            return a.reshape((ncol, nzc) + tuple(a.shape[nsp:]))

        D = to_cols(Dg, 2)
        U = to_cols(Ug, 2)
        invD = [self._inv_small(D[:, 0])]
        Ls = []
        for k in range(1, nzc):
            # the lower block at row k is U_{k-1}^T (symmetric operator)
            Lk = self._bmm(U[:, k - 1].transpose(-1, -2), invD[-1])
            Dk = D[:, k] - self._bmm(Lk, U[:, k - 1])
            invD.append(self._inv_small(Dk))
            Ls.append(Lk)
        shape_perm = tuple(grid[j] for j in perm) + (d,)

        def zsolve(r):
            rg = to_cols(r, 1)                              # (ncol, nzc, d)
            y = [rg[:, 0]]
            for k in range(1, nzc):
                y.append(rg[:, k] - self._bmv(Ls[k - 1], y[-1]))
            x = [None] * nzc
            x[-1] = self._bmv(invD[-1], y[-1])
            for k in range(nzc - 2, -1, -1):
                x[k] = self._bmv(
                    invD[k], y[k] - self._bmv(U[:, k], x[k + 1]))
            xg = torch.stack(x, dim=1).reshape(shape_perm)
            return xg.permute(inv_perm + (nsp,))
        return zsolve

    @staticmethod
    def _power_rho(mv, zsolve, shape, dtype, device, iters=8):
        """Power-iteration estimate of rho(Z^{-1}A) from the fixed start
        sin(0.7 k) + 0.01 (no random generator), times 1.1."""
        n = int(np.prod(shape))
        v = (torch.sin(torch.arange(n, dtype=dtype, device=device) * 0.7)
             + 0.01).reshape(shape)
        rho = torch.ones((), dtype=dtype, device=device)
        for _ in range(iters):
            w = zsolve(mv(v))
            nw = torch.linalg.norm(w.reshape(-1))
            rho = nw / torch.linalg.norm(v.reshape(-1))
            v = w / nw
        return rho * 1.1

    def preconditioner_g(self, G_q, K_q, fine_table=None):
        """The V-cycle apply at the coefficient fields G_q / K_q ((*dims, q)
        of the fine level): r (*grid, d) -> ~A^{-1} r. `fine_table` shares
        the caller's fine-level stencil table (one build per solve)."""
        matvecs, diags, rhos, zsolves = [], [], [], []
        Gq, Kq = G_q, K_q
        n_levels = len(self.ops)
        for i, op in enumerate(self.ops):
            if self.use_tables:
                tbl = (fine_table if i == 0 and fine_table is not None
                       else op.stencil_table_g(Gq, Kq))
                mv = (lambda op, tbl: lambda v: op.matvec_table_g(tbl, v)
                      )(op, tbl)
            else:
                mv = op.make_matvec_g(Gq, Kq)
            matvecs.append(mv)
            Gcell = torch.mean(Gq, dim=-1)
            Kcell = torch.mean(Kq, dim=-1)
            if i == n_levels - 1 and self.coarse_inv is not None:
                # dense direct coarse solve: no smoother data
                zsolves.append(None)
                diags.append(None)
                rhos.append(None)
            elif self._smoothers[i] == "column":
                Dg, Ug = self._column_blocks(i, Gcell, Kcell)
                zs = self._column_solver(i, Dg, Ug)
                zsolves.append(zs)
                diags.append(None)
                rhos.append(self._power_rho(
                    mv, zs, op.grid + (op.d,), Gq.dtype, Gq.device))
            else:
                zsolves.append(None)
                diags.append(op.jacobian_diag_g(Gq, Kq))
                rhos.append(self._rho_bound(op, self._tables[i],
                                            torch.amax(Gq, dim=-1),
                                            torch.amax(Kq, dim=-1)))
            if self.axes[i] is not None:
                Gc = self._coarsen_cells(Gcell, self.axes[i])
                Kc = self._coarsen_cells(Kcell, self.axes[i])
                q = self.ops[i + 1].qw1.shape[0]
                Gq = Gc[..., None].expand(Gc.shape + (q,))
                Kq = Kc[..., None].expand(Kc.shape + (q,))

        def smooth(i, x, b, nu):
            # Chebyshev acceleration of the level smoother Z^{-1} (line
            # solve or point diagonal) over [rho/4, rho]. x None is the
            # zero start, whose first residual b - A 0 is b exactly
            if zsolves[i] is not None:
                zsolve = zsolves[i]
            else:
                zsolve = (lambda di: lambda r: r / di)(diags[i])
            lmax = rhos[i]
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b if x is None else b - matvecs[i](x)
            p = zsolve(r) / theta
            x = p if x is None else x + p
            for _ in range(max(nu - 1, 0)):
                r = b - matvecs[i](x)
                z = zsolve(r)
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        def coarse_solve(i, b):
            if self.coarse_inv is None:
                return smooth(i, None, b, self.coarse_iters)
            return (self.coarse_inv @ b.reshape(-1)).reshape(b.shape)

        def cycle(b):
            # a loop down the levels and back up: a recursive closure would
            # hold itself, so each build's level tables would wait for the
            # cyclic collector
            bs, xs = [], []
            i = 0
            while self.axes[i] is not None:
                x = smooth(i, None, b, self.nu_pre)
                r = b - matvecs[i](x)
                bs.append(b)
                xs.append(x)
                b = self._restrict(i, r)
                i += 1
            xc = coarse_solve(i, b)
            for i in reversed(range(len(xs))):
                x = xs[i] + self._prolong(i, xc)
                xc = smooth(i, x, bs[i], self.nu_post)
            return xc

        return cycle
