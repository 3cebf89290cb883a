"""Stencil matvec for CG-1 on structured box meshes.

Counterpart of fem_glass_tempering_tpu/ops/stencil.py (StencilMatrix). On
a structured grid the Jacobian is a 3^d-point stencil, so the matvec needs
no gather: J x = sum_o vals[o] * shift(x, o). The constant mass/stiffness
parts are laid out once at setup (numpy); the per-Newton boundary
linearization is scattered into a precomputed index set, one group of
distinct targets at a time (ops/scatter.py).

The production apply is `matvec_flat`: the minor grid axes merge into one
flat axis (gx, gy*gz), and the apply is the hand-written CUDA kernel of
ops/cuda_stencil.py on the GPU (its plain twin on the CPU).

DGStencilMatrix is the SIPG-DG counterpart: a block stencil on the cell
lattice, in plain PyTorch (small-block matmuls and slices of the cell
grid), carrying the Jacobian action and the whole Newton residual and
diagonal of a DG space on a box.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter


class StencilMatrix:
    def __init__(self, op: HeatOperator, make_tables: bool = True):
        fs = op.fs
        mesh = fs.mesh
        if mesh.structured is None or fs.family != "CG" or fs.degree != 1:
            raise ValueError("StencilMatrix needs a structured box mesh "
                             "with a CG-1 space")
        self.op = op
        dims = tuple(mesh.structured["dims"])
        d = len(dims)
        self.grid = tuple(n + 1 for n in dims)
        n = fs.n_scalar_dofs
        if int(np.prod(self.grid)) != n:
            raise ValueError("space size does not match the node grid")

        # lattice offsets, lexicographic: index o = sum((delta_i+1)*3^pos)
        self.offsets = [off for off in np.ndindex(*([3] * d))]
        self.n_off = 3 ** d
        strides = np.array([int(np.prod(self.grid[i + 1:])) for i in range(d)])

        def multi(idx):
            out = []
            for s in strides:
                out.append(idx // s)
                idx = idx % s
            return np.stack(out, axis=-1)

        def offset_flat(rows, cols):
            """(row, col) dof pairs -> flat index o*n + row into the
            (n_off, n) stencil layout."""
            delta = multi(cols.astype(np.int64)) - multi(rows.astype(np.int64)) + 1
            if delta.min() < 0 or delta.max() > 2:
                raise ValueError("dof pair is not a lattice neighbour")
            o = np.zeros(rows.shape, dtype=np.int64)
            for i in range(d):
                o = o * 3 + delta[..., i]
            return o * n + rows

        # single-cell element matrices from the operator's numpy sources
        qw = op.np_qw
        phi = op.np_phi
        gphi = op.np_gphi
        if not (op.uniform and qw.ndim == 1):
            raise ValueError("StencilMatrix needs uniform single-cell tables")
        mass1 = op.c_mass * np.einsum("q,ql,qm->lm", qw, phi, phi)
        stiff1 = op.c_diff * np.einsum("q,qlg,qmg->lm", qw, gphi, gphi)
        nloc = mass1.shape[0]
        # slice accumulation: corner l of every cell covers the node-grid
        # window [loff_i, loff_i + nc_i) per axis — each (l, m) pair adds
        # one constant into one offset plane over that window
        loffs = [tuple((l >> i) & 1 for i in range(d)) for l in range(nloc)]
        vals_mass = np.zeros((self.n_off,) + self.grid)
        vals_stiff = np.zeros((self.n_off,) + self.grid)
        for l in range(nloc):
            sl = tuple(slice(loffs[l][i], loffs[l][i] + dims[i])
                       for i in range(d))
            for m in range(nloc):
                o = 0
                for i in range(d):
                    o = o * 3 + (loffs[m][i] - loffs[l][i] + 1)
                vals_mass[(o,) + sl] += mass1[l, m]
                vals_stiff[(o,) + sl] += stiff1[l, m]
        self.np_mass = vals_mass
        self.np_stiff = vals_stiff
        self.st_mass = self.st_stiff = None
        if make_tables:
            self.ensure_tables()

        # host-side Gershgorin row statistics for the smoother spectrum
        # bounds (solver/multigrid.py freeze_omegas): abs row sums and
        # diagonals of mass/stiffness, plus the boundary linearization at T_0
        vm = vals_mass.reshape(self.n_off, n)
        vs = vals_stiff.reshape(self.n_off, n)
        center = (self.n_off - 1) // 2
        p = op.params
        b_abs = np.zeros(n)
        b_diag = np.zeros(n)
        bdm = op.np_b_dofmap.astype(np.int64)
        if len(bdm):
            dflux0 = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * p.T_0**3 + p.htc)
            blocks = dflux0 * np.einsum(
                "fq,fql,fqm->flm", op.np_b_qw, op.np_b_phi, op.np_b_phi)
            b_abs = np.bincount(bdm.reshape(-1),
                                weights=np.abs(blocks).sum(axis=2).reshape(-1),
                                minlength=n)
            b_diag = np.bincount(bdm.reshape(-1),
                                 weights=np.einsum("fll->fl", blocks).reshape(-1),
                                 minlength=n)
        self.gersh = {
            "mass_abs": np.abs(vm).sum(axis=0), "mass_diag": vm[center].copy(),
            "stiff_abs": np.abs(vs).sum(axis=0), "stiff_diag": vs[center].copy(),
            "b_abs": b_abs, "b_diag": b_diag,
        }

        # boundary-block scatter positions into the stencil layout
        b_dofmap = op.np_b_dofmap.astype(np.int64)
        if len(b_dofmap):
            nb = b_dofmap.shape[1]
            b_rows = np.broadcast_to(b_dofmap[:, :, None],
                                     b_dofmap.shape[:1] + (nb, nb))
            b_cols = np.broadcast_to(b_dofmap[:, None, :],
                                     b_dofmap.shape[:1] + (nb, nb))
            self.np_b_st_idx = offset_flat(b_rows.reshape(-1),
                                           b_cols.reshape(-1))
            self._sc_b = GroupedScatter(self.np_b_st_idx, self.n_off * n,
                                        op.device)
        else:
            self.np_b_st_idx = self._sc_b = None
        self.n = n
        self.d = d

    def ensure_tables(self) -> None:
        """Materialise the (n_off, *grid) device tables (idempotent)."""
        if self.st_mass is None:
            f = lambda a: torch.as_tensor(a, dtype=self.op.dtype,
                                          device=self.op.device)
            self.st_mass = f(self.np_mass)
            self.st_stiff = f(self.np_stiff)

    # ------------------------------------------------------------------
    def values_at(self, T: torch.Tensor, dt) -> torch.Tensor:
        op = self.op
        p = op.params
        if self.st_mass is None:
            raise RuntimeError(
                "device tables not materialised — call ensure_tables()")
        vals = self.st_mass + dt * self.st_stiff
        if self._sc_b is not None:
            Tb = torch.einsum("fql,fl->fq", op.b_phi, T[op.b_dofmap])
            dflux = p.boundary_scale * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
            blocks = torch.einsum("fq,fql,fqm->flm", op.b_qw * dt * dflux,
                                  op.b_phi, op.b_phi)
            vals = self._sc_b.add_(vals.reshape(-1), blocks).reshape(
                vals.shape)
        return vals

    def np_dense(self, T0: float, dt: float) -> np.ndarray:
        """Dense (n, n) Jacobian at the uniform temperature T0, assembled
        on the host from the numpy stencil sources — the frozen direct
        coarse solve of the MG hierarchy. Mirrors values_at(T0, dt):
        mass + dt*stiffness + the boundary linearization, then Dirichlet
        identity rows matching the masked matvec."""
        op = self.op
        n = self.n
        grid = self.grid
        vals = (self.np_mass + dt * self.np_stiff)
        A = np.zeros((n, n))
        idx = np.arange(n).reshape(grid)
        for o, off in enumerate(self.offsets):
            delta = [int(v) - 1 for v in off]
            rows_sl = tuple(slice(max(0, -dl), g - max(0, dl))
                            for dl, g in zip(delta, grid))
            cols_sl = tuple(slice(max(0, dl), g - max(0, -dl))
                            for dl, g in zip(delta, grid))
            A[idx[rows_sl].ravel(), idx[cols_sl].ravel()] = \
                vals[o][rows_sl].ravel()
        bdm = op.np_b_dofmap.astype(np.int64)
        if len(bdm):
            p = op.params
            dflux0 = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * float(T0) ** 3 + p.htc)
            blocks = np.einsum("fq,fql,fqm->flm", op.np_b_qw * (dt * dflux0),
                               op.np_b_phi, op.np_b_phi)
            np.add.at(A, (np.broadcast_to(bdm[:, :, None], blocks.shape),
                          np.broadcast_to(bdm[:, None, :], blocks.shape)),
                      blocks)
        if op.has_bc:
            mask = op.np_bc_mask
            A[mask, :] = 0.0
            A[:, mask] = 0.0
            A[np.ix_(mask, mask)] = np.eye(int(mask.sum()))
        return A

    def matvec_g(self, vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
        """Grid-shaped matvec: (n_off, *grid) values x (*grid) -> (*grid),
        as zero-padded shifted slices."""
        xp = F.pad(xg, (1, 1) * self.d)
        acc = torch.zeros(self.grid, dtype=xg.dtype, device=xg.device)
        for o, off in enumerate(self.offsets):
            sl = tuple(slice(int(v), int(v) + g) for v, g in zip(off, self.grid))
            acc = acc + vals[o] * xp[sl]
        return acc

    def matvec(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.matvec_g(vals, x.reshape(self.grid)).reshape(-1)

    def matvec_flat(self, vals2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """vals2: (n_off, gx, M) with M = prod(grid[1:]); x flat (n,).
        The CUDA kernel on the GPU, its plain twin on the CPU."""
        return stencil_matvec(vals2, x, self.grid)

    def make_matvec(self, T: torch.Tensor, dt):
        vals = self.values_at(T, dt)
        if self.d > 1:
            vals2 = vals.reshape(self.n_off, self.grid[0], -1)
            mv = lambda v: self.matvec_flat(vals2, v)
        else:
            mv = lambda v: self.matvec(vals, v)
        if self.op.has_bc:
            mask = self.op.bc_mask
            return lambda v: torch.where(
                mask, v, mv(torch.where(mask, torch.zeros_like(v), v)))
        return mv


def _sl(axis: int, s: slice) -> tuple:
    """Index tuple applying slice `s` along `axis`."""
    return (slice(None),) * axis + (s,)


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched small-block matvec: (..., n, m) x (..., m) -> (..., n)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


class DGStencilMatrix:
    """Gather-free SIPG-DG Jacobian on structured box meshes.

    DG dofs are cell-contiguous (dof = cell*nloc + l), and on a box mesh
    every interior facet joins lattice-neighbour cells, so the Jacobian is
    a block stencil on the cell lattice:

        (J x)_c = A_c x_c + dt * sum_a [ B+_a x_{c+e_a} + B-_a x_{c-e_a} ]

    - A_c: consistent mass + dt*(stiffness + SIPG self terms) + the
      per-Newton boundary (radiation/convection) linearization; a
      (C, nloc, nloc) table, or with `allow_const` one interior block plus
      corrections on the 2d boundary cell layers.
    - B±_a: the SIPG facet coupling, one constant (nloc, nloc) block per
      direction on a uniform box (per-cell blocks otherwise).

    Neighbour access is slicing of the (*cell_dims, nloc) cell grid. The
    boundary-facet terms are added one group of distinct cells at a time
    (ops/scatter.py `GroupedScatter`), never by a scatter with repeated
    indices.
    """

    def __init__(self, op: HeatOperator, allow_const: bool = True):
        fs = op.fs
        mesh = fs.mesh
        if mesh.structured is None or fs.family != "DG":
            raise ValueError("DGStencilMatrix needs a structured box mesh "
                             "with a DG space")
        self.op = op
        dims = tuple(mesh.structured["dims"])
        d = len(dims)
        self.cell_dims = dims
        nloc = fs.element.nloc
        C = mesh.n_cells
        if int(np.prod(dims)) != C or fs.n_scalar_dofs != C * nloc:
            raise ValueError("space size does not match the cell grid")
        self.nloc, self.C, self.d = nloc, C, d
        p = op.params
        dev = op.device
        g = lambda arr: torch.as_tensor(np.asarray(arr), dtype=op.dtype,
                                        device=dev)

        qw = op.np_qw
        phi = op.np_phi
        gphi = op.np_gphi
        if qw.ndim == 1:       # uniform-mesh compact tables
            m1 = op.c_mass * np.einsum("q,ql,qm->lm", qw, phi, phi)
            s1 = op.c_diff * np.einsum("q,qlg,qmg->lm", qw, gphi, gphi)
            self_mass = np.broadcast_to(m1, (C,) + m1.shape).copy()
            self_stiff = np.broadcast_to(s1, (C,) + s1.shape).copy()
        else:
            self_mass = op.c_mass * np.einsum("cq,ql,qm->clm", qw, phi, phi)
            self_stiff = op.c_diff * np.einsum("cq,cqlg,cqmg->clm",
                                               qw, gphi, gphi)

        # ---- SIPG facet blocks (the residual's formulas) ----
        coef = op.c_diff * op.np_i["qw"]                  # (f, q)
        php = op.np_i["phi_p"]
        phm = op.np_i["phi_m"]
        dnp_ = op.np_i["dnphi_p"]
        dnm = op.np_i["dnphi_m"]
        penh = (p.dg_penalty / op.np_i["h_p"])[:, None]
        Jpp = (np.einsum("fq,fql,fqm->flm", coef * penh, php, php)
               - 0.5 * np.einsum("fq,fql,fqm->flm", coef, dnp_, php)
               - 0.5 * np.einsum("fq,fql,fqm->flm", coef, php, dnp_))
        Jpm = (-np.einsum("fq,fql,fqm->flm", coef * penh, php, phm)
               + 0.5 * np.einsum("fq,fql,fqm->flm", coef, dnp_, phm)
               - 0.5 * np.einsum("fq,fql,fqm->flm", coef, php, dnm))
        Jmp = (-np.einsum("fq,fql,fqm->flm", coef * penh, phm, php)
               - 0.5 * np.einsum("fq,fql,fqm->flm", coef, dnm, php)
               + 0.5 * np.einsum("fq,fql,fqm->flm", coef, phm, dnp_))
        Jmm = (np.einsum("fq,fql,fqm->flm", coef * penh, phm, phm)
               + 0.5 * np.einsum("fq,fql,fqm->flm", coef, dnm, phm)
               + 0.5 * np.einsum("fq,fql,fqm->flm", coef, phm, dnm))

        # cell-contiguous dofmap -> facet cell ids and lattice directions
        cell_p = op.np_i["dofmap_p"][:, 0] // nloc
        cell_m = op.np_i["dofmap_m"][:, 0] // nloc
        base = np.arange(nloc * nloc)
        flat_p = (cell_p[:, None] * (nloc * nloc) + base).reshape(-1)
        flat_m = (cell_m[:, None] * (nloc * nloc) + base).reshape(-1)
        self_stiff = (self_stiff.reshape(-1)
                      + np.bincount(flat_p, weights=Jpp.reshape(-1),
                                    minlength=C * nloc * nloc)
                      + np.bincount(flat_m, weights=Jmm.reshape(-1),
                                    minlength=C * nloc * nloc)
                      ).reshape(C, nloc, nloc)

        strides = np.array([int(np.prod(dims[i + 1:])) for i in range(d)])

        def multi(idx):
            out = []
            for s in strides:
                out.append(idx // s)
                idx = idx % s
            return np.stack(out, axis=-1)

        delta = multi(cell_m.astype(np.int64)) - multi(cell_p.astype(np.int64))
        if not np.all(np.abs(delta).sum(axis=-1) == 1):
            raise ValueError("interior facet joins non-neighbour cells")
        axis_of = np.argmax(np.abs(delta), axis=-1)       # (f,)
        if not np.all(delta[np.arange(len(delta)), axis_of] == 1):
            raise ValueError("the '+' cell must be the lower lattice index")

        # per-axis cross blocks; constant on a uniform grid
        self.cross_const = True
        Bp, Bm = [], []                      # Bp[a]: x_{c+e_a} block (rows c)
        self.Bp_cells = self.Bm_cells = None
        for a in range(d):
            sel = axis_of == a
            if not sel.any():                # degenerate axis (dims[a] == 1)
                Bp.append(np.zeros((nloc, nloc)))
                Bm.append(np.zeros((nloc, nloc)))
                continue
            jp, jm = Jpm[sel], Jmp[sel]
            scale = max(np.abs(jp).max(), 1e-30)
            if (np.abs(jp - jp[0]).max() > 1e-10 * scale
                    or np.abs(jm - jm[0]).max() > 1e-10 * scale):
                self.cross_const = False
            Bp.append(jp[0])
            Bm.append(jm[0])
        if self.cross_const:
            self.Bp = [g(b) for b in Bp]
            self.Bm = [g(b) for b in Bm]
        else:
            # per-cell cross blocks, zero where no neighbour exists
            Bp_cells = np.zeros((d, C, nloc, nloc))
            Bm_cells = np.zeros((d, C, nloc, nloc))
            for a in range(d):
                sel = axis_of == a
                Bp_cells[a, cell_p[sel]] = Jpm[sel]
                Bm_cells[a, cell_m[sel]] = Jmp[sel]
            self.Bp_cells = g(Bp_cells)
            self.Bm_cells = g(Bm_cells)

        # ---- constant-block form (uniform box) ----
        # every cell's self block is
        #   A_c = m1 + dt*( s1 + sum_a [1(c_a<n_a-1) Jpp_a + 1(c_a>0) Jmm_a] )
        # so the (C, nloc, nloc) tables collapse to one interior block plus
        # per-axis corrections on the two boundary cell layers, and the
        # boundary-flux linearization rides as facet-local blocks
        self.self_const = False
        self.A_mass = self.A_stiff = None
        self.corr_pp = self.corr_mm = None
        if allow_const and qw.ndim == 1 and self.cross_const:
            ok = True
            Cpp, Cmm = [], []
            for a in range(d):
                sel = axis_of == a
                if not sel.any():
                    Cpp.append(np.zeros((nloc, nloc)))
                    Cmm.append(np.zeros((nloc, nloc)))
                    continue
                jpp, jmm = Jpp[sel], Jmm[sel]
                scale = max(np.abs(jpp).max(), 1e-30)
                if (np.abs(jpp - jpp[0]).max() > 1e-10 * scale
                        or np.abs(jmm - jmm[0]).max() > 1e-10 * scale):
                    ok = False
                    break
                Cpp.append(jpp[0])
                Cmm.append(jmm[0])
            if ok:
                base = s1 + sum(Cpp) + sum(Cmm)   # interior-cell stiffness
                self.A_mass = g(m1)
                self.A_stiff = g(base)
                self.corr_pp = [g(c) for c in Cpp]
                self.corr_mm = [g(c) for c in Cmm]
                self.self_const = True

        # numpy copies for host-side setup (DGMultigrid.freeze)
        self.np_self_mass = self_mass
        self.np_self_stiff = self_stiff
        self.np_Bp = [np.asarray(b) for b in Bp]
        self.np_Bm = [np.asarray(b) for b in Bm]
        # source row integral per cell dof: the f term of the residual
        if qw.ndim == 1:
            f1_row = np.einsum("q,ql->l", qw, phi)
            self.f1_row = g(f1_row)                          # (nloc,)
            self.f1 = (None if self.self_const
                       else g(np.broadcast_to(f1_row, (C, nloc)).copy()))
        else:
            self.f1_row = None
            self.f1 = g(np.einsum("cq,ql->cl", qw, phi))
        # the (C, nloc, nloc) device tables exist only in the table form
        self.self_mass = self.self_stiff = None
        if not self.self_const:
            self.self_mass = g(self_mass)
            self.self_stiff = g(self_stiff)
        # boundary (exterior facet) cells, as groups of distinct cells
        b_dofmap = op.np_b_dofmap
        self.b_cell = self._sc_b = None
        if len(b_dofmap):
            b_cell = (b_dofmap[:, 0] // nloc).astype(np.int64)
            self.b_cell = torch.as_tensor(b_cell, device=dev)
            self._sc_b = GroupedScatter(b_cell, C, dev)
        self.n = fs.n_scalar_dofs

    # ------------------------------------------------------------------
    def _bflux_blocks(self, T: torch.Tensor, dt) -> torch.Tensor:
        """Per-boundary-facet (f, nloc, nloc) linearized radiation +
        convection blocks at the frozen T."""
        op = self.op
        p = op.params
        Tb = torch.einsum("fql,fl->fq", op.b_phi, T[op.b_dofmap])
        dflux = p.boundary_scale * (4.0 * p.sigma * p.epsilon * Tb**3
                                    + p.htc)
        return torch.einsum("fq,fql,fqm->flm", op.b_qw * dt * dflux,
                            op.b_phi, op.b_phi)

    def _layer_corrections(self, dt):
        """(axis, cell-layer, block) triples: subtract dt*Jpp_a on the
        last layer of axis a (no +a facet) and dt*Jmm_a on the first
        (no -a facet)."""
        out = []
        for a in range(self.d):
            n_a = self.cell_dims[a]
            out.append((a, n_a - 1, dt * self.corr_pp[a]))
            out.append((a, 0, dt * self.corr_mm[a]))
        return out

    def _self_const_mv(self, A0: torch.Tensor, cscale, xg: torch.Tensor):
        """y_c = A_c x_c from the constant-block form: one matmul with the
        interior block A0, then the 2d boundary cell layers corrected in
        order (on an axis of one cell both land on the same layer).
        `cscale` scales the stiffness-only corrections (dt for the
        Jacobian, 1 for the residual's stiffness apply).
        xg: (*cell_dims, nloc); returns the same shape."""
        y = xg @ A0.T
        for a, layer, Jc in self._layer_corrections(cscale):
            s = _sl(a, slice(layer, layer + 1))
            y[s] = y[s] - xg[s] @ Jc.T
        return y

    def values_at(self, T: torch.Tensor, dt) -> torch.Tensor:
        """Self blocks A_c(T) = mass + dt*(stiff+SIPG_self) + dt*B'(T), as
        a (C, nloc, nloc) tensor (rebuilt from the constant blocks in the
        constant-block form)."""
        nloc = self.nloc
        if self.self_const:
            A0 = self.A_mass + dt * self.A_stiff
            vals = A0.expand(self.cell_dims + (nloc, nloc)).clone()
            for a, layer, Jc in self._layer_corrections(dt):
                s = _sl(a, slice(layer, layer + 1))
                vals[s] = vals[s] - Jc
            vals = vals.reshape(self.C, nloc, nloc)
        else:
            vals = self.self_mass + dt * self.self_stiff
        if self.b_cell is not None:
            self._sc_b.add_(vals, self._bflux_blocks(T, dt))
        return vals

    def _cross_apply(self, y, xg, dt):
        """Add the facet cross-block terms dt*(B+_a x_{c+e_a} + B-_a
        x_{c-e_a}) to the grid-shaped y, in place: x_{c+e_a} is zero on
        the last layer of axis a, x_{c-e_a} on the first."""
        nloc = self.nloc
        for a in range(self.d):
            hi, lo = _sl(a, slice(1, None)), _sl(a, slice(0, -1))
            if self.cross_const:
                y[lo] = y[lo] + dt * (xg[hi] @ self.Bp[a].T)
                y[hi] = y[hi] + dt * (xg[lo] @ self.Bm[a].T)
            else:
                Bp = self.Bp_cells[a].reshape(self.cell_dims + (nloc, nloc))
                Bm = self.Bm_cells[a].reshape(self.cell_dims + (nloc, nloc))
                y[lo] = y[lo] + dt * _bmv(Bp[lo], xg[hi])
                y[hi] = y[hi] + dt * _bmv(Bm[hi], xg[lo])
        return y

    def matvec(self, vals_self: torch.Tensor, dt,
               x: torch.Tensor) -> torch.Tensor:
        xc = x.reshape(self.C, self.nloc)
        y = _bmv(vals_self, xc).reshape(self.cell_dims + (self.nloc,))
        return self._cross_apply(
            y, x.reshape(self.cell_dims + (self.nloc,)), dt).reshape(-1)

    def make_matvec(self, T: torch.Tensor, dt):
        if self.self_const:
            A0 = self.A_mass + dt * self.A_stiff
            blocks = (self._bflux_blocks(T, dt)
                      if self.b_cell is not None else None)
            nloc = self.nloc

            def mv(v):
                xg = v.reshape(self.cell_dims + (nloc,))
                y = self._cross_apply(self._self_const_mv(A0, dt, xg), xg, dt)
                if blocks is not None:
                    yb = _bmv(blocks, v.reshape(self.C, nloc)[self.b_cell])
                    self._sc_b.add_(y.reshape(self.C, nloc), yb)
                return y.reshape(-1)
        else:
            vals = self.values_at(T, dt)
            mv = lambda v: self.matvec(vals, dt, v)
        if self.op.has_bc:
            mask = self.op.bc_mask
            return lambda v: torch.where(
                mask, v, mv(torch.where(mask, torch.zeros_like(v), v)))
        return mv

    # ------------------------------------------------------------------
    # Gather-free residual / diagonal: everything but the boundary flux is
    # linear in T and encoded by the block stencil, so the residual is one
    # stencil apply plus a boundary-layer term
    def _base_residual(self, T, T_prev, dt):
        op = self.op
        p = op.params
        nloc = self.nloc
        Tc = T.reshape(self.C, nloc)
        Tpc = T_prev.reshape(self.C, nloc)
        # mass acts on the per-step difference (small next to ~800 K)
        if self.self_const:
            r = (((Tc - Tpc) @ self.A_mass.T)
                 - (dt * p.f) * self.f1_row).reshape(-1)
        else:
            f1 = self.f1 if self.f1 is not None else self.f1_row
            r = (_bmv(self.self_mass, Tc - Tpc) - (dt * p.f) * f1).reshape(-1)
        # (K + SIPG) annihilates constant fields, so apply it to T - mean(T)
        # and leave no row-sum cancellation of the ~800 K constant part
        z = T - torch.mean(T)
        if self.self_const:
            zg = z.reshape(self.cell_dims + (nloc,))
            y = self._cross_apply(
                self._self_const_mv(self.A_stiff, 1.0, zg), zg, 1.0)
            r = r + dt * y.reshape(-1)
        else:
            r = r + dt * self.matvec(self.self_stiff, 1.0, z)
        if self.b_cell is not None:
            Tb = torch.einsum("fql,fl->fq", op.b_phi, T[op.b_dofmap])
            gflux = p.boundary_scale * (
                (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
                + p.htc * (Tb - p.T_ambient))
            r_b = torch.einsum("fq,fql->fl", op.b_qw * dt * gflux, op.b_phi)
            r = self._sc_b.add_(r.reshape(self.C, nloc), r_b).reshape(-1)
        return r

    def residual(self, T: torch.Tensor, T_prev: torch.Tensor,
                 dt=None) -> torch.Tensor:
        op = self.op
        dt = op.dt if dt is None else dt
        if not op.has_bc:
            return self._base_residual(T, T_prev, dt)
        T_eff = torch.where(op.bc_mask, op.bc_values, T)
        r = self._base_residual(T_eff, T_prev, dt)
        return torch.where(op.bc_mask, T - op.bc_values, r)

    def jacobian_diag(self, T: torch.Tensor, dt=None) -> torch.Tensor:
        op = self.op
        dt = op.dt if dt is None else dt
        nloc = self.nloc
        if self.self_const:
            drow = torch.diagonal(self.A_mass + dt * self.A_stiff)  # (nloc,)
            dg = drow.expand(self.cell_dims + (nloc,)).clone()
            for a, layer, Jc in self._layer_corrections(dt):
                s = _sl(a, slice(layer, layer + 1))
                dg[s] = dg[s] - torch.diagonal(Jc)
            d = dg.reshape(self.C, nloc)
            if self.b_cell is not None:
                db = torch.diagonal(self._bflux_blocks(T, dt), dim1=-2,
                                    dim2=-1)
                self._sc_b.add_(d, db)
            d = d.reshape(-1)
        else:
            vals = self.values_at(T, dt)                 # (C, nloc, nloc)
            d = torch.diagonal(vals, dim1=-2, dim2=-1).reshape(-1)
        if op.has_bc:
            d = torch.where(op.bc_mask, torch.ones_like(d), d)
        return d


def make_stencil_operator(op: HeatOperator, allow_const: bool = True):
    """The gather-free stencil operator of the operator's space: the CG-1
    nodal stencil or the DG block stencil, on structured box meshes.
    Raises ValueError when neither applies."""
    if op.fs.family == "DG":
        return DGStencilMatrix(op, allow_const=allow_const)
    return StencilMatrix(op)
