"""Gather-free vector elasticity operator for CG-1 on uniform box meshes.

Counterpart of fem_glass_tempering_tpu/ops/grid_elasticity.py: the
equilibrium-mechanics operator (models/mechanics.py) applied cell-wise on
the node grid instead of through a dofmap gather:

  1. the 2^d cell-corner fields are static slices of the (*grid, d)
     displacement grid;
  2. grad(u) at the cell quadrature points is one einsum with the single
     uniform-cell gradient table (q, l, g);
  3. the stress and r_cell = w sigma : grad(phi) run batched over all
     cells, with per-cell-quadrature G/K coefficients;
  4. the scatter back is 2^d static-slice adds (no repeated index, so the
     card repeats its bits).

`stencil_table_g` materialises the frozen-coefficient operator as a
(*grid, 3^d, d, d) block-stencil table, which `matvec_table_g` streams;
the CG and the V-cycle (solver/grid_mg.py) apply it. Both stay plain
PyTorch here, as they are plain XLA in the JAX package.

`pad_axis0` appends ghost node planes along axis 0 (pinned: identity
rows; zero strain), the layout of the grid-sharded step
(parallel/grid_shard.py). `slab(lo, hi)` restricts the operator to one
rank's planes of it (GridElasticitySlab): the whole grid's methods on the
planes [lo - 1, hi + 1) and the cells between them, the owned rows kept,
each equal to the whole grid's row.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry
from fem_glass_tempering_tpu_torch.ops.elasticity import _rigid_body_pins


def slab_cells(lo: int, hi: int, ncell: int) -> tuple:
    """The cells along axis 0 of the node planes [lo, hi) of a grid with
    `ncell` cells there -> ((c0, c1), (a, b)): [c0, c1) the cells between
    the planes [lo - 1, hi + 1) (a slab's window), [a, b) those whose low
    plane lies in [lo, hi) (the rank's own: every cell has one owner)."""
    c0 = min(max(0, lo - 1), ncell)
    c1 = max(c0, min(ncell, hi))
    a = min(lo, ncell)
    return (c0, c1), (a, max(a, min(hi, ncell)))


class GridElasticityOperator:
    """Vector CG-1 equilibrium operator on a uniform box mesh, applied to
    grid-shaped displacement fields (*grid, d). `pad_axis0` appends that
    many ghost node planes along axis 0, pinned (identity rows), as
    GridHeatOperator does."""

    def __init__(self, fs_sigma: FunctionSpace, dtype=torch.float32,
                 pad_axis0: int = 0, device=None):
        mesh = fs_sigma.mesh
        if mesh.structured is None:
            raise ValueError("GridElasticityOperator needs a structured box")
        self.fs = FunctionSpace(mesh, fs_sigma.family, fs_sigma.degree)
        if self.fs.family != "CG" or self.fs.degree != 1:
            raise ValueError("GridElasticityOperator needs a CG-1 space")
        self.device = resolve_device(device)
        self.d = mesh.tdim
        self.dtype = dtype
        self.dims = tuple(mesh.structured["dims"])
        self.base_grid = tuple(n + 1 for n in self.dims)
        self.pad0 = int(pad_axis0)
        self.grid = (self.base_grid[0] + self.pad0,) + self.base_grid[1:]
        self.n = self.fs.n_scalar_dofs
        # the whole grid on axis 0: its cells [0, dims[0]) from node row 0
        self._row0 = 0
        self._cells0 = (0, self.dims[0])

        cg = build_cell_geometry(mesh, self.fs)
        qw = np.asarray(cg.qweights)
        gphi = np.asarray(cg.grad_phys)
        if (np.abs(qw - qw[0]).max() > 1e-12 * max(qw.max(), 1e-30)
                or np.abs(gphi - gphi[0]).max() > 1e-12):
            raise ValueError("non-uniform cell tables — mesh is not a "
                             "uniform box")
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        self.qw1 = f(qw[0])                  # (q,)
        self.phi1 = f(cg.phi)                # (q, l)
        self.gphi1 = f(gphi[0])              # (q, l, g)
        self.nloc = self.phi1.shape[1]
        # local corner l <-> lattice offset bits (the builders' order)
        self.loffs = [tuple((l >> i) & 1 for i in range(self.d))
                      for l in range(self.nloc)]

        # rigid-body pins, the flat operator's choice on the node grid
        pins = _rigid_body_pins(self.fs)
        mask = np.zeros(self.base_grid + (self.d,))
        for dof, comp in pins:
            idx = np.unravel_index(int(dof), self.base_grid)
            mask[idx + (int(comp),)] = 1.0
        if self.pad0:
            # the ghost planes pinned: identity rows
            mask = np.pad(mask, [(0, self.pad0)] + [(0, 0)] * self.d,
                          constant_values=1.0)
        self.np_pin_mask = mask              # numpy source (dense coarse)
        self.pin_mask_g = torch.as_tensor(mask > 0, device=self.device)
        self._slabs: dict = {}

        # host copies for the smoother bounds of solver/grid_mg.py
        self.np_qw1 = qw[0]
        self.np_gphi1 = gphi[0]

        # q-resolved element tensors of the block-stencil table:
        # E(cell)[l,a,m,b] = sum_q G_q EGq[q,l,a,m,b] + K_q EKq[q,l,a,m,b]
        # with EGq = w (delta_ab gp_l.gp_m + gp[m,a] gp[l,b]
        #               - (2/d) gp[l,a] gp[m,b]),  EKq = w gp[l,a] gp[m,b]
        gp = self.np_gphi1                                 # (q, l, g)
        w = self.np_qw1                                    # (q,)
        gg = np.einsum("qlg,qmg->qlm", gp, gp)
        eye = np.eye(self.d)
        EKq = np.einsum("q,qla,qmb->qlamb", w, gp, gp)
        EGq = (np.einsum("qlm,ab->qlamb", np.einsum("q,qlm->qlm", w, gg),
                         eye)
               + np.einsum("q,qma,qlb->qlamb", w, gp, gp)
               - (2.0 / self.d) * EKq)
        self._EGq = f(EGq)
        self._EKq = f(EKq)
        # the 3^d offsets of the block stencil: k = sum_i (off_i + 1) 3^i
        self._offsets = [tuple(int(o) - 1 for o in idx)
                         for idx in np.ndindex(*([3] * self.d))]
        self._offset_index = {off: sum((off[i] + 1) * 3 ** i
                                       for i in range(self.d))
                              for off in self._offsets}
        self._k_order = [self._offset_index[off] for off in self._offsets]

    def slab(self, lo: int, hi: int) -> "GridElasticitySlab":
        """The operator restricted to planes [lo, hi) of the grid (one per
        range: the coupling's CG and its V-cycle's fine level share it)."""
        if (lo, hi) not in self._slabs:
            self._slabs[(lo, hi)] = GridElasticitySlab(self, lo, hi)
        return self._slabs[(lo, hi)]

    # ------------------------------------------------------------------
    def _corner_slice(self, l: int) -> tuple:
        """Static slices addressing corner l of every cell: a window of the
        node grid shaped as the cells (axis 0: the cells [c0, c1) of
        `_cells0`, from node row `_row0`)."""
        off = self.loffs[l]
        c0, c1 = self._cells0
        b = c0 - self._row0 + off[0]
        return (slice(b, b + c1 - c0),) + tuple(
            slice(off[i], off[i] + self.dims[i]) for i in range(1, self.d))

    def _corners(self, ug: torch.Tensor) -> torch.Tensor:
        """(*grid, d) -> (*dims, l, d) cell-corner values."""
        return torch.stack([ug[self._corner_slice(l)]
                            for l in range(self.nloc)], dim=-2)

    def _scatter(self, r_cell: torch.Tensor, out_shape, dtype) -> torch.Tensor:
        """(*dims, l, ...) cell contributions -> (*grid, ...) nodal sums by
        2^d static-slice adds."""
        r = torch.zeros(tuple(out_shape), dtype=dtype, device=r_cell.device)
        for l in range(self.nloc):
            r[self._corner_slice(l)] += r_cell[..., l, :]
        return r

    def _mask(self, vg: torch.Tensor) -> torch.Tensor:
        return torch.where(self.pin_mask_g, torch.zeros_like(vg), vg)

    # ------------------------------------------------------------------
    def strain_at_q(self, ug: torch.Tensor) -> torch.Tensor:
        """eps(u) at the cell quadrature points: (*dims, q, d, d)."""
        uc = self._corners(ug)                                 # (*dims, l, d)
        gu = torch.einsum("...la,qlg->...qag", uc, self.gphi1)
        return 0.5 * (gu + gu.transpose(-1, -2))

    def _cell_residual(self, eps, sigma_hist_q, G_q, K_q):
        d = self.d
        tr = torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)
        I = torch.eye(d, dtype=eps.dtype, device=eps.device)
        dev = eps - (tr / d)[..., None, None] * I
        # summed left to right, as the JAX version: (hist + 2G dev) + K tr I
        sig = 2.0 * G_q[..., None, None] * dev
        if sigma_hist_q is not None:
            sig = sigma_hist_q + sig
        sig = sig + K_q[..., None, None] * tr[..., None, None] * I
        return torch.einsum("q,...qag,qlg->...la", self.qw1, sig, self.gphi1)

    def residual_g(self, ug, sigma_hist_q, eps0_q, G_q, K_q):
        """Weak equilibrium residual on the grid. ug: (*grid, d);
        sigma_hist_q / eps0_q: (*dims, q, d, d); G_q / K_q: (*dims, q).
        Returns (*grid, d), zero at the pinned components."""
        ug = self._mask(ug)
        eps = self.strain_at_q(ug) - eps0_q
        r_cell = self._cell_residual(eps, sigma_hist_q, G_q, K_q)
        r = self._scatter(r_cell, ug.shape, ug.dtype)
        return torch.where(self.pin_mask_g, ug, r)

    def make_matvec_g(self, G_q, K_q):
        """v -> K v (grid-shaped) at frozen coefficients, recomputed cell
        by cell; pinned components are identity rows."""
        def mv(vg):
            eps = self.strain_at_q(self._mask(vg))
            r_cell = self._cell_residual(eps, None, G_q, K_q)
            r = self._scatter(r_cell, vg.shape, vg.dtype)
            return torch.where(self.pin_mask_g, vg, r)
        return mv

    def stencil_table_g(self, G_q, K_q) -> torch.Tensor:
        """The frozen-coefficient operator as a block-stencil table
        B (*grid, 3^d, d, d), B[n, k] coupling node n to node n + offset(k)
        (zero blocks toward missing neighbours): 4^d slice adds of the
        per-cell element blocks. Equal to make_matvec_g's apply."""
        d = self.d
        E = (torch.einsum("...q,qlamb->...lamb", G_q, self._EGq)
             + torch.einsum("...q,qlamb->...lamb", K_q, self._EKq))
        B = torch.zeros(self.grid + (3 ** d, d, d), dtype=G_q.dtype,
                        device=G_q.device)
        for l in range(self.nloc):
            sl = self._corner_slice(l)
            for m in range(self.nloc):
                off = tuple(self.loffs[m][i] - self.loffs[l][i]
                            for i in range(d))
                B[sl + (self._offset_index[off],)] += E[..., l, :, m, :]
        return B

    def matvec_table_g(self, B: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
        """v -> K v from the block table: 3^d shifted multiply-reduce terms
        over the zero-padded grid. The shifted copies are one unfolded
        view of the padded grid, multiplied and reduced in one pass each;
        the 3^d terms are then summed one by one in the offsets' order, as
        the JAX version sums them."""
        vp = F.pad(self._mask(vg), (0, 0) + (1, 1) * self.d)
        r = self._apply_table(B, vp, self.grid)
        return torch.where(self.pin_mask_g, vg, r)

    def _apply_table(self, B, vp, rows_grid) -> torch.Tensor:
        """The table's rows `rows_grid` applied to `vp`, the masked vector
        with one more plane (zero or halo) on each side of every axis."""
        d = self.d
        for i in range(d):
            vp = vp.unfold(i, 3, 1)          # (*rows, d, o_0, ..., o_i)
        # (*rows, o_{d-1}, ..., o_0, d) -> (*rows, 3^d, d): k = sum o_i 3^i
        perm = (tuple(range(d)) + tuple(d + 1 + i for i in reversed(range(d)))
                + (d,))
        V = vp.permute(perm).reshape(tuple(rows_grid) + (3 ** d, d))
        S = (B * V[..., None, :]).sum(-1)                  # (*rows, 3^d, d)
        r = S[..., self._k_order[0], :]
        for k in self._k_order[1:]:
            r = r + S[..., k, :]
        return r

    def jacobian_diag_g(self, G_q, K_q) -> torch.Tensor:
        """Exact diagonal of the elastic stiffness, (*grid, d), from the
        per-cell closed form of ops/elasticity.py, by slice adds."""
        d = self.d
        g2 = torch.einsum("qlg,qlg->ql", self.gphi1, self.gphi1)
        ga2 = self.gphi1 ** 2                                  # (q, l, g)
        coefG = torch.einsum("...q,q,ql->...l", G_q, self.qw1, g2)
        term = torch.einsum("...q,q,qlg->...lg",
                            G_q * (1.0 - 2.0 / d) + K_q, self.qw1, ga2)
        diag_cell = coefG[..., None] + term                    # (*dims, l, d)
        dd = self._scatter(diag_cell, self.grid + (d,), G_q.dtype)
        return torch.where(self.pin_mask_g, torch.ones_like(dd), dd)

    # ------------------------------------------------------------------
    def cell_avg_from_nodes(self, xg: torch.Tensor) -> torch.Tensor:
        """Nodal grid scalar (*grid) -> (*dims, q) values at the quadrature
        points."""
        xc = torch.stack([xg[self._corner_slice(l)]
                          for l in range(self.nloc)], dim=-1)  # (*dims, l)
        return torch.einsum("...l,ql->...q", xc, self.phi1)

    def tensor_at_q(self, sg: torch.Tensor) -> torch.Tensor:
        """Nodal tensor grid (*grid, d, d) -> (*dims, q, d, d)."""
        sc = torch.stack([sg[self._corner_slice(l)]
                          for l in range(self.nloc)], dim=-3)
        return torch.einsum("...lab,ql->...qab", sc, self.phi1)

    def strain_at_nodes(self, ug: torch.Tensor) -> torch.Tensor:
        """eps(u) at the grid nodes, each from its owner cell (the highest
        cell index wins, fem/functionspace.py): node i along an axis is
        corner 0 of cell i, the last node corner 1 of the last cell; zero
        on the ghost planes. Returns (*grid, d, d)."""
        d = self.d
        c0, c1 = self._cells0
        zeros = lambda n: torch.zeros(  # noqa: E731
            (n,) + self.grid[1:] + (d, d), dtype=ug.dtype, device=ug.device)
        if c1 == c0:
            return zeros(self.grid[0])
        # grad phi at the vertices of the uniform cell: invJ = diag(1/h)
        ipts = self.fs.element.interpolation_points()
        dphi_ip = np.asarray(self.fs.element.tabulate_grad(ipts))  # (p,l,t)
        h = [ln / dd for ln, dd in zip(
            self.fs.mesh.structured["lengths"], self.dims)]
        invJ = np.diag([1.0 / hh for hh in h])                 # (t, g)
        gphi_ip = torch.as_tensor(np.einsum("tg,plt->plg", invJ, dphi_ip),
                                  dtype=self.dtype, device=ug.device)
        uc = self._corners(ug)                                 # (*dims, l, d)
        gu = torch.einsum("...la,plg->...pag", uc, gphi_ip)
        eps_c = 0.5 * (gu + gu.transpose(-1, -2))              # (*dims,p,d,d)

        def build(axis, bits):
            if axis == d:
                p = sum(bits[i] << i for i in range(d))
                return eps_c[..., p, :, :]
            low = build(axis + 1, bits + (0,))
            if axis == 0 and c1 < self.dims[0]:
                return low               # the last cell lies past the window
            high = build(axis + 1, bits + (1,))
            last = high.narrow(axis, low.shape[axis] - 1, 1)
            return torch.cat([low, last], dim=axis)

        # the nodes [c0, c0 + n) of axis 0; the other rows hold no owner
        # cell of the window (ghost planes, a slab's edges)
        out = build(0, ())
        before = c0 - self._row0
        after = self.grid[0] - before - out.shape[0]
        if before or after:
            out = torch.cat([zeros(before), out, zeros(after)])
        return out


class GridElasticitySlab(GridElasticityOperator):
    """A GridElasticityOperator restricted to planes [lo, hi) of its
    (padded) grid: one rank's share of the grid-sharded step. It computes
    on the L + 2 planes [lo - 1, hi + 1) and the cells between them (the
    whole grid's methods on that window; the pin mask sliced from the
    whole grid's, pinned outside it) and keeps the L owned rows, each
    equal to the whole grid's row. Its node inputs carry the halo: (L +
    2, *grid[1:], ...), the neighbours' planes first and last, zeros where
    there is none (parallel/comm.py halo_exchange); its cell inputs
    (G_q, K_q, ...) are over `cell_grid`, the window's cells."""

    def __init__(self, op: GridElasticityOperator, lo: int, hi: int):
        self.__dict__.update(op.__dict__)
        self._slabs = {}
        G0 = op.grid[0]
        if not 0 <= lo < hi <= G0:
            raise ValueError(f"slab [{lo}, {hi}) outside the grid's {G0} "
                             f"planes")
        self.L = hi - lo
        self.slab_grid = (self.L,) + op.grid[1:]
        e0, E = lo - 1, self.L + 2
        self.grid = (E,) + op.grid[1:]
        self._row0 = e0
        self._cells0, self.own_cells = slab_cells(lo, hi, op.dims[0])
        self.cell_grid = ((self._cells0[1] - self._cells0[0],)
                          + op.dims[1:])
        a, b = max(e0, 0), min(e0 + E, G0)
        mask = np.pad(op.np_pin_mask[a:b],
                      [(a - e0, e0 + E - b)] + [(0, 0)] * self.d,
                      constant_values=1.0)
        self.np_pin_mask = mask
        self.pin_mask_g = torch.as_tensor(mask > 0, device=self.device)
        self.own_pin = self.pin_mask_g[1:-1]

    def residual_r(self, u_ext, sigma_hist_q, eps0_q, G_q, K_q):
        """The owned rows of the residual, (L, *grid[1:], d)."""
        return self.residual_g(u_ext, sigma_hist_q, eps0_q, G_q, K_q)[1:-1]

    def jacobian_diag_r(self, G_q, K_q):
        return self.jacobian_diag_g(G_q, K_q)[1:-1]

    def stencil_table_r(self, G_q, K_q):
        """The owned rows' block table (L, *grid[1:], 3^d, d, d)."""
        return self.stencil_table_g(G_q, K_q)[1:-1]

    def matvec_table_r(self, B_r, v_ext):
        """v -> K v on the owned rows from their table and v with its halo
        planes (L + 2, *grid[1:], d)."""
        vp = F.pad(self._mask(v_ext), (0, 0) + (1, 1) * (self.d - 1)
                   + (0, 0))
        r = self._apply_table(B_r, vp, self.slab_grid)
        return torch.where(self.own_pin, v_ext[1:-1], r)

    def strain_at_nodes_r(self, u_ext):
        """eps(u) at the owned nodes (L, *grid[1:], d, d)."""
        return self.strain_at_nodes(u_ext)[1:-1]
