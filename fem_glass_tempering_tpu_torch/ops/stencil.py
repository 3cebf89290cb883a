"""Stencil matvec for CG-1 on structured box meshes.

Counterpart of fem_glass_tempering_tpu/ops/stencil.py (StencilMatrix). On
a structured grid the Jacobian is a 3^d-point stencil, so the matvec needs
no gather: J x = sum_o vals[o] * shift(x, o). The constant mass/stiffness
parts are laid out once at setup (numpy); the per-Newton boundary
linearization is scattered into a precomputed index set.

The production apply is `matvec_flat`: the minor grid axes merge into one
flat axis (gx, gy*gz), and the apply is the hand-written CUDA kernel of
ops/cuda_stencil.py on the GPU (its plain twin on the CPU).

The DG block stencil (DGStencilMatrix) waits for Slice 3 of the port
(ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator


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
            self.b_st_idx = torch.as_tensor(
                offset_flat(b_rows.reshape(-1), b_cols.reshape(-1)),
                device=op.device)
        else:
            self.b_st_idx = None
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
        if self.b_st_idx is not None:
            Tb = torch.einsum("fql,fl->fq", op.b_phi, T[op.b_dofmap])
            dflux = p.boundary_scale * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
            blocks = torch.einsum("fq,fql,fqm->flm", op.b_qw * dt * dflux,
                                  op.b_phi, op.b_phi)
            vals = vals.reshape(-1).index_add(
                0, self.b_st_idx, blocks.reshape(-1)).reshape(vals.shape)
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
