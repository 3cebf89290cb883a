"""Geometry precompute for assembly (setup-time numpy).

A copy of the JAX package's `ops/assembly.py` builders: quadrature-point
geometry factors (physical basis gradients, weighted Jacobian determinants,
facet normals) as dense numpy arrays, which the operators copy onto the
device as torch tensors.

Layout conventions (index letters used in einsums):
  c = cells, q = quadrature points, l/m = local basis functions,
  g/d = spatial dimension, f = facets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fem_glass_tempering_tpu_torch.fem.elements import geometry_element
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import Mesh
from fem_glass_tempering_tpu_torch.fem.quadrature import cell_quadrature, facet_quadrature


# ======================================================================
# dataclasses holding precomputed geometry (numpy; consumers copy to torch)
# ======================================================================

@dataclass
class CellGeometry:
    """Per-cell quadrature geometry for volume integrals."""

    qpoints_ref: np.ndarray   # (q, tdim)
    qweights: np.ndarray      # (c, q)  = w_q * |detJ|
    phi: np.ndarray           # (q, l) basis values
    grad_phys: np.ndarray     # (c, q, l, g) physical basis gradients
    qpoints_phys: np.ndarray  # (c, q, g) physical quadrature points


@dataclass
class FacetGeometry:
    """Per-boundary-facet quadrature geometry."""

    cell: np.ndarray          # (f,) incident cell
    qweights: np.ndarray      # (f, q) = w_q * physical facet measure
    phi: np.ndarray           # (f, q, l) cell basis at facet points
    grad_phys: np.ndarray     # (f, q, l, g)
    normal: np.ndarray        # (f, q, g) outward unit normal
    qpoints_phys: np.ndarray  # (f, q, g)


@dataclass
class InteriorFacetGeometry:
    """Per-interior-facet ('+'/'-') quadrature geometry for DG."""

    cell_p: np.ndarray        # (f,)
    cell_m: np.ndarray        # (f,)
    qweights: np.ndarray      # (f, q)
    phi_p: np.ndarray         # (f, q, l)
    phi_m: np.ndarray
    grad_p: np.ndarray        # (f, q, l, g)
    grad_m: np.ndarray
    normal_p: np.ndarray      # (f, q, g) outward from '+' cell
    h_p: np.ndarray           # (f,) SIPG penalty length: vol(K+)/area(F)
    qpoints_phys: np.ndarray  # (f, q, g) physical quadrature points


# ======================================================================
# geometry helpers (setup-time numpy)
# ======================================================================

def _jacobians(mesh: Mesh, ref_points: np.ndarray, cells: np.ndarray):
    """J, detJ, invJ at `ref_points` for the given cells.

    J: (c, q, g, t) = d x / d xi. For gdim == tdim only (this framework's
    scope; the reference is likewise gdim == tdim, ThermoViscoProblem.py:28).
    """
    geom = geometry_element(mesh.cell_type)
    dphi = geom.tabulate_grad(ref_points)        # (q, v, t)
    xc = mesh.nodes[mesh.cells[cells]]           # (c, v, g)
    J = np.einsum("cvg,qvt->cqgt", xc, dphi)
    if mesh.tdim == 1:
        detJ = J[..., 0, 0]
        invJ = (1.0 / detJ)[..., None, None]
    else:
        detJ = np.linalg.det(J)
        invJ = np.linalg.inv(J)
    return J, detJ, invJ


def _reference_outward_normals(mesh: Mesh) -> np.ndarray:
    """(n_facets, tdim) outward unit normals of the reference cell facets."""
    rc = mesh.ref_cell
    centroid = rc.vertices.mean(axis=0)
    out = []
    for lf in range(rc.n_facets):
        fv = rc.facet_vertex_coords(lf)
        if rc.tdim == 1:
            n = np.array([1.0]) if fv[0, 0] > centroid[0] else np.array([-1.0])
        else:
            v0 = fv[0]
            A = (fv[1:] - v0).T
            _, _, vt = np.linalg.svd(A.T, full_matrices=True)
            n = vt[rc.tdim - 1]
            if np.dot(n, fv.mean(axis=0) - centroid) < 0:
                n = -n
        out.append(n / np.linalg.norm(n))
    return np.asarray(out)


def _invert_geometry_map(mesh: Mesh, cells: np.ndarray, x_phys: np.ndarray) -> np.ndarray:
    """Reference coordinates of physical points inside given cells.

    x_phys: (f, q, g); returns (f, q, t). Affine cells solve in one step;
    bilinear/trilinear cells use a few Newton iterations (setup-time numpy).
    """
    geom = geometry_element(mesh.cell_type)
    rc = mesh.ref_cell
    xc = mesh.nodes[mesh.cells[cells]]           # (f, v, g)
    f, q, g = x_phys.shape
    xi = np.broadcast_to(rc.vertices.mean(axis=0), (f, q, rc.tdim)).copy()
    for _ in range(1 if rc.simplex else 12):
        pts = xi.reshape(f * q, rc.tdim)
        phi = geom.tabulate(pts).reshape(f, q, -1)                     # (f,q,v)
        dphi = geom.tabulate_grad(pts).reshape(f, q, -1, rc.tdim)      # (f,q,v,t)
        X = np.einsum("fqv,fvg->fqg", phi, xc)
        J = np.einsum("fvg,fqvt->fqgt", xc, dphi)
        r = x_phys - X
        if mesh.tdim == 1:
            dxi = (r[..., 0] / J[..., 0, 0])[..., None]
        else:
            dxi = np.linalg.solve(J, r[..., None])[..., 0]
        xi = xi + dxi
        if np.max(np.abs(r)) < 1e-13:
            break
    return xi


# ======================================================================
# builders
# ======================================================================

def build_cell_geometry(mesh: Mesh, fs: FunctionSpace, quad_degree: int | None = None) -> CellGeometry:
    qd = quad_degree if quad_degree is not None else 2 * fs.degree + 1
    qp, qw = cell_quadrature(mesh.cell_type, qd)
    phi = fs.element.tabulate(qp)                  # (q, l)
    dphi = fs.element.tabulate_grad(qp)            # (q, l, t)
    if mesh.structured is not None:
        # uniform box: every cell is congruent — tabulate ONE cell and
        # broadcast (read-only views, no per-cell memory or compute; the
        # O(n_cells) einsums cost minutes at 1M cells)
        J1, detJ1, invJ1 = _jacobians(mesh, qp, np.arange(1))
        grad1 = np.einsum("cqtg,qlt->cqlg", invJ1, dphi)       # (1,q,l,g)
        c = mesh.n_cells
        q = qp.shape[0]
        qweights = np.broadcast_to(qw[None, :] * np.abs(detJ1), (c, q))
        grad_phys = np.broadcast_to(grad1, (c,) + grad1.shape[1:])
        geom = geometry_element(mesh.cell_type)
        gphi = geom.tabulate(qp)
        xq1 = np.einsum("qv,vg->qg", gphi, mesh.nodes[mesh.cells[0]])
        org0 = mesh.nodes[mesh.cells[0, 0]]
        xq = (mesh.nodes[mesh.cells[:, 0]][:, None, :]
              + (xq1 - org0)[None])
        return CellGeometry(qpoints_ref=qp, qweights=qweights, phi=phi,
                            grad_phys=grad_phys, qpoints_phys=xq)
    cells = np.arange(mesh.n_cells)
    J, detJ, invJ = _jacobians(mesh, qp, cells)
    # physical gradient: grad_x phi[g] = sum_t invJ[t, g] * dphi[t]
    # (invJ from np.linalg.inv(J) has layout [t, g] = d xi_t / d x_g)
    grad_phys = np.einsum("cqtg,qlt->cqlg", invJ, dphi)
    geom = geometry_element(mesh.cell_type)
    gphi = geom.tabulate(qp)
    xq = np.einsum("qv,cvg->cqg", gphi, mesh.nodes[mesh.cells])
    return CellGeometry(
        qpoints_ref=qp,
        qweights=qw[None, :] * np.abs(detJ),
        phi=phi,
        grad_phys=grad_phys,
        qpoints_phys=xq,
    )


def cell_volumes(mesh: Mesh) -> np.ndarray:
    """Physical cell measures (∫_K 1 dx), quadrature-exact for every
    supported cell type; one congruent cell evaluated on uniform boxes."""
    qp, qw = cell_quadrature(mesh.cell_type, 2)
    if mesh.structured is not None:
        _, detJ1, _ = _jacobians(mesh, qp, np.arange(1))
        v1 = float((qw * np.abs(detJ1[0])).sum())
        return np.full(mesh.n_cells, v1)
    _, detJ, _ = _jacobians(mesh, qp, np.arange(mesh.n_cells))
    return (qw[None, :] * np.abs(detJ)).sum(axis=1)


def _facet_side_tables(mesh: Mesh, fs: FunctionSpace, cells: np.ndarray,
                       xi_cell: np.ndarray, with_grad: bool = True):
    """Tabulate basis values/physical gradients of `fs` at per-facet cell
    reference points xi_cell (f, q, t). Returns phi (f,q,l), grad (f,q,l,g)
    (None without `with_grad`), J-related per-point quantities. Tabulation
    is ONE merged call over all f*q points (a per-facet Python loop costs
    minutes at 100k+ facets)."""
    f, q, t = xi_cell.shape
    pts = xi_cell.reshape(f * q, t)
    phi = fs.element.tabulate(pts).reshape(f, q, -1)
    geom = geometry_element(mesh.cell_type)
    xc = mesh.nodes[mesh.cells[cells]]
    gdt = geom.tabulate_grad(pts).reshape(f, q, -1, t)      # (f, q, v, t)
    Jl = np.einsum("fvg,fqvt->fqgt", xc, gdt)               # (f, q, g, t)
    if mesh.tdim == 1:
        invJ = (1.0 / Jl[..., 0, 0])[..., None, None]
        detJ = Jl[..., 0, 0]
    else:
        invJ = np.linalg.inv(Jl)
        detJ = np.linalg.det(Jl)
    if not with_grad:
        return phi, None, Jl, detJ, invJ
    dphi = fs.element.tabulate_grad(pts).reshape(f, q, phi.shape[-1], t)
    grad_phys = np.einsum("fqtg,fqlt->fqlg", invJ, dphi)
    return phi, grad_phys, Jl, detJ, invJ


def _facet_measure_and_normal(mesh: Mesh, local_facets: np.ndarray,
                              Jl: np.ndarray, detJ: np.ndarray, invJ: np.ndarray,
                              fq_weights: np.ndarray):
    """Physical facet quadrature weights and outward unit normals.

    Weights via the embedded-facet metric: M = J @ G with G the (constant,
    affine) facet-embedding Jacobian; w_phys = w_ref * sqrt(det(M^T M)).
    Normals via Nanson: n ∝ J^{-T} N_ref (outward for det(J) > 0 maps).
    """
    rc = mesh.ref_cell
    N_ref = _reference_outward_normals(mesh)     # (n_local_facets, t)
    f, q = Jl.shape[:2]
    if mesh.tdim == 1:
        w = np.broadcast_to(fq_weights[None, :], (f, q)).copy()
        n_dir = N_ref[local_facets][:, None, :]  # (f, 1, t)
        n = np.sign(Jl[..., 0, 0])[..., None] * np.broadcast_to(n_dir, (f, q, 1))
        return w, n
    # facet embedding Jacobians G per local facet (t, t-1)
    Gs = []
    for lf in range(rc.n_facets):
        fv = rc.facet_vertex_coords(lf).astype(np.float64)
        # affine embedding: xi(s) = v0 + sum_k s_k (v_{k+1} - v0); exact for
        # all our facet types (quad faces have v3 = v1 + v2 - v0)
        G = np.stack([fv[k + 1] - fv[0] for k in range(mesh.tdim - 1)], axis=1)
        Gs.append(G)
    Gs = np.asarray(Gs)                           # (nlf, t, t-1)
    G = Gs[local_facets]                          # (f, t, t-1)
    M = np.einsum("fqgt,fts->fqgs", Jl, G)        # (f, q, g, t-1)
    MtM = np.einsum("fqgs,fqgr->fqsr", M, M)
    area = np.sqrt(np.abs(np.linalg.det(MtM)))    # (f, q)
    w = fq_weights[None, :] * area
    nr = N_ref[local_facets]                      # (f, t)
    # Nanson: n[g] ∝ sum_t invJ[t, g] * N_ref[t]  (J^{-T} applied)
    n = np.einsum("fqtg,ft->fqg", invJ, nr)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return w, n


def build_boundary_geometry(mesh: Mesh, fs: FunctionSpace,
                            quad_degree: int | None = None,
                            with_grad: bool = True) -> FacetGeometry:
    """The boundary facets' quadrature tables; `with_grad=False` leaves out
    the basis gradients (grad_phys None), which the heat operators do not
    read: at degree 2 they are most of the build's time."""
    qd = quad_degree if quad_degree is not None else 2 * fs.degree + 1
    fq, fw = facet_quadrature(mesh.cell_type, qd)
    rc = mesh.ref_cell
    cells = mesh.boundary_cell
    lfs = mesh.boundary_local_facet
    # cell-reference coords of facet quad points: per LOCAL facet, indexed
    xi_all = np.stack([rc.map_facet_points(lf, fq)
                       for lf in range(rc.n_facets)])
    xi = xi_all[lfs]                                        # (f, q, t)
    phi, grad_phys, Jl, detJ, invJ = _facet_side_tables(mesh, fs, cells, xi,
                                                        with_grad)
    w, n = _facet_measure_and_normal(mesh, lfs, Jl, detJ, invJ, fw)
    geom = geometry_element(mesh.cell_type)
    xc = mesh.nodes[mesh.cells[cells]]
    if len(cells):
        gv = geom.tabulate(xi.reshape(-1, xi.shape[-1]))
        gv = gv.reshape(len(cells), len(fw), -1)            # (f, q, v)
        xq = np.einsum("fqv,fvg->fqg", gv, xc)
    else:
        xq = np.zeros((0, len(fw), mesh.gdim))
    return FacetGeometry(
        cell=cells, qweights=w, phi=phi, grad_phys=grad_phys, normal=n,
        qpoints_phys=xq,
    )


def build_interior_geometry(mesh: Mesh, fs: FunctionSpace,
                            quad_degree: int | None = None) -> InteriorFacetGeometry:
    qd = quad_degree if quad_degree is not None else 2 * fs.degree + 1
    fq, fw = facet_quadrature(mesh.cell_type, qd)
    rc = mesh.ref_cell
    cp, lp = mesh.interior_cell_p, mesh.interior_local_facet_p
    cm, lm = mesh.interior_cell_m, mesh.interior_local_facet_m
    nf = len(cp)
    if nf == 0:
        z = np.zeros
        q = len(fw)
        l = fs.element.nloc
        g = mesh.gdim
        return InteriorFacetGeometry(
            cell_p=cp, cell_m=cm, qweights=z((0, q)),
            phi_p=z((0, q, l)), phi_m=z((0, q, l)),
            grad_p=z((0, q, l, g)), grad_m=z((0, q, l, g)),
            normal_p=z((0, q, g)), h_p=z((0,)),
            qpoints_phys=z((0, q, g)),
        )
    # uniform-box fast path: every interior facet with the same
    # (local_facet_p, local_facet_m) pair is congruent (translation
    # images of each other), so the geometric tables are computed for ONE
    # representative facet per pair and broadcast — the per-facet merged
    # tabulation below costs ~38 s at 64x64x16 (190k facets x 4 qpoints,
    # measured; it dominated DG setup twice over for the f64/f32 twins)
    sel = None
    if mesh.structured is not None:
        pairs = lp.astype(np.int64) * rc.n_facets + lm.astype(np.int64)
        uniq, inv = np.unique(pairs, return_inverse=True)
        inv = np.asarray(inv).reshape(-1)
        reps = np.array([int(np.argmax(pairs == u)) for u in uniq])
        sel = (reps, inv)
        cp_t, lp_t, cm_t, lm_t = cp[reps], lp[reps], cm[reps], lm[reps]
    else:
        cp_t, lp_t, cm_t, lm_t = cp, lp, cm, lm
    # '+' side: map facet points into + cell reference coords
    xi_all = np.stack([rc.map_facet_points(lf, fq)
                       for lf in range(rc.n_facets)])
    xi_p = xi_all[lp_t]
    phi_p, grad_p, Jp, detJp, invJp = _facet_side_tables(mesh, fs, cp_t, xi_p)
    w, n_p = _facet_measure_and_normal(mesh, lp_t, Jp, detJp, invJp, fw)
    # physical points from + side, pulled back into '-' cells so both sides
    # quadrate the same physical points in the same order
    geom = geometry_element(mesh.cell_type)
    xcp = mesh.nodes[mesh.cells[cp_t]]
    gv = geom.tabulate(xi_p.reshape(-1, xi_p.shape[-1]))
    gv = gv.reshape(len(cp_t), len(fw), -1)
    xq = np.einsum("fqv,fvg->fqg", gv, xcp)
    xi_m = _invert_geometry_map(mesh, cm_t, xq)
    phi_m, grad_m, _, _, _ = _facet_side_tables(mesh, fs, cm_t, xi_m)
    if sel is not None:
        _, inv = sel
        w, phi_p, phi_m = w[inv], phi_p[inv], phi_m[inv]
        grad_p, grad_m, n_p = grad_p[inv], grad_m[inv], n_p[inv]
    # SIPG penalty length h: the '+' cell's measure divided by the facet
    # measure — the cell's extent NORMAL to the facet. An anisotropy-robust
    # replacement for CellDiameter (the reference's 1D form,
    # ThermoViscoProblem.py:313-314, where both coincide: vol/area =
    # element length / 1 = diameter, so 1D parity and the oracle anchors
    # are bit-identical). On anisotropic 3D plate cells CellDiameter
    # under-penalizes the thin-direction facets by diam/h_n (~35x at
    # 64x64x16, aspect 25:1) and the SIPG operator goes INDEFINITE
    # (measured: the z-column block-tridiagonal principal submatrices
    # have lambda_min = -1.7e-2 with lambda_max = 2.0e-2, hence
    # rho(Z^-1 A) = 295 for the column smoother, a divergent V-cycle
    # [rho(E) = 5.7] and 600+ CG iterations; with h = vol/area the same
    # setup measures lambda_min = +2.1e-5, rho(E) = 0.185, and 8 CG
    # iterations to 1e-10).
    area_f = w.sum(axis=1)
    h_p = cell_volumes(mesh)[cp] / np.maximum(area_f, 1e-300)
    # physical facet quadrature points for ALL facets (the sel fast path
    # above broadcasts only the translation-invariant tables; coordinates
    # are per-facet). gv depends on the local facet index only.
    gv_lf = np.stack([
        geom.tabulate(xi_all[lf].reshape(-1, xi_all.shape[-1]))
        for lf in range(rc.n_facets)
    ])                                                # (n_lf, q, nverts)
    xq_full = np.einsum("fqv,fvg->fqg", gv_lf[lp],
                        mesh.nodes[mesh.cells[cp]])
    return InteriorFacetGeometry(
        cell_p=cp, cell_m=cm, qweights=w,
        phi_p=phi_p, phi_m=phi_m, grad_p=grad_p, grad_m=grad_m,
        normal_p=n_p, h_p=h_p, qpoints_phys=xq_full,
    )
