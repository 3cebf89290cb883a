"""Post-processing: tempering-specific residual stress analysis.

Counterpart of fem_glass_tempering_tpu/models/analysis.py. The reference
writes raw fields and stops; the quantities glass engineers read off a
tempering run (surface compression, mid-plane tension, through-thickness
profiles) are computed here, on the host in numpy. Fields may be numpy
arrays or tensors on any device.

Conventions: sigma is the total stress tensor field on the sigma space
(ViscoState.sigma); negative normal stress = compression.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.io.vtu import host_array
from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry


@dataclass
class TemperProfile:
    coordinate: np.ndarray        # (n,) sorted positions along the axis
    stress: np.ndarray            # (n,) in-plane stress component
    temperature: np.ndarray | None
    surface_stress: float         # stress at the two surfaces (averaged)
    midplane_stress: float
    membrane_stress: float        # thickness-averaged (should be ~0 in
                                  # equilibrium; nonzero here because the
                                  # reference model solves no equilibrium PDE)


def through_thickness_profile(fs_sigma: FunctionSpace, sigma, *, axis: int = 0,
                              component: tuple[int, int] | None = None,
                              T_fs: FunctionSpace | None = None,
                              T=None) -> TemperProfile:
    """Extract the stress profile along `axis` (the thickness direction).

    component defaults to the first in-plane direction (i, i) with i != axis
    for dim > 1, or (0, 0) in 1D. Dofs are averaged over duplicate
    coordinates (DG) and sorted.
    """
    sigma = host_array(sigma)
    x = fs_sigma.dof_coords[:, axis]
    dim = sigma.shape[-1]
    if component is None:
        i = 0 if dim == 1 else (1 if axis == 0 else 0)
        component = (i, i)
    s = sigma[:, component[0], component[1]]
    # average duplicates on identical coordinates
    xr = np.round(x, 12)
    uniq, inv = np.unique(xr, return_inverse=True)
    acc = np.zeros(len(uniq))
    cnt = np.zeros(len(uniq))
    np.add.at(acc, inv, s)
    np.add.at(cnt, inv, 1.0)
    prof = acc / cnt

    temp = None
    if T is not None and T_fs is not None:
        xt = np.round(np.asarray(T_fs.dof_coords[:, axis]), 12)
        tu, ti = np.unique(xt, return_inverse=True)
        ta = np.zeros(len(tu))
        tc = np.zeros(len(tu))
        np.add.at(ta, ti, host_array(T))
        np.add.at(tc, ti, 1.0)
        temp = np.interp(uniq, tu, ta / tc)

    surface = 0.5 * (prof[0] + prof[-1])
    mid = prof[len(prof) // 2]
    thickness = uniq[-1] - uniq[0]
    membrane = float(np.trapezoid(prof, uniq) / thickness) if thickness > 0 else float(prof.mean())
    return TemperProfile(
        coordinate=uniq, stress=prof, temperature=temp,
        surface_stress=float(surface), midplane_stress=float(mid),
        membrane_stress=membrane,
    )


def temper_metrics(profile: TemperProfile) -> dict:
    """Summary metrics: surface compression (+ compressive magnitude),
    center tension, compression-depth fraction, balance residual."""
    s = profile.stress
    x = profile.coordinate
    surf_comp = -profile.surface_stress        # >0 when surface compressive
    center_ten = profile.midplane_stress
    in_comp = s < 0
    frac_comp = float(in_comp.mean())
    return {
        "surface_compression": float(surf_comp),
        "midplane_tension": float(center_ten),
        "compressive_fraction": frac_comp,
        "membrane_residual": profile.membrane_stress,
        "thickness": float(x[-1] - x[0]),
    }


def stress_l2_norm(fs_sigma: FunctionSpace, sigma) -> float:
    """Frobenius L2 norm of the stress field over the mesh (quadrature-
    weighted) — the parity metric of BASELINE.md."""
    cg = build_cell_geometry(fs_sigma.mesh, fs_sigma)
    vals = host_array(sigma)[fs_sigma.dofmap]          # (c, l, d, d)
    at_q = np.einsum("ql,clij->cqij", cg.phi, vals)
    frob2 = (at_q ** 2).sum(axis=(-1, -2))
    return float(np.sqrt(np.sum(cg.qweights * frob2)))
