"""Tool-Narayanaswamy / Prony-series viscoelastic tempering engine.

Counterpart of fem_glass_tempering_tpu/models/viscoelastic.py (the
reference's per-step cascade, ViscoelasticModel.py:86-230 and
ThermoViscoProblem.py:455-595): T-space quantities (shift function,
fictive temperatures, scaled time) on (n_T,) tensors, strain/stress
quantities on (n_S, dim, dim) tensors at the sigma-space points, with the
6-term Prony tableau as a broadcast axis.

Update chain per step (Nielsen et al. eq. numbers as cited by the reference):
  phi      = exp(H/Rg (1/Tb - 1/T))                                 [eq. 5]
  Tf_p[n]  = (lam_m[n] Tf_p_prev[n] + T dt phi) / (lam_m[n] + dt phi) [eq. 24]
  Tf       = sum_n m[n] Tf_p[n]                                     [eq. 26]
  eps_th   = I (a_s dT + (a_l - a_s) dTf)                           [eq. 9]
  eps_tot  = -eps_th                                                [eq. 28]
  eps_dev  = eps_tot - (1/dim) I tr(eps_tot)                        [eq. 29]
  T_next   = 2 T - T_prev (linear predictor)
  xi       = dt/2 (phi(T_next) - phi(T))                            [eq. 19 as coded]
  ds[n]    = 2 g[n] eps_dev (1 - xi/(2 lam_g[n]))                   [eq. 15a+20]
  dsig[n]  = k[n] tr(eps_tot) I (1 - xi/(2 lam_k[n]))               [eq. 15b+20]
  s~[n]'   = decay_src[n] * texp(xi/lam_g[n])                       [eq. 16a]
  s[n]'    = ds[n] + s~[n]'                                         [eq. 17a]
  sigma    = sum_n (s[n]' + sig[n]')                                [eq. 18]

The T-space chain for eq. 5 with the reference xi is the hand-written CUDA
kernel of ops/cuda_kernels.py on the GPU (its plain twin on the CPU); the
eq. 25 and trapezoid variants compute other functions and stay plain
PyTorch, as does the sigma-space chain.

physics_mode 'reference' reproduces the reference's runtime semantics
(the dTf term vanishes because Tf_prev is rotated before the thermal
strain evaluates, and the decayed stresses start at 0 and stay 0);
'corrected' uses the literature semantics. See the JAX module's docstring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.device import resolve_device
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.cuda_kernels import material_tspace
from fem_glass_tempering_tpu_torch.ops.interpolation import build_cross_eval

# 6-term Prony tableaus for float glass (Nielsen et al., as carried by the
# reference ViscoelasticModel.py:19-68)
TABLEAU_SIZE = 6
M_N = np.array([5.523e-2, 8.205e-2, 1.215e-1, 2.286e-1, 2.860e-1, 2.265e-1])
LAMBDA_M_N = np.array([5.965e-4, 1.077e-2, 1.362e-1, 1.505e-1, 6.747e0, 2.963e1])
G_N = np.array([1.585, 2.354, 3.486, 6.558, 8.205, 6.498])
LAMBDA_G_N = np.array([6.658e-5, 1.197e-3, 1.514e-2, 1.672e-1, 7.497e-1, 3.292e0])
K_N = np.array([7.588e-1, 7.650e-1, 9.806e-1, 7.301e0, 1.347e1, 1.090e1])
LAMBDA_K_N = np.array([5.009e-5, 9.945e-4, 2.022e-3, 1.925e-2, 1.199e-1, 2.033e0])


@dataclass(frozen=True)
class PronyTableaus:
    m_n: np.ndarray
    lambda_m_n: np.ndarray
    g_n: np.ndarray
    lambda_g_n: np.ndarray
    k_n: np.ndarray
    lambda_k_n: np.ndarray

    @staticmethod
    def nielsen() -> "PronyTableaus":
        return PronyTableaus(M_N, LAMBDA_M_N, G_N, LAMBDA_G_N, K_N, LAMBDA_K_N)


class ViscoState(NamedTuple):
    """Full per-step field state. Shapes: (n_T,) scalars on the T space;
    (n_S, d, d) tensors at the sigma-space points; the tableau axis leads
    the tensor axes where present. The step never updates a state's
    tensors in place: each step returns a new state."""

    t: torch.Tensor                 # () current time
    T: torch.Tensor                 # (n_T,) current temperature
    T_prev: torch.Tensor            # (n_T,)
    Tf: torch.Tensor                # (n_T,) fictive temperature
    Tf_prev: torch.Tensor           # (n_T,)
    Tf_partial: torch.Tensor        # (n_T, 6)
    phi: torch.Tensor               # (n_T,) shift function
    xi: torch.Tensor                # (n_T,) scaled-time increment
    thermal_strain: torch.Tensor    # (n_S, d, d)
    total_strain: torch.Tensor      # (n_S, d, d)
    deviatoric_strain: torch.Tensor # (n_S, d, d)
    s_tilde: torch.Tensor           # (n_S, 6, d, d) decayed deviatoric partials
    sigma_tilde: torch.Tensor       # (n_S, 6, d, d) decayed hydrostatic partials
    s_partial: torch.Tensor         # (n_S, 6, d, d) total deviatoric partials
    sigma_partial: torch.Tensor     # (n_S, 6, d, d) total hydrostatic partials
    sigma: torch.Tensor             # (n_S, d, d) total stress
    # (n_S, d) displacement of the last equilibrium-mechanics solve
    du: torch.Tensor | None = None


class ViscoelasticEngine:
    """Builds the material step for a (T-space, sigma-space) pair."""

    def __init__(self, fs_T: FunctionSpace, fs_sigma: FunctionSpace,
                 params: ModelParams, dt: float, *,
                 tableaus: PronyTableaus | None = None,
                 physics_mode: str = "reference",
                 shift_function: str = "eq5",
                 xi_formula: str = "reference",
                 use_pallas: bool | str = "auto",
                 dtype=torch.float64, device=None):
        if physics_mode not in ("reference", "corrected"):
            raise ValueError(physics_mode)
        if shift_function not in ("eq5", "eq25"):
            raise ValueError(shift_function)
        if xi_formula not in ("reference", "trapezoid"):
            raise ValueError(xi_formula)
        # kept for parity with the JAX engine: the fused kernel is the CUDA
        # path of the eq5 + reference-xi chain whatever this says
        self.use_pallas = use_pallas
        self.xi_formula = xi_formula
        self.fs_T = fs_T
        self.fs_sigma = fs_sigma
        self.params = params
        self.dt = float(dt)
        self.mode = physics_mode
        self.shift_function = shift_function
        self.dtype = dtype
        self.device = resolve_device(device)
        self.dim = fs_T.mesh.tdim
        tb = tableaus or PronyTableaus.nielsen()
        self.tableaus = tb
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=self.device)
        self.m_n = f(tb.m_n)
        self.lambda_m_n = f(tb.lambda_m_n)
        self.g_n = f(tb.g_n)
        self.lambda_g_n = f(tb.lambda_g_n)
        self.k_n = f(tb.k_n)
        self.lambda_k_n = f(tb.lambda_k_n)
        self.to_sigma = build_cross_eval(fs_sigma, {"T": fs_T},
                                         device=self.device)
        self.I = f(np.eye(self.dim))

    # ------------------------------------------------------------------
    def init_state(self) -> ViscoState:
        """Initial conditions (reference ThermoViscoProblem.py:187-233):
        T = Tf = Tf_partial[n] = T_0 everywhere; all stresses zero."""
        p = self.params
        nT = self.fs_T.n_scalar_dofs
        nS = self.fs_sigma.n_scalar_dofs
        d = self.dim
        f = lambda shape, v=0.0: torch.full(shape, v, dtype=self.dtype,
                                            device=self.device)
        return ViscoState(
            t=f((), 0.0),
            T=f((nT,), p.T_0),
            T_prev=f((nT,), p.T_0),
            Tf=f((nT,), p.T_0),
            Tf_prev=f((nT,), p.T_0),
            Tf_partial=f((nT, TABLEAU_SIZE), p.T_0),
            phi=f((nT,)),
            xi=f((nT,)),
            thermal_strain=f((nS, d, d)),
            total_strain=f((nS, d, d)),
            deviatoric_strain=f((nS, d, d)),
            s_tilde=f((nS, TABLEAU_SIZE, d, d)),
            sigma_tilde=f((nS, TABLEAU_SIZE, d, d)),
            s_partial=f((nS, TABLEAU_SIZE, d, d)),
            sigma_partial=f((nS, TABLEAU_SIZE, d, d)),
            sigma=f((nS, d, d)),
            du=f((nS, d)),
        )

    # ------------------------------------------------------------------
    def _phi_of(self, T, Tf_prev):
        p = self.params
        if self.shift_function == "eq5":
            return torch.exp(p.H / p.Rg * (1.0 / p.Tb - 1.0 / T))
        # eq. 25: chi-weighted TN shift (ViscoelasticModel.py:100-108)
        return torch.exp(p.H / p.Rg * (
            1.0 / p.Tb - p.chi / T - (1.0 - p.chi) / Tf_prev
        ))

    @staticmethod
    def _taylor_exp(y):
        """3-term Taylor of exp(-y) (Nielsen eq. 20)."""
        return 1.0 - y + 0.5 * y * y

    def _decay(self, y):
        """Stress decay factor e^{-y}: Taylor in reference-xi mode, exact
        exponential in trapezoid mode."""
        if self.xi_formula == "reference":
            return self._taylor_exp(y)
        return torch.exp(-y)

    def _relax_factor(self, y):
        """(lambda/xi)(1 - e^{-xi/lambda}), the eq. 15 increment factor:
        Taylor-consistent 1 - y/2 in reference-xi mode, the exact
        singularity-free form in trapezoid mode."""
        if self.xi_formula == "reference":
            return 1.0 - 0.5 * y
        small = torch.abs(y) < 1e-8
        safe = torch.where(small, torch.ones_like(y), y)
        return torch.where(small, 1.0 - 0.5 * y,
                           (1.0 - torch.exp(-safe)) / safe)

    def material_step(self, state: ViscoState, T_new: torch.Tensor,
                      dt=None, mech=None) -> ViscoState:
        return self.material_step_with(state, T_new, self.to_sigma.eval, dt,
                                       mech=mech)

    def material_step_with(self, state: ViscoState, T_new: torch.Tensor,
                           ev, dt=None, mech=None) -> ViscoState:
        """Advance all material fields given the freshly solved temperature.
        `ev(name, dof_array)` evaluates a T-space field at the sigma-space
        points. `mech(state, xi, scalar_th)` returns `(eps(du), du)` at the
        sigma points; None reproduces the reference's no-equilibrium
        semantics (total strain = -thermal strain)."""
        p = self.params
        dt = self.dt if dt is None else dt
        ref = self.mode == "reference"

        # ---- T-space pointwise chain ----
        if self.shift_function == "eq5" and self.xi_formula == "reference":
            tb = self.tableaus
            phi, Tf_partial, Tf, xi = material_tspace(
                T_new, state.T_prev, state.Tf_partial, dt=dt,
                H_over_Rg=p.H / p.Rg, Tb=p.Tb, m_n=tb.m_n,
                lambda_m_n=tb.lambda_m_n)
        else:
            phi = self._phi_of(T_new, state.Tf)       # shift function
            Tf_partial = (
                self.lambda_m_n * state.Tf_partial
                + (T_new * dt * phi)[..., None]
            ) / (self.lambda_m_n + (dt * phi)[..., None])             # eq. 24
            Tf = Tf_partial @ self.m_n                                 # eq. 26
            T_next = 2.0 * T_new - state.T_prev       # linear predictor
            phi_next = self._phi_of(T_next, Tf)
            if self.xi_formula == "reference":
                xi = 0.5 * dt * (phi_next - phi)                       # eq. 19 as coded
            else:
                xi = 0.5 * dt * (phi_next + phi)      # physical trapezoid

        # ---- evaluate T-space quantities at sigma-space points ----
        T_s = ev("T", T_new)
        T_prev_s = ev("T", state.T_prev)
        xi_s = ev("T", xi)
        if ref:
            # Tf_prev was already overwritten with Tf when the thermal
            # strain evaluates -> the dTf term vanishes identically
            dTf_s = torch.zeros_like(T_s)
        else:
            dTf_s = ev("T", Tf - state.Tf)

        # ---- strain chain (sigma-space points) ----
        dT_s = T_s - T_prev_s
        scalar_th = p.alpha_solid * dT_s + (p.alpha_liquid - p.alpha_solid) * dTf_s
        thermal_strain = scalar_th[..., None, None] * self.I           # eq. 9
        du_new = state.du
        if mech is None:
            total_strain = -thermal_strain                             # eq. 28
        else:
            dTf_T = torch.zeros_like(T_new) if ref else Tf - state.Tf
            scalar_th_T = (p.alpha_solid * (T_new - state.T_prev)
                           + (p.alpha_liquid - p.alpha_solid) * dTf_T)
            eps_mech, du_new = mech(state, xi, scalar_th_T)
            total_strain = eps_mech - thermal_strain
        tr_tot = torch.diagonal(total_strain, dim1=-2, dim2=-1).sum(-1)
        deviatoric_strain = total_strain - (
            tr_tot[..., None, None] / self.dim
        ) * self.I                                                     # eq. 29

        # ---- Prony stress updates (tableau axis n broadcast) ----
        y_g = xi_s[..., None] / self.lambda_g_n                       # (..., 6)
        y_k = xi_s[..., None] / self.lambda_k_n
        texp_g = self._decay(y_g)[..., None, None]
        texp_k = self._decay(y_k)[..., None, None]
        ds = (2.0 * self.g_n[:, None, None]
              * deviatoric_strain[..., None, :, :]
              * self._relax_factor(y_g)[..., None, None])             # eq. 15a+20
        dsig = (self.k_n[:, None, None]
                * (tr_tot[..., None, None] * self.I)[..., None, :, :]
                * self._relax_factor(y_k)[..., None, None])           # eq. 15b+20
        # eq. 16a/b: reference mode decays s_tilde (which stays 0);
        # corrected mode decays the accumulated partial stress
        s_decay_src = state.s_tilde if ref else state.s_partial
        sig_decay_src = state.sigma_tilde if ref else state.sigma_partial
        s_tilde = s_decay_src * texp_g
        sigma_tilde = sig_decay_src * texp_k
        s_partial = ds + s_tilde                                       # eq. 17a
        sigma_partial = dsig + sigma_tilde                             # eq. 17b
        sigma = torch.sum(s_partial + sigma_partial, dim=-3)          # eq. 18

        return ViscoState(
            t=state.t + dt,
            T=T_new,
            T_prev=T_new,      # rotated at end of step (ThermoViscoProblem.py:378-379)
            Tf=Tf,
            Tf_prev=Tf,
            Tf_partial=Tf_partial,
            phi=phi,
            xi=xi,
            thermal_strain=thermal_strain,
            total_strain=total_strain,
            deviatoric_strain=deviatoric_strain,
            s_tilde=s_tilde,
            sigma_tilde=sigma_tilde,
            s_partial=s_partial,
            sigma_partial=sigma_partial,
            sigma=sigma,
            du=du_new,
        )
