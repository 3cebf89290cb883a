"""Thermal parameter model: form selection + derived quantities.

Replaces the reference's ThermalModel (ThermalModel.py:6-29), which wraps
the heat-equation parameters as mesh-bound dolfinx Constants — and then
never uses rho/cp/k in the weak form (SURVEY.md §Quirks 6: the mass term
carries no rho*cp and diffusion uses the bare `alpha`). Here the class
owns that decision explicitly: `coefficients()` returns the (mass,
diffusion) coefficients for either form, so the operators support both

  - 'reference':  (T - T_prev) v dx + dt alpha grad T . grad v dx - ...
                  (exact parity with ThermoViscoProblem.py:293-306)
  - 'physical':   rho cp (T - T_prev) v dx + dt k grad T . grad v dx - ...
                  (the dimensional equation the reference's parameters
                  imply but never assemble)

plus the derived quantities users need when choosing time steps on
dimensional problems.
"""

from __future__ import annotations

from dataclasses import dataclass

from fem_glass_tempering_tpu_torch.config import ModelParams

FORMS = ("reference", "physical")


@dataclass(frozen=True)
class ThermalModel:
    f: float
    epsilon: float
    sigma: float
    alpha: float
    htc: float
    rho: float
    cp: float
    k: float
    T_ambient: float

    @staticmethod
    def from_params(p: ModelParams) -> "ThermalModel":
        return ThermalModel(
            f=p.f, epsilon=p.epsilon, sigma=p.sigma, alpha=p.alpha,
            htc=p.htc, rho=p.rho, cp=p.cp, k=p.k, T_ambient=p.T_ambient,
        )

    def validate(self) -> None:
        for name in ("rho", "cp", "k", "alpha"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if not 0.0 <= self.epsilon <= 1.0:
            raise ValueError("emissivity epsilon must be in [0, 1]")

    # ---- weak-form coefficients ---------------------------------------
    def coefficients(self, form: str = "reference") -> tuple[float, float]:
        """(mass coefficient, diffusion coefficient) of the selected heat
        form. 'reference' reproduces the reference's non-dimensionalized
        equation exactly (mass 1, diffusion alpha); 'physical' assembles
        the dimensional rho*cp / k equation."""
        if form not in FORMS:
            raise ValueError(f"heat form must be one of {FORMS}")
        if form == "reference":
            return 1.0, self.alpha
        self.validate()
        return self.rho * self.cp, self.k

    # ---- derived quantities -------------------------------------------
    def diffusivity(self) -> float:
        """Thermal diffusivity k / (rho cp) [m^2/s]."""
        return self.k / (self.rho * self.cp)

    def diffusion_time(self, length: float) -> float:
        """Characteristic conduction time L^2 / diffusivity [s]."""
        return length * length / self.diffusivity()

    def biot(self, length: float) -> float:
        """Biot number htc L / k — lumped-capacitance validity check."""
        return self.htc * length / self.k

    def radiation_htc(self, T: float) -> float:
        """Linearized radiative transfer coefficient at temperature T:
        4 eps sigma_SB T^3 [W/m^2 K], comparable against htc."""
        return 4.0 * self.epsilon * self.sigma * T**3
