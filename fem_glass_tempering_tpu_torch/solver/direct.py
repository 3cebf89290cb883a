"""Dense direct linear solve for small and validation problems.

Counterpart of fem_glass_tempering_tpu/solver/direct.py, the stand-in for
the reference's latent MUMPS setting: the Jacobian is materialised column
by column through forward-mode derivatives (fine for the 1D validation
meshes) and each Newton step solved by LU (`torch.linalg.solve`). It
cross-checks the matrix-free Newton-CG path and serves stiff problems
whose Krylov counts explode.
"""

from __future__ import annotations

from typing import Callable

import torch


def materialize_jacobian(residual_fn: Callable,
                         x: torch.Tensor) -> torch.Tensor:
    """Dense (n, n) Jacobian of residual_fn at x: `torch.func.vmap` over
    the `torch.func.jvp` columns."""
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return torch.func.vmap(
        lambda v: torch.func.jvp(residual_fn, (x,), (v,))[1])(eye).T


def newton_direct(residual_fn: Callable, x0: torch.Tensor, *,
                  rtol: float = 1e-12, atol: float = 1e-10,
                  max_it: int = 50):
    """Newton with a dense LU inner solve, stopping when ||dx|| <= rtol
    ||x_new|| + atol. Returns (x, iters, converged)."""
    x = x0
    k = 0
    converged = False
    while not converged and k < max_it:
        F = residual_fn(x)
        J = materialize_jacobian(residual_fn, x)
        dx = torch.linalg.solve(J, -F)
        x = x + dx
        k += 1
        converged = bool(torch.linalg.norm(dx)
                         <= rtol * torch.linalg.norm(x) + atol)
    return x, k, converged
