"""Polynomial time-scaling profiles (cubic / quintic / linear).

Counterpart of ``manipulapy_tpu/core/time_scaling.py``: (s, s_dot, s_ddot)
as functions of the normalized time ``tau = t / Tf``, with derivatives in
real time. Degenerate inputs (``N <= 1`` or ``Tf <= 0``) collapse to "sit
at start" with zero rates.
"""

from __future__ import annotations

import torch

__all__ = ["time_scaling", "scaling_profile", "CUBIC", "QUINTIC", "LINEAR"]

CUBIC = 3
QUINTIC = 5
LINEAR = 1


def time_scaling(tau: torch.Tensor, Tf, method: int):
    """Evaluate (s, s_dot, s_ddot) at normalized times ``tau`` in [0, 1].

    ``method`` is a Python int (3, 5, or anything else for linear).
    """
    Tf = torch.as_tensor(Tf, dtype=tau.dtype, device=tau.device)
    Tf_safe = torch.where(Tf > 0, Tf, torch.ones_like(Tf))
    if method == CUBIC:
        s = 3.0 * tau**2 - 2.0 * tau**3
        s_dot = 6.0 * tau * (1.0 - tau) / Tf_safe
        s_ddot = 6.0 * (1.0 - 2.0 * tau) / (Tf_safe * Tf_safe)
    elif method == QUINTIC:
        tau2 = tau * tau
        tau3 = tau2 * tau
        tau4 = tau2 * tau2
        s = 10.0 * tau3 - 15.0 * tau4 + 6.0 * tau4 * tau
        s_dot = (30.0 * tau2 - 60.0 * tau3 + 30.0 * tau4) / Tf_safe
        s_ddot = (60.0 * tau - 180.0 * tau2 + 120.0 * tau3) / (Tf_safe * Tf_safe)
    else:
        s = tau
        s_dot = torch.ones_like(tau) / Tf_safe
        s_ddot = torch.zeros_like(tau)
    ok = Tf > 0
    zero = torch.zeros_like(tau)
    return (
        torch.where(ok, s, zero),
        torch.where(ok, s_dot, zero),
        torch.where(ok, s_ddot, zero),
    )


def scaling_profile(Tf, N: int, method: int, dtype=torch.float32, device=None):
    """(s, s_dot, s_ddot) sampled at ``N`` uniform points over [0, Tf];
    ``tau_t = t / (N - 1)``, and ``N <= 1`` collapses to zeros."""
    if N <= 1:
        zero = torch.zeros((max(N, 0),), dtype=dtype, device=device)
        return zero, zero, zero
    tau = torch.linspace(0.0, 1.0, N, dtype=dtype, device=device)
    return time_scaling(tau, Tf, method)
