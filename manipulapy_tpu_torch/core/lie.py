"""Batched, branchless SO(3)/SE(3) screw-theory primitives in PyTorch.

Counterpart of ``manipulapy_tpu/core/lie.py``. Every function batches over
leading dimensions and keeps the input dtype and device. The special cases
(prismatic vs revolute twists, theta ~ 0, theta ~ pi rotation logs) are
``torch.where`` selections with Taylor-series branches, as in the
reference.

Twist convention: ``[omega; v]`` (angular first). Transforms are 4x4
homogeneous matrices acting on column vectors.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "exp_twist",
    "adjoint",
    "ad_twist",
    "trans_inv",
    "trans_to_rp",
    "rp_to_trans",
]

# Small-angle threshold below which Taylor expansions replace the closed
# forms (the Taylor terms are O(theta^2) ~ 1e-8 at the crossover).
_EPS = 1e-4


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vector -> (..., 3, 3) skew-symmetric matrix ``[v]x``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric matrix -> (..., 3) vector."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sinc_coeffs_sq(t2: torch.Tensor):
    """Rodrigues coefficients ``A = sin(t)/t``, ``B = (1-cos(t))/t^2`` and
    ``C = (t-sin(t))/t^3`` as functions of ``t^2``; a polynomial in ``t2``
    below the small-angle threshold (no sqrt at the origin)."""
    small = t2 < _EPS * _EPS
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    a_closed = torch.sin(t) / t
    b_closed = (1.0 - torch.cos(t)) / t2_safe
    c_closed = (t - torch.sin(t)) / (t2_safe * t)
    a_taylor = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    b_taylor = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    c_taylor = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    return (
        torch.where(small, a_taylor, a_closed),
        torch.where(small, b_taylor, b_closed),
        torch.where(small, c_taylor, c_closed),
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): ``R = I + A [w]x + B [w]x^2``."""
    a, b, _ = _sinc_coeffs_sq(torch.sum(omega * omega, dim=-1))
    w_hat = skew(omega)
    return _eye3(omega) + a[..., None, None] * w_hat + b[..., None, None] * (w_hat @ w_hat)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3): the rotation vector with ``|omega| in [0, pi]``.

    Generic, theta ~ 0 (series in ``u = 1 - cos(theta)``) and theta ~ pi
    (axis from the dominant row of ``sym(R) + I``, sign from the
    antisymmetric part) branches, as in the reference.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    u = 1.0 - cos_theta
    small = u < (_EPS * _EPS)
    theta = torch.acos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))

    sin_theta = torch.sin(theta)
    safe_sin = torch.where(sin_theta.abs() < 1e-30, torch.ones_like(sin_theta), sin_theta)
    antisym = unskew(R - R.transpose(-1, -2))
    factor_closed = theta / (2.0 * safe_sin)
    factor_small = 0.5 + u / 6.0 + u * u / 15.0
    omega_generic = torch.where(small, factor_small, factor_closed)[..., None] * antisym

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    sym = 0.5 * (R + R.transpose(-1, -2)) + _eye3(R)
    index = k[..., None, None].expand(k.shape + (1, 3))
    axis_raw = torch.gather(sym, -2, index)[..., 0, :]
    axis_norm = torch.linalg.norm(axis_raw, dim=-1, keepdim=True)
    axis_norm = torch.where(axis_norm < 1e-12, torch.ones_like(axis_norm), axis_norm)
    axis = axis_raw / axis_norm
    sign = torch.sign(torch.sum(axis * antisym, dim=-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    omega_pi = sign * axis * theta[..., None]

    eps = torch.finfo(R.dtype).eps
    band = max(1e-3, 100.0 * math.sqrt(eps))
    near_pi = theta > (math.pi - band)
    return torch.where(near_pi[..., None], omega_pi, omega_generic)


def exp_twist(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``exp([S] theta)`` for a unit screw axis (``|omega|`` in {0, 1}).

    Args:
        S: (..., 6) screw axes ``[omega; v]``.
        theta: (...) joint displacements.

    Returns:
        (..., 4, 4) homogeneous transforms.
    """
    omega = S[..., :3]
    v = S[..., 3:]
    is_revolute = torch.linalg.norm(omega, dim=-1) > 0.5
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    sin_t = torch.sin(theta)[..., None, None]
    cos_t = torch.cos(theta)[..., None, None]
    eye3 = _eye3(S)
    R_rev = eye3 + sin_t * w_hat + (1.0 - cos_t) * w_hat2
    t = theta[..., None, None]
    G = eye3 * t + (1.0 - cos_t) * w_hat + (t - sin_t) * w_hat2
    p_rev = _matvec(G, v)
    R = torch.where(is_revolute[..., None, None], R_rev, eye3)
    p = torch.where(is_revolute[..., None], p_rev, v * theta[..., None])
    return rp_to_trans(R, p)


def se3_exp(V: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3) for an unnormalized twist ``V``."""
    omega = V[..., :3]
    v = V[..., 3:]
    a, b, c = _sinc_coeffs_sq(torch.sum(omega * omega, dim=-1))
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    eye3 = _eye3(V)
    R = eye3 + a[..., None, None] * w_hat + b[..., None, None] * w_hat2
    G = eye3 + b[..., None, None] * w_hat + c[..., None, None] * w_hat2
    return rp_to_trans(R, _matvec(G, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3), returning the twist ``[omega; v]``."""
    R, p = trans_to_rp(T)
    omega = so3_log(R)
    t2 = torch.sum(omega * omega, dim=-1)
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    small = t2 < (_EPS * _EPS)
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    half = torch.sqrt(t2_safe) * 0.5
    d_closed = (1.0 - half * torch.cos(half) / torch.sin(half)) / t2_safe
    d_taylor = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    d = torch.where(small, d_taylor, d_closed)
    G_inv = _eye3(T) - 0.5 * w_hat + d[..., None, None] * w_hat2
    return torch.cat([omega, _matvec(G_inv, p)], dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6, 6) adjoint ``[[R, 0], [[p]x R, R]]``."""
    R, p = trans_to_rp(T)
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([skew(p) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def ad_twist(V: torch.Tensor) -> torch.Tensor:
    """Lie bracket matrix of a twist: ``ad_V = [[[w], 0], [[v], [w]]]``."""
    w_hat = skew(V[..., :3])
    v_hat = skew(V[..., 3:])
    top = torch.cat([w_hat, torch.zeros_like(w_hat)], dim=-1)
    bottom = torch.cat([v_hat, w_hat], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def trans_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a homogeneous transform: ``[R^T, -R^T p]``."""
    R, p = trans_to_rp(T)
    Rt = R.transpose(-1, -2)
    return rp_to_trans(Rt, -_matvec(Rt, p))


def trans_to_rp(T: torch.Tensor):
    """Split (..., 4, 4) into rotation (..., 3, 3) and position (..., 3)."""
    return T[..., :3, :3], T[..., :3, 3]


def rp_to_trans(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 3, 3) rotation and (..., 3) position into (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    R = R.expand(batch + (3, 3))
    p = p.expand(batch + (3,))
    top = torch.cat([R, p[..., None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)
