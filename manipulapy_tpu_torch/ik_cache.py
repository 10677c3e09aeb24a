"""IK initial-guess strategies: solution cache, smart and robust solvers.

Counterpart of ``manipulapy_tpu/ik_cache.py``. The cache is host-side
NumPy state (a copy of the JAX module's k-NN cache); everything it feeds
runs as batched solves on the model's device. ``smart_ik`` races every
strategy of its fallback chain as one batch and keeps the chain's order in
the selection; ``robust_ik`` runs the whole (guess x damping x step-cap)
schedule as one batch with a damping and a step cap per lane.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .ik import (
    IKResult,
    _lane_tensor,
    extrapolate_guess,
    midpoint_guess,
    multi_start_ik,
    random_guesses,
    select_best,
    solve_ik_batch,
    workspace_heuristic_guess,
)
from .models.robot import RobotModel

__all__ = ["IKInitialGuessCache", "smart_ik", "robust_ik", "adaptive_multi_start_ik"]


def _pose_distance(T_a: np.ndarray, T_b: np.ndarray, w_rot: float = 0.5) -> float:
    """Position + weighted rotation (chordal) distance between poses, the
    cache's similarity metric."""
    dp = float(np.linalg.norm(T_a[:3, 3] - T_b[:3, 3]))
    dR = float(np.linalg.norm(T_a[:3, :3] - T_b[:3, :3], "fro"))
    return dp + w_rot * dR


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class IKInitialGuessCache:
    """k-NN cache of (pose -> solution) pairs with quality scores and FIFO
    eviction."""

    def __init__(self, max_entries: int = 128, k: int = 3):
        self.max_entries = int(max_entries)
        self.k = int(k)
        self._poses: List[np.ndarray] = []
        self._solutions: List[np.ndarray] = []
        self._quality: List[float] = []
        # Inserts whose (success, theta) are still device tensors: read in
        # one batched copy at the next host-side access, so ``smart_ik``
        # waits for no device result.
        self._pending: List[Tuple[np.ndarray, torch.Tensor, torch.Tensor]] = []

    def add_async(self, T, success_dev: torch.Tensor, theta_dev: torch.Tensor) -> None:
        """Queue an insert whose (success, theta) are still device tensors;
        they are read at the next host-side access (lookup, add, len)."""
        self._pending.append((np.asarray(_host(T), dtype=np.float64).copy(), success_dev, theta_dev))
        # A caller that never reads the cache must not grow the pending
        # list, and the device tensors it holds, without bound.
        if len(self._pending) > self.max_entries:
            self._materialize()

    def _materialize(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # One device-to-host copy for every pending insert.
        rows = torch.stack([torch.cat([th.reshape(-1).double(), s.reshape(1).double()])
                            for _, s, th in pending]).cpu().numpy()
        for (T, _, _), row in zip(pending, rows):
            if bool(row[-1]):
                self.add(T, row[:-1])

    def __len__(self) -> int:
        self._materialize()
        return len(self._poses)

    def add(self, T, theta, quality: float = 1.0) -> None:
        """Insert a solved pose; FIFO-evict beyond capacity. Pending inserts
        land first, so the eviction order is the solve order."""
        self._materialize()
        self._poses.append(np.asarray(_host(T), dtype=np.float64).copy())
        self._solutions.append(np.asarray(_host(theta), dtype=np.float64).copy())
        self._quality.append(float(quality))
        if len(self._poses) > self.max_entries:
            self._poses.pop(0)
            self._solutions.pop(0)
            self._quality.pop(0)

    def lookup(self, T, max_distance: float = np.inf) -> Optional[np.ndarray]:
        """Quality-weighted blend of the k nearest cached solutions; None on
        a miss."""
        hit = self.lookup_with_distance(T, max_distance)
        return None if hit is None else hit[0]

    def lookup_with_distance(self, T, max_distance: float = np.inf) -> Optional[Tuple[np.ndarray, float]]:
        """Like :meth:`lookup`, with the nearest entry's pose distance."""
        self._materialize()
        if not self._poses:
            return None
        T = np.asarray(_host(T), dtype=np.float64)
        d = np.array([_pose_distance(T, P) for P in self._poses])
        order = np.argsort(d)[: self.k]
        if d[order[0]] > max_distance:
            return None
        w = np.array([self._quality[i] / (d[i] + 1e-6) for i in order])
        w = w / w.sum()
        blend = np.einsum("i,ij->j", w, np.stack([self._solutions[i] for i in order]))
        return blend, float(d[order[0]])

    def clear(self) -> None:
        self._pending.clear()
        self._poses.clear()
        self._solutions.clear()
        self._quality.clear()


def _smart_core(model, T_desired, extra_guesses, q_current, seed, device_chain, solve_kw) -> IKResult:
    """Race the cache's guesses and every device strategy as one batch and
    select with chain semantics: the earliest successful strategy wins;
    with no success, the smallest error."""
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    dev = []
    for s in device_chain:
        if s == "workspace_heuristic":
            dev.append(workspace_heuristic_guess(model, T_desired))
        elif s == "midpoint":
            dev.append(midpoint_guess(model))
        elif s == "random":
            dev.append(random_guesses(model, gen, 1)[0])
        elif s == "extrapolate":
            dev.append(extrapolate_guess(model, q_current, T_desired))
    stack = torch.cat([extra_guesses] + ([torch.stack(dev)] if dev else []))
    results = solve_ik_batch(model, T_desired, stack, **solve_kw)
    if stack.shape[0] == 1:
        return IKResult(*(x[0] for x in results))
    order = torch.arange(stack.shape[0], dtype=results.rot_err.dtype, device=stack.device)
    combined = results.rot_err + results.trans_err
    # NaN-safe as select_best: a diverged lane's NaN score must not win.
    combined = torch.where(torch.isnan(combined), float("inf"), combined)
    i = torch.argmin(torch.where(results.success, order, 1e6 + combined))
    return IKResult(*(x[i] for x in results))


def smart_ik(
    model: RobotModel,
    T_desired,
    *,
    strategy: str = "auto",
    q_current=None,
    cache: Optional[IKInitialGuessCache] = None,
    seed: int = 0,
    fast_path_distance: float = 0.25,
    **solve_kw,
) -> Optional[IKResult]:
    """Strategy-dispatched IK with a fallback chain.

    Strategies: ``workspace_heuristic`` / ``extrapolate`` / ``cached`` /
    ``random`` / ``midpoint`` / ``auto`` (the chain through all of them,
    the first success winning). Successful solves go into ``cache`` lazily,
    read at its next lookup. ``fast_path_distance``: on an ``auto`` chain,
    a cache hit within this pose distance is solved alone first, and only
    its failure runs the whole chain."""
    chain = (
        ["cached", "extrapolate", "workspace_heuristic", "midpoint", "random"]
        if strategy == "auto"
        else [strategy]
    )
    extras, device_chain, hit_dist = [], [], np.inf
    for s in chain:
        if s == "cached":
            if cache is None:
                continue
            hit = cache.lookup_with_distance(T_desired)
            if hit is not None:
                extras.append(np.asarray(hit[0], dtype=np.float64))
                hit_dist = hit[1]
        elif s == "extrapolate":
            if q_current is not None:
                device_chain.append(s)
        elif s in ("workspace_heuristic", "midpoint", "random"):
            device_chain.append(s)
        else:
            raise ValueError(f"Unknown IK strategy {s!r}")
    if not extras and not device_chain:
        return None

    n = model.num_joints
    f = dict(dtype=model.dtype, device=model.device)
    extra_stack = torch.as_tensor(np.stack(extras), **f) if extras else torch.zeros((0, n), **f)
    qc = torch.as_tensor(q_current, **f) if q_current is not None else torch.zeros(n, **f)
    Td = torch.as_tensor(T_desired, **f)

    res = None
    if extras and device_chain and strategy == "auto" and hit_dist <= fast_path_distance:
        hit_res = _smart_core(model, Td, extra_stack, qc, seed, (), solve_kw)
        if bool(hit_res.success):
            res = hit_res
    if res is None:
        res = _smart_core(model, Td, extra_stack, qc, seed, tuple(device_chain), solve_kw)
    if cache is not None:
        cache.add_async(T_desired, res.success, res.theta)
    return res


_ROBUST_DAMPINGS = (5e-2, 5e-2, 1e-1, 1e-1, 2e-1, 5e-2, 1e-1, 2e-1, 3e-1, 5e-1)
_ROBUST_STEP_CAPS = (0.5, 0.3, 0.5, 0.3, 0.5, 1.0, 1.0, 0.7, 0.5, 0.3)


def robust_ik(
    model: RobotModel,
    T_desired,
    *,
    theta0=None,
    seed: int = 0,
    **solve_kw,
) -> IKResult:
    """The 10-entry (guess, damping, step-cap) schedule as one batch: the
    user's guess (or the workspace heuristic), the midpoint, zeros and 7
    random guesses from ``torch.Generator(seed)``, each with its own
    damping and step cap."""
    f = dict(dtype=model.dtype, device=model.device)
    Td = torch.as_tensor(T_desired, **f)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    guesses = torch.cat([
        torch.stack([
            torch.as_tensor(theta0, **f) if theta0 is not None else workspace_heuristic_guess(model, Td),
            midpoint_guess(model),
            torch.zeros(model.num_joints, **f),
        ]),
        random_guesses(model, gen, 7),
    ])
    B = len(_ROBUST_DAMPINGS)
    results = solve_ik_batch(
        model, Td, guesses, damping=_lane_tensor(_ROBUST_DAMPINGS, B, **f),
        step_cap=_lane_tensor(_ROBUST_STEP_CAPS, B, **f), **solve_kw,
    )
    return select_best(results)


def adaptive_multi_start_ik(
    model: RobotModel,
    T_desired,
    *,
    initial_starts: int = 4,
    max_starts: int = 32,
    cache: Optional[IKInitialGuessCache] = None,
    seed: int = 0,
    **solve_kw,
) -> Tuple[IKResult, int]:
    """Escalating multi-start: double the start count from
    ``initial_starts`` until success or ``max_starts``. Returns (result,
    total starts used); one host read a round."""
    gen = torch.Generator().manual_seed(int(seed))  # round seeds, on the host
    num, used, best, theta0 = initial_starts, 0, None, None
    if cache is not None:
        hit = cache.lookup(T_desired)
        if hit is not None:
            theta0 = torch.as_tensor(hit, dtype=model.dtype, device=model.device)
    while True:
        round_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        res = multi_start_ik(model, T_desired, num_starts=num, theta0=theta0, seed=round_seed, **solve_kw)
        used += num
        if best is None or float(res.rot_err + res.trans_err) < float(best.rot_err + best.trans_err):
            best = res
        if bool(res.success):
            if cache is not None:
                cache.add(T_desired, res.theta)
            return best, used
        if num >= max_starts:
            return best, used
        num = min(2 * num, max_starts)
