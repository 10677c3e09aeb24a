"""Device meshes and scenario-axis sharding.

Counterpart of ``manipulapy_tpu/parallel/mesh.py``. JAX's mesh is
single-controller: one process drives every local device. Its counterpart
here is a :class:`Mesh` that holds a tuple of torch devices, by default
every visible CUDA device, and no process group: a sharded call splits the
leading scenario axis into one chunk a device, runs each chunk where it
lies (a CUDA launch returns at once, so the devices overlap), and gathers
the results on the first device. Ragged batches are padded to a multiple
of the mesh size with copies of their first row and un-padded on return.
The cross-device mean of the fleet layer is the mean of the per-device
means, gathered on the first device. With one device nothing moves.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import vmap

__all__ = [
    "Mesh",
    "make_mesh",
    "scenario_sharding",
    "replicate_model",
    "shard_batch",
    "sharded_vmap",
    "distributed_rollout",
    "distributed_ik",
    "scaling_efficiency",
]

SCENARIO_AXIS = "scenario"


class Mesh(NamedTuple):
    """A 1-D mesh: the devices the scenario axis is split over."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SCENARIO_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = SCENARIO_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the first ``num_devices`` of ``devices``, by default
    every visible CUDA device. With no CUDA device and no ``devices`` it
    raises: it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, (axis_name,))


def scenario_sharding(mesh: Mesh, batch: int) -> Tuple[Tuple[torch.device, slice], ...]:
    """Each device's rows of a (batch, ...) scenario axis; ``batch`` must
    divide by the mesh size."""
    if batch % mesh.size:
        raise ValueError(f"batch {batch} must divide by the mesh size {mesh.size}")
    per = batch // mesh.size
    return tuple((d, slice(i * per, (i + 1) * per)) for i, d in enumerate(mesh.devices))


def replicate_model(model, mesh: Mesh) -> tuple:
    """One copy of ``model`` (anything with ``.to(device)``) a device."""
    return tuple(model.to(d) for d in mesh.devices)


def shard_batch(batch, mesh: Mesh) -> list:
    """Split a (B, ...) tensor, or a tuple or list of them, over the mesh:
    one shard a device, on that device. B must divide by the mesh size
    (pad upstream; the helpers below do)."""
    if isinstance(batch, (tuple, list)):
        return [type(batch)(shard) for shard in zip(*(shard_batch(x, mesh) for x in batch))]
    return [batch[rows].to(d) for d, rows in scenario_sharding(mesh, batch.shape[0])]


def _pad_to_multiple(x: torch.Tensor, multiple: int):
    b = x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return x, b
    return torch.cat([x, x[:1].expand((rem,) + x.shape[1:])]), b


def _gather(parts: list, b: int):
    """Concatenate per-device outputs (tensors or tuples of them) on the
    first device, then drop the padded rows."""
    first = parts[0]
    if isinstance(first, tuple):
        items = [_gather([p[i] for p in parts], b) for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    out = first if len(parts) == 1 else torch.cat([p.to(first.device) for p in parts])
    return out if out.shape[0] == b else out[:b]


def _map_chunks(mesh: Mesh, fn: Callable, model, args) -> object:
    """``fn(model_d, *chunk_d)`` on every device's chunk of the padded
    batch, gathered and un-padded."""
    padded, orig = zip(*(_pad_to_multiple(torch.as_tensor(a), mesh.size) for a in args))
    models = replicate_model(model, mesh)
    shards = shard_batch(list(padded), mesh)
    return _gather([fn(m, *shard) for m, shard in zip(models, shards)], orig[0])


def sharded_vmap(fn: Callable, mesh: Mesh, *, axis_name: str = SCENARIO_AXIS) -> Callable:
    """Lift a per-scenario ``fn(model, *per_scenario_args)`` to ``F(model,
    *batched_args)``: ``torch.func.vmap`` over each device's chunk of the
    leading scenario axis, the model replicated."""

    def wrapper(model, *args):
        lifted = vmap(fn, in_dims=(None,) + (0,) * len(args))
        return _map_chunks(mesh, lifted, model, args)

    return wrapper


def distributed_rollout(
    model,
    mesh: Mesh,
    q0: torch.Tensor,
    dq0: torch.Tensor,
    taus: torch.Tensor,
    *,
    g=None,
    dt: float = 0.01,
    intRes: int = 1,
):
    """Sharded batched forward-dynamics rollouts: (B, n) initial states and
    (B, N, n) torques, B split over the mesh. Each device's chunk goes
    through ``trajectory.forward_dynamics_trajectory`` as one (B/d, n)
    call, so float32 chunks on a CUDA device run the rollout kernel (K1)."""
    from ..trajectory import forward_dynamics_trajectory

    def chunk(m, q0_c, dq0_c, tau_c):
        return forward_dynamics_trajectory(m, q0_c, dq0_c, tau_c, g=g, dt=dt, intRes=intRes)

    return _map_chunks(mesh, chunk, model, (q0, dq0, taus))


def distributed_ik(model, mesh: Mesh, targets: torch.Tensor, guesses: torch.Tensor, **kw):
    """Sharded batched IK: (B, 4, 4) targets and (B, n) guesses, one
    ``ik.solve_ik_batch`` a device chunk."""
    from ..ik import solve_ik_batch

    def chunk(m, T_c, th_c):
        return solve_ik_batch(m, T_c, th_c, **kw)

    return _map_chunks(mesh, chunk, model, (targets, guesses))


def scaling_efficiency(times_by_devices: dict) -> dict:
    """Weak-scaling report: ``eff(n) = T(1) / T(n)`` with the work per
    device held constant (ideal: 1.0). For strong scaling pass ``{n: T(n) *
    n}``."""
    if 1 not in times_by_devices:
        raise ValueError("need a 1-device baseline time")
    t1 = times_by_devices[1]
    return {n: t1 / t for n, t in times_by_devices.items()}
