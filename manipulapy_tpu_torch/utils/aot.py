"""AOT artifacts: a built MPC solver that a fresh process loads without nvcc.

Counterpart of ``manipulapy_tpu/utils/aot.py``. The JAX module serializes a
compiled executable; the port's kernels are shared libraries that
``ops/_build.py::build_library`` builds from emitted CUDA source and loads
without ``nvcc`` when ``<root>/<sha256>/<name>.so`` already exists. So an
artifact here is one pickle file, written atomically, holding

* the meta: a magic string, ``torch.__version__``, ``torch.version.cuda``,
  the device type, name and compute capability, and ``NVCC_FLAGS``;
* the solver's build arguments (``BatchTrackingMPC.build_args`` or
  ``TrackingMPC.build_args``): the model's f64 host arrays with their
  digest, the goals, the shapes, the iterations and alphas, the weights,
  ``reg``, ``u_limit`` and ``g``;
* on the card, the bytes of every built unit, keyed ``<sha256>/<name>.so``
  as ``build_library`` names it (``ops/_build.py::library_key``).

Workflow::

    # once, on the target card:
    aot.save_batch_mpc(build_batch_tracking_mpc(panda, goals, 1024, 50, 0.01),
                       aot.artifact_path("panda_b1024_h50"))

    # any later process, with or without nvcc:
    solve = aot.load_batch_mpc(aot.artifact_path("panda_b1024_h50"))
    us, xs, cost = solve(x0, us_warm)

A load re-emits each unit's source from the stored arguments (no compiler:
the emitter is Python), checks that the artifact holds the library of that
source, writes the libraries under the build root
(``utils.config.configure_cache``) and rebuilds the solver, whose units
then load with ``compile_seconds`` 0. It returns ``None``, so that a caller
can build normally, on a missing or corrupt file, on any meta mismatch
(another card, torch, CUDA or nvcc flags) and when a re-emitted source
hashes to a library the artifact lacks. On the CPU an artifact holds no
libraries and the loaded solver runs the plain versions.

The JAX ``save_jitted`` has no counterpart: PyTorch has no serialized
executable of eager code. :func:`load_executable` returns ``(libraries,
meta)``. Artifacts are TRUSTED INPUT: loading one unpickles it.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Optional

import torch

from ..models.robot import from_host_arrays, host_arrays
from ..ops._build import NVCC_FLAGS, build_root

__all__ = [
    "default_aot_dir",
    "artifact_path",
    "load_executable",
    "save_batch_mpc",
    "load_batch_mpc",
    "save_tracking_mpc",
    "load_tracking_mpc",
]

logger = logging.getLogger(__name__)

_MAGIC = "manipulapy_tpu_torch-aot-v1"
# Precedes the pickle, so a file of another kind is refused before it is
# unpickled.
_HEADER = (_MAGIC + "\n").encode()


def default_aot_dir() -> str:
    """``$MANIPULAPY_AOT_DIR`` or ``~/.manipulapy_tpu_torch/aot``."""
    return os.environ.get(
        "MANIPULAPY_AOT_DIR",
        os.path.join(os.path.expanduser("~"), ".manipulapy_tpu_torch", "aot"),
    )


def _env_meta(device_type: str) -> Optional[dict]:
    """What an artifact for ``device_type`` must match here; None when this
    process has no such device."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            return None
        name, capability = torch.cuda.get_device_name(), list(torch.cuda.get_device_capability())
    elif device_type == "cpu":
        name, capability = "cpu", None
    else:
        return None
    return {
        "magic": _MAGIC,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device_type,
        "device_name": name,
        "capability": capability,
        "nvcc_flags": list(NVCC_FLAGS),
    }


def artifact_path(name: str, root: Optional[str] = None) -> str:
    """Canonical artifact location for ``name`` on this host's device
    (``cuda`` when PyTorch sees a card, else ``cpu``)."""
    root = root or default_aot_dir()
    return os.path.join(root, "cuda" if torch.cuda.is_available() else "cpu", f"{name}.aot")


def _save(mpc, path: str, kind: str) -> str:
    args = dict(mpc.build_args)
    if args["host_arrays"] is None:
        raise ValueError(
            "the solver's model has no host arrays (a dataclasses.replace derivative); "
            "build it from the catalog or from_host_arrays to save it"
        )
    device = args.pop("device")
    meta = _env_meta(device)
    if meta is None:
        raise RuntimeError(f"no {device} device to save a {device} artifact on")
    units = mpc.kernels.unit_keys()
    libraries = {}
    if device == "cuda":
        for unit, built in mpc.kernels.build().items():
            libraries[units[unit]] = built.path.read_bytes()
    meta.update(kind=kind, build=args, units=units)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER)
        pickle.dump({"meta": meta, "libraries": libraries}, f)
    os.replace(tmp, path)
    return path


def load_executable(path: str) -> Optional[tuple]:
    """``(libraries, meta)`` of the artifact at ``path``: the built units'
    bytes keyed ``<sha256>/<name>.so``, and the meta with the solver's kind,
    build arguments and units. None when the file is missing, corrupt or was
    made for another device, torch, CUDA or nvcc flags."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            if f.read(len(_HEADER)) != _HEADER:
                return None
            blob = pickle.load(f)
        meta, libraries = blob["meta"], blob["libraries"]
        device = meta["device"]
    except Exception as exc:  # a corrupt artifact is refused, not raised
        logger.warning("AOT artifact %s is unreadable: %r", path, exc)
        return None
    env = _env_meta(device)
    if env is None or any(meta.get(key) != value for key, value in env.items()):
        return None
    return libraries, meta


def _rebuild(path: str, kind: str, build: Callable):
    """The solver of the artifact at ``path``, its libraries under the build
    root; None on any refusal."""
    loaded = load_executable(path)
    if loaded is None:
        return None
    libraries, meta = loaded
    if meta.get("kind") != kind:
        return None
    args = dict(meta["build"])
    arrays = args.pop("host_arrays")
    model = from_host_arrays(arrays, dtype=torch.float32, device=meta["device"])
    if host_arrays(model)["digest"] != arrays["digest"]:
        return None
    mpc = build(model, args.pop("q_goal"), **args)
    keys = mpc.kernels.unit_keys()
    if any(key not in meta["units"].values() for key in keys.values()):
        return None
    if meta["device"] == "cuda":
        if any(key not in libraries for key in keys.values()):
            return None
        _unpack({key: libraries[key] for key in keys.values()})
        mpc.kernels.build()
    return mpc


def _unpack(libraries: dict) -> None:
    """Write each library under the build root at its key, where
    ``build_library`` finds it (atomically; one already there stays)."""
    root = build_root()
    for key, data in libraries.items():
        target = root / key
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
            tmp.write_bytes(data)
            os.replace(tmp, target)


def _solve_of(mpc) -> Callable:
    def solve(x0, us_init, q_goal=None):
        return mpc.solve(x0, us_init, q_goal)

    solve.handle = mpc
    return solve


def save_batch_mpc(mpc, path: str) -> str:
    """Save a built :class:`~manipulapy_tpu_torch.mpc.fused_batch.
    BatchTrackingMPC` (its build arguments and, on the card, its built
    K2-K5 units; they build here first if they have not)."""
    return _save(mpc, path, "batch_mpc")


def load_batch_mpc(path: str) -> Optional[Callable]:
    """Load an AOT batched solver: returns ``solve(x0 (B, 2n), us (B, H,
    n), q_goal=None) -> (us, xs, cost)`` (``BatchTrackingMPC.solve``), or
    None on any mismatch. No nvcc runs; ``solve.handle`` is the rebuilt
    handle, whose ``kernels.build()`` gives each unit's ``BuiltLibrary``."""
    from ..mpc.fused_batch import build_batch_tracking_mpc

    mpc = _rebuild(path, "batch_mpc", build_batch_tracking_mpc)
    return None if mpc is None else _solve_of(mpc)


def save_tracking_mpc(mpc, path: str) -> str:
    """Save a built :class:`~manipulapy_tpu_torch.mpc.fused.TrackingMPC`
    (the single-problem latency solver)."""
    return _save(mpc, path, "tracking_mpc")


def load_tracking_mpc(path: str) -> Optional[Callable]:
    """Load an AOT latency solver: returns ``solve(x0 (2n,), us (H, n),
    q_goal=None) -> (us, xs, cost)`` or None on mismatch; ``solve.handle``
    as for :func:`load_batch_mpc`."""
    from ..mpc.fused import build_tracking_mpc

    mpc = _rebuild(path, "tracking_mpc", build_tracking_mpc)
    return None if mpc is None else _solve_of(mpc)
