"""Checkpoint / resume for long-running MPC and optimization loops.

Counterpart of ``manipulapy_tpu/utils/checkpoint.py``, with its file
layout: one ``.npz`` archive, written atomically (a temporary file, then
``os.replace``), whose leaves are ``leaf_0 .. leaf_k`` and whose
``__meta_json__`` holds ``{"meta", "dtypes"}``; a leaf of a dtype that
numpy's ``savez`` does not round-trip (bfloat16, float8) is stored as its
``uint8`` byte view and its dtype's name. The leaves come in
``jax.tree.flatten``'s order (dict keys sorted; NamedTuple and dataclass
fields, lists and tuples in order; ``None`` an empty subtree; a Python
scalar a 0-d leaf), so for the same tree the ``leaf_*`` arrays and the
``"dtypes"`` entry equal a JAX checkpoint's byte for byte.

The structure record is the port's own, under ``__tree_pickle__``: JAX's
``__treedef_pickle__`` is a pickled ``PyTreeDef``, which cannot be read
without JAX, so :func:`load_checkpoint` refuses a JAX-written file with an
error that says so. A ``torch.Generator``'s ``get_state()`` is a leaf like
any tensor, the counterpart of a JAX PRNG key.

``save_checkpoint(path, tree)`` / ``load_checkpoint(path)`` are the whole
API surface, with :class:`CheckpointManager` for step-numbered rotation.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_STRUCT_KEY = "__tree_pickle__"
_JAX_STRUCT_KEY = "__treedef_pickle__"
_META_KEY = "__meta_json__"
# dtypes np.savez/np.load round-trip natively; anything else (bfloat16,
# float8_*, ...) is stored as a uint8 byte view + recorded name.
_NATIVE_DTYPES = frozenset(
    np.dtype(t).name
    for t in (
        np.bool_, np.int8, np.int16, np.int32, np.int64,
        np.uint8, np.uint16, np.uint32, np.uint64,
        np.float16, np.float32, np.float64,
        np.complex64, np.complex128,
    )
)


def _flatten(tree: Any, leaves: list):
    """The structure of ``tree``, appending its leaves to ``leaves`` in
    ``jax.tree.flatten``'s order."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], leaves) for k in keys])
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return ("namedtuple", type(tree), [_flatten(v, leaves) for v in tree])
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, [_flatten(v, leaves) for v in tree])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ("dataclass", type(tree), names, [_flatten(getattr(tree, k), leaves) for k in names])
    leaves.append(tree)
    return ("leaf",)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if kind == "namedtuple":
        return spec[1](*[_unflatten(s, leaves) for s in spec[2]])
    if kind == "dataclass":
        return spec[1](**{k: _unflatten(s, leaves) for k, s in zip(spec[2], spec[3])})
    items = [_unflatten(s, leaves) for s in spec[1]]
    return tuple(items) if kind == "tuple" else items


def _host_leaf(x: Any):
    """(numpy array as stored, dtype override or None)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).split(".")[-1]
        if name in _NATIVE_DTYPES:
            return t.numpy(), None
        t = t.reshape(-1) if t.dim() == 0 else t
        return t.contiguous().view(torch.uint8).numpy(), {"dtype": name, "scalar": x.dim() == 0}
    a = np.asarray(x)
    if a.dtype.name in _NATIVE_DTYPES:
        return a, None
    override = {"dtype": a.dtype.name, "scalar": a.ndim == 0}
    return np.ascontiguousarray(a.reshape(-1) if a.ndim == 0 else a).view(np.uint8), override


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> str:
    """Atomically snapshot a tree of tensors, arrays and scalars to ``path``
    (.npz). Tensors are pulled to the host; the structure is stored so the
    exact containers (dicts, NamedTuples, dataclasses, lists, tuples) are
    restored by :func:`load_checkpoint`. ``meta`` is an optional small
    JSON-able dict (step number, wall time, config hash).

    SECURITY: the container structure round-trips through pickle, so a
    checkpoint file is TRUSTED INPUT — never load one from an untrusted
    source (loading executes the embedded pickle).
    """
    leaves: list = []
    spec = _flatten(tree, leaves)
    arrays = {}
    dtype_overrides = {}
    for i, x in enumerate(leaves):
        a, override = _host_leaf(x)
        if override is not None:
            dtype_overrides[str(i)] = override
        arrays[f"leaf_{i}"] = a
    arrays[_STRUCT_KEY] = np.frombuffer(pickle.dumps(spec), dtype=np.uint8)
    arrays[_META_KEY] = np.frombuffer(
        json.dumps({"meta": meta or {}, "dtypes": dtype_overrides}).encode(), dtype=np.uint8
    )
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()

    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):  # only on failure
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, with_meta: bool = False, device=None):
    """Restore the tree saved by :func:`save_checkpoint`, every leaf a
    tensor on ``device`` (the card unless the caller names the CPU); a
    bfloat16 or float8 leaf is its stored bytes viewed as its dtype.

    Returns the tree, or ``(tree, meta)`` when ``with_meta=True``.
    TRUSTED INPUT ONLY: the stored container structure round-trips
    through pickle (see :func:`save_checkpoint`).
    """
    device = torch.device("cuda" if device is None else device)
    with np.load(path, allow_pickle=False) as z:
        if _STRUCT_KEY not in z.files:
            if _JAX_STRUCT_KEY in z.files:
                raise ValueError(
                    f"{path} was written by the JAX package: its structure is a pickled "
                    "jax PyTreeDef, which cannot be read without JAX"
                )
            raise ValueError(f"{path} is not a checkpoint (no {_STRUCT_KEY} entry)")
        spec = pickle.loads(z[_STRUCT_KEY].tobytes())
        blob = json.loads(z[_META_KEY].tobytes().decode())
        meta, overrides = blob["meta"], blob["dtypes"]
        leaves = []
        for i in range(sum(k.startswith("leaf_") for k in z.files)):
            t = torch.from_numpy(z[f"leaf_{i}"])
            ov = overrides.get(str(i))
            if ov is not None:
                t = t.view(getattr(torch, ov["dtype"]))
                if ov["scalar"]:
                    t = t.reshape(())
            leaves.append(t.to(device))
    tree = _unflatten(spec, iter(leaves))
    return (tree, meta) if with_meta else tree


class CheckpointManager:
    """Step-numbered checkpoints with rotation.

    >>> mgr = CheckpointManager("run", max_to_keep=3)
    >>> mgr.save(step, solver_state)
    >>> step, state = mgr.restore_latest()

    ``restore`` and ``restore_latest`` take :func:`load_checkpoint`'s
    ``device``.
    """

    def __init__(self, directory: str, prefix: str = "ckpt", max_to_keep: int = 3):
        if int(max_to_keep) < 1:
            # [:-0] == [:0] silently disabled rotation entirely
            raise ValueError("max_to_keep must be >= 1")
        self.directory = directory
        self.prefix = prefix
        self.max_to_keep = int(max_to_keep)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:012d}.npz")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(self.prefix + "_") and name.endswith(".npz"):
                try:
                    steps.append(int(name[len(self.prefix) + 1 : -4]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> str:
        meta = dict(meta or {})
        meta["step"] = int(step)
        path = save_checkpoint(self._path(step), tree, meta)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))
        return path

    def restore(self, step: int, device=None):
        return load_checkpoint(self._path(step), device=device)

    def restore_latest(self, device=None):
        """(step, tree) of the newest checkpoint; (None, None) if empty."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, device=device)
