"""Build a CUDA translation unit into a shared library and load it.

The library has a plain C interface and is loaded with ``ctypes``; its
source includes no PyTorch header, so ``nvcc`` takes seconds, not minutes.
Builds go to ``<root>/<sha256 of source and flags>/<name>.so``, are written
atomically (a temporary file, then ``os.replace``) and are reused by
content. The root is read at each build (:func:`build_root`): the one
``utils.config.configure_cache`` set, else ``$MANIPULAPY_TPU_CACHE_DIR``,
else ``build/manipulapy_tpu_torch/`` beside the package. A library already
under the root is loaded without ``nvcc``, which is how an AOT artifact
(``utils/aot.py``) ships built kernels. A missing ``nvcc`` or a failed
build raises: nothing falls back to a plain version.

:class:`KernelSet` is what the MPC kernel sets share: their units built
in parallel, the checks that route a call to its kernel or its plain
version, the launch on PyTorch's current stream and the launch counts.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

__all__ = ["NVCC_FLAGS", "BuiltLibrary", "KernelSet", "build_library", "build_root", "library_key", "nvcc_path"]

# --fmad=false: no multiply-add contraction, so every emitted operation
# rounds once, as each eager op of the plain PyTorch version does. With
# contraction the UR5 rollout at B=4097, N=50 left the plain version by
# 1.3e-3 in dq (H100 80GB HBM3, 700 W), over the 1e-3 tolerance: the
# rollout is chaotic enough to amplify last-bit differences over 50 steps.
# Contraction was no faster there (UR5 B=131072 N=50: 3.34 ms with it,
# 3.25-3.28 ms without), since memory access, not arithmetic, bounds it.
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "--fmad=false",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-Xcompiler",
    "-fPIC",
    "-shared",
    "-Xptxas",
    "-v",
)

_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "manipulapy_tpu_torch"
_CACHE_DIR = None  # set by utils.config.configure_cache
_LOADED: dict = {}


def build_root() -> Path:
    """Where kernels build into and load from: the directory
    ``utils.config.configure_cache`` set, else ``$MANIPULAPY_TPU_CACHE_DIR``,
    else ``build/manipulapy_tpu_torch/`` beside the package."""
    return Path(_CACHE_DIR or os.environ.get("MANIPULAPY_TPU_CACHE_DIR") or _BUILD_ROOT)


def library_key(source: str, name: str, flags: Tuple[str, ...] = ()) -> str:
    """``<sha256>/<name>.so``: where :func:`build_library` puts the library
    of ``source`` built with ``NVCC_FLAGS`` and ``flags``, under the root."""
    digest = hashlib.sha256((source + "\0" + " ".join(NVCC_FLAGS + tuple(flags))).encode()).hexdigest()
    return f"{digest}/{name}.so"


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    compile_seconds: float  # 0.0 when the library was already on disk
    log: str  # nvcc's output, with -Xptxas -v's register and spill report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA "
        "kernels of manipulapy_tpu_torch are built from source at first use"
    )


def _write_atomic(path: Path, text: str) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build_library(source: str, name: str, flags: Tuple[str, ...] = ()) -> BuiltLibrary:
    """Compile ``source`` with ``nvcc`` for sm_90a (once per content and
    flags: ``NVCC_FLAGS``, then the unit's own ``flags``) and load the
    shared library."""
    key = library_key(source, name, flags)
    flags = NVCC_FLAGS + tuple(flags)
    so_path = build_root() / key
    hit = _LOADED.get(so_path)
    if hit is not None:
        return hit
    out_dir = so_path.parent
    log_path = out_dir / f"{name}.log"
    seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu_path = out_dir / f"{name}.cu"
        _write_atomic(cu_path, source)
        tmp_so = out_dir / f".{name}.{os.getpid()}.so"
        cmd = [nvcc_path(), *flags, "-o", str(tmp_so), str(cu_path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp_so.unlink(missing_ok=True)
            errors = "\n".join(line for line in log.splitlines() if "error" in line)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {cu_path}:\n{errors[:8000]}\n...\n{log[-4000:]}"
            )
        _write_atomic(log_path, log)
        os.replace(tmp_so, so_path)
    log = log_path.read_text() if log_path.exists() else ""
    built = BuiltLibrary(ctypes.CDLL(str(so_path)), so_path, seconds, log)
    _LOADED[so_path] = built
    return built


class KernelSet:
    """The stages of one set of kernels, built from several translation
    units, each stage a ``launch_<stage>`` and an ``attributes_<stage>``
    C entry point of its unit.

    A subclass sets ``UNITS`` (unit: its stages), ``ARGTYPES`` (stage: the
    ctypes of its launch's arguments, the stream last), ``LIB_PREFIX``, its
    own ``launch_count`` dict (launches of every instance, per stage) and,
    where a unit needs them, ``UNIT_FLAGS`` (unit: nvcc flags besides
    ``NVCC_FLAGS``), and fills ``self.sources`` (unit: CUDA source)."""

    UNITS: Dict[str, Tuple[str, ...]] = {}
    UNIT_FLAGS: Dict[str, Tuple[str, ...]] = {}
    ARGTYPES: Dict[str, list] = {}
    LIB_PREFIX = ""
    launch_count: Dict[str, int] = {}
    sources: Dict[str, str]
    _libs = None

    @classmethod
    def reset_launch_count(cls) -> None:
        cls.launch_count = dict.fromkeys(cls.launch_count, 0)

    def build(self) -> Dict[str, BuiltLibrary]:
        """Compile the translation units in parallel, one nvcc each (once
        per source), and load them; returns ``{unit: BuiltLibrary}``."""
        if self._libs is None:
            with concurrent.futures.ThreadPoolExecutor(len(self.UNITS)) as pool:
                futures = {
                    unit: pool.submit(build_library, self.sources[unit], f"{self.LIB_PREFIX}_{unit}",
                                      self.UNIT_FLAGS.get(unit, ()))
                    for unit in self.UNITS
                }
                built = {unit: f.result() for unit, f in futures.items()}
            for unit, stages in self.UNITS.items():
                lib = built[unit].lib
                for stage in stages:
                    launch = getattr(lib, f"launch_{stage}")
                    launch.argtypes = self.ARGTYPES[stage]
                    launch.restype = ctypes.c_int
                    attrs = getattr(lib, f"attributes_{stage}")
                    attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
                    attrs.restype = ctypes.c_int
            self._libs = built
        return self._libs

    def unit_keys(self) -> Dict[str, str]:
        """Per unit, the :func:`library_key` its build has under the root."""
        return {unit: library_key(self.sources[unit], f"{self.LIB_PREFIX}_{unit}", self.UNIT_FLAGS.get(unit, ()))
                for unit in self.UNITS}

    def _lib(self, stage: str) -> ctypes.CDLL:
        libs = self.build()
        return next(libs[u].lib for u, stages in self.UNITS.items() if stage in stages)

    def kernel_attributes(self) -> Dict[str, dict]:
        """Per stage: registers per thread, spill (local) bytes per thread,
        the largest block size and the static shared bytes per block, from
        ``cudaFuncGetAttributes``."""
        keys = ("num_regs", "local_bytes", "max_threads", "smem_bytes")
        out = {}
        for stages in self.UNITS.values():
            for stage in stages:
                values = [ctypes.c_int() for _ in keys]
                err = getattr(self._lib(stage), f"attributes_{stage}")(*map(ctypes.byref, values))
                if err:
                    raise RuntimeError(f"cudaFuncGetAttributes({stage}) failed with CUDA error {err}")
                out[stage] = {k: v.value for k, v in zip(keys, values)}
        return out

    def _route(self, stage: str, tensors: Dict[str, "torch.Tensor"], shapes: Dict[str, tuple]) -> bool:
        """True when the stage runs its kernel, False for the plain version
        (all tensors on the CPU). Raises on anything the kernel does not
        take."""
        for name, x in tensors.items():
            if tuple(x.shape) != shapes[name]:
                raise ValueError(f"{stage}: {name} must be {shapes[name]}, got {tuple(x.shape)}")
        devices = {x.device for x in tensors.values()}
        if all(d.type == "cpu" for d in devices):
            return False
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{stage}: inputs must all lie on one CUDA device, got {sorted(map(str, devices))}")
        for name, x in tensors.items():
            if x.dtype != torch.float32:
                raise TypeError(f"the {stage} kernel takes float32; {name} is {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{stage}: {name} must be contiguous")
            if x.requires_grad:
                raise ValueError(f"the {stage} kernel has no backward; detach {name}")
        return True

    def _launch(self, stage: str, device, *args) -> None:
        fn = getattr(self._lib(stage), f"launch_{stage}")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err:
            raise RuntimeError(f"{stage} kernel launch failed with CUDA error {err}")
        type(self).launch_count[stage] += 1
