"""Build a CUDA translation unit into a shared library and load it.

The library has a plain C interface and is loaded with ``ctypes``; its
source includes no PyTorch header, so ``nvcc`` takes seconds, not minutes.
Builds go to ``build/manipulapy_tpu_torch/<sha256 of source and flags>/``
beside the package, are written atomically (a temporary file, then
``os.replace``) and are reused by content. A missing ``nvcc`` or a failed
build raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BuiltLibrary", "build_library", "nvcc_path"]

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
_LOADED: dict = {}


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


def build_library(source: str, name: str) -> BuiltLibrary:
    """Compile ``source`` with ``nvcc`` for sm_90a (once per content) and
    load the shared library."""
    digest = hashlib.sha256((source + "\0" + " ".join(NVCC_FLAGS)).encode()).hexdigest()
    hit = _LOADED.get(digest)
    if hit is not None:
        return hit
    out_dir = _BUILD_ROOT / digest
    so_path = out_dir / f"{name}.so"
    log_path = out_dir / f"{name}.log"
    seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu_path = out_dir / f"{name}.cu"
        _write_atomic(cu_path, source)
        tmp_so = out_dir / f".{name}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_so), str(cu_path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp_so.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {cu_path}:\n{log[-8000:]}"
            )
        _write_atomic(log_path, log)
        os.replace(tmp_so, so_path)
    log = log_path.read_text() if log_path.exists() else ""
    built = BuiltLibrary(ctypes.CDLL(str(so_path)), so_path, seconds, log)
    _LOADED[digest] = built
    return built
