"""The port's AOT artifacts (``manipulapy_tpu_torch/utils/aot.py``) on the
CPU: a saved solver loads in the same process and solves bitwise as the
solver it was saved from, for the batched and the single-problem solver
(the two-link arm; on the CPU an artifact holds no libraries and the
loaded solve runs the plain versions); missing, corrupt, mismatched and
stale artifacts give None; and a library unpacked under the build root is
loaded by ``build_library`` without nvcc (a g++-built shared library
stands in for nvcc's). The load on a card, in a process without nvcc, is
``tests/test_torch_cuda.py``'s."""

import ctypes
import os
import pickle
import shutil
import subprocess

import numpy as np
import pytest
import torch

from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused import build_tracking_mpc
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import _build
from manipulapy_tpu_torch.utils import aot
from manipulapy_tpu_torch.utils.config import configure_cache

CPU = "cpu"
B, H = 3, 6


@pytest.fixture(scope="module")
def planar():
    model = catalog.two_link_planar(device=CPU)
    rng = np.random.default_rng(0)
    goals = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    x0 = np.concatenate([rng.uniform(-1.0, 1.0, (B, 2)), np.zeros((B, 2))], 1).astype(np.float32)
    us = rng.uniform(-1.0, 1.0, (B, H, 2)).astype(np.float32)
    return dict(
        model=model, x0=torch.from_numpy(x0), us=torch.from_numpy(us),
        batch=build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=2, u_limit=[4.0, 3.0]),
        single=build_tracking_mpc(model, goals[0], H, 0.01, iterations=2, line_search_steps=4),
    )


@pytest.fixture
def cache_dir(tmp_path):
    configure_cache(str(tmp_path / "root"))
    yield tmp_path / "root"
    configure_cache(None)


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_round_trip_is_bitwise(planar, tmp_path, kind):
    mpc = planar[kind]
    if kind == "batch":
        path = aot.save_batch_mpc(mpc, str(tmp_path / "a" / "b.aot"))
        solve = aot.load_batch_mpc(path)
        args = (planar["x0"], planar["us"])
        goal = torch.tensor([0.3, -0.2])
    else:
        path = aot.save_tracking_mpc(mpc, str(tmp_path / "s.aot"))
        solve = aot.load_tracking_mpc(path)
        args = (planar["x0"][0], planar["us"][0])
        goal = torch.tensor([0.3, -0.2])
    assert solve is not None
    _same(solve(*args), mpc.solve(*args))
    _same(solve(*args, goal), mpc.solve(*args, goal))
    libraries, meta = aot.load_executable(path)
    assert libraries == {} and meta["device"] == CPU
    assert meta["units"] == mpc.kernels.unit_keys()
    # The other kind's loader refuses it.
    other = aot.load_tracking_mpc if kind == "batch" else aot.load_batch_mpc
    assert other(path) is None


def test_missing_and_corrupt_artifacts_give_none(planar, tmp_path):
    assert aot.load_batch_mpc(str(tmp_path / "none.aot")) is None
    garbage = tmp_path / "garbage.aot"
    garbage.write_bytes(b"\x80\x04not an artifact")
    assert aot.load_batch_mpc(str(garbage)) is None
    path = aot.save_batch_mpc(planar["batch"], str(tmp_path / "b.aot"))
    data = open(path, "rb").read()
    truncated = tmp_path / "truncated.aot"
    truncated.write_bytes(data[: len(data) // 2])
    assert aot.load_batch_mpc(str(truncated)) is None
    assert aot.load_executable(str(truncated)) is None


def _edit(path, out, fn):
    with open(path, "rb") as f:
        header = f.readline()
        blob = pickle.load(f)
    fn(blob)
    with open(out, "wb") as f:
        f.write(header)
        pickle.dump(blob, f)
    return str(out)


@pytest.mark.parametrize("key, value", [
    ("device_name", "another card"), ("torch_version", "0.0.0"), ("nvcc_flags", ["-O0"]),
    ("magic", "manipulapy_tpu-aot-v1"), ("device", "cuda"),
])
def test_wrong_meta_gives_none(planar, tmp_path, key, value):
    path = aot.save_batch_mpc(planar["batch"], str(tmp_path / "b.aot"))
    bad = _edit(path, tmp_path / "bad.aot", lambda blob: blob["meta"].__setitem__(key, value))
    assert aot.load_batch_mpc(bad) is None


def test_stale_digest_gives_none(planar, tmp_path):
    """A unit re-emitted from the stored arguments hashes to a library the
    artifact lacks: its recorded key is another's."""
    path = aot.save_batch_mpc(planar["batch"], str(tmp_path / "b.aot"))

    def stale(blob):
        unit = sorted(blob["meta"]["units"])[0]
        blob["meta"]["units"][unit] = "0" * 64 + "/" + blob["meta"]["units"][unit].split("/")[1]

    assert aot.load_batch_mpc(_edit(path, tmp_path / "stale.aot", stale)) is None

    def moved_model(blob):  # the host arrays no longer hash to their digest
        blob["meta"]["build"]["host_arrays"] = dict(blob["meta"]["build"]["host_arrays"], digest="0" * 16)

    assert aot.load_batch_mpc(_edit(path, tmp_path / "digest.aot", moved_model)) is None


def test_artifact_path_names_the_device(tmp_path, monkeypatch):
    assert aot.artifact_path("panda", root=str(tmp_path)) == str(tmp_path / "cpu" / "panda.aot")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert aot.artifact_path("panda", root=str(tmp_path)) == str(tmp_path / "cuda" / "panda.aot")
    monkeypatch.setenv("MANIPULAPY_AOT_DIR", str(tmp_path / "env"))
    assert aot.artifact_path("x") == str(tmp_path / "env" / "cuda" / "x.aot")


def test_unpacked_library_loads_without_nvcc(tmp_path, cache_dir, monkeypatch):
    gxx = shutil.which("g++")
    assert gxx is not None, "the host tests compile their kernels' C with g++"
    source = 'extern "C" int answer(void) { return 42; }\n'
    src = tmp_path / "unit.cpp"
    src.write_text(source)
    built = tmp_path / "unit.so"
    subprocess.run([gxx, "-shared", "-fPIC", "-o", str(built), str(src)], check=True)
    key = _build.library_key(source, "unit")

    def no_nvcc():
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    aot._unpack({key: built.read_bytes()})
    assert (cache_dir / key).exists() and _build.build_root() == cache_dir
    lib = _build.build_library(source, "unit")
    assert lib.compile_seconds == 0.0 and lib.path == cache_dir / key
    lib.lib.answer.restype = ctypes.c_int
    assert lib.lib.answer() == 42
    # A source the root holds no library of does call nvcc.
    with pytest.raises(AssertionError, match="nvcc was called"):
        _build.build_library(source + "// another\n", "unit")


def test_save_refuses_a_model_without_host_arrays(planar, tmp_path):
    mpc = planar["batch"]
    bare = mpc._replace(build_args=dict(mpc.build_args, host_arrays=None))
    with pytest.raises(ValueError, match="host arrays"):
        aot.save_batch_mpc(bare, str(tmp_path / "b.aot"))
    assert not os.path.exists(tmp_path / "b.aot")
