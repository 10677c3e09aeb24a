"""The port's runtime utilities (``manipulapy_tpu_torch/utils``) against the
JAX package's: config flags and the kernels' build root, the feature map
(JAX's keys with ``tpu`` -> ``cuda``), ``require_feature``,
``check_dependencies``, ``test_installation`` on the CPU, the profiling
dicts; and the public names that the port's facades gained: the package's
submodules and lazy names, ``ops``' Cholesky re-exports and
``ops.cgen.transform_inv_const``, each against its JAX name."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manipulapy_tpu as jax_pkg
import manipulapy_tpu_torch as port
from manipulapy_tpu import ops as jax_ops
from manipulapy_tpu.ops import cgen as jax_cgen
from manipulapy_tpu.utils import features as jax_features
from manipulapy_tpu.utils import profiling as jax_profiling
from manipulapy_tpu_torch import ops
from manipulapy_tpu_torch.ops import _build, cgen
from manipulapy_tpu_torch.utils import config, features, profiling


@pytest.fixture
def fresh_features():
    yield
    features.get_available_features(refresh=True)


@pytest.mark.parametrize("value, default, expected", [
    (None, False, False), (None, True, True), ("1", False, True), ("yes", False, True), (" On ", False, True),
    ("true", False, True), ("0", True, False), ("no", True, False), ("", True, False),
])
def test_env_flag(monkeypatch, value, default, expected):
    if value is None:
        monkeypatch.delenv("MANIPULAPY_TPU_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("MANIPULAPY_TPU_TEST_FLAG", value)
    assert config.env_flag("MANIPULAPY_TPU_TEST_FLAG", default) is expected
    assert config.env_flag("MANIPULAPY_TPU_TEST_FLAG", default) is jax_pkg.utils.env_flag("MANIPULAPY_TPU_TEST_FLAG", default)


def test_configure_cache_moves_the_build_root(tmp_path, monkeypatch):
    default = _build.build_root()
    monkeypatch.delenv("MANIPULAPY_TPU_CACHE_DIR", raising=False)
    try:
        config.configure_cache(str(tmp_path / "a"))
        assert _build.build_root() == tmp_path / "a"
        monkeypatch.setenv("MANIPULAPY_TPU_CACHE_DIR", str(tmp_path / "env"))
        assert _build.build_root() == tmp_path / "a"  # the configured root wins
        config.configure_cache()  # None: the environment's
        assert _build.build_root() == tmp_path / "env"
        monkeypatch.delenv("MANIPULAPY_TPU_CACHE_DIR")
        assert _build.build_root() == _build._BUILD_ROOT
    finally:
        config.configure_cache(None)
    assert _build.build_root() == default
    assert _build._BUILD_ROOT.parts[-2:] == ("build", "manipulapy_tpu_torch")


def test_configure_cpu_precision_sets_float64():
    before = torch.get_default_dtype()
    try:
        config.configure_cpu_precision()
        assert torch.get_default_dtype() == torch.float64
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_default_dtype(before)


def _nvcc_found() -> bool:
    try:
        _build.nvcc_path()
    except RuntimeError:
        return False
    return True


def test_feature_keys_are_jax_with_cuda_for_tpu(fresh_features):
    jax_keys = set(jax_features.get_available_features(refresh=True))
    feats = features.get_available_features(refresh=True)
    assert set(feats) == (jax_keys - {"tpu"}) | {"cuda"}
    assert feats["core"] is True and feats["checkpoint"] is True
    assert feats["cuda"] is (torch.cuda.is_available() and _nvcc_found())
    assert feats["mesh"] is (torch.cuda.device_count() > 1)
    for key in ("simulation", "vision", "ml"):  # the same probes of the same host
        assert feats[key] is jax_features.get_available_features()[key]


def test_require_feature_errors(monkeypatch, fresh_features):
    features.require_feature("core")
    with pytest.raises(ValueError, match="unknown feature"):
        features.require_feature("warp-drive")
    monkeypatch.setitem(features._FEATURE_DEPS, "simulation", [("definitely_not_a_module", "nope")])
    features.get_available_features(refresh=True)
    with pytest.raises(ImportError, match="nope.*pip install pybullet"):
        features.require_feature("simulation")
    monkeypatch.setattr(features, "_cuda_available", lambda: False)
    features.get_available_features(refresh=True)
    with pytest.raises(ImportError, match="'cuda' requires: cuda"):
        features.require_feature("cuda")


def test_check_dependencies_output(capsys, monkeypatch, fresh_features):
    feats = features.check_dependencies(verbose=False)
    assert capsys.readouterr().out == "" and isinstance(feats, dict)
    monkeypatch.setitem(features._FEATURE_DEPS, "vision", [("definitely_not_cv2", "opencv-python")])
    features.check_dependencies(verbose=True)
    out = capsys.readouterr().out
    assert out.startswith("manipulapy_tpu_torch feature availability\n" + "=" * 40 + "\n")
    assert "vision      : NOT available" in out and "    missing definitely_not_cv2 (opencv-python)" in out
    assert "To enable missing features:" in out and "  pip install opencv-python" in out
    assert features.get_installation_command("core") == "" and "pybullet" in features.get_installation_command("simulation")
    assert features.missing_dependencies()["vision"] == [{"module": "definitely_not_cv2", "package": "opencv-python"}]


def test_test_installation_on_the_cpu():
    assert features.test_installation(device="cpu") is True


def test_performance_monitor_matches_jax():
    ours, theirs = profiling.PerformanceMonitor(), jax_profiling.PerformanceMonitor()
    for mon in (ours, theirs):
        with mon.time_op("fk"):
            pass
        with mon.time_op("fk"):
            pass
        mon.record("ik", 0.5)
    a, b = ours.get_performance_stats(), theirs.get_performance_stats()
    assert sorted(a) == sorted(b) and all(sorted(a[k]) == sorted(b[k]) for k in a)
    assert a["fk"]["calls"] == 2 and a["ik"] == b["ik"] == {"calls": 1, "total_time_s": 0.5, "avg_time_s": 0.5}
    ours.reset()
    assert ours.get_performance_stats() == {}


def test_benchmark_fn_matches_jax():
    ours = profiling.benchmark_fn(lambda x: x * 2.0, torch.ones(16), warmup=1, iters=4)
    theirs = jax_profiling.benchmark_fn(lambda x: x * 2.0, jnp.ones(16), warmup=1, iters=4)
    assert set(ours) == set(theirs) and ours["iterations"] == 4
    assert ours["min_time_ms"] <= ours["median_time_ms"] <= ours["max_time_ms"]
    assert ours["min_time_ms"] <= ours["avg_time_ms"] <= ours["max_time_ms"] and ours["std_time_ms"] >= 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64).cumsum(0)
    assert log_dir == str(tmp_path / "trace")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_facade_names_equal_jax():
    assert set(jax_pkg._SUBMODULES) <= set(port._SUBMODULES)
    assert set(jax_pkg._LAZY_ATTRS) <= set(port._LAZY_ATTRS)
    for name in ("utils", "vision", "perception", "plotting"):
        assert getattr(port, name).__name__ == f"manipulapy_tpu_torch.{name}"
    assert port.test_installation is port.utils.test_installation
    for name in ("check_dependencies", "get_available_features", "get_installation_command", "require_feature"):
        assert getattr(port, name) is getattr(port.utils, name)
    assert sorted(port.utils.__all__) == sorted(jax_pkg.utils.__all__)


def test_ops_reexports_the_cholesky_helpers():
    assert ops.__all__ == jax_ops.__all__
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 4))
    A = A @ A.T + 4 * np.eye(4)
    b = rng.standard_normal(4)
    x = ops.solve_spd_small(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jax_ops.solve_spd_small(jnp.asarray(A), jnp.asarray(b))), rtol=1e-12, atol=1e-12)
    L = ops.chol_factor_small(torch.from_numpy(A))
    np.testing.assert_allclose(ops.chol_solve_small(L, torch.from_numpy(b)).numpy(), x.numpy(), rtol=1e-12, atol=1e-12)


def test_transform_inv_const_equals_jax():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    R = [[float(v) for v in row] for row in q]
    R[0][1] = 0.0  # an exact zero the folding keeps
    p = [float(v) for v in rng.standard_normal(3)]
    ours = cgen.transform_inv_const((R, p))
    theirs = jax_cgen.transform_inv_const((R, p))
    assert ours == theirs
    Rt, pt = ours
    np.testing.assert_allclose(np.asarray(Rt) @ np.asarray(p) + np.asarray(pt), 0.0, atol=1e-12)
