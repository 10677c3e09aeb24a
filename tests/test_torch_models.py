"""The port's robot models against the JAX package's, and its import rules.

The port (``manipulapy_tpu_torch``) must build every catalog robot with
fields equal, in f64, to the JAX catalog's host arrays, and must never
import JAX.
"""

import dataclasses
import gc
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch.models import (
    HOST_ARRAY_KEYS,
    catalog,
    from_host_arrays,
    host_arrays,
    make_robot_model,
)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CATALOG = {
    "ur5": (lambda: jax_catalog.ur5(dtype=jnp.float64), lambda: catalog.ur5(dtype=torch.float64, device=CPU)),
    "panda": (lambda: jax_catalog.panda(dtype=jnp.float64), lambda: catalog.panda(dtype=torch.float64, device=CPU)),
    "two_link_planar": (
        lambda: jax_catalog.two_link_planar(dtype=jnp.float64),
        lambda: catalog.two_link_planar(dtype=torch.float64, device=CPU),
    ),
    "serial_chain_3": (
        lambda: jax_catalog.serial_chain(3, dtype=jnp.float64),
        lambda: catalog.serial_chain(3, dtype=torch.float64, device=CPU),
    ),
}


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_catalog_fields_equal_jax(name):
    make_jax, make_port = CATALOG[name]
    jax_model = make_jax()
    reference = from_host_arrays(jax_host_arrays(jax_model), dtype=torch.float64, device=CPU)
    port = make_port()
    for key in HOST_ARRAY_KEYS:
        a, b = getattr(port, key), getattr(reference, key)
        assert a.dtype == torch.float64 and a.shape == b.shape, key
        assert torch.equal(a, b), key
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jax_model, key)), err_msg=key)


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_digest_agrees_with_jax(name):
    make_jax, make_port = CATALOG[name]
    digest = jax_host_arrays(make_jax())["digest"]
    assert host_arrays(make_port())["digest"] == digest
    assert host_arrays(from_host_arrays(jax_host_arrays(make_jax()), device=CPU))["digest"] == digest


def test_import_never_loads_jax():
    code = (
        "import sys\n"
        "import manipulapy_tpu_torch as m\n"
        "from manipulapy_tpu_torch import core, models, kinematics, dynamics, trajectory, ops\n"
        "from manipulapy_tpu_torch.core import lie, time_scaling\n"
        "from manipulapy_tpu_torch.models import robot, catalog\n"
        "from manipulapy_tpu_torch.ops import cgen, fd_step, smallinalg, dispatch, cuda_rollout, _build\n"
        "from manipulapy_tpu_torch.ops import cuda_mpc_batch, cuda_mpc_single\n"
        "from manipulapy_tpu_torch import mpc\n"
        "from manipulapy_tpu_torch.mpc import costs, ilqr, fused_batch, fused\n"
        "from manipulapy_tpu_torch.ops import elementwise\n"
        "from manipulapy_tpu_torch import potential_field, planner, control, singularity\n"
        "from manipulapy_tpu_torch import sim, ik, ik_cache, trac_ik, parallel\n"
        "from manipulapy_tpu_torch.mpc import pscan\n"
        "from manipulapy_tpu_torch.parallel import mesh, fleet, fused_fleet\n"
        "assert m.parallel is parallel and m.sim is sim and m.ik is ik\n"
        "assert m.create_planner is planner.create_planner and m.TrajectoryPlanner is planner.TrajectoryPlanner\n"
        "import torch\n"
        "catalog.ur5(device='cpu')\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'manipulapy_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_host_arrays_dtype_and_missing_keys():
    host = jax_host_arrays(jax_catalog.ur5(dtype=jnp.float64))
    model = from_host_arrays(host, dtype=torch.float32, device=CPU)
    assert model.dtype == torch.float32 and model.num_joints == 6
    assert model.device == CPU
    partial = {k: v for k, v in host.items() if k != "inertias"}
    with pytest.raises(KeyError):
        from_host_arrays(partial)


def test_factories_default_to_the_card():
    """With no device named, every factory builds on ``cuda``; a host
    without a card raises CUDA's own error rather than falling back."""
    host = jax_host_arrays(jax_catalog.ur5(dtype=jnp.float64))
    factories = (
        catalog.ur5,
        lambda: catalog.get_robot("panda"),
        lambda: from_host_arrays(host),
        lambda: make_robot_model(np.eye(4), np.eye(6)[:2]),
    )
    for make in factories:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
    assert catalog.ur5(device="cpu").device == CPU
    assert catalog.ur5(device="cpu").to(dtype=torch.float64).device == CPU


def test_to_keeps_host_arrays_and_digest():
    model = catalog.ur5(dtype=torch.float64, device=CPU)
    moved = model.to(dtype=torch.float32)
    assert moved.dtype == torch.float32
    assert host_arrays(moved)["digest"] == host_arrays(model)["digest"]
    np.testing.assert_array_equal(host_arrays(moved)["screws_space"], model.screws_space.numpy())


def test_replace_derivative_misses_registry():
    model = catalog.ur5(dtype=torch.float64, device=CPU)
    tighter = dataclasses.replace(model, joint_lower=model.joint_lower * 0.5)
    assert host_arrays(tighter) is None


def test_registry_evicts_with_model():
    from manipulapy_tpu_torch.models import robot

    model = catalog.panda(device=CPU)
    key = id(model)
    assert key in robot._HOST_ARRAYS
    del model
    gc.collect()
    assert key not in robot._HOST_ARRAYS


def test_registry_copies_are_immutable():
    S = np.eye(6)[:2].copy()
    model = make_robot_model(np.eye(4), S, dtype=torch.float64, device=CPU)
    S[0, 0] = 5.0
    host = host_arrays(model)
    assert host["screws_space"][0, 0] == 1.0
    with pytest.raises(ValueError):
        host["screws_space"][0, 0] = 2.0


def test_make_robot_model_layout_and_defaults():
    S = np.array([[0, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0.3]], dtype=float)
    rows = make_robot_model(np.eye(4), S, dtype=torch.float64, device=CPU)
    cols = make_robot_model(np.eye(4), S.T, layout="cols", dtype=torch.float64, device=CPU)
    assert torch.equal(rows.screws_space, cols.screws_space)
    assert torch.equal(rows.inertias, torch.eye(6, dtype=torch.float64).expand(2, 6, 6))
    assert torch.isinf(rows.joint_lower).all() and torch.isinf(rows.velocity_limit).all()
    with pytest.raises(ValueError):
        make_robot_model(np.eye(4), S.T, dtype=torch.float64, device=CPU)


def test_get_robot_and_list():
    assert catalog.list_robots() == ["panda", "two_link_planar", "ur5"]
    assert catalog.get_robot("UR5", device=CPU).num_joints == 6
    with pytest.raises(KeyError):
        catalog.get_robot("no_such_robot")
