"""The port's robot catalogs against the JAX package's.

* The port's own copy of the vendored reference URDFs
  (``manipulapy_tpu_torch/data/robots/``): every file's sha256 and size as
  its ``PROVENANCE.md`` row says, and byte for byte the JAX package's copy.
* The calibrated catalog (``models/robot_data.py``): for every robot, and
  for the Panda arm without its finger, the f64 host arrays and the
  digest equal the JAX package's bit for bit; ``from_host_arrays`` of them
  rebuilds the same tensors.
* The DH-generated catalog (``models/data.py``): every URDF document byte
  for byte the JAX package's, and every model's host arrays and digest.
* ``catalog.get_robot(name, source=...)`` resolves every name of the three
  catalogs (and the calibrated aliases) to the JAX package's robot under
  each source, with the ``"auto"`` order calibrated, programmatic, DH;
  ``register_robot``, ``list_robots``, the listing functions and
  ``load_robot``'s cache.

Everything is built on the CPU in f64.
"""

import dataclasses
import hashlib
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manipulapy_tpu.models as jax_models
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models import data as jax_data
from manipulapy_tpu.models import robot_data as jax_robot_data
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
import manipulapy_tpu_torch.models as models
from manipulapy_tpu_torch.models import HOST_ARRAY_KEYS, catalog, data, from_host_arrays, host_arrays, robot_data

CPU = torch.device("cpu")
F64 = dict(dtype=torch.float64, device=CPU)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DATA = os.path.join(REPO, "manipulapy_tpu_torch", "data", "robots")
JAX_DATA = os.path.join(REPO, "manipulapy_tpu", "data", "robots")
PANDA_ARM = dict(tip_link="panda_hand", chain_joints_only=True)


def assert_same_robot(port_model, jax_model):
    """Host arrays bit for bit (inf in the same places) and the digest."""
    hp, hj = host_arrays(port_model), jax_host_arrays(jax_model)
    assert hp is not None and hj is not None
    assert hp["digest"] == hj["digest"]
    for k in HOST_ARRAY_KEYS:
        np.testing.assert_array_equal(hp[k], hj[k], err_msg=k)
    rebuilt = from_host_arrays(hp, dtype=port_model.dtype, device=CPU)
    assert host_arrays(rebuilt)["digest"] == hp["digest"]
    for k in HOST_ARRAY_KEYS:
        assert torch.equal(getattr(rebuilt, k), getattr(port_model, k)), k


def _provenance_rows():
    rows = {}
    with open(os.path.join(PORT_DATA, "PROVENANCE.md"), encoding="utf-8") as f:
        for line in f:
            m = re.match(r"^\| (\S+\.urdf) \| ([0-9a-f]{64}) \| (\d+) \|$", line.strip())
            if m:
                rows[m.group(1)] = (m.group(2), int(m.group(3)))
    return rows


def _files_under(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
        if not f.endswith((".pyc",))
    )


def test_data_copy_matches_provenance_and_jax_copy():
    rows = _provenance_rows()
    files = _files_under(PORT_DATA)
    assert files == _files_under(JAX_DATA)
    assert sorted(rows) == [f for f in files if f != "PROVENANCE.md"]
    assert len(rows) == 28
    for rel, (sha, size) in rows.items():
        with open(os.path.join(PORT_DATA, rel), "rb") as f:
            blob = f.read()
        assert hashlib.sha256(blob).hexdigest() == sha, rel
        assert len(blob) == size, rel
    for rel in files:
        with open(os.path.join(PORT_DATA, rel), "rb") as a, open(os.path.join(JAX_DATA, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_urdf_paths_resolve_to_the_port_copy():
    for key in robot_data.list_robots(include_aliases=True):
        path = robot_data.get_robot_urdf(key)
        assert path.startswith(PORT_DATA + os.sep), path
        assert os.path.relpath(path, PORT_DATA) == os.path.relpath(jax_robot_data.get_robot_urdf(key), JAX_DATA)


@pytest.mark.parametrize("name", jax_robot_data.list_robots())
def test_calibrated_host_arrays_match_jax(name):
    assert_same_robot(robot_data.load_robot(name, **F64), jax_robot_data.load_robot(name, dtype=jnp.float64))


def test_panda_arm_host_arrays_match_jax():
    arm = robot_data.load_robot("panda", **F64, **PANDA_ARM)
    assert arm.num_joints == 7
    assert_same_robot(arm, jax_robot_data.load_robot("panda", dtype=jnp.float64, **PANDA_ARM))


def test_calibrated_shapes_the_kernels_meet():
    """The Panda's eighth joint is its prismatic finger, [0, 0.04] m at
    0.2 m/s; the Gen3 has no position limit on joints 1, 3, 5 and 7."""
    panda = robot_data.load_robot("panda", **F64)
    assert panda.num_joints == 8
    assert float(panda.joint_lower[7]) == 0.0 and float(panda.joint_upper[7]) == 0.04
    assert float(panda.velocity_limit[7]) == 0.2
    assert float(panda.screws_space[7, :3].norm()) == 0.0  # no rotation: prismatic
    gen3 = robot_data.load_robot("gen3", **F64)
    unlimited = torch.isinf(gen3.joint_lower) & torch.isinf(gen3.joint_upper)
    assert unlimited.tolist() == [True, False, True, False, True, False, True]


@pytest.mark.parametrize("name", jax_data.list_robots())
def test_dh_urdf_string_matches_jax(name):
    assert data.robot_urdf_string(name) == jax_data.robot_urdf_string(name)


@pytest.mark.parametrize("name", jax_data.list_robots())
def test_dh_host_arrays_match_jax(name):
    assert_same_robot(data.load_robot(name, **F64), jax_data.load_robot(name, dtype=jnp.float64))


def _cases():
    out = [("calibrated", k) for k in jax_robot_data.list_robots(include_aliases=True)]
    out += [("dh", k) for k in jax_data.list_robots()]
    out += [("programmatic", k) for k in ("ur5", "panda", "two_link_planar")]
    names = set(jax_catalog.list_robots()) | set(jax_robot_data.list_robots(include_aliases=True))
    out += [("auto", k) for k in sorted(names)]
    return out


@pytest.mark.parametrize("source,name", _cases())
def test_get_robot_resolves_as_jax(source, name):
    port = catalog.get_robot(name.upper(), source=source, **F64)
    ref = jax_catalog.get_robot(name.upper(), source=source, dtype=jnp.float64)
    assert_same_robot(port, ref)
    if source == "auto" and name in robot_data.ROBOT_DATABASE:
        assert port is robot_data.load_robot(name, **F64)  # calibrated first, one cached object


def test_auto_order_and_errors():
    ur5 = host_arrays(catalog.get_robot("ur5", **F64))["digest"]
    assert ur5 == host_arrays(robot_data.load_robot("ur5", **F64))["digest"]
    assert ur5 != host_arrays(catalog.ur5(**F64))["digest"]
    assert ur5 != host_arrays(data.load_robot("ur5", **F64))["digest"]
    # two_link_planar is programmatic only; z1 is DH only
    assert host_arrays(catalog.get_robot("two_link_planar", **F64))["digest"] == \
        host_arrays(catalog.two_link_planar(**F64))["digest"]
    assert host_arrays(catalog.get_robot("z1", **F64))["digest"] == host_arrays(data.load_robot("z1", **F64))["digest"]
    with pytest.raises(KeyError, match="Unknown robot"):
        catalog.get_robot("no_such_robot", device=CPU)
    with pytest.raises(ValueError, match="Unknown source"):
        catalog.get_robot("ur5", source="nominal", device=CPU)
    with pytest.raises(KeyError):
        catalog.get_robot("z1", source="calibrated", device=CPU)


@pytest.fixture
def no_vendored_data(monkeypatch, tmp_path):
    """The package's data copy absent: an empty first root, no env root,
    and cold caches (cleared again afterwards)."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setattr(robot_data, "_VENDORED", empty)
    monkeypatch.delenv("MANIPULAPY_TPU_DATA", raising=False)
    robot_data._extract.cache_clear()
    robot_data._build_model_cached.cache_clear()
    yield tmp_path
    robot_data._extract.cache_clear()
    robot_data._build_model_cached.cache_clear()


def test_auto_falls_through_when_the_data_is_missing(no_vendored_data):
    """JAX's order when a calibrated file is missing: the programmatic
    factory, then the DH catalog; ``"calibrated"`` raises."""
    with pytest.raises(FileNotFoundError):
        robot_data.get_robot_urdf("ur5")
    with pytest.raises(FileNotFoundError):
        catalog.get_robot("ur5", source="calibrated", **F64)
    assert host_arrays(catalog.get_robot("ur5", **F64))["digest"] == host_arrays(catalog.ur5(**F64))["digest"]
    assert host_arrays(catalog.get_robot("gen3", **F64))["digest"] == host_arrays(data.load_robot("gen3", **F64))["digest"]


def test_env_data_root_is_second(no_vendored_data, monkeypatch):
    root = no_vendored_data / "env_root"
    rel = jax_robot_data.ROBOT_DATABASE["ur5"].urdf
    os.makedirs(root / os.path.dirname(rel))
    shutil.copyfile(os.path.join(PORT_DATA, rel), root / rel)
    monkeypatch.setenv("MANIPULAPY_TPU_DATA", str(root))
    assert robot_data.get_robot_urdf("ur5") == str(root / rel)
    assert_same_robot(robot_data.load_robot("ur5", **F64), jax_robot_data.load_robot("ur5", dtype=jnp.float64))
    with pytest.raises(FileNotFoundError):
        robot_data.get_robot_urdf("panda")


def test_register_robot_and_list_robots(monkeypatch):
    monkeypatch.setattr(catalog, "_REGISTRY", dict(catalog._REGISTRY))
    monkeypatch.setattr(jax_catalog, "_REGISTRY", dict(jax_catalog._REGISTRY))
    catalog.register_robot("Chain_4", lambda **kw: catalog.serial_chain(4, **kw))
    jax_catalog.register_robot("Chain_4", lambda **kw: jax_catalog.serial_chain(4, **kw))
    assert catalog.list_robots() == jax_catalog.list_robots()
    assert "chain_4" in catalog.list_robots()
    for source in ("programmatic", "auto"):
        assert_same_robot(
            catalog.get_robot("chain_4", source=source, **F64),
            jax_catalog.get_robot("chain_4", source=source, dtype=jnp.float64),
        )
    # a registered name never shadows a calibrated one under "auto"
    catalog.register_robot("ur5", lambda **kw: catalog.two_link_planar(**kw))
    assert catalog.get_robot("ur5", **F64).num_joints == 6
    assert catalog.get_robot("ur5", source="programmatic", **F64).num_joints == 2


def test_load_robot_caches_one_object_per_key():
    a = robot_data.load_robot("panda", **F64)
    assert robot_data.load_robot("PANDA", **F64) is a
    assert robot_data.load_robot("franka_panda", **F64) is not a  # its own key, the same robot
    assert host_arrays(robot_data.load_robot("franka_panda", **F64))["digest"] == host_arrays(a)["digest"]
    f32 = robot_data.load_robot("panda", device=CPU)
    assert f32.dtype == torch.float32 and f32 is not a
    assert robot_data.load_robot("panda", dtype=torch.float32, device="cpu") is f32
    arm = robot_data.load_robot("panda", **F64, **PANDA_ARM)
    assert arm is not a and arm.num_joints == 7
    hand = robot_data.load_robot("panda", **F64, tip_link="panda_hand")
    assert hand.num_joints == 8 and hand is not arm
    with pytest.raises(KeyError, match="Unknown robot"):
        robot_data.load_robot("terminator", device=CPU)


def test_listing_functions_match_jax(capsys):
    for aliases in (False, True):
        assert robot_data.list_robots(aliases) == jax_robot_data.list_robots(aliases)
        for dof in (1, 6, 7):
            assert robot_data.get_robots_by_dof(dof, aliases) == jax_robot_data.get_robots_by_dof(dof, aliases)
    assert data.list_robots() == jax_data.list_robots()
    for dof in (6, 7):
        assert data.get_robots_by_dof(dof) == jax_data.get_robots_by_dof(dof)
    for name in data.list_robots():
        assert dataclasses.asdict(data.get_robot_info(name)) == dataclasses.asdict(jax_data.get_robot_info(name))
    for port_mod, jax_mod in ((robot_data, jax_robot_data), (data, jax_data)):
        port_mod.print_robot_catalog()
        ours = capsys.readouterr().out
        jax_mod.print_robot_catalog()
        assert ours == capsys.readouterr().out
    assert set(jax_models.__all__) <= set(models.__all__)
    assert models.load_robot is data.load_robot and models.get_robot_urdf is robot_data.get_robot_urdf
    assert models.get_robots_by_dof is data.get_robots_by_dof
    assert models.print_robot_catalog is data.print_robot_catalog


def test_dh_urdf_files(tmp_path):
    path = data.get_robot_urdf("ur5")
    assert os.path.basename(os.path.dirname(path)) == "manipulapy_tpu_torch_urdf"
    with open(path, encoding="utf-8") as f:
        assert f.read() == jax_data.robot_urdf_string("ur5")
    own = data.get_robot_urdf("panda", directory=str(tmp_path))
    assert own == str(tmp_path / "panda.urdf")
    assert (tmp_path / "panda.urdf").read_text(encoding="utf-8") == jax_data.robot_urdf_string("panda")
    with pytest.raises(KeyError):
        data.get_robot_urdf("no_such_robot")
