"""The port's checkpoints (``manipulapy_tpu_torch/utils/checkpoint.py``)
against the JAX package's: the same tree, made from a seeded NumPy
generator, saved by both gives the same ``leaf_*`` arrays byte for byte and
the same ``"dtypes"`` record; then the port's own round trip, rotation,
atomic write, a generator's state, and a batched solve resumed from a
checkpoint, bitwise the uninterrupted run."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.mpc.ilqr import ILQRResult as JaxILQRResult
from manipulapy_tpu.utils import checkpoint as jax_checkpoint
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused_batch import batch_mpc_step, build_batch_tracking_mpc
from manipulapy_tpu_torch.mpc.ilqr import ILQRResult
from manipulapy_tpu_torch.utils import CheckpointManager, load_checkpoint, save_checkpoint

CPU = "cpu"


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "c": rng.standard_normal(5),  # float64
        "d": rng.standard_normal((4, 2)).astype(np.float32),
        "flag": np.asarray([True, False, True]),
    }


def _trees(kind):
    """(JAX tree, port tree) of one shape, the same values."""
    a = _arrays()
    J = lambda x: jnp.asarray(x)
    T = torch.from_numpy
    if kind == "dict":
        mk = lambda f: {"us": f(a["a"]), "steps": f(a["b"]), "nested": {"z": f(a["c"]), "ok": f(a["flag"])}}
        return mk(J), mk(T)
    if kind == "namedtuple":
        mk = lambda cls, f: cls(xs=f(a["a"]), us=f(a["d"]), cost=f(np.float32(3.5)), gains_K=f(a["c"]),
                                converged=f(np.asarray(True)))
        return mk(JaxILQRResult, J), mk(ILQRResult, lambda x: torch.as_tensor(np.asarray(x)))
    if kind == "list_with_none":
        mk = lambda f: [f(a["a"]), [f(a["b"]), None, (f(a["c"]), f(a["d"]))], None, {"k": None, "v": f(a["flag"])}]
        return mk(J), mk(T)
    if kind == "scalars":
        tree = {"reg": 1e-3, "round": 7, "ok": True, "x": None}
        return dict(tree), dict(tree)
    if kind == "bfloat16":
        bf = a["a"] * 3.0
        return (
            {"us": jnp.asarray(bf, jnp.bfloat16), "scale": jnp.asarray(0.3, jnp.bfloat16), "f32": J(a["d"])},
            {"us": torch.from_numpy(bf).to(torch.bfloat16), "scale": torch.tensor(0.3).to(torch.bfloat16),
             "f32": T(a["d"])},
        )
    raise ValueError(kind)


def _entries(path):
    with np.load(path, allow_pickle=False) as z:
        leaves = {k: z[k] for k in z.files if k.startswith("leaf_")}
        blob = json.loads(z["__meta_json__"].tobytes().decode())
    return leaves, blob


@pytest.mark.parametrize("kind", ["dict", "namedtuple", "list_with_none", "scalars", "bfloat16"])
def test_leaf_bytes_and_dtypes_equal_jax(tmp_path, kind):
    jax_tree, port_tree = _trees(kind)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax.npz"), jax_tree, meta={"step": 3})
    save_checkpoint(str(tmp_path / "port.npz"), port_tree, meta={"step": 3})
    jl, jb = _entries(tmp_path / "jax.npz")
    pl, pb = _entries(tmp_path / "port.npz")
    assert sorted(jl) == sorted(pl) and len(pl) > 0
    for k in jl:
        assert jl[k].dtype == pl[k].dtype and jl[k].shape == pl[k].shape, k
        assert jl[k].tobytes() == pl[k].tobytes(), k
    assert jb == pb  # {"meta", "dtypes"}


@pytest.mark.parametrize("kind", ["dict", "namedtuple", "list_with_none", "scalars", "bfloat16"])
def test_round_trip(tmp_path, kind):
    _, tree = _trees(kind)
    path = save_checkpoint(str(tmp_path / "sub" / "c.npz"), tree, meta={"note": "x"})
    out, meta = load_checkpoint(path, with_meta=True, device=CPU)
    assert meta == {"note": "x"}

    def same(a, b):
        if b is None:
            assert a is None
        elif isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            ref = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))  # a scalar's numpy dtype
            assert isinstance(a, torch.Tensor) and a.device.type == CPU
            assert a.dtype == ref.dtype and a.shape == ref.shape
            bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert torch.equal(bits(a), bits(ref))

    same(out, tree)


def test_load_refuses_a_jax_file(tmp_path):
    jax_checkpoint.save_checkpoint(str(tmp_path / "j.npz"), {"x": jnp.ones(2)})
    with pytest.raises(ValueError, match="JAX"):
        load_checkpoint(str(tmp_path / "j.npz"), device=CPU)


def test_manager_rotation_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore_latest(device=CPU) == (None, None)
    for step in range(5):
        mgr.save(step, {"x": torch.tensor(float(step))})
    assert mgr.all_steps() == [3, 4]
    step, tree = mgr.restore_latest(device=CPU)
    assert step == 4 and float(tree["x"]) == 4.0
    assert float(mgr.restore(3, device=CPU)["x"]) == 3.0
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_write_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"x": torch.ones(3)})

    def fail(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, {"x": torch.zeros(3)})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["c.npz"]  # no temporary file left
    assert torch.equal(load_checkpoint(path, device=CPU)["x"], torch.ones(3))  # the old file is whole


def test_generator_state_resumes_its_draws(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    save_checkpoint(str(tmp_path / "g.npz"), {"gen": gen.get_state()})
    expected = torch.rand(7, generator=gen)
    other = torch.Generator().manual_seed(0)
    other.set_state(load_checkpoint(str(tmp_path / "g.npz"), device=CPU)["gen"])
    assert torch.equal(torch.rand(7, generator=other), expected)


def test_batched_solve_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Two-link arm, plain versions: 3 rounds, a checkpoint (state, warm
    start, round, generator, a bf16 copy), a freshly built solver, 2 more
    rounds; bitwise 5 rounds in one go."""
    B, H = 4, 5
    model = catalog.two_link_planar(device=CPU)
    rng = np.random.default_rng(0)
    goals = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32))
    x0 = torch.from_numpy(np.concatenate([rng.uniform(-1.0, 1.0, (B, 2)), np.zeros((B, 2))], 1).astype(np.float32))
    build = lambda: build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=2)

    def rounds(mpc, x, us_warm, gen, count):
        for _ in range(count):
            _, us_warm, (us, xs, cost) = batch_mpc_step(mpc, x, us_warm)
            x = xs[:, 1] + 1e-3 * torch.randn(x.shape, generator=gen)  # a disturbance
        return x, us_warm, (us, xs, cost)

    us0 = torch.zeros((B, H, 2))
    ref = rounds(build(), x0, us0, torch.Generator().manual_seed(5), 5)

    gen = torch.Generator().manual_seed(5)
    x, us_warm, _ = rounds(build(), x0, us0, gen, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": x, "us_warm": us_warm, "round": 3, "gen": gen.get_state(),
                 "us_bf16": us_warm.to(torch.bfloat16)})
    step, state = mgr.restore_latest(device=CPU)
    assert step == 3 and int(state["round"]) == 3
    assert torch.equal(state["us_bf16"].view(torch.int16), us_warm.to(torch.bfloat16).view(torch.int16))
    resumed_gen = torch.Generator()
    resumed_gen.set_state(state["gen"])
    got = rounds(build(), state["x"], state["us_warm"], resumed_gen, 2)
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]):
        assert torch.equal(g, r)
