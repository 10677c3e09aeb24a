"""Every public name of the JAX package has its counterpart in the port.

Both trees are read with ``ast``; neither package is imported. A module's
public names are its top-level functions, classes and assigned names that
do not start with an underscore, and the public members of its public
classes (methods, properties, fields, class attributes), as
``Class.member``. Each JAX module is held against the port module of the
same path, except the two Pallas modules, whose counterparts are the CUDA
ones. The port may have more names; it may lack only ``ALLOWED``, the
divergences that are meant, and each of those must still be missing, so
the list cannot outlive its reason.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "manipulapy_tpu", REPO / "manipulapy_tpu_torch"
# The Pallas modules' counterparts: their entry points are TPU kernels, and
# the port's CUDA modules name theirs after the card.
RENAMED = {"ops/pallas_kernels.py": "ops/elementwise.py", "ops/pallas_rollout.py": "ops/cuda_rollout.py"}
ALLOWED = {
    # An AOT artifact is the build arguments plus the built libraries; no
    # jitted executable to save (ROADMAP, "Runtime layer").
    "utils/aot.py": {"save_jitted"},
    # The Pallas size threshold of the JAX dispatcher.
    "ops/dispatch.py": {"MIN_PALLAS_ELEMENTS", "pallas_wanted"},
    "ops/pallas_kernels.py": {"cartesian_potential_pallas", "pallas_available", "trajectory_pallas"},
    "ops/pallas_rollout.py": {"build_pallas_rollout", "stage_batch", "unstage_batch"},
}


def _targets(node):
    for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def public_names(path: Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(n for n in _targets(node) if not n.startswith("_"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        members = [sub.name]
                    elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        members = list(_targets(sub))
                    else:
                        members = []
                    out.update(f"{node.name}.{m}" for m in members if not m.startswith("_"))
    return out


JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))


def test_the_walk_sees_both_packages():
    assert len(JAX_MODULES) > 40
    assert "RobotModel.astype" in public_names(JAX_ROOT / "models/robot.py")
    assert "RobotModel.joint_limits" in public_names(PORT_ROOT / "models/robot.py")


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_public_name(module):
    port = PORT_ROOT / RENAMED.get(module, module)
    assert port.exists(), f"no counterpart of manipulapy_tpu/{module}"
    missing = public_names(JAX_ROOT / module) - public_names(port)
    allowed = ALLOWED.get(module, set())
    assert missing == allowed, (
        f"{module}: missing {sorted(missing - allowed)}; allowed but present {sorted(allowed - missing)}"
    )
