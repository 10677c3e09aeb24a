"""The port's plotting (``manipulapy_tpu_torch/plotting.py``) against the JAX
package's: each of the six figures, built from the same seeded arrays (CPU
tensors for the port, NumPy for JAX), has equal line, scatter and surface
data and equal titles and labels; and importing the module does not import
matplotlib."""

import os
import subprocess
import sys
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from manipulapy_tpu import plotting as jplot  # noqa: E402
from manipulapy_tpu.singularity import Ellipsoid as JaxEllipsoid  # noqa: E402
from manipulapy_tpu_torch import plotting as tplot  # noqa: E402
from manipulapy_tpu_torch.singularity import Ellipsoid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _figure_data(fig):
    """Every axes' title and labels, its lines' data and labels, its
    collections' offsets (3-D where they have them) and its surfaces'
    vertices; the figure's suptitle."""
    out = {"suptitle": fig._suptitle.get_text() if fig._suptitle else None, "axes": []}
    for ax in fig.axes:
        lines = []
        for ln in ax.get_lines():
            data = np.asarray(ln.get_data_3d()) if hasattr(ln, "get_data_3d") else ln.get_xydata()
            lines.append((ln.get_label(), np.asarray(data, dtype=np.float64)))
        cols = []
        for c in ax.collections:
            if hasattr(c, "_offsets3d"):
                cols.append(("offsets3d", np.asarray([np.asarray(v, dtype=np.float64) for v in c._offsets3d])))
            elif hasattr(c, "_vec"):
                cols.append(("surface", np.asarray(c._vec, dtype=np.float64)))
            else:
                cols.append(("offsets", np.asarray(c.get_offsets(), dtype=np.float64)))
        labels = (ax.get_xlabel(), ax.get_ylabel(), getattr(ax, "get_zlabel", lambda: None)())
        out["axes"].append({"title": ax.get_title(), "labels": labels, "lines": lines, "collections": cols})
    return out


def _assert_same(fig_port, fig_jax):
    a, b = _figure_data(fig_port), _figure_data(fig_jax)
    plt.close(fig_port)
    plt.close(fig_jax)
    assert a["suptitle"] == b["suptitle"] and len(a["axes"]) == len(b["axes"]) > 0
    for x, y in zip(a["axes"], b["axes"]):
        assert x["title"] == y["title"] and x["labels"] == y["labels"]
        assert [n for n, _ in x["lines"]] == [n for n, _ in y["lines"]]
        for (_, d1), (_, d2) in zip(x["lines"], y["lines"]):
            np.testing.assert_array_equal(d1, d2)
        assert [k for k, _ in x["collections"]] == [k for k, _ in y["collections"]]
        for (_, d1), (_, d2) in zip(x["collections"], y["collections"]):
            np.testing.assert_array_equal(d1, d2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    traj = {k: rng.standard_normal((40, 3)).astype(np.float32) for k in ("position", "velocity", "acceleration")}
    t = np.linspace(0.0, 2.0, 200)
    y = 1.0 - np.exp(-3.0 * t) * np.cos(6.0 * t)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return dict(traj=traj, ee=rng.standard_normal((30, 3)), t=t, y=y, radii=rng.uniform(0.1, 1.0, 3), axes=q,
                points=rng.standard_normal((500, 3)))


def _traj(d, tensor):
    f = torch.from_numpy if tensor else (lambda x: x)
    return SimpleNamespace(**{k: f(v) for k, v in d["traj"].items()})


def test_plot_trajectory(data):
    _assert_same(tplot.plot_trajectory(_traj(data, True), Tf=2.0, title="t", joint_names=["a", "b", "c"]),
                 jplot.plot_trajectory(_traj(data, False), Tf=2.0, title="t", joint_names=["a", "b", "c"]))
    _assert_same(tplot.plot_trajectory(_traj(data, True)), jplot.plot_trajectory(_traj(data, False)))


def test_plot_ee_trajectory(data):
    _assert_same(tplot.plot_ee_trajectory(torch.from_numpy(data["ee"])), jplot.plot_ee_trajectory(data["ee"]))


def test_plot_cartesian_trajectory(data):
    _assert_same(tplot.plot_cartesian_trajectory(_traj(data, True), Tf=3.0),
                 jplot.plot_cartesian_trajectory(_traj(data, False), Tf=3.0))


def test_plot_step_response_default_metrics(data):
    """The metrics come from each package's own ``step_response_metrics``."""
    t, y = data["t"], data["y"]
    fig_port = tplot.plot_step_response(torch.from_numpy(t), torch.from_numpy(y), torch.tensor(1.0))
    fig_jax = jplot.plot_step_response(t, y, 1.0)
    assert "overshoot" in fig_port.axes[0].get_title()
    _assert_same(fig_port, fig_jax)
    metrics = {"rise_time": 0.25, "settling_time": float("nan")}
    _assert_same(tplot.plot_step_response(torch.from_numpy(t), torch.from_numpy(y[:, None]), 1.0, metrics=metrics),
                 jplot.plot_step_response(t, y[:, None], 1.0, metrics=metrics))


def test_plot_manipulability_ellipsoid(data):
    ell = Ellipsoid(radii=torch.from_numpy(data["radii"]), axes=torch.from_numpy(data["axes"]))
    jell = JaxEllipsoid(radii=data["radii"], axes=data["axes"])
    _assert_same(tplot.plot_manipulability_ellipsoid(ell, center=torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)),
                 jplot.plot_manipulability_ellipsoid(jell, center=(0.1, 0.2, 0.3)))


def test_plot_workspace_subsamples(data):
    _assert_same(tplot.plot_workspace(torch.from_numpy(data["points"]), max_points=100),
                 jplot.plot_workspace(data["points"], max_points=100))
    _assert_same(tplot.plot_workspace(torch.from_numpy(data["points"])), jplot.plot_workspace(data["points"]))


def test_import_does_not_load_matplotlib():
    code = (
        "import sys\n"
        "from manipulapy_tpu_torch import plotting\n"
        "assert 'matplotlib' not in sys.modules, sorted(k for k in sys.modules if 'matplotlib' in k)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
