"""The port's small utilities against the JAX package: the Burgers PINN
residual (`tasks/burgers/pinn.py`: the one-step FD reconstruction, its loss
and its gradient by autograd), the step timer and JSONL metrics logger and
the torch.profiler trace (`utils/profiling.py`), and the plots and vis-data
dumps (`utils/visualization.py`; the plotting tests skip where matplotlib is
absent)."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.burgers import pinn as JPINN
from safediffcon_tpu.utils import profiling as JPROF
from safediffcon_torch.tasks.burgers import pinn as TPINN
from safediffcon_torch.utils import profiling as TPROF
from safediffcon_torch.utils import visualization as V

torch.set_num_threads(1)


def _trajectory(seed=0):
    """A (2, 16, 128, 3) trajectory tensor: smooth u over the 11 rows, f on
    10, noise in the padding rows and the s channel."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, 130)[1:-1]
    t = np.linspace(0, 1, 11)[:, None]
    traj = rng.normal(scale=0.1, size=(2, 16, 128, 3)).astype(np.float32)
    traj[0, :11, :, 0] = 0.3 * np.sin(2 * np.pi * (x - 0.1 * t))
    traj[1, :11, :, 0] = 0.3 * np.cos(2 * np.pi * x) * np.exp(-t)
    traj[:, :10, :, 1] = rng.normal(scale=0.05, size=(2, 10, 128))
    return traj


@pytest.mark.parametrize("mode", ["mean", "forward", "backward"])
@pytest.mark.parametrize("partial", [None, "mid"])
def test_pinn_loss_matches_jax(mode, partial):
    x = _trajectory()
    u, f = x[:, :11, :, 0], x[:, :10, :, 1]
    ref = JPINN.pinn_loss(jnp.asarray(u), jnp.asarray(f), mode=mode, partially_observed=partial)
    got = TPINN.pinn_loss(torch.from_numpy(u), torch.from_numpy(f), mode=mode,
                          partially_observed=partial)
    # float32 stencils and one mean: 1e-6 relative
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        TPINN.one_step_solver_u(torch.from_numpy(u), torch.from_numpy(f), mode=mode).numpy(),
        np.asarray(JPINN.one_step_solver_u(jnp.asarray(u), jnp.asarray(f), mode=mode)),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        TPINN.one_step_solver_u(torch.from_numpy(u), torch.from_numpy(f), mode="central")


@pytest.mark.parametrize("mode", ["mean", "forward"])
def test_residual_gradient_matches_jax(mode):
    x = _trajectory(1)
    ref = np.asarray(JPINN.residual_gradient(jnp.asarray(x), mode=mode))
    got = TPINN.residual_gradient(torch.from_numpy(x), mode=mode).numpy()
    assert got.shape == x.shape and np.abs(ref).max() > 0
    # d(mean of squares)/dx through the stencils, by autograd on both sides:
    # 1e-6 of the largest entry
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    assert not got[:, 11:].any() and not got[..., 2].any()  # padding rows and s: no gradient


def test_step_timer_like_jax():
    for cls in (TPROF.StepTimer, JPROF.StepTimer):
        t = cls(window=4)
        assert t.steps_per_sec == 0.0
        for _ in range(6):
            t.tick()
        assert t.steps_per_sec > 0 and t.count == 6 and len(t._recent) == 4
        assert t.total > 0


def test_metrics_logger_like_jax(tmp_path):
    lines = {}
    for name, cls in (("torch", TPROF.MetricsLogger), ("jax", JPROF.MetricsLogger)):
        p = str(tmp_path / name / "m.jsonl")
        ml = cls(p)
        ml.log(1, loss=0.5)
        ml.log(2, loss=torch.tensor(0.25), lr=1e-4)
        ml.close()
        with open(p) as f:
            lines[name] = [json.loads(line) for line in f]
    for a, b in zip(lines["torch"], lines["jax"], strict=True):
        assert a.keys() == b.keys() and {k: a[k] for k in a if k != "time"} == \
            {k: b[k] for k in b if k != "time"}
    TPROF.MetricsLogger().log(3, loss=1.0)  # no path: the logging mirror only


def test_trace_writes_a_chrome_trace(tmp_path):
    with TPROF.trace(None):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    with TPROF.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_write_png_files(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    assert _is_png(V.plot_tokamak_trajectories(
        rng.normal(1.5, 0.1, size=(122, 3)), states_solver=rng.normal(1.5, 0.1, size=(122, 3)),
        targets=(1.8, 5.2, 1.0), path=str(tmp_path / "t.png")))
    assert _is_png(V.plot_burgers_trajectory(rng.normal(size=(11, 128)),
                                             rng.normal(size=(10, 128)),
                                             path=str(tmp_path / "u.png")))
    assert _is_png(V.plot_smoke_frames(rng.uniform(size=(8, 16, 16, 7)), frames=(0, 4, 7),
                                       path=str(tmp_path / "s.png")))


def test_kstar_boundary_plot(tmp_path):
    pytest.importorskip("matplotlib")
    from safediffcon_torch.solvers import kstar

    params = kstar.load_kstar_params(device="cpu")
    assert _is_png(V.plot_kstar_boundary(params, path=str(tmp_path / "b.png")))


def test_dump_vis_data_needs_only_numpy(tmp_path):
    p = V.dump_vis_data(str(tmp_path), 3, outputs=np.ones((4, 2)), controls=torch.zeros(3))
    z = np.load(p)
    assert z["outputs"].shape == (4, 2) and z["controls"].shape == (3,)


def test_plotting_without_matplotlib_raises_import_error(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="dump_vis_data"):
        V.plot_burgers_trajectory(np.zeros((11, 128)))
