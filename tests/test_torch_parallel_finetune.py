"""The fine-tuning phases split over two gloo ranks against one process, on
the CPU: Burgers `posttrain` and `inference_finetune`, tokamak
`run_inference` (post-training and the backward fine-tune) and smoke
`run_inference`: post-training from its device pool at dp 2, and the
backward fine-tune at sp 2 (the frames of the UNet3D split over the two
ranks, the batch whole on each). Each rank takes its rows of every
batch and of the global draws, eagerly, with every calibration and
evaluation of the phase; the one process runs the same phase from the
same seeds. Phase 13's tolerances (`chip_smoke.py`): losses and Q-hat
within 1e-5 relative, the weights within 2.5 learning rates (a first Adam
step moves an entry whose gradient is rounding by up to 2 lr), the metrics
within 1e-3 relative (a smoke percentage within one test sample); the two
ranks end on the same weights, bit for bit. The smoke phases calibrate
after their steps, so their Q-hat carries the weights' difference: Adam's
first step moves an entry by lr g / (|g| + 1e-8), whose rounding-level
gradients give differences up to ~2 lr, and on the dim-8 UNet3D these move
Q-hat by ~1e-4 relative at the recipes' lr of 1e-4 (one process at 1 and 3
threads: 5e-5). At lr 1e-6 the same rounding moves it by 1e-6 to 3e-6, so
the smoke cases take that lr and Q-hat is held at 1e-5. The backward loss
is held at 1e-3: it is the squared spatial mean of a sampled channel, 0.055
from values of order 1, on samples that rounding alone moves by 1.1e-3 of
their largest value (one process at 1 and 3 threads; DDIM from pure noise
amplifies the first x0 estimate), which moves the loss by 1e-5 to 1e-4 on
the split and across thread counts alike; a split that took other rows or
draws moves it by far more. (The captured route of the
Burgers and tokamak phases against this eager split:
`test_torch_nccl_capture.py`.)"""
import fcntl

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from safediffcon_torch.tasks.smoke import SmokeDataset, generate_smoke_dataset
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params
from test_torch_nccl_capture import _args, burgers_data, tokamak_data  # noqa: F401  (fixtures)
from test_torch_smoke_pipeline import CONF as S_CONF
from test_torch_smoke_pipeline import PIPE as S_PIPE
from test_torch_smoke_pipeline import RECORD_FRAMES, SPACE_SCALE

torch.set_num_threads(1)

LR = {"posttrain": 1e-3, "infft": 1e-3, "weighted": 1e-3, "backward": 1e-3}
# smoke: one epoch; post-training 2 steps of a batch of 2 from a pool of 4
S_INF = {"weighted": dict(finetune_epoch=1, finetune_steps=2, finetune_batch_size=2,
                          device_pool=4, finetune_lr=1e-6),
         "backward": dict(finetune_epoch=1, finetune_steps=1, finetune_lr=1e-6)}


# the smoke rollout stops at the solver's 1e-4 (`S_PIPE`), and a rank solves
# its own rows as one system: a metric near 0 agrees within a tenth of that
# (13(d): 1e-9 at 1e-8); the backward loss, see the module docstring
SMOKE_TOL = {"weighted": dict(metric_atol=1e-5),
             "backward": dict(metric_atol=1e-5, loss_tol=1e-3)}


TIME_SCALE = 4  # 16 solver frames per record of 4
S_PIPE = dict(S_PIPE, solver_time_scale=TIME_SCALE)


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    # generated once per pytest run for every xdist worker (the run's shared
    # temp root, under a lock)
    root = tmp_path_factory.getbasetemp().parent
    path = root / "parallel_finetune_smoke.npz"
    with open(root / "parallel_finetune_smoke.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = root / "parallel_finetune_smoke.tmp.npz"
            generate_smoke_dataset(str(tmp), n_train=4, n_cal=4, n_test=2,
                                   n_frames=RECORD_FRAMES * TIME_SCALE,
                                   record_frames=RECORD_FRAMES, space_scale=SPACE_SCALE,
                                   gen_batch=10, accuracy=1e-4, max_iter=80, device="cpu")
            tmp.rename(path)
    return {s: SmokeDataset.load(str(path), s) for s in ("train", "cal", "test")}


def _smoke_args(part, data):
    net = init_params(build_model(S_PIPE["dim"], S_PIPE["dim_mults"], device="cpu"), seed=0)
    sd = {k: v.detach() for k, v in net.state_dict().items()}
    splits = [(data[s].data, data[s].raw) for s in ("train", "cal", "test")]
    return (S_CONF, S_PIPE, sd, *splits, S_INF[part])


def _rel(a, b) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def _metrics(rec):
    out = dict(rec.get("eval") or {})
    for i, m in enumerate(rec.get("eval_history", [])):
        out.update({f"{i}/{k}": v for k, v in m.items()})
    return out


def _agrees(got, one, lr, n_test, loss_tol=1e-5, metric_atol=1e-9):
    assert _rel(got["q"], one["q"]) <= 1e-5, (got["q"], one["q"])
    assert len(got["hist"]) == len(one["hist"])
    for g, o in zip(got["hist"], one["hist"]):
        assert _rel(g["quantile"], o["quantile"]) <= 1e-5
        assert (g["loss"] is None) == (o["loss"] is None)
        if o["loss"] is not None:
            assert _rel(g["loss"], o["loss"]) <= loss_tol, (g["loss"], o["loss"])
        gm, om = _metrics(g), _metrics(o)
        assert gm.keys() == om.keys() and om
        for k, v in om.items():
            tol = 100 / n_test + 1e-9 if "percentage" in k else 1e-3 * abs(v) + metric_atol
            assert abs(gm[k] - v) <= tol, (k, gm[k], v)
    for name in ("params", "ema"):
        for k, v in one.get(name, {}).items():
            assert np.abs(got[name][k] - v).max() <= 2.5 * lr, (name, k)


@pytest.mark.parametrize("task,part,mesh", [
    ("burgers", "posttrain", (2, 1)), ("burgers", "infft", (2, 1)),
    ("tokamak", "weighted", (2, 1)), ("tokamak", "backward", (2, 1)),
    ("smoke", "weighted", (2, 1)), ("smoke", "backward", (1, 2))])
def test_split_finetune_matches_one_process(task, part, mesh, request, tmp_path):
    """Two gloo ranks (dp 2, or sp 2 for smoke) run the phase eagerly and
    agree with one process within phase 13's tolerances, and with each
    other bit for bit."""
    data = request.getfixturevalue(f"{task}_data")
    args = _smoke_args(part, data) if task == "smoke" else _args(task, part, data)
    ranks = W.run_ranks(W.split_finetune, 2, tmp_path, task, part, args, mesh_shape=mesh)
    one = W.split_finetune(task, part, args)
    n_test = len(data["test"].data)
    lr = S_INF[part]["finetune_lr"] if task == "smoke" else LR[part]
    tol = SMOKE_TOL.get(part, {}) if task == "smoke" else {}
    for got in ranks:
        _agrees(got, one, lr, n_test, **tol)
        # a fine-tuning step moved the weights and had a loss to move them by
        assert any(np.abs(got["params"][k] - args[2][k].numpy()).max() > 0 for k in args[2])
        assert any(r["loss"] for r in got["hist"])
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
