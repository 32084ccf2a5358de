"""The port's `run_inference` (per epoch: posttrain or InfFT steps ->
recalibrate Q-hat -> evaluate through the solver) on a tiny config: a resumed
run equals an uninterrupted one bit for bit, an InfFT epoch trains and stays
finite, the deadline and the device pool, `reweights` against the JAX
package's, and the fine-tuned checkpoint."""
import math

import numpy as np
import pytest
import torch

from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as JConf
from safediffcon_tpu.tasks.smoke import SmokeDataset as JDataset
from safediffcon_tpu.tasks.smoke import SmokePipeline as JPipeline
from safediffcon_torch.tasks.smoke import (
    SmokeConformalConfig,
    SmokeDataset,
    SmokeInferenceConfig,
    SmokePipeline,
    generate_smoke_dataset,
    run_inference,
)
from safediffcon_torch.tasks.smoke.pipeline import init_params
from safediffcon_torch.utils.checkpoint import load_phase_state, save_finetuned

torch.set_num_threads(1)

RECORD_FRAMES, TIME_SCALE, SPACE_SCALE = 2, 8, 4  # 16 solver frames, 32^2 records
CONF = dict(cal_batch_size=4, num_cal_batch=1, n_test_samples=2, test_batch_size=2,
            ddim_sampling_steps=3, timesteps=6, alpha=0.25, standard_fixed_ratio=10.0,
            safe_bound=0.001)
PIPE = dict(dim=8, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=40,
            solver_time_scale=TIME_SCALE, solver_space_scale=SPACE_SCALE)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "smoke.npz")
    generate_smoke_dataset(path, n_train=3, n_cal=4, n_test=2,
                           n_frames=RECORD_FRAMES * TIME_SCALE, record_frames=RECORD_FRAMES,
                           space_scale=SPACE_SCALE, gen_batch=9, accuracy=1e-4, max_iter=40,
                           device="cpu")
    return {s: SmokeDataset.load(path, s) for s in ("train", "cal", "test")}


@pytest.fixture(scope="module")
def pipe_and_params():
    pipe = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE)
    init_params(pipe.model, seed=0)
    return pipe, {k: v.clone() for k, v in pipe.model.state_dict().items()}


def _cfg(**kw):
    base = dict(conformal=SmokeConformalConfig(**CONF), finetune_epoch=2, finetune_steps=2,
                finetune_batch_size=3)
    return SmokeInferenceConfig(**{**base, **kw})


def _run(cfg, pipe, params, data, **kw):
    return run_inference(cfg, pipe, params, data["train"], data["cal"], data["test"], **kw)


def test_posttrain_resume_is_bit_identical(tiny_data, pipe_and_params, tmp_path):
    """A run that lost its epoch-1 state resumes from epoch 0's in
    `state_dir` and ends where the uninterrupted run ended: per-epoch draws
    depend on (seed, epoch) only and the state holds weights, Adam moments and
    Q-hat."""
    pipe, params = pipe_and_params
    d = tmp_path / "phase"
    pA, qA, hA = _run(_cfg(), pipe, params, tiny_data, state_dir=str(d))
    assert load_phase_state(str(d))[3] == 1
    (d / "ckpt-1.pt").unlink()  # "crash" before epoch 1 was saved
    assert load_phase_state(str(d))[3] == 0
    d = str(d)
    replayed = []
    pB, qB, hB = _run(_cfg(), pipe, params, tiny_data, state_dir=d, on_epoch=replayed.append)
    assert [h["epoch"] for h in hB] == [0, 1] and [r["epoch"] for r in replayed] == [0, 1]
    assert float(qA) == float(qB) and hA == hB
    for k in pA:
        torch.testing.assert_close(pA[k], pB[k], rtol=0, atol=0)
    # the epochs trained: the weights moved and every number is finite
    assert any(not torch.equal(pA[k], params[k]) for k in pA)
    for rec in hA:
        assert math.isfinite(rec["loss"]) and math.isfinite(rec["quantile"])
        assert all(math.isfinite(v) for v in rec["eval"].values())


def test_infft_epoch_trains_and_stays_finite(tiny_data, pipe_and_params):
    pipe, params = pipe_and_params
    cfg = _cfg(backward_finetune=True, finetune_epoch=1, finetune_steps=1)
    p, q, hist = _run(cfg, pipe, params, tiny_data)
    assert len(hist) == 1 and math.isfinite(hist[0]["loss"]) and math.isfinite(float(q))
    assert all(math.isfinite(v) for v in hist[0]["eval"].values())
    assert any(not torch.equal(p[k], params[k]) for k in p)


def test_deadline_and_unported_options(tiny_data, pipe_and_params):
    pipe, params = pipe_and_params
    p, q, hist = _run(_cfg(), pipe, params, tiny_data, deadline=0.0)
    assert hist == [] and float(q) == 0.0
    assert all(torch.equal(p[k], params[k]) for k in p)
    # device_pool is ported: an epoch trains from a bfloat16 pool of 2 of the
    # 3 train sims (its parity with JAX: tests/test_torch_loop_pipelines.py)
    p, q, hist = _run(_cfg(device_pool=2, finetune_epoch=1), pipe, params, tiny_data)
    assert len(hist) == 1 and math.isfinite(hist[0]["loss"]) and math.isfinite(float(q))
    assert any(not torch.equal(p[k], params[k]) for k in p)


@pytest.mark.parametrize("Q", [0.0, 0.07])
def test_reweights_match_jax(tiny_data, Q):
    train = tiny_data["train"]
    jp = JPipeline(JConf(**CONF), dim=8, dim_mults=(1, 2), solver_time_scale=TIME_SCALE,
                   solver_space_scale=SPACE_SCALE)
    ref = jp.reweights(JDataset(train.data, train.raw), Q)
    got = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE).reweights(
        SmokeDataset(train.data, train.raw), Q)
    # the same float32 statistics and exp: 1e-6 relative
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got.sum() == pytest.approx(len(train), rel=1e-5)


def test_save_finetuned_round_trip(pipe_and_params, tmp_path):
    _, params = pipe_and_params
    path = save_finetuned(str(tmp_path), params, torch.tensor(0.125), step=3)
    saved = torch.load(path, weights_only=True)
    assert saved["Q"] == 0.125 and saved["step"] == 3
    for k, v in params.items():
        torch.testing.assert_close(saved["params"][k], v, rtol=0, atol=0)
