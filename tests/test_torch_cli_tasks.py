"""The smoke and tokamak paths of the port's command line end to end on the
CPU at a tiny size: generate-data -> pretrain (--steps-per-call 2, then
--resume to a second milestone) -> posttrain (--resume) / infft -> eval (one
milestone and a --checkpoints sweep). Results JSON, fine-tuned checkpoints
and metadata/<phase>.json are written; the phase configs' depths are cut as
the JAX package's e2e tests cut theirs."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import safediffcon_torch.tasks.smoke as smoke
import safediffcon_torch.tasks.tokamak as tokamak
from safediffcon_torch.cli import main as M

torch.set_num_threads(1)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _drive(task, tmp_path, extra_pretrain=()):
    """The whole command line of one task; returns the eval results."""
    out = str(tmp_path)
    c = ["--out", out, "--device", "cpu", "--dim", "8"]
    assert M.main([task, "generate-data", "--n-train", "4", "--n-cal", "4", "--n-test", "2"]
                  + c) == 0
    assert M.main([task, "pretrain", "--steps", "2", "--steps-per-call", "2", *extra_pretrain]
                  + c) == 0
    assert M.main([task, "pretrain", "--steps", "4", "--steps-per-call", "2", "--resume",
                   *extra_pretrain] + c) == 0
    assert sorted(os.listdir(tmp_path / f"{task}-pretrain")) == ["ckpt-2.pt", "ckpt-4.pt"]

    assert M.main([task, "posttrain", "--resume"] + c) == 0
    first = _json(tmp_path / f"{task}_posttrain_results.json")
    assert [r["epoch"] for r in first] == [0] and np.isfinite(first[0]["loss"])
    # --resume: the phase state holds the epoch, so a rerun returns its record
    assert M.main([task, "posttrain", "--resume"] + c) == 0
    assert _json(tmp_path / f"{task}_posttrain_results.json") == first
    assert os.listdir(tmp_path / f"{task}-posttrain-state")
    assert M.main([task, "infft"] + c) == 0
    rec = _json(tmp_path / f"{task}_infft_results.json")
    assert len(rec) == 1 and np.isfinite(rec[0]["loss"])
    saved = torch.load(tmp_path / f"{task}-infft" / "ckpt-0.pt")
    assert saved["Q"] == pytest.approx(rec[0]["quantile"])

    assert M.main([task, "eval", "--checkpoints", "2:4:2", "--ddim-steps", "2"] + c) == 0
    table = _json(tmp_path / f"{task}_eval_sweep.json")
    assert set(table) == {"2", "4"} and all("error" not in m for m in table.values())
    assert M.main([task, "eval", "--from-phase", "infft"] + c) == 0
    metrics = _json(tmp_path / f"{task}_eval_results.json")
    assert np.isfinite(metrics["quantile"])
    meta = _json(tmp_path / "metadata" / "pretrain.json")
    assert list(meta) == [f"{task}-pretrain-0", f"{task}-pretrain-1"]
    for phase in ("generate-data", "posttrain", "infft", "eval"):
        assert os.path.exists(tmp_path / "metadata" / f"{phase}.json")
    return metrics


# two cal batches of 4 over the 4 cal sims: calibrate takes the split whole
SMOKE_CONF = dict(cal_batch_size=4, num_cal_batch=2, n_test_samples=2, test_batch_size=2,
                  ddim_sampling_steps=3, timesteps=6)


def test_smoke_end_to_end(tmp_path, monkeypatch):
    conf = functools.partial(smoke.SmokeConformalConfig, **SMOKE_CONF)
    monkeypatch.setattr(smoke, "SmokeConformalConfig", conf)
    monkeypatch.setattr(smoke, "generate_smoke_dataset", functools.partial(
        smoke.generate_smoke_dataset, n_frames=16, record_frames=2, space_scale=4, gen_batch=10,
        accuracy=1e-4, max_iter=40))
    monkeypatch.setattr(smoke, "SmokePretrainConfig", functools.partial(
        smoke.SmokePretrainConfig, dim_mults=(1, 2), timesteps=6, batch_size=2))
    monkeypatch.setattr(smoke, "posttrain_config", lambda: smoke.SmokeInferenceConfig(
        conformal=conf(), finetune_epoch=1, finetune_steps=2, finetune_batch_size=2))
    monkeypatch.setattr(smoke, "finetune_config", lambda: smoke.SmokeInferenceConfig(
        conformal=conf(), backward_finetune=True, finetune_epoch=1, finetune_steps=1))
    monkeypatch.setattr(smoke, "SmokePipeline", functools.partial(
        smoke.SmokePipeline, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=40,
        solver_time_scale=8, solver_space_scale=4))
    metrics = _drive("smoke", tmp_path, ("--conv-impl", "pallas"))
    assert {"mse", "J_safe_target_pred"} <= set(metrics)


TOK_CONF = dict(cal_batch_size=4, num_cal_batch=1, n_cal_samples=4, n_test_samples=2,
                test_batch_size=2, ddim_sampling_steps=3, timesteps=8)


def test_tokamak_end_to_end(tmp_path, monkeypatch):
    conf = functools.partial(tokamak.TokamakConformalConfig, **TOK_CONF)
    monkeypatch.setattr(tokamak, "TokamakConformalConfig", conf)
    monkeypatch.setattr(tokamak, "generate_tokamak_dataset", functools.partial(
        tokamak.generate_tokamak_dataset, gen_batch=16))
    monkeypatch.setattr(tokamak, "TokamakPretrainConfig", functools.partial(
        tokamak.TokamakPretrainConfig, dim_mults=(1, 2), timesteps=8, batch_size=2))
    cut = dict(finetune_epoch=1, train_batch_size=4)
    post, fine = tokamak.posttrain_config(), tokamak.finetune_config()
    monkeypatch.setattr(tokamak, "posttrain_config", lambda: dataclasses.replace(
        post, conformal=conf(guidance_scaler=5.0), **cut))
    monkeypatch.setattr(tokamak, "finetune_config", lambda: dataclasses.replace(
        fine, conformal=conf(guidance_scaler=0.01), **cut))
    monkeypatch.setattr(tokamak, "TokamakPipeline", functools.partial(
        tokamak.TokamakPipeline, dim_mults=(1, 2)))
    metrics = _drive("tokamak", tmp_path)
    assert np.isfinite(list(metrics.values())).all()
