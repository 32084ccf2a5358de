"""The round-1 and reference-scale validation runs of the JAX package, on
the port, held against the JAX package's recorded results.

Port of `experiments/run_1d_validation.py`, `run_1d_infft_validation.py`,
`run_tokamak_validation.py`, `run_2d_validation.py`,
`run_2d_posttrain_validation.py`, `run_1d_long.py`,
`run_tokamak_refscale.py`, `run_1d_refscale.py` and
`run_1d_dpm_refscale_r4.py`: datagen, pretrain, calibrate and evaluate,
then posttrain, InfFT or the smoke and tokamak backward fine-tunes (or, in
`burgers_dpm_refscale`, calibrate and evaluate under five samplers), with each script's own arguments (the recipe dicts
below; the two reference-scale scripts with the overrides that make them
the runs of their round-2 results, ROUND2), through the port's entry
points:

    python -m safediffcon_torch.experiments.round1
        {burgers,burgers_infft,tokamak,smoke,smoke_posttrain,burgers_20k,
         tokamak_refscale,burgers_refscale,burgers_dpm_refscale}
        [--seed S] [--eval-seeds N] [--device cuda|cpu] [--scale full|tiny] [--out DIR]
        [--state-dir DIR] [--pretrain-seconds S]

Each run prints the JAX script's `SUMMARY {...}` line (its keys and metric
names), then the comparison with the JAX run's committed results
(`experiments/validation_*_round1.json`, `validation_tokamak_refscale_round2.json`,
`validation_1d_refscale_round2.json`, `validation_1d_dpm_round4.json`, read
as data):

    COMPARE <phase> <metric>: port <mean> +- <across-seed std> | jax <value>
            | band <b> | in/out
    SIGN <metric>: port <+/-> jax <+/->      (from one phase to the next)

After each phase (for `smoke_posttrain`, after each fine-tuning epoch,
through `run_inference`'s `on_epoch`) the same weights and Q-hat are
evaluated `--eval-seeds` times (the script's draw, then seeds 1001, 1002,
...), and the port's mean is held against the JAX value with the band

  - a mean over samples (J, obj_mse_mean, safety_score_mean, J_target,
    safe_target): 3 * max(across-seed std, per-sample std / sqrt(n_test));
  - a ratio (R_p, R_s, R_t, time_below_ratio, sample_below_ratio,
    unsafe_percentage / 100), a mean of per-sample rates in [0, 1]:
    3 * max(across-seed std, sqrt(p (1 - p) / n_test)), p the port's mean;
  - Q-hat, one weighted quantile over the n calibration samples:
    3 * the std of the quantile over 200 bootstrap resamples of the
    (score, weight) pairs (numpy seed 0).

`--seed` replaces the training configs' seed (weights, batch order, draws);
the data keep the scripts' seeds. The three reference-scale recipes, as
their scripts do, generate their data file (`<out>/tok_ref.npz`,
`<out>/burgers_ref.npz`) only when it is missing, and print `DATA
generated|reused <path> <sha256 of its first MiB>`. On the card the
full-scale runs take settings that change no result's distribution: smoke
pretrain on kernel K2 (conv_impl "pallas", the port of the Pallas conv;
JAX's default is its XLA conv), and calibration in chunks of a whole
calibration batch. `--scale tiny` cuts every count and width to seconds of
work (the tests' and chip_smoke.py's size), not the recipes' shapes of
data.

Each run also prints the seconds and peak device memory of every stage, the
card's `name, power.limit` (nvidia-smi), and, per stage, the launches of K1
(`ops/pressure_cg.py`) and K2 (`ops/conv3d_mxu.py`, tensor-core modes and
SIMT), and writes all of it to `<out>/round1_<recipe>.json`. A stage opened
inside another (an evaluation inside a fine-tuning phase) is not counted in
the outer one. The smoke runs also print the mean |c| of the sampled
controls in the band below the maze against the test data's (CONTROL), and
`smoke` saves its evaluated EMA weights as a flax tree
(`<out>/smoke_ema_flax.npz`, `models/convert.py::save_flax_npz`), which
`tools/smoke_weight_swap.py` samples and evaluates with the JAX package.

`burgers_20k` pretrains through `pretrain(resume_dir=, deadline=)`: its
checkpoints go to `--state-dir` (default `<out>/b_long_ckpt`), a rerun with
the same directory resumes from the last one, and `--pretrain-seconds`
stops pretraining after that many seconds with a checkpoint (the run then
ends with a PRETRAIN line and no comparison). The reference-scale recipes
write their pretrain checkpoints under `--out` (the scripts' /tmp
directories' names); `tokamak_refscale` does not resume from them, as its
round-2 script did not.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from safediffcon_torch.core.conformal import conformal_quantile
from safediffcon_torch.models.convert import save_flax_npz, state_dict_to_flax

REPO = Path(__file__).resolve().parents[2]

# ---------------------------------------------------------------------------
# Recipes: the keyword arguments of each script's calls, by callee; a callee
# called with two argument sets holds a list, in the script's order; a
# config built as another config's keyword argument is "Outer.keyword".
# ---------------------------------------------------------------------------

class ScriptExpr(str):
    """A keyword argument the script computes at run time (a `for` loop's
    variable, too), as its source text (it equals that text); the runner
    computes the same value."""


BURGERS = {
    "generate_burgers_dataset": dict(n_train=20000, n_cal=1000, n_test=50, seed=0),
    "BurgersPretrainConfig": dict(dim=128, batch_size=16, lr=1e-4, checkpoint_every=10**9,
                                  compute_dtype="bfloat16"),
    "pretrain": dict(num_steps=3000, log_every=500),
    "BurgersConformalConfig": dict(w_score=500.0),
    "BurgersPipeline": dict(dim=128, compute_dtype="bfloat16"),
    "BurgersPostTrainConfig": dict(finetune_epoch=2, finetune_steps=300, finetune_batch_size=64,
                                   finetune_subset_size=6400, finetune_lr=1e-4),
    "BurgersPostTrainConfig.conformal": dict(w_score=2500.0),
    "BurgersDataset.load": dict(subset=6400),
    "posttrain": dict(eval_every_subset_epoch=False),
}

BURGERS_INFFT = {
    "generate_burgers_dataset": dict(n_train=12000, n_cal=1000, n_test=50, seed=1),
    "BurgersPretrainConfig": dict(dim=128, batch_size=16, lr=1e-4, checkpoint_every=10**9,
                                  compute_dtype="bfloat16"),
    "pretrain": dict(num_steps=2500, log_every=500),
    "BurgersConformalConfig": dict(w_score=500.0),
    # the dtype check's pipeline (compute_dtype per dtype), then InfFT's
    "BurgersPipeline": [dict(dim=128, compute_dtype=ScriptExpr("dt")),
                        dict(dim=128, compute_dtype="bfloat16")],
    "BurgersInfFTConfig": dict(InfFT_iters=3, finetune_lr=1e-5),
}
DTYPE_CHECK = ("bfloat16", "float32")

TOKAMAK = {
    "generate_tokamak_dataset": dict(n_train=5000, n_cal=1000, n_test=50, gen_batch=512),
    "TokamakPretrainConfig": dict(dim=128, batch_size=16, checkpoint_every=10**9,
                                  compute_dtype="bfloat16"),
    "pretrain": dict(num_steps=2500, log_every=500),
    "TokamakConformalConfig": dict(guidance_scaler=5.0),
    "TokamakPipeline": dict(dim=128, compute_dtype="bfloat16"),
    "TokamakInferenceConfig": dict(finetune_epoch=2, finetune_steps=20, train_batch_size=256,
                                   finetune_lr=7e-6),
}

SMOKE = {
    "generate_smoke_dataset": dict(n_train=96, n_cal=32, n_test=8, n_frames=256, gen_batch=16),
    "SmokePretrainConfig": dict(dim=32, dim_mults=(1, 2), batch_size=4, checkpoint_every=10**9,
                                compute_dtype="bfloat16"),
    "pretrain": dict(num_steps=300, log_every=100),
    "SmokeConformalConfig": dict(cal_batch_size=32, num_cal_batch=1, ddim_sampling_steps=50,
                                 test_batch_size=8),
    "SmokePipeline": dict(dim=32, dim_mults=(1, 2), compute_dtype="bfloat16"),
}

_SMOKE_DIM = dict(dim=32, dim_mults=(1, 2))
SMOKE_POSTTRAIN = {
    "generate_smoke_dataset": dict(n_train=96, n_cal=32, n_test=8, n_frames=256, gen_batch=16,
                                   seed=7),
    "SmokePretrainConfig": dict(**_SMOKE_DIM, batch_size=4, checkpoint_every=10**9,
                                compute_dtype="bfloat16"),
    "pretrain": dict(num_steps=400, log_every=100),
    "SmokeConformalConfig": dict(cal_batch_size=32, num_cal_batch=1, ddim_sampling_steps=50,
                                 test_batch_size=8, standard_fixed_ratio=100.0, w_safe=0.9),
    # posttrain's pipeline, then the backward fine-tune's (on the test set)
    "SmokePipeline": [dict(**_SMOKE_DIM, compute_dtype="bfloat16"),
                      dict(**_SMOKE_DIM, compute_dtype="bfloat16", finetune_set="test")],
    "SmokeInferenceConfig": [dict(finetune_epoch=2, finetune_steps=50, finetune_batch_size=4,
                                  finetune_lr=1e-4),
                             dict(backward_finetune=True, finetune_epoch=1, finetune_steps=1)],
    "SmokeInferenceConfig.conformal": dict(cal_batch_size=32, num_cal_batch=1,
                                           ddim_sampling_steps=50, test_batch_size=8,
                                           standard_fixed_ratio=100.0, w_safe=1.0,
                                           use_guidance=False, alpha=0.01),
}

BURGERS_20K = {
    "generate_burgers_dataset": dict(n_train=40000, n_cal=1000, n_test=50, seed=0),
    "BurgersPretrainConfig": dict(dim=128, batch_size=32, lr=1e-4, checkpoint_every=10_000,
                                  compute_dtype="bfloat16"),
    # checkpoint_dir is the script's; the port writes under --state-dir
    "pretrain": dict(num_steps=20000, log_every=1000, checkpoint_dir="/tmp/b_long_ckpt"),
    "BurgersConformalConfig": dict(w_score=500.0),
    "BurgersPipeline": dict(dim=128, compute_dtype="bfloat16"),
    "BurgersPostTrainConfig": dict(finetune_epoch=3, finetune_steps=400, finetune_batch_size=64,
                                   finetune_subset_size=10240, finetune_lr=1e-4),
    "BurgersPostTrainConfig.conformal": dict(w_score=2500.0),
    "BurgersDataset.load": dict(subset=10240),
    "posttrain": dict(eval_every_subset_epoch=False),
    "BurgersInfFTConfig": dict(InfFT_iters=3, finetune_lr=1e-5),
}

# The reference-scale scripts as they stand; ROUND2 below turns each into
# the run that wrote its round-2 results.
TOKAMAK_REFSCALE = {
    "generate_tokamak_dataset": dict(n_train=48950, n_cal=1000, n_test=50, gen_batch=512),
    "TokamakPretrainConfig": dict(dim=128, batch_size=32, checkpoint_every=25_000,
                                  compute_dtype="bfloat16"),
    # num_steps is TOK_PRETRAIN_STEPS' default; the directories are the
    # script's, the port's go under --out
    "pretrain": dict(num_steps=200_000, log_every=1000, checkpoint_dir="/tmp/tok_ref_ckpt",
                     resume_dir="/tmp/tok_ref_ckpt", steps_per_call=50),
    "posttrain_config": {},
    "TokamakPipeline": dict(dim=128, compute_dtype="bfloat16"),
    "finetune_config": {},
    # dataclasses.replace(finetune_config().conformal, ...): the backward
    # fine-tune's composite weight at the posttrain checkpoint's settings
    "replace.conformal": dict(
        wo_post_train=False, finetune_quantile=ScriptExpr("float(Q_pt)"),
        finetune_w_obj=ScriptExpr("pt_cfg.conformal.w_obj"),
        finetune_w_safe=ScriptExpr("pt_cfg.conformal.w_safe"),
        finetune_guidance_scaler=ScriptExpr("pt_cfg.conformal.guidance_scaler"),
        finetune_set="test"),
}

BURGERS_REFSCALE = {
    "generate_burgers_dataset": dict(n_train=40000, n_cal=1000, n_test=50, seed=0),
    "BurgersPretrainConfig": dict(dim=128, batch_size=16, lr=1e-5, checkpoint_every=50_000,
                                  compute_dtype="bfloat16"),
    # num_steps is B_PRETRAIN_STEPS' default; directories as above
    "pretrain": dict(num_steps=200_000, log_every=2000, checkpoint_dir="/tmp/b_ref_ckpt",
                     resume_dir="/tmp/b_ref_ckpt", steps_per_call=50),
    "BurgersConformalConfig": dict(w_score=500.0),
    "BurgersPipeline": dict(dim=128, compute_dtype="bfloat16"),
    # finetune_epoch / finetune_steps are B_PT_EPOCHS' and B_PT_STEPS' defaults
    "BurgersPostTrainConfig": dict(finetune_epoch=5, finetune_steps=3200, finetune_batch_size=32,
                                   finetune_subset_size=10240, finetune_lr=1e-4,
                                   steps_per_call=25),
    "BurgersPostTrainConfig.conformal": dict(w_score=2500.0),
    "BurgersDataset.load": dict(subset=10240),
    "posttrain": dict(eval_every_subset_epoch=False),
    "BurgersInfFTConfig": dict(InfFT_iters=3, finetune_lr=1e-5),
}

# experiments/run_1d_dpm_refscale_r4.py: burgers_refscale's round-2 EMA
# (its datagen and pretrain, ROUND2's 50,000 steps) calibrated and evaluated
# under five samplers, one pipeline each; N_SEEDS is DPM_EVAL_SEEDS' default
BURGERS_DPM_REFSCALE = {
    "variants": [("ddim", 200), ("ddim", 20), ("ddim", 50), ("dpm", 50), ("dpm", 20)],
    "N_SEEDS": 3,
    "generate_burgers_dataset": dict(n_train=40000, n_cal=1000, n_test=50, seed=0),
    "BurgersConformalConfig": dict(sampler=ScriptExpr("sampler"),
                                   ddim_sampling_steps=ScriptExpr("steps")),
    "BurgersPipeline": dict(dim=128, compute_dtype="bfloat16"),
}
# its calls' positional arguments: calibrate(params, cal, 0.0, PRNGKey(0)),
# then evaluate(..., PRNGKey(5000 + s)) for s < N_SEEDS
DPM_CALIBRATE_Q, DPM_CALIBRATE_KEY, DPM_EVAL_KEY_BASE = 0.0, 0, 5000
# which arm's J the few-step arms' are held against (FEWSTEP lines)
DPM_BASELINE = "ddim200"

# What the scripts were when their round-2 results were written (None: the
# argument was not passed). The tokamak JSON was committed at 14357c1 from
# the script of 3dfca3d: TOK_PRETRAIN_STEPS defaulted to 20,000, checkpoints
# every 5,000, no resume_dir, and no finetune_guidance_scaler, which kept
# its default of 1.0 (fe54396 later made the fine-tune carry the posttrain
# guidance_scaler of 5.0). The Burgers JSON records pretrain_steps 50,000.
ROUND2 = {
    "tokamak_refscale": {"pretrain": dict(num_steps=20_000, resume_dir=None),
                         "TokamakPretrainConfig": dict(checkpoint_every=5_000),
                         "replace.conformal": dict(finetune_guidance_scaler=None)},
    "burgers_refscale": {"pretrain": dict(num_steps=50_000)},
}

RECIPES = {"burgers": BURGERS, "burgers_infft": BURGERS_INFFT, "tokamak": TOKAMAK,
           "smoke": SMOKE, "smoke_posttrain": SMOKE_POSTTRAIN, "burgers_20k": BURGERS_20K,
           "tokamak_refscale": TOKAMAK_REFSCALE, "burgers_refscale": BURGERS_REFSCALE,
           "burgers_dpm_refscale": BURGERS_DPM_REFSCALE}
SCRIPTS = {"burgers": "experiments/run_1d_validation.py",
           "burgers_infft": "experiments/run_1d_infft_validation.py",
           "tokamak": "experiments/run_tokamak_validation.py",
           "smoke": "experiments/run_2d_validation.py",
           "smoke_posttrain": "experiments/run_2d_posttrain_validation.py",
           "burgers_20k": "experiments/run_1d_long.py",
           "tokamak_refscale": "experiments/run_tokamak_refscale.py",
           "burgers_refscale": "experiments/run_1d_refscale.py",
           "burgers_dpm_refscale": "experiments/run_1d_dpm_refscale_r4.py"}
JAX_RESULTS = {"burgers": "experiments/validation_1d_round1.json",
               "burgers_infft": "experiments/validation_1d_infft_round1.json",
               "tokamak": "experiments/validation_tokamak_round1.json",
               "smoke": "experiments/validation_2d_round1.json",
               "smoke_posttrain": "experiments/validation_2d_posttrain_round1.json",
               "burgers_20k": "experiments/validation_1d_20k_round1.json",
               "tokamak_refscale": "experiments/validation_tokamak_refscale_round2.json",
               "burgers_refscale": "experiments/validation_1d_refscale_round2.json",
               "burgers_dpm_refscale": "experiments/validation_1d_dpm_round4.json"}

# Settings of the full-scale runs on the card (module docstring).
CARD = {
    "burgers": {"BurgersPipeline": dict(cal_chunk=250)},
    "burgers_infft": {"BurgersPipeline": dict(cal_chunk=250)},
    "tokamak": {"TokamakPipeline": dict(cal_chunk=1000)},
    "smoke": {"SmokePretrainConfig": dict(conv_impl="pallas")},
    "smoke_posttrain": {"SmokePretrainConfig": dict(conv_impl="pallas")},
    "burgers_20k": {"BurgersPipeline": dict(cal_chunk=250)},
    "tokamak_refscale": {"TokamakPipeline": dict(cal_chunk=1000)},
    "burgers_refscale": {"BurgersPipeline": dict(cal_chunk=250)},
    "burgers_dpm_refscale": {"BurgersPipeline": dict(cal_chunk=250)},
}

# --scale tiny: counts and widths cut, merged over the recipe (a dict over
# each entry of a list, a list entry by entry).
_TINY_BURGERS_CONF = dict(ddim_sampling_steps=10, cal_batch_size=8, num_cal_batch=1)
_TINY_TOKAMAK_CONF = dict(ddim_sampling_steps=10, cal_batch_size=8)
_TINY_SMOKE_DATA = dict(n_train=8, n_cal=4, n_test=2, n_frames=16, record_frames=2,
                        space_scale=4, gen_batch=14, accuracy=1e-4, max_iter=40)
_TINY_SMOKE_CONF = dict(cal_batch_size=4, ddim_sampling_steps=5, test_batch_size=2,
                        timesteps=20)
_TINY_SMOKE_PIPE = dict(dim=8, solver_accuracy=1e-4, solver_max_iter=40, solver_space_scale=4)
TINY = {
    "burgers": {
        "generate_burgers_dataset": dict(n_train=40, n_cal=8, n_test=4),
        "BurgersPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2),
        "BurgersConformalConfig": _TINY_BURGERS_CONF,
        "BurgersPipeline": dict(dim=8, dim_mults=(1, 2)),
        "BurgersPostTrainConfig": dict(finetune_steps=2, finetune_batch_size=4,
                                       finetune_subset_size=16),
        "BurgersPostTrainConfig.conformal": _TINY_BURGERS_CONF,
        "BurgersDataset.load": dict(subset=16),
    },
    "burgers_infft": {
        "generate_burgers_dataset": dict(n_train=16, n_cal=8, n_test=4),
        "BurgersPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2),
        "BurgersConformalConfig": _TINY_BURGERS_CONF,
        "BurgersPipeline": dict(dim=8, dim_mults=(1, 2)),
    },
    "tokamak": {
        "generate_tokamak_dataset": dict(n_train=16, n_cal=8, n_test=4, gen_batch=16),
        "TokamakPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2),
        "TokamakConformalConfig": dict(ddim_sampling_steps=10, cal_batch_size=8),
        "TokamakPipeline": dict(dim=8, dim_mults=(1, 2)),
        "TokamakInferenceConfig": dict(finetune_steps=2, train_batch_size=4),
    },
    "smoke": {
        "generate_smoke_dataset": _TINY_SMOKE_DATA,
        "SmokePretrainConfig": dict(dim=8, timesteps=20, batch_size=2),
        "pretrain": dict(num_steps=4, log_every=2),
        "SmokeConformalConfig": _TINY_SMOKE_CONF,
        "SmokePipeline": _TINY_SMOKE_PIPE,
    },
    "smoke_posttrain": {
        "generate_smoke_dataset": _TINY_SMOKE_DATA,
        "SmokePretrainConfig": dict(dim=8, timesteps=20, batch_size=2),
        "pretrain": dict(num_steps=4, log_every=2),
        "SmokeConformalConfig": _TINY_SMOKE_CONF,
        "SmokePipeline": _TINY_SMOKE_PIPE,
        "SmokeInferenceConfig": [dict(finetune_steps=2, finetune_batch_size=2), {}],
        "SmokeInferenceConfig.conformal": _TINY_SMOKE_CONF,
    },
    "burgers_20k": {
        "generate_burgers_dataset": dict(n_train=40, n_cal=8, n_test=4),
        "BurgersPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2),
        "BurgersConformalConfig": _TINY_BURGERS_CONF,
        "BurgersPipeline": dict(dim=8, dim_mults=(1, 2)),
        "BurgersPostTrainConfig": dict(finetune_steps=2, finetune_batch_size=4,
                                       finetune_subset_size=16),
        "BurgersPostTrainConfig.conformal": _TINY_BURGERS_CONF,
        "BurgersDataset.load": dict(subset=16),
    },
    "tokamak_refscale": {
        "generate_tokamak_dataset": dict(n_train=16, n_cal=8, n_test=4, gen_batch=16),
        "TokamakPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2, steps_per_call=2),
        "posttrain_config": dict(finetune_epoch=2, train_batch_size=4,
                                 conformal=_TINY_TOKAMAK_CONF),
        "TokamakPipeline": dict(dim=8, dim_mults=(1, 2)),
        "finetune_config": dict(finetune_epoch=2, conformal=_TINY_TOKAMAK_CONF),
    },
    "burgers_refscale": {
        "generate_burgers_dataset": dict(n_train=40, n_cal=8, n_test=4),
        "BurgersPretrainConfig": dict(dim=8, dim_mults=(1, 2)),
        "pretrain": dict(num_steps=4, log_every=2, steps_per_call=2),
        "BurgersConformalConfig": _TINY_BURGERS_CONF,
        "BurgersPipeline": dict(dim=8, dim_mults=(1, 2)),
        "BurgersPostTrainConfig": dict(finetune_epoch=2, finetune_steps=2, finetune_batch_size=4,
                                       finetune_subset_size=16, steps_per_call=2),
        "BurgersPostTrainConfig.conformal": _TINY_BURGERS_CONF,
        "BurgersDataset.load": dict(subset=16),
    },
    "burgers_dpm_refscale": {
        # five arms still, each sampler at fewer steps
        "variants": [("ddim", 20), ("ddim", 10), ("ddim", 15), ("dpm", 15), ("dpm", 10)],
        "generate_burgers_dataset": dict(n_train=40, n_cal=12, n_test=4),
        # three calibration chunks: a captured calibration's warm-up, capture, replay
        "BurgersConformalConfig": dict(cal_batch_size=4, num_cal_batch=3),
        "BurgersPipeline": dict(dim=8, dim_mults=(1, 2)),
    },
}

# Headline metrics: (name, kind, per-sample std key); kind "mean", "ratio"
# or "percent" (a ratio times 100). The smoke means take their per-sample
# values from the pipeline's record.
HEADLINE = {
    "burgers": [("control_mse_mean (J)", "mean", "control_mse_std"),
                ("point_exceed_ratio (R_p)", "ratio", None),
                ("sample_exceed_ratio (R_s)", "ratio", None),
                ("time_exceed_ratio (R_t)", "ratio", None)],
    "tokamak": [("obj_mse_mean", "mean", "obj_mse_std"),
                ("safety_score_mean", "mean", "safety_score_std"),
                ("time_below_ratio", "ratio", None),
                ("sample_below_ratio", "ratio", None)],
    "smoke": [("J_target", "mean", "record"),
              ("safe_target", "mean", "record"),
              ("unsafe_percentage", "percent", None)],
}
HEADLINE.update(burgers_infft=HEADLINE["burgers"], burgers_20k=HEADLINE["burgers"],
                smoke_posttrain=HEADLINE["smoke"], tokamak_refscale=HEADLINE["tokamak"],
                burgers_refscale=HEADLINE["burgers"], burgers_dpm_refscale=HEADLINE["burgers"])
N_BOOTSTRAP = 200
EVAL_SEED_BASE = 1000


def recipe(name: str, scale: str = "full", device="cuda") -> dict:
    """The recipe of run `name` with its round-2 overrides (ROUND2; an
    argument set to None is dropped), the tiny cuts (`scale` "tiny") and the
    card's settings (a CUDA `device`) merged in: a dict of keyword arguments
    over the recipe's, a list of them entry by entry, anything else (a
    value, a list of values) in place of the recipe's."""
    out = copy.deepcopy(RECIPES[name])
    merged = [ROUND2.get(name, {})] + ([TINY[name]] if scale == "tiny" else [])
    if torch.device(device).type == "cuda":
        merged.append(CARD[name])
    for extra in merged:
        for key, kw in extra.items():
            if not isinstance(kw, (dict, list)) or (
                    isinstance(kw, list) and not all(isinstance(k, dict) for k in kw)):
                out[key] = copy.deepcopy(kw)  # a value, or a list of values
            elif isinstance(kw, list):
                out[key] = [{**d, **k} for d, k in zip(out[key], kw)]
            elif isinstance(out[key], list):
                out[key] = [{**d, **kw} for d in out[key]]
            else:
                out[key] = {k: v for k, v in {**out[key], **kw}.items() if v is not None}
    return out


def configured(cfg, kw: dict):
    """A config a script builds by a factory call (`posttrain_config()`),
    with `kw` replaced; a `conformal` dict replaces fields of its
    conformal config."""
    kw = dict(kw)
    if "conformal" in kw:
        kw["conformal"] = dataclasses.replace(cfg.conformal, **kw["conformal"])
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Bands and verdicts
# ---------------------------------------------------------------------------

def band(kind: str, seed_values: Sequence[float], n: int,
         per_sample_std: Optional[float] = None) -> float:
    """Half-width of the band a port mean must fall in around the JAX value
    (module docstring): `seed_values` are the metric over the eval seeds,
    `n` the test samples, `per_sample_std` a mean metric's per-sample std."""
    vals = np.asarray(seed_values, np.float64)
    across = float(vals.std(ddof=1)) if vals.size > 1 else 0.0
    if kind == "mean":
        within = float(per_sample_std) / math.sqrt(n)
    elif kind in ("ratio", "percent"):
        scale = 100.0 if kind == "percent" else 1.0
        p = min(max(float(vals.mean()) / scale, 0.0), 1.0)
        within = scale * math.sqrt(p * (1.0 - p) / n)
    else:
        raise ValueError(f"unknown metric kind {kind!r}")
    return 3.0 * max(across, within)


def verdict(port: float, jax: float, half_width: float) -> str:
    return "in" if abs(port - jax) <= half_width else "out"


def bootstrap_q_std(scores: torch.Tensor, weights: torch.Tensor, alpha: float, convention: str,
                    n_boot: int = N_BOOTSTRAP, seed: int = 0) -> float:
    """Std of the weighted conformal quantile over bootstrap resamples of the
    (score, weight) pairs."""
    rng = np.random.default_rng(seed)
    n = scores.shape[0]
    qs = [float(conformal_quantile(scores[idx], weights[idx], alpha, convention))
          for idx in (torch.from_numpy(rng.integers(0, n, n)) for _ in range(n_boot))]
    return float(np.std(qs, ddof=1))


def sign(x: float) -> str:
    return "+" if x > 0 else ("-" if x < 0 else "0")


def control_line(phase: str, per_sample: Dict[str, list], test_raw: np.ndarray,
                 space_scale: int) -> str:
    """CONTROL line of a smoke phase: the mean |c| of the sampled controls in
    the band below the maze (rows under 16 // space_scale, every frame,
    physical units; `per_sample["band_control_abs"]`, one list per
    evaluation) against the test data's."""
    sampled = float(np.mean([np.mean(v) for v in per_sample["band_control_abs"]]))
    data = float(np.abs(np.asarray(test_raw)[:, :, : 16 // space_scale, :, 3:5]).mean())
    return (f"CONTROL {phase} band mean |c|: sampled {sampled:.6g} | data {data:.6g} | "
            f"ratio {sampled / data:.3g}")


@dataclasses.dataclass
class Phase:
    """One phase's results: the evals of its weights over the eval seeds,
    its Q-hat, the bootstrap std of Q-hat, the JAX values."""

    name: str
    evals: List[Dict[str, float]]
    Q: float
    q_std: float
    jax: Dict[str, float]
    jax_Q: float
    per_sample: Dict[str, List[float]] = dataclasses.field(default_factory=dict)


def compare(phases: List[Phase], headline, n_test: int) -> List[dict]:
    """One row per (phase, headline metric) and per phase's Q-hat."""
    rows = []
    for ph in phases:
        for name, kind, std_key in headline:
            vals = [m[name] for m in ph.evals]
            if std_key == "record":
                per_sample = float(np.mean([np.std(v, ddof=1) for v in ph.per_sample[name]]))
            elif std_key is not None:
                per_sample = float(np.mean([m[std_key] for m in ph.evals]))
            else:
                per_sample = None
            b = band(kind, vals, n_test, per_sample)
            mean = float(np.mean(vals))
            rows.append(dict(phase=ph.name, metric=name, port=mean,
                             port_std=float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0,
                             seeds=len(vals), jax=float(ph.jax[name]), band=b,
                             result=verdict(mean, float(ph.jax[name]), b)))
        b = 3.0 * ph.q_std
        rows.append(dict(phase=ph.name, metric="Q-hat", port=ph.Q, port_std=0.0, seeds=1,
                         jax=ph.jax_Q, band=b, result=verdict(ph.Q, ph.jax_Q, b)))
    return rows


def signs(before: Phase, after: Phase, headline) -> List[dict]:
    out = []
    for name in [h[0] for h in headline] + ["Q-hat"]:
        if name == "Q-hat":
            port, jax = after.Q - before.Q, after.jax_Q - before.jax_Q
        else:
            port = np.mean([m[name] for m in after.evals]) - np.mean([m[name] for m in before.evals])
            jax = after.jax[name] - before.jax[name]
        out.append(dict(metric=name, port=sign(float(port)), jax=sign(float(jax)),
                        agree=sign(float(port)) == sign(float(jax))))
    return out


# ---------------------------------------------------------------------------
# The runner: stage timing, peak memory, kernel launches, the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def kernel_counts() -> Dict[str, object]:
    from safediffcon_torch.ops import conv3d_mxu as K2
    from safediffcon_torch.ops import pressure_cg as K1

    return {"K1": K1.pressure_cg_cuda.launches,
            "K2": dict(K2.conv3d_fused_cuda.launches),
            "K2_simt": K2.conv3d_fused_simt_cuda.launches}


def _launch_delta(before, after) -> Dict[str, object]:
    return {"K1": after["K1"] - before["K1"],
            "K2": {m: after["K2"][m] - before["K2"][m] for m in after["K2"]
                   if after["K2"][m] - before["K2"][m]},
            "K2_simt": after["K2_simt"] - before["K2_simt"]}


def split_shapes(kw: dict, **tails: tuple) -> Dict[str, tuple]:
    """The npz keys and shapes of a generator's splits: `{split}_{name}`
    (n, *tail) for n the generator's keyword `n_{split}` in `kw`."""
    return {f"{s}_{name}": (kw[f"n_{s}"], *tail)
            for s in ("train", "cal", "test") for name, tail in tails.items()}


def data_file(run: "Run", path: str, generate: Callable[[str], None],
              shapes: Dict[str, tuple]) -> str:
    """`path`, written by `generate(path)` (in the stage "datagen") only when
    it is missing, as the reference-scale scripts guard their data; prints
    `DATA generated|reused <path> <sha256 of its first MiB>`. The file must
    hold exactly `shapes` ({npz key: shape}, this run's splits): one written
    at another scale or with other sizes raises."""
    with run.stage("datagen"):
        made = not os.path.exists(path)
        if made:
            generate(path)
    with np.load(path) as z:
        found = {k: z[k].shape for k in z.files}
    if found != shapes:
        raise ValueError(f"{path} holds {found}, not this run's {shapes}: it was written at "
                         f"another scale or with other sizes; remove it or give another --out")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read(1 << 20)).hexdigest()
    run.emit(f"DATA {'generated' if made else 'reused'} {path} {digest}")
    return path


class Run:
    """One recipe's run on `device`: stages, the lines it prints, its
    result."""

    def __init__(self, name: str, device, scale: str, seed: Optional[int], eval_seeds: int,
                 out: Optional[str], emit: Callable[[str], None] = print):
        self.name, self.scale, self.seed = name, scale, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.eval_seeds = max(int(eval_seeds), 1)
        self.out = Path(out) if out else REPO / "build" / "round1" / (
            name if scale == "full" else f"{name}-{scale}")
        self.out.mkdir(parents=True, exist_ok=True)
        self.emit = emit
        self.recipe = recipe(name, scale, device)
        with open(REPO / JAX_RESULTS[name]) as f:
            self.jax = json.load(f)
        self.stages: Dict[str, float] = {}
        self.peak_gb: Dict[str, float] = {}
        self.launches: Dict[str, dict] = {}
        self._open: List[str] = []  # the stages open, innermost last
        self._segment = (0.0, None)  # (start, kernel counts) of the innermost one
        self.t0 = time.perf_counter()

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def seeded(self, kw: dict) -> dict:
        return kw if self.seed is None else {**kw, "seed": self.seed}

    def in_out(self, kw: dict) -> dict:
        """`kw` with the script's checkpoint and resume directories moved
        under the output directory."""
        return {k: str(self.out / Path(v).name) if k in ("checkpoint_dir", "resume_dir") else v
                for k, v in kw.items()}

    def tick(self, msg: str) -> None:
        self.emit(f"[{time.perf_counter() - self.t0:7.1f}s] {msg}")

    def _start_segment(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._segment = (time.perf_counter(), kernel_counts())

    def _end_segment(self, name: str) -> None:
        """Add the time, peak memory and launches since the last
        `_start_segment` to stage `name`."""
        t, before = self._segment
        if self.cuda:
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device) / 1e9
            self.peak_gb[name] = max(self.peak_gb.get(name, 0.0), peak)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t
        delta = _launch_delta(before, kernel_counts())
        prev = self.launches.setdefault(name, {"K1": 0, "K2": {}, "K2_simt": 0})
        prev["K1"] += delta["K1"]
        prev["K2_simt"] += delta["K2_simt"]
        for m, c in delta["K2"].items():
            prev["K2"][m] = prev["K2"].get(m, 0) + c

    @contextlib.contextmanager
    def stage(self, name: str):
        """Seconds, peak memory and kernel launches of a stage, summed over
        its entries; a stage opened inside another is not counted in it."""
        if self._open:
            self._end_segment(self._open[-1])
        self._open.append(name)
        self._start_segment()
        try:
            yield
        finally:
            self._end_segment(name)
            self._open.pop()
            if self._open:
                self._start_segment()

    def evals(self, phase: str, evaluate: Callable[[torch.Generator], Dict[str, float]],
              first_seed: Optional[int], record: Optional[dict] = None):
        """Evaluations of one phase's weights: the script's draw
        (`first_seed`, unless None), then the extra eval seeds up to
        `eval_seeds` in all; with `record` (a pipeline's), also the per-sample
        values each evaluation recorded."""
        seeds = [first_seed] if first_seed is not None else []
        seeds += [EVAL_SEED_BASE + i for i in range(1, self.eval_seeds)]
        ms, per_sample = [], {}
        for seed in seeds:
            if record is not None:
                for k in [k for k in record if not k.startswith("cal_")]:
                    del record[k]
            with self.stage(f"{phase}_evaluate"):
                ms.append(evaluate(self.gen(seed)))
            if record is not None:
                for k, v in record.items():
                    if not k.startswith("cal_"):
                        per_sample.setdefault(k, []).append(torch.cat(v).numpy().tolist())
        return ms, per_sample

    def q_std(self, pipe, Q, alpha: float, convention: str) -> float:
        """Bootstrap std of the last calibration's Q-hat, from the scores and
        weights it recorded, after checking that they give its Q-hat (to a
        few float32 ulps: the weights' sum runs in another order on the
        CPU)."""
        rec = pipe.record
        again = float(conformal_quantile(rec["cal_scores"], rec["cal_weights"], alpha, convention))
        if abs(again - float(Q)) > 1e-6 * abs(float(Q)):
            raise AssertionError(f"recorded calibration gives Q-hat {again}, not {float(Q)}")
        return bootstrap_q_std(rec["cal_scores"], rec["cal_weights"], alpha, convention)

    def finish(self, summary: dict, phases: List[Phase], headline, n_test: int,
               sign_pairs=(), extra: Optional[dict] = None) -> dict:
        rows = compare(phases, headline, n_test)
        sgn = [dict(pair=f"{a.name}->{b.name}", **s) for a, b in sign_pairs
               for s in signs(a, b, headline)]
        card = card_line() if self.cuda else "cpu"
        self.emit("SUMMARY " + json.dumps(summary))
        for r in rows:
            self.emit(f"COMPARE {r['phase']} {r['metric']}: port {r['port']:.6g} +- "
                      f"{r['port_std']:.3g} ({r['seeds']} eval seeds) | jax {r['jax']:.6g} | "
                      f"band {r['band']:.3g} | {r['result']}")
        for s in sgn:
            self.emit(f"SIGN {s['pair']} {s['metric']}: port {s['port']} jax {s['jax']}"
                      f"{'' if s['agree'] else ' (differs)'}")
        self.emit("STAGES " + json.dumps({k: round(v, 3) for k, v in self.stages.items()}))
        if self.cuda:
            self.emit("PEAK_GB " + json.dumps({k: round(v, 3) for k, v in self.peak_gb.items()}))
        self.emit("LAUNCHES " + json.dumps(self.launches))
        self.emit(f"CARD {card}")
        result = dict(recipe=self.name, scale=self.scale, seed=self.seed,
                      eval_seeds=self.eval_seeds, device=str(self.device), card=card,
                      summary=summary, comparison=rows, signs=sgn, stages=self.stages,
                      peak_gb=self.peak_gb, launches=self.launches, **(extra or {}))
        with open(self.out / f"round1_{self.name}.json", "w") as f:
            json.dump(result, f, indent=1)
        return result


# ---------------------------------------------------------------------------
# The runs
# ---------------------------------------------------------------------------

def run_1d_validation(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                      emit=print) -> dict:
    """experiments/run_1d_validation.py: Burgers datagen, pretrain at the
    turbo width in bf16, calibrate + evaluate, posttrain, evaluate."""
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersPipeline, BurgersPostTrainConfig,
        BurgersPretrainConfig, generate_burgers_dataset, posttrain, pretrain)

    run = Run("burgers", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    path = str(run.out / "burgers_val.npz")
    with run.stage("datagen"):
        generate_burgers_dataset(path, **R["generate_burgers_dataset"], device=dev)
    data = {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"dataset generated ({sum(len(d) for d in data.values())} trajectories)")

    pre = BurgersPretrainConfig(**run.seeded(R["BurgersPretrainConfig"]))
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **R["pretrain"], device=dev)
    run.tick(f"pretrain {R['pretrain']['num_steps']} steps done")

    conf = BurgersConformalConfig(**R["BurgersConformalConfig"])
    pipe = BurgersPipeline(conf, **R["BurgersPipeline"], device=dev)
    pipe.record = {}
    with run.stage("pretrain_calibrate"):
        Q = pipe.calibrate(state.ema_params, data["cal"].data, torch.zeros((), device=dev),
                           generator=run.gen(0))
    run.tick(f"Q-hat = {float(Q):.5f}")
    q_pre = run.q_std(pipe, Q, conf.alpha, "alpha")
    m0s, _ = run.evals("pretrain", lambda g: pipe.evaluate(state.ema_params, data["test"], Q,
                                                           generator=g), 1)
    run.tick(f"eval after pretrain: {json.dumps(m0s[0])}")

    pt = BurgersPostTrainConfig(
        conformal=BurgersConformalConfig(**R["BurgersPostTrainConfig.conformal"]),
        **run.seeded(R["BurgersPostTrainConfig"]))
    finetune = BurgersDataset.load(path, "train", **R["BurgersDataset.load"])
    with run.stage("posttrain"):
        state2, Q2, hist = posttrain(pt, pipe, state.ema_params, finetune, data["cal"],
                                     data["test"], **R["posttrain"])
    run.tick(f"posttrain done, Q={float(Q2):.5f}")
    q_post = run.q_std(pipe, Q2, conf.alpha, "alpha")
    m1s, _ = run.evals("posttrain", lambda g: pipe.evaluate(state2.ema_params, data["test"], Q2,
                                                            generator=g), 2)
    run.tick(f"eval after posttrain: {json.dumps(m1s[0])}")

    summary = {"pretrain_eval": m0s[0], "posttrain_eval": m1s[0], "Q_pre": float(Q),
               "Q_post": float(Q2)}
    j = run.jax
    phases = [Phase("pretrain", m0s, float(Q), q_pre, j["pretrain_eval"], j["Q_pre"]),
              Phase("posttrain", m1s, float(Q2), q_post, j["posttrain_eval"], j["Q_post"])]
    return run.finish(summary, phases, HEADLINE["burgers"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1])],
                      extra=dict(posttrain_history=hist))


def run_1d_infft_validation(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                            emit=print) -> dict:
    """experiments/run_1d_infft_validation.py: Burgers datagen and pretrain,
    bf16 and float32 calibrate + evaluate on the same weights, then InfFT."""
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersInfFTConfig, BurgersPipeline,
        BurgersPretrainConfig, generate_burgers_dataset, inference_finetune, pretrain)

    run = Run("burgers_infft", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    path = str(run.out / "burgers_val2.npz")
    with run.stage("datagen"):
        generate_burgers_dataset(path, **R["generate_burgers_dataset"], device=dev)
    run.tick("dataset generated")
    data = {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}

    pre = BurgersPretrainConfig(**run.seeded(R["BurgersPretrainConfig"]))
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **R["pretrain"], device=dev)
    run.tick(f"pretrain {R['pretrain']['num_steps']} steps done")

    results, phases = {}, []
    for dt in DTYPE_CHECK:
        conf = BurgersConformalConfig(**R["BurgersConformalConfig"])
        pipe = BurgersPipeline(conf, **{**R["BurgersPipeline"][0], "compute_dtype": dt},
                               device=dev)
        pipe.record = {}
        with run.stage(f"{dt}_calibrate"):
            Q = pipe.calibrate(state.ema_params, data["cal"].data, torch.zeros((), device=dev),
                               generator=run.gen(0))
        qs = run.q_std(pipe, Q, conf.alpha, "alpha")
        ms, _ = run.evals(dt, lambda g: pipe.evaluate(state.ema_params, data["test"], Q,
                                                      generator=g), 1)
        results[dt] = {"Q": float(Q), **ms[0]}
        jd = run.jax["dtype_check"][dt]
        phases.append(Phase(dt, ms, float(Q), qs, jd, jd["Q"]))
        run.tick(f"{dt}: Q={float(Q):.4f} J={ms[0]['control_mse_mean (J)']:.4f} "
                 f"R_t={ms[0]['time_exceed_ratio (R_t)']:.4f}")
        del pipe

    conf = BurgersConformalConfig(**R["BurgersConformalConfig"])
    pipe = BurgersPipeline(conf, **R["BurgersPipeline"][1], device=dev)
    pipe.record = {}
    cfg = BurgersInfFTConfig(**run.seeded(R["BurgersInfFTConfig"]))
    with run.stage("infft"):
        state2, Q2, hist = inference_finetune(cfg, pipe, state.ema_params, data["cal"],
                                              data["test"])
    run.tick(f"InfFT done, Q={float(Q2):.4f}")
    q_ft = run.q_std(pipe, Q2, conf.alpha, "alpha")
    mfs, _ = run.evals("infft", lambda g: pipe.evaluate(state2.ema_params, data["test"], Q2,
                                                        generator=g), 2)
    run.tick(f"eval after InfFT: {json.dumps(mfs[0])}")
    summary = {"dtype_check": results, "infft_eval": mfs[0], "infft_history": hist,
               "Q_infft": float(Q2)}
    phases.append(Phase("infft", mfs, float(Q2), q_ft, run.jax["infft_eval"], run.jax["Q_infft"]))

    # the script's dtype check: bf16 against float32 on the same weights and draws
    b, f = results["bfloat16"], results["float32"]
    dtype_rel = {k: abs(b[k] - f[k]) / abs(f[k]) for k in ("control_mse_mean (J)", "Q")}
    emit("DTYPE bf16 vs float32 relative difference: "
         + ", ".join(f"{k} {v:.3%}" for k, v in dtype_rel.items())
         + (" (within 1 %)" if max(dtype_rel.values()) <= 0.01 else " (over 1 %)"))
    return run.finish(summary, phases, HEADLINE["burgers"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[2])], extra=dict(dtype_rel=dtype_rel))


def run_tokamak_validation(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                           emit=print) -> dict:
    """experiments/run_tokamak_validation.py: closed-loop datagen, pretrain
    of the turbo UNet1D in bf16, calibrate + evaluate, then posttrain
    through run_inference."""
    from safediffcon_torch.tasks.tokamak import (
        TokamakConformalConfig, TokamakDataset, TokamakInferenceConfig, TokamakPipeline,
        TokamakPretrainConfig, generate_tokamak_dataset, pretrain, run_inference)

    run = Run("tokamak", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    path = str(run.out / "tok_val.npz")
    with run.stage("datagen"):
        generate_tokamak_dataset(path, **R["generate_tokamak_dataset"], device=dev)
    data = {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"dataset generated ({sum(len(d) for d in data.values())} closed-loop "
             f"trajectories)")

    pre = TokamakPretrainConfig(**run.seeded(R["TokamakPretrainConfig"]))
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **R["pretrain"], device=dev)
    run.tick(f"pretrain {R['pretrain']['num_steps']} steps done")

    conf = TokamakConformalConfig(**R["TokamakConformalConfig"])
    pipe = TokamakPipeline(conf, **R["TokamakPipeline"], device=dev)
    pipe.record = {}
    with run.stage("pretrain_calibrate"):
        Q = pipe.calibrate(state.ema_params, data["cal"], torch.zeros((), device=dev),
                           generator=run.gen(0))
    run.tick(f"Q-hat = {float(Q):.5f}")
    q_pre = run.q_std(pipe, Q, conf.alpha, "alpha")
    m0s, _ = run.evals("pretrain", lambda g: pipe.evaluate(state.ema_params, data["test"], Q,
                                                           generator=g), 1)
    run.tick(f"eval after pretrain: {json.dumps(m0s[0])}")

    cfg = TokamakInferenceConfig(conformal=conf, **run.seeded(R["TokamakInferenceConfig"]))
    with run.stage("posttrain"):
        params, Q2, hist = run_inference(cfg, pipe, state.ema_params, data["train"],
                                         data["cal"], data["test"])
    run.tick(f"posttrain done, Q={float(Q2):.5f}")
    q_post = run.q_std(pipe, Q2, conf.alpha, "alpha")
    # the script's posttrain eval is the last epoch's; the extra seeds follow
    m1 = hist[-1]["eval"]
    extra, _ = run.evals("posttrain", lambda g: pipe.evaluate(None, data["test"], Q2,
                                                              generator=g), None)
    m1s = [m1] + extra
    summary = {"pretrain_eval": m0s[0], "posttrain_eval": m1, "Q_pre": float(Q), "Q_post": float(Q2)}
    j = run.jax
    phases = [Phase("pretrain", m0s, float(Q), q_pre, j["pretrain_eval"], j["Q_pre"]),
              Phase("posttrain", m1s, float(Q2), q_post, j["posttrain_eval"], j["Q_post"])]
    return run.finish(summary, phases, HEADLINE["tokamak"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1])], extra=dict(posttrain_history=hist))


def run_2d_validation(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                      emit=print) -> dict:
    """experiments/run_2d_validation.py: smoke datagen (256-frame rollouts on
    K1), pretrain of a reduced UNet3D in bf16 (on K2 on the card),
    calibrate, evaluate through the 256-frame solver (K1)."""
    from safediffcon_torch.tasks.smoke import (
        SmokeConformalConfig, SmokeDataset, SmokePipeline, SmokePretrainConfig,
        generate_smoke_dataset, pretrain)

    run = Run("smoke", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    if run.cuda:
        from safediffcon_torch.ops import build

        with run.stage("build_kernels"):  # one nvcc per source, all together
            build.build_all(["pressure_cg", "conv3d_wgmma", "conv3d_simt"])
    path = str(run.out / "smoke_val.npz")
    with run.stage("datagen"):
        generate_smoke_dataset(path, **R["generate_smoke_dataset"], device=dev)
    data = {s: SmokeDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"dataset generated ({sum(len(d) for d in data.values())} sims x "
             f"{R['generate_smoke_dataset']['n_frames']} frames)")
    run.tick(f"train data {data['train'].data.shape}")

    pre = SmokePretrainConfig(**run.seeded(R["SmokePretrainConfig"]))
    steps = R["pretrain"]["num_steps"]
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **R["pretrain"], device=dev)
    run.tick(f"pretrain {steps} steps done")

    conf = SmokeConformalConfig(**R["SmokeConformalConfig"])
    pipe = SmokePipeline(conf, **R["SmokePipeline"], device=dev)
    pipe.model.load_state_dict(state.ema_params)
    pipe.record = {}
    with run.stage("pretrain_calibrate"):
        Q = pipe.calibrate(data["cal"], torch.zeros((), device=dev), generator=run.gen(0))
    run.tick(f"Q-hat = {float(Q):.5f}")
    q_std = run.q_std(pipe, Q, conf.alpha, "one_minus_alpha")
    ms, per_sample = run.evals("pretrain", lambda g: pipe.evaluate(data["test"], Q, generator=g),
                               1, record=pipe.record)
    run.tick(f"eval (solver rollout): {json.dumps(ms[0])}")
    emit(control_line("pretrain", per_sample, data["test"].raw, pipe.solver_kw["space_scale"]))
    # the evaluated weights, for the JAX package (tools/smoke_weight_swap.py)
    save_flax_npz(str(run.out / "smoke_ema_flax.npz"),
                  state_dict_to_flax(pipe.model, state.ema_params))
    summary = {"eval": ms[0], "Q": float(Q)}
    phases = [Phase("pretrain", ms, float(Q), q_std, run.jax["eval"], run.jax["Q"], per_sample)]
    launches = run.launches
    per_step = {m: c / steps for m, c in launches["pretrain"]["K2"].items()}
    emit(f"K2 per pretrain step: tensor cores {json.dumps(per_step)}, SIMT "
         f"{launches['pretrain']['K2_simt'] / steps:g}; K1: datagen "
         f"{launches['datagen']['K1']}, evaluate {launches['pretrain_evaluate']['K1']}")
    return run.finish(summary, phases, HEADLINE["smoke"], len(data["test"]))


def run_2d_posttrain_validation(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                                emit=print) -> dict:
    """experiments/run_2d_posttrain_validation.py: smoke datagen (seed 7, K1),
    pretrain of the dim-32 UNet3D in bf16 (K2 on the card), posttrain
    through run_inference (2 epochs), then the backward fine-tune (InfFT, one
    epoch on the test set, unguided) on a second pipeline; after each epoch
    the same weights and Q-hat are evaluated over the eval seeds."""
    from safediffcon_torch.tasks.smoke import (
        SmokeConformalConfig, SmokeDataset, SmokeInferenceConfig, SmokePipeline,
        SmokePretrainConfig, generate_smoke_dataset, pretrain, run_inference)

    run = Run("smoke_posttrain", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    if run.cuda:
        from safediffcon_torch.ops import build

        with run.stage("build_kernels"):  # one nvcc per source, all together
            build.build_all(["pressure_cg", "conv3d_wgmma", "conv3d_simt"])
    path = str(run.out / "smoke_val2.npz")
    with run.stage("datagen"):
        generate_smoke_dataset(path, **R["generate_smoke_dataset"], device=dev)
    run.tick("dataset generated")
    data = {s: SmokeDataset.load(path, s) for s in ("train", "cal", "test")}

    pre = SmokePretrainConfig(**run.seeded(R["SmokePretrainConfig"]))
    steps = R["pretrain"]["num_steps"]
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **R["pretrain"], device=dev)
    run.tick(f"pretrain {steps} steps done")

    def finetune(name, cfg, pipe, params, train, jax_hist):
        """run_inference with its epochs held against JAX's: after each
        epoch, its own evaluation (the script's) and the extra eval seeds on
        the same weights and Q-hat."""
        phases = []
        pipe.record = {}

        def on_epoch(rec):
            e = rec["epoch"]
            first = {k: [torch.cat(v).numpy().tolist()] for k, v in pipe.record.items()
                     if not k.startswith("cal_")}
            q = torch.tensor(rec["quantile"], device=dev)
            q_std = run.q_std(pipe, q, cfg.conformal.alpha, "one_minus_alpha")
            extra, per = run.evals(f"{name}{e}", lambda g: pipe.evaluate(data["test"], q,
                                                                         generator=g),
                                   None, record=pipe.record)
            for k in [k for k in pipe.record if not k.startswith("cal_")]:
                del pipe.record[k]  # the next epoch's evaluation starts afresh
            per_sample = {k: first[k] + per.get(k, []) for k in first}
            phases.append(Phase(f"{name}{e}", [rec["eval"]] + extra, rec["quantile"], q_std,
                                jax_hist[e]["eval"], jax_hist[e]["quantile"], per_sample))
            run.tick(f"{name} epoch {e}: Q={rec['quantile']:.5f} loss={rec['loss']} "
                     f"J_target={rec['eval']['J_target']:.5g} "
                     f"unsafe%={rec['eval']['unsafe_percentage']:.1f}")

        with run.stage(name):
            params, Q, hist = run_inference(cfg, pipe, params, train, data["cal"], data["test"],
                                            on_epoch=on_epoch)
        return params, Q, hist, phases

    conf = SmokeConformalConfig(**R["SmokeConformalConfig"])
    pipe = SmokePipeline(conf, **R["SmokePipeline"][0], device=dev)
    cfg = SmokeInferenceConfig(conformal=conf, **run.seeded(R["SmokeInferenceConfig"][0]))
    params, Q, hist, phases = finetune(
        "posttrain", cfg, pipe, state.ema_params, data["train"], run.jax["posttrain_history"])
    run.tick(f"posttrain done Q={float(Q):.5f}")
    del pipe

    bf = SmokeInferenceConfig(
        conformal=SmokeConformalConfig(**R["SmokeInferenceConfig.conformal"]),
        **run.seeded(R["SmokeInferenceConfig"][1]))
    pipe2 = SmokePipeline(bf.conformal, **R["SmokePipeline"][1], device=dev)
    _, Q2, hist2, phases2 = finetune(
        "backward", bf, pipe2, params, None, run.jax["backward_history"])
    run.tick(f"backward finetune done Q={float(Q2):.5f}")

    for ph in phases + phases2:
        emit(control_line(ph.name, ph.per_sample, data["test"].raw,
                          pipe2.solver_kw["space_scale"]))
    st = run.launches
    n_extra = max(eval_seeds, 1) - 1
    per_eval = {k: v["K1"] / n_extra for k, v in st.items()
                if k.endswith("_evaluate") and n_extra}
    emit(f"K2 per pretrain step: tensor cores "
         f"{json.dumps({m: c / steps for m, c in st['pretrain']['K2'].items()})}, SIMT "
         f"{st['pretrain']['K2_simt'] / steps:g}; K2 in posttrain "
         f"{sum(st['posttrain']['K2'].values()) + st['posttrain']['K2_simt']}, backward "
         f"{sum(st['backward']['K2'].values()) + st['backward']['K2_simt']}; K1: datagen "
         f"{st['datagen']['K1']}, posttrain (its {len(hist)} evaluations) "
         f"{st['posttrain']['K1']}, backward ({len(hist2)}) {st['backward']['K1']}, "
         f"per extra evaluation {json.dumps(per_eval)}")
    summary = {"posttrain_history": hist, "backward_history": hist2}
    return run.finish(summary, phases + phases2, HEADLINE["smoke_posttrain"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1])])


def burgers_fine_tuning(run: "Run", path: str, data: dict, params, names: Sequence[str]):
    """The Burgers scripts' phases after pretrain: calibrate + evaluate
    `params`, posttrain on the train subset, evaluate, InfFT, evaluate (the
    scripts' eval draws 1, 2, 3). Returns (name, Q-hat, its bootstrap std,
    the evaluations) per phase, in `names`, and the posttrain and InfFT
    histories."""
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersInfFTConfig, BurgersPipeline,
        BurgersPostTrainConfig, inference_finetune, posttrain)

    R, dev = run.recipe, run.device
    conf = BurgersConformalConfig(**R["BurgersConformalConfig"])
    pipe = BurgersPipeline(conf, **R["BurgersPipeline"], device=dev)
    pipe.record = {}
    out = []

    def phase(name, weights, Q, draw):
        q_std = run.q_std(pipe, Q, conf.alpha, "alpha")
        ms, _ = run.evals(name, lambda g: pipe.evaluate(weights, data["test"], Q, generator=g),
                          draw)
        run.tick(f"{name} eval: Q={float(Q):.4f} {json.dumps(ms[0])}")
        out.append((name, float(Q), q_std, ms))

    with run.stage("pretrain_calibrate"):
        Q = pipe.calibrate(params, data["cal"].data, torch.zeros((), device=dev),
                           generator=run.gen(0))
    phase(names[0], params, Q, 1)

    pt = BurgersPostTrainConfig(
        conformal=BurgersConformalConfig(**R["BurgersPostTrainConfig.conformal"]),
        **run.seeded(R["BurgersPostTrainConfig"]))
    ft = BurgersDataset.load(path, "train", **R["BurgersDataset.load"])
    with run.stage("posttrain"):
        state2, Q2, hist = posttrain(pt, pipe, params, ft, data["cal"], data["test"],
                                     **R["posttrain"])
    phase(names[1], state2.ema_params, Q2, 2)

    cfg = BurgersInfFTConfig(**run.seeded(R["BurgersInfFTConfig"]))
    with run.stage("infft"):
        state3, Q3, hist3 = inference_finetune(cfg, pipe, state2.ema_params, data["cal"],
                                               data["test"])
    phase(names[2], state3.ema_params, Q3, 3)
    return out, hist, hist3


def run_1d_long(scale="full", seed=None, eval_seeds=3, device="cuda", out=None, emit=print,
                state_dir: Optional[str] = None, pretrain_seconds: Optional[float] = None
                ) -> dict:
    """experiments/run_1d_long.py: Burgers datagen of 40,000 + 1,000 + 50,
    pretrain of the turbo UNet2D in bf16 for 20,000 steps (checkpoints in
    `state_dir`, resumed from its last one; stopped after
    `pretrain_seconds`), calibrate + evaluate, posttrain 3 x 400, evaluate,
    InfFT, evaluate. A pretrain stopped short returns before calibrating,
    with `pretrain_step` in its result and no comparison."""
    from safediffcon_torch.tasks.burgers import (
        BurgersDataset, BurgersPretrainConfig, generate_burgers_dataset, pretrain)

    run = Run("burgers_20k", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    path = str(run.out / "burgers_long.npz")
    with run.stage("datagen"):
        generate_burgers_dataset(path, **R["generate_burgers_dataset"], device=dev)
    data = {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"dataset generated ({sum(len(d) for d in data.values())})")

    pre = BurgersPretrainConfig(**run.seeded(R["BurgersPretrainConfig"]))
    kw = dict(R["pretrain"])
    script_ckpt = kw.pop("checkpoint_dir")  # the script's /tmp path; the port's is below
    ckpt = state_dir or str(run.out / Path(script_ckpt).name)
    deadline = None if pretrain_seconds is None else time.time() + pretrain_seconds
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **kw, checkpoint_dir=ckpt, resume_dir=ckpt,
                         deadline=deadline, device=dev)
    emit(f"PRETRAIN step {state.step} of {kw['num_steps']}, state dir {ckpt}")
    if state.step < kw["num_steps"]:
        emit(f"PRETRAIN stopped short: rerun with --state-dir {ckpt} to continue")
        return dict(recipe=run.name, pretrain_step=state.step, state_dir=ckpt,
                    stages=run.stages, launches=run.launches)

    names = ("pretrain20k", "posttrain", "posttrain_infft")
    res, hist, hist3 = burgers_fine_tuning(run, path, data, state.ema_params, names)
    j = run.jax
    phases = [Phase(n, ms, Q, q_std, j[n], j["Q"][i]) for i, (n, Q, q_std, ms) in enumerate(res)]
    summary = {"pretrain20k": res[0][3][0], "posttrain": res[1][3][0],
               "posttrain_infft": res[2][3][0], "Q": [r[1] for r in res]}
    return run.finish(summary, phases, HEADLINE["burgers_20k"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1]), (phases[1], phases[2])],
                      extra=dict(posttrain_history=hist, infft_history=hist3,
                                 state_dir=ckpt))


def burgers_refscale_pretrain(run: "Run", checkpoints: bool = True):
    """`burgers_refscale`'s datagen (the run's own `generate_burgers_dataset`
    arguments, the same in both recipes; only when its file is missing) and
    its pretrain at the run's scale and device (the turbo UNet2D in bf16 at
    batch 16 and lr 1e-5, ROUND2's 50,000 steps); with `checkpoints`, its
    checkpoints under the run's output directory, else none (the state stays
    in memory). Returns the data's path, its splits and the pretrained
    state."""
    from safediffcon_torch.tasks.burgers import (
        BurgersDataset, BurgersPretrainConfig, generate_burgers_dataset, pretrain)
    from safediffcon_torch.tasks.burgers import task as BT

    R, dev = recipe("burgers_refscale", run.scale, run.device), run.device
    kw = run.recipe["generate_burgers_dataset"]
    path = data_file(run, str(run.out / "burgers_ref.npz"),
                     lambda p: generate_burgers_dataset(p, **kw, device=dev),
                     split_shapes(kw, u=(BT.NT, BT.NX), f=(BT.NT - 1, BT.NX)))
    data = {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"splits loaded ({sum(len(d) for d in data.values())})")

    pre = BurgersPretrainConfig(**run.seeded(R["BurgersPretrainConfig"]))
    kw = (run.in_out(R["pretrain"]) if checkpoints else
          {k: v for k, v in R["pretrain"].items() if k not in ("checkpoint_dir", "resume_dir")})
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **kw, device=dev)
    run.tick(f"pretrain {state.step} steps done")
    return path, data, state


def run_1d_refscale(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                    emit=print) -> dict:
    """experiments/run_1d_refscale.py at its round-2 size (ROUND2): Burgers
    datagen of 40,000 + 1,000 + 50, pretrain of the turbo UNet2D in bf16 at
    batch 16 and lr 1e-5 for 50,000 steps (checkpoints under `out`),
    calibrate + evaluate, posttrain 5 x 3,200 at batch 32, evaluate, InfFT,
    evaluate."""
    run = Run("burgers_refscale", device, scale, seed, eval_seeds, out, emit)
    path, data, state = burgers_refscale_pretrain(run)

    names = ("pretrain", "posttrain", "infft")
    res, hist, hist3 = burgers_fine_tuning(run, path, data, state.ema_params, names)
    j = run.jax
    phases = [Phase(n, ms, Q, q_std, j[f"{n}_eval"], j[f"Q_{n}"]) for n, Q, q_std, ms in res]
    summary = {"pretrain_steps": run.recipe["pretrain"]["num_steps"]}
    for n, Q, _, ms in res:
        summary[f"{n}_eval"], summary[f"Q_{n}"] = ms[0], Q
    return run.finish(summary, phases, HEADLINE["burgers_refscale"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1]), (phases[1], phases[2])],
                      extra=dict(posttrain_history=hist, infft_history=hist3))


def run_1d_dpm_refscale(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                        emit=print) -> dict:
    """experiments/run_1d_dpm_refscale_r4.py: `burgers_refscale`'s datagen
    and round-2 pretrain (50,000 steps; the EMA kept in memory, no
    checkpoint), then per sampler arm (`variants`: DDIM 200, stochastic DDIM
    20 and 50, DPM-Solver++ 2M at 50 and 20) a pipeline of that sampler that
    calibrates the EMA at Q = 0 and evaluates it over the eval seeds (the
    script's keys 5000 + s). Per arm the JAX run's J, R_p, R_s, R_t and
    Q-hat are compared (COMPARE), each few-step arm's J minus DDIM 200's
    set beside JAX's (FEWSTEP), and the route its calls took printed
    (ROUTE: the graphs the pipeline captured and replayed in each)."""
    from safediffcon_torch.tasks.burgers import BurgersConformalConfig, BurgersPipeline

    run = Run("burgers_dpm_refscale", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    _, data, state = burgers_refscale_pretrain(run, checkpoints=False)
    params = state.ema_params
    del state
    results, phases, routes = {}, [], {}
    # each arm under its JAX result's name (at --scale tiny: fewer steps)
    for (sampler, steps), (s0, n0) in zip(R["variants"], BURGERS_DPM_REFSCALE["variants"]):
        key = f"{s0}{n0}"
        conf = BurgersConformalConfig(**{**R["BurgersConformalConfig"], "sampler": sampler,
                                         "ddim_sampling_steps": steps})
        pipe = BurgersPipeline(conf, **R["BurgersPipeline"], device=dev)
        pipe.record = {}
        with run.stage(f"{key}_calibrate"):
            Q = pipe.calibrate(params, data["cal"].data, torch.full((), DPM_CALIBRATE_Q,
                                                                      device=dev),
                               generator=run.gen(DPM_CALIBRATE_KEY))
        q_std = run.q_std(pipe, Q, conf.alpha, "alpha")
        routes[key] = {"calibrate": pipe.graphs.counts()}
        pipe.graphs.clear()
        ms, times = [], []
        for s in range(run.eval_seeds):
            t = time.perf_counter()
            with run.stage(f"{key}_evaluate"):
                ms.append(pipe.evaluate(params, data["test"], Q,
                                        generator=run.gen(DPM_EVAL_KEY_BASE + s)))
            times.append(time.perf_counter() - t)
            run.tick(f"{key} seed {s}: {json.dumps(ms[-1])}")
        routes[key]["evaluate"] = pipe.graphs.counts()
        del pipe
        emit(f"ROUTE {key}: " + ", ".join(
            f"{k} {v['graphs']} graphs captured, {v['replays']} replays"
            for k, v in routes[key].items()))
        agg = {k: {"mean": float(np.mean([m[k] for m in ms])),
                   "std": float(np.std([m[k] for m in ms]))} for k in ms[0]}
        results[key] = {"sampler": sampler, "steps": steps, "Q": float(Q),
                        "calibrate_s": run.stages[f"{key}_calibrate"], "per_seed": ms,
                        "agg": agg, "eval_s_first": times[0],
                        "eval_s_steady": float(np.mean(times[1:])) if len(times) > 1 else None}
        jax = run.jax[key]
        phases.append(Phase(key, ms, float(Q), q_std,
                            {k: v["mean"] for k, v in jax["agg"].items()}, jax["Q"]))
        run.tick(f"{key}: J={agg['control_mse_mean (J)']['mean']:.5f} Q={float(Q):.4f}")
    j_name = "control_mse_mean (J)"
    few = {}
    base = results[DPM_BASELINE]["agg"][j_name]["mean"]
    jax_base = run.jax[DPM_BASELINE]["agg"][j_name]["mean"]
    for key, res in results.items():
        if key == DPM_BASELINE:
            continue
        port = res["agg"][j_name]["mean"] - base
        jax = run.jax[key]["agg"][j_name]["mean"] - jax_base
        few[key] = dict(port=port, jax=jax, port_rel=port / base, jax_rel=jax / jax_base)
        emit(f"FEWSTEP {key} J - {DPM_BASELINE} J: port {port:+.6g} ({port / base:+.1%}) | "
             f"jax {jax:+.6g} ({jax / jax_base:+.1%})")
    return run.finish(results, phases, HEADLINE["burgers_dpm_refscale"], len(data["test"]),
                      extra=dict(fewstep=few, routes=routes))


def run_tokamak_refscale(scale="full", seed=None, eval_seeds=3, device="cuda", out=None,
                         emit=print) -> dict:
    """experiments/run_tokamak_refscale.py as it ran for round 2 (ROUND2):
    closed-loop datagen of 48,950 + 1,000 + 50 (when `<out>/tok_ref.npz` is
    missing), pretrain of the turbo UNet1D in bf16 at batch 32 for 20,000
    steps (checkpoints under `out`),
    calibrate + evaluate at `posttrain_config()`'s conformal settings,
    post-training (`posttrain_config()`, 8 epochs), then the backward
    fine-tune (`finetune_config()`, 5 epochs on the test set) from the
    posttrained weights on a pipeline whose calibration weights carry the
    posttrain Q-hat's composite factor. The posttrain and fine-tune values
    are each phase's last epoch's evaluation, then the extra eval seeds."""
    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPipeline, TokamakPretrainConfig, finetune_config,
        generate_tokamak_dataset, posttrain_config, pretrain, run_inference)
    from safediffcon_torch.tasks.tokamak import task as TT

    run = Run("tokamak_refscale", device, scale, seed, eval_seeds, out, emit)
    R, dev = run.recipe, run.device
    kw = R["generate_tokamak_dataset"]
    path = data_file(run, str(run.out / "tok_ref.npz"),
                     lambda p: generate_tokamak_dataset(p, **kw, device=dev),
                     split_shapes(kw, states=(TT.NT, TT.N_STATES),
                                  actions=(TT.NT - 1, TT.N_ACTIONS)))
    data = {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}
    run.tick(f"splits loaded: {', '.join(f'{s}={len(d)}' for s, d in data.items())}")

    pre = TokamakPretrainConfig(**run.seeded(R["TokamakPretrainConfig"]))
    with run.stage("pretrain"):
        state = pretrain(pre, data["train"], **run.in_out(R["pretrain"]), device=dev)
    run.tick(f"pretrain {state.step} steps done")

    def fine_tune(name, cfg, pipe, params):
        """run_inference, then the extra eval seeds on its weights and Q-hat."""
        pipe.record = {}
        with run.stage(name):
            params, Q, hist = run_inference(cfg, pipe, params, data["train"], data["cal"],
                                            data["test"])
        q_std = run.q_std(pipe, Q, cfg.conformal.alpha, "alpha")
        extra, _ = run.evals(name, lambda g: pipe.evaluate(params, data["test"], Q, generator=g),
                             None)
        run.tick(f"{name} done: Q={float(Q):.4f} {json.dumps(hist[-1]['eval'])}")
        return params, float(Q), q_std, [hist[-1]["eval"]] + extra, hist

    pt = configured(posttrain_config(), run.seeded(R["posttrain_config"]))
    pipe = TokamakPipeline(pt.conformal, **R["TokamakPipeline"], device=dev)
    pipe.record = {}
    with run.stage("pretrain_calibrate"):
        Q0 = pipe.calibrate(state.ema_params, data["cal"], torch.zeros((), device=dev),
                            generator=run.gen(0))
    q0_std = run.q_std(pipe, Q0, pt.conformal.alpha, "alpha")
    m0s, _ = run.evals("pretrain", lambda g: pipe.evaluate(state.ema_params, data["test"], Q0,
                                                           generator=g), 1)
    run.tick(f"pretrain eval: Q={float(Q0):.4f} {json.dumps(m0s[0])}")
    params_pt, Q_pt, q_pt_std, m1s, hist_pt = fine_tune("posttrain", pt, pipe, state.ema_params)
    del pipe, state

    ft = configured(finetune_config(), run.seeded(R["finetune_config"]))
    computed = {"finetune_quantile": Q_pt, "finetune_w_obj": pt.conformal.w_obj,
                "finetune_w_safe": pt.conformal.w_safe,
                "finetune_guidance_scaler": pt.conformal.guidance_scaler}
    conformal = {k: computed[k] if isinstance(v, ScriptExpr) else v
                 for k, v in R["replace.conformal"].items()}
    ft = dataclasses.replace(ft, conformal=dataclasses.replace(ft.conformal, **conformal))
    pipe_ft = TokamakPipeline(ft.conformal, **R["TokamakPipeline"], device=dev)
    _, Q_ft, q_ft_std, m2s, hist_ft = fine_tune("finetune", ft, pipe_ft, params_pt)

    summary = {"pretrain_eval": m0s[0], "Q_pretrain": float(Q0),
               "posttrain_history": hist_pt, "posttrain_eval": m1s[0], "Q_posttrain": Q_pt,
               "finetune_history": hist_ft, "finetune_eval": m2s[0], "Q_finetune": Q_ft}
    j = run.jax
    phases = [Phase("pretrain", m0s, float(Q0), q0_std, j["pretrain_eval"], j["Q_pretrain"]),
              Phase("posttrain", m1s, Q_pt, q_pt_std, j["posttrain_eval"], j["Q_posttrain"]),
              Phase("finetune", m2s, Q_ft, q_ft_std, j["finetune_eval"], j["Q_finetune"])]
    return run.finish(summary, phases, HEADLINE["tokamak_refscale"], len(data["test"]),
                      sign_pairs=[(phases[0], phases[1]), (phases[1], phases[2])],
                      extra=dict(finetune_conformal=dataclasses.asdict(ft.conformal)))


RUNS = {"burgers": run_1d_validation, "burgers_infft": run_1d_infft_validation,
        "tokamak": run_tokamak_validation, "smoke": run_2d_validation,
        "smoke_posttrain": run_2d_posttrain_validation, "burgers_20k": run_1d_long,
        "tokamak_refscale": run_tokamak_refscale, "burgers_refscale": run_1d_refscale,
        "burgers_dpm_refscale": run_1d_dpm_refscale}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m safediffcon_torch.experiments.round1",
        description="The JAX package's round-1 and reference-scale validation runs on the "
                    "port, held against its recorded results")
    ap.add_argument("recipe", choices=sorted(RUNS))
    ap.add_argument("--seed", type=int, default=None,
                    help="training seed (default: the configs' own)")
    ap.add_argument("--eval-seeds", type=int, default=3,
                    help="evaluations of each phase's weights (default 3)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", default="full", choices=("full", "tiny"))
    ap.add_argument("--out", default=None, help="data and results directory "
                    "(default build/round1/<recipe>)")
    ap.add_argument("--state-dir", default=None,
                    help="burgers_20k: pretrain checkpoints, resumed from (default "
                         "<out>/b_long_ckpt)")
    ap.add_argument("--pretrain-seconds", type=float, default=None,
                    help="burgers_20k: stop pretraining after this many seconds, with a "
                         "checkpoint")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to run on the CPU")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    extra = {}
    if args.recipe == "burgers_20k":
        extra = dict(state_dir=args.state_dir, pretrain_seconds=args.pretrain_seconds)
    elif args.state_dir is not None or args.pretrain_seconds is not None:
        ap.error("--state-dir and --pretrain-seconds are burgers_20k's")
    RUNS[args.recipe](scale=args.scale, seed=args.seed, eval_seeds=args.eval_seeds,
                      device=args.device, out=args.out,
                      emit=lambda line: print(line, flush=True), **extra)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
