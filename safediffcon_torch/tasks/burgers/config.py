"""Config dataclasses for the 1D Burgers task.

Same fields and defaults as `safediffcon_tpu/tasks/burgers/config.py`, which
mirror the reference reproduce runs (reference:
1D/configs/train_config.py:69-77, 1D/configs/posttrain_config.py:116-127,
1D/configs/inference_config.py:117-134, 1D/scripts/reproduce_InfFT.sh).
`BurgersPostTrainConfig.steps_per_call` chunks post-training's steps inside
each evaluation segment (`pipeline.posttrain`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BurgersPretrainConfig:
    # model ("turbo" preset)
    dim: int = 128
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    resnet_block_groups: int = 1
    # diffusion
    timesteps: int = 1000
    beta_schedule: str = "cosine"
    objective: str = "pred_noise"
    # training (reference: 1D/model/trainer.py:27-41,80-81)
    train_num_steps: int = 200_000
    batch_size: int = 16
    lr: float = 1e-5
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    cosine_t_max: int = 10_000
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    checkpoint_every: int = 1000
    use_max_safety: bool = True
    gradient_accumulate_every: int = 1
    compute_dtype: str = None  # or "bfloat16"
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class BurgersConformalConfig:
    """Shared posttrain/InfFT settings (reference: 1D/configs/*_config.py)."""

    u_bound: float = 0.8
    use_max_safety: bool = True
    alpha: float = 0.98
    n_cal_samples: int = 1000
    cal_batch_size: int = 250
    num_cal_batch: int = 4
    n_test_samples: int = 50
    test_batch_size: int = 50
    # sampling
    ddim_sampling_steps: int = 200
    ddim_eta: float = 1.0
    timesteps: int = 1000
    sampler: str = "ddim"  # "ddim" | "dpm" (DPM-Solver++ 2M, fewer steps)
    # dpm only: RePaint-style noise-matched condition imposition at
    # intermediate steps (core/diffusion.py::DiffusionConfig)
    dpm_noise_matched_cond: bool = False
    # guidance
    w_score: float = 500.0  # reproduce-ft preset (1D/configs/inference_config.py:118-123)
    J_scheduler: Optional[str] = None  # "constant"
    # composite calibration weight: multiply a second exp(-guidance(x, InfFT_Q))
    # factor when set (reference: 1D/inference/conformal.py:67-73,
    # 1D/configs/inference_config.py:46)
    InfFT_Q: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BurgersPostTrainConfig:
    conformal: BurgersConformalConfig = BurgersConformalConfig(w_score=2500.0)
    finetune_epoch: int = 5
    finetune_steps: int = 3200
    finetune_batch_size: int = 380
    finetune_subset_size: int = 10_240
    finetune_lr: float = 1e-4
    weight_decay: float = 1e-4
    cosine_epoch: int = 4
    optimizer: str = "adamw"
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    seed: int = 42
    # optimizer steps per chunk: one host-to-device copy of the chunk's
    # batches and weights, its steps back to back
    steps_per_call: int = 1


@dataclasses.dataclass(frozen=True)
class BurgersInfFTConfig:
    conformal: BurgersConformalConfig = BurgersConformalConfig(w_score=500.0)
    InfFT_iters: int = 3
    finetune_lr: float = 1e-5
    weight_decay: float = 1e-4
    cosine_ratio: float = 1.0
    optimizer: str = "adamw"
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    seed: int = 5169  # reference: 1D/run_inference_ft.py:18
