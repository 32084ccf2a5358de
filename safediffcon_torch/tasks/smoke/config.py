"""Config dataclasses for the 2D smoke task.

Same fields and defaults as `safediffcon_tpu/tasks/smoke/config.py`, which
mirror the reference reproduce runs (reference: 2d/train_2d.py:26-76,
2d/scripts/{train,posttrain,finetune}.sh). `device_pool` > 0 holds a
bfloat16 pool of train sims on the device in post-training
(`pipeline.run_inference`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SmokePretrainConfig:
    # model (reference: 2d/train_2d.py:43-55)
    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    # diffusion (reference: diffusion_2d.py defaults — sigmoid betas, l2)
    timesteps: int = 1000
    beta_schedule: str = "sigmoid"
    objective: str = "pred_noise"
    # training (reference: 2d/ddpm/diffusion_2d.py:462-643)
    train_num_steps: int = 200_000
    batch_size: int = 16
    lr: float = 1e-3
    lr_milestones: Tuple[int, ...] = (50_000, 150_000, 300_000)
    lr_gamma: float = 0.1
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    checkpoint_every: int = 10_000
    gradient_accumulate_every: int = 1
    compute_dtype: str = None
    remat_policy: str = "full"
    conv_impl: str = "xla"  # "xla" (framework conv) | "pallas" (fused 3x3x3 kernel)
    attn_impl: str = "packed"
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class SmokeConformalConfig:
    sampler: str = "ddim"  # "ddim" | "dpm" (DPM-Solver++ 2M, fewer steps)
    safe_bound: float = 0.1
    alpha: float = 0.04  # inverted (1-alpha) convention
    w_safe: float = 0.9
    standard_fixed_ratio: float = 100.0
    finetune_standard_fixed_ratio: float = 0.0
    cal_batch_size: int = 50
    num_cal_batch: int = 4
    n_test_samples: int = 50
    test_batch_size: int = 50
    use_guidance: bool = True
    ddim_sampling_steps: int = 100
    ddim_eta: float = 1.0
    timesteps: int = 1000
    beta_schedule: str = "sigmoid"


@dataclasses.dataclass(frozen=True)
class SmokeInferenceConfig:
    """Unified post-train / backward-finetune config
    (reference: 2d/scripts/posttrain.sh, 2d/scripts/finetune.sh)."""

    conformal: SmokeConformalConfig = SmokeConformalConfig()
    backward_finetune: bool = False
    finetune_lr: float = 1e-4
    finetune_epoch: int = 8
    finetune_steps: int = 4000
    finetune_batch_size: int = 14
    seed: int = 42
    device_pool: int = 0  # post-training: train sims held on the device in bf16


def posttrain_config() -> SmokeInferenceConfig:
    return SmokeInferenceConfig(
        conformal=SmokeConformalConfig(
            alpha=0.04, standard_fixed_ratio=100.0, w_safe=0.9,
            cal_batch_size=50, num_cal_batch=4,
        ),
        finetune_lr=1e-4, finetune_epoch=8, finetune_steps=4000,
    )


def finetune_config() -> SmokeInferenceConfig:
    return SmokeInferenceConfig(
        conformal=SmokeConformalConfig(
            alpha=0.01, standard_fixed_ratio=495.0, w_safe=1.0,
            cal_batch_size=40, num_cal_batch=1,
        ),
        backward_finetune=True, finetune_epoch=4, finetune_steps=1,
    )
