"""Config dataclasses for the tokamak task.

Same fields and defaults as `safediffcon_tpu/tasks/tokamak/config.py`, which
mirror the reference reproduce runs (reference:
tokamak/configs/pretrain_config.py, tokamak/configs/inference_config.py,
tokamak/scripts/posttrain.sh, tokamak/scripts/finetune.sh).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TokamakPretrainConfig:
    # model ("turbo" preset; "large" is dim 256)
    dim: int = 128
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    resnet_block_groups: int = 1
    # diffusion
    timesteps: int = 1000
    beta_schedule: str = "cosine"
    objective: str = "pred_noise"
    # training (reference: tokamak/model/trainer.py:27-41)
    train_num_steps: int = 200_000
    batch_size: int = 16
    lr: float = 1e-4
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    cosine_t_max: int = 10_000
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    checkpoint_every: int = 1000
    gradient_accumulate_every: int = 1
    compute_dtype: str = None  # or "bfloat16"
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class TokamakConformalConfig:
    """Shared posttrain/finetune settings (reference: tokamak/configs/inference_config.py)."""

    safety_threshold: float = 4.98
    alpha: float = 0.9
    n_cal_samples: int = 1000
    cal_batch_size: int = 1000
    num_cal_batch: int = 1
    n_test_samples: int = 50
    test_batch_size: int = 50
    # sampling
    ddim_sampling_steps: int = 200
    ddim_eta: float = 1.0
    timesteps: int = 1000
    sampler: str = "ddim"  # "ddim" | "dpm" (DPM-Solver++ 2M, fewer steps)
    # guidance
    w_obj: float = 0.0
    w_safe: float = 1.0
    guidance_scaler: float = 1.0
    use_guidance: bool = False  # guidance during test sampling
    J_scheduler: Optional[str] = None
    # composite calibration-weight factors
    # (reference: tokamak/inference/conformal.py:84-100). finetune_set is
    # which split the finetune loop consumes ('train' = post-training,
    # 'test' = backward finetune); wo_post_train is False when the model was
    # loaded from a posttrain checkpoint, whose embedded quantile / guidance
    # hyperparameters become the finetune_* factors
    # (reference: tokamak/utils/common.py:146-154).
    finetune_set: str = "train"
    wo_post_train: bool = True
    finetune_quantile: Optional[float] = None
    finetune_w_obj: float = 0.0
    finetune_w_safe: float = 1.0
    finetune_guidance_scaler: float = 1.0


@dataclasses.dataclass(frozen=True)
class TokamakInferenceConfig:
    """Unified post-train / backward-finetune pipeline config
    (reference: tokamak/inference/pipeline.py + scripts).

    backward_finetune=False -> weighted-loss post-training on the train set
    (posttrain.sh: guidance_scaler 5, lr 7e-6, 8 epochs x 1 step);
    backward_finetune=True -> InfFT on test samples
    (finetune.sh: DDIM 250, lr 9e-6, scaler .01, 5 epochs).
    """

    conformal: TokamakConformalConfig = TokamakConformalConfig()
    backward_finetune: bool = False
    optimizer: str = "adam"  # Adam betas (0.99, 0.999), no EMA, no clip
    finetune_lr: float = 7e-6
    finetune_epoch: int = 8
    finetune_steps: int = 1
    train_batch_size: int = 1000
    loss_weight_train: float = 1.0
    loss_weight_test: float = 0.0
    seed: int = 42


def posttrain_config() -> TokamakInferenceConfig:
    return TokamakInferenceConfig(
        conformal=TokamakConformalConfig(guidance_scaler=5.0),
        finetune_lr=7e-6,
        finetune_epoch=8,
    )


def finetune_config() -> TokamakInferenceConfig:
    return TokamakInferenceConfig(
        conformal=TokamakConformalConfig(
            ddim_sampling_steps=250, guidance_scaler=0.01
        ),
        backward_finetune=True,
        finetune_lr=9e-6,
        finetune_epoch=5,
    )
