"""Tokamak KSTAR control task plugin: pretraining, calibration, evaluation,
posttrain / InfFT."""
from safediffcon_torch.tasks.tokamak.task import (
    NT,
    PAD_SIZE,
    SCALER,
    TokamakConditioner,
    TokamakTaskConfig,
)
from safediffcon_torch.tasks.tokamak.config import (
    TokamakConformalConfig,
    TokamakInferenceConfig,
    TokamakPretrainConfig,
    finetune_config,
    posttrain_config,
)
from safediffcon_torch.tasks.tokamak.data import TokamakDataset, generate_tokamak_dataset
from safediffcon_torch.tasks.tokamak.pipeline import (
    TokamakPipeline,
    make_finetune_steps,
    pretrain,
    run_inference,
    run_inference_resilient,
)
