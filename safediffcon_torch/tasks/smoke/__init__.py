"""2D smoke control task plugin: pretraining, posttrain / InfFT, serving."""
from safediffcon_torch.tasks.smoke.task import (
    FRAMES,
    RESCALER,
    SIZE,
    SmokeConditioner,
    SmokeTaskConfig,
)
from safediffcon_torch.tasks.smoke.config import (
    SmokeConformalConfig,
    SmokeInferenceConfig,
    SmokePretrainConfig,
    finetune_config,
    posttrain_config,
)
from safediffcon_torch.tasks.smoke.data import SmokeDataset, generate_smoke_dataset
from safediffcon_torch.tasks.smoke.pipeline import (
    SmokePipeline,
    make_finetune_steps,
    pretrain,
    run_inference,
    run_inference_resilient,
)
