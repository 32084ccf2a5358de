"""1D Burgers control task plugin: pretraining, posttrain / InfFT, serving."""
from safediffcon_torch.tasks.burgers.task import (
    COND_IDX,
    NT,
    NX,
    PAD_SIZE,
    SCALER,
    BurgersConditioner,
    BurgersTaskConfig,
    guidance_grad_fn,
    guidance_values,
    safety_statistic,
    shift_weights,
)
from safediffcon_torch.tasks.burgers.config import (
    BurgersConformalConfig,
    BurgersInfFTConfig,
    BurgersPostTrainConfig,
    BurgersPretrainConfig,
)
from safediffcon_torch.tasks.burgers.data import BurgersDataset, generate_burgers_dataset
from safediffcon_torch.tasks.burgers.pipeline import (
    BurgersPipeline,
    inference_finetune,
    inference_finetune_resilient,
    infft_step,
    posttrain,
    posttrain_resilient,
    pretrain,
    weighted_step,
)
