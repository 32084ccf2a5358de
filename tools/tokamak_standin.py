#!/usr/bin/env python3
"""Train a dim-32 stand-in of the `tokamak_refscale` recipe's UNet1D on the
card and calibrate it there; its EMA is small enough (16 MB) to come back
from a chip call, where the dim-128 EMA (0.23 GB) is not.

It reads the recipe's data (`python -m safediffcon_torch.experiments.round1
tokamak_refscale --out build/ref/tokamak_refscale` writes it), pretrains at
the recipe's other settings (batch 32, bf16, 20,000 captured steps in
chunks of 50), saves the EMA as a flax npz and the calibration's scores and
weights in the directory given (default `build/standin`; on a remote card,
one whose files come back), and prints one `SURROGATE {...}` line: the
pretrain's seconds, the card's Q-hat at Q = 0 with `posttrain_config()`'s
conformal settings (one chunk of 1,000, the card's own draws) and the
evaluation of the test split. `tools/tokamak_weight_swap.py --weights`
holds JAX and the port to each other on the saved EMA on the CPU.

    python tools/tokamak_standin.py [OUT_DIR]   # from the repository root, on the card
"""
import json
import os
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

from safediffcon_torch.models.convert import save_flax_npz, state_dict_to_flax
from safediffcon_torch.tasks.tokamak import (TokamakDataset, TokamakPipeline,
                                             TokamakPretrainConfig, posttrain_config, pretrain)

out = sys.argv[1] if len(sys.argv) > 1 else "build/standin"
os.makedirs(out, exist_ok=True)
path = "build/ref/tokamak_refscale/tok_ref.npz"
data = {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}
cfg = TokamakPretrainConfig(dim=32, batch_size=32, checkpoint_every=10**9,
                            compute_dtype="bfloat16")
t = time.perf_counter()
state = pretrain(cfg, data["train"], num_steps=20000, log_every=5000, steps_per_call=50,
                 device="cuda")
torch.cuda.synchronize()
pre_s = time.perf_counter() - t
conf = posttrain_config().conformal
pipe = TokamakPipeline(conf, dim=32, compute_dtype="bfloat16", cal_chunk=1000, device="cuda")
save_flax_npz(os.path.join(out, "tok_dim32_ema.npz"), state_dict_to_flax(pipe.model, state.ema_params))
pipe.record = {}
q = pipe.calibrate(state.ema_params, data["cal"], torch.zeros((), device="cuda"),
                   generator=torch.Generator(device="cuda").manual_seed(0))
m = pipe.evaluate(state.ema_params, data["test"], q,
                  generator=torch.Generator(device="cuda").manual_seed(1))
np.savez(os.path.join(out, "tok_dim32_cal.npz"), scores=pipe.record["cal_scores"].numpy(),
         weights=pipe.record["cal_weights"].numpy())
print("SURROGATE " + json.dumps(dict(pretrain_s=pre_s, Q=float(q), eval=m)), flush=True)
