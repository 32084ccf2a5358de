#!/usr/bin/env python3
"""Train a dim-32 stand-in of the `burgers_dpm_refscale` recipe's UNet2D on
the card, and run the recipe's DDIM 200 and DPM-Solver++ 50 arms on it
there; its EMA is small enough to come back from a chip call, where the
dim-128 EMA is not.

It generates the recipe's data (40,000 + 1,000 + 50 sims, seed 0),
pretrains the stand-in in bf16 at batch 16 (10,000 captured steps in chunks
of 50, at lr 1e-4: ten times the recipe's, for a fifth of its steps), saves
the EMA as a flax npz in the directory given (default `build/b_standin`;
on a remote card, one whose files come back), and then, per arm, a
pipeline of that sampler calibrates the EMA at Q = 0 (the 1,000 cal sims,
generator seed 0) and evaluates it on the 50 test sims at generator seeds
5000-5002, as the recipe does. Printed: one `ARM {...}` line per arm (Q-hat,
the metrics' means over the seeds) and a last JSON line with DPM 50's J over
DDIM 200's. `tools/burgers_sampler_swap.py` holds JAX and the port to each
other on the saved EMA on the CPU.

    python tools/burgers_standin.py [OUT_DIR]   # from the repository root, on the card
"""
import json
import os
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

from safediffcon_torch.experiments.round1 import card_line
from safediffcon_torch.models.convert import save_flax_npz, state_dict_to_flax
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig, BurgersDataset, BurgersPipeline, BurgersPretrainConfig,
    generate_burgers_dataset, pretrain)

DIM, STEPS, LR = 32, 10_000, 1e-4
ARMS = (("ddim", 200), ("dpm", 50))
J = "control_mse_mean (J)"

out = sys.argv[1] if len(sys.argv) > 1 else "build/b_standin"
os.makedirs(out, exist_ok=True)
os.makedirs("build", exist_ok=True)
path = os.path.join("build", "b_standin_data.npz")
t = time.perf_counter()
generate_burgers_dataset(path, n_train=40000, n_cal=1000, n_test=50, seed=0, device="cuda")
data = {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}
gen_s = time.perf_counter() - t
cfg = BurgersPretrainConfig(dim=DIM, batch_size=16, lr=LR, checkpoint_every=10**9,
                            compute_dtype="bfloat16")
t = time.perf_counter()
state = pretrain(cfg, data["train"], num_steps=STEPS, log_every=2000, steps_per_call=50,
                 device="cuda")
torch.cuda.synchronize()
pre_s = time.perf_counter() - t
params = state.ema_params
arms = {}
for sampler, steps in ARMS:
    conf = BurgersConformalConfig(w_score=500.0, sampler=sampler, ddim_sampling_steps=steps)
    pipe = BurgersPipeline(conf, dim=DIM, compute_dtype="bfloat16", cal_chunk=250,
                           device="cuda")
    if not arms:
        save_flax_npz(os.path.join(out, "burgers_dim32_ema.npz"),
                      state_dict_to_flax(pipe.model, params))
    t = time.perf_counter()
    q = pipe.calibrate(params, data["cal"].data, torch.zeros((), device="cuda"),
                       generator=torch.Generator(device="cuda").manual_seed(0))
    ms = [pipe.evaluate(params, data["test"], q,
                        generator=torch.Generator(device="cuda").manual_seed(5000 + s))
          for s in range(3)]
    line = dict(arm=f"{sampler}{steps}", Q=float(q), seconds=time.perf_counter() - t,
                **{k: float(np.mean([m[k] for m in ms])) for k in ms[0]})
    arms[line["arm"]] = line
    print("ARM " + json.dumps(line), flush=True)
    del pipe
print(json.dumps(dict(card=card_line(), datagen_s=gen_s, pretrain_s=pre_s, steps=STEPS,
                      dim=DIM, lr=LR, arms=arms,
                      dpm50_j_over_ddim200=arms["dpm50"][J] / arms["ddim200"][J] - 1)),
      flush=True)
