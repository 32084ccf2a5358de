#!/usr/bin/env python3
"""Time the captured Burgers pretrain at the `burgers_refscale` recipe's
settings (dim 128, batch 16, lr 1e-5, bf16, chunks of 50) on 2,048 sims:
one call of 100 steps, then one of 1,000, each line of its log giving the
steps/s since the call began. Prints one `PROBE_B16 {...}` line.

`steady_steps_per_s` (the 900 steps the longer call adds over the shorter)
overstates the rate: the first call also pays the process's one-time costs.
The steady rate is the one between two log lines of the longer call.

    python tools/burgers_pretrain_probe.py   # from the repository root, on the card
"""
import json
import logging
import sys
import time

sys.path.insert(0, ".")
import torch

from safediffcon_torch.tasks.burgers import (BurgersDataset, BurgersPretrainConfig,
                                             generate_burgers_dataset, pretrain)

logging.basicConfig(level=logging.INFO)
path = "build/probe_b16.npz"
generate_burgers_dataset(path, n_train=2048, n_cal=8, n_test=8, seed=0, device="cuda")
train = BurgersDataset.load(path, "train")
cfg = BurgersPretrainConfig(dim=128, batch_size=16, lr=1e-5, checkpoint_every=50_000,
                            compute_dtype="bfloat16")
out = {}
for steps in (100, 1000):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = pretrain(cfg, train, num_steps=steps, log_every=250, steps_per_call=50,
                     device="cuda")
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    out[steps] = dict(seconds=s, steps_per_s=steps / s,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del state
out["steady_steps_per_s"] = 900 / (out[1000]["seconds"] - out[100]["seconds"])
print("PROBE_B16 " + json.dumps(out), flush=True)
