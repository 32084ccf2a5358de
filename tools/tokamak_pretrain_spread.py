#!/usr/bin/env python3
"""How far two pretrains of the port part when their starts differ by
rounding alone: the settings of `tools/tokamak_weight_swap.py
--pretrain-steps` (a dim-32 UNet1D, batch 32, bf16, the `tokamak_refscale`
recipe's Adam, cosine learning rate and EMA, the 1,000 train sims), run
twice from the port's seeded weights, once with every weight moved by a
relative 2^-9 (about half a bf16 rounding step) times a seeded N(0, 1),
both with the same draws (`pretrain`'s own generator). Each EMA is then
calibrated at Q = 0 with the same draws (`posttrain_config()`'s conformal
settings, the 1,000 calibration sims in chunks of 50) and evaluated. The
two Q-hats' difference is the spread against which JAX's and the port's in
`tokamak_weight_swap.py --pretrain-steps` are read. CPU only, no JAX:

    python tools/tokamak_pretrain_spread.py --data tok_swap.npz [--out r.json]

`--data` is the npz `tokamak_weight_swap.py` writes (1,000 / 1,000 / 50
sims, seed 0), generated the same way if missing.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS = 4000  # as the `tokamak_weight_swap.py --pretrain-steps 4000` run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="tokamak npz (generated if missing)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPipeline, TokamakPretrainConfig, generate_tokamak_dataset,
        posttrain_config, pretrain)
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

    torch.set_num_threads(os.cpu_count() or 1)
    if not os.path.exists(args.data):
        generate_tokamak_dataset(args.data, n_train=1000, n_cal=1000, n_test=50, seed=0,
                                 device="cpu")
    data = {s: TokamakDataset.load(args.data, s) for s in ("train", "cal", "test")}
    cfg = TokamakPretrainConfig(dim=32, batch_size=32, checkpoint_every=10**9,
                                compute_dtype="bfloat16")
    start = init_params(build_model(dim=32, device="cpu"), seed=cfg.seed).state_dict()
    gen = torch.Generator().manual_seed(0)
    nudged = {k: v + 2.0**-9 * v.abs() * torch.randn(v.shape, generator=gen)
              if v.is_floating_point() else v for k, v in start.items()}
    pipe = TokamakPipeline(posttrain_config().conformal, dim=32, compute_dtype="bfloat16",
                           cal_chunk=50, device="cpu")
    out, emas = dict(steps=STEPS, n_train=len(data["train"]), n_cal=len(data["cal"])), {}
    for name, params in (("seeded", start), ("nudged", nudged)):
        losses = []
        t = time.perf_counter()
        state = pretrain(cfg, data["train"], num_steps=STEPS, params=params, device="cpu",
                         losses=losses)
        s_pre = time.perf_counter() - t
        q = float(pipe.calibrate(state.ema_params, data["cal"], 0.0,
                                 generator=torch.Generator().manual_seed(0)))
        m = pipe.evaluate(state.ema_params, data["test"], q,
                          generator=torch.Generator().manual_seed(1))
        losses = np.array([float(v) for v in losses])
        out[name] = dict(pretrain_seconds=s_pre, loss_last500_mean=float(losses[-500:].mean()),
                         q=q, eval=m)
        emas[name] = state.ema_params
        print(f"{name.upper()} " + json.dumps(out[name]), flush=True)
    keys = [k for k, v in emas["seeded"].items() if v.is_floating_point()]
    diff = np.concatenate([(emas["seeded"][k] - emas["nudged"][k]).abs().ravel().numpy()
                           for k in keys])
    moved = np.concatenate([(emas["seeded"][k] - start[k]).abs().ravel().numpy()
                            for k in keys])
    out["ema_diff_over_moved"] = float(diff.mean() / moved.mean())
    out["q_rel"] = abs(out["nudged"]["q"] - out["seeded"]["q"]) / out["seeded"]["q"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
