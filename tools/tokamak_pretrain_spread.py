#!/usr/bin/env python3
"""How far pretrains of the port part when their starts differ by rounding
alone: the settings of `tools/tokamak_weight_swap.py --pretrain-steps` (a
dim-32 UNet1D, batch 32, bf16, the `tokamak_refscale` recipe's Adam, cosine
learning rate and EMA, the 1,000 train sims), run from the port's seeded
weights ("seeded") and from those weights with every weight moved by a
relative 2^-9 (about half a bf16 rounding step) times an N(0, 1) drawn with
nudge seed S (arm "S"), all with the same draws (`pretrain`'s own
generator). Each EMA is then calibrated at Q = 0 with the same draws
(`posttrain_config()`'s conformal settings, the 1,000 calibration sims in
chunks of 50) and evaluated. The Q-hat differences of two arms (a pair) are
the spread against which JAX's and the port's in `tokamak_weight_swap.py
--pretrain-steps` are read. CPU only, no JAX:

    python tools/tokamak_pretrain_spread.py --data tok_swap.npz \\
        [--arms seeded 0 1 2] [--out-dir DIR] [--threads N] [--out r.json]

`--data` is the npz `tokamak_weight_swap.py` writes (1,000 / 1,000 / 50
sims, seed 0), generated the same way if missing. Each arm saves its EMA
and its line in `--out-dir`; the arms can run in separate processes on the
same directory (one arm each, so that they run side by side), and every run
ends by comparing all the arms the directory holds: one PAIR line per two
arms (EMAs apart over how far the first moved, the Q-hats' relative
difference) and one JSON line.
"""
import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from weight_nudge import nudged  # noqa: E402  (tools/, the script's own directory)

STEPS = 4000  # as the `tokamak_weight_swap.py --pretrain-steps 4000` run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="tokamak npz (generated if missing)")
    ap.add_argument("--arms", nargs="*", default=["seeded", "0"],
                    help='"seeded" and / or nudge seeds (default: seeded 0)')
    ap.add_argument("--out-dir", default=None,
                    help="where each arm's EMA and line go (default: beside --data)")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPipeline, TokamakPretrainConfig, generate_tokamak_dataset,
        posttrain_config, pretrain)
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

    torch.set_num_threads(args.threads)
    out_dir = Path(args.out_dir or Path(args.data).with_name("tok_spread"))
    out_dir.mkdir(parents=True, exist_ok=True)
    if not os.path.exists(args.data):
        generate_tokamak_dataset(args.data, n_train=1000, n_cal=1000, n_test=50, seed=0,
                                 device="cpu")
    data = {s: TokamakDataset.load(args.data, s) for s in ("train", "cal", "test")}
    cfg = TokamakPretrainConfig(dim=32, batch_size=32, checkpoint_every=10**9,
                                compute_dtype="bfloat16")
    start = init_params(build_model(dim=32, device="cpu"), seed=cfg.seed).state_dict()
    pipe = TokamakPipeline(posttrain_config().conformal, dim=32, compute_dtype="bfloat16",
                           cal_chunk=50, device="cpu")

    for arm in args.arms:
        params = start if arm == "seeded" else nudged(start, int(arm))
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
        line = dict(arm=arm, pretrain_seconds=s_pre, threads=args.threads,
                    loss_last500_mean=float(losses[-500:].mean()), q=q, eval=m)
        torch.save(state.ema_params, out_dir / f"{arm}.pt")
        (out_dir / f"{arm}.json").write_text(json.dumps(line) + "\n")
        print("ARM " + json.dumps(line), flush=True)

    # the seeded arm first: a pair's Q-hat difference is relative to its first arm
    arms = sorted((p.stem for p in out_dir.glob("*.json")), key=lambda a: (a != "seeded", a))
    lines = {a: json.loads((out_dir / f"{a}.json").read_text()) for a in arms}
    emas = {a: torch.load(out_dir / f"{a}.pt") for a in arms}
    keys = [k for k, v in start.items() if v.is_floating_point()]
    pairs = []
    for a, b in itertools.combinations(arms, 2):
        diff = np.concatenate([(emas[a][k] - emas[b][k]).abs().ravel().numpy() for k in keys])
        moved = np.concatenate([(emas[a][k] - start[k]).abs().ravel().numpy() for k in keys])
        qa, qb = lines[a]["q"], lines[b]["q"]
        pair = dict(pair=[a, b], q=[qa, qb], q_rel=abs(qb - qa) / abs(qa),
                    ema_diff_over_moved=float(diff.mean() / moved.mean()))
        pairs.append(pair)
        print("PAIR " + json.dumps(pair), flush=True)
    result = json.dumps(dict(steps=STEPS, n_train=len(data["train"]), n_cal=len(data["cal"]),
                             arms=lines, pairs=pairs))
    print(result, flush=True)
    if args.out:
        Path(args.out).write_text(result + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
