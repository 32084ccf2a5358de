#!/usr/bin/env python3
"""Does the precision of the KSTAR surrogate's matmuls move the tokamak
Q-hat? The `tokamak_refscale` recipe's splits (48,950 + 1,000 + 50
closed-loop sims, seed 0) are generated twice on the card:

  - "float32": as the port generates them, every surrogate matmul in float32
    (`safediffcon_torch/solvers/kstar.py`: `_dense` and the LSTM's two
    matmuls, TF32 off);
  - "bf16pass": every one of those matmuls computed as one bf16 pass of a
    TPU's matrix unit computes a float32 matmul at JAX's DEFAULT precision:
    both operands rounded to bf16, their products summed in float32.

On each arm's data a dim-32 stand-in of the recipe's UNet1D is trained at
the recipe's other settings (batch 32, bf16, 20,000 captured steps in chunks
of 50, the same seed, as `tools/tokamak_standin.py`), calibrated at Q = 0
on the arm's own cal split (`posttrain_config()`'s conformal settings, one
chunk of 1,000, generator seed 0) and evaluated on its test split
(generator seed 1). The bf16-pass arm keeps the bf16-pass surrogate for its
evaluation's rollouts too, as a TPU run would.

Printed, one line each: `DATA <arm> {...}` (the cal split's safety score,
min_t q95 in physical units: mean, quantiles, the fraction under the
recipe's bound 4.98), `SURROGATE {...}` (the same 50 test controls rolled
out open-loop under both surrogates: how far min q95 moves), `ARM <arm>
{...}` (pretrain seconds, Q-hat and its bootstrap std, the evaluation), and
a last JSON line with the Q-hat ratio, also written to `<out>/result.json`.
The switch lives in this tool, not in the package:

    python tools/tokamak_data_precision.py [--out build/data_precision]   # from the repository root

`--device cpu` is a try-out of the same code at tiny sizes (`TINY`: 64 /
16 / 4 sims, 4 steps of a dim-8 stand-in).
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)
ARMS = ("float32", "bf16pass")
# the recipe's splits, the stand-in's width and its pretrain steps; TINY on the CPU
FULL = dict(n_train=48950, n_cal=1000, n_test=50, dim=32, steps=20000)
TINY = dict(n_train=64, n_cal=16, n_test=4, dim=8, steps=4)


def bf16_pass(x, w):
    """x @ w as one bf16 pass: operands rounded to bf16, a float32 product."""
    import torch

    return torch.matmul(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())


@contextlib.contextmanager
def surrogate_precision(arm: str):
    """The KSTAR surrogate's matmuls in `arm`'s precision while inside."""
    import torch

    from safediffcon_torch.solvers import kstar

    if arm == "float32":
        yield
        return

    def dense(w, x):
        return bf16_pass(x, w["kernel"]) + w["bias"]

    def lstm_layer(w, xs):
        units = w["recurrent"].shape[0]
        xk = bf16_pass(xs, w["kernel"])
        h = xs.new_zeros((xs.shape[0], units))
        c = torch.zeros_like(h)
        hs = []
        for step in range(xs.shape[1]):
            z = xk[:, step] + bf16_pass(h, w["recurrent"]) + w["bias"]
            gates = torch.sigmoid(z)
            i, f, o = gates[:, :units], gates[:, units : 2 * units], gates[:, 3 * units :]
            c = f * c + i * torch.tanh(z[:, 2 * units : 3 * units])
            h = o * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    saved = kstar._dense, kstar.lstm_layer
    kstar._dense, kstar.lstm_layer = dense, lstm_layer
    try:
        yield
    finally:
        kstar._dense, kstar.lstm_layer = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/data_precision")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: a try-out at the TINY sizes")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from safediffcon_torch.experiments.round1 import bootstrap_q_std, card_line
    from safediffcon_torch.solvers import kstar
    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPipeline, TokamakPretrainConfig, generate_tokamak_dataset,
        posttrain_config, pretrain)
    from safediffcon_torch.tasks.tokamak.task import safety_score

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to run on the CPU")
    size = FULL if dev.type == "cuda" else TINY
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    conf = posttrain_config().conformal
    bound = conf.safety_threshold
    result = dict(card=card_line() if dev.type == "cuda" else "cpu", steps=size["steps"],
                  dim=size["dim"], arms={})
    for arm in ARMS:
        path = str(out / f"tok_{arm}.npz")
        with surrogate_precision(arm):
            t = time.perf_counter()
            generate_tokamak_dataset(path, n_train=size["n_train"], n_cal=size["n_cal"],
                                     n_test=size["n_test"], gen_batch=512, device=dev)
            gen_s = time.perf_counter() - t
            data = {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}
            score = safety_score(torch.from_numpy(data["cal"].state_phys)).numpy()
            stats = dict(datagen_s=gen_s, cal_safety_mean=float(score.mean()),
                         cal_safety_quantiles=dict(zip(map(str, QUANTILES),
                                                       np.quantile(score, QUANTILES).tolist())),
                         cal_fraction_under_bound=float((score < bound).mean()))
            print(f"DATA {arm} " + json.dumps(stats), flush=True)

            cfg = TokamakPretrainConfig(dim=size["dim"], batch_size=32, checkpoint_every=10**9,
                                        compute_dtype="bfloat16")
            t = time.perf_counter()
            state = pretrain(cfg, data["train"], num_steps=size["steps"], log_every=5000,
                             steps_per_call=50, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            pre_s = time.perf_counter() - t
            pipe = TokamakPipeline(conf, dim=size["dim"], compute_dtype="bfloat16",
                                   cal_chunk=size["n_cal"], device=dev)
            pipe.record = {}
            q = pipe.calibrate(state.ema_params, data["cal"], torch.zeros((), device=dev),
                               generator=torch.Generator(device=dev).manual_seed(0))
            q_std = bootstrap_q_std(pipe.record["cal_scores"], pipe.record["cal_weights"],
                                    conf.alpha, "alpha")
            m = pipe.evaluate(state.ema_params, data["test"], q,
                              generator=torch.Generator(device=dev).manual_seed(1))
            line = dict(pretrain_s=pre_s, Q=float(q), Q_bootstrap_std=q_std,
                        cal_score_mean=float(pipe.record["cal_scores"].mean()), eval=m)
            print(f"ARM {arm} " + json.dumps(line), flush=True)
            result["arms"][arm] = dict(data=stats, **line)
            del pipe, state

    # the same controls (the float32 arm's test split) under both surrogates
    with np.load(out / "tok_float32.npz") as f:
        acts = torch.from_numpy(f["test_actions"]).to(dev)
    params = kstar.load_kstar_params(device=dev)
    mins = {}
    for arm in ARMS:
        with surrogate_precision(arm):
            outs = kstar.simulate_batch(params, acts)
        mins[arm] = safety_score(outs[:, :, [1, 4, 6]].cpu()).numpy()
    d = np.abs(mins["bf16pass"] - mins["float32"])
    result["surrogate"] = dict(min_q95_abs_diff_mean=float(d.mean()),
                               min_q95_abs_diff_max=float(d.max()),
                               min_q95_mean=float(mins["float32"].mean()))
    print("SURROGATE " + json.dumps(result["surrogate"]), flush=True)
    qf, qb = result["arms"]["float32"]["Q"], result["arms"]["bf16pass"]["Q"]
    result["q_bf16pass_over_float32"] = qb / qf
    line = json.dumps(result)
    print(line, flush=True)
    (out / "result.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
