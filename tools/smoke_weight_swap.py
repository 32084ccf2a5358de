#!/usr/bin/env python3
"""Sample and evaluate the port's trained smoke weights with the JAX package.

The round-1 `smoke` recipe of the port (`python -m
safediffcon_torch.experiments.round1 smoke`) saves its evaluated EMA
weights as a flax tree (`smoke_ema_flax.npz` beside its results JSON). This
tool hands them to the JAX package on the CPU: the recipe's data
(`generate_smoke_dataset` with the script's arguments, in JAX), then
`SmokePipeline.calibrate` and guided evaluation with the recipe's
`SmokeConformalConfig` and pipeline arguments, `--eval-seeds` evaluations
of the same weights and Q-hat. It tells a fault of the port's sampling or
evaluation (JAX's result on the same weights differs from the port's) from
one of its training (they agree).

    JAX_PLATFORMS=cpu python tools/smoke_weight_swap.py \
        --weights <out>/smoke_ema_flax.npz [--data build/swap/smoke_val.npz] \
        [--eval-seeds 3] [--n-cal 32] [--chunk 4]

First it holds the port's UNet3D against the JAX package's on the same
weights at the recipe's shape (one record of 32 frames of 64^2, N(0, 1)
input, t = 999, 500 and 10, float32 and bfloat16): the largest difference
over the largest output, which separates the model from the sampler and
the evaluation. `--datagen-only` stops after writing the data, `--eval-seeds
0` after the forward check. The evaluation loop is the
JAX pipeline's `evaluate` taken apart (each chunk's key split as there,
`_sample_test`, the data's initial density, `solver_rollout`,
`evaluate_samples`), so that the sampled controls can be measured: the
mean |c| of the control channels in the band below the maze (rows 0-7 of
the 64^2 record, every frame, physical units), against the test data's.
`--chunk` sets the calibration and evaluation sub-batch (the mid-level
full spatial attention of the dim-32 UNet3D takes ~1.5 GB per sample on
the CPU); it changes the key chain's split, not the distribution. On an
8-core CPU one forward of that UNet3D takes ~7 s per sample in JAX, so
the recipe's 32 calibration and 3 x 8 test chains (2,800 forwards) take
hours: `--n-cal` calibrates on the first n calibration sims (the config's
cal_batch_size set to n) and `--eval-seeds` sets the evaluations. It
prints one JSON line and writes it to `<weights dir>/smoke_weight_swap.json`.
It imports JAX and the JAX package, so it is not part of the port.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
EVAL_SEED_BASE = 1000  # the port's extra eval seeds are 1001, 1002, ...


def band_control_abs(x) -> np.ndarray:
    """Per-sample mean |c| of the two control channels in the band below the
    maze (rows 0-7 of the 64^2 record), every frame, physical units."""
    return np.abs(np.asarray(x, np.float32)[:, :, :8, :, 3:5]).mean(axis=(1, 2, 3, 4))


def forward_check(tree) -> dict:
    """max |port - JAX| / max |JAX| of one UNet3D forward on the same weights,
    per compute dtype and timestep."""
    import jax
    import jax.numpy as jnp
    import torch

    from safediffcon_tpu.tasks.smoke.pipeline import build_model as jax_model
    from safediffcon_torch.experiments.round1 import RECIPES
    from safediffcon_torch.models.convert import load_flax_params
    from safediffcon_torch.tasks.smoke.pipeline import build_model

    kw = RECIPES["smoke"]["SmokePipeline"]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    x = np.random.default_rng(0).normal(size=(1, 32, 64, 64, 7)).astype(np.float32)
    out = {}
    for dtype in (None, "bfloat16"):
        jm = jax_model(kw["dim"], kw["dim_mults"], dtype)
        tm = load_flax_params(build_model(kw["dim"], kw["dim_mults"], dtype, device="cpu"),
                              tree).eval()
        for t in (999, 500, 10):
            ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.full((1,), t, jnp.int32)),
                             np.float32)
            with torch.no_grad():
                got = tm(torch.from_numpy(x), torch.full((1,), t)).float().numpy()
            out[f"{dtype or 'float32'} t={t}"] = float(np.abs(got - ref).max() / np.abs(ref).max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", help="the port's smoke_ema_flax.npz")
    ap.add_argument("--data", default=str(ROOT / "build" / "swap" / "smoke_val.npz"),
                    help="the recipe's data (generated with the JAX package if missing)")
    ap.add_argument("--eval-seeds", type=int, default=3)
    ap.add_argument("--n-cal", type=int, default=None,
                    help="calibrate on the first n calibration sims (default: all)")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--datagen-only", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from safediffcon_tpu.tasks.smoke import (
        SmokeConformalConfig, SmokeDataset, SmokePipeline, generate_smoke_dataset)
    from safediffcon_tpu.tasks.smoke.metrics import evaluate_samples, solver_rollout
    from safediffcon_tpu.tasks.smoke.task import RESCALER, SAFE, SMOKE
    from safediffcon_torch.experiments.round1 import RECIPES
    from safediffcon_torch.models.convert import load_flax_npz

    R = RECIPES["smoke"]
    t0 = time.time()
    if not os.path.exists(args.data):
        generate_smoke_dataset(args.data, **R["generate_smoke_dataset"])
        print(f"[{time.time() - t0:7.1f}s] data generated: {args.data}", flush=True)
    if args.datagen_only:
        return 0
    tree = load_flax_npz(args.weights)
    forward = forward_check(tree)
    print(f"[{time.time() - t0:7.1f}s] forward, max diff / max |JAX|: {json.dumps(forward)}",
          flush=True)
    if args.eval_seeds < 1:
        return 0
    data = {s: SmokeDataset.load(args.data, s) for s in ("cal", "test")}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    conf_kw = dict(R["SmokeConformalConfig"])
    if args.n_cal is not None:
        data["cal"] = SmokeDataset.load(args.data, "cal", subset=args.n_cal)
        conf_kw["cal_batch_size"] = args.n_cal
    conf = SmokeConformalConfig(**conf_kw)
    pipe = SmokePipeline(conf, **R["SmokePipeline"], cal_chunk=args.chunk,
                         eval_chunk=args.chunk)

    Q = pipe.calibrate(params, data["cal"], jnp.zeros(()), jax.random.PRNGKey(0))
    q = float(Q)  # waits for the calibration
    print(f"[{time.time() - t0:7.1f}s] Q-hat {q:.6g}", flush=True)
    test = data["test"]
    evals, ctrl, per_sample = [], [], {"J_target": [], "safe_target": []}
    seeds = [1] + [EVAL_SEED_BASE + i for i in range(1, args.eval_seeds)]
    for seed in seeds:
        rng, totals, n = jax.random.PRNGKey(seed), {}, len(test.raw)
        j, s, c = [], [], []
        for lo in range(0, n, args.chunk):  # pipe.evaluate, taken apart
            rng, key = jax.random.split(rng)
            raw = jnp.asarray(test.raw[lo : lo + args.chunk])
            pred = pipe._sample_test(params, key, raw / jnp.asarray(RESCALER), Q, guided=True)
            pred = pred.at[:, 0, :, :, 0].set(raw[:, 0, :, :, 0])
            sol = solver_rollout(pipe.masks, pred, raw, **pipe.solver_kw)
            m = evaluate_samples(pred, sol, Q, conf.safe_bound)
            for name, v in m.items():
                totals[name] = totals.get(name, 0.0) + float(v) * raw.shape[0]
            j.append(-np.asarray(sol[:, -1, 0, 0, SMOKE]))
            s.append(np.asarray(sol[:, -1, 0, 0, SAFE]))
            c.append(band_control_abs(pred))
        evals.append({k: v / n for k, v in totals.items()})
        per_sample["J_target"].append(np.concatenate(j).tolist())
        per_sample["safe_target"].append(np.concatenate(s).tolist())
        ctrl.append(float(np.concatenate(c).mean()))
        print(f"[{time.time() - t0:7.1f}s] eval seed {seed}: {json.dumps(evals[-1])}", flush=True)

    mean = {k: float(np.mean([e[k] for e in evals])) for k in evals[0]}
    std = {k: float(np.std([e[k] for e in evals], ddof=1)) if len(evals) > 1 else 0.0
           for k in evals[0]}
    out = dict(
        weights=str(args.weights), eval_seeds=seeds, chunk=args.chunk, n_cal=len(data["cal"]),
        Q_hat=float(Q),
        J_target=mean["J_target"], safe_target=mean["safe_target"],
        unsafe_percentage=mean["unsafe_percentage"], std=std, evals=evals,
        per_sample=per_sample, sampled_band_control_abs=float(np.mean(ctrl)),
        sampled_band_control_abs_per_seed=ctrl,
        data_band_control_abs=float(band_control_abs(test.raw).mean()),
        forward=forward, seconds=time.time() - t0, platform=jax.default_backend())
    line = json.dumps(out)
    print(line, flush=True)
    with open(Path(args.weights).parent / "smoke_weight_swap.json", "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
