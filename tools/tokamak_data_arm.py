#!/usr/bin/env python3
"""The `tokamak_refscale` recipe on a chosen draw of its data, and its
pretrain Q-hat recalibrated at more generator keys: how far the port's
Q-hat moves with the data realisation and with the calibration draw.

The recipe draws its dataset from a `torch.Generator` seeded 0, and JAX's
is another realisation of the same distribution; both of the port's
training seeds so far shared the port's one dataset and one calibration
key. This tool writes `<out>/tok_ref.npz` (the layout, keys and splits of
the port's `generate_tokamak_dataset`) in one of two ways:

  - `--targets U.npy`: JAX's draw, from the (N, 4, 3) uniforms of
    `tools/tokamak_jax_targets.py`, through the port's
    `kstar.targets_from_uniform` and `closed_loop_from_targets` in batches
    of the recipe's `gen_batch` (512). The quantized targets equal those of
    JAX's jitted `closed_loop_batch` bit for bit; JAX's datagen calls it
    un-jitted for its last, partial batch (the last 336 sims: 286 of the
    cal split, the 50 test sims), whose exact division by 1000 parts from
    the port's reciprocal product by one float32 ulp in 2,530 of those
    4,032 target values;
  - `--data-seed S`: the port's own draw at seed S.

Then it runs `python -m safediffcon_torch.experiments.round1
tokamak_refscale --seed 42 --out <out>` in this process, which finds the
file and reuses it (`DATA reused`), and prints the recipe's COMPARE rows.
Last, it loads the pretrain EMA from the recipe's final checkpoint
(`<out>/tok_ref_ckpt/ckpt-<steps>.pt`) and recalibrates it on the same cal
split with the recipe's pipeline (`posttrain_config().conformal`, dim 128,
bf16) at generator keys 0-4: key 0 is the recipe's own calibration, done
again as a check. Printed: `ARMDATA {...}`, the recipe's lines, one
`CALKEY <key> Q <Q-hat> boot_std <bootstrap std>` per key, `CALSPREAD
{...}` (the five keys' mean and std, ddof 1, and the gap to JAX's 0.1418 at
pretrain), `CARD <name, power limit>`, and a last JSON line, also written to
`--json` (default `<out>/data_arm.json`). No JAX is imported.

On the card, from the repository root (one chip call, ~900 s):

    python tools/tokamak_data_arm.py --targets build/tokamak_jax_targets.npy \\
        --out build/tok_TJ [--json PATH]
    python tools/tokamak_data_arm.py --data-seed 1 --out build/tok_TD1 [--json PATH]

(on a remote card, `--json` a path whose files come back: the npz and the
checkpoints under `--out` are ~1 GB).

`--device cpu` runs the same code at the recipe's `--scale tiny` sizes (a
try-out and the tests' size; `--targets` then needs uniforms of those sizes).
"""
import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TRAIN_SEED = 42
CAL_KEYS = (0, 1, 2, 3, 4)
JAX_Q_PRETRAIN = 0.1418  # validation_tokamak_refscale_round2.json, rounded as the rule reads it


def write_data(path: str, sizes: dict, dev, targets=None, data_seed=None) -> dict:
    """`path` in `generate_tokamak_dataset`'s layout, from JAX's uniforms
    (`targets`, a .npy path) or the port's draw at `data_seed`."""
    import numpy as np
    import torch

    from safediffcon_torch.solvers import kstar
    from safediffcon_torch.tasks.tokamak import generate_tokamak_dataset
    from safediffcon_torch.tasks.tokamak.data import save_tokamak_splits

    split = {k: sizes[k] for k in ("n_train", "n_cal", "n_test")}
    total, batch = sum(split.values()), sizes["gen_batch"]
    t = time.perf_counter()
    if targets is None:
        generate_tokamak_dataset(path, **split, seed=data_seed, gen_batch=batch, device=dev)
        source = dict(data_seed=data_seed)
    else:
        u = np.load(targets)
        if u.shape != (total, kstar.N_TARGETS, 3) or u.dtype != np.float32:
            raise SystemExit(f"{targets}: {u.shape} {u.dtype}, want ({total}, "
                             f"{kstar.N_TARGETS}, 3) float32")
        params = kstar.load_kstar_params(device=dev)
        states, actions = [], []
        for lo in range(0, total, batch):
            tg = kstar.targets_from_uniform(torch.from_numpy(u[lo : lo + batch]).to(dev))
            outs, acts, _ = kstar.closed_loop_from_targets(params, tg)
            states.append(outs[:, :, [1, 4, 6]].cpu().numpy())
            actions.append(acts.cpu().numpy())
        save_tokamak_splits(path, np.concatenate(states), np.concatenate(actions), **split)
        source = dict(targets=str(targets),
                      targets_sha256=hashlib.sha256(u.tobytes()).hexdigest())
    with np.load(path) as z:
        train = z["train_states"]
        stats = dict(train_states_sha256=hashlib.sha256(train.tobytes()).hexdigest(),
                     train_q95_min_mean=float(train[:, :, 1].min(axis=1).mean()))
    return dict(path=path, seconds=time.perf_counter() - t, **split, gen_batch=batch,
                **source, **stats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--targets", help="JAX's (N, 4, 3) uniforms (tools/tokamak_jax_targets.py)")
    src.add_argument("--data-seed", type=int, help="the port's own draw at this seed")
    ap.add_argument("--out", default=None, help="data, checkpoints and the recipe's results "
                    "(default build/tok_data_arm, build/tok_data_arm-tiny with --device cpu)")
    ap.add_argument("--json", default=None, help="result JSON (default <out>/data_arm.json)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the recipe's tiny sizes")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from safediffcon_torch.experiments import round1 as R1
    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPipeline, posttrain_config)
    from safediffcon_torch.utils.checkpoint import load_checkpoint

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to run on the CPU")
    scale = "full" if dev.type == "cuda" else "tiny"
    R = R1.recipe("tokamak_refscale", scale, dev)
    out = Path(args.out or f"build/tok_data_arm{'' if scale == 'full' else '-tiny'}")
    out.mkdir(parents=True, exist_ok=True)
    path = str(out / "tok_ref.npz")
    data = write_data(path, R["generate_tokamak_dataset"], dev, args.targets, args.data_seed)
    print("ARMDATA " + json.dumps(data), flush=True)

    R1.main(["tokamak_refscale", "--seed", str(TRAIN_SEED), "--out", str(out),
             "--device", dev.type, "--scale", scale])
    res = json.loads((out / "round1_tokamak_refscale.json").read_text())

    steps = R["pretrain"]["num_steps"]
    ema = {k: v.to(dev) for k, v in load_checkpoint(
        str(out / Path(R["pretrain"]["checkpoint_dir"]).name), steps)["ema_params"].items()}
    conf = R1.configured(posttrain_config(),
                         {**R["posttrain_config"], "seed": TRAIN_SEED}).conformal
    pipe = TokamakPipeline(conf, **R["TokamakPipeline"], device=dev)
    cal = TokamakDataset.load(path, "cal")
    cal_keys = []
    for key in CAL_KEYS:
        pipe.record = {}
        t = time.perf_counter()
        q = float(pipe.calibrate(ema, cal, torch.zeros((), device=dev),
                                 generator=torch.Generator(device=dev).manual_seed(key)))
        boot = R1.bootstrap_q_std(pipe.record["cal_scores"], pipe.record["cal_weights"],
                                  conf.alpha, "alpha")
        cal_keys.append(dict(key=key, Q=q, boot_std=boot, seconds=time.perf_counter() - t))
        print(f"CALKEY {key} Q {q:.6f} boot_std {boot:.6f}", flush=True)
    qs = np.array([c["Q"] for c in cal_keys])
    q0 = res["summary"]["Q_pretrain"]
    spread = dict(mean=float(qs.mean()), std=float(qs.std(ddof=1)),
                  three_std=float(3 * qs.std(ddof=1)),
                  recipe_Q_pretrain=q0, key0_equals_recipe=bool(abs(qs[0] - q0) <= 1e-6 * q0),
                  gap_recipe=(JAX_Q_PRETRAIN - q0) / JAX_Q_PRETRAIN,
                  gap_mean=(JAX_Q_PRETRAIN - float(qs.mean())) / JAX_Q_PRETRAIN)
    print("CALSPREAD " + json.dumps(spread), flush=True)
    card = R1.card_line() if dev.type == "cuda" else "cpu"
    print(f"CARD {card}", flush=True)
    result = dict(card=card, data=data, train_seed=TRAIN_SEED, cal_keys=cal_keys,
                  cal_spread=spread, comparison=res["comparison"], stages=res["stages"],
                  launches=res["launches"], summary={k: v for k, v in res["summary"].items()
                                                     if not k.endswith("_history")})
    line = json.dumps(result)
    dest = Path(args.json) if args.json else out / "data_arm.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
