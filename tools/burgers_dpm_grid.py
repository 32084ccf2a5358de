#!/usr/bin/env python3
"""The Burgers few-step samplers' J by guidance setting, on the card: does
the `burgers_dpm_refscale` recipe's DPM-Solver++ excess over DDIM 200 come
from the unguided DPM path, or from the guidance strength (Q-hat) and the
bf16 rounding of the guided chain?

In one process it rebuilds the recipe's EMA, as the recipe does
(`round1.burgers_refscale_pretrain(run, checkpoints=False)`: the data file
`<out>/burgers_ref.npz`, generated if missing, and 50,000 captured bf16
steps at the recipe's seed 42), then evaluates it through one
`BurgersPipeline` per sampler arm, built as the recipe builds them
(`BurgersConformalConfig` of the arm, dim 128, bf16), over the recipe's eval
keys 5000-5002 on all 50 test sims, in these settings:

  a    Q = 0 (the guidance's hinge inactive): DDIM 200, stochastic DDIM 20
       and 50, DPM-Solver++ 50 and 20; each evaluation also gives the
       metrics of its first 16 sims (`sims` 16), the size of the JAX
       package's float32 CPU run (`validation_1d_dpm_cpu_round4.json`);
  b    JAX's calibrated Q-hats (`validation_1d_dpm_round4.json`): DDIM 200,
       DPM 50, DPM 20;
  c    the port's own Q-hats, each arm calibrated as the recipe calibrates
       (Q = 0, key 0, the 1,000 cal sims): DDIM 200, DPM 50, DPM 20;
  d    as c, DDIM 200 and DPM 50 only, on the EMA with every weight moved
       by 2^-9 relative (half a bf16 step) times a seeded N(0, 1), as
       `tools/burgers_sampler_swap.py` nudges it;
  a32  as a, in float32 with TF32 off (the precision of JAX's CPU run):
       DPM 20, DPM 50, DDIM 200 on the first 16 test sims at key 5000 only.
       It runs last, each arm only while the tool's seconds stay within
       3,000 by the seconds per sampler step measured so far.

Printed: one `GRID <setting> <arm> <sims> <key> J R_p R_s R_t Q` line per
evaluation and per mean over keys (key "mean"), one `EXCESS <setting>
<sims> <arm> <J over DDIM 200's J, %>` line per few-step arm and setting,
the stages' seconds (STAGES) and K1 / K2 launches (LAUNCHES, 0 on this
path), `CARD <name, power limit>` and a last JSON line, also written to
`--json`. No JAX is imported. On the card, from the repository root (one
chip call, ~2,600-3,000 s):

    python tools/burgers_dpm_grid.py [--out build/burgers_dpm_grid] [--json PATH]

(`--json`, default `<out>/burgers_dpm_grid.json`: on a remote card, a path
whose files come back.)

`--device cpu` runs the same code at the recipe's `--scale tiny` sizes (4
test sims, of which the first 2 stand for the first 16) and eval key 5000
only, by default in build/burgers_dpm_grid-tiny.
"""
import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from weight_nudge import nudged  # noqa: E402  (tools/, the script's own directory)

TRAIN_SEED = 42
FIRST = 16  # the JAX CPU run's test sims
J = "control_mse_mean (J)"
METRICS = (J, "point_exceed_ratio (R_p)", "sample_exceed_ratio (R_s)",
           "time_exceed_ratio (R_t)")
GUIDED_ARMS = ("ddim200", "dpm50", "dpm20")
NUDGED_ARMS = ("ddim200", "dpm50")
FLOAT32_ARMS = ("dpm20", "dpm50", "ddim200")  # cheapest first: each times the next
BUDGET_S = 3000.0  # a float32 arm runs only if the tool is expected to end within this


def with_first_rows(metrics, n: int):
    """`metrics` (a pipeline's, over a batch of sims) that also returns its
    values over the batch's first `n` sims, under "<metric>@first"."""

    def both(pred, controlled, u_target, u_bound):
        out = metrics(pred, controlled, u_target, u_bound)
        first = metrics(pred[:n], controlled[:n], u_target[:n], u_bound)
        out.update({f"{k}@first": v for k, v in first.items()})
        return out

    return both


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="the data file's directory (default "
                    "build/burgers_dpm_grid, build/burgers_dpm_grid-tiny with --device cpu)")
    ap.add_argument("--json", default=None,
                    help="result JSON (default <out>/burgers_dpm_grid.json)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the recipe's tiny sizes and eval key 5000 only")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from safediffcon_torch.experiments import round1 as R1
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersPipeline)

    t_start = time.perf_counter()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to run on the CPU")
    scale = "full" if dev.type == "cuda" else "tiny"
    out_dir = args.out or f"build/burgers_dpm_grid{'' if scale == 'full' else '-tiny'}"
    run = R1.Run("burgers_dpm_refscale", dev, scale, TRAIN_SEED, 3 if scale == "full" else 1,
                 out_dir,
                 emit=lambda line: print(line, flush=True))
    R = run.recipe
    path, data, state = R1.burgers_refscale_pretrain(run, checkpoints=False)
    ema = state.ema_params
    del state
    arms = {f"{s0}{n0}": (sampler, steps) for (sampler, steps), (s0, n0) in
            zip(R["variants"], R1.BURGERS_DPM_REFSCALE["variants"])}
    test, n_test = data["test"], len(data["test"])
    first = FIRST if n_test > FIRST else n_test // 2  # tiny: half the test split
    keys = [R1.DPM_EVAL_KEY_BASE + s for s in range(run.eval_seeds)]
    pipes = {}

    def pipeline(arm, dtype="bf16"):
        if (arm, dtype) not in pipes:
            sampler, steps = arms[arm]
            conf = BurgersConformalConfig(**{**R["BurgersConformalConfig"], "sampler": sampler,
                                             "ddim_sampling_steps": steps})
            kw = R["BurgersPipeline"] if dtype == "bf16" else {
                **R["BurgersPipeline"], "compute_dtype": None}
            pipe = pipes[arm, dtype] = BurgersPipeline(conf, **kw, device=dev)
            if dtype == "bf16":  # the whole test split: its first sims' view too
                pipe.metrics = with_first_rows(pipe.metrics, first)
        return pipes[arm, dtype]

    rows, excess = [], {}

    def line(setting, arm, sims, key, m, q):
        row = dict(setting=setting, arm=arm, sims=sims, key=key, Q=q,
                   **{k.split(" ")[-1].strip("()"): m[k] for k in METRICS})
        rows.append(row)
        print(f"GRID {setting} {arm} {sims} {key} " + " ".join(
            f"{row[k]:.6g}" for k in ("J", "R_p", "R_s", "R_t")) + f" {q:.6g}", flush=True)
        return row

    def evaluate(setting, arm, params, q, dtype="bf16", subset=None, eval_keys=keys):
        """Evaluations at `eval_keys`; GRID lines per key and their means,
        over all sims and (full test split) over the first ones."""
        pipe, split = pipeline(arm, dtype), subset or test
        ms = []
        with run.stage(f"{setting}_evaluate"):
            for key in eval_keys:
                ms.append(pipe.evaluate(params, split, torch.full((), q, device=dev),
                                        generator=run.gen(key)))
        views = [(len(split), "")] + ([(first, "@first")] if subset is None else [])
        for sims, suffix in views:
            per = [{k: m[k + suffix] for k in METRICS} for m in ms]
            for key, m in zip(eval_keys, per):
                line(setting, arm, sims, key, m, q)
            mean = {k: float(np.mean([m[k] for m in per])) for k in METRICS}
            line(setting, arm, sims, "mean", mean, q)
            excess.setdefault((setting, sims), {})[arm] = mean[J]

    def calibrate(setting, arm, params):
        pipe = pipeline(arm)
        with run.stage(f"{setting}_calibrate"):
            q = float(pipe.calibrate(params, data["cal"].data,
                                     torch.full((), R1.DPM_CALIBRATE_Q, device=dev),
                                     generator=run.gen(R1.DPM_CALIBRATE_KEY)))
        run.tick(f"{setting} {arm}: calibrated Q-hat {q:.6g}")
        return q

    own, failed = {}, []

    def setting(name, fn):
        """Run one setting; a failure is printed and the next setting runs
        (the pretrain before them is the call's cost)."""
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported, and the tool exits 1
            failed.append(name)
            traceback.print_exc()
            print(f"GRID {name} failed: {type(e).__name__}: {e}", flush=True)

    def guided_own():
        for arm in GUIDED_ARMS:
            own[arm] = calibrate("c", arm, ema)
        for arm in GUIDED_ARMS:
            evaluate("c", arm, ema, own[arm])

    def nudged_arms():
        ema_n = nudged(ema)
        for arm in NUDGED_ARMS:
            evaluate("d", arm, ema_n, calibrate("d", arm, ema_n))

    setting("a", lambda: [evaluate("a", arm, ema, 0.0) for arm in arms])
    setting("b", lambda: [evaluate("b", arm, ema, float(run.jax[arm]["Q"]))
                          for arm in GUIDED_ARMS])
    setting("c", guided_own)
    setting("d", nudged_arms)
    for p in list(pipes.values()):
        p.graphs.clear()
    pipes.clear()

    # a32: float32 with TF32 off, the first sims, one key
    sub = BurgersDataset.load(path, "test", subset=first)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    skipped = []

    def float32_arms():
        per_step = 3.0  # s per sampler step, until one is measured
        for arm in FLOAT32_ARMS:
            steps = arms[arm][1]
            if time.perf_counter() - t_start + steps * per_step > BUDGET_S:
                skipped.append(arm)
                print(f"GRID a32 {arm} {first} {keys[0]} skipped: {steps * per_step:.0f} s "
                      f"expected past {BUDGET_S:.0f} s", flush=True)
                continue
            t = time.perf_counter()
            evaluate("a32", arm, ema, 0.0, dtype="float32", subset=sub, eval_keys=keys[:1])
            per_step = (time.perf_counter() - t) / steps

    try:
        setting("a32", float32_arms)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    for (name, sims), js in excess.items():
        base = js.get(R1.DPM_BASELINE)
        for arm, j in js.items():
            if arm != R1.DPM_BASELINE and base is not None:
                print(f"EXCESS {name} {sims} {arm} {100 * (j / base - 1):+.2f}", flush=True)
    card = R1.card_line() if dev.type == "cuda" else "cpu"
    print("STAGES " + json.dumps({k: round(v, 3) for k, v in run.stages.items()}), flush=True)
    print("LAUNCHES " + json.dumps(run.launches), flush=True)
    print(f"CARD {card}", flush=True)
    result = dict(card=card, train_seed=TRAIN_SEED, eval_keys=keys, own_Q=own,
                  jax_Q={a: float(run.jax[a]["Q"]) for a in GUIDED_ARMS}, rows=rows,
                  excess={f"{s} {n}": {a: 100 * (j / js[R1.DPM_BASELINE] - 1)
                                       for a, j in js.items() if a != R1.DPM_BASELINE}
                          for (s, n), js in excess.items() if R1.DPM_BASELINE in js},
                  float32_skipped=skipped, failed=failed, stages=run.stages,
                  launches=run.launches,
                  seconds=time.perf_counter() - t_start)
    out = json.dumps(result)
    dest = Path(args.json) if args.json else Path(out_dir) / "burgers_dpm_grid.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(out + "\n")
    print(out, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
