#!/usr/bin/env python3
"""Hold the port's tokamak pretrain, calibration, evaluation and
post-training to the JAX package's on the same weights, data and draws, on
the CPU.

The weights are either a UNet1D's as a flax tree (`--weights`,
`models/convert.py::save_flax_npz`), e.g. a model trained on the card at
the `tokamak_refscale` recipe's settings, on which both frameworks run steps
1-5; or, with `--pretrain-steps N`, each framework's own EMA after N steps
of step 0. Both get the same data (the port's `generate_tokamak_dataset`,
1,000 / 1,000 / 50 sims, seed 0, written to `--data` if missing), the
`posttrain_config()` conformal settings (DDIM 200, alpha 0.9) with the
1,000 calibration sims in one batch of chunks of 50, bf16 compute (float32
with `--dtype float32`, both U-Nets then in exact float32 on the CPU), and
JAX's key chain replayed into the port's `noise=` iterators by the helpers
the parity tests use (`tests/tokamak_replay.py`):

  0. with `--pretrain-steps`: the `tokamak_refscale` recipe's pretrain
     (batch 32, Adam, the cosine learning rate, the EMA) of both from
     the port's seeded weights: each step's loss, and how far the EMAs
     part against how far they moved;
  1. one UNet1D forward on N(0, 1) input at t = 999, 500, 10: the largest
     difference over the largest output;
  2. `calibrate` at Q = 0 with PRNGKey(0): Q-hat, and each sample's score
     and weight from JAX's `_cal_batch` on its chunk;
  3. `evaluate` of the test split at each side's Q-hat with PRNGKey(1);
  4. `--posttrain-epochs` epochs of `run_inference(posttrain_config())`
     (recalibrate, one weighted step at batch 1,000 of the train split,
     evaluate): each epoch's Q-hat, loss and metrics;
  5. `--finetune-epochs` epochs of the backward fine-tune as the
     `tokamak_refscale` recipe runs it (`finetune_config()`, DDIM 250, on
     the test split, the composite calibration weight at JAX's Q-hat of step 2
     as `finetune_quantile` and guidance scaler 1.0), from the same
     weights: each epoch's Q-hat, loss and metrics.

It prints one JSON line and writes it to `--out`. It imports JAX and the
JAX package, so it is not part of the port:

    JAX_PLATFORMS=cpu python tools/tokamak_weight_swap.py --dim 32 \\
        (--weights w.npz | --pretrain-steps N) [--dtype float32] [--data tok_swap.npz]
        [--posttrain-epochs 1] [--finetune-epochs 1] [--out r.json]
"""
import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

N_TRAIN = N_CAL = 1000
CAL_CHUNK = 50


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="UNet1D weights as a flax npz")
    src.add_argument("--pretrain-steps", type=int,
                     help="pretrain both sides this many steps from the same seeded weights")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="compute dtype of both frameworks' U-Nets (default bfloat16)")
    ap.add_argument("--data", default=None, help="tokamak npz (generated if missing)")
    ap.add_argument("--posttrain-epochs", type=int, default=0)
    ap.add_argument("--finetune-epochs", type=int, default=0)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1,
                    help="the port's CPU threads")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    import tokamak_replay as TR
    from safediffcon_tpu.core.conformal import normalize_weights, weighted_quantile
    from safediffcon_tpu.tasks.tokamak import config as JC
    from safediffcon_tpu.tasks.tokamak import data as JD
    from safediffcon_tpu.tasks.tokamak import pipeline as JP
    from safediffcon_torch.models.convert import (
        flax_to_state_dict, load_flax_npz, state_dict_to_flax)
    from safediffcon_torch.tasks.tokamak import (
        TokamakConformalConfig, TokamakDataset, TokamakPipeline, TokamakPretrainConfig,
        finetune_config, generate_tokamak_dataset, posttrain_config, pretrain, run_inference)
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

    torch.set_num_threads(args.threads)
    DTYPE = args.dtype
    data_path = args.data or str(Path(args.out or "tok_swap.json").with_name("tok_swap.npz"))
    if not os.path.exists(data_path):
        generate_tokamak_dataset(data_path, n_train=N_TRAIN, n_cal=N_CAL, n_test=50, seed=0,
                                 device="cpu")
    data = {s: TokamakDataset.load(data_path, s) for s in ("train", "cal", "test")}
    jdata = {s: JD.TokamakDataset(d.data, d.state_phys) for s, d in data.items()}
    kw = dict(dim=args.dim)
    meta = build_model(**kw, compute_dtype=DTYPE, device="meta")
    out = dict(weights=args.weights, pretrain_steps=args.pretrain_steps, dim=args.dim,
               dtype=DTYPE, n_cal=len(data["cal"]), n_train=len(data["train"]))
    t0 = time.perf_counter()

    if args.weights:
        tree = load_flax_npz(args.weights)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        sd = flax_to_state_dict(meta, tree)
    else:
        # 0. the pretrain of both from the same weights and draws
        n = args.pretrain_steps
        pre = dict(**kw, batch_size=32, checkpoint_every=10**9, compute_dtype=DTYPE)
        cfg = TokamakPretrainConfig(**pre)
        net = init_params(build_model(**kw, device="cpu"), seed=cfg.seed)
        start = state_dict_to_flax(net, net.state_dict())
        losses_ref = []

        class Recorder:
            def info(self, msg, *a):
                if " step %d loss " in msg:
                    losses_ref.append(float(a[2]))

        log, JP.log = JP.log, Recorder()
        try:
            t = time.perf_counter()
            jstate = JP.pretrain(JC.TokamakPretrainConfig(**pre), jdata["train"], num_steps=n,
                                 log_every=1, params=jax.tree_util.tree_map(jnp.asarray, start))
            s_jax = time.perf_counter() - t
        finally:
            JP.log = log
        losses = []
        t = time.perf_counter()
        state = pretrain(cfg, data["train"], num_steps=n, params=flax_to_state_dict(meta, start),
                         device="cpu", losses=losses,
                         noise=TR.pretrain_draws(cfg.seed, n, (32, 128, 12), cfg.timesteps))
        s_port = time.perf_counter() - t
        jparams, sd = jstate.ema_params, state.ema_params
        losses, losses_ref = np.array([float(v) for v in losses]), np.array(losses_ref)
        got = dict(jax.tree_util.tree_flatten_with_path(state_dict_to_flax(meta, sd))[0])
        first = dict(jax.tree_util.tree_flatten_with_path(start)[0])
        diffs, moved = [], []
        for path, ref in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            ref = np.asarray(ref)
            diffs.append(np.abs(got[path] - ref).ravel())
            moved.append(np.abs(ref - first[path]).ravel())
        diffs, moved = np.concatenate(diffs), np.concatenate(moved)
        tail = slice(-min(500, n), None)
        out["pretrain"] = dict(
            steps=n, seconds=[s_port, s_jax], loss_first=[losses[0], losses_ref[0]],
            loss_last500_mean=[losses[tail].mean(), losses_ref[tail].mean()],
            loss_rel_last500_mean=float((np.abs(losses - losses_ref) / losses_ref)[tail].mean()),
            loss_curve_every_500=[[float(losses[i]), float(losses_ref[i])]
                                  for i in range(0, n, 500)],
            ema_diff_mean=float(diffs.mean()), ema_moved_mean=float(moved.mean()),
            ema_diff_over_moved=float(diffs.mean() / moved.mean()))
        print("PRETRAIN " + json.dumps(out["pretrain"]), flush=True)

    # 1. the forward on the weights
    x = np.random.default_rng(0).normal(size=(4, 128, 12)).astype(np.float32)
    jm = JP.build_model(args.dim, (1, 2, 4, 8), 1, DTYPE)
    tm = build_model(**kw, compute_dtype=DTYPE, device="cpu")
    tm.load_state_dict(sd)
    tm.eval()
    fwd = {}
    for t in (999, 500, 10):
        ref = np.asarray(jm.apply(jparams, jnp.asarray(x), jnp.full((4,), t)), np.float32)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.full((4,), t)).float().numpy()
        fwd[str(t)] = rel(got, ref)
    out["forward_rel"] = fwd

    pt = posttrain_config()
    conf = dict(dataclasses.asdict(pt.conformal), cal_batch_size=len(data["cal"]))
    ddim_steps = conf["ddim_sampling_steps"] - 1
    chunk = min(CAL_CHUNK, len(data["cal"]))
    jconf = JC.TokamakConformalConfig(**conf)
    jp = JP.TokamakPipeline(jconf, args.dim, (1, 2, 4, 8), 1, DTYPE, cal_chunk=CAL_CHUNK)
    tp = TokamakPipeline(TokamakConformalConfig(**conf), compute_dtype=DTYPE,
                         cal_chunk=CAL_CHUNK, device="cpu", **kw)

    # 2. calibrate at Q = 0
    # JAX's: its calibrate's loop (one batch), then its last lines on the chunks
    cal = data["cal"]
    rng, s_ref, w_ref = jax.random.PRNGKey(0), [], []
    for lo in range(0, len(cal), chunk):
        rng, key = jax.random.split(rng)
        s, w = jp._cal_batch(jparams, key, cal.data[lo : lo + chunk],
                             cal.state_phys[lo : lo + chunk], 0.0)
        s_ref.append(np.asarray(s))
        w_ref.append(np.asarray(w))
    q_ref = float(weighted_quantile(normalize_weights(jnp.concatenate(w_ref))
                                    * jnp.concatenate(s_ref), jconf.alpha))
    tp.record = {}
    q = float(tp.calibrate(sd, cal, 0.0, noise=TR.calibrate_draws(
        jax.random.PRNGKey(0), -(-len(cal) // chunk), (chunk, 128, 12), ddim_steps)))
    s_ref, w_ref = np.concatenate(s_ref), np.concatenate(w_ref)
    s_got, w_got = tp.record["cal_scores"].numpy(), tp.record["cal_weights"].numpy()
    out["calibrate"] = dict(
        q_jax=q_ref, q_port=q, q_rel=abs(q - q_ref) / abs(q_ref),
        scores_rel=rel(s_got, s_ref), scores_mean=[float(s_got.mean()), float(s_ref.mean())],
        score_mean_rel=abs(float(s_got.mean() - s_ref.mean())) / float(np.abs(s_ref).mean()),
        weights_rel=rel(w_got, w_ref), seconds=time.perf_counter() - t0)
    print("CALIBRATE " + json.dumps(out["calibrate"]), flush=True)

    # 3. evaluate at each side's Q-hat
    m_ref = jp.evaluate(jparams, jdata["test"], q_ref, jax.random.PRNGKey(1))
    m = tp.evaluate(sd, data["test"], q, noise=iter([TR.sampler_noise(
        jax.random.PRNGKey(1), data["test"].data.shape, ddim_steps)]))
    out["evaluate"] = {k: [m[k], float(m_ref[k])] for k in m_ref}
    print("EVALUATE " + json.dumps(out["evaluate"]), flush=True)

    def epochs(hist, h_ref):
        """Per epoch, [port, JAX] of Q-hat, the loss and every metric."""
        return [dict(epoch=h["epoch"], quantile=[h["quantile"], r["quantile"]],
                     loss=[h["loss"], r["loss"]],
                     eval={k: [h["eval"][k], float(r["eval"][k])] for k in r["eval"]})
                for h, r in zip(hist, h_ref)]

    # 4. post-training epochs, JAX's key chain replayed
    if args.posttrain_epochs:
        cfg = dataclasses.replace(pt, conformal=TokamakConformalConfig(**conf),
                                  finetune_epoch=args.posttrain_epochs)
        jcfg = dataclasses.replace(JC.posttrain_config(), conformal=jconf,
                                   finetune_epoch=args.posttrain_epochs)
        _, _, h_ref = JP.run_inference(jcfg, jp, jparams, jdata["train"], jdata["cal"],
                                       jdata["test"])
        _, _, hist = run_inference(cfg, tp, sd, data["train"], cal, data["test"],
                                   noise=TR.epoch_draws(cfg, False, len(data["test"]), CAL_CHUNK))
        out["posttrain"] = epochs(hist, h_ref)
        print("POSTTRAIN " + json.dumps(out["posttrain"]), flush=True)

    # 5. backward fine-tune epochs with the composite weight, JAX's key chain replayed
    if args.finetune_epochs:
        ft = finetune_config()
        fconf = dict(dataclasses.asdict(ft.conformal), cal_batch_size=len(data["cal"]),
                     wo_post_train=False, finetune_quantile=q_ref,
                     finetune_w_obj=pt.conformal.w_obj, finetune_w_safe=pt.conformal.w_safe,
                     finetune_set="test")
        cfg = dataclasses.replace(ft, conformal=TokamakConformalConfig(**fconf),
                                  finetune_epoch=args.finetune_epochs)
        jcfg = dataclasses.replace(JC.finetune_config(), conformal=JC.TokamakConformalConfig(
            **fconf), finetune_epoch=args.finetune_epochs)
        jp_ft = JP.TokamakPipeline(jcfg.conformal, args.dim, (1, 2, 4, 8), 1, DTYPE,
                                   cal_chunk=CAL_CHUNK)
        tp_ft = TokamakPipeline(cfg.conformal, compute_dtype=DTYPE, cal_chunk=CAL_CHUNK,
                                device="cpu", **kw)
        _, _, h_ref = JP.run_inference(jcfg, jp_ft, jparams, jdata["train"], jdata["cal"],
                                       jdata["test"])
        _, _, hist = run_inference(cfg, tp_ft, sd, data["train"], cal, data["test"],
                                   noise=TR.epoch_draws(cfg, True, len(data["test"]), CAL_CHUNK))
        out["finetune"] = epochs(hist, h_ref)
        print("FINETUNE " + json.dumps(out["finetune"]), flush=True)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
