#!/usr/bin/env python3
"""Does each step of the port's tokamak pretrain still compute what JAX's
computes once the weights have moved far from their start? The settings of
`tools/tokamak_weight_swap.py --pretrain-steps 4000 --dim 32 --dtype
float32` (batch 32, the `tokamak_refscale` recipe's Adam, cosine learning
rate and EMA, the 1,000 train sims, JAX's key chain replayed): the port
pretrains 4,000 steps in float32 and keeps its weights every 500; at each
of those points both frameworks take the loss and its gradient from the
same weights, on the same batch
(the first 32 train sims) with that step's draws. A fault in a step shows
as an error that grows past the float32 rounding of the first points (the
4e-7 of `tests/test_torch_long_pretrain.py`); a trajectory that parts by
rounding alone keeps it flat. Printed: one `POINT {...}` line per point
(the loss's relative difference, the gradient's relative L2 error, the
worst leaf's largest difference over its largest entry) and a last JSON
line. `--dim 128 --steps 2000` takes the check to the recipe's width (its
points every `--steps` / 8).

`--dtype bfloat16` pretrains the port in bf16, the recipe's dtype, and
holds each point's bf16 gradients against the float32 gradient g32 at the
same point (JAX's; the port's float32 gradient beside it, as a check of the
float32 agreement): e_p = |g_port,bf16 - g32| / |g32|, e_j the same for
JAX's bf16 gradient, d = |g_port,bf16 - g_jax,bf16| / |g32| (L2 norms over
every leaf). A point passes when 0.5 <= e_p / e_j <= 2 and d <= 2 max(e_p,
e_j); its line also names the three leaves with the largest share of d,
and each side's three leaves furthest from g32.
It imports JAX, so it is not part of the port:

    JAX_PLATFORMS=cpu python tools/tokamak_step_check.py --data tok_swap.npz \\
        [--dim 32] [--steps 4000] [--dtype float32|bfloat16] [--threads 6] [--out r.json]
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

# as the `tokamak_weight_swap.py --pretrain-steps 4000 --dim 32 --dtype float32` run
POINTS = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="the swap's tokamak npz (generated if missing)")
    ap.add_argument("--dim", type=int, default=32, help="the UNet1D's width (recipe: 128)")
    ap.add_argument("--steps", type=int, default=4000, help="pretrain steps (a multiple of 8)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the pretrain's compute dtype (recipe: bfloat16)")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import tokamak_replay as TR
    from safediffcon_tpu.core import diffusion as JDiff
    from safediffcon_tpu.core.schedules import make_schedule as j_schedule
    from safediffcon_tpu.tasks.tokamak import pipeline as JP
    from safediffcon_tpu.tasks.tokamak.task import train_conditioner as j_cond
    from safediffcon_torch.core.diffusion import DiffusionConfig, p_losses
    from safediffcon_torch.core.schedules import make_schedule
    from safediffcon_torch.models.convert import state_dict_to_flax
    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPretrainConfig, generate_tokamak_dataset, pretrain)
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params
    from safediffcon_torch.tasks.tokamak.task import train_conditioner
    from safediffcon_torch.utils.checkpoint import load_checkpoint

    torch.set_num_threads(args.threads)
    dim, steps, every, dtype = args.dim, args.steps, args.steps // POINTS, args.dtype
    if not os.path.exists(args.data):
        generate_tokamak_dataset(args.data, n_train=1000, n_cal=1000, n_test=50, seed=0,
                                 device="cpu")
    train = TokamakDataset.load(args.data, "train")
    cfg = TokamakPretrainConfig(dim=dim, batch_size=32, checkpoint_every=every,
                                compute_dtype=dtype)
    shape = (cfg.batch_size, 128, 12)
    net = init_params(build_model(dim=dim, device="cpu"), seed=cfg.seed)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    tmp = tempfile.TemporaryDirectory()  # the weights every `every` steps, removed at exit
    ckpt = tmp.name
    t0 = time.perf_counter()
    pretrain(cfg, train, num_steps=steps, params=start, device="cpu", checkpoint_dir=ckpt,
             noise=TR.pretrain_draws(cfg.seed, steps, shape, cfg.timesteps))
    pre_s = time.perf_counter() - t0

    # the loss of one step on both sides, from the same weights, batch and draws
    jsched = j_schedule(cfg.timesteps, cfg.beta_schedule, cfg.objective)
    jdcfg = JDiff.DiffusionConfig(timesteps=cfg.timesteps, objective=cfg.objective)
    jcond = j_cond()
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.objective, device="cpu")
    dcfg = DiffusionConfig(timesteps=cfg.timesteps, objective=cfg.objective,
                           beta_schedule=cfg.beta_schedule)
    cond = train_conditioner()
    dtypes = ("float32",) if dtype == "float32" else ("bfloat16", "float32")
    models, j_fns = {}, {}
    for dt in dtypes:
        models[dt] = build_model(dim, compute_dtype=dt, device="cpu")
        jmodel = JP.build_model(dim, (1, 2, 4, 8), 1, dt)
        j_fns[dt] = jax.jit(lambda params, batch, t, noise, m=jmodel: jax.value_and_grad(
            lambda p: JDiff.p_losses(lambda q, x, s: m.apply(q, x, s), p, jsched, jdcfg,
                                     batch, t, noise, jcond).mean())(params))

    def flat(tree) -> dict:
        return {jax.tree_util.keystr(path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def port(dt, weights, t, noise):
        model = models[dt]
        model.load_state_dict(weights)
        model.zero_grad()
        loss = p_losses(model, sched, dcfg, batch, t, noise, cond).mean()
        loss.backward()
        return float(loss.detach()), flat(state_dict_to_flax(
            model, {k: p.grad for k, p in model.named_parameters()}))

    def jax_side(dt, weights, t, noise):
        loss, g = j_fns[dt](
            jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(models[dt], weights)),
            jnp.asarray(batch.numpy()), jnp.asarray(t.numpy(), jnp.int32),
            jnp.asarray(noise.numpy()))
        return float(loss), flat(g)

    def l2(a: dict, b: dict) -> float:
        return sum(float(((a[k] - b[k]) ** 2).sum()) for k in b) ** 0.5

    batch = torch.from_numpy(np.ascontiguousarray(train.data[: cfg.batch_size]))
    draws = TR.pretrain_draws(cfg.seed, steps + 1, shape, cfg.timesteps)
    points = []
    for step in range(steps + 1):
        t, noise = next(draws)
        if step % every:
            continue
        weights = start if step == 0 else load_checkpoint(ckpt, step)["params"]
        loss, got = port(dtype, weights, t, noise)
        ref_loss, ref = jax_side(dtype, weights, t, noise)
        norm = sum(float((r ** 2).sum()) for r in ref.values()) ** 0.5
        worst = max(float(np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-30))
                    for k, r in ref.items())
        point = dict(step=step, loss=[loss, ref_loss],
                     loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                     grad_rel_l2=l2(got, ref) / norm, worst_leaf_rel=worst)
        if dtype == "bfloat16":
            loss32, got32 = port("float32", weights, t, noise)
            ref_loss32, g32 = jax_side("float32", weights, t, noise)
            n32 = sum(float((r ** 2).sum()) for r in g32.values()) ** 0.5
            e_p, e_j, d = l2(got, g32) / n32, l2(ref, g32) / n32, l2(got, ref) / n32
            share = sorted(((float(((got[k] - ref[k]) ** 2).sum()) / n32 ** 2 / d ** 2, k)
                            for k in ref), reverse=True)[:3]
            # each side's leaves furthest from g32, relative to the leaf's norm
            leaf = {side: sorted(((float(np.linalg.norm(g[k] - r) / max(np.linalg.norm(r), 1e-30)),
                                   k) for k, r in g32.items()), reverse=True)[:3]
                    for side, g in (("port", got), ("jax", ref))}
            point.update(e_p=e_p, e_j=e_j, d=d, ratio=e_p / e_j,
                         f32_rel_l2=l2(got32, g32) / n32, loss32=[loss32, ref_loss32],
                         passes=bool(0.5 <= e_p / e_j <= 2 and d <= 2 * max(e_p, e_j)),
                         worst_leaves=[dict(leaf=k, share_of_d2=v) for v, k in share],
                         furthest_from_f32={side: [dict(leaf=k, rel_l2=v) for v, k in rows]
                                            for side, rows in leaf.items()})
        points.append(point)
        print("POINT " + json.dumps(point), flush=True)
    tmp.cleanup()
    summary = dict(dim=dim, steps=steps, every=every, dtype=dtype, pretrain_seconds=pre_s,
                   points=points)
    if dtype == "bfloat16":
        summary["verdict"] = ("no bf16 step fault" if all(p["passes"] for p in points)
                              else "fault")
    out = json.dumps(summary)
    print(out, flush=True)
    if args.out:
        Path(args.out).write_text(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
