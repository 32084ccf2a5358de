#!/usr/bin/env python3
"""Does the port's DPM-Solver++(2M) update agree with JAX's when the
denoiser computes in bf16? Both samplers run on ONE denoiser, the port's
bf16 UNet2D on trained weights (a flax npz, as `tools/burgers_standin.py`
saves the dim-32 stand-in's EMA), which JAX's sampler calls from inside its
scan through `jax.pure_callback`; so the two chains differ only in what
each framework computes around the denoiser.

For each of DPM-Solver++ 50 and 20 (the `burgers_dpm_refscale` recipe's
conformal settings: 1,000 timesteps, w_score 500, its J scheduler) and each
Q-hat (0, where the guidance's hinge is inactive, and JAX's DPM 50 Q-hat
3.189 of `validation_1d_dpm_round4.json`), on the first 16 test sims of
`--data` (the port's `generate_burgers_dataset`, seed 0, written if
missing), both samplers start from JAX's initial noise of `PRNGKey(5000)`,
the conditions and the guidance of the pipelines' evaluate:

  live    each sampler calls the denoiser on its own iterate; float32
          differences in the update reach the bf16 rounding of the
          denoiser's input and grow from there;
  replay  both samplers get the live port chain's denoiser outputs, in
          order, whatever their input: the chains then differ only in the
          update's arithmetic.

Four more numbers locate what the replayed chains still differ by:
`replay_f32_scalars`, the port's replay again with its DPM step scalars
computed as JAX's scan computes them (float32 log-SNRs and their
difference) in place of its exact ones (`_dpm_coefficients`); `x0_first`,
the first step's x0 = sqrt(1/abar_t) x - sqrt(1/abar_t - 1) eps (`predict_
start_from_noise`) of both frameworks on the live chain's first denoiser
input and output, over all cells and the largest difference where the clip
to [-1, 1] keeps it (at t = 999 the cosine schedule's sqrt(1/abar_t) is
2.03e4), with the share of cells it keeps, the share of the port's x0 equal
to the formula with each product rounded (as written), and the share of
JAX's equal to it with a x unrounded (a fused multiply-add);
`replay_x0_first` and `replay_x0_scan`, both replays again with the first
x0 (t = 999), or every x0 but the final one, taken from the port's replay
in both samplers, so that they differ only in the steps' combination of x0
and the iterate. Printed: one `CHECK {...}` line per arm and Q-hat (per
mode: the samples' relative L2 difference, both chains' J from the port's
solver rollout and metrics, J's relative difference; the numbers above)
and a last JSON line. It imports JAX and
the JAX package, so it is not part of the port:

    JAX_PLATFORMS=cpu python tools/burgers_dpm_update_check.py \\
        --weights build/b_standin/burgers_dim32_ema.npz [--data b_check.npz] [--threads 6]
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ARMS = (50, 20)
QS = (0.0, 3.1888887882232666)  # 0 and JAX's DPM 50 Q-hat (validation_1d_dpm_round4.json)
N_TEST = 16
EVAL_KEY = 5000
J = "control_mse_mean (J)"


def _jax_dpm_scalars(alphas_cumprod, time: int, time_next: int, h_prev):
    """`sampling._dpm_coefficients`'s values as JAX's scan computes them:
    half log-SNRs in float32 and h their float32 difference."""
    import numpy as np

    f = np.float32

    def lam(t):
        a = f(alphas_cumprod[t])
        return f(0.5) * (np.log(a) - np.log1p(-a))

    a_s, a_t = f(alphas_cumprod[time_next]), f(alphas_cumprod[time])
    h = f(lam(time_next) - lam(time))
    w = None
    if h_prev is not None:
        r = f(h_prev) / h
        w = (float(f(1) + f(1) / (f(2) * r)), float(f(1) / (f(2) * r)))
    return (h, float(np.sqrt(f(1) - a_s) / np.sqrt(f(1) - a_t)),
            float(np.sqrt(a_s) * np.expm1(-h)), w)


@contextlib.contextmanager
def _port_x0(seen: list, given=()):
    """The port's `model_predictions` while inside: each call's x0 is
    appended to `seen`, the i-th replaced by `given[i]` first (i <
    len(given))."""
    from safediffcon_torch.core import sampling as S

    orig = S.model_predictions

    def wrapped(*a, **k):
        p = orig(*a, **k)
        if len(seen) < len(given):
            p = p._replace(pred_x_start=given[len(seen)])
        seen.append(p.pred_x_start)
        return p

    S.model_predictions = wrapped
    try:
        yield
    finally:
        S.model_predictions = orig


@contextlib.contextmanager
def _jax_x0(given):
    """JAX's `model_predictions` while inside (traced inside): its i-th
    call's x0 replaced by `given[i]` (a torch tensor) for i < len(given),
    through `jax.pure_callback`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from safediffcon_tpu.core import sampling as JS

    orig, calls = JS.model_predictions, []

    def swap(x0):
        calls.append(None)
        i = len(calls) - 1
        return np.asarray(given[i].numpy() if i < len(given) else x0, np.float32)

    def wrapped(*a, **k):
        p = orig(*a, **k)
        x0 = p.pred_x_start
        return p._replace(pred_x_start=jax.pure_callback(
            swap, jax.ShapeDtypeStruct(x0.shape, jnp.float32), x0))

    JS.model_predictions = wrapped
    try:
        yield
    finally:
        JS.model_predictions = orig


def check(denoise, test, steps: int, q: float) -> dict:
    """Both samplers of DPM-Solver++ `steps` at Q-hat `q` on the denoiser
    `denoise` ((x, t) -> float32 noise prediction, torch, on the CPU) and
    the BurgersDataset `test`: the live and the replayed chains' sample
    difference and J, and the replays with the first / every scanned x0
    taken from the port's replay."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from safediffcon_tpu.core import diffusion as JD
    from safediffcon_tpu.core import sampling as JS
    from safediffcon_tpu.tasks.burgers import config as JC
    from safediffcon_tpu.tasks.burgers import pipeline as JP
    from safediffcon_tpu.tasks.burgers import task as JT
    from safediffcon_torch.core import diffusion as D
    from safediffcon_torch.core import sampling as S
    from safediffcon_torch.tasks.burgers import BurgersConformalConfig, BurgersPipeline
    from safediffcon_torch.tasks.burgers import task as T
    from safediffcon_torch.tasks.burgers.metrics import control_trajectories, evaluate_samples
    from safediffcon_torch.tasks.burgers.task import SCALER

    t0 = time.perf_counter()
    conf = dict(w_score=500.0, sampler="dpm", ddim_sampling_steps=steps)
    # the pipelines give the schedule, the guidance and the J scheduler;
    # their own models are not called
    pipe = BurgersPipeline(BurgersConformalConfig(**conf), dim=8, dim_mults=(1, 2),
                           device="cpu")
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**conf), dim=8, dim_mults=(1, 2))
    state, u_target = torch.from_numpy(test.data), torch.from_numpy(test.u_phys)
    shape = tuple(test.data.shape)
    init = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(EVAL_KEY), shape,
                                                       jnp.float32)))
    jstate = jnp.asarray(test.data)
    jcond = JT.BurgersConditioner(u0=jstate[:, 0, :, 0], uT=jstate[:, T.COND_IDX, :, 0])
    cond = T.BurgersConditioner(u0=state[:, 0, :, 0], uT=state[:, T.COND_IDX, :, 0])
    outs, first = [], []  # the live port chain's denoiser outputs; its first call

    def port_live(x, t):
        with torch.no_grad():
            y = denoise(x, t).float()
        if not outs:
            first.append((x.detach().clone(), t, y))
        outs.append(y)
        return y

    def jax_live(x, t):
        with torch.no_grad():
            return denoise(torch.from_numpy(np.array(x)),
                           torch.from_numpy(np.array(t)).long()).float().numpy()

    def port_sample(apply):
        return S.dpm_solver_sample(
            apply, pipe.sched, pipe.diff_cfg, shape, cond=cond,
            guidance_grad=T.guidance_grad_fn(q, pipe.task_cfg), j_scheduler=pipe.j_scheduler,
            init_noise=init).numpy()

    def jax_sample(callback):
        def apply(_, x, t):
            return jax.pure_callback(callback, jax.ShapeDtypeStruct(x.shape, jnp.float32), x, t)

        g = jax.grad(lambda x: JT.guidance_values(x, q, jp.task_cfg).sum())
        return np.array(jax.jit(lambda key: JS.dpm_solver_sample(
            apply, None, jp.sched, jp.diff_cfg, key, shape, cond=jcond, guidance_grad=g,
            j_scheduler=jp.j_scheduler))(jax.random.PRNGKey(EVAL_KEY)))

    def j_of(x0):
        pred = torch.from_numpy(x0) * SCALER
        with torch.no_grad():
            return float(evaluate_samples(pred, control_trajectories(pred), u_target, 0.8)[J])

    live = {"port": port_sample(port_live), "jax": jax_sample(jax_live)}
    recorded, replay = list(outs), {}
    for name, run in (("port", lambda it: port_sample(lambda x, t: next(it))),
                      ("jax", lambda it: jax_sample(lambda x, t: next(it).numpy()))):
        it = iter(recorded)
        replay[name] = run(it)
        if next(it, None) is not None:
            raise AssertionError(f"the {name} sampler took fewer denoiser calls")
    shared = {}  # both replays with the port replay's first / every scanned x0
    x0s: list = []
    it = iter(recorded)
    with _port_x0(x0s):
        port_sample(lambda x, t: next(it))
    for mode, given in (("replay_x0_first", x0s[:1]), ("replay_x0_scan", x0s[:-1])):
        it, seen = iter(recorded), []
        with _port_x0(seen, given):
            xp = port_sample(lambda x, t: next(it))
        it = iter(recorded)
        with _jax_x0(given):
            xj = jax_sample(lambda x, t: next(it).numpy())
        shared[mode] = dict(sample_rel_l2=float(np.linalg.norm(xp - xj) / np.linalg.norm(xj)),
                            J_rel=j_of(xp) / j_of(xj) - 1)
    it = iter(recorded)
    saved, S._dpm_coefficients = S._dpm_coefficients, _jax_dpm_scalars
    try:
        f32 = port_sample(lambda x, t: next(it))
    finally:
        S._dpm_coefficients = saved
    x, t, eps = first[0]
    x0_port = D.predict_start_from_noise(pipe.sched, x, t, eps).numpy()
    x0_jax = np.asarray(jax.jit(lambda x, t, e: JD.predict_start_from_noise(jp.sched, x, t, e))(
        x.numpy(), t.numpy().astype(np.int32), eps.numpy()))
    kept = np.abs(x0_jax) <= 1
    xn, en = x.numpy(), eps.numpy()
    a, b = (getattr(pipe.sched, k)[int(t[0])].numpy()
            for k in ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"))
    out = dict(steps=steps, Q=q, calls=len(recorded),
               replay_f32_scalars=float(np.linalg.norm(f32 - replay["jax"])
                                        / np.linalg.norm(replay["jax"])),
               x0_first=dict(t=int(t[0]), rel_l2=float(np.linalg.norm(x0_port - x0_jax)
                                                       / np.linalg.norm(x0_jax)),
                             # where the clip to [-1, 1] keeps x0
                             kept_share=float(np.mean(kept)),
                             max_abs_kept=float(np.abs(x0_port - x0_jax)[kept].max(initial=0.0)),
                             # each product rounded to float32, then their
                             # difference (the formula as written)
                             port_plain_share=float(np.mean(x0_port == a * xn - b * en)),
                             # a x exact, minus the rounded b eps, rounded once
                             # (a fused multiply-add)
                             jax_fma_share=float(np.mean(x0_jax == (
                                 np.float64(a) * xn - (b * en).astype(np.float64)
                             ).astype(np.float32)))))
    for mode, xs in (("live", live), ("replay", replay)):
        jp_, jj = j_of(xs["port"]), j_of(xs["jax"])
        out[mode] = dict(sample_rel_l2=float(np.linalg.norm(xs["port"] - xs["jax"])
                                             / np.linalg.norm(xs["jax"])),
                         J_port=jp_, J_jax=jj, J_rel=jp_ / jj - 1)
    out.update(shared)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True, help="a UNet2D's flax npz")
    ap.add_argument("--data", default="build/b_update_check.npz",
                    help="Burgers npz (generated if missing)")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from safediffcon_torch.models.convert import flax_to_state_dict, load_flax_npz
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersPipeline, generate_burgers_dataset)
    from safediffcon_torch.tasks.burgers.pipeline import build_model

    torch.set_num_threads(args.threads)
    if not os.path.exists(args.data):
        generate_burgers_dataset(args.data, n_train=16, n_cal=16, n_test=N_TEST, seed=0,
                                 device="cpu")
    test = BurgersDataset.load(args.data, "test", subset=N_TEST)
    flax = load_flax_npz(args.weights)
    dim = int(flax["params"]["init_conv"]["kernel"].shape[-1])
    params = flax_to_state_dict(build_model(dim=dim, device="meta"), flax)
    denoise = BurgersPipeline(BurgersConformalConfig(), dim=dim, compute_dtype="bfloat16",
                              device="cpu").apply_fn(params)
    result = dict(weights=args.weights, dim=dim, n_test=N_TEST, checks=[])
    for steps in ARMS:
        for q in QS:
            c = check(denoise, test, steps, q)
            result["checks"].append(c)
            print("CHECK " + json.dumps(c), flush=True)
    out = json.dumps(result)
    print(out, flush=True)
    if args.out:
        Path(args.out).write_text(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
