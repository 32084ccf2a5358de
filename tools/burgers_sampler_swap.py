#!/usr/bin/env python3
"""Hold the port's Burgers DDIM 200 and DPM-Solver++ 50 arms to the JAX
package's on the same trained weights, data and draws, in bf16 and in
float32, on the CPU: does the port's few-step bf16 path reproduce JAX's J
on trained weights, and is a difference the bf16 rounding's or the
algorithm's?

The weights are a UNet2D's as a flax npz (`tools/burgers_standin.py` writes
the dim-32 stand-in's EMA). Both frameworks get the same data (the port's
`generate_burgers_dataset`, 32 cal and 16 test sims at the task's 128
cells, seed 0, written to `--data` if missing), the `burgers_dpm_refscale`
recipe's conformal settings (w_score 500, alpha 0.98, 1,000 timesteps) with
32 cal sims in two chunks of 16 and one test batch of 16, bf16 and then
float32 compute, and JAX's key chain replayed into the port's `noise=`
iterators: per arm, calibrate at Q = 0 with `PRNGKey(0)` (`rng, key =
split(rng)` per chunk; a call's initial noise, then, for DDIM, one split
per stochastic step) and the guided evaluate at the calibrated Q-hat with
`PRNGKey(5000)`, as the recipe's script calls them. In bf16 the port runs
each arm a second time on the weights moved by 2^-9 relative (half a bf16
step) times a seeded N(0, 1) (`nudged`): the spread rounding alone makes,
against which the port-vs-JAX bf16 difference is read, and a third time
with flax's two roundings of a bf16 conv or dense layer and its bias
(`twice`: the product rounded, then the bias added in bf16; the port's
layers round once), held against JAX's. Before the arms,
one UNet2D forward of both frameworks on the cal split's first 16 sims
noised to t = 999, 500 and 10 (`FORWARD`: the port's relative L2 distance
from JAX's in each dtype and with two roundings in bf16, the nudged
weights' bf16 output from the port's, and each framework's bf16 output
from its own float32 one).

Printed: the `FORWARD {...}` line, one `ARM {...}` line per dtype and arm
(both frameworks' Q-hat and metrics, the port's relative difference from
JAX's) and a last JSON line with each framework's DPM 50 J over its DDIM
200 J in each dtype. It imports JAX and the JAX package, so it is not part
of the port:

    JAX_PLATFORMS=cpu python tools/burgers_sampler_swap.py --weights burgers_dim32_ema.npz \\
        [--data b_swap.npz] [--threads 4] [--out r.json]
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
import weight_nudge  # noqa: E402  (tools/, the script's own directory)

ARMS = (("ddim", 200), ("dpm", 50))
DTYPES = ("bfloat16", "float32")
FORWARD_T = (999, 500, 10)
CONF = dict(w_score=500.0, n_cal_samples=32, cal_batch_size=16, num_cal_batch=2,
            n_test_samples=16, test_batch_size=16)
J = "control_mse_mean (J)"


@contextlib.contextmanager
def flax_bias_rounding():
    """The port's bf16 `Conv2dCL` and `Linear` with flax's two roundings
    while inside: the product rounded to bf16, then the bias added in bf16
    (the port passes the bias to the conv / `F.linear`, one rounding)."""
    import torch
    import torch.nn.functional as F

    from safediffcon_torch.models import layers as L

    conv_fwd, lin_fwd = L.Conv2dCL.forward, L.Linear.forward

    def conv(self, x):
        dt = L._compute_dtype(self.compute_dtype, x, self.weight)
        if dt != torch.bfloat16:
            return conv_fwd(self, x)
        y = self._conv_forward(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), None)
        return (y + self.bias.to(dt)[:, None, None]).permute(0, 2, 3, 1)

    def linear(self, x):
        dt = L._compute_dtype(self.compute_dtype, x, self.weight)
        if dt != torch.bfloat16 or self.bias is None:
            return lin_fwd(self, x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)

    L.Conv2dCL.forward, L.Linear.forward = conv, linear
    try:
        yield
    finally:
        L.Conv2dCL.forward, L.Linear.forward = conv_fwd, lin_fwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True, help="UNet2D weights as a flax npz")
    ap.add_argument("--data", default="b_swap.npz", help="Burgers npz (generated if missing)")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1,
                    help="the port's CPU threads")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from safediffcon_tpu.core.schedules import make_schedule as j_schedule
    from safediffcon_tpu.tasks.burgers import config as JC
    from safediffcon_tpu.tasks.burgers import data as JD
    from safediffcon_tpu.tasks.burgers import pipeline as JP
    from safediffcon_torch.core.schedules import make_schedule
    from safediffcon_torch.models.convert import flax_to_state_dict, load_flax_npz
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersPipeline, generate_burgers_dataset)
    from safediffcon_torch.tasks.burgers.pipeline import build_model

    torch.set_num_threads(args.threads)
    if not os.path.exists(args.data):
        generate_burgers_dataset(args.data, n_train=16, n_cal=CONF["n_cal_samples"],
                                 n_test=CONF["n_test_samples"], seed=0, device="cpu")
    cal, test = (BurgersDataset.load(args.data, s) for s in ("cal", "test"))
    flax_params = jax.tree_util.tree_map(jnp.asarray, load_flax_npz(args.weights))
    dim = int(flax_params["params"]["init_conv"]["kernel"].shape[-1])
    params = flax_to_state_dict(build_model(dim=dim, device="meta"), load_flax_npz(args.weights))
    nudged = weight_nudge.nudged(params)

    def as_tensor(a):
        return torch.from_numpy(np.array(a))

    def draws(sampler, steps, key, shape):
        """One sampler call's draws from `key`: the initial noise, then, for
        DDIM, one split per stochastic step (DPM draws nothing more)."""
        init, rest, k = as_tensor(jax.random.normal(key, shape, jnp.float32)), [], key
        for _ in range(steps - 1 if sampler == "ddim" else 0):
            k, sub = jax.random.split(k)
            rest.append(as_tensor(jax.random.normal(sub, shape, jnp.float32)))
        return init, rest

    def cal_noise(sampler, steps, rng, shape):
        for _ in range(CONF["num_cal_batch"]):
            rng, key = jax.random.split(rng)
            yield draws(sampler, steps, key, shape)

    out = dict(weights=args.weights, dim=dim, conf=CONF, arms={})

    # one forward of both on the same noised inputs, in each dtype
    x0 = cal.data[:CONF["cal_batch_size"]]
    noise = np.random.default_rng(0).normal(size=x0.shape).astype(np.float32)
    acp = make_schedule(1000, "cosine", device="cpu").host["alphas_cumprod"]
    assert np.allclose(acp, np.asarray(j_schedule(1000, "cosine").alphas_cumprod))
    outs = {}
    for dt in DTYPES:
        jm = JP.build_model(dim, (1, 2, 4, 8), 1, dt)
        tm = build_model(dim=dim, compute_dtype=None if dt == "float32" else dt, device="cpu")
        tm.load_state_dict(params)
        for t in FORWARD_T:
            a = np.float32(acp[t])
            x = (np.sqrt(a) * x0 + np.sqrt(np.float32(1) - a) * noise).astype(np.float32)
            ts = np.full((len(x),), t, np.int32)
            outs["jax", dt, t] = np.asarray(jm.apply(flax_params, jnp.asarray(x),
                                                     jnp.asarray(ts)), np.float64)
            with torch.no_grad():
                outs["port", dt, t] = tm(torch.from_numpy(x), torch.from_numpy(ts).long()
                                         ).double().numpy()
                if dt == "bfloat16":
                    with flax_bias_rounding():
                        outs["twice", dt, t] = tm(torch.from_numpy(x),
                                                  torch.from_numpy(ts).long()).double().numpy()
                    tm.load_state_dict(nudged)
                    outs["nudged", dt, t] = tm(torch.from_numpy(x), torch.from_numpy(ts).long()
                                               ).double().numpy()
                    tm.load_state_dict(params)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    out["forward"] = {str(t): dict(
        port_vs_jax={dt: rel(outs["port", dt, t], outs["jax", dt, t]) for dt in DTYPES},
        twice_vs_jax=rel(outs["twice", "bfloat16", t], outs["jax", "bfloat16", t]),
        nudged_vs_port=rel(outs["nudged", "bfloat16", t], outs["port", "bfloat16", t]),
        bf16_vs_float32={f: rel(outs[f, "bfloat16", t], outs[f, "float32", t])
                         for f in ("port", "jax")}) for t in FORWARD_T}
    print("FORWARD " + json.dumps(out["forward"]), flush=True)

    for dt, (sampler, steps) in ((dt, arm) for dt in DTYPES for arm in ARMS):
        conf = dict(CONF, sampler=sampler, ddim_sampling_steps=steps)
        t = time.perf_counter()
        jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**conf), dim=dim,
                                compute_dtype=None if dt == "float32" else dt)
        q_ref = float(jp.calibrate(flax_params, cal.data, 0.0, jax.random.PRNGKey(0)))
        m_ref = jp.evaluate(flax_params, JD.BurgersDataset(test.data, test.u_phys, test.f_phys),
                            q_ref, jax.random.PRNGKey(5000))
        jax_s = time.perf_counter() - t
        tp = BurgersPipeline(BurgersConformalConfig(**conf), dim=dim,
                             compute_dtype=None if dt == "float32" else dt, device="cpu")
        shape = (CONF["cal_batch_size"],) + cal.data.shape[1:]

        def port(weights):
            q = float(tp.calibrate(weights, cal.data, 0.0, noise=cal_noise(
                sampler, steps, jax.random.PRNGKey(0), shape)))
            m = tp.evaluate(weights, test, q, noise=iter([draws(
                sampler, steps, jax.random.PRNGKey(5000), test.data.shape)]))
            return q, {k: float(v) for k, v in m.items()}

        t = time.perf_counter()
        q, m = port(params)
        port_s = time.perf_counter() - t
        line = dict(dtype=dt, arm=f"{sampler}{steps}", q=[q, q_ref], q_rel=q / q_ref - 1,
                    port=m, jax={k: float(v) for k, v in m_ref.items()},
                    j_rel=m[J] / float(m_ref[J]) - 1, seconds=[port_s, jax_s])
        if dt == "bfloat16":
            # the spread bf16 rounding alone makes: the port on weights half
            # a bf16 step away
            qn, mn = port(nudged)
            line.update(nudged=dict(q=qn, q_rel=qn / q - 1, j_rel=mn[J] / m[J] - 1, metrics=mn))
            # the port with flax's two bias roundings, against JAX
            with flax_bias_rounding():
                qt, mt = port(params)
            line.update(twice=dict(q=qt, q_rel=qt / q_ref - 1,
                                   j_rel=mt[J] / float(m_ref[J]) - 1, metrics=mt))
        out["arms"][f"{dt} {line['arm']}"] = line
        print("ARM " + json.dumps(line), flush=True)
    out["dpm50_j_over_ddim200"] = {}
    for dt in DTYPES:
        a, b = out["arms"][f"{dt} dpm50"], out["arms"][f"{dt} ddim200"]
        out["dpm50_j_over_ddim200"][dt] = {f: a[f][J] / b[f][J] - 1 for f in ("port", "jax")}
    for arm in ("nudged", "twice"):
        a, b = out["arms"]["bfloat16 dpm50"][arm], out["arms"]["bfloat16 ddim200"][arm]
        out["dpm50_j_over_ddim200"]["bfloat16"][f"port_{arm}"] = (
            a["metrics"][J] / b["metrics"][J] - 1)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
