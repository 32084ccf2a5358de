#!/usr/bin/env python3
"""Is the bias rounding of the port's bf16 convs and dense layers a cause of
the tokamak pretrain's distance from JAX's? flax's `nn.Conv` / `nn.Dense`
in bf16 round the product to bf16 and then the sum with the bias (two
roundings); the port's `Conv1dCL` / `Linear` pass the bias to the conv or
`F.linear`, which round once. On the CPU:

  1. one (32, 128, 64) -> 64 channel 3-tap conv in bf16: the share of the
     port's outputs that differ from flax's, and of the same conv with the
     bias added after the rounded product;
  2. the 150-step bf16 pretrain of `tests/test_torch_long_pretrain.py`
     (tiny UNet1D, JAX's key chain replayed) with the port's layers as they
     are ("once") and with the bias added after the rounded product
     ("twice"): each arm's mean relative loss difference from JAX over the
     last 50 steps and its EMA's distance from JAX's over how far it moved.

It imports JAX, so it is not part of the port:

    JAX_PLATFORMS=cpu python tools/tokamak_bias_rounding.py
"""
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

STEPS = 150  # as `tests/test_torch_long_pretrain.py`


def main() -> int:
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch.nn.functional as F

    import tokamak_replay as TR
    from safediffcon_tpu.tasks.tokamak import config as JC
    from safediffcon_tpu.tasks.tokamak import data as JD
    from safediffcon_tpu.tasks.tokamak import pipeline as JP
    from safediffcon_torch.models import layers as L
    from safediffcon_torch.models.convert import state_dict_to_flax
    from safediffcon_torch.tasks.tokamak import (
        TokamakDataset, TokamakPretrainConfig, generate_tokamak_dataset, pretrain)
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

    torch.set_num_threads(2)
    out = {}

    # 1. one conv
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 128, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 64, 64)) * 0.1).astype(np.float32)  # flax (k, in, out)
    b = (rng.normal(size=(64,)) * 0.5).astype(np.float32)
    ref = np.asarray(nn.Conv(64, (3,), dtype=jnp.bfloat16, padding="SAME").apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x)).astype(jnp.float32))
    conv = L.Conv1dCL(64, 64, 3, dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(2, 1, 0))
        conv.bias.copy_(torch.from_numpy(b))
        once = conv(torch.from_numpy(x)).float().numpy()
        xt = torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
        twice = (F.conv1d(xt, conv.weight.to(torch.bfloat16), padding=1)
                 + conv.bias.to(torch.bfloat16)[:, None]).transpose(1, 2).float().numpy()
    out["conv_differs_from_flax"] = dict(once=float((once != ref).mean()),
                                         twice=float((twice != ref).mean()))
    print("CONV " + json.dumps(out["conv_differs_from_flax"]), flush=True)

    # 2. the long bf16 pretrain, once and twice
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tok.npz")
        generate_tokamak_dataset(path, n_train=64, n_cal=8, n_test=4, seed=0, gen_batch=64,
                                 device="cpu")
        train = TokamakDataset.load(path, "train")
    net = init_params(build_model(**TR.PIPE, device="cpu"), seed=0)
    start = state_dict_to_flax(net, net.state_dict())
    pre = dict(**TR.PIPE, timesteps=100, batch_size=4, cosine_t_max=50, lr=1e-3,
               checkpoint_every=10**9, compute_dtype="bfloat16")
    losses_ref = []

    class Recorder:
        def info(self, msg, *a):
            if " step %d loss " in msg:
                losses_ref.append(float(a[2]))

    JP.log = Recorder()
    jstate = JP.pretrain(JC.TokamakPretrainConfig(**pre),
                         JD.TokamakDataset(train.data, train.state_phys), num_steps=STEPS,
                         log_every=1, params=jax.tree_util.tree_map(jnp.asarray, start))
    losses_ref = np.array(losses_ref)
    first = dict(jax.tree_util.tree_flatten_with_path(start)[0])
    conv_fwd, lin_fwd = L.Conv1dCL.forward, L.Linear.forward

    def conv_twice(self, x):
        if L._compute_dtype(self.compute_dtype, x, self.weight) != torch.bfloat16:
            return conv_fwd(self, x)
        xt = x.transpose(1, 2).to(torch.bfloat16)
        y = self._conv_forward(xt, self.weight.to(torch.bfloat16), None)
        return (y + self.bias.to(torch.bfloat16)[:, None]).transpose(1, 2)

    def lin_twice(self, x):
        if (L._compute_dtype(self.compute_dtype, x, self.weight) != torch.bfloat16
                or self.bias is None):
            return lin_fwd(self, x)
        dt = torch.bfloat16
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)

    for arm in ("once", "twice"):
        if arm == "twice":
            L.Conv1dCL.forward, L.Linear.forward = conv_twice, lin_twice
        cfg = TokamakPretrainConfig(**pre)
        losses = []
        state = pretrain(cfg, train, num_steps=STEPS, params=TR.sd_from_flax(start),
                         device="cpu", noise=TR.pretrain_draws(cfg.seed, STEPS),
                         losses=losses)
        rel = np.abs(np.array([float(v) for v in losses]) - losses_ref) / losses_ref
        got = dict(jax.tree_util.tree_flatten_with_path(state_dict_to_flax(
            build_model(**TR.PIPE, device="meta"), state.ema_params))[0])
        diff, moved = [], []
        for p, r in jax.tree_util.tree_flatten_with_path(jstate.ema_params)[0]:
            r = np.asarray(r)
            diff.append(np.abs(got[p] - r).ravel())
            moved.append(np.abs(r - first[p]).ravel())
        out[arm] = dict(loss_rel_last50=float(rel[-50:].mean()),
                        ema_diff_over_moved=float(np.concatenate(diff).mean()
                                                  / np.concatenate(moved).mean()))
        print(f"PRETRAIN {arm} " + json.dumps(out[arm]), flush=True)
    L.Conv1dCL.forward, L.Linear.forward = conv_fwd, lin_fwd
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
