"""A long pretrain of the port's smoke UNet3D against the JAX package: 30
steps of a tiny UNet3D (dim 8, mults (1, 2), 4 frames of 16^2) under smoke
pretrain's own recipe (Adam (0.9, 0.99), the MultiStepLR schedule, the
global-norm clip at 1, the EMA of 0.995 every 10 steps), in float32 and in
bfloat16 compute, with JAX's key chain replayed into the port and the same
numpy batch order. The port's conv is K2's plain version (conv_impl
"pallas", as the round-1 smoke recipes train on the card); JAX's is its XLA
conv, the default of its pretrain. Compared: the loss curve step by step
and the EMA weights at the end (tests/test_torch_long_pretrain.py does the
same for the tokamak UNet1D).

30 steps, not 150: JAX compiles the UNet3D's step in 17-21 s and the
port's step takes ~0.4 s on one CPU thread (K2's plain version under the
"full" remat), so 150 steps per arm take ~2 min; 30 keep the file near a
minute and move the EMA three times. The conv biases of the 8-channel
blocks feed a GroupNorm of 8 groups, one channel each, which removes them:
their gradient is rounding noise, which Adam scales to steps of +-lr, so
they are left out of the weight comparison (no other weight is)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_tpu.tasks.smoke.config import SmokePretrainConfig as JPretrainConfig
from safediffcon_tpu.tasks.smoke.data import SmokeDataset as JDataset
from safediffcon_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from safediffcon_torch.tasks.smoke import SmokeDataset, SmokePretrainConfig, pretrain
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params
from safediffcon_torch.tasks.smoke.task import RESCALER

torch.set_num_threads(1)

STEPS = 30
SHAPE = (4, 16, 16, 7)  # frames, size, size, channels
MODEL = dict(dim=8, dim_mults=(1, 2))
PRE = dict(**MODEL, batch_size=2, checkpoint_every=10**9)


@pytest.fixture(scope="module")
def train_raw():
    return (0.3 * np.random.default_rng(0).normal(size=(8, *SHAPE))).astype(np.float32)


@pytest.fixture(scope="module")
def flax_params():
    net = init_params(build_model(**MODEL, device="cpu"), seed=0)
    return state_dict_to_flax(net, net.state_dict())


def replayed_draws(seed, steps, batch_shape, timesteps):
    """Each step's (t, noise) as JAX's pretrain draws them: `rng, key =
    split(rng)` per step, `split(key, 1)` in accumulated_grads, then
    `rng_t, rng_n = split(k)` in the loss."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        rng_t, rng_n = jax.random.split(jax.random.split(key, 1)[0])
        t = jax.random.randint(rng_t, (batch_shape[0],), 0, timesteps)
        n = jax.random.normal(rng_n, batch_shape, jnp.float32)
        yield torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(n))


def _normed_away(path, leaf) -> bool:
    """A Block3D conv bias of dim channels: its GroupNorm has one channel
    per group, so the bias has no effect on the output."""
    keys = [getattr(k, "key", None) for k in path]
    return (keys[-1] == "bias" and any(str(k).startswith("Block3D") for k in keys)
            and leaf.shape == (MODEL["dim"],))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_long_pretrain_follows_jax(train_raw, flax_params, monkeypatch, compute_dtype):
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    jstate = JP.pretrain(JPretrainConfig(**PRE, compute_dtype=compute_dtype),
                         JDataset(train_raw / RESCALER, train_raw), num_steps=STEPS, log_every=1,
                         params=jax.tree_util.tree_map(jnp.asarray, flax_params))

    cfg = SmokePretrainConfig(**PRE, compute_dtype=compute_dtype, conv_impl="pallas")
    noise = replayed_draws(cfg.seed, STEPS, (cfg.batch_size, *SHAPE), cfg.timesteps)
    losses = []
    state = pretrain(cfg, SmokeDataset(train_raw / RESCALER, train_raw), num_steps=STEPS,
                     params=flax_to_state_dict(build_model(**MODEL, device="meta"), flax_params),
                     device="cpu", noise=noise, losses=losses)
    assert next(noise, None) is None  # every replayed draw was used
    losses = np.array([float(v) for v in losses])
    losses_ref = np.array(losses_ref)
    assert losses.shape == losses_ref.shape == (STEPS,)
    rel = np.abs(losses - losses_ref) / losses_ref

    got = dict(jax.tree_util.tree_flatten_with_path(state_dict_to_flax(
        build_model(**MODEL, device="meta"), state.ema_params))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(flax_params)[0])
    diffs, moved = [], []
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.ema_params)[0]:
        ref = np.asarray(ref)
        if _normed_away(path, ref):
            continue
        diffs.append(np.abs(got[path] - ref).ravel())
        moved.append(np.abs(ref - start[path]).ravel())
    diffs, moved = np.concatenate(diffs), np.concatenate(moved)
    if compute_dtype is None:
        # float32: no drift (seen: losses 8.7e-7 apart at most, the EMA
        # 2.6e-7 = 2.6e-4 lr at most)
        assert rel.max() < 1e-5, rel.max()
        assert diffs.max() < 1e-2 * cfg.lr, diffs.max()
    else:
        # bf16: both sides round activations to 8 bits in other orders (seen:
        # 0.073 % mean loss difference over the last 20 steps, 0.22 % at
        # most; the EMA 6.8 % of the mean distance it moved)
        assert rel[-20:].mean() < 1e-2 and rel.max() < 5e-2, (rel[-20:].mean(), rel.max())
        assert diffs.mean() < 0.1 * moved.mean(), (diffs.mean(), moved.mean())
    # both learn, by the same factor
    assert losses[-10:].mean() < 0.5 * losses[0]
    np.testing.assert_allclose(losses[-10:].mean(), losses_ref[-10:].mean(), rtol=1e-2)
