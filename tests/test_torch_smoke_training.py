"""Smoke pretraining against the JAX package: `pretrain` on a tiny
UNet3D(conv_impl="pallas") (JAX: the Pallas conv in interpret mode; the port:
K2's plain version), with the same flax weights, JAX's key chain replayed into
the port and the same numpy batch order; the port's pretrain checkpoints;
`SmokeDataset.load_sim_dirs` and `stats.py` against JAX's."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_tpu.tasks.smoke import stats as JS
from safediffcon_tpu.tasks.smoke.config import SmokePretrainConfig as JPretrainConfig
from safediffcon_tpu.tasks.smoke.data import SmokeDataset as JDataset
from safediffcon_torch.core.train import TrainState
from safediffcon_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from safediffcon_torch.tasks.smoke import SmokeDataset, SmokePretrainConfig, pretrain
from safediffcon_torch.tasks.smoke import stats as TS
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params
from safediffcon_torch.tasks.smoke.task import RESCALER
from safediffcon_torch.utils.checkpoint import latest_step, load_checkpoint

torch.set_num_threads(1)

SHAPE = (4, 16, 16, 7)  # frames, size, size, channels
# dim 16: GroupNorm(8) groups of 2+ channels, so every conv bias before a
# norm has a gradient (with 1-channel groups it would be 0 up to rounding)
PRE = dict(dim=16, dim_mults=(1, 2), timesteps=6, batch_size=2, gradient_accumulate_every=2,
           checkpoint_every=10**9, conv_impl="pallas")
STEPS = 3


@pytest.fixture(scope="module")
def train_raw():
    return (0.3 * np.random.default_rng(0).normal(size=(5, *SHAPE))).astype(np.float32)


@pytest.fixture(scope="module")
def flax_params():
    """Seeded weights as a flax tree: the port's `init_params` carried over by
    the weight bridge (whose round trip is exact)."""
    net = init_params(build_model(16, (1, 2), device="cpu"), seed=0)
    return state_dict_to_flax(net, net.state_dict())


def _replayed_train_noise(seed, steps, accum, batch_shape, timesteps):
    """The (t, noise) of each micro-batch as JAX's pretrain draws them:
    `rng, key = split(rng)` per step, `split(key, accum)` in
    accumulated_grads, then `rng_t, rng_n = split(k)` in the loss."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        for k in jax.random.split(key, accum):
            rng_t, rng_n = jax.random.split(k)
            t = jax.random.randint(rng_t, (batch_shape[0],), 0, timesteps)
            n = jax.random.normal(rng_n, batch_shape, jnp.float32)
            yield torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(n))


class _LossRecorder:
    """Stands in for the JAX pipeline's logger: keeps each logged loss at
    full precision (log_every=1 logs every step)."""

    def __init__(self):
        self.losses = []

    def info(self, msg, *args):
        if " step %d loss " in msg:
            self.losses.append(args[2])


def _record_jax_grads(monkeypatch):
    """Each step's accumulated gradients of the JAX pretrain, as numpy trees
    (a host callback inside its jitted step)."""
    grads = []
    accumulate = JP.accumulated_grads

    def recording(loss_fn, k):
        total = accumulate(loss_fn, k)

        def step(params, rng, batches):
            loss, g = total(params, rng, batches)
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return loss, g

        return step

    monkeypatch.setattr(JP, "accumulated_grads", recording)
    return grads


def _record_port_grads(monkeypatch):
    """Each step's gradients as the port's pretrain hands them to the
    optimizer, in parameter order."""
    grads = []
    apply = TrainState.apply_gradients

    def recording(self, g):
        grads.append([x.clone() for x in g])
        return apply(self, g)

    monkeypatch.setattr(TrainState, "apply_gradients", recording)
    return grads


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_pretrain_matches_jax(train_raw, flax_params, monkeypatch):
    recorder = _LossRecorder()
    monkeypatch.setattr(JP, "log", recorder)
    jgrads = _record_jax_grads(monkeypatch)
    jstate = JP.pretrain(JPretrainConfig(**PRE), JDataset(train_raw / RESCALER, train_raw),
                         num_steps=STEPS, log_every=1,
                         params=jax.tree_util.tree_map(jnp.asarray, flax_params))

    cfg = SmokePretrainConfig(**PRE)
    net = build_model(16, (1, 2), device="cpu")
    noise = _replayed_train_noise(cfg.seed, STEPS, 2, (cfg.batch_size, *SHAPE), cfg.timesteps)
    losses = []
    pgrads = _record_port_grads(monkeypatch)
    state = pretrain(cfg, SmokeDataset(train_raw / RESCALER, train_raw), num_steps=STEPS,
                     params=flax_to_state_dict(net, flax_params), device="cpu", noise=noise,
                     losses=losses)
    assert state.step == int(jstate.step) == STEPS
    assert next(noise, None) is None  # every replayed draw was used, none was missing
    # the first loss sees identical inputs (float32, sums in another order);
    # later ones follow Adam steps of +-lr that agree to ~1e-6 of lr
    np.testing.assert_allclose([float(v) for v in losses], recorder.losses, rtol=2e-5)

    # every step's gradients, held directly: float32 sums in another order
    # leave each leaf within 1e-4 of its largest entry (measured 4.2e-5), and
    # the first step's within 5e-3 relative where they exceed 1e-3 of it
    # (measured 1.35e-3)
    assert len(jgrads) == len(pgrads) == STEPS
    names = [n for n, _ in state.model.named_parameters()]
    port = [_flat(state_dict_to_flax(state.model, dict(zip(names, g)))) for g in pgrads]
    jax_g = [_flat(g) for g in jgrads]
    for s in range(STEPS):
        for path, ref in jax_g[s].items():
            top = np.abs(ref).max()
            np.testing.assert_allclose(port[s][path], ref, rtol=0, atol=1e-4 * top,
                                       err_msg=f"step {s + 1} {path}")
            if s == 0:
                big = np.abs(ref) > 1e-3 * top
                np.testing.assert_allclose(np.asarray(port[0][path])[big], ref[big], rtol=5e-3,
                                           err_msg=str(path))

    # The weights after the 3 steps. Adam's first update of an entry is
    # u = c g / (|c g| + eps), g its gradient, c the global-norm clip's scale
    # (the same on both sides to 1e-6). Where g lies within the gradient
    # tolerance eta (1e-4 of its leaf's largest entry) of 0, float32 noise
    # decides u's sign: the two sides can part by 2 lr. Elsewhere u moves by
    # at most eps c eta / (c (|g| - eta) + eps)^2 per unit of lr. Those
    # entries are named and given that much more than the 0.05 lr every
    # entry gets for steps 2-3 (first gradients around 1e-7 clipped by
    # c ~ 0.1 sit at eps = 1e-8, where u is 0.5-0.6 and moves with g).
    lr, eps = cfg.lr, 1e-8
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in jax_g[0].values()))
    c = min(1.0, cfg.max_grad_norm / norm)
    got = _flat(state_dict_to_flax(state.model, state.model.state_dict()))
    start = _flat(flax_params)
    moved, named, total = 0.0, 0, 0
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        ref = np.asarray(ref)
        moved = max(moved, float(np.abs(ref - start[path]).max()))
        g = np.abs(jax_g[0][path]).astype(np.float64)
        eta = 1e-4 * g.max()
        spread = np.where(g <= eta, 2.0,
                          eps * c * eta / (c * np.maximum(g - eta, 0) + eps) ** 2)
        noisy = spread > 0.05
        named += int(noisy.sum())
        total += g.size
        np.testing.assert_array_less(np.abs(np.asarray(got[path]) - ref),
                                     lr * (0.05 + np.where(noisy, spread, 0)) + 1e-12,
                                     err_msg=str(path))
    assert moved > 2 * lr  # the comparison bites: weights moved by several lr
    assert named < 1e-2 * total  # few entries are left to noise (measured 2,004 of 547,239)
    # the EMA first moves at step 10: both still hold the initial weights
    for name, ema in state.ema_params.items():
        np.testing.assert_array_equal(
            ema.numpy(), flax_to_state_dict(state.model, flax_params)[name].numpy())


def test_pretrain_checkpoints_and_resume(train_raw, tmp_path):
    """Checkpoints land at each multiple of checkpoint_every and at the last
    step; a resumed run restores step, weights, Adam moments and EMA."""
    cfg = SmokePretrainConfig(**{**PRE, "checkpoint_every": 2, "conv_impl": "xla"})
    data = SmokeDataset(train_raw / RESCALER, train_raw)
    d = str(tmp_path / "ckpt")
    state = pretrain(cfg, data, num_steps=3, checkpoint_dir=d, device="cpu")
    assert sorted(os.listdir(d)) == ["ckpt-2.pt", "ckpt-3.pt"] and latest_step(d) == 3
    saved = load_checkpoint(d, 3)
    assert saved["step"] == 3 and saved["opt_state"]["count"] == 3
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(saved["params"][k], v, rtol=0, atol=0)

    resumed = pretrain(cfg, data, num_steps=3, resume_dir=d, device="cpu")
    assert resumed.step == 3  # nothing left to do
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)
    for a, b in zip(resumed.opt_state.nu, state.opt_state.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    more = pretrain(cfg, data, num_steps=4, resume_dir=d, checkpoint_dir=d, device="cpu")
    assert more.step == 4 and latest_step(d) == 4

    # a deadline in the past stops before the first step
    idle = pretrain(cfg, data, num_steps=3, deadline=0.0, checkpoint_dir=str(tmp_path / "x"),
                    device="cpu")
    assert idle.step == 0 and latest_step(str(tmp_path / "x")) is None


def _write_sim_dirs(root, rng):
    """A reference-layout tree: 5 train-dir sims, 2 test-dir sims."""
    for split, ids in (("train", range(5)), ("test", (20000, 20001))):
        for sim_id in ids:
            sim = os.path.join(root, split, f"sim_{sim_id:06d}")
            os.makedirs(sim)
            for name, shape in (("Density", (16, 16, 1, 6)), ("Velocity", (16, 16, 2, 6)),
                                ("Control", (16, 16, 2, 6)), ("Smoke", (6, 3)),
                                ("Smoke_safe", (6, 2))):
                arr = rng.uniform(0.1, 1.0, size=shape).astype(np.float64)
                np.save(os.path.join(sim, f"{name}.npy"), arr)
    os.makedirs(os.path.join(root, "train", "not_a_sim"))


@pytest.mark.parametrize("split,subset", [("train", None), ("cal", None), ("test", 1)])
def test_load_sim_dirs_matches_jax(tmp_path, split, subset):
    root = str(tmp_path)
    _write_sim_dirs(root, np.random.default_rng(5))
    got = SmokeDataset.load_sim_dirs(root, split, n_cal=2, subset=subset, frames=4)
    ref = JDataset.load_sim_dirs(root, split, n_cal=2, subset=subset, frames=4)
    assert got.raw.shape == ref.raw.shape
    np.testing.assert_array_equal(got.raw, ref.raw)
    np.testing.assert_array_equal(got.data, ref.data)
    with pytest.raises(ValueError):
        SmokeDataset.load_sim_dirs(root, "train", n_cal=5)


def test_stats_match_jax(train_raw):
    raw = np.abs(train_raw) * 3
    assert TS.dataset_success_rate(raw) == JS.dataset_success_rate(raw)
    assert TS.dataset_safe_stats(raw, 0.5) == JS.dataset_safe_stats(raw, 0.5)
    np.testing.assert_array_equal(TS.derive_rescaler(raw), JS.derive_rescaler(raw))
