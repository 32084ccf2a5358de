"""The smoke datagen mass-conservation filter (`generate_smoke_dataset`'s
`conservation_min` / `conservation_max`, the reference writer's
min_sum_rate / max_sum_rate): the kept sims are exactly those whose final over
initial mass lies strictly inside the bounds, rejected sims are regenerated
until every split is full, a filter that rejects nearly everything raises
after 20 * total + gen_batch attempts, and no bound leaves the output as it
was. The mass ratio of a batch agrees with the JAX package's rollout on the
same inputs and control noise."""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.solvers import smoke as JS
from safediffcon_torch.solvers import smoke as TS
from safediffcon_torch.tasks.smoke import SmokeDataset
from safediffcon_torch.tasks.smoke import data as TD

torch.set_num_threads(1)

RECORD_FRAMES, TIME_SCALE, SPACE_SCALE = 2, 8, 4  # 16 solver frames, 32^2 records
GEN = dict(n_frames=RECORD_FRAMES * TIME_SCALE, record_frames=RECORD_FRAMES,
           space_scale=SPACE_SCALE, accuracy=1e-4, max_iter=40, device="cpu")


class Spy:
    """Wraps `_generate_batch`: every batch's records and mass ratios."""

    def __init__(self, monkeypatch):
        self.batches, self.real = [], TD._generate_batch
        monkeypatch.setattr(TD, "_generate_batch", self)

    def __call__(self, *a, **kw):
        out, ratio = self.real(*a, **kw)
        self.batches.append((out, ratio))
        return out, ratio


def _splits(path):
    return {s: SmokeDataset.load(path, s).raw for s in ("train", "cal", "test")}


def test_filter_keeps_exactly_the_sims_inside_the_bounds(tmp_path, monkeypatch):
    # the bounds: around the median ratio of an unfiltered batch, so that
    # the filter rejects sims on both sides
    spy = Spy(monkeypatch)
    TD.generate_smoke_dataset(str(tmp_path / "probe.npz"), n_train=6, n_cal=0, n_test=0,
                              gen_batch=6, seed=1, **GEN)
    r = np.sort(spy.batches[0][1])
    lo, hi = float(r[1] + r[2]) / 2, float(r[4] + r[5]) / 2
    spy.batches.clear()
    path = str(tmp_path / "kept.npz")
    kept = TD.generate_smoke_dataset(path, n_train=3, n_cal=2, n_test=1, gen_batch=4, seed=2,
                                     conservation_min=lo, conservation_max=hi, **GEN)
    outs = np.concatenate([o for o, _ in spy.batches])
    ratios = np.concatenate([m for _, m in spy.batches])
    inside = (ratios > lo) & (ratios < hi)
    assert (~inside).any() and len(spy.batches) > 2  # sims were rejected and regenerated
    np.testing.assert_array_equal(kept, ratios[inside])
    assert ((kept > lo) & (kept < hi)).all()
    splits = _splits(path)
    assert [len(splits[s]) for s in ("train", "cal", "test")] == [3, 2, 1]
    np.testing.assert_array_equal(np.concatenate([splits[s] for s in ("train", "cal", "test")]),
                                  outs[inside][:6])


def test_filter_raises_after_the_attempt_limit(tmp_path, monkeypatch):
    """Bounds no sim meets: 20 * total + gen_batch = 43 attempted sims, in
    batches of min(gen_batch, total - kept) = 2, then RuntimeError."""
    calls = []

    def fake_batch(masks, dens0, vxs, vys, noise, **kw):
        calls.append(len(dens0))
        b = len(dens0)
        return np.zeros((b, RECORD_FRAMES, 32, 32, 7), np.float32), np.full(b, 0.9, np.float32)

    monkeypatch.setattr(TD, "_generate_batch", fake_batch)
    with pytest.raises(RuntimeError, match="bounds too tight"):
        TD.generate_smoke_dataset(str(tmp_path / "x.npz"), n_train=1, n_cal=1, n_test=0,
                                  gen_batch=3, conservation_min=0.95, **GEN)
    assert calls == [2] * 22  # 44 >= 43 attempted


def test_no_bounds_leaves_the_output_as_it_was(tmp_path):
    """No bound, and bounds that keep every sim, give the same files; every
    sim's mass ratio is returned."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ra = TD.generate_smoke_dataset(a, n_train=2, n_cal=1, n_test=1, gen_batch=3, seed=3, **GEN)
    rb = TD.generate_smoke_dataset(b, n_train=2, n_cal=1, n_test=1, gen_batch=3, seed=3,
                                   conservation_min=-1.0, conservation_max=10.0, **GEN)
    assert len(ra) == 4
    np.testing.assert_array_equal(ra, rb)
    sa, sb = _splits(a), _splits(b)
    for s in sa:
        np.testing.assert_array_equal(sa[s], sb[s])


def test_mass_ratio_matches_jax():
    """A batch of 2 sims, 16 solver frames, JAX's control noise fed to the
    port: the mass ratio mass[:, -1] / mass[:, 0] of JAX's rollout (the one
    `gen_batch_fn` returns) and the port's, both with the whole-batch CG to
    1e-4."""
    rng = np.random.default_rng(4)
    b, n_frames = 2, GEN["n_frames"]
    dens0 = np.zeros((b, TS.CELLS, TS.CELLS), np.float32)
    vxs = np.zeros((b, n_frames), np.float32)
    vys = np.zeros((b, n_frames), np.float32)
    for i in range(b):
        xs, ys = TD._waypoints(rng)
        dens0[i, ys[0] : ys[0] + 10, xs[0] : xs[0] + 10] = 1.0
        vxs[i], vys[i] = TD._velocity_program(rng, xs, ys, n_frames)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    noise = jax.random.normal(key, (b, n_frames - 1, JS.N, JS.N, 2), jnp.float32)

    # JAX: gen_batch_fn's control synthesis and rollout
    ctrl = jnp.stack([jnp.asarray(vxs)[:, :-1, None, None] * (1 + 0.1 * noise[..., 0]),
                      jnp.asarray(vys)[:, :-1, None, None] * (1 + 0.1 * noise[..., 1])], axis=-1)
    v0 = np.zeros((b, JS.N, JS.N, 2), np.float32)
    v0[..., 1] = 0.8
    rec = JS.smoke_rollout(JS.build_masks(), jnp.asarray(dens0), jnp.asarray(v0), ctrl,
                           GEN["accuracy"], GEN["max_iter"], backend="xla")
    ref = np.asarray(rec.mass[:, -1] / rec.mass[:, 0])

    out, ratio = TD._generate_batch(
        TS.build_masks("cpu"), dens0, vxs, vys, torch.from_numpy(np.array(noise)),
        time_scale=TIME_SCALE, space_scale=SPACE_SCALE, accuracy=GEN["accuracy"],
        max_iter=GEN["max_iter"], backend="xla", device="cpu",
        phase=lambda name: contextlib.nullcontext())
    assert out.shape == (b, RECORD_FRAMES, 32, 32, 7)
    # float32 rollouts with the CG to 1e-4 on both sides: 1e-5 relative
    np.testing.assert_allclose(ratio, ref, rtol=1e-5)
    assert (ratio != 1.0).all()  # mass leaves the domain: the ratio carries information
