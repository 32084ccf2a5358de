"""The port's KSTAR surrogate (`solvers/kstar.py`) against the reference
goldens (tests/golden/kstar_reference_rollouts.npz, the reference Keras
solver's rollouts) and against the JAX solver on the same weights: the
networks, the steady start, the clip and quantisation, and the closed loop
with JAX's random targets replayed."""
import hashlib
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.solvers import kstar as JK
from safediffcon_torch.solvers import kstar as K

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "kstar_reference_rollouts.npz")


@pytest.fixture(scope="module")
def params():
    return K.load_kstar_params(device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return JK.load_kstar_params()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_weights_are_the_jax_archive(params):
    # the port's own copy, inside the port, byte for byte the JAX archive
    port, jax_archive = Path(K.DEFAULT_WEIGHTS).resolve(), Path(JK.DEFAULT_WEIGHTS).resolve()
    assert port.is_relative_to(Path(__file__).resolve().parents[1] / "safediffcon_torch")
    assert hashlib.sha256(port.read_bytes()).hexdigest() == hashlib.sha256(
        jax_archive.read_bytes()).hexdigest()
    assert params["rl"]["n_layers"] == 2
    assert params["lstm"]["lstm0"]["kernel"].shape == (18, 400)
    assert params["lstm"]["lstm0"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("i", range(3))
def test_rollout_parity_vs_reference(params, golden, i):
    out = K.simulate(params, torch.from_numpy(golden[f"actions_{i}"])).numpy()
    ref = golden[f"outputs_{i}"]
    assert out.shape == (122, 8)
    # the JAX test's bound; wmhd ~1e5 magnifies float32 differences
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert rel.max() < 1e-4, f"sample {i}: max rel err {rel.max()}"


def test_batch_matches_single(params, golden):
    actions = torch.from_numpy(np.stack([golden[f"actions_{i}"] for i in range(3)]))
    batch = K.simulate_batch(params, actions).numpy()
    for i in range(3):
        single = K.simulate(params, actions[i]).numpy()
        # batched matmuls block differently: float32 wiggle, magnified by wmhd
        np.testing.assert_allclose(batch[i], single, rtol=1e-5)


def test_action_quantization_and_clip(params):
    """Out-of-bounds actions are clipped, then truncated to 1e-3."""
    s0 = K.steady_init(params, 2)
    s1 = K.apply_action(s0, torch.full((2, 9), 99.0))
    np.testing.assert_allclose(s1.inputs[:, K.ACTION_TO_INPUT].numpy(),
                               np.broadcast_to(np.trunc(K.HIGH_ACTION * 1000) / 1000, (2, 9)),
                               atol=1e-6)
    s2 = K.apply_action(s0, torch.full((2, 9), -99.0))
    np.testing.assert_allclose(s2.inputs[:, K.ACTION_TO_INPUT].numpy(),
                               np.broadcast_to(np.trunc(K.LOW_ACTION * 1000) / 1000, (2, 9)),
                               atol=1e-6)
    # the untouched inputs stay
    rest = np.setdiff1d(np.arange(15), K.ACTION_TO_INPUT)
    assert torch.equal(s1.inputs[:, rest], s0.inputs[:, rest])


def test_quantize_equals_jax_bitwise():
    """JAX's trunc(v * 1000) / 1000 as XLA computes it, bit for bit."""
    x = np.random.default_rng(0).uniform(0, 5, 20_000).astype(np.float32)
    ref = np.asarray(jax.jit(JK.quantize)(jnp.asarray(x)))
    np.testing.assert_array_equal(K.quantize(torch.from_numpy(x)).numpy(), ref)


def test_steady_init_matches_jax(params, jparams):
    ref = JK.steady_init(jparams)
    got = K.steady_init(params, 3)
    for name in ("buffer", "inputs", "outputs"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == (3, *r.shape)
        # float32 MLPs, sums in another order (wmhd ~1e5: relative)
        np.testing.assert_allclose(g, np.broadcast_to(r, g.shape), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_lstm_and_policy_forward_match_jax(params, jparams):
    rng = np.random.default_rng(1)
    state = JK.steady_init(jparams)
    buf = (np.asarray(state.buffer)[None]
           * (1 + 0.05 * rng.normal(size=(4, K.SEQ_LEN, 18)))).astype(np.float32)
    ref = np.stack([np.asarray(JK.lstm_forward(jparams["lstm"], jnp.asarray(b))) for b in buf])
    got = K.lstm_forward(params["lstm"], torch.from_numpy(buf)).numpy()
    # two float32 LSTMs of 10 steps: 1e-5 of the output's scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    low = np.concatenate([np.concatenate([K.LOW_ACTION, K.LOW_TARGET])] * 3 + [K.LOW_TARGET])
    high = np.concatenate([np.concatenate([K.HIGH_ACTION, K.HIGH_TARGET])] * 3 + [K.HIGH_TARGET])
    obs = (low + rng.uniform(size=(5, 39)) * (high - low)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda o: JK.rl_policy_forward(jparams["rl"], o))(jnp.asarray(obs)))
    got = K.rl_policy_forward(params["rl"], torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ((got >= K.LOW_ACTION - 1e-6) & (got <= K.HIGH_ACTION + 1e-6)).all()


@pytest.mark.parametrize("du,dl", [(0.3, 0.75), (0.8, 0.4)])
def test_k2rz_forward_matches_jax(params, jparams, du, dl):
    args = (0.5, 1.8, 0.6, 1.32, 2.22, 1.7, du, dl)
    r_ref, z_ref = JK.k2rz_forward(jparams, *args)
    r, z = K.k2rz_forward(params, *args)
    assert r.shape == z.shape == (65,)
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z, z_ref, rtol=1e-5, atol=1e-6)


def _quantised(a):
    """The port's clip and 1e-3 quantisation of (..., 9) actions, numpy."""
    lo, hi = K.LOW_ACTION.astype(np.float32), K.HIGH_ACTION.astype(np.float32)
    return K.quantize(torch.from_numpy(np.clip(a, lo, hi).astype(np.float32))).numpy()


def _near_boundary(a, d):
    """Where an action lies within d of a 1e-3 quantisation boundary: a
    value within d of it may quantise to another step (clipped values are
    not near one unless the clip bound is)."""
    return _quantised(a - d) != _quantised(a + d)


@pytest.fixture(scope="module")
def jax_loop(jparams):
    """JAX's jitted closed loop of 3 trajectories (the quantisation as XLA
    compiles it, as the JAX datagen runs it) and the uniforms of its
    targets."""
    key = jax.random.PRNGKey(3)
    outs, acts, tgts = (
        np.asarray(a) for a in jax.jit(lambda k: JK.closed_loop_batch(jparams, k, 3))(key))
    u = np.stack([np.asarray(jax.random.uniform(k, (4, 3))) for k in jax.random.split(key, 3)])
    return outs, acts, tgts, u


def test_closed_loop_teacher_forced_matches_jax(params, jparams, jax_loop):
    """Every one of the 121 steps of JAX's closed loop, one step at a time:
    the port's policy on JAX's own observations, and the port's clip,
    quantisation and surrogate step on JAX's own states and actions. No
    step depends on an earlier one of the port, so nothing parts."""
    outs_ref, acts_ref, tgts_ref, _ = jax_loop

    def states(actions):
        def body(s, a):
            s1 = JK.apply_action(s, a)
            return JK.lstm_step(jparams, s1), (s, s1, JK.lstm_step(jparams, s1))

        return jax.lax.scan(body, JK.steady_init(jparams), actions)[1]

    before, applied, after = (jax.tree.map(np.asarray, x) for x in
                              jax.jit(jax.vmap(states))(jnp.asarray(acts_ref)))
    # the replayed states are the loop's own
    np.testing.assert_array_equal(after.outputs, outs_ref[:, 1:])

    # the policy: JAX's history rows [action, βp, q95, li] and target
    hist0 = np.concatenate([K.LOW_ACTION, K.TARGET_INIT]).astype(np.float32)
    rows = np.concatenate([acts_ref, outs_ref[:, 1:][..., [1, 4, 6]]], axis=2)
    hist = np.concatenate([np.broadcast_to(hist0, (3, K.LOOKBACK, 12)), rows], axis=1)
    obs = np.stack([np.concatenate([hist[:, s : s + K.LOOKBACK].reshape(3, -1),
                                    tgts_ref[:, s + 1]], axis=1) for s in range(121)], axis=1)
    acts = K.rl_policy_forward(params["rl"], torch.from_numpy(obs.reshape(-1, 39))).numpy()
    # float32 MLP, sums in another order: 5e-6 (measured 1.0e-6)
    np.testing.assert_allclose(acts.reshape(3, 121, 9), acts_ref, rtol=0, atol=5e-6)

    flat = {name: torch.from_numpy(np.array(x.reshape(363, *x.shape[2:])))
            for name, x in before._asdict().items()}
    state = K.apply_action(K.SolverState(**flat), torch.from_numpy(acts_ref.reshape(363, 9).copy()))
    # clip and quantisation of the same float32 action: bit for bit
    np.testing.assert_array_equal(state.inputs.numpy(), applied.inputs.reshape(363, 15))
    nxt = K.lstm_step(params, state)
    # float32 LSTM and MLPs (wmhd ~1e5: relative): 1e-5 (measured 8.8e-7
    # for the outputs, 4.5e-7 for the buffer)
    np.testing.assert_allclose(nxt.outputs.numpy(), after.outputs.reshape(363, 8),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nxt.buffer.numpy(), after.buffer.reshape(363, 10, 18),
                               rtol=1e-5, atol=1e-6)


# The rounding distance of the free-running loops: ten times the policy's
# teacher-forced error (1.0e-6), and over twice the free-running loops'
# action difference over the steps it lets them be compared (under 4e-6).
ROUNDING = 1e-5


def test_closed_loop_matches_jax_with_replayed_targets(params, jax_loop):
    """JAX's closed loop of 3 trajectories, its uniforms replayed into the
    port's targets, free-running. Policy and surrogate agree to float32
    rounding, but an action within rounding distance of a 1e-3 quantisation
    boundary can quantise to either side, after which the loops part. So
    the loops agree up to the first step where one of JAX's actions lies
    within ROUNDING of a boundary, which does not depend on the host's
    rounding; where they part later, it is at an action that lies within
    1e-4 (the actions' tolerance) of a boundary."""
    outs_ref, acts_ref, tgts_ref, u = jax_loop
    targets = K.targets_from_uniform(torch.from_numpy(u))
    outs, acts, tgts = (a.numpy() for a in K.closed_loop_from_targets(params, targets))
    assert outs.shape == (3, 122, 8) and acts.shape == (3, 121, 9) and tgts.shape == (3, 122, 3)
    np.testing.assert_array_equal(tgts, tgts_ref)

    near = _near_boundary(acts_ref, ROUNDING).any(axis=2)
    parted = np.abs(_quantised(acts) - _quantised(acts_ref)).max(axis=2) > 1e-4
    for i in range(3):
        first_near = int(np.argmax(near[i])) if near[i].any() else 121
        n = int(np.argmax(parted[i])) if parted[i].any() else 121
        assert n >= first_near, f"trajectory {i} parts at step {n}, before step {first_near}"
        np.testing.assert_allclose(acts[i, :first_near], acts_ref[i, :first_near], rtol=0,
                                   atol=ROUNDING)
        if n < 121:
            differ = _quantised(acts[i, n]) != _quantised(acts_ref[i, n])
            assert _near_boundary(acts_ref[i, n], 1e-4)[differ].all(), f"trajectory {i}"
        np.testing.assert_allclose(acts[i, :n], acts_ref[i, :n], rtol=0, atol=1e-4)
        # outputs row s + 1 follows action s
        np.testing.assert_allclose(outs[i, : n + 1], outs_ref[i, : n + 1], rtol=1e-4, atol=1e-5)
    # both loops stay physical throughout
    assert ((outs[..., 4] > 2.0) & (outs[..., 4] < 9.0)).all()
    assert ((acts >= K.LOW_ACTION - 1e-6) & (acts <= K.HIGH_ACTION + 1e-6)).all()
