"""The training-loop options of the port against the JAX package: SGD with
momentum against optax, `run_train_loop` with `steps_per_call` (the chunk
clamp at the checkpoint cadence, a tail chunk, a reshuffle inside a chunk)
and with a bfloat16 `device_pool` that is refreshed, on a toy model whose
loss takes a draw per step, with JAX's key chain replayed into the port.
float32 throughout; inputs from numpy with a seed."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch import nn

from safediffcon_tpu.core import train as JT
from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_torch.core import train as TT
from safediffcon_torch.tasks.smoke import pipeline as TP

torch.set_num_threads(1)

SHAPES = [(5, 3), (4,), (2, 3, 3)]


def _sgd_run(max_grad_norm, lr_j, lr_t, steps=5):
    rng = np.random.default_rng(11)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    tx = JT.make_optimizer("sgd", lr_j, max_grad_norm=max_grad_norm)
    opt = TT.make_optimizer("sgd", lr_t, max_grad_norm=max_grad_norm)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for i in range(steps):
        scale = (0.05, 3.0, 0.2, 10.0, 0.5)[i]  # global norms below and above 1
        g = [(scale * rng.normal(size=s) / 4).astype(np.float32) for s in SHAPES]
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g], ts)
        for a, b in zip(tp, jp):
            # the same float32 operations in the same order: 1e-7 relative
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-9)
    return opt, ts, tp


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0])
def test_sgd_matches_optax(max_grad_norm):
    """optax.sgd(lr, momentum=0.9) after clip_by_global_norm (or none), five
    updates, constant learning rate and a MultiStepLR schedule."""
    _sgd_run(max_grad_norm, 1e-2, 1e-2)
    opt, state, params = _sgd_run(max_grad_norm, JP.multistep_lr(1e-2, (2, 4), 0.5),
                                  TP.multistep_lr(1e-2, (2, 4), 0.5))
    assert isinstance(opt, TT.SGD) and state.count == 5
    # the state round-trips through its state_dict, as phase-state resume does
    fresh = opt.init(params)
    fresh.load_state_dict(state.state_dict())
    assert fresh.count == 5
    for a, b in zip(fresh.trace, state.trace):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# run_train_loop on a toy model
# ---------------------------------------------------------------------------

N, FEAT, B = 10, 4, 4  # a chunk of 3 steps takes 12 > 10 rows: a reshuffle inside it


def _data(n=N):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(n, FEAT)).astype(np.float32)
    data[:, 0] = np.arange(n)  # the row's index, exact in float32 and bfloat16
    return data


def _jax_setup(seen):
    params = {"w": jnp.asarray(np.eye(FEAT, dtype=np.float32) * 0.5),
              "b": jnp.zeros((FEAT,), jnp.float32)}
    state = JT.TrainState.create(params, JT.make_optimizer("adam", 1e-2), ema_decay=0.9,
                                 ema_update_every=2)

    def step_fn(state, rng, batch):
        jax.debug.callback(lambda b: seen.append(np.asarray(b)), batch, ordered=True)

        def loss_fn(p):
            x = batch + 0.1 * jax.random.normal(rng, batch.shape)
            return jnp.mean((x @ p["w"] + p["b"] - 1.0) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    return state, step_fn


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.eye(FEAT) * 0.5)
        self.b = nn.Parameter(torch.zeros(FEAT))


def _torch_setup(draws, seen):
    model = Toy()
    state = TT.TrainState.create(model, TT.make_optimizer("adam", 1e-2), ema_decay=0.9,
                                 ema_update_every=2)

    def step_fn(state, batch):
        seen.append(batch.numpy().copy())
        x = batch + 0.1 * next(draws)
        loss = torch.mean((x @ model.w + model.b - 1.0) ** 2)
        state.apply_gradients(torch.autograd.grad(loss, [model.w, model.b]))
        return loss.detach()

    return state, step_fn


def _chunks(k, num_steps, checkpoint_every=10**9):
    """JAX's chunk sizes: min(k, steps left), clamped at the cadence."""
    out, step = [], 0
    while step < num_steps:
        kk = min(k, num_steps - step)
        if checkpoint_every < 10**9:
            kk = min(kk, (step // checkpoint_every + 1) * checkpoint_every - step)
        out.append(kk)
        step += kk
    return out


def _step_draws(seed_key, chunks, k, pool):
    """Each step's draw in JAX's key order: `rng, key = split(rng)` per chunk,
    then split(key, k) for a full chunk of k > 1; a partial chunk runs single
    steps on split(key, kk); without the pool a k = 1 step takes the key."""
    rng, out = seed_key, []
    for kk in chunks:
        rng, key = jax.random.split(rng)
        keys = [key] if (kk == k == 1 and not pool) else list(jax.random.split(key, kk))
        out += [torch.from_numpy(np.array(jax.random.normal(kt, (B, FEAT)))) for kt in keys]
    return out


class Recorder:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args)


def _milestones(path):
    return sorted(int(name.split("-")[1].split(".")[0]) for name in os.listdir(path)
                  if name.startswith("ckpt-"))


def _run_both(tmp_path, num_steps, k, checkpoint_every=10**9, **kw):
    data = _data()
    seen_j, seen_t = [], []
    jstate, jstep = _jax_setup(seen_j)
    ck = dict(checkpoint_every=checkpoint_every)
    if checkpoint_every < 10**9:
        ck_j, ck_t = (dict(ck, checkpoint_dir=str(tmp_path / d)) for d in ("jax", "torch"))
    else:
        ck_j = ck_t = ck
    jlog, tlog = Recorder(), Recorder()
    jout = JT.run_train_loop(jstep, jstate, data, batch_take=B, num_steps=num_steps,
                             rng=jax.random.PRNGKey(3), seed=9, steps_per_call=k,
                             log_every=10**9, logger=jlog, **ck_j, **kw)
    jax.effects_barrier()
    draws = iter(_step_draws(jax.random.PRNGKey(3), _chunks(k, num_steps, checkpoint_every),
                             k, pool="device_pool" in kw))
    tstate, tstep = _torch_setup(draws, seen_t)
    tout = TT.run_train_loop(tstep, tstate, data, batch_take=B, num_steps=num_steps, seed=9,
                             steps_per_call=k, log_every=10**9, logger=tlog, **ck_t, **kw)
    assert next(draws, None) is None
    return jout, tout, seen_j, seen_t, jlog, tlog


def _check_params(jout, tout):
    # Adam from the same batches and draws; float32 sums in another order:
    # 1e-6 absolute on weights of order 1
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(tout.model, name).detach().numpy(),
                                   np.asarray(jout.params[name]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tout.ema_params[name].numpy(),
                                   np.asarray(jout.ema_params[name]), rtol=0, atol=1e-6)
    assert tout.step == int(jout.step)


def test_steps_per_call_matches_jax(tmp_path):
    """steps_per_call 3 over 7 steps with checkpoint_every 4: chunks 3, 1
    (clamped at the cadence), 3; the first chunk takes 12 of 10 rows, so the
    permutation is redrawn inside it, seeded at the chunk's first step."""
    assert _chunks(3, 7, 4) == [3, 1, 3]
    jout, tout, seen_j, seen_t, _, _ = _run_both(tmp_path, 7, 3, checkpoint_every=4)
    assert len(seen_t) == len(seen_j) == 7
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a[:, 0], b[:, 0])  # the same rows, in order
    # one draw of 12 indices: a chunk's batches differ from single steps'
    # where it holds the reshuffle
    single = []
    s1, f1 = _torch_setup(iter([torch.zeros(B, FEAT)] * 7), single)
    TT.run_train_loop(f1, s1, _data(), batch_take=B, num_steps=7, seed=9)
    assert [a[:, 0].tolist() for a in single[:2]] == [a[:, 0].tolist() for a in seen_t[:2]]
    assert not np.array_equal(single[2][:, 0], seen_t[2][:, 0])
    assert _milestones(tmp_path / "torch") == _milestones(tmp_path / "jax") == [4, 7]
    _check_params(jout, tout)


def test_device_pool_with_refresh_matches_jax(tmp_path):
    """A pool of 6 of the 10 rows in bfloat16, refreshed every 2 steps,
    chunks of 2: the gathered batches equal JAX's bit for bit (the same
    rounding to bfloat16), and the refreshes fall on the same steps."""
    jout, tout, seen_j, seen_t, jlog, tlog = _run_both(
        tmp_path, 6, 2, device_pool=6, pool_refresh_every=2)
    assert len(seen_t) == len(seen_j) == 6
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    data = _data()
    assert not np.array_equal(seen_t[0], data[seen_t[0][:, 0].astype(int)])  # bf16-rounded
    refreshed = [line for line in tlog.lines if "refreshed device" in line]
    assert refreshed == [line for line in jlog.lines if "refreshed device" in line]
    assert [int(line.split()[-1]) for line in refreshed] == [2, 4]
    _check_params(jout, tout)


def test_device_pool_default_refresh_and_single_steps(tmp_path):
    """The default refresh period max(1, 3 * pool // batch) = 3 with a pool
    of 4, and single steps (steps_per_call 1) on the pool."""
    jout, tout, seen_j, seen_t, jlog, tlog = _run_both(tmp_path, 5, 1, device_pool=4)
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    assert any("refreshed every 3 steps" in line for line in tlog.lines)
    assert [line for line in tlog.lines if "refreshed device" in line] == \
        [line for line in jlog.lines if "refreshed device" in line]
    _check_params(jout, tout)


def test_deadline_stops_at_a_chunk_boundary(tmp_path, monkeypatch):
    """A deadline that passes during the first chunk stops the loop after it
    (the clock is read at t0 and at each chunk boundary) and checkpoints the
    step reached; a resume goes on to the target."""
    import time as _t

    from safediffcon_torch.utils.checkpoint import latest_step, load_checkpoint

    data = _data(32)
    draws = iter([torch.zeros(B, FEAT)] * 12)
    state, step_fn = _torch_setup(draws, [])
    t0 = _t.time()
    calls = {"n": 0}

    def fake_time():
        calls["n"] += 1
        return t0 + (0.0 if calls["n"] <= 2 else 100.0) + calls["n"] * 1e-3

    monkeypatch.setattr(_t, "time", fake_time)
    out = TT.run_train_loop(step_fn, state, data, batch_take=B, num_steps=12, steps_per_call=4,
                            checkpoint_dir=str(tmp_path), deadline=t0 + 50.0)
    monkeypatch.undo()
    assert out.step == 4 and latest_step(str(tmp_path)) == 4
    state2, step_fn2 = _torch_setup(draws, [])
    state2.load_state_dict(load_checkpoint(str(tmp_path), 4))
    out2 = TT.run_train_loop(step_fn2, state2, data, batch_take=B, num_steps=12,
                             start_step=4, steps_per_call=4, checkpoint_dir=str(tmp_path))
    assert out2.step == 12 and _milestones(tmp_path) == [4, 12]
