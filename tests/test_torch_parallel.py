"""The port's data parallelism (`safediffcon_torch/parallel/mesh.py`) on the
CPU, against the port in one process and the JAX package under a 2-device
mesh: the mesh helpers, a two-process `init_distributed`, and
`run_train_loop` (plain, `steps_per_call` 2, a device pool) on the toy
model of `test_torch_train_loop_options.py`, whose JAX key chain is
replayed. The ranks are spawned gloo processes (`torch_parallel_workers`)."""
import numpy as np
import jax
import pytest
import torch

import torch_parallel_workers as W
from safediffcon_tpu.core import train as JT
from safediffcon_tpu.parallel import mesh as JM
from safediffcon_torch.parallel import mesh as TM
from test_torch_train_loop_options import _chunks, _data, _step_draws

torch.set_num_threads(1)


@pytest.fixture
def jax_mesh():
    """The JAX package's data mesh over 2 of the conftest's 8 CPU devices."""
    prev = JM.activate_mesh(JM.get_mesh(n_devices=2))
    yield JM.active_mesh()
    JM.activate_mesh(prev)


def _shard_data(arr, r):
    """Device r's shard of a JAX array."""
    shard = next(s for s in arr.addressable_shards if s.device == arr.sharding.mesh.devices.flat[r])
    return np.asarray(shard.data)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_helpers_match_jax_shards(mesh_shape, tmp_path):
    """Each rank's `maybe_shard` slice is the shard JAX puts on the device of
    the same index (batch over 'data', frames over 'frames' with video=True),
    an axis the mesh does not divide stays whole, `gather` undoes the slice,
    `maybe_replicate` copies rank 0's tensors, and a sliced generator's draws
    are the rows of the single-process draw."""
    dp, sp = mesh_shape
    res = W.run_ranks(W.mesh_helpers, dp * sp, tmp_path, mesh_shape=mesh_shape)
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    jmesh = JM.get_mesh_2d(dp, sp) if sp > 1 else JM.get_mesh(n_devices=dp)
    ref_local = JM.maybe_shard(x, mesh=jmesh)
    ref_video = JM.maybe_shard(x, mesh=jmesh, video=True)
    full_randn = torch.randn((8, 5), generator=torch.Generator().manual_seed(3)).numpy()
    full_randint = torch.randint(0, 10, (8,), generator=torch.Generator().manual_seed(4)).numpy()
    for r, got in enumerate(res):
        assert got["rank"] == r and (got["data"], got["frames"]) == mesh_shape
        assert got["route"] == "all-reduce"  # gloo
        np.testing.assert_array_equal(got["local"], _shard_data(ref_local, r) if dp > 1 else x)
        np.testing.assert_array_equal(got["video"], _shard_data(ref_video, r))
        np.testing.assert_array_equal(got["odd"], x[:7])  # 7 rows: no split
        lo, hi = got["rows"]
        assert hi - lo == 8 // dp and got["kb"].shape == (2, 4 // dp, 3, 3)
        np.testing.assert_array_equal(got["gathered"], 2 * x)
        np.testing.assert_array_equal(got["bcast"][0], np.zeros(3))
        np.testing.assert_array_equal(got["bcast"][1], np.full((2, 2), 10.0))
        np.testing.assert_array_equal(got["randn"], full_randn[lo:hi])
        np.testing.assert_array_equal(got["randint"], full_randint[lo:hi])
        assert got["frame_lo"] == (None if sp == 1 else (r % sp) * (4 // sp))


def test_maybe_shard_without_mesh_and_pad_to_multiple():
    assert TM.active_mesh() is None
    x = np.ones((8, 2), np.float32)
    out = TM.maybe_shard(x)
    assert isinstance(out, torch.Tensor) and out.shape == (8, 2)
    sh = TM.batch_shard(8, frames=4)
    assert not sh.split and sh.frames is None
    loss, grads = torch.tensor(2.0), [torch.ones(3)]
    assert sh.reduce(loss, grads)[0] is not None  # nothing moves without a mesh
    b = np.arange(10, dtype=np.float32).reshape(5, 2)
    for m in (1, 2, 4):
        got, n = TM.pad_to_multiple(b, m)
        ref, n_ref = JM.pad_to_multiple(b, m)
        np.testing.assert_array_equal(got, ref)
        assert n == n_ref == 5


def test_init_distributed_two_processes(tmp_path):
    """Two processes with torchrun's RANK / WORLD_SIZE join one group
    through `init_distributed` (a file rendezvous here, as the tests run
    several at once), all-reduce across it and build the data mesh; with one
    process it does nothing (tests/test_multihost.py)."""
    res = W.run_ranks(W.init_two_processes, 2, tmp_path, mesh_shape="env")
    for r, got in enumerate(res):
        assert got == dict(joined=True, world=2, rank=r, sum=3.0,
                           mesh="2 data (gloo, all-reduce)")
    assert TM.init_distributed(world_size=1) is False
    assert TM.auto_mesh() is None  # one process: no mesh
    with pytest.raises(SystemExit, match="exceeds the 1 visible device"):
        TM.auto_mesh(sp=2)


def _jax_setup():
    """The toy model's JAX state and step (that of
    test_torch_train_loop_options.py, without its ordered debug callback,
    which JAX refuses on more than one device)."""
    import jax.numpy as jnp

    params = {"w": jnp.asarray(np.eye(W.FEAT, dtype=np.float32) * 0.5),
              "b": jnp.zeros((W.FEAT,), jnp.float32)}
    state = JT.TrainState.create(params, JT.make_optimizer("adam", 1e-2), ema_decay=0.9,
                                 ema_update_every=2)

    def step_fn(state, rng, batch):
        def loss_fn(p):
            x = batch + 0.1 * jax.random.normal(rng, batch.shape)
            return jnp.mean((x @ p["w"] + p["b"] - 1.0) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    return state, step_fn


LOOPS = {"plain": (1, 6, {}), "steps_per_call_2": (2, 6, {}),
         "device_pool": (2, 6, dict(device_pool=6, pool_refresh_every=2))}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_train_loop_data_parallel(case, jax_mesh, tmp_path):
    """Two ranks each take their half of every batch (micro-batch rows, the
    pool whole on each) and the same global draw's rows; with the gradient
    average they train what one process trains, and what JAX trains under a
    2-device mesh."""
    k, num_steps, kw = LOOPS[case]
    data = _data()
    jstate, jstep = _jax_setup()
    jout = JT.run_train_loop(jstep, jstate, data, batch_take=W.BATCH, num_steps=num_steps,
                             rng=jax.random.PRNGKey(3), seed=9, steps_per_call=k, **kw)
    draws = _step_draws(jax.random.PRNGKey(3), _chunks(k, num_steps), k,
                        pool="device_pool" in kw)
    one = W.train_loop(data, draws, k, num_steps, kw)
    ranks = W.run_ranks(W.train_loop, 2, tmp_path, data, draws, k, num_steps, kw)
    for r, got in enumerate(ranks):
        # each rank saw its rows of every batch
        assert len(got["seen"]) == num_steps
        for a, b in zip(got["seen"], one["seen"]):
            np.testing.assert_array_equal(a, b[2 * r : 2 * r + 2])
        # the mean of two half-batch means: float32 reassociation, 1e-6
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
        for name in ("w", "b"):
            np.testing.assert_allclose(got[name], one[name], rtol=0, atol=1e-6)
            # Adam from the same batches and draws as JAX (the single-process
            # test's tolerance)
            np.testing.assert_allclose(got[name], np.asarray(jout.params[name]), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(got["ema"][name], np.asarray(jout.ema_params[name]),
                                       rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["w"], ranks[1]["w"])  # identical on every rank
