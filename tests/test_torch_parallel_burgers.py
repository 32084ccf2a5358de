"""Data parallelism of the Burgers pipeline on the CPU, on two spawned gloo
ranks (`torch_parallel_workers`), against the port in one process and the
JAX package under a 2-device mesh, with JAX's key chain replayed:
calibrate, guided evaluate (each rank samples and rolls out its half of the
test batch, the metrics come from the gathered whole) and one pretrain step.
With a seeded generator instead, two ranks give what one process gives from
the same seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import burgers_replay as BR
import torch_parallel_workers as W
from burgers_replay import data, flax_params  # noqa: F401  (fixtures)
from safediffcon_tpu.parallel import mesh as JM
from safediffcon_tpu.tasks.burgers import config as BJC
from safediffcon_tpu.tasks.burgers import data as BJD
from safediffcon_tpu.tasks.burgers import pipeline as BJP
from safediffcon_torch.models.convert import state_dict_to_flax

torch.set_num_threads(1)


@pytest.fixture
def jax_mesh():
    prev = JM.activate_mesh(JM.get_mesh(n_devices=2))
    yield JM.active_mesh()
    JM.activate_mesh(prev)


def _close(a, b, rtol, atol=1e-7):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_burgers_data_parallel(data, flax_params, jax_mesh, tmp_path):  # noqa: F811
    cal, test, train = data["cal"], data["test"], data["train"]
    pre = dict(**BR.PIPE, timesteps=100, batch_size=4, cosine_t_max=4, checkpoint_every=10**9,
               lr=1e-4)
    jp = BJP.BurgersPipeline(BJC.BurgersConformalConfig(**BR.CONF), **BR.PIPE)
    q_ref = float(jp.calibrate(flax_params, cal.data, 0.0, jax.random.PRNGKey(1)))
    m_ref = jp.evaluate(flax_params, BJD.BurgersDataset(test.data, test.u_phys, test.f_phys),
                        q_ref, jax.random.PRNGKey(2))
    jstate = BJP.pretrain(BJC.BurgersPretrainConfig(**pre),
                          BJD.BurgersDataset(train.data, train.u_phys, train.f_phys),
                          num_steps=1, params=jax.tree_util.tree_map(jnp.asarray, flax_params))

    shape = (BR.CONF["cal_batch_size"], 16, BR.NX, 3)
    cal_noise = BR.calibrate_noise(jax.random.PRNGKey(1), 2, shape)
    eval_noise = [BR.sampler_noise(jax.random.PRNGKey(2), test.data.shape)]
    # the loop's split, then accumulated_grads' split
    _, key = jax.random.split(jax.random.PRNGKey(BJC.BurgersPretrainConfig(**pre).seed))
    step_noise = [BR.train_draws(jax.random.split(key, 1)[0], (4, 16, BR.NX, 3), 100)]
    sd = BR.sd_from_flax(flax_params)
    args = (BR.CONF, BR.PIPE, sd, cal.data, (test.data, test.u_phys, test.f_phys), cal_noise,
            eval_noise, pre, (train.data, train.u_phys, train.f_phys), step_noise)
    one = W.burgers(*args)
    ranks = W.run_ranks(W.burgers, 2, tmp_path, *args)
    for got in ranks:
        # half-batch samples gathered: the same float32 sampler, 1e-5 of Q-hat
        _close(got["q"], one["q"], 1e-5)
        _close(got["q_gen"], one["q_gen"], 1e-5)
        # against JAX: the single-process test's 1e-4 and metric check
        _close(got["q"], q_ref, 1e-4)
        BR.check_metrics(got["m"], m_ref)
        BR.check_metrics(got["m"], one["m"])
        BR.check_metrics(got["m_gen"], one["m_gen"])
        _close(got["loss"], one["loss"], 1e-6)
        # one Adam step: entries with a near-zero gradient land within 2 lr,
        # all but 1 % within 0.01 lr (`compare_params`), of JAX's and of one
        # process's
        got_sd = {k: torch.from_numpy(v) for k, v in got["params"].items()}
        BR.compare_params(got_sd, jstate.params, flax_params, pre["lr"])
        one_sd = {k: torch.from_numpy(v) for k, v in one["params"].items()}
        BR.compare_params(got_sd, state_dict_to_flax(BR.build_model(**BR.PIPE, device="meta"),
                                                     one_sd), flax_params, pre["lr"])
    assert one["q"] > 0 and one["q_gen"] > 0
