"""Data parallelism of the tokamak and smoke pipelines on the CPU, on two
spawned gloo ranks (`torch_parallel_workers`), against the port in one
process and the JAX package under a 2-device mesh, with JAX's key chain
replayed: the tokamak calibrate and a tiny smoke calibrate
(test_torch_parallel_burgers.py holds the Burgers case). Each rank samples its half of every batch from
its rows of the global draws; with a seeded generator instead, two ranks
give what one process gives from the same seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tokamak_replay as TR
import torch_parallel_workers as W
from safediffcon_tpu.parallel import mesh as JM
from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as SJConf
from safediffcon_tpu.tasks.smoke import SmokeDataset as SJDataset
from safediffcon_tpu.tasks.smoke import SmokePipeline as SJPipeline
from safediffcon_tpu.tasks.tokamak import config as TJC
from safediffcon_tpu.tasks.tokamak import pipeline as TJP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.smoke.pipeline import build_model as smoke_model
from safediffcon_torch.tasks.smoke.pipeline import init_params as smoke_init
from safediffcon_torch.tasks.tokamak import TokamakDataset, generate_tokamak_dataset
from test_torch_smoke_pipeline import CONF as SCONF
from test_torch_smoke_pipeline import PIPE as SPIPE
from test_torch_smoke_pipeline import _replayed_noise, tiny_data  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.fixture
def jax_mesh():
    prev = JM.activate_mesh(JM.get_mesh(n_devices=2))
    yield JM.active_mesh()
    JM.activate_mesh(prev)


def _close(a, b, rtol, atol=1e-7):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def tokamak_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokamak") / "tokamak.npz")
    generate_tokamak_dataset(path, n_train=8, n_cal=8, n_test=4, seed=0, gen_batch=32,
                             device="cpu")
    return TokamakDataset.load(path, "cal")


def test_tokamak_calibrate_data_parallel(tokamak_data, jax_mesh, tmp_path):
    net = TR.init_params(TR.build_model(**TR.PIPE, device="cpu"), seed=0)
    params = state_dict_to_flax(net, net.state_dict())
    cal = tokamak_data
    jp = TJP.TokamakPipeline(TJC.TokamakConformalConfig(**TR.CONF), **TR.PIPE)
    q_ref = float(jp.calibrate(params, TR.jax_data(cal), 0.0, jax.random.PRNGKey(1)))
    args = (TR.CONF, TR.PIPE, TR.sd_from_flax(params), (cal.data, cal.state_phys),
            TR.calibrate_noise(jax.random.PRNGKey(1)))
    one = W.tokamak(*args)
    for got in W.run_ranks(W.tokamak, 2, tmp_path, *args):
        _close(got["q"], one["q"], 1e-5)
        _close(got["q_gen"], one["q_gen"], 1e-5)
        _close(got["q"], q_ref, 1e-4)  # the single-process test's tolerance
    assert one["q"] > 0


def test_smoke_calibrate_data_parallel(tiny_data, jax_mesh, tmp_path):  # noqa: F811
    cal = tiny_data["cal"]
    net = smoke_init(smoke_model(8, (1, 2), device="cpu"), seed=0)
    params = state_dict_to_flax(net, net.state_dict())
    jp = SJPipeline(SJConf(**SCONF), **SPIPE)
    q_ref = float(jp.calibrate(params, SJDataset(cal.data, cal.raw), jnp.zeros(()),
                               jax.random.PRNGKey(1)))
    steps = SCONF["ddim_sampling_steps"] - 1
    cal_noise = list(_replayed_noise(jax.random.PRNGKey(1), [cal.data.shape], steps))
    args = (SCONF, SPIPE, net.state_dict(), (cal.data, cal.raw), cal_noise)
    one = W.smoke(*args)
    for got in W.run_ranks(W.smoke, 2, tmp_path, *args):
        _close(got["q"], one["q"], 1e-5)
        _close(got["q_gen"], one["q_gen"], 1e-5)
        _close(got["q"], q_ref, 1e-4)  # the single-process test's tolerance
    assert one["q"] > 0
