"""The reference's unused `finetune_Q` in the smoke task (reference:
2d/inference_2d.py:83-92): its test-mode reweighting passes a stored
finetune_Q to guidance(), which ignores the argument and uses the current
Q. The JAX package keeps that (`safediffcon_tpu/tasks/smoke/task.py`,
`shift_weights`), and so does the port: its test-mode weights, its
calibration weights on the test-set pipeline and its guidance gradient
take the current Q, equal the JAX package's on the same inputs, and would
differ if a stored finetune_Q were used."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import task as JT
from safediffcon_tpu.tasks.smoke.config import SmokeConformalConfig as JConf
from safediffcon_torch.tasks.smoke import SmokeConformalConfig, SmokeDataset, SmokePipeline
from safediffcon_torch.tasks.smoke import task as TT
from safediffcon_torch.tasks.smoke.pipeline import init_params

torch.set_num_threads(1)

Q_NOW, FINETUNE_Q = 0.05, 0.3  # the current Q-hat; a stored posttrain Q-hat
RATIOS = dict(standard_fixed_ratio=100.0, finetune_standard_fixed_ratio=5.0)


@pytest.fixture(scope="module")
def state():
    """Normalized records whose final safe rates straddle the bound at Q_NOW
    and all lie over it at FINETUNE_Q, so that the relu is active on both."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 2, 16, 16, 7)).astype(np.float32) * 0.2
    x[..., TT.SMOKE] = rng.uniform(0.0, 0.5, size=(6, 2, 1, 1))
    x[..., TT.SAFE] = np.linspace(0.0, 0.12, 6, dtype=np.float32)[:, None, None, None]
    return x


def _task_cfg(**kw):
    return dict(safe_bound=0.1, w_safe=0.9, alpha=0.04, **RATIOS, **kw)


def _reference_weight(x, q, ratio, cfg):
    """exp(-ratio * guidance(x, q)) in numpy (reference: 2d/inference_2d.py:173-186)."""
    s = x * TT.RESCALER
    success = s[..., TT.SMOKE].mean(axis=(-1, -2, -3))
    safe = np.maximum(s[:, -1, :, :, TT.SAFE].mean(axis=(-1, -2)) + q - cfg["safe_bound"], 0.0)
    return np.exp(-ratio * (-(1.0 - cfg["w_safe"]) * success + cfg["w_safe"] * safe))


def test_configs_hold_no_finetune_q():
    for cls in (TT.SmokeTaskConfig, JT.SmokeTaskConfig, SmokeConformalConfig, JConf):
        assert "finetune_Q" not in {f.name for f in dataclasses.fields(cls)}
    assert ({f.name for f in dataclasses.fields(TT.SmokeTaskConfig)}
            == {f.name for f in dataclasses.fields(JT.SmokeTaskConfig)})


def test_test_mode_weights_use_the_current_q(state):
    cfg = _task_cfg()
    got = TT.shift_weights(torch.from_numpy(state), Q_NOW, TT.SmokeTaskConfig(**cfg), "test")
    ref = JT.shift_weights(jnp.asarray(state), Q_NOW, JT.SmokeTaskConfig(**cfg), mode="test")
    # exp(-ratio g): the relative error is ratio times g's, whose float32
    # sums run in another order on each side (seen: 1.6e-6 at ratio 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    now = _reference_weight(state, Q_NOW, RATIOS["finetune_standard_fixed_ratio"], cfg)
    stored = _reference_weight(state, FINETUNE_Q, RATIOS["finetune_standard_fixed_ratio"], cfg)
    # the float64 formula against float32 sums: exp(-ratio g) scales g's rounding
    np.testing.assert_allclose(got.numpy(), now, rtol=1e-4)
    assert np.abs(got.numpy() - stored).max() > 0.1 * np.abs(now).max()  # a stored Q would show
    train = TT.shift_weights(torch.from_numpy(state), Q_NOW, TT.SmokeTaskConfig(**cfg), "train")
    np.testing.assert_allclose(
        train.numpy(), _reference_weight(state, Q_NOW, RATIOS["standard_fixed_ratio"], cfg),
        rtol=1e-4)


def test_guidance_uses_the_current_q(state):
    cfg = _task_cfg()
    x = torch.from_numpy(state)
    got = TT.guidance_grad_fn(Q_NOW, TT.SmokeTaskConfig(**cfg))(x)
    ref = JT.guidance_grad_fn(Q_NOW, JT.SmokeTaskConfig(**cfg))(jnp.asarray(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    stored = TT.guidance_grad_fn(FINETUNE_Q, TT.SmokeTaskConfig(**cfg))(x)
    assert float((got - stored).abs().max()) > 0.1 * float(got.abs().max())


def test_test_set_calibration_weights_use_the_current_q(state):
    """SmokePipeline(finetune_set="test") calibrates with train-mode times
    test-mode weights, both at the Q it is given."""
    conf = SmokeConformalConfig(cal_batch_size=6, num_cal_batch=1, ddim_sampling_steps=2,
                                timesteps=10, **RATIOS)
    pipe = SmokePipeline(conf, dim=8, dim_mults=(1, 2), finetune_set="test", device="cpu")
    init_params(pipe.model, seed=0)
    pipe.record = {}
    raw = state * TT.RESCALER
    pipe.calibrate(SmokeDataset(state, raw), torch.tensor(Q_NOW),
                   generator=torch.Generator().manual_seed(0))
    tc = JT.SmokeTaskConfig(**_task_cfg())
    ref = (JT.shift_weights(jnp.asarray(state), Q_NOW, tc, "train")
           * JT.shift_weights(jnp.asarray(state), Q_NOW, tc, "test"))
    # ratio 100 (seen: 3.3e-5; see the test-mode weights above)
    np.testing.assert_allclose(pipe.record["cal_weights"].numpy(), np.asarray(ref), rtol=2e-4)
    cfg = _task_cfg()
    stored = (_reference_weight(state, Q_NOW, RATIOS["standard_fixed_ratio"], cfg)
              * _reference_weight(state, FINETUNE_Q, RATIOS["finetune_standard_fixed_ratio"], cfg))
    assert np.abs(pipe.record["cal_weights"].numpy() - stored).max() > 0.1 * np.abs(ref).max()
