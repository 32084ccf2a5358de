"""The tokamak task's math (`tasks/tokamak/task.py`, `metrics.py`) against
the reference goldens (tests/golden/tokamak_weights_reference.npz, the
reference's calculate_weight / normalize_weights) and against the JAX
package on the same inputs: the conditioner, the guidance loss and its
gradient, the conformal score, the backward loss and the metric set."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.tokamak import metrics as JM
from safediffcon_tpu.tasks.tokamak import task as JT
from safediffcon_torch.core.conformal import normalize_weights
from safediffcon_torch.tasks.tokamak import metrics as TM
from safediffcon_torch.tasks.tokamak import task as TT

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tokamak_weights_reference.npz")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_weights_match_reference_goldens():
    """The port's shift_weights and normalize_weights on the reference's
    fixture (layout transposed: the reference is (B, C, T), the port
    (B, T, C)): the single factor, the posttrain squared-train composite,
    the test-mode finetune composite, and the sum = n normalization, at the
    JAX test's rtol 2e-5."""
    g = np.load(GOLDEN)
    x = _t(g["x"].transpose(0, 2, 1).copy())
    tgt = _t(g["tgt"].transpose(0, 2, 1).copy())
    Q, Q_ft = float(g["Q"]), float(g["Q_ft"])
    cfg = TT.TokamakTaskConfig(w_obj=0.5, w_safe=0.5, guidance_scaler=5.0)
    w = TT.shift_weights(x, tgt, Q, cfg)
    np.testing.assert_allclose(w.numpy(), g["w_single"], rtol=2e-5)
    np.testing.assert_allclose((w * w).numpy(), g["w_train_squared"], rtol=2e-5)
    cfg_ft = TT.TokamakTaskConfig(w_obj=0.4, w_safe=0.6, guidance_scaler=0.01)
    w_ft = TT.shift_weights(x, tgt, Q_ft, cfg_ft)
    np.testing.assert_allclose((w * w_ft).numpy(), g["w_test_composite"], rtol=2e-5)
    np.testing.assert_allclose(normalize_weights(w * w).numpy(),
                               g["w_train_squared_normalized"], rtol=2e-5)


def _batch(seed, b=4):
    """A normalized (B, 128, 12) batch with zero padding, the physical
    targets, and noise."""
    rng = np.random.default_rng(seed)
    states = np.stack([rng.uniform(0.5, 2.0, (b, TT.NT)), rng.uniform(3.5, 7.0, (b, TT.NT)),
                       rng.uniform(0.7, 1.2, (b, TT.NT))], axis=-1)
    actions = rng.uniform(0.0, 2.0, (b, TT.NT - 1, 9))
    x = np.zeros((b, TT.PAD_SIZE, 12), np.float32)
    x[:, : TT.NT, :3] = states
    x[:, : TT.NT - 1, 3:] = actions
    x /= TT.SCALER
    target = (states * rng.uniform(0.9, 1.1, states.shape)).astype(np.float32)
    return x, target, rng.normal(size=x.shape).astype(np.float32)


def test_conditioner_matches_jax():
    x, _, noise = _batch(0)
    cond_j = JT.TokamakConditioner(u0=jnp.asarray(x[:, 0, :3]),
                                   uT=jnp.stack([x[:, :122, 0], x[:, :122, 2]], -1),
                                   w=jnp.asarray(x[:, :, 3:]))
    for actions in (False, True):
        ref = (cond_j if actions else cond_j.replace(w=None)).apply(jnp.asarray(noise))
        got = TT.sampling_conditioner(_t(x), actions=actions).apply(_t(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    train_j, train_t = JT.train_conditioner(), TT.train_conditioner()
    np.testing.assert_array_equal(train_t.apply_train(_t(noise), _t(x)).numpy(),
                                  np.asarray(train_j.apply_train(jnp.asarray(noise),
                                                                 jnp.asarray(x))))
    np.testing.assert_array_equal(train_t.loss_target(_t(noise)).numpy(),
                                  np.asarray(train_j.loss_target(jnp.asarray(noise))))
    np.testing.assert_array_equal(
        train_t.mask_output(_t(noise), _t(x)).numpy(),
        np.asarray(train_j.mask_output(jnp.asarray(noise), jnp.asarray(x))))


@pytest.mark.parametrize("w_obj,w_safe,Q", [(0.0, 1.0, 0.0), (0.5, 0.5, 0.3), (1.0, 2.0, 1.5)])
def test_guidance_loss_and_gradient_match_jax(w_obj, w_safe, Q):
    x, target, _ = _batch(1)
    cfg_j = JT.TokamakTaskConfig(w_obj=w_obj, w_safe=w_safe, guidance_scaler=5.0)
    cfg_t = TT.TokamakTaskConfig(w_obj=w_obj, w_safe=w_safe, guidance_scaler=5.0)
    ref = np.asarray(JT.guidance_loss(jnp.asarray(x), jnp.asarray(target), Q, cfg_j))
    got = TT.guidance_loss(_t(x), _t(target), Q, cfg_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (ref > 0).any()  # the safety relu is active somewhere
    g_ref = np.asarray(JT.guidance_grad_fn(jnp.asarray(target), Q, cfg_j)(jnp.asarray(x)))
    g = TT.guidance_grad_fn(_t(target), Q, cfg_t)(_t(x)).numpy()
    np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TT.shift_weights(_t(x), _t(target), Q, cfg_t).numpy(),
                               np.asarray(JT.shift_weights(jnp.asarray(x), jnp.asarray(target),
                                                           Q, cfg_j)), rtol=1e-5)


def test_conformal_score_and_backward_loss_match_jax():
    x, target, noise = _batch(2)
    pred = x + 0.05 * noise
    np.testing.assert_allclose(
        TT.conformal_score(_t(pred), _t(x)).numpy(),
        np.asarray(JT.conformal_score(jnp.asarray(pred), jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    cfg_j = JT.TokamakTaskConfig(w_obj=0.3, w_safe=1.0)
    cfg_t = TT.TokamakTaskConfig(w_obj=0.3, w_safe=1.0)
    scaled = pred * TT.SCALER
    for Q in (0.0, 2.0):
        ref = float(JT.backward_loss(jnp.asarray(scaled), jnp.asarray(target), Q, cfg_j))
        got = float(TT.backward_loss(_t(scaled), _t(target), Q, cfg_t))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_evaluate_samples_matches_jax():
    """The metric set on sampled (physical) trajectories, controlled states
    straddling the threshold; stds with ddof 1."""
    x, target, noise = _batch(3, b=6)
    diffused = (x + 0.05 * noise) * TT.SCALER
    rng = np.random.default_rng(4)
    controlled = (target * rng.uniform(0.9, 1.1, target.shape)).astype(np.float32)
    # q95 of each sample near its own level, 4.6 to 5.6: some dip below 4.98
    controlled[:, :, 1] = (np.linspace(4.6, 5.6, 6)[:, None]
                           + rng.uniform(0.0, 0.2, (6, TT.NT))).astype(np.float32)
    ref = JM.evaluate_samples(jnp.asarray(diffused), jnp.asarray(controlled),
                              jnp.asarray(target), 4.98)
    got = TM.evaluate_samples(_t(diffused), _t(controlled), _t(target), 4.98)
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(float(got[name]), float(r), rtol=1e-5, err_msg=name)
    assert 0 < float(got["sample_below_ratio"]) < 1  # both sides of the threshold
