"""UNet3D's remat policy "save_heavy" (selective activation checkpointing):
its gradients equal those of "full", in float32 and in bfloat16, and its
backward pass recomputes no convolution or matmul autograd recorded, while
K2 (its plain version here) is recomputed, as the JAX policy recomputes the
pallas_call it cannot save."""
import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from safediffcon_torch.models import unet3d as TU
from safediffcon_torch.ops import conv3d_mxu as K
from safediffcon_torch.tasks.smoke.pipeline import init_params

torch.set_num_threads(1)

POLICIES = {"none": dict(use_remat=False), "full": dict(remat_policy="full"),
            "save_heavy": dict(remat_policy="save_heavy")}


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops of `TU.SAVED_OPS` dispatched outside K2's plain
    version (whose own matmuls are K2's, not the model's)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.in_k2 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in TU.SAVED_OPS and not self.in_k2:
            self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _backward(policy, dtype, conv_impl, monkeypatch):
    """Gradients, op counts and K2 plain-version calls of one backward pass."""
    torch.manual_seed(0)
    net = TU.UNet3D(8, (1, 2), channels=7, compute_dtype=dtype, conv_impl=conv_impl,
                    **POLICIES[policy])
    init_params(net, seed=1)
    x = torch.randn(2, 4, 8, 8, 7)
    t = torch.tensor([3, 900])
    loss = (net(x, t) ** 2).mean()
    counter, k2_calls = _OpCounter(), [0]
    plain = K.conv3d_fused_plain

    def counted(*args):
        k2_calls[0] += 1
        counter.in_k2 += 1
        try:
            return plain(*args)
        finally:
            counter.in_k2 -= 1

    monkeypatch.setattr(K, "conv3d_fused_plain", counted)
    with counter:
        loss.backward()
    monkeypatch.setattr(K, "conv3d_fused_plain", plain)
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    n_fused = sum(isinstance(m, TU.FusedConv3x3x3) for m in net.modules())
    return grads, counter.counts, k2_calls[0], n_fused


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_save_heavy_gradients_equal_full(dtype, monkeypatch):
    ref, *_ = _backward("full", dtype, "pallas", monkeypatch)
    got, *_ = _backward("save_heavy", dtype, "pallas", monkeypatch)
    for name, g in ref.items():
        # the same ops on the same inputs: equal to 1e-6 relative (bitwise here)
        torch.testing.assert_close(got[name], g, rtol=1e-6, atol=1e-6 * float(g.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_save_heavy_recomputes_no_conv_or_matmul(conv_impl, monkeypatch):
    """The backward pass of "save_heavy" dispatches exactly the convolutions
    and matmuls of a backward pass without remat (those of the gradients
    themselves), where "full" dispatches more (its recomputed forward); K2
    runs in the backward once per conv for dx, plus once per conv for the
    recomputed forward under either remat policy."""
    _, none_ops, none_k2, n_fused = _backward("none", None, conv_impl, monkeypatch)
    _, full_ops, full_k2, _ = _backward("full", None, conv_impl, monkeypatch)
    _, heavy_ops, heavy_k2, _ = _backward("save_heavy", None, conv_impl, monkeypatch)
    assert heavy_ops == none_ops
    assert sum(full_ops.values()) > sum(none_ops.values())  # the count bites
    if conv_impl == "pallas":
        assert n_fused == 22 and none_k2 == n_fused
        assert heavy_k2 == full_k2 == none_k2 + n_fused
    else:
        assert n_fused == none_k2 == heavy_k2 == 0
