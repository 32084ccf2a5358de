"""The port's DPM-Solver++(2M) update against JAX's when the denoiser
computes in bf16 (`tools/burgers_dpm_update_check.py`, whose run on the
card-trained stand-in is in PERF.md): both samplers are fed the same
denoiser outputs, in order, so their chains differ only in what each
framework computes around the denoiser. On seeded weights at a small width
(DPM-Solver++ 10 of 1,000 timesteps, the guidance active and off) the first
x0, at t = 999, is clipped to [-1, 1] in all but a few cells, and the
replayed chains agree within 1e-5. With a denoiser whose x0 stays inside
[-1, 1] at t = 999, as a trained one's partly does, the two frameworks'
float32 roundings of x0 = sqrt(1/abar) x - sqrt(1/abar - 1) eps
(sqrt(1/abar) = 2.03e4 there) part by ~1e-3, the port rounding each
product as written and jitted JAX fusing a multiply-add, and the replayed
chains part by as much; with every x0 but the last taken from one side they
agree again, so the gap is that rounding, not the update."""
import sys
from pathlib import Path

import pytest
import torch

from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig, BurgersDataset, BurgersPipeline, generate_burgers_dataset)
from safediffcon_torch.tasks.burgers.pipeline import init_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import burgers_dpm_update_check as U  # noqa: E402

DIM = 8


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dpm_bf16") / "b.npz")
    generate_burgers_dataset(path, n_train=4, n_cal=4, n_test=4, seed=0, device="cpu")
    return BurgersDataset.load(path, "test")


def _pipeline():
    return BurgersPipeline(BurgersConformalConfig(), dim=DIM, dim_mults=(1, 2),
                           compute_dtype="bfloat16", device="cpu")


@pytest.mark.parametrize("q", U.QS, ids=["q0", "q_jax"])
def test_dpm_update_in_bf16_matches_jax(test_split, q):
    pipe = _pipeline()
    params = init_params(pipe.model, seed=3).state_dict()
    got = U.check(pipe.apply_fn(params), test_split, 10, q)
    assert got["calls"] == 10
    # x0 at t = 999 is clipped in all but a few cells (measured: 2 of 24,576)
    assert got["x0_first"]["t"] == 999 and got["x0_first"]["kept_share"] < 1e-3
    # the B3 rule's bounds: the update alone agrees to float32 rounding
    assert got["replay"]["sample_rel_l2"] <= 1e-5
    assert abs(got["replay"]["J_rel"]) <= 1e-4
    assert got["live"]["sample_rel_l2"] < 0.1


def test_unclipped_first_x0_parts_the_replays_by_its_rounding(test_split):
    """A float32 denoiser whose x0 is a fixed field inside [-1, 1] at every
    t (eps = (x - sqrt(abar) x0) / sqrt(1 - abar)), at Q = 0."""
    sched = _pipeline().sched
    acp = sched.alphas_cumprod
    gen = torch.Generator().manual_seed(0)
    target = 0.5 * torch.tanh(torch.randn(test_split.data.shape, generator=gen))

    def denoise(x, t):
        a = acp[t].view(-1, 1, 1, 1)
        return (x - a.sqrt() * target) / (1 - a).sqrt()

    got = U.check(denoise, test_split, 10, 0.0)
    # measured: x0 at t = 999 1.26e-3 apart (3.7e-3 at most), replays 1.26e-3
    # apart, 1.1e-6 with the first x0 shared, 8.8e-8 with every x0 but the
    # last shared; the live chains, each denoiser call on its own iterate,
    # 4.1e-8
    x0 = got["x0_first"]
    assert x0["t"] == 999 and x0["kept_share"] == 1.0
    assert 1e-4 < x0["rel_l2"] < 1e-2 and 1e-4 < x0["max_abs_kept"] < 1e-2
    # the port rounds each product, as the formula is written (and as JAX
    # does un-jitted); jitted JAX fuses a x into a multiply-add
    assert x0["port_plain_share"] == 1.0 and x0["jax_fma_share"] >= 0.999
    assert 1e-4 < got["replay"]["sample_rel_l2"] < 1e-2
    assert got["replay_x0_first"]["sample_rel_l2"] <= 1e-5
    assert got["replay_x0_scan"]["sample_rel_l2"] <= 1e-6
    assert got["live"]["sample_rel_l2"] <= 1e-6
