"""The two tools that replay JAX's tokamak data draw on the port:
`tools/tokamak_jax_targets.py` (JAX; the target uniforms along
`generate_tokamak_dataset`'s key chain) and `tools/tokamak_data_arm.py`
(the port; the recipe's data from those uniforms or from a port seed, the
`tokamak_refscale` recipe on it, and the pretrain EMA recalibrated at five
generator keys). At small sizes that keep a partial last batch, the
uniforms equal `jax.random.uniform` on the key chain bit for bit, and the
port's quantized targets from them equal the targets JAX's jitted
`closed_loop_batch` returns for those keys bit for bit (the un-jitted call
JAX's datagen makes for its last batch within one ulp); the data arm at the
recipe's tiny sizes writes the layout of `generate_tokamak_dataset`."""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from safediffcon_tpu.solvers import kstar as JK
from safediffcon_torch.experiments import round1 as R1
from safediffcon_torch.solvers import kstar as K
from safediffcon_torch.tasks.tokamak import TokamakDataset, generate_tokamak_dataset

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import tokamak_data_arm  # noqa: E402
import tokamak_jax_targets  # noqa: E402

# 12 + 4 + 4 sims in batches of 8: 8, 8 and a last, partial batch of 4
SIZES = dict(n_train=12, n_cal=4, n_test=4, gen_batch=8)


def _key_chain(total, gen_batch):
    """generate_tokamak_dataset's per-batch keys and sizes at its seed 0."""
    rng, out, done = jax.random.PRNGKey(0), [], 0
    while done < total:
        n = min(gen_batch, total - done)
        rng, key = jax.random.split(rng)
        out.append((key, n))
        done += n
    return out


def test_uniforms_and_targets_are_jaxs(tmp_path):
    npy = tmp_path / "u.npy"
    assert tokamak_jax_targets.main(["--out", str(npy)] + [
        f"--{k.replace('_', '-')}={v}" for k, v in SIZES.items()]) == 0
    u = np.load(npy)
    meta = json.loads(Path(f"{npy}.json").read_text())
    assert u.shape == (20, 4, 3) and u.dtype == np.float32 and meta["shape"] == [20, 4, 3]
    assert meta["jax_version"] == jax.__version__
    assert meta["jax_threefry_partitionable"] == bool(jax.config.jax_threefry_partitionable)
    chain = _key_chain(20, SIZES["gen_batch"])
    assert [n for _, n in chain] == [8, 8, 4]
    want = np.stack([np.asarray(jax.random.uniform(k, (4, 3)))
                     for key, n in chain for k in jax.random.split(key, n)])
    assert np.array_equal(u, want)

    # JAX's datagen jits closed_loop_batch for its full batches, where XLA
    # divides by 1000 as a product with the float32 reciprocal, as the port's
    # quantize does; its last, partial batch runs un-jitted, where the
    # division is exact: those targets part from the port's by one ulp at most
    params, jparams = K.load_kstar_params(device="cpu"), JK.load_kstar_params()
    lo = 0
    for key, n in chain:
        _, _, targets = K.closed_loop_from_targets(
            params, K.targets_from_uniform(torch.from_numpy(u[lo : lo + n])))
        jitted = jax.jit(lambda k, n=n: JK.closed_loop_batch(jparams, k, n))(key)[2]
        assert np.array_equal(targets.numpy(), np.asarray(jitted))
        if n < SIZES["gen_batch"]:
            eager = np.asarray(JK.closed_loop_batch(jparams, key, n)[2])
            ulps = np.abs(eager.view(np.int32) - targets.numpy().view(np.int32))
            assert ulps.max() <= 1
        lo += n


def test_data_seed_arm_is_the_ports_draw(tmp_path):
    tokamak_data_arm.write_data(str(tmp_path / "arm.npz"), SIZES, "cpu", data_seed=1)
    generate_tokamak_dataset(str(tmp_path / "port.npz"), **SIZES, seed=1, device="cpu")
    with np.load(tmp_path / "arm.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_tiny_arm_on_jax_targets(tmp_path, capsys):
    sizes = R1.recipe("tokamak_refscale", "tiny", "cpu")["generate_tokamak_dataset"]
    npy = tmp_path / "u.npy"
    np.save(npy, tokamak_jax_targets.jax_uniforms(sizes["n_train"], sizes["n_cal"],
                                                  sizes["n_test"], sizes["gen_batch"]))
    out = tmp_path / "arm"
    assert tokamak_data_arm.main(["--device", "cpu", "--targets", str(npy),
                                  "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    # the layout of generate_tokamak_dataset at the same sizes
    generate_tokamak_dataset(str(tmp_path / "port.npz"), **sizes, device="cpu")
    with np.load(out / "tok_ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
        assert {k: a[k].dtype for k in a.files} == {k: b[k].dtype for k in b.files}
    for split in ("train", "cal", "test"):
        assert len(TokamakDataset.load(str(out / "tok_ref.npz"), split)) == sizes[f"n_{split}"]
    assert any(x.startswith("DATA reused ") for x in lines)
    assert len([x for x in lines if x.startswith("COMPARE ")]) == 15
    calkeys = [x.split() for x in lines if x.startswith("CALKEY ")]
    assert [int(c[1]) for c in calkeys] == [0, 1, 2, 3, 4]
    result = json.loads(lines[-1])
    assert result == json.loads((out / "data_arm.json").read_text())
    spread = result["cal_spread"]
    assert spread["key0_equals_recipe"]
    assert spread["mean"] == pytest.approx(np.mean([c["Q"] for c in result["cal_keys"]]))
    assert all(v["K1"] == 0 and not v["K2"] for v in result["launches"].values())
