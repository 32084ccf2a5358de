"""The port's command line (`python -m safediffcon_torch.cli.main`) against
the JAX package's: `_dispatch_load` on each on-disk format (the arrays equal
the JAX loaders'), `_parse_checkpoints`, the flags and their defaults (equal
flag by flag but for the documented departures), the device checks, and the
Burgers path end to end on the CPU at a tiny size: generate-data -> pretrain
(--steps-per-call 2, then --resume) -> posttrain (--resume) / infft -> eval
(one milestone and a --checkpoints sweep), with the two-model errors and
outputs of tests/test_two_model_cli.py. The smoke and tokamak paths are in
test_torch_cli_tasks.py."""
import argparse
import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from safediffcon_tpu.cli import main as JM
from safediffcon_tpu.tasks.burgers.data import BurgersDataset as JBurgers
from safediffcon_tpu.tasks.smoke.data import SmokeDataset as JSmoke
from safediffcon_tpu.tasks.tokamak.data import TokamakDataset as JTokamak
from safediffcon_torch.cli import main as M
from safediffcon_torch.tasks.burgers import config as BC
from safediffcon_torch.tasks.burgers import pipeline as BP
from safediffcon_torch.tasks.burgers.data import BurgersDataset
from safediffcon_torch.tasks.smoke.data import SmokeDataset
from safediffcon_torch.tasks.tokamak.data import TokamakDataset
from tests.test_reference_loaders import _write_reference_sim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# _dispatch_load, _parse_checkpoints, flags
# ---------------------------------------------------------------------------

def _assert_same(got, ref, fields):
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


def test_dispatch_burgers_h5_with_sibling_resolution(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("cal", 2)):
        with h5py.File(tmp_path / f"burgers_{split}.h5", "w") as h5:
            grp = h5.create_group(split)
            grp.create_dataset("pde_11-128", data=rng.normal(size=(n, 11, 128)))
            grp.create_dataset("pde_11-128_f", data=rng.normal(size=(n, 10, 128)))
    path = str(tmp_path / "burgers_train.h5")  # the cal split resolves to the sibling
    for split, n in (("train", 4), ("cal", 2)):
        got = M._dispatch_load(BurgersDataset, path, split)
        assert len(got) == n and got.data.shape == (n, 16, 128, 3)
        _assert_same(got, JM._dispatch_load(JBurgers, path, split), ("data", "u_phys", "f_phys"))
    sub = M._dispatch_load(BurgersDataset, path, "train", subset=2)
    _assert_same(sub, JM._dispatch_load(JBurgers, path, "train", subset=2), ("data",))
    assert len(sub) == 2


def test_dispatch_smoke_sim_dirs(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(4):
        _write_reference_sim(tmp_path / "train", i, rng)
    _write_reference_sim(tmp_path / "test", 20000, rng)
    for split, n, kw in (("train", 3, dict(n_cal=1)), ("cal", 1, dict(n_cal=1)),
                         ("test", 1, {})):
        got = M._dispatch_load(SmokeDataset, str(tmp_path), split, **kw)
        assert len(got) == n
        _assert_same(got, JM._dispatch_load(JSmoke, str(tmp_path), split, **kw), ("data", "raw"))


def test_dispatch_tokamak_hf_waits_for_the_dataset(tmp_path):
    """A tokamak HF-dataset directory (written by `datasets.save_to_disk`)
    goes to `load_hf`, which the port reads with its own numpy Arrow reader:
    the arrays equal the JAX loader's. A directory with neither an HF
    dataset nor sim dirs still exits."""
    datasets = pytest.importorskip("datasets")
    rng = np.random.default_rng(4)
    outputs = rng.normal(size=(6, 122, 8))
    actions = rng.normal(size=(6, 121, 9)).astype(np.float32)
    path = tmp_path / "tok_ds"
    datasets.Dataset.from_dict({"outputs": list(outputs), "actions": list(actions)}
                               ).save_to_disk(str(path))
    kw = dict(n_train=3, n_cal=2, n_test=1)
    for split in ("train", "cal", "test"):
        got = M._dispatch_load(TokamakDataset, str(path), split, **kw)
        _assert_same(got, JM._dispatch_load(JTokamak, str(path), split, **kw),
                     ("data", "state_phys"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no sim-dir loader"):
        M._dispatch_load(TokamakDataset, str(tmp_path / "empty"), "train")


def test_dispatch_npz_fallback(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "b.npz")
    np.savez(path, train_u=rng.normal(size=(3, 11, 128)).astype(np.float32),
             train_f=rng.normal(size=(3, 10, 128)).astype(np.float32))
    got = M._dispatch_load(BurgersDataset, path, "train")
    assert len(got) == 3
    _assert_same(got, JM._dispatch_load(JBurgers, path, "train"), ("data", "u_phys", "f_phys"))
    tok = str(tmp_path / "t.npz")
    np.savez(tok, train_states=rng.normal(size=(2, 122, 3)).astype(np.float32),
             train_actions=rng.normal(size=(2, 121, 9)).astype(np.float32))
    _assert_same(M._dispatch_load(TokamakDataset, tok, "train"),
                 JM._dispatch_load(JTokamak, tok, "train"), ("data", "state_phys"))


def test_dispatch_wrong_format_errors(tmp_path):
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "x.h5", "w"):
        pass
    with pytest.raises(SystemExit, match="no HDF5 loader"):
        M._dispatch_load(TokamakDataset, str(tmp_path / "x.h5"), "train")


@pytest.mark.parametrize("spec", ["10:200:10", "3:5", "10,20,170", "0:0", "4:2", "1:5:0",
                                  "a:b", "1,x", "7"])
def test_parse_checkpoints_equals_jax(spec):
    try:
        ref = JM._parse_checkpoints(spec)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            M._parse_checkpoints(spec)
        assert str(got.value) == str(e)
    else:
        assert M._parse_checkpoints(spec) == ref


# the documented departures: flag -> (JAX default, port default)
DEPARTURES = {"steps_per_call": (None, 1), "eval_chunk": (10, 50)}


def _jax_parser():
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=sorted(JM.TASKS))
    p.add_argument("phase", choices=JM.PHASES)
    JM._add_common(p)
    return p


def test_flags_and_defaults_equal_jax():
    jp, tp = _jax_parser(), M.build_parser()
    j_actions = {a.dest: a for a in jp._actions if a.dest != "help"}
    t_actions = {a.dest: a for a in tp._actions if a.dest != "help"}
    assert set(t_actions) == set(j_actions) | {"device"}
    for dest, ja in j_actions.items():
        ta = t_actions[dest]
        assert ta.option_strings == ja.option_strings, dest
        assert ta.choices == ja.choices and ta.type == ja.type and ta.nargs == ja.nargs, dest
        want = DEPARTURES.get(dest, (ja.default, ja.default))
        assert (ja.default, ta.default) == want, dest
    assert t_actions["device"].default == "cuda"
    for argv in (["burgers", "eval"], ["smoke", "pretrain", "--conv-impl", "pallas",
                                       "--steps-per-call", "2", "--remat-policy", "save_heavy"]):
        ja, ta = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
        ta.pop("device")
        for dest in DEPARTURES:
            if dest not in argv and f"--{dest.replace('_', '-')}" not in argv:
                ja.pop(dest), ta.pop(dest)
        assert ta == ja
    # --help states the departures
    text = tp.format_help()
    for flag in ("--device", "--conv-impl", "--steps-per-call", "--eval-chunk", "--sp"):
        assert flag in text.split("except:")[1].split("Results are")[0], flag


def test_device_checks(tmp_path, monkeypatch):
    """Without a card, --device cuda exits with an error (there is no
    fall-back to the CPU); --sp 2 in one process exits with the JAX command
    line's message (sequence parallelism needs sp ranks on the frame axis)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ["--out", str(tmp_path)]
    with pytest.raises(SystemExit, match="--device cpu"):
        M.main(["burgers", "generate-data", "--n-train", "2"] + out)
    with pytest.raises(SystemExit, match=re.escape(
            "--sp 2 exceeds the 1 visible device(s); sequence parallelism needs at least "
            "sp devices on the frame axis")):
        M.main(["burgers", "eval", "--sp", "2", "--device", "cpu"] + out)
    assert not os.path.exists(tmp_path / "burgers.npz")
    with pytest.raises(SystemExit):
        M.main(["bogus", "pretrain"])


def test_module_entry_point_refuses_to_run_without_a_card(tmp_path):
    """`python -m safediffcon_torch.cli.main` with no card and no --device cpu
    exits non-zero and writes nothing; with --device cpu it runs, importing
    no module of JAX or of the JAX package (`-X importtime` lists them)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cmd = [sys.executable, "-X", "importtime", "-m", "safediffcon_torch.cli.main", "burgers",
           "generate-data", "--n-train", "2", "--n-cal", "1", "--n-test", "1",
           "--out", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "burgers.npz")
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and os.path.exists(tmp_path / "burgers.npz")
    modules = re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)", proc.stderr, re.M)
    assert "safediffcon_torch.tasks.burgers.data" in modules
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "safediffcon_tpu")]


# ---------------------------------------------------------------------------
# Burgers end to end on the CPU
# ---------------------------------------------------------------------------

CONF = dict(cal_batch_size=4, num_cal_batch=1, n_cal_samples=4, n_test_samples=2,
            test_batch_size=2, ddim_sampling_steps=3, timesteps=20)


@pytest.fixture
def tiny_burgers(monkeypatch):
    """The phase configs cut to a tiny size, as the JAX e2e tests cut theirs."""
    conf = functools.partial(BC.BurgersConformalConfig, **CONF)
    monkeypatch.setattr(BC, "BurgersConformalConfig", conf)
    monkeypatch.setattr(BC, "BurgersPretrainConfig", functools.partial(
        BC.BurgersPretrainConfig, dim_mults=(1, 2), timesteps=20, batch_size=4))
    monkeypatch.setattr(BC, "BurgersPostTrainConfig", functools.partial(
        BC.BurgersPostTrainConfig, conformal=conf(), finetune_epoch=2, finetune_steps=2,
        finetune_batch_size=2, finetune_subset_size=4))
    monkeypatch.setattr(BC, "BurgersInfFTConfig", functools.partial(
        BC.BurgersInfFTConfig, conformal=conf(), InfFT_iters=2))
    monkeypatch.setattr(BP, "BurgersPipeline", functools.partial(BP.BurgersPipeline,
                                                                 dim_mults=(1, 2)))


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_burgers_end_to_end(tmp_path, tiny_burgers, capsys):
    out = str(tmp_path)
    c = ["--out", out, "--device", "cpu", "--dim", "8"]
    assert M.main(["burgers", "generate-data", "--n-train", "8", "--n-cal", "4",
                   "--n-test", "2"] + c) == 0
    assert M.main(["burgers", "pretrain", "--steps", "2", "--steps-per-call", "2"] + c) == 0
    assert M.main(["burgers", "pretrain", "--steps", "4", "--steps-per-call", "2",
                   "--resume"] + c) == 0
    assert sorted(os.listdir(tmp_path / "burgers-pretrain")) == ["ckpt-2.pt", "ckpt-4.pt"]
    assert torch.load(tmp_path / "burgers-pretrain" / "ckpt-4.pt")["step"] == 4

    assert M.main(["burgers", "posttrain", "--resume"] + c) == 0
    first = _json(tmp_path / "burgers_posttrain_results.json")
    assert [r["epoch"] for r in first] == [0, 1] and np.isfinite(first[0]["loss"])
    # --resume: the phase state holds both epochs, so a rerun trains nothing
    # and returns the saved records
    assert M.main(["burgers", "posttrain", "--resume"] + c) == 0
    assert _json(tmp_path / "burgers_posttrain_results.json") == first
    assert M.main(["burgers", "infft"] + c) == 0
    assert len(_json(tmp_path / "burgers_infft_results.json")) == 1

    capsys.readouterr()
    assert M.main(["burgers", "eval", "--checkpoints", "2:6:2"] + c) == 0
    table = _json(tmp_path / "burgers_eval_sweep.json")
    assert set(table) == {"2", "4", "6"} and "error" in table["6"]  # no milestone 6
    assert np.isfinite(table["4"]["control_mse_mean (J)"])
    printed = capsys.readouterr().out
    assert printed.splitlines()[0].startswith("checkpoint\t")
    assert M.main(["burgers", "eval", "--from-phase", "posttrain"] + c) == 0
    m = _json(tmp_path / "burgers_eval_results.json")
    # milestones load onto the asked device (the pipelines bind them as given)
    args = M.build_parser().parse_args(["burgers", "eval"] + c)
    params, _ = M._load_params(args, out, "burgers", step=2, device="meta")
    assert params and all(v.is_meta for v in params.values())
    assert np.isfinite(m["quantile"]) and np.isfinite(m["control_mse_mean (J)"])

    meta = {p: _json(tmp_path / "metadata" / f"{p}.json")
            for p in ("generate-data", "pretrain", "posttrain", "infft", "eval")}
    assert list(meta["pretrain"]) == ["burgers-pretrain-0", "burgers-pretrain-1"]
    assert meta["pretrain"]["burgers-pretrain-1"]["args"]["resume"] is True
    assert meta["eval"]["burgers-eval-0"]["args"]["device"] == "cpu"


def test_burgers_two_model(tmp_path, tiny_burgers):
    """tests/test_two_model_cli.py's path: the prior's pretrain, the errors,
    and beta 1 reducing to the single-model path."""
    out = str(tmp_path)
    c = ["--out", out, "--device", "cpu", "--dim", "8"]
    assert M.main(["burgers", "generate-data", "--n-train", "8", "--n-cal", "4",
                   "--n-test", "2"] + c) == 0
    assert M.main(["burgers", "pretrain", "--steps", "2"] + c) == 0
    with pytest.raises(SystemExit, match="no w-model checkpoint"):
        M.main(["burgers", "eval", "--two-model"] + c)
    assert M.main(["burgers", "pretrain", "--steps", "2", "--model-w"] + c) == 0
    assert os.path.isdir(os.path.join(out, "burgers-pretrain-w"))
    with pytest.raises(SystemExit, match="sampling/eval"):
        M.main(["burgers", "posttrain", "--two-model"] + c)

    def j(*extra):
        assert M.main(["burgers", "eval", "--ddim-steps", "4", *extra] + c) == 0
        return _json(tmp_path / "burgers_eval_results.json")["control_mse_mean (J)"]

    half, one, single = (j("--two-model", "--prior-beta", "0.5"),
                         j("--two-model", "--prior-beta", "1.0"), j())
    assert np.isfinite(half)
    assert one == pytest.approx(single, rel=1e-4)
    assert half != pytest.approx(single, rel=1e-6)


def test_burgers_pretrain_on_two_ranks(tmp_path, tiny_burgers):
    """`burgers pretrain` as two gloo ranks of a launch on the CPU: the
    command line builds the data mesh over them, only rank 0 writes the
    checkpoint and the run registry, and both ranks end with the same
    weights, which are the checkpoint's."""
    import torch_parallel_workers as W

    out = str(tmp_path / "run")
    c = ["--out", out, "--device", "cpu", "--dim", "8"]
    assert M.main(["burgers", "generate-data", "--n-train", "8", "--n-cal", "4",
                   "--n-test", "2"] + c) == 0
    ranks = W.run_ranks(W.cli_burgers_pretrain, 2, tmp_path, out, mesh_shape=None)
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[0]["saves"] and all(name.startswith("ckpt-2.pt.") for name in
                                     ranks[0]["saves"])
    assert ranks[1]["saves"] == []
    assert sorted(os.listdir(os.path.join(out, "burgers-pretrain"))) == ["ckpt-2.pt"]
    saved = torch.load(os.path.join(out, "burgers-pretrain", "ckpt-2.pt"))
    assert saved["step"] == 2
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
        np.testing.assert_array_equal(saved["params"][k].numpy(), v)
    assert list(_json(os.path.join(out, "metadata", "pretrain.json"))) == ["burgers-pretrain-0"]


def test_spawned_workers_run_and_a_failing_rank_fails_the_command(tmp_path, monkeypatch):
    """The spawner the command line uses with several cards and no launcher
    (`_spawn_workers`), driven here with --device cpu: two ranks join over
    localhost and train, rank 0 writes the checkpoint; a command every rank
    fails on returns 1 after the ranks are stopped."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank: one thread
    out = str(tmp_path)
    c = ["--out", out, "--device", "cpu", "--dim", "8"]
    assert M.main(["burgers", "generate-data", "--n-train", "8", "--n-cal", "4",
                   "--n-test", "2"] + c) == 0
    assert M._spawn_workers(["burgers", "pretrain", "--steps", "1"] + c, 2) == 0
    assert sorted(os.listdir(tmp_path / "burgers-pretrain")) == ["ckpt-1.pt"]
    assert M._spawn_workers(["burgers", "pretrain", "--steps", "1", "--data",
                             str(tmp_path / "missing.npz")] + c, 2) == 1
