"""Data parallelism inside captured CUDA graphs, and one kernel build per
checkout, on the CPU.

- The capture decision (`Graphs.on`, `pmesh.graph_collectives`): a batch
  split over an NCCL group runs as a graph, one split over gloo runs
  eagerly and the log says so once, one process runs as a graph; a
  sliced generator registers the generator it wraps.
- Burgers and tokamak calibrate and pretrain, the tokamak evaluate, the
  Burgers post-training and InfFT phases and tokamak's post-training and
  backward fine-tuning (`run_inference`), on two gloo ranks through the
  graph stand-in (`torch_graph_standin`), with the gate opened as an NCCL
  group opens it: the graphs hold the gathers and the gradient all-reduce
  (recorded and replayed like any operation) and give what the eager
  split gives, bit for bit.
- The loss a data-parallel split returns holds its own value only, not
  the flattened gradient it was all-reduced with (a kept loss would keep
  that gradient alive: every step's, over a run).
- Four processes calling `build.build_all` at once against a stand-in
  nvcc: one compile, the same library for all four.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_graph_standin as standin
import torch_parallel_workers as W
from safediffcon_torch.core.train import CapturedCall, Graphs
from safediffcon_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


class _Shard:
    def __init__(self, dp):
        self.dp, self.split, self.group = dp, dp > 1, None


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_capture_decision(backend, monkeypatch, caplog):
    """NCCL: a split batch is a graph; gloo: eager, logged once; one
    process: a graph on either; no process group: no graph for a split."""
    standin.install(monkeypatch)
    assert not pmesh.graph_collectives(None)  # no process group here
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert pmesh.graph_collectives(None) == (backend == "nccl")
    graphs = Graphs("cpu", True, "p")
    with caplog.at_level("INFO", logger="safediffcon_torch.core.train"):
        assert graphs.on(_Shard(1))
        assert graphs.on(_Shard(4)) == graphs.on(_Shard(2)) == (backend == "nccl")
    logged = sum("eager calls" in r.getMessage() for r in caplog.records)
    assert logged == (backend == "gloo")
    assert not Graphs("cpu", False, "p").on(_Shard(4))


def test_sliced_generator_registers_its_generator(monkeypatch):
    """A data-parallel rank's `SlicedGenerator` is registered with the
    graph as the generator it wraps (a CUDA graph takes only those)."""
    standin.install(monkeypatch)
    g = torch.Generator().manual_seed(0)
    call = CapturedCall("cpu", generators=[pmesh.SlicedGenerator(g, 4, 2, 4), g])
    assert call.generators == [g, g]
    x = torch.zeros(2)
    for _ in range(3):
        call(lambda: x.copy_(pmesh.randn((2,), pmesh.SlicedGenerator(g, 4, 2, 4))))
    assert call.graph is not None and call.graph.generators == [g, g]


B_CONF = dict(cal_batch_size=6, num_cal_batch=1, n_cal_samples=6, n_test_samples=4,
              test_batch_size=4, ddim_sampling_steps=3, timesteps=100, w_score=5.0, alpha=0.7)
T_CONF = dict(cal_batch_size=12, num_cal_batch=1, n_cal_samples=12, n_test_samples=4,
              test_batch_size=4, ddim_sampling_steps=3, timesteps=6)
# calibrate in three chunks (a row or two per rank): warm-up, capture,
# replay; evaluate: a warm-up, a capture on other draws, a replay of the
# first (tokamak only: the Burgers evaluation's 10,000-step rollout is
# slow to record here; chip_smoke.py phase 17e captures it on four cards)
B_PIPE = dict(dim=8, dim_mults=(1, 2), cal_chunk=2)
T_PIPE = dict(dim=8, dim_mults=(1, 2), cal_chunk=4)
SEEDS = {"burgers": (), "tokamak": (2, 3, 2)}
PRE = dict(dim=8, dim_mults=(1, 2), batch_size=4, cosine_t_max=4, checkpoint_every=10**9,
           lr=1e-4)
STEPS, K = 6, 2  # chunks of 2: two warm-up calls, then the capture (replayed)


@pytest.fixture(scope="module")
def burgers_data(tmp_path_factory):
    from safediffcon_torch.tasks.burgers import BurgersDataset, generate_burgers_dataset

    path = str(tmp_path_factory.mktemp("burgers") / "burgers.npz")
    generate_burgers_dataset(path, n_train=8, n_cal=6, n_test=4, seed=0, nx=128, device="cpu")
    return {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}


@pytest.fixture(scope="module")
def tokamak_data(tmp_path_factory):
    from safediffcon_torch.tasks.tokamak import TokamakDataset, generate_tokamak_dataset

    path = str(tmp_path_factory.mktemp("tokamak") / "tokamak.npz")
    generate_tokamak_dataset(path, n_train=8, n_cal=12, n_test=4, seed=0, gen_batch=32,
                             device="cpu")
    return {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}


def _args(task, part, data):
    if task == "burgers":
        from safediffcon_torch.tasks.burgers import pipeline as mod

        conf, pipe, pre = B_CONF, B_PIPE, dict(PRE, timesteps=100)
        cal = data["cal"].data
        test = (data["test"].data, data["test"].u_phys, data["test"].f_phys)
        train = (data["train"].data, data["train"].u_phys, data["train"].f_phys)
    else:
        from safediffcon_torch.tasks.tokamak import pipeline as mod

        conf, pipe, pre = T_CONF, T_PIPE, dict(PRE, timesteps=6)
        cal = (data["cal"].data, data["cal"].state_phys)
        test = (data["test"].data, data["test"].state_phys)
        train = (data["train"].data, data["train"].state_phys)
    model = mod.init_params(mod.build_model(PRE["dim"], PRE["dim_mults"], device="cpu"), seed=3)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    if part == "serve":
        return (conf, pipe, sd, cal, test, SEEDS[task])
    if part == "train":
        return (pre, sd, train, STEPS, K)
    if task == "burgers":
        cal = (data["cal"].data, data["cal"].u_phys, data["cal"].f_phys)
        if part == "infft":
            conf, sd = dict(conf, w_score=2.0), _unclipped_safety(sd)
    else:
        from safediffcon_torch.tasks.tokamak import finetune_config, posttrain_config

        base = finetune_config() if part == "backward" else posttrain_config()
        # w_obj 1: the backward loss has a gradient (tests/tokamak_replay.py)
        conf = dict(conf, guidance_scaler=base.conformal.guidance_scaler,
                    w_obj=1.0 if part == "backward" else 0.0)
    return (conf, pipe, sd, train, cal, test)


def _unclipped_safety(sd):
    """InfFT's loss has no gradient where random weights clip the s channel
    (tests/test_torch_captured_burgers.py): a small final conv with a bias
    on the s output."""
    sd = dict(sd, **{"final_conv.weight": sd["final_conv.weight"] * 0.01})
    sd["final_conv.bias"] = sd["final_conv.bias"].clone()
    sd["final_conv.bias"][2] = 2.0
    return sd


FIELDS = {"serve": ("q", "m"), "train": ("losses",)}


def _equal(a, b, part):
    assert all(a[f] == b[f] for f in FIELDS.get(part, ("q", "hist")))
    for k, v in b.get("params", {}).items():
        np.testing.assert_array_equal(a["params"][k], v)


@pytest.mark.parametrize("task,part", [
    ("burgers", "serve"), ("burgers", "train"), ("burgers", "posttrain"), ("burgers", "infft"),
    ("tokamak", "serve"), ("tokamak", "train"), ("tokamak", "weighted"),
    ("tokamak", "backward")])
def test_split_batches_captured_with_collectives(task, part, request, tmp_path):
    """Two gloo ranks: with the gate open as over NCCL, calibrate (three
    chunks) and evaluate (serve; tokamak), pretrain (chunks of 2, train),
    post-training (chunks of 2) and InfFT (Burgers), and `run_inference`'s
    post-training and backward fine-tuning steps (tokamak) run as graphs
    holding their collectives and equal the eager split bit for bit
    (Q-hat, metrics, losses, epoch records, weights), on both ranks alike;
    each fine-tuning step's graph is replayed; the losses a pretrain keeps
    hold their own values, not a gradient. (The eager split against one
    process: `test_torch_parallel_burgers.py`,
    `test_torch_parallel_tasks.py`.)"""
    data = request.getfixturevalue(f"{task}_data")
    args = _args(task, part, data)
    ranks = W.run_ranks(W.split_capture, 2, tmp_path, task, part, args)
    for got in ranks:
        eager, captured = got["eager"], got["captured"]
        assert eager["replays"] == 0 and captured["replays"] > 0
        if part == "train":
            # an eager step's loss is one float32; a chunk's losses share
            # their chunk's K values
            assert max(eager["loss_bytes"]) == 4 and max(captured["loss_bytes"]) <= 4 * K
        elif part != "serve":
            assert eager["step_replays"] == 0 and captured["step_replays"] > 0
            assert any(r["loss"] for r in captured["hist"])
        if part == "serve":
            # calibrate: chunk 2 captured, chunk 3 replayed; evaluate: call 2
            # captured (and replayed), call 3 a replay
            n_eval = len(SEEDS[task])
            assert eager["counts"] == dict(graphs=0, replays=0)
            assert captured["counts"] == dict(graphs=1 + (n_eval > 1),
                                              replays=1 + max(n_eval - 2, 0))
        _equal(captured, eager, part)
    _equal(ranks[0]["captured"], ranks[1]["captured"], part)


def test_split_loss_holds_its_own_element(tmp_path):
    """Two data ranks: `BatchShard.reduce` returns the mean loss and
    gradient, and a loss whose storage is its one float32, not the
    flattened gradient it was all-reduced with."""
    ranks = W.run_ranks(W.reduce_loss, 2, tmp_path, 1000)
    for got in ranks:
        assert got["loss"] == 1.5 and got["nbytes"] == 4
        np.testing.assert_array_equal(got["grad"], np.full(1000, 0.5, np.float32))


STUB_NVCC = """#!/bin/sh
# stand-in nvcc: count the call, then write the -o file after a pause
echo x >> "{count}"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""

BUILDER = """
import sys
from pathlib import Path
from safediffcon_torch.ops import build
build.BUILD_DIR = Path(sys.argv[1])
build._nvcc = lambda: sys.argv[2]
print(build.build_all(["pressure_cg", "conv3d_simt"])[0])
"""


def test_build_all_compiles_once_for_four_processes(tmp_path):
    """Four processes build at once (the ranks of one launch): one nvcc run
    per source, and every process gets the same library."""
    count, stub = tmp_path / "count", tmp_path / "nvcc"
    stub.write_text(STUB_NVCC.format(count=count))
    stub.chmod(0o755)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(BUILDER),
                               str(tmp_path / "kernels"), str(stub)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert count.read_text().count("x") == 2  # two sources, each compiled once
    assert not list((tmp_path / "kernels").glob("*.tmp"))
