"""Device-fault handling of the port (`utils/faults.py`): how CUDA errors are
classed (sticky: the context is lost, no retry in the process; recoverable:
retried with a fresh pipeline that resumes from `state_dir`; not a fault:
out-of-memory and program errors), and `run_inference_resilient` on a tiny
tokamak config, where a recoverable fault in the second epoch ends
bit-identical to an uninterrupted run."""
import dataclasses
import logging

import pytest
import torch

from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakDataset,
    TokamakPipeline,
    generate_tokamak_dataset,
    posttrain_config,
    run_inference_resilient,
)
from safediffcon_torch.tasks.tokamak.pipeline import init_params
from safediffcon_torch.utils import faults

torch.set_num_threads(1)

ACCEL = getattr(torch, "AcceleratorError", RuntimeError)
CASES = [
    # sticky: the CUDA context is unusable for the rest of the process
    (ACCEL("CUDA error: an illegal memory access was encountered\nCUDA kernel errors "
           "might be asynchronously reported"), "sticky"),
    (RuntimeError("CUDA error: unspecified launch failure"), "sticky"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "sticky"),
    (ACCEL("CUDA error: device-side assert triggered"), "sticky"),
    (RuntimeError("CUDA error: misaligned address"), "sticky"),
    (RuntimeError("CUDA error: an illegal instruction was encountered"), "sticky"),
    (RuntimeError("CUDA error: the launch timed out and was terminated"), "sticky"),
    (RuntimeError("pressure_cg kernel launch failed with CUDA error 700"), "sticky"),
    (RuntimeError("conv3d_fused_cuda: kernel launch failed with CUDA error 719"), "sticky"),
    # recoverable: the call failed, the context is still usable
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or unavailable"),
     "recoverable"),
    (ACCEL("CUDA error: system not yet initialized"), "recoverable"),
    (RuntimeError("pressure_cg kernel launch failed with CUDA error 46"), "recoverable"),
    # not a device fault: out of memory, program errors, other exceptions
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), None),
    (RuntimeError("CUDA error: out of memory"), None),
    (ACCEL("CUDA error: invalid argument"), None),
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied (4x3 and 4x3)"), None),
    (RuntimeError("the payload mentions an illegal memory access"), None),
    (ValueError("CUDA error: an illegal memory access was encountered"), None),
    (KeyError("params"), None),
]


@pytest.mark.parametrize("exc,kind", CASES, ids=lambda v: type(v).__name__ if
                         isinstance(v, BaseException) else str(v))
def test_fault_classification(exc, kind):
    assert faults.fault_kind(exc) == kind
    assert faults.is_device_fault(exc) == (kind is not None)


class Counter:
    def __init__(self, make):
        self.make, self.n = make, 0

    def __call__(self):
        self.n += 1
        return self.make()


def _raise_each_time(exc):
    calls = []

    def run(pipe, params):
        calls.append(params)
        raise exc

    return run, calls


def test_sticky_fault_is_reraised_at_once(caplog):
    make = Counter(lambda: object())
    run, calls = _raise_each_time(RuntimeError("CUDA error: an illegal memory access was "
                                               "encountered"))
    with caplog.at_level(logging.ERROR, logger=faults.__name__):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            faults.resilient_phase(make, run, {"w": torch.ones(2)}, retries=3, backoff_s=0.0,
                                   describe="tokamak finetune", state_dir="out/state")
    assert make.n == len(calls) == 1
    assert "--resume" in caplog.text and "out/state" in caplog.text


def test_program_error_propagates_on_the_first_attempt():
    make = Counter(lambda: object())
    run, calls = _raise_each_time(ValueError("bad shape"))
    with pytest.raises(ValueError):
        faults.resilient_phase(make, run, None, retries=3, backoff_s=0.0)
    oom = torch.OutOfMemoryError("CUDA out of memory")
    run, calls = _raise_each_time(oom)
    with pytest.raises(torch.OutOfMemoryError):
        faults.resilient_phase(make, run, None, retries=3, backoff_s=0.0)
    assert make.n == 2 and len(calls) == 1


def test_retries_exhausted_reraise_the_last_fault():
    make = Counter(lambda: object())
    params = {"w": torch.arange(3.0)}
    run, calls = _raise_each_time(RuntimeError("CUDA error: CUDA-capable device(s) is/are "
                                               "busy or unavailable"))
    with pytest.raises(RuntimeError, match="busy or unavailable"):
        faults.resilient_phase(make, run, params, retries=2, backoff_s=0.0)
    assert make.n == len(calls) == 3  # the first attempt and two retries
    # every attempt gets the host copy taken once, not the caller's tensors
    assert all(c is calls[0] for c in calls) and calls[0]["w"] is not params["w"]
    assert torch.equal(calls[0]["w"], params["w"])


def test_no_rank_retries_alone_under_a_process_group(caplog, monkeypatch):
    """With more than one rank, even a recoverable fault is re-raised at
    once: a rank that retried alone would leave the others waiting in a
    collective, so it exits and its launcher stops them all."""
    from safediffcon_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "world_size", lambda: 2)
    monkeypatch.setattr(pmesh, "rank", lambda: 1)
    make = Counter(lambda: object())
    run, calls = _raise_each_time(RuntimeError("CUDA error: CUDA-capable device(s) is/are "
                                               "busy or unavailable"))
    with caplog.at_level(logging.ERROR, logger=faults.__name__):
        with pytest.raises(RuntimeError, match="busy or unavailable"):
            faults.resilient_phase(make, run, None, retries=3, backoff_s=0.0,
                                   describe="smoke finetune", state_dir="out/state")
    assert make.n == len(calls) == 1
    assert "rank 1 of 2" in caplog.text and "--resume" in caplog.text


CONF = dict(cal_batch_size=4, num_cal_batch=1, n_cal_samples=4, n_test_samples=2,
            test_batch_size=2, ddim_sampling_steps=3, timesteps=6)
PIPE = dict(dim=8, dim_mults=(1, 2))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokamak") / "tokamak.npz")
    generate_tokamak_dataset(path, n_train=8, n_cal=4, n_test=2, seed=0, gen_batch=16,
                             device="cpu")
    return {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}


def test_recoverable_fault_resumes_bit_identically(data, tmp_path):
    """Two post-training epochs; the first pipeline's evaluate raises a
    recoverable fault in epoch 1, after epoch 0 was persisted. The retry
    builds a fresh pipeline, resumes after epoch 0 and ends where an
    uninterrupted run ends, bit for bit."""
    cfg = dataclasses.replace(posttrain_config(), finetune_epoch=2, finetune_steps=1,
                              train_batch_size=4, conformal=TokamakConformalConfig(**CONF))
    weights = init_params(TokamakPipeline(cfg.conformal, device="cpu", **PIPE).model,
                          seed=1).state_dict()
    train, cal, test = data["train"], data["cal"], data["test"]
    ref_p, ref_q, ref_h = run_inference_resilient(
        cfg, lambda: TokamakPipeline(cfg.conformal, device="cpu", **PIPE), weights, train,
        cal, test, state_dir=str(tmp_path / "ref"), backoff_s=0.0)

    built = []

    def make_pipeline():
        pipe = TokamakPipeline(cfg.conformal, device="cpu", **PIPE)
        if not built:  # the first attempt's pipeline faults in its 2nd evaluate
            real, n = pipe.evaluate, []

            def evaluate(*a, **kw):
                n.append(1)
                if len(n) == 2:
                    raise ACCEL("CUDA error: CUDA-capable device(s) is/are busy or "
                                "unavailable")
                return real(*a, **kw)

            pipe.evaluate = evaluate
        built.append(pipe)
        return pipe

    seen = []
    params, q, hist = run_inference_resilient(
        cfg, make_pipeline, weights, train, cal, test, on_epoch=seen.append,
        state_dir=str(tmp_path / "run"), backoff_s=0.0)
    assert len(built) == 2
    assert [r["epoch"] for r in seen] == [0, 0, 1]  # epoch 0 re-fired on resume
    assert hist == ref_h and float(q) == float(ref_q)
    for k, v in ref_p.items():
        assert torch.equal(params[k], v), k
    assert any(not torch.equal(params[k], weights[k]) for k in params)
