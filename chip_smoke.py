#!/usr/bin/env python3
"""Drive the PyTorch port's smoke serving path on one CUDA card.

Run from the repository root with no arguments: `python3 chip_smoke.py`. It
needs one CUDA card and the CUDA toolkit (nvcc); without a card it exits
non-zero before printing any result, and it has no CPU path. Any phase that
fails ends the run with a non-zero exit.

  1. device: the card's name and power limit, torch version, TF32 flags;
  2. build: kernel K1 (safediffcon_torch/csrc/pressure_cg.cu) into
     build/kernels/;
  3. K1 against its plain PyTorch version on the card at the serving shapes
     (B = 8, 10 and 50 samples of 127^2, warm start, accuracy 1e-6 and 1e-8,
     max_iter 500, convergence checks every 1 and every 32 iterations),
     the residual |A p - div|, and the gradient (a solve of the cotangent);
  4. the serving path at the reference model's full width (UNet3D dim 64,
     mults (1, 2, 4), 7 channels, 32 frames of 64^2, seeded weights):
     generate 50 cal and 50 test sims with the port's solver (256 frames at
     128^2, CG 1e-6), then SmokePipeline.calibrate and guided evaluate with
     the SmokeConformalConfig defaults (DDIM 100, eta 1, solver 1e-8 / 500,
     backend "auto" = K1) and the pipeline's default chunks, so each runs
     one batch of 50 and reports its peak device memory. K1's launch count
     is zeroed just before calibrate and read just after evaluate;
  5. a small input run on the card and on the CPU (whose path the CPU tests
     hold against the JAX package) with the same weights and noise, in
     float32 without TF32: the metrics must agree.

Its last three lines are the `kernels` JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks: HBM3 bandwidth, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# CG work per cell per iteration: 5-point stencil (9), three dot products
# (6), max |r| (2), three axpy updates (6)
CG_FLOPS_PER_CELL = 23
CELLS = 127
N_CAL, N_TEST = 50, 50  # sims per split (reference: 200 cal, 50 test)
GEN_BATCH = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cg_bound_ms(batch: int, iters: list) -> tuple:
    """Least time for one solve: each input read once and the output written
    once over HBM bandwidth, against this run's iterations' flops at the
    float32 peak. Returns (ms, "bytes" | "operations")."""
    cells = CELLS * CELLS
    nbytes = 4 * cells * (3 * batch + 5)  # div, guess, x; 5 stencil planes
    chunk_sizes = [min(8, batch - 8 * c) for c in range(len(iters))]
    flops = CG_FLOPS_PER_CELL * cells * sum(i * s for i, s in zip(iters, chunk_sizes))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_vs_plain(K, S):
    """K1 against its plain version at the serving shapes; returns the case
    records and the main-path case (B=50 as evaluate runs it, 1e-8, check
    every iteration)."""
    masks = S.build_masks("cuda")
    planes = masks.planes
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for batch in (8, 10, N_TEST):
        # a rollout-like pair of frames: the previous frame's pressure is the
        # warm start of the next one's solve
        v = 0.3 * torch.randn((batch, 128, 128, 2), generator=gen, device="cuda")
        v_prev = v + 0.05 * torch.randn(v.shape, generator=gen, device="cuda")
        div = S.divergence(v * masks.velocity_mask).contiguous()
        div_prev = S.divergence(v_prev * masks.velocity_mask).contiguous()
        guess, _ = K.pressure_cg_plain(div_prev, torch.zeros_like(div), planes, 1e-6, 500)
        for accuracy in (1e-6, 1e-8):
            for check_every in (1, K.BLOCK_K):
                args = (div, guess, planes, accuracy, 500, check_every)
                xk, ik = K.pressure_cg_cuda(*args)
                xp, ip = K.pressure_cg_plain(*args)
                torch.cuda.synchronize()
                diff = float((xk - xp).abs().max())
                scale = float(xp.abs().max())
                res_k = float((K.apply_A_planes(planes, xk) - div).abs().max())
                res_p = float((K.apply_A_planes(planes, xp) - div).abs().max())
                kernel_ms = cuda_ms(lambda: K.pressure_cg_cuda(*args), reps=5)
                plain_ms = cuda_ms(lambda: K.pressure_cg_plain(*args), reps=2)
                iters, plain_iters = ik.tolist(), ip.tolist()
                bound_ms, bound_by = cg_bound_ms(batch, iters)
                case = dict(variant="v1" if check_every == 1 else "v2", check_every=check_every,
                            batch=batch, accuracy=accuracy, max_iter=500, kernel_ms=kernel_ms,
                            plain_ms=plain_ms, iterations=iters, plain_iterations=plain_iters,
                            max_diff=diff, max_abs_x=scale, residual=res_k,
                            plain_residual=res_p, bound_ms=bound_ms, bound_by=bound_by)
                log("K1 " + json.dumps(case))
                # Both run the same recurrence; their float32 dot products sum
                # in other orders, so the iterates differ by rounding that CG
                # does not amplify past the solve's own accuracy: 1e-4 of
                # max|x| (the CPU tests see 1e-6 of it against Pallas).
                if not diff <= 1e-4 * scale:
                    raise AssertionError(f"K1 differs from its plain version: {diff} > 1e-4 * {scale}")
                # float32 recursive-residual termination leaves a small true
                # residual (tests/test_ops_pallas.py bounds it by 1e-3)
                if not (res_k < 1e-3 and res_k <= 2 * res_p + 1e-5):
                    raise AssertionError(f"K1 residual {res_k} (plain {res_p})")
                if max(abs(a - b) for a, b in zip(iters, plain_iters)) > max(check_every, 5):
                    raise AssertionError(f"K1 iterations {iters} vs plain {plain_iters}")
                cases.append(case)
    main = next(c for c in cases if c["batch"] == N_TEST and c["accuracy"] == 1e-8
                and c["check_every"] == 1)
    return masks, cases, main


def phase_gradient(K, S, masks):
    """The backward pass launches K1 on the cotangent: A (dL/ddiv) = w, and
    the gradient equals the plain solve of w."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    div = torch.randn((8, CELLS, CELLS), generator=gen, device="cuda").requires_grad_()
    w = torch.randn((8, CELLS, CELLS), generator=gen, device="cuda")
    before = K.pressure_cg_cuda.launches
    (K.pressure_solve_kernel(masks, div, 1e-7, 2000) * w).sum().backward()
    torch.cuda.synchronize()
    if K.pressure_cg_cuda.launches - before != 2:
        raise AssertionError("the backward pass did not launch K1")
    adjoint = float((S._apply_A(masks, div.grad) - w).abs().max())
    plain, _ = K.pressure_cg_plain(w, torch.zeros_like(w), masks.planes, 1e-7, 2000)
    diff = float((div.grad - plain).abs().max())
    log(f"K1 gradient: max|A g - w| = {adjoint:.3e}, max|g - plain| = {diff:.3e} "
        f"(max|g| = {float(plain.abs().max()):.3e})")
    if not (adjoint < 1e-3 and diff <= 1e-4 * float(plain.abs().max())):
        raise AssertionError("K1 gradient check failed")


def phase_serving(K, smoke):
    """Datagen, then calibrate + guided evaluate at full width."""
    out_dir = ROOT / "build" / "chip_smoke"
    path = str(out_dir / "smoke.npz")
    K.pressure_cg_cuda.iterations = []
    launches0 = K.pressure_cg_cuda.launches
    t0 = time.perf_counter()
    smoke.generate_smoke_dataset(path, n_train=0, n_cal=N_CAL, n_test=N_TEST, seed=0,
                                 gen_batch=GEN_BATCH, accuracy=1e-6, max_iter=500, device="cuda")
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    gen_iters = torch.cat(K.pressure_cg_cuda.iterations).float()
    log(f"phase datagen: {N_CAL + N_TEST} sims x 255 solver steps in {datagen_s:.2f} s "
        f"(batches of {GEN_BATCH}); "
        f"K1 launches {K.pressure_cg_cuda.launches - launches0}, iterations per chunk "
        f"mean {float(gen_iters.mean()):.1f} max {int(gen_iters.max())} (accuracy 1e-6)")
    cal = smoke.SmokeDataset.load(path, "cal")
    test = smoke.SmokeDataset.load(path, "test")

    ccfg = smoke.SmokeConformalConfig(cal_batch_size=N_CAL, num_cal_batch=1,
                                      n_test_samples=N_TEST, test_batch_size=N_TEST)
    pipe = smoke.SmokePipeline(ccfg, device="cuda")
    log(f"depth cut: {N_CAL} cal + {N_TEST} test sims (reference 200 + 50); width, "
        f"frames, DDIM {ccfg.ddim_sampling_steps} steps and the 256-frame solver are the "
        f"reference's; default chunks: calibrate {pipe.cal_chunk}, evaluate {pipe.eval_chunk}")
    from safediffcon_torch.tasks.smoke.pipeline import init_params
    init_params(pipe.model, seed=0)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"UNet3D dim 64 mults (1, 2, 4): {n_params} parameters; solver {pipe.solver_kw}")

    # the main path: counts zeroed just before, read just after
    K.pressure_cg_cuda.launches = 0
    K.pressure_cg_cuda.iterations = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = pipe.calibrate(cal, 0.0, generator=torch.Generator(device="cuda").manual_seed(1))
    q = float(q)
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    pipe.phase_seconds = {}
    t0 = time.perf_counter()
    metrics = pipe.evaluate(test, q, generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launches = K.pressure_cg_cuda.launches
    iters = torch.cat(K.pressure_cg_cuda.iterations)
    K.pressure_cg_cuda.iterations = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = ccfg.ddim_sampling_steps
    sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]
    at_max = float((iters >= 500).float().mean())
    log(f"phase calibrate: {calibrate_s:.2f} s ({1e3 * calibrate_s / steps:.1f} ms per "
        f"conditioned DDIM step at B={N_CAL}); Q-hat {q:.6f}; peak device memory "
        f"{cal_peak_gb:.2f} GB")
    log(f"phase evaluate: {evaluate_s:.2f} s = sampling {sampling_s:.2f} s "
        f"({1e3 * sampling_s / steps:.1f} ms per guided step at B={N_TEST}) + solver rollout "
        f"{rollout_s:.2f} s; peak device memory {peak_gb:.2f} GB")
    log(f"K1 on the main path: {launches} launches, iterations per chunk mean "
        f"{float(iters.float().mean()):.1f}, share at max_iter 500: {at_max:.3f} "
        f"(accuracy {pipe.solver_kw['accuracy']})")
    log("metrics " + json.dumps(metrics, sort_keys=True))
    if launches == 0:
        raise AssertionError("the serving path never launched K1")
    if not (math.isfinite(q) and all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"non-finite result: Q {q}, metrics {metrics}")
    return test, launches, dict(datagen_s=datagen_s, calibrate_s=calibrate_s,
                                sampling_s=sampling_s, rollout_s=rollout_s,
                                ms_per_guided_step=1e3 * sampling_s / steps,
                                peak_gb=peak_gb, cal_peak_gb=cal_peak_gb,
                                iter_share_at_max=at_max)


def phase_small_input_agreement(K, smoke, test):
    """The same small evaluate on the card and on the CPU, float32 without
    TF32: the CPU path is the one the tests hold against the JAX package."""
    from safediffcon_torch.tasks.smoke.pipeline import init_params
    conf = smoke.SmokeConformalConfig(ddim_sampling_steps=3, timesteps=6,
                                      standard_fixed_ratio=10.0, safe_bound=0.001)
    kw = dict(dim=8, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=60,
              solver_time_scale=8, solver_space_scale=4)
    raw = test.raw[:2, ::8, ::2, ::2]  # 4 frames of 32^2
    small = smoke.SmokeDataset(data=raw / smoke.RESCALER, raw=raw)
    gen = torch.Generator().manual_seed(3)
    init = torch.randn(raw.shape, generator=gen)
    steps = [torch.randn(raw.shape, generator=gen) for _ in range(2)]
    results = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            pipe = smoke.SmokePipeline(conf, device=device, **kw)
            init_params(pipe.model, seed=0)
            noise = iter([(init.to(device), [s.to(device) for s in steps])])
            results[device] = pipe.evaluate(small, 0.05, noise=noise)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log("small input: card " + json.dumps(results["cuda"], sort_keys=True))
    log("small input: cpu  " + json.dumps(results["cpu"], sort_keys=True))
    for name, ref in results["cpu"].items():
        got = results["cuda"][name]
        # float32 on both, sums in other orders: 1e-3 relative (percentages exact)
        tol = 1e-9 if "percentage" in name else 1e-3 * abs(ref) + 1e-6
        if not abs(got - ref) <= tol:
            raise AssertionError(f"card and CPU disagree on {name}: {got} vs {ref}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from safediffcon_torch.ops import build
    from safediffcon_torch.ops import pressure_cg as K
    from safediffcon_torch.solvers import smoke as S
    import safediffcon_torch.tasks.smoke as smoke

    card = card_line()
    log(f"device: {card}; {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = build.build("pressure_cg")
    log(f"phase build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    masks, cases, main_case = phase_kernel_vs_plain(K, S)
    phase_gradient(K, S, masks)
    test, launches, times = phase_serving(K, smoke)
    phase_small_input_agreement(K, smoke, test)
    log(f"phase times {json.dumps(times, sort_keys=True)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    kernels = [dict(
        name="pressure_cg", route="cuda", source="safediffcon_torch/csrc/pressure_cg.cu",
        replaces="safediffcon_tpu/ops/pressure_cg.py:42",
        also_replaces="safediffcon_tpu/ops/pressure_cg.py:119",
        launches=launches, max_abs_err=max(c["max_diff"] for c in cases),
        ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"], library_ms=None,
        shape=dict(batch=N_TEST, cells=[CELLS, CELLS], accuracy=1e-8, max_iter=500, check_every=1),
        cases=cases)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
