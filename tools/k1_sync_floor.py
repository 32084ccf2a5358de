#!/usr/bin/env python3
"""Time the per-iteration synchronisation floor of kernel K1 on one CUDA card.

Run from the repository root: `python3 tools/k1_sync_floor.py`. It builds
tools/k1_sync_floor.cu (K1's own source with a kernel that runs only the
synchronisation of a CG iteration: two cluster sums and one halo exchange)
into build/tools/, and times, at K1's layout for 127^2 and B = 8 and 50
(1 and 7 clusters of 16 blocks), over ROUNDS iterations each:

  - the synchronisation alone, per round;
  - K1 itself (`pressure_cg_cuda`, accuracy 0 so that it runs exactly
    ROUNDS iterations), per iteration.

It prints one JSON line with both times and the card's name and power
limit. It needs the CUDA toolkit and a card; it is not part of the package
and no path of it runs this.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 500
CELLS = 127
REPS = 5


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


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_sync_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from safediffcon_torch.ops import build
    from safediffcon_torch.ops import pressure_cg as K
    from safediffcon_torch.solvers import smoke as S

    out = ROOT / "build" / "tools" / "libk1_sync_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "k1_sync_floor.cu")], check=True)
    fn = ctypes.CDLL(str(out)).k1_sync_floor_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lay = K.cluster_layout(CELLS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    planes = S.build_masks("cuda").planes
    result = dict(card=card, rounds=ROUNDS, cluster=lay.cluster, rows=lay.rows)
    for batch in (8, 50):
        clusters = -(-batch // K.CHUNK)
        sink = torch.empty(clusters * lay.cluster, device="cuda")

        def floor():
            err = fn(clusters * lay.cluster, lay.cluster, ROUNDS, sink.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"the synchronisation kernel failed with CUDA error {err}")

        div = torch.randn((batch, CELLS, CELLS), generator=gen, device="cuda")
        args = (div, torch.zeros_like(div), planes, 0.0, ROUNDS, 1)
        iters = K.pressure_cg_cuda(*args)[1]
        if iters.tolist() != [ROUNDS] * clusters:
            raise AssertionError(f"K1 ran {iters.tolist()} iterations, expected {ROUNDS}")
        floor_us = 1e3 * cuda_ms(floor, REPS) / ROUNDS
        kernel_us = 1e3 * cuda_ms(lambda: K.pressure_cg_cuda(*args), REPS) / ROUNDS
        result[f"b{batch}"] = dict(clusters=clusters, sync_us_per_iter=floor_us,
                                   k1_us_per_iter=kernel_us, ratio=kernel_us / floor_us)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
