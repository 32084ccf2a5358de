"""Kernel K1: chunked-batch conjugate gradient for the masked pressure solve.

Port of `safediffcon_tpu/ops/pressure_cg.py` (`_make_kernel`/`_cg_pallas`,
v1, and `_make_block_kernel`/`_cg_pallas_v2`, v2). One CUDA kernel,
`csrc/pressure_cg.cu`, covers both variants: `check_every=1` tests
convergence every iteration as v1 does, `check_every=32` every 32 as v2
does. Dot products and the test are shared within chunks of CHUNK=8
samples, and both modes use v2's safe divide. The kernel runs each chunk
on one thread-block cluster, a band of grid rows per block, with the CG
state in registers and shared memory for the whole solve;
`cluster_layout` computes its launch layout and is None for a shape it
cannot take.

`pressure_cg` dispatches on the device of its inputs: CUDA tensors launch
the kernel (or raise), CPU tensors run `pressure_cg_plain`, the same
recurrence in plain PyTorch with the identical chunking, check interval and
safe divide. `pressure_solve_kernel` is the differentiable entry the smoke
solver calls; its backward pass is the same solve applied to the cotangent,
with zero gradient for the warm start (pressure_cg.py:254-264).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from safediffcon_torch.ops import build

CHUNK = 8  # samples sharing one cluster, its dot products and its convergence test
BLOCK_K = 32  # v2's iterations between convergence tests
COLS = 128  # threads across one grid row of a band: the kernel takes n <= 128
ROWS = 8  # grid rows per block: 16 blocks (a non-portable cluster) cover n = 127
MAX_CLUSTER = 16  # slots per cluster sum in the kernel's shared memory
_KERNEL = "pressure_cg"


def apply_A_planes(planes, p: torch.Tensor) -> torch.Tensor:
    """Masked 5-point stencil on (..., n, n) from the 5 (n, n) planes
    (diag, up_y, lo_y, up_x, lo_x), stacked or as a sequence; neighbours
    outside the grid read 0."""
    diag, up_y, lo_y, up_x, lo_x = planes
    return (
        diag * p
        + up_y * F.pad(p[..., 1:, :], (0, 0, 0, 1))
        + lo_y * F.pad(p[..., :-1, :], (0, 0, 1, 0))
        + up_x * F.pad(p[..., :, 1:], (0, 1))
        + lo_x * F.pad(p[..., :, :-1], (1, 0))
    )


def pressure_cg_plain(div, guess, planes, accuracy: float, max_iter: int,
                      check_every: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: returns (x, iterations per
    chunk). All chunks step together; a chunk that has stopped keeps its
    state. The convergence test syncs with the host once per check."""
    b, n, _ = div.shape
    chunks = -(-b // CHUNK)
    pad = chunks * CHUNK - b

    def chunked(t):
        return F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(chunks, CHUNK, n, n)

    def dot(u, v):
        return (u * v).sum((1, 2, 3))

    def per_chunk(v):
        return v[:, None, None, None]

    rhs, x = chunked(div), chunked(guess)
    r = rhs - apply_A_planes(planes, x)
    m = r
    am = apply_A_planes(planes, m)
    mam, mr = dot(m, am), dot(m, r)
    maxr = r.abs().amax((1, 2, 3))
    active = torch.ones(chunks, dtype=torch.bool, device=div.device)
    iters = torch.zeros(chunks, dtype=torch.int32, device=div.device)
    it = 0
    while True:
        if it % check_every == 0:
            active = active & (maxr >= accuracy) & (it < max_iter)
            if not bool(active.any()):
                break
        nonzero = mam != 0
        inv = torch.where(nonzero, 1.0 / torch.where(nonzero, mam, torch.ones_like(mam)),
                          torch.zeros_like(mam))
        a = mr * inv
        x_new = x + per_chunk(a) * m
        r_new = r - per_chunk(a) * am
        beta = -dot(r_new, am) * inv
        m_new = r_new + per_chunk(beta) * m
        am_new = apply_A_planes(planes, m_new)
        keep = per_chunk(active)
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        m = torch.where(keep, m_new, m)
        am = torch.where(keep, am_new, am)
        maxr = torch.where(active, r_new.abs().amax((1, 2, 3)), maxr)
        mam = torch.where(active, dot(m_new, am_new), mam)
        mr = torch.where(active, dot(m_new, r_new), mr)
        iters += active.to(torch.int32)
        it += 1
    return x.reshape(chunks * CHUNK, n, n)[:b], iters


class ClusterLayout(NamedTuple):
    """How K1 spreads one chunk of CHUNK samples over a thread-block cluster."""
    cluster: int  # blocks per chunk, each on its own SM
    rows: int  # grid rows per block (a band); the last band may hold fewer
    smem_bytes: int  # dynamic shared memory per block

    def bands(self, n: int) -> List[Tuple[int, int]]:
        """(first row, rows) of each block's band of the n x n grid, by rank."""
        return [(k * self.rows, min(self.rows, n - k * self.rows)) for k in range(self.cluster)]


def cluster_layout(n: int) -> Optional[ClusterLayout]:
    """K1's launch layout for samples of n x n, or None for a grid the
    kernel cannot take: a band row is 128 threads (n <= 128) and a block 8
    band rows, so a cluster has at most 16 blocks (Hopper's non-portable
    maximum). The shared memory holds m of the band for the chunk's 8
    samples, two sets of 16 ranks' 4-float slots, the rows just below and
    above the band, 32 warps' 3 partials and 3 mbarriers: the carve-up of
    csrc/pressure_cg.cu, whose launch refuses less."""
    if not 1 <= n <= COLS:
        return None
    smem_bytes = 4 * (CHUNK * ROWS * COLS + 2 * 4 * MAX_CLUSTER + 2 * COLS * CHUNK + 3 * 32) + 3 * 8
    return ClusterLayout(-(-n // ROWS), ROWS, smem_bytes)


def max_active_clusters(n: int) -> int:
    """How many clusters of K1's layout for n fit on the card at once
    (cudaOccupancyMaxActiveClusters); chunks beyond it run in later waves."""
    lay = cluster_layout(n)
    if lay is None:
        raise ValueError(f"K1 takes no {n} x {n} grid")
    fn = build.load(_KERNEL).pressure_cg_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(n, lay.cluster, lay.smem_bytes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {err}")
    return out.value


def pressure_cg_cuda(div, guess, planes, accuracy: float, max_iter: int,
                     check_every: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream of the tensors' card (made the
    current device for the launch: the kernel's attributes are set there)
    with `cluster_layout`'s layout:
    returns (x, iterations per chunk). Raises for a grid the kernel cannot
    take. Counts its launches in `pressure_cg_cuda.launches`; when
    `pressure_cg_cuda.iterations` is a list, appends each launch's
    iteration counts to it (device tensors, no sync); when
    `pressure_cg_cuda.events` is a list, appends a (start, end) pair of
    timing CUDA events around each launch (no sync)."""
    b, n, _ = div.shape
    lay = cluster_layout(n)
    if lay is None:
        raise ValueError(f"K1 takes n <= {COLS}, got {b} samples of {n} x {n}")
    fn = build.load(_KERNEL).pressure_cg_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty_like(div)
    iters = torch.empty(-(-b // CHUNK), dtype=torch.int32, device=div.device)
    stream = torch.cuda.current_stream(div.device)
    events = pressure_cg_cuda.events
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
    with torch.cuda.device(div.device):
        err = fn(div.data_ptr(), guess.data_ptr(), planes.data_ptr(), x.data_ptr(),
                 iters.data_ptr(), b, n, float(accuracy), int(max_iter), int(check_every),
                 lay.cluster, lay.smem_bytes, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"pressure_cg kernel launch failed with CUDA error {err}")
    pressure_cg_cuda.launches += 1
    if events is not None:
        end.record(stream)
        events.append((start, end))
    if pressure_cg_cuda.iterations is not None:
        pressure_cg_cuda.iterations.append(iters)
    return x, iters


pressure_cg_cuda.launches = 0
pressure_cg_cuda.iterations = None
pressure_cg_cuda.events = None


def pressure_cg(div, guess, planes, accuracy: float, max_iter: int,
                check_every: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = div per chunk of 8 samples from the warm start `guess`.

    div, guess: (B, n, n) float32, contiguous; planes: (5, n, n) float32.
    Returns (x, iterations per chunk). CUDA tensors launch the kernel, CPU
    tensors run the plain version; anything else raises."""
    if div.dim() != 3 or div.shape[1] != div.shape[2]:
        raise ValueError(f"div must be (B, n, n), got {tuple(div.shape)}")
    n = div.shape[1]
    if guess.shape != div.shape or planes.shape != (5, n, n):
        raise ValueError(f"shape mismatch: div {tuple(div.shape)}, guess "
                         f"{tuple(guess.shape)}, planes {tuple(planes.shape)}")
    for name, t in (("div", div), ("guess", guess), ("planes", planes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != div.device:
            raise ValueError(f"{name} is on {t.device}, div on {div.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if check_every < 1 or max_iter < 0:
        raise ValueError(f"check_every must be >= 1 and max_iter >= 0, got "
                         f"{check_every}, {max_iter}")
    if div.shape[0] == 0:
        return div.clone(), torch.zeros(0, dtype=torch.int32, device=div.device)
    if div.is_cuda:
        return pressure_cg_cuda(div, guess, planes, accuracy, max_iter, check_every)
    if div.device.type == "cpu":
        return pressure_cg_plain(div, guess, planes, accuracy, max_iter, check_every)
    raise ValueError(f"pressure_cg runs on CUDA or CPU tensors, not {div.device}")


class _KernelSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, div, guess, planes, accuracy, max_iter, check_every):
        ctx.save_for_backward(planes)
        ctx.accuracy, ctx.max_iter, ctx.check_every = accuracy, max_iter, check_every
        return pressure_cg(div, guess, planes, accuracy, max_iter, check_every)[0]

    @staticmethod
    def backward(ctx, g):
        # x = A^-1 div whatever the warm start: CG on the cotangent (A is
        # symmetric), zero cotangent for the guess
        (planes,) = ctx.saved_tensors
        g = g.contiguous()
        gd = pressure_cg(g, torch.zeros_like(g), planes, ctx.accuracy, ctx.max_iter,
                         ctx.check_every)[0]
        return gd, torch.zeros_like(g), None, None, None, None


def pressure_solve_kernel(
    masks, div: torch.Tensor, accuracy: float = 1e-6, max_iter: int = 500,
    guess: Optional[torch.Tensor] = None, check_every: int = 1,
) -> torch.Tensor:
    """Solve A p = div (B, 127, 127) with K1; differentiable in `div`.

    masks: `solvers.smoke.SmokeMasks` on the device of `div`; `guess`
    warm-starts the solve. check_every=1 is the Pallas v1 schedule, 32 v2's."""
    if guess is None:
        guess = torch.zeros_like(div)
    return _KernelSolve.apply(div.contiguous(), guess.contiguous(), masks.planes,
                              accuracy, max_iter, check_every)
