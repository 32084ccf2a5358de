"""Kernel K1: chunked-batch conjugate gradient for the masked pressure solve.

Port of `safediffcon_tpu/ops/pressure_cg.py` (`_make_kernel`/`_cg_pallas`,
v1, and `_make_block_kernel`/`_cg_pallas_v2`, v2). One CUDA kernel,
`csrc/pressure_cg.cu`, covers both variants: `check_every=1` tests
convergence every iteration as v1 does, `check_every=32` every 32 as v2
does. Dot products and the test are shared within chunks of CHUNK=8
samples, and both modes use v2's safe divide.

`pressure_cg` dispatches on the device of its inputs: CUDA tensors launch
the kernel (or raise), CPU tensors run `pressure_cg_plain`, the same
recurrence in plain PyTorch with the identical chunking, check interval and
safe divide. `pressure_solve_kernel` is the differentiable entry the smoke
solver calls; its backward pass is the same solve applied to the cotangent,
with zero gradient for the warm start (pressure_cg.py:254-264).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from safediffcon_torch.ops import build

CHUNK = 8  # samples sharing one block, its dot products and its convergence test
BLOCK_K = 32  # v2's iterations between convergence tests
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


def pressure_cg_cuda(div, guess, planes, accuracy: float, max_iter: int,
                     check_every: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream: returns (x, iterations per chunk).
    Counts its launches in `pressure_cg_cuda.launches`; when
    `pressure_cg_cuda.iterations` is a list, appends each launch's
    iteration counts to it (device tensors, no sync)."""
    b, n, _ = div.shape
    fn = build.load(_KERNEL).pressure_cg_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty_like(div)
    m = torch.empty_like(div)
    am = torch.empty_like(div)
    r = torch.empty_like(div)
    iters = torch.empty(-(-b // CHUNK), dtype=torch.int32, device=div.device)
    stream = torch.cuda.current_stream(div.device).cuda_stream
    err = fn(div.data_ptr(), guess.data_ptr(), planes.data_ptr(), x.data_ptr(),
             m.data_ptr(), am.data_ptr(), r.data_ptr(), iters.data_ptr(),
             b, n, float(accuracy), int(max_iter), int(check_every), stream)
    if err != 0:
        raise RuntimeError(f"pressure_cg kernel launch failed with CUDA error {err}")
    pressure_cg_cuda.launches += 1
    if pressure_cg_cuda.iterations is not None:
        pressure_cg_cuda.iterations.append(iters)
    return x, iters


pressure_cg_cuda.launches = 0
pressure_cg_cuda.iterations = None


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
