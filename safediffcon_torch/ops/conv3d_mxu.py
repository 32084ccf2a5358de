"""Kernel K2: fused stride-1 SAME 3x3x3 convolution on channels-last input.

Port of `safediffcon_tpu/ops/conv3d_mxu.py` (`_make_kernel` +
`_conv3d_fused_fwd`, and the custom_vjp around them). Two CUDA kernels
compute it as an implicit GEMM over M = B*F*H*W voxels, N = Cout and
K = 27*Cin:

- `csrc/conv3d_wgmma.cu`, the main one: TMA-fed wgmma on the tensor cores.
  float32 input runs in one TF32 pass when `torch.backends.cudnn.allow_tf32`
  is True at call time (the flag that also governs cuDNN's float32 convs)
  and in 3xTF32 split precision (`split_tf32`) when it is False; bfloat16
  input runs one bf16 pass. It takes every shape that splits into its
  128-voxel tiles (`wgmma_tile`).
- `csrc/conv3d_simt.cu`, float32 FMAs on the CUDA cores, for the shapes the
  first does not take. The choice is made from the shape alone.

- `conv3d_fused(x, w_flat)` dispatches on the device of its inputs: CUDA
  tensors launch a kernel (or raise), CPU tensors run
  `conv3d_fused_plain`, the same function as a sum of 27 shifted-slice
  matmuls in float32.
- `conv3d_fused_fn(x, weight)` is the differentiable entry the UNet3D calls
  with the weight in `nn.Conv3d` layout (Cout, Cin, 3, 3, 3). Its backward
  pass computes dx with the same kernel on the cotangent and the flipped,
  channel-transposed weight (`_bwd`, conv3d_mxu.py:126-139), reading the
  TF32 flag when it runs. dW is a weight-gradient reduction outside the
  kernel, as in JAX: the framework's `conv3d_weight` on CUDA and the plain
  shifted-slice form on the CPU, both in float32 (for bf16 input too) and
  rounded once to the weight's dtype.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from safediffcon_torch.ops import build

# the 27 taps (df, dh, dw) in the order of the flattened weight's rows
OFFSETS = [(df, dh, dw) for df in range(3) for dh in range(3) for dw in range(3)]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_VOXELS = 128  # output voxels per block of the tensor-core kernel
MODES = {"tf32": 0, "3xtf32": 1, "bf16": 2}


def flatten_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (27 * Cin, Cout), rows in (df, dh, dw, c) order:
    flax's (3, 3, 3, Cin, Cout) kernel reshaped, as `_flatten_kernel` does."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 4, 1, 0).reshape(27 * cin, cout).contiguous()


def flip_transpose(weight: torch.Tensor) -> torch.Tensor:
    """The spatially flipped, channel-transposed weight in the same
    (Cout, Cin, 3, 3, 3) layout (`_flip_transpose`): correlating the
    cotangent with it is the stride-1 SAME conv transpose."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def _shifted(x: torch.Tensor):
    """The 27 shifted (B, F, H, W, C) views of x with a zero border, in
    OFFSETS order."""
    _, f, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    for df, dh, dw in OFFSETS:
        yield xp[:, df : df + f, dh : dh + h, dw : dw + w, :]


def conv3d_fused_plain(x: torch.Tensor, w_flat: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: 27 shifted-slice matmuls
    accumulated in float32, output in x's dtype."""
    c = x.shape[-1]
    w32 = w_flat.float()
    out = None
    for i, view in enumerate(_shifted(x.float())):
        term = view @ w32[i * c : (i + 1) * c]
        out = term if out is None else out + term
    return out.to(x.dtype)


def conv3d_weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dW of the conv in (Cout, Cin, 3, 3, 3) layout from the input x
    (B, F, H, W, Cin) and the cotangent g (B, F, H, W, Cout), in float32."""
    g2 = g.float().reshape(-1, g.shape[-1])
    rows = [view.reshape(-1, x.shape[-1]).t() @ g2 for view in _shifted(x.float())]
    dw = torch.stack(rows).reshape(3, 3, 3, x.shape[-1], g.shape[-1])
    return dw.permute(4, 3, 0, 1, 2)


def k_major_weight(w_flat: torch.Tensor) -> torch.Tensor:
    """(27 * Cin, Cout) in (df, dh, dw, c) row order -> (Cout, 27, Cin)
    contiguous: the K-major layout the tensor cores take for B (the weight
    in `nn.Conv3d` layout, permuted to (Cout, 3, 3, 3, Cin))."""
    cout = w_flat.shape[1]
    return w_flat.reshape(27, -1, cout).permute(2, 0, 1).contiguous()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest, ties away from
    zero: PTX's cvt.rna.tf32.f32), as float32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo exactly, with hi = `round_tf32(x)` and lo the float32
    remainder. float32 in, float32 out."""
    hi = round_tf32(x)
    return hi, x - hi


def wgmma_tile(shape, dtype) -> Optional[Tuple[int, int]]:
    """(rows, frames) of the tensor-core kernel's 128-voxel tile for x of
    shape (B, F, H, W, Cin) and this dtype, or None where that kernel does
    not take the shape: W must divide 128; a tile is 128 / W whole rows of
    one frame (H a multiple of them) or, for frames of fewer than 128
    voxels, 128 / (H * W) whole frames (F a multiple of them); Cin * element
    size must be a multiple of 16 bytes (the TMA stride rule)."""
    _, f, h, w, c = shape
    size = torch.tensor([], dtype=dtype).element_size()
    if w > TILE_VOXELS or TILE_VOXELS % w or (c * size) % 16:
        return None
    if h * w >= TILE_VOXELS:
        rows = TILE_VOXELS // w
        return (rows, 1) if h % rows == 0 else None
    if TILE_VOXELS % (h * w) == 0 and f % (TILE_VOXELS // (h * w)) == 0:
        return (h, TILE_VOXELS // (h * w))
    return None


def kernel_mode(dtype) -> str:
    """The tensor-core kernel's precision for this input dtype under the
    current `torch.backends.cudnn.allow_tf32`."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "tf32" if torch.backends.cudnn.allow_tf32 else "3xtf32"


def _launch(fn, x, args, counter):
    """Run one launch on the current stream of x's card, with that card the
    current device (the kernel's attributes are set on the current one),
    raising on a refused launch; time it when `counter.events` is a list.
    The caller counts it."""
    stream = torch.cuda.current_stream(x.device)
    events = counter.events
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
    with torch.cuda.device(x.device):
        err = fn(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{counter.__name__}: kernel launch failed with CUDA error {err}")
    if events is not None:
        end.record(stream)
        events.append((start, end))


def conv3d_fused_cuda(x: torch.Tensor, w_flat: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """Launch the tensor-core kernel (`csrc/conv3d_wgmma.cu`) on the current
    stream with the tile of `wgmma_tile`, in the precision of `kernel_mode`.
    Counts its launches per precision mode in the dict
    `conv3d_fused_cuda.launches` ({mode: count}); when
    `conv3d_fused_cuda.events` is a list, appends a (start, end) pair of
    timing CUDA events around each launch (no sync)."""
    b, f, h, w, c = x.shape
    cout = w_flat.shape[1]
    mode = kernel_mode(x.dtype)
    w_hi, w_lo = k_major_weight(w_flat), None
    if mode == "tf32":
        w_hi = round_tf32(w_hi)
    elif mode == "3xtf32":
        w_hi, w_lo = split_tf32(w_hi)
    fn = build.load("conv3d_wgmma").conv3d_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, f, h, w, cout), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w_hi.data_ptr(), None if w_lo is None else w_lo.data_ptr(),
            out.data_ptr(), b, f, h, w, c, cout, *tile, MODES[mode])
    _launch(fn, x, args, conv3d_fused_cuda)
    conv3d_fused_cuda.launches[mode] += 1
    return out


conv3d_fused_cuda.launches = dict.fromkeys(MODES, 0)
conv3d_fused_cuda.events = None


def conv3d_fused_simt_cuda(x: torch.Tensor, w_flat: torch.Tensor) -> torch.Tensor:
    """Launch the SIMT kernel (`csrc/conv3d_simt.cu`, float32 FMAs) on the
    current stream; counts in `conv3d_fused_simt_cuda.launches` and times
    like `conv3d_fused_cuda`."""
    b, f, h, w, c = x.shape
    cout = w_flat.shape[1]
    fn = build.load("conv3d_simt").conv3d_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, f, h, w, cout), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w_flat.data_ptr(), out.data_ptr(), b, f, h, w, c, cout,
            _DTYPES[x.dtype])
    _launch(fn, x, args, conv3d_fused_simt_cuda)
    conv3d_fused_simt_cuda.launches += 1
    return out


conv3d_fused_simt_cuda.launches = 0
conv3d_fused_simt_cuda.events = None


def conv3d_fused(x: torch.Tensor, w_flat: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3x3 conv, no bias.

    x: (B, F, H, W, Cin) float32 or bfloat16, contiguous; w_flat: (27 * Cin,
    Cout) of the same dtype (`flatten_weight`). Returns (B, F, H, W, Cout) in
    x's dtype. CUDA tensors launch the tensor-core kernel where `wgmma_tile`
    takes the shape and the SIMT kernel elsewhere; CPU tensors run the plain
    version; anything else raises."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, F, H, W, C), got {tuple(x.shape)}")
    if w_flat.dim() != 2 or w_flat.shape[0] != 27 * x.shape[-1]:
        raise ValueError(f"w_flat must be (27 * {x.shape[-1]}, Cout), got {tuple(w_flat.shape)}")
    if x.dtype not in _DTYPES or w_flat.dtype != x.dtype:
        raise TypeError(f"x and w_flat must both be float32 or bfloat16, got {x.dtype}, "
                        f"{w_flat.dtype}")
    if w_flat.device != x.device:
        raise ValueError(f"w_flat is on {w_flat.device}, x on {x.device}")
    if not (x.is_contiguous() and w_flat.is_contiguous()):
        raise ValueError("x and w_flat must be contiguous")
    if x.is_cuda:
        if x[..., 0].numel() >= 2**31:
            raise ValueError(f"B*F*H*W = {x[..., 0].numel()} voxels exceeds the kernel's 2^31")
        if x.numel() == 0:
            return torch.empty((*x.shape[:-1], w_flat.shape[1]), dtype=x.dtype, device=x.device)
        tile = wgmma_tile(x.shape, x.dtype)
        if tile is None or x.data_ptr() % 16:
            return conv3d_fused_simt_cuda(x, w_flat)
        return conv3d_fused_cuda(x, w_flat, tile)
    if x.device.type == "cpu":
        return conv3d_fused_plain(x, w_flat)
    raise ValueError(f"conv3d_fused runs on CUDA or CPU tensors, not {x.device}")


class _Conv3dFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv3d_fused(x, flatten_weight(weight))

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_fused(g, flatten_weight(flip_transpose(weight)))
        if ctx.needs_input_grad[1]:
            # in float32 from the operands, rounded once to the weight's
            # dtype, as the JAX VJP computes it (bf16 operands are exact in
            # float32 and in TF32)
            if g.is_cuda:
                dw = torch.nn.grad.conv3d_weight(
                    x.float().permute(0, 4, 1, 2, 3), weight.shape,
                    g.float().permute(0, 4, 1, 2, 3), padding=1)
            else:
                dw = conv3d_weight_grad_plain(x, g)
            dw = dw.to(weight.dtype)
        return dx, dw


def conv3d_fused_fn(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Differentiable K2 conv of channels-last x with an (Cout, Cin, 3, 3, 3)
    weight, both of one dtype; no bias."""
    return _Conv3dFused.apply(x.contiguous(), weight)
