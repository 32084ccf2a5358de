"""3D (video) U-Net denoiser for the 2D smoke task.

Port of `safediffcon_tpu/models/unet3d.py` (reference topology:
2d/video_diffusion_pytorch/video_diffusion_pytorch_conv3d.py:357-574).
Activations stay channels-last (B, F, H, W, C) as in the JAX module; each
convolution views its input as NCDHW with `permute` (no copy: the permuted
view has the channels-last-3d strides cuDNN takes directly) and views the
result back.

`attn_impl="packed"` is a TPU matrix-unit layout whose result equals
per-head attention (`safediffcon_tpu/models/unet3d.py:66-79`); the port
accepts either flag and computes per-head attention.

`conv_impl="pallas"` runs every 3x3x3 conv of the residual blocks on kernel
K2 (`ops/conv3d_mxu.py`), with the same parameters as the framework conv, so
a state_dict loads into either.

`compute_dtype="bfloat16"` runs every Dense and Conv (K2 included) in bf16
from float32 parameters, with flax's dtype semantics (`models/layers.py`):
the input, the time embedding and the relative-position bias are cast to
bf16, so the residual stream stays bf16 (each pre-norm block ends in a bf16
Dense); ChanLayerNorm takes bf16 statistics and returns float32 through its
float32 `g`, which the next Dense casts back. The output is float32 either
way.

`use_remat` recomputes each residual block and pre-norm attention block in
the backward pass (`torch.utils.checkpoint`), as `nn.remat` does in JAX; it
acts only while autograd records. `remat_policy="full"` keeps only each
block's inputs; `"save_heavy"` also keeps the outputs of the convolutions
and matmuls autograd records (`SAVED_OPS`) and recomputes the rest, as the
JAX policy saves `conv_general_dilated` and `dot_general`.

Under a mesh with a frame axis that divides F (`parallel/mesh.py`), the
forward takes the whole input on every rank and computes its F/sp frames of
every activation (sequence parallelism; the JAX package leaves it to XLA's
partitioner). The layers that see across frames exchange what they need:
the 7x7x7 `init_conv` cuts its window of 3 frames either side from the whole
input, each 3x3x3 conv of a `Block3D` (cuDNN or K2, the latter on F/sp + 2
frames, its two edge outputs dropped) takes a halo of one frame from each
neighbour, `GroupNormCL` all-reduces its statistics, and `TemporalAttention`
gathers the keys and values of every frame, with RoPE at the global
positions and this rank's rows of the relative-position bias. The output is
gathered along frames, so the loss sees the whole of it; its backward keeps
this rank's slice, and the weights' gradients are summed over the frame
ranks afterwards (`BatchShard.reduce`). Under remat the collectives inside a
block run again in the backward pass, in the same order on every rank, and
"save_heavy" does not keep their outputs (they run inside autograd
Functions, which its policy does not see), so they are recomputed too.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from safediffcon_torch.models.layers import (
    COMPUTE_DTYPES,
    GroupNormCL,
    Linear,
    PreNormResidual,
    TimeMLP,
    _compute_dtype,
)
from safediffcon_torch.ops.conv3d_mxu import conv3d_fused_fn
from safediffcon_torch.parallel import mesh as pmesh

ATTN_IMPLS = ("heads", "packed")
CONV_IMPLS = ("xla", "pallas")
REMAT_POLICIES = ("full", "save_heavy")
# the aten ops that F.conv3d / F.conv_transpose3d, F.linear and matmul /
# einsum reach below autograd: the counterparts of conv_general_dilated and
# dot_general, whose outputs "save_heavy" keeps
_aten = torch.ops.aten
SAVED_OPS = frozenset({_aten.convolution.default, _aten.mm.default, _aten.bmm.default,
                       _aten.addmm.default, _aten.baddbmm.default})


def _save_heavy_policy(ctx, op, *args, **kwargs):
    # Only ops autograd records are kept. K2's autograd.Function runs its
    # forward with grad off: its plain version (CPU) is recomputed, and its
    # CUDA launch goes through ctypes, which no policy sees, so K2 is
    # recomputed on both devices, as JAX recomputes the pallas_call inside
    # its custom_vjp.
    if op in SAVED_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_heavy_context():
    return create_selective_checkpoint_contexts(_save_heavy_policy)


def _rel_pos_buckets(n: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """T5 relative position buckets for an n x n attention map
    (reference: video_diffusion_pytorch_conv3d.py:86-104)."""
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    rel = k - q
    neg = -rel
    num_buckets //= 2
    ret = (neg < 0).astype(np.int64) * num_buckets
    nabs = np.abs(neg)
    max_exact = num_buckets // 2
    is_small = nabs < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(nabs, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, nabs, val_if_large)


def _rope(x: torch.Tensor, theta: float = 10000.0, offset: int = 0) -> torch.Tensor:
    """Interleaved rotary position embedding over the token axis (axis -2),
    whose first token sits at position `offset`; the angle table is built in
    float64 numpy and cast, as in JAX."""
    n, d = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    angles = (np.arange(n) + offset)[:, None] * freqs[None, :]
    cos = torch.as_tensor(np.cos(angles), dtype=x.dtype, device=x.device)
    sin = torch.as_tensor(np.sin(angles), dtype=x.dtype, device=x.device)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x1 * sin + x2 * cos
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape)


class Conv3dCL(nn.Conv3d):
    """flax `nn.Conv(dtype=...)` over channels-last (B, F, H, W, C) tensors."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size, stride=1, padding=0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim_in, dim_out, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x, halo: bool = False):
        """`halo`: x's frame axis already carries the frame padding on
        either side (a halo exchange or a window of the whole video), so
        the frames are not padded again."""
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        pad = (0,) + tuple(self.padding[1:]) if halo else self.padding
        y = _conv_in(F.conv3d, dt, x.permute(0, 4, 1, 2, 3), self.weight, self.bias,
                     stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 4, 1)


def _conv_in(conv, dt: torch.dtype, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             **kw) -> torch.Tensor:
    """`conv(x, w, b, **kw)` (F.conv3d or F.conv_transpose3d) on operands
    cast to `dt`. A bf16 conv of CPU tensors is taken in float32 on the
    bf16-rounded operands, its output rounded once to bf16 and the bias
    added in bf16, as XLA's CPU backend computes flax's bf16 conv: oneDNN's
    bf16 3-D conv, which F.conv3d reaches on the CPU, corrupts memory in its
    backward on a channels-last input (torch 2.13 on an AVX512-BF16 CPU).
    CUDA tensors take cuDNN's bf16 conv as they are."""
    x, w, b = x.to(dt), w.to(dt), b.to(dt)
    if dt == torch.bfloat16 and x.device.type == "cpu":
        y = conv(x.float(), w.float(), None, **kw).to(dt)
        return y + b.view(-1, *(1,) * (y.dim() - 2))
    return conv(x, w, b, **kw)


def _flax_same_transpose_pad(k: int, s: int):
    """(low, high) padding of the stride-dilated input that flax's
    ConvTranspose(padding="SAME") applies (jax.lax.conv_transpose)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class ConvTransposeCL(nn.Module):
    """flax `nn.ConvTranspose(padding="SAME", transpose_kernel=False)` on
    channels-last tensors.

    flax dilates the input by the stride, pads it and CORRELATES it with the
    kernel as stored, with no flip. `F.conv_transpose3d` flips its kernel and
    swaps its channel axes, so it gets the flipped, transposed weight and the
    padding k - 1 - pad that reproduces flax's pad (which is symmetric for
    every kernel and stride UNet3D uses; asymmetric ones are refused). The
    weight is held in correlation layout (Cout, Cin, kD, kH, kW), like a
    Conv3d's."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size, stride,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = []
        for k, s in zip(self.kernel_size, self.stride):
            lo, hi = _flax_same_transpose_pad(k, s)
            if lo != hi:
                raise NotImplementedError(f"asymmetric SAME padding for k={k}, s={s}")
            self.padding.append(k - 1 - lo)
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim_out))

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        y = _conv_in(F.conv_transpose3d, dt, x.permute(0, 4, 1, 2, 3),
                     self.weight.flip(2, 3, 4).transpose(0, 1), self.bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class TemporalAttention(nn.Module):
    """Full attention over the frame axis with RoPE + relative position bias
    (reference: video_diffusion_pytorch_conv3d.py:277-353). In bf16 the
    scores, the bias and the softmax are bf16, as in the JAX module."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x, pos_bias=None, fs: Optional[pmesh.FrameShard] = None):
        """`fs`: x holds this rank's frames of a video split over a frame
        group. Its queries attend to the keys and values of every frame
        (gathered, at their global RoPE positions), and `pos_bias` holds
        this rank's rows (H, F/sp, F)."""
        b, f, hh, ww, c = x.shape
        t = x.permute(0, 2, 3, 1, 4).reshape(b, hh * ww, f, c)
        q, k, v = self.to_qkv(t).chunk(3, dim=-1)

        def heads(z):  # (..., n, H*D) -> (..., H, n, D)
            return z.reshape(*z.shape[:-1], self.heads, self.dim_head).transpose(-3, -2)

        q, k, v = heads(q), heads(k), heads(v)
        q = q * (self.dim_head ** -0.5)
        offset = 0 if fs is None else fs.lo
        q = _rope(q, offset=offset)
        k = _rope(k, offset=offset)
        if fs is not None:
            k = pmesh.gather_kv(k, fs, dim=-2)
            v = pmesh.gather_kv(v, fs, dim=-2)
        sim = q @ k.transpose(-1, -2)
        if pos_bias is not None:
            sim = sim + pos_bias  # (H, F, F) broadcast over (B, HW)
        sim = sim - sim.amax(dim=-1, keepdim=True)
        out = sim.softmax(dim=-1) @ v
        out = out.transpose(-3, -2).reshape(b, hh * ww, f, self.heads * self.dim_head)
        out = self.to_out(out)
        return out.reshape(b, hh, ww, f, c).permute(0, 3, 1, 2, 4)


class SpatialLinearAttention3D(nn.Module):
    """Per-frame linear attention over H*W tokens
    (reference: video_diffusion_pytorch_conv3d.py:232-258)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        b, f, hh, ww, c = x.shape
        t = x.reshape(b * f, hh * ww, c)
        q, k, v = self.to_qkv(t).chunk(3, dim=-1)

        def heads(z):  # (B', N, H*D) -> (B', H, D, N)
            bb, n, _ = z.shape
            return z.reshape(bb, n, self.heads, self.dim_head).permute(0, 2, 3, 1)

        q, k, v = heads(q), heads(k), heads(v)
        q = q.softmax(dim=-2)
        k = k.softmax(dim=-1)
        q = q * (self.dim_head ** -0.5)
        context = k @ v.transpose(-1, -2)  # (B', H, D, E)
        out = context.transpose(-1, -2) @ q  # (B', H, E, N)
        bb, h, d, n = out.shape
        out = out.permute(0, 3, 1, 2).reshape(bb, n, h * d)
        return self.to_out(out).reshape(b, f, hh, ww, c)


class MidSpatialAttention(nn.Module):
    """Full per-frame spatial attention at the bottleneck (`_MidSpatial`)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(self, z):
        b, ff, hh, ww, c = z.shape
        tkn = z.reshape(b * ff, hh * ww, c)
        q, k, v = self.to_qkv(tkn).chunk(3, dim=-1)

        def heads(zz):  # (B', N, H*D) -> (B', H, N, D)
            bb, n, _ = zz.shape
            return zz.reshape(bb, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        q = q * (self.dim_head ** -0.5)
        sim = q @ k.transpose(-1, -2)
        sim = sim - sim.amax(dim=-1, keepdim=True)
        out = sim.softmax(dim=-1) @ v
        bb, hd, n, d = out.shape
        out = out.transpose(1, 2).reshape(bb, n, hd * d)
        return self.to_out(out).reshape(b, ff, hh, ww, c)


class FusedConv3x3x3(nn.Module):
    """Stride-1 SAME 3x3x3 conv on channels-last tensors through kernel K2
    (`FusedConv3x3x3` of the JAX module). Its parameters are a Conv3d's:
    weight (Cout, Cin, 3, 3, 3) and bias (Cout,), float32; with a dtype, x,
    the weight and the bias are cast to it, and the bias is added in it."""

    def __init__(self, dim_in: int, dim_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(dim_out))
        self.compute_dtype = dtype

    def forward(self, x, halo: bool = False):
        """`halo`: x carries one frame of padding on either side (a halo
        exchange): K2 runs on all of them and the two edge outputs, whose
        frame padding was K2's own zeros, are dropped."""
        dt = self.compute_dtype or x.dtype
        y = conv3d_fused_fn(x.to(dt), self.weight.to(dt))
        if halo:
            y = y[:, 1:-1]
        return y + self.bias.to(dt)


class Block3D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, groups: int = 8, conv_impl: str = "xla",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_impl == "pallas":
            self.conv = FusedConv3x3x3(dim_in, dim_out, dtype)
        else:
            self.conv = Conv3dCL(dim_in, dim_out, kernel_size=3, padding=1, dtype=dtype)
        self.norm = GroupNormCL(groups, dim_out, dtype=dtype)

    def forward(self, x, scale_shift=None, fs: Optional[pmesh.FrameShard] = None):
        if fs is None:
            x = self.norm(self.conv(x))
        else:  # this rank's frames: a halo of one frame for the 3x3x3 conv
            x = self.norm(self.conv(pmesh.halo_exchange(x, 1, fs), halo=True), fs)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResnetBlock3D(nn.Module):
    """Two conv blocks with FiLM time conditioning + residual; `time_dim=None`
    builds the block without its time projection."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: Optional[int], groups: int = 8,
                 conv_impl: str = "xla", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = Linear(time_dim, dim_out * 2, dtype=dtype) if time_dim else None
        self.block1 = Block3D(dim_in, dim_out, groups, conv_impl, dtype)
        self.block2 = Block3D(dim_out, dim_out, groups, conv_impl, dtype)
        self.res_conv = (Conv3dCL(dim_in, dim_out, kernel_size=1, dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x, time_emb=None, fs: Optional[pmesh.FrameShard] = None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            h_t = self.mlp(F.silu(time_emb))
            h_t = h_t.reshape(h_t.shape[0], 1, 1, 1, h_t.shape[-1])
            scale_shift = h_t.chunk(2, dim=-1)
        h = self.block1(x, scale_shift, fs=fs)
        h = self.block2(h, fs=fs)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class UNet3D(nn.Module):
    """UNet3D forward on (B, F, H, W, C) input and (B,) timesteps; float32
    output."""

    def __init__(
        self,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2, 4),
        channels: int = 7,
        attn_heads: int = 4,
        attn_dim_head: int = 32,
        resnet_groups: int = 8,
        compute_dtype: Optional[str] = None,
        use_remat: bool = True,
        remat_policy: str = "full",
        conv_impl: str = "xla",
        attn_impl: str = "packed",
    ):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        dt = COMPUTE_DTYPES[compute_dtype]
        self.compute_dtype = dt or torch.float32
        self.use_remat = use_remat
        self.remat_policy = remat_policy

        def temporal(d):
            return PreNormResidual(d, TemporalAttention(d, attn_heads, attn_dim_head, dt))

        def spatial(d):
            return PreNormResidual(d, SpatialLinearAttention3D(d, attn_heads, attn_dim_head, dt))

        time_dim = dim * 4
        self.time_rel_pos_bias = nn.Embedding(32, attn_heads)
        self.time_mlp = TimeMLP(dim, time_dim, dtype=dt)
        self.init_conv = Conv3dCL(channels, dim, kernel_size=7, padding=3, dtype=dt)
        self.init_temporal_attn = temporal(dim)

        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        num_res = len(in_out)

        def resnet(d_in, d_out, t_dim=time_dim):
            return ResnetBlock3D(d_in, d_out, t_dim, resnet_groups, conv_impl, dt)

        # each level: [resnet, resnet, spatial attn, temporal attn, resample]
        self.downs = nn.ModuleList()
        for i, (dim_in, dim_out) in enumerate(in_out):
            is_last = i >= num_res - 1
            self.downs.append(nn.ModuleList([
                resnet(dim_in, dim_out),
                resnet(dim_out, dim_out),
                spatial(dim_out),
                temporal(dim_out),
                # spatial-only downsample, k(1,4,4) s(1,2,2)
                nn.Identity() if is_last else Conv3dCL(
                    dim_out, dim_out, kernel_size=(1, 4, 4), stride=(1, 2, 2),
                    padding=(0, 1, 1), dtype=dt),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = resnet(mid_dim, mid_dim)
        self.mid_spatial_attn = PreNormResidual(
            mid_dim, MidSpatialAttention(mid_dim, attn_heads, attn_dim_head, dt))
        self.mid_temporal_attn = temporal(mid_dim)
        self.mid_block2 = resnet(mid_dim, mid_dim)

        self.ups = nn.ModuleList()
        for i, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = i >= num_res - 1
            self.ups.append(nn.ModuleList([
                resnet(dim_out * 2, dim_in),
                resnet(dim_in, dim_in),
                spatial(dim_in),
                temporal(dim_in),
                # spatial-only transposed-conv upsample, k(1,4,4) s(1,2,2)
                nn.Identity() if is_last else ConvTransposeCL(
                    dim_in, dim_in, kernel_size=(1, 4, 4), stride=(1, 2, 2), dtype=dt),
            ]))

        self.final_block = resnet(dim * 2, dim, None)
        self.final_conv = Conv3dCL(dim, channels, kernel_size=1, dtype=dt)

    def forward(self, x, t):
        """x: the whole (B, F, H, W, C) input on every rank. Under a mesh
        whose frame axis divides F (`parallel.mesh.frame_shard`), each rank
        computes its F/sp frames of every activation and the output is
        gathered along frames, so every rank returns the whole output."""
        dt = self.compute_dtype
        x = x.to(dt)
        f = x.shape[1]
        fs = pmesh.frame_shard(f)
        buckets = torch.as_tensor(_rel_pos_buckets(f, num_buckets=32, max_distance=32),
                                  device=x.device)
        pos_bias = self.time_rel_pos_bias(buckets).permute(2, 0, 1).to(dt)  # (H, F, F)
        time_emb = self.time_mlp(t).to(dt)
        if fs is not None:
            pos_bias = pos_bias[:, fs.lo : fs.lo + fs.length]  # this rank's query rows

        if self.use_remat and torch.is_grad_enabled():
            # each residual / pre-norm block keeps its inputs ("full") and
            # its conv / matmul outputs ("save_heavy"); the rest is
            # recomputed in the backward pass
            kw_ckpt = dict(use_reentrant=False, preserve_rng_state=False)
            if self.remat_policy == "save_heavy":
                kw_ckpt["context_fn"] = _save_heavy_context

            def run(block, *args, **kw):
                return checkpoint(block, *args, **kw_ckpt, **kw)
        else:
            def run(block, *args, **kw):
                return block(*args, **kw)

        if fs is None:
            x = self.init_conv(x)
        else:  # the 7x7x7 conv's window of the whole input: 3 frames each side
            pad = self.init_conv.padding[0]
            x = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad)).narrow(1, fs.lo, fs.length + 2 * pad)
            x = self.init_conv(x, halo=True)
        x = run(self.init_temporal_attn, x, pos_bias=pos_bias, fs=fs)
        r = x

        h = []
        for res1, res2, spatial_attn, temporal_attn, downsample in self.downs:
            x = run(res1, x, time_emb, fs=fs)
            x = run(res2, x, time_emb, fs=fs)
            x = run(spatial_attn, x)
            x = run(temporal_attn, x, pos_bias=pos_bias, fs=fs)
            h.append(x)
            x = downsample(x)

        x = run(self.mid_block1, x, time_emb, fs=fs)
        x = run(self.mid_spatial_attn, x)
        x = run(self.mid_temporal_attn, x, pos_bias=pos_bias, fs=fs)
        x = run(self.mid_block2, x, time_emb, fs=fs)

        for res1, res2, spatial_attn, temporal_attn, upsample in self.ups:
            x = torch.cat([x, h.pop()], dim=-1)
            x = run(res1, x, time_emb, fs=fs)
            x = run(res2, x, time_emb, fs=fs)
            x = run(spatial_attn, x)
            x = run(temporal_attn, x, pos_bias=pos_bias, fs=fs)
            x = upsample(x)

        x = torch.cat([x, r], dim=-1)
        x = run(self.final_block, x, fs=fs)
        x = self.final_conv(x).to(torch.float32)
        return x if fs is None else pmesh.gather_frames(x, fs)
