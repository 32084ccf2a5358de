"""The arithmetic of K2's tensor-core kernel (`csrc/conv3d_wgmma.cu`) in plain
PyTorch on the CPU: the TF32 split the 3xTF32 mode uses, its emulation
against the float32 plain version and the JAX package's Pallas kernel
(interpret mode), the 1xTF32 error that sets chip_smoke.py's tolerance, the
shape test that routes between the tensor-core and the SIMT kernels, the
K-major weight layout, and the build's hash over included headers. The
kernels themselves run only on the card (chip_smoke.py phase 6)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from safediffcon_tpu.ops import conv3d_mxu as J
from safediffcon_torch.ops import build
from safediffcon_torch.ops import conv3d_mxu as K

torch.set_num_threads(1)

# (x shape, Cout): the JAX tests' shapes and the small pretrain's
SHAPES = [
    ((2, 4, 8, 8, 8), 4),
    ((1, 3, 4, 8, 16), 4),
    ((1, 2, 12, 8, 8), 8),
    ((1, 4, 8, 8, 32), 16),
    ((1, 2, 16, 16, 16), 32),
]
# (H = W, Cin, Cout) of UNet3D's 3x3x3 convs at dim 64 (chip_smoke.K2_SHAPES)
UNET3D = [(64, 64, 64), (64, 128, 64), (32, 64, 128), (32, 128, 128), (32, 256, 64),
          (32, 64, 64), (16, 128, 256), (16, 256, 256), (16, 512, 128), (16, 128, 128)]


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], cout)) / np.sqrt(27 * shape[-1])).astype(np.float32)
    return x, k


def _w_flat(k):
    """flax (3, 3, 3, Cin, Cout) -> (27 * Cin, Cout), the port's flattened weight."""
    return torch.from_numpy(np.array(J._flatten_kernel(jnp.asarray(k))))


def _tf32_read(x):
    """x as the tensor cores read a float32 operand in TF32: its top 19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def conv3d_fused_emulated(x, w_flat, mode):
    """The tensor-core kernel's float32 arithmetic in plain PyTorch. "tf32":
    one product of the TF32-rounded operands; "3xtf32": hi*hi + hi*lo + lo*hi
    of the `split_tf32` parts. Each product of two TF32 values is exact in
    float32, so only the summation order differs from the kernel."""
    x_hi, x_lo = K.split_tf32(x.float())
    w_hi, w_lo = K.split_tf32(w_flat.float())
    out = K.conv3d_fused_plain(x_hi, w_hi)
    if mode == "3xtf32":
        out = out + K.conv3d_fused_plain(x_hi, _tf32_read(w_lo))
        out = out + K.conv3d_fused_plain(_tf32_read(x_lo), w_hi)
    elif mode != "tf32":
        raise ValueError(f"mode must be 'tf32' or '3xtf32', got {mode!r}")
    return out.to(x.dtype)


def _exact(x, k):
    """The conv in float64: F.conv3d on NCDHW views."""
    xt = torch.from_numpy(x).double().permute(0, 4, 1, 2, 3)
    wt = torch.from_numpy(k).double().permute(4, 3, 0, 1, 2)
    return F.conv3d(xt, wt, padding=1).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_is_exact_and_rounds_to_ten_bits(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = K.split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 10 mantissa bits
    # round to nearest: the remainder is at most half a TF32 ulp of x
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert bool((lo.abs() <= ulp / 2).all())


def test_split_tf32_ties_round_away_from_zero():
    # 1 + 2^-11 lies halfway between TF32 neighbours 1 and 1 + 2^-10
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 0.0])
    hi, _ = K.split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 0.0]


def test_round_tf32_matches_a_float64_reference():
    """The TF32 mode rounds the weight alone (3xTF32 splits it): 11
    significant bits, ties away from zero, against frexp in float64."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=8192) * 10.0 ** rng.integers(-6, 6, 8192)).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    ref = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    got = K.round_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.float64), ref)
    assert torch.equal(got, K.split_tf32(torch.from_numpy(x))[0])


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_3xtf32_emulation_matches_plain_and_pallas(shape, cout):
    x, k = _inputs(shape, cout, 0)
    wf = _w_flat(k)
    emu = conv3d_fused_emulated(torch.from_numpy(x), wf, "3xtf32")
    plain = K.conv3d_fused_plain(torch.from_numpy(x), wf)
    pallas = np.asarray(J.conv3d_fused(jnp.asarray(x), jnp.asarray(k), 8, True))
    scale = float(plain.abs().max())
    # float32-level: hi + lo carries 21 of each operand's 24 bits, and each
    # product of two TF32 values is exact in float32
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(emu.numpy(), pallas, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_tf32_error_exceeds_3xtf32_and_stays_within_5e_3(shape, cout):
    """One TF32 pass rounds each operand to 10 mantissa bits: its error is
    well above 3xTF32's and, over these sums, well within chip_smoke's 5e-3
    of max|out|."""
    x, k = _inputs(shape, cout, 1)
    wf = _w_flat(k)
    exact = _exact(x, k)
    scale = float(exact.abs().max())
    err = {mode: float((conv3d_fused_emulated(torch.from_numpy(x), wf, mode).double()
                        - exact).abs().max()) for mode in ("tf32", "3xtf32")}
    assert err["3xtf32"] < 1e-6 * scale
    assert 10 * err["3xtf32"] < err["tf32"] <= 5e-3 * scale


def test_emulation_refuses_other_modes():
    x, k = _inputs((1, 2, 4, 4, 4), 4, 2)
    with pytest.raises(ValueError):
        conv3d_fused_emulated(torch.from_numpy(x), _w_flat(k), "bf16")


@pytest.mark.parametrize("h,cin,cout", UNET3D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_unet3d_shape_takes_the_tensor_core_kernel(h, cin, cout, dtype):
    # B = 16, F = 32 as chip_smoke runs them; dx swaps Cin and Cout
    for c in (cin, cout):
        rows, frames = K.wgmma_tile((16, 32, h, h, c), dtype)
        assert rows * frames * h == K.TILE_VOXELS and h % rows == 0 and frames == 1


@pytest.mark.parametrize("shape,tile", [
    ((2, 4, 16, 16, 16), (8, 1)),   # small pretrain, 16^2 frames: 8 whole rows
    ((2, 4, 8, 8, 32), (8, 2)),     # small pretrain, 8^2 frames: 2 whole frames
    ((2, 4, 8, 8, 64), (8, 2)),
    ((1, 1, 1, 128, 4), (1, 1)),    # one row of 128
])
def test_small_shapes_take_the_tensor_core_kernel(shape, tile):
    assert K.wgmma_tile(shape, torch.float32) == tile


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 8, 256, 8), torch.float32),  # W > 128
    ((1, 2, 8, 80, 8), torch.float32),   # W does not divide 128
    ((1, 2, 5, 32, 8), torch.float32),   # H not a multiple of 128 / W = 4 rows
    ((1, 3, 4, 8, 16), torch.float32),   # 32-voxel frames, F = 3 not a multiple of 4
    ((1, 2, 4, 4, 8), torch.float32),    # 16-voxel frames, F = 2 < 8
    ((1, 8, 8, 8, 6), torch.float32),    # Cin * 4 = 24 bytes, not a multiple of 16
    ((1, 8, 8, 8, 4), torch.bfloat16),   # Cin * 2 = 8 bytes
])
def test_other_shapes_go_to_the_simt_kernel(shape, dtype):
    assert K.wgmma_tile(shape, dtype) is None


def test_k_major_weight_matches_flatten_kernel():
    _, k = _inputs((1, 1, 1, 1, 12), 5, 3)
    wk = K.k_major_weight(_w_flat(k))
    ref = np.asarray(J._flatten_kernel(jnp.asarray(k))).reshape(27, 12, 5).transpose(2, 0, 1)
    assert wk.shape == (5, 27, 12) and wk.is_contiguous()
    np.testing.assert_array_equal(wk.numpy(), ref)
    # the same (Cout, 3, 3, 3, Cin) permutation of the nn.Conv3d weight
    w = torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy())
    np.testing.assert_array_equal(wk.numpy(), w.permute(0, 2, 3, 4, 1).reshape(5, 27, 12).numpy())


def test_kernel_mode_follows_the_cudnn_tf32_flag():
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        assert K.kernel_mode(torch.float32) == "tf32"
        torch.backends.cudnn.allow_tf32 = False
        assert K.kernel_mode(torch.float32) == "3xtf32"
        assert K.kernel_mode(torch.bfloat16) == "bf16"
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_cpu_tensors_launch_neither_kernel():
    x, k = _inputs((1, 2, 8, 8, 8), 8, 4)
    before = (dict(K.conv3d_fused_cuda.launches), K.conv3d_fused_simt_cuda.launches)
    out = K.conv3d_fused(torch.from_numpy(x), _w_flat(k))
    assert out.shape == (1, 2, 8, 8, 8)
    assert (K.conv3d_fused_cuda.launches, K.conv3d_fused_simt_cuda.launches) == before


def test_kernel_sources_list_their_headers():
    assert [p.name for p in build.sources("conv3d_wgmma")] == ["conv3d_wgmma.cu", "hopper.cuh"]
    assert [p.name for p in build.sources("conv3d_simt")] == ["conv3d_simt.cu"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define A 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    assert build.library_path("k") == first  # unchanged sources, same library
    (tmp_path / "b.cuh").write_text("#define A 2\n")  # a header two levels down
    second = build.library_path("k")
    assert second != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DX"])
    assert build.library_path("k") not in (first, second)
