// Kernel K2 on Hopper's tensor cores: fused stride-1 SAME 3x3x3 convolution
// on channels-last input, as a TMA-fed wgmma implicit GEMM.
//
// Replaces the Pallas TPU kernel of safediffcon_tpu/ops/conv3d_mxu.py:46
// (`_make_kernel`) + :73 (`_conv3d_fused_fwd`): one im2col matmul per frame
// with K = 27 * Cin, f32 accumulation, output in the input's dtype. It
// computes
//   out[b, f, h, w, o] = sum over (df, dh, dw, c) of
//       x[b, f + df - 1, h + dh - 1, w + dw - 1, c] * wk[o, (df, dh, dw), c]
// with wk the weight K-major, (Cout, 27, Cin), and voxels outside the volume
// read as 0. The backward pass (dx) is the same kernel on the cotangent with
// the flipped, channel-transposed weight, as the TPU kernel's custom_vjp.
//
// What bounds it: operations. A call does 2 * M * 27 * Cin * Cout flops
// (M = B*F*H*W voxels) on 4 (or 2) bytes per input and output element: at
// the UNet3D shapes 4.6e11 flops against 1.07 GB at (H, Cin, Cout) =
// (64, 64, 64), so the tensor cores' 495 TFLOP/s (TF32) or 989 (bf16) set
// the bound, not the 3.35 TB/s of HBM. What holds it back in practice is
// the traffic from L2 into shared memory: an implicit GEMM reads each input
// voxel once per tap it feeds. The halo tilings below cut that threefold for
// A (PERF.md has the bytes and times per shape).
//
// Design. An implicit GEMM with M = voxels, N = Cout, K = 27 * Cin, in K
// steps of one 128-byte chunk of channels (32 float32 or 64 bf16) for one
// tap, or for three taps that share one A box (the halo tilings).
// - A by TMA from a 5-D tensor map of x, (C, W, H, F, B) innermost first.
//   A block's 128 voxels are whole rows (128 / W rows of one frame) or whole
//   frames (128 / (H*W) of them), so a tap's A tile is one box at
//   (c0, w0 + dw - 1, h0 + dh - 1, f0 + df - 1, b). Tiled TMA fills
//   coordinates outside the tensor with zeros: that is the SAME border, with
//   no padded copy and no im2col buffer. A chunk past Cin (Cin = 16) is
//   zero-filled the same way. The box is widened by one voxel on each side
//   in w (W = 64: taps dw = 0, 1, 2 are 64-row windows one row apart) or in
//   h (W <= 32: taps dh are 128-row windows W rows apart); see `Tiling`.
// - B by TMA from a 3-D map of the K-major weight (Cin, 27, Cout), one box
//   per tap: wgmma's tf32 form takes both operands K-major only.
// - Both land as 128-byte rows with 128-byte swizzle, wgmma's canonical
//   K-major layout. A ring of STAGES (A, B) stages with full / empty
//   mbarriers: one producer thread issues the loads; two consumer
//   warpgroups (rows 0-63 and 64-127 of the tile) run
//   wgmma.mma_async m64nBNk8 (tf32) or m64nBNk16 (bf16), four per tap.
// - Each stage's products go to a fresh accumulator that is then added to
//   the running sum in registers. Summed inside the tensor cores over all of
//   K, the 3xTF32 error grew with K to near the 1e-4 tolerance at the
//   largest UNet3D K; with the per-stage sum it stays near 1e-6 of max|out|.
// - Precision modes, one pipeline:
//   TF32 (mode 0, float32 in, `torch.backends.cudnn.allow_tf32` True): one
//     pass on operands rounded to TF32 to nearest. The tensor map of x has
//     type TFLOAT32, so TMA rounds A to nearest as it lands, at no cost to
//     the consumers (rounding the landed tile in shared memory with
//     cvt.rna gave the same results, more slowly); the wrapper rounds the
//     weight. The tensor cores' own truncation of float32 operands would
//     roughly double the error against cuDNN's TF32.
//   3xTF32 (mode 1, the flag False): a = a_hi + a_lo with a_hi = rna(a),
//     and D += a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps float32-level
//     accuracy at a third of the TF32 rate. The wrapper splits the weight
//     once per call (it is small and the same for every block); the A tile
//     is split in shared memory after it lands (`prepare_stage`, overlapped
//     with the previous stage's products), so x is read from HBM once and
//     no split copy of it exists.
//   bf16 (mode 2): bf16 operands, one pass, f32 accumulation.
// - Epilogue: the f32 sums are written straight from registers in x's
//   dtype, two neighbouring channels per store, masked at Cout.
// Tiles: BM = 128 voxels x BN = 64 (Cout <= 64) or 128 channels; 384
// threads (two consumer warpgroups, one producer warpgroup); 2-6 stages in
// up to 220 KB of dynamic shared memory (`Cfg`). ptxas (nvcc 12.9,
// sm_90a, `-Xptxas -v` on this file): TF32 and bf16 77-80 registers at
// BN = 64 and 141-144 at BN = 128; 3xTF32 120-128 and 168, the most 384
// threads may hold; no spills.
//
// Interface: plain C, launched on the caller's stream; the tensor maps are
// encoded here with cuTensorMapEncodeTiled, taken from the driver through
// the runtime's entry-point query (no -lcuda). Returns cudaGetLastError(),
// or a negative code when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

enum Mode { TF32 = 0, TF32X3 = 1, BF16 = 2 };

constexpr int BM = 128;         // output voxels per block
constexpr int ROW_BYTES = 128;  // one K step: a 128-byte chunk of channels
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; warpgroup 2 loads
constexpr int CONSUMERS = 256;
constexpr int SMEM_BUDGET = 220 * 1024;

// How a K step's A box is cut into the taps' 128-row tiles:
// ONE: one box per tap, 128 voxels (whole rows or whole frames).
// W_HALO: two rows of W = 64 with w = -1 .. 64 (66 smem rows per image row);
//   tap dw of a K step (df, dh) is the window of warpgroup wg's 64 rows that
//   starts at row 66 wg + dw.
// H_HALO: 128 / W rows of W <= 32 with h0 - 1 .. h0 + 128 / W (128 + 2W smem
//   rows); tap dh of a K step (df, dw) is the 128-row window at row dh * W.
// Both halos load A once for three taps instead of three times.
enum Tiling { ONE = 0, W_HALO = 1, H_HALO = 2 };
constexpr int W_HALO_W = 64;
constexpr int H_HALO_MAX_W = 32;

template <int MODE, int BN, int TILING>
struct Cfg {
  static constexpr int TAPS = TILING == ONE ? 1 : 3;  // taps per K step
  // A rows the stage holds (the most TMA lands)
  static constexpr int A_ROWS =
      TILING == W_HALO ? 2 * (W_HALO_W + 2) : TILING == H_HALO ? BM + 2 * H_HALO_MAX_W : BM;
  static constexpr int A_BYTES = (A_ROWS * ROW_BYTES + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = TAPS * BN * ROW_BYTES;
  // stage: [A hi | B hi] and, for 3xTF32, [A lo | B lo]
  static constexpr int HALF = A_BYTES + B_BYTES;
  static constexpr int STAGE_BYTES = (MODE == TF32X3 ? 2 : 1) * HALF;
  static constexpr int STAGES = SMEM_BUDGET / STAGE_BYTES > 6 ? 6 : SMEM_BUDGET / STAGE_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment
  static constexpr uint32_t B_TX = (MODE == TF32X3 ? 2 : 1) * B_BYTES;
};

struct Geometry {
  int F, H, W;     // frames, rows, columns
  int Cout;        // output channels
  int c_chunks;    // 128-byte channel chunks per tap
  int n_tiles;     // BN-wide column tiles
  int a_rows;      // rows of the A box
};

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool both) {
  if (both) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool both) {
  if (both) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
  }
}

// Waits for stage k's tiles. For 3xTF32 the consumers then split A: they
// round it to TF32 in place and write the remainders at the same (swizzled)
// offsets of the stage's lo buffer. Each warpgroup splits the rows its own
// windows read (with H_HALO the windows of the two overlap, so both split
// the whole box together); a proxy fence and a barrier make the rows
// visible to the wgmma. In TF32 mode the TMA load itself rounds A to TF32.
template <int MODE, int TILING, typename C>
__device__ __forceinline__ void prepare_stage(uint8_t* smem, uint64_t* full, int k, int wg,
                                              int t, int a_rows) {
  mbar_wait(&full[k % C::STAGES], (k / C::STAGES) & 1);
  if constexpr (MODE == TF32X3) {
    constexpr bool SHARED = TILING == H_HALO;
    constexpr int THREADS_SPLIT = SHARED ? CONSUMERS : 128;
    const int rows = SHARED ? a_rows : a_rows / 2;
    const int chunks = rows * (ROW_BYTES / 16);
    const int first = SHARED ? t + 128 * wg : t;
    uint8_t* st = smem + (k % C::STAGES) * C::STAGE_BYTES + (SHARED ? 0 : wg * rows * ROW_BYTES);
    for (int idx = first; idx < chunks; idx += THREADS_SPLIT) {
      float4* hi_p = reinterpret_cast<float4*>(st + 16 * idx);
      const float4 v = *hi_p;
      const float4 hi = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
      *hi_p = hi;
      *reinterpret_cast<float4*>(st + C::HALF + 16 * idx) =
          make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
    }
    fence_proxy_async();
    if constexpr (SHARED) {
      named_bar_sync(1, CONSUMERS);
    } else {
      named_bar_sync(1 + wg, 128);
    }
  }
}

template <int MODE, int BN, int TILING, typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap_hi,
                    const __grid_constant__ CUtensorMap wmap_lo, T* __restrict__ out,
                    const Geometry g) {
  using C = Cfg<MODE, BN, TILING>;
  static_assert(C::STAGES >= 2, "the consumers prepare stage k + 1 before releasing stage k");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % g.n_tiles) * BN;
  const long long m0 = static_cast<long long>(blockIdx.x / g.n_tiles) * BM;
  const int steps = (27 / C::TAPS) * g.c_chunks;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread keeps the ring full
    if (tid == CONSUMERS) {
      const long long plane = static_cast<long long>(g.H) * g.W;
      const int h0 = static_cast<int>((m0 % plane) / g.W);
      const long long frame = m0 / plane;
      const int f0 = static_cast<int>(frame % g.F);
      const int b = static_cast<int>(frame / g.F);
      constexpr int CHUNK = ROW_BYTES / sizeof(T);
      for (int k = 0; k < steps; ++k) {
        const int s = k % C::STAGES;
        if (k >= C::STAGES) mbar_wait(&empty[s], ((k / C::STAGES) - 1) & 1);
        // the step's taps: one tap; (df, dh) and dw = j; (df, dw) and dh = j
        const int group = k / g.c_chunks;
        const int c0 = (k - group * g.c_chunks) * CHUNK;
        const int df = TILING == ONE ? group / 9 : group / 3;
        const int dh = TILING == ONE ? (group / 3) % 3 : TILING == W_HALO ? group % 3 : 0;
        const int dw = TILING == ONE ? group % 3 : TILING == H_HALO ? group % 3 : 0;
        uint8_t* st = smem + s * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], g.a_rows * ROW_BYTES + C::B_TX);
        tma_load_5d(st, &xmap, &full[s], c0, dw - 1, h0 + dh - 1, f0 + df - 1, b);
#pragma unroll
        for (int j = 0; j < C::TAPS; ++j) {
          const int tap = 9 * df + 3 * (TILING == H_HALO ? j : dh) + (TILING == W_HALO ? j : dw);
          uint8_t* b_tile = st + C::A_BYTES + j * BN * ROW_BYTES;
          tma_load_3d(b_tile, &wmap_hi, &full[s], c0, tap, n0);
          if constexpr (MODE == TF32X3) {
            tma_load_3d(b_tile + C::HALF, &wmap_lo, &full[s], c0, tap, n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid / 128;
  const int t = tid % 128;
  float acc[BN / 2];   // the running sum, added in registers (round to nearest)
  float part[BN / 2];  // one stage's products, summed by the tensor cores
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  prepare_stage<MODE, TILING, C>(smem, full, 0, wg, t, g.a_rows);
  for (int k = 0; k < steps; ++k) {
    uint8_t* st = smem + (k % C::STAGES) * C::STAGE_BYTES;
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < C::TAPS; ++j) {
      // this warpgroup's 64-row window for the step's tap j. Both TMA and
      // wgmma swizzle by absolute shared-memory address bits, so a window
      // that starts off an 8-row atom needs no base offset in its descriptor.
      const int row = TILING == W_HALO ? wg * (W_HALO_W + 2) + j
                      : TILING == H_HALO ? j * g.W + wg * 64
                                         : wg * 64;
      const uint64_t da = sw128_desc(st + row * ROW_BYTES);
      const uint64_t da_lo = sw128_desc(st + C::HALF + row * ROW_BYTES);
      const uint64_t db = sw128_desc(st + C::A_BYTES + j * BN * ROW_BYTES);
      const uint64_t db_lo = sw128_desc(st + C::HALF + C::A_BYTES + j * BN * ROW_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int keep = j + kk > 0 ? 1 : 0;  // the stage's first product overwrites part
        if constexpr (MODE == BF16) {
          mma_bf16<BN>(part, da + 2 * kk, db + 2 * kk, keep);
        } else if constexpr (MODE == TF32) {
          mma_tf32<BN>(part, da + 2 * kk, db + 2 * kk, keep);
        } else {
          mma_tf32<BN>(part, da_lo + 2 * kk, db + 2 * kk, keep);
          mma_tf32<BN>(part, da + 2 * kk, db_lo + 2 * kk, 1);
          mma_tf32<BN>(part, da + 2 * kk, db + 2 * kk, 1);
        }
      }
    }
    wgmma_commit();
    fence_operands(part);
    // the next stage's tile is split while these products run
    if (k + 1 < steps) prepare_stage<MODE, TILING, C>(smem, full, k + 1, wg, t, g.a_rows);
    wgmma_wait<0>();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    mbar_arrive(&empty[k % C::STAGES]);
  }

  const int warp = t / 32, lane = t % 32;
  T* o = out + (m0 + wg * 64 + warp * 16 + lane / 4) * g.Cout;
  // an even Cout keeps each (n, n + 1) pair in range and 2-element aligned
  const bool pairs = (g.Cout % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n < g.Cout) {
      store2(o + n, acc[4 * j], acc[4 * j + 1], pairs);
      store2(o + 8 * g.Cout + n, acc[4 * j + 2], acc[4 * j + 3], pairs);
      if (!pairs && n + 1 < g.Cout) {
        store2(o + n + 1, acc[4 * j + 1], 0.0f, false);
        store2(o + 8 * g.Cout + n + 1, acc[4 * j + 3], 0.0f, false);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int MODE, int BN, int TILING, typename T>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& whi, const CUtensorMap& wlo,
                   void* out, const Geometry& g, long long m_tiles, cudaStream_t stream) {
  using C = Cfg<MODE, BN, TILING>;
  auto kernel = conv3d_wgmma_kernel<MODE, BN, TILING, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(m_tiles * g.n_tiles);
  kernel<<<blocks, THREADS, C::SMEM, stream>>>(xmap, whi, wlo, static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <int MODE, int BN, typename T>
cudaError_t launch_tiling(const CUtensorMap& xmap, const CUtensorMap& whi,
                          const CUtensorMap& wlo, void* out, const Geometry& g, int tiling,
                          long long m_tiles, cudaStream_t stream) {
  if constexpr (Cfg<MODE, BN, W_HALO>::STAGES >= 2) {
    if (tiling == W_HALO) return launch<MODE, BN, W_HALO, T>(xmap, whi, wlo, out, g, m_tiles, stream);
  }
  if constexpr (Cfg<MODE, BN, H_HALO>::STAGES >= 2) {
    if (tiling == H_HALO) return launch<MODE, BN, H_HALO, T>(xmap, whi, wlo, out, g, m_tiles, stream);
  }
  return launch<MODE, BN, ONE, T>(xmap, whi, wlo, out, g, m_tiles, stream);
}

// the tiling for this shape: a halo where the ring still holds two stages
template <int MODE, int BN>
int choose_tiling(int W, int tf) {
  if (tf == 1 && W == W_HALO_W && Cfg<MODE, BN, W_HALO>::STAGES >= 2) return W_HALO;
  if (tf == 1 && W <= H_HALO_MAX_W && Cfg<MODE, BN, H_HALO>::STAGES >= 2) return H_HALO;
  return ONE;
}

}  // namespace

// x: (B, F, H, W, C) contiguous, 16-byte aligned; w_hi, w_lo: the weight
// K-major, (Cout, 27, C) contiguous (w_lo: the 3xTF32 remainders, else
// unused and may be null); out: (B, F, H, W, Cout) contiguous, x's dtype.
// mode 0 = TF32, 1 = 3xTF32 (both float32), 2 = bf16. (th, tf) = rows and
// frames of one 128-voxel tile: th * tf * W = 128, with H % th = 0 and
// F % tf = 0 (tf > 1 only when th = H). C * element size must be a multiple
// of 16 bytes. The wrapper chooses the shapes this kernel takes.
extern "C" int conv3d_wgmma_launch(const void* x, const void* w_hi, const void* w_lo, void* out,
                                   int B, int F, int H, int W, int C, int Cout, int th, int tf,
                                   int mode, void* stream) {
  if (th * tf * W != BM || H % th != 0 || F % tf != 0 || (tf > 1 && th != H) || mode < 0 ||
      mode > 2 || (mode == 1 && w_lo == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  const int bn = Cout <= 64 ? 64 : 128;
  int tiling;
  if (mode == TF32) {
    tiling = bn == 64 ? choose_tiling<TF32, 64>(W, tf) : choose_tiling<TF32, 128>(W, tf);
  } else if (mode == TF32X3) {
    tiling = bn == 64 ? choose_tiling<TF32X3, 64>(W, tf) : choose_tiling<TF32X3, 128>(W, tf);
  } else {
    tiling = bn == 64 ? choose_tiling<BF16, 64>(W, tf) : choose_tiling<BF16, 128>(W, tf);
  }
  const bool bf16 = mode == BF16;
  const cuuint64_t es = bf16 ? 2 : 4;
  const CUtensorMapDataType dtype =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // TF32 mode: TMA rounds x to TF32 as it lands (the weight comes rounded)
  const CUtensorMapDataType xdtype = mode == TF32 ? CU_TENSOR_MAP_DATA_TYPE_TFLOAT32 : dtype;
  const cuuint32_t chunk = static_cast<cuuint32_t>(ROW_BYTES / es);
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};

  CUtensorMap xmap, whi, wlo;
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)F,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[4] = {C * es, (cuuint64_t)W * C * es, (cuuint64_t)H * W * C * es,
                                  (cuuint64_t)F * H * W * C * es};
  const cuuint32_t xbox[5] = {chunk, (cuuint32_t)(tiling == W_HALO ? W + 2 : W),
                              (cuuint32_t)(tiling == H_HALO ? th + 2 : th), (cuuint32_t)tf, 1};
  if (encode(&xmap, xdtype, 5, const_cast<void*>(x), xdims, xstrides, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return -2;
  }
  const cuuint64_t wdims[3] = {(cuuint64_t)C, 27, (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {C * es, 27 * C * es};
  const cuuint32_t wbox[3] = {chunk, 1, (cuuint32_t)bn};
  const void* wsrc[2] = {w_hi, mode == TF32X3 ? w_lo : w_hi};
  CUtensorMap* wmaps[2] = {&whi, &wlo};
  for (int i = 0; i < 2; ++i) {
    if (encode(wmaps[i], dtype, 3, const_cast<void*>(wsrc[i]), wdims, wstrides, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -3;
    }
  }

  Geometry g;
  g.F = F;
  g.H = H;
  g.W = W;
  g.Cout = Cout;
  g.c_chunks = (int)((C + chunk - 1) / chunk);
  g.n_tiles = (Cout + bn - 1) / bn;
  g.a_rows = xbox[1] * xbox[2] * xbox[3];
  const long long m_tiles = static_cast<long long>(B) * F * H * W / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == TF32) {
    err = bn == 64 ? launch_tiling<TF32, 64, float>(xmap, whi, wlo, out, g, tiling, m_tiles, s)
                   : launch_tiling<TF32, 128, float>(xmap, whi, wlo, out, g, tiling, m_tiles, s);
  } else if (mode == TF32X3) {
    err = bn == 64 ? launch_tiling<TF32X3, 64, float>(xmap, whi, wlo, out, g, tiling, m_tiles, s)
                   : launch_tiling<TF32X3, 128, float>(xmap, whi, wlo, out, g, tiling, m_tiles, s);
  } else {
    err = bn == 64
              ? launch_tiling<BF16, 64, __nv_bfloat16>(xmap, whi, wlo, out, g, tiling, m_tiles, s)
              : launch_tiling<BF16, 128, __nv_bfloat16>(xmap, whi, wlo, out, g, tiling, m_tiles, s);
  }
  return static_cast<int>(err);
}
