// Kernel K2, SIMT form: fused stride-1 SAME 3x3x3 convolution on
// channels-last input with float32 FMAs on the CUDA cores. The tensor-core
// kernel (conv3d_wgmma.cu) runs every shape of the UNet3D; the wrapper
// (ops/conv3d_mxu.py::wgmma_tile) sends here, by a test of the shape alone,
// what that kernel does not take: W > 128 or not a divisor of 128, H or F
// that do not split into its 128-voxel tiles, or Cin * element size not a
// multiple of 16 bytes.
//
// Replaces the Pallas TPU kernel of safediffcon_tpu/ops/conv3d_mxu.py:
// `_make_kernel` + `_conv3d_fused_fwd` (one im2col matmul per frame with
// K = 27 * Cin, f32 accumulation, output in the input's dtype). It computes
// what that kernel computes, not its block structure:
//   out[b, f, h, w, o] = sum over (df, dh, dw, c) of
//       x[b, f + df - 1, h + dh - 1, w + dw - 1, c] * wf[(df, dh, dw, c), o]
// with wf the (27 * Cin, Cout) weight flattened in the (df, dh, dw, c) order
// of `_flatten_kernel`, and input voxels outside the volume read as 0. The
// backward pass (dx) calls the same kernel on the cotangent with the
// flipped, channel-transposed weight, as the TPU kernel's custom_vjp does.
//
// Design: an implicit GEMM. M = B*F*H*W output voxels, N = Cout, K = 27*Cin.
// Each block of 256 threads owns a tile of BM = 128 voxels x BN = 64 or 128
// output channels and walks K in steps of BK = 16 channels of one tap. Per
// step it gathers the A tile straight from x (the 27 shifted views are
// never materialised; each voxel's in-bounds taps are a 27-bit mask computed
// once, which is how the SAME border is masked without the padded copy that
// the JAX wrapper makes in HBM) and the B tile from wf into shared memory,
// converting bf16 to f32 on the way. The next step's global loads are issued
// into registers before the current step's products, so their latency hides
// behind the arithmetic. Each thread accumulates an 8 x 4 (BN 64) or 8 x 8
// (BN 128) tile in f32 registers; the output is written once, in the input's
// dtype.
//
// What bounds it: operations. At the UNet3D shapes a call does 2*M*K*N flops
// against a few bytes per flop at most (the (64, 64, 64) case: 4.6e11 flops,
// 1.07 GB in and out), so the card's arithmetic rate is the limit. This
// first version does the products as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (495 TF32, 989 bf16), because a TF32
// product would not hold the f32 results to the tolerance the port keeps
// against the plain version. Register tiling (8 x 4 or 8 x 8 outputs per
// thread from two or three 16-byte shared loads per k) keeps the FMA pipes
// fed.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output voxels per block
constexpr int BK = 16;        // input channels per K step (within one tap)
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int APAD = 4;       // shared-memory row padding of the A tile
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 8
constexpr int A_ROW_STEP = THREADS / BK;         // 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
conv3d_fused_kernel(const T* __restrict__ x, const T* __restrict__ wf, T* __restrict__ out,
                    int M, int F, int H, int W, int C, int Cout) {
  constexpr int TN = BN / 16;                      // output channels per thread: 4 or 8
  constexpr int B_PER_THREAD = BK * BN / THREADS;  // 4 or 8
  constexpr int B_ROW_STEP = THREADS / BN;         // 4 or 2

  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: channel a_k of rows a_row + 16 i. Each row's in-bounds taps
  // as a 27-bit mask (tap = (df * 3 + dh) * 3 + dw).
  const int a_k = tid % BK;
  const int a_row = tid / BK;
  int a_m[A_PER_THREAD];
  unsigned a_taps[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int m = m0 + a_row + A_ROW_STEP * i;
    a_m[i] = m;
    unsigned taps = 0;
    if (m < M) {
      const int w_ = m % W;
      const int h_ = (m / W) % H;
      const int f_ = (m / (W * H)) % F;
      const unsigned fok = (f_ > 0 ? 1u : 0u) | 2u | (f_ < F - 1 ? 4u : 0u);
      const unsigned hok = (h_ > 0 ? 1u : 0u) | 2u | (h_ < H - 1 ? 4u : 0u);
      const unsigned wok = (w_ > 0 ? 1u : 0u) | 2u | (w_ < W - 1 ? 4u : 0u);
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        const int df = t / 9, dh = (t / 3) % 3, dw = t % 3;
        if (((fok >> df) & (hok >> dh) & (wok >> dw) & 1u) != 0u) taps |= 1u << t;
      }
    }
    a_taps[i] = taps;
  }
  // B loader: column b_n of rows b_k + B_ROW_STEP j
  const int b_n = tid % BN;
  const int b_k = tid / BN;

  const int c_steps = (C + BK - 1) / BK;
  const int steps = 27 * c_steps;
  float ra[A_PER_THREAD];
  float rb[B_PER_THREAD];

  auto load = [&](int s) {
    const int tap = s / c_steps;
    const int c0 = (s - tap * c_steps) * BK;
    const int df = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
    const int off = ((df - 1) * H + (dh - 1)) * W + (dw - 1);  // voxel offset of the tap
    const int c = c0 + a_k;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const bool ok = ((a_taps[i] >> tap) & 1u) != 0u && c < C;
      ra[i] = ok ? to_f32(x[(long long)(a_m[i] + off) * C + c]) : 0.0f;
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) {
      const int cc = c0 + b_k + B_ROW_STEP * j;
      const bool ok = cc < C && n < Cout;
      rb[j] = ok ? to_f32(wf[((long long)tap * C + cc) * Cout + n]) : 0.0f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) As[a_k][a_row + A_ROW_STEP * i] = ra[i];
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) Bs[b_k + B_ROW_STEP * j][b_n] = rb[j];
  };

  // compute layout: thread (tx, ty) owns rows {ty*4 + r, 64 + ty*4 + r} and
  // columns {tx*4 + c} (+ {64 + tx*4 + c} when BN = 128)
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][TN];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  load(0);
  stash();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);  // in flight during the products below
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
    if (s + 1 < steps) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4);
      if (n < Cout) store_as(&out[(long long)m * Cout + n], acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wf, void* out, int M, int F, int H, int W, int C,
                   int Cout, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wf);
  T* op = static_cast<T*>(out);
  const unsigned gm = (unsigned)((M + BM - 1) / BM);
  if (Cout > 64) {
    dim3 grid(gm, (unsigned)((Cout + 127) / 128));
    conv3d_fused_kernel<T, 128><<<grid, THREADS, 0, stream>>>(xp, wp, op, M, F, H, W, C, Cout);
  } else {
    dim3 grid(gm, 1);
    conv3d_fused_kernel<T, 64><<<grid, THREADS, 0, stream>>>(xp, wp, op, M, F, H, W, C, Cout);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (B, F, H, W, C) contiguous; wf: (27 * C, Cout) contiguous, same dtype;
// out: (B, F, H, W, Cout) contiguous, same dtype. dtype 0 = float32,
// 1 = bfloat16. B * F * H * W must be below 2^31 (the wrapper checks).
extern "C" int conv3d_fused_launch(const void* x, const void* wf, void* out, int B, int F, int H,
                                   int W, int C, int Cout, int dtype, void* stream) {
  const int M = B * F * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, wf, out, M, F, H, W, C, Cout, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, wf, out, M, F, H, W, C, Cout, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
