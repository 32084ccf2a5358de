// Kernel K1: masked-Poisson pressure solve by conjugate gradient.
//
// Replaces the Pallas TPU kernels of safediffcon_tpu/ops/pressure_cg.py:
// `_make_kernel` + `_cg_pallas` (v1, data-dependent while loop in VMEM) and
// `_make_block_kernel` + `_cg_pallas_v2` (v2, fixed 32-iteration blocks under
// an outer convergence loop). It computes what they compute, not their block
// structure:
//   - one thread block per chunk of CHUNK = 8 samples; dot products and the
//     convergence test max|r| < accuracy are shared within the chunk;
//   - the CG recurrence of pressure_cg.py:68-75, warm-started as in :77-78;
//   - the test runs every `check_every` iterations: 1 reproduces v1, 32
//     reproduces v2 with its rounding of max_iter up to a multiple of 32
//     (v2 tests max|r| over the whole batch, this kernel per chunk, so for
//     B > 8 a chunk that converges early stops early);
//   - v2's safe divide (pressure_cg.py:153) in both modes: it differs from
//     v1 only where v1 would produce NaN.
// The 5-point stencil is applied on the fly from 5 coefficient planes on the
// 127 x 127 cell grid; neighbours outside the grid read as 0 (the planes are
// 0 there too). The TPU's 128-lane padding is not needed.
//
// What bounds it: each iteration is a chain of dependent passes over the
// chunk's x/m/Am/r state (4 x 8 x 127^2 f32 = 2 MB) separated by block-wide
// barriers and reductions, with ~25 flops per element. The state lives in
// global scratch that the wrapper allocates and stays resident in the 50 MB
// L2, so the kernel is bound by one SM's L2 bandwidth and barrier latency,
// not by HBM or flops. A chunk runs on one SM: at the serving batch (8-10
// samples) one or two SMs of 132 do all the work. Spreading a chunk over a
// thread-block cluster with its state in distributed shared memory, or
// keeping it in registers across more blocks, is the next design.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// Block-wide reduction of two values: a sum, and a sum or a max (of
// non-negative values). Every thread gets both results.
template <bool SECOND_IS_MAX>
__device__ __forceinline__ void block_reduce2(float& s, float& t, float* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    float u = __shfl_xor_sync(0xffffffffu, t, o);
    t = SECOND_IS_MAX ? fmaxf(t, u) : t + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's readers are done with sh
  if (lane == 0) {
    sh[warp] = s;
    sh[WARPS + warp] = t;
  }
  __syncthreads();
  if (warp == 0) {
    s = sh[lane];
    t = sh[WARPS + lane];
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      float u = __shfl_xor_sync(0xffffffffu, t, o);
      t = SECOND_IS_MAX ? fmaxf(t, u) : t + u;
    }
    if (lane == 0) {
      sh[2 * WARPS] = s;
      sh[2 * WARPS + 1] = t;
    }
  }
  __syncthreads();
  s = sh[2 * WARPS];
  t = sh[2 * WARPS + 1];
}

// (A p)[e] for element e = (sample, y, x) of a chunk-local field p.
__device__ __forceinline__ float apply_A(const float* p, int e, int y, int x, int n,
                                         const float* __restrict__ diag,
                                         const float* __restrict__ up_y,
                                         const float* __restrict__ lo_y,
                                         const float* __restrict__ up_x,
                                         const float* __restrict__ lo_x, int c) {
  float v = __ldg(diag + c) * p[e];
  if (y + 1 < n) v += __ldg(up_y + c) * p[e + n];
  if (y > 0) v += __ldg(lo_y + c) * p[e - n];
  if (x + 1 < n) v += __ldg(up_x + c) * p[e + 1];
  if (x > 0) v += __ldg(lo_x + c) * p[e - 1];
  return v;
}

__global__ void __launch_bounds__(THREADS)
pressure_cg_kernel(const float* __restrict__ div, const float* __restrict__ guess,
                   const float* __restrict__ planes, float* x, float* m, float* am,
                   float* r, int* iters, int batch, int n, float accuracy,
                   int max_iter, int check_every) {
  __shared__ float sh[2 * WARPS + 2];
  const int nn = n * n;
  const int first = blockIdx.x * CHUNK;
  const int count = min(CHUNK, batch - first);
  const int total = count * nn;
  const size_t base = (size_t)first * nn;
  const float* gd = div + base;
  const float* gg = guess + base;
  float* X = x + base;
  float* M = m + base;
  float* AM = am + base;
  float* R = r + base;
  const float* diag = planes;
  const float* up_y = planes + nn;
  const float* lo_y = planes + 2 * nn;
  const float* up_x = planes + 3 * nn;
  const float* lo_x = planes + 4 * nn;

  // warm start: x = guess, r = m = div - A guess
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int c = e % nn, y = c / n, xx = c % n;
    const float g = gg[e];
    const float res = gd[e] - apply_A(gg, e, y, xx, n, diag, up_y, lo_y, up_x, lo_x, c);
    X[e] = g;
    R[e] = res;
    M[e] = res;
  }
  __syncthreads();
  // Am = A m; the first iteration's m.Am and m.r; max|r| of the start
  float mam = 0.f, mr = 0.f, maxr = 0.f;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int c = e % nn, y = c / n, xx = c % n;
    const float v = apply_A(M, e, y, xx, n, diag, up_y, lo_y, up_x, lo_x, c);
    const float mv = M[e], rv = R[e];
    AM[e] = v;
    mam += mv * v;
    mr += mv * rv;
    maxr = fmaxf(maxr, fabsf(rv));
  }
  {
    float s = maxr, dummy = 0.f;
    block_reduce2<true>(dummy, s, sh);
    maxr = s;
  }
  block_reduce2<false>(mam, mr, sh);

  int it = 0;
  while (true) {
    if (it % check_every == 0 && !(maxr >= accuracy && it < max_iter)) break;
    const float inv = mam != 0.f ? 1.f / mam : 0.f;
    const float a = mr * inv;
    // x += a m; r -= a Am; r.Am and max|r| of the new residual
    float ram = 0.f;
    maxr = 0.f;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const float mv = M[e], av = AM[e];
      X[e] += a * mv;
      const float rv = R[e] - a * av;
      R[e] = rv;
      ram += rv * av;
      maxr = fmaxf(maxr, fabsf(rv));
    }
    block_reduce2<true>(ram, maxr, sh);
    const float b = -ram * inv;
    // m = r + b m
    for (int e = threadIdx.x; e < total; e += THREADS) M[e] = R[e] + b * M[e];
    __syncthreads();  // the stencil below reads neighbours' m
    // Am = A m; the next iteration's m.Am and m.r
    mam = 0.f;
    mr = 0.f;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int c = e % nn, y = c / n, xx = c % n;
      const float v = apply_A(M, e, y, xx, n, diag, up_y, lo_y, up_x, lo_x, c);
      const float mv = M[e];
      AM[e] = v;
      mam += mv * v;
      mr += mv * R[e];
    }
    block_reduce2<false>(mam, mr, sh);
    ++it;
  }
  if (threadIdx.x == 0) iters[blockIdx.x] = it;
}

}  // namespace

extern "C" int pressure_cg_launch(const float* div, const float* guess,
                                  const float* planes, float* x, float* m, float* am,
                                  float* r, int* iters, int batch, int n,
                                  float accuracy, int max_iter, int check_every,
                                  cudaStream_t stream) {
  const int chunks = (batch + CHUNK - 1) / CHUNK;
  pressure_cg_kernel<<<chunks, THREADS, 0, stream>>>(
      div, guess, planes, x, m, am, r, iters, batch, n, accuracy, max_iter,
      check_every);
  return (int)cudaGetLastError();
}
