// Kernel K1: masked-Poisson pressure solve by conjugate gradient, one
// thread-block cluster per chunk of 8 samples, its whole CG state on chip.
//
// Replaces the Pallas TPU kernels of safediffcon_tpu/ops/pressure_cg.py:
// `_make_kernel` + `_cg_pallas` (:42, v1, data-dependent while loop in VMEM)
// and `_make_block_kernel` + `_cg_pallas_v2` (:119, v2, fixed 32-iteration
// blocks under an outer convergence loop). It computes what they compute,
// not their block structure:
//   - dot products and the convergence test max|r| < accuracy are shared
//     within a chunk of CHUNK = 8 samples;
//   - the CG recurrence of pressure_cg.py:68-75, warm-started as in :77-78;
//   - the test runs every `check_every` iterations: 1 reproduces v1, 32
//     reproduces v2 with its rounding of max_iter up to a multiple of 32
//     (v2 tests max|r| over the whole batch, this kernel per chunk, so for
//     B > 8 a chunk that converges early stops early);
//   - v2's safe divide (pressure_cg.py:153) in both modes: it differs from
//     v1 only where v1 would produce NaN.
// The 5-point stencil is applied on the fly from 5 coefficient planes on the
// n x n cell grid (n <= 128); neighbours outside the grid read as 0.
//
// Layout (chosen by the wrapper, ops/pressure_cg.py `cluster_layout`). A
// chunk runs on one cluster of `ranks` = ceil(n / ROWS) blocks (16 at
// n = 127, a non-portable cluster size). Block `rank` owns the band of rows
// [rank * ROWS, rank * ROWS + ROWS) of all 8 samples; rows and columns past
// n hold zeros (zero planes, zero data) that stay zero. Thread (row, col) =
// (tid / 128, tid % 128) owns one cell of the band in every sample: x, r, m
// and Am of its 8 cells and the cell's 5 stencil coefficients live in
// registers for the whole solve. m is also written to shared memory, where
// the stencil reads the row and column neighbours inside the band. Global
// memory is read once at the start (div, guess, planes) and written once at
// the end (x, the iteration count).
//
// One iteration:
//   (a) x += a m, r -= a Am, block partials of r.Am and max|r| -> sum R1 -> b;
//   (b) m = r + b m; the band's first and last rows go to the neighbouring
//       blocks' halo buffers -> block barrier, halo wait;
//   (c) Am = A m, block partials of m.Am and m.r -> sum R3 -> a, the test.
// Blocks exchange data only by pushing it into each other's shared memory
// with st.async, which counts the bytes on an mbarrier in the receiving
// block: the receiver waits for its own mbarrier, and no cluster-wide
// barrier or memory fence is on the per-iteration path. A cluster sum (R1,
// R3) reduces in-block (warp shuffles, then warp 0 over the 32 warps); warp
// 0 stores the block's partials into its rank's slot in every block, and
// every warp of every block then reads its own block's slots, lane l rank
// l's, and sums them by the same xor butterfly. Every thread of the cluster
// thus gets the same bits for a, b and the test, and all leave the loop at
// the same iteration. R1 and R3 use separate slots and mbarriers. No block
// can write a slot or halo buffer of iteration i + 1 before the receiver
// has read those of iteration i: writing them needs the receiver's own
// next partial, which it sends only after a block barrier that follows
// those reads. A first cluster barrier makes sure every block has started
// and initialised its mbarriers before any store reaches it; a last one
// keeps every block alive until all stores have landed.
//
// What bounds it: per iteration each thread does ~25 flops on each of its
// 8 cells and ~5 shared-memory accesses per cell; the rest is latency: two
// cluster sums and one halo exchange (each a round of DSMEM stores and an
// mbarrier wait) and three block barriers, all on the critical path of a
// recurrence that cannot overlap one iteration with the next. Not L2 or HBM
// bandwidth (the state never leaves the SMs), not flops.
//
// Registers and shared memory (a one-off `nvcc -Xptxas -v` build of this
// file with ops/build.py's flags, CUDA 12.8): 64 registers, the cap of a
// 1024-thread block, with 36 bytes of spill stores and 20 of spill loads,
// and SMEM_BYTES = 41,880 bytes of dynamic shared memory. One block per SM.
//
// Interface: plain C, launched on the caller's stream with
// cudaLaunchKernelEx and a cluster-dimension attribute; the kernel allocates
// nothing, and the launch returns cudaGetLastError() so the wrapper can raise
// on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using hopper::smem_addr;

namespace {

constexpr int CHUNK = 8;                // samples per cluster
constexpr int COLS = 128;               // threads across a band row
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = THREADS / COLS;    // grid rows per block, one per thread row
constexpr int MAX_CLUSTER = 16;         // Hopper's largest (non-portable) cluster

// Dynamic shared memory of one block, offsets in floats: m of the band
// [CHUNK][ROWS][COLS]; two sets of MAX_CLUSTER slots of the ranks' 3
// partials (padded to 4); the rows just below and above the band
// [COLS][CHUNK] each; the per-warp partials [WARPS][3]; three mbarriers.
constexpr int SLOTS = CHUNK * ROWS * COLS;
constexpr int HALO = SLOTS + 2 * 4 * MAX_CLUSTER;
constexpr int RED = HALO + 2 * COLS * CHUNK;
constexpr int BARS = RED + 3 * WARPS;
constexpr int SMEM_BYTES = 4 * BARS + 3 * 8;

// Two sums and the max of non-negative values across the warp; every lane
// gets the same bits (each step adds the same two operands, commuted).
__device__ __forceinline__ void warp_reduce(float& s0, float& s1, float& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// One cluster sum: where this block's partials go and where they are read.
struct ClusterSum {
  float4* slots;     // this block's slots, one per rank
  uint64_t* bar;     // counts the 16 bytes of every rank
  uint32_t dst;      // warp 0, lane l: this rank's slot in block l
  uint32_t dst_bar;  // warp 0, lane l: block l's mbarrier
  uint32_t phase;
};

// (s0, s1, mx) summed / maxed over the whole cluster; every thread of every
// block gets the same bits.
__device__ __forceinline__ void cluster_reduce(float& s0, float& s1, float& mx, float* red,
                                               ClusterSum& sum, int ranks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_reduce(s0, s1, mx);
  if (lane == 0) {
    red[3 * warp] = s0;
    red[3 * warp + 1] = s1;
    red[3 * warp + 2] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    s0 = red[3 * lane];
    s1 = red[3 * lane + 1];
    mx = red[3 * lane + 2];
    warp_reduce(s0, s1, mx);
    if (lane < ranks) hopper::st_async_v4(sum.dst, s0, s1, mx, 0.f, sum.dst_bar);
    if (lane == 0) hopper::mbar_arrive_expect_tx(sum.bar, 16 * ranks);
  }
  hopper::mbar_wait_cluster(sum.bar, sum.phase);
  sum.phase ^= 1;
  const float4 p = lane < ranks ? sum.slots[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
  s0 = p.x;
  s1 = p.y;
  mx = p.z;
  warp_reduce(s0, s1, mx);
}

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The shared memory of one block, where its neighbours' copies are, and the
// exchanges with them.
struct Block {
  float* sm_m;        // [CHUNK][ROWS][COLS]
  float* halo_below;  // [COLS][CHUNK]: row rank * ROWS - 1, from rank - 1
  float* halo_above;  // [COLS][CHUNK]: row (rank + 1) * ROWS, from rank + 1
  float* red;
  uint64_t* halo_bar;
  ClusterSum sum_a, sum_c;
  bool sends_halo = false;  // edge threads with a neighbour on their side
  uint32_t halo_dst = 0, halo_dst_bar = 0;  // ... its halo buffer and mbarrier
  uint32_t halo_bytes, halo_phase = 0;
  int rank, ranks, row, col;

  __device__ Block(int rank_, int ranks_) : rank(rank_), ranks(ranks_) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    sm_m = smem;
    halo_below = smem + HALO;
    halo_above = halo_below + COLS * CHUNK;
    red = smem + RED;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BARS);
    halo_bar = bars + 2;
    row = threadIdx.x / COLS;
    col = threadIdx.x % COLS;
    const int lane = threadIdx.x & 31;
    const uint32_t peer = lane < ranks ? lane : 0;
    float4* slots = reinterpret_cast<float4*>(smem + SLOTS);
    sum_a = {slots, bars, hopper::map_rank(smem_addr(slots + rank), peer),
             hopper::map_rank(smem_addr(bars), peer), 0};
    sum_c = {slots + MAX_CLUSTER, bars + 1,
             hopper::map_rank(smem_addr(slots + MAX_CLUSTER + rank), peer),
             hopper::map_rank(smem_addr(bars + 1), peer), 0};
    // row 0 of the band is the row above rank - 1's band; the last row is
    // the row below rank + 1's
    if (row == 0 && rank > 0) {
      sends_halo = true;
      halo_dst = hopper::map_rank(smem_addr(halo_above + col * CHUNK), rank - 1);
      halo_dst_bar = hopper::map_rank(smem_addr(halo_bar), rank - 1);
    }
    if (row == ROWS - 1 && rank + 1 < ranks) {
      sends_halo = true;
      halo_dst = hopper::map_rank(smem_addr(halo_below + col * CHUNK), rank + 1);
      halo_dst_bar = hopper::map_rank(smem_addr(halo_bar), rank + 1);
    }
    halo_bytes = 4 * COLS * CHUNK * ((rank > 0) + (rank + 1 < ranks));
    if (threadIdx.x == 0) {
      hopper::mbar_init(bars, 1);
      hopper::mbar_init(bars + 1, 1);
      hopper::mbar_init(halo_bar, 1);
      hopper::fence_mbar_init();
    }
  }

  // Sends the band's edge rows of m (8 samples each) to the neighbours: the
  // first row (threads of row 0) down a rank, the last (row ROWS - 1) up a
  // rank. Then m of the block is visible to all its threads, and the edge
  // threads have their neighbours' rows.
  __device__ __forceinline__ void exchange_halo(const float (&m)[CHUNK]) {
    if (sends_halo) {
      hopper::st_async_v4(halo_dst, m[0], m[1], m[2], m[3], halo_dst_bar);
      hopper::st_async_v4(halo_dst + 16, m[4], m[5], m[6], m[7], halo_dst_bar);
    }
    if (threadIdx.x == 0) hopper::mbar_arrive_expect_tx(halo_bar, halo_bytes);
    __syncthreads();
    if (row == 0 || row == ROWS - 1) hopper::mbar_wait_cluster(halo_bar, halo_phase);
    halo_phase ^= 1;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
pressure_cg_kernel(const float* __restrict__ div, const float* __restrict__ guess,
                   const float* __restrict__ planes, float* __restrict__ x_out,
                   int* __restrict__ iters, int batch, int n, float accuracy, int max_iter,
                   int check_every) {
  cg::cluster_group cluster = cg::this_cluster();
  Block blk((int)cluster.block_rank(), (int)cluster.num_blocks());
  const int rank = blk.rank, ranks = blk.ranks, col = blk.col, j = blk.row;
  float* sm_m = blk.sm_m;
  const int chunk = blockIdx.x / ranks;
  const int first = chunk * CHUNK;
  const int count = min(CHUNK, batch - first);
  const int nn = n * n;
  const size_t base = (size_t)first * nn;
  const int y = rank * ROWS + j;
  const bool cell = y < n && col < n;
  const int c = y * n + col;

  float pl[5];
  float x[CHUNK], r[CHUNK], m[CHUNK], am[CHUNK];

  // warm start: x = guess, r = m = div - A guess (guess read from global)
#pragma unroll
  for (int k = 0; k < 5; ++k) pl[k] = cell ? __ldg(planes + k * nn + c) : 0.f;
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) {
    float g = 0.f, res = 0.f;
    if (cell && s < count) {
      const float* gs = guess + base + (size_t)s * nn;
      g = __ldg(gs + c);
      float ag = pl[0] * g;
      if (y + 1 < n) ag += pl[1] * __ldg(gs + c + n);
      if (y > 0) ag += pl[2] * __ldg(gs + c - n);
      if (col + 1 < n) ag += pl[3] * __ldg(gs + c + 1);
      if (col > 0) ag += pl[4] * __ldg(gs + c - 1);
      res = __ldg(div + base + (size_t)s * nn + c) - ag;
    }
    x[s] = g;
    r[s] = res;
    m[s] = res;
    sm_m[(s * ROWS + j) * COLS + col] = res;
  }
  // every block has started and initialised its mbarriers before any
  // DSMEM store reaches it
  cluster.sync();

  // Am = A m from registers (centre), this band's shared m (row and column
  // neighbours) and the halo rows; adds the block's share of m.Am and m.r
  auto stencil = [&](float& mam, float& mr) {
    const float4* below = reinterpret_cast<const float4*>(blk.halo_below + col * CHUNK);
    const float4* above = reinterpret_cast<const float4*>(blk.halo_above + col * CHUNK);
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const int i = (s * ROWS + j) * COLS + col;
      float up, down;
      if (j + 1 < ROWS)
        up = sm_m[i + COLS];
      else
        up = rank + 1 < ranks ? component(above[s / 4], s % 4) : 0.f;
      if (j > 0)
        down = sm_m[i - COLS];
      else
        down = rank > 0 ? component(below[s / 4], s % 4) : 0.f;
      const float right = col + 1 < COLS ? sm_m[i + 1] : 0.f;
      const float left = col > 0 ? sm_m[i - 1] : 0.f;
      const float v = pl[0] * m[s] + pl[1] * up + pl[2] * down + pl[3] * right + pl[4] * left;
      am[s] = v;
      mam += m[s] * v;
      mr += m[s] * r[s];
    }
  };

  blk.exchange_halo(m);
  float mam = 0.f, mr = 0.f, maxr = 0.f;
  stencil(mam, mr);
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) maxr = fmaxf(maxr, fabsf(r[s]));
  cluster_reduce(mam, mr, maxr, blk.red, blk.sum_c, ranks);

  int it = 0;
  while (true) {
    if (it % check_every == 0 && !(maxr >= accuracy && it < max_iter)) break;
    const float inv = mam != 0.f ? 1.f / mam : 0.f;
    const float a = mr * inv;
    // (a) x += a m; r -= a Am; r.Am and max|r| of the new residual
    float ram = 0.f, unused = 0.f;
    maxr = 0.f;
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      x[s] += a * m[s];
      r[s] -= a * am[s];
      ram += r[s] * am[s];
      maxr = fmaxf(maxr, fabsf(r[s]));
    }
    cluster_reduce(ram, unused, maxr, blk.red, blk.sum_a, ranks);  // R1
    const float b = -ram * inv;
    // (b) m = r + b m; the block's last reads of the old m came before R1
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      m[s] = r[s] + b * m[s];
      sm_m[(s * ROWS + j) * COLS + col] = m[s];
    }
    blk.exchange_halo(m);
    // (c) Am = A m; the next iteration's m.Am and m.r
    mam = 0.f;
    mr = 0.f;
    stencil(mam, mr);
    unused = 0.f;
    cluster_reduce(mam, mr, unused, blk.red, blk.sum_c, ranks);  // R3
    ++it;
  }
  cluster.sync();  // no block leaves before every store into it has landed

  if (cell) {
#pragma unroll
    for (int s = 0; s < CHUNK; ++s)
      if (s < count) x_out[base + (size_t)s * nn + c] = x[s];
  }
  if (rank == 0 && threadIdx.x == 0) iters[chunk] = it;
}

// The kernel's function attributes, set once per process and device: a
// cluster of up to 16 blocks, and the opt-in maximum of dynamic shared
// memory (a launch asks for its own smem_bytes within it).
cudaError_t prepare() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pressure_cg_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pressure_cg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

// Whether the kernel can run this layout safely: every row owned by a
// block, no more ranks than the cluster sums have slots, and at least the
// shared memory the kernel addresses.
bool runnable(int n, int cluster, int smem_bytes) {
  return n >= 1 && n <= COLS && cluster >= 1 && cluster <= MAX_CLUSTER && cluster * ROWS >= n &&
         smem_bytes >= SMEM_BYTES;
}

cudaLaunchConfig_t cluster_config(int blocks, int smem_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Solve for `batch` samples of n x n: one cluster of `cluster` blocks per
// chunk of 8 samples, each block with `smem_bytes` of dynamic shared memory.
extern "C" int pressure_cg_launch(const float* div, const float* guess, const float* planes,
                                  float* x, int* iters, int batch, int n, float accuracy,
                                  int max_iter, int check_every, int cluster, int smem_bytes,
                                  cudaStream_t stream) {
  if (batch < 1 || check_every < 1 || !runnable(n, cluster, smem_bytes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (batch + CHUNK - 1) / CHUNK;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(chunks * cluster, smem_bytes, stream, &attr, cluster);
  err = cudaLaunchKernelEx(&cfg, pressure_cg_kernel, div, guess, planes, x, iters, batch, n,
                           accuracy, max_iter, check_every);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks with `smem_bytes` each the card runs
// at once (cudaOccupancyMaxActiveClusters); chunks beyond it wait for a free
// cluster.
extern "C" int pressure_cg_max_active_clusters(int n, int cluster, int smem_bytes, int* out) {
  if (!runnable(n, cluster, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, smem_bytes, nullptr, &attr, cluster);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)pressure_cg_kernel, &cfg);
}
