// The synchronisation of one iteration of kernel K1 alone, for
// tools/k1_sync_floor.py: the two cluster sums and the halo exchange of
// safediffcon_torch/csrc/pressure_cg.cu, with no field work. Built from the
// kernel's own source, so it times the kernel's own protocol.

#include "../safediffcon_torch/csrc/pressure_cg.cu"

namespace {

__global__ void __launch_bounds__(THREADS, 1) sync_floor_kernel(int rounds, float* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  Block blk((int)cluster.block_rank(), (int)cluster.num_blocks());
  cluster.sync();
  const float edge[CHUNK] = {};
  float acc = 0.f;
  for (int i = 0; i < rounds; ++i) {
    float s0 = (float)threadIdx.x, s1 = acc, mx = (float)i;
    cluster_reduce(s0, s1, mx, blk.red, blk.sum_a, blk.ranks);
    blk.exchange_halo(edge);
    cluster_reduce(s0, s1, mx, blk.red, blk.sum_c, blk.ranks);
    acc += s0 + s1 + mx;
  }
  cluster.sync();
  if (threadIdx.x == 0) sink[blockIdx.x] = acc;
}

}  // namespace

// `rounds` rounds on `blocks` blocks in clusters of `cluster`, each with K1's
// shared memory.
extern "C" int k1_sync_floor_launch(int blocks, int cluster, int rounds, float* sink,
                                    cudaStream_t stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || blocks % cluster != 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(sync_floor_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(blocks, SMEM_BYTES, stream, &attr, cluster);
  err = cudaLaunchKernelEx(&cfg, sync_floor_kernel, rounds, sink);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
