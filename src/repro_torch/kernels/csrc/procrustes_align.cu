// B2-B4: the per-stage Procrustes-fixing kernels of one aggregation round.
//
// Replace the Pallas TPU kernels of src/repro/kernels/procrustes_align.py:
//   B2 batched_gram        (:141, body :80)   G_i = V_i^T ref      -> (m, r, r)
//   B3 batched_gram_polar  (:155, body :101)  Z_i = NS-polar(G_i)  -> (m, r, r)
//   B4 align_average       (:198, body :179)  (1/m) sum_i V_i Z_i  -> (d, r)
//
// What bounds them on an H100: FP32 operations, narrowly.  At the
// production width (m = 8, d = 8192, r = 128) B2 and B4 each do
// 2 m d r^2 = 2.15 GFLOP (32 us at 67 TFLOP/s) over the 33.5 MB stack
// (10 us at 3.35 TB/s); both are small enough that launch latency and
// filling 132 SMs matter as much as either floor.  B3 adds 24
// Newton-Schulz steps on eight r x r tiles (1.6 GFLOP at r = 128), which
// one SM a machine would take ~1.2 ms over.
//
// The TPU kernels walk d sequentially per machine.  Here a
// machine-per-block grid would fill 8 of 132 SMs, so:
//   * B2 is one launch with no global scratch.  Block (split q, tile,
//     machine z) computes a whole 128 x 128 output tile (all of r at
//     r <= 128; a wider r adds tiles) over its split of d: 256 threads
//     with 8 x 8 accumulators fed by float4 shared-memory reads, 32-row
//     slices of V_i and ref in a 3-stage cp.async ring (96 KB;
//     tile_products.cuh).  The splits of one (machine, tile) are a
//     thread-block cluster of k <= 16 blocks (16 needs
//     cudaFuncAttributeNonPortableClusterSizeAllowed): each block stages
//     its partial tile in its own shared memory, and after a cluster
//     barrier block q sums rows q ceil(r / k) .. of the tile over the
//     cluster's ranks in rank order through distributed shared memory and
//     stores them.  No atomics, and every run gives the same bits.  The
//     wrapper plans k and the rows a split from the card's
//     cudaOccupancyMaxActiveClusters (the fewest waves x rows): an H100
//     holds 7 clusters of 16 blocks at once (one block an SM, 96 KB), 15
//     of 8, so at the main shape 8 clusters of 8 splits of 1024 rows run
//     in one wave on 64 SMs.  A block takes at least one 32-row slice, so
//     at d <= 32 k is 1.
//   * B3's first pass is B2 into an (m, r, r) Gram.  Its second is one
//     cooperative launch of groups of g blocks (ns_polar.cuh's grouped
//     form): group j runs the 24 Newton-Schulz steps of machine j (then
//     j + groups, ... when m exceeds the groups the grid holds), each
//     block owning ceil(r / g) columns of the iterate, the group meeting
//     once a step at its counter in global memory.  One machine on one
//     block would keep 8 of 132 SMs busy at the main shape.  The iterates
//     alternate between the machine's slot of out and its Gram's slot.
//     Up to r = 136 a block stages the whole iterate in shared memory;
//     past it, it streams the iterate from L2 in slices of rows.  The
//     wrapper plans g and the grid from the co-resident block count
//     (_polar_plan): at the main shape 8 groups of 16 blocks.  Block 0
//     zeroes the groups' counters before a grid barrier, so every launch
//     starts them at zero.
//   * B4 is one (d x m r) . (m r x r) product over the stack as it lies in
//     memory: the sum over machines and over r is one reduction of depth
//     K = m r, walked in 16-deep slices (one machine each) in a fixed
//     order, so the result is deterministic.  A block owns 64 rows of d
//     and up to 128 columns (all of r at r <= 128; a wider r adds column
//     tiles, each reading its rows of V again), so at r <= 128 every V_i
//     element is read once: at d = 8192, r = 128 that is 128 blocks, one
//     wave on 132 SMs.  With one block an SM the FMAs must not wait on
//     shared memory or on the loads: 256 threads each hold an 8x4
//     register tile fed by float4 shared-memory reads (12 loads per 128
//     FMAs), and a 3-stage cp.async ring (36 KB of static shared memory)
//     keeps two slices of V and Z in flight (apply::rows,
//     tile_products.cuh).  FP32 FMAs only (no TF32); 1/m is applied in
//     the store.
// The 1e-30 norm floor and the 3I form of _ns_polar_tile (:90-98) are
// kept exactly.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "ns_polar.cuh"
#include "tile_products.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::gram::kBM;
constexpr int kMaxCluster = 16;
constexpr int kNsThreads = 256;

// B2: out[z] tile (blockIdx.y) = sum over the cluster's splits of
// V_z[split]^T ref[split]; block q of the cluster owns rows
// q rows .. (q + 1) rows - 1 of d.  VEC: r % 4 == 0 and aligned pointers.
template <bool VEC>
__global__ void __launch_bounds__(rt::gram::kThreads, 1)
    batched_gram_kernel(const float* __restrict__ vs,
                        const float* __restrict__ ref, float* __restrict__ out,
                        int d, int r, int rows) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int tiles = (r + kBM - 1) / kBM;
  const int i0 = (blockIdx.y / tiles) * kBM;
  const int j0 = (blockIdx.y % tiles) * kBM;
  const int k_begin = min(d, q * rows);
  const int k_end = min(d, k_begin + rows);
  const size_t rr = static_cast<size_t>(r) * r;

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  rt::gram::tile_acc<float, VEC>(vs + blockIdx.z * static_cast<size_t>(d) * r,
                                 nullptr, r, r, ref, r, r, k_begin, k_end, i0,
                                 j0, smem, acc);

  // The ring is drained: stage this split's partial tile [kBM][kBM] there.
  const int ty = rt::gram::ty();
  const int tx = rt::gram::tx();
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(smem + rt::gram::ofs(ty, u) * kBM +
                                 rt::gram::ofs(tx, 4 * h)) =
          make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2],
                      acc[u][4 * h + 3]);
  cluster.sync();

  // Rows [lo, hi) of the tile: the cluster's partials summed in rank order.
  const int nrow = min(kBM, r - i0);
  const int ncol = min(kBM, r - j0);
  const int per = (nrow + k - 1) / k;
  const int lo = min(nrow, q * per);
  const int hi = min(nrow, lo + per);
  float* oz = out + blockIdx.z * rr;
  if (VEC) {
    const int c4 = ncol / 4;
    for (int e = threadIdx.x; e < (hi - lo) * c4; e += blockDim.x) {
      const int row = lo + e / c4;
      const int col = (e % c4) * 4;
      float4* mine = reinterpret_cast<float4*>(smem + row * kBM + col);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int src = 0; src < k; ++src) {
        const float4 p = *cluster.map_shared_rank(mine, src);
        s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
      }
      *reinterpret_cast<float4*>(oz + static_cast<size_t>(i0 + row) * r + j0 + col) = s;
    }
  } else {
    for (int e = threadIdx.x; e < (hi - lo) * ncol; e += blockDim.x) {
      const int row = lo + e / ncol;
      const int col = e % ncol;
      float* mine = smem + row * kBM + col;
      float s = 0.f;
      for (int src = 0; src < k; ++src) s += *cluster.map_shared_rank(mine, src);
      oz[static_cast<size_t>(i0 + row) * r + j0 + col] = s;
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The B2 instance for these operands, with its shared memory and (past a
// cluster of 8) the non-portable cluster size allowed.
int gram_kernel_for(bool vec, void (**kernel)(const float*, const float*,
                                              float*, int, int, int)) {
  *kernel = vec ? batched_gram_kernel<true> : batched_gram_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rt::gram::kSmemBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return static_cast<int>(err);
}

cudaLaunchConfig_t gram_config(int cluster, int tiles, int m, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles * tiles, m);
  cfg.blockDim = dim3(rt::gram::kThreads);
  cfg.dynamicSmemBytes = rt::gram::kSmemBytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// B2 into out (m, r, r): the wrapper's plan of rows a split and cluster
// splits (1, 2, 4, 8 or 16, covering d).
int launch_gram(const float* vs, const float* ref, float* out, int m, int d,
                int r, int rows, int cluster, cudaStream_t s) {
  const int tiles = (r + kBM - 1) / kBM;
  if (cluster < 1 || cluster > kMaxCluster || kBM % cluster ||
      static_cast<long long>(rows) * cluster < d || tiles * tiles > 65535 ||
      m > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = r % 4 == 0 && aligned16(vs) && aligned16(ref) && aligned16(out);
  void (*kernel)(const float*, const float*, float*, int, int, int);
  int code = gram_kernel_for(vec, &kernel);
  if (code) return code;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = gram_config(cluster, tiles, m, s, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, vs, ref, out, d, r, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 of B3, one cooperative launch: machine z on the group of `group`
// blocks z .. (taking machines in turn when m exceeds the groups), the
// Newton-Schulz steps on its Gram g[z] (ns_polar_grouped), the iterates
// alternating between out[z] and g[z].  nsn: (m, group) sums of squares;
// ctr: (m) barrier counters, zeroed here.
__global__ void __launch_bounds__(kNsThreads, 1)
    ns_group_kernel(float* g, float* out, float* nsn, unsigned* ctr, int m,
                    int r, int ns_iters, int group) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kNsThreads / 32];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    for (int z = threadIdx.x; z < m; z += blockDim.x) ctr[z] = 0;
  }
  grid.sync();
  const size_t rr = static_cast<size_t>(r) * r;
  const int groups = static_cast<int>(gridDim.x) / group;
  for (int z = blockIdx.x / group; z < m; z += groups) {
    rt::ns_polar_grouped(g + z * rr, 1, out + z * rr, g + z * rr,
                         nsn + static_cast<size_t>(z) * group, ctr + z, group,
                         blockIdx.x % group, r, ns_iters, smem, red);
  }
}

// The pass-2 kernel's shared memory at edge r set as its limit; *smem the
// bytes, 0 when r is past the grouped form's reach.
int group_kernel_smem(int r, size_t* smem) {
  *smem = rt::ns_grouped_smem_bytes(r);
  if (!*smem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      ns_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

// B4: out (d, r) = (1/m) sum_i vs[i] (d, r) @ zs[i] (r, r), one product
// over K = m r (apply::rows); block (x, y) owns output rows 64 y ..
// 64 y + 63 and columns 128 x .. 128 x + 127.
template <bool VEC>
__global__ void __launch_bounds__(rt::apply::kThreads)
    align_average_kernel(const float* __restrict__ vs,
                         const float* __restrict__ zs,
                         float* __restrict__ out, int m, int d, int r) {
  __shared__ __align__(16) float smem[rt::apply::kSmemFloats];
  rt::apply::rows<float, VEC>(vs, static_cast<size_t>(d) * r, nullptr, zs, m,
                              d, r, blockIdx.y * rt::apply::kBM,
                              blockIdx.x * rt::apply::kBN,
                              static_cast<float>(m), false, out, smem);
}

}  // namespace

extern "C" {

// vs: (m, d, r), ref: (d, r), out: (m, r, r); rows a split and the
// cluster size from the wrapper's plan.
int rt_batched_gram(int device, const void* vs, const void* ref, void* out,
                    int m, int d, int r, int rows, int cluster, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gram(static_cast<const float*>(vs),
                     static_cast<const float*>(ref), static_cast<float*>(out),
                     m, d, r, rows, cluster, static_cast<cudaStream_t>(stream));
}

// *active: how many clusters of B2's blocks of size cluster the card holds
// at once (cudaOccupancyMaxActiveClusters), 0 if it refuses the size.
int rt_batched_gram_clusters(int device, int cluster, int* active) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(const float*, const float*, float*, int, int, int);
  int code = gram_kernel_for(true, &kernel);
  if (code) return code;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = gram_config(cluster, 1, 1, nullptr, &attr);
  *active = 0;
  err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (err != cudaSuccess) {
    *active = 0;
    cudaGetLastError();  // a refused size is an answer, not a fault
  }
  return 0;
}

// *blocks: the co-resident blocks of B3's pass-2 kernel at edge r, the
// most its cooperative launch may have.
int rt_batched_gram_polar_coresident(int device, int r, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  int code = group_kernel_smem(r, &smem);
  if (code) return code;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ns_group_kernel,
                                                      kNsThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

// g: (m, r, r) f32 scratch for the Gram (and the second iterate buffer);
// nsn: (m, group) f32; ctr: (m) 32-bit words; grid and group from the
// wrapper's plan (grid a multiple of group, at most the co-resident
// blocks).  form_out (may be null) receives the Newton-Schulz form: group,
// negated past rt::kNsSmemMaxR (the streamed iterate).
int rt_batched_gram_polar(int device, const void* vs, const void* ref, void* g,
                          void* out, void* nsn, void* ctr, int m, int d, int r,
                          int rows, int cluster, int ns_iters, int grid,
                          int group, int* form_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (group < 1 || grid < group || grid % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = launch_gram(static_cast<const float*>(vs),
                         static_cast<const float*>(ref), static_cast<float*>(g),
                         m, d, r, rows, cluster, s);
  if (code) return code;
  size_t smem = 0;
  code = group_kernel_smem(r, &smem);
  if (code) return code;
  if (form_out) *form_out = r > rt::kNsSmemMaxR ? -group : group;
  float* gp = static_cast<float*>(g);
  float* op = static_cast<float*>(out);
  float* np = static_cast<float*>(nsn);
  unsigned* cp = static_cast<unsigned*>(ctr);
  void* args[] = {&gp, &op, &np, &cp, &m, &r, &ns_iters, &group};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ns_group_kernel),
                                    dim3(grid), dim3(kNsThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// vs: (m, d, r), zs: (m, r, r), out: (d, r).
int rt_align_average(int device, const void* vs, const void* zs, void* out,
                     int m, int d, int r, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((r + rt::apply::kBN - 1) / rt::apply::kBN,
                  (d + rt::apply::kBM - 1) / rt::apply::kBM);
  const bool vec = r % 4 == 0 && aligned16(vs) && aligned16(zs) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vs);
  const float* z = static_cast<const float*>(zs);
  float* o = static_cast<float*>(out);
  if (vec) {
    align_average_kernel<true><<<grid, rt::apply::kThreads, 0, s>>>(v, z, o, m, d, r);
  } else {
    align_average_kernel<false><<<grid, rt::apply::kThreads, 0, s>>>(v, z, o, m, d, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
