// Building blocks of the f32 flash kernels that run in thread-block
// clusters on the CUDA cores, shared by flash_fwd.cu (both forwards) and
// flash_bwd.cu (both backward pairs), each at head dims 256 and above
// (f32_cluster_head_dim; at 32, 64 and 128 both sources run the same tiles,
// one CTA a tile, on a slab as wide as the head: load_head, store_head,
// tile_scores), and included by them only when built with
// -DFLASH_HEAD_DIM_WIDE
// (kernels/build.py's *_wide libraries; the f32 kernels live in the bf16
// ones, kWithF32). The slab geometry, the cluster walk and the launch
// (SlabGeo, SlabCols, cluster_slot, launch_clusters) also serve
// flash_bwd.cu's 16-bit pair and flash_fwd.cu's 16-bit forwards above 576,
// on the tensor cores at their own slab widths.
//
// A head dim d splits into n = ceil(d / 128) slabs of kF32WideSlab columns,
// the last one starting at d - 128 (it overlaps the one before it where 128
// does not divide d). The n slab CTAs of a tile are one thread-block cluster
// (cudaLaunchKernelEx with a cluster dimension on the grid's x) of up to
// kF32WideCluster = 8, the portable size; above 8 slabs a tile has g =
// ceil(n / 8) clusters of c = ceil(n / g) CTAs (those past the n-th write
// nothing), each cluster also summing the columns its slabs do not own in
// 64-column foreign chunks spread over its CTAs (F32WideCols). Each CTA sums
// a partial score tile over the columns it owns, and the cluster adds the
// partials through distributed shared memory in rank order (the same bits
// every run). f32 tiles in shared memory are [rows][W] with their float4
// columns XOR-swizzled by row (swz) and arrive by 16-byte cp.async
// (load_tile); products are register blocked (f32_wide_thread: a warp
// covers four row blocks and eight column blocks, so each float4 load is one
// wavefront). The host side launches a cluster kernel after asking
// cudaOccupancyMaxActiveClusters whether its cluster fits at its shared
// memory (once per card, kernel and cluster size): none is kNoCluster.

#pragma once

#include "flash_wide.cuh"  // wide_slabs

namespace hopper {

constexpr int kF32WideTile = 64;     // q rows and keys of an f32 tile
constexpr int kF32WideChunk = 64;    // columns of an f32 foreign chunk
constexpr int kF32WideSlab = 128;    // columns of each output an f32 CTA holds
constexpr int kF32WideStages = 2;    // stages of the f32 streamed ring
constexpr int kF32WideCluster = 8;   // the most CTAs of an f32 cluster (the portable limit)
constexpr int kF32Threads = 256;     // threads of an f32 cluster CTA
constexpr int kNoCluster = -3;       // no cluster of the plan's CTAs fits on the card

// The head dims the f32 cluster kernels take: 256 and above, whole 64-column
// chunks (2 slab CTAs at 256, 4 at 512, 5 at 576, the last one from 448).
__host__ __device__ constexpr bool f32_cluster_head_dim(int d) {
  return d >= 256 && d % kF32WideChunk == 0;
}

// How the CTAs of one tile split the head dim d (flash_fwd.py::
// f32_wide_geometry): n slabs of W columns (kF32WideSlab for the f32
// kernels, kWideDqSlab or kWideDkvSlab for flash_bwd.cu's 16-bit pair above
// 576), the last one starting at d - W, in g clusters of c CTAs (c at most
// kF32WideCluster: one cluster when n <= 8); the grid holds g * c CTAs a
// tile, and those past the n-th write no column.
template <int W>
struct SlabGeo {
  int n, g, c;
  __host__ __device__ explicit SlabGeo(int d)
      : n(wide_slabs(d, W)),
        g((n + kF32WideCluster - 1) / kF32WideCluster),
        c((n + g - 1) / g) {}
  __host__ __device__ int ctas() const { return g * c; }
};
using F32WideGeo = SlabGeo<kF32WideSlab>;  // the f32 kernels' slabs

// The columns of CTA z of a tile. It writes [own0, own1) (its slab's own
// columns, none past the n-th slab) from the slab at g0, and sums into its
// partial scores its own columns and every c-th of the 64-column chunks its
// cluster owns none of (the foreign chunks: none when n <= 8), so the c
// CTAs of a cluster sum each column of d once.
template <int W>
struct SlabCols {
  int g0, own0, own1;  // the slab's first column and the columns it writes
  int cl0, cl1;        // the columns the cluster's CTAs write
  int rank, nf;        // the rank in the cluster and the count of foreign chunks
  __device__ SlabCols(const SlabGeo<W>& geo, int z, int d) {
    rank = z % geo.c;
    own0 = min(z * W, d);
    own1 = min(own0 + W, d);
    g0 = min(z * W, d - W);
    cl0 = (z - rank) * W;
    cl1 = min(cl0 + geo.c * W, d);
    const int foreign = (d - (cl1 - cl0)) / kF32WideChunk;
    nf = foreign > rank ? (foreign - rank - 1) / geo.c + 1 : 0;
  }
  __device__ bool owns() const { return own1 > own0; }
  // per tile pair: the foreign chunks, then the main item (the slabs)
  __device__ int items() const { return nf + (owns() ? 1 : 0); }
  // the first column of the CTA's k-th foreign chunk
  __device__ int foreign(int k, int c) const {
    const int c0 = (rank + k * c) * kF32WideChunk;
    return c0 < cl0 ? c0 : c0 + (cl1 - cl0);
  }
};
using F32WideCols = SlabCols<kF32WideSlab>;

// A [rows][W] f32 tile in shared memory, float4 f of row r stored at float4
// f ^ ((r >> 2) & 7) of the row: the rows 4t .. 4t + 3 read by a warp's
// four (or eight) values of t in the score loop, and the eight float4s of
// one row read in the output loop, fall in distinct banks.
template <int W>
__device__ __forceinline__ int swz(int r, int f) {
  return r * W + ((f ^ ((r >> 2) & 7)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 scale4(float4 v, float m) {
  return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
}
__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// Rows [r0, r0 + R) and columns [c0, c0 + W) of an (s, d) f32 matrix into a
// swizzled [R][W] tile by 16-byte cp.async (rows past s zero-filled).
template <int W, int R = kF32WideTile>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int s, int d,
                                          int c0) {
  constexpr int F = W / 4;
  static_assert(R * F % kF32Threads == 0, "every thread loads as many float4s");
  // recomputed at every call: hoisted out of the walk, the addresses of all
  // four tile shapes held 40-50 registers and spilled dK/dV (255 registers)
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
#pragma unroll
  for (int k = 0; k < R * F / kF32Threads; ++k) {
    const int e = tid + k * kF32Threads;
    const int r = e / F, f = e % F;
    const bool in = r0 + r < s;
    cp_async16(dst + swz<W>(r, f), src + static_cast<size_t>(in ? r0 + r : 0) * d + c0 + 4 * f,
               in);
  }
}

// Rows [r0, r0 + R) and columns [0, W) of an (s, d) f32 matrix into a
// swizzled [R][W] tile by 16-byte cp.async, zero past row s and past column
// d: a head whole in one slab (the tile kernels at head dims up to 128).
// Fewer float4s than threads (16 rows of 32 columns): the first R W / 4
// threads load one each.
template <int W, int R = kF32WideTile>
__device__ __forceinline__ void load_head(float* dst, const float* src, int r0, int s, int d) {
  constexpr int F = W / 4;
  static_assert(R * F % kF32Threads == 0 || kF32Threads % (R * F) == 0,
                "every loading thread loads as many float4s");
  int tid = threadIdx.x;  // recomputed at every call, as load_tile's
  asm volatile("" : "+r"(tid));
  if constexpr (R * F < kF32Threads) {
    if (tid >= R * F) return;
  }
#pragma unroll
  for (int k = 0; k < (R * F + kF32Threads - 1) / kF32Threads; ++k) {
    const int e = tid + k * kF32Threads;
    const int r = e / F, f = e % F;
    const bool in = r0 + r < s && 4 * f < d;
    cp_async16(dst + swz<W>(r, f), src + (in ? static_cast<size_t>(r0 + r) * d + 4 * f : 0), in);
  }
}

// A thread's RM x (W / 16) block of an output (rows r0 + RM ta + a, columns
// 4 (tb + 16 h) + e; at W 32 columns 2 tb + e) into an (s, d) f32 matrix:
// rows inside s, columns inside d.
template <int W, int RM = 4>
__device__ __forceinline__ void store_head(float* dst, const float (&acc)[RM][W / 16], int r0,
                                           int s, int d, int ta, int tb) {
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int r = r0 + RM * ta + a;
    if (r >= s) continue;
    if constexpr (W == 32) {
      if (2 * tb < d) {
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * d + 2 * tb) =
            make_float2(acc[a][0], acc[a][1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < W / 64; ++h) {
        const int col = 4 * (tb + 16 * h);
        if (col >= d) continue;
        st4(dst + static_cast<size_t>(r) * d + col,
            make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]));
      }
    }
  }
}

// acc[i][j] += A(RM ta + i) . B(4 tb + j) over the float4 columns [0, f1) of
// swizzled [rows][W] tiles, an f32 FMA chain in column order (SB: B's values
// times qscale first, q's share of the score): S, or dP, of a thread's RM x 4
// block. partial_scores' loop for one product at a time: B's four float4s
// and A's one in registers, not eight and two, so that the backward's dQ at a
// 64-column slab keeps to 128 registers (two CTAs an SM).
template <int W, bool SB, int RM = 4>
__device__ __forceinline__ void tile_scores(float (&acc)[RM][4], const float* A, const float* B,
                                            int ta, int tb, int f1, float qscale) {
  const float* a_row = A + RM * ta * W;
  const float* b_row = B + 4 * tb * W;
  const int xa = (RM == 4 ? ta : RM * ta >> 2) & 7, xb = tb & 7;  // the rows' swizzle
#pragma unroll 1
  for (int f = 0; f < f1; ++f) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ld4(b_row + j * W + ((f ^ xb) << 2));
      if (SB) b[j] = scale4(b[j], qscale);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = ld4(a_row + i * W + ((f ^ xa) << 2));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// The thread's (ta, tb) in a 64 x 64 tile: a warp covers four consecutive ta
// and eight consecutive tb, so each float4 load of the score loop is one
// wavefront.
__device__ __forceinline__ int2 f32_wide_thread() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return make_int2((lane >> 3) | ((warp >> 1) << 2), (lane & 7) | ((warp & 1) << 3));
}

// Rows 4 ta + a of a thread's 4 x 8 block into a (s, d) f32 matrix from row
// r0 and the slab at g0: its owned columns, rows inside s.
__device__ __forceinline__ void store_block(float* dst, const float (&acc)[4][8], int r0, int s,
                                            int d, const F32WideCols& cols, int ta, int tb) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 4 * ta + a;
    if (r >= s) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = cols.g0 + 4 * (tb + 16 * h);
      if (col < cols.own0 || col >= cols.own1) continue;
      st4(dst + static_cast<size_t>(r) * d + col,
          make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]));
    }
  }
}

// The (row, tile) that the cluster of this block walks, of `rows` rows and
// `tiles` 64-row tiles (the forward's: q tiles of its plan's height): the
// launch's n-th cluster (its tile on x, its row on y and z, as cluster_grid
// lays them out) takes tile n / rows of row n % rows, so the clusters start
// tile-major, the longest walks first (dK/dV's key tile 0; with
// `heaviest_last`, the last q tile of dQ under a plain causal mask and of
// the triangle forward); x -1 past the last cluster (the last z slice).
__device__ __forceinline__ int2 cluster_slot(int rows, int tiles, int ctas, bool heaviest_last) {
  constexpr int kMaxY = 65535;  // rows a z slice, as cluster_grid lays them out
  const long long n = blockIdx.x / ctas + static_cast<long long>(tiles) *
                                               (static_cast<long long>(blockIdx.z) * kMaxY +
                                                blockIdx.y);
  if (n >= static_cast<long long>(tiles) * rows) return make_int2(-1, 0);
  const int rank = static_cast<int>(n / rows);
  return make_int2(static_cast<int>(n % rows), heaviest_last ? tiles - 1 - rank : rank);
}

// The grid of an f32 cluster kernel: `tiles` tiles x `ctas` CTAs on x, the
// rows on y in z slices of 65,535.
inline dim3 cluster_grid(int tiles, int ctas, int rows) {
  constexpr int kMaxY = 65535;
  return dim3(tiles * ctas, rows < kMaxY ? rows : kMaxY, (rows + kMaxY - 1) / kMaxY);
}

// A launch of `grid` in clusters of c CTAs on x, `threads` a CTA, `smem`
// bytes of dynamic shared memory, on `stream`; `attr` holds the cluster
// dimension.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int c, int threads, int smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One kernel's answers of cudaOccupancyMaxActiveClusters, per card (the
// first kCachedCards) and cluster size; 0 where not asked yet.
constexpr int kCachedCards = 16;
struct ClusterCounts {
  int known[kCachedCards][kF32WideCluster + 1] = {};
};

// How many clusters of c CTAs of `kernel` (`threads` a CTA, kF32Threads
// unless given) at `smem` bytes the current card holds at once, asked once
// per card and cluster size (`counts` keeps the answers); minus a CUDA error
// code when the query fails.
template <typename... Args>
int active_clusters(void (*kernel)(Args...), int c, int smem, ClusterCounts& counts,
                    int threads = kF32Threads) {
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int* const slot = card < kCachedCards ? &counts.known[card][c] : nullptr;
  if (slot != nullptr && *slot != 0) return *slot;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(c), c, threads, smem, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (slot != nullptr) *slot = n;
  return n;
}

// `kernel` over `grid` in clusters of c CTAs of `threads`: 0, a CUDA error
// code, or kNoCluster when no such cluster fits on the card at `smem` bytes.
template <typename... Args, typename... Actual>
int launch_clusters(void (*kernel)(Args...), dim3 grid, int c, int threads, int smem,
                    cudaStream_t stream, ClusterCounts& counts, Actual... args) {
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int clusters = active_clusters(kernel, c, smem, counts, threads);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, c, threads, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace hopper
