// Flash-attention forward kernels for Hopper (sm_90a).
//
// Replace the two Pallas forward kernels of the JAX package:
//   flash_fwd_tri_kernel  <- tpu_operator/workloads/flashattention.py::_flash_fwd_tri_kernel
//                            (plain causal, sq == sk)
//   flash_fwd_rect_kernel <- tpu_operator/workloads/flashattention.py::_flash_fwd_kernel
//                            (causal or full, sliding window, segment ids, global
//                            q_start/k_start offsets, sq != sk)
// Both run a base-2 online softmax on scores scaled by log2(e)/sqrt(d) and
// write O in the input dtype and the natural-log logsumexp per row (f32); a
// row with no valid key gets O = 0 and lse = -inf.
//
// Two designs, chosen by dtype:
//
// bf16 and fp16 (flash_fwd_{tri,rect}_kernel<T, D, WG>, T __nv_bfloat16 or
// __half): the tensor-core design, one body for both 16-bit types, which
// differ only in wgmma's operand type, the tensor maps' data type and the
// rounding of packed pairs (hopper.cuh). A library holds one of them: this
// source built as is holds bf16 and the f32 kernels, built with
// -DFLASH_ELEM_F16 it holds fp16 only (kernels/build.py builds that one at
// the first fp16 call), so a bf16 caller never compiles the fp16 kernels.
// At long context attention is operations-bound (O(S^2 D) FLOPs over O(S D)
// bytes), so both products run on wgmma in T with f32 accumulators. A CTA owns BM = 64 * WG q rows (WG consumer warpgroups, one
// per 64 rows) and one producer warp. The producer loads Q once and feeds K
// and V tiles through a two-stage ring with TMA (3-D tensor maps (D, S,
// rows), so a tile past S zero-fills instead of reading the next head),
// each stage guarded by a "full" mbarrier (TMA bytes) and an "empty" one
// (one arrival per consumer warp). Per k tile a consumer warpgroup runs
// S = Q.K^T (A and B from shared memory, both K-major), masks, runs the
// online softmax on the accumulator fragment, packs P to T in registers
// and runs O += P.V with P as the register A operand (the f32 accumulator
// layout of S is the 16-bit A layout of P) and V as an MN-major B operand
// (the transpose flag), so P never touches shared memory. Scores are raw
// q.k scaled in f32 after the product, as the backward kernels recompute
// them; P is rounded to T before P.V and the row sum is taken from the
// unrounded P. Swizzle per D matches the TMA box to the wgmma descriptor:
// 32B at D 16, 64B at D 32, 128B at D 64 and 128B over two 64-column boxes
// at D 128, four at D 256, eight at 512, nine at 576. The tile height,
// grid, shared-memory bytes and swizzle come from the caller's plan
// (flash_fwd.py::tri_plan, rect_plan), which this file checks against its
// own layout. No setmaxnreg up to D 128: with one
// producer warp beside at most two warpgroups the register cap (168 a
// thread at WG = 2, 255 at WG = 1) holds the O and S accumulators.
// D 256 (rows_body, both masks; WG = 2): a CTA owns 128 q rows, two
// consumer warpgroups of 64 that share every K and V tile, so a tile's
// copy feeds twice the products of a 64-row CTA (the copies, from L2, set
// the pace of a 64-row CTA at this width). O (128 f32), S (32) and P (16)
// are 176 registers a thread, past the 168 of 384 threads, so a producer
// warpgroup gives its registers up (setmaxnreg, 40) and the consumers take
// them (232). Both masks walk 64-key ring tiles (two stages of 128-key
// tiles would pass a block's shared memory): the triangle's q tile meets
// the causal mask in its last two, each one warpgroup's diagonal. K and V
// have barriers of their own a stage: a warpgroup issues tile j's S, then
// tile j - 1's P.V (one m64n256k16 wgmma per 16 keys), and runs tile j's
// softmax under that P.V (one wgmma group in flight), rescaling O and
// rounding P once it is done; S releases K, P.V its V. Every wgmma is
// issued on the warpgroup's one path (a wgmma whose registers a divergent
// path may touch is serialized by ptxas, C7518), so a tile none of a
// warpgroup's rows sees is multiplied and masked whole. The warpgroups
// issue as they come: taking turns (named barriers) measured no gain. With
// segment ids every warp reduces each tile's ids itself: a tile whose one
// document is not the one of all 128 rows is never copied. The shared-
// memory reads of S on m64n64k16 (32 FLOP a byte: the SM's tensor rate
// over its shared-memory rate) and the TMA writes bound a step near 65%
// of the tensor cores' rate. 197,704 bytes of shared memory (the general
// kernel 512 more: the staged ids).
// D 512 (WG = 1 only; its own library, built with -DFLASH_HEAD_DIM_512, so a
// caller at D <= 256 never compiles it): O for 64 rows would be 256 f32 a
// thread, past the 255 a thread may hold, and P.V's N = 512 past wgmma's
// 256. So two CTAs share a q tile, its column halves on the grid's z: each
// is the D 256 design on 256 columns of O (128 f32 a thread), forms S over
// all 512 columns (32 k16 steps), and runs P.V as one m64n256k16 per 16 keys
// on its half of V (column boxes 0-3 or 4-7). S is formed twice per tile:
// 1.5x the ideal tensor-core work (S and P.V once each), and no exchange
// between the CTAs; only half 0 writes lse. The Q tile (64 KiB) and one
// stage of 64-key K and V tiles (64 KiB each) take 197,656 bytes (the
// general kernel 264 more), so the ring has one stage (stages<D>): the
// producer refills K and V only after both of the tile's products.
// D 576 (MLA's absorbed heads: WG = 1 only; its own library, built with
// -DFLASH_HEAD_DIM_576): two halves of 288 columns would pass wgmma's N of
// 256, so three CTAs share a q tile, its column thirds on the grid's z
// (col_split<D>): each holds 192 columns of O (96 f32 a thread; column boxes
// 3c to 3c + 2 of the nine), forms S over all 576 columns (36 k16 steps) and
// runs P.V as one m64n192k16 per 16 keys. S is formed three times per tile:
// 2x the ideal tensor-core work; only third 0 writes lse. Q, K and V tiles of
// 64 rows (72 KiB each) and one stage take 222,232 bytes (the general kernel
// 264 more). 640 columns would need 245,760 for the three tiles alone, past
// the 232,448 a block may use: 576 is the widest head this design holds.
// Above 576 (flash_fwd_wide_kernel<T, TRI>; its own library, built with
// -DFLASH_HEAD_DIM_WIDE, the head dim a runtime multiple of 64 and the
// helpers in flash_wide.cuh and flash_cluster.cuh): a CTA is one warpgroup
// that owns 64 q rows and one slab of kWideSlab = 256 columns of O (the last
// slab starts at D - 256 so that every CTA runs the same m64n256k16 P.V, and
// writes only the columns no earlier slab owns), and the slab CTAs of a q
// tile are one thread-block cluster (SlabGeo: 3 CTAs at 640 and 704, 4 at
// 1024, 8 at 2048; above 8 slabs g = ceil(n / 8) clusters a q tile, each
// also summing the 64-column chunks none of its CTAs owns, SlabCols). A CTA
// keeps its own columns of the q tile's Q resident (TMA, once) and streams
// only its own columns of each key tile's K and V in 64 x 64 boxes through a
// two-stage K ring and a two-stage V ring (a foreign chunk is a Q and a K box
// in a K stage); thread 0 issues the TMA and every warp walks the loads with
// it. Per key tile each CTA forms a partial S over its columns on wgmma and
// stores it in f32; CTA `rank` owns rows [64 rank / c, 64 (rank + 1) / c) of
// the tile pair: it reads those rows of every CTA's partial through
// distributed shared memory, adds them in rank order (the same bits every
// run), runs the tile rule's mask and the online softmax there, and stores P
// (rounded to T, in the 128-byte swizzle wgmma reads) and each row's
// (correction, running sum) into every CTA; each CTA then rescales O and runs
// O += P.V on its slab, both operands in shared memory. One cluster barrier a
// tile pair, X(n): partial n and P of tile n - 1 written; partials and P
// tiles are double-buffered, and the next tile's partial S is formed under
// the barrier's latency. (An all-gather, every CTA reading all c partials
// and running the whole softmax with P in registers, moved c x 16 KiB a CTA
// and tile pair and ran slower, PERF.md §6.) The walk (the band, the sk
// edge, the segment-id skip) depends on the row, the tiles and the ids
// alone, so every CTA of a cluster meets every barrier; an empty walk meets
// none (O = 0, lse = -inf). S is formed once per cluster (g times a tile
// pair), Q, K and V are read from L2 once per slab; 215,080 bytes of shared
// memory, one CTA an SM; the clusters launch tile-major, a plain causal
// mask's heaviest q tiles first (cluster_slot). The triangle is the same
// body. (f32 there: the cluster kernels, below.)
//   triangle: K/V tiles of BN = BM keys, so only the diagonal tile needs the
//     mask; q tiles launch heaviest first (blockIdx.y reversed, (batch,
//     head) rows on x); every row sees key 0, so its running max is finite
//     from the first tile.
//   general: K/V ring tiles of 64 keys (kRingRows, as the backward pairs'),
//     q tiles in natural order. A CTA walks the key tiles some row can see
//     by global position: all of them, or up to its last row's diagonal
//     (q_start + q_end - k_start), from its first row's window on; a walk
//     may be empty (no TMA is then issued, and the rows get O = 0, lse =
//     -inf). Each warpgroup treats each tile as the reference's
//     _dispatch_block does: dead (no live pair: outside its rows' band, or
//     both sides one document each and different ones; no products, the
//     stage still released), fast (every pair live: inside the band's
//     interior, every key < sk, one shared document; the softmax body
//     instantiated without the mask) or masked (the body instantiated with a
//     per-element test of key < sk, the band and equal ids). A row may see
//     no key in a masked tile, or none at all, so the running max is
//     guarded against -inf. Segment ids (B, s) cannot come by TMA (a
//     (B, s) int32 row breaks its 16-byte stride rule): lanes 1-31 of the
//     producer warp stage each ring tile's 64 ids and their min and max
//     beside it, each arriving on the stage's full barrier, while lane 0
//     only issues TMA; consumers hold their own rows' ids and their
//     warpgroup's id range in registers.
//
// f32 at D 32, 64 and 128 (flash_fwd_{tri,rect}_tile_f32_kernel<W, BM>,
// attend_tile<TRI, W, BM>, in the flash_fwd_wide library beside the cluster
// kernels below): their design at one CTA a tile. A CTA of 256 threads holds
// BM q rows (64, or 16 for a call of at most 16, as the cluster kernels) and
// the whole head in one slab of W columns (W = d: 32, 64 or 128; O at W 32
// as a 4 x 2 block of float2 columns), so S is whole in the CTA: no
// exchange, no cluster. Q stays resident times qscale (rounded
// as attend rounds it); K and V stream as XOR-swizzled [64][W] tiles by
// 16-byte cp.async through two stages, the next key tile loading under this
// one's products. Thread (ty, tx) forms a 4 x 4 block of S (BM 16: 1 x 4)
// over float4 rows, an FMA chain in column order (attend's bits), runs the
// base-2 online softmax for its rows with the row's 16 threads in one half
// warp (shuffles), writes P to shared memory and holds O as a 4 x (W / 16)
// register block at the same rows, O += P.V over float4 rows of V: two
// barriers a key tile. Under segment ids every warp skips a key tile whose
// documents cannot meet the q tile's; the CTAs launch tile-major, a plain
// causal mask's heaviest q tiles first (cluster_slot, as the backward pairs').
// Shared memory 58,368 bytes at W 32 and 99,328 at W 64 (at least two CTAs
// an SM under __launch_bounds__(256, 2)), 181,248 at W 128 (one); at BM 16
// 39,168, 73,984 and 143,616.
//
// f32 at D 16 (attend<float, 16, TRI>, the base bf16 library, where serving's
// prefill chunk runs it): the first port's whole-row design, one CTA of 256
// threads (16 x 16) per (bh row, 64-row q tile), q tiles on the grid's x
// and bh rows on y and z (kMaxGridY rows a z slice). K and V tiles are
// staged element by element through shared memory as f32; each thread owns
// a 4 x 4 block of the score tile and the matching 4 x 1 block of the
// output, and P goes through shared memory. f32 stays on the CUDA cores
// everywhere because it must not round through TF32 (serving prefill holds
// its greedy tokens to the reference's).
//
// f32 at D 256 and above (flash_fwd_f32_cluster_kernel<TRI, BM>, the
// triangle and the general masks from one body, in the flash_fwd_wide
// library: the head dim is a runtime multiple of 64; slabs, clusters and
// tiles in flash_cluster.cuh): a CTA of 256 threads holds BM q rows (64, or
// 16 for a call of at most 16, serving's prefill chunk) and one 128-column
// slab of O, and the n = ceil(d / 128) slab CTAs of a q tile are one
// thread-block cluster (2 at 256, 4 at 512, 5 at 576, 8 at 1024; above 8
// slabs g = ceil(n / 8) clusters a tile, each also summing the columns its
// slabs do not own in 64-column foreign chunks). A CTA keeps its own
// columns of Q (times qscale, as attend scales q) resident and streams only
// its own columns of each key tile's K and V (64 x 128 slabs) through two
// cp.async stages, the next tile's loading under this one's products; so Q,
// K and V are read once per q tile per cluster. Per tile pair each CTA sums
// a partial S over the columns it owns (the last slab starts at d - 128 and
// owns only the columns no earlier slab does), 4 x 4 register blocks over
// float4 rows of XOR-swizzled tiles; CTA r of c adds rows [BM r / c, BM (r
// + 1) / c) of every CTA's partials in rank order through distributed
// shared memory (the same bits every run), applies the tile's mask (the
// triangle's diagonal; the general kernel's causal band at the global
// offsets, window, sk edge and segment ids) and runs the base-2 online
// softmax for those rows (16 threads a row), then stores P and the rows'
// correction and running sum into every CTA: two cluster barriers a tile
// pair (partials and P live in separate buffers). Each CTA then runs O_slab
// = O_slab * corr + P . V_slab on its columns, 4 x 8 register blocks (at BM
// 16 the 256 threads split the columns of the score loop and the keys of
// P.V four ways, added in order at the end). The walk (the key tiles of the
// band, less a tile whose documents cannot meet the q tile's, which every
// warp finds from the ids' range itself) depends only on the row and the
// tiles, so every CTA of a cluster meets every barrier; an empty walk
// leaves O = 0 and lse = -inf. 197,632 bytes of shared memory at BM 64
// (160,000 at 16): one CTA an SM, so a cluster needs c SMs of one GPC
// (cudaOccupancyMaxActiveClusters, checked at launch: none is kNoCluster).
//
// Bound on this card: at the main path's shapes (burn-in 128 x 128 scores
// per head, serving prefill 8 x 64) every kernel is latency-bound (a few
// MB moved, few CTAs of one or two tiles each); at long context attention
// turns operations-bound, where the 16-bit design's wgmma counts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers, id ranges, the tensor-map encoder
#ifdef FLASH_HEAD_DIM_WIDE
#include "flash_wide.cuh"  // the D-streaming kernels' boxes, slabs and maps
#include "flash_cluster.cuh"  // the f32 kernels' slabs, clusters and swizzled tiles
#endif

namespace {

using namespace hopper;

constexpr int kBM = 64;         // q rows per CTA
constexpr int kBN = 64;         // keys per k tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRM = kBM / 16;   // score/output rows per thread
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kUnsupported = -1;
constexpr int kNoTensorMap = -2;  // cuTensorMapEncodeTiled missing or refused the map
constexpr int kMaxGridY = 65535;  // the CUDA-core kernels' bh rows per z slice of the grid

struct Params {
  const void* q;      // (bh, sq, D)
  const void* k;      // (bh_kv, sk, D)
  const void* v;      // (bh_kv, sk, D)
  const int* seg;     // (B, sk) segment ids or nullptr (requires sq == sk)
  void* o;            // (bh, sq, D)
  float* lse;         // (bh, sq)
  int sq, sk, heads, kv_heads;
  int causal, q_start, k_start, window;  // window <= 0: no window (a causal band only)
  float qscale;       // softmax scale * log2(e): folded into q (CUDA cores), or
                      // applied to q.k after the product (tensor cores)
  int rows;           // bh
};

// The CUDA-core kernels run f32 only (bf16 and fp16 take the tensor cores),
// so these conversions are identities; they keep the body's rounding points
// visible.
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

constexpr size_t smem_bytes(int d) {
  // q tile, k tile, v tile ([rows][D + 1]), p tile ([kBM][kBN + 1]), k segment ids
  return sizeof(float) * ((kBM + 2 * kBN) * (d + 1) + kBM * (kBN + 1)) + sizeof(int) * kBN;
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void attend(const Params& p) {
  static_assert(D == 16, "f32 at head dims 32 and above: flash_fwd_wide's tile and cluster kernels");
  constexpr int BN = kBN;
  constexpr int RN = BN / 16;  // score columns per thread
  constexpr int LD = D + 1;   // odd stride: a column walk hits 16 different banks
  constexpr int LP = BN + 1;
  constexpr int CN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBM * LD;
  float* vs = ks + BN * LD;
  float* ps = vs + BN * LD;
  int* kseg = reinterpret_cast<int*>(ps + kBM * LP);

  const int bh = blockIdx.z * kMaxGridY + blockIdx.y;
  if (bh >= p.rows) return;  // past the last row in the last z slice
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBM;
  const int b = bh / p.heads;
  // grouped-query attention: q heads share kv heads in groups (_kv_row)
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const T* qg = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const T* kg = static_cast<const T*>(p.k) + static_cast<size_t>(kv_row) * p.sk * D;
  const T* vg = static_cast<const T*>(p.v) + static_cast<size_t>(kv_row) * p.sk * D;
  const bool segments = !TRI && p.seg != nullptr;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < p.sq) {
      // q pre-scaled in f32, as the reference's triangle path scales it
      // (flashattention.py:750)
      x = to_f(qg[static_cast<size_t>(q0 + r) * D + c]) * p.qscale;
    }
    qs[r * LD + c] = x;
  }

  // the k range any row of this q tile can see (local key indices)
  const int q_end = min(q0 + kBM, p.sq);
  int k_lo = 0, k_hi = p.sk;
  if (TRI) {
    k_hi = min(p.sk, q_end);
  } else if (p.causal) {
    k_hi = max(0, min(p.sk, p.q_start + q_end - p.k_start));
    if (p.window > 0) k_lo = max(0, p.q_start + q0 - p.window + 1 - p.k_start);
  }
  const int t_lo = k_lo / BN;
  const int t_hi = (k_hi + BN - 1) / BN;

  float m[kRM], l[kRM], acc[kRM][CN];
  int qseg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
    const int qi = q0 + ty + 16 * i;
    qseg[i] = (segments && qi < p.sq) ? p.seg[static_cast<size_t>(b) * p.sk + qi] : 0;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int i = tid; i < BN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      const size_t off = static_cast<size_t>(k0 + r) * D + c;
      ks[r * LD + c] = in ? to_f(kg[off]) : 0.f;
      vs[r * LD + c] = in ? to_f(vg[off]) : 0.f;
    }
    if (segments && tid < BN) {
      kseg[tid] = (k0 + tid < p.sk) ? p.seg[static_cast<size_t>(b) * p.sk + k0 + tid] : 0;
    }
    __syncthreads();

    float s[kRM][RN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRM], kv[RN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool keep = kj < p.sk;
        if (TRI) {
          keep = keep && kj <= qi;
        } else {
          if (p.causal) {
            const int dist = (p.q_start + qi) - (p.k_start + kj);
            keep = keep && dist >= 0 && (p.window <= 0 || dist < p.window);
          }
          if (segments) keep = keep && qseg[i] == kseg[tx + 16 * j];
        }
        if (!keep) s[i][j] = -CUDART_INF_F;
      }
    }

    // online softmax in base 2; -inf guards keep fully masked rows at 0
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < RN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float corr = (m[i] == -CUDART_INF_F) ? 0.f : exp2f(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float pj = (s[i][j] == -CUDART_INF_F) ? 0.f : exp2f(s[i][j] - safe);
        rs += pj;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(pj);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[kRM], vv[CN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) vv[c] = vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      og[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
    }
    if (tx == 0) {
      const bool live = l[i] > 0.f && m[i] != -CUDART_INF_F;
      p.lse[static_cast<size_t>(bh) * p.sq + qi] = live ? m[i] * kLn2 + logf(l[i]) : -CUDART_INF_F;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_tri_kernel(Params p) {
  attend<T, D, true>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_rect_kernel(Params p) {
  attend<T, D, false>(p);
}

// ---------------------------------------------------------------------------
// The 16-bit kernels on the tensor cores: wgmma + TMA (see the note on top).
// ---------------------------------------------------------------------------

constexpr int kStages = 2;        // K/V ring depth
// the general kernel's staged segment ids: kStages x (the ring tile's 64
// ids, then their min and max), int32
constexpr int kSegBytes = kStages * (kRingRows + 2) * 4;
// At D = 512: one ring stage (see the note on top), and two CTAs per q
// tile, each on a column half of O (256 columns: wgmma's widest N); at
// D = 576 one stage and three CTAs, each on a column third (192 columns).
template <int D>
__host__ __device__ constexpr int stages() { return D > 256 ? 1 : kStages; }
template <int D>
constexpr int seg_bytes() { return D > 256 ? (kRingRows + 2) * 4 : kSegBytes; }
template <int D>
__host__ __device__ constexpr int col_split() { return D > 512 ? 3 : D > 256 ? 2 : 1; }

template <int D, int WG, bool TRI>
constexpr int tc_smem_bytes() {
  // alignment slack, Q tile (64 WG rows), stages<D> K and V tiles (the
  // triangle's 64 WG keys, the general kernel's 64) with (general) their
  // keys' segment ids, full/empty/Q barriers
  return kSmemAlign + (64 * WG + 2 * stages<D>() * (TRI ? 64 * WG : kRingRows)) * D * 2 +
         (TRI ? 0 : seg_bytes<D>()) + 8 * (2 * stages<D>() + 1);
}

// D = 256: 128-row CTAs (see the note on top), both masks from one body.
constexpr int kRowsHeadDim = 256;
constexpr int kRowsBM = 128;          // q rows a CTA: two consumer warpgroups of 64
constexpr int kRowsThreads = 3 * 128;  // and a producer warpgroup
// registers a thread after setmaxnreg (2 x 128 x 232 + 128 x 40 <= 65,536):
// O (128 f32), S (32) and P (16) are past the 168 a thread of 384 gets
constexpr int kRowsProducerRegs = 40;
constexpr int kRowsConsumerRegs = 232;
// mbarriers a ring stage: K full and empty, V full and empty (S reads a
// tile's K, P.V its V one tile later: each is released once its product is done)
constexpr int kRowsStageBarriers = 4;

template <bool TRI>
constexpr int rows_smem_bytes() {
  // alignment slack, the Q tile (128 rows), kStages 64-key K and V tiles
  // with (general) their keys' segment ids, the stages' barriers and Q's
  return kSmemAlign + (kRowsBM + 2 * kStages * kRingRows) * kRowsHeadDim * 2 +
         (TRI ? 0 : kStages * kRingRows * 4) + 8 * (kRowsStageBarriers * kStages + 1);
}
static_assert(rows_smem_bytes<false>() <= 232448, "past the shared memory a block may use");

// The 16-bit forward at D = 256 on the tensor cores. blockIdx.x: (batch,
// head) row; blockIdx.y: q tile of 128 rows (TRI: the triangle, reversed so
// that the heaviest tiles launch first; else the general masks of Params,
// in order). Both consumer warpgroups read every K and V ring tile the CTA
// copies and mask a tile as the general kernel's warpgroups do (fast or
// masked for its 64 rows; one none of them sees, masked whole). Per tile a
// warpgroup issues S = Q.K^T and then the last tile's O += P.V, and runs
// this tile's softmax under that P.V. With segment ids every warp reduces
// each tile's ids to their range itself (the next tile's read under this
// one): a tile whose one document is not the one of all the CTA's rows
// holds no live pair, and it is neither copied nor multiplied.
template <typename T, bool TRI>
__device__ __forceinline__ void rows_body(const Params& p, const CUtensorMap* qmap,
                                          const CUtensorMap* kmap, const CUtensorMap* vmap) {
  constexpr int D = kRowsHeadDim;
  using G = Geo<D>;
  constexpr int BM = kRowsBM;
  constexpr int BN = kRingRows;
  constexpr int ST = kStages;
  constexpr int NW = BM / 16;  // consumer warps
  constexpr uint32_t kQBytes = BM * D * 2;
  constexpr uint32_t kKVBytes = BN * D * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + kQBytes;        // stage st at k_s + st * kKVBytes
  unsigned char* v_s = k_s + ST * kKVBytes;  // likewise
  int* kid_s = reinterpret_cast<int*>(v_s + ST * kKVBytes);  // general: [ST][BN]
  uint64_t* k_full = reinterpret_cast<uint64_t*>(kid_s + (TRI ? 0 : ST * BN));
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  uint64_t* q_full = v_empty + ST;

  const bool causal = TRI || p.causal != 0;
  const int window = TRI ? 0 : p.window;  // > 0 only under a causal mask
  const bool segments = !TRI && p.seg != nullptr;
  const int q_start = TRI ? 0 : p.q_start, k_start = TRI ? 0 : p.k_start;
  const int bh = blockIdx.x;
  const int q0 = (TRI ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  // the keys some row of the CTA can see, by global position: all of them,
  // or up to the last row's diagonal, from the first row's window on
  const int q_end = min(p.sq, q0 + BM);
  const int k_hi = causal ? max(0, min(p.sk, q_start + q_end - k_start)) : p.sk;
  const int k_lo = window > 0 ? max(0, q_start + q0 - window + 1 - k_start) : 0;
  const int t_lo = k_lo / BN;
  const int n_tiles = k_lo < k_hi ? (k_hi + BN - 1) / BN - t_lo : 0;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.sk : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // (segment ids; every lane of a warp calls these) a lane's two ids of
  // walk tile t (a position past sk reads the last id inside sk, which lies
  // in the same tile) and the warp's range of them; the range of the CTA's
  // rows' ids; a tile whose one document is not the rows' one document
  auto tile_ids = [&](int t) {
    const int k0 = (t_lo + t) * BN;
    return make_int2(seg[min(k0 + lane, p.sk - 1)], seg[min(k0 + lane + 32, p.sk - 1)]);
  };
  auto range_of = [&](int2 ids) {
    return warp_range(~0u, min(ids.x, ids.y), max(ids.x, ids.y));
  };
  int2 rows = make_int2(0, 1);
  auto apart = [&](int2 keys) { return rows.x == rows.y && keys.x == keys.y && keys.x != rows.x; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      // K: the TMA bytes, then (segment ids) each producer lane's staged ids
      mbar_init(&k_full[st], segments ? 1 + 32 : 1);
      mbar_init(&k_empty[st], NW);
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], NW);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NW) {
    // the producer warpgroup hands its registers to the consumers; its
    // first warp's lane 0 loads Q once (none for an empty walk, so that no
    // TMA is in flight when the CTA exits), then each tile's K and V, each
    // as soon as its stage is free; with segment ids the warp passes over a
    // tile apart from the rows, and stages a copied tile's ids beside its K
    reg_dealloc<kRowsProducerRegs>();
    if (warp > NW) return;
    if (segments) rows = id_range<BM>(seg, q0, p.sq, lane, 32, ~0u, nullptr);
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int b = 0; b < G::kBoxes; ++b) {
        tma_load_3d(q_s + b * BM * G::kRowBytes, qmap, q_full, b * G::kCols, q0, bh);
      }
    }
    const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
    int2 ids = make_int2(0, 0);
    if (segments && n_tiles > 0) ids = tile_ids(0);
    int n = 0;  // ring tiles copied
    for (int t = 0; t < n_tiles; ++t) {
      const int2 cur = ids;
      if (segments && t + 1 < n_tiles) ids = tile_ids(t + 1);
      if (segments && apart(range_of(cur))) continue;
      const int st = n % ST;
      const uint32_t freed = ((n / ST) - 1) & 1;
      const int k0 = (t_lo + t) * BN;
      if (n >= ST) mbar_wait(&k_empty[st], freed);
      if (lane == 0) {
        mbar_expect_tx(&k_full[st], kKVBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(k_s + st * kKVBytes + b * BN * G::kRowBytes, kmap, &k_full[st],
                      b * G::kCols, k0, kv_row);
        }
      }
      if (segments) {
        kid_s[st * BN + lane] = cur.x;
        kid_s[st * BN + lane + 32] = cur.y;
        mbar_arrive(&k_full[st]);  // releases this lane's ids to the consumers
      }
      if (n >= ST) mbar_wait(&v_empty[st], freed);
      if (lane == 0) {
        mbar_expect_tx(&v_full[st], kKVBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(v_s + st * kKVBytes + b * BN * G::kRowBytes, vmap, &v_full[st],
                      b * G::kCols, k0, kv_row);
        }
      }
      ++n;
    }
    return;
  }
  reg_alloc<kRowsConsumerRegs>();

  // consumers: warpgroup wg owns q rows w0 .. w0 + 63; this thread holds
  // rows r0 and r0 + 8 of its warp's 16, at keys 8 j + 2 tq (+1) of a tile
  const int wg = warp / 4;
  const int tq = lane % 4;
  const int w0 = q0 + wg * 64;
  const int r0 = w0 + (warp % 4) * 16 + lane / 4;
  const float qscale = p.qscale;
  const int win = window > 0 ? window : INT_MAX;
  // the global positions of the warpgroup's first row and its last inside sq
  const int qg0 = q_start + w0, qg1 = q_start + min(w0 + 63, p.sq - 1);
  int qk[2];            // rows r0, r0 + 8 as (global position - k_start): key j is
                        // qk - j positions before the row
  int qid[2] = {0, 0};  // their segment ids
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    qk[h] = q_start + row - k_start;
    if (segments && row < p.sq) qid[h] = seg[row];
  }
  // the segment ids of the CTA's rows and of the warpgroup's (one id
  // throughout when x == y)
  int2 qrange = make_int2(0, 1);
  if (segments) {
    rows = id_range<BM>(seg, q0, p.sq, lane, 32, ~0u, nullptr);
    qrange = id_range(seg, w0, p.sq, lane, 32, ~0u, nullptr);
  }
  float o[D / 2], s[BN / 2];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, scaled (base-2) units
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums

  // the tile's S = Q.K^T, issued; the last tile's O += P.V (V from its
  // stage, MN-major), issued; a warp's release of a stage. Every wgmma and
  // every wait lies on the warpgroup's one path (ptxas serializes a wgmma
  // whose registers a divergent path may touch, C7518), so a tile that holds
  // no live pair of the warpgroup's rows is multiplied too, its scores
  // masked to -inf
  auto issue_s = [&](int st) {
    wgmma_fence();
    mma_rows_by_rows<T, D>(s, q_s, BM, wg * 64, k_s + st * kKVBytes);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    hold(pa);
    wgmma_fence();
    mma_frag_by_tile<T, D>(o, pa, v_s + st * kKVBytes);
    wgmma_commit();
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with the stage
  };
  // the next tile of the walk from t on that the CTA copies (n_tiles:
  // none), its ids' range in keys; ids holds tile t's ids on entry
  int2 ids = make_int2(0, 0), keys = make_int2(0, 0);
  if (segments && n_tiles > 0) ids = tile_ids(0);
  auto next_tile = [&](int t) {
    for (; t < n_tiles; ++t) {
      if (!segments) break;
      const int2 cur = ids;
      if (t + 1 < n_tiles) ids = tile_ids(t + 1);
      keys = range_of(cur);
      if (!apart(keys)) break;  // else never copied
    }
    return t;
  };

  // the online softmax in base 2 on tile t's S (stage st), while the last
  // P.V runs: the element mask or (a fast tile) none, as the general
  // kernel's; the running max, O's and the row sums' rescale (c0, c1), the
  // tile's row sums, P in place of S. A row may see no key yet (a later
  // document, a band edge, or none at all): its max stays -inf, and `safe`
  // keeps exp2 at 0 for its masked scores and its rescale
  float c0 = 1.f, c1 = 1.f, rs0 = 0.f, rs1 = 0.f;
  auto softmax = [&](int t, int st) {
    const int k0 = (t_lo + t) * BN;
    // global positions of the tile's first key and its last inside sk; some
    // pair is live when the rows' distances to the keys, which run from
    // qg0 - kg1 to qg1 - kg0, meet the band [0, window), and every pair is
    // when they lie inside it and every key is inside sk
    const int kg0 = k_start + k0, kg1 = k_start + min(k0 + BN - 1, p.sk - 1);
    bool sees = w0 < p.sq;
    bool masked = k0 + BN > p.sk;  // a zero-filled key past sk would score
    if (causal) {
      sees = sees && qg1 >= kg0;
      masked = masked || qg0 < kg1;
    }
    if (window > 0) {
      sees = sees && qg0 - kg1 < window;
      masked = masked || qg1 - kg0 >= window;
    }
    if (segments) {
      // both sides one document each: the fast path when it is the same one
      const bool uniform = qrange.x == qrange.y && keys.x == keys.y;
      sees = sees && !(uniform && qrange.x != keys.x);
      masked = masked || !uniform;
    }
    auto body = [&](auto mask) {
      constexpr bool kMask = decltype(mask)::value;
      if constexpr (kMask) {
        const int2* kid = reinterpret_cast<const int2*>(kid_s + st * BN);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          int2 kj = make_int2(0, 0);  // the segment ids of keys 8 j + 2 tq (+1)
          if (segments) kj = kid[4 * j + tq];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * tq + e % 2;
            const int dist = qk[e / 2] - key;
            bool live = key < p.sk && (!causal || (dist >= 0 && dist < win));
            if (segments) live = live && (e % 2 ? kj.y : kj.x) == qid[e / 2];
            if (!live) s[4 * j + e] = -CUDART_INF_F;
          }
        }
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * qscale), mn1 = fmaxf(m1, mx1 * qscale);
      const float safe0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float safe1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      c0 = exp2f(m0 - safe0);
      c1 = exp2f(m1 - safe1);
      m0 = mn0;
      m1 = mn1;
      rs0 = rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], qscale, -safe0));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], qscale, -safe0));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], qscale, -safe1));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], qscale, -safe1));
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    // a tile the warpgroup does not see takes the mask, which kills every score
    if (masked || !sees) {
      body(std::true_type{});
    } else {
      body(std::false_type{});
    }
  };
  // once the last P.V is done: O and the row sums rescaled, P rounded to T
  // (the accumulator layout of S is wgmma's register layout of A)
  auto rescale = [&]() {
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        pa[kk][2 * h] = pack2<T>(s[4 * j], s[4 * j + 1]);
        pa[kk][2 * h + 1] = pack2<T>(s[4 * j + 2], s[4 * j + 3]);
      }
    }
  };

  // per copied tile: its S and the last tile's P.V issued together, its
  // softmax under that P.V; the first tile has no P.V before it, the last
  // one's runs after the walk
  if (n_tiles > 0) mbar_wait(q_full, 0);
  int t = next_tile(0);
  if (t < n_tiles) {
    int n = 1;  // ring tiles consumed
    int st = 0;
    uint32_t phase = 0;
    mbar_wait(&k_full[0], 0);
    issue_s(0);
    wgmma_wait<0>();
    hold(s);
    softmax(t, 0);
    release(&k_empty[0]);  // S and the tile's ids are read
    rescale();
    for (t = next_tile(t + 1); t < n_tiles; t = next_tile(t + 1)) {
      const int last = st;
      st = n % ST;
      phase = (n / ST) & 1;
      ++n;
      mbar_wait(&k_full[st], phase);
      mbar_wait(&v_full[last], (n - 2) / ST & 1);
      issue_s(st);
      issue_pv(last);
      wgmma_wait<1>();  // S is done; the last P.V may still run
      hold(s);
      softmax(t, st);
      release(&k_empty[st]);
      wgmma_wait<0>();
      hold(o);
      hold(pa);
      release(&v_empty[last]);
      rescale();
    }
    mbar_wait(&v_full[st], phase);
    issue_pv(st);
    wgmma_wait<0>();
    hold(o);
    hold(pa);
    release(&v_empty[st]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= p.sq) continue;
    // a row that saw no key: O = 0 (nothing was added) and lse = -inf
    const float l = half ? l1 : l0;
    const float denom = l > 0.f ? l : 1.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * D);  // T pairs
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[4 * j + tq] = pack2<T>(o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
    }
    if (tq == 0) {
      p.lse[static_cast<size_t>(bh) * p.sq + row] =
          l > 0.f ? (half ? m1 : m0) * kLn2 + logf(l) : -CUDART_INF_F;
    }
  }
}

// The 16-bit triangle forward on the tensor cores. blockIdx.x: (batch, head)
// row; blockIdx.y: q tile, reversed so the heaviest tiles launch first;
// blockIdx.z: the column slice of O at D = 512 (halves) and 576 (thirds).
template <typename T, int D, int WG>
__global__ void __launch_bounds__(D == kRowsHeadDim ? kRowsThreads : WG * 128 + 32, 1)
    flash_fwd_tri_kernel(Params p, const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core triangle is bf16 or fp16");
  if constexpr (D == kRowsHeadDim) {
    static_assert(WG == 2, "D 256: two consumer warpgroups of 64 rows");
    rows_body<T, true>(p, &qmap, &kmap, &vmap);
  } else {
    using G = Geo<D>;
    constexpr int BM = 64 * WG;
    constexpr int BN = BM;  // square tiles: only the diagonal tile needs the mask
    constexpr int ST = stages<D>();
    constexpr int DC = D / col_split<D>();  // this CTA's columns of O
    constexpr uint32_t kQBytes = BM * D * 2;
    constexpr uint32_t kKVBytes = BN * D * 2;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
    unsigned char* q_s = base;
    unsigned char* k_s = q_s + kQBytes;             // stage st at k_s + st * kKVBytes
    unsigned char* v_s = k_s + ST * kKVBytes;  // likewise
    uint64_t* full = reinterpret_cast<uint64_t*>(v_s + ST * kKVBytes);
    uint64_t* empty = full + ST;
    uint64_t* q_full = empty + ST;

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
    const int col0 = DC < D ? static_cast<int>(blockIdx.z) * DC : 0;  // the CTA's first column
    const int n_tiles = (min(p.sq, q0 + BM) + BN - 1) / BN;  // the tile on the diagonal is last
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
#pragma unroll
      for (int st = 0; st < ST; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], WG * 4);
      }
      mbar_init(q_full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == WG * 4) {
      // producer warp: Q once, then K and V tile by tile through the ring
      if (lane == 0) {
        const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
        mbar_expect_tx(q_full, kQBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(q_s + b * BM * G::kRowBytes, &qmap, q_full, b * G::kCols, q0, bh);
        }
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % ST;
          if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kKVBytes);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b) {
            tma_load_3d(k_s + st * kKVBytes + b * BN * G::kRowBytes, &kmap, &full[st],
                        b * G::kCols, t * BN, kv_row);
            tma_load_3d(v_s + st * kKVBytes + b * BN * G::kRowBytes, &vmap, &full[st],
                        b * G::kCols, t * BN, kv_row);
          }
        }
      }
      return;
    }

    // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread holds
    // rows r0 and r0 + 8 of its warp's 16, at columns 8 j + 2 tq (+1)
    const int wg = warp / 4;
    const int tq = lane % 4;
    const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const float qscale = p.qscale;
    float o[DC / 2], s[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, scaled (base-2) units
    float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % ST;
      mbar_wait(&full[st], (t / ST) & 1);
      const unsigned char* ks = k_s + st * kKVBytes;
      // V from the CTA's first column on (P.V on its column slice at D 512 and 576)
      const unsigned char* vs = v_s + st * kKVBytes + col0 / G::kCols * BN * G::kRowBytes;

      // S = Q.K^T: both K-major; a k16 step advances 32 bytes inside a box
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / G::kCols, off = (kk * 16 % G::kCols) * 2;
        const uint64_t da = make_desc(q_s + box * BM * G::kRowBytes + wg * 64 * G::kRowBytes + off,
                                      16, G::kAtom, G::kLayout);
        const uint64_t db = make_desc(ks + box * BN * G::kRowBytes + off, 16, G::kAtom, G::kLayout);
        mma_scores<T, BN>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(s);

      if (t == n_tiles - 1) {  // the diagonal tile: drop keys after the row
        const int k0 = t * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * tq + c;
            if (key > r0) s[4 * j + c] = -CUDART_INF_F;
            if (key > r0 + 8) s[4 * j + 2 + c] = -CUDART_INF_F;
          }
        }
      }

      // online softmax in base 2; every row sees key 0 in its first tile and
      // key k0 in its diagonal one, so the running max is finite from tile 0
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * qscale), mn1 = fmaxf(m1, mx1 * qscale);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const float p00 = exp2f(fmaf(s[4 * j], qscale, -mn0));
          const float p01 = exp2f(fmaf(s[4 * j + 1], qscale, -mn0));
          const float p10 = exp2f(fmaf(s[4 * j + 2], qscale, -mn1));
          const float p11 = exp2f(fmaf(s[4 * j + 3], qscale, -mn1));
          rs0 += p00 + p01;
          rs1 += p10 + p11;
          // the accumulator layout of S is wgmma's register layout of A
          pa[kk][2 * h] = pack2<T>(p00, p01);
          pa[kk][2 * h + 1] = pack2<T>(p10, p11);
        }
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }

      // O += P.V: P from registers, V MN-major (transposed); a k16 step is
      // 16 keys, two 8-row atoms; the second 64-column box (D = 128) is LBO away
      hold(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = make_desc(vs + kk * 16 * G::kRowBytes, BN * G::kRowBytes, G::kAtom,
                                      G::kLayout);
        mma_pv<T, DC>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(o);
      hold(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= p.sq) continue;
      const float l = half ? l1 : l0;
      // T pairs
      uint32_t* orow = reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * D + col0);
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        orow[4 * j + tq] = pack2<T>(o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
      }
      if (tq == 0 && col0 == 0) {  // every column slice holds lse: slice 0 writes it
        p.lse[static_cast<size_t>(bh) * p.sq + row] = (half ? m1 : m0) * kLn2 + logf(l);
      }
    }
  }
}

// The 16-bit general forward on the tensor cores (see the note on top).
// blockIdx.x: (batch, head) row; blockIdx.y: q tile of 64 WG rows, in order;
// blockIdx.z: the column slice of O at D = 512 (halves) and 576 (thirds).
template <typename T, int D, int WG>
__global__ void __launch_bounds__(D == kRowsHeadDim ? kRowsThreads : WG * 128 + 32, 1)
    flash_fwd_rect_kernel(Params p, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core general forward is bf16 or fp16");
  if constexpr (D == kRowsHeadDim) {
    static_assert(WG == 2, "D 256: two consumer warpgroups of 64 rows");
    rows_body<T, false>(p, &qmap, &kmap, &vmap);
  } else {
    using G = Geo<D>;
    constexpr int BM = 64 * WG;
    constexpr int BN = kRingRows;
    constexpr int ST = stages<D>();
    constexpr int DC = D / col_split<D>();  // this CTA's columns of O
    constexpr uint32_t kQBytes = BM * D * 2;
    constexpr uint32_t kKVBytes = BN * D * 2;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
    unsigned char* q_s = base;
    unsigned char* k_s = q_s + kQBytes;             // stage st at k_s + st * kKVBytes
    unsigned char* v_s = k_s + ST * kKVBytes;  // likewise
    int* kid_s = reinterpret_cast<int*>(v_s + ST * kKVBytes);  // [ST][BN]
    int* krange_s = kid_s + ST * BN;                           // [ST][min, max]
    uint64_t* full = reinterpret_cast<uint64_t*>(krange_s + 2 * ST);
    uint64_t* empty = full + ST;
    uint64_t* q_full = empty + ST;

    const bool causal = p.causal != 0;
    const int window = p.window;  // > 0 only under a causal mask (the entry drops it otherwise)
    const bool segments = p.seg != nullptr;
    const int bh = blockIdx.x;
    const int q0 = blockIdx.y * BM;
    const int col0 = DC < D ? static_cast<int>(blockIdx.z) * DC : 0;  // the CTA's first column
    // the keys some row of the CTA can see, by global position: all of them,
    // or up to the last row's diagonal, from the first row's window on
    const int q_end = min(p.sq, q0 + BM);
    const int k_hi = causal ? max(0, min(p.sk, p.q_start + q_end - p.k_start)) : p.sk;
    const int k_lo = window > 0 ? max(0, p.q_start + q0 - window + 1 - p.k_start) : 0;
    const int t_lo = k_lo / BN;
    const int n_tiles = k_lo < k_hi ? (k_hi + BN - 1) / BN - t_lo : 0;
    const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.sk : nullptr;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
#pragma unroll
      for (int st = 0; st < ST; ++st) {
        // the TMA bytes, then (segment ids) each id-staging lane's stores
        mbar_init(&full[st], segments ? 1 + 31 : 1);
        mbar_init(&empty[st], WG * 4);
      }
      mbar_init(q_full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == WG * 4) {
      // producer warp: lane 0 loads Q once (none for an empty walk, so that
      // no TMA is in flight when the CTA exits), then K and V tile by tile
      // through the ring; with segment ids, lanes 1-31 stage each tile's key
      // ids and their range beside it
      if (lane == 0) {
        if (n_tiles > 0) {
          mbar_expect_tx(q_full, kQBytes);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b) {
            tma_load_3d(q_s + b * BM * G::kRowBytes, &qmap, q_full, b * G::kCols, q0, bh);
          }
        }
        const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % ST;
          if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kKVBytes);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b) {
            tma_load_3d(k_s + st * kKVBytes + b * BN * G::kRowBytes, &kmap, &full[st],
                        b * G::kCols, (t_lo + t) * BN, kv_row);
            tma_load_3d(v_s + st * kKVBytes + b * BN * G::kRowBytes, &vmap, &full[st],
                        b * G::kCols, (t_lo + t) * BN, kv_row);
          }
        }
      } else if (segments) {
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % ST;
          if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
          const int2 range = id_range(seg, (t_lo + t) * BN, p.sk, lane - 1, 31, 0xfffffffeu,
                                      kid_s + st * BN);
          if (lane == 1) {
            krange_s[2 * st] = range.x;
            krange_s[2 * st + 1] = range.y;
          }
          mbar_arrive(&full[st]);  // releases this lane's stores to the consumers
        }
      }
      return;
    }

    // consumers: warpgroup wg owns q rows w0 .. w0 + 63; this thread holds
    // rows r0 and r0 + 8 of its warp's 16, at keys 8 j + 2 tq (+1) of a tile
    const int wg = warp / 4;
    const int tq = lane % 4;
    const int w0 = q0 + wg * 64;
    const int r0 = w0 + (warp % 4) * 16 + lane / 4;
    const float qscale = p.qscale;
    const int win = window > 0 ? window : INT_MAX;
    // the global positions of the warpgroup's first row and its last inside sq
    const int qg0 = p.q_start + w0, qg1 = p.q_start + min(w0 + 63, p.sq - 1);
    int qk[2];            // rows r0, r0 + 8 as (global position - k_start): key j is
                          // qk - j positions before the row
    int qid[2] = {0, 0};  // their segment ids
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      qk[h] = p.q_start + row - p.k_start;
      if (segments && row < p.sq) qid[h] = seg[row];
    }
    // the segment ids of the warpgroup's rows: one id throughout when x == y
    const int2 qrange =
        segments ? id_range(seg, w0, p.sq, lane, 32, ~0u, nullptr) : make_int2(0, 1);
    float o[DC / 2], s[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, scaled (base-2) units
    float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % ST;
      const int k0 = (t_lo + t) * BN;
      mbar_wait(&full[st], (t / ST) & 1);
      // global positions of the tile's first key and its last inside sk; some
      // pair is live when the rows' distances to the keys, which run from
      // qg0 - kg1 to qg1 - kg0, meet the band [0, window), and every pair is
      // when they lie inside it and every key is inside sk
      const int kg0 = p.k_start + k0, kg1 = p.k_start + min(k0 + BN - 1, p.sk - 1);
      bool sees = w0 < p.sq;
      bool masked = k0 + BN > p.sk;  // a zero-filled key past sk would score
      if (causal) {
        sees = sees && qg1 >= kg0;
        masked = masked || qg0 < kg1;
      }
      if (window > 0) {
        sees = sees && qg0 - kg1 < window;
        masked = masked || qg1 - kg0 >= window;
      }
      if (segments) {
        // both sides one document each: the fast path when it is the same
        // one, no live pair (and no products) when it is not
        const int kmin = krange_s[2 * st], kmax = krange_s[2 * st + 1];
        const bool uniform = qrange.x == qrange.y && kmin == kmax;
        sees = sees && !(uniform && qrange.x != kmin);
        masked = masked || !uniform;
      }
      if (sees) {
        const unsigned char* ks = k_s + st * kKVBytes;
        const unsigned char* vs = v_s + st * kKVBytes;
        const int2* kid = reinterpret_cast<const int2*>(kid_s + st * BN);
        wgmma_fence();
        mma_rows_by_rows<T, D>(s, q_s, BM, wg * 64, ks);  // S = Q.K^T
        wgmma_commit();
        wgmma_wait_all();
        hold(s);

        // the online softmax in base 2 and P, with the element mask or (a fast
        // tile) without: two instantiations, as the reference's
        // _dispatch_block emits two branches, so that a fast tile issues no
        // mask instruction. A row may see no key yet (a later document, a
        // band edge, or none at all): its max stays -inf, and `safe` keeps
        // exp2 at 0 for its masked scores and its rescale
        auto softmax = [&](auto mask) {
          constexpr bool kMask = decltype(mask)::value;
          if constexpr (kMask) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              int2 kj = make_int2(0, 0);  // the segment ids of keys 8 j + 2 tq (+1)
              if (segments) kj = kid[4 * j + tq];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = k0 + 8 * j + 2 * tq + e % 2;
                const int dist = qk[e / 2] - key;
                bool live = key < p.sk && (!causal || (dist >= 0 && dist < win));
                if (segments) live = live && (e % 2 ? kj.y : kj.x) == qid[e / 2];
                if (!live) s[4 * j + e] = -CUDART_INF_F;
              }
            }
          }
          float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
          }
          const float mn0 = fmaxf(m0, mx0 * qscale), mn1 = fmaxf(m1, mx1 * qscale);
          const float safe0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
          const float safe1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
          const float c0 = exp2f(m0 - safe0), c1 = exp2f(m1 - safe1);
          m0 = mn0;
          m1 = mn1;
          float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 2 * kk + h;
              const float p00 = exp2f(fmaf(s[4 * j], qscale, -safe0));
              const float p01 = exp2f(fmaf(s[4 * j + 1], qscale, -safe0));
              const float p10 = exp2f(fmaf(s[4 * j + 2], qscale, -safe1));
              const float p11 = exp2f(fmaf(s[4 * j + 3], qscale, -safe1));
              rs0 += p00 + p01;
              rs1 += p10 + p11;
              // the accumulator layout of S is wgmma's register layout of A
              pa[kk][2 * h] = pack2<T>(p00, p01);
              pa[kk][2 * h + 1] = pack2<T>(p10, p11);
            }
          }
          l0 = l0 * c0 + rs0;
          l1 = l1 * c1 + rs1;
#pragma unroll
          for (int j = 0; j < DC / 8; ++j) {
            o[4 * j] *= c0;
            o[4 * j + 1] *= c0;
            o[4 * j + 2] *= c1;
            o[4 * j + 3] *= c1;
          }
        };
        if (masked) {
          softmax(std::true_type{});
        } else {
          softmax(std::false_type{});
        }

        hold(pa);
        wgmma_fence();
        mma_frag_by_tile<T, D, DC>(o, pa, vs, col0 / G::kCols);  // O += P.V, V MN-major
        wgmma_commit();
        wgmma_wait_all();
        hold(o);
        hold(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= p.sq) continue;
      // a row that saw no key: O = 0 (nothing was added) and lse = -inf
      const float l = half ? l1 : l0;
      const float denom = l > 0.f ? l : 1.f;
      // T pairs
      uint32_t* orow = reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * D + col0);
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        orow[4 * j + tq] = pack2<T>(o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
      }
      if (tq == 0 && col0 == 0) {
        p.lse[static_cast<size_t>(bh) * p.sq + row] =
            l > 0.f ? (half ? m1 : m0) * kLn2 + logf(l) : -CUDART_INF_F;
      }
    }
  }
}

#ifdef FLASH_HEAD_DIM_WIDE
// ---------------------------------------------------------------------------
// Head dims above 576: the D-streaming forward (see the note on top).
// ---------------------------------------------------------------------------

constexpr int kWideSlab = 256;     // columns of O a 16-bit CTA holds (wgmma's widest N)
constexpr int kWideRing = 2;       // stages of the K ring and of the V ring, a slab's boxes each
constexpr int kWideThreads = 128;  // one warpgroup a 16-bit CTA
constexpr int kWidePartFloats = kRingRows * kRingRows;  // a partial S: 64 x 64 f32
// float4s of the partials a thread sums at the fewest CTAs a q tile (3: 22 rows)
constexpr int kWideXchItems = 3;
static_assert(kWideXchItems * kWideThreads >= (kRingRows + 2) / 3 * (kRingRows / 4),
              "a rank's rows of the exchange in kWideXchItems passes");

constexpr int wide_smem_bytes() {
  // alignment slack, the resident own boxes of Q (a slab's), the K ring and
  // the V ring (a slab's boxes a stage each), two f32 partial S, two 16-bit
  // P tiles with their rows' (correction, running sum), and the barriers
  return kSmemAlign + (1 + 2 * kWideRing) * (kWideSlab / kWideBox) * kWideBoxBytes +
         2 * kWidePartFloats * 4 + 2 * (kWideBoxBytes + kRingRows * 8) + 8 * (2 * kWideRing + 1);
}
static_assert(wide_smem_bytes() <= 232448, "past the shared memory a block may use");

// The float offset of X[a][4 f .. 4 f + 3] in an f32 partial S: row a at 64 a
// floats, the float4s of each half of it swizzled by a & 7, so that a warp's
// stores of its accumulator (eight rows, two float4s each) and the 16 lanes
// that read a row are each one wavefront.
__device__ __forceinline__ int part_at(int a, int f) {
  return a * kRingRows + ((f & 8) | ((f & 7) ^ (a & 7))) * 4;
}

// The 16-bit D-streaming forward on the tensor cores, in clusters (see the
// note on top). blockIdx.x: q tile x (g c) + z; y and z: bh rows, walked
// tile-major (cluster_slot; a plain causal mask's last q tile first). The
// CTA keeps its own columns of the q tile's Q resident and streams its own
// columns of each live key tile's K and V; per key tile it forms a partial S
// over those columns (and, above 8 slabs, its foreign chunks). CTA `rank`
// owns rows [64 rank / c, 64 (rank + 1) / c) of the tile pair: it adds every
// CTA's partial of its rows in rank order (the same bits every run), runs
// the mask and the online softmax there and stores P (rounded to T) and each
// row's (correction, running sum) into every CTA; each CTA then rescales O
// and runs O += P.V on its slab with both operands in shared memory. One
// cluster barrier a tile pair, X(n): partial n and P of tile n - 1 written.
// The partial S of tile n + 1 is formed under the barrier's latency, a tile
// ahead of the exchange. TRI: the triangle; else the general masks, a key
// tile whose documents cannot meet the q tile's skipped by every CTA of the
// cluster (the walk depends on the row, the tiles and the ids alone).
template <typename T, bool TRI>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_kernel(Params p, int d, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core wide forward is bf16 or fp16");
  constexpr int BN = kRingRows;
  constexpr int W = kWideSlab, NB = W / kWideBox, R = kWideRing;
  constexpr uint32_t kSlabBytes = NB * kWideBoxBytes;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* q_s = base;                  // Q's own boxes of the slab
  unsigned char* k_s = q_s + kSlabBytes;      // K stage st: an item's boxes
  unsigned char* v_s = k_s + R * kSlabBytes;  // V stage st: a key tile's own boxes of the slab
  float* xs = reinterpret_cast<float*>(v_s + R * kSlabBytes);  // partial S n % 2 (part_at)
  unsigned char* pt = reinterpret_cast<unsigned char*>(xs + 2 * kWidePartFloats);  // P n % 2
  float2* stats = reinterpret_cast<float2*>(pt + 2 * kWideBoxBytes);  // [2][64] (correction, sum)
  uint64_t* k_full = reinterpret_cast<uint64_t*>(stats + 2 * BN);
  uint64_t* v_full = k_full + R;
  uint64_t* q_full = v_full + R;

  const SlabGeo<W> geo(d);
  const bool causal = p.causal != 0;
  const int window = p.window;  // > 0 only under a causal mask
  const int2 slot =
      cluster_slot(p.rows, (p.sq + BN - 1) / BN, geo.ctas(), TRI || (causal && window <= 0));
  if (slot.x < 0) return;  // the whole cluster
  const int bh = slot.x, q0 = slot.y * BN;
  const SlabCols<W> cols(geo, blockIdx.x % geo.ctas(), d);
  const int b_own = (cols.own0 - cols.g0) / kWideBox;  // the slab's first own box (NB: none)
  const int ni = cols.items();  // a key tile's items: the foreign chunks, then the own boxes
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.sk : nullptr;
  const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;

  // the key tiles some row of the q tile can see by global position: all of
  // them, or up to its last row's diagonal, from its first row's window on;
  // every warp finds the next live one itself
  const int q_end = min(p.sq, q0 + BN);
  const int k_hi = causal ? max(0, min(p.sk, p.q_start + q_end - p.k_start)) : p.sk;
  const int k_lo = window > 0 ? max(0, p.q_start + q0 - window + 1 - p.k_start) : 0;
  const int t_hi = k_lo < k_hi ? (k_hi + BN - 1) / BN : 0;
  const int2 qrange =
      segments ? id_range(seg, q0, p.sq, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    while (segments && t < t_hi &&
           apart(qrange, id_range(seg, t * BN, p.sk, lane, 32, ~0u, nullptr))) {
      ++t;
    }
    return t;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // P.V before the first tile: a zero P (tile 1) at correction 1
  for (int i = threadIdx.x; i < kWideBoxBytes / 16; i += kWideThreads) {
    reinterpret_cast<uint4*>(pt + kWideBoxBytes)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x < BN) stats[BN + threadIdx.x] = make_float2(1.f, 0.f);
  __syncthreads();

  // thread 0 loads the resident Q boxes, then the K items of the walk in
  // order, each once its stage's reader is done; every warp walks the loads
  // with it (a walk in one warp alone puts its id reductions on a path of one
  // warp, where ptxas serializes the wgmma)
  int t = live_from(k_lo / BN);
  int pt_tile = t, pit = 0, pidx = 0;
  auto issue = [&](int limit) {
    while (pidx < limit && pt_tile < t_hi) {
      if (threadIdx.x == 0) {
        unsigned char* stage = k_s + (pidx % R) * kSlabBytes;
        uint64_t* bar = &k_full[pidx % R];
        if (pit < cols.nf) {  // a foreign chunk: its Q box, then its K box
          const int c0 = cols.foreign(pit, geo.c);
          mbar_expect_tx(bar, 2 * kWideBoxBytes);
          tma_load_3d(stage, &qmap, bar, c0, q0, bh);
          tma_load_3d(stage + kWideBoxBytes, &kmap, bar, c0, pt_tile * BN, kv_row);
        } else {  // the own boxes of K, where the slab puts them
          mbar_expect_tx(bar, (NB - b_own) * kWideBoxBytes);
          for (int b = b_own; b < NB; ++b) {
            tma_load_3d(stage + b * kWideBoxBytes, &kmap, bar, cols.g0 + b * kWideBox,
                        pt_tile * BN, kv_row);
          }
        }
      }
      ++pidx;
      if (++pit == ni) {
        pit = 0;
        pt_tile = live_from(pt_tile + 1);
      }
    }
  };
  if (t < t_hi) {
    if (threadIdx.x == 0 && cols.owns()) {
      mbar_expect_tx(q_full, (NB - b_own) * kWideBoxBytes);
      for (int b = b_own; b < NB; ++b) {
        tma_load_3d(q_s + b * kWideBoxBytes, &qmap, q_full, cols.g0 + b * kWideBox, q0, bh);
      }
    }
    issue(R);
    if (cols.owns()) mbar_wait(q_full, 0);
  }

  const float qscale = p.qscale;
  const int win = window > 0 ? window : INT_MAX;
  const int qg0 = p.q_start + q0, qg1 = p.q_start + min(q0 + BN - 1, p.sq - 1);
  // the rows this rank owns, [a0, a1): float4 i = tid + 128 k of them (k <
  // kWideXchItems) at row a0 + i / 16, keys 4 (i % 16) ..; a row's 16 float4s
  // lie in 16 consecutive lanes, which hold its running max and sum
  const int a0 = BN * cols.rank / geo.c, a1 = BN * (cols.rank + 1) / geo.c;
  const int owned = (a1 - a0) * (BN / 4);
  float m[kWideXchItems], l[kWideXchItems];
  int qid[kWideXchItems];
#pragma unroll
  for (int k = 0; k < kWideXchItems; ++k) {
    m[k] = -CUDART_INF_F;
    l[k] = 0.f;
    const int row = q0 + a0 + (static_cast<int>(threadIdx.x) + kWideThreads * k) / (BN / 4);
    qid[k] = segments && row < p.sq ? seg[row] : 0;
  }
  // O at rows 16 w + lane / 4 and 8 more, the slab's columns 8 j + 2 tq (+1)
  float o[W / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;

  int idx = 0;  // K items consumed so far
  // the partial S of key tile `tile` (none past t_hi) over the CTA's columns,
  // item by item; every warp's products (and the last P.V) are done before
  // a stage is loaded again
  auto partial_s = [&](int tile) {
    for (int it = 0; it < (tile < t_hi ? ni : 0); ++it, ++idx) {
      const int st = idx % R;
      const unsigned char* stage = k_s + st * kSlabBytes;
      mbar_wait(&k_full[st], (idx / R) & 1);
      const bool foreign = it < cols.nf;
      const int lo = foreign ? 0 : b_own, hi = foreign ? 1 : NB;
      hold(s);
      wgmma_fence();
      for (int b = lo; b < hi; ++b) {
        mma_box_by_box<T>(s, foreign ? stage : q_s + b * kWideBoxBytes,
                          foreign ? stage + kWideBoxBytes : stage + b * kWideBoxBytes,
                          it == 0 && b == lo);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      hold(o);
      __syncthreads();
      issue(idx + 1 + R);
    }
  };
  // the n-th key tile's own V boxes into stage n % R
  auto load_v = [&](int tile, int n) {
    if (tile < t_hi && threadIdx.x == 0 && cols.owns()) {
      const int vs = n % R;
      mbar_expect_tx(&v_full[vs], (NB - b_own) * kWideBoxBytes);
      for (int b = b_own; b < NB; ++b) {
        tma_load_3d(v_s + vs * kSlabBytes + b * kWideBoxBytes, &vmap, &v_full[vs],
                    cols.g0 + b * kWideBox, tile * BN, kv_row);
      }
    }
  };
  // S into partial n % 2
  auto store_partial = [&](int n) {
    float* xn = xs + (n & 1) * kWidePartFloats;
    const int r = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(xn + part_at(r + 8 * h, 2 * j + tq / 2) + 2 * (tq % 2)) =
            make_float2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
      }
    }
  };

  // tile n is t, tile n + 1 is t1 (its partial S in s). Buffers: partial n
  // is written before X(n) and read by the owners after it, and partial n + 2
  // is written after X(n + 1), which no CTA passes before every owner has
  // read partial n; P n is written after X(n), read after X(n + 1), and P n +
  // 2 is written after X(n + 2), before which every CTA's P.V of tile n is
  // done.
  partial_s(t);
  load_v(t, 0);
  if (t < t_hi) {
    store_partial(0);
    cluster_arrive();  // X(0)
  }
  int t1 = t < t_hi ? live_from(t + 1) : t_hi;
  partial_s(t1);
  int n = 0;
  for (bool go = t < t_hi; go;) {
    cluster_wait();  // X(n)
    if (t1 < t_hi) store_partial(n + 1);
    // O rescaled by its rows' corrections of tile n - 1, then O += P.V of it
    // under this rank's part of the exchange (at the first tile the zero P
    // against the resident Q, finite in every column this CTA writes)
    const int pn = (n + 1) & 1;
    if (n > 0 && cols.owns()) mbar_wait(&v_full[(n - 1) % R], ((n - 1) / R) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float c = stats[pn * BN + warp * 16 + lane / 4 + 8 * h].x;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        o[4 * j + 2 * h] *= c;
        o[4 * j + 2 * h + 1] *= c;
      }
    }
    hold(o);
    fence_proxy_async_cta();  // P's stores, seen through X(n), before wgmma reads them
    wgmma_fence();
    mma_tile_by_slab<T, W>(o, pt + pn * kWideBoxBytes,
                           n > 0 ? v_s + ((n - 1) % R) * kSlabBytes : q_s);
    wgmma_commit();
    const bool live = t < t_hi;
    if (live) {
      // the general kernel's tile rule (flash_fwd_rect_kernel): whether some
      // pair needs the element mask (a key past sk, after a row, outside the
      // window or in another document)
      const int k0 = t * BN;
      const int kg0 = p.k_start + k0, kg1 = p.k_start + min(k0 + BN - 1, p.sk - 1);
      bool masked = k0 + BN > p.sk;
      if (causal) masked = masked || qg0 < kg1;
      if (window > 0) masked = masked || qg1 - kg0 >= window;
      if (segments) {
        masked = masked || !one_doc(qrange, id_range(seg, k0, p.sk, lane, 32, ~0u, nullptr));
      }
      // this rank's rows of tile n: S as every rank's partial in rank order,
      // the mask, the online softmax; P and the rows' (correction, running
      // sum) into every CTA, each float4's as soon as it is formed (no
      // accumulator register is written while the P.V runs: ptxas would
      // serialize every wgmma, C7515)
      const float* xn = xs + (n & 1) * kWidePartFloats;
      unsigned char* ptn = pt + (n & 1) * kWideBoxBytes;
      float2* stn = stats + (n & 1) * BN;
#pragma unroll
      for (int k = 0; k < kWideXchItems; ++k) {
        const int i = static_cast<int>(threadIdx.x) + kWideThreads * k;
        const bool mine = i < owned;
        const int a = a0 + (mine ? i / (BN / 4) : 0), f = i % (BN / 4);
        float sv[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
        if (mine) {
          float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < kF32WideCluster; ++r) {
            if (r < geo.c) x4 = add4(x4, ld_cluster4(cluster_addr(xn + part_at(a, f), r)));
          }
          sv[0] = x4.x;
          sv[1] = x4.y;
          sv[2] = x4.z;
          sv[3] = x4.w;
          if (masked) {
            const int qk = p.q_start + q0 + a - p.k_start;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 4 * f + e;
              const int dist = qk - key;
              bool keep = key < p.sk && (!causal || (dist >= 0 && dist < win));
              if (segments && keep) keep = seg[key] == qid[k];
              if (!keep) sv[e] = -CUDART_INF_F;
            }
          }
        }
        float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
#pragma unroll
        for (int off = 1; off < BN / 4; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        // a row that saw no key yet keeps max -inf: `safe` keeps exp2 at 0
        const float mn = fmaxf(m[k], mx * qscale);
        const float safe = mn == -CUDART_INF_F ? 0.f : mn;
        const float corr = exp2f(m[k] - safe);
        m[k] = mn;
        float pe[4], rs = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = exp2f(fmaf(sv[e], qscale, -safe));
          rs += pe[e];
        }
#pragma unroll
        for (int off = 1; off < BN / 4; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[k] = l[k] * corr + rs;
        if (mine) {
          const uint2 pv = make_uint2(pack2<T>(pe[0], pe[1]), pack2<T>(pe[2], pe[3]));
          const uint2 sl = make_uint2(__float_as_uint(corr), __float_as_uint(l[k]));
          for (int r = 0; r < geo.c; ++r) {
            st_cluster2(cluster_addr(ptn + tile16_at(a, f), r), pv);
            if (f == 0) st_cluster2(cluster_addr(stn + a, r), sl);
          }
        }
      }
    }
    wgmma_wait<0>();
    hold(o);
    if (!live) break;
    cluster_arrive();  // X(n + 1)
    // under the barrier: the partial S two tiles on, then tile n + 1's V
    // (its stage's last P.V, of tile n - 1, done in every warp)
    const int t2 = t1 < t_hi ? live_from(t1 + 1) : t_hi;
    partial_s(t2);
    if (t2 >= t_hi) __syncthreads();
    load_v(t1, n + 1);
    t = t1;
    t1 = t2;
    ++n;
  }

  // the rows' sums: the last tile's statistics (none after an empty walk,
  // whose rows get O = 0 and lse = -inf); no barrier after the walk, since
  // every access to another CTA's shared memory came before the last X
  const float2* last = stats + ((n + 1) & 1) * BN;
  T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int a = warp * 16 + lane / 4 + 8 * half;
    const int row = q0 + a;
    if (row >= p.sq || !cols.owns()) continue;
    const float lr = n > 0 ? last[a].y : 0.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * d + cols.g0);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (cols.g0 + 8 * j < cols.own0) continue;  // an earlier slab's columns
      orow[4 * j + tq] =
          lr > 0.f ? pack2<T>(o[4 * j + 2 * half] / lr, o[4 * j + 2 * half + 1] / lr) : 0u;
    }
  }
  if (blockIdx.x % geo.ctas() < geo.c) {  // the first cluster's owners write lse
#pragma unroll
    for (int k = 0; k < kWideXchItems; ++k) {
      const int i = static_cast<int>(threadIdx.x) + kWideThreads * k;
      const int row = q0 + a0 + i / (BN / 4);
      if (i < owned && i % (BN / 4) == 0 && row < p.sq) {
        p.lse[static_cast<size_t>(bh) * p.sq + row] =
            l[k] > 0.f ? m[k] * kLn2 + logf(l[k]) : -CUDART_INF_F;
      }
    }
  }
}

#ifndef FLASH_ELEM_F16  // the f32 kernels live in the bf16 library (kWithF32)
// ---------------------------------------------------------------------------
// f32 at head dims 256 and above: slab CTAs in a thread-block cluster (see
// the note on top; slabs, clusters and tiles: flash_cluster.cuh).
// ---------------------------------------------------------------------------

// The q rows of an f32 cluster CTA: 64, or 16 for a call of at most 16 q
// rows (serving's prefill chunk), chosen from sq (flash_fwd.py::f32_rows).
__host__ __device__ constexpr int f32_rows(int sq) { return sq <= 16 ? 16 : kF32WideTile; }

template <int BM>
constexpr int f32_cluster_smem_bytes() {
  // the Q slab times qscale ([BM][128]), two stages of the streamed ring (a K
  // and a V slab, or a foreign Q and K chunk), the partial scores (64 / BM
  // parts of [BM][64]: 64 x 64 floats), P ([BM][64]) and per q row its
  // correction and running sum (a float4)
  return 4 * (BM * kF32WideSlab + kF32WideStages * 2 * kF32WideTile * kF32WideSlab +
              kF32WideTile * kF32WideTile + BM * kF32WideTile + 4 * BM);
}
static_assert(f32_cluster_smem_bytes<kF32WideTile>() <= 232448,
              "past the shared memory a block may use");

// The thread's (ta, tb, part): q rows 4 ta .. 4 ta + 3 and keys 4 tb .. 4 tb
// + 3 of the score tile, q rows 4 ta .. and slab columns 4 (tb + 16 h) .. of
// O, and its share of each reduction (at BM 16 one of four: a quarter of the
// columns in the score loop, of the keys in P.V); a warp covers four ta and
// eight tb, as f32_wide_thread.
template <int BM>
__device__ __forceinline__ int3 f32_cluster_thread() {
  if constexpr (BM == kF32WideTile) {
    const int2 t = f32_wide_thread();
    return make_int3(t.x, t.y, 0);
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return make_int3(lane >> 3, (lane & 7) | ((warp & 1) << 3), warp >> 1);
  }
}

// sc[i][j] += A(4 ta + i) . B(4 tb + j) over the float4 columns [f0, f1) of
// swizzled [rows][WA] (A: q rows) and [64][WB] (B: keys) tiles, an f32 FMA
// chain in column order; SA: A's values times qscale first (q's share of
// the score, rounded as attend rounds it). 8 float4 loads for 64 FMAs; a
// warp's four values of ta and eight of tb read one wavefront each.
template <int WA, int WB, bool SA>
__device__ __forceinline__ void partial_scores(float (&sc)[4][4], const float* A, const float* B,
                                               int ta, int tb, int f0, int f1, float qscale) {
  const float* a_row = A + 4 * ta * WA;
  const float* b_row = B + 4 * tb * WB;
  const int xa = ta & 7, xb = tb & 7;  // the rows' swizzle
#pragma unroll 2
  for (int f = f0; f < f1; ++f) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(b_row + j * WB + ((f ^ xb) << 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 a = ld4(a_row + i * WA + ((f ^ xa) << 2));
      if (SA) a = scale4(a, qscale);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a.x, b[j].x, sc[i][j]);
        sc[i][j] = fmaf(a.y, b[j].y, sc[i][j]);
        sc[i][j] = fmaf(a.z, b[j].z, sc[i][j]);
        sc[i][j] = fmaf(a.w, b[j].w, sc[i][j]);
      }
    }
  }
}

// Whether q row qi attends key kj (both local): the triangle's diagonal, or
// the general masks (key < sk, the causal band at the global offsets, the
// window, equal segment ids; seg: the batch row's ids or nullptr).
template <bool TRI>
__device__ __forceinline__ bool keeps(const Params& p, int qi, int kj, const int* seg) {
  if (qi >= p.sq || kj >= p.sk) return false;
  if (TRI) return kj <= qi;
  if (p.causal) {
    const int dist = (p.q_start + qi) - (p.k_start + kj);
    if (dist < 0 || (p.window > 0 && dist >= p.window)) return false;
  }
  return seg == nullptr || seg[qi] == seg[kj];
}

// The cluster's exchange and softmax of one tile pair (q rows from q0, keys
// from k0). Every CTA holds a partial S over its columns (sc, at the
// thread's th; at BM 16 one of four parts), written to its xs as
// X[part][row][key]. CTA `rank` of c owns the q rows [BM rank / c, BM (rank
// + 1) / c), 16 threads a row and four keys a thread, one pass per 16 rows:
// it adds every CTA's partials (and parts) in rank order (the same bits
// every run), applies the tile's mask, runs the base-2 online softmax (m, l:
// the pass's row's running max and sum, kept by its 16 threads across the
// walk; the -inf guards keep a row that sees no key at O = 0) and stores P
// into every CTA's ps ([row][key]) and the row's (correction, running sum)
// into every CTA's stats. Two cluster barriers: the partials written; P and
// the stats in. xs and ps are apart, so the next pair's partials never
// overwrite what an owner still reads.
template <bool TRI, int BM>
__device__ __forceinline__ void softmax_exchange(const Params& p, float* xs, float* ps,
                                                 float4* stats, const float (&sc)[4][4], int3 th,
                                                 int c, int q0, int k0, const int* seg,
                                                 float (&m)[2], float (&l)[2]) {
  constexpr int kParts = kF32WideTile / BM;
  constexpr int kPartFloats = BM * kF32WideTile;
  float* part = xs + th.z * kPartFloats;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st4(part + (4 * th.x + i) * kF32WideTile + 4 * th.y,
        make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]));
  }
  cluster_sync();
  const int rank = static_cast<int>(cluster_rank());
  const int a0 = BM * rank / c, a1 = BM * (rank + 1) / c;
  const int f = threadIdx.x & 15;  // the thread's keys 4 f .. 4 f + 3
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // at most 32 rows a CTA (c >= 2)
    const int row = a0 + static_cast<int>(threadIdx.x >> 4) + 16 * j;
    const bool mine = row < a1;
    float s[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    if (mine) {
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < c; ++r) {
        const uint32_t x = cluster_addr(xs + row * kF32WideTile + 4 * f, r);
#pragma unroll
        for (int pp = 0; pp < kParts; ++pp) {
          const float4 u = ld_cluster4(x + 4 * pp * kPartFloats);
          s4 = make_float4(s4.x + u.x, s4.y + u.y, s4.z + u.z, s4.w + u.w);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (keeps<TRI>(p, q0 + row, k0 + 4 * f + e, seg)) s[e] = comp(s4, e);
      }
    }
    // the row's 16 threads are a half warp; every lane takes part
    float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[j], mx);
    const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
    const float corr = (m[j] == -CUDART_INF_F) ? 0.f : exp2f(m[j] - safe);
    float pe[4], rs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pe[e] = (s[e] == -CUDART_INF_F) ? 0.f : exp2f(s[e] - safe);
      rs += pe[e];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l[j] = l[j] * corr + rs;
    m[j] = m_new;
    if (mine) {
      const float4 pv = make_float4(pe[0], pe[1], pe[2], pe[3]);
      const float4 stat = make_float4(corr, l[j], 0.f, 0.f);
      for (int r = 0; r < c; ++r) {
        st_cluster4(cluster_addr(ps + row * kF32WideTile + 4 * f, r), pv);
        if (f == 0) st_cluster4(cluster_addr(stats + row, r), stat);
      }
    }
  }
  cluster_sync();
}

// acc[i][4 h + e] += sum over the thread's keys r of P[4 ta + i][r] * V[r][4
// (tb + 16 h) + e] (P [BM][64]; V a swizzled [64][128] slab): a thread's 4 x
// 8 block of the O slab over all 64 keys, or at BM 16 over its part's 16.
// 12 float4 loads for 128 FMAs.
template <int BM>
__device__ __forceinline__ void pv_product(float (&acc)[4][8], const float* P, const float* V,
                                           int3 th) {
  const float* p_rows = P + 4 * th.x * kF32WideTile;
  const int r0 = th.z * BM;
#pragma unroll 2
  for (int r = r0; r < r0 + BM; r += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = ld4(p_rows + i * kF32WideTile + r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 y0 = ld4(V + swz<kF32WideSlab>(r + k, th.y));
      const float4 y1 = ld4(V + swz<kF32WideSlab>(r + k, th.y + 16));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = comp(pa[i], k);
        acc[i][0] = fmaf(x, y0.x, acc[i][0]);
        acc[i][1] = fmaf(x, y0.y, acc[i][1]);
        acc[i][2] = fmaf(x, y0.z, acc[i][2]);
        acc[i][3] = fmaf(x, y0.w, acc[i][3]);
        acc[i][4] = fmaf(x, y1.x, acc[i][4]);
        acc[i][5] = fmaf(x, y1.y, acc[i][5]);
        acc[i][6] = fmaf(x, y1.z, acc[i][6]);
        acc[i][7] = fmaf(x, y1.w, acc[i][7]);
      }
    }
  }
}

// The f32 forward at a head dim d of 256 and above on the CUDA cores, in
// clusters (see the note on top). blockIdx.x: q tile x (g c) + z (the
// triangle's q tiles heaviest first); y and z: bh rows (kMaxGridY a z
// slice). TRI: the triangle; else the general masks, the key tiles of the
// band, a key tile whose documents cannot meet the q tile's skipped (by
// every CTA of the cluster: the walk depends on the row, the tiles and the
// ids alone, so the CTAs meet at every barrier).
template <bool TRI, int BM>
__device__ __forceinline__ void attend_cluster(const Params& p, int d) {
  constexpr int kParts = kF32WideTile / BM;
  constexpr int kSlabFloats = kF32WideTile * kF32WideSlab;
  extern __shared__ float4 f32c_smem[];
  float* qres = reinterpret_cast<float*>(f32c_smem);  // the Q slab times qscale
  float* ring = qres + BM * kF32WideSlab;  // per stage: K and V slabs, or Q and K chunks
  float* xs = ring + kF32WideStages * 2 * kSlabFloats;
  float* ps = xs + kF32WideTile * kF32WideTile;
  float4* stats = reinterpret_cast<float4*>(ps + BM * kF32WideTile);

  const int bh = blockIdx.z * kMaxGridY + blockIdx.y;
  if (bh >= p.rows) return;  // the whole cluster: it shares y and z
  const F32WideGeo geo(d);
  const int z = blockIdx.x % geo.ctas();
  const F32WideCols cols(geo, z, d);
  const int tile = blockIdx.x / geo.ctas();
  const int q0 = (TRI ? (p.sq + BM - 1) / BM - 1 - tile : tile) * BM;
  const int3 th = f32_cluster_thread<BM>();
  const int b = bh / p.heads;
  // grouped-query attention: q heads share kv heads in groups (_kv_row)
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.sq * d;
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.sk * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.sk * d;
  const int* seg = !TRI && p.seg != nullptr ? p.seg + static_cast<size_t>(b) * p.sk : nullptr;
  const int lane = threadIdx.x & 31;

  // the key tiles some row of this q tile can see by global position: all,
  // or up to its last row's diagonal, from its first row's window on (maybe
  // none); every warp finds the next live one itself (the ids' range by
  // warp reductions)
  const int q_end = min(q0 + BM, p.sq);
  int k_lo = 0, k_hi = p.sk;
  if (TRI) {
    k_hi = min(p.sk, q_end);
  } else if (p.causal) {
    k_hi = max(0, min(p.sk, p.q_start + q_end - p.k_start));
    if (p.window > 0) k_lo = max(0, p.q_start + q0 - p.window + 1 - p.k_start);
  }
  const int t_lo = k_lo / kF32WideTile;
  const int t_hi = k_lo < k_hi ? (k_hi + kF32WideTile - 1) / kF32WideTile : t_lo;
  const int2 qrange =
      seg != nullptr ? id_range<BM>(seg, q0, p.sq, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    for (; seg != nullptr && t < t_hi; ++t) {
      const int2 krange = id_range(seg, t * kF32WideTile, p.sk, lane, 32, ~0u, nullptr);
      // a live pair unless both sides are one document each, different ones
      if (!(qrange.x == qrange.y && krange.x == krange.y && qrange.x != krange.x)) break;
    }
    return t;
  };
  const int items = cols.items();
  auto fetch = [&](int t, int it, int st) {
    float* dst = ring + st * 2 * kSlabFloats;
    const int k0 = t * kF32WideTile;
    if (it < cols.nf) {
      const int c0 = cols.foreign(it, geo.c);
      load_tile<kF32WideChunk, BM>(dst, qg, q0, p.sq, d, c0);
      load_tile<kF32WideChunk>(dst + kSlabFloats, kg, k0, p.sk, d, c0);
    } else {
      load_tile<kF32WideSlab>(dst, kg, k0, p.sk, d, cols.g0);
      load_tile<kF32WideSlab>(dst + kSlabFloats, vg, k0, p.sk, d, cols.g0);
    }
  };
  // the thread's share of a score loop over the float4 columns [f0, f1)
  auto share = [&](int f0, int f1) {
    return make_int2(f0 + (f1 - f0) * th.z / kParts, f0 + (f1 - f0) * (th.z + 1) / kParts);
  };

  int t = live_from(t_lo);
  if (cols.owns()) load_tile<kF32WideSlab, BM>(qres, qg, q0, p.sq, d, cols.g0);
  cp_async_commit();
  if (t < t_hi && items > 0) fetch(t, 0, 0);
  cp_async_commit();
  for (int r = threadIdx.x; r < BM; r += kF32Threads) stats[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait<1>();  // the resident slab
  __syncthreads();
  // q pre-scaled in f32, as attend scales it (flashattention.py:750)
  for (int e = threadIdx.x; e < BM * kF32WideSlab; e += kF32Threads) qres[e] *= p.qscale;

  float acc[4][8], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int st = 0;  // the stage of the next item
  while (t < t_hi) {
    const int next = live_from(t + 1);
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    const float* vslab = nullptr;  // the main item's V slab
    for (int it = 0; it < items; ++it) {
      // the item after this one loads under this one's products
      if (it + 1 < items) {
        fetch(t, it + 1, st ^ 1);
      } else if (next < t_hi) {
        fetch(next, 0, st ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* sp = ring + st * 2 * kSlabFloats;
      if (it < cols.nf) {
        const int2 fs = share(0, kF32WideChunk / 4);
        partial_scores<kF32WideChunk, kF32WideChunk, true>(sc, sp, sp + kSlabFloats, th.x, th.y,
                                                           fs.x, fs.y, p.qscale);
        __syncthreads();  // the stage is free for the item after the next
      } else {
        const int2 fs = share((cols.own0 - cols.g0) / 4, (cols.own1 - cols.g0) / 4);
        partial_scores<kF32WideSlab, kF32WideSlab, false>(sc, qres, sp, th.x, th.y, fs.x, fs.y,
                                                          1.f);
        vslab = sp + kSlabFloats;
      }
      st ^= 1;
    }
    softmax_exchange<TRI, BM>(p, xs, ps, stats, sc, th, geo.c, q0, t * kF32WideTile, seg, m, l);
    if (vslab != nullptr) {  // O = O * corr + P . V_slab
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float corr = stats[4 * th.x + i].x;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
      }
      pv_product<BM>(acc, ps, vslab, th);
    }
    __syncthreads();  // the main stage is free
    t = next;
  }
  cp_async_wait<0>();

  // lse: the owners of the tile's first cluster
  if (z < geo.c && (threadIdx.x & 15) == 0) {
    const int rank = z;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = BM * rank / geo.c + static_cast<int>(threadIdx.x >> 4) + 16 * j;
      const int qi = q0 + row;
      if (row < BM * (rank + 1) / geo.c && qi < p.sq) {
        const bool live = l[j] > 0.f && m[j] != -CUDART_INF_F;
        p.lse[static_cast<size_t>(bh) * p.sq + qi] =
            live ? m[j] * kLn2 + logf(l[j]) : -CUDART_INF_F;
      }
    }
  }
  if (!cols.owns()) return;
  if constexpr (kParts > 1) {
    // the parts' sums of O through the free ring, added in part order
    __syncthreads();
    if (th.z > 0) {
      float* red = ring + (th.z - 1) * BM * kF32WideSlab;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          st4(red + (4 * th.x + i) * kF32WideSlab + 4 * (th.y + 16 * h),
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
        }
    }
    __syncthreads();
    if (th.z > 0) return;
    for (int pp = 1; pp < kParts; ++pp) {
      const float* other = ring + (pp - 1) * BM * kF32WideSlab;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 u = ld4(other + (4 * th.x + i) * kF32WideSlab + 4 * (th.y + 16 * h));
          acc[i][4 * h] += u.x;
          acc[i][4 * h + 1] += u.y;
          acc[i][4 * h + 2] += u.z;
          acc[i][4 * h + 3] += u.w;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = stats[4 * th.x + i].y;
    const float denom = (sum == 0.f) ? 1.f : sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] /= denom;
  }
  store_block(static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.sq * d, acc, q0, p.sq, d,
              cols, th.x, th.y);
}

// The f32 forward kernels at head dims 256 and above: the triangle (TRI) and
// the general masks, each at 64- and 16-row q tiles, launched in clusters of
// F32WideGeo(d).c CTAs on the grid's x.
template <bool TRI, int BM>
__global__ void __launch_bounds__(kF32Threads, 1) flash_fwd_f32_cluster_kernel(Params p, int d) {
  attend_cluster<TRI, BM>(p, d);
}

// Each kernel's answers of cudaOccupancyMaxActiveClusters (flash_cluster.cuh).
template <bool TRI, int BM>
ClusterCounts& f32_cluster_counts() {
  static ClusterCounts counts;
  return counts;
}

template <bool TRI, int BM>
int f32_cluster_clusters(int d) {
  return active_clusters(flash_fwd_f32_cluster_kernel<TRI, BM>, F32WideGeo(d).c,
                         f32_cluster_smem_bytes<BM>(), f32_cluster_counts<TRI, BM>());
}

template <bool TRI, int BM>
int launch_f32_cluster(const Params& p, int bh, int d, int smem, cudaStream_t stream) {
  if (smem != f32_cluster_smem_bytes<BM>()) return kUnsupported;
  const F32WideGeo geo(d);
  return launch_clusters(flash_fwd_f32_cluster_kernel<TRI, BM>,
                         cluster_grid((p.sq + BM - 1) / BM, geo.ctas(), bh), geo.c, kF32Threads,
                         smem, stream, f32_cluster_counts<TRI, BM>(), p, d);
}

// ---------------------------------------------------------------------------
// f32 at head dims 32, 64 and 128: the cluster forward at one CTA a tile (see
// the note on top).
// ---------------------------------------------------------------------------

// The head dims of the f32 tile forward (flash_fwd.py::F32_TILE_HEAD_DIMS);
// 16 keeps attend in the base library.
__host__ __device__ constexpr bool f32_tile_head_dim(int d) {
  return d == 32 || d == 64 || d == 128;
}
// P's row stride: the two rows a warp reads at once in P.V fall 16 banks apart
constexpr int kF32TilePStride = kF32WideTile + 4;
// CTAs an SM: two or more at a 32- or 64-column slab (at most 128 registers a
// thread), else one
constexpr int f32_tile_ctas(int w) { return w < kF32WideSlab ? 2 : 1; }
template <int W, int BM>
constexpr int f32_tile_smem_bytes() {
  // Q times qscale ([BM][W]), two stages of a K and a V tile ([64][W]), P
  // ([BM][kF32TilePStride])
  return 4 * (BM * W + kF32WideStages * 2 * kF32WideTile * W + BM * kF32TilePStride);
}
static_assert(2 * (f32_tile_smem_bytes<64, kF32WideTile>() + 1024) <= 233472,
              "two CTAs an SM at a 64-column slab");
static_assert(f32_tile_smem_bytes<kF32WideSlab, kF32WideTile>() <= 232448,
              "past the shared memory a block may use");

// acc[i][4 h + e] += sum over the 64 keys r, in order, of P[RM ty + i][r] *
// V[r][4 (tx + 16 h) + e] (at W 32: acc[i][e] over V[r][2 tx + e]; P
// [BM][kF32TilePStride]; V a swizzled [64][W] tile): a thread's RM x (W /
// 16) block of O. A 4-key step at RM 4 takes 4 + 4 W / 64 float4 loads for
// W FMAs (8 for 64 at W 64, 12 for 128 at 128; at W 32 four float4s and
// four float2s for 32).
template <int W, int RM>
__device__ __forceinline__ void pv_rows(float (&acc)[RM][W / 16], const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int H = W / 64;  // float4 columns of O a thread holds (W 32: one float2)
  const float* p_rows = P + RM * ty * kF32TilePStride;
#pragma unroll 2
  for (int r = 0; r < kF32WideTile; r += 4) {
    float4 pa[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) pa[i] = ld4(p_rows + i * kF32TilePStride + r);
    if constexpr (W == 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 y =
            *reinterpret_cast<const float2*>(V + swz<W>(r + k, tx >> 1) + 2 * (tx & 1));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float x = comp(pa[i], k);
          acc[i][0] = fmaf(x, y.x, acc[i][0]);
          acc[i][1] = fmaf(x, y.y, acc[i][1]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4 y[H];
#pragma unroll
        for (int h = 0; h < H; ++h) y[h] = ld4(V + swz<W>(r + k, tx + 16 * h));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float x = comp(pa[i], k);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            acc[i][4 * h] = fmaf(x, y[h].x, acc[i][4 * h]);
            acc[i][4 * h + 1] = fmaf(x, y[h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(x, y[h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(x, y[h].w, acc[i][4 * h + 3]);
          }
        }
      }
    }
  }
}

// The f32 forward at head dims 32, 64 and 128 on the CUDA cores, a CTA a
// q tile of BM rows (64, or 16 for a call of at most 16) whose head is one
// slab of W columns (see the note on top). blockIdx.x: q tile; y and z: bh
// rows (kMaxGridY a z slice), walked tile-major (cluster_slot; a plain causal
// mask's last q tile first).
// Thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) holds S at q rows
// RM ty + i and keys 4 tx + j, and O at the same rows, columns 4 (tx + 16 h)
// + e: a row's 16 threads are a half warp, so its max and sum are shuffles
// and its correction never leaves registers. Per key tile: one barrier
// before the scores (the tile's K and V landed, the last tile's P and stage
// read: the next tile's K and V then load under this one), one before O +=
// P.V. TRI: the triangle; else the general masks, the key tiles of the band
// by global position, a key tile whose documents cannot meet the q tile's
// skipped by every warp.
template <bool TRI, int W, int BM>
__device__ __forceinline__ void attend_tile(const Params& p, int d) {
  constexpr int RM = BM / 16;  // q rows a thread
  constexpr int kSlab = kF32WideTile * W;
  extern __shared__ float4 f32t_smem[];
  float* qres = reinterpret_cast<float*>(f32t_smem);  // the Q tile times qscale
  float* ring = qres + BM * W;                         // per stage: the K and V tiles
  float* ps = ring + kF32WideStages * 2 * kSlab;       // P

  // tile-major, the longest walks first (a plain causal mask's last q tile)
  const int2 slot =
      cluster_slot(p.rows, (p.sq + BM - 1) / BM, 1, TRI || (p.causal && p.window <= 0));
  if (slot.x < 0) return;  // past the last CTA in the last z slice
  const int bh = slot.x;
  const int q0 = slot.y * BM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = bh / p.heads;
  // grouped-query attention: q heads share kv heads in groups (_kv_row)
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.sq * d;
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.sk * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.sk * d;
  const int* seg = !TRI && p.seg != nullptr ? p.seg + static_cast<size_t>(b) * p.sk : nullptr;
  const int lane = threadIdx.x & 31;

  // the key tiles some row of this q tile can see by global position (maybe
  // none), less those whose documents cannot meet the q tile's, which every
  // warp finds from the ids' range itself (attend_cluster's walk)
  const int q_end = min(q0 + BM, p.sq);
  int k_lo = 0, k_hi = p.sk;
  if (TRI) {
    k_hi = min(p.sk, q_end);
  } else if (p.causal) {
    k_hi = max(0, min(p.sk, p.q_start + q_end - p.k_start));
    if (p.window > 0) k_lo = max(0, p.q_start + q0 - p.window + 1 - p.k_start);
  }
  const int t_lo = k_lo / kF32WideTile;
  const int t_hi = k_lo < k_hi ? (k_hi + kF32WideTile - 1) / kF32WideTile : t_lo;
  const int2 qrange =
      seg != nullptr ? id_range<BM>(seg, q0, p.sq, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    for (; seg != nullptr && t < t_hi; ++t) {
      const int2 krange = id_range(seg, t * kF32WideTile, p.sk, lane, 32, ~0u, nullptr);
      // a live pair unless both sides are one document each, different ones
      if (!(qrange.x == qrange.y && krange.x == krange.y && qrange.x != krange.x)) break;
    }
    return t;
  };
  auto fetch = [&](int t, int st) {
    float* dst = ring + st * 2 * kSlab;
    load_head<W>(dst, kg, t * kF32WideTile, p.sk, d);
    load_head<W>(dst + kSlab, vg, t * kF32WideTile, p.sk, d);
  };

  int t = live_from(t_lo);
  load_head<W, BM>(qres, qg, q0, p.sq, d);
  if (t < t_hi) fetch(t, 0);
  cp_async_commit();
  float m[RM], l[RM], acc[RM][W / 16];
  int qseg[RM];  // the thread's rows' segment ids
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < W / 16; ++c) acc[i][c] = 0.f;
    const int qi = q0 + RM * ty + i;
    qseg[i] = seg != nullptr && qi < p.sq ? seg[qi] : 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  // q pre-scaled in f32, as attend scales it (flashattention.py:750)
  for (int e = threadIdx.x; e < BM * W; e += kF32Threads) qres[e] *= p.qscale;

  int st = 0;  // the stage of tile t
  while (t < t_hi) {
    const int next = live_from(t + 1);
    const int k0 = t * kF32WideTile;
    int kseg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + 4 * tx + j;
      kseg[j] = seg != nullptr && kj < p.sk ? seg[kj] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();  // tile t's K and V in; the last tile's P and stage read
    if (next < t_hi) fetch(next, st ^ 1);
    cp_async_commit();
    const float* kv = ring + st * 2 * kSlab;
    float sc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    tile_scores<W, false, RM>(sc, qres, kv, ty, tx, d / 4, 1.f);

    // the mask, then the online softmax in base 2 (attend's; the -inf guards
    // keep a row that sees no key at O = 0); P into ps, O rescaled
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + RM * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        bool keep = qi < p.sq && kj < p.sk;
        if (TRI) {
          keep = keep && kj <= qi;
        } else {
          if (p.causal) {
            const int dist = (p.q_start + qi) - (p.k_start + kj);
            keep = keep && dist >= 0 && (p.window <= 0 || dist < p.window);
          }
          if (seg != nullptr) keep = keep && qseg[i] == kseg[j];
        }
        if (!keep) sc[i][j] = -CUDART_INF_F;
      }
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float corr = (m[i] == -CUDART_INF_F) ? 0.f : exp2f(m[i] - safe);
      float pe[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pe[j] = (sc[i][j] == -CUDART_INF_F) ? 0.f : exp2f(sc[i][j] - safe);
        rs += pe[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
      st4(ps + (RM * ty + i) * kF32TilePStride + 4 * tx, make_float4(pe[0], pe[1], pe[2], pe[3]));
#pragma unroll
      for (int c = 0; c < W / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P in
    pv_rows<W, RM>(acc, ps, kv + kSlab, ty, tx);  // O += P . V
    st ^= 1;
    t = next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < W / 16; ++c) acc[i][c] /= denom;
    const int qi = q0 + RM * ty + i;
    if (tx == 0 && qi < p.sq) {
      const bool live = l[i] > 0.f && m[i] != -CUDART_INF_F;
      p.lse[static_cast<size_t>(bh) * p.sq + qi] = live ? m[i] * kLn2 + logf(l[i]) : -CUDART_INF_F;
    }
  }
  store_head<W, RM>(static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.sq * d, acc, q0, p.sq,
                    d, ty, tx);
}

// The f32 forward kernels at head dims 32, 64 and 128: the triangle and the
// general masks at slab width W (the head dim) and BM q rows (64 or 16), one
// CTA a q tile.
template <int W, int BM>
__global__ void __launch_bounds__(kF32Threads, f32_tile_ctas(W))
    flash_fwd_tri_tile_f32_kernel(Params p, int d) {
  attend_tile<true, W, BM>(p, d);
}

template <int W, int BM>
__global__ void __launch_bounds__(kF32Threads, f32_tile_ctas(W))
    flash_fwd_rect_tile_f32_kernel(Params p, int d) {
  attend_tile<false, W, BM>(p, d);
}

template <bool TRI, int W, int BM>
auto f32_tile_kernel() {
  if constexpr (TRI) {
    return flash_fwd_tri_tile_f32_kernel<W, BM>;
  } else {
    return flash_fwd_rect_tile_f32_kernel<W, BM>;
  }
}

// How many CTAs of the tile kernel the current card holds at once (its SMs
// times cudaOccupancyMaxActiveBlocksPerMultiprocessor at the plan's shared
// memory), asked once per card; a negative CUDA error code when the query
// fails.
template <bool TRI, int W, int BM>
int f32_tile_resident() {
  static int known[kCachedCards] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (card < kCachedCards && known[card] != 0) return known[card];
  constexpr int smem = f32_tile_smem_bytes<W, BM>();
  const auto kernel = f32_tile_kernel<TRI, W, BM>();
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kF32Threads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (card < kCachedCards) known[card] = sms * per_sm;
  return sms * per_sm;
}

// The tile kernel at slab width W and BM q rows: grid (q tiles, rows, z
// slices), one CTA a tile.
template <bool TRI, int W, int BM>
int launch_f32_tile(const Params& p, int bh, int d, int smem, cudaStream_t stream) {
  if (smem != f32_tile_smem_bytes<W, BM>()) return kUnsupported;
  const auto kernel = f32_tile_kernel<TRI, W, BM>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cluster_grid((p.sq + BM - 1) / BM, 1, bh), kF32Threads, smem, stream>>>(p, d);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel of the plan: its slab f32_tile_width(d), block_m q rows (64
// or 16).
template <bool TRI>
int dispatch_f32_tile(const Params& p, int bh, int d, int block_m, int smem,
                      cudaStream_t stream) {
  if (d <= 32) {
    return block_m == kF32WideTile ? launch_f32_tile<TRI, 32, kF32WideTile>(p, bh, d, smem, stream)
                                   : launch_f32_tile<TRI, 32, 16>(p, bh, d, smem, stream);
  }
  if (d <= 64) {
    return block_m == kF32WideTile ? launch_f32_tile<TRI, 64, kF32WideTile>(p, bh, d, smem, stream)
                                   : launch_f32_tile<TRI, 64, 16>(p, bh, d, smem, stream);
  }
  return block_m == kF32WideTile
             ? launch_f32_tile<TRI, kF32WideSlab, kF32WideTile>(p, bh, d, smem, stream)
             : launch_f32_tile<TRI, kF32WideSlab, 16>(p, bh, d, smem, stream);
}

template <bool TRI>
int f32_tile_resident_at(int d, int block_m) {
  if (d <= 32) {
    return block_m == kF32WideTile ? f32_tile_resident<TRI, 32, kF32WideTile>()
                                   : f32_tile_resident<TRI, 32, 16>();
  }
  if (d <= 64) {
    return block_m == kF32WideTile ? f32_tile_resident<TRI, 64, kF32WideTile>()
                                   : f32_tile_resident<TRI, 64, 16>();
  }
  return block_m == kF32WideTile ? f32_tile_resident<TRI, kF32WideSlab, kF32WideTile>()
                                 : f32_tile_resident<TRI, kF32WideSlab, 16>();
}
#endif  // FLASH_ELEM_F16

// The clusters of the 16-bit wide forward resident on each card, per mask
// and cluster size (asked once: active_clusters).
template <bool TRI>
ClusterCounts& wide_counts() {
  static ClusterCounts counts;
  return counts;
}

// How many clusters of the library's 16-bit wide forward at head dim d the
// current card holds at once; a negative CUDA error code when the query
// fails.
template <bool TRI>
int wide_clusters(int d) {
  return active_clusters(flash_fwd_wide_kernel<Elem16, TRI>, SlabGeo<kWideSlab>(d).c,
                         wide_smem_bytes(), wide_counts<TRI>(), kWideThreads);
}

// The library's 16-bit type on the tensor cores at a head dim above 576, with
// the caller's plan (64-row q tiles, the layout's shared memory, the 128-byte
// swizzle; the slab CTAs of a q tile in one cluster, kNoCluster where none
// fits); or f32 on the CUDA cores at head dims 32, 64 and 128 (the tile
// kernels) and from 256 on (the cluster kernels), with the plan's q rows,
// f32_rows(sq), and shared memory; no swizzle.
template <bool TRI>
int dispatch_wide(const Params& p, int dtype, int bh, int d, int block_m, int smem, int swizzle,
                  cudaStream_t stream) {
  if (dtype == kElemCode) {
    if (!wide_head_dim(d) || block_m != 64) return kUnsupported;
    if (swizzle != WideGeo::kRowBytes || smem != wide_smem_bytes()) return kUnsupported;
    if (!tma_aligned({p.q, p.k, p.v, p.o})) return kUnsupported;  // TMA needs 16-byte bases
    CUtensorMap qmap, kmap, vmap;
    const int bh_kv = bh / p.heads * p.kv_heads;
    if (!encode_wide_map<Elem16>(&qmap, p.q, p.sq, bh, d) ||
        !encode_wide_map<Elem16>(&kmap, p.k, p.sk, bh_kv, d) ||
        !encode_wide_map<Elem16>(&vmap, p.v, p.sk, bh_kv, d)) {
      return kNoTensorMap;
    }
    const SlabGeo<kWideSlab> geo(d);
    return launch_clusters(flash_fwd_wide_kernel<Elem16, TRI>,
                           cluster_grid((p.sq + 63) / 64, geo.ctas(), bh), geo.c, kWideThreads,
                           smem, stream, wide_counts<TRI>(), p, d, qmap, kmap, vmap);
  }
#ifdef FLASH_ELEM_F16
  return kUnsupported;
#else
  if (dtype != 0 || swizzle != 0 || block_m != f32_rows(p.sq)) return kUnsupported;
  // cp.async and float4 stores move 16 bytes: 16-byte bases (rows are d * 4 bytes)
  if (!tma_aligned({p.q, p.k, p.v, p.o})) return kUnsupported;
  if (f32_tile_head_dim(d)) return dispatch_f32_tile<TRI>(p, bh, d, block_m, smem, stream);
  if (!f32_cluster_head_dim(d)) return kUnsupported;
  return block_m == kF32WideTile ? launch_f32_cluster<TRI, kF32WideTile>(p, bh, d, smem, stream)
                                 : launch_f32_cluster<TRI, 16>(p, bh, d, smem, stream);
#endif
}
#endif  // FLASH_HEAD_DIM_WIDE

// TRI: the triangle (K/V tiles as tall as the q tile); else the general
// kernel (64-key ring tiles).
template <typename T, int D, int WG, bool TRI>
int launch_tc(const Params& p, int bh, int smem, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  const int q_tiles = (p.sq + BM - 1) / BM;
  if (smem != tc_smem_bytes<D, WG, TRI>() || q_tiles > 65535) return kUnsupported;
  CUtensorMap qmap, kmap, vmap;
  const int bh_kv = bh / p.heads * p.kv_heads;
  const int kv_box = TRI ? BM : kRingRows;
  if (!encode_map<T, D>(&qmap, p.q, p.sq, bh, BM) ||
      !encode_map<T, D>(&kmap, p.k, p.sk, bh_kv, kv_box) ||
      !encode_map<T, D>(&vmap, p.v, p.sk, bh_kv, kv_box)) {
    return kNoTensorMap;
  }
  void (*kernel)(Params, CUtensorMap, CUtensorMap, CUtensorMap);
  if constexpr (TRI) {
    kernel = flash_fwd_tri_kernel<T, D, WG>;
  } else {
    kernel = flash_fwd_rect_kernel<T, D, WG>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bh, q_tiles, col_split<D>()), WG * 128 + 32, smem, stream>>>(p, qmap, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

// D = 256: the 128-row CTAs (their plan's block_m is the CTA's 128 rows;
// the K and V ring tiles are 64 keys under both masks).
template <bool TRI>
int launch_rows(const Params& p, int bh, int block_m, int smem, cudaStream_t stream) {
  constexpr int D = kRowsHeadDim;
  const int q_tiles = (p.sq + kRowsBM - 1) / kRowsBM;
  if (block_m != kRowsBM || smem != rows_smem_bytes<TRI>() || q_tiles > 65535) {
    return kUnsupported;
  }
  CUtensorMap qmap, kmap, vmap;
  const int bh_kv = bh / p.heads * p.kv_heads;
  if (!encode_map<Elem16, D>(&qmap, p.q, p.sq, bh, kRowsBM) ||
      !encode_map<Elem16, D>(&kmap, p.k, p.sk, bh_kv, kRingRows) ||
      !encode_map<Elem16, D>(&vmap, p.v, p.sk, bh_kv, kRingRows)) {
    return kNoTensorMap;
  }
  void (*kernel)(Params, CUtensorMap, CUtensorMap, CUtensorMap);
  if constexpr (TRI) {
    kernel = flash_fwd_tri_kernel<Elem16, D, 2>;
  } else {
    kernel = flash_fwd_rect_kernel<Elem16, D, 2>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bh, q_tiles, 1), kRowsThreads, smem, stream>>>(p, qmap, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool TRI>
int dispatch_tc(const Params& p, int bh, int block_m, int smem, int swizzle, cudaStream_t stream) {
  if (swizzle != Geo<D>::kRowBytes) return kUnsupported;
  if (!tma_aligned({p.q, p.k, p.v, p.o})) return kUnsupported;  // TMA needs 16-byte bases
  if constexpr (D == kRowsHeadDim) {
    return launch_rows<TRI>(p, bh, block_m, smem, stream);
  } else {
    if (block_m == 64) return launch_tc<Elem16, D, 1, TRI>(p, bh, smem, stream);
    if constexpr (D <= 128) {  // D 512 and 576: one warpgroup only (see the note on top)
      if (block_m == 128) return launch_tc<Elem16, D, 2, TRI>(p, bh, smem, stream);
    }
    return kUnsupported;
  }
}

template <int D, bool TRI>
int launch(const Params& p, int bh, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (TRI) {
    kernel = flash_fwd_tri_kernel<float, D>;
  } else {
    kernel = flash_fwd_rect_kernel<float, D>;
  }
  const int smem = static_cast<int>(smem_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBM - 1) / kBM, bh < kMaxGridY ? bh : kMaxGridY,
                  (bh + kMaxGridY - 1) / kMaxGridY);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The library's 16-bit type on the tensor cores with the caller's plan; f32
// at D 16 (the bf16 library only) on the CUDA cores, whose plan is fixed (64,
// its shared memory, no swizzle).
template <bool TRI>
int dispatch(const Params& p, int dtype, int bh, int d, int block_m, int smem, int swizzle,
             void* stream) {
  if (!(bh > 0 && p.sq > 0 && p.sk > 0 && p.heads > 0 && p.kv_heads > 0 &&
        p.heads % p.kv_heads == 0)) {
    return kUnsupported;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef FLASH_HEAD_DIM_WIDE
  return dispatch_wide<TRI>(p, dtype, bh, d, block_m, smem, swizzle, st);
#else
  if (dtype == kElemCode) {
    switch (d) {
#ifdef FLASH_HEAD_DIM_512
      case 512: return dispatch_tc<512, TRI>(p, bh, block_m, smem, swizzle, st);
#elif defined(FLASH_HEAD_DIM_576)
      case 576: return dispatch_tc<576, TRI>(p, bh, block_m, smem, swizzle, st);
#else
      case 16: return dispatch_tc<16, TRI>(p, bh, block_m, smem, swizzle, st);
      case 32: return dispatch_tc<32, TRI>(p, bh, block_m, smem, swizzle, st);
      case 64: return dispatch_tc<64, TRI>(p, bh, block_m, smem, swizzle, st);
      case 128: return dispatch_tc<128, TRI>(p, bh, block_m, smem, swizzle, st);
      case 256: return dispatch_tc<256, TRI>(p, bh, block_m, smem, swizzle, st);
#endif
      default: return kUnsupported;
    }
  }
  if constexpr (!kWithF32) {
    return kUnsupported;
  } else {
    if (dtype != 0 || block_m != kBM || swizzle != 0 ||
        smem != static_cast<int>(smem_bytes(d))) {
      return kUnsupported;
    }
    // D 16 here; 32 and above: the tile and cluster kernels of the wide library
#if !defined(FLASH_HEAD_DIM_512) && !defined(FLASH_HEAD_DIM_576)
    if (d == 16) return launch<16, TRI>(p, bh, st);
#endif
    return kUnsupported;
  }
#endif  // FLASH_HEAD_DIM_WIDE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the library built as is), 2 = float16
// (the library built with -DFLASH_ELEM_F16); a library refuses the others.
// Each returns 0 on a launched kernel, a CUDA error code when the launch was
// refused, -1 for a shape, dtype, plan or alignment these kernels do not
// take, -2 when no TMA tensor map could be made. block_m, smem (bytes) and
// swizzle (bytes) are the caller's launch plan (flash_fwd.py::tri_plan,
// rect_plan): bf16 and fp16 run the tensor-core kernels at block_m 64 or 128
// (64 only at D 256, 512, 576 and above); f32 runs the CUDA-core kernels,
// whose plans are fixed (64 at D 16, else f32_rows(sq); their shared memory;
// no swizzle). A library takes D 16-256 (f32: 16), or (built with
// -DFLASH_HEAD_DIM_512) D 512 alone, or (-DFLASH_HEAD_DIM_576) D 576 alone
// (16-bit only), or (-DFLASH_HEAD_DIM_WIDE) every multiple of 64 above 576
// and, in f32, 32, 64, 128 and from 256 on (flash_fwd.py::wide_plan,
// f32_tile_plan, f32_cluster_plan).
extern "C" int flash_fwd_tri(const void* q, const void* k, const void* v, void* o, float* lse,
                             int dtype, int bh, int s, int d, int heads, int kv_heads,
                             float qscale, int block_m, int smem, int swizzle,
                             void* stream) {
  Params p{q, k, v, nullptr, o, lse, s, s, heads, kv_heads, 1, 0, 0, 0, qscale, bh};
  return dispatch<true>(p, dtype, bh, d, block_m, smem, swizzle, stream);
}

// Segment ids (B, sk) come only with sq == sk. A window is a band of causal
// attention only: without a causal mask it becomes 0 (none).
extern "C" int flash_fwd_rect(const void* q, const void* k, const void* v, const int* seg,
                              void* o, float* lse, int dtype, int bh, int sq, int sk, int d,
                              int heads, int kv_heads, int causal, int q_start, int k_start,
                              int window, float qscale, int block_m, int smem, int swizzle,
                              void* stream) {
  if (seg != nullptr && sq != sk) return kUnsupported;
  Params p{q, k, v, seg, o, lse, sq, sk, heads, kv_heads, causal, q_start, k_start,
           causal && window > 0 ? window : 0, qscale, bh};
  return dispatch<false>(p, dtype, bh, d, block_m, smem, swizzle, stream);
}

#ifdef FLASH_HEAD_DIM_WIDE
// How many clusters of the library's 16-bit wide forward (tri 1: the
// triangle's, 0: the general kernel's) at head dim d (above 576, a multiple
// of 64) the card holds at once: cudaOccupancyMaxActiveClusters at its
// plan's shared memory and cluster size. -1 for a head dim it does not take,
// minus a CUDA error code when the query fails.
extern "C" int flash_fwd_wide16_clusters(int tri, int d) {
  if (!wide_head_dim(d)) return kUnsupported;
  return tri ? wide_clusters<true>(d) : wide_clusters<false>(d);
}
#endif

#if defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_ELEM_F16)
// How many clusters of an f32 forward kernel at head dim d (tri 1: the
// triangle, 0: the general kernel; block_m its q rows, 64 or 16) the card
// holds at once: at 256 and above cudaOccupancyMaxActiveClusters at its
// plan's shared memory and cluster size; at 32, 64 and 128 (a CTA a tile, a
// cluster of one) its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor.
// -1 for a head dim or height these kernels do not take, minus a CUDA error
// code when the query fails.
extern "C" int flash_fwd_f32_clusters(int tri, int d, int block_m) {
  if (block_m != kF32WideTile && block_m != 16) return kUnsupported;
  if (f32_tile_head_dim(d)) {  // a CTA a tile: its resident CTAs, each a cluster of one
    return tri ? f32_tile_resident_at<true>(d, block_m) : f32_tile_resident_at<false>(d, block_m);
  }
  if (!f32_cluster_head_dim(d)) return kUnsupported;
  if (block_m == kF32WideTile) {
    return tri ? f32_cluster_clusters<true, kF32WideTile>(d)
               : f32_cluster_clusters<false, kF32WideTile>(d);
  }
  return tri ? f32_cluster_clusters<true, 16>(d) : f32_cluster_clusters<false, 16>(d);
}
#endif
