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
// own layout. No setmaxnreg: with one
// producer warp beside at most two warpgroups the register cap (168 a
// thread at WG = 2, 255 at WG = 1) holds the O and S accumulators. At D 256
// only WG = 1 is built: O (128 f32), S (32) and P (16) are 176 registers a
// thread, past WG = 2's cap, and the triangle's two-stage ring of 128-key
// K and V tiles would need 328,744 bytes of shared memory; P.V is one
// m64n256k16 wgmma per 16 keys.
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
// helpers in flash_wide.cuh): the reduction over D streams. A CTA owns 64 q
// rows and one slab of kWideSlab = 256 columns of O (the grid's z; the last
// slab starts at D - 256 so that every CTA runs the same m64n256k16 P.V, and
// writes only the columns no earlier slab owns). Per 64-key tile the
// producer warp loads the tile's V slab (four boxes) into a two-stage ring,
// then streams Q and K in 64 x 64 boxes through a four-stage ring; the
// consumer warpgroup sums S over the D / 64 chunks (one chunk's wgmma in
// flight while the next is issued, each stage released once its products
// are done), then runs the general kernel's tile rule, softmax and P.V.
// Every slab's CTA forms the whole S: (slabs + 1) / 2 times the ideal
// tensor-core work (2.5x at 1024), and Q, K and V are read from L2 once per
// key tile per slab. 132,720 bytes of shared memory; the triangle is the
// same body with its q tiles heaviest first. f32 (flash_fwd_wide_f32_kernel):
// attend's arithmetic with q and k staged in 64-column chunks and O in
// 256-column slabs (the slab and the q tile on the grid's x).
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
// f32 (attend<float, D, TRI>, the triangle and the general masks): one CTA
// of 256 threads (16 x 16) per (bh row, 64-row q tile) on the CUDA cores,
// q tiles on the grid's x and bh rows on y and z (kMaxGridY rows a z slice,
// so any number of rows launches at once).
// The k loop visits only the tiles some row of the q tile can see. K and V
// tiles are staged through shared memory as f32; each thread owns a 4 x 4
// block of the score tile and the matching 4 x D/16 block of the output
// accumulator, so the per-row rescale never leaves registers. P goes
// through shared memory. f32 stays here because it must not round through
// TF32 (serving prefill holds its greedy tokens to the reference's).
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

// The CUDA-core kernels' keys per k tile: 64, or 16 at D = 512 and 576, where
// two [64][D + 1] f32 tiles beside Q's would pass the 227 KB a block may use
// (at 576 the 16-key layout takes 225,984 bytes).
__host__ __device__ constexpr int f32_keys(int d) { return d > 256 ? 16 : kBN; }

constexpr size_t smem_bytes(int d) {
  // q tile, k tile, v tile ([rows][D + 1]), p tile ([kBM][keys + 1]), k segment ids
  return sizeof(float) * ((kBM + 2 * f32_keys(d)) * (d + 1) + kBM * (f32_keys(d) + 1)) +
         sizeof(int) * f32_keys(d);
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void attend(const Params& p) {
  constexpr int BN = f32_keys(D);
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

// The 16-bit triangle forward on the tensor cores. blockIdx.x: (batch, head)
// row; blockIdx.y: q tile, reversed so the heaviest tiles launch first;
// blockIdx.z: the column slice of O at D = 512 (halves) and 576 (thirds).
template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    flash_fwd_tri_kernel(Params p, const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core triangle is bf16 or fp16");
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

// The 16-bit general forward on the tensor cores (see the note on top).
// blockIdx.x: (batch, head) row; blockIdx.y: q tile of 64 WG rows, in order;
// blockIdx.z: the column slice of O at D = 512 (halves) and 576 (thirds).
template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    flash_fwd_rect_kernel(Params p, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core general forward is bf16 or fp16");
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

#ifdef FLASH_HEAD_DIM_WIDE
// ---------------------------------------------------------------------------
// Head dims above 576: the D-streaming forward (see the note on top).
// ---------------------------------------------------------------------------

constexpr int kWideSlab = 256;     // columns of O a 16-bit CTA holds (wgmma's widest N)
constexpr int kWideRing = 4;       // stages of the Q/K chunk ring
constexpr int kWideVStages = 2;    // stages of the V slab ring
constexpr int kF32WideChunk = 64;  // columns of a Q/K chunk of the f32 kernel
constexpr int kF32WideSlab = 256;  // columns of O an f32 CTA holds

constexpr int wide_smem_bytes() {
  // alignment slack, the Q/K chunk ring (two boxes a stage), the V slab ring
  // (kWideSlab / 64 boxes a stage) with each slab's 64 keys' segment ids and
  // their min and max, the four barrier arrays
  return kSmemAlign + kWideRing * 2 * kWideBoxBytes +
         kWideVStages * (kWideSlab / kWideBox) * kWideBoxBytes +
         kWideVStages * (kRingRows + 2) * 4 + 8 * (2 * kWideRing + 2 * kWideVStages);
}

constexpr int f32_wide_smem_bytes() {
  // q and k chunks ([64][chunk + 1]), the v slab ([64][slab + 1]), the p tile
  // ([64][65]), the keys' segment ids
  return sizeof(float) * (2 * kBM * (kF32WideChunk + 1) + kBN * (kF32WideSlab + 1) +
                          kBM * (kBN + 1)) +
         sizeof(int) * kBN;
}

// The 16-bit D-streaming forward on the tensor cores: the general kernel's
// walk, tile rule and softmax, with S formed over d / 64 streamed chunks.
// blockIdx.x: (batch, head) row; blockIdx.y: 64-row q tile (TRI: reversed,
// heaviest first); blockIdx.z: the slab of O.
template <typename T, bool TRI>
__global__ void __launch_bounds__(128 + 32, 1)
    flash_fwd_wide_kernel(Params p, int d, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap) {
  static_assert(kElem16<T>, "the tensor-core wide forward is bf16 or fp16");
  constexpr int BN = kRingRows;
  constexpr int W = kWideSlab, NB = W / kWideBox;
  constexpr int R = kWideRing, VS = kWideVStages;
  constexpr uint32_t kSlabBytes = NB * kWideBoxBytes;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* qk_s = base;                                  // stage st: a Q box, a K box
  unsigned char* v_s = qk_s + R * 2 * kWideBoxBytes;           // stage vs: NB V boxes
  int* kid_s = reinterpret_cast<int*>(v_s + VS * kSlabBytes);  // [VS][BN]
  int* krange_s = kid_s + VS * BN;                             // [VS][min, max]
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(krange_s + 2 * VS);
  uint64_t* qk_empty = qk_full + R;
  uint64_t* v_full = qk_empty + R;
  uint64_t* v_empty = v_full + VS;

  const bool causal = p.causal != 0;
  const int window = p.window;  // > 0 only under a causal mask
  const bool segments = !TRI && p.seg != nullptr;
  const int bh = blockIdx.x;
  const int q0 = (TRI ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int own0 = blockIdx.z * W;     // the first column this CTA writes
  const int col0 = min(own0, d - W);   // the first column of its products
  const int nc = d / kWideBox;         // chunks of the contraction over d
  const int q_end = min(p.sq, q0 + 64);
  const int k_hi = causal ? max(0, min(p.sk, p.q_start + q_end - p.k_start)) : p.sk;
  const int k_lo = window > 0 ? max(0, p.q_start + q0 - window + 1 - p.k_start) : 0;
  const int t_lo = k_lo / BN;
  const int n_tiles = k_lo < k_hi ? (k_hi + BN - 1) / BN - t_lo : 0;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.sk : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R; ++st) {
      mbar_init(&qk_full[st], 1);
      mbar_init(&qk_empty[st], 4);
    }
#pragma unroll
    for (int st = 0; st < VS; ++st) {
      mbar_init(&v_full[st], segments ? 1 + 31 : 1);  // the TMA bytes, then each id lane
      mbar_init(&v_empty[st], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer warp: per key tile, lane 0 loads the V slab, then streams the
    // Q and K chunks; with segment ids, lanes 1-31 stage the tile's key ids
    // and their range beside the V slab
    if (lane == 0) {
      const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = (t_lo + t) * BN;
        const int vs = t % VS;
        if (t >= VS) mbar_wait(&v_empty[vs], ((t / VS) - 1) & 1);
        mbar_expect_tx(&v_full[vs], kSlabBytes);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(v_s + vs * kSlabBytes + b * kWideBoxBytes, &vmap, &v_full[vs],
                      col0 + b * kWideBox, k0, kv_row);
        }
        for (int c = 0; c < nc; ++c) {
          const int i = t * nc + c, st = i % R;
          if (i >= R) mbar_wait(&qk_empty[st], ((i / R) - 1) & 1);
          unsigned char* stage = qk_s + st * 2 * kWideBoxBytes;
          mbar_expect_tx(&qk_full[st], 2 * kWideBoxBytes);
          tma_load_3d(stage, &qmap, &qk_full[st], c * kWideBox, q0, bh);
          tma_load_3d(stage + kWideBoxBytes, &kmap, &qk_full[st], c * kWideBox, k0, kv_row);
        }
      }
    } else if (segments) {
      for (int t = 0; t < n_tiles; ++t) {
        const int vs = t % VS;
        if (t >= VS) mbar_wait(&v_empty[vs], ((t / VS) - 1) & 1);
        const int2 range = id_range(seg, (t_lo + t) * BN, p.sk, lane - 1, 31, 0xfffffffeu,
                                    kid_s + vs * BN);
        if (lane == 1) {
          krange_s[2 * vs] = range.x;
          krange_s[2 * vs + 1] = range.y;
        }
        mbar_arrive(&v_full[vs]);  // releases this lane's stores to the consumers
      }
    }
    return;
  }

  // consumers: one warpgroup owns q rows q0 .. q0 + 63; this thread holds
  // rows r0 and r0 + 8 of its warp's 16, at keys 8 j + 2 tq (+1) of a tile
  const int tq = lane % 4;
  const int r0 = q0 + warp * 16 + lane / 4;
  const float qscale = p.qscale;
  const int win = window > 0 ? window : INT_MAX;
  const int qg0 = p.q_start + q0, qg1 = p.q_start + min(q0 + 63, p.sq - 1);
  int qk[2];
  int qid[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    qk[h] = p.q_start + row - p.k_start;
    if (segments && row < p.sq) qid[h] = seg[row];
  }
  const int2 qrange =
      segments ? id_range(seg, q0, p.sq, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  float o[W / 2], s[BN / 2];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int vs = t % VS;
    const int k0 = (t_lo + t) * BN;
    mbar_wait(&v_full[vs], (t / VS) & 1);
    // the general kernel's tile rule (flash_fwd_rect_kernel)
    const int kg0 = p.k_start + k0, kg1 = p.k_start + min(k0 + BN - 1, p.sk - 1);
    bool sees = q0 < p.sq;
    bool masked = k0 + BN > p.sk;
    if (causal) {
      sees = sees && qg1 >= kg0;
      masked = masked || qg0 < kg1;
    }
    if (window > 0) {
      sees = sees && qg0 - kg1 < window;
      masked = masked || qg1 - kg0 >= window;
    }
    if (segments) {
      const int kmin = krange_s[2 * vs], kmax = krange_s[2 * vs + 1];
      const bool uniform = qrange.x == qrange.y && kmin == kmax;
      sees = sees && !(uniform && qrange.x != kmin);
      masked = masked || !uniform;
    }
    if (sees) {
      // S = Q.K^T over the d / 64 chunks, one chunk's products in flight
      // while the next is issued; a chunk's stage is released once its
      // products are done
      for (int c = 0; c < nc; ++c) {
        const int i = t * nc + c, st = i % R;
        mbar_wait(&qk_full[st], (i / R) & 1);
        const unsigned char* stage = qk_s + st * 2 * kWideBoxBytes;
        hold(s);
        wgmma_fence();
        mma_box_by_box<T>(s, stage, stage + kWideBoxBytes, c == 0);
        wgmma_commit();
        wgmma_wait<1>();
        hold(s);
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&qk_empty[(i - 1) % R]);
        }
      }
      wgmma_wait<0>();
      hold(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&qk_empty[(t * nc + nc - 1) % R]);

      const int2* kid = reinterpret_cast<const int2*>(kid_s + vs * BN);
      auto softmax = [&](auto mask) {
        constexpr bool kMask = decltype(mask)::value;
        if constexpr (kMask) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            int2 kj = make_int2(0, 0);
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
            pa[kk][2 * h] = pack2<T>(p00, p01);
            pa[kk][2 * h + 1] = pack2<T>(p10, p11);
          }
        }
        l0 = l0 * c0 + rs0;
        l1 = l1 * c1 + rs1;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
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
      hold(o);
      wgmma_fence();
      mma_frag_by_slab<T, W>(o, pa, v_s + vs * kSlabBytes);  // O += P.V_slab, V MN-major
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(pa);
    } else {
      // a dead tile: its chunks are released unread
      for (int c = 0; c < nc; ++c) {
        const int i = t * nc + c, st = i % R;
        mbar_wait(&qk_full[st], (i / R) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&qk_empty[st]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[vs]);  // this warp is done with the slab
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= p.sq) continue;
    const float l = half ? l1 : l0;
    const float denom = l > 0.f ? l : 1.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row) * d + col0);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (col0 + 8 * j < own0) continue;  // an earlier slab's columns
      orow[4 * j + tq] = pack2<T>(o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
    }
    if (tq == 0 && blockIdx.z == 0) {
      p.lse[static_cast<size_t>(bh) * p.sq + row] =
          l > 0.f ? (half ? m1 : m0) * kLn2 + logf(l) : -CUDART_INF_F;
    }
  }
}

// The f32 D-streaming forward on the CUDA cores: attend's arithmetic, with
// the score tile summed over 64-column chunks of q and k and the output in
// slabs of kF32WideSlab columns. blockIdx.x: q tile x slabs + slab; y and z:
// bh rows (kMaxGridY a z slice).
template <bool TRI>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wide_f32_kernel(Params p, int d) {
  constexpr int RN = kBN / 16;
  constexpr int LC = kF32WideChunk + 1;
  constexpr int LS = kF32WideSlab + 1;
  constexpr int LP = kBN + 1;
  constexpr int CN = kF32WideSlab / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [kBM][LC]
  float* ks = qs + kBM * LC;   // [kBN][LC]
  float* vs = ks + kBN * LC;   // [kBN][LS]
  float* ps = vs + kBN * LS;   // [kBM][LP]
  int* kseg = reinterpret_cast<int*>(ps + kBM * LP);

  const int bh = blockIdx.z * kMaxGridY + blockIdx.y;
  if (bh >= p.rows) return;
  const int n_slabs = wide_slabs(d, kF32WideSlab);
  const int q0 = (blockIdx.x / n_slabs) * kBM;
  const int col0 = (blockIdx.x % n_slabs) * kF32WideSlab;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = bh / p.heads;
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.sq * d;
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.sk * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.sk * d;
  const bool segments = !TRI && p.seg != nullptr;

  const int q_end = min(q0 + kBM, p.sq);
  int k_lo = 0, k_hi = p.sk;
  if (TRI) {
    k_hi = min(p.sk, q_end);
  } else if (p.causal) {
    k_hi = max(0, min(p.sk, p.q_start + q_end - p.k_start));
    if (p.window > 0) k_lo = max(0, p.q_start + q0 - p.window + 1 - p.k_start);
  }
  const int t_lo = k_lo / kBN;
  const int t_hi = (k_hi + kBN - 1) / kBN;

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
    const int k0 = t * kBN;
    float s[kRM][RN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kF32WideChunk) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      for (int i = tid; i < kBM * kF32WideChunk; i += kThreads) {
        const int r = i / kF32WideChunk, c = i % kF32WideChunk;
        // q pre-scaled in f32, as attend scales it
        qs[r * LC + c] =
            q0 + r < p.sq ? qg[static_cast<size_t>(q0 + r) * d + c0 + c] * p.qscale : 0.f;
        ks[r * LC + c] = k0 + r < p.sk ? kg[static_cast<size_t>(k0 + r) * d + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kF32WideChunk; ++dd) {
        float qv[kRM], kv[RN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) qv[i] = qs[(ty + 16 * i) * LC + dd];
#pragma unroll
        for (int j = 0; j < RN; ++j) kv[j] = ks[(tx + 16 * j) * LC + dd];
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // the V slab and the keys' ids (their buffers' last readers passed the
    // chunk loop's barriers)
    for (int i = tid; i < kBN * kF32WideSlab; i += kThreads) {
      const int r = i / kF32WideSlab, c = i % kF32WideSlab;
      const bool in = k0 + r < p.sk && col0 + c < d;
      vs[r * LS + c] = in ? vg[static_cast<size_t>(k0 + r) * d + col0 + c] : 0.f;
    }
    if (segments && tid < kBN) {
      kseg[tid] = (k0 + tid < p.sk) ? p.seg[static_cast<size_t>(b) * p.sk + k0 + tid] : 0;
    }
    __syncthreads();

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
        ps[(ty + 16 * i) * LP + tx + 16 * j] = pj;
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
    for (int kk = 0; kk < kBN; ++kk) {
      float pv[kRM], vv[CN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) vv[c] = vs[kk * LS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* og = static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.sq * d;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < d) og[static_cast<size_t>(qi) * d + col] = acc[i][c] / denom;
    }
    if (tx == 0 && col0 == 0) {
      const bool live = l[i] > 0.f && m[i] != -CUDART_INF_F;
      p.lse[static_cast<size_t>(bh) * p.sq + qi] = live ? m[i] * kLn2 + logf(l[i]) : -CUDART_INF_F;
    }
  }
}

// The library's 16-bit type on the tensor cores, or f32 on the CUDA cores, at
// a head dim above 576, with the caller's plan: 64-row q tiles, the layout's
// shared memory, the 128-byte swizzle (16-bit) or none (f32).
template <bool TRI>
int dispatch_wide(const Params& p, int dtype, int bh, int d, int block_m, int smem, int swizzle,
                  cudaStream_t stream) {
  if (!wide_head_dim(d) || block_m != 64) return kUnsupported;
  if (dtype == kElemCode) {
    if (swizzle != WideGeo::kRowBytes || smem != wide_smem_bytes()) return kUnsupported;
    if (!tma_aligned({p.q, p.k, p.v, p.o})) return kUnsupported;  // TMA needs 16-byte bases
    const int q_tiles = (p.sq + 63) / 64;
    if (q_tiles > 65535) return kUnsupported;
    CUtensorMap qmap, kmap, vmap;
    const int bh_kv = bh / p.heads * p.kv_heads;
    if (!encode_wide_map<Elem16>(&qmap, p.q, p.sq, bh, d) ||
        !encode_wide_map<Elem16>(&kmap, p.k, p.sk, bh_kv, d) ||
        !encode_wide_map<Elem16>(&vmap, p.v, p.sk, bh_kv, d)) {
      return kNoTensorMap;
    }
    auto kernel = flash_fwd_wide_kernel<Elem16, TRI>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bh, q_tiles, wide_slabs(d, kWideSlab)), 128 + 32, smem, stream>>>(p, d, qmap,
                                                                                  kmap, vmap);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (!kWithF32) {
    return kUnsupported;
  } else {
    if (dtype != 0 || swizzle != 0 || smem != f32_wide_smem_bytes()) return kUnsupported;
    auto kernel = flash_fwd_wide_f32_kernel<TRI>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.sq + kBM - 1) / kBM * wide_slabs(d, kF32WideSlab),
                    bh < kMaxGridY ? bh : kMaxGridY, (bh + kMaxGridY - 1) / kMaxGridY);
    kernel<<<grid, kThreads, smem, stream>>>(p, d);
    return static_cast<int>(cudaGetLastError());
  }
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

template <int D, bool TRI>
int dispatch_tc(const Params& p, int bh, int block_m, int smem, int swizzle, cudaStream_t stream) {
  if (swizzle != Geo<D>::kRowBytes) return kUnsupported;
  if (!tma_aligned({p.q, p.k, p.v, p.o})) return kUnsupported;  // TMA needs 16-byte bases
  if (block_m == 64) return launch_tc<Elem16, D, 1, TRI>(p, bh, smem, stream);
  if constexpr (D <= 128) {  // D 256, 512 and 576: one warpgroup only (see the note on top)
    if (block_m == 128) return launch_tc<Elem16, D, 2, TRI>(p, bh, smem, stream);
  }
  return kUnsupported;
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
// (the bf16 library only) on the CUDA cores, whose plan is fixed (64, its
// shared memory, no swizzle).
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
    switch (d) {
#ifdef FLASH_HEAD_DIM_512
      case 512: return launch<512, TRI>(p, bh, st);
#elif defined(FLASH_HEAD_DIM_576)
      case 576: return launch<576, TRI>(p, bh, st);
#else
      case 16: return launch<16, TRI>(p, bh, st);
      case 32: return launch<32, TRI>(p, bh, st);
      case 64: return launch<64, TRI>(p, bh, st);
      case 128: return launch<128, TRI>(p, bh, st);
      case 256: return launch<256, TRI>(p, bh, st);
#endif
      default: return kUnsupported;
    }
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
// (64 only at D 256, 512, 576 and above); f32 runs the CUDA-core kernel, whose
// plan is fixed (64, its shared memory, no swizzle). A library takes D
// 16-256, or (built with -DFLASH_HEAD_DIM_512) D 512 alone, or
// (-DFLASH_HEAD_DIM_576) D 576 alone, or (-DFLASH_HEAD_DIM_WIDE) every
// multiple of 64 above 576 (flash_fwd.py::wide_plan).
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
