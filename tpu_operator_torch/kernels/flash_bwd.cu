// Flash-attention backward kernels for Hopper (sm_90a): the FlashAttention-2
// backward of the forward kernels in flash_fwd.cu.
//
// Replace the four Pallas backward kernels of the JAX package:
//   flash_bwd_dq_tri_kernel   <- tpu_operator/workloads/flashattention.py::_flash_dq_tri_kernel
//                                (plain causal dQ)
//   flash_bwd_dkv_tri_kernel  <- tpu_operator/workloads/flashattention.py::_flash_dkv_tri_kernel
//                                (plain causal dK/dV)
//   flash_bwd_dq_rect_kernel  <- tpu_operator/workloads/flashattention.py::_flash_dq_kernel
//                                (causal or full, sliding window, segment ids)
//   flash_bwd_dkv_rect_kernel <- tpu_operator/workloads/flashattention.py::_flash_dkv_kernel
// Inputs are the forward's q, k, v, its natural-log lse, the output cotangent
// dO and delta = rowsum(dO * O); sq == sk. P is recomputed tile by tile from
// the score the forward built, so P = exp2(s - lse * log2(e)) is the
// forward's softmax and its rows sum to 1. Then dS = P * (dP - delta) /
// sqrt(d) with dP = dO . V^T, and
//   dQ = dS . K,  dK = dS^T . Q,  dV = P^T . dO.
// As the reference does, P is rounded to dO's dtype before dV, and dS to
// the input dtype before dQ and dK; every sum is f32. Both kernels of a pair
// are deterministic: no atomics, every gradient element is written once by
// one thread, and a GQA group's q heads sum inside one CTA, or in parts that
// a second kernel adds in part order.
//
// Two designs, chosen by dtype:
//
// bf16 and fp16 (flash_bwd_{dq,dkv}_{tri,rect}_kernel<T, D, WG>, T
// __nv_bfloat16 or __half): the tensor-core design, on the forward's
// machinery (hopper.cuh), one body per kernel (dq_tc_body / dkv_tc_body<T,
// D, WG, TRI>; dK/dV at D 512 and 576: dkv_slice_body) for the triangle and
// the general masks and for both 16-bit types. A library holds one of them,
// as flash_fwd.cu's do: built as is, bf16 and the f32 pair at D 16; built
// with -DFLASH_ELEM_F16, fp16. f32 at every other head dim lives in the
// bf16 wide library. At long
// context the pair is operations-bound (14 D FLOPs per live (q, k) pair over
// O(S D) bytes), so every product runs on wgmma in T with f32
// accumulators, and the scores are the forward's: the raw 16-bit q.k on the
// tensor cores, P = exp2(fma(S, log2(e)/sqrt(d), -lse * log2(e))). Each CTA
// has a producer warp that TMA-loads its own side's tiles once and feeds
// the other side's 64-row tiles through a two-stage ring ("full" mbarriers
// count TMA bytes, "empty" ones one arrival per consumer warp), and WG
// consumer warpgroups of 64 rows each.
//   dQ: a CTA owns 64 WG q rows of one (batch, head) row (q tiles launch
//       heaviest first) and walks the 64-key K/V tiles from key 0 to its
//       diagonal. Per tile a warpgroup runs S = Q.K^T and dP = dO.V^T (A and
//       B from shared memory, both K-major), masks keys after its rows on the
//       tiles that cross the diagonal, forms P and dS in registers with its
//       rows' lse and delta held in registers, and runs dQ += dS.K with dS
//       packed to T as the register A operand (the f32 accumulator layout
//       of S is wgmma's register layout of A) and the same K tile as an
//       MN-major B operand (the transpose flag). dS never touches shared
//       memory.
//   dK/dV: a CTA owns 64 WG keys of one kv row (the first keys, whose walk
//       is longest, launch first) and walks, for every GQA group member, the
//       64-row Q/dO tiles from its diagonal down. Per tile a warpgroup runs
//       S^T = K.Q^T and dP^T = V.dO^T (K/V as A, Q/dO as B, all K-major),
//       drops rows before its keys and rows past s (their lse reads as +inf,
//       so a zero-filled q row gives P = 0, not exp2(-lse)), and runs
//       dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//       operands and dO and Q as MN-major B operands from the same stage.
//       lse and delta are per column here: the producer warp stages each
//       tile's 64 values (lse pre-scaled to base 2) beside its Q and dO with
//       plain loads (a TMA global stride must be a multiple of 16 bytes,
//       which a (rows, s) f32 row is not for every s), and each producer lane
//       arrives on the stage's full barrier after its stores.
// A warpgroup skips a tile it cannot see (past the diagonal, or all rows or
// keys past s) and still releases the stage. 3-D tensor maps (D, s, rows)
// zero-fill past s.
// The general pair (rect) walks what its masks leave: full attention walks
// every tile (dK/dV: of every group member) and launches in natural order,
// as does a window band (dQ from key max(0, q0 - window + 1) to its
// diagonal, dK/dV from its diagonal to row k_end - 1 + window); plain causal
// walks and orders as the triangle does. Segment ids (B, s) cannot come by
// TMA either (the same 16-byte stride rule): the producer warp stages the
// ring tile's 64 ids and their min and max (warp reductions) beside the
// tile, each staging lane arriving on the full barrier (dQ: lanes 1-31,
// while lane 0 only issues TMA, so that no id load delays a tile; dK/dV:
// every lane, the ids loaded beside lse and delta); each consumer holds its
// own rows' (or keys') ids and its warpgroup's id range in registers. A
// tile then takes one of three paths, as the reference's _dispatch_block
// does: no live pair (both sides one document each, different ones: no
// products, the stage still released), fast (inside the band's interior,
// inside s, and both sides in the same single document), or masked (per
// element: key < s for dQ, the causal/window band, equal ids). P and dS
// come from one body instantiated with and without the element mask, so a
// fast tile issues no mask instruction (a runtime test per element cost the
// general pair about half its speed at 64-row tiles). Keys past s matter
// only in dQ, where a zero-filled key would score exp2(-lse); rows past s
// read lse = +inf, and keys past s are never written.
// The tile height (64 or 128), grid, shared-memory bytes and swizzle come
// from the caller's plan (flash_bwd.py::tri_bwd_plan, rect_bwd_plan), which
// this file checks against its own layout. Registers: a consumer of
// dK/dV at D = 128 holds dK and dV (64 + 64 f32), S^T and dP^T (32 + 32)
// and the packed P^T/dS^T fragments (16 + 16). ptxas budgets a CTA of
// 2 x 128 + 32 threads as one of 384, 168 registers a thread, and spilled
// there; so the dK/dV producer warp sits in a warpgroup of its own (three
// idle warps) and, at WG = 2, setmaxnreg moves registers from that
// warpgroup (40 a thread) to the consumers (232). dQ (S, dP and dQ:
// 32 + 32 + 64) fits beside a lone producer warp, as the forward does.
// D = 256 (64-row tiles only: a 128-row CTA's own two tiles and the ring
// would pass the 232,448 bytes of shared memory a block may use): dQ holds
// 128 + 32 + 32 f32 and 16 packed registers beside its producer warp, under
// the 255 of a one-warpgroup CTA, with one m64n256k16 wgmma per 16 keys for
// dQ += dS.K. dK and dV alone would be 256 f32 a thread, so two consumer
// warpgroups share a CTA's 64 keys and split the head dim (kv_split), each
// accumulating dK and dV for its 128 columns (m64n128k16 from the Q and dO
// tiles' column boxes 0-1 or 2-3). S^T and dP^T are formed once a tile:
// warpgroup w forms them over all 256 columns for q rows 32 w .. 32 w + 31
// of the ring tile (m64n32k16, half a tile's rows: its descriptors start 32
// rows into each box, whole swizzle atoms), turns them into its half of P^T
// and dS^T, and the two hand their halves to each other through 16 KiB of
// shared memory (kXchBytes: both warpgroups' thread i hold the same keys, so
// each thread stores its four A-fragment registers a k16 step and reads the
// whole tile's back; a named barrier before the stores, that the other has
// read the last ones, and one after) for dV += P^T.dO and dK += dS^T.Q over
// all 64 rows: four tile products a tile where forming both in both
// warpgroups ran six. 192 registers of data a thread inside setmaxnreg's
// 232.
// The 16-bit dK/dV up to D 256 (dkv_tc_body) splits its walk over a GQA
// group in sp parts (flash_bwd.py::gqa_split, from the card's resident CTAs:
// at one kv head a key tile's CTA walks group x q tiles steps, and the first
// key tiles' walks set the launch's pace), the parts on the grid's x (sp x
// kv rows), so every part's key tile 0 launches first; part j walks members
// [j group / sp, (j + 1) group / sp) into f32 partials that
// flash_bwd_dkv_split_sum_kernel<T> adds in part order and rounds to T once
// (no atomics: the same bits every run; sp = 1 writes dK and dV straight).
// Under segment ids every warp of it, the producer's and the consumers',
// reduces each q tile's 64 ids to their range itself (id_range: two loads a
// lane, two warp reductions; a table built before the launch cost two
// kernel launches a call) and passes over a tile whose one document is not
// the CTA's keys' one: no TMA, no ring stage, no barrier (it was loaded and
// then dropped).
// D = 512 (64-row own tiles only; its own library, built with
// -DFLASH_HEAD_DIM_512, so a caller at D <= 256 never compiles it): a CTA's
// own two tiles are 128 KiB, so the ring is one stage (stages<D>) of 32-row
// tiles (ring_rows<D>: 64 KiB for K and V, or Q and dO), S and dP (S^T and
// dP^T) are m64n32k16 products over all 512 columns (32 k16 steps), and two
// CTAs share each own-side tile, its column halves on the grid's z
// (col_split<D>: the gradients' N = 512 is past wgmma's 256). dQ: each CTA
// is the D = 256 design on 256 columns of dQ (128 f32 a thread, one
// m64n256k16 per 16 keys from the K tile's column boxes 0-3 or 4-7), S and
// dP formed by both: 5/3 of the ideal tensor-core work (S, dP and dQ once
// each). dK/dV (dkv_slice_body): each CTA holds its 256 columns in two
// consumer warpgroups of 128 columns each under setmaxnreg (64 + 64 + 16 +
// 16 + 8 + 8 registers of data a thread), every one of the four forming S^T
// and dP^T over all 512 columns: 2.5x the ideal (S, dP, dV, dK once each),
// and no exchange between warpgroups or CTAs. Shared memory: dQ 197,656 bytes (general pair
// 136 more), dK/dV 197,912 (136 more).
// D = 576 (MLA's absorbed heads; its own library, built with
// -DFLASH_HEAD_DIM_576): the D = 512 design on 64-row own tiles of 72 KiB
// and one stage of 32-row ring tiles (36 KiB), S and dP over all 576 columns
// (36 k16 steps), but three CTAs share each own-side tile, its column thirds
// on the grid's z (col_split<D>: two halves of 288 would pass wgmma's N).
// dQ: 192 columns of dQ a CTA (96 f32 a thread, one m64n192k16 per 16 keys
// from the K tile's column boxes 3c to 3c + 2): 7/3 of the ideal. dK/dV: a
// CTA's 192 columns are three 64-column boxes, and an MN-major operand
// cannot start inside a box (its 128-byte swizzle rows hold 64 columns), so
// the two consumer warpgroups own two boxes and one, not 96 columns each.
// Both run the same m64n128k16 products (128 columns: 64 + 64 f32 of dK and
// dV a thread, as at D = 512): the second on boxes 3c + 1 and 3c + 2, of
// which it writes only the last, since a wgmma on one warpgroup's path
// alone is serialized by ptxas. Every one of the six forms S^T and dP^T:
// 11/3 of the ideal (S, dP, dV, dK once each). Shared memory: dQ 222,232
// bytes (general pair 136 more), dK/dV 222,488 (136 more), of the 232,448 a
// block may use; 640 columns would pass it with the own tiles alone.
// Above 576 (both pairs; their own library, built with
// -DFLASH_HEAD_DIM_WIDE, the head dim a runtime multiple of 64, helpers in
// flash_wide.cuh and flash_cluster.cuh): the slab CTAs of a 64-row tile are
// one thread-block cluster (SlabGeo: n = ceil(d / W) slabs of W columns,
// dQ's 256 on m64n256 halves, dK/dV's 128; up to 8 a cluster, above that g
// clusters a tile that also sum the 64-column foreign chunks their slabs do
// not own, SlabCols). One warpgroup a CTA: its own columns of its own side
// stay resident (dQ: Q and dO; dK/dV: K and V), the other side's own
// columns stream by TMA through a ring of four 32 KiB stages (thread 0
// issues each item once its stage's last reader is done; every warp walks
// the loads with it), and per tile pair it sums a partial S and dP (S^T and
// dP^T) over its own 64 x 64 boxes on wgmma. The cluster's exchange
// (exchange16) adds the n partials in rank order through distributed shared
// memory (CTA r sums rows [64 r / n, 64 (r + 1) / n) of every CTA's f32
// partials: the same bits every run), forms P and dS once at the forward's
// scale and rounding, and stores them, rounded to T, into every CTA's 16-bit
// tiles in the 128-byte swizzle wgmma reads (laid over the f32 rows that
// only the same rank reads: one CTA barrier between its reads and its
// stores). Two cluster barriers a tile pair: the partials written; the
// tiles written (so the partials read). Each CTA then runs its gradient
// products with both operands in shared memory (dQ += dS . K on its slab's
// two halves, dV += P^T . dO and dK += dS^T . Q), under the next tile pair's
// loads. A CTA loads only its own columns, so a cluster reads each chunk of
// a tile pair once, and S and dP are formed once per tile pair up to 8
// slabs. The walks, the band, the masks and the segment-id skip depend only
// on the row, the tiles and the ids, so every CTA of a cluster meets every
// barrier; a masked tile's dead scores go to -inf before P and dS. The
// clusters launch tile-major, the longest walks first (cluster_slot).
// Shared memory: dQ 231,464 bytes, dK/dV 198,696, both masks alike.
// f32 at head dims 256 and above (flash_bwd_{dq,dkv}_{tri,rect}_wide_f32_kernel,
// dq_wide_f32_body / dkv_wide_f32_body<TRI>, also in the wide library:
// f32_cluster_head_dim): the CUDA cores (TF32 would not hold the 1e-4
// bar), on 64-row tiles, a CTA of 256 threads per 128-column slab
// of the gradients (the last one starting at d - 128: at 576 it starts at
// 448 and owns 512-575), and the n slab CTAs of a tile launched as one
// thread-block cluster (cudaLaunchKernelEx, the grid's x tile x n + slab; 2
// at 256, 4 at 512, 5 at 576, 8 at 1024). Per (q tile, key tile) pair each
// CTA sums a partial S and dP over the columns it owns (the write rule's:
// never the last slab's overlap twice), and the cluster adds the partials
// through distributed shared memory: CTA r sums rows [64 r / n, 64 (r + 1) /
// n) of every CTA's partials in rank order (no atomics: the same bits every
// run; 32 rows a CTA at n = 2, two passes of its 256 threads), forms P and
// dS there and stores them into every CTA (three cluster barriers), and
// each CTA runs its own slab's gradient products. S and dP
// are formed once per tile pair up to d 1024 (n <= 8, the portable cluster
// size); above it the slabs form g = ceil(n / 8) clusters of c = ceil(n /
// g) (the last CTAs past the n-th write nothing), each cluster also summing
// the columns its slabs do not own in 64-column foreign chunks spread over
// its CTAs: S and dP formed g times (2 at 2048, 4 at 4096). Own side
// resident: dQ holds its Q slab (times qscale) and dO slab for the whole
// walk and streams the key tile's K and V slabs, K's serving both the
// partial S and dQ += dS.K; dK/dV holds K and V and streams Q and dO,
// which serve S^T, dP^T, dV and dK. The streamed slabs (or a foreign
// item's four chunks) come by 16-byte cp.async through two 64 KiB stages,
// the next item loading under this one's products. Products are register
// blocked: a thread holds 4 x 4 of S and dP and 4 x 8 of each gradient
// slab, reads float4s of k-contiguous rows from tiles whose float4 columns
// are XOR-swizzled by row (each load of a warp one wavefront): 16 loads
// for 128 FMAs in the score loop, 3 for 32 (dQ) and 6 for 64 (dK/dV) in
// the gradient loops. Shared memory: 229,888 bytes (dQ: its rows' lse and
// delta too) and 229,376; one CTA per SM, so a cluster of n needs n SMs of
// one GPC (cudaOccupancyMaxActiveClusters, checked at launch: none is an
// error, kNoCluster). The walks, the band and the segment-id skip (every
// warp reads the ids' range itself) depend only on the row and the tiles,
// so the CTAs of a cluster meet at every barrier. The clusters launch
// tile-major, the longest walks first (cluster_slot: dK/dV's key tile 0 of
// every row, dQ's last q tile under a plain causal mask), as a
// longest-first schedule wants: in row order a split dK/dV left the last
// part's key tile 0 to start a third of the way into the launch. dK/dV's walk over a GQA
// group can set the launch's pace (at one kv head key tile 0's cluster walks
// group x q tiles pairs while the grid holds a wave of clusters), so it
// splits in sp parts, a divisor of the group chosen by the plan
// (flash_bwd.py::gqa_split): part j's clusters walk members [j group / sp,
// (j + 1) group / sp) and write f32 partial dK and dV, which
// flash_bwd_dkv_split_sum_kernel adds in part order (no atomics: the same
// bits every run); sp = 1 writes dK and dV straight.
//
// f32 at D 32, 64 and 128 (flash_bwd_{dq,dkv}_{tri,rect}_tile_f32_kernel<W>,
// dq_tile_f32_body / dkv_tile_f32_body<TRI, W>, in the wide library too):
// the cluster pair at c = 1. A tile's head is one slab of W columns (W 64 at
// d 32 and 64, d 32 zero-filled past d as the slab loads; W 128 at d 128),
// so S and dP are whole in the CTA and no exchange, no
// cluster and no distributed shared memory is needed: each thread forms P
// and dS on its own 4 x 4 block from its rows' lse and delta in registers
// and stores them transposed for the gradient products. Kept from the
// cluster pair: swizzled float4 tiles by 16-byte cp.async through a
// two-stage ring (the next tile loads under this one), the 4 x 4 score
// blocks and 4 x (W / 16) gradient blocks, dK/dV's GQA walk in sp parts
// summed in part order, the segment-id skip, tiles launched longest walk
// first. Per tile pair two barriers. Shared memory: dQ at W 64 114,688
// bytes, two CTAs an SM (__launch_bounds__(256, 2): at most 128 registers a
// thread, so S and dP are formed one after the other, tile_scores); dK/dV at
// W 64 131,072, dQ at W 128 212,992, dK/dV 229,376, one CTA an SM. f32
// stays on the CUDA cores because it must not round through TF32.
//
// f32 at D 16 (dq_body / dkv_body<T, 16, TRI>, the base bf16 library): the
// whole-row pair, kept because the tile pair on a 64-column slab read slower
// there (0.03172 against 0.02473 ms a (2,128,4,16) triangle pair on an H100
// 80GB HBM3 at 700 W, scripts/kernel_ab.py). One CTA of 256 threads (16 x
// 16) per (bh row, 64-row q tile) for dQ and per (kv row, 64-key tile) for
// dK/dV, tiles on the grid's x and rows on y and z (kMaxGridY a z slice);
// the TPU kernels' sequential grid
// axis is a loop inside the CTA (up to the diagonal, the window band, or
// all; dK/dV over every GQA group member). Tiles are staged through shared
// memory as f32, the score is built as the CUDA-core forward builds it (q *
// scale * log2(e) in f32, then an f32 FMA chain over d), each thread owns a
// 4 x 4 block of the score tile and the matching rows of D/16 columns of
// each accumulator, and P and dS go through shared memory between the two.
//
// Bound on this card: at the burn-in shape (S 128, D 64) each launch moves
// about 2 MB and runs a few tens of MFLOP, so by the roofline it is
// bytes-bound, and in practice latency-bound (32-64 CTAs of one to two
// tiles). At long context the work is O(S^2 D) over O(S D) bytes and turns
// operations-bound, where the 16-bit pairs' wgmma counts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers, the tensor-map encoder
#ifdef FLASH_HEAD_DIM_WIDE
#include "flash_wide.cuh"  // the D-streaming kernels' boxes, slabs and maps
#include "flash_cluster.cuh"  // the f32 kernels' slabs, clusters and swizzled tiles
#endif

namespace {

using namespace hopper;

constexpr int kTile = 64;       // q rows and keys per tile
static_assert(kTile == kRingRows, "the tensor-core tiles are the ring's (hopper.cuh)");
constexpr int kThreads = 256;   // 16 x 16
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnsupported = -1;
constexpr int kNoTensorMap = -2;  // cuTensorMapEncodeTiled missing or refused the map
constexpr int kMaxGridY = 65535;  // the CUDA-core kernels' rows per z slice of the grid

struct Params {
  const void* q;       // (bh, s, D)
  const void* k;       // (bh_kv, s, D)
  const void* v;       // (bh_kv, s, D)
  const void* dout;    // (bh, s, D)
  const float* lse;    // (bh, s), natural log
  const float* delta;  // (bh, s)
  const int* seg;      // (B, s) segment ids or nullptr
  void* dq;            // (bh, s, D)
  void* dk;            // (bh_kv, s, D)
  void* dv;            // (bh_kv, s, D)
  int s, heads, kv_heads;
  int causal, window;  // window <= 0: no window
  float qscale;        // log2(e)/sqrt(d): folded into q (CUDA cores) or applied to
                       // q.k after the product (tensor cores), as the forward does
  float scale;         // the softmax scale, 1/sqrt(d) of the unpadded head dim
  int rows;            // the grid's rows: bh (dQ) or bh_kv (dK/dV)
};

// The CUDA-core kernels run f32 only (bf16 and fp16 take the tensor cores),
// so these conversions are identities; they keep the bodies' rounding
// points visible.
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Whether query qi attends key kj (both local, < s).
template <bool TRI>
__device__ __forceinline__ bool attends(const Params& p, int qi, int kj, bool segments,
                                        int qseg, int kseg) {
  if (TRI) return kj <= qi;
  if (p.causal) {
    const int dist = qi - kj;
    if (dist < 0 || (p.window > 0 && dist >= p.window)) return false;
  }
  return !segments || qseg == kseg;
}

// Rows [r0, r0 + kTile) of a (s, D) matrix into a [kTile][D + 1] f32 tile,
// times mul; rows past s are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int s, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        (r0 + r < s) ? to_f(src[static_cast<size_t>(r0 + r) * D + c]) * mul : 0.f;
  }
}

constexpr size_t dq_smem_bytes(int d) {
  // q (pre-scaled), dO, k, v tiles ([64][d + 1]), dS tile ([64][65]), key
  // segment ids
  return sizeof(float) * (4 * kTile * (d + 1) + kTile * (kTile + 1)) + sizeof(int) * kTile;
}

constexpr size_t dkv_smem_bytes(int d) {
  // k, v, q, dO tiles, P and dS tiles, per-row lse*log2e, delta, segment ids
  return sizeof(float) * (4 * kTile * (d + 1) + 2 * kTile * (kTile + 1) + 2 * kTile) +
         sizeof(int) * kTile;
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void dq_body(const Params& p) {
  static_assert(D == 16, "f32 at head dims 32 and above: flash_bwd_wide's pair");
  constexpr int R = kTile / 16, LP = kTile + 1;  // rows a thread, P/dS stride
  constexpr int LD = D + 1;
  constexpr int CN = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;
  int* kseg = reinterpret_cast<int*>(dss + kTile * LP);

  const int bh = blockIdx.z * kMaxGridY + blockIdx.y;
  if (bh >= p.rows) return;  // past the last row in the last z slice
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int b = bh / p.heads;
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const size_t qoff = static_cast<size_t>(bh) * p.s * D;
  const size_t kvoff = static_cast<size_t>(kv_row) * p.s * D;
  const bool segments = !TRI && p.seg != nullptr;

  stage<T, D>(qs, static_cast<const T*>(p.q) + qoff, q0, p.s, p.qscale);
  stage<T, D>(dos, static_cast<const T*>(p.dout) + qoff, q0, p.s, 1.f);

  float lse2[R], dlt[R], acc[R][CN];
  int qseg[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool in = qi < p.s;
    lse2[i] = in ? p.lse[static_cast<size_t>(bh) * p.s + qi] * kLog2e : -CUDART_INF_F;
    dlt[i] = in ? p.delta[static_cast<size_t>(bh) * p.s + qi] : 0.f;
    qseg[i] = (segments && in) ? p.seg[static_cast<size_t>(b) * p.s + qi] : 0;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  // the keys any row of this q tile can see
  const int q_end = min(q0 + kTile, p.s);
  int k_lo = 0, k_hi = p.s;
  if (TRI || p.causal) k_hi = q_end;
  if (!TRI && p.causal && p.window > 0) k_lo = max(0, q0 - p.window + 1);

  for (int t = k_lo / kTile; t < (k_hi + kTile - 1) / kTile; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's k/dS reads are done
    stage<T, D>(ks, static_cast<const T*>(p.k) + kvoff, k0, p.s, 1.f);
    stage<T, D>(vs, static_cast<const T*>(p.v) + kvoff, k0, p.s, 1.f);
    if (segments && tid < kTile) {
      kseg[tid] = (k0 + tid < p.s) ? p.seg[static_cast<size_t>(b) * p.s + k0 + tid] : 0;
    }
    __syncthreads();

    float sc[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + d];
        dov[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = qi < p.s && kj < p.s && lse2[i] != -CUDART_INF_F &&
                          attends<TRI>(p, qi, kj, segments, qseg[i], kseg[tx + 16 * j]);
        const float pij = live ? exp2f(sc[i][j] - lse2[i]) : 0.f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] - dlt[i]) * p.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[R], kv[CN];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.s) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) dqg[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void dkv_body(const Params& p) {
  static_assert(D == 16, "f32 at head dims 32 and above: flash_bwd_wide's pair");
  constexpr int R = kTile / 16, LP = kTile + 1;  // rows a thread, P/dS stride
  constexpr int LD = D + 1;
  constexpr int CN = D / 16;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* dss = ps + kTile * LP;
  float* lse2 = dss + kTile * LP;
  float* dlt = lse2 + kTile;
  int* qseg = reinterpret_cast<int*>(dlt + kTile);

  const int kv_row = blockIdx.z * kMaxGridY + blockIdx.y;
  if (kv_row >= p.rows) return;  // past the last row in the last z slice
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kTile;
  const int b = kv_row / p.kv_heads;
  const int group = p.heads / p.kv_heads;
  const size_t kvoff = static_cast<size_t>(kv_row) * p.s * D;
  const bool segments = !TRI && p.seg != nullptr;

  stage<T, D>(ks, static_cast<const T*>(p.k) + kvoff, k0, p.s, 1.f);
  stage<T, D>(vs, static_cast<const T*>(p.v) + kvoff, k0, p.s, 1.f);

  // score columns of this thread: keys k0 + tx + 16 j
  int kseg[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int kj = k0 + tx + 16 * j;
    kseg[j] = (segments && kj < p.s) ? p.seg[static_cast<size_t>(b) * p.s + kj] : 0;
  }
  // accumulator rows of this thread: keys k0 + ty + 16 i
  float dk[R][CN], dv[R][CN];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the queries that can see any key of this tile
  const int k_end = min(k0 + kTile, p.s);
  int q_lo = 0, q_hi = p.s;
  if (TRI || p.causal) q_lo = k0;
  if (!TRI && p.causal && p.window > 0) q_hi = min(p.s, k_end - 1 + p.window);
  const int t_lo = q_lo / kTile;
  const int t_hi = (q_hi + kTile - 1) / kTile;

  for (int m = 0; m < group; ++m) {
    // the q head of group member m (flashattention.py q_index)
    const int q_row = b * p.heads + (kv_row % p.kv_heads) * group + m;
    const size_t qoff = static_cast<size_t>(q_row) * p.s * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's q/dO/P/dS reads are done
      stage<T, D>(qs, static_cast<const T*>(p.q) + qoff, q0, p.s, 1.f);
      stage<T, D>(dos, static_cast<const T*>(p.dout) + qoff, q0, p.s, 1.f);
      if (tid < kTile) {
        const int qi = q0 + tid;
        const bool in = qi < p.s;
        lse2[tid] = in ? p.lse[static_cast<size_t>(q_row) * p.s + qi] * kLog2e : -CUDART_INF_F;
        dlt[tid] = in ? p.delta[static_cast<size_t>(q_row) * p.s + qi] : 0.f;
        qseg[tid] = (segments && in) ? p.seg[static_cast<size_t>(b) * p.s + qi] : 0;
      }
      __syncthreads();

      float sc[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          // the same f32 product the forward folds into q
          qv[i] = qs[(ty + 16 * i) * LD + d] * p.qscale;
          dov[i] = dos[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          kv[j] = ks[(tx + 16 * j) * LD + d];
          vv[j] = vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        const int qi = q0 + r;
        const float l2 = lse2[r];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kj = k0 + tx + 16 * j;
          const bool live = qi < p.s && kj < p.s && l2 != -CUDART_INF_F &&
                            attends<TRI>(p, qi, kj, segments, qseg[r], kseg[j]);
          const float pij = live ? exp2f(sc[i][j] - l2) : 0.f;
          ps[r * LP + tx + 16 * j] = round_to<T>(pij);
          dss[r * LP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] - dlt[r]) * p.scale);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[R], dsv[R], dov[CN], qv[CN];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = ps[r * LP + ty + 16 * i];
          dsv[i] = dss[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          dov[c] = dos[r * LD + tx + 16 * c];
          qv[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + kvoff;
  T* dvg = static_cast<T*>(p.dv) + kvoff;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.s) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const size_t off = static_cast<size_t>(kj) * D + tx + 16 * c;
      dkg[off] = from_f<T>(dk[i][c]);
      dvg[off] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tri_kernel(Params p) {
  dq_body<T, D, true>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_rect_kernel(Params p) {
  dq_body<T, D, false>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tri_kernel(Params p) {
  dkv_body<T, D, true>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_rect_kernel(Params p) {
  dkv_body<T, D, false>(p);
}

// ---------------------------------------------------------------------------
// The 16-bit pairs on the tensor cores: wgmma + TMA (see the note on top).
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // depth of the ring of 64-row tiles
// dK/dV at two consumer warpgroups: registers a thread after setmaxnreg
// (2 x 128 x 232 + 128 x 40 <= 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// dK/dV consumer warpgroups per 64 keys: at D = 256 dK and dV alone are 256
// f32 a thread, past the 255 a thread may hold, so two warpgroups share the
// keys and each accumulates dK and dV for its share of the CTA's columns
// (halves at D = 256 and 512; two boxes and one at D = 576)
template <int D>
__host__ __device__ constexpr int kv_split() { return D > 128 ? 2 : 1; }
// the general pair's staged segment ids: kStages x (the ring tile's 64 ids,
// then their min and max), int32
constexpr int kSegBytes = kStages * (kTile + 2) * 4;
// At D = 512 (see the note on top): one ring stage of 32-row tiles, and two
// CTAs per own-side tile, each on a column half of the gradients; at D = 576
// the same ring and three CTAs, each on a column third.
template <int D>
__host__ __device__ constexpr int stages() { return D > 256 ? 1 : kStages; }
template <int D>
__host__ __device__ constexpr int ring_rows() { return D > 256 ? 32 : kTile; }
template <int D>
constexpr int seg_bytes() { return D > 256 ? (ring_rows<D>() + 2) * 4 : kSegBytes; }
template <int D>
__host__ __device__ constexpr int col_split() { return D > 512 ? 3 : D > 256 ? 2 : 1; }

template <int D, int WG, bool TRI>
constexpr int dq_tc_smem_bytes() {
  // alignment slack, Q and dO tiles (64 WG rows), stages<D> K and V tiles
  // (ring_rows<D> keys), the keys' segment ids (general pair),
  // full/empty/Q barriers
  return kSmemAlign + (2 * 64 * WG + 2 * stages<D>() * ring_rows<D>()) * D * 2 +
         (TRI ? 0 : seg_bytes<D>()) + 8 * (2 * stages<D>() + 1);
}

// The dK/dV consumers' exchange at D = 256 (dkv_tc_body): per consumer
// warpgroup the P^T and dS^T A fragments of its 32 q rows of the ring tile,
// 16 bytes (one k16 step) a thread, as [warpgroup][P^T, dS^T][k16 step][thread]
constexpr int kXchBytes = 2 * 2 * 2 * 128 * 16;
static_assert(kXchBytes == 2 * 2 * kTile * (kTile / 2) * 2, "P^T and dS^T of a tile, 16-bit");
template <int D>
__host__ __device__ constexpr int xch_bytes() {
  return kv_split<D>() > 1 && col_split<D>() == 1 ? kXchBytes : 0;
}

template <int D, int WG, bool TRI>
constexpr int dkv_tc_smem_bytes() {
  // alignment slack, K and V tiles (64 WG keys), stages<D> Q and dO tiles
  // (ring_rows<D> rows), the exchange (D = 256), the rows' lse and delta
  // (f32) and segment ids (general pair), full/empty/KV barriers
  return kSmemAlign + (2 * 64 * WG + 2 * stages<D>() * ring_rows<D>()) * D * 2 + xch_bytes<D>() +
         2 * stages<D>() * ring_rows<D>() * 4 + (TRI ? 0 : seg_bytes<D>()) +
         8 * (2 * stages<D>() + 1);
}
static_assert(dkv_tc_smem_bytes<256, 1, false>() <= 232448,
              "past the shared memory a block may use");

// A barrier of the `count` consumer threads that reach it (named barrier
// `id`, 1-15: 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
constexpr int kXchFree = 1;  // the other warpgroup has read the last exchange
constexpr int kXchFull = 2;  // both warpgroups have written this one

// dQ on the tensor cores. blockIdx.x: (batch, head) row; blockIdx.y: q tile
// of 64 WG rows, reversed under a plain causal mask so that the heaviest
// tiles launch first (with a window or none, every tile walks about as far);
// blockIdx.z: the column slice of dQ at D = 512 (halves) and 576 (thirds).
// TRI: the triangle; else the general masks of Params.
template <typename T, int D, int WG, bool TRI>
__device__ __forceinline__ void dq_tc_body(const Params& p, const CUtensorMap* qmap,
                                           const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           const CUtensorMap* domap) {
  static_assert(kElem16<T>, "the tensor-core backward is bf16 or fp16");
  using G = Geo<D>;
  constexpr int BM = 64 * WG;
  constexpr int KT = ring_rows<D>();      // keys of a ring tile
  constexpr int ST = stages<D>();
  constexpr int DC = D / col_split<D>();  // this CTA's columns of dQ
  constexpr uint32_t kQBytes = BM * D * 2;
  constexpr uint32_t kKVBytes = KT * D * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* q_s = base;
  unsigned char* do_s = q_s + kQBytes;
  unsigned char* k_s = do_s + kQBytes;            // stage st at k_s + st * kKVBytes
  unsigned char* v_s = k_s + ST * kKVBytes;  // likewise
  int* kid_s = reinterpret_cast<int*>(v_s + ST * kKVBytes);  // general: [ST][KT]
  int* krange_s = kid_s + ST * KT;                           // general: [ST][min, max]
  uint64_t* full = reinterpret_cast<uint64_t*>(TRI ? reinterpret_cast<unsigned char*>(kid_s)
                                                   : reinterpret_cast<unsigned char*>(
                                                         krange_s + 2 * ST));
  uint64_t* empty = full + ST;
  uint64_t* q_full = empty + ST;

  const bool causal = TRI || p.causal;
  const int window = TRI ? 0 : p.window;  // > 0: the band (the entry drops one >= s)
  const bool segments = !TRI && p.seg != nullptr;
  const int bh = blockIdx.x;
  const int q0 = (causal && window == 0 ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int col0 = DC < D ? static_cast<int>(blockIdx.z) * DC : 0;  // the CTA's first column
  // the key tiles some row of the CTA can see: all of them, or up to the
  // diagonal, from the window's first key on
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / KT : 0;
  const int t_hi = ((causal ? min(p.s, q0 + BM) : p.s) + KT - 1) / KT;
  const int n_tiles = t_hi - t_lo;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.s : nullptr;
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
    // producer warp: lane 0 loads Q and dO once, then K and V tile by tile
    // through the ring; with segment ids, lanes 1-31 stage each tile's key
    // ids and their range beside it, so that no id load delays a TMA
    if (lane == 0) {
      const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
      mbar_expect_tx(q_full, 2 * kQBytes);
#pragma unroll
      for (int b = 0; b < G::kBoxes; ++b) {
        tma_load_3d(q_s + b * BM * G::kRowBytes, qmap, q_full, b * G::kCols, q0, bh);
        tma_load_3d(do_s + b * BM * G::kRowBytes, domap, q_full, b * G::kCols, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST;
        const int k0 = (t_lo + t) * KT;
        if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kKVBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(k_s + st * kKVBytes + b * KT * G::kRowBytes, kmap, &full[st],
                      b * G::kCols, k0, kv_row);
          tma_load_3d(v_s + st * kKVBytes + b * KT * G::kRowBytes, vmap, &full[st],
                      b * G::kCols, k0, kv_row);
        }
      }
    } else if (segments) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
        const int2 range = id_range<KT>(seg, (t_lo + t) * KT, p.s, lane - 1, 31, 0xfffffffeu,
                                        kid_s + st * KT);
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
  const float qscale = p.qscale, scale = p.scale;
  const int win = window > 0 ? window : INT_MAX;
  float l2[2], dl[2];  // lse * log2(e) and delta of rows r0, r0 + 8; +inf keeps P = 0
  int qid[2] = {0, 0};  // their segment ids
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t at = static_cast<size_t>(bh) * p.s + row;
    const float lse = row < p.s ? p.lse[at] : -CUDART_INF_F;
    l2[h] = lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e;
    dl[h] = row < p.s ? p.delta[at] : 0.f;
    if (segments && row < p.s) qid[h] = seg[row];
  }
  // the segment ids of the warpgroup's rows: one id throughout when x == y
  const int2 qrange =
      segments ? id_range(seg, w0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  float dq[DC / 2], s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % ST;
    const int k0 = (t_lo + t) * KT;
    mbar_wait(&full[st], (t / ST) & 1);
    // whether some key of the tile is at or before some row and inside the
    // window, and whether some pair needs the element mask: a key after a
    // row, outside the window or past s
    bool sees = w0 < p.s;
    bool masked = causal && k0 + KT - 1 > w0;
    if (causal) sees = sees && k0 <= w0 + 63;
    if (window > 0) {
      sees = sees && w0 - (k0 + KT - 1) < window;
      masked = masked || w0 + 63 - k0 >= window;
    }
    if (!TRI) masked = masked || k0 + KT > p.s;
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
      const int2* kid = reinterpret_cast<const int2*>(kid_s + st * KT);
      wgmma_fence();
      mma_rows_by_rows<T, D, KT>(s, q_s, BM, wg * 64, ks);    // S = Q.K^T
      mma_rows_by_rows<T, D, KT>(dp, do_s, BM, wg * 64, vs);  // dP = dO.V^T
      wgmma_commit();
      wgmma_wait_all();
      hold(s);
      hold(dp);

      uint32_t dsa[KT / 16][4];
      // dS from S and dP, with the element mask or (a fast tile) without:
      // two instantiations, as the reference's _dispatch_block emits two
      // branches, so that a fast tile issues no mask instruction
      auto form_ds = [&](auto mask) {
        constexpr bool kMask = decltype(mask)::value;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          int2 kj = make_int2(0, 0);  // the segment ids of keys 8 j + 2 tq (+1)
          if (kMask && segments) kj = kid[4 * j + tq];
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * (e / 2);
            const int key = k0 + 8 * j + 2 * tq + e % 2;
            float pe = exp2f(fmaf(s[4 * j + e], qscale, -l2[e / 2]));
            if constexpr (kMask) {
              bool live;
              if constexpr (TRI) {
                live = key <= row;
              } else {
                live = key < p.s && (!causal || (key <= row && row - key < win));
                if (segments) live = live && (e % 2 ? kj.y : kj.x) == qid[e / 2];
              }
              if (!live) pe = 0.f;
            }
            ds[e] = pe * (dp[4 * j + e] - dl[e / 2]) * scale;
          }
          // the accumulator layout of dS is wgmma's register layout of A
          dsa[j / 2][2 * (j % 2)] = pack2<T>(ds[0], ds[1]);
          dsa[j / 2][2 * (j % 2) + 1] = pack2<T>(ds[2], ds[3]);
        }
      };
      if (masked) {
        form_ds(std::true_type{});
      } else {
        form_ds(std::false_type{});
      }

      hold(dsa);
      wgmma_fence();
      mma_frag_by_tile<T, D, DC, KT>(dq, dsa, ks, col0 / G::kCols);  // dQ += dS.K, K MN-major
      wgmma_commit();
      wgmma_wait_all();
      hold(dq);
      hold(dsa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  T* dqg = static_cast<T*>(p.dq) + static_cast<size_t>(bh) * p.s * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.s) continue;
    // T pairs
    uint32_t* out = reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row) * D + col0);
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      out[4 * j + tq] = pack2<T>(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
    }
  }
}

// dK/dV on the tensor cores at D <= 256 (D 512 and 576: dkv_slice_body).
// blockIdx.x: part x kv rows + kv row, the GQA walk in sp = gridDim.x /
// rows parts (part j walks members [j group / sp, (j + 1) group / sp) and,
// at sp > 1, writes f32 partials that flash_bwd_dkv_split_sum_kernel adds in
// part order); blockIdx.y: key tile of 64 WG keys, so every part's key tile
// 0 (under a causal mask the longest walks) launches first. With segment
// ids, the producer and the consumers each reduce a q tile's ids to their
// range and pass over a tile whose one document is not the CTA's keys' one:
// no TMA, no ring stage, no barrier. At D = 256 each consumer
// warpgroup forms S^T and dP^T for its half of the tile's q rows over all of
// D and hands its P^T and dS^T halves to the other through shared memory
// (two named barriers a tile), so S^T and dP^T are formed once. TRI: the
// triangle; else the general masks of Params.
template <typename T, int D, int WG, bool TRI>
__device__ __forceinline__ void dkv_tc_body(const Params& p, const CUtensorMap* qmap,
                                            const CUtensorMap* kmap, const CUtensorMap* vmap,
                                            const CUtensorMap* domap) {
  static_assert(kElem16<T>, "the tensor-core backward is bf16 or fp16");
  static_assert(col_split<D>() == 1, "D 512 and 576: dkv_slice_body");
  using G = Geo<D>;
  constexpr int BN = 64 * WG;
  constexpr int CS = kv_split<D>();  // warpgroups per 64 keys, each on a share of the columns
  constexpr int NC = WG * CS;        // consumer warpgroups
  constexpr int DC = D / CS;         // a consumer's columns of dK and dV
  constexpr int QH = kTile / CS;     // the q rows of a ring tile whose S^T and dP^T it forms
  constexpr int ST = kStages;
  constexpr uint32_t kKVBytes = BN * D * 2;
  constexpr uint32_t kQBytes = kTile * D * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* k_s = base;
  unsigned char* v_s = k_s + kKVBytes;
  unsigned char* q_s = v_s + kKVBytes;        // stage st at q_s + st * kQBytes
  unsigned char* do_s = q_s + ST * kQBytes;   // likewise
  unsigned char* xch_s = do_s + ST * kQBytes;  // D = 256: the exchange, kXchBytes
  float* lse_s = reinterpret_cast<float*>(xch_s + xch_bytes<D>());  // [ST][64]
  float* dl_s = lse_s + ST * kTile;                                // likewise
  int* qid_s = reinterpret_cast<int*>(dl_s + ST * kTile);  // general: [ST][64], kSegBytes in all
  uint64_t* full = reinterpret_cast<uint64_t*>(TRI ? reinterpret_cast<unsigned char*>(qid_s)
                                                   : reinterpret_cast<unsigned char*>(qid_s) +
                                                         kSegBytes);
  uint64_t* empty = full + ST;
  uint64_t* kv_full = empty + ST;

  const bool causal = TRI || p.causal;
  const int window = TRI ? 0 : p.window;  // > 0: the band (the entry drops one >= s)
  const bool segments = !TRI && p.seg != nullptr;
  const int kv_row = blockIdx.x % p.rows;
  const int part = blockIdx.x / p.rows;
  const int k0 = blockIdx.y * BN;
  const int group = p.heads / p.kv_heads;
  const int share = group / (gridDim.x / p.rows);  // the part's GQA members
  // the q head of group member m is q_row0 + m (flashattention.py q_index)
  const int q_row0 =
      (kv_row / p.kv_heads) * p.heads + (kv_row % p.kv_heads) * group + part * share;
  // the q tiles that can see some key of the CTA: all of them, or from the
  // diagonal down, to the last row inside the window of the last key
  const int t_lo = causal ? k0 / kTile : 0;
  const int q_end = window > 0 ? min(p.s, min(k0 + BN, p.s) - 1 + window) : p.s;
  const int per_member = (q_end + kTile - 1) / kTile - t_lo;
  const int n_steps = share * per_member;
  const int* seg = segments ? p.seg + static_cast<size_t>(kv_row / p.kv_heads) * p.s : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // (segment ids; every lane of a warp calls these) the id range of the
  // CTA's keys (read once the K and V copies are under way), a lane's two
  // ids of q tile t (a position past s reads the last id inside s, which
  // lies in the same tile) and the warp's range of them: a q tile that
  // holds one document while the keys hold one other has no live (q, k)
  // pair, and it is never loaded
  int2 keys = make_int2(0, 0);
  auto key_range = [&] { return id_range<BN>(seg, k0, p.s, lane, 32, ~0u, nullptr); };
  auto tile_ids = [&](int t) {
    return make_int2(seg[min(t * kTile + lane, p.s - 1)], seg[min(t * kTile + lane + 32, p.s - 1)]);
  };
  auto range_of = [&](int2 ids) {
    return warp_range(~0u, min(ids.x, ids.y), max(ids.x, ids.y));
  };
  auto dead = [&](int2 r) { return r.x == r.y && keys.x == keys.y && r.x != keys.x; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1 + 32);  // the TMA bytes, then each producer lane's staged values
      mbar_init(&empty[st], NC * 4);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {
    // the producer warpgroup: beside two consumer warpgroups it hands
    // registers to them (dK and dV at D = 128 need more than the 168 a
    // thread of 384 gets, and at D = 256 each consumer's half does); its
    // first warp loads K and V once, then per live (member, q tile) Q and
    // dO by TMA and the tile's lse (base 2; +inf past s), delta and segment
    // ids by plain loads
    if constexpr (NC == 2) reg_dealloc<kProducerRegs>();
    if (warp == NC * 4) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKVBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(k_s + b * BN * G::kRowBytes, kmap, kv_full, b * G::kCols, k0, kv_row);
          tma_load_3d(v_s + b * BN * G::kRowBytes, vmap, kv_full, b * G::kCols, k0, kv_row);
        }
      }
      bool keyed = false;  // (segment ids) the keys' range, read at the first tile that needs it
      int n = 0;  // ring tiles loaded
      for (int i = 0; i < n_steps; ++i) {
        const int t = t_lo + i % per_member;
        // a q tile whose positions overlap the keys' holds a live pair: no
        // test, so a causal walk's first tile loads with no id read before it
        if (segments && (t * kTile >= k0 + BN || (t + 1) * kTile <= k0)) {
          if (!keyed) keys = key_range();
          keyed = true;
          if (dead(range_of(tile_ids(t)))) continue;
        }
        const int st = n % ST;
        const int q_row = q_row0 + i / per_member;
        const int q0 = t * kTile;
        if (n >= ST) mbar_wait(&empty[st], ((n / ST) - 1) & 1);
        ++n;
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kQBytes);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b) {
            tma_load_3d(q_s + st * kQBytes + b * kTile * G::kRowBytes, qmap, &full[st],
                        b * G::kCols, q0, q_row);
            tma_load_3d(do_s + st * kQBytes + b * kTile * G::kRowBytes, domap, &full[st],
                        b * G::kCols, q0, q_row);
          }
        }
        for (int c = lane; c < kTile; c += 32) {
          const int q = q0 + c;
          const size_t at = static_cast<size_t>(q_row) * p.s + q;
          const float lse = q < p.s ? p.lse[at] : -CUDART_INF_F;
          lse_s[st * kTile + c] = lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e;
          dl_s[st * kTile + c] = q < p.s ? p.delta[at] : 0.f;
          if (segments) qid_s[st * kTile + c] = q < p.s ? seg[q] : 0;
        }
        mbar_arrive(&full[st]);  // releases this lane's stores to the consumers
      }
    }
  } else {
    if constexpr (NC == 2) reg_alloc<kConsumerRegs>();
    // consumers: warpgroup wg owns keys w0 .. w0 + 63 and computes dK/dV
    // columns c0 .. c0 + DC - 1 (all of them but at D = 256), and at D = 256
    // S^T and dP^T for q rows r0 .. r0 + QH - 1 of each tile; this thread
    // holds keys key and key + 8 (accumulator rows) at q rows 8 j + 2 tq (+1)
    const int wg = warp / 4;
    const int kw = wg / CS;          // the 64-key slice
    const int half = wg % CS;        // its share of the slice
    const int c0 = half * DC;
    const int r0 = half * QH;
    const int box = c0 / G::kCols;   // c0 as a column box of the Q and dO tiles
    const int tq = lane % 4;
    const int w0 = k0 + kw * 64;
    const int key = w0 + (warp % 4) * 16 + lane / 4;
    const float qscale = p.qscale, scale = p.scale;
    const int win = window > 0 ? window : INT_MAX;
    int kid[2] = {0, 0};  // the segment ids of keys key and key + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (segments && key + 8 * h < p.s) kid[h] = seg[key + 8 * h];
    }
    // the segment ids of the warpgroup's keys: one id throughout when x == y
    const int2 krange =
        segments ? id_range(seg, w0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
    float dk[DC / 2], dv[DC / 2], s[QH / 2], dp[QH / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < QH / 2; ++i) s[i] = dp[i] = 0.f;

    // (segment ids) the next step's ids, loaded under this step's work
    int2 ids = make_int2(0, 0);
    if (segments) {
      keys = key_range();
      if (n_steps > 0) ids = tile_ids(t_lo);
    }
    mbar_wait(kv_full, 0);
    int n = 0;  // ring tiles consumed
    for (int i = 0; i < n_steps; ++i) {
      const int t = t_lo + i % per_member;
      const int2 qr = segments ? range_of(ids) : make_int2(0, 0);
      if (segments && i + 1 < n_steps) ids = tile_ids(t_lo + (i + 1) % per_member);
      if (segments && dead(qr)) continue;
      const int st = n % ST;
      const int q0 = t * kTile;
      mbar_wait(&full[st], (n / ST) & 1);
      ++n;
      // whether some row of the tile is at or after some key and inside the
      // window, and whether some pair needs the element mask: a row before a
      // key or outside the window (rows past s have P = 0 from their lse,
      // and keys past s are never written). Every test is the same for both
      // warpgroups of a key slice, which meet at the exchange.
      bool sees = w0 < p.s;
      bool masked = causal && q0 < w0 + 63;
      if (causal) sees = sees && q0 + kTile - 1 >= w0;
      if (window > 0) {
        sees = sees && q0 - (w0 + 63) < window;
        masked = masked || q0 + kTile - 1 - w0 >= window;
      }
      if (segments) {
        // both sides one document each: the fast path when it is the same
        // one, no live pair (and no products) when it is not
        const bool uniform = krange.x == krange.y && qr.x == qr.y;
        sees = sees && !(uniform && krange.x != qr.x);
        masked = masked || !uniform;
      }
      if (sees) {
        const unsigned char* qs = q_s + st * kQBytes;
        const unsigned char* dos = do_s + st * kQBytes;
        const float2* l2 = reinterpret_cast<const float2*>(lse_s + st * kTile);
        const float2* dl = reinterpret_cast<const float2*>(dl_s + st * kTile);
        const int2* qid = reinterpret_cast<const int2*>(qid_s + st * kTile);
        // S^T = K.Q^T and dP^T = V.dO^T over all of D for the warpgroup's q rows
        wgmma_fence();
        mma_rows_by_ring_rows<T, D, QH>(s, k_s, BN, kw * 64, qs, r0);
        mma_rows_by_ring_rows<T, D, QH>(dp, v_s, BN, kw * 64, dos, r0);
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        hold(dp);

        // P^T and dS^T of the tile's 64 q rows as wgmma A fragments; the
        // warpgroup forms steps 0 .. QH / 16 - 1 (its q rows) here
        uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
        // with the element mask or (a fast tile) without, as in dQ
        auto form_p_ds = [&](auto mask) {
          constexpr bool kMask = decltype(mask)::value;
#pragma unroll
          for (int j = 0; j < QH / 8; ++j) {
            const int c = (r0 + 8 * j) / 2 + tq;  // rows r0 + 8 j + 2 tq (+1), as pairs
            const float2 lj = l2[c], dj = dl[c];
            int2 qj = make_int2(0, 0);  // and their segment ids
            if (kMask && segments) qj = qid[c];
            float pe[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = q0 + 2 * c + e % 2;
              const int kk = key + 8 * (e / 2);
              const float lse2 = e % 2 ? lj.y : lj.x;
              float v = exp2f(fmaf(s[4 * j + e], qscale, -lse2));
              if constexpr (kMask) {
                bool live;
                if constexpr (TRI) {
                  live = q >= kk;
                } else {
                  live = !causal || (q >= kk && q - kk < win);
                  if (segments) live = live && (e % 2 ? qj.y : qj.x) == kid[e / 2];
                }
                if (!live) v = 0.f;
              }
              pe[e] = v;
              ds[e] = v * (dp[4 * j + e] - (e % 2 ? dj.y : dj.x)) * scale;
            }
            // the accumulator layout of P^T and dS^T is wgmma's register layout of A
            pa[j / 2][2 * (j % 2)] = pack2<T>(pe[0], pe[1]);
            pa[j / 2][2 * (j % 2) + 1] = pack2<T>(pe[2], pe[3]);
            dsa[j / 2][2 * (j % 2)] = pack2<T>(ds[0], ds[1]);
            dsa[j / 2][2 * (j % 2) + 1] = pack2<T>(ds[2], ds[3]);
          }
        };
        if (masked) {
          form_p_ds(std::true_type{});
        } else {
          form_p_ds(std::false_type{});
        }

        if constexpr (CS > 1) {
          // hand the warpgroup's k16 steps to the other and take all of the
          // tile's, both warpgroups' thread i holding the same keys
          constexpr int KS = QH / 16;
          const int me = threadIdx.x % 128;
          uint4* xch = reinterpret_cast<uint4*>(xch_s);  // [CS][P^T, dS^T][KS][128]
          uint4* mine = xch + half * 2 * KS * 128;
          named_sync(kXchFree, NC * 128);
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            mine[k * 128 + me] = make_uint4(pa[k][0], pa[k][1], pa[k][2], pa[k][3]);
            mine[(KS + k) * 128 + me] = make_uint4(dsa[k][0], dsa[k][1], dsa[k][2], dsa[k][3]);
          }
          named_sync(kXchFull, NC * 128);
#pragma unroll
          for (int k = 0; k < kTile / 16; ++k) {
            const uint4* from = xch + (k / KS) * 2 * KS * 128 + (k % KS) * 128 + me;
            const uint4 a = from[0], b = from[KS * 128];
            pa[k][0] = a.x, pa[k][1] = a.y, pa[k][2] = a.z, pa[k][3] = a.w;
            dsa[k][0] = b.x, dsa[k][1] = b.y, dsa[k][2] = b.z, dsa[k][3] = b.w;
          }
        }

        hold(pa);
        hold(dsa);
        wgmma_fence();
        mma_frag_by_tile<T, D, DC>(dv, pa, dos, box);  // dV += P^T.dO, dO MN-major
        mma_frag_by_tile<T, D, DC>(dk, dsa, qs, box);  // dK += dS^T.Q, Q MN-major
        wgmma_commit();
        wgmma_wait_all();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }

    // dK and dV's row blockIdx.x: the kv row, or (sp > 1) part x kv rows +
    // kv row of the f32 partials, dK's [sp][rows][s][D], then dV's
    const size_t row = blockIdx.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = key + 8 * h;
      if (kj >= p.s) continue;
      const size_t at = (row * p.s + kj) * D + c0;
      if (gridDim.x == p.rows) {  // one part: T pairs
        auto* dkr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dk) + at);
        auto* dvr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dv) + at);
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          dkr[4 * j + tq] = pack2<T>(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
          dvr[4 * j + tq] = pack2<T>(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
      } else {
        auto* dkr = reinterpret_cast<float2*>(static_cast<float*>(p.dk) + at);
        auto* dvr = reinterpret_cast<float2*>(static_cast<float*>(p.dv) + at);
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          dkr[4 * j + tq] = make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
          dvr[4 * j + tq] = make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// dK/dV on the tensor cores at D = 512 and 576 (D <= 256: dkv_tc_body).
// blockIdx.x: kv row; blockIdx.y: key tile of 64 WG keys, in order (under a
// causal mask the first keys, the longest walks, launch first); blockIdx.z:
// the column slice of dK and dV, halves (512) or thirds (576). TRI: the
// triangle; else the general masks of Params.
template <typename T, int D, int WG, bool TRI>
__device__ __forceinline__ void dkv_slice_body(const Params& p, const CUtensorMap* qmap,
                                               const CUtensorMap* kmap, const CUtensorMap* vmap,
                                               const CUtensorMap* domap) {
  static_assert(kElem16<T>, "the tensor-core backward is bf16 or fp16");
  static_assert(col_split<D>() > 1, "D <= 256: dkv_tc_body");
  using G = Geo<D>;
  constexpr int BN = 64 * WG;
  constexpr int CS = kv_split<D>();  // warpgroups per 64 keys, each on a share of the columns
  constexpr int NC = WG * CS;        // consumer warpgroups
  constexpr int DCTA = D / col_split<D>();  // the CTA's dK and dV columns
  // a consumer's columns, in whole column boxes (an MN-major operand starts
  // on a box): warpgroup w of a key slice owns DC from w DC on, the last
  // one the rest. Every consumer's products are DC wide, so that all run
  // the same wgmma (one on a divergent path is serialized): at D = 576
  // (two boxes and one) the last one's products start a box early, inside
  // the CTA's columns, and it writes only its own.
  constexpr int DC = (DCTA / G::kCols + CS - 1) / CS * G::kCols;
  constexpr bool kOverlap = CS * DC > DCTA;
  static_assert(DCTA >= DC && DCTA > (CS - 1) * DC, "each consumer owns some of the columns");
  constexpr int QT = ring_rows<D>();           // q rows of a ring tile
  constexpr int ST = stages<D>();
  constexpr uint32_t kKVBytes = BN * D * 2;
  constexpr uint32_t kQBytes = QT * D * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* k_s = base;
  unsigned char* v_s = k_s + kKVBytes;
  unsigned char* q_s = v_s + kKVBytes;        // stage st at q_s + st * kQBytes
  unsigned char* do_s = q_s + ST * kQBytes;   // likewise
  float* lse_s = reinterpret_cast<float*>(do_s + ST * kQBytes);  // [ST][QT]
  float* dl_s = lse_s + ST * QT;                                 // likewise
  int* qid_s = reinterpret_cast<int*>(dl_s + ST * QT);  // general: [ST][QT]
  int* qrange_s = qid_s + ST * QT;                      // general: [ST][min, max]
  uint64_t* full = reinterpret_cast<uint64_t*>(TRI ? reinterpret_cast<unsigned char*>(qid_s)
                                                   : reinterpret_cast<unsigned char*>(
                                                         qrange_s + 2 * ST));
  uint64_t* empty = full + ST;
  uint64_t* kv_full = empty + ST;

  const bool causal = TRI || p.causal;
  const int window = TRI ? 0 : p.window;  // > 0: the band (the entry drops one >= s)
  const bool segments = !TRI && p.seg != nullptr;
  const int kv_row = blockIdx.x;
  const int k0 = blockIdx.y * BN;
  const int group = p.heads / p.kv_heads;
  // the q head of group member m is q_row0 + m (flashattention.py q_index)
  const int q_row0 = (kv_row / p.kv_heads) * p.heads + (kv_row % p.kv_heads) * group;
  // the q tiles that can see some key of the CTA: all of them, or from the
  // diagonal down, to the last row inside the window of the last key
  const int t_lo = causal ? k0 / QT : 0;
  const int q_end = window > 0 ? min(p.s, min(k0 + BN, p.s) - 1 + window) : p.s;
  const int per_member = (q_end + QT - 1) / QT - t_lo;
  const int n_steps = group * per_member;
  const int* seg = segments ? p.seg + static_cast<size_t>(kv_row / p.kv_heads) * p.s : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1 + 32);  // the TMA bytes, then each producer lane's staged values
      mbar_init(&empty[st], NC * 4);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {
    // the producer warpgroup: beside two consumer warpgroups it hands
    // registers to them (dK and dV at D = 128 need more than the 168 a
    // thread of 384 gets, and at D = 256 each consumer's half does); its
    // first warp loads K and V once, then per (member, q tile) Q and dO by
    // TMA and the tile's lse (base 2; +inf past s), delta and segment ids
    // by plain loads
    if constexpr (NC == 2) reg_dealloc<kProducerRegs>();
    if (warp == NC * 4) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKVBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load_3d(k_s + b * BN * G::kRowBytes, kmap, kv_full, b * G::kCols, k0, kv_row);
          tma_load_3d(v_s + b * BN * G::kRowBytes, vmap, kv_full, b * G::kCols, k0, kv_row);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % ST;
        const int q_row = q_row0 + i / per_member;
        const int q0 = (t_lo + i % per_member) * QT;
        if (i >= ST) mbar_wait(&empty[st], ((i / ST) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kQBytes);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b) {
            tma_load_3d(q_s + st * kQBytes + b * QT * G::kRowBytes, qmap, &full[st],
                        b * G::kCols, q0, q_row);
            tma_load_3d(do_s + st * kQBytes + b * QT * G::kRowBytes, domap, &full[st],
                        b * G::kCols, q0, q_row);
          }
        }
        int lo = INT_MAX, hi = INT_MIN;  // (segment ids) the rows' range inside s
        for (int c = lane; c < QT; c += 32) {
          const int q = q0 + c;
          const size_t at = static_cast<size_t>(q_row) * p.s + q;
          const float lse = q < p.s ? p.lse[at] : -CUDART_INF_F;
          const int id = segments && q < p.s ? seg[q] : 0;  // loaded beside lse and delta
          lse_s[st * QT + c] = lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e;
          dl_s[st * QT + c] = q < p.s ? p.delta[at] : 0.f;
          if (segments) {
            qid_s[st * QT + c] = id;
            if (q < p.s) {
              lo = min(lo, id);
              hi = max(hi, id);
            }
          }
        }
        if (segments) {
          const int2 range = warp_range(~0u, lo, hi);
          if (lane == 0) {
            qrange_s[2 * st] = range.x;
            qrange_s[2 * st + 1] = range.y;
          }
        }
        mbar_arrive(&full[st]);  // releases this lane's stores to the consumers
      }
    }
  } else {
    if constexpr (NC == 2) reg_alloc<kConsumerRegs>();
    // consumers: warpgroup wg owns keys w0 .. w0 + 63 and computes dK/dV
    // columns c0 .. c0 + DC - 1 (all of them but at D = 256, 512 and 576),
    // writing those from its own first column on; this thread holds keys key
    // and key + 8 (accumulator rows) at q rows 8 j + 2 tq (+1) of a tile
    const int wg = warp / 4;
    const int kw = wg / CS;            // the 64-key slice
    const int own = (wg % CS) * DC;    // its first column inside the CTA's
    // its products' first column inside the CTA's, and the 8-column groups
    // of its accumulators before its own first column (D = 576's last: 8)
    const int first = kOverlap ? min(own, DCTA - DC) : own;
    const int skip = kOverlap ? (own - first) / 8 : 0;
    // the first column: the CTA's column slice (D = 512 and 576), then the warpgroup's
    const int c0 = (DCTA < D ? static_cast<int>(blockIdx.z) * DCTA : 0) + first;
    const int box = c0 / G::kCols;     // ... as a column box of the Q and dO tiles
    const int tq = lane % 4;
    const int w0 = k0 + kw * 64;
    const int key = w0 + (warp % 4) * 16 + lane / 4;
    const float qscale = p.qscale, scale = p.scale;
    const int win = window > 0 ? window : INT_MAX;
    int kid[2] = {0, 0};  // the segment ids of keys key and key + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (segments && key + 8 * h < p.s) kid[h] = seg[key + 8 * h];
    }
    // the segment ids of the warpgroup's keys: one id throughout when x == y
    const int2 krange =
        segments ? id_range(seg, w0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
    float dk[DC / 2], dv[DC / 2], s[QT / 2], dp[QT / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % ST;
      const int q0 = (t_lo + i % per_member) * QT;
      mbar_wait(&full[st], (i / ST) & 1);
      // whether some row of the tile is at or after some key and inside the
      // window, and whether some pair needs the element mask: a row before a
      // key or outside the window (rows past s have P = 0 from their lse,
      // and keys past s are never written)
      bool sees = w0 < p.s;
      bool masked = causal && q0 < w0 + 63;
      if (causal) sees = sees && q0 + QT - 1 >= w0;
      if (window > 0) {
        sees = sees && q0 - (w0 + 63) < window;
        masked = masked || q0 + QT - 1 - w0 >= window;
      }
      if (segments) {
        // both sides one document each: the fast path when it is the same
        // one, no live pair (and no products) when it is not
        const int qmin = qrange_s[2 * st], qmax = qrange_s[2 * st + 1];
        const bool uniform = krange.x == krange.y && qmin == qmax;
        sees = sees && !(uniform && krange.x != qmin);
        masked = masked || !uniform;
      }
      if (sees) {
        const unsigned char* qs = q_s + st * kQBytes;
        const unsigned char* dos = do_s + st * kQBytes;
        const float2* l2 = reinterpret_cast<const float2*>(lse_s + st * QT);
        const float2* dl = reinterpret_cast<const float2*>(dl_s + st * QT);
        const int2* qid = reinterpret_cast<const int2*>(qid_s + st * QT);
        // S^T and dP^T over all of D: at D = 256 and 512 both warpgroups of a
        // key slice form them, each for its own share of dK and dV
        wgmma_fence();
        mma_rows_by_rows<T, D, QT>(s, k_s, BN, kw * 64, qs);    // S^T = K.Q^T
        mma_rows_by_rows<T, D, QT>(dp, v_s, BN, kw * 64, dos);  // dP^T = V.dO^T
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        hold(dp);

        uint32_t pa[QT / 16][4], dsa[QT / 16][4];
        // P^T and dS^T, with the element mask or (a fast tile) without, as in dQ
        auto form_p_ds = [&](auto mask) {
          constexpr bool kMask = decltype(mask)::value;
#pragma unroll
          for (int j = 0; j < QT / 8; ++j) {
            const float2 lj = l2[4 * j + tq], dj = dl[4 * j + tq];  // rows 8 j + 2 tq (+1)
            int2 qj = make_int2(0, 0);                              // and their segment ids
            if (kMask && segments) qj = qid[4 * j + tq];
            float pe[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = q0 + 8 * j + 2 * tq + e % 2;
              const int kk = key + 8 * (e / 2);
              const float lse2 = e % 2 ? lj.y : lj.x;
              float v = exp2f(fmaf(s[4 * j + e], qscale, -lse2));
              if constexpr (kMask) {
                bool live;
                if constexpr (TRI) {
                  live = q >= kk;
                } else {
                  live = !causal || (q >= kk && q - kk < win);
                  if (segments) live = live && (e % 2 ? qj.y : qj.x) == kid[e / 2];
                }
                if (!live) v = 0.f;
              }
              pe[e] = v;
              ds[e] = v * (dp[4 * j + e] - (e % 2 ? dj.y : dj.x)) * scale;
            }
            // the accumulator layout of P^T and dS^T is wgmma's register layout of A
            pa[j / 2][2 * (j % 2)] = pack2<T>(pe[0], pe[1]);
            pa[j / 2][2 * (j % 2) + 1] = pack2<T>(pe[2], pe[3]);
            dsa[j / 2][2 * (j % 2)] = pack2<T>(ds[0], ds[1]);
            dsa[j / 2][2 * (j % 2) + 1] = pack2<T>(ds[2], ds[3]);
          }
        };
        if (masked) {
          form_p_ds(std::true_type{});
        } else {
          form_p_ds(std::false_type{});
        }

        hold(pa);
        hold(dsa);
        wgmma_fence();
        mma_frag_by_tile<T, D, DC, QT>(dv, pa, dos, box);  // dV += P^T.dO, dO MN-major
        mma_frag_by_tile<T, D, DC, QT>(dk, dsa, qs, box);  // dK += dS^T.Q, Q MN-major
        wgmma_commit();
        wgmma_wait_all();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }

    const size_t kvoff = static_cast<size_t>(kv_row) * p.s * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = key + 8 * h;
      if (kj >= p.s) continue;
      const size_t at = kvoff + static_cast<size_t>(kj) * D + c0;
      auto* dkr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dk) + at);  // T pairs
      auto* dvr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dv) + at);
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        if (kOverlap && j < skip) continue;  // a neighbour's columns
        dkr[4 * j + tq] = pack2<T>(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
        dvr[4 * j + tq] = pack2<T>(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The four tensor-core kernels: T is bf16 or fp16; D the head dim; WG the consumer
// warpgroups, 64 rows (dQ) or keys (dK/dV) each.
#define TC_MAPS                                                                       \
  const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap, \
      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap

template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1) flash_bwd_dq_tri_kernel(Params p, TC_MAPS) {
  dq_tc_body<T, D, WG, true>(p, &qmap, &kmap, &vmap, &domap);
}

template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1) flash_bwd_dq_rect_kernel(Params p, TC_MAPS) {
  dq_tc_body<T, D, WG, false>(p, &qmap, &kmap, &vmap, &domap);
}

template <typename T, int D, int WG>
__global__ void __launch_bounds__((WG * kv_split<D>() + 1) * 128, 1)
    flash_bwd_dkv_tri_kernel(Params p, TC_MAPS) {
  if constexpr (col_split<D>() > 1) {
    dkv_slice_body<T, D, WG, true>(p, &qmap, &kmap, &vmap, &domap);
  } else {
    dkv_tc_body<T, D, WG, true>(p, &qmap, &kmap, &vmap, &domap);
  }
}

template <typename T, int D, int WG>
__global__ void __launch_bounds__((WG * kv_split<D>() + 1) * 128, 1)
    flash_bwd_dkv_rect_kernel(Params p, TC_MAPS) {
  if constexpr (col_split<D>() > 1) {
    dkv_slice_body<T, D, WG, false>(p, &qmap, &kmap, &vmap, &domap);
  } else {
    dkv_tc_body<T, D, WG, false>(p, &qmap, &kmap, &vmap, &domap);
  }
}

#ifdef FLASH_HEAD_DIM_WIDE
// ---------------------------------------------------------------------------
// Head dims above 576: the D-streaming pairs (see the note on top).
// ---------------------------------------------------------------------------

constexpr int kWideDqSlab = 256;     // columns of dQ a 16-bit CTA holds
constexpr int kWideDkvSlab = 128;    // columns of dK and of dV a 16-bit CTA holds
constexpr int kWideRing = 4;         // stages of the streamed ring, four boxes each
constexpr int kWideThreads = 128;    // one warpgroup a 16-bit CTA
// the exchange: partial S and dP (64 x 64 f32 each), the 16-bit P and dS over them
constexpr int kWideXchBytes = 2 * kTile * kTile * 4;
// float4s of the exchange a thread sums at the fewest CTAs a tile (3: 22 rows)
constexpr int kWideXchItems = 3;
static_assert(kWideXchItems * kWideThreads >= (kTile + 2) / 3 * (kTile / 4),
              "a rank's rows of the exchange in kWideXchItems passes");
// the f32 pair's tiles, slabs and clusters: flash_cluster.cuh

template <bool DQ>
constexpr int wide16_smem_bytes() {
  // alignment slack, the resident own boxes (dQ: Q and dO, dK/dV: K and V,
  // one slab each), the ring, the exchange, the tile's 64 (lse * log2(e),
  // delta) and the 64 segment ids of each side, the ring's barriers and the
  // resident boxes' one
  return kSmemAlign + 2 * ((DQ ? kWideDqSlab : kWideDkvSlab) / kWideBox) * kWideBoxBytes +
         kWideRing * 4 * kWideBoxBytes + kWideXchBytes + kTile * (8 + 2 * 4) +
         8 * (kWideRing + 1);
}
static_assert(wide16_smem_bytes<true>() <= 232448, "past the shared memory a block may use");

// f32: the resident slabs (dQ: Q times qscale and dO; dK/dV: K and V), the
// streamed ring, the exchange tiles (partial S and dP, then P and dS), and
// for dQ its q tile's lse * log2(e) and delta; the same for both pairs
constexpr int kF32SlabFloats = kF32WideTile * kF32WideSlab;
constexpr int kF32StageFloats = 2 * kF32SlabFloats;  // two slabs, or four chunks
constexpr int kF32TileFloats = kF32WideTile * kF32WideTile;
template <bool DQ>
constexpr int f32_wide_smem_bytes() {
  return 4 * (2 * kF32SlabFloats + kF32WideStages * kF32StageFloats + 2 * kF32TileFloats +
              (DQ ? 2 * kF32WideTile : 0));
}
static_assert(f32_wide_smem_bytes<true>() <= 232448, "past the shared memory a block may use");

// Wait for stage `st` of a ring (its phase n / stages), as both roles do.
__device__ __forceinline__ uint32_t ring_parity(int n, int stages) { return (n / stages) & 1; }

// The float offset of X[a][4 f .. 4 f + 3] in an f32 tile of the 16-bit
// exchange: two halves of 32 columns, row a of a half at 32 a floats, its
// eight float4s swizzled by a & 7 as a 128-byte TMA box swizzles a 16-bit
// row. A 16-bit [64][64] tile over the first half (tile16_at) then puts row
// a over X's row a alone, which only the rank that owns row a reads.
__device__ __forceinline__ int xs_at(int a, int f) {
  return (f >> 3) * (kTile * 32) + a * 32 + (((f & 7) ^ (a & 7)) << 2);
}

// A warpgroup's m64n64 accumulator (rows 16 w + lane / 4 and 8 more,
// columns 8 j + 2 (lane % 4) and the next) into an exchange tile (xs_at).
__device__ __forceinline__ void store_partial(float* xs, const float (&acc)[32], int warp,
                                              int lane) {
  const int r = warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // columns 8 j + 2 tq (+1): float4 2 j + tq / 2, its floats 2 (tq % 2) (+1)
      *reinterpret_cast<float2*>(xs + xs_at(r + 8 * h, 2 * j + tq / 2) + 2 * (tq % 2)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The cluster's exchange of one tile pair in the 16-bit pair above 576.
// Every CTA holds its partial S and dP (dK/dV: S^T and dP^T) over its own
// columns in the two f32 tiles at xs (xs_at). CTA `rank` of c sums rows [64
// rank / c, 64 (rank + 1) / c) of every CTA's partials in rank order (the
// same bits every run), `form`s P and dS of each float4 there (the rows' or
// columns' lse and delta, the masks), rounded to T, and stores them into
// every CTA's 16-bit tiles: P over the first f32 tile, dS over the second
// (DQ: dS over the first, no P). Two cluster barriers (the partials written;
// the tiles written, so the partials read) and one of the CTA between a
// rank's reads and its stores, whose rows lie over the f32 rows it reads.
template <typename T, bool DQ, typename Form>
__device__ __forceinline__ void exchange16(unsigned char* xs_bytes, int c, Form form) {
  float* xs = reinterpret_cast<float*>(xs_bytes);
  cluster_sync();
  const int rank = static_cast<int>(cluster_rank());
  const int a0 = kTile * rank / c, a1 = kTile * (rank + 1) / c;
  const int owned = (a1 - a0) * (kTile / 4);
  uint2 pv[kWideXchItems], dv[kWideXchItems];
#pragma unroll
  for (int k = 0; k < kWideXchItems; ++k) {
    const int i = static_cast<int>(threadIdx.x) + kWideThreads * k;
    pv[k] = dv[k] = make_uint2(0u, 0u);
    if (i >= owned) continue;
    const int a = a0 + i / (kTile / 4), f = i % (kTile / 4);
    const int at = xs_at(a, f);
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f), d4 = s4;
#pragma unroll
    for (int r = 0; r < kF32WideCluster; ++r) {
      if (r < c) s4 = add4(s4, ld_cluster4(cluster_addr(xs + at, r)));
    }
#pragma unroll
    for (int r = 0; r < kF32WideCluster; ++r) {
      if (r < c) d4 = add4(d4, ld_cluster4(cluster_addr(xs + kTile * kTile + at, r)));
    }
    form(a, f, s4, d4, pv[k], dv[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWideXchItems; ++k) {
    const int i = static_cast<int>(threadIdx.x) + kWideThreads * k;
    if (i >= owned) continue;
    const int at = tile16_at(a0 + i / (kTile / 4), i % (kTile / 4));
    for (int r = 0; r < c; ++r) {
      const uint32_t x = cluster_addr(xs_bytes + at, r);
      if (DQ) {
        st_cluster2(x, dv[k]);
      } else {
        st_cluster2(x, pv[k]);
        st_cluster2(x + kTile * kTile * 4, dv[k]);
      }
    }
  }
  fence_proxy_async();
  cluster_sync();
}

// The walk of a tile pair's items in a 16-bit CTA above 576: nf foreign
// chunks (SlabCols), then the halves of its slab (two boxes each: dQ's
// 256 columns two halves, dK/dV's 128 one) from the half of its first own
// box b_own on. Stage layouts: a foreign chunk's four boxes are the own
// side's two (dQ: Q, dO; dK/dV: K, V), then the streamed side's (dQ: K, V;
// dK/dV: Q, dO); half h of the slab is the streamed side's boxes 2 h and 2 h
// + 1 of its first tensor, then of its second (only the own boxes load).
// The resident boxes are the own side's slab, its first tensor's NB boxes
// then its second's.
template <int W>
struct WideItems {
  static constexpr int NB = W / kWideBox;  // boxes of a slab
  int nf, b_own, h0, ni;
  __device__ explicit WideItems(const SlabCols<W>& cols)
      : nf(cols.nf),
        b_own((cols.own0 - cols.g0) / kWideBox),
        h0(b_own / 2),
        ni(cols.nf + (cols.owns() ? NB / 2 - b_own / 2 : 0)) {}
  // the half of the slab that item `it` holds (it >= nf), and its first box
  __device__ int half(int it) const { return h0 + it - nf; }
  __device__ int first_box(int it) const { return max(2 * half(it), b_own); }
};

// TMA of item `it` into `stage` on barrier `bar`: the own side's rows o0 of
// row orow (maps oa, ob) and the streamed side's rows s0 of row srow (sa,
// sb), columns from the CTA's slab or foreign chunk.
template <int W>
__device__ __forceinline__ void load_item(unsigned char* stage, uint64_t* bar, int it,
                                          const WideItems<W>& items, const SlabCols<W>& cols,
                                          int c, const CUtensorMap* oa, const CUtensorMap* ob,
                                          int o0, int orow, const CUtensorMap* sa,
                                          const CUtensorMap* sb, int s0, int srow) {
  if (it < items.nf) {
    const int c0 = cols.foreign(it, c);
    mbar_expect_tx(bar, 4 * kWideBoxBytes);
    tma_load_3d(stage, oa, bar, c0, o0, orow);
    tma_load_3d(stage + kWideBoxBytes, ob, bar, c0, o0, orow);
    tma_load_3d(stage + 2 * kWideBoxBytes, sa, bar, c0, s0, srow);
    tma_load_3d(stage + 3 * kWideBoxBytes, sb, bar, c0, s0, srow);
    return;
  }
  const int h = items.half(it), lo = items.first_box(it);
  mbar_expect_tx(bar, 2 * (2 * h + 2 - lo) * kWideBoxBytes);
  for (int b = lo; b < 2 * h + 2; ++b) {
    const int col = cols.g0 + b * kWideBox;
    tma_load_3d(stage + (b - 2 * h) * kWideBoxBytes, sa, bar, col, s0, srow);
    tma_load_3d(stage + (b - 2 * h + 2) * kWideBoxBytes, sb, bar, col, s0, srow);
  }
}

// The partial score products of item `it` in `stage`: s (+)= first tensor's
// boxes . the streamed first tensor's^T, dp (+)= the second's (a foreign
// chunk's boxes 0 . 2^T and 1 . 3^T; a half's own boxes against the resident
// ones); `first` starts both from zero.
template <typename T, int W>
__device__ __forceinline__ void item_products(float (&s)[32], float (&dp)[32],
                                              const unsigned char* res,
                                              const unsigned char* stage, int it,
                                              const WideItems<W>& items, bool first) {
  constexpr int NB = W / kWideBox;
  const bool foreign = it < items.nf;
  const int h = items.half(it);
  const int lo = foreign ? 0 : items.first_box(it) - 2 * h;
  for (int b = lo; b < (foreign ? 1 : 2); ++b) {
    const unsigned char* as = foreign ? stage : res + (2 * h + b) * kWideBoxBytes;
    const unsigned char* bs = foreign ? stage + 2 * kWideBoxBytes : stage + b * kWideBoxBytes;
    const unsigned char* ap =
        foreign ? stage + kWideBoxBytes : res + (NB + 2 * h + b) * kWideBoxBytes;
    const unsigned char* bp =
        foreign ? stage + 3 * kWideBoxBytes : stage + (b + 2) * kWideBoxBytes;
    mma_box_by_box<T>(s, as, bs, first && b == lo);
    mma_box_by_box<T>(dp, ap, bp, first && b == lo);
  }
}

// dQ at a head dim above 576 on the tensor cores, in clusters (see the note
// on top). blockIdx.x: q tile x (g c) + z; y and z: bh rows, walked
// tile-major (cluster_slot; a plain causal mask's last q tile first). The
// CTA keeps its own columns of Q and dO resident and streams the key tiles'
// own columns of K and V; per key tile the cluster forms dS once (exchange16)
// and each CTA runs dQ += dS . K on its slab's two halves (m64n128k16 each).
// TRI: the triangle; else the general masks, a key tile whose documents
// cannot meet the q tile's skipped by every CTA of the cluster (the walk
// depends on the row, the tiles and the ids alone).
template <typename T, bool TRI>
__device__ __forceinline__ void dq_wide_body(const Params& p, int d, const CUtensorMap* qmap,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap,
                                             const CUtensorMap* domap) {
  static_assert(kElem16<T>, "the tensor-core backward is bf16 or fp16");
  constexpr int W = kWideDqSlab, NB = W / kWideBox, R = kWideRing;
  constexpr uint32_t kStageBytes = 4 * kWideBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* res = base;                            // Q's own boxes of the slab, then dO's
  unsigned char* ring = res + 2 * NB * kWideBoxBytes;   // stage st: an item's four boxes
  unsigned char* xs = ring + R * kStageBytes;           // the exchange
  float2* stats = reinterpret_cast<float2*>(xs + kWideXchBytes);  // rows' (lse log2 e, delta)
  int* ids_q = reinterpret_cast<int*>(stats + kTile);             // the rows' segment ids
  int* ids_k = ids_q + kTile;                                     // the key tile's
  uint64_t* full = reinterpret_cast<uint64_t*>(ids_k + kTile);
  uint64_t* res_full = full + R;

  const SlabGeo<W> geo(d);
  const int tiles = (p.s + kTile - 1) / kTile;
  const int2 slot =
      cluster_slot(p.rows, tiles, geo.ctas(), TRI || (p.causal && p.window <= 0));
  if (slot.x < 0) return;  // the whole cluster
  const int bh = slot.x, q0 = slot.y * kTile;
  const SlabCols<W> cols(geo, blockIdx.x % geo.ctas(), d);
  const WideItems<W> items(cols);
  const bool causal = TRI || p.causal;
  const int window = TRI ? 0 : p.window;  // > 0: the band (the entry drops one >= s)
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.s : nullptr;
  const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the key tiles some row of the q tile can see: all of them, or up to the
  // diagonal, from the window's first key on; every warp finds the next live
  // one itself
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / kTile : 0;
  const int t_hi = causal ? (min(p.s, q0 + kTile) + kTile - 1) / kTile : tiles;
  const int2 qrange = segments ? id_range(seg, q0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    while (segments && t < t_hi &&
           apart(qrange, id_range(seg, t * kTile, p.s, lane, 32, ~0u, nullptr))) {
      ++t;
    }
    return t;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R; ++st) mbar_init(&full[st], 1);
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    float l2 = CUDART_INF_F, dl = 0.f;  // +inf keeps P = 0
    int id = 0;
    if (qi < p.s) {
      const size_t at = static_cast<size_t>(bh) * p.s + qi;
      const float lse = p.lse[at];
      l2 = lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e;
      dl = p.delta[at];
      if (segments) id = seg[qi];
    }
    stats[threadIdx.x] = make_float2(l2, dl);
    ids_q[threadIdx.x] = id;
  }
  __syncthreads();

  // thread 0 loads the resident boxes, then the items of the walk in order,
  // each once its stage's last reader is done (issue's bound); every warp
  // walks the loads with it (a walk in warp 0 alone, its id reductions on a
  // path of one warp, made ptxas serialize the general pair's wgmma)
  int t = live_from(t_lo);
  int pt = t, pit = 0, pidx = 0;
  auto issue = [&](int limit) {
    while (pidx < limit && pt < t_hi) {
      if (threadIdx.x == 0) {
        load_item<W>(ring + (pidx % R) * kStageBytes, &full[pidx % R], pit, items, cols, geo.c,
                     qmap, domap, q0, bh, kmap, vmap, pt * kTile, kv_row);
      }
      ++pidx;
      if (++pit == items.ni) {
        pit = 0;
        pt = live_from(pt + 1);
      }
    }
  };
  if (threadIdx.x == 0 && cols.owns()) {
    mbar_expect_tx(res_full, 2 * (NB - items.b_own) * kWideBoxBytes);
    for (int b = items.b_own; b < NB; ++b) {
      const int col = cols.g0 + b * kWideBox;
      tma_load_3d(res + b * kWideBoxBytes, qmap, res_full, col, q0, bh);
      tma_load_3d(res + (NB + b) * kWideBoxBytes, domap, res_full, col, q0, bh);
    }
  }
  if (items.ni > 0) issue(R);
  if (cols.owns()) mbar_wait(res_full, 0);

  const float qscale = p.qscale, scale = p.scale;
  const int win = window > 0 ? window : INT_MAX;
  float dq0[W / 4], dq1[W / 4], s[32], dp[32];  // dQ's two 128-column halves
#pragma unroll
  for (int i = 0; i < W / 4; ++i) dq0[i] = dq1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  int idx = 0;  // items consumed so far
  while (t < t_hi) {
    const int k0 = t * kTile;
    if (segments && threadIdx.x < kTile) {
      ids_k[threadIdx.x] = k0 + threadIdx.x < p.s ? seg[k0 + threadIdx.x] : 0;
    }
    // the tile rule: whether some pair needs the element mask (a key after a
    // row, outside the window or past s, or in another document)
    bool masked;
    if constexpr (TRI) {
      masked = k0 == q0;  // the diagonal tile
    } else {
      masked = (causal && k0 + kTile - 1 > q0) || (window > 0 && q0 + kTile - 1 - k0 >= window) ||
               k0 + kTile > p.s;
      if (segments) {
        masked = masked || !one_doc(qrange, id_range(seg, k0, p.s, lane, 32, ~0u, nullptr));
      }
    }
    // the partial S and dP over the CTA's columns, item by item
    const unsigned char* halves[2] = {ring, ring};  // the stages of the slab's halves
    const int first_main = idx + items.nf;
    for (int it = 0; it < items.ni; ++it, ++idx) {
      const int st = idx % R;
      const unsigned char* stage = ring + st * kStageBytes;
      mbar_wait(&full[st], ring_parity(idx, R));
      hold(s);
      hold(dp);
      wgmma_fence();
      item_products<T, W>(s, dp, res, stage, it, items, it == 0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      hold(dq0);
      hold(dq1);
      if (it >= items.nf) halves[items.half(it)] = stage;
      // every warp's products are done: this item's stage is free unless it
      // holds a half of the slab, which dQ += dS . K reads after the exchange
      __syncthreads();
      issue(min(idx + 1, first_main) + R);
    }
    store_partial(reinterpret_cast<float*>(xs), s, warp, lane);
    store_partial(reinterpret_cast<float*>(xs) + kTile * kTile, dp, warp, lane);
    // dS = P * (dP - delta) * scale, the masks as the tile rule says
    auto form = [&](int a, int f, float4 s4, float4 d4, uint2&, uint2& ds) {
      const int qi = q0 + a;
      const float2 rs = stats[a];
      const int qid = ids_q[a];
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 4 * f + e;
        float sv = comp(s4, e);
        if (!TRI && masked) {
          bool live = kj < p.s && (!causal || (kj <= qi && qi - kj < win));
          if (segments) live = live && ids_k[4 * f + e] == qid;
          if (!live) sv = -CUDART_INF_F;
        }
        float pe = exp2f(fmaf(sv, qscale, -rs.x));
        if (TRI && masked && kj > qi) pe = 0.f;
        de[e] = pe * (comp(d4, e) - rs.y) * scale;
      }
      ds = make_uint2(pack2<T>(de[0], de[1]), pack2<T>(de[2], de[3]));
    };
    exchange16<T, true>(xs, geo.c, form);
    hold(dq0);
    hold(dq1);
    wgmma_fence();
    mma_tile_by_slab<T, W / 2>(dq0, xs, halves[0]);  // dQ += dS . K, K's boxes MN-major
    mma_tile_by_slab<T, W / 2>(dq1, xs, halves[1]);
    wgmma_commit();
    t = live_from(t + 1);
  }
  wgmma_wait<0>();
  hold(dq0);
  hold(dq1);

  if (!cols.owns()) return;
  T* dqg = static_cast<T*>(p.dq) + static_cast<size_t>(bh) * p.s * d;
  const int r0 = q0 + warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.s) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row) * d + cols.g0);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = cols.g0 + 8 * j;
      if (col < cols.own0 || col >= cols.own1) continue;  // another slab's columns
      const float* acc = j < W / 16 ? dq0 : dq1;
      const int jj = j % (W / 16);
      out[4 * j + tq] = pack2<T>(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
}

// dK/dV at a head dim above 576 on the tensor cores, in clusters (see the
// note on top). blockIdx.x: key tile x (g c) + z; y and z: kv rows, walked
// tile-major (cluster_slot: every row's key tile 0 first). The CTA keeps its
// own columns of K and V resident and walks, for every GQA group member, the
// q tiles some row of which sees one of its keys, streaming their own
// columns of Q and dO; per q tile the cluster forms P^T and dS^T once
// (exchange16) and each CTA runs dV += P^T . dO and dK += dS^T . Q on its
// slab (m64n128k16). TRI: the triangle; else the general masks, as dQ's.
template <typename T, bool TRI>
__device__ __forceinline__ void dkv_wide_body(const Params& p, int d, const CUtensorMap* qmap,
                                              const CUtensorMap* kmap, const CUtensorMap* vmap,
                                              const CUtensorMap* domap) {
  static_assert(kElem16<T>, "the tensor-core backward is bf16 or fp16");
  constexpr int W = kWideDkvSlab, NB = W / kWideBox, R = kWideRing;
  constexpr uint32_t kStageBytes = 4 * kWideBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  unsigned char* res = base;                            // K's own boxes of the slab, then V's
  unsigned char* ring = res + 2 * NB * kWideBoxBytes;   // stage st: an item's four boxes
  unsigned char* xs = ring + R * kStageBytes;           // the exchange
  float2* stats = reinterpret_cast<float2*>(xs + kWideXchBytes);  // q rows' (lse log2 e, delta)
  int* ids_q = reinterpret_cast<int*>(stats + kTile);             // the q tile's segment ids
  int* ids_k = ids_q + kTile;                                     // the keys'
  uint64_t* full = reinterpret_cast<uint64_t*>(ids_k + kTile);
  uint64_t* res_full = full + R;

  const SlabGeo<W> geo(d);
  const int tiles = (p.s + kTile - 1) / kTile;
  const int2 slot = cluster_slot(p.rows, tiles, geo.ctas(), false);
  if (slot.x < 0) return;  // the whole cluster
  const int kv_row = slot.x, k0 = slot.y * kTile;
  const SlabCols<W> cols(geo, blockIdx.x % geo.ctas(), d);
  const WideItems<W> items(cols);
  const bool causal = TRI || p.causal;
  const int window = TRI ? 0 : p.window;
  const bool segments = !TRI && p.seg != nullptr;
  const int group = p.heads / p.kv_heads;
  const int b = kv_row / p.kv_heads;
  const int* seg = segments ? p.seg + static_cast<size_t>(b) * p.s : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto q_row = [&](int m) { return b * p.heads + (kv_row % p.kv_heads) * group + m; };

  // the q tiles that can see any key of this tile: from the diagonal down
  // (causal), to the last row inside the window of the last key; walked for
  // every member, a tile whose documents cannot meet the key tile's skipped
  const int t_lo = causal ? k0 / kTile : 0;
  const int t_hi =
      window > 0 ? (min(p.s, min(k0 + kTile, p.s) - 1 + window) + kTile - 1) / kTile : tiles;
  const int2 krange = segments ? id_range(seg, k0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  // (m, t) to the first live (member, q tile) at or after it
  auto advance = [&](int& m, int& t) {
    while (m < group) {
      if (t >= t_hi) {
        ++m;
        t = t_lo;
      } else if (segments &&
                 apart(krange, id_range(seg, t * kTile, p.s, lane, 32, ~0u, nullptr))) {
        ++t;
      } else {
        return;
      }
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R; ++st) mbar_init(&full[st], 1);
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < kTile) {
    const int kj = k0 + threadIdx.x;
    ids_k[threadIdx.x] = segments && kj < p.s ? seg[kj] : 0;
  }
  __syncthreads();

  int m = 0, t = t_lo;
  advance(m, t);
  int pm = m, pt = t, pit = 0, pidx = 0;  // the next item to load (thread 0's)
  auto issue = [&](int limit) {
    while (pidx < limit && pm < group) {
      if (threadIdx.x == 0) {
        load_item<W>(ring + (pidx % R) * kStageBytes, &full[pidx % R], pit, items, cols, geo.c,
                     kmap, vmap, k0, kv_row, qmap, domap, pt * kTile, q_row(pm));
      }
      ++pidx;
      if (++pit == items.ni) {
        pit = 0;
        ++pt;
        advance(pm, pt);
      }
    }
  };
  if (threadIdx.x == 0 && cols.owns()) {
    mbar_expect_tx(res_full, 2 * (NB - items.b_own) * kWideBoxBytes);
    for (int bb = items.b_own; bb < NB; ++bb) {
      const int col = cols.g0 + bb * kWideBox;
      tma_load_3d(res + bb * kWideBoxBytes, kmap, res_full, col, k0, kv_row);
      tma_load_3d(res + (NB + bb) * kWideBoxBytes, vmap, res_full, col, k0, kv_row);
    }
  }
  if (items.ni > 0) issue(R);
  if (cols.owns()) mbar_wait(res_full, 0);

  const float qscale = p.qscale, scale = p.scale;
  const int win = window > 0 ? window : INT_MAX;
  float dk[W / 2], dv[W / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  int idx = 0;  // items consumed so far
  while (m < group) {
    const int q0 = t * kTile;
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      float l2 = CUDART_INF_F, dl = 0.f;  // +inf past s and for a row that saw no key
      int id = 0;
      if (qi < p.s) {
        const size_t at = static_cast<size_t>(q_row(m)) * p.s + qi;
        const float lse = p.lse[at];
        l2 = lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e;
        dl = p.delta[at];
        if (segments) id = seg[qi];
      }
      stats[threadIdx.x] = make_float2(l2, dl);
      ids_q[threadIdx.x] = id;
    }
    // the tile rule, as in dQ: a row before a key or outside the window, or
    // in another document (rows past s have P = 0 from their lse, and keys
    // past s are never written)
    bool masked;
    if constexpr (TRI) {
      masked = q0 == k0;  // the diagonal tile
    } else {
      masked = (causal && q0 < k0 + kTile - 1) || (window > 0 && q0 + kTile - 1 - k0 >= window);
      if (segments) {
        masked = masked || !one_doc(krange, id_range(seg, q0, p.s, lane, 32, ~0u, nullptr));
      }
    }
    const unsigned char* slab = ring;  // the stage of the Q and dO slab
    const int first_main = idx + items.nf;
    for (int it = 0; it < items.ni; ++it, ++idx) {
      const int st = idx % R;
      const unsigned char* stage = ring + st * kStageBytes;
      mbar_wait(&full[st], ring_parity(idx, R));
      hold(s);
      hold(dp);
      wgmma_fence();
      item_products<T, W>(s, dp, res, stage, it, items, it == 0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      hold(dp);
      hold(dk);
      hold(dv);
      if (it >= items.nf) slab = stage;
      __syncthreads();  // every warp's products are done (see dQ)
      issue(min(idx + 1, first_main) + R);
    }
    store_partial(reinterpret_cast<float*>(xs), s, warp, lane);
    store_partial(reinterpret_cast<float*>(xs) + kTile * kTile, dp, warp, lane);
    // P^T and dS^T, the rows before a key dropped on the triangle's diagonal tile
    auto form = [&](int a, int f, float4 s4, float4 d4, uint2& pt4, uint2& ds) {
      const int kj = k0 + a;
      const int kid = ids_k[a];
      float pe[4], de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * f + e, qi = q0 + c;
        const float2 rs = stats[c];
        float sv = comp(s4, e);
        if (!TRI && masked) {
          bool live = !causal || (qi >= kj && qi - kj < win);
          if (segments) live = live && ids_q[c] == kid;
          if (!live) sv = -CUDART_INF_F;
        }
        float v = exp2f(fmaf(sv, qscale, -rs.x));
        if (TRI && masked && qi < kj) v = 0.f;
        pe[e] = v;
        de[e] = v * (comp(d4, e) - rs.y) * scale;
      }
      pt4 = make_uint2(pack2<T>(pe[0], pe[1]), pack2<T>(pe[2], pe[3]));
      ds = make_uint2(pack2<T>(de[0], de[1]), pack2<T>(de[2], de[3]));
    };
    exchange16<T, false>(xs, geo.c, form);
    hold(dk);
    hold(dv);
    wgmma_fence();
    mma_tile_by_slab<T, W>(dv, xs, slab + 2 * kWideBoxBytes);              // dV += P^T . dO
    mma_tile_by_slab<T, W>(dk, xs + kTile * kTile * 4, slab);              // dK += dS^T . Q
    wgmma_commit();
    ++t;
    advance(m, t);
  }
  wgmma_wait<0>();
  hold(dk);
  hold(dv);

  if (!cols.owns()) return;
  const size_t kvoff = static_cast<size_t>(kv_row) * p.s * d;
  const int key = k0 + warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = key + 8 * h;
    if (kj >= p.s) continue;
    const size_t at = kvoff + static_cast<size_t>(kj) * d + cols.g0;
    auto* dkr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dk) + at);  // T pairs
    auto* dvr = reinterpret_cast<uint32_t*>(static_cast<T*>(p.dv) + at);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = cols.g0 + 8 * j;
      if (col < cols.own0 || col >= cols.own1) continue;  // another slab's columns
      dkr[4 * j + tq] = pack2<T>(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      dvr[4 * j + tq] = pack2<T>(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// The four 16-bit D-streaming kernels: the triangle pair and the general pair,
// each launched in clusters of SlabGeo(d).c CTAs on the grid's x.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dq_tri_wide_kernel(Params p, int d, TC_MAPS) {
  dq_wide_body<T, true>(p, d, &qmap, &kmap, &vmap, &domap);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dq_rect_wide_kernel(Params p, int d, TC_MAPS) {
  dq_wide_body<T, false>(p, d, &qmap, &kmap, &vmap, &domap);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dkv_tri_wide_kernel(Params p, int d, TC_MAPS) {
  dkv_wide_body<T, true>(p, d, &qmap, &kmap, &vmap, &domap);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dkv_rect_wide_kernel(Params p, int d, TC_MAPS) {
  dkv_wide_body<T, false>(p, d, &qmap, &kmap, &vmap, &domap);
}

#ifndef FLASH_ELEM_F16  // the f32 kernels live in the bf16 library (kWithF32)
// The partial S and dP of a thread's 4 x 4 block over the float4 columns
// [f0, f1): sc[a][b] += A(4 ta + a) . B(4 tb + b) and dp[a][b] += C(4 ta + a)
// . E(4 tb + b), each an f32 FMA chain in column order, rows of swizzled
// [64][WA] (A, C) and [64][WB] (B, E) tiles. SA / SB: A's / B's values times
// qscale first (q's share of the score, rounded as the forward rounds it).
// 16 float4 loads a thread for 128 FMAs; a warp's four values of ta and
// eight of tb read one wavefront each. B's and E's four rows stay in
// registers while A's and C's stream through one row at a time.
template <int WA, int WB, bool SA, bool SB>
__device__ __forceinline__ void partial_scores(float (&sc)[4][4], float (&dp)[4][4],
                                               const float* A, const float* C, const float* B,
                                               const float* E, int ta, int tb, int f0, int f1,
                                               float qscale) {
  const float* a_row = A + 4 * ta * WA;
  const float* c_row = C + 4 * ta * WA;
  const float* b_row = B + 4 * tb * WB;
  const float* e_row = E + 4 * tb * WB;
  const int xa = ta & 7, xb = tb & 7;  // the rows' swizzle
#pragma unroll 1
  for (int f = f0; f < f1; ++f) {
    float4 b[4], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ld4(b_row + j * WB + ((f ^ xb) << 2));
      e[j] = ld4(e_row + j * WB + ((f ^ xb) << 2));
      if (SB) b[j] = scale4(b[j], qscale);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 a = ld4(a_row + i * WA + ((f ^ xa) << 2));
      const float4 c = ld4(c_row + i * WA + ((f ^ xa) << 2));
      if (SA) a = scale4(a, qscale);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a.x, b[j].x, sc[i][j]);
        sc[i][j] = fmaf(a.y, b[j].y, sc[i][j]);
        sc[i][j] = fmaf(a.z, b[j].z, sc[i][j]);
        sc[i][j] = fmaf(a.w, b[j].w, sc[i][j]);
        dp[i][j] = fmaf(c.x, e[j].x, dp[i][j]);
        dp[i][j] = fmaf(c.y, e[j].y, dp[i][j]);
        dp[i][j] = fmaf(c.z, e[j].z, dp[i][j]);
        dp[i][j] = fmaf(c.w, e[j].w, dp[i][j]);
      }
    }
  }
}

// The cluster's exchange of one tile pair: every CTA holds partial S and dP
// over its columns (sc, dp: rows 4 ta + a, columns 4 tb + b of its thread's
// block) and ends with the tile's dS (DQ: as dS^T[key][q row] in xs) or P
// and dS (dK/dV: [q row][key] in xs and xs + 4096), summed over all of d, in
// its own shared memory. The partials go to xs as X[4 tb + b][4 ta + a]
// (X[key][q row] for dQ, X[q row][key] for dK/dV); CTA `rank` of c sums rows
// [64 rank / c, 64 (rank + 1) / c) of every CTA's X in rank order (the same
// bits every run), a float4 of a row a thread and two passes where the rows
// pass 16 (c = 2, at d 256), forms P and dS there (`rows`: a row's lse *
// log2(e) and delta), and stores them into every CTA's xs. Three cluster
// barriers: the partials written; read (xs is reused); results in.
template <bool TRI, bool DQ, typename Rows>
__device__ __forceinline__ void exchange(const Params& p, float* xs, const float (&sc)[4][4],
                                         const float (&dp)[4][4], int ta, int tb, int c,
                                         int q0, int k0, const int* seg, Rows rows) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    st4(xs + (4 * tb + b) * kF32WideTile + 4 * ta,
        make_float4(sc[0][b], sc[1][b], sc[2][b], sc[3][b]));
    st4(xs + kF32TileFloats + (4 * tb + b) * kF32WideTile + 4 * ta,
        make_float4(dp[0][b], dp[1][b], dp[2][b], dp[3][b]));
  }
  cluster_sync();
  const int rank = static_cast<int>(cluster_rank());
  const int a0 = kF32WideTile * rank / c, a1 = kF32WideTile * (rank + 1) / c;
  constexpr int kRowF4 = kF32WideTile / 4;           // float4s of a row
  const int owned = (a1 - a0) * kRowF4;              // the rank's float4s: at most 2 a thread
  const bool segments = !TRI && seg != nullptr;
  float4 pv[2], dsv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = static_cast<int>(threadIdx.x) + kThreads * j;
    pv[j] = dsv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= owned) continue;
    const int at = (a0 + i / kRowF4) * kF32WideTile + 4 * (i % kRowF4);  // its offset in X
    float4 s4 = pv[j], d4 = pv[j];
    for (int r = 0; r < c; ++r) {
      const uint32_t x = cluster_addr(xs + at, r);
      const float4 u = ld_cluster4(x), w = ld_cluster4(x + 4 * kF32TileFloats);
      s4 = make_float4(s4.x + u.x, s4.y + u.y, s4.z + u.z, s4.w + u.w);
      d4 = make_float4(d4.x + w.x, d4.y + w.y, d4.z + w.z, d4.w + w.w);
    }
    const int a = at / kF32WideTile, b0 = at % kF32WideTile;
    float pe[4], de[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + (DQ ? b0 + e : a), kj = k0 + (DQ ? a : b0 + e);
      const float2 ld = rows(DQ ? b0 + e : a);  // (lse * log2(e), delta) of row qi
      const bool live =
          qi < p.s && kj < p.s && ld.x != -CUDART_INF_F &&
          attends<TRI>(p, qi, kj, segments, segments ? seg[qi] : 0, segments ? seg[kj] : 0);
      pe[e] = live ? exp2f(comp(s4, e) - ld.x) : 0.f;
      de[e] = pe[e] * (comp(d4, e) - ld.y) * p.scale;
    }
    pv[j] = make_float4(pe[0], pe[1], pe[2], pe[3]);
    dsv[j] = make_float4(de[0], de[1], de[2], de[3]);
  }
  cluster_sync();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = static_cast<int>(threadIdx.x) + kThreads * j;
    if (i >= owned) continue;
    const int at = (a0 + i / kRowF4) * kF32WideTile + 4 * (i % kRowF4);
    for (int r = 0; r < c; ++r) {
      const uint32_t x = cluster_addr(xs + at, r);
      if (DQ) {
        st_cluster4(x, dsv[j]);
      } else {
        st_cluster4(x, pv[j]);
        st_cluster4(x + 4 * kF32TileFloats, dsv[j]);
      }
    }
  }
  cluster_sync();
}

// acc[a][4 h + e] += sum over the 64 rows r of X[r][4 ta + a] * Y(r)[4 (tb +
// 16 h) + e] (Y a swizzled [64][W] slab, h < W / 64): a thread's 4 x (W /
// 16) block of a gradient slab. At W 128 3 float4 loads for 32 FMAs, at 64 2
// for 16.
template <int W = kF32WideSlab>
__device__ __forceinline__ void slab_product(float (&acc)[4][W / 16], const float* X,
                                             const float* Y, int ta, int tb) {
  constexpr int H = W / 64;
#pragma unroll 4
  for (int r = 0; r < kF32WideTile; ++r) {
    const float4 x = ld4(X + r * kF32WideTile + 4 * ta);
    float4 y[H];
#pragma unroll
    for (int h = 0; h < H; ++h) y[h] = ld4(Y + swz<W>(r, tb + 16 * h));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float xa = comp(x, a);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        acc[a][4 * h] = fmaf(xa, y[h].x, acc[a][4 * h]);
        acc[a][4 * h + 1] = fmaf(xa, y[h].y, acc[a][4 * h + 1]);
        acc[a][4 * h + 2] = fmaf(xa, y[h].z, acc[a][4 * h + 2]);
        acc[a][4 * h + 3] = fmaf(xa, y[h].w, acc[a][4 * h + 3]);
      }
    }
  }
}

// The f32 D-streaming dQ on the CUDA cores, in clusters (see the note on
// top). blockIdx.x: q tile x (g c) + z; y and z: bh rows (kMaxGridY a z
// slice), walked tile-major (cluster_slot; a plain causal mask's last q
// tile first). A thread holds S and dP at q rows 4 ta + a and keys 4 tb + b, and
// dQ at rows 4 ta + a, slab columns 4 (tb + 16 h) + e. TRI: the triangle;
// else the general masks, the key tiles of the band, a key tile whose
// documents cannot meet the q tile's skipped (by every CTA of the cluster:
// the walk depends on the row, the tiles and the ids alone).
template <bool TRI>
__device__ __forceinline__ void dq_wide_f32_body(const Params& p, int d) {
  extern __shared__ float4 f32w_smem[];
  float* qres = reinterpret_cast<float*>(f32w_smem);  // the Q slab times qscale
  float* dores = qres + kF32SlabFloats;
  float* ring = dores + kF32SlabFloats;  // per stage: K and V slabs, or Q, dO, K, V chunks
  float* xs = ring + kF32WideStages * kF32StageFloats;
  float* lse2s = xs + 2 * kF32TileFloats;
  float* dlts = lse2s + kF32WideTile;

  const F32WideGeo geo(d);
  const int2 slot = cluster_slot(p.rows, (p.s + kF32WideTile - 1) / kF32WideTile, geo.ctas(),
                                 TRI || (p.causal && p.window <= 0));
  if (slot.x < 0) return;  // the whole cluster: it shares x / (g c), y and z
  const int bh = slot.x;
  const F32WideCols cols(geo, blockIdx.x % geo.ctas(), d);
  const int q0 = slot.y * kF32WideTile;
  const int2 th = f32_wide_thread();
  const int ta = th.x, tb = th.y;
  const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.s * d;
  const float* dog = static_cast<const float*>(p.dout) + static_cast<size_t>(bh) * p.s * d;
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.s * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.s * d;
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.s : nullptr;
  const int lane = threadIdx.x & 31;

  // the key tiles any row of this q tile can see: up to the diagonal
  // (causal), from the window's first key on; every warp finds the next
  // live one itself (the ids' range by warp reductions)
  int t_lo = 0, t_hi = (p.s + kF32WideTile - 1) / kF32WideTile;
  if (TRI || p.causal) t_hi = (min(q0 + kF32WideTile, p.s) + kF32WideTile - 1) / kF32WideTile;
  if (!TRI && p.causal && p.window > 0) t_lo = max(0, q0 - p.window + 1) / kF32WideTile;
  const int2 qrange = segments ? id_range(seg, q0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    while (segments && t < t_hi &&
           apart(qrange, id_range(seg, t * kF32WideTile, p.s, lane, 32, ~0u, nullptr))) {
      ++t;
    }
    return t;
  };
  const int items = cols.items();
  auto fetch = [&](int t, int it, int st) {
    float* dst = ring + st * kF32StageFloats;
    const int k0 = t * kF32WideTile;
    if (it < cols.nf) {
      const int c0 = cols.foreign(it, geo.c);
      load_tile<kF32WideChunk>(dst, qg, q0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + kF32TileFloats, dog, q0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + 2 * kF32TileFloats, kg, k0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + 3 * kF32TileFloats, vg, k0, p.s, d, c0);
    } else {
      load_tile<kF32WideSlab>(dst, kg, k0, p.s, d, cols.g0);
      load_tile<kF32WideSlab>(dst + kF32SlabFloats, vg, k0, p.s, d, cols.g0);
    }
  };

  int t = live_from(t_lo);
  if (cols.owns()) {
    load_tile<kF32WideSlab>(qres, qg, q0, p.s, d, cols.g0);
    load_tile<kF32WideSlab>(dores, dog, q0, p.s, d, cols.g0);
  }
  cp_async_commit();
  if (t < t_hi && items > 0) fetch(t, 0, 0);
  cp_async_commit();
  if (threadIdx.x < kF32WideTile) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < p.s;
    lse2s[threadIdx.x] = in ? p.lse[static_cast<size_t>(bh) * p.s + qi] * kLog2e : -CUDART_INF_F;
    dlts[threadIdx.x] = in ? p.delta[static_cast<size_t>(bh) * p.s + qi] : 0.f;
  }
  cp_async_wait<1>();  // the resident slabs
  __syncthreads();
  for (int e = threadIdx.x; e < kF32SlabFloats; e += kThreads) qres[e] *= p.qscale;
  auto rows = [&](int r) { return make_float2(lse2s[r], dlts[r]); };

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
  int st = 0;  // the stage of the next item
  while (t < t_hi) {
    const int next = live_from(t + 1);
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = dp[a][b] = 0.f;
    const float* slabs = nullptr;  // the main item's stage
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
      const float* sp = ring + st * kF32StageFloats;
      if (it < cols.nf) {
        partial_scores<kF32WideChunk, kF32WideChunk, true, false>(
            sc, dp, sp, sp + kF32TileFloats, sp + 2 * kF32TileFloats, sp + 3 * kF32TileFloats, ta,
            tb, 0, kF32WideChunk / 4, p.qscale);
        __syncthreads();  // the stage is free for the item after the next
      } else {
        partial_scores<kF32WideSlab, kF32WideSlab, false, false>(
            sc, dp, qres, dores, sp, sp + kF32SlabFloats, ta, tb, (cols.own0 - cols.g0) / 4,
            (cols.own1 - cols.g0) / 4, 1.f);
        slabs = sp;
      }
      st ^= 1;
    }
    exchange<TRI, true>(p, xs, sc, dp, ta, tb, geo.c, q0, t * kF32WideTile, seg, rows);
    if (slabs != nullptr) slab_product(acc, xs, slabs, ta, tb);  // dQ += dS . K_slab
    __syncthreads();  // the main stage and xs are free
    t = next;
  }
  cp_async_wait<0>();
  if (cols.owns()) {
    store_block(static_cast<float*>(p.dq) + static_cast<size_t>(bh) * p.s * d, acc, q0, p.s, d,
                cols, ta, tb);
  }
}

// The f32 D-streaming dK/dV on the CUDA cores, in clusters (see the note on
// top). blockIdx.x: key tile x (g c) + z; y and z: part x kv rows + kv row,
// sp parts of the GQA group, walked tile-major (cluster_slot: every row's
// key tile 0 first). A thread holds S^T and dP^T at keys 4 ta + a
// and q rows 4 tb + b, and dK and dV at keys 4 ta + a, slab columns 4 (tb +
// 16 h) + e; it walks the q tiles of its part's group / sp members in turn
// and writes its sums at row part x rows + kv row of p.dk and p.dv (sp 1:
// dK and dV; above: the partials flash_bwd_dkv_split_sum_kernel adds). TRI:
// the triangle; else the general masks, as dQ's.
template <bool TRI>
__device__ __forceinline__ void dkv_wide_f32_body(const Params& p, int d, int sp) {
  extern __shared__ float4 f32w_smem[];
  float* kres = reinterpret_cast<float*>(f32w_smem);  // the K and V slabs
  float* vres = kres + kF32SlabFloats;
  float* ring = vres + kF32SlabFloats;  // per stage: Q and dO slabs, or K, V, Q, dO chunks
  float* xs = ring + kF32WideStages * kF32StageFloats;

  const F32WideGeo geo(d);
  const int2 slot =
      cluster_slot(p.rows * sp, (p.s + kF32WideTile - 1) / kF32WideTile, geo.ctas(), false);
  if (slot.x < 0) return;  // the whole cluster
  const int row = slot.x;  // part x kv rows + kv row
  const int kv_row = row % p.rows;
  const F32WideCols cols(geo, blockIdx.x % geo.ctas(), d);
  const int k0 = slot.y * kF32WideTile;
  const int2 th = f32_wide_thread();
  const int ta = th.x, tb = th.y;
  const int b = kv_row / p.kv_heads;
  const int group = p.heads / p.kv_heads;
  const int m_end = (row / p.rows + 1) * (group / sp);  // past the part's last member
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.s * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.s * d;
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(b) * p.s : nullptr;
  const int lane = threadIdx.x & 31;
  auto q_row = [&](int m) { return b * p.heads + (kv_row % p.kv_heads) * group + m; };

  // the q tiles that can see any key of this tile: from the diagonal down
  // (causal), to the last row inside the window of the last key; walked
  // for every member, a tile whose documents cannot meet the key tile's
  // skipped
  int t_lo = 0, t_hi = (p.s + kF32WideTile - 1) / kF32WideTile;
  if (TRI || p.causal) t_lo = k0 / kF32WideTile;
  if (!TRI && p.causal && p.window > 0) {
    t_hi = (min(p.s, min(k0 + kF32WideTile, p.s) - 1 + p.window) + kF32WideTile - 1) /
           kF32WideTile;
  }
  const int2 krange = segments ? id_range(seg, k0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  // (m, t) to the first live (member, q tile) at or after it
  auto advance = [&](int& m, int& t) {
    while (m < m_end) {
      if (t >= t_hi) {
        ++m;
        t = t_lo;
      } else if (segments &&
                 apart(krange, id_range(seg, t * kF32WideTile, p.s, lane, 32, ~0u, nullptr))) {
        ++t;
      } else {
        return;
      }
    }
  };
  const int items = cols.items();
  auto fetch = [&](int m, int t, int it, int st) {
    float* dst = ring + st * kF32StageFloats;
    const int q0 = t * kF32WideTile;
    const size_t qoff = static_cast<size_t>(q_row(m)) * p.s * d;
    const float* qg = static_cast<const float*>(p.q) + qoff;
    const float* dog = static_cast<const float*>(p.dout) + qoff;
    if (it < cols.nf) {
      const int c0 = cols.foreign(it, geo.c);
      load_tile<kF32WideChunk>(dst, kg, k0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + kF32TileFloats, vg, k0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + 2 * kF32TileFloats, qg, q0, p.s, d, c0);
      load_tile<kF32WideChunk>(dst + 3 * kF32TileFloats, dog, q0, p.s, d, c0);
    } else {
      load_tile<kF32WideSlab>(dst, qg, q0, p.s, d, cols.g0);
      load_tile<kF32WideSlab>(dst + kF32SlabFloats, dog, q0, p.s, d, cols.g0);
    }
  };

  int m = m_end - group / sp, t = t_lo;
  advance(m, t);
  if (cols.owns()) {
    load_tile<kF32WideSlab>(kres, kg, k0, p.s, d, cols.g0);
    load_tile<kF32WideSlab>(vres, vg, k0, p.s, d, cols.g0);
  }
  if (m < m_end && items > 0) fetch(m, t, 0, 0);
  cp_async_commit();

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[a][j] = dv[a][j] = 0.f;
  int st = 0;
  while (m < m_end) {
    int nm = m, nt = t + 1;
    advance(nm, nt);
    const size_t lrow = static_cast<size_t>(q_row(m)) * p.s;
    const int q0 = t * kF32WideTile;
    auto rows = [&](int r) {
      const int qi = q0 + r;
      return qi < p.s ? make_float2(p.lse[lrow + qi] * kLog2e, p.delta[lrow + qi])
                      : make_float2(-CUDART_INF_F, 0.f);
    };
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
    const float* slabs = nullptr;
    for (int it = 0; it < items; ++it) {
      if (it + 1 < items) {
        fetch(m, t, it + 1, st ^ 1);
      } else if (nm < m_end) {
        fetch(nm, nt, 0, st ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* sp = ring + st * kF32StageFloats;
      if (it < cols.nf) {
        partial_scores<kF32WideChunk, kF32WideChunk, false, true>(
            sc, dp, sp, sp + kF32TileFloats, sp + 2 * kF32TileFloats, sp + 3 * kF32TileFloats, ta,
            tb, 0, kF32WideChunk / 4, p.qscale);
        __syncthreads();
      } else {
        partial_scores<kF32WideSlab, kF32WideSlab, false, true>(
            sc, dp, kres, vres, sp, sp + kF32SlabFloats, ta, tb, (cols.own0 - cols.g0) / 4,
            (cols.own1 - cols.g0) / 4, p.qscale);
        slabs = sp;
      }
      st ^= 1;
    }
    exchange<TRI, false>(p, xs, sc, dp, ta, tb, geo.c, q0, k0, seg, rows);
    if (slabs != nullptr) {
      slab_product(dv, xs, slabs + kF32SlabFloats, ta, tb);   // dV += P^T . dO_slab
      slab_product(dk, xs + kF32TileFloats, slabs, ta, tb);   // dK += dS^T . Q_slab
    }
    __syncthreads();
    m = nm;
    t = nt;
  }
  cp_async_wait<0>();
  if (cols.owns()) {
    store_block(static_cast<float*>(p.dk) + static_cast<size_t>(row) * p.s * d, dk, k0, p.s, d,
                cols, ta, tb);
    store_block(static_cast<float*>(p.dv) + static_cast<size_t>(row) * p.s * d, dv, k0, p.s, d,
                cols, ta, tb);
  }
}

// The four f32 cluster kernels: the triangle pair and the general pair, each
// launched in clusters of F32WideGeo(d).c CTAs on the grid's x; dK/dV's
// GQA walk in sp parts.
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_tri_wide_f32_kernel(Params p, int d) {
  dq_wide_f32_body<true>(p, d);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_rect_wide_f32_kernel(Params p, int d) {
  dq_wide_f32_body<false>(p, d);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tri_wide_f32_kernel(Params p, int d, int sp) {
  dkv_wide_f32_body<true>(p, d, sp);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_rect_wide_f32_kernel(Params p, int d, int sp) {
  dkv_wide_f32_body<false>(p, d, sp);
}

// f32 at head dims 32, 64 and 128: one CTA a tile (the cluster pair at c =
// 1, with no exchange), its head whole in one slab of W columns: W 64 at d
// 32 and 64 (d 32 zero-filled past d inside the slab, which changes neither
// q.k, nor dO.V, nor delta), W 128 at d 128. d 16 keeps the whole-row pair
// of the base library (dq_body / dkv_body), which this design did not beat
// there (see the note on top).
__host__ __device__ constexpr bool f32_tile_head_dim(int d) {
  return d == 32 || d == 64 || d == 128;
}
// CTAs an SM holds: dQ at W 64 two (its shared memory under half the SM's,
// registers at most 128 a thread), else one. dK/dV at W 64 held one score
// tile for P^T and then dS^T to fit two an SM: four barriers a tile pair,
// and 24% slower at (1,2048,8,64) than one CTA an SM with two tiles.
constexpr int f32_tile_ctas(int w, bool dq) { return dq && w < kF32WideSlab ? 2 : 1; }
// The resident tiles (dQ: Q times qscale and dO; dK/dV: K and V), the
// ring's two stages of two tiles (K and V; Q and dO), and the score tiles
// (dQ: dS^T; dK/dV: P^T and dS^T).
template <int W, bool DQ>
constexpr int f32_tile_smem_bytes() {
  return 4 * ((2 + 2 * kF32WideStages) * kF32WideTile * W + (DQ ? 1 : 2) * kF32TileFloats);
}
static_assert(2 * (f32_tile_smem_bytes<64, true>() + 1024) <= 233472, "two dQ CTAs an SM at W 64");
static_assert(f32_tile_smem_bytes<128, false>() <= 232448,
              "past the shared memory a block may use");

// X[4 tb + b][4 ta + a] = v[a][b] in a [64][64] score tile: a thread's 4 x 4
// block stored transposed (dQ: dS^T[key][q row]; dK/dV: P^T and dS^T as
// [q row][key]), as slab_product reads it.
__device__ __forceinline__ void store_scores(float* xs, const float (&v)[4][4], int ta, int tb) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    st4(xs + (4 * tb + b) * kF32WideTile + 4 * ta, make_float4(v[0][b], v[1][b], v[2][b], v[3][b]));
  }
}

// The f32 dQ at head dims up to 128 on the CUDA cores, a CTA a 64-row q tile
// (see the note on top). blockIdx.x: q tile; y and z: bh rows (kMaxGridY a
// z slice), walked tile-major (cluster_slot; a plain causal mask's last q
// tile first). A thread holds S and dP at q rows 4 ta + a and keys 4 tb + b,
// forms P and dS there from its rows' lse and delta (held in registers),
// and holds dQ at rows 4 ta + a, columns 4 (tb + 16 h) + e. Per key tile: one
// barrier before the scores (the tile's K and V landed, the last tile's dS^T
// and stage read: the next tile's K and V then load under this one) and one
// before dQ += dS . K. TRI: the triangle; else the general masks, the key
// tiles of the band, a key tile whose documents cannot meet the q tile's
// skipped.
template <bool TRI, int W>
__device__ __forceinline__ void dq_tile_f32_body(const Params& p, int d) {
  constexpr int kSlab = kF32WideTile * W;
  extern __shared__ float4 f32w_smem[];
  float* qres = reinterpret_cast<float*>(f32w_smem);  // the Q tile times qscale
  float* dores = qres + kSlab;
  float* ring = dores + kSlab;  // per stage: the K and V tiles
  float* xs = ring + kF32WideStages * 2 * kSlab;  // dS^T

  const int tiles = (p.s + kF32WideTile - 1) / kF32WideTile;
  const int2 slot = cluster_slot(p.rows, tiles, 1, TRI || (p.causal && p.window <= 0));
  if (slot.x < 0) return;
  const int bh = slot.x;
  const int q0 = slot.y * kF32WideTile;
  const int2 th = f32_wide_thread();
  const int ta = th.x, tb = th.y;
  const int kv_row = (bh / p.heads) * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.s * d;
  const float* dog = static_cast<const float*>(p.dout) + static_cast<size_t>(bh) * p.s * d;
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.s * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.s * d;
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(bh / p.heads) * p.s : nullptr;
  const int lane = threadIdx.x & 31;

  int t_lo = 0, t_hi = tiles;
  if (TRI || p.causal) t_hi = (min(q0 + kF32WideTile, p.s) + kF32WideTile - 1) / kF32WideTile;
  if (!TRI && p.causal && p.window > 0) t_lo = max(0, q0 - p.window + 1) / kF32WideTile;
  const int2 qrange = segments ? id_range(seg, q0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto live_from = [&](int t) {
    while (segments && t < t_hi &&
           apart(qrange, id_range(seg, t * kF32WideTile, p.s, lane, 32, ~0u, nullptr))) {
      ++t;
    }
    return t;
  };
  auto fetch = [&](int t, int st) {
    float* dst = ring + st * 2 * kSlab;
    load_head<W>(dst, kg, t * kF32WideTile, p.s, d);
    load_head<W>(dst + kSlab, vg, t * kF32WideTile, p.s, d);
  };

  int t = live_from(t_lo);
  load_head<W>(qres, qg, q0, p.s, d);
  load_head<W>(dores, dog, q0, p.s, d);
  if (t < t_hi) fetch(t, 0);
  cp_async_commit();
  // the thread's rows: lse * log2(e), delta and segment ids
  float l2[4], dl[4];
  int qseg[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + 4 * ta + a;
    const bool in = qi < p.s;
    l2[a] = in ? p.lse[static_cast<size_t>(bh) * p.s + qi] * kLog2e : -CUDART_INF_F;
    dl[a] = in ? p.delta[static_cast<size_t>(bh) * p.s + qi] : 0.f;
    qseg[a] = segments && in ? seg[qi] : 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < kSlab; e += kThreads) qres[e] *= p.qscale;

  float acc[4][W / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < W / 16; ++j) acc[a][j] = 0.f;
  int st = 0;  // the stage of tile t
  while (t < t_hi) {
    const int next = live_from(t + 1);
    const int k0 = t * kF32WideTile;
    int kseg[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int kj = k0 + 4 * tb + b;
      kseg[b] = segments && kj < p.s ? seg[kj] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();  // tile t's K and V in; the last tile's dS^T and stage read
    if (next < t_hi) fetch(next, st ^ 1);
    cp_async_commit();
    const float* kv = ring + st * 2 * kSlab;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = dp[a][b] = 0.f;
    tile_scores<W, false>(sc, qres, kv, ta, tb, d / 4, 1.f);
    tile_scores<W, false>(dp, dores, kv + kSlab, ta, tb, d / 4, 1.f);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + 4 * ta + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kj = k0 + 4 * tb + b;
        const bool live = qi < p.s && kj < p.s && l2[a] != -CUDART_INF_F &&
                          attends<TRI>(p, qi, kj, segments, qseg[a], kseg[b]);
        const float pe = live ? exp2f(sc[a][b] - l2[a]) : 0.f;
        dp[a][b] = pe * (dp[a][b] - dl[a]) * p.scale;
      }
    }
    store_scores(xs, dp, ta, tb);
    __syncthreads();
    slab_product<W>(acc, xs, kv, ta, tb);  // dQ += dS . K
    st ^= 1;
    t = next;
  }
  cp_async_wait<0>();
  store_head<W>(static_cast<float*>(p.dq) + static_cast<size_t>(bh) * p.s * d, acc, q0, p.s, d,
                ta, tb);
}

// The f32 dK/dV at head dims up to 128 on the CUDA cores, a CTA a 64-key
// tile (see the note on top). blockIdx.x: key tile; y and z: part x kv rows
// + kv row, sp parts of the GQA group, walked tile-major (cluster_slot:
// every row's key tile 0 first). A thread holds S^T and dP^T at keys 4 ta +
// a and q rows 4 tb + c (each q tile's rows' lse and delta loaded into
// registers before its barrier), and dK and dV at keys 4 ta + a, columns 4
// (tb + 16 h) + e; it walks the q tiles of its part's group / sp members
// and writes its sums at row part x rows + kv row of p.dk and p.dv (sp 1:
// dK and dV; above: the partials flash_bwd_dkv_split_sum_kernel adds). TRI:
// the triangle; else the general masks, as dQ's.
template <bool TRI, int W>
__device__ __forceinline__ void dkv_tile_f32_body(const Params& p, int d, int sp) {
  constexpr int kSlab = kF32WideTile * W;
  extern __shared__ float4 f32w_smem[];
  float* kres = reinterpret_cast<float*>(f32w_smem);  // the K and V tiles
  float* vres = kres + kSlab;
  float* ring = vres + kSlab;  // per stage: the Q and dO tiles
  float* xs = ring + kF32WideStages * 2 * kSlab;  // P^T and dS^T

  const int tiles = (p.s + kF32WideTile - 1) / kF32WideTile;
  const int2 slot = cluster_slot(p.rows * sp, tiles, 1, false);
  if (slot.x < 0) return;
  const int row = slot.x;  // part x kv rows + kv row
  const int kv_row = row % p.rows;
  const int k0 = slot.y * kF32WideTile;
  const int2 th = f32_wide_thread();
  const int ta = th.x, tb = th.y;
  const int b = kv_row / p.kv_heads;
  const int group = p.heads / p.kv_heads;
  const int m_end = (row / p.rows + 1) * (group / sp);  // past the part's last member
  const float* kg = static_cast<const float*>(p.k) + static_cast<size_t>(kv_row) * p.s * d;
  const float* vg = static_cast<const float*>(p.v) + static_cast<size_t>(kv_row) * p.s * d;
  const bool segments = !TRI && p.seg != nullptr;
  const int* seg = segments ? p.seg + static_cast<size_t>(b) * p.s : nullptr;
  const int lane = threadIdx.x & 31;
  auto q_row = [&](int m) { return b * p.heads + (kv_row % p.kv_heads) * group + m; };

  int t_lo = 0, t_hi = tiles;
  if (TRI || p.causal) t_lo = k0 / kF32WideTile;
  if (!TRI && p.causal && p.window > 0) {
    t_hi = (min(p.s, min(k0 + kF32WideTile, p.s) - 1 + p.window) + kF32WideTile - 1) /
           kF32WideTile;
  }
  const int2 krange = segments ? id_range(seg, k0, p.s, lane, 32, ~0u, nullptr) : make_int2(0, 1);
  auto advance = [&](int& m, int& t) {  // (m, t) to the first live (member, q tile) from it
    while (m < m_end) {
      if (t >= t_hi) {
        ++m;
        t = t_lo;
      } else if (segments &&
                 apart(krange, id_range(seg, t * kF32WideTile, p.s, lane, 32, ~0u, nullptr))) {
        ++t;
      } else {
        return;
      }
    }
  };
  auto fetch = [&](int m, int t, int st) {
    float* dst = ring + st * 2 * kSlab;
    const size_t qoff = static_cast<size_t>(q_row(m)) * p.s * d;
    load_head<W>(dst, static_cast<const float*>(p.q) + qoff, t * kF32WideTile, p.s, d);
    load_head<W>(dst + kSlab, static_cast<const float*>(p.dout) + qoff, t * kF32WideTile, p.s, d);
  };

  int m = m_end - group / sp, t = t_lo;
  advance(m, t);
  load_head<W>(kres, kg, k0, p.s, d);
  load_head<W>(vres, vg, k0, p.s, d);
  if (m < m_end) fetch(m, t, 0);
  cp_async_commit();

  float dk[4][W / 16], dv[4][W / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < W / 16; ++j) dk[a][j] = dv[a][j] = 0.f;
  int st = 0;
  while (m < m_end) {
    int nm = m, nt = t + 1;
    advance(nm, nt);
    const size_t lrow = static_cast<size_t>(q_row(m)) * p.s;
    const int q0 = t * kF32WideTile;
    float l2[4], dl[4];  // q rows 4 tb + c: lse * log2(e) and delta
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = q0 + 4 * tb + c;
      const bool in = qi < p.s;
      l2[c] = in ? p.lse[lrow + qi] * kLog2e : -CUDART_INF_F;
      dl[c] = in ? p.delta[lrow + qi] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // this tile's Q and dO in; the last tile's scores and stage read
    if (nm < m_end) fetch(nm, nt, st ^ 1);
    cp_async_commit();
    const float* qd = ring + st * 2 * kSlab;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
    tile_scores<W, true>(sc, kres, qd, ta, tb, d / 4, p.qscale);
    tile_scores<W, false>(dp, vres, qd + kSlab, ta, tb, d / 4, 1.f);
    int qseg[4], kseg[4];  // the q rows' and the keys' segment ids
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = q0 + 4 * tb + c, kj = k0 + 4 * ta + c;
      qseg[c] = segments && qi < p.s ? seg[qi] : 0;
      kseg[c] = segments && kj < p.s ? seg[kj] : 0;
    }
    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kj = k0 + 4 * ta + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = q0 + 4 * tb + c;
        const bool live = qi < p.s && kj < p.s && l2[c] != -CUDART_INF_F &&
                          attends<TRI>(p, qi, kj, segments, qseg[c], kseg[a]);
        sc[a][c] = live ? exp2f(sc[a][c] - l2[c]) : 0.f;
        dp[a][c] = sc[a][c] * (dp[a][c] - dl[c]) * p.scale;
      }
    }
    store_scores(xs, sc, ta, tb);
    store_scores(xs + kF32TileFloats, dp, ta, tb);
    __syncthreads();
    slab_product<W>(dv, xs, qd + kSlab, ta, tb);                   // dV += P^T . dO
    slab_product<W>(dk, xs + kF32TileFloats, qd, ta, tb);          // dK += dS^T . Q
    st ^= 1;
    m = nm;
    t = nt;
  }
  cp_async_wait<0>();
  store_head<W>(static_cast<float*>(p.dk) + static_cast<size_t>(row) * p.s * d, dk, k0, p.s, d,
                ta, tb);
  store_head<W>(static_cast<float*>(p.dv) + static_cast<size_t>(row) * p.s * d, dv, k0, p.s, d,
                ta, tb);
}

// The four f32 kernels at head dims up to 128, at slab width W (64 or 128):
// the triangle pair and the general pair, one CTA a tile; dK/dV's GQA walk
// in sp parts.
template <int W>
__global__ void __launch_bounds__(kThreads, f32_tile_ctas(W, true))
    flash_bwd_dq_tri_tile_f32_kernel(Params p, int d) {
  dq_tile_f32_body<true, W>(p, d);
}

template <int W>
__global__ void __launch_bounds__(kThreads, f32_tile_ctas(W, true))
    flash_bwd_dq_rect_tile_f32_kernel(Params p, int d) {
  dq_tile_f32_body<false, W>(p, d);
}

template <int W>
__global__ void __launch_bounds__(kThreads, f32_tile_ctas(W, false))
    flash_bwd_dkv_tri_tile_f32_kernel(Params p, int d, int sp) {
  dkv_tile_f32_body<true, W>(p, d, sp);
}

template <int W>
__global__ void __launch_bounds__(kThreads, f32_tile_ctas(W, false))
    flash_bwd_dkv_rect_tile_f32_kernel(Params p, int d, int sp) {
  dkv_tile_f32_body<false, W>(p, d, sp);
}
#endif  // FLASH_ELEM_F16
#endif  // FLASH_HEAD_DIM_WIDE

// dK and dV (of type O: f32 for the f32 cluster pair, the library's 16-bit
// type for the tensor-core pair up to D 256) from the sp partials of a split
// GQA walk (parts: dK's sp x n4 float4s, then dV's): each float4 of dK, then
// of dV, the sum of its parts in part order, rounded to O once, so two runs
// give the same bits. Bound by bytes: 2 sp reads of n4 float4s and 2 writes
// of n4 O quads, each once, over HBM (or L2, where the partials still sit).
template <typename O>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_split_sum_kernel(const float4* __restrict__ parts, O* __restrict__ dk,
                                   O* __restrict__ dv, size_t n4, int sp) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < 2 * n4;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const bool is_v = i >= n4;
    const size_t e = is_v ? i - n4 : i;
    const float4* src = parts + (is_v ? static_cast<size_t>(sp) * n4 : 0) + e;
    float4 acc = src[0];
    for (int j = 1; j < sp; ++j) {
      const float4 u = src[static_cast<size_t>(j) * n4];
      acc = make_float4(acc.x + u.x, acc.y + u.y, acc.z + u.z, acc.w + u.w);
    }
    if constexpr (std::is_same<O, float>::value) {
      reinterpret_cast<float4*>(is_v ? dv : dk)[e] = acc;
    } else {
      reinterpret_cast<uint2*>(is_v ? dv : dk)[e] =
          make_uint2(pack2<O>(acc.x, acc.y), pack2<O>(acc.z, acc.w));
    }
  }
}

#undef TC_MAPS

enum Kind { kDqTri, kDqRect, kDkvTri, kDkvRect };

constexpr bool is_dq(Kind k) { return k == kDqTri || k == kDqRect; }
constexpr bool is_tri(Kind k) { return k == kDqTri || k == kDkvTri; }

// rows: the grid's row count, bh for dQ and bh_kv for dK/dV; dK/dV's split
// parts of its GQA walk multiply them on the grid's x.
template <typename T, int D, int WG, Kind K>
int launch_tc(const Params& p, int rows, int smem, int split, cudaStream_t stream) {
  constexpr bool kDq = is_dq(K), kTri = is_tri(K);
  constexpr int B = 64 * WG;  // the CTA's own side: q rows (dQ) or keys (dK/dV)
  const int tiles = (p.s + B - 1) / B;
  if (smem != (kDq ? dq_tc_smem_bytes<D, WG, kTri>() : dkv_tc_smem_bytes<D, WG, kTri>()) ||
      tiles > 65535) {
    return kUnsupported;
  }
  const int bh = kDq ? rows : rows / p.kv_heads * p.heads;
  const int bh_kv = kDq ? rows / p.heads * p.kv_heads : rows;
  // the CTA's own side comes in boxes of B rows, the ring's side in ring_rows<D>
  const int q_box = kDq ? B : ring_rows<D>(), kv_box = kDq ? ring_rows<D>() : B;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_map<T, D>(&qmap, p.q, p.s, bh, q_box) ||
      !encode_map<T, D>(&domap, p.dout, p.s, bh, q_box) ||
      !encode_map<T, D>(&kmap, p.k, p.s, bh_kv, kv_box) ||
      !encode_map<T, D>(&vmap, p.v, p.s, bh_kv, kv_box)) {
    return kNoTensorMap;
  }
  void (*kernel)(Params, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap);
  if constexpr (K == kDqTri) {
    kernel = flash_bwd_dq_tri_kernel<T, D, WG>;
  } else if constexpr (K == kDqRect) {
    kernel = flash_bwd_dq_rect_kernel<T, D, WG>;
  } else if constexpr (K == kDkvTri) {
    kernel = flash_bwd_dkv_tri_kernel<T, D, WG>;
  } else {
    kernel = flash_bwd_dkv_rect_kernel<T, D, WG>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ: one producer warp; dK/dV: a producer warpgroup (setmaxnreg beside
  // two consumer warpgroups)
  const int threads = kDq ? WG * 128 + 32 : (WG * kv_split<D>() + 1) * 128;
  kernel<<<dim3(rows * split, tiles, col_split<D>()), threads, smem, stream>>>(p, qmap, kmap, vmap,
                                                                              domap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, Kind K>
int dispatch_tc(const Params& p, int rows, int block, int smem, int swizzle, int split,
                cudaStream_t stream) {
  if (swizzle != Geo<D>::kRowBytes) return kUnsupported;
  if (split != 1 && (is_dq(K) || col_split<D>() > 1)) return kUnsupported;  // dK/dV to D 256
  if (!tma_aligned({p.q, p.k, p.v, p.dout})) return kUnsupported;  // TMA needs 16-byte bases
  if (block == 64) return launch_tc<Elem16, D, 1, K>(p, rows, smem, split, stream);
  if constexpr (D <= 128) {  // D 256, 512 and 576: 64-row tiles only (see the note on top)
    if (block == 128) return launch_tc<Elem16, D, 2, K>(p, rows, smem, split, stream);
  }
  return kUnsupported;
}

template <typename T, int D, Kind K>
int launch(const Params& p, int rows, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (K == kDqTri) {
    kernel = flash_bwd_dq_tri_kernel<T, D>;
  } else if constexpr (K == kDqRect) {
    kernel = flash_bwd_dq_rect_kernel<T, D>;
  } else if constexpr (K == kDkvTri) {
    kernel = flash_bwd_dkv_tri_kernel<T, D>;
  } else {
    kernel = flash_bwd_dkv_rect_kernel<T, D>;
  }
  const size_t smem = is_dq(K) ? dq_smem_bytes(D) : dkv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + kTile - 1) / kTile, rows < kMaxGridY ? rows : kMaxGridY,
                  (rows + kMaxGridY - 1) / kMaxGridY);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Kind K>
int dispatch_dim(const Params& p, int rows, int d, cudaStream_t stream) {
  // D 16 here (the whole-row pair is faster there); 32 and above: flash_bwd_wide's pair
#if !defined(FLASH_HEAD_DIM_512) && !defined(FLASH_HEAD_DIM_576)
  if (d == 16) return launch<T, 16, K>(p, rows, stream);
#endif
  return kUnsupported;
}

bool valid(const Params& p, int rows) {
  return rows > 0 && p.s > 0 && p.heads > 0 && p.kv_heads > 0 &&
         p.heads % p.kv_heads == 0;
}

#if defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_ELEM_F16)
// The head dims of the f32 pair (the wide library's): 32-128 a CTA a tile,
// 256 and above in clusters.
bool f32_bwd_head_dim(int d) { return f32_tile_head_dim(d) || f32_cluster_head_dim(d); }

// The f32 cluster kernel of K (dK/dV's take the split besides d).
template <Kind K>
auto f32_wide_kernel() {
  if constexpr (K == kDqTri) {
    return flash_bwd_dq_tri_wide_f32_kernel;
  } else if constexpr (K == kDqRect) {
    return flash_bwd_dq_rect_wide_f32_kernel;
  } else if constexpr (K == kDkvTri) {
    return flash_bwd_dkv_tri_wide_f32_kernel;
  } else {
    return flash_bwd_dkv_rect_wide_f32_kernel;
  }
}

// K's answers of cudaOccupancyMaxActiveClusters (flash_cluster.cuh)
template <Kind K>
ClusterCounts& f32_wide_counts() {
  static ClusterCounts counts;
  return counts;
}

// How many clusters of K's at head dim d the current card holds at once
// (at the plan's shared memory and cluster size); a negative CUDA error
// code when the query fails.
template <Kind K>
int f32_wide_clusters(int d) {
  return active_clusters(f32_wide_kernel<K>(), F32WideGeo(d).c, f32_wide_smem_bytes<is_dq(K)>(),
                         f32_wide_counts<K>());
}

// The f32 cluster kernel K at head dim d: grid (tiles x g c, rows, z
// slices), clusters of c CTAs on x; dK/dV's rows are split x rows, one
// walk part each.
template <Kind K>
int launch_f32_wide(const Params& p, int rows, int d, int smem, int split, cudaStream_t stream) {
  const F32WideGeo geo(d);
  const int tiles = (p.s + kF32WideTile - 1) / kF32WideTile;
  if constexpr (is_dq(K)) {
    return launch_clusters(f32_wide_kernel<K>(), cluster_grid(tiles, geo.ctas(), rows), geo.c,
                           kF32Threads, smem, stream, f32_wide_counts<K>(), p, d);
  } else {
    return launch_clusters(f32_wide_kernel<K>(), cluster_grid(tiles, geo.ctas(), rows * split),
                           geo.c, kF32Threads, smem, stream, f32_wide_counts<K>(), p, d, split);
  }
}

// The f32 kernel of K at head dims up to 128 and slab width W.
template <Kind K, int W>
auto f32_tile_kernel() {
  if constexpr (K == kDqTri) {
    return flash_bwd_dq_tri_tile_f32_kernel<W>;
  } else if constexpr (K == kDqRect) {
    return flash_bwd_dq_rect_tile_f32_kernel<W>;
  } else if constexpr (K == kDkvTri) {
    return flash_bwd_dkv_tri_tile_f32_kernel<W>;
  } else {
    return flash_bwd_dkv_rect_tile_f32_kernel<W>;
  }
}

// How many CTAs of K's f32 kernel at head dim d (32-128) the current card
// holds at once (its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at the plan's shared memory), asked once per card; a negative CUDA error
// code when the query fails.
template <Kind K, int W>
int f32_tile_resident() {
  static int known[kCachedCards] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (card < kCachedCards && known[card] != 0) return known[card];
  constexpr int smem = f32_tile_smem_bytes<W, is_dq(K)>();
  const auto kernel = f32_tile_kernel<K, W>();
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (card < kCachedCards) known[card] = sms * per_sm;
  return sms * per_sm;
}

// The f32 kernel K at head dim d up to 128 on slabs of W: grid (tiles,
// rows, z slices), one CTA a tile; dK/dV's rows are split x rows, one walk
// part each.
template <Kind K, int W>
int launch_f32_tile(const Params& p, int rows, int d, int smem, int split, cudaStream_t stream) {
  if (smem != f32_tile_smem_bytes<W, is_dq(K)>()) return kUnsupported;
  const auto kernel = f32_tile_kernel<K, W>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.s + kF32WideTile - 1) / kF32WideTile;
  if constexpr (is_dq(K)) {
    kernel<<<cluster_grid(tiles, 1, rows), kThreads, smem, stream>>>(p, d);
  } else {
    kernel<<<cluster_grid(tiles, 1, rows * split), kThreads, smem, stream>>>(p, d, split);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif

// The libraries that split dK/dV's GQA walk, and the gradients' type there:
// the wide bf16 one (the f32 cluster pair) and the base ones (the 16-bit
// pair up to D 256).
#if defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_ELEM_F16)
#define FLASH_BWD_SPLITS
using SplitOut = float;
bool split_takes(int dtype, int d) { return dtype == 0 && f32_bwd_head_dim(d); }
#elif !defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_HEAD_DIM_512) && !defined(FLASH_HEAD_DIM_576)
#define FLASH_BWD_SPLITS
using SplitOut = Elem16;
bool split_takes(int dtype, int d) { return dtype == kElemCode && d <= 256; }
#endif

#ifdef FLASH_BWD_SPLITS
// dK and dV (n elements each) from a split walk's partials: one float4 a
// thread, a grid of at most kSplitSumBlocks CTAs striding over the rest.
constexpr size_t kSplitSumBlocks = 8192;
int launch_split_sum(const float* partials, void* dk, void* dv, size_t n, int split,
                     cudaStream_t stream) {
  const size_t n4 = n / 4;
  const size_t want = (2 * n4 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < kSplitSumBlocks ? want : kSplitSumBlocks);
  flash_bwd_dkv_split_sum_kernel<SplitOut><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(partials), static_cast<SplitOut*>(dk),
      static_cast<SplitOut*>(dv), n4, split);
  return static_cast<int>(cudaGetLastError());
}
#endif

#ifdef FLASH_HEAD_DIM_WIDE
// The 16-bit cluster kernel of K above 576.
template <Kind K>
auto wide16_kernel() {
  if constexpr (K == kDqTri) {
    return flash_bwd_dq_tri_wide_kernel<Elem16>;
  } else if constexpr (K == kDqRect) {
    return flash_bwd_dq_rect_wide_kernel<Elem16>;
  } else if constexpr (K == kDkvTri) {
    return flash_bwd_dkv_tri_wide_kernel<Elem16>;
  } else {
    return flash_bwd_dkv_rect_wide_kernel<Elem16>;
  }
}

// K's answers of cudaOccupancyMaxActiveClusters (flash_cluster.cuh)
template <Kind K>
ClusterCounts& wide16_counts() {
  static ClusterCounts counts;
  return counts;
}

// How many clusters of the 16-bit kernel K at head dim d the current card
// holds at once; a negative CUDA error code when the query fails.
template <Kind K>
int wide16_clusters(int d) {
  constexpr bool kDq = is_dq(K);
  return active_clusters(wide16_kernel<K>(), SlabGeo<kDq ? kWideDqSlab : kWideDkvSlab>(d).c,
                         wide16_smem_bytes<kDq>(), wide16_counts<K>(), kWideThreads);
}

// Either pair in the wide library with the caller's plan: 64-row tiles, the
// layout's shared memory, the 128-byte swizzle (16-bit, above 576) or none
// (f32, 256 and above: the cluster pair; dK/dV's GQA walk in `split` parts).
template <Kind K>
int dispatch_wide(const Params& p, int dtype, int rows, int d, int block, int smem, int swizzle,
                  int split, cudaStream_t stream) {
  constexpr bool kDq = is_dq(K);
  if (block != 64) return kUnsupported;
  const int tiles = (p.s + kTile - 1) / kTile;
  if (dtype == kElemCode) {
    if (!wide_head_dim(d) || split != 1 || swizzle != WideGeo::kRowBytes ||
        smem != wide16_smem_bytes<kDq>()) {
      return kUnsupported;
    }
    if (!tma_aligned({p.q, p.k, p.v, p.dout})) return kUnsupported;  // TMA needs 16-byte bases
    const int bh = kDq ? rows : rows / p.kv_heads * p.heads;
    const int bh_kv = kDq ? rows / p.heads * p.kv_heads : rows;
    CUtensorMap qmap, kmap, vmap, domap;
    if (!encode_wide_map<Elem16>(&qmap, p.q, p.s, bh, d) ||
        !encode_wide_map<Elem16>(&domap, p.dout, p.s, bh, d) ||
        !encode_wide_map<Elem16>(&kmap, p.k, p.s, bh_kv, d) ||
        !encode_wide_map<Elem16>(&vmap, p.v, p.s, bh_kv, d)) {
      return kNoTensorMap;
    }
    const SlabGeo<kDq ? kWideDqSlab : kWideDkvSlab> geo(d);
    return launch_clusters(wide16_kernel<K>(), cluster_grid(tiles, geo.ctas(), rows), geo.c,
                           kWideThreads, smem, stream, wide16_counts<K>(), p, d, qmap, kmap, vmap,
                           domap);
  }
#ifdef FLASH_ELEM_F16
  return kUnsupported;
#else
  if (dtype != 0 || swizzle != 0 || !f32_bwd_head_dim(d) ||
      (kDq ? split != 1 : (p.heads / p.kv_heads) % split != 0)) {
    return kUnsupported;
  }
  // cp.async and float4 stores move 16 bytes: 16-byte bases (rows are d * 4 bytes)
  if (!tma_aligned({p.q, p.k, p.v, p.dout, kDq ? p.dq : p.dk, kDq ? p.dq : p.dv})) {
    return kUnsupported;
  }
  if (d <= 64) return launch_f32_tile<K, 64>(p, rows, d, smem, split, stream);
  if (d == 128) return launch_f32_tile<K, kF32WideSlab>(p, rows, d, smem, split, stream);
  if (smem != f32_wide_smem_bytes<kDq>()) return kUnsupported;
  return launch_f32_wide<K>(p, rows, d, smem, split, stream);
#endif
}
#endif  // FLASH_HEAD_DIM_WIDE

// The library's 16-bit type on the tensor cores with the caller's plan; f32
// on the CUDA cores: D 16 in the base bf16 library, whose whole-row plan is
// fixed (its tile, shared memory, no swizzle), every other head dim in the
// wide bf16 library (32-128: a CTA a tile; 256 and above: slab clusters).
// `split` > 1 (dK/dV's GQA walk in parts) in the wide library's f32 pair
// and the base libraries' 16-bit one.
template <Kind K>
int dispatch(const Params& p, int dtype, int rows, int d, int block, int smem, int swizzle,
             int split, void* stream) {
  if (!valid(p, rows) || split < 1) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef FLASH_HEAD_DIM_WIDE
  return dispatch_wide<K>(p, dtype, rows, d, block, smem, swizzle, split, st);
#else
  if (dtype == kElemCode) {
    switch (d) {
#ifdef FLASH_HEAD_DIM_512
      case 512: return dispatch_tc<512, K>(p, rows, block, smem, swizzle, split, st);
#elif defined(FLASH_HEAD_DIM_576)
      case 576: return dispatch_tc<576, K>(p, rows, block, smem, swizzle, split, st);
#else
      case 16: return dispatch_tc<16, K>(p, rows, block, smem, swizzle, split, st);
      case 32: return dispatch_tc<32, K>(p, rows, block, smem, swizzle, split, st);
      case 64: return dispatch_tc<64, K>(p, rows, block, smem, swizzle, split, st);
      case 128: return dispatch_tc<128, K>(p, rows, block, smem, swizzle, split, st);
      case 256: return dispatch_tc<256, K>(p, rows, block, smem, swizzle, split, st);
#endif
      default: return kUnsupported;
    }
  }
  if constexpr (!kWithF32) {
    return kUnsupported;
  } else {
    const size_t fixed = is_dq(K) ? dq_smem_bytes(d) : dkv_smem_bytes(d);
    if (dtype != 0 || block != kTile || swizzle != 0 || smem != static_cast<int>(fixed) ||
        split != 1) {
      return kUnsupported;
    }
    return dispatch_dim<float, K>(p, rows, d, st);
  }
#endif  // FLASH_HEAD_DIM_WIDE
}

// dK/dV with its GQA walk in `split` parts: 1 writes dk and dv straight;
// above 1 (the f32 cluster pair, and the 16-bit pair up to D 256: split_takes)
// part j's CTAs sum their group / split members into f32 partials (dK's
// split x rows x s x d floats, then dV's), which
// flash_bwd_dkv_split_sum_kernel adds into dk and dv in part order.
template <Kind K>
int dispatch_dkv(Params p, int dtype, int rows, int d, int block, int smem, int swizzle,
                 float* partials, int split, void* stream) {
  if (split == 1) return dispatch<K>(p, dtype, rows, d, block, smem, swizzle, 1, stream);
#ifdef FLASH_BWD_SPLITS
  if (split < 1 || !valid(p, rows) || (p.heads / p.kv_heads) % split != 0 ||
      !split_takes(dtype, d) || !tma_aligned({partials, p.dk, p.dv}) || partials == nullptr) {
    return kUnsupported;
  }
  void* const dk = p.dk;
  void* const dv = p.dv;
  const size_t n = static_cast<size_t>(rows) * p.s * d;
  p.dk = partials;
  p.dv = partials + static_cast<size_t>(split) * n;
  const int code = dispatch<K>(p, dtype, rows, d, block, smem, swizzle, split, stream);
  if (code != 0) return code;
  return launch_split_sum(partials, dk, dv, n, split, static_cast<cudaStream_t>(stream));
#else
  return kUnsupported;
#endif
}

// A window is a band of causal attention only, and one of s or more keys
// is no band at all: both become 0 (none), as the launch plan reads them.
int band(int causal, int window, int s) { return causal && window > 0 && window < s ? window : 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the library built as is), 2 = float16
// (the library built with -DFLASH_ELEM_F16); a library refuses the others.
// Each returns 0 on a launched kernel, a
// CUDA error code when the launch was refused, -1 for a shape, dtype, plan or
// alignment these kernels do not take, -2 when no TMA tensor map could be
// made. bh counts q rows (batch x heads), bh_kv kv rows. block, smem (bytes)
// and swizzle (bytes) are the caller's launch plan (flash_bwd.py::
// tri_bwd_plan and rect_bwd_plan); the dK/dV entries take its split too
// (BwdPlan.split: 1, or above 1 with partials, 2 x split x bh_kv x s x d
// floats of scratch: the f32 pair, and the 16-bit pair up to D 256). A
// library takes D 16-256 (f32: 16 alone), or (built with
// -DFLASH_HEAD_DIM_512) D 512 alone, or (-DFLASH_HEAD_DIM_576) D 576 alone,
// both 16-bit only, or (-DFLASH_HEAD_DIM_WIDE) every multiple of 64 above
// 576 and f32 at 32, 64, 128 and from 256 on (flash_bwd.py::wide_bwd_plans).
extern "C" int flash_bwd_dq_tri(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int dtype, int bh,
                                int s, int d, int heads, int kv_heads, float qscale, float scale,
                                int block, int smem, int swizzle, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dq, nullptr, nullptr,
           s, heads, kv_heads, 1, 0, qscale, scale, bh};
  return dispatch<kDqTri>(p, dtype, bh, d, block, smem, swizzle, 1, stream);
}

extern "C" int flash_bwd_dkv_tri(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 int dtype, int bh_kv, int s, int d, int heads, int kv_heads,
                                 float qscale, float scale, int block, int smem, int swizzle,
                                 float* partials, int split, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,
           s, heads, kv_heads, 1, 0, qscale, scale, bh_kv};
  return dispatch_dkv<kDkvTri>(p, dtype, bh_kv, d, block, smem, swizzle, partials, split, stream);
}

extern "C" int flash_bwd_dq_rect(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dq,
                                 int dtype, int bh, int s, int d, int heads, int kv_heads,
                                 int causal, int window, float qscale, float scale, int block,
                                 int smem, int swizzle, void* stream) {
  Params p{q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr,
           s, heads, kv_heads, causal, band(causal, window, s), qscale, scale, bh};
  return dispatch<kDqRect>(p, dtype, bh, d, block, smem, swizzle, 1, stream);
}

extern "C" int flash_bwd_dkv_rect(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, const int* seg, void* dk,
                                  void* dv, int dtype, int bh_kv, int s, int d, int heads,
                                  int kv_heads, int causal, int window, float qscale, float scale,
                                  int block, int smem, int swizzle, float* partials, int split,
                                  void* stream) {
  Params p{q, k, v, dout, lse, delta, seg, nullptr, dk, dv,
           s, heads, kv_heads, causal, band(causal, window, s), qscale, scale, bh_kv};
  return dispatch_dkv<kDkvRect>(p, dtype, bh_kv, d, block, smem, swizzle, partials, split,
                                stream);
}

#if !defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_HEAD_DIM_512) && !defined(FLASH_HEAD_DIM_576)
namespace {
// CTAs of the library's 16-bit dK/dV kernel at (D, WG) an SM holds at once.
template <int D, int WG>
int dkv_ctas_per_sm(bool tri, int smem) {
  void (*kernel)(Params, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap) =
      tri ? flash_bwd_dkv_tri_kernel<Elem16, D, WG> : flash_bwd_dkv_rect_kernel<Elem16, D, WG>;
  if (smem != (tri ? dkv_tc_smem_bytes<D, WG, true>() : dkv_tc_smem_bytes<D, WG, false>())) {
    return kUnsupported;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                         (WG * kv_split<D>() + 1) * 128, smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int D>
int dkv_ctas_per_sm_at(bool tri, int block, int smem) {
  if (block == 64) return dkv_ctas_per_sm<D, 1>(tri, smem);
  if constexpr (D <= 128) {
    if (block == 128) return dkv_ctas_per_sm<D, 2>(tri, smem);
  }
  return kUnsupported;
}
}  // namespace

// How many CTAs of the 16-bit dK/dV kernel (tri 1: the triangle pair's, 0:
// the general pair's) at head dim d (16-256) and the plan's block and shared
// memory an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// shared memory, registers, threads), which sizes its GQA split. -1 for a
// plan these kernels do not take, minus a CUDA error code when the query
// fails.
extern "C" int flash_bwd_dkv_ctas_per_sm(int tri, int d, int block, int smem) {
  switch (d) {
    case 16: return dkv_ctas_per_sm_at<16>(tri, block, smem);
    case 32: return dkv_ctas_per_sm_at<32>(tri, block, smem);
    case 64: return dkv_ctas_per_sm_at<64>(tri, block, smem);
    case 128: return dkv_ctas_per_sm_at<128>(tri, block, smem);
    case 256: return dkv_ctas_per_sm_at<256>(tri, block, smem);
    default: return kUnsupported;
  }
}
#endif

#ifdef FLASH_HEAD_DIM_WIDE
// How many clusters of the library's 16-bit kernel (dq 1: dQ, 0: dK/dV; tri
// 1: the triangle pair's, 0: the general pair's) at head dim d (above 576,
// a multiple of 64) the card holds at once: cudaOccupancyMaxActiveClusters
// at its plan's shared memory and cluster size. -1 for a head dim these
// kernels do not take, minus a CUDA error code when the query fails.
extern "C" int flash_bwd_wide16_clusters(int dq, int tri, int d) {
  if (!wide_head_dim(d)) return kUnsupported;
  if (dq) return tri ? wide16_clusters<kDqTri>(d) : wide16_clusters<kDqRect>(d);
  return tri ? wide16_clusters<kDkvTri>(d) : wide16_clusters<kDkvRect>(d);
}
#endif

#if defined(FLASH_HEAD_DIM_WIDE) && !defined(FLASH_ELEM_F16)
// How many clusters of an f32 kernel (dq 1: dQ, 0: dK/dV; tri 1: the
// triangle pair's, 0: the general pair's) at head dim d the card holds at
// once: at 256 and above cudaOccupancyMaxActiveClusters at its plan's shared
// memory and cluster size; at 32-128 (a CTA a tile, a cluster of one) its
// SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor. -1 for a head dim
// these kernels do not take,
// minus a CUDA error code when the query fails.
extern "C" int flash_bwd_f32_wide_clusters(int dq, int tri, int d) {
  if (f32_tile_head_dim(d)) {  // 32-128, a CTA a tile: its resident CTAs, each a cluster of one
    if (d <= 64) {
      if (dq) return tri ? f32_tile_resident<kDqTri, 64>() : f32_tile_resident<kDqRect, 64>();
      return tri ? f32_tile_resident<kDkvTri, 64>() : f32_tile_resident<kDkvRect, 64>();
    }
    if (dq) {
      return tri ? f32_tile_resident<kDqTri, kF32WideSlab>()
                 : f32_tile_resident<kDqRect, kF32WideSlab>();
    }
    return tri ? f32_tile_resident<kDkvTri, kF32WideSlab>()
               : f32_tile_resident<kDkvRect, kF32WideSlab>();
  }
  if (!f32_cluster_head_dim(d)) return kUnsupported;
  if (dq) return tri ? f32_wide_clusters<kDqTri>(d) : f32_wide_clusters<kDqRect>(d);
  return tri ? f32_wide_clusters<kDkvTri>(d) : f32_wide_clusters<kDkvRect>(d);
}
#endif
