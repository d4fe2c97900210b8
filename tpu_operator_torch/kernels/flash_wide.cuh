// Building blocks of the D-streaming ("wide") flash kernels for head dims
// above 576, shared by flash_fwd.cu and flash_bwd.cu and included by them
// only when built with -DFLASH_HEAD_DIM_WIDE (kernels/build.py's *_wide
// libraries), so no caller at D <= 576 compiles them.
//
// At D > 576 no 64-row Q, K and V tile (or Q, dO, K and V) fits a block's
// 232,448 bytes of shared memory beside another, so the reductions over D
// stream: a tensor is read in boxes of 64 rows x 64 columns (one TMA box,
// 128-byte swizzle, 8 KiB in 16 bits), the head dim D (a multiple of 64) is a
// runtime argument, and a score tile (S = Q.K^T or S^T = K.Q^T, dP or dP^T)
// accumulates over the 64-column chunks in registers. An output that spans
// D (O, dQ, dK, dV) is split into column slabs of W columns, one CTA each,
// the slab CTAs of a tile one thread-block cluster that adds their partial
// scores through distributed shared memory (flash_cluster.cuh); a slab is
// W / 64 boxes that lie side by side in shared memory, read as one MN-major
// wgmma operand of N = W. The last slab starts at D - W so that every slab
// runs the same product; it writes only the columns no earlier slab owns.

#pragma once

#include "hopper.cuh"

namespace hopper {

constexpr int kWideBox = 64;                            // rows and columns of a box
constexpr uint32_t kWideBoxBytes = kWideBox * kWideBox * 2;  // 8 KiB of 16-bit values
using WideGeo = Geo<kWideBox>;                          // 128-byte rows, 128B swizzle

// acc (+)= A(smem, K-major: a 64 x 64 box) . B(smem, K-major: a 64 x 64 box)^T,
// the contraction over the box's 64 columns as four k16 steps; `first`
// starts acc from zero.
template <typename T>
__device__ __forceinline__ void mma_box_by_box(float (&acc)[32], const unsigned char* a_box,
                                               const unsigned char* b_box, bool first) {
#pragma unroll
  for (int kk = 0; kk < kWideBox / 16; ++kk) {
    const uint64_t da = make_desc(a_box + kk * 32, 16, WideGeo::kAtom, WideGeo::kLayout);
    const uint64_t db = make_desc(b_box + kk * 32, 16, WideGeo::kAtom, WideGeo::kLayout);
    wgmma_ss_n64<T>(acc, da, db, first && kk == 0 ? 0 : 1);
  }
}

// acc += A(registers: 64 x 64, T fragments) . B(smem, MN-major: a slab of
// N / 64 boxes of 64 rows side by side, contracted over its 64 rows).
template <typename T, int N>
__device__ __forceinline__ void mma_frag_by_slab(float (&acc)[N / 2], const uint32_t (&a)[4][4],
                                                 const unsigned char* slab) {
  static_assert(N % kWideBox == 0 && N <= 256, "a slab is up to four whole boxes");
#pragma unroll
  for (int kk = 0; kk < kWideBox / 16; ++kk) {
    // a k16 step is 16 rows, two 8-row atoms; the next box is LBO away
    const uint64_t db = make_desc(slab + kk * 16 * WideGeo::kRowBytes, kWideBoxBytes,
                                  WideGeo::kAtom, WideGeo::kLayout);
    mma_pv<T, N>(acc, a[kk], db);
  }
}

// acc += A(smem, K-major: a 64 x 64 box, rows M, contracted over its 64
// columns) . B(smem, MN-major: a slab of N / 64 boxes of 64 rows side by
// side, contracted over its 64 rows): the backward's gradient products above
// 576 with P^T, dS^T or dS formed in shared memory by the cluster's exchange.
template <typename T, int N>
__device__ __forceinline__ void mma_tile_by_slab(float (&acc)[N / 2], const unsigned char* tile,
                                                 const unsigned char* slab) {
  static_assert(N == 128 || N == 256, "a slab of two or four boxes");
#pragma unroll
  for (int kk = 0; kk < kWideBox / 16; ++kk) {
    const uint64_t da = make_desc(tile + kk * 32, 16, WideGeo::kAtom, WideGeo::kLayout);
    const uint64_t db = make_desc(slab + kk * 16 * WideGeo::kRowBytes, kWideBoxBytes,
                                  WideGeo::kAtom, WideGeo::kLayout);
    if constexpr (N == 128) {
      wgmma_ss_t_n128<T>(acc, da, db, 1);
    } else {
      wgmma_ss_t_n256<T>(acc, da, db, 1);
    }
  }
}

// A 3-D map over a contiguous (rows, s, d) tensor of T with d a runtime
// multiple of 64: boxes of 64 rows x 64 columns, 128B swizzle; rows past s
// read as zero.
template <typename T>
bool encode_wide_map(CUtensorMap* map, const void* base, int s, int rows, int d) {
  static_assert(kElem16<T>, "TMA maps are made for bf16 or fp16 tiles");
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {kWideBox, kWideBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The byte offset of elements (a, 4 f .. 4 f + 3) of a 16-bit [64][64] tile
// in a TMA box's 128-byte swizzle, as wgmma reads a K-major operand
// (the 16-bit P and dS tiles both sources' cluster exchanges form).
__device__ __forceinline__ int tile16_at(int a, int f) {
  return a * 128 + (((f >> 1) ^ (a & 7)) << 4) + ((f & 1) << 3);
}

// The head dims the wide kernels take: above 576, whole boxes.
__host__ __device__ constexpr bool wide_head_dim(int d) { return d > 576 && d % kWideBox == 0; }

// Whether two sides' segment-id ranges (id_range's min and max over their
// positions inside s) are one document each, and whether they are two
// different ones: then the pair of tiles holds no live pair (both sources'
// walks above 576 skip such a tile in every warp).
__device__ __forceinline__ bool one_doc(int2 a, int2 b) { return a.x == a.y && b.x == b.y; }
__device__ __forceinline__ bool apart(int2 a, int2 b) { return one_doc(a, b) && a.x != b.x; }

// Column slabs of width w over a head dim d (the last one overlapping).
__host__ __device__ constexpr int wide_slabs(int d, int w) { return (d + w - 1) / w; }

}  // namespace hopper
