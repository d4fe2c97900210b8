// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// flash_fwd.cu and flash_bwd.cu: mbarriers, TMA tile loads, wgmma shared-
// memory descriptors and products, the segment-id ranges of a tile, and the
// host-side tensor-map encoder. The element type T of the products and the
// maps is a template parameter: bf16 or fp16 (kElem16), each kernel source
// instantiating one of them per library.
//
// Tile convention: a [rows][D] 16-bit tile lives in shared memory as
// Geo<D>::kBoxes column boxes of [rows][kCols], each row kRowBytes long and
// swizzled over that span, exactly as one TMA box of encode_map<T, D> lands. A
// K-major wgmma operand (contracting over D) steps 32 bytes inside a box per
// k16 step; an MN-major B operand (contracting over rows, the transpose
// flag) steps 16 rows per k16 step and reaches the next 64-column boxes
// (D = 128: one more, D = 256: three more) through the descriptor's leading
// byte offset, the boxes lying evenly apart. At D = 512 a tile is eight
// boxes: a K-major product's k16 steps cross all of them, and an MN-major B
// operand of N = 256 (wgmma's widest) takes four from a given box on. At
// D = 576 a tile is nine boxes (kBoxes need not be a power of two), and an
// MN-major B operand takes whole boxes from a given one on: three (N = 192)
// or two (128); an MN-major operand never starts inside a box, whose
// 128-byte swizzle rows hold 64 columns. A ring tile is kRingRows rows, or 32
// where a D = 512 or 576 tile of 64 would not fit beside the CTA's own tiles
// (the R parameter of the helpers below).
//
// kernels/build.py hashes every .cuh here with each source, so a change to
// this file rebuilds both libraries.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace hopper {

constexpr int kSmemAlign = 1024;  // the 128B swizzle atom (8 rows x 128 bytes)
// rows of a ring tile: the 64 keys (or q rows) a producer feeds per stage
// to the general forward and to both backward pairs
constexpr int kRingRows = 64;

// Tile geometry for head dim D: a [rows][D] 16-bit tile is stored as kBoxes
// column boxes of [rows][kCols], each row kRowBytes long and swizzled over
// that span, exactly as one TMA box lands.
template <int D>
struct Geo {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;  // 32, 64, 128: also the swizzle span
  static constexpr int kBoxes = D / kCols;     // 2 at D 128, 4 at 256, 8 at 512, 9 at 576, else 1
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // bytes of one 8-row swizzle atom
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A ring
// that never fills (a lost TMA, a wrong byte count) traps after ~10 s of
// clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of this warp's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// setmaxnreg: a warpgroup gives up (dealloc) or takes (alloc) registers,
// down or up to N a thread; every warp of the warpgroup runs it, on a path
// that never rejoins the other role's.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 16 bytes from global to shared memory without registers (cp.async, cached
// in L2 only); `in` false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread-block clusters: the CTA's rank, a barrier of every thread of every
// CTA of the cluster (release / acquire: shared-memory writes before it,
// local or remote, are seen after it), and distributed shared memory: the
// address of `ptr` (in this CTA's shared memory) in CTA `rank`'s, and
// 16-byte loads and stores there.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The same barrier split in its two halves, so that work that touches no
// shared memory another CTA reads or writes (the next tile's products) runs
// under its latency: cluster_arrive releases this thread's shared-memory
// writes and reads before it, cluster_wait returns once every thread of the
// cluster has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_addr(const void* ptr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(ptr)), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// 8 bytes (four 16-bit values) into distributed shared memory
__device__ __forceinline__ void st_cluster2(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}
// Order this thread's shared-memory stores (local or remote) before later
// reads of the async proxy (wgmma operands, TMA), which a barrier then
// hands on to other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}
// The same for this CTA's shared memory, on the reading side: shared-memory
// stores that a barrier has made seen (local or from another CTA of the
// cluster) before this thread's later reads of the async proxy.
__device__ __forceinline__ void fence_proxy_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tensor-core kernels' element types: bf16 and fp16. Both are 16 bits,
// so tiles, swizzles, TMA boxes and the register layouts of P and dS are the
// same; only wgmma's operand type, the tensor map's data type and the
// rounding of a packed pair differ.
template <typename T>
inline constexpr bool kHalf = std::is_same<T, __half>::value;
template <typename T>
inline constexpr bool kElem16 = kHalf<T> || std::is_same<T, __nv_bfloat16>::value;

// The 16-bit element type a kernel library is built for, and its dtype code
// (the wrappers' _DTYPES: 0 f32, 1 bf16, 2 fp16): built as is, bf16, beside
// the f32 CUDA-core kernels; built with -DFLASH_ELEM_F16 (kernels/build.py's
// fp16 libraries), fp16 alone, so a bf16 caller never compiles fp16 kernels.
#ifdef FLASH_ELEM_F16
using Elem16 = __half;
constexpr int kElemCode = 2;
#else
using Elem16 = __nv_bfloat16;
constexpr int kElemCode = 1;
#endif
constexpr bool kWithF32 = kElemCode == 1;

// The head dims a library holds: built with -DFLASH_HEAD_DIM_512 (kernels/
// build.py's *_d512 libraries), D 512 alone, in its 16-bit type and (bf16
// library) the f32 backward pair; with -DFLASH_HEAD_DIM_576 (*_d576), D 576
// alone; built with neither, 16 to 256 (the f32 forward up to 128: from 256
// on it runs in the flash_fwd_wide library's cluster kernels). So a caller
// at D <= 256 never compiles the wide kernels, nor one at D 512 those of 576
// (each source's dispatch switch reads the macros).

// Two floats rounded to nearest even into a pair of T, as one 32-bit
// register: a wgmma A fragment, or two neighbouring elements of a store.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(kElem16<T>, "the tensor-core kernels take bf16 or fp16");
  if constexpr (kHalf<T>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// One wgmma statement for element type T. TEXT(ty) spells the instruction
// with its operand type ("bf16" or "f16"): the asm text is a literal, so
// the type is chosen at compile time. The rest are the statement's operands.
#define HOPPER_WGMMA(T, TEXT, ...)                                          \
  do {                                                                      \
    static_assert(kElem16<T>, "the tensor-core kernels take bf16 or fp16"); \
    if constexpr (kHalf<T>) {                                               \
      asm volatile(TEXT("f16") __VA_ARGS__);                                \
    } else {                                                                \
      asm volatile(TEXT("bf16") __VA_ARGS__);                               \
    }                                                                       \
  } while (0)

// d[0..16) += A(smem, K-major) . B(smem, K-major), m64n32k16, T in, f32 out
#define HOPPER_SS_N32(ty)                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." ty "." ty " {"           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  HOPPER_WGMMA(T, HOPPER_SS_N32,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HOPPER_SS_N32

// d[0..32) += A(smem, K-major) . B(smem, K-major), m64n64k16, T in, f32 out
#define HOPPER_SS_N64(ty)                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                     \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {"                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  HOPPER_WGMMA(T, HOPPER_SS_N64,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HOPPER_SS_N64

// d[0..64) += A(smem, K-major) . B(smem, K-major), m64n128k16, T in, f32 out
#define HOPPER_SS_N128(ty)                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                       \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {"                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  HOPPER_WGMMA(T, HOPPER_SS_N128,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HOPPER_SS_N128

// d[0..8) += A(registers) . B(smem, MN-major), m64n16k16, T in, f32 out
#define HOPPER_RS_N16(ty)                                      \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                 \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." ty "." ty " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7"                             \
  "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N16,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N16

// d[0..16) += A(registers) . B(smem, MN-major), m64n32k16, T in, f32 out
#define HOPPER_RS_N32(ty)                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                           \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." ty "." ty " {"           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N32,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N32

// d[0..32) += A(registers) . B(smem, MN-major), m64n64k16, T in, f32 out
#define HOPPER_RS_N64(ty)                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {"                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N64,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N64

// d[0..64) += A(registers) . B(smem, MN-major), m64n128k16, T in, f32 out
#define HOPPER_RS_N128(ty)                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                       \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {"                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N128,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N128

// d[0..96) += A(registers) . B(smem, MN-major), m64n192k16, T in, f32 out
#define HOPPER_RS_N192(ty)                                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                                            \
  "wgmma.mma_async.sync.aligned.m64n192k16.f32." ty "." ty " {"                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "       \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"         \
  "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N192,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N192

// d[0..128) += A(registers) . B(smem, MN-major), m64n256k16, T in, f32 out
#define HOPPER_RS_N256(ty)                                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                    \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." ty "." ty " {"                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "               \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "               \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "               \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "               \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "               \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "   \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  HOPPER_WGMMA(T, HOPPER_RS_N256,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef HOPPER_RS_N256

// d[0..64) += A(smem, K-major) . B(smem, MN-major), m64n128k16, T in, f32 out:
// both operands from shared memory, B transposed (a [K][N] tile of 64-column
// boxes whose rows hold N), as the D-streaming backward's gradient products
// read a P^T, dS^T or dS tile and a slab of the other side
#define HOPPER_SS_T_N128(ty)                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                       \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {"                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
  "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  HOPPER_WGMMA(T, HOPPER_SS_T_N128,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HOPPER_SS_T_N128

// d[0..128) += A(smem, K-major) . B(smem, MN-major), m64n256k16, T in, f32 out:
// both operands from shared memory, B transposed (a [K][N] tile of 64-column
// boxes whose rows hold N), as the D-streaming backward's gradient products
// read a P^T, dS^T or dS tile and a slab of the other side
#define HOPPER_SS_T_N256(ty)                                                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                                    \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." ty "." ty " {"                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "               \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "               \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "               \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "               \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "               \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "   \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
template <typename T>
__device__ __forceinline__ void wgmma_ss_t_n256(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  HOPPER_WGMMA(T, HOPPER_SS_T_N256,
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HOPPER_SS_T_N256

#undef HOPPER_WGMMA

template <typename T, int N>
__device__ __forceinline__ void mma_scores(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64<T>(d, a, b, scale_d);
  else wgmma_ss_n128<T>(d, a, b, scale_d);
}

template <typename T, int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16<T>(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32<T>(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64<T>(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128<T>(d, a, b);
  else if constexpr (N == 192) wgmma_rs_n192<T>(d, a, b);
  else wgmma_rs_n256<T>(d, a, b);
}


// acc = A(smem, K-major: 64 rows of an [a_rows][D] tile from row `row` on)
//     . B(smem, K-major: an [R][D] ring tile)^T, contracted over all of D
template <typename T, int D, int R = kRingRows>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[R / 2], const unsigned char* a_tile,
                                                 int a_rows, int row, const unsigned char* b_tile) {
  static_assert(R == kRingRows || R == 32, "ring tiles are 64 or 32 rows");
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // a k16 step advances 32 bytes inside a box; D = 128 spans two boxes, 256 four, 512 eight,
    // 576 nine
    const int box = kk * 16 / G::kCols, off = (kk * 16 % G::kCols) * 2;
    const uint64_t da = make_desc(a_tile + box * a_rows * G::kRowBytes + row * G::kRowBytes + off,
                                  16, G::kAtom, G::kLayout);
    const uint64_t db = make_desc(b_tile + box * R * G::kRowBytes + off, 16, G::kAtom, G::kLayout);
    if constexpr (R == 32) {
      wgmma_ss_n32<T>(acc, da, db, kk > 0);
    } else {
      wgmma_ss_n64<T>(acc, da, db, kk > 0);
    }
  }
}

// acc = A(smem, K-major: 64 rows of an [a_rows][D] tile from row `row` on)
//     . B(smem, K-major: rows b_row .. b_row + N - 1 of a [kRingRows][D] ring
// tile)^T, contracted over all of D: N = 64 the whole tile, 32 half of it
// (b_row a multiple of 8: whole swizzle atoms, so the descriptor's start
// keeps the 1024-byte alignment of its box's)
template <typename T, int D, int N>
__device__ __forceinline__ void mma_rows_by_ring_rows(float (&acc)[N / 2],
                                                      const unsigned char* a_tile, int a_rows,
                                                      int row, const unsigned char* b_tile,
                                                      int b_row) {
  static_assert(N == kRingRows || N == kRingRows / 2, "a ring tile or half of one");
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / G::kCols, off = (kk * 16 % G::kCols) * 2;
    const uint64_t da = make_desc(a_tile + box * a_rows * G::kRowBytes + row * G::kRowBytes + off,
                                  16, G::kAtom, G::kLayout);
    const uint64_t db = make_desc(
        b_tile + box * kRingRows * G::kRowBytes + b_row * G::kRowBytes + off, 16, G::kAtom,
        G::kLayout);
    if constexpr (N == kRingRows) {
      wgmma_ss_n64<T>(acc, da, db, kk > 0);
    } else {
      wgmma_ss_n32<T>(acc, da, db, kk > 0);
    }
  }
}

// acc += A(registers: 64 x R, T fragments) . B(smem, MN-major: N columns
// of an [R][D] ring tile, from column box `box` on, contracted over its
// rows). N = D takes every column; the dK/dV kernel at D = 256 takes 128,
// every kernel at D = 512 takes 256 or 128 (its CTA's column half), and at
// D = 576 192 (its CTA's column third), or 128 (each of dK/dV's warpgroups).
template <typename T, int D, int N = D, int R = kRingRows>
__device__ __forceinline__ void mma_frag_by_tile(float (&acc)[N / 2],
                                                 const uint32_t (&a)[R / 16][4],
                                                 const unsigned char* b_tile, int box = 0) {
  using G = Geo<D>;
  const unsigned char* b = b_tile + box * R * G::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    // a k16 step is 16 rows, two 8-row atoms; the next 64-column boxes are LBO apart
    const uint64_t db = make_desc(b + kk * 16 * G::kRowBytes, R * G::kRowBytes, G::kAtom,
                                  G::kLayout);
    mma_pv<T, N>(acc, a[kk], db);
  }
}

// The min and max of the segment ids that the lanes of `mask` hold in lo
// and hi, for every one of those lanes.
__device__ __forceinline__ int2 warp_range(unsigned mask, int lo, int hi) {
  return make_int2(__reduce_min_sync(mask, lo), __reduce_max_sync(mask, hi));
}

// The min and max segment id of the R positions from t0 that lie inside s
// (INT_MAX and INT_MIN when none does), read by the n lanes of `mask`,
// lane index idx (0 .. n - 1) taking positions idx, idx + n, ...; ids,
// when given, receives all R ids (0 past s). Segment ids never come by
// TMA: a (B, s) int32 row breaks its 16-byte stride rule for most s.
template <int R = kRingRows>
__device__ __forceinline__ int2 id_range(const int* seg, int t0, int s, int idx, int n,
                                         unsigned mask, int* ids) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int c = idx; c < R; c += n) {
    const int pos = t0 + c;
    const int id = pos < s ? seg[pos] : 0;
    if (ids != nullptr) ids[c] = id;
    if (pos < s) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
  return warp_range(mask, lo, hi);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reach it through the
// runtime, so the library links nothing beyond cudart.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous (rows, s, D) tensor of T (bf16 or fp16): boxes
// of [box_rows][kCols] with the swizzle of Geo<D>; rows past s read as zero.
template <typename T, int D>
bool encode_map(CUtensorMap* map, const void* base, int s, int rows, int box_rows) {
  static_assert(kElem16<T>, "TMA maps are made for bf16 or fp16 tiles");
  using G = Geo<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::kCols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether every pointer starts on a 16-byte boundary, as a TMA base must.
inline bool tma_aligned(std::initializer_list<const void*> ptrs) {
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  }
  return true;
}

}  // namespace hopper
