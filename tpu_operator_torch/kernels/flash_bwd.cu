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
// dO and delta = rowsum(dO * O); sq == sk. P is recomputed tile by tile:
// the score is built exactly as the forward built it (q * log2(e)/sqrt(d) in
// f32, then an f32 FMA chain over d in the same order), so P = exp2(s -
// lse * log2(e)) is the forward's softmax and its rows sum to 1. Then
// dS = P * (dP - delta) / sqrt(d) with dP = dO . V^T, and
//   dQ = dS . K,  dK = dS^T . Q,  dV = P^T . dO.
// As the reference does, P is rounded to dO's dtype before dV, and dS to
// the input dtype before dQ and dK; every sum is f32.
//
// Design. The TPU kernels carry their accumulators across a sequential grid
// axis; here that axis is a loop inside one CTA of 256 threads (16 x 16):
//   dQ:   one CTA per (bh row, 64-row q tile); it walks the 64-key tiles its
//         rows can see (up to the diagonal, the window band, or all) and keeps
//         dQ for its rows in registers.
//   dK/dV: one CTA per (kv row, 64-key tile); it walks every (GQA group
//         member, q tile) that can see its keys (from the diagonal down, the
//         band, or all), so a group's q heads sum inside the CTA.
// Each thread owns a 4 x 4 block of the score tile and a 4 x D/16 block of
// each accumulator; P and dS go through shared memory between the two. No
// atomics: every gradient element is written once by one thread, so the
// result is deterministic.
//
// Bound on this card: at the burn-in shape (S 128, D 64) each launch moves
// about 2 MB and runs a few tens of MFLOP, so by the roofline it is
// bytes-bound, and in practice latency-bound (64-128 CTAs, one to two tiles
// each). At long context the work is O(S^2 D) over O(S D) bytes and turns
// operations-bound; like the forward, this first design does f32 FMA on CUDA
// cores (the f32 path must not run TF32) and sits far below the tensor cores'
// rate there. mma/wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 64;       // q rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kR = kTile / 16;  // tile rows (and columns) per thread
constexpr int kLP = kTile + 1;  // odd stride of the P / dS tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnsupported = -1;

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
  float qscale;        // log2(e)/sqrt(d), folded into q as the forward does
  float scale;         // 1/sqrt(d)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast rounds
}

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

template <int D>
constexpr size_t dq_smem_bytes() {
  // q (pre-scaled), dO, k, v tiles ([kTile][D + 1]), dS tile, key segment ids
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLP) + sizeof(int) * kTile;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles, P and dS tiles, per-row lse*log2e, delta, segment ids
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile) + sizeof(int) * kTile;
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void dq_body(const Params& p) {
  constexpr int LD = D + 1;
  constexpr int CN = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;
  int* kseg = reinterpret_cast<int*>(dss + kTile * kLP);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int b = bh / p.heads;
  const int kv_row = b * p.kv_heads + (bh % p.heads) / (p.heads / p.kv_heads);
  const size_t qoff = static_cast<size_t>(bh) * p.s * D;
  const size_t kvoff = static_cast<size_t>(kv_row) * p.s * D;
  const bool segments = !TRI && p.seg != nullptr;

  stage<T, D>(qs, static_cast<const T*>(p.q) + qoff, q0, p.s, p.qscale);
  stage<T, D>(dos, static_cast<const T*>(p.dout) + qoff, q0, p.s, 1.f);

  float lse2[kR], dlt[kR], acc[kR][CN];
  int qseg[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
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

    float sc[kR][kR], dp[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kR], dov[kR], kv[kR], vv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + d];
        dov[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = qi < p.s && kj < p.s && lse2[i] != -CUDART_INF_F &&
                          attends<TRI>(p, qi, kj, segments, qseg[i], kseg[tx + 16 * j]);
        const float pij = live ? exp2f(sc[i][j] - lse2[i]) : 0.f;
        dss[(ty + 16 * i) * kLP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] - dlt[i]) * p.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kR], kv[CN];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = dss[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.s) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) dqg[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void dkv_body(const Params& p) {
  constexpr int LD = D + 1;
  constexpr int CN = D / 16;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* dss = ps + kTile * kLP;
  float* lse2 = dss + kTile * kLP;
  float* dlt = lse2 + kTile;
  int* qseg = reinterpret_cast<int*>(dlt + kTile);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int kv_row = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int b = kv_row / p.kv_heads;
  const int group = p.heads / p.kv_heads;
  const size_t kvoff = static_cast<size_t>(kv_row) * p.s * D;
  const bool segments = !TRI && p.seg != nullptr;

  stage<T, D>(ks, static_cast<const T*>(p.k) + kvoff, k0, p.s, 1.f);
  stage<T, D>(vs, static_cast<const T*>(p.v) + kvoff, k0, p.s, 1.f);

  // score columns of this thread: keys k0 + tx + 16 j
  int kseg[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int kj = k0 + tx + 16 * j;
    kseg[j] = (segments && kj < p.s) ? p.seg[static_cast<size_t>(b) * p.s + kj] : 0;
  }
  // accumulator rows of this thread: keys k0 + ty + 16 i
  float dk[kR][CN], dv[kR][CN];
#pragma unroll
  for (int i = 0; i < kR; ++i)
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

      float sc[kR][kR], dp[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[kR], dov[kR], kv[kR], vv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          // the same f32 product the forward folds into q
          qv[i] = qs[(ty + 16 * i) * LD + d] * p.qscale;
          dov[i] = dos[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          kv[j] = ks[(tx + 16 * j) * LD + d];
          vv[j] = vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = ty + 16 * i;
        const int qi = q0 + r;
        const float l2 = lse2[r];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int kj = k0 + tx + 16 * j;
          const bool live = qi < p.s && kj < p.s && l2 != -CUDART_INF_F &&
                            attends<TRI>(p, qi, kj, segments, qseg[r], kseg[j]);
          const float pij = live ? exp2f(sc[i][j] - l2) : 0.f;
          ps[r * kLP + tx + 16 * j] = round_to<T>(pij);
          dss[r * kLP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] - dlt[r]) * p.scale);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[kR], dsv[kR], dov[CN], qv[CN];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = ps[r * kLP + ty + 16 * i];
          dsv[i] = dss[r * kLP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          dov[c] = dos[r * LD + tx + 16 * c];
          qv[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
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
  for (int i = 0; i < kR; ++i) {
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

enum Kind { kDqTri, kDqRect, kDkvTri, kDkvRect };

template <typename T, int D, Kind K>
int launch(const Params& p, int rows, cudaStream_t stream) {
  void (*kernel)(Params);
  size_t smem;
  if constexpr (K == kDqTri) {
    kernel = flash_bwd_dq_tri_kernel<T, D>;
  } else if constexpr (K == kDqRect) {
    kernel = flash_bwd_dq_rect_kernel<T, D>;
  } else if constexpr (K == kDkvTri) {
    kernel = flash_bwd_dkv_tri_kernel<T, D>;
  } else {
    kernel = flash_bwd_dkv_rect_kernel<T, D>;
  }
  if constexpr (K == kDqTri || K == kDqRect) {
    smem = dq_smem_bytes<D>();
  } else {
    smem = dkv_smem_bytes<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + kTile - 1) / kTile, rows);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Kind K>
int dispatch_dim(const Params& p, int rows, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, K>(p, rows, stream);
    case 32: return launch<T, 32, K>(p, rows, stream);
    case 64: return launch<T, 64, K>(p, rows, stream);
    case 128: return launch<T, 128, K>(p, rows, stream);
    default: return kUnsupported;
  }
}

// rows: the grid's row count, bh for dQ and bh_kv for dK/dV.
template <Kind K>
int dispatch(const Params& p, int dtype, int rows, int d, void* stream) {
  if (rows <= 0 || rows > 65535 || p.s <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0) {
    return kUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float, K>(p, rows, d, s);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16, K>(p, rows, d, s);
  return kUnsupported;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0 on a launched kernel, a
// CUDA error code when the launch was refused, -1 for a shape or dtype these
// kernels do not take. bh counts q rows (batch x heads), bh_kv kv rows.
extern "C" int flash_bwd_dq_tri(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int dtype, int bh,
                                int s, int d, int heads, int kv_heads, float qscale, float scale,
                                void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dq, nullptr, nullptr,
           s, heads, kv_heads, 1, 0, qscale, scale};
  return dispatch<kDqTri>(p, dtype, bh, d, stream);
}

extern "C" int flash_bwd_dkv_tri(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 int dtype, int bh_kv, int s, int d, int heads, int kv_heads,
                                 float qscale, float scale, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,
           s, heads, kv_heads, 1, 0, qscale, scale};
  return dispatch<kDkvTri>(p, dtype, bh_kv, d, stream);
}

extern "C" int flash_bwd_dq_rect(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dq,
                                 int dtype, int bh, int s, int d, int heads, int kv_heads,
                                 int causal, int window, float qscale, float scale,
                                 void* stream) {
  Params p{q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr,
           s, heads, kv_heads, causal, window, qscale, scale};
  return dispatch<kDqRect>(p, dtype, bh, d, stream);
}

extern "C" int flash_bwd_dkv_rect(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, const int* seg, void* dk,
                                  void* dv, int dtype, int bh_kv, int s, int d, int heads,
                                  int kv_heads, int causal, int window, float qscale, float scale,
                                  void* stream) {
  Params p{q, k, v, dout, lse, delta, seg, nullptr, dk, dv,
           s, heads, kv_heads, causal, window, qscale, scale};
  return dispatch<kDkvRect>(p, dtype, bh_kv, d, stream);
}
