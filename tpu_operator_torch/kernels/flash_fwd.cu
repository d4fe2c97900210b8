// Flash-attention forward kernels for Hopper (sm_90a).
//
// Replace the two Pallas forward kernels of the JAX package:
//   flash_fwd_tri_kernel  <- tpu_operator/workloads/flashattention.py::_flash_fwd_tri_kernel
//                            (plain causal, sq == sk)
//   flash_fwd_rect_kernel <- tpu_operator/workloads/flashattention.py::_flash_fwd_kernel
//                            (causal or full, sliding window, segment ids, global
//                            q_start/k_start offsets, sq != sk)
// Both run a base-2 online softmax on q pre-scaled by log2(e)/sqrt(d) and write
// O in the input dtype and the natural-log logsumexp per row (f32); a row with
// no valid key gets O = 0 and lse = -inf.
//
// Design. One CTA of 256 threads (16 x 16) per (bh row, 64-row q tile). The
// k loop walks 64-key tiles and visits only the tiles some row of the q tile
// can see: up to the diagonal for causal attention, the band for a window.
// K and V tiles are staged through shared memory as f32; each thread owns a
// 4 x 4 block of the score tile (rows ty + 16 i, keys tx + 16 j), keeps the
// online-softmax state (m, l) of its 4 rows in registers, and owns the
// matching 4 x D/16 block of the output accumulator, so the per-row rescale
// never leaves registers. Row max and row sum reduce over the 16 lanes of a
// half-warp with shuffles. P goes through shared memory (rounded to the
// input dtype first, as the reference rounds P to v's dtype before P.V).
//
// Bound on this card: by the roofline the main path's calls are bytes-bound
// (at most a few MB moved: serving prefill is 8 x 64 scores per head, the
// burn-in 128 x 128 per head), but at those sizes a launch is latency-bound
// (few CTAs, one or two tiles each). At long context the work turns
// operations-bound (O(S^2 D) FLOPs over O(S D) bytes), and this first design,
// f32 FMA on the CUDA cores, sits far below the tensor cores' rate there; its
// f32 path must stay off TF32 anyway. mma/wgmma, TMA and warp specialisation
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBM = 64;         // q rows per CTA
constexpr int kBN = 64;         // keys per k tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRM = kBM / 16;   // score/output rows per thread
constexpr int kRN = kBN / 16;   // score columns per thread
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kUnsupported = -1;

struct Params {
  const void* q;      // (bh, sq, D)
  const void* k;      // (bh_kv, sk, D)
  const void* v;      // (bh_kv, sk, D)
  const int* seg;     // (B, sk) segment ids or nullptr (requires sq == sk)
  void* o;            // (bh, sq, D)
  float* lse;         // (bh, sq)
  int sq, sk, heads, kv_heads;
  int causal, q_start, k_start, window;  // window <= 0: no window
  float qscale;       // softmax scale * log2(e), folded into q
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

template <int D>
constexpr size_t smem_bytes() {
  // q tile, k tile, v tile ([rows][D + 1]), p tile ([kBM][kBN + 1]), k segment ids
  return sizeof(float) * ((kBM + 2 * kBN) * (D + 1) + kBM * (kBN + 1)) + sizeof(int) * kBN;
}

template <typename T, int D, bool TRI>
__device__ __forceinline__ void attend(const Params& p) {
  constexpr int LD = D + 1;   // odd stride: a column walk hits 16 different banks
  constexpr int LP = kBN + 1;
  constexpr int CN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBM * LD;
  float* vs = ks + kBN * LD;
  float* ps = vs + kBN * LD;
  int* kseg = reinterpret_cast<int*>(ps + kBM * LP);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
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
      // pre-scaled q stays f32: the reference's triangle path rounds it back
      // to the input dtype (flashattention.py:750); keeping f32 is closer
      // to exact and costs nothing here, since tiles are f32 in shared memory
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
    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      const size_t off = static_cast<size_t>(k0 + r) * D + c;
      ks[r * LD + c] = in ? to_f(kg[off]) : 0.f;
      vs[r * LD + c] = in ? to_f(vg[off]) : 0.f;
    }
    if (segments && tid < kBN) {
      kseg[tid] = (k0 + tid < p.sk) ? p.seg[static_cast<size_t>(b) * p.sk + k0 + tid] : 0;
    }
    __syncthreads();

    float s[kRM][kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRM], kv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kRN; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
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
      for (int j = 1; j < kRN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float corr = (m[i] == -CUDART_INF_F) ? 0.f : exp2f(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
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
    for (int kk = 0; kk < kBN; ++kk) {
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

template <typename T, int D, bool TRI>
int launch(const Params& p, int bh, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (TRI) {
    kernel = flash_fwd_tri_kernel<T, D>;
  } else {
    kernel = flash_fwd_rect_kernel<T, D>;
  }
  const int smem = static_cast<int>(smem_bytes<D>());
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TRI>
int dispatch_dim(const Params& p, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, TRI>(p, bh, stream);
    case 32: return launch<T, 32, TRI>(p, bh, stream);
    case 64: return launch<T, 64, TRI>(p, bh, stream);
    case 128: return launch<T, 128, TRI>(p, bh, stream);
    default: return kUnsupported;
  }
}

template <bool TRI>
int dispatch(const Params& p, int dtype, int bh, int d, void* stream) {
  if (bh <= 0 || bh > 65535 || p.sq <= 0 || p.sk <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0) {
    return kUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float, TRI>(p, bh, d, s);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16, TRI>(p, bh, d, s);
  return kUnsupported;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a launched kernel, a CUDA
// error code when the launch was refused, -1 for a shape or dtype these
// kernels do not take.
extern "C" int flash_fwd_tri(const void* q, const void* k, const void* v, void* o, float* lse,
                             int dtype, int bh, int s, int d, int heads, int kv_heads,
                             float qscale, void* stream) {
  Params p{q, k, v, nullptr, o, lse, s, s, heads, kv_heads, 1, 0, 0, 0, qscale};
  return dispatch<true>(p, dtype, bh, d, stream);
}

extern "C" int flash_fwd_rect(const void* q, const void* k, const void* v, const int* seg,
                              void* o, float* lse, int dtype, int bh, int sq, int sk, int d,
                              int heads, int kv_heads, int causal, int q_start, int k_start,
                              int window, float qscale, void* stream) {
  if (seg != nullptr && sq != sk) return kUnsupported;
  Params p{q, k, v, seg, o, lse, sq, sk, heads, kv_heads, causal, q_start, k_start, window, qscale};
  return dispatch<false>(p, dtype, bh, d, stream);
}
