// Streaming triad for Hopper (sm_90a): out = alpha * x + y over f32 arrays.
//
// Replaces the Pallas kernel of the JAX package:
//   triad_kernel <- tpu_operator/workloads/kernels.py::_triad_kernel
// which the HBM-bandwidth probe (hbm_bandwidth_probe) chains, usually in place
// (out is x). Each element is computed as fmaf(x, alpha, y): one rounding, as
// the reference's x * alpha + y compiles to a fused multiply-add.
//
// Bound on this card: bytes. One pass reads x and y once and writes out once
// (12 bytes per element against 2 FLOPs), so the least time is 12 n bytes over
// the HBM rate; the arithmetic is free. The probe's arrays (64 and 128 MiB
// each) are larger than the 50 MB L2, so every pass streams from HBM.
//
// Design. One launch covers the whole array with many small CTAs: each CTA of
// 128 threads owns one contiguous chunk of 512 float4 (8 KiB of each array),
// and each thread loads its four float4 of x and four of y (neighbouring
// threads on neighbouring addresses) before its first store, so enough bytes
// are in flight to cover HBM latency, and the hardware scheduler balances the
// CTAs over the SMs. (A grid-stride loop over a few CTAs per SM measured no
// faster and up to a few percent slower on the probe's arrays.) x is never
// read through the read-only path, because in place the kernel writes it.
// When the three pointers share their offset from a 16-byte boundary, the
// first CTA also takes the scalar head before that boundary and the scalar
// tail after the last float4; otherwise every CTA takes a chunk of 512 single
// floats.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;                     // float4 (or floats) per thread
constexpr int kChunk = kThreads * kPerThread;     // per CTA
constexpr int kUnsupported = -1;

__device__ __forceinline__ float4 fma4(float4 a, float alpha, float4 b) {
  return make_float4(fmaf(a.x, alpha, b.x), fmaf(a.y, alpha, b.y), fmaf(a.z, alpha, b.z),
                     fmaf(a.w, alpha, b.w));
}

// vec: elements [head, head + 4 n4) go as float4 (x + head, y + head and
// out + head are 16-byte aligned) and CTA 0 also takes [0, head) and
// [head + 4 n4, n) one at a time. Otherwise every element goes alone.
__global__ void __launch_bounds__(kThreads)
    triad_kernel(const float* x, const float* y, float* out, long long n, long long head,
                 long long n4, bool vec, float alpha) {
  const long long base = static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x;
  if (!vec) {
    float a[kPerThread], b[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long j = base + u * kThreads;
      if (j < n) a[u] = x[j], b[u] = y[j];
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long j = base + u * kThreads;
      if (j < n) out[j] = fmaf(a[u], alpha, b[u]);
    }
    return;
  }
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float4* y4 = reinterpret_cast<const float4*>(y + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  float4 a[kPerThread], b[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long j = base + u * kThreads;
    if (j < n4) a[u] = x4[j], b[u] = y4[j];
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long j = base + u * kThreads;
    if (j < n4) o4[j] = fma4(a[u], alpha, b[u]);
  }
  if (blockIdx.x == 0) {
    const long long tail = head + 4 * n4;
    if (threadIdx.x < head) out[threadIdx.x] = fmaf(x[threadIdx.x], alpha, y[threadIdx.x]);
    if (tail + threadIdx.x < n) {
      const long long j = tail + threadIdx.x;
      out[j] = fmaf(x[j], alpha, y[j]);
    }
  }
}

}  // namespace

// out = alpha * x + y over n floats on `stream` of CUDA device `device`. out
// may be x (in place) or y, but overlaps no input at an offset (the wrapper
// checks). Returns 0, kUnsupported, or the CUDA error of the launch.
extern "C" int triad(const float* x, const float* y, float* out, long long n, float alpha,
                     int device, void* stream) {
  if (n < 0) return kUnsupported;
  if (n == 0) return 0;
  const auto mis = [](const void* p) { return reinterpret_cast<unsigned long long>(p) & 15; };
  const bool vec = mis(x) == mis(y) && mis(x) == mis(out) && mis(x) % 4 == 0 && n >= 4;
  long long head = 0, n4 = 0;
  if (vec) {
    head = ((16 - mis(x)) & 15) / 4;
    n4 = (n - head) / 4;
  }
  const long long ctas = ((vec ? n4 : n) + kChunk - 1) / kChunk;
  if (ctas > 0x7fffffffLL) return kUnsupported;

  int previous = 0;
  cudaGetDevice(&previous);
  if (previous != device) cudaSetDevice(device);
  triad_kernel<<<static_cast<unsigned>(ctas > 0 ? ctas : 1), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, y, out, n, head, n4, vec, alpha);
  const int err = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return err;
}
