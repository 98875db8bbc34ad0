// Token dispatch and combine for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/dispatch_pallas.py:
//   scatter_rows   (:63, body _scatter_kernel)
//       out[r] = w[r] * x[src[r]]   (R, d), fp32 product cast to x's type;
//       0 where src[r] < 0 or r >= *total_rows
//   gather_combine (:127, body _gather_kernel)
//       out[t] = sum_k w[t, k] * buf[slots[t, k]]   (T, d), summed in fp32
//       for k = 0..K-1 in order, skipping slots < 0, cast to buf's type
// Each is the other's transpose: the training path's backward of one is the
// other (kernels/ops.py).  *total_rows is read on the device, so a caller
// never waits on the host for the routed load.
//
// What bounds it on an H100: bytes.  Each output row is one input row (or K
// of them) moved once: at the training path's shapes (R = 4096 rows of
// d = 4096 bf16) scatter_rows moves 2 x 33.6 MB, about 0.02 ms at 3.35 TB/s.
//
// Design: one block of 128 threads per output row; each thread moves
// 16-byte vectors along d (8 bf16 or 4 fp32 values), converts to fp32, and
// scales/accumulates with explicitly rounded multiplies and adds
// (__fmul_rn / __fadd_rn), so no contraction into an FMA changes a bit
// against the plain version.  The TPU kernels keep the whole source in VMEM
// and loop over the rows of an output block; here the L2 cache holds the
// source and the rows of a block are the grid.  d must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// one 16-byte vector of bf16 or fp32 values, to and from fp32
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void load(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const int* __restrict__ total_rows, const T* __restrict__ w,
                    T* __restrict__ out, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int r = blockIdx.x;
  const int s = src[r];
  const bool live = s >= 0 && r < *total_rows;
  const float scale = (live && w) ? to_f(w[r]) : 1.0f;
  T* o = out + (size_t)r * d;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
    float v[VEC];
    if (live) {
      load(x + (size_t)s * d + c, v);
      if (w) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __fmul_rn(v[i], scale);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
    }
    store(o + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_combine_kernel(const T* __restrict__ buf, const int* __restrict__ slots,
                      const T* __restrict__ w, T* __restrict__ out, int K, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int t = blockIdx.x;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int s = slots[(size_t)t * K + k];
      if (s < 0) continue;
      float v[VEC];
      load(buf + (size_t)s * d + c, v);
      const float wk = w ? to_f(w[(size_t)t * K + k]) : 1.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], w ? __fmul_rn(v[i], wk) : v[i]);
    }
    store(out + (size_t)t * d + c, acc);
  }
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() right after the launch (0 = launched).  A null weight
// pointer means no weights (scale 1).

extern "C" int scatter_rows_bf16(const void* x, const void* src, const void* total_rows,
                                 const void* w, void* out, int R, int d, void* stream) {
  scatter_rows_kernel<__nv_bfloat16><<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)src, (const int*)total_rows,
      (const __nv_bfloat16*)w, (__nv_bfloat16*)out, d);
  return (int)cudaGetLastError();
}

extern "C" int scatter_rows_f32(const void* x, const void* src, const void* total_rows,
                                const void* w, void* out, int R, int d, void* stream) {
  scatter_rows_kernel<float><<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)src, (const int*)total_rows, (const float*)w, (float*)out,
      d);
  return (int)cudaGetLastError();
}

extern "C" int gather_combine_bf16(const void* buf, const void* slots, const void* w,
                                   void* out, int T, int K, int d, void* stream) {
  gather_combine_kernel<__nv_bfloat16><<<T, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)buf, (const int*)slots, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)out, K, d);
  return (int)cudaGetLastError();
}

extern "C" int gather_combine_f32(const void* buf, const void* slots, const void* w, void* out,
                                  int T, int K, int d, void* stream) {
  gather_combine_kernel<float><<<T, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)buf, (const int*)slots, (const float*)w, (float*)out, K, d);
  return (int)cudaGetLastError();
}
