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
// d = 4096 bf16) scatter_rows reads 16.8 MB and writes 33.6 MB, at least
// 0.015 ms at 3.35 TB/s, so what decides its speed is how many bytes each SM
// keeps in flight and how little else a block does.
//
// scatter_rows: one warp per output row, four rows a block.  A lane holds
// 8 of its row's 16-byte vectors in registers and issues all 8 loads before
// its first store, so a warp keeps 4 KB of its row in flight (a d = 4096
// bf16 row takes two such rounds).  Dead rows (src[r] < 0 or r >=
// *total_rows) read nothing and store zeros.  The stores stream past the
// L2 cache (st.global.cs, evict first), so the larger output does not push
// out the source rows that a token's other copies (top-k > 1) read again.
// Chosen by timing variants on the H100 at the path's two shapes: 4 or 16
// vectors a lane and 8 rows a block were slower, and plain stores much
// slower where sources repeat; one 128-thread block per row, each thread
// storing a vector before loading the next, kept too few bytes in flight.
// A bulk async copy (cp.async.bulk through shared memory) would spare the
// registers, but it cannot scale a row, and registers already keep enough
// in flight.
//
// gather_combine: one block of 128 threads per output row; each thread
// moves 16-byte vectors along d and sums its K slot rows in fp32.
//
// Both convert to fp32 and scale/accumulate with explicitly rounded
// multiplies and adds (__fmul_rn / __fadd_rn), so no contraction into an
// FMA changes a bit against the plain version; an unweighted scatter copies
// the bits.  The TPU kernels keep the whole source in VMEM and loop over the
// rows of an output block; here the L2 cache holds the source and the rows
// of a block are the grid.  d must be a multiple of 8.

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

// a 16-byte vector of bf16 or fp32 values times scale, rounded once
__device__ __forceinline__ uint4 scaled(uint4 raw, float scale, const __nv_bfloat16*) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
  }
  return raw;
}
__device__ __forceinline__ uint4 scaled(uint4 raw, float scale, const float*) {
  float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __fmul_rn(f[i], scale);
  return raw;
}

constexpr int ROW_WARPS = 4;   // scatter_rows: rows (one warp each) a block
constexpr int UNROLL = 8;      // 16-byte vectors a lane keeps in flight

template <typename T>
__global__ void __launch_bounds__(32 * ROW_WARPS)
scatter_rows_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    const int* __restrict__ total_rows, int rows, const T* __restrict__ w,
                    T* __restrict__ out, int R, int d) {
  const int r = blockIdx.x * ROW_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const int s = src[r];
  const bool live = s >= 0 && r < (total_rows ? *total_rows : rows);
  const bool scale_row = live && w != nullptr;
  const float scale = scale_row ? to_f(w[r]) : 1.0f;
  const int nv = d / (16 / (int)sizeof(T));
  const uint4* in = reinterpret_cast<const uint4*>(x + (size_t)(live ? s : 0) * d);
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)r * d);
  for (int c0 = lane; c0 < nv; c0 += 32 * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int c = c0 + 32 * i;
      v[i] = live && c < nv ? __ldg(in + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int c = c0 + 32 * i;
      if (c < nv) __stcs(o + c, scale_row ? scaled(v[i], scale, x) : v[i]);
    }
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
// pointer means no weights (scale 1).  scatter_rows reads the live rows from
// the device at total_rows, or, when that pointer is null, takes the host's
// count `rows` (no device tensor, so no fill kernel, for a count the caller
// knows).

extern "C" int scatter_rows_bf16(const void* x, const void* src, const void* total_rows, int rows,
                                 const void* w, void* out, int R, int d, void* stream) {
  scatter_rows_kernel<__nv_bfloat16>
      <<<(R + ROW_WARPS - 1) / ROW_WARPS, 32 * ROW_WARPS, 0, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)x, (const int*)src, (const int*)total_rows, rows,
          (const __nv_bfloat16*)w, (__nv_bfloat16*)out, R, d);
  return (int)cudaGetLastError();
}

extern "C" int scatter_rows_f32(const void* x, const void* src, const void* total_rows, int rows,
                                const void* w, void* out, int R, int d, void* stream) {
  scatter_rows_kernel<float>
      <<<(R + ROW_WARPS - 1) / ROW_WARPS, 32 * ROW_WARPS, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const int*)src, (const int*)total_rows, rows, (const float*)w,
          (float*)out, R, d);
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
