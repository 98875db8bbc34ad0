// AdamW and its clipping norm for Hopper (sm_90a), each element in one pass.
//
// Replaces, on the card, the plain path of src/repro_torch/optim/adamw.py:
// its sliced loop (about 14 PyTorch elementwise kernels per fp32 working
// slice) and global_norm's fp32 copy and squared copy of each gradient.
// That path moves about 152 bytes a bf16 parameter; the update itself needs
// 22 (g 2, p 2, m 4, v 4 read; p 2, m 4, v 4 written) and the norm 2 more,
// so at Mixtral-8x7B's 3.16e9 parameters of two layers the pair is bound by
// ~76 GB, 22.7 ms at 3.35 TB/s.
//
//   sumsq_partials  one launch over a table of gradients: each block sums
//                   the squares of its chunks, in fp32 within a chunk and in
//                   fp64 across them, and writes two partials (replicated
//                   tensors, sharded tensors) to its own slot; no atomics,
//                   so a rerun on the same grid gives the same bits
//   sumsq_finish    one block adds every slot's partials in a fixed order
//                   and writes the two sums as fp32
//   adamw_update    one launch over a table of (g, p, m, v), g and p of one
//                   type: reads each element once and writes p, m and v once
//
// The update uses the plain path's fp32 operations and rounding points, as
// PyTorch's CUDA elementwise kernels compute them, so that it is bit-equal
// to that path on the card:
//   gf  = g * scale                         (mul by a device 0-d tensor)
//   m   = fma(gf, 1-b1, m * b1)             (mul_(b1).add_(gf, alpha=1-b1))
//   v   = fma(gf * gf, 1-b2, v * b2)        (mul_(b2).addcmul_(gf, gf, value=1-b2))
//   den = sqrt(v / bc2) + eps               (div, sqrt_, add_(eps))
//   u   = (m / bc1) / den
//   u   = fma(pf, wd, u)                    (add_(pf, alpha=wd))
//   p   = fma(u, -lr, pf)                   (add_(u, alpha=-lr)), rounded to p's type
// PyTorch's `a + b * alpha` contracts into one fma under nvcc's default
// -fmad=true; here each step is written with its explicit intrinsic
// (__fmaf_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn), so neither
// contraction nor fast-math can move a bit.  A missing gradient (null g)
// is a zero gradient: gf = 0 and weight decay still applies.
//
// Bytes decide the speed.  A thread moves 16-byte vectors (8 bf16 or 4
// fp32 parameters, the moments two or one float4 each) with streaming cache
// hints (__ldcs / __stcs: nothing is read twice), over chunks of CHUNK
// elements that the grid strides through, table entry by table entry.  A
// tensor any of whose four pointers is off a 16-byte boundary takes the
// scalar loop whole; a chunk's tail past its last full vector takes it too.
// The table (at most MAX_TENSORS entries, passed by value as the kernel's
// __grid_constant__ parameter) lets one launch cover every tensor of one
// type (a gradient has its parameter's type: autograd gives it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TENSORS = 64;   // entries of a launch's table
constexpr int THREADS = 256;
constexpr int CHUNK = 16384;      // elements a block takes at a time
constexpr int FLAG_VECTOR = 1;    // every pointer 16-byte aligned
constexpr int FLAG_SHARDED = 2;   // the norm: an EP-sharded tensor

struct Table {
  const void* g[MAX_TENSORS];     // null: a missing gradient
  void* p[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  long long n[MAX_TENSORS];
  int first[MAX_TENSORS + 1];     // first chunk of each entry; first[count]: all
  unsigned char flags[MAX_TENSORS];
  int count;
};

// the host's description: per entry g, p, m, v, n, flags as int64
int fill(Table& t, const long long* desc, int count) {
  if (count < 0 || count > MAX_TENSORS) return -1;
  t.count = count;
  t.first[0] = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 6 * i;
    t.g[i] = (const void*)d[0];
    t.p[i] = (void*)d[1];
    t.m[i] = (float*)d[2];
    t.v[i] = (float*)d[3];
    t.n[i] = d[4];
    t.flags[i] = (unsigned char)d[5];
    t.first[i + 1] = t.first[i] + (int)((d[4] + CHUNK - 1) / CHUNK);
  }
  return 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* o) { *o = __float2bfloat16_rn(x); }

// N consecutive values as fp32, streamed: N * sizeof(T) is 16 or 32 bytes
template <int N>
__device__ __forceinline__ void load(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p) + i);
    o[4 * i] = a.x; o[4 * i + 1] = a.y; o[4 * i + 2] = a.z; o[4 * i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
  static_assert(N == 8, "bf16 in vectors of 8");
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void store(float* p, const float* o) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    __stcs(reinterpret_cast<float4*>(p) + i,
           make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]));
}
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* o) {
  static_assert(N == 8, "bf16 in vectors of 8");
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), raw);
}

struct Hyper {
  float b1, a1, b2, a2, eps, wd, neg_lr;   // a1 = 1 - b1, a2 = 1 - b2
};

// one element: gf the scaled gradient (0 when missing); m, v updated in
// place; returns the new parameter in fp32
__device__ __forceinline__ float adamw(float gf, float& m, float& v, float pf, float c1,
                                       float c2, const Hyper& h) {
  m = __fmaf_rn(gf, h.a1, __fmul_rn(m, h.b1));
  v = __fmaf_rn(__fmul_rn(gf, gf), h.a2, __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, c1), den);
  u = __fmaf_rn(pf, h.wd, u);
  return __fmaf_rn(u, h.neg_lr, pf);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const __grid_constant__ Table t, const float* __restrict__ scale,
             const float c1, const float c2, const Hyper h) {
  constexpr int VEC = 16 / sizeof(T);
  const float s = *scale;
  int e = 0;
  for (int c = blockIdx.x; c < t.first[t.count]; c += gridDim.x) {
    while (t.first[e + 1] <= c) ++e;
    const long long lo = (long long)(c - t.first[e]) * CHUNK;
    const long long hi = min(lo + CHUNK, t.n[e]);
    const T* g = static_cast<const T*>(t.g[e]);
    T* p = static_cast<T*>(t.p[e]);
    float* m = t.m[e];
    float* v = t.v[e];
    long long i0 = lo;
    if (t.flags[e] & FLAG_VECTOR) {
      const long long nv = (hi - lo) / VEC;
      for (long long k = threadIdx.x; k < nv; k += THREADS) {
        const long long i = lo + k * VEC;
        float gv[VEC], pv[VEC], mv[VEC], vv[VEC];
        if (g) {
          load<VEC>(g + i, gv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) gv[j] = __fmul_rn(gv[j], s);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) gv[j] = 0.0f;
        }
        load<VEC>(p + i, pv);
        load<VEC>(m + i, mv);
        load<VEC>(v + i, vv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) pv[j] = adamw(gv[j], mv[j], vv[j], pv[j], c1, c2, h);
        store<VEC>(m + i, mv);
        store<VEC>(v + i, vv);
        store<VEC>(p + i, pv);
      }
      i0 = lo + nv * VEC;
    }
    for (long long i = i0 + threadIdx.x; i < hi; i += THREADS) {
      const float gf = g ? __fmul_rn(to_f(g[i]), s) : 0.0f;
      float mi = m[i], vi = v[i];
      const float pn = adamw(gf, mi, vi, to_f(p[i]), c1, c2, h);
      m[i] = mi;
      v[i] = vi;
      from_f(pn, p + i);
    }
  }
}

// the block's sum of `x` over its threads, in fp64, valid in thread 0
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_down_sync(0xffffffffu, x, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = x;
  __syncthreads();
  x = 0.0;
  if (threadIdx.x < 32) {
    x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  __syncthreads();
  return x;
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const __grid_constant__ Table t, double* __restrict__ partials) {
  constexpr int VEC = 16 / sizeof(G);
  double acc[2] = {0.0, 0.0};     // replicated, sharded
  int e = 0;
  for (int c = blockIdx.x; c < t.first[t.count]; c += gridDim.x) {
    while (t.first[e + 1] <= c) ++e;
    const long long lo = (long long)(c - t.first[e]) * CHUNK;
    const long long hi = min(lo + CHUNK, t.n[e]);
    const G* g = static_cast<const G*>(t.g[e]);
    float sq = 0.0f;
    long long i0 = lo;
    if (t.flags[e] & FLAG_VECTOR) {
      const long long nv = (hi - lo) / VEC;
      for (long long k = threadIdx.x; k < nv; k += THREADS) {
        float x[VEC];
        load<VEC>(g + lo + k * VEC, x);
#pragma unroll
        for (int j = 0; j < VEC; ++j) sq = __fmaf_rn(x[j], x[j], sq);
      }
      i0 = lo + nv * VEC;
    }
    for (long long i = i0 + threadIdx.x; i < hi; i += THREADS) {
      const float x = to_f(g[i]);
      sq = __fmaf_rn(x, x, sq);
    }
    acc[(t.flags[e] & FLAG_SHARDED) ? 1 : 0] += (double)sq;
  }
  const double rep = block_sum(acc[0]);
  const double shd = block_sum(acc[1]);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = rep;
    partials[2 * blockIdx.x + 1] = shd;
  }
}

__global__ void __launch_bounds__(THREADS)
sumsq_finish_kernel(const double* __restrict__ partials, int n, float* __restrict__ rep,
                    float* __restrict__ shd) {
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  a = block_sum(a);
  b = block_sum(b);
  if (threadIdx.x == 0) {
    *rep = (float)a;
    *shd = (float)b;
  }
}

template <typename T>
int update(const long long* desc, int count, const void* scale, float bc1, float bc2,
           float b1, float a1, float b2, float a2, float eps, float wd, float neg_lr,
           int grid, void* stream) {
  Table t;
  if (fill(t, desc, count) != 0) return (int)cudaErrorInvalidValue;
  const int chunks = t.first[count];
  if (chunks == 0) return 0;
  const Hyper h{b1, a1, b2, a2, eps, wd, neg_lr};
  adamw_kernel<T><<<grid < chunks ? grid : chunks, THREADS, 0, (cudaStream_t)stream>>>(
      t, (const float*)scale, bc1, bc2, h);
  return (int)cudaGetLastError();
}

template <typename G>
int partials(const long long* desc, int count, void* out, int grid, void* stream) {
  Table t;
  if (fill(t, desc, count) != 0) return (int)cudaErrorInvalidValue;
  sumsq_kernel<G><<<grid, THREADS, 0, (cudaStream_t)stream>>>(t, (double*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() right after the launch (0 = launched).  `desc` is a
// host array of 6 int64 per table entry (g, p, m, v, n, flags; the norm
// reads g, n and flags); `scale` is a 0-d fp32 tensor on the device, read
// there, so the host never waits for it; the bias corrections `bc1`, `bc2`
// depend only on the step, so the host passes their fp32 values.  The
// update's symbol names the type of the parameters and gradients.  sumsq_partials
// always launches `grid` blocks and writes 2 * grid fp64 partials;
// sumsq_finish adds `n` such pairs.

#define ADAMW_UPDATE(NAME, T)                                                            \
  extern "C" int NAME(const long long* desc, int count, const void* scale, float bc1,    \
                      float bc2, float b1, float a1, float b2, float a2, float eps,      \
                      float wd, float neg_lr, int grid, void* stream) {                  \
    return update<T>(desc, count, scale, bc1, bc2, b1, a1, b2, a2, eps, wd, neg_lr, grid, \
                     stream);                                                            \
  }

ADAMW_UPDATE(adamw_update_bf16, __nv_bfloat16)
ADAMW_UPDATE(adamw_update_f32, float)

extern "C" int sumsq_partials_bf16(const long long* desc, int count, void* out, int grid,
                                   void* stream) {
  return partials<__nv_bfloat16>(desc, count, out, grid, stream);
}

extern "C" int sumsq_partials_f32(const long long* desc, int count, void* out, int grid,
                                  void* stream) {
  return partials<float>(desc, count, out, grid, stream);
}

extern "C" int sumsq_finish(const void* partials, int n, void* rep, void* shd, void* stream) {
  sumsq_finish_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((const double*)partials, n,
                                                                (float*)rep, (float*)shd);
  return (int)cudaGetLastError();
}
