// The fused MoE expert leg for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_moe.py:105
// fused_moe (body _fused_kernel): over the ragged layout (R rows in bm-row
// blocks, block i of expert b2e[i], rows at or past *total_rows dead),
//   h[r]   = silu(x[src[r]] @ w1[e]) * (x[src[r]] @ w3[e])   fp32 sums, cast
//            to x's type (the TPU kernel's epilogue cast)
//   y[r]   = h[r] @ w2[e]                                    fp32
//   out[t] = sum over rows r with src[r] == t of wslot[r] * y[r]   fp32, then
//            cast to x's type
// Token rows are gathered straight from x through src, so the (R, d)
// dispatch buffer never exists.
//
// What differs from the TPU kernel, and why: it keeps a (bm, f) fp32
// accumulator pair and the whole (T, d) fp32 output resident in VMEM for
// the whole grid.  At Mixtral's f = 14336 neither fits the 227 KB of shared
// memory a Hopper block can have, and blocks run in no order.  So the leg is
// split at the point where the TPU kernel already rounds h to x's type:
//   1. up:    one block per (64 columns of f, tm rows): gather x rows
//             through src, both up-projections, silu * mul, h stored to an
//             (R, f) workspace in x's type;
//   2. down:  one block per (64 columns of d, tm rows): h @ w2[e] in fp32,
//             then each row's wslot-weighted y added into a zeroed (T, d)
//             fp32 output with atomicAdd;
//   3. cast:  the fp32 output to x's type (bf16 only; fp32 returns it).
// Dead blocks skip both products.  One call of the wrapper is one memset
// and these three launches.
//
// The combine is fp32 atomicAdd: exact on the training path, where the EP
// leg's slot map is (T_recv, 1) (each token has one row, so its sum is
// 0 + one term), and for K > 1 rows per token equal to the plain version's
// ascending-row sum up to fp32 reordering, held to tolerance.
//
// What bounds it on an H100: the tensor cores.  At the training path's
// shapes (T = 4096 received rows, R = 5120, d = 4096, f = 14336, bf16) the
// three products are 3 x 2 R d f = 1.80 TFLOP, 1.83 ms at 989 TFLOP/s,
// against 2.9 GB of weights and rows at 3.35 TB/s (0.86 ms).  This first
// kernel is the simple tiled loop of ragged_tile.cuh; PERF.md has its time.

#include "ragged_tile.cuh"

namespace {

using namespace ragged;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_up_kernel(const T* __restrict__ x, const int* __restrict__ src, const T* __restrict__ w1,
                const T* __restrict__ w3, const int* __restrict__ b2e,
                const int* __restrict__ total_rows, T* __restrict__ h, int d, int f, int bm,
                int tm) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const int m0 = blockIdx.y * tm, n0 = blockIdx.x * BN;
  if (m0 >= *total_rows) return;  // dead block: the down pass skips it too
  const size_t e = (size_t)b2e[m0 / bm];
  tile<T, 2, false>(x, src, w1 + e * d * f, w3 + e * d * f, m0, tm, n0, d, f, cs);
  store_tile(h, cs, m0, tm, n0, f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_down_kernel(const T* __restrict__ h, const int* __restrict__ src,
                  const T* __restrict__ wslot, const T* __restrict__ w2,
                  const int* __restrict__ b2e, const int* __restrict__ total_rows,
                  float* __restrict__ acc, int d, int f, int bm, int tm) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const int m0 = blockIdx.y * tm, n0 = blockIdx.x * BN;
  if (m0 >= *total_rows) return;
  const size_t e = (size_t)b2e[m0 / bm];
  tile<T, 1, false>(h, nullptr, w2 + e * f * d, nullptr, m0, tm, n0, f, d, cs);
  for (int idx = threadIdx.x; idx < tm * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int t = src[m0 + r];
    if (t >= 0 && n0 + c < d)
      atomicAdd(acc + (size_t)t * d + n0 + c,
                __fmul_rn(cs[r * CS_LD + c], to_f(wslot[m0 + r])));
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                 size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(in[i]);
}

template <typename T>
int launch(const void* x, const void* w1, const void* w3, const void* w2, const void* src,
           const void* wslot, const void* b2e, const void* total_rows, void* h, float* acc,
           void* out, int T_tok, int R, int d, int f, int bm, int tm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)T_tok * d * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  fused_up_kernel<T><<<dim3((f + BN - 1) / BN, R / tm), THREADS, 0, s>>>(
      (const T*)x, (const int*)src, (const T*)w1, (const T*)w3, (const int*)b2e,
      (const int*)total_rows, (T*)h, d, f, bm, tm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_down_kernel<T><<<dim3((d + BN - 1) / BN, R / tm), THREADS, 0, s>>>(
      (const T*)h, (const int*)src, (const T*)wslot, (const T*)w2, (const int*)b2e,
      (const int*)total_rows, acc, d, f, bm, tm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (out != nullptr) {
    const size_t n = (size_t)T_tok * d;
    cast_bf16_kernel<<<(unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, s>>>(
        acc, (__nv_bfloat16*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// the first CUDA error of the memset and launches (0 = all launched).
// h: (R, f) workspace in x's type; acc: (T, d) fp32 output; out: (T, d)
// bf16 (the bf16 entry point casts acc into it).
extern "C" int fused_moe_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                              const void* src, const void* wslot, const void* b2e,
                              const void* total_rows, void* h, void* acc, void* out, int T,
                              int R, int d, int f, int bm, int tm, void* stream) {
  return launch<__nv_bfloat16>(x, w1, w3, w2, src, wslot, b2e, total_rows, h, (float*)acc, out,
                               T, R, d, f, bm, tm, stream);
}

extern "C" int fused_moe_f32(const void* x, const void* w1, const void* w3, const void* w2,
                             const void* src, const void* wslot, const void* b2e,
                             const void* total_rows, void* h, void* acc, int T, int R, int d,
                             int f, int bm, int tm, void* stream) {
  return launch<float>(x, w1, w3, w2, src, wslot, b2e, total_rows, h, (float*)acc, nullptr, T,
                       R, d, f, bm, tm, stream);
}
