// Ragged (MegaBlocks-style) grouped expert matmul and SwiGLU for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ragged_mlp.py over
// the ragged layout (R rows in bm-row blocks, block i of expert b2e[i], rows
// at or past *total_rows written as 0), fp32 sums cast to the input type:
//   ragged_matmul (:99, body _ragged_kernel):        out = x (R, K) @ w[e]
//   ragged_swiglu (:131, body _ragged_swiglu_kernel):
//                      out = silu(x @ w1[e]) * (x @ w3[e]), silu in fp32
// The three-launch EP leg runs ragged_swiglu then ragged_matmul forward, and
// its backward recomputes both up-projections with ragged_matmul; the fused
// leg's backward calls ragged_matmul five times per chunk (the recomputed
// up-projections, and the three products with a transposed weight, which it
// reads in place: TRANS).
//
// What bounds them on an H100: the tensor cores.  At the training path's
// shapes (R = 5120 rows, bm = 128, d = 4096, f = 14336, bf16) one
// ragged_matmul is 2 R K N = 601 GFLOP against 1.13 GB of operands (the
// weights 0.94 GB): 0.61 ms at the 989 TFLOP/s bf16 peak against 0.34 ms at
// 3.35 TB/s; ragged_swiglu is twice the products and the weights.  These
// first kernels are the simple tiled loop of ragged_tile.cuh (WMMA, no
// pipelining; ragged_swiglu is its two-weight form, silu * mul in the
// epilogue); they reach a small share of that bound, measured in PERF.md.
//
// Dead row blocks (at or past *total_rows, read on the device) skip their
// products and store zeros, so issued work follows the routed load.

#include "ragged_tile.cuh"

namespace {

using namespace ragged;

// NW = 1: x @ w[e]; NW = 2: silu(x @ w[e]) * (x @ w3[e]).
template <typename T, int NW, bool TRANS>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ w3,
              T* __restrict__ out, const int* __restrict__ b2e,
              const int* __restrict__ total_rows, int K, int N, int bm, int tm) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const int m0 = blockIdx.y * tm, n0 = blockIdx.x * BN;
  if (m0 < *total_rows) {
    const size_t e = (size_t)b2e[m0 / bm];
    tile<T, NW, TRANS>(x, nullptr, w + e * K * N, NW == 2 ? w3 + e * K * N : nullptr, m0, tm,
                       n0, K, N, cs);
  } else {
    for (int idx = threadIdx.x; idx < tm * BN; idx += THREADS)
      cs[(idx / BN) * CS_LD + idx % BN] = 0.0f;
    __syncthreads();
  }
  store_tile(out, cs, m0, tm, n0, N);
}

template <typename T>
int launch(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
           int R, int K, int N, int bm, int tm, int trans, void* stream) {
  const dim3 grid((N + BN - 1) / BN, R / tm);
  if (trans)
    ragged_kernel<T, 1, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)w, nullptr, (T*)out, (const int*)b2e, (const int*)total_rows, K,
        N, bm, tm);
  else
    ragged_kernel<T, 1, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)w, nullptr, (T*)out, (const int*)b2e, (const int*)total_rows, K,
        N, bm, tm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_swiglu(const void* x, const void* w1, const void* w3, void* out, const void* b2e,
                  const void* total_rows, int R, int K, int N, int bm, int tm, void* stream) {
  const dim3 grid((N + BN - 1) / BN, R / tm);
  ragged_kernel<T, 2, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const T*)w3, (T*)out, (const int*)b2e,
      (const int*)total_rows, K, N, bm, tm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() right after the launch (0 = launched).  w is (E, K, N),
// or (E, N, K) read as its transpose when trans != 0.
extern "C" int ragged_matmul_bf16(const void* x, const void* w, void* out, const void* b2e,
                                  const void* total_rows, int R, int K, int N, int bm, int tm,
                                  int trans, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, b2e, total_rows, R, K, N, bm, tm, trans, stream);
}

extern "C" int ragged_matmul_f32(const void* x, const void* w, void* out, const void* b2e,
                                 const void* total_rows, int R, int K, int N, int bm, int tm,
                                 int trans, void* stream) {
  return launch<float>(x, w, out, b2e, total_rows, R, K, N, bm, tm, trans, stream);
}

// w1, w3: (E, K, N).
extern "C" int ragged_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                  const void* b2e, const void* total_rows, int R, int K, int N,
                                  int bm, int tm, void* stream) {
  return launch_swiglu<__nv_bfloat16>(x, w1, w3, out, b2e, total_rows, R, K, N, bm, tm, stream);
}

extern "C" int ragged_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                 const void* b2e, const void* total_rows, int R, int K, int N,
                                 int bm, int tm, void* stream) {
  return launch_swiglu<float>(x, w1, w3, out, b2e, total_rows, R, K, N, bm, tm, stream);
}
