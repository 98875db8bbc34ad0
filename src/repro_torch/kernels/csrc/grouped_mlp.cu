// Grouped (per-expert) matmul and fused SwiGLU for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's capacity-layout
// expert FFN (src/repro/kernels/grouped_mlp.py):
//   grouped_swiglu  out[e] = silu(x[e] @ w1[e]) * (x[e] @ w3[e])
//   grouped_matmul  out[e] = x[e] @ w[e]
// with x (E, M, K), w (E, K, N), out (E, M, N), all row-major and contiguous,
// both sums in fp32, silu in fp32, the result cast to the input type.
//
// What bounds it on an H100: the expert weights.  At decode M is the number
// of occupied slots (a handful of rows per expert after the batch rows are
// folded into M), so every weight byte is used for a few multiply-adds only:
// the up-projections of one Mixtral-8x7B layer read 2 x 8 x 4096 x 14336 x 2 B
// = 1.88 GB and the down-projection 0.94 GB, i.e. at least 0.56 ms and
// 0.28 ms at 3.35 TB/s, against well under 0.1 ms of tensor-core work.
//
// Design (simple and right first; TMA, wgmma and pipelining are later work):
// one block of 128 threads per (expert, 64-row M tile, 64-column N tile),
// the expert from the grid's z index, running the tiled loop of
// ragged_tile.cuh on that expert's rows and weights.  A 64-row M tile covers
// every row of a decode wave, so each weight byte is read from device memory
// once per launch.  The M, N and K edges are predicated (zero-filled in
// shared memory, never stored) instead of padding the operands in device
// memory as the TPU kernel does.

#include "ragged_tile.cuh"

namespace {

using namespace ragged;

// NW = number of weight matrices: 1 -> grouped_matmul, 2 -> grouped_swiglu.
template <typename T, int NW>
__global__ void __launch_bounds__(THREADS)
grouped_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w3,
               T* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const size_t e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tm = min(BM, M - m0);
  tile<T, NW, false>(x + e * M * K, nullptr, w1 + e * K * N,
                     NW == 2 ? w3 + e * K * N : nullptr, m0, tm, n0, K, N, cs);
  store_tile(out + e * M * N, cs, m0, tm, n0, N);
}

template <typename T, int NW>
int launch(const void* x, const void* w1, const void* w3, void* out, int E, int M, int K, int N,
           void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  grouped_kernel<T, NW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const T*)w3, (T*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() right after the launch (0 = launched).

extern "C" int grouped_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                   int E, int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16, 2>(x, w1, w3, out, E, M, K, N, stream);
}

extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E, int M, int K,
                                   int N, void* stream) {
  return launch<__nv_bfloat16, 1>(x, w, nullptr, out, E, M, K, N, stream);
}

extern "C" int grouped_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                  int E, int M, int K, int N, void* stream) {
  return launch<float, 2>(x, w1, w3, out, E, M, K, N, stream);
}

extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E, int M, int K,
                                  int N, void* stream) {
  return launch<float, 1>(x, w, nullptr, out, E, M, K, N, stream);
}
