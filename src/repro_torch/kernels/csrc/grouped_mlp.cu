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
// one block of 128 threads per (expert, 64-row M tile, 64-column N tile).
// A K loop stages a 64x32 tile of x and a 32x64 tile of each weight in
// shared memory with 16-byte loads and keeps the fp32 accumulators in
// registers.  A 64-row M tile covers every row of a decode wave, so each
// weight byte is read from device memory once per launch.  The M, N and K
// edges are predicated (zero-filled in shared memory, never stored) instead
// of padding the operands in device memory as the TPU kernel does.
//   bf16: WMMA 16x16x16 on the tensor cores, each warp a 32x32 sub-tile
//         (warps whose rows all lie past M skip their products).
//   fp32: FMA on the CUDA cores, each thread a 4x8 sub-tile.
// The SwiGLU variant keeps two accumulators and applies silu in the epilogue
// before the single cast.  K and N must be multiples of 8 (one 16-byte
// vector of bf16) and the pointers 16-byte aligned; the wrapper checks both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int XS_LD = BK + 8;  // shared-memory row pitches, padded against
constexpr int WS_LD = BN + 8;  // bank conflicts; multiples of 8 elements
constexpr int CS_LD = BN + 4;  // as WMMA requires (4 for fp32)

__device__ __forceinline__ float silu(float a) { return a / (1.0f + expf(-a)); }

// Copy a rows x cols tile starting at (row0, col0) of a row-major matrix
// with leading dimension ld into shared memory, 16 bytes per thread-step;
// vectors past (row_lim, col_lim) are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* __restrict__ src,
                                          int ld, int rows, int cols, int row0, int col0,
                                          int row_lim, int col_lim) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int v = threadIdx.x; v < rows * per_row; v += THREADS) {
    const int r = v / per_row, c = (v % per_row) * VEC;
    const int gr = row0 + r, gc = col0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < row_lim && gc < col_lim)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = val;
  }
}

// NW = number of weight matrices: 1 -> grouped_matmul, 2 -> grouped_swiglu.
template <int NW>
__global__ void __launch_bounds__(THREADS)
grouped_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ w3, __nv_bfloat16* __restrict__ out,
                    int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(128) __nv_bfloat16 ws[NW][BK * WS_LD];
  __shared__ __align__(128) float cs[BM * CS_LD];

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* wp[NW];
  x += (size_t)e * M * K;
  wp[0] = w1 + (size_t)e * K * N;
  if constexpr (NW == 2) wp[1] = w3 + (size_t)e * K * N;
  out += (size_t)e * M * N;

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const bool live = m0 + wm < M;  // warp-uniform: rows past M need no products

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2][2];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[w][i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(xs, XS_LD, x, K, BM, BK, m0, k0, M, K);
#pragma unroll
    for (int w = 0; w < NW; ++w) load_tile(ws[w], WS_LD, wp[w], N, BK, BN, k0, n0, K, N);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * XS_LD + kk, XS_LD);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, ws[w] + kk * WS_LD + wn + 16 * j, WS_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[w][i][j], a[i], b, acc[w][i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: fragments of one type share their element mapping, so silu(a)*b
  // is taken element by element in registers before the fp32 tile is staged
  if (live) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (NW == 2) {
#pragma unroll
          for (int t = 0; t < acc[0][i][j].num_elements; ++t)
            acc[0][i][j].x[t] = silu(acc[0][i][j].x[t]) * acc[1][i][j].x[t];
        }
        wmma::store_matrix_sync(cs + (wm + 16 * i) * CS_LD + wn + 16 * j, acc[0][i][j], CS_LD,
                                wmma::mem_row_major);
      }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    if (m0 + r < M && n0 + c < N)
      out[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(cs[r * CS_LD + c]);
  }
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
grouped_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w3, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(128) float xs[BM * XS_LD];
  __shared__ __align__(128) float ws[NW][BK * WS_LD];

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* wp[NW];
  x += (size_t)e * M * K;
  wp[0] = w1 + (size_t)e * K * N;
  if constexpr (NW == 2) wp[1] = w3 + (size_t)e * K * N;
  out += (size_t)e * M * N;

  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;  // rows ty*4.., cols tx*8..
  float acc[NW][4][8];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[w][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(xs, XS_LD, x, K, BM, BK, m0, k0, M, K);
#pragma unroll
    for (int w = 0; w < NW; ++w) load_tile(ws[w], WS_LD, wp[w], N, BK, BN, k0, n0, K, N);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * XS_LD + kk];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 b0 = *reinterpret_cast<const float4*>(ws[w] + kk * WS_LD + tx * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(ws[w] + kk * WS_LD + tx * 8 + 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[w][i][j] = fmaf(a[i], b[j], acc[w][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (NW == 2) v = silu(v) * acc[1][i][j];
      out[(size_t)m * N + n] = v;
    }
  }
}

dim3 grid_for(int E, int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, E); }

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() right after the launch (0 = launched).

extern "C" int grouped_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                   int E, int M, int K, int N, void* stream) {
  grouped_bf16_kernel<2><<<grid_for(E, M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1, (const __nv_bfloat16*)w3,
      (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E, int M, int K,
                                   int N, void* stream) {
  grouped_bf16_kernel<1><<<grid_for(E, M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, nullptr, (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int grouped_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                  int E, int M, int K, int N, void* stream) {
  grouped_f32_kernel<2><<<grid_for(E, M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)w3, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E, int M, int K,
                                  int N, void* stream) {
  grouped_f32_kernel<1><<<grid_for(E, M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, nullptr, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}
