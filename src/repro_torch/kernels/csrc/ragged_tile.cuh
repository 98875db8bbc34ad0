// The tiled loop of the port's first expert-FFN kernels, now their fp32
// forms: grouped_mlp.cu, ragged_mlp.cu and fused_moe.cu (every bf16 kernel
// runs hopper.cuh's designs; the fp32 loops of flash_attention.cu and
// weight_grad.cu borrow load_tile).  The caller picks the expert: per grid z index in the capacity layout, per row
// block from block_to_expert in the ragged one.
//
// Ragged layout (the JAX package's MegaBlocks-style flat layout): A (R, K)
// rows grouped by expert, each expert's rows padded to the row-block size
// bm, so row block b belongs to expert b2e[b]; rows at or past *total_rows
// (read on the device, never on the host) are dead.  Capacity layout: A is
// one expert's (M, K) rows.  W (E, K, N) stacked per expert, or (E, N, K)
// when TRANS (the backward's w^T, read in place instead of being copied
// transposed).
//
// One block of 128 threads per (64-column N tile, tm-row M tile), tm <= 64:
// in the ragged layout tm = min(64, bm) with bm % tm == 0, so a block's rows
// never straddle two row blocks (two experts); in the capacity layout tm =
// min(64, M - m0).  A K loop stages a tm x 32 tile of A (rows past tm
// zero-filled) and a 32 x 64 tile of each weight in shared memory with
// 16-byte loads; the sums stay in registers, FMA on the CUDA cores, each
// thread a 4x8 sub-tile.
// A's rows may be gathered through a row map (row r of A is read as row
// map[r], none when map[r] < 0), which is how the fused kernel
// dispatches tokens without building the (R, d) buffer.  K and N must be
// multiples of 8 (the wrappers' rule for both dtypes) and the pointers
// 16-byte aligned; the wrappers check both.
//
// The epilogue is the caller's: it gets the fp32 tile (silu(a) * b already
// applied when NW == 2) in shared memory, tm x 64 at pitch CS_LD, and may
// store it with store_tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ragged {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int XS_LD = BK + 8;   // shared-memory pitches, padded against bank
constexpr int WS_LD = BN + 8;   // conflicts; multiples of 4 elements for the
constexpr int WT_LD = BK + 8;   // float4 reads
constexpr int CS_LD = BN + 4;
constexpr int W_TILE = (BK * WS_LD > BN * WT_LD) ? BK * WS_LD : BN * WT_LD;

__device__ __forceinline__ float silu(float a) { return a / (1.0f + expf(-a)); }

// Copy a rows x cols tile starting at (row0, col0) of a row-major matrix
// with leading dimension ld into shared memory, 16 bytes per thread-step;
// vectors past (row_lim, col_lim) are zero-filled.  With a row map, tile
// row r reads matrix row map[row0 + r] (nothing when it is negative).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* __restrict__ src,
                                          int ld, int rows, int cols, int row0, int col0,
                                          int row_lim, int col_lim,
                                          const int* __restrict__ map = nullptr) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int v = threadIdx.x; v < rows * per_row; v += THREADS) {
    const int r = v / per_row, c = (v % per_row) * VEC;
    const int gc = col0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_lim && gc < col_lim) {
      const int gr = map ? map[row0 + r] : row0 + r;
      if (gr >= 0) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    }
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = val;
  }
}

// Stage the weight tile for k0..k0+BK, n0..n0+BN of B = w (K, N), or of
// B = w^T with w (N, K) when TRANS (stored n-major, read col-major).
template <typename T, bool TRANS>
__device__ __forceinline__ void load_w(T* ws, const T* __restrict__ w, int K, int N, int k0,
                                       int n0) {
  if constexpr (TRANS)
    load_tile(ws, WT_LD, w, K, BN, BK, n0, k0, N, K);
  else
    load_tile(ws, WS_LD, w, N, BK, BN, k0, n0, K, N);
}

// The tile's fp32 result, silu(acc1) * acc3 when NW == 2, into cs (BM x
// CS_LD).  A: rows m0..m0+tm of a (R, K) matrix, through `map` if given.
template <int NW, bool TRANS>
__device__ void tile(const float* __restrict__ a, const int* __restrict__ map,
                     const float* __restrict__ w1, const float* __restrict__ w3, int m0, int tm,
                     int n0, int K, int N, float* cs) {
  __shared__ __align__(128) float xs[BM * XS_LD];
  __shared__ __align__(128) float ws[NW][W_TILE];
  const float* wp[2] = {w1, w3};

  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;  // rows ty*4.., cols tx*8..
  float acc[NW][4][8];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[w][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(xs, XS_LD, a, K, BM, BK, m0, k0, m0 + tm, K, map);
#pragma unroll
    for (int w = 0; w < NW; ++w) load_w<float, TRANS>(ws[w], wp[w], K, N, k0, n0);
    __syncthreads();
    if (ty * 4 < tm) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xs[(ty * 4 + i) * XS_LD + kk];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          float b[8];
          if constexpr (TRANS) {
#pragma unroll
            for (int j = 0; j < 8; ++j) b[j] = ws[w][(tx * 8 + j) * WT_LD + kk];
          } else {
            const float4 b0 = *reinterpret_cast<const float4*>(ws[w] + kk * WS_LD + tx * 8);
            const float4 b1 = *reinterpret_cast<const float4*>(ws[w] + kk * WS_LD + tx * 8 + 4);
            b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[w][i][j] = fmaf(av[i], b[j], acc[w][i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[0][i][j];
      if constexpr (NW == 2) v = silu(v) * acc[1][i][j];
      cs[(ty * 4 + i) * CS_LD + tx * 8 + j] = v;
    }
  __syncthreads();
}

// Store the tile's first tm rows, columns n0.. below N, of the fp32 tile cs
// into rows m0.. of the row-major (.., N) matrix out.
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float* cs, int m0,
                                           int tm, int n0, int N) {
  for (int idx = threadIdx.x; idx < tm * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    if (n0 + c < N) out[(size_t)(m0 + r) * N + n0 + c] = cs[r * CS_LD + c];
  }
}

}  // namespace ragged
