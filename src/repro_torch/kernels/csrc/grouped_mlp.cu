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
// Which dtype runs which kernel:
//   grouped_matmul, bf16: grouped_matmul_wgmma below, a weight stream.  A
//     persistent grid (one block per SM) walks (expert, 128-column N panel,
//     64-row M tile) tiles, M fastest, so the M tiles of a panel run side by
//     side and the panel is read from device memory once.  One producer
//     warp keeps an 8-stage ring of x (64 of K x 64 rows, through a 3-D
//     (E, M, K) tensor map, so rows past M and the K tail read as 0 and no
//     other expert's rows are read) and w (64 of K x 128 columns, N-major
//     64-column boxes read with the transpose bit) in flight by TMA: 8 x 16
//     KB of weights per SM, what HBM needs to stay busy, where the first
//     kernel kept a few KB.  One consumer warpgroup runs m64n128k16 wgmma,
//     one k-block's products in flight while the next stage is waited for;
//     the tensor cores are nearly idle at decode (< 0.03 ms of products).
//     At decode 8 x 32 = 256 tiles on 132 SMs are 97% balanced, so there is
//     no split-K and the output repeats bit for bit.  A second weight map
//     and accumulator set would give grouped_swiglu the same stream.
//   grouped_matmul, fp32, and grouped_swiglu, both dtypes: one block of
//     128 threads per (expert, 64-row M tile, 64-column N tile), the expert
//     from the grid's z index, running the tiled loop of ragged_tile.cuh on
//     that expert's rows and weights (WMMA bf16 / FMA fp32, no pipelining).
//     A 64-row M tile covers every row of a decode wave, so each weight byte
//     is read from device memory once per launch.  The M, N and K edges are
//     predicated (zero-filled in shared memory, never stored) instead of
//     padding the operands in device memory as the TPU kernel does.

#include "hopper.cuh"
#include "ragged_tile.cuh"

namespace {

// ---- bf16 grouped_matmul: a TMA weight stream into wgmma --------------------

namespace gs {

constexpr int BM = 64, BN = 128, BK = 64, STAGES = 8;
constexpr int THREADS = 128 + 32;               // one consumer warpgroup, then the producer warp
constexpr int A_BYTES = BM * BK * 2;            // x: 64 rows x 64 of K
constexpr int B_BOX = 64 * BK * 2;              // one 64-column box of N-major w
constexpr int STAGE = A_BYTES + BN * BK * 2;    // 24 KB
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
grouped_matmul_wgmma(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, __nv_bfloat16* __restrict__ out,
                     int E, int M, int K, int N) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  const int tiles = E * num_n * num_m, nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread starts every load
    if (threadIdx.x == 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % num_m) * BM, n0 = (t / num_m % num_n) * BN, e = t / (num_m * num_n);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* sa = smem + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          tma_load_3d(sa, &x_map, &full[s], kb * BK, m0, e);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(sa + A_BYTES + j * B_BOX, &w_map, &full[s], n0 + 64 * j, kb * BK, e);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % num_m) * BM, n0 = (t / num_m % num_n) * BN, e = t / (num_m * num_n);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* sa = smem + s * STAGE;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<1>(acc, desc_sw128(sa + kk * 32, 16, 1024),
                      desc_sw128(sa + A_BYTES + kk * 16 * 128, B_BOX, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-block's products are done
        fence_regs(acc);
        if (prev >= 0 && threadIdx.x == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && threadIdx.x == 0) mbar_arrive(&empty[prev]);
      // epilogue: bf16 pairs straight from the accumulator layout, rows
      // below M and columns below N
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * warp + lane / 4 + 8 * h;
        if (row >= M) continue;
        __nv_bfloat16* orow = out + ((size_t)e * M + row) * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

int launch(const void* x, const void* w, void* out, int E, int M, int K, int N,
           cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  int err = hopper::make_map(&x_map, x, 3, x_dims, x_strides, x_box);
  if (err) return err;
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, BK, 1};
  if ((err = hopper::make_map(&w_map, w, 3, w_dims, w_strides, w_box))) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = E * ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  grouped_matmul_wgmma<<<grid, THREADS, SMEM, stream>>>(x_map, w_map, (__nv_bfloat16*)out, E, M,
                                                        K, N);
  return (int)cudaGetLastError();
}

}  // namespace gs

// ---- fp32 grouped_matmul and grouped_swiglu: the tile loop of ragged_tile.cuh

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
// the first CUDA error of the set-up and the launch (0 = launched).

extern "C" int grouped_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                   int E, int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16, 2>(x, w1, w3, out, E, M, K, N, stream);
}

extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E, int M, int K,
                                   int N, void* stream) {
  return gs::launch(x, w, out, E, M, K, N, (cudaStream_t)stream);
}

extern "C" int grouped_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                  int E, int M, int K, int N, void* stream) {
  return launch<float, 2>(x, w1, w3, out, E, M, K, N, stream);
}

extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E, int M, int K,
                                  int N, void* stream) {
  return launch<float, 1>(x, w, nullptr, out, E, M, K, N, stream);
}
