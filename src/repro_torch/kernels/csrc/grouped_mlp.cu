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
//   bf16, both functions: grouped_wgmma<NW> below, a weight stream of NW
//     weights (1: grouped_matmul, 2: grouped_swiglu).  A persistent grid
//     (one block per SM) walks (expert, 128-column N panel, 64-row M tile)
//     tiles, M fastest, so the M tiles of a panel run side by side and the
//     panel is read from device memory once.  One producer warp keeps a
//     ring of stages in flight by TMA; a stage holds one x box (64 of K x
//     64 rows, through a 3-D (E, M, K) tensor map, so rows past M and the
//     K tail read as 0 and no other expert's rows are read) and the same
//     128 columns of each weight (N-major 64-column boxes read with the
//     transpose bit), so both products of grouped_swiglu share the x box.
//     Stages: 8 of 24 KB for one weight, 5 of 40 KB for two: 128 and 160
//     KB of weights in flight per SM, what HBM needs to stay busy (the tile
//     loop below keeps a few KB).  One consumer warpgroup runs m64n128k16
//     wgmma into NW accumulator sets (64 fp32 a thread each), one k-block's
//     products in flight while the next stage is waited for; a stage is
//     released only after wgmma.wait_group says its products are done.  At
//     decode the tensor cores are lightly loaded: even padded to 64 rows,
//     grouped_swiglu's products take ~0.12 ms at the bf16 rate, overlapped
//     with the stream.  The epilogue works from the accumulator registers: grouped_swiglu's
//     silu(a) * b in fp32 (ragged::silu, as the other SwiGLU kernels), one
//     rounding to bf16, pairs of columns stored; rows at or past M and
//     columns at or past N are never stored.  At decode grouped_matmul has
//     8 x 32 = 256 tiles and grouped_swiglu 8 x 112 = 896 on 132 SMs, 97%
//     balanced either way, so there is no split-K and the output repeats
//     bit for bit.
//   fp32, both functions: one block of 128 threads per (expert, 64-row M
//     tile, 64-column N tile), the expert from the grid's z index, running
//     the tiled loop of ragged_tile.cuh on that expert's rows and weights
//     (FMA, no pipelining).  No full-width path runs fp32; the reduced
//     model's check on the card does.  The M, N and K edges are predicated
//     (zero-filled in shared memory, never stored) instead of padding the
//     operands in device memory as the TPU kernel does.

#include "hopper.cuh"
#include "ragged_tile.cuh"

namespace {

// ---- bf16: a TMA weight stream into wgmma -----------------------------------

namespace gs {

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int THREADS = 128 + 32;               // one consumer warpgroup, then the producer warp
constexpr int A_BYTES = BM * BK * 2;            // x: 64 rows x 64 of K
constexpr int B_BOX = 64 * BK * 2;              // one 64-column box of N-major w
constexpr int B_BYTES = BN * BK * 2;            // one weight's 128 columns: 16 KB

template <int NW>
struct Cfg {
  static constexpr int STAGE = A_BYTES + NW * B_BYTES;       // 24 or 40 KB
  static constexpr int STAGES = NW == 1 ? 8 : 5;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// out[e] = x[e] @ w[e] (NW 1), or bf16(silu(x[e] @ w[e]) * (x[e] @ w3[e]))
// (NW 2; w3_map is unused for NW 1)
template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap w3_map, __nv_bfloat16* __restrict__ out, int E,
              int M, int K, int N) {
  using namespace hopper;
  using C = Cfg<NW>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
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
          uint8_t* sa = smem + s * C::STAGE;
          mbar_expect_tx(&full[s], C::STAGE);
          tma_load_3d(sa, &x_map, &full[s], kb * BK, m0, e);
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(sa + A_BYTES + w * B_BYTES + j * B_BOX, w == 0 ? &w_map : &w3_map,
                          &full[s], n0 + 64 * j, kb * BK, e);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float acc[NW][BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % num_m) * BM, n0 = (t / num_m % num_n) * BN, e = t / (num_m * num_n);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[w][i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* sa = smem + s * C::STAGE;
#pragma unroll
        for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_sw128(sa + kk * 32, 16, 1024);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            wgmma_ss<1>(acc[w], da,
                        desc_sw128(sa + A_BYTES + w * B_BYTES + kk * 16 * 128, B_BOX, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-block's products are done
#pragma unroll
        for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
        if (prev >= 0 && threadIdx.x == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
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
          const int col = n0 + 8 * j + 2 * (lane % 4), i = 4 * j + 2 * h;
          if (col >= N) continue;
          const __nv_bfloat162 v =
              NW == 1 ? __floats2bfloat162_rn(acc[0][i], acc[0][i + 1])
                      : __floats2bfloat162_rn(ragged::silu(acc[0][i]) * acc[NW - 1][i],
                                              ragged::silu(acc[0][i + 1]) * acc[NW - 1][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
        }
      }
    }
  }
}

// w (E, K, N), loaded N-major in 64-column x BK boxes
int map_weight(CUtensorMap* map, const void* w, int E, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  return hopper::make_map(map, w, 3, dims, strides, box);
}

// w3 is null for NW 1
template <int NW>
int launch(const void* x, const void* w, const void* w3, void* out, int E, int M, int K, int N,
           cudaStream_t stream) {
  CUtensorMap x_map, w_map, w3_map;
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  int err = hopper::make_map(&x_map, x, 3, x_dims, x_strides, x_box);
  if (err || (err = map_weight(&w_map, w, E, K, N))) return err;
  if ((err = map_weight(&w3_map, NW == 2 ? w3 : w, E, K, N))) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      grouped_wgmma<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<NW>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = E * ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  grouped_wgmma<NW><<<grid, THREADS, Cfg<NW>::SMEM, stream>>>(
      x_map, w_map, w3_map, (__nv_bfloat16*)out, E, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace gs

// ---- fp32: the tile loop of ragged_tile.cuh

using namespace ragged;

// NW = number of weight matrices: 1 -> grouped_matmul, 2 -> grouped_swiglu.
template <int NW>
__global__ void __launch_bounds__(THREADS)
grouped_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ w3, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const size_t e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tm = min(BM, M - m0);
  tile<NW, false>(x + e * M * K, nullptr, w1 + e * K * N, NW == 2 ? w3 + e * K * N : nullptr, m0,
                  tm, n0, K, N, cs);
  store_tile(out + e * M * N, cs, m0, tm, n0, N);
}

template <int NW>
int launch_f32(const void* x, const void* w1, const void* w3, void* out, int E, int M, int K,
               int N, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  grouped_kernel<NW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)w3, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// the first CUDA error of the set-up and the launch (0 = launched).

extern "C" int grouped_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                   int E, int M, int K, int N, void* stream) {
  return gs::launch<2>(x, w1, w3, out, E, M, K, N, (cudaStream_t)stream);
}

extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E, int M, int K,
                                   int N, void* stream) {
  return gs::launch<1>(x, w, nullptr, out, E, M, K, N, (cudaStream_t)stream);
}

extern "C" int grouped_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                  int E, int M, int K, int N, void* stream) {
  return launch_f32<2>(x, w1, w3, out, E, M, K, N, stream);
}

extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E, int M, int K,
                                  int N, void* stream) {
  return launch_f32<1>(x, w, nullptr, out, E, M, K, N, stream);
}
