// Ragged (MegaBlocks-style) grouped expert matmul and SwiGLU for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ragged_mlp.py over
// the ragged layout (R rows in bm-row blocks, block i of expert b2e[i], rows
// at or past *total_rows written as 0; *total_rows is read on the device,
// never on the host), fp32 sums cast to the input type:
//   ragged_matmul (:99, body _ragged_kernel :57):   out = x (R, K) @ w[e]
//   ragged_swiglu (:131, body _ragged_swiglu_kernel):
//                      out = silu(x @ w1[e]) * (x @ w3[e]), silu in fp32
// The three-launch EP leg runs ragged_swiglu then ragged_matmul forward, and
// its backward recomputes both up-projections with ragged_matmul; the fused
// leg's backward calls ragged_matmul five times per chunk.  ragged_matmul
// meets w (E, K, N) N-major (buf @ w1, h @ w2) and w (E, N, K) read as its
// transpose, K-major (g @ w2ᵀ, dh @ w1ᵀ, dh @ w3ᵀ; never copied).
//
// What bounds them on an H100: the tensor cores.  At the training path's
// shapes (R = 5120 rows, bm = 128, d = 4096, f = 14336, bf16) one
// ragged_matmul is 2 R K N = 601 GFLOP against 1.13 GB of operands (the
// weights 0.94 GB): 0.61 ms at the 989 TFLOP/s bf16 peak against 0.34 ms at
// 3.35 TB/s; ragged_swiglu is twice the products and the weights.
//
// Which dtype runs which kernel:
//   ragged_matmul, bf16: ragged_matmul_wgmma below, the Hopper design.
//     A persistent grid (one block per SM) walks 128 x 256 output tiles
//     (64 x 256 when bm is not a multiple of 128: bm <= 64 keeps the row
//     block's bm rows of it).  A tile never straddles two row blocks, so it
//     has one expert, b2e[m0 / bm], read on the device and used as the
//     weight map's outer coordinate.  Tile order (tile_at): the M tiles of
//     one expert form a run, and a run's tiles are walked M fastest over
//     all N tiles, so each weight panel is read from device memory once
//     (0.94 GB a call at full width, 0.28 ms of the bound) and the run's
//     rows stay in L2; walking all M tiles fastest instead re-read the
//     rows once per wave and ran ~1.5x slower at (5120, 4096) @ w1
//     (PERF.md).  One producer warp keeps a 4-stage ring of A (64 of K x the
//     tile's rows) and B (64 of K x 256 columns) tiles in flight by TMA
//     (128-byte swizzle, edges zero-filled), each stage guarded by a full
//     and an empty mbarrier; two consumer warpgroups run wgmma on the
//     shared-memory operands (each 64 rows x 256 columns, or 64 x 128 of a
//     64-row tile), one k-block's products in flight while the next stage
//     is waited for, fp32 sums in registers (setmaxnreg: 232 for
//     consumers, 40 for the producer).  N-major weights are read with the
//     transpose bit from 64-column boxes.  Tiles at or past *total_rows
//     load nothing and store zeros; the epilogue stores bf16 pairs straight
//     from the registers, rows past *total_rows as 0.
//   ragged_matmul, fp32, and ragged_swiglu, both dtypes: the simple tiled
//     loop of ragged_tile.cuh (WMMA bf16 / FMA fp32, no pipelining), one
//     block per 64 x 64 tile; dead row blocks skip their products.
// PERF.md has each one's time against its bound.

#include "hopper.cuh"
#include "ragged_tile.cuh"

namespace {

// ---- bf16 ragged_matmul: TMA + mbarrier ring + wgmma -----------------------

namespace wg {

constexpr int BN = 256, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // two consumer warpgroups, then the producer
constexpr int B_BOX = 64 * BK * 2;              // one 64-column box of N-major B

// The tile order.  M tiles form runs of one expert (a run also ends at a
// multiple of GM, which bounds the scan below); a run's tiles are walked M
// fastest over all N tiles, so its weight panels are read from device
// memory once and its rows stay in L2 while they are reused.  Tile t lies
// in the run holding M tile t / num_n (a run of len M tiles owns len *
// num_n consecutive t), so the order needs no table: each thread finds its
// run by scanning b2e.  Dead M tiles (at or past *total_rows) form runs of
// their own.
constexpr int GM = 16;

__device__ __forceinline__ void tile_at(int t, int num_m, int num_n, int tm, int bm, int total,
                                        const int* __restrict__ b2e, int& m0, int& n0) {
  const auto key = [&](int i) { return i * tm < total ? b2e[i * tm / bm] : -1; };
  const int mm = t / num_n, k = key(mm);
  int ms = mm, me = mm + 1;
  while (ms % GM != 0 && key(ms - 1) == k) --ms;
  while (me < num_m && me % GM != 0 && key(me) == k) ++me;
  const int local = t - ms * num_n, len = me - ms;
  m0 = (ms + local % len) * tm;
  n0 = (local / len) * BN;
}

template <int TM>
struct Tile {
  static constexpr int A_BYTES = TM * BK * 2;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int WN = TM == 128 ? BN : BN / 2;  // columns of one consumer
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// out = x @ w[b2e[row / bm]] over TM x BN tiles; each tile stores its first
// tm rows (tm = TM, or bm when bm < 64).  TRANS: w is (E, N, K), K-major.
template <int TM, bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
ragged_matmul_wgmma(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ b2e, const int* __restrict__ total_rows, int R, int K,
                    int N, int bm, int tm) {
  using namespace hopper;
  using T = Tile<TM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE);
  uint64_t* empty = full + STAGES;

  const int num_m = R / tm, num_n = (N + BN - 1) / BN, tiles = num_m * num_n;
  const int nk = (K + BK - 1) / BK;
  const int total = *total_rows;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // producer: one thread starts every load of the block's live tiles
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_at(t, num_m, num_n, tm, bm, total, b2e, m0, n0);
        if (m0 >= total) continue;
        const int e = b2e[m0 / bm];
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* sa = smem + s * T::STAGE;
          uint8_t* sb = sa + T::A_BYTES;
          mbar_expect_tx(&full[s], T::STAGE);
          tma_load_2d(sa, &a_map, &full[s], kb * BK, m0);
          if constexpr (TRANS) {
            tma_load_3d(sb, &b_map, &full[s], kb * BK, n0, e);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(sb + j * B_BOX, &b_map, &full[s], n0 + 64 * j, kb * BK, e);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    // this consumer's rows and columns within the tile
    const int row0 = TM == 128 ? 64 * wgi : 0, col0 = TM == 128 ? 0 : T::WN * wgi;
    float acc[T::WN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_at(t, num_m, num_n, tm, bm, total, b2e, m0, n0);
      const bool live = m0 < total;
#pragma unroll
      for (int i = 0; i < T::WN / 2; ++i) acc[i] = 0.0f;
      if (live) {
        int prev = -1;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          const uint8_t* sa = smem + s * T::STAGE + row0 * 128;
          const uint8_t* sb = smem + s * T::STAGE + T::A_BYTES;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = desc_sw128(sa + kk * 32, 16, 1024);
            if constexpr (TRANS)
              wgmma_ss<0>(acc, da, desc_sw128(sb + col0 * 128 + kk * 32, 16, 1024));
            else
              wgmma_ss<1>(acc, da,
                          desc_sw128(sb + (col0 / 64) * B_BOX + kk * 16 * 128, B_BOX, 1024));
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous k-block's products are done
          fence_regs(acc);
          if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
      }
      // epilogue: bf16 pairs straight from the accumulator layout
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * warp + lane / 4 + 8 * h, grow = m0 + r;
        if (r >= tm) continue;
        const bool keep = live && grow < total;
        __nv_bfloat16* orow = out + (size_t)grow * N;
#pragma unroll
        for (int j = 0; j < T::WN / 8; ++j) {
          const int col = n0 + col0 + 8 * j + 2 * (lane % 4);
          if (col < N) {
            const float v0 = keep ? acc[4 * j + 2 * h] : 0.0f;
            const float v1 = keep ? acc[4 * j + 2 * h + 1] : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

template <int TM, bool TRANS>
int launch_tile(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
                int R, int K, int N, int E, int bm, int tm, cudaStream_t stream) {
  using T = Tile<TM>;
  CUtensorMap a_map, b_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BK, TM};
  int err = hopper::make_map(&a_map, x, 2, a_dims, a_strides, a_box);
  if (err) return err;
  if (TRANS) {  // w (E, N, K): boxes of 64 of K x 256 rows of N
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
    const cuuint32_t box[3] = {BK, BN, 1};
    err = hopper::make_map(&b_map, w, 3, dims, strides, box);
  } else {      // w (E, K, N): boxes of 64 columns of N x 64 rows of K
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
    const cuuint32_t box[3] = {64, BK, 1};
    err = hopper::make_map(&b_map, w, 3, dims, strides, box);
  }
  if (err) return err;
  auto kernel = ragged_matmul_wgmma<TM, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (R / tm) * ((N + BN - 1) / BN);
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, T::SMEM, stream>>>(a_map, b_map, (__nv_bfloat16*)out, (const int*)b2e,
                                             (const int*)total_rows, R, K, N, bm, tm);
  return (int)cudaGetLastError();
}

// tm: the rows a tile keeps, 128 when bm is a multiple of 128 (128-row
// tiles), else 64 or bm (64-row tiles).
int launch(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
           int R, int K, int N, int E, int bm, int tm, int trans, cudaStream_t stream) {
  if (tm == 128)
    return trans ? launch_tile<128, true>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream)
                 : launch_tile<128, false>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream);
  return trans ? launch_tile<64, true>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream)
               : launch_tile<64, false>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream);
}

}  // namespace wg

// ---- fp32 ragged_matmul and ragged_swiglu: the tile loop of ragged_tile.cuh

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

int launch_f32(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
               int R, int K, int N, int bm, int tm, int trans, void* stream) {
  using T = float;
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
// the first CUDA error of the set-up and the launch (0 = launched).  w is
// (E, K, N), or (E, N, K) read as its transpose when trans != 0; tm is the
// rows a tile keeps (kernels/ragged_mlp.py::row_tile).
extern "C" int ragged_matmul_bf16(const void* x, const void* w, void* out, const void* b2e,
                                  const void* total_rows, int R, int K, int N, int bm, int tm,
                                  int trans, int E, void* stream) {
  return wg::launch(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, trans,
                    (cudaStream_t)stream);
}

extern "C" int ragged_matmul_f32(const void* x, const void* w, void* out, const void* b2e,
                                 const void* total_rows, int R, int K, int N, int bm, int tm,
                                 int trans, int E, void* stream) {
  return launch_f32(x, w, out, b2e, total_rows, R, K, N, bm, tm, trans, stream);
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
