// The expert weights' gradient over the ragged layout, for Hopper (sm_90a).
//
// Mirrors src/repro/kernels/ops.py:158 _segment_outer (a lax.scan over row
// blocks, not a pallas_call), the weight-gradient step of the ragged and
// fused legs' backward:
//   dw[e] = sum over the live row blocks i of expert e of a_iᵀ @ b_i
// a (R, K) and b (R, N) row-major, R rows in bm-row blocks, block i of
// expert b2e[i]; blocks that start at or past *total_rows (read on the
// device, never on the host) are skipped.  dw (E, K, N) in the operands'
// type.  Sums are fp32; the store either writes the sum (out = w(acc)) or
// adds it into what out holds, with the JAX package's rounding points for a
// cotangent summed over FCDA chunks (out = w(float(out) + float(w(acc))),
// w() the cast to the weight's type).  That add is what lets one MoE layer
// keep one gradient buffer per expert weight across its chunks
// (kernels/ops.py).  Every output tile is stored, also that of an expert
// with no live rows (its sum is 0).
//
// What bounds it on an H100: at the training path's shapes (4736 live rows
// of R = 5120, E = 8, K = 4096, N = 14336 or K = 14336, N = 4096) the
// products are 2 x 4736 x 4096 x 14336 = 0.56 TFLOP (0.56 ms at 989
// TFLOP/s); the output is 0.94 GB of bf16, written once (0.33 ms at 3.35
// TB/s with the operands) or read and written when adding (0.61 ms).  So the
// operations and the output's bytes weigh about the same.
//
// Which dtype runs which kernel:
//   bf16: TMA + mbarrier ring + wgmma (weight_grad_wgmma), the structure of
//     ragged_wgmma.cuh: a persistent grid walks TM x 256 output tiles of one
//     expert's (K, N) gradient, expert by expert, and a tile's reduction
//     runs over that expert's live rows, found by scanning b2e.  One
//     producer warpgroup keeps a 4-stage ring of 64-row stages in flight:
//     A boxes (rows x 64 columns of a) and B boxes (rows x 64 columns of
//     b), both M- / N-major in shared memory, so wgmma reads A with the
//     transpose bit as ragged_wgmma.cuh reads N-major B.  A stage is filled
//     from G-row groups, G = gcd(bm, 64), each group a TMA load of one row
//     block's rows, so a stage never holds another expert's rows; the last
//     stage of an expert holds fewer rows and the consumers issue only the
//     k16 steps that hold rows (a half-filled k16 step, bm = 8, is padded
//     with a load past the tensor's last row, which TMA fills with zeros).
//     Two consumer warpgroups each hold 64 rows x 256 columns of fp32 sums
//     (TM = 128) or share 64 rows, 128 columns each (TM = 64, for K <= 64);
//     the epilogue loads a row's old values first, then stores, from the
//     registers.
//   fp32: a plain FMA tile loop (weight_grad_f32), one block of 128 threads
//     per 64 x 64 output tile of one expert, 32 rows of a and b staged in
//     shared memory at a time with ragged_tile.cuh's loader.
// PERF.md has its time against its bound.

#include "hopper.cuh"
#include "ragged_tile.cuh"
#include "ragged_wgmma.cuh"

namespace {

// ---- bf16: TMA ring + wgmma -------------------------------------------------

namespace wg {

using rw::BK;
using rw::CONSUMERS;
using rw::STAGES;
using rw::THREADS;
constexpr int BN = 256;
constexpr int BOX = 64 * BK * 2;  // one 64-column box of a 64-row stage

template <int TM>
struct Cfg {
  static_assert(TM == 128 || TM == 64, "TM is 64 or 128 rows of K");
  static constexpr int WN = TM == 128 ? BN : BN / 2;  // columns of one consumer
  static constexpr int A_BYTES = TM / 64 * BOX;
  static constexpr int STAGE = A_BYTES + BN / 64 * BOX;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

struct Args {
  __nv_bfloat16* out;
  const int* b2e;
  const int* total_rows;
  int R, K, N, E, bm, g;  // g: the rows of one TMA group, gcd(bm, 64)
};

// The live G-row groups of expert e, in the order a tile reduces them.
__device__ __forceinline__ int expert_groups(const Args& p, int total, int e) {
  const int nb = p.R / p.bm;
  int n = 0;
  for (int i = 0; i < nb && i * p.bm < total; ++i) n += p.b2e[i] == e;
  return n * (p.bm / p.g);
}

// Tile t: expert e, M tile mt, N tile nt; an expert's tiles are consecutive,
// so its rows stay in L2 while they are reduced for every tile of its output
__device__ __forceinline__ void tile_coords(int t, int num_m, int num_n, int& e, int& mt,
                                            int& nt) {
  const int per = num_m * num_n, rest = t % per;
  e = t / per;
  mt = rest % num_m;  // M tiles fastest within an expert
  nt = rest / num_m;
}

template <int TM, bool ADD>
__global__ void __launch_bounds__(THREADS, 1)
weight_grad_wgmma(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, const Args p) {
  using namespace hopper;
  using C = Cfg<TM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  const int num_m = (p.K + TM - 1) / TM, num_n = (p.N + BN - 1) / BN;
  const int tiles = p.E * num_m * num_n;
  const int total = *p.total_rows;
  const int per_stage = BK / p.g;  // groups of a full stage
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
    // producer: one thread issues every TMA load
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      const int nb = p.R / p.bm, row_bytes = (TM + BN) * 2;
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, mt, nt;
        tile_coords(t, num_m, num_n, e, mt, nt);
        const int m0 = mt * TM, n0 = nt * BN;
        const int groups = expert_groups(p, total, e);
        int gi = 0;
        uint8_t* sa = smem;
        for (int i = 0; i < nb && i * p.bm < total; ++i) {
          if (p.b2e[i] != e) continue;
          for (int r0 = i * p.bm; r0 < (i + 1) * p.bm; r0 += p.g, ++gi) {
            const int slot = gi % per_stage, s = it % STAGES;
            if (slot == 0) {
              mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
              sa = smem + s * C::STAGE;
              const int in_stage = min(per_stage, groups - gi);
              // a stage's rows end on a whole k16 step: an 8-row tail gets
              // one more group, loaded from past the last row (zeros)
              const int pad = (in_stage * p.g) % 16 ? 1 : 0;
              mbar_expect_tx(&full[s], (in_stage + pad) * p.g * row_bytes);
              if (pad) {
                const int off = in_stage * p.g * 128;
#pragma unroll
                for (int j = 0; j < TM / 64; ++j)
                  tma_load_2d(sa + j * BOX + off, &a_map, &full[s], m0 + 64 * j, p.R);
#pragma unroll
                for (int j = 0; j < BN / 64; ++j)
                  tma_load_2d(sa + C::A_BYTES + j * BOX + off, &b_map, &full[s], n0 + 64 * j,
                              p.R);
              }
            }
            const int off = slot * p.g * 128;
#pragma unroll
            for (int j = 0; j < TM / 64; ++j)
              tma_load_2d(sa + j * BOX + off, &a_map, &full[s], m0 + 64 * j, r0);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(sa + C::A_BYTES + j * BOX + off, &b_map, &full[s], n0 + 64 * j, r0);
            if (slot == per_stage - 1 || gi == groups - 1) ++it;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    // this consumer's A box (its 64 rows of K) and first column in the tile
    const int abox = TM == 128 ? wgi : 0, col0 = TM == 128 ? 0 : C::WN * wgi;
    const int row0 = 64 * abox;
    float acc[C::WN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, mt, nt;
      tile_coords(t, num_m, num_n, e, mt, nt);
      const int m0 = mt * TM, n0 = nt * BN;
      const int groups = expert_groups(p, total, e);
#pragma unroll
      for (int i = 0; i < C::WN / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int g0 = 0; g0 < groups; g0 += per_stage, ++it) {
        const int s = it % STAGES;
        const int rows = min(per_stage, groups - g0) * p.g;
        const int steps = (rows + 15) / 16;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* sa = smem + s * C::STAGE + abox * BOX;
        const uint8_t* sb = smem + s * C::STAGE + C::A_BYTES + (col0 / 64) * BOX;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (kk < steps)
            wgmma_ss<1, 1>(acc, desc_sw128(sa + kk * 16 * 128, BOX, 1024),
                           desc_sw128(sb + kk * 16 * 128, BOX, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);

      // epilogue, from the accumulator layout: row 16 warp + lane / 4 + 8 h,
      // columns 8 j + 2 (lane % 4) + {0, 1}; a row's old values are all
      // loaded before any is stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row0 + 16 * warp + lane / 4 + 8 * h;
        if (row >= p.K) continue;
        __nv_bfloat16* orow = p.out + ((size_t)e * p.K + row) * p.N + n0 + col0 + 2 * (lane % 4);
        const int cols = p.N - (n0 + col0 + 2 * (lane % 4));
        [[maybe_unused]] __nv_bfloat162 old[C::WN / 8];
        if constexpr (ADD) {
#pragma unroll
          for (int j = 0; j < C::WN / 8; ++j)
            if (8 * j < cols) old[j] = *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * j);
        }
#pragma unroll
        for (int j = 0; j < C::WN / 8; ++j) {
          if (8 * j >= cols) continue;
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if constexpr (ADD) {
            const float2 o = __bfloat1622float2(old[j]), s2 = __bfloat1622float2(v);
            v = __floats2bfloat162_rn(o.x + s2.x, o.y + s2.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v;
        }
      }
    }
  }
}

// x (R, C) row-major, loaded in `rows` x 64-column boxes
inline int map_cols(CUtensorMap* map, const void* x, int R, int C, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  return hopper::make_map(map, x, 2, dims, strides, box);
}

template <int TM, bool ADD>
int launch(const void* a, const void* b, const Args& p, cudaStream_t stream) {
  using C = Cfg<TM>;
  CUtensorMap a_map, b_map;
  int err = map_cols(&a_map, a, p.R, p.K, p.g);
  if (err) return err;
  if ((err = map_cols(&b_map, b, p.R, p.N, p.g))) return err;
  auto kernel = weight_grad_wgmma<TM, ADD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = p.E * ((p.K + TM - 1) / TM) * ((p.N + BN - 1) / BN);
  if (tiles == 0) return 0;
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(a_map, b_map, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

int gcd64(int bm) {
  int g = 64;
  while (bm % g) g /= 2;
  return g;
}

int launch_bf16(const void* a, const void* b, void* out, const void* b2e, const void* total_rows,
                int R, int K, int N, int E, int bm, int tm, int add, cudaStream_t s) {
  const wg::Args p{(__nv_bfloat16*)out, (const int*)b2e, (const int*)total_rows, R, K, N, E, bm,
                   gcd64(bm)};
  if (tm == 128)
    return add ? wg::launch<128, true>(a, b, p, s) : wg::launch<128, false>(a, b, p, s);
  return add ? wg::launch<64, true>(a, b, p, s) : wg::launch<64, false>(a, b, p, s);
}

// ---- fp32: an FMA tile loop ---------------------------------------------------

using ragged::load_tile;
constexpr int F_TILE = 64, F_ROWS = 32, F_LD = F_TILE + 4;

// one block of 128 threads per (64-column N tile, 64-row K tile, expert);
// thread (ty, tx) holds rows 4 ty.. and columns 8 tx.. of the tile
template <bool ADD>
__global__ void __launch_bounds__(ragged::THREADS)
weight_grad_f32(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, const int* __restrict__ b2e,
                const int* __restrict__ total_rows, int R, int K, int N, int bm) {
  __shared__ __align__(16) float as[F_ROWS * F_LD];
  __shared__ __align__(16) float bs[F_ROWS * F_LD];
  const int n0 = blockIdx.x * F_TILE, m0 = blockIdx.y * F_TILE, e = blockIdx.z;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int total = *total_rows, nb = R / bm;
  float acc[4][8] = {};
  for (int i = 0; i < nb && i * bm < total; ++i) {
    if (b2e[i] != e) continue;
    const int end = (i + 1) * bm;
    for (int r0 = i * bm; r0 < end; r0 += F_ROWS) {
      // rows past the block's end read as 0: another expert's
      load_tile(as, F_LD, a, K, F_ROWS, F_TILE, r0, m0, end, K);
      load_tile(bs, F_LD, b, N, F_ROWS, F_TILE, r0, n0, end, N);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < F_ROWS; ++k) {
        float av[4], bv[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) av[u] = as[k * F_LD + ty * 4 + u];
#pragma unroll
        for (int v = 0; v < 8; ++v) bv[v] = bs[k * F_LD + tx * 8 + v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = m0 + ty * 4 + u;
    if (row >= K) continue;
    float* orow = out + ((size_t)e * K + row) * N;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int col = n0 + tx * 8 + v;
      if (col < N) orow[col] = ADD ? orow[col] + acc[u][v] : acc[u][v];
    }
  }
}

int launch_f32(const void* a, const void* b, void* out, const void* b2e, const void* total_rows,
               int R, int K, int N, int E, int bm, int add, cudaStream_t s) {
  const dim3 grid((N + F_TILE - 1) / F_TILE, (K + F_TILE - 1) / F_TILE, E);
  if (grid.x * grid.y * grid.z == 0) return 0;
  if (add)
    weight_grad_f32<true><<<grid, ragged::THREADS, 0, s>>>(
        (const float*)a, (const float*)b, (float*)out, (const int*)b2e, (const int*)total_rows,
        R, K, N, bm);
  else
    weight_grad_f32<false><<<grid, ragged::THREADS, 0, s>>>(
        (const float*)a, (const float*)b, (float*)out, (const int*)b2e, (const int*)total_rows,
        R, K, N, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// the first CUDA error of the set-up and the launch (0 = launched).  a (R,
// K), b (R, N), out (E, K, N); add != 0 adds into out (write otherwise); tm:
// the output tile's rows of K, 64 or 128 (bf16 only).
extern "C" int segment_outer_bf16(const void* a, const void* b, void* out, const void* b2e,
                                  const void* total_rows, int R, int K, int N, int E, int bm,
                                  int tm, int add, void* stream) {
  return launch_bf16(a, b, out, b2e, total_rows, R, K, N, E, bm, tm, add, (cudaStream_t)stream);
}

extern "C" int segment_outer_f32(const void* a, const void* b, void* out, const void* b2e,
                                 const void* total_rows, int R, int K, int N, int E, int bm,
                                 int tm, int add, void* stream) {
  return launch_f32(a, b, out, b2e, total_rows, R, K, N, E, bm, add, (cudaStream_t)stream);
}
