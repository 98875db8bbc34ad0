// The Hopper (sm_90a) mainloop of the port's bf16 ragged expert products,
// shared by ragged_mlp.cu (ragged_matmul and ragged_swiglu) and fused_moe.cu
// (the fused leg's up and down passes); each caller gives it its epilogue.
// weight_grad.cu reuses its constants and its ring's structure.
//
// The ragged layout: R rows in bm-row blocks, block i of expert b2e[i];
// rows at or past *total_rows (read on the device, never on the host) are
// dead.  The product is A (R, K) @ w[e] per row block, NW weights of (E, K,
// N) read N-major, or one (E, N, K) read as its transpose (TRANS).
//
// A persistent grid (one block per SM) walks TM x BN output tiles; a tile
// keeps its first tm rows (tm = TM, or bm when bm is smaller), so it never
// straddles two row blocks and has one expert, b2e[m0 / bm], the weight
// maps' outer coordinate.  Tile order (tile_at): the M tiles of one expert
// form a run, and a run's tiles are walked M fastest over all N tiles, so
// each weight panel is read from device memory once and the run's rows stay
// in L2 (walking all M tiles fastest instead re-read the rows once per wave
// and ran ~1.5x slower at (5120, 4096) @ w1; PERF.md).
//
// One producer warpgroup keeps a 4-stage ring of A (BK of K x TM rows) and
// B (BK of K x BN columns, per weight) tiles in flight, each stage guarded
// by a full and an empty mbarrier.  B always comes by TMA (128-byte swizzle,
// edges zero-filled).  A comes by one 2-D TMA load, or, when GATHER, row by
// row through a row map (row r is x[src[r]], none when src[r] < 0): TMA
// cannot gather rows, so the producer warpgroup's 128 threads copy 16-byte
// chunks with cp.async, writing the same 128-byte swizzle by address (chunk
// c of row r at r * 128 + (c ^ r % 8) * 16), zero-filling dead rows and the
// K tail, and each thread's copies arrive on the stage's full barrier
// (noinc: the barrier counts those 128 arrivals beside the TMA thread's).
// Two consumer warpgroups run wgmma on the shared-memory operands (each 64
// rows x WN columns per weight), one k-block's products in flight while the
// next stage is waited for, fp32 sums in registers (setmaxnreg); a stage is
// released only after wgmma.wait_group says its products are done.  Tiles
// at or past *total_rows load nothing.
//
// The epilogue works from the registers: for each of a thread's rows it
// makes a row handle (Epi::row, given whether the row is live) and passes
// it each of the row's column pairs, one fp32 pair per weight (Epi::put).

#pragma once

#include "hopper.cuh"

namespace rw {

constexpr int BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // two consumer warpgroups, then the producer
constexpr int B_BOX = 64 * BK * 2;              // one 64-column box of N-major B
constexpr int GM = 16;                          // the longest run of M tiles

// TM rows by BN columns of each of NW weights; TRANS: one (E, N, K) weight;
// GATHER: A's rows through the row map.
template <int TM_, int NW_, bool TRANS_, bool GATHER_>
struct Cfg {
  static constexpr int TM = TM_, NW = NW_;
  static constexpr bool TRANS = TRANS_, GATHER = GATHER_;
  static_assert(TM == 128 || (TM == 64 && NW == 1), "64-row tiles take one weight");
  static_assert(NW == 1 || !TRANS, "two weights are read N-major");
  static constexpr int BN = 256 / NW;                 // 128 accumulators a consumer thread
  static constexpr int WN = TM == 128 ? BN : BN / 2;  // columns of one consumer
  static constexpr int A_BYTES = TM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + NW * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  // the gathering producer keeps eight row indices and addresses
  static constexpr int PRODUCER_REGS = GATHER ? 56 : 40;
  static constexpr int CONSUMER_REGS = GATHER ? 224 : 232;
};

// What the mainloop reads besides the tensor maps.
struct Rows {
  const int* b2e;
  const int* total_rows;
  const int* src;             // GATHER: the row map
  const __nv_bfloat16* x;     // GATHER: the (.., K) matrix its rows index
  int R, K, N, bm, tm;
};

// The tile order.  M tiles form runs of one expert (a run also ends at a
// multiple of GM, which bounds the scan below); a run's tiles are walked M
// fastest over all N tiles.  Tile t lies in the run holding M tile t / num_n
// (a run of len M tiles owns len * num_n consecutive t), so the order needs
// no table: each thread finds its run by scanning b2e.  Dead M tiles (at or
// past *total_rows) form runs of their own.
__device__ __forceinline__ void tile_at(int t, int num_m, int num_n, int bn, const Rows& p,
                                        int total, int& m0, int& n0) {
  const auto key = [&](int i) { return i * p.tm < total ? p.b2e[i * p.tm / p.bm] : -1; };
  const int mm = t / num_n, k = key(mm);
  int ms = mm, me = mm + 1;
  while (ms % GM != 0 && key(ms - 1) == k) --ms;
  while (me < num_m && me % GM != 0 && key(me) == k) ++me;
  const int local = t - ms * num_n, len = me - ms;
  m0 = (ms + local % len) * p.tm;
  n0 = (local / len) * bn;
}

template <class C>
__device__ __forceinline__ void load_b(uint8_t* sb, const CUtensorMap* map, uint64_t* bar,
                                       int kb, int n0, int e) {
  using namespace hopper;
  if constexpr (C::TRANS) {
    tma_load_3d(sb, map, bar, kb * BK, n0, e);
  } else {
#pragma unroll
    for (int j = 0; j < C::BN / 64; ++j)
      tma_load_3d(sb + j * B_BOX, map, bar, n0 + 64 * j, kb * BK, e);
  }
}

// a_map: A (R, K) in TM-row boxes (unused when GATHER); b_map, b3_map: the
// weights (b3_map is the second weight when NW == 2).
template <class C, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
ragged_wgmma(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
             const __grid_constant__ CUtensorMap b3_map, const Rows p, const Epi epi) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  const int num_m = p.R / p.tm, num_n = (p.N + C::BN - 1) / C::BN, tiles = num_m * num_n;
  const int nk = (p.K + BK - 1) / BK;
  const int total = *p.total_rows;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrive-expect-tx, and each gathering thread's copies
      mbar_init(&full[s], C::GATHER ? 1 + 128 : 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // producer: thread 0 of the warpgroup starts the TMA loads; when GATHER
    // all 128 threads copy A's rows, thread q chunk q % 8 of rows q / 8 + 16 i
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int q = threadIdx.x - CONSUMERS * 128;
    if (C::GATHER || q == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_at(t, num_m, num_n, C::BN, p, total, m0, n0);
        if (m0 >= total) continue;
        const int e = p.b2e[m0 / p.bm];
        [[maybe_unused]] int src[C::TM / 16];
        if constexpr (C::GATHER) {
#pragma unroll
          for (int i = 0; i < C::TM / 16; ++i) {
            const int r = q / 8 + 16 * i;
            src[i] = r < p.tm && m0 + r < total ? p.src[m0 + r] : -1;
          }
        }
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* sa = smem + s * C::STAGE;
          uint8_t* sb = sa + C::A_BYTES;
          if (q == 0) {
            mbar_expect_tx(&full[s], C::GATHER ? C::NW * C::B_BYTES : C::STAGE);
            if constexpr (!C::GATHER) tma_load_2d(sa, &a_map, &full[s], kb * BK, m0);
            load_b<C>(sb, &b_map, &full[s], kb, n0, e);
            if constexpr (C::NW == 2) load_b<C>(sb + C::B_BYTES, &b3_map, &full[s], kb, n0, e);
          }
          if constexpr (C::GATHER) {
            const int c = q % 8, k = kb * BK + 8 * c;
#pragma unroll
            for (int i = 0; i < C::TM / 16; ++i) {
              const int r = q / 8 + 16 * i;
              const bool on = src[i] >= 0 && k < p.K;
              cp_async16(sa + r * 128 + ((c ^ (r % 8)) * 16),
                         on ? p.x + (size_t)src[i] * p.K + k : p.x, on ? 16 : 0);
            }
            cp_async_arrive_noinc(&full[s]);
          }
        }
      }
      if constexpr (C::GATHER) cp_async_wait_all();
    }
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    // this consumer's rows and columns within the tile
    const int row0 = C::TM == 128 ? 64 * wgi : 0, col0 = C::TM == 128 ? 0 : C::WN * wgi;
    float acc[C::NW][C::WN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_at(t, num_m, num_n, C::BN, p, total, m0, n0);
      const bool live = m0 < total;
#pragma unroll
      for (int w = 0; w < C::NW; ++w)
#pragma unroll
        for (int i = 0; i < C::WN / 2; ++i) acc[w][i] = 0.0f;
      if (live) {
        int prev = -1;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          if constexpr (C::GATHER) fence_proxy_async();
          const uint8_t* sa = smem + s * C::STAGE + row0 * 128;
          const uint8_t* sb = smem + s * C::STAGE + C::A_BYTES;
#pragma unroll
          for (int w = 0; w < C::NW; ++w) fence_regs(acc[w]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = desc_sw128(sa + kk * 32, 16, 1024);
#pragma unroll
            for (int w = 0; w < C::NW; ++w) {
              const uint8_t* sbw = sb + w * C::B_BYTES;
              if constexpr (C::TRANS)
                wgmma_ss<0>(acc[w], da, desc_sw128(sbw + col0 * 128 + kk * 32, 16, 1024));
              else
                wgmma_ss<1>(acc[w], da,
                            desc_sw128(sbw + (col0 / 64) * B_BOX + kk * 16 * 128, B_BOX, 1024));
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous k-block's products are done
#pragma unroll
          for (int w = 0; w < C::NW; ++w) fence_regs(acc[w]);
          if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int w = 0; w < C::NW; ++w) fence_regs(acc[w]);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
      }
      // epilogue, from the accumulator layout: row 16 warp + lane / 4 + 8 h,
      // columns 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * warp + lane / 4 + 8 * h, grow = m0 + r;
        if (r >= p.tm) continue;
        const auto row = epi.row(grow, live && grow < total);
#pragma unroll
        for (int j = 0; j < C::WN / 8; ++j) {
          const int col = n0 + col0 + 8 * j + 2 * (lane % 4);
          if (col < p.N) {
            float v[C::NW][2];
#pragma unroll
            for (int w = 0; w < C::NW; ++w) {
              v[w][0] = acc[w][4 * j + 2 * h];
              v[w][1] = acc[w][4 * j + 2 * h + 1];
            }
            epi.put(row, col, v);
          }
        }
      }
    }
  }
}

// ---- host ------------------------------------------------------------------

// A (R, K) row-major, loaded in BK x rows boxes
inline int map_rows(CUtensorMap* map, const void* a, int R, int K, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)rows};
  return hopper::make_map(map, a, 2, dims, strides, box);
}

// w (E, K, N), loaded N-major in 64-column x BK boxes; or, when trans, w
// (E, N, K) loaded K-major in BK x bn boxes
inline int map_weights(CUtensorMap* map, const void* w, int E, int K, int N, bool trans,
                       int bn) {
  if (trans) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)bn, 1};
    return hopper::make_map(map, w, 3, dims, strides, box);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  return hopper::make_map(map, w, 3, dims, strides, box);
}

// Launch the mainloop on a persistent grid; returns 0 or a CUDA error.
template <class C, class Epi>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const CUtensorMap& b3_map,
           const Rows& p, const Epi& epi, cudaStream_t stream) {
  auto kernel = ragged_wgmma<C, Epi>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.R / p.tm) * ((p.N + C::BN - 1) / C::BN);
  if (tiles == 0) return 0;
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(a_map, b_map, b3_map, p, epi);
  return (int)cudaGetLastError();
}

}  // namespace rw
