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
// operations and the output's bytes weigh about the same, and the kernel
// is only near its bound when the output's traffic runs under the products.
// Stored straight from the registers (4-byte pairs in the accumulator's
// layout, the tensor cores waiting), the output went out at 1.28 TB/s
// (scripts/chip_wgrad_probe.py; PERF.md).
//
// Which dtype runs which kernel:
//   bf16: TMA + mbarrier ring + wgmma (weight_grad_wgmma), the structure of
//     ragged_wgmma.cuh: a persistent grid walks TM x 256 output tiles of one
//     expert's (K, N) gradient, expert by expert, and a tile's reduction
//     runs over that expert's live rows, found by scanning b2e (once per
//     expert a block meets).  Thread 0 of the producer warpgroup keeps a
//     ring of 64-row stages in flight (3 at TM = 128, as many as fit beside
//     the 64 KB staging tile; 4 at TM = 64; six 32-row stages ran the
//     products at 517 TFLOP/s where three 64-row ones ran them at 805): A
//     boxes (rows x 64 columns of a) and B boxes (rows x 64 columns of b),
//     both M- / N-major in shared memory, so wgmma reads A with the
//     transpose bit as ragged_wgmma.cuh reads N-major B.  A stage is filled
//     from G-row groups, G = gcd(bm, 64), each group a TMA load of one row
//     block's rows, so a stage never holds another expert's rows; when bm
//     < 64 the last stage of an expert may hold fewer groups, and its other
//     slots are loaded from past the tensor's last row, which TMA fills
//     with zeros.  So the consumers issue every k16 step of every stage: a
//     wgmma on a data-dependent path makes ptxas serialize all of them
//     (its note C7520), which runs them at ~40% of the tensor rate.
//     Two consumer warpgroups each hold 64 rows x 256 columns of fp32 sums
//     (TM = 128) or share 64 rows, 128 columns each (TM = 64, for K <= 64).
//     The epilogue runs beside the next tile's products: each consumer
//     writes its bf16 tile into a staging tile of its own in shared memory
//     (64 x 64 boxes in the output map's 128-byte swizzle, so a warp's
//     writes fall in 32 banks), fences it for the async proxy, and marks it
//     staged; thread 32 of the producer warpgroup stores it by TMA (3-D
//     (N, K, E) map: the edges at K and N, and the expert's last row, clip
//     in hardware) and goes on while the store runs.  The consumers start
//     the next tile's products at once; they wait only if, at their next
//     epilogue, the store has not yet read the staging tile.  When adding,
//     the storer TMA-loads a tile's old values into the staging tile as
//     soon as the last store has read it, so the load lands under the
//     tile's products, and the epilogue adds in place with the rounding
//     points above.  (A TMA reduce-add into the output rounds as those
//     points do, but the L2's adds ran at ~2.2 TB/s of old and new values
//     where the loads and stores ran at ~3.5: slower wherever bytes bound
//     the call.)  One staging tile per consumer, not two, and no ping-pong
//     of consumers across tiles: TM x 256 sums fill the consumers'
//     registers, and the ring needs the rest of the shared memory.  ptxas:
//     168 registers (the launch bound; setmaxnreg moves the producer to 56,
//     the consumers to 224), no spills, no serialized wgmma, in all four
//     instantiations.
//   fp32: a plain FMA tile loop (weight_grad_f32), one block of 128 threads
//     per 64 x 64 output tile of one expert, 32 rows of a and b staged in
//     shared memory at a time with ragged_tile.cuh's loader.
// PERF.md has its time against its bound.

#include "hopper.cuh"
#include "ragged_tile.cuh"
#include "ragged_wgmma.cuh"

namespace {

// ---- bf16: TMA ring + wgmma, TMA-stored epilogue -----------------------------

namespace wg {

using rw::CONSUMERS;
using rw::THREADS;
constexpr int BN = 256;
constexpr int SR = 64;              // rows of a and b in one ring stage
constexpr int BOX = 64 * SR * 2;    // one 64-column box of a stage
constexpr int OBOX = 64 * 64 * 2;   // one 64 x 64 box of the output
constexpr int SMEM_MAX = 232448;    // the shared memory a block may use
constexpr int BARRIERS = 256;       // room for the mbarriers

template <int TM>
struct Cfg {
  static_assert(TM == 128 || TM == 64, "TM is 64 or 128 rows of K");
  static constexpr int WN = TM == 128 ? BN : BN / 2;  // columns of one consumer
  static constexpr int A_BYTES = TM / 64 * BOX;
  static constexpr int STAGE = A_BYTES + BN / 64 * BOX;
  static constexpr int HALF = 64 * WN * 2;      // one consumer's staging tile, WN / 64 boxes
  static constexpr int OUT = CONSUMERS * HALF;  // the staging tile: TM x BN
  static constexpr int FIT = (SMEM_MAX - 1024 - BARRIERS - OUT) / STAGE;
  static constexpr int STAGES = FIT < rw::STAGES ? FIT : rw::STAGES;  // 3 at TM 128, 4 at 64
  static constexpr int SMEM = STAGES * STAGE + OUT + BARRIERS + 1024;
  static_assert(STAGES >= 3 && SMEM <= SMEM_MAX, "the ring and the staging tile must fit");
};

struct Args {
  const int* b2e;
  const int* total_rows;
  int R, K, N, E, bm, g;  // g: the rows of one TMA group, gcd(bm, SR)
};

// The live G-row groups of expert e, which a tile reduces in block order;
// its live blocks lie in [lo, hi) (lo = hi = 0 when it has none).
__device__ __forceinline__ int expert_span(const Args& p, int total, int e, int& lo, int& hi) {
  const int nb = p.R / p.bm;
  int n = 0;
  lo = hi = 0;
  for (int i = 0; i < nb && i * p.bm < total; ++i) {
    if (p.b2e[i] != e) continue;
    if (n++ == 0) lo = i;
    hi = i + 1;
  }
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

// consumer w's first row of K and first column within the tile
template <int TM>
__device__ __forceinline__ int row0_of(int w) {
  return TM == 128 ? 64 * w : 0;
}
template <int TM>
__device__ __forceinline__ int col0_of(int w) {
  return TM == 128 ? 0 : Cfg<TM>::WN * w;
}

template <int TM, bool ADD>
__global__ void __launch_bounds__(THREADS, 1)
weight_grad_wgmma(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap out_map, const Args p) {
  using namespace hopper;
  using C = Cfg<TM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* staging = smem + C::STAGES * C::STAGE;  // consumer w's tile at w * HALF
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::OUT);
  uint64_t* empty = full + C::STAGES;
  // per consumer: its staging tile may be written (write) or holds the
  // tile's old values (add); its staging tile holds the tile's output
  uint64_t* ready = empty + C::STAGES;
  uint64_t* staged = ready + CONSUMERS;

  const int num_m = (p.K + TM - 1) / TM, num_n = (p.N + BN - 1) / BN;
  const int tiles = p.E * num_m * num_n;
  const int total = *p.total_rows;
  const int per_stage = SR / p.g;  // groups of a full stage
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int w = 0; w < CONSUMERS; ++w) {
      mbar_init(&ready[w], 1);
      mbar_init(&staged[w], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // producer: thread 0 issues every TMA load of a and b, thread 32 every
    // TMA transfer of the output (at 40 registers a thread, the TM = 64
    // instantiation spilled)
    setmaxnreg_dec<56>();
    const int q = threadIdx.x % 128;
    if (q == 0) {
      const int row_bytes = (TM + BN) * 2;
      int it = 0, cached_e = -1, groups = 0, lo = 0, hi = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, mt, nt;
        tile_coords(t, num_m, num_n, e, mt, nt);
        const int m0 = mt * TM, n0 = nt * BN;
        if (e != cached_e) {  // a block's tiles run expert by expert
          groups = expert_span(p, total, e, lo, hi);
          cached_e = e;
        }
        int gi = 0;
        uint8_t* sa = smem;
        for (int i = lo; i < hi; ++i) {
          if (p.b2e[i] != e) continue;
          for (int r0 = i * p.bm; r0 < (i + 1) * p.bm; r0 += p.g, ++gi) {
            const int slot = gi % per_stage, s = it % C::STAGES;
            if (slot == 0) {
              mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
              sa = smem + s * C::STAGE;
              // every stage is whole: the group slots past an expert's
              // last row are loaded from past the tensor's last row (zeros)
              mbar_expect_tx(&full[s], SR * row_bytes);
              for (int z = min(per_stage, groups - gi); z < per_stage; ++z) {
#pragma unroll
                for (int j = 0; j < TM / 64; ++j)
                  tma_load_2d(sa + j * BOX + z * p.g * 128, &a_map, &full[s], m0 + 64 * j, p.R);
#pragma unroll
                for (int j = 0; j < BN / 64; ++j)
                  tma_load_2d(sa + C::A_BYTES + j * BOX + z * p.g * 128, &b_map, &full[s],
                              n0 + 64 * j, p.R);
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
    } else if (q == 32) {
      // the output: per tile and consumer, make the staging tile ready (add:
      // load the old values into it), then store it once the consumer has
      // written it.  Boxes wholly past K or N are neither loaded nor stored;
      // TMA clips the others at the tensor's edges.
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        int e, mt, nt;
        tile_coords(t, num_m, num_n, e, mt, nt);
        bulk_wait_read<0>();  // the last tile's stores have read the staging tile
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          const int r0 = mt * TM + row0_of<TM>(w), c0 = nt * BN + col0_of<TM>(w);
          if constexpr (ADD) {
            int boxes = 0;
#pragma unroll
            for (int j = 0; j < C::WN / 64; ++j) boxes += r0 < p.K && c0 + 64 * j < p.N;
            mbar_expect_tx(&ready[w], boxes * OBOX);
#pragma unroll
            for (int j = 0; j < C::WN / 64; ++j)
              if (r0 < p.K && c0 + 64 * j < p.N)
                tma_load_3d(staging + w * C::HALF + j * OBOX, &out_map, &ready[w], c0 + 64 * j,
                            r0, e);
          } else {
            mbar_arrive(&ready[w]);
          }
        }
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          const int r0 = mt * TM + row0_of<TM>(w), c0 = nt * BN + col0_of<TM>(w);
          mbar_wait(&staged[w], n & 1);
#pragma unroll
          for (int j = 0; j < C::WN / 64; ++j)
            if (r0 < p.K && c0 + 64 * j < p.N)
              tma_store_3d(&out_map, staging + w * C::HALF + j * OBOX, c0 + 64 * j, r0, e);
          bulk_commit();
        }
      }
      bulk_wait<0>();  // every store has reached global memory
    }
  } else {
    setmaxnreg_inc<224>();  // 128 x 56 + 256 x 224 registers fit in the SM's 65536
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    // this consumer's A box (its 64 rows of K) and first column in the tile
    const int abox = TM == 128 ? wgi : 0, col0 = col0_of<TM>(wgi);
    uint8_t* mine = staging + wgi * C::HALF;
    float acc[C::WN / 2];
    int it = 0, n = 0, cached_e = -1, groups = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
      int e, mt, nt;
      tile_coords(t, num_m, num_n, e, mt, nt);
      if (e != cached_e) {
        int lo, hi;
        groups = expert_span(p, total, e, lo, hi);
        cached_e = e;
      }
#pragma unroll
      for (int i = 0; i < C::WN / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int g0 = 0; g0 < groups; g0 += per_stage, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&full[s], (it / C::STAGES) & 1);
        const uint8_t* sa = smem + s * C::STAGE + abox * BOX;
        const uint8_t* sb = smem + s * C::STAGE + C::A_BYTES + (col0 / 64) * BOX;
        fence_regs(acc);
        wgmma_fence();
        // every k16 step, unconditionally: a wgmma on a data-dependent path
        // makes ptxas serialize them all (C7520)
#pragma unroll
        for (int kk = 0; kk < SR / 16; ++kk)
          wgmma_ss<1, 1>(acc, desc_sw128(sa + kk * 16 * 128, BOX, 1024),
                         desc_sw128(sb + kk * 16 * 128, BOX, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);

      // epilogue, from the accumulator layout (row 16 warp + lane / 4 + 8 h,
      // columns 8 j + 2 (lane % 4) + {0, 1}) into the staging tile, in the
      // output map's 64 x 64 boxes with their 128-byte swizzle (the 16-byte
      // chunk c of row r at r * 128 + (c ^ r % 8) * 16; r % 8 = lane / 4, so
      // a warp's 32 words fall in 32 banks).  Adding reads each old value
      // from the same word it writes.
      mbar_wait(&ready[wgi], n & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < C::WN / 8; ++j) {
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              mine + (j / 8) * OBOX + r * 128 + ((j % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4);
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if constexpr (ADD) {
            const float2 o = __bfloat1622float2(*dst), s2 = __bfloat1622float2(v);
            v = __floats2bfloat162_rn(o.x + s2.x, o.y + s2.y);
          }
          *dst = v;
        }
      }
      fence_proxy_async();            // the writes, before the TMA store reads them
      named_bar_sync(1 + wgi, 128);   // this consumer's 128 threads
      if (t128 == 0) mbar_arrive(&staged[wgi]);
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
int launch(const void* a, const void* b, void* out, const Args& p, cudaStream_t stream) {
  using C = Cfg<TM>;
  CUtensorMap a_map, b_map, out_map;
  int err = map_cols(&a_map, a, p.R, p.K, p.g);
  if (err) return err;
  if ((err = map_cols(&b_map, b, p.R, p.N, p.g))) return err;
  // out (E, K, N) has a weight's layout: 64-column x 64-row boxes, and the
  // third dimension keeps a box from crossing into the next expert's rows
  if ((err = rw::map_weights(&out_map, out, p.E, p.K, p.N, false, 0))) return err;
  auto kernel = weight_grad_wgmma<TM, ADD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = p.E * ((p.K + TM - 1) / TM) * ((p.N + BN - 1) / BN);
  if (tiles == 0) return 0;
  const int sms = hopper::sm_count(), grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(a_map, b_map, out_map, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

// the rows of one TMA group: the largest power of two up to a stage's rows
// that divides bm, so a group never holds two row blocks
int group_rows(int bm) {
  int g = wg::SR;
  while (bm % g) g /= 2;
  return g;
}

int launch_bf16(const void* a, const void* b, void* out, const void* b2e, const void* total_rows,
                int R, int K, int N, int E, int bm, int tm, int add, cudaStream_t s) {
  const wg::Args p{(const int*)b2e, (const int*)total_rows, R, K, N, E, bm, group_rows(bm)};
  if (tm == 128)
    return add ? wg::launch<128, true>(a, b, out, p, s) : wg::launch<128, false>(a, b, out, p, s);
  return add ? wg::launch<64, true>(a, b, out, p, s) : wg::launch<64, false>(a, b, out, p, s);
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
