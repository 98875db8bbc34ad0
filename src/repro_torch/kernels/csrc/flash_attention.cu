// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:76
// flash_attention (body _flash_kernel :25): q (BH, S, hd), k and v (BH, Skv,
// hd), heads folded into the leading dim and KV already repeated, ->
//   out = softmax(q kᵀ * hd**-0.5) v   over the visible (query, key) pairs,
// key k visible from query q when k <= q (causal) and k > q - window (a
// window, with or without causal); a masked score is -1e30, finite as in the
// TPU kernel, so exp(s - m) never meets inf - inf; keys past Skv weigh 0.
// The running max m and denominator l are fp32; out = acc / max(l, 1e-30),
// cast to q's type.  hd must be a multiple of 8, at most 128; the wrapper
// checks it, and the pointers' 16-byte alignment.
//
// What bounds it on an H100: the tensor cores.  At Mixtral-8x7B's prefill
// shapes (BH = 64, S = 2048, hd = 128, causal) the visible pairs are 68.7
// GFLOP (0.070 ms at 989 TFLOP/s) against 134 MB of q, k, v and out (0.040 ms
// at 3.35 TB/s).
//
// Both kernels walk (bh, query tile) items longest band first, and per item
// a loop over the live KV tiles only, from the tile holding q0 - window + 1
// to the diagonal tile (the last KV tile when not causal), so causal and
// window work follows the band (band() below).  Each item's output tile is
// written once: no atomics, deterministic.  Rows and keys past S and Skv
// are masked, so any S and Skv work.
//
// Which dtype runs which kernel:
//   bf16: flash_wgmma_kernel, the Hopper design (FA3's shape).  A
//     persistent grid (one block per SM) takes the items in rounds, in
//     reverse on odd rounds so the blocks' totals even out.  A 128-row
//     query tile, two consumer warpgroups of 64 rows each.  A producer warp
//     loads Q by TMA once per item (into one buffer, freed as soon as the
//     consumers hold it in registers, so the next item's Q lands while this
//     one runs) and K and V tiles of 128 keys into a 3-stage ring that runs
//     on across items; K and V have their own full and empty mbarriers, so
//     a K slot is refilled as soon as its scores are done (224 KB of shared
//     memory).  S = Q Kᵀ is an RS wgmma: Q's fragments in registers (read
//     once per item by ldmatrix, so the products read only K from shared
//     memory, which with the TMA writes is what the loop is short of), K as
//     it lies, (keys, hd), the K-major B operand.  Tile i's
//     scores are started before tile i-1's P·V, and tile i's online softmax
//     runs on the accumulator fragments in registers while that P·V is on
//     the tensor cores: ex2 with the scale folded into log2 e, row max and
//     sum across the four threads of a row by shuffles, the mask applied
//     only on tiles that hold an invisible pair (the diagonal, the window's
//     edge, keys past Skv).  P is rounded to bf16 in registers and fed as
//     the A operand of an RS wgmma against V, the N-major B operand
//     (transpose bit); l is summed from the fp32 P.  hd below 128 is padded
//     with TMA's zero fill (3-D maps, so the S edge never reads the next
//     head), and columns past hd are not stored.  The TPU kernel keeps P in
//     fp32 for P·V: rounding P is the one rounding point it does not have.
//   fp32: the first, simple kernel: one block of four warps per (bh, 64-row
//     query tile), Q, K and V staged in shared memory with 16-byte loads
//     (ragged_tile.cuh's load_tile), scores and the online softmax (two
//     lanes per row) through shared memory, both products on FMA in fp32;
//     nothing is rounded.
// PERF.md has both kernels' times against the bound.

#include <math.h>

#include "hopper.cuh"
#include "ragged_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// The live KV range of the BQ-row query tile at q0: [lo, hi), lo a multiple
// of BKV.
template <int BQ, int BKV>
__device__ __forceinline__ void band(int q0, int S, int Skv, int causal, int window, int& lo,
                                     int& hi) {
  const int q_last = min(q0 + BQ, S) - 1;
  lo = window ? max(0, q0 - window + 1) / BKV * BKV : 0;
  hi = causal ? min(Skv, q_last + 1) : Skv;
}

// ---- bf16: TMA + mbarrier ring + wgmma, softmax in registers --------------

namespace wg {

constexpr int BQ = 128, BKV = 128, HD = 128, STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // two consumer warpgroups, then the producer
constexpr int HALF = 128 * 64 * 2;              // one box: 128 rows x 64 of hd
constexpr int TILE = 2 * HALF;                  // a 128 x 128 tile of Q, K or V
constexpr int SMEM = (1 + 2 * STAGES) * TILE + (2 + 4 * STAGES) * 8 + 1024;
static_assert(SMEM <= 232448, "the ring fits the 227 KB a block may use");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What one consumer thread needs to mask and scale its scores.
struct Rows {
  int qa;      // the warpgroup's first query row
  int qr;      // this thread's first row (the second is qr + 8)
  int lane;
  int Skv, causal, window;
  float sl2;   // hd**-0.5 * log2 e: scores to the log2 domain
};

// The warpgroup's 64 rows of Q as the A fragments of the score products,
// read once per item from the 128-byte-swizzled tile by ldmatrix (lane l
// gives the address of row l % 8 of 8 x 8 matrix l / 8: rows +0/+8, then
// columns +0/+8), so the products read only K from shared memory.
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4], const uint8_t* qs, int wgi,
                                       int warp, int lane) {
  const int m = lane / 8, r = lane % 8;
  const int row = 64 * wgi + 16 * warp + (m % 2) * 8 + r;  // row % 8 == r
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int chunk = (kk % 4) * 2 + m / 2;  // 16-byte chunk of the 128-byte row
    const uint32_t a = hopper::smem_u32(qs + (kk / 4) * HALF + row * 128 + ((chunk ^ r) * 16));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
                 : "r"(a));
  }
}

// Start (and commit) sc = Q Kᵀ for the warpgroup's rows of Q (fragments
// qf) against the 128 keys of the K tile kt (the first product overwrites
// sc); K as it lies, (keys, hd), is the K-major B operand.  The caller
// fences and waits.
__device__ __forceinline__ void start_qk(float (&sc)[BKV / 2], const uint32_t (&qf)[HD / 16][4],
                                         const uint8_t* kt) {
  using namespace hopper;
  fence_regs(sc);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_rs<0>(sc, qf[kk], desc_sw128(kt + (kk / 4) * HALF + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// Start (and commit) o += P V for the V tile vt: V (keys, hd) is the N-major
// B operand (transpose bit), its two 64-column boxes HALF apart.
__device__ __forceinline__ void start_pv(float (&o)[HD / 2], const uint32_t (&p)[BKV / 16][4],
                                         const uint8_t* vt) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    hopper::wgmma_rs<1>(o, p[kk], desc_sw128(vt + kk * 16 * 128, HALF, 1024));
  wgmma_commit();
}

// The online-softmax step of the KV tile at kv0, in registers: the raw
// scores sc become P = exp2((s - m) sl2) in fp32; m (raw) and this thread's
// share of l are updated and alpha = exp2((m_prev - m) sl2) returned per
// row.  Row max across the four threads of a row by shuffles.  The mask is
// applied only on a tile that holds an invisible pair or keys past Skv.  A
// masked raw score is -1e30 (-1e30 hd**-0.5 once scaled, where the TPU
// kernel has -1e30): finite and far below every visible score, so P is the
// same, and a row that has seen only masked keys so far weighs them 1 until
// its first visible key rescales them by alpha = 0, as there.
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kv0, const Rows& r) {
  const bool edge = kv0 + BKV > r.Skv || (r.causal && kv0 + BKV - 1 > r.qa) ||
                    (r.window && kv0 <= r.qa + 63 - r.window);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sc[4 * j + 2 * h + c];
        if (edge) {
          const int key = kv0 + 8 * j + 2 * (r.lane % 4) + c, q = r.qr + 8 * h;
          const bool visible = (!r.causal || key <= q) && (!r.window || key > q - r.window);
          x = key >= r.Skv ? -INFINITY : (visible ? x : NEG_INF);
          sc[4 * j + 2 * h + c] = x;
        }
        mx[h] = fmaxf(mx[h], x);
      }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * r.sl2);
    m[h] = mx[h];
    l[h] *= alpha[h];
    ms[h] = mx[h] * r.sl2;
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float pv = ex2(fmaf(sc[4 * j + 2 * h + c], r.sl2, -ms[h]));
        l[h] += pv;
        sc[4 * j + 2 * h + c] = pv;
      }
}

// P rounded to bf16 as the A operand of P·V: the scores' accumulator layout
// is the A fragment's, two columns per register.
__device__ __forceinline__ void pack_p(uint32_t (&p)[BKV / 16][4], const float (&sc)[BKV / 2]) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p[j / 2][2 * (j % 2) + h] = hopper::pack_bf16(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
}

// Work item w (a 128-row query tile of one head), longest bands first:
// the query tiles from the last, heads fastest.  Round r of the persistent
// grid takes items r G .. r G + G - 1, block b the b-th of them, in
// reverse on odd rounds, so a block that drew a long band draws a short one
// next and the blocks' totals stay within a tile or two of each other.
__device__ __forceinline__ int item_index(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

struct Item {
  int q0, bh, lo, n_kv;
};

__device__ __forceinline__ Item item_at(int w, int BH, int S, int Skv, int causal, int window) {
  Item it;
  const int nq = (S + BQ - 1) / BQ;
  it.q0 = (nq - 1 - w / BH) * BQ;
  it.bh = w % BH;
  int hi;
  band<BQ, BKV>(it.q0, S, Skv, causal, window, it.lo, hi);
  it.n_kv = (hi - it.lo + BKV - 1) / BKV;
  return it;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                   int BH, int S, int Skv, int hd, int causal, int window, float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* ks = smem + TILE;                 // STAGES K tiles, then STAGES V tiles
  uint8_t* vs = smem + (1 + STAGES) * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + (1 + 2 * STAGES) * TILE);
  uint64_t* q_empty = q_full + 1;        // Q is free once every consumer warp has read it
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;   // a K slot is free once its scores are done,
  uint64_t* v_empty = k_empty + STAGES;  // a V slot once its P·V is

  const int work = ((S + BQ - 1) / BQ) * BH;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * 4);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // producer: per work item Q, then K and V of each live KV tile into the
    // ring, which runs on across items (c counts the KV tiles)
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int c = 0;
      for (int j = 0; item_index(j) < work; ++j) {
        const Item it = item_at(item_index(j), BH, S, Skv, causal, window);
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, TILE);
        tma_load_3d(qs, &q_map, q_full, 0, it.q0, it.bh);
        tma_load_3d(qs + HALF, &q_map, q_full, 64, it.q0, it.bh);
        for (int i = 0; i < it.n_kv; ++i, ++c) {
          const int s = c % STAGES, kv0 = it.lo + i * BKV;
          const uint32_t free_parity = ((c / STAGES) & 1) ^ 1;
          mbar_wait(&k_empty[s], free_parity);
          mbar_expect_tx(&k_full[s], TILE);
          tma_load_3d(ks + s * TILE, &k_map, &k_full[s], 0, kv0, it.bh);
          tma_load_3d(ks + s * TILE + HALF, &k_map, &k_full[s], 64, kv0, it.bh);
          mbar_wait(&v_empty[s], free_parity);
          mbar_expect_tx(&v_full[s], TILE);
          tma_load_3d(vs + s * TILE, &v_map, &v_full[s], 0, kv0, it.bh);
          tma_load_3d(vs + s * TILE + HALF, &v_map, &v_full[s], 64, kv0, it.bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    float o[HD / 2], sc[BKV / 2], alpha[2];
    uint32_t p[BKV / 16][4], qf[HD / 16][4];
    int c = 0;
    for (int j = 0; item_index(j) < work; ++j) {
      const Item it = item_at(item_index(j), BH, S, Skv, causal, window);
      // this thread's two query rows (h = 0, 1) and its warpgroup's 64
      const int qa = it.q0 + 64 * wgi, qr = qa + 16 * warp + lane / 4;
      const Rows rows{qa, qr, lane, Skv, causal, window, scale * LOG2E};
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};  // l: this thread's share
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      mbar_wait(q_full, j & 1);
      load_q(qf, qs, wgi, warp, lane);
      if (lane == 0) mbar_arrive(q_empty);  // each warp, once its ldmatrix are done

      // Tile i's scores are started before tile i-1's P·V, and tile i's
      // softmax runs while that P·V is on the tensor cores.
      if (it.n_kv > 0) {
        const int s = c % STAGES;
        mbar_wait(&k_full[s], (c / STAGES) & 1);
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) fence_regs(qf[kk]);
        wgmma_fence();
        start_qk(sc, qf, ks + s * TILE);
        wgmma_wait<0>();
        fence_regs(sc);
        if (t128 == 0) mbar_arrive(&k_empty[s]);
        softmax_tile(sc, m, l, alpha, it.lo, rows);
        pack_p(p, sc);
      }
      for (int i = 1; i < it.n_kv; ++i) {
        const int ci = c + i, s = ci % STAGES, sp = (ci - 1) % STAGES;
        mbar_wait(&k_full[s], (ci / STAGES) & 1);
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(p[kk]);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) fence_regs(qf[kk]);
        wgmma_fence();
        start_qk(sc, qf, ks + s * TILE);
        mbar_wait(&v_full[sp], ((ci - 1) / STAGES) & 1);
        start_pv(o, p, vs + sp * TILE);
        wgmma_wait<1>();  // the scores are done; P·V may still run
        fence_regs(sc);
        if (t128 == 0) mbar_arrive(&k_empty[s]);
        softmax_tile(sc, m, l, alpha, it.lo + i * BKV, rows);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(p[kk]);
        if (t128 == 0) mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            o[4 * jj + 2 * h] *= alpha[h];
            o[4 * jj + 2 * h + 1] *= alpha[h];
          }
        pack_p(p, sc);
      }
      if (it.n_kv > 0) {
        const int cl = c + it.n_kv - 1, sl = cl % STAGES;
        mbar_wait(&v_full[sl], (cl / STAGES) & 1);
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(p[kk]);
        wgmma_fence();
        start_pv(o, p, vs + sl * TILE);
        wgmma_wait<0>();
        fence_regs(o);
        if (t128 == 0) mbar_arrive(&v_empty[sl]);
      }
      c += it.n_kv;

      // out = o / max(l, 1e-30), rows past S and columns past hd not
      // stored; the producer is loading the next item meanwhile
      __nv_bfloat16* ob = out + (size_t)it.bh * S * hd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lt = l[h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.0f / fmaxf(lt, 1e-30f);
        const int q = qr + 8 * h;
        if (q >= S) continue;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          const int col = 8 * jj + 2 * (lane % 4);
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)q * hd + col) =
                __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
        }
      }
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int Skv,
           int hd, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint64_t q_dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t q_strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)hd, (cuuint64_t)Skv, (cuuint64_t)BH};
  const cuuint64_t kv_strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)Skv * hd * 2};
  int err = hopper::make_map(&q_map, q, 3, q_dims, q_strides, box);
  if (!err) err = hopper::make_map(&k_map, k, 3, kv_dims, kv_strides, box);
  if (!err) err = hopper::make_map(&v_map, v, 3, kv_dims, kv_strides, box);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int work = ((S + BQ - 1) / BQ) * BH;
  const int sms = hopper::sm_count(), grid = work < sms ? work : sms;
  flash_wgmma_kernel<<<grid, THREADS, SMEM, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, BH, S, Skv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---- fp32: FMA, scores and softmax through shared memory --------------------

namespace f32 {

using ragged::load_tile;

constexpr int BQ = 64, BKV = 64, THREADS = ragged::THREADS, HD_MAX = 128;
static_assert(THREADS == 128 && BQ == 4 * 16, "four warps of 16 query rows");

// shared-memory pitches in floats, padded against bank conflicts
constexpr int QL = HD_MAX + 4, PL = BKV + 4, S_LD = BKV + 4;
constexpr size_t SMEM = (3 * (size_t)BQ * QL + (size_t)BQ * S_LD + (size_t)BQ * PL + 3 * BQ) *
                        sizeof(float);

struct Smem {
  float* q;
  float* k;
  float* v;
  float* s;
  float* p;
  float* m;
  float* l;
  float* alpha;
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem sm;
  sm.q = reinterpret_cast<float*>(base);
  sm.k = sm.q + BQ * QL;
  sm.v = sm.q + 2 * BQ * QL;
  sm.s = sm.q + 3 * BQ * QL;
  sm.p = sm.s + BQ * S_LD;
  sm.m = sm.p + BQ * PL;
  sm.l = sm.m + BQ;
  sm.alpha = sm.l + BQ;
  return sm;
}

// One warp's online-softmax step over its 16 rows of the fp32 scores of the
// KV tile at kv0: two lanes per row, 32 columns each.  Writes P and the
// row's new m, l and rescale factor alpha = exp(m_prev - m_new).
__device__ __forceinline__ void softmax_rows(const Smem& sm, int r0, int q0, int kv0, int Skv,
                                             int causal, int window, float scale) {
  const int lane = threadIdx.x % 32, half = lane & 1;
  const int row = r0 + (lane >> 1), qpos = q0 + row;
  float sv[32];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = half * 32 + c, kpos = kv0 + col;
    float s = sm.s[row * S_LD + col] * scale;
    const bool visible = (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
    s = visible ? s : NEG_INF;
    if (kpos >= Skv) s = -INFINITY;  // no such key: p = 0, and not in the max
    sv[c] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_prev = sm.m[row];
  const float m_new = fmaxf(m_prev, mx);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float p = expf(sv[c] - m_new);
    sm.p[row * PL + half * 32 + c] = p;
    sum += p;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0) {
    const float alpha = expf(m_prev - m_new);
    sm.m[row] = m_new;
    sm.l[row] = sm.l[row] * alpha + sum;
    sm.alpha[row] = alpha;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int BH, int S, int Skv,
                 int hd, int causal, int window, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  float *qs = sm.q, *ks = sm.k, *vs = sm.v, *ps = sm.p;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BQ, bh = blockIdx.x % BH;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  // each lane: rows r0 + rg*4 + i (i < 4); score columns cg*8 + j (j < 8),
  // output columns cg*16 + j (j < 16)
  const int rg = lane / 8, cg = lane % 8;
  const bool o_live = cg * 16 < hdp;
  const float* kb = k + (size_t)bh * Skv * hd;
  const float* vb = v + (size_t)bh * Skv * hd;
  int lo, hi;
  band<BQ, BKV>(q0, S, Skv, causal, window, lo, hi);

  load_tile(qs, QL, q + (size_t)bh * S * hd, hd, BQ, hdp, q0, 0, S, hd);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.0f;
  }
  __syncthreads();
  float o[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) o[i][j] = 0.0f;

  for (int kv0 = lo; kv0 < hi; kv0 += BKV) {
    load_tile(ks, QL, kb, hd, BKV, hdp, kv0, 0, Skv, hd);
    load_tile(vs, QL, vb, hd, BKV, hdp, kv0, 0, Skv, hd);
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int c = 0; c < hd; ++c) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(r0 + rg * 4 + i) * QL + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ks[(cg * 8 + j) * QL + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.s[(r0 + rg * 4 + i) * S_LD + cg * 8 + j] = acc[i][j];
    __syncwarp();
    softmax_rows(sm, r0, q0, kv0, Skv, causal, window, scale);
    __syncwarp();
    if (o_live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = sm.alpha[r0 + rg * 4 + i];
#pragma unroll
        for (int j = 0; j < 16; ++j) o[i][j] *= alpha;
      }
      for (int c = 0; c < BKV; ++c) {
        float p[4], vv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ps[(r0 + rg * 4 + i) * PL + c];
#pragma unroll
        for (int j = 0; j < 16; ++j) vv[j] = vs[c * QL + cg * 16 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
      }
    }
    __syncthreads();  // before the next tile overwrites K and V
  }

  if (!o_live) return;
  float* ob = out + (size_t)bh * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i, qpos = q0 + row;
    if (qpos >= S) continue;
    const float l = fmaxf(sm.l[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = cg * 16 + j;
      if (c < hd) ob[(size_t)qpos * hd + c] = o[i][j] / l;
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int Skv,
           int hd, int causal, int window, float scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  flash_f32_kernel<<<(unsigned)nq * (unsigned)BH, THREADS, SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, BH, S, Skv, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns the
// first CUDA error of the set-up and the launch (0 = launched).
// q, out: (BH, S, hd); k, v: (BH, Skv, hd); window 0 = none.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BH, int S, int Skv, int hd, int causal, int window,
                                    float scale, void* stream) {
  return wg::launch(q, k, v, out, BH, S, Skv, hd, causal, window, scale, (cudaStream_t)stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int BH, int S, int Skv, int hd, int causal, int window,
                                   float scale, void* stream) {
  return f32::launch(q, k, v, out, BH, S, Skv, hd, causal, window, scale, (cudaStream_t)stream);
}
