// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:76
// flash_attention (body _flash_kernel): q (BH, S, hd), k and v (BH, Skv, hd),
// heads folded into the leading dim and KV already repeated, ->
//   out = softmax(q kᵀ * hd**-0.5) v   over the visible (query, key) pairs,
// key k visible from query q when k <= q (causal) and k > q - window (a
// window, with or without causal); a masked score is -1e30, finite as in the
// TPU kernel, so exp(s - m) never meets inf - inf.  The running max m and
// denominator l are fp32; out = acc / max(l, 1e-30), cast to q's type.
//
// Design (first, simple kernel): one block of 128 threads per (bh, 64-row
// query tile); the longest causal bands are launched first.  A loop runs over
// the live 64-row KV tiles only, from the tile holding q0 - window + 1 to the
// diagonal tile (the last KV tile when not causal), so causal and window work
// follows the band; a tile wholly masked is never visited.  Q stays in shared
// memory, K and V tiles are staged there with 16-byte loads (ragged_tile.cuh's
// load_tile; rows past S or Skv and columns past hd zero-filled).  Each warp
// owns 16 query rows: their scores, their online softmax (two lanes per row)
// and their output rows, so only the K/V staging needs the whole block.  Each
// block writes its own output tile: no atomics, and the result is
// deterministic.  Rows and keys past S and Skv are masked, so any S and Skv
// work (the TPU wrapper instead halves its blocks until they divide S).
//   bf16: q kᵀ on WMMA 16x16x16 (exact bf16 products, fp32 sums).  P is
//         rounded to bf16 for a WMMA P·V with fp32 sums, and the output
//         accumulator stays in WMMA fragments; the TPU kernel keeps P in fp32
//         there, so this is the one rounding point it does not have (l is
//         summed from the fp32 P).
//   fp32: both products on FMA in fp32; nothing is rounded.
// hd must be a multiple of 8, at most 128 (padded to 16 inside); the wrapper
// checks it, and the pointers' 16-byte alignment.
//
// What bounds it on an H100: the tensor cores.  At Mixtral-8x7B's prefill
// shapes (BH = 64, S = 2048, hd = 128, causal) the visible pairs are 68.7
// GFLOP (0.070 ms at 989 TFLOP/s) against 134 MB of q, k, v and out (0.040 ms
// at 3.35 TB/s).  This kernel has one tile in flight per block and rounds
// through shared memory for the softmax; PERF.md has its time.

#include <math.h>

#include "ragged_tile.cuh"

namespace {

using namespace nvcuda;
using ragged::from_f;
using ragged::load_tile;

constexpr int BQ = 64, BKV = 64, THREADS = ragged::THREADS, HD_MAX = 128;
constexpr float NEG_INF = -1e30f;
static_assert(THREADS == 128 && BQ == 4 * 16, "four warps of 16 query rows");

// shared-memory pitches in elements, padded against bank conflicts and kept
// multiples of 16 bytes as WMMA requires
template <typename T>
__host__ __device__ constexpr int qkv_ld() {
  return sizeof(T) == 2 ? HD_MAX + 8 : HD_MAX + 4;
}
template <typename T>
__host__ __device__ constexpr int p_ld() {
  return sizeof(T) == 2 ? BKV + 8 : BKV + 4;
}
constexpr int S_LD = BKV + 4;   // fp32 scores
constexpr int O_LD = HD_MAX + 4;  // fp32 output staging (bf16), over the K and V tiles

template <typename T>
constexpr size_t smem_bytes() {
  return 3 * (size_t)BQ * qkv_ld<T>() * sizeof(T) + (size_t)BQ * S_LD * sizeof(float) +
         (size_t)BQ * p_ld<T>() * sizeof(T) + 3 * BQ * sizeof(float);
}
static_assert((size_t)BQ * O_LD * sizeof(float) <= 2 * (size_t)BKV * (HD_MAX + 8) * 2,
              "the bf16 output staging fits over the K and V tiles");

struct Smem {
  void* q;
  void* k;
  void* v;
  float* s;
  void* p;
  float* m;
  float* l;
  float* alpha;
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* base) {
  constexpr int QL = qkv_ld<T>(), PL = p_ld<T>();
  Smem sm;
  T* q = reinterpret_cast<T*>(base);
  sm.q = q;
  sm.k = q + BQ * QL;
  sm.v = q + 2 * BQ * QL;
  sm.s = reinterpret_cast<float*>(q + 3 * BQ * QL);
  T* p = reinterpret_cast<T*>(sm.s + BQ * S_LD);
  sm.p = p;
  sm.m = reinterpret_cast<float*>(p + BQ * PL);
  sm.l = sm.m + BQ;
  sm.alpha = sm.l + BQ;
  return sm;
}

// One warp's online-softmax step over its 16 rows of the fp32 scores of the
// KV tile at kv0: two lanes per row, 32 columns each.  Writes P (in T) and
// the row's new m, l and rescale factor alpha = exp(m_prev - m_new).
template <typename T>
__device__ __forceinline__ void softmax_rows(const Smem& sm, int r0, int q0, int kv0, int Skv,
                                             int causal, int window, float scale) {
  constexpr int PL = p_ld<T>();
  const int lane = threadIdx.x % 32, half = lane & 1;
  const int row = r0 + (lane >> 1), qpos = q0 + row;
  T* ps = reinterpret_cast<T*>(sm.p);
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
    ps[row * PL + half * 32 + c] = from_f<T>(p);
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

// The live KV range of the query tile at q0: [lo, hi), lo a tile start.
__device__ __forceinline__ void band(int q0, int S, int Skv, int causal, int window, int& lo,
                                     int& hi) {
  const int q_last = min(q0 + BQ, S) - 1;
  lo = window ? max(0, q0 - window + 1) / BKV * BKV : 0;
  hi = causal ? min(Skv, q_last + 1) : Skv;
}

__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int BH,
                  int S, int Skv, int hd, int causal, int window, float scale) {
  using T = __nv_bfloat16;
  constexpr int QL = qkv_ld<T>(), PL = p_ld<T>(), NF = HD_MAX / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve<T>(smem);
  T *qs = (T*)sm.q, *ks = (T*)sm.k, *vs = (T*)sm.v, *ps = (T*)sm.p;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BQ, bh = blockIdx.x % BH;
  const int hdp = (hd + 15) & ~15, nf = hdp / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const T* kb = k + (size_t)bh * Skv * hd;
  const T* vb = v + (size_t)bh * Skv * hd;
  int lo, hi;
  band(q0, S, Skv, causal, window, lo, hi);

  load_tile(qs, QL, q + (size_t)bh * S * hd, hd, BQ, hdp, q0, 0, S, hd);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.0f;
  }
  // rowid: an accumulator fragment whose element t holds its row (0..15);
  // fragments of one type share their element mapping, so it names the row
  // of every output element for the per-row rescale and division
  for (int i = lane; i < 256; i += 32) sm.s[(r0 + i / 16) * S_LD + i % 16] = (float)(i / 16);
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> rowid, of[NF];
  wmma::load_matrix_sync(rowid, sm.s + r0 * S_LD, S_LD, wmma::mem_row_major);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qf[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    wmma::fill_fragment(of[i], 0.0f);
    if (i < nf) wmma::load_matrix_sync(qf[i], qs + r0 * QL + i * 16, QL);
  }
  __syncwarp();

  for (int kv0 = lo; kv0 < hi; kv0 += BKV) {
    load_tile(ks, QL, kb, hd, BKV, hdp, kv0, 0, Skv, hd);
    load_tile(vs, QL, vb, hd, BKV, hdp, kv0, 0, Skv, hd);
    __syncthreads();
    // scores of the warp's 16 rows against the 64 keys: q kᵀ, K read as a
    // column-major B operand in place
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (i < nf) {
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, ks + (j * 16) * QL + i * 16, QL);
          wmma::mma_sync(sf[j], qf[i], kf, sf[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j)
      wmma::store_matrix_sync(sm.s + r0 * S_LD + j * 16, sf[j], S_LD, wmma::mem_row_major);
    __syncwarp();
    softmax_rows<T>(sm, r0, q0, kv0, Skv, causal, window, scale);
    __syncwarp();
    // acc = acc * alpha + P V
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < nf)
#pragma unroll
        for (int t = 0; t < of[j].num_elements; ++t)
          of[j].x[t] *= sm.alpha[r0 + (int)rowid.x[t]];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, ps + r0 * PL + kk * 16, PL);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (j < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, vs + (kk * 16) * QL + j * 16, QL);
          wmma::mma_sync(of[j], pf, vf, of[j]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K and V
  }

  // out = acc / max(l, 1e-30), staged in fp32 over the K and V tiles
  __syncthreads();
  float* os = reinterpret_cast<float*>(ks);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (j < nf) {
#pragma unroll
      for (int t = 0; t < of[j].num_elements; ++t)
        of[j].x[t] = of[j].x[t] / fmaxf(sm.l[r0 + (int)rowid.x[t]], 1e-30f);
      wmma::store_matrix_sync(os + r0 * O_LD + j * 16, of[j], O_LD, wmma::mem_row_major);
    }
  }
  __syncwarp();
  T* ob = out + (size_t)bh * S * hd;
  for (int i = lane; i < 16 * hd; i += 32) {
    const int rr = i / hd, c = i % hd, qpos = q0 + r0 + rr;
    if (qpos < S) ob[(size_t)qpos * hd + c] = from_f<T>(os[(r0 + rr) * O_LD + c]);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int BH, int S, int Skv,
                 int hd, int causal, int window, float scale) {
  using T = float;
  constexpr int QL = qkv_ld<T>(), PL = p_ld<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve<T>(smem);
  T *qs = (T*)sm.q, *ks = (T*)sm.k, *vs = (T*)sm.v, *ps = (T*)sm.p;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BQ, bh = blockIdx.x % BH;
  const int hdp = (hd + 15) & ~15;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  // each lane: rows r0 + rg*4 + i (i < 4); score columns cg*8 + j (j < 8),
  // output columns cg*16 + j (j < 16)
  const int rg = lane / 8, cg = lane % 8;
  const bool o_live = cg * 16 < hdp;
  const T* kb = k + (size_t)bh * Skv * hd;
  const T* vb = v + (size_t)bh * Skv * hd;
  int lo, hi;
  band(q0, S, Skv, causal, window, lo, hi);

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
    softmax_rows<T>(sm, r0, q0, kv0, Skv, causal, window, scale);
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

template <typename T, typename K>
int launch(K kernel, const void* q, const void* k, const void* v, void* out, int BH, int S,
           int Skv, int hd, int causal, int window, float scale, void* stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  kernel<<<(unsigned)nq * (unsigned)BH, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, BH, S, Skv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns the
// first CUDA error of the attribute call and the launch (0 = launched).
// q, out: (BH, S, hd); k, v: (BH, Skv, hd); window 0 = none.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BH, int S, int Skv, int hd, int causal, int window,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(flash_bf16_kernel, q, k, v, out, BH, S, Skv, hd, causal, window,
                               scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int BH, int S, int Skv, int hd, int causal, int window,
                                   float scale, void* stream) {
  return launch<float>(flash_f32_kernel, q, k, v, out, BH, S, Skv, hd, causal, window, scale,
                       stream);
}
