// The fused MoE expert leg for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_moe.py:105
// fused_moe (body _fused_kernel): over the ragged layout (R rows in bm-row
// blocks, block i of expert b2e[i], rows at or past *total_rows dead),
//   h[r]   = silu(x[src[r]] @ w1[e]) * (x[src[r]] @ w3[e])   fp32 sums, cast
//            to x's type (the TPU kernel's epilogue cast)
//   y[r]   = h[r] @ w2[e]                                    fp32
//   out[t] = sum over rows r with src[r] == t of wslot[r] * y[r]   fp32, then
//            cast to x's type
// Token rows are gathered straight from x through src, so the (R, d)
// dispatch buffer never exists.
//
// What differs from the TPU kernel, and why: it keeps a (bm, f) fp32
// accumulator pair and the whole (T, d) fp32 output resident in VMEM for
// the whole grid.  At Mixtral's f = 14336 neither fits the 227 KB of shared
// memory a Hopper block can have, and blocks run in no order.  So the leg is
// split at the point where the TPU kernel already rounds h, and one call of
// the wrapper is a memset of the (T, d) fp32 output and three launches:
//   1. up:    gather x rows through src, both up-projections, silu * mul,
//             h stored to an (R, f) workspace in x's type;
//   2. down:  h @ w2[e] in fp32, each row's wslot-weighted y added into the
//             zeroed (T, d) fp32 output at row src[r] with atomicAdd;
//   3. cast:  the fp32 output to x's type (bf16 only; fp32 returns it).
// Dead tiles (at or past *total_rows) skip both products.
//
// Which dtype runs which kernel:
//   bf16: the Hopper mainloop of ragged_wgmma.cuh (TMA ring, wgmma, fp32
//     sums in registers) for both passes.  Up: 128 rows x 128 columns of f
//     for each of w1 and w3 (two consumer warpgroups, 2 x 64 accumulators a
//     thread), A's rows gathered by the producer warpgroup with cp.async
//     (TMA cannot gather), the weights by TMA; silu(a) * b taken in
//     registers and stored as bf16 pairs.  Down: ragged_matmul's
//     configuration (128 x 256 tiles, or 64 x 256 when bm is not a multiple
//     of 128) on h @ w2, with the combine as its epilogue.
//   fp32: the simple tiled loop of ragged_tile.cuh, one block per 64 x 64
//     tile, for both passes.
//
// The combine is fp32 atomicAdd: exact and deterministic on the training
// path, where the EP leg's slot map is (T_recv, 1) (each token has one row,
// so its sum is 0 + one term), and for K > 1 rows per token equal to the
// plain version's ascending-row sum up to fp32 reordering, held to
// tolerance.
//
// What bounds it on an H100: the tensor cores.  At the training path's
// shapes (T = 4096 received rows, R = 5120, d = 4096, f = 14336, bf16) the
// three products are 3 x 2 R d f = 1.80 TFLOP, 1.83 ms at 989 TFLOP/s,
// against 2.9 GB of weights and rows at 3.35 TB/s (0.86 ms).  PERF.md has
// each kernel's time against its bound.

#include "ragged_tile.cuh"
#include "ragged_wgmma.cuh"

namespace {

// ---- bf16: the shared Hopper mainloop --------------------------------------

// up pass: h (R, f) = silu(a) * b in bf16; dead rows and tiles store nothing
// (the down pass skips the same tiles)
struct FusedUpStore {
  __nv_bfloat16* h;
  int N;
  __device__ __nv_bfloat16* row(int grow, bool keep) const {
    return keep ? h + (size_t)grow * N : nullptr;
  }
  __device__ void put(__nv_bfloat16* r, int col, const float (&v)[2][2]) const {
    if (r == nullptr) return;
    *reinterpret_cast<__nv_bfloat162*>(r + col) = __floats2bfloat162_rn(
        ragged::silu(v[0][0]) * v[1][0], ragged::silu(v[0][1]) * v[1][1]);
  }
};

// down pass: out[src[r]] += wslot[r] * y[r] in fp32, live rows with a token
struct FusedCombine {
  float* out;
  const int* src;
  const __nv_bfloat16* wslot;
  int N;
  struct Row {
    float* p;
    float w;
  };
  __device__ Row row(int grow, bool keep) const {
    const int t = keep ? src[grow] : -1;
    return t >= 0 ? Row{out + (size_t)t * N, __bfloat162float(wslot[grow])} : Row{nullptr, 0.0f};
  }
  __device__ void put(const Row& r, int col, const float (&v)[1][2]) const {
    if (r.p == nullptr) return;
    atomicAdd(r.p + col, __fmul_rn(v[0][0], r.w));
    atomicAdd(r.p + col + 1, __fmul_rn(v[0][1], r.w));
  }
};

template <int TM>
int launch_down(const void* h, const void* w2, const rw::Rows& p, const FusedCombine& epi,
                int E, cudaStream_t s) {
  using C = rw::Cfg<TM, 1, false, false>;
  CUtensorMap h_map, w2_map;
  int err = rw::map_rows(&h_map, h, p.R, p.K, TM);
  if (err) return err;
  if ((err = rw::map_weights(&w2_map, w2, E, p.K, p.N, false, C::BN))) return err;
  return rw::launch<C>(h_map, w2_map, w2_map, p, epi, s);
}

// the up and down passes; tm: the rows a tile keeps (128, 64 or bm < 64)
int launch_passes_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                       const void* src, const void* wslot, const void* b2e,
                       const void* total_rows, void* h, float* acc, int R, int d, int f, int E,
                       int bm, int tm, cudaStream_t s) {
  using Up = rw::Cfg<128, 2, false, true>;
  CUtensorMap w1_map, w3_map;
  int err = rw::map_weights(&w1_map, w1, E, d, f, false, Up::BN);
  if (err) return err;
  if ((err = rw::map_weights(&w3_map, w3, E, d, f, false, Up::BN))) return err;
  const rw::Rows up{(const int*)b2e, (const int*)total_rows, (const int*)src,
                    (const __nv_bfloat16*)x, R, d, f, bm, tm};
  // A's rows are gathered, so its map is never read: w1's stands in
  if ((err = rw::launch<Up>(w1_map, w1_map, w3_map, up,
                            FusedUpStore{(__nv_bfloat16*)h, f}, s)))
    return err;
  const rw::Rows down{(const int*)b2e, (const int*)total_rows, nullptr, nullptr, R, f, d, bm, tm};
  const FusedCombine epi{acc, (const int*)src, (const __nv_bfloat16*)wslot, d};
  return tm == 128 ? launch_down<128>(h, w2, down, epi, E, s)
                   : launch_down<64>(h, w2, down, epi, E, s);
}

// ---- fp32: the tile loop of ragged_tile.cuh --------------------------------

using namespace ragged;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_up_kernel(const T* __restrict__ x, const int* __restrict__ src, const T* __restrict__ w1,
                const T* __restrict__ w3, const int* __restrict__ b2e,
                const int* __restrict__ total_rows, T* __restrict__ h, int d, int f, int bm,
                int tm) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const int m0 = blockIdx.y * tm, n0 = blockIdx.x * BN;
  if (m0 >= *total_rows) return;  // dead block: the down pass skips it too
  const size_t e = (size_t)b2e[m0 / bm];
  tile<2, false>(x, src, w1 + e * d * f, w3 + e * d * f, m0, tm, n0, d, f, cs);
  store_tile(h, cs, m0, tm, n0, f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_down_kernel(const T* __restrict__ h, const int* __restrict__ src,
                  const T* __restrict__ wslot, const T* __restrict__ w2,
                  const int* __restrict__ b2e, const int* __restrict__ total_rows,
                  float* __restrict__ acc, int d, int f, int bm, int tm) {
  __shared__ __align__(128) float cs[BM * CS_LD];
  const int m0 = blockIdx.y * tm, n0 = blockIdx.x * BN;
  if (m0 >= *total_rows) return;
  const size_t e = (size_t)b2e[m0 / bm];
  tile<1, false>(h, nullptr, w2 + e * f * d, nullptr, m0, tm, n0, f, d, cs);
  for (int idx = threadIdx.x; idx < tm * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int t = src[m0 + r];
    if (t >= 0 && n0 + c < d)
      atomicAdd(acc + (size_t)t * d + n0 + c,
                __fmul_rn(cs[r * CS_LD + c], wslot[m0 + r]));
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                 size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(in[i]);
}

template <typename T>
int launch(const void* x, const void* w1, const void* w3, const void* w2, const void* src,
           const void* wslot, const void* b2e, const void* total_rows, void* h, float* acc,
           void* out, int T_tok, int R, int d, int f, int E, int bm, int tm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)T_tok * d * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2) {
    const int rc = launch_passes_bf16(x, w1, w3, w2, src, wslot, b2e, total_rows, h, acc, R, d,
                                      f, E, bm, tm, s);
    if (rc != 0) return rc;
  } else {
    fused_up_kernel<T><<<dim3((f + BN - 1) / BN, R / tm), THREADS, 0, s>>>(
        (const T*)x, (const int*)src, (const T*)w1, (const T*)w3, (const int*)b2e,
        (const int*)total_rows, (T*)h, d, f, bm, tm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fused_down_kernel<T><<<dim3((d + BN - 1) / BN, R / tm), THREADS, 0, s>>>(
        (const T*)h, (const int*)src, (const T*)wslot, (const T*)w2, (const int*)b2e,
        (const int*)total_rows, acc, d, f, bm, tm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (out != nullptr) {
    const size_t n = (size_t)T_tok * d;
    cast_bf16_kernel<<<(unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, s>>>(
        acc, (__nv_bfloat16*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, returns
// the first CUDA error of the memset and launches (0 = all launched).
// h: (R, f) workspace in x's type; acc: (T, d) fp32 output; out: (T, d)
// bf16 (the bf16 entry point casts acc into it); E experts; tm: the rows a
// tile keeps (kernels/ragged_mlp.py::row_tile, wide for bf16).
extern "C" int fused_moe_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                              const void* src, const void* wslot, const void* b2e,
                              const void* total_rows, void* h, void* acc, void* out, int T,
                              int R, int d, int f, int E, int bm, int tm, void* stream) {
  return launch<__nv_bfloat16>(x, w1, w3, w2, src, wslot, b2e, total_rows, h, (float*)acc, out,
                               T, R, d, f, E, bm, tm, stream);
}

extern "C" int fused_moe_f32(const void* x, const void* w1, const void* w3, const void* w2,
                             const void* src, const void* wslot, const void* b2e,
                             const void* total_rows, void* h, void* acc, int T, int R, int d,
                             int f, int E, int bm, int tm, void* stream) {
  return launch<float>(x, w1, w3, w2, src, wslot, b2e, total_rows, h, (float*)acc, nullptr, T,
                       R, d, f, E, bm, tm, stream);
}
