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
//   ragged_matmul, bf16: the Hopper mainloop of ragged_wgmma.cuh (TMA ring,
//     wgmma, 128 x 256 tiles, or 64 x 256 when bm is not a multiple of 128)
//     with an epilogue that stores bf16 pairs straight from the registers,
//     rows past *total_rows (and whole dead tiles) as 0.
//   ragged_swiglu, bf16: the same mainloop with two weights (128 rows x 128
//     columns of f for each of w1 and w3, A by one 2-D TMA load, as
//     fused_moe.cu's up pass without its gather); the epilogue takes
//     silu(a) * b in fp32 from the fp32 sums and stores it as bf16 (the JAX
//     kernel's epilogue, one cast), dead rows and tiles as 0.  When bm is
//     not a multiple of 128 a tile keeps its first 64 or bm rows.
//   fp32 ragged_matmul and ragged_swiglu: the simple tiled loop of
//     ragged_tile.cuh (FMA, no pipelining), one block per 64 x 64 tile; dead
//     row blocks skip their products.
// PERF.md has each one's time against its bound.

#include "ragged_tile.cuh"
#include "ragged_wgmma.cuh"

namespace {

// ---- bf16 ragged_matmul: the shared Hopper mainloop ------------------------

// out (R, N) in bf16; rows past *total_rows, and dead tiles, as 0
struct RaggedStore {
  __nv_bfloat16* out;
  int N;
  struct Row {
    __nv_bfloat16* p;
    bool keep;
  };
  __device__ Row row(int grow, bool keep) const { return {out + (size_t)grow * N, keep}; }
  __device__ void put(const Row& r, int col, const float (&v)[1][2]) const {
    *reinterpret_cast<__nv_bfloat162*>(r.p + col) =
        __floats2bfloat162_rn(r.keep ? v[0][0] : 0.0f, r.keep ? v[0][1] : 0.0f);
  }
};

template <int TM, bool TRANS>
int launch_tile(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
                int R, int K, int N, int E, int bm, int tm, cudaStream_t stream) {
  using C = rw::Cfg<TM, 1, TRANS, false>;
  CUtensorMap a_map, b_map;
  int err = rw::map_rows(&a_map, x, R, K, TM);
  if (err) return err;
  if ((err = rw::map_weights(&b_map, w, E, K, N, TRANS, C::BN))) return err;
  const rw::Rows p{(const int*)b2e, (const int*)total_rows, nullptr, nullptr, R, K, N, bm, tm};
  return rw::launch<C>(a_map, b_map, b_map, p, RaggedStore{(__nv_bfloat16*)out, N}, stream);
}

// bf16 ragged_swiglu: silu(a) * b in fp32, one cast to bf16; rows past
// *total_rows, and dead tiles, as 0
struct SwigluStore {
  __nv_bfloat16* out;
  int N;
  struct Row {
    __nv_bfloat16* p;
    bool keep;
  };
  __device__ Row row(int grow, bool keep) const { return {out + (size_t)grow * N, keep}; }
  __device__ void put(const Row& r, int col, const float (&v)[2][2]) const {
    *reinterpret_cast<__nv_bfloat162*>(r.p + col) =
        r.keep ? __floats2bfloat162_rn(ragged::silu(v[0][0]) * v[1][0],
                                       ragged::silu(v[0][1]) * v[1][1])
               : __floats2bfloat162_rn(0.0f, 0.0f);
  }
};

// tm: the rows a tile keeps (128, 64 or bm < 64); the tile is 128 rows
int launch_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out, const void* b2e,
                       const void* total_rows, int R, int K, int N, int E, int bm, int tm,
                       cudaStream_t stream) {
  using C = rw::Cfg<128, 2, false, false>;
  CUtensorMap a_map, w1_map, w3_map;
  int err = rw::map_rows(&a_map, x, R, K, C::TM);
  if (err) return err;
  if ((err = rw::map_weights(&w1_map, w1, E, K, N, false, C::BN))) return err;
  if ((err = rw::map_weights(&w3_map, w3, E, K, N, false, C::BN))) return err;
  const rw::Rows p{(const int*)b2e, (const int*)total_rows, nullptr, nullptr, R, K, N, bm, tm};
  return rw::launch<C>(a_map, w1_map, w3_map, p, SwigluStore{(__nv_bfloat16*)out, N}, stream);
}

// tm: the rows a tile keeps, 128 when bm is a multiple of 128 (128-row
// tiles), else 64 or bm (64-row tiles).
int launch_bf16(const void* x, const void* w, void* out, const void* b2e, const void* total_rows,
                int R, int K, int N, int E, int bm, int tm, int trans, cudaStream_t stream) {
  if (tm == 128)
    return trans ? launch_tile<128, true>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream)
                 : launch_tile<128, false>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream);
  return trans ? launch_tile<64, true>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream)
               : launch_tile<64, false>(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, stream);
}

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
    tile<NW, TRANS>(x, nullptr, w + e * K * N, NW == 2 ? w3 + e * K * N : nullptr, m0, tm, n0,
                    K, N, cs);
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

int launch_swiglu_f32(const void* x, const void* w1, const void* w3, void* out, const void* b2e,
                      const void* total_rows, int R, int K, int N, int bm, int tm, void* stream) {
  using T = float;
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
  return launch_bf16(x, w, out, b2e, total_rows, R, K, N, E, bm, tm, trans,
                     (cudaStream_t)stream);
}

extern "C" int ragged_matmul_f32(const void* x, const void* w, void* out, const void* b2e,
                                 const void* total_rows, int R, int K, int N, int bm, int tm,
                                 int trans, int E, void* stream) {
  return launch_f32(x, w, out, b2e, total_rows, R, K, N, bm, tm, trans, stream);
}

// w1, w3: (E, K, N); tm as above (bf16: kernels/ragged_mlp.py::row_tile, wide).
extern "C" int ragged_swiglu_bf16(const void* x, const void* w1, const void* w3, void* out,
                                  const void* b2e, const void* total_rows, int R, int K, int N,
                                  int bm, int tm, int E, void* stream) {
  return launch_swiglu_bf16(x, w1, w3, out, b2e, total_rows, R, K, N, E, bm, tm,
                            (cudaStream_t)stream);
}

extern "C" int ragged_swiglu_f32(const void* x, const void* w1, const void* w3, void* out,
                                 const void* b2e, const void* total_rows, int R, int K, int N,
                                 int bm, int tm, int E, void* stream) {
  return launch_swiglu_f32(x, w1, w3, out, b2e, total_rows, R, K, N, bm, tm, stream);
}
