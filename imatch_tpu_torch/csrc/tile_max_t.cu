// K6: tile-max scoring over a corpus stored transposed, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces scripts/exp_pallas_search.py::_tile_max_kernel_T (launched by
// phase1_transposed there). The corpus is (Dp, N) bf16, feature-major;
// validity rides in the penalty feature row, as in the script (the query
// has 1 there, an invalid row -4), so there is no mask operand. For each
// query q and each tile t of tile_n corpus columns it writes
//   out[q, t] = max over the columns c of tile t of sum_d q[q, d] * c_t[d, c]
// accumulated in fp32.
//
// What bounds it on the card: the corpus bytes, read once per query chunk,
// over the 3.35 TB/s of HBM3 (0.40 ms at (640, 2^20), 0.33 ms at 528). The
// TPU experiment asked whether a transposed corpus saves its matrix unit a
// relayout (exp_pallas_search.py:7-14). Here the layout is a question of the
// load pattern, and this design answers it for the transposed layout:
// neighbouring threads take neighbouring corpus columns, each thread loads
// 8 consecutive bf16 columns (16 bytes) of a feature row, so a warp reads
// 512 contiguous bytes a row and every load coalesces along N. Each thread
// then owns 8 whole dot products per query, summed over the feature rows in
// order in fp32 FMAs: no shuffle reduction for the dot, only for the tile
// max (warp shuffles, then shared memory). The query chunk (up to 8) sits
// in shared memory as fp32 and every read of it is a broadcast. One block
// covers 2048 columns a pass: several tiles when tile_n < 2048, or one
// tile in tile_n / 2048 passes. One plain store per (query, tile), no
// atomics. Tensor cores are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int COLS = 8;                  // columns a thread: one 16-byte load
constexpr int WARP_COLS = 32 * COLS;     // 256 columns a warp
constexpr int SPAN = NTHREADS * COLS;    // 2048 columns a block pass
constexpr float NEG_INF = -3.0e38f;

template <int QC>
__global__ void __launch_bounds__(NTHREADS)
tile_max_t_kernel(const __nv_bfloat16* __restrict__ queries,
                  const __nv_bfloat16* __restrict__ corpus_t, float* __restrict__ out, int Q,
                  int D, int N, int tile_n, int n_tiles, int tiles_per_block, int passes) {
  extern __shared__ __align__(16) float qs[];  // QC x D, fp32
  __shared__ float red[NWARPS][QC];

  const int qbase = blockIdx.y * QC;
  const int nq = min(QC, Q - qbase);
  for (int i = threadIdx.x; i < QC * D; i += NTHREADS) {
    qs[i] = i / D < nq ? __bfloat162float(queries[size_t(qbase) * D + i]) : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t col_base = size_t(blockIdx.x) * tiles_per_block * tile_n;

  float best[QC];
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) best[qi] = NEG_INF;

  for (int pass = 0; pass < passes; ++pass) {
    const size_t c0 = col_base + size_t(pass) * SPAN + size_t(threadIdx.x) * COLS;
    if (c0 >= size_t(N)) continue;  // past the last tile: contributes nothing
    float acc[QC][COLS];
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
#pragma unroll
      for (int e = 0; e < COLS; ++e) acc[qi][e] = 0.f;
    }
    const __nv_bfloat16* col = corpus_t + c0;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(col + size_t(d) * N));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float x[COLS];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) {
        const float qv = qs[qi * D + d];
#pragma unroll
        for (int e = 0; e < COLS; ++e) acc[qi][e] = fmaf(qv, x[e], acc[qi][e]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
#pragma unroll
      for (int e = 0; e < COLS; ++e) best[qi] = fmaxf(best[qi], acc[qi][e]);
    }
  }

  // A warp's 256 columns lie in one tile (tile_n is a multiple of 256).
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      best[qi] = fmaxf(best[qi], __shfl_xor_sync(0xffffffffu, best[qi], m));
  }
  if (lane == 0) {
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) red[warp][qi] = best[qi];
  }
  __syncthreads();
  if (threadIdx.x < tiles_per_block * nq) {
    const int t = threadIdx.x / nq;
    const int q = threadIdx.x % nq;
    const int tile = blockIdx.x * tiles_per_block + t;
    if (tile < n_tiles) {
      float m = NEG_INF;
      for (int w = 0; w < NWARPS; ++w) {
        if ((w * WARP_COLS) / tile_n == t) m = fmaxf(m, red[w][q]);  // 0 when tile_n >= SPAN
      }
      out[size_t(qbase + q) * n_tiles + tile] = m;
    }
  }
}

template <int QC>
cudaError_t launch(const __nv_bfloat16* queries, const __nv_bfloat16* corpus_t, float* out, int Q,
                   int D, int N, int tile_n, cudaStream_t stream) {
  const int n_tiles = N / tile_n;
  const int tiles_per_block = tile_n < SPAN ? SPAN / tile_n : 1;
  const int passes = tile_n < SPAN ? 1 : tile_n / SPAN;
  const size_t smem = sizeof(float) * size_t(QC) * D;
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(tile_max_t_kernel<QC>, int(smem), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, (Q + QC - 1) / QC);
  tile_max_t_kernel<QC><<<grid, NTHREADS, smem, stream>>>(queries, corpus_t, out, Q, D, N, tile_n,
                                                          n_tiles, tiles_per_block, passes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries (Q, D) bf16 and corpus_t (D, N) bf16, row-major; N a multiple of
// tile_n; tile_n a multiple of 256 that divides 2048 or a multiple of 2048;
// out (Q, N / tile_n) fp32. Returns the cudaError_t of the launch.
int tile_max_t(const void* queries, const void* corpus_t, void* out, int Q, int D, int N,
               int tile_n, void* stream) {
  if (tile_n <= 0 || tile_n % WARP_COLS || N % tile_n) return cudaErrorInvalidValue;
  if (tile_n < SPAN ? SPAN % tile_n : tile_n % SPAN) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(queries);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(corpus_t);
  float* o = static_cast<float*>(out);
  if (Q <= 1) return launch<1>(q, c, o, Q, D, N, tile_n, st);
  if (Q <= 2) return launch<2>(q, c, o, Q, D, N, tile_n, st);
  if (Q <= 4) return launch<4>(q, c, o, Q, D, N, tile_n, st);
  return launch<8>(q, c, o, Q, D, N, tile_n, st);
}

const char* tile_max_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
