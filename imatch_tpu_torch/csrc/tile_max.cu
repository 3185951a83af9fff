// K1: tile-max scoring, phase 1 of the exact two-phase top-k, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces imatch_tpu/ops/pallas/topk.py::_tile_max_kernel (launched by
// _query_prepared) and the XLA phase 1 of index/search.py::_tilemax_topk.
// For each query q and each tile t of tile_n corpus rows it writes
//   out[q, t] = max over the valid rows r of tile t of sum_d q[q, d] * c[r, d]
// accumulated in fp32 from bf16 or fp32 operands; a tile with no valid row
// gives -3e38. Row validity is a byte mask: the TPU kernel folded it into a
// penalty feature column only because Mosaic could not lower a (1, tile_n)
// mask operand; phase 2 picks the same tiles either way.
//
// What bounds it on the card: each corpus byte is needed once per query
// chunk and there are Q * D multiply-adds per row, so for the query counts
// a search serves (1 to a few hundred) it is bound by the corpus bytes over
// the 3.35 TB/s of HBM3. What the design does about that: one block per
// (tile, chunk of up to 16 queries); the query chunk is staged once in
// shared memory as fp32; groups of 8 lanes stream one corpus row each with
// 16-byte coalesced loads, so every corpus byte is read from device memory
// once per query chunk; each lane keeps per-query partial sums and running
// maxima in registers, reduced with warp shuffles and then through shared
// memory; one plain store per (query, tile) and no atomics, since no two
// blocks write the same output. Tensor cores, TMA and persistent blocks are
// left for later work.
//
// The int8 variant (tile_max_int8 below) is phase 1 of the int8 score tier
// and of the tilemax-host tier: the math of imatch_tpu/index/search.py::
// _int8_scores, which JAX leaves to XLA. Codes are int8 (queries and corpus,
// the corpus dim a multiple of 16), with a per-query and a per-row fp32
// scale. The dots accumulate exactly in int32 with __dp4a on 16-byte loads
// (the query chunk sits in shared memory packed four codes to an int32);
// an integer sum is exact in any order, and the dequantize is
// ((float)acc * qscale) * scale with one rounding each (__fmul_rn, so nvcc
// cannot contract them), so the result is bit-identical to the plain
// PyTorch version. Bound: the int8 corpus bytes, half of bf16's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int GROUP = 8;                  // lanes per corpus row
constexpr int NGROUPS = NTHREADS / GROUP;  // rows in flight per block
constexpr float NEG_INF = -3.0e38f;

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = f[e];
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int QC>
__global__ void __launch_bounds__(NTHREADS)
tile_max_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                const uint8_t* __restrict__ valid, float* __restrict__ out, int Q, int D,
                int tile_n, int n_tiles) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ __align__(16) float qs[];  // QC x D, fp32
  __shared__ float red[NWARPS][QC];

  const int tile = blockIdx.x;
  const int qbase = blockIdx.y * QC;
  const int nq = min(QC, Q - qbase);
  for (int i = threadIdx.x; i < QC * D; i += NTHREADS) {
    const int qi = i / D;
    qs[i] = qi < nq ? to_f(queries[size_t(qbase) * D + i]) : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = threadIdx.x & (GROUP - 1);
  const int grp = threadIdx.x / GROUP;
  const size_t row0 = size_t(tile) * tile_n;

  float best[QC];
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) best[qi] = NEG_INF;

  // Every lane runs the same number of iterations (the shuffles below need
  // the whole warp); a lane whose row is past the tile contributes nothing.
  for (int r0 = 0; r0 < tile_n; r0 += NGROUPS) {
    const int r = r0 + grp;
    const bool active = r < tile_n;
    float acc[QC];
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) acc[qi] = 0.f;
    if (active) {
      const T* row = corpus + (row0 + r) * size_t(D);
      for (int d = sub * VEC; d < D; d += GROUP * VEC) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + d));
        float x[VEC];
        unpack(raw, x);
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) {
          const float* qrow = qs + qi * D + d;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + e);
            acc[qi] = fmaf(qv.x, x[e], acc[qi]);
            acc[qi] = fmaf(qv.y, x[e + 1], acc[qi]);
            acc[qi] = fmaf(qv.z, x[e + 2], acc[qi]);
            acc[qi] = fmaf(qv.w, x[e + 3], acc[qi]);
          }
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 1);
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 2);
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 4);
    }
    if (active && valid[row0 + r]) {
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) best[qi] = fmaxf(best[qi], acc[qi]);
    }
  }

  // The four row groups of a warp, then the warps of the block.
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
    best[qi] = fmaxf(best[qi], __shfl_xor_sync(0xffffffffu, best[qi], 8));
    best[qi] = fmaxf(best[qi], __shfl_xor_sync(0xffffffffu, best[qi], 16));
  }
  if (lane == 0) {
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) red[warp][qi] = best[qi];
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    out[size_t(qbase + threadIdx.x) * n_tiles + tile] = m;
  }
}

template <typename T, int QC>
cudaError_t launch(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                   int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(QC) * D;
  cudaError_t err = cudaFuncSetAttribute(tile_max_kernel<T, QC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  tile_max_kernel<T, QC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus), valid, out, Q, D, tile_n,
      n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                     int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  // The smallest query chunk that holds every query, at most 16: a single
  // query does not pay 16 queries' multiply-adds.
  if (Q <= 1) return launch<T, 1>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  if (Q <= 2) return launch<T, 2>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  if (Q <= 4) return launch<T, 4>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  if (Q <= 8) return launch<T, 8>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  return launch<T, 16>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
}

// -- int8 ---------------------------------------------------------------------

template <int QC>
__global__ void __launch_bounds__(NTHREADS)
tile_max_int8_kernel(const int8_t* __restrict__ queries, const int8_t* __restrict__ corpus,
                     const float* __restrict__ qscale, const float* __restrict__ scale,
                     const uint8_t* __restrict__ valid, float* __restrict__ out, int Q, int D,
                     int tile_n, int n_tiles) {
  constexpr int VEC = 16;  // codes per 16-byte load
  extern __shared__ __align__(16) int qw[];  // QC x D/4, four codes a word
  __shared__ float red[NWARPS][QC];

  const int W = D / 4;
  const int tile = blockIdx.x;
  const int qbase = blockIdx.y * QC;
  const int nq = min(QC, Q - qbase);
  const int* qsrc = reinterpret_cast<const int*>(queries + size_t(qbase) * D);
  for (int i = threadIdx.x; i < QC * W; i += NTHREADS) qw[i] = i / W < nq ? qsrc[i] : 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = threadIdx.x & (GROUP - 1);
  const int grp = threadIdx.x / GROUP;
  const size_t row0 = size_t(tile) * tile_n;

  float qs[QC];
  float best[QC];
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
    qs[qi] = qi < nq ? qscale[qbase + qi] : 0.f;
    best[qi] = NEG_INF;
  }

  for (int r0 = 0; r0 < tile_n; r0 += NGROUPS) {
    const int r = r0 + grp;
    const bool active = r < tile_n;
    int acc[QC];
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) acc[qi] = 0;
    if (active) {
      const int8_t* row = corpus + (row0 + r) * size_t(D);
      for (int d = sub * VEC; d < D; d += GROUP * VEC) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(row + d));
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) {
          const int4 qv = *reinterpret_cast<const int4*>(qw + qi * W + d / 4);
          acc[qi] = __dp4a(x.x, qv.x, acc[qi]);
          acc[qi] = __dp4a(x.y, qv.y, acc[qi]);
          acc[qi] = __dp4a(x.z, qv.z, acc[qi]);
          acc[qi] = __dp4a(x.w, qv.w, acc[qi]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 1);
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 2);
      acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], 4);
    }
    if (active && valid[row0 + r]) {
      const float sr = scale[row0 + r];
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) {
        const float s = __fmul_rn(__fmul_rn(__int2float_rn(acc[qi]), qs[qi]), sr);
        best[qi] = fmaxf(best[qi], s);
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
    best[qi] = fmaxf(best[qi], __shfl_xor_sync(0xffffffffu, best[qi], 8));
    best[qi] = fmaxf(best[qi], __shfl_xor_sync(0xffffffffu, best[qi], 16));
  }
  if (lane == 0) {
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) red[warp][qi] = best[qi];
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    out[size_t(qbase + threadIdx.x) * n_tiles + tile] = m;
  }
}

template <int QC>
cudaError_t launch_int8(const int8_t* queries, const int8_t* corpus, const float* qscale,
                        const float* scale, const uint8_t* valid, float* out, int Q, int D,
                        int tile_n, int n_tiles, cudaStream_t stream) {
  const size_t smem = sizeof(int) * size_t(QC) * (D / 4);
  cudaError_t err = cudaFuncSetAttribute(tile_max_int8_kernel<QC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  tile_max_int8_kernel<QC><<<grid, NTHREADS, smem, stream>>>(queries, corpus, qscale, scale,
                                                             valid, out, Q, D, tile_n, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. queries (Q, D) and corpus
// (n_tiles * tile_n, D) are row-major in that dtype with D a multiple of 8,
// valid is one byte a corpus row, out is (Q, n_tiles) fp32. Returns the
// cudaError_t of the launch (0 on success).
int tile_max(const void* queries, const void* corpus, const void* valid, void* out, int dtype,
             int Q, int D, int tile_n, int n_tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return dispatch<float>(queries, corpus, vm, o, Q, D, tile_n, n_tiles, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(queries, corpus, vm, o, Q, D, tile_n, n_tiles, st);
  return cudaErrorInvalidValue;
}

// The int8 variant. queries (Q, D) and corpus (n_tiles * tile_n, D) int8
// codes, row-major, D a multiple of 16; qscale (Q,) and scale
// (n_tiles * tile_n,) fp32; valid one byte a corpus row; out (Q, n_tiles)
// fp32. Returns the cudaError_t of the launch (0 on success).
int tile_max_int8(const void* queries, const void* corpus, const void* qscale, const void* scale,
                  const void* valid, void* out, int Q, int D, int tile_n, int n_tiles,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(queries);
  const int8_t* c = static_cast<const int8_t*>(corpus);
  const float* qs = static_cast<const float*>(qscale);
  const float* s = static_cast<const float*>(scale);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (D % 16) return cudaErrorInvalidValue;
  if (Q <= 1) return launch_int8<1>(q, c, qs, s, vm, o, Q, D, tile_n, n_tiles, st);
  if (Q <= 2) return launch_int8<2>(q, c, qs, s, vm, o, Q, D, tile_n, n_tiles, st);
  if (Q <= 4) return launch_int8<4>(q, c, qs, s, vm, o, Q, D, tile_n, n_tiles, st);
  if (Q <= 8) return launch_int8<8>(q, c, qs, s, vm, o, Q, D, tile_n, n_tiles, st);
  return launch_int8<16>(q, c, qs, s, vm, o, Q, D, tile_n, n_tiles, st);
}

const char* tile_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
