// K5: tile-max scoring over an int4 corpus, for Hopper (sm_90a), CUDA C++.
//
// Replaces scripts/exp_int4_kernel.py::_int4_tile_max_kernel (launched by
// int4_tile_max there). The corpus is nibble-packed in halves: byte b of a
// row holds feature b in its low nibble and feature b + H in its high
// nibble (H = D / 2), both signed 4-bit codes in [-7, 7]. A side array of
// shape (8, N) bf16 carries each row's dequant scale in row 0 and its
// validity in row 1. For each query q and each tile t of tile_n rows it
// writes
//   out[q, t] = max over the rows r of tile t with side[1, r] > 0 of
//               (sum_d q[q, d] * code[r, d]) * (float)side[0, r]
// accumulated in fp32; a tile with no valid row gives -3e38.
//
// What bounds it on the card: the packed corpus (D / 2 bytes a row) and
// rows 0 and 1 of the side array, read once per query chunk, over the
// 3.35 TB/s of HBM3; at 8 x 2^20 x 512 that is 0.0814 ms, the first kernel
// of the port that reads fewer than 8 bits a feature. What the design does about that: one block
// per (tile, chunk of up to 8 queries); the query chunk is staged once in
// shared memory as fp32; groups of 8 lanes stream one packed row each with
// 16-byte coalesced loads (a 256-byte row is 16 of them, two a lane); each
// byte is sign-extended in registers, the low nibble as (int8)(b << 4) >> 4
// and the high one as (int8)b >> 4. The high nibble pairs with query
// feature b + H, so nothing is interleaved. The query is stored permuted
// (qpos below) so that the 8 lanes of a group, one quarter-warp, read 128
// contiguous bytes with each float4 load: stored in feature order, their
// float4s were 64 bytes apart, four lanes to a bank, and each load took 16
// shared-memory wavefronts instead of 4. A query value times a code in
// [-7, 7] is exact in fp32; the sums run in fp32 FMAs, reduced with warp
// shuffles and then through shared memory; one plain store per
// (query, tile) and no atomics. The TPU kernel unpacked to bf16 for its
// matrix unit; tensor cores are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int GROUP = 8;                   // lanes per packed row
constexpr int NGROUPS = NTHREADS / GROUP;  // rows in flight per block
constexpr float NEG_INF = -3.0e38f;
constexpr int CHUNK = GROUP * 16;  // bytes of a row a group loads in one step

// Shared-memory position of query feature f (0 <= f < H) within its half:
// float4 number (j * 4 + e4) * GROUP + sub holds features 4 * e4 .. + 3 of
// the 16-byte chunk that lane sub loads in step j.
__device__ __forceinline__ int qpos(int f) {
  const int c = f / 16, e = f % 16;
  return (((c / GROUP) * 4 + e / 4) * GROUP + c % GROUP) * 4 + e % 4;
}

template <int QC>
__global__ void __launch_bounds__(NTHREADS)
int4_tile_max_kernel(const __nv_bfloat16* __restrict__ queries, const uint8_t* __restrict__ packed,
                     const __nv_bfloat16* __restrict__ side, float* __restrict__ out, int Q, int H,
                     int N, int tile_n, int n_tiles) {
  // QC x 2 halves x HP fp32, each half permuted by qpos; HP is H rounded
  // up to whole CHUNKs (slots past H are never read)
  extern __shared__ __align__(16) float qs[];
  __shared__ float red[NWARPS][QC];

  const int D = 2 * H;
  const int HP = (H + CHUNK - 1) / CHUNK * CHUNK;
  const int tile = blockIdx.x;
  const int qbase = blockIdx.y * QC;
  const int nq = min(QC, Q - qbase);
  for (int i = threadIdx.x; i < QC * D; i += NTHREADS) {
    const int qi = i / D, f = i % D;
    const float v = qi < nq ? __bfloat162float(queries[size_t(qbase) * D + i]) : 0.f;
    qs[(qi * 2 + f / H) * HP + qpos(f % H)] = v;
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
      const uint8_t* row = packed + (row0 + r) * size_t(H);
      for (int step = 0, b = sub * 16; b < H; ++step, b += CHUNK) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + b));
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        float lo[16], hi[16];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // byte j of the word, sign-extended nibbles
            lo[4 * w + j] = float(int(words[w] << (28 - 8 * j)) >> 28);
            hi[4 * w + j] = float(int(words[w] << (24 - 8 * j)) >> 28);
          }
        }
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) {
          const float4* qlo =
              reinterpret_cast<const float4*>(qs + qi * 2 * HP) + step * 4 * GROUP + sub;
          const float4* qhi = qlo + HP / 4;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 a = qlo[(e / 4) * GROUP];
            const float4 c = qhi[(e / 4) * GROUP];
            acc[qi] = fmaf(a.x, lo[e], acc[qi]);
            acc[qi] = fmaf(a.y, lo[e + 1], acc[qi]);
            acc[qi] = fmaf(a.z, lo[e + 2], acc[qi]);
            acc[qi] = fmaf(a.w, lo[e + 3], acc[qi]);
            acc[qi] = fmaf(c.x, hi[e], acc[qi]);
            acc[qi] = fmaf(c.y, hi[e + 1], acc[qi]);
            acc[qi] = fmaf(c.z, hi[e + 2], acc[qi]);
            acc[qi] = fmaf(c.w, hi[e + 3], acc[qi]);
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
    if (active && __bfloat162float(side[size_t(N) + row0 + r]) > 0.f) {
      const float scale = __bfloat162float(side[row0 + r]);
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) best[qi] = fmaxf(best[qi], acc[qi] * scale);
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

template <int QC>
cudaError_t launch(const __nv_bfloat16* queries, const uint8_t* packed, const __nv_bfloat16* side,
                   float* out, int Q, int H, int N, int tile_n, int n_tiles, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(QC) * 2 * ((H + CHUNK - 1) / CHUNK * CHUNK);
  cudaError_t err = cudaFuncSetAttribute(int4_tile_max_kernel<QC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  int4_tile_max_kernel<QC><<<grid, NTHREADS, smem, stream>>>(queries, packed, side, out, Q, H, N,
                                                             tile_n, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries (Q, 2H) bf16; packed (N, H) bytes, H a multiple of 16; side
// (8, N) bf16 (row 0 scale, row 1 validity); out (Q, N / tile_n) fp32, all
// row-major. Returns the cudaError_t of the launch (0 on success).
int int4_tile_max(const void* queries, const void* packed, const void* side, void* out, int Q,
                  int H, int N, int tile_n, void* stream) {
  if (H % 16 || tile_n <= 0 || N % tile_n) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(queries);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(side);
  float* o = static_cast<float*>(out);
  const int n_tiles = N / tile_n;
  if (Q <= 1) return launch<1>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
  if (Q <= 2) return launch<2>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
  if (Q <= 4) return launch<4>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
  return launch<8>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
}

const char* int4_tile_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
