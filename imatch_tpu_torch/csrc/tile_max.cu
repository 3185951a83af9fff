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
// chunk and there are Q * D multiply-adds per row, so a few queries are
// bound by the corpus bytes over the 3.35 TB/s of HBM3, and past about 40
// fp32 queries (2 * Q * D operations against 4 * D bytes a row, at 67
// TFLOP/s fp32) by the fp32 operations. Every variant reads each corpus
// byte from device memory once per query chunk, writes one plain store per
// (query, tile) and uses no atomics, since no two blocks write the same
// output.
//
// Q = 1 (tile_max_kernel, bf16 and fp32): one block per tile; the query is
// staged once in shared memory as fp32; groups of 8 lanes stream one
// corpus row each with 16-byte coalesced loads; each lane keeps its
// partial sum and running maximum in registers, reduced with warp shuffles
// and then through shared memory. This reaches about 90% of the bound.
//
// bf16 at Q >= 2 (tile_max_mma_kernel): the tensor cores, mma.sync
// m16n8k16 with A = 16 corpus rows x 16 dims and B = 16 dims x 8 queries
// (Q padded to 8 or 16 columns, one or two n-tiles). A dot product may sum
// its dims in any order, so the k index of the fragments is permuted: for
// each 32-dim chunk, lane (g, t) loads dims 8t .. 8t+7 of rows g and g+8 of
// its 16-row group as two 16-byte loads straight from device memory into
// registers (every 32-byte sector fully used, no shared-memory staging),
// and those 8 dims are the lane's A elements of the chunk's two k16 steps.
// The queries are staged once in shared memory, bf16, in the same
// permuted order ([chunk][query][t], 16 bytes each): a warp's B reads are
// 512 contiguous bytes, conflict-free. Each mma starts from zero and its
// 16-product partial is added to the running fp32 sum with a rounded add,
// so the sum rounds like a CUDA-core sum (the kernel is bytes-bound; the
// adds are free). Invalid rows are masked to -3e38 after the k loop; the
// tile maximum reduces over the fragment's rows with shuffles, then
// across the warps through shared memory.
//
// fp32 at Q >= 2 (tile_max_fp32_kernel): a register-blocked product on
// the CUDA cores (no TF32: fp32 is the fidelity tier). A block owns one
// tile and one chunk of queries: 4 x ceil(Q / 4) queries up to 40 queries
// (at most 3 padded query columns, and the corpus read once: Q = 17 does
// 20 queries' work), 64 queries beyond (the corpus read ceil(Q / 64)
// times; the chunks of one tile are neighbouring blocks, so the later
// ones mostly find its rows in L2). It walks the tile in slabs of 256 rows
// (512 past 40 queries); each slab goes through shared memory in stages
// of 32 dims, corpus rows and queries alike, copied with cp.async 16-byte
// copies into a double buffer, so the next stage loads while this one
// computes (one barrier a stage). Staged rows are padded to 36 floats (9
// 16-byte units, odd), so the 8 consecutive rows or queries that a warp's
// 16-byte reads touch fall in 8 different bank groups: every read is a
// conflict-free float4. Each thread keeps a TM x TN micro-tile of fp32
// accumulators, rows ty + NRG * i and queries tx + 4j: per 4 dims it reads
// TM + TN float4s for 4 * TM * TN multiply-adds. Past 40 queries the tile
// is 8 rows x 16 queries, 5.3 multiply-adds a float read: on this card the
// shared-memory crossbar delivers 32 floats a clock to an SM's lanes
// against 128 fp32 multiply-adds, so a product needs more than 4
// multiply-adds a float read to be bound by the FMAs and not by shared
// memory; 8 x 8 (4 a float) measured slower. Up to 40 queries the tile is
// 4 rows x TN queries: there the bytes bound it, and the small tile keeps
// 2 blocks (16 warps) an SM to overlap the copies. After a slab's last
// stage the invalid rows (and rows past tile_n) are masked to -3e38 and
// folded into a running maximum a query; at the end the maxima reduce
// over the row groups with shuffles, then across the warps through shared
// memory. Each dot sums its dims in order, one fp32 FMA a dim.
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

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tile_max_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                const uint8_t* __restrict__ valid, float* __restrict__ out, int Q, int D,
                int tile_n, int n_tiles) {
  constexpr int QC = 1;  // one query: Q >= 2 runs on tile_max_mma_kernel or tile_max_fp32_kernel
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

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                   int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  constexpr int QC = 1;
  const size_t smem = sizeof(float) * size_t(QC) * D;
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(tile_max_kernel<T>, int(smem), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  tile_max_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus), valid, out, Q, D, tile_n,
      n_tiles);
  return cudaGetLastError();
}

// -- bf16, Q >= 2: tensor cores ---------------------------------------------------

constexpr int MMA_U = 8;  // 32-dim chunks whose loads a lane has in flight at once

template <int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
tile_max_mma_kernel(const __nv_bfloat16* __restrict__ queries,
                    const __nv_bfloat16* __restrict__ corpus, const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int Q, int D, int tile_n, int n_tiles) {
  constexpr int QC = 8 * NT;  // queries a block: NT n-tiles of 8
  extern __shared__ __align__(16) uint4 qsm[];  // [chunk][query][t]: dims 32*chunk + 8t .. +7
  __shared__ float red[NWARPS][QC];

  const int nch = (D + 31) / 32;
  const int tile = blockIdx.x;
  const int qbase = blockIdx.y * QC;
  const int nq = min(QC, Q - qbase);
  for (int i = threadIdx.x; i < nch * QC * 4; i += NTHREADS) {
    const int qi = (i >> 2) % QC;
    const int d = 32 * (i / (QC * 4)) + 8 * (i & 3);
    qsm[i] = qi < nq && d < D
                 ? *reinterpret_cast<const uint4*>(queries + size_t(qbase + qi) * D + d)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row0 = size_t(tile) * tile_n;

  float best[NT][2];  // queries 8 * nt + 2t and 8 * nt + 2t + 1
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) best[nt][0] = best[nt][1] = NEG_INF;

  for (int r = 16 * warp; r < tile_n; r += 16 * NWARPS) {
    const int ra = r + g;
    const int rb = ra + 8;
    const bool ina = ra < tile_n;
    const bool inb = rb < tile_n;
    const __nv_bfloat16* pa = corpus + (row0 + (ina ? ra : 0)) * size_t(D) + 8 * t;
    const __nv_bfloat16* pb = corpus + (row0 + (inb ? rb : 0)) * size_t(D) + 8 * t;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int c0 = 0; c0 < nch; c0 += MMA_U) {
      uint4 xa[MMA_U], xb[MMA_U];
#pragma unroll
      for (int u = 0; u < MMA_U; ++u) {
        const bool in = 32 * (c0 + u) + 8 * t < D;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        xa[u] = in && ina ? __ldg(reinterpret_cast<const uint4*>(pa + 32 * (c0 + u))) : zero;
        xb[u] = in && inb ? __ldg(reinterpret_cast<const uint4*>(pb + 32 * (c0 + u))) : zero;
      }
#pragma unroll
      for (int u = 0; u < MMA_U; ++u) {
        if (c0 + u < nch) {
          const uint32_t a0[4] = {xa[u].x, xb[u].x, xa[u].y, xb[u].y};
          const uint32_t a1[4] = {xa[u].z, xb[u].z, xa[u].w, xb[u].w};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint4 qv = qsm[((c0 + u) * QC + 8 * nt + g) * 4 + t];
            float p0[4] = {0.f, 0.f, 0.f, 0.f};
            float p1[4] = {0.f, 0.f, 0.f, 0.f};
            hopper::mma_bf16(p0, a0, qv.x, qv.y);
            hopper::mma_bf16(p1, a1, qv.z, qv.w);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(__fadd_rn(acc[nt][e], p0[e]), p1[e]);
          }
        }
      }
    }
    const bool va = ina && valid[row0 + ra];
    const bool vb = inb && valid[row0 + rb];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      best[nt][0] = fmaxf(best[nt][0], fmaxf(va ? acc[nt][0] : NEG_INF, vb ? acc[nt][2] : NEG_INF));
      best[nt][1] = fmaxf(best[nt][1], fmaxf(va ? acc[nt][1] : NEG_INF, vb ? acc[nt][3] : NEG_INF));
    }
  }

  // The 8 row pairs of a warp (lanes with the same t), then the warps.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float b = best[nt][j];
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 4));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 8));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 16));
      if (g == 0) red[warp][8 * nt + 2 * t + j] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    out[size_t(qbase + threadIdx.x) * n_tiles + tile] = m;
  }
}

template <int NT>
cudaError_t launch_mma(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                       int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  constexpr int QC = 8 * NT;
  const size_t smem = sizeof(uint4) * size_t((D + 31) / 32) * QC * 4;
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(tile_max_mma_kernel<NT>, int(smem), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  tile_max_mma_kernel<NT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(queries), static_cast<const __nv_bfloat16*>(corpus),
      valid, out, Q, D, tile_n, n_tiles);
  return cudaGetLastError();
}

// -- fp32, Q >= 2: register-blocked CUDA-core product -----------------------------

constexpr int F_BK = 32;   // dims a stage
constexpr int F_STAGES = 2;  // buffers in the cp.async ring

// NTHREADS threads in NQG query groups of TN queries and NTHREADS / NQG
// row groups of TM rows.
template <int NQG, int TN, int TM>
struct F32Shape {
  static constexpr int LD = F_BK + 4;            // a staged row: 9 16-byte units (odd)
  static constexpr int CPR = F_BK / 4;           // 16-byte chunks of a staged row
  static constexpr int QC = NQG * TN;            // queries a block
  static constexpr int NRG = NTHREADS / NQG;     // row groups
  static constexpr int BM = NRG * TM;            // corpus rows a slab
  static constexpr int STAGE = (BM + QC) * LD;   // floats a stage: rows, then queries
  static constexpr int SMEM = F_STAGES * STAGE * int(sizeof(float));
  static constexpr int MIN_BLOCKS = BM <= 256 ? 2 : 1;  // blocks an SM the registers allow
};

template <int NQG, int TN, int TM>
__global__ void __launch_bounds__(NTHREADS, F32Shape<NQG, TN, TM>::MIN_BLOCKS)
tile_max_fp32_kernel(const float* __restrict__ queries, const float* __restrict__ corpus,
                     const uint8_t* __restrict__ valid, float* __restrict__ out, int Q, int D,
                     int tile_n, int n_tiles, int n_chunks) {
  using Sh = F32Shape<NQG, TN, TM>;
  constexpr int LD = Sh::LD;
  constexpr int CPR = Sh::CPR;
  constexpr int QC = Sh::QC;
  constexpr int NRG = Sh::NRG;
  constexpr int BM = Sh::BM;
  extern __shared__ __align__(16) float fsm[];
  __shared__ float red[NWARPS][QC];

  const int tid = threadIdx.x;
  const int tx = tid % NQG;  // queries tx + NQG * j
  const int ty = tid / NQG;  // rows ty + NRG * i of each slab
  // the chunks of one tile are neighbouring blocks: they share its rows in L2
  const int chunk = blockIdx.x % n_chunks;
  const int tile = blockIdx.x / n_chunks;
  const int qbase = chunk * QC;
  const int nq = min(QC, Q - qbase);
  const size_t row0 = size_t(tile) * tile_n;
  const int nk = (D + F_BK - 1) / F_BK;
  const int steps = (tile_n + BM - 1) / BM * nk;

  // Stage `step` (slab step / nk, dims (step % nk) * F_BK ..) into its
  // buffer: rows past the tile, queries past Q and dims past D are zeros.
  // Past the last step it commits an empty group, so that every step
  // waits for the same count.
  auto load = [&](int step) {
    if (step < steps) {
      const int slab = step / nk;
      const int d0 = (step - slab * nk) * F_BK;
      float* dst = fsm + (step % F_STAGES) * Sh::STAGE;
      for (int i = tid; i < (BM + QC) * CPR; i += NTHREADS) {
        const int r = i / CPR;
        const int c = 4 * (i - r * CPR);
        const int d = d0 + c;
        const float* src = corpus;
        bool in;
        if (r < BM) {
          const int rr = slab * BM + r;
          in = rr < tile_n && d < D;
          if (in) src = corpus + (row0 + rr) * size_t(D) + d;
        } else {
          const int qi = r - BM;
          in = qi < nq && d < D;
          if (in) src = queries + size_t(qbase + qi) * D + d;
        }
        hopper::cp_async16(hopper::smem_addr(dst + r * LD + c), src, in);
      }
    }
    hopper::cp_async_commit();
  };

  float acc[TM][TN];
  float best[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    best[j] = NEG_INF;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    hopper::cp_async_wait<F_STAGES - 2>();
    // This step's buffer is in shared memory for every warp, and every warp
    // is done with the buffer the next load refills (the last step's).
    __syncthreads();
    load(step + F_STAGES - 1);

    const float* as = fsm + (step % F_STAGES) * Sh::STAGE + ty * LD;
    const float* bs = fsm + (step % F_STAGES) * Sh::STAGE + (BM + tx) * LD;
#pragma unroll
    for (int k = 0; k < F_BK; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(as + i * NRG * LD + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(bs + j * NQG * LD + k);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }

    const int slab = step / nk;
    if (step - slab * nk == nk - 1) {  // the slab's dots are complete
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = slab * BM + ty + NRG * i;
        const bool ok = r < tile_n && valid[row0 + r];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          best[j] = fmaxf(best[j], ok ? acc[i][j] : NEG_INF);
          acc[i][j] = 0.f;
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

  // The row groups of a warp (lanes with the same tx), then the warps.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
#pragma unroll
    for (int off = NQG; off < 32; off <<= 1)
      best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], off));
  }
  if ((tid & 31) < NQG) {
#pragma unroll
    for (int j = 0; j < TN; ++j) red[tid >> 5][tx + NQG * j] = best[j];
  }
  __syncthreads();
  if (tid < nq) {
    float m = red[0][tid];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w][tid]);
    out[size_t(qbase + tid) * n_tiles + tile] = m;
  }
}

template <int NQG, int TN, int TM>
cudaError_t launch_fp32(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                        int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  using Sh = F32Shape<NQG, TN, TM>;
  auto kernel = tile_max_fp32_kernel<NQG, TN, TM>;
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(kernel, Sh::SMEM, granted);
  if (err != cudaSuccess) return err;
  const int n_chunks = (Q + Sh::QC - 1) / Sh::QC;
  const long long blocks = static_cast<long long>(n_tiles) * n_chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<unsigned(blocks), NTHREADS, Sh::SMEM, stream>>>(static_cast<const float*>(queries),
                                                     static_cast<const float*>(corpus), valid,
                                                     out, Q, D, tile_n, n_tiles, n_chunks);
  return cudaGetLastError();
}

// fp32 at Q >= 2: 4 x ceil(Q / 4) queries a block in 256-row slabs up to
// 40 queries, then 64 queries in 512-row slabs.
cudaError_t dispatch_fp32(const void* queries, const void* corpus, const uint8_t* valid,
                          float* out, int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  switch ((Q + 3) / 4) {
#define CASE(TN) \
  case TN:       \
    return launch_fp32<4, TN, 4>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)
#undef CASE
    default:
      return launch_fp32<4, 16, 8>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  }
}

template <typename T>
cudaError_t dispatch(const void* queries, const void* corpus, const uint8_t* valid, float* out,
                     int Q, int D, int tile_n, int n_tiles, cudaStream_t stream) {
  // One query streams the corpus on the CUDA cores; bf16 at Q >= 2 runs on
  // the tensor cores, fp32 at Q >= 2 on the register-blocked product.
  if (Q <= 1) return launch<T>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (Q <= 8) return launch_mma<1>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
    return launch_mma<2>(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  } else {
    return dispatch_fp32(queries, corpus, valid, out, Q, D, tile_n, n_tiles, stream);
  }
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
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(tile_max_int8_kernel<QC>, int(smem), granted);
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
