// K2: flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces imatch_tpu/ops/pallas/flash_attention.py::_flash_kernel (launched
// by flash_mha). Computes softmax(Q K^T * Dh^-1/2) V for (B, H, S, Dh) inputs
// in fp32 or bf16, with fp32 accumulation and an fp32 online softmax
// (running max, normaliser and accumulator) over blocks of 64 keys. Keys at or
// past kv_len are masked; with `causal` a query at position i sees keys <= i.
// A row with no visible key writes 0. The output is in the input's dtype.
//
// What bounds it on the card: at CLIP's lengths (S = 50..257, Dh = 64) the
// work is 4*B*H*S^2*Dh operations against 4*B*H*S*Dh elements moved, i.e.
// about S operations per element. On the bf16 tensor cores (989 TFLOP/s)
// that is bound by its bytes below S ~ 300: (32,16,257,64) does 8.7 GFLOP,
// 0.0088 ms, and moves 67.4 MB, 0.0201 ms at 3.35 TB/s; at B = 1 a launch
// is too small to fill the card, and the chain of dependent steps of one
// block (its key tiles, one after another) sets the time.
//
// bf16 (flash_fwd_mma_kernel), a FlashAttention-2-style forward on the
// tensor cores with mma.sync m16n8k16 (fp32 accumulators):
// - each warp owns 16 query rows, whose Q fragments are loaded once from
//   device memory into registers (the head dim padded with zeros to a
//   multiple of 16); a block has 4 warps, or 2 or 1 where 4 would put
//   fewer than 132 blocks (one an SM) on the card: (1,16,257,64) runs 144
//   blocks of 2 warps;
// - K and V tiles of 64 keys are staged in shared memory with cp.async
//   16-byte copies, double-buffered, so the next tile loads while this one
//   computes; keys at or past kv_len are zero-filled, never read. Rows are
//   padded to an odd number of 16-byte units, so the 8 row addresses of
//   each ldmatrix phase fall in 8 different bank groups. K is read with
//   ldmatrix, V with ldmatrix.trans;
// - S = Q K^T with mma into fp32; Dh^-1/2 (times log2 e) is applied to
//   the fp32 logits, not to a bf16 Q, since at Dh = 72 it is not a power
//   of two; masking is as for fp32: keys >= kv_len, causal keys > query,
//   and a causal block stops at its last query's key; a warp skips the
//   tiles that are wholly masked for its rows;
// - the online softmax runs in registers: a row's max and sum reduce over
//   the quad of lanes that shares it (xor shuffles 1 and 2); m starts at a
//   finite -1e30, so a row with no visible key keeps l = 0 and writes 0;
// - P is rounded to bf16 and repacked from the S accumulator fragments
//   straight into A fragments for O += P V: it never goes through shared
//   memory. l sums the rounded P, so the output is a convex combination
//   of V rows. O stays in fp32 registers and is written once, as bf16.
// The strides are the caller's (the towers hand over views of their fused
// QKV projection): every row start must be 16-byte aligned, which the
// wrapper checks.
//
// fp32 (flash_fwd_kernel, unchanged from the first port): 128 threads own
// a 64-query tile and do both products on the fp32 CUDA cores (no TF32:
// fp32 is the fidelity path), so it is bound by those operations
// (67 TFLOP/s). Thread (ty, tx), ty = tid / 8 and tx = tid % 8, owns query
// rows 4*ty .. 4*ty+3, key columns tx + 8*j of each logits tile and output
// columns tx + 8*j of the accumulator; Q, K and V are read once per (query
// block, key block), the logits live only in shared memory, and the ragged
// edges are masked in the kernel with no padded copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per step
constexpr int NTHREADS = 128;   // 16 row groups x 8 column lanes
constexpr float M_INIT = -1e30f;  // running max before any visible key

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to DH + 1 floats a row (no bank conflicts when
  // 8 lanes read 8 different rows), V unpadded, P padded to BK + 1.
  return sizeof(float) *
         (size_t(BQ) * (DH + 1) + size_t(BK) * (DH + 1) + size_t(BK) * DH + size_t(BQ) * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int S, int kv_len, int causal, float scale,
                 long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss, long long osb,
                 long long osh, long long oss) {
  constexpr int LD = DH + 1;
  constexpr int LP = BK + 1;
  constexpr int NJ = DH / 8;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // BQ x LD, already scaled
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x DH
  float* Ps = Vs + BK * DH;    // BQ x LP

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  T* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * DH; i += NTHREADS) {
    const int r = i / DH;
    const int c = i - r * DH;
    const int qp = q0 + r;
    Qs[r * LD + c] = qp < S ? to_f(qb[qp * qss + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = M_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // Keys past the block's last query are masked for every row of a causal
  // block, so the loop stops there.
  int kv_end = kv_len;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    for (int i = tid; i < BK * DH; i += NTHREADS) {
      const int r = i / DH;
      const int c = i - r * DH;
      const int kp = k0 + r;
      const bool in = kp < kv_len;
      Ks[r * LD + c] = in ? to_f(kb[kp * kss + c]) : 0.f;
      Vs[r * DH + c] = in ? to_f(vb[kp * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool ok = kp < kv_len && (!causal || kp <= qp);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      // m_new stays finite (>= M_INIT), so masked logits give exp(-inf) = 0
      // and a row with no visible key keeps l == 0.
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(4 * ty + i) * LP + tx + 8 * j] = p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[c * DH + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= S) continue;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      ob[qp * oss + tx + 8 * jj] = from_f<T>(any ? acc[i][jj] / l[i] : 0.f);
  }
}

// -- bf16: tensor cores ----------------------------------------------------------

constexpr int MMA_BK = 64;        // keys a tile
constexpr int MMA_MAX_WARPS = 4;  // 16 query rows a warp
constexpr int FILL_BLOCKS = 132;  // the H100's SMs: blocks that fill the card once
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int DH>
struct MmaShape {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // QK^T contraction, padded to k16 steps
  static constexpr int LD = DHP + 8;  // smem row in elements: DHP / 8 + 1 (odd) 16-byte units
  static constexpr int KSTEPS = DHP / 16;
  static constexpr int NT_O = DH / 8;  // n-tiles of 8 output columns
  static constexpr int TILE = MMA_BK * LD;  // elements of one staged K or V tile
  static constexpr int SMEM = 2 * 2 * TILE * int(sizeof(bf16));  // 2 stages of K and V
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int DH>
__global__ void __launch_bounds__(32 * MMA_MAX_WARPS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S, int kv_len,
                     int causal, float scale_log2, long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                     long long vss, long long osb, long long osh, long long oss) {
  using Sh = MmaShape<DH>;
  constexpr int LD = Sh::LD;
  constexpr int KSTEPS = Sh::KSTEPS;
  constexpr int NT_O = Sh::NT_O;
  constexpr int TILE = Sh::TILE;
  constexpr int CPR = DH / 8;  // 16-byte chunks of a K or V row
  extern __shared__ __align__(16) bf16 kv_smem[];  // stage s: K at 2*s*TILE, V after it

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bq = nthreads / 2;  // 16 query rows for each of blockDim.x / 32 warps
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * bq;
  const int wq0 = q0 + 16 * (tid >> 5);  // the warp's first query row

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  bf16* ob = o + b * osb + h * osh;

  // Keys past the block's last query are masked for every row of a causal
  // block, so the loop stops there.
  int kv_end = kv_len;
  if (causal && q0 + bq < kv_end) kv_end = q0 + bq;
  const int n_tiles = (kv_end + MMA_BK - 1) / MMA_BK;

  // The pad columns DH..DHP-1 of K take part in QK^T: zero them once in
  // both stages (cp.async never writes them; Q's pad is zero too).
  if constexpr (Sh::DHP > DH) {
    for (int r = tid; r < 2 * MMA_BK; r += nthreads) {
      bf16* row = kv_smem + (r / MMA_BK) * 2 * TILE + (r % MMA_BK) * LD + DH;
      *reinterpret_cast<uint4*>(row) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * MMA_BK;
    bf16* ks = kv_smem + stage * 2 * TILE;
    bf16* vs = ks + TILE;
    for (int i = tid; i < MMA_BK * CPR; i += nthreads) {
      const int r = i / CPR;
      const int c = (i - r * CPR) * 8;
      const int kp = k0 + r;
      const bool in = kp < kv_len;
      const long long src = in ? kp : 0;
      hopper::cp_async16(hopper::smem_addr(ks + r * LD + c), kb + src * kss + c, in);
      hopper::cp_async16(hopper::smem_addr(vs + r * LD + c), vb + src * vss + c, in);
    }
    hopper::cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // This lane's Q fragments (rows wq0 + g and wq0 + g + 8), for the whole
  // key loop; rows past S and pad columns are zero.
  uint32_t qf[KSTEPS][4];
  {
    const int r0 = wq0 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * s + 8 * half + 2 * t;
        qf[s][2 * half] = c < DH && r0 < S ? ld_pair(qb + r0 * qss + c) : 0u;
        qf[s][2 * half + 1] = c < DH && r1 < S ? ld_pair(qb + r1 * qss + c) : 0u;
      }
    }
  }

  float m[2] = {M_INIT, M_INIT};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix row addresses of this lane within a tile: for K (non-trans,
  // matrices key 0-7 / dim 0-7, key 0-7 / dim 8-15, key 8-15 / dim 0-7,
  // key 8-15 / dim 8-15) and for V (trans, matrices key 0-7 / dim 0-7,
  // key 8-15 / dim 0-7, key 0-7 / dim 8-15, key 8-15 / dim 8-15).
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // this tile is in shared memory for every warp

    const int k0 = tile * MMA_BK;
    if (wq0 < S && (!causal || k0 <= wq0 + 15)) {
      const bf16* ks = kv_smem + stage * 2 * TILE;
      const bf16* vs = ks + TILE;

      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          hopper::ldmatrix_x4(kf, hopper::smem_addr(ks + (16 * np + k_row) * LD + 16 * kk + k_col));
          hopper::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          hopper::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // fp32 logits, scaled to log2 units; masked ones are -inf.
      const bool edge = k0 + MMA_BK > kv_len || (causal && k0 + MMA_BK - 1 > wq0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qp = wq0 + g + 8 * (e >> 1);
            x = kp < kv_len && (!causal || kp <= qp) ? x : -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m stays finite (>= M_INIT), so masked logits give exp2(-inf) = 0
        // and a row with no visible key keeps l == 0.
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }

      // P in bf16, straight from the S fragments into PV's A fragments:
      // k-step j of PV covers the S n-tiles 2j and 2j + 1.
      uint32_t pf[4][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(exp2f(s[j][0] - m[0]), exp2f(s[j][1] - m[0]));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(exp2f(s[j][2] - m[1]), exp2f(s[j][3] - m[1]));
        const float2 flo = __bfloat1622float2(lo);
        const float2 fhi = __bfloat1622float2(hi);
        rs[0] += flo.x + flo.y;
        rs[1] += fhi.x + fhi.y;
        pf[j >> 1][2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&lo);
        pf[j >> 1][2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* vrow = vs + (16 * kk + v_row) * LD;
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          uint32_t vf[4];
          hopper::ldmatrix_x4_trans(vf, hopper::smem_addr(vrow + 16 * np + v_col));
          hopper::mma_bf16(acc[2 * np], pf[kk], vf[0], vf[1]);
          hopper::mma_bf16(acc[2 * np + 1], pf[kk], vf[2], vf[3]);
        }
        if constexpr (NT_O % 2) {
          uint32_t vf[2];
          hopper::ldmatrix_x2_trans(vf, hopper::smem_addr(vrow + 8 * (NT_O - 1)));
          hopper::mma_bf16(acc[NT_O - 1], pf[kk], vf[0], vf[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wq0 + g + 8 * i;
    if (qp >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* orow = ob + qp * oss + 2 * t;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          hopper::pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int S, int kv_len, int causal, const long long* st,
                        cudaStream_t stream) {
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(flash_fwd_mma_kernel<DH>, MmaShape<DH>::SMEM, granted);
  if (err != cudaSuccess) return err;
  // The most warps a block (up to 4) that still put a block on every SM.
  const int bh = B * H;
  int nw = MMA_MAX_WARPS;
  while (nw > 1 && bh * ((S + 16 * nw - 1) / (16 * nw)) < FILL_BLOCKS) nw /= 2;
  const dim3 grid((S + 16 * nw - 1) / (16 * nw), bh);
  const float scale_log2 = LOG2E / sqrtf(float(DH));
  flash_fwd_mma_kernel<DH><<<grid, 32 * nw, MmaShape<DH>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, S, kv_len, causal, scale_log2, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(int dh, const void* q, const void* k, const void* v, void* o, int B,
                          int H, int S, int kv_len, int causal, const long long* st,
                          cudaStream_t stream) {
  switch (dh) {
#define CASE(D) \
  case D:       \
    return launch_bf16<D>(q, k, v, o, B, H, S, kv_len, causal, st, stream);
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// -- fp32: CUDA cores ----------------------------------------------------------------

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                   int kv_len, int causal, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(flash_fwd_kernel<T, DH>, int(smem), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf(float(DH));
  flash_fwd_kernel<T, DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, S, kv_len, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, void* o, int B, int H,
                     int S, int kv_len, int causal, const long long* st, cudaStream_t stream) {
  switch (dh) {
#define CASE(D) \
  case D:       \
    return launch<T, D>(q, k, v, o, B, H, S, kv_len, causal, st, stream);
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48) CASE(56) CASE(64)
    CASE(72) CASE(80) CASE(88) CASE(96) CASE(104) CASE(112) CASE(120) CASE(128)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) for q, k, v and o in that order; the head dim is contiguous.
// Returns the cudaError_t of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                        int H, int S, int Dh, int kv_len, int causal, const long long* strides,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(Dh, q, k, v, o, B, H, S, kv_len, causal, strides, st);
  if (dtype == 1) return dispatch_bf16(Dh, q, k, v, o, B, H, S, kv_len, causal, strides, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
