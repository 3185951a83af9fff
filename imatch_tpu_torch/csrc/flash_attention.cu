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
// fp32 (flash_fwd_fp32_kernel) runs both products on the fp32 CUDA cores
// (no TF32: fp32 is the fidelity path), so it is bound by those operations,
// 4 * S^2 * Dh a head at 67 TFLOP/s (its bytes take a quarter of that time
// at S = 257). It is built as an fp32 GEMM is:
// - register-blocked micro-tiles for both products. Each warp owns 16
//   query rows and lane (ty, tx), ty = lane / 8 and tx = lane % 8, owns
//   rows ty + 4i (i < 4): for S = Q K^T the keys tx + 8j of the 64-key
//   tile (4 x 8 accumulators; per 4 dims 12 float4 reads for 128 FMAs),
//   for O += P V the columns 4(tx + 8m) .. +3 as float4s and, for Dh % 32
//   = 8 .. 24, the single columns 32 * (Dh / 32) + tx + 8r: Dh / 8
//   columns, so Dh = 72 takes two float4s and one float a key with no
//   padded column. What bounds it: the shared-memory crossbar delivers 32
//   floats a clock to an SM's lanes against 128 fp32 FMAs, so a tile that
//   does R FMAs a float read runs the FMAs at most R / 4 of the time; this
//   one does 2.7. An 8 x 8 tile (4 a float) measured slower: its 255
//   registers a thread fit 8 warps an SM, against 12 here, and the loop
//   waits on shared memory's latency;
// - Q and K rows are padded to Dh + 4 floats (an odd number of 16-byte
//   units), so the 4 rows or 8 keys that a warp's float4 reads touch fall
//   in different bank groups; V is read along its rows and a warp's P rows
//   are padded to 72 floats: no bank conflict anywhere;
// - Q (once), K and V are copied with cp.async 16-byte copies; K and V
//   each have one buffer, and each copy runs while the other's product
//   computes: V of this tile during Q K^T, K of the next tile during P V.
//   Every copy overlaps compute as with a double buffer, in half its
//   shared memory (74 KB a block of 4 warps at Dh = 72: three blocks an
//   SM), two barriers a tile;
// - the online softmax runs in registers in log2 units (Dh^-1/2 and log2 e
//   applied to the fp32 logits, ex2.approx for the exponentials); a row's
//   max and sum reduce over the 8 lanes that share it (xor shuffles 1, 2,
//   4), and P goes through a slice of shared memory private to the warp,
//   so P V needs only __syncwarp;
// - up to 4 warps a block: the most that still put a block on every SM
//   and leave under a quarter of the warps without a row (B = 1 shapes:
//   (1,16,257,64) runs 272 blocks of one warp). The last key tile and the
//   last warp's rows compute only their 8-key and 4-row groups that hold a
//   visible key or a row below S: S = 257 does not pay for 320 keys, and a
//   causal warp stops at its diagonal. A causal grid starts the row blocks
//   that see the most keys first, across all heads, so that the short
//   ones fill the tail.
// Every row start of q, k and v must be 16-byte aligned (base pointers and
// strides), which the wrapper checks; keys at or past kv_len are
// zero-filled in shared memory, never read; m starts at the finite
// M_INIT, so a row with no visible key keeps l = 0 and writes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr float M_INIT = -1e30f;  // running max before any visible key

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

constexpr int F_BK = 64;          // keys a tile
constexpr int F_MAX_WARPS = 4;
constexpr int F_TM = 4;           // query rows a lane: rows ty + 4i
constexpr int F_WR = 4 * F_TM;    // query rows a warp
constexpr int F_LP = F_BK + 8;    // a P row: 18 16-byte units, rows 8 banks apart

// 2^x by the hardware's approximation (ex2.approx.ftz: relative error
// about 2^-22, exp2(-inf) = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
struct F32Shape {
  static constexpr int LD = DH + 4;            // Q and K rows: DH / 4 + 1 16-byte units (odd)
  static constexpr int CPR = DH / 4;           // 16-byte chunks of a row
  static constexpr int NC4 = DH / 32;          // float4 output columns a lane: 4(tx + 8m)
  static constexpr int NR = DH % 32 / 8;       // single output columns a lane: 32 NC4 + tx + 8r
  static constexpr int TD = DH / 8;            // output columns a lane
  static constexpr int smem(int nw) {
    return int(sizeof(float)) * (nw * F_WR * (LD + F_LP) + F_BK * (LD + DH));
  }
};

template <int DH>
__global__ void __launch_bounds__(32 * F_MAX_WARPS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H, int S,
                      int kv_len, int causal, float scale_log2, long long qsb, long long qsh,
                      long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                      long long vsh, long long vss, long long osb, long long osh, long long oss) {
  using Sh = F32Shape<DH>;
  constexpr int TM = F_TM;
  constexpr int WR = F_WR;
  constexpr int LD = Sh::LD;
  constexpr int CPR = Sh::CPR;
  constexpr int NC4 = Sh::NC4;
  constexpr int NR = Sh::NR;
  constexpr int TD = Sh::TD;
  extern __shared__ __align__(16) float f32_smem[];

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = lane >> 3;
  const int tx = lane & 7;
  const int bq = (nthreads >> 5) * WR;
  // A head's row blocks are neighbours (they share its K and V in L2); a
  // causal grid runs its last row blocks, which see the most keys, first
  // across all heads, so the short ones fill the tail.
  const int n_rb = (S + bq - 1) / bq;
  const int n_bh = int(gridDim.x) / n_rb;
  int rb, bh;
  if (causal) {
    rb = n_rb - 1 - int(blockIdx.x) / n_bh;
    bh = int(blockIdx.x) % n_bh;
  } else {
    rb = int(blockIdx.x) % n_rb;
    bh = int(blockIdx.x) / n_rb;
  }
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = rb * bq;
  const int wr0 = q0 + warp * WR;  // the warp's first query row

  float* qs = f32_smem;                            // bq x LD
  float* ks = qs + bq * LD;                        // F_BK x LD
  float* vs = ks + F_BK * LD;                      // F_BK x DH
  float* ps = vs + F_BK * DH + warp * WR * F_LP;   // the warp's P: WR x F_LP

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  float* ob = o + b * osb + h * osh;

  // Keys past the block's last query are masked for every row of a causal
  // block, so the loop stops there.
  int kv_end = kv_len;
  if (causal && q0 + bq < kv_end) kv_end = q0 + bq;
  const int n_tiles = (kv_end + F_BK - 1) / F_BK;

  // Q once (rows past S zero), then K of the first tile, in one group.
  for (int i = tid; i < bq * CPR; i += nthreads) {
    const int r = i / CPR;
    const int c = 4 * (i - r * CPR);
    const int qp = q0 + r;
    const bool in = qp < S;
    hopper::cp_async16(hopper::smem_addr(qs + r * LD + c), qb + (in ? qp : 0) * qss + c, in);
  }
  // One tile of K or V: keys at or past kv_len are zero-filled, never read.
  auto load = [&](float* dst, int ld, const float* src, long long ss, int k0) {
    for (int i = tid; i < F_BK * CPR; i += nthreads) {
      const int r = i / CPR;
      const int c = 4 * (i - r * CPR);
      const int kp = k0 + r;
      const bool in = kp < kv_len;
      hopper::cp_async16(hopper::smem_addr(dst + r * ld + c), src + (in ? kp : 0) * ss + c, in);
    }
    hopper::cp_async_commit();
  };
  load(ks, LD, kb, kss, 0);

  // Groups of 4 rows (rows ty + 4i) that hold a row below S.
  const int row_groups = wr0 < S ? min(TM, (S - wr0 + 3) / 4) : 0;
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = M_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < TD; ++d) acc[i][d] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * F_BK;
    hopper::cp_async_wait<0>();
    __syncthreads();  // K (and Q) in shared memory; every warp is done with V
    load(vs, DH, vb, vss, k0);

    // Keys of the tile that some row of the warp sees: [k0, kend).
    int kend = min(kv_len, k0 + F_BK);
    if (causal) kend = min(kend, wr0 + WR);
    const bool active = row_groups > 0 && kend > k0;
    // An edge tile masks its logits and computes only the 8-key groups
    // below kend and the 4-row groups below S.
    const bool edge = kend < k0 + F_BK || (causal && k0 + F_BK - 1 > wr0) || row_groups < TM;
    const int key_groups = (kend - k0 + 7) / 8;

    // S = Q K^T, masked, and the online softmax; P into the warp's slice.
    auto qk_softmax = [&](auto edge_tag) {
      constexpr bool EDGE = decltype(edge_tag)::value;
      const int jn = EDGE ? key_groups : 8;
      const int in = EDGE ? row_groups : TM;
      float s[TM][8];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      const float* qrow = qs + (warp * WR + ty) * LD;
      const float* krow = ks + tx * LD;
      for (int d = 0; d < DH; d += 4) {
        float4 kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < jn) kf[j] = *reinterpret_cast<const float4*>(krow + 8 * j * LD + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i < in) {
            const float4 qf = *reinterpret_cast<const float4*>(qrow + 4 * i * LD + d);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < jn) s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < jn) s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < jn) s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < jn) s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i < in) {
          const int qp = wr0 + ty + 4 * i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < jn) {
              float x = s[i][j] * scale_log2;
              if (EDGE) {
                const int kp = k0 + tx + 8 * j;
                x = kp < kv_len && (!causal || kp <= qp) ? x : -INFINITY;
              }
              s[i][j] = x;
              mx = fmaxf(mx, x);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          // m stays finite (>= M_INIT), so masked logits give exp2(-inf) = 0
          // and a row with no visible key keeps l == 0.
          const float m_new = fmaxf(m[i], mx);
          const float alpha = fast_exp2(m[i] - m_new);
          m[i] = m_new;
          float rs = 0.f;
          float* prow = ps + (ty + 4 * i) * F_LP + tx;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < jn) {
              const float p = fast_exp2(s[i][j] - m_new);
              rs += p;
              prow[8 * j] = p;
            }
          }
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          rs += __shfl_xor_sync(0xffffffffu, rs, 4);
          l[i] = l[i] * alpha + rs;
#pragma unroll
          for (int d = 0; d < TD; ++d) acc[i][d] *= alpha;
        }
      }
      __syncwarp();  // the warp's P is written
    };

    // O += P V over the keys whose P this warp wrote.
    auto pv = [&](auto edge_tag) {
      constexpr bool EDGE = decltype(edge_tag)::value;
      const int in = EDGE ? row_groups : TM;
      const int n_keys = EDGE ? 8 * key_groups : F_BK;
      const float* prow = ps + ty * F_LP;
      for (int c = 0; c < n_keys; c += 4) {
        float4 pf[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (i < in) pf[i] = *reinterpret_cast<const float4*>(prow + 4 * i * F_LP + c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vrow = vs + (c + kk) * DH;
          float4 vf[NC4 > 0 ? NC4 : 1];
          float vc[NR > 0 ? NR : 1];
#pragma unroll
          for (int mm = 0; mm < NC4; ++mm)
            vf[mm] = *reinterpret_cast<const float4*>(vrow + 4 * (tx + 8 * mm));
#pragma unroll
          for (int r = 0; r < NR; ++r) vc[r] = vrow[32 * NC4 + tx + 8 * r];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (i < in) {
              const float p = kk == 0 ? pf[i].x : kk == 1 ? pf[i].y : kk == 2 ? pf[i].z : pf[i].w;
#pragma unroll
              for (int mm = 0; mm < NC4; ++mm) {
                acc[i][4 * mm] = fmaf(p, vf[mm].x, acc[i][4 * mm]);
                acc[i][4 * mm + 1] = fmaf(p, vf[mm].y, acc[i][4 * mm + 1]);
                acc[i][4 * mm + 2] = fmaf(p, vf[mm].z, acc[i][4 * mm + 2]);
                acc[i][4 * mm + 3] = fmaf(p, vf[mm].w, acc[i][4 * mm + 3]);
              }
#pragma unroll
              for (int r = 0; r < NR; ++r) acc[i][4 * NC4 + r] = fmaf(p, vc[r], acc[i][4 * NC4 + r]);
            }
          }
        }
      }
    };

    if (active) {
      if (edge) {
        qk_softmax(std::true_type{});
      } else {
        qk_softmax(std::false_type{});
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // V in shared memory; every warp is done with K
    if (t + 1 < n_tiles) load(ks, LD, kb, kss, k0 + F_BK);
    if (active) {
      if (edge) {
        pv(std::true_type{});
      } else {
        pv(std::false_type{});
      }
    }
  }

  hopper::cp_async_wait<0>();  // kv_len 0 leaves the first tile's zero-fill in flight

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = wr0 + ty + 4 * i;
    if (qp >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + qp * oss;
#pragma unroll
    for (int mm = 0; mm < NC4; ++mm) {
      *reinterpret_cast<float4*>(orow + 4 * (tx + 8 * mm)) =
          make_float4(acc[i][4 * mm] * inv, acc[i][4 * mm + 1] * inv, acc[i][4 * mm + 2] * inv,
                      acc[i][4 * mm + 3] * inv);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) orow[32 * NC4 + tx + 8 * r] = acc[i][4 * NC4 + r] * inv;
  }
}

template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int S, int kv_len, int causal, const long long* st,
                        cudaStream_t stream) {
  using Sh = F32Shape<DH>;
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err =
      hopper::allow_smem(flash_fwd_fp32_kernel<DH>, Sh::smem(F_MAX_WARPS), granted);
  if (err != cudaSuccess) return err;
  // The most warps a block that still put a block on every SM and leave
  // under a quarter of the warps without a row (S = 257 at 32 rows a warp
  // is 9 warps: 3 blocks of 3, not 3 blocks of 4 whose last holds one row).
  const int bh = B * H;
  const int warps = (S + F_WR - 1) / F_WR;  // a head's
  int nw = 1;
  for (int c = F_MAX_WARPS; c > 1; --c) {
    const int blocks = (warps + c - 1) / c;
    if (bh * blocks >= FILL_BLOCKS && 4 * (blocks * c - warps) < blocks * c) {
      nw = c;
      break;
    }
  }
  const dim3 grid(unsigned((warps + nw - 1) / nw) * unsigned(bh));
  const float scale_log2 = LOG2E / sqrtf(float(DH));
  flash_fwd_fp32_kernel<DH><<<grid, 32 * nw, Sh::smem(nw), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, S, kv_len, causal, scale_log2, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(int dh, const void* q, const void* k, const void* v, void* o, int B,
                          int H, int S, int kv_len, int causal, const long long* st,
                          cudaStream_t stream) {
  switch (dh) {
#define CASE(D) \
  case D:       \
    return launch_fp32<D>(q, k, v, o, B, H, S, kv_len, causal, st, stream);
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
  if (dtype == 0) return dispatch_fp32(Dh, q, k, v, o, B, H, S, kv_len, causal, strides, st);
  if (dtype == 1) return dispatch_bf16(Dh, q, k, v, o, B, H, S, kv_len, causal, strides, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
