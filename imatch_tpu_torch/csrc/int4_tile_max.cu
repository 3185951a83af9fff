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
// rows 0 and 1 of the side array, read once per chunk of 8 queries, over
// the 3.35 TB/s of HBM3; at 8 x 2^20 x 512 that is 0.0814 ms. The first
// design (fp32 FMAs on CUDA cores, the query chunk read from shared memory
// for every 16 bytes of codes) was bound by shared-memory bandwidth at 8x
// the bound. As the TPU kernel does on its matrix unit, this one unpacks
// the codes to bf16 (exact) and multiplies on the tensor cores: mma.sync
// m16n8k16, bf16 in, fp32 accumulation, A = 16 corpus rows (an m-tile) x
// 16 features, B = 16 features x the block's 8 queries (zero columns past
// Q; more queries are more query chunks in the grid's y).
//
// A dot product may sum its features in any order, so the k index of the
// fragments is a permutation chosen for the loads. Lane (g, t) of a warp
// (g = lane / 4, t = lane % 4) takes the 16-byte chunks 4j + t of rows g
// and g + 8 of an m-tile, a quad reading 64 contiguous bytes of a row.
// Each 32-bit word w of a chunk (bytes b .. b + 3) becomes four bf16
// pairs without the integer-to-float unit: (w >> s) & 0x000F000F puts two
// nibbles at bits 0-3 and 16-19, and XOR with 0x43084308 flips their sign
// bits (u = code + 8 in [0, 15]) and sets 0x4300 above them, giving the
// bf16 pair 128 + u, exactly; one bf16 subtract of 136 leaves the codes,
// exactly. Shifts 0, 4, 8, 12 give the features (b, b+2), (b+H, b+H+2),
// (b+1, b+3), (b+H+1, b+H+3): the A registers of two k16 steps. The
// queries' B fragments are staged once a block in shared memory in the
// same order ([step][word][lane], so a warp's 16-byte reads are
// conflict-free) and, where a row fits one segment of 4 x KC chunks
// (D <= 512), copied once into registers (64 of them at D = 512): no query
// is read from shared memory inside the row loop. Longer rows run in
// segments and reload the segment's B fragments a unit. Chunks past H (H
// not a multiple of 64 bytes) are zero-filled and meet zero queries.
//
// Bytes in flight: with the loads in registers (a ring of three m-tiles a
// warp, 220 registers, 8 warps an SM) the kernel stayed well short of its
// bound, and so did its loads alone: what held it back was the bytes in
// flight, not the arithmetic. Here each lane streams its own chunks
// of the next STAGES - 1 units into a private ring in shared memory with
// cp.async (16 bytes a copy, with an L2 256-byte prefetch hint; the rows'
// scale and validity as the aligned 4-byte words that hold them), so the
// bytes in flight cost no registers: 118 registers, 4 warps a block, 3
// blocks (12 warps) an SM. A lane reads back only what it copied, so no
// barrier guards the ring; cp.async.wait_group alone orders it. Two
// accumulator chains (even and odd k16 steps) halve the mma dependency
// chain; products are exact, only the order of the fp32 sums differs from
// the plain version. The epilogue scales each row's sum by its bf16 scale
// (one rounded multiply, as the plain version), masks rows whose validity
// is not > 0, and keeps a running max per query in registers; at the
// tile's end shuffles reduce over g and shared memory over the warps: one
// plain store per (query, tile), no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int STAGES = 3;  // units a warp has in its ring: STAGES - 1 in flight
constexpr int QC = 8;      // queries a block: the n of one m16n8k16
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

// Two nibbles of w, at bits SHIFT .. SHIFT + 3 and SHIFT + 16 .. + 19, as
// a bf16 pair of their signed codes (exact).
template <int SHIFT>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  const uint32_t biased = ((w >> SHIFT) & 0x000F000Fu) ^ 0x43084308u;  // 128 + code + 8
  const uint32_t k136 = 0x43084308u;                                    // bf16 136, twice
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// 16 bytes to shared memory, asking L2 to fetch the whole 256-byte row
// segment; with `pred` false nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async16_l2_256(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// The 4-byte aligned word that holds the bf16 at p, and the shift that
// brings that bf16 to its low half.
__device__ __forceinline__ const void* word_of(const uint16_t* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
}
__device__ __forceinline__ int half_shift(const uint16_t* p) {
  return int(reinterpret_cast<uintptr_t>(p) & 2) * 8;
}

// Where a warp's units lie. A unit is one segment (4 * KC chunks a lane
// quad, 64 * KC bytes) of one m-tile; unit u is segment u % nseg of the
// warp's m-tile u / nseg (m-tile warp + NWARPS * (u / nseg) of the tile).
struct Rows {
  const uint8_t* packed;
  const uint16_t* side;
  size_t row0;  // the tile's first row
  int H, N, nc, nseg, tile_n, warp, g, t;

  // the tile row of unit u that A row g + 8h holds
  __device__ __forceinline__ int row(int u, int h) const {
    return (warp + NWARPS * (u / nseg)) * 16 + g + 8 * h;
  }
};

// Unit u into a lane's slots of one stage, 16 bytes each and 32 lanes
// apart: slot h * KC + j holds chunk 4 (seg KC + j) + t of row g + 8h;
// slot 2 KC the words of scale g, validity g, scale g + 8, validity g + 8.
template <int KC>
__device__ __forceinline__ void issue_unit(const Rows& rw, int u, uint32_t slots) {
  const int seg = u % rw.nseg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rw.row(u, h);
    const bool in = rr < rw.tile_n;
    const size_t row = rw.row0 + (in ? rr : 0);
    const uint8_t* p = rw.packed + row * size_t(rw.H);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = 4 * (seg * KC + j) + rw.t;
      const bool ok = in && c < rw.nc;
      cp_async16_l2_256(slots + (h * KC + j) * 32 * 16, p + (ok ? 16 * c : 0), ok);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // zeroed past the tile: validity 0, masked
      cp_async4(slots + 2 * KC * 32 * 16 + 4 * (2 * h + k), word_of(rw.side + size_t(k) * rw.N + row),
                in);
    }
  }
  hopper::cp_async_commit();
}

// The B fragments of segment seg: 16 registers a chunk step, in the order
// codes_bf16x2 produces the A registers.
template <int KC>
__device__ __forceinline__ void load_b(const uint4* qsm, int seg, int lane, uint32_t (&bq)[KC][16]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = qsm[((seg * KC + j) * 4 + i) * 32 + lane];
      bq[j][4 * i] = v.x;
      bq[j][4 * i + 1] = v.y;
      bq[j][4 * i + 2] = v.z;
      bq[j][4 * i + 3] = v.w;
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(NTHREADS, 3)
int4_tile_max_mma_kernel(const uint16_t* __restrict__ queries, const uint8_t* __restrict__ packed,
                         const uint16_t* __restrict__ side, float* __restrict__ out, int Q, int H,
                         int N, int tile_n, int n_tiles) {
  constexpr int SLOTS = 2 * KC + 1;
  constexpr uint32_t STAGE_BYTES = SLOTS * 32 * 16;
  // the B fragments ([step J][word i][lane]: word m of the uint4 is the
  // bf16 pair of query g at the features of codes_bf16x2's register m of
  // word i of chunk 4J + t), then each warp's ring of STAGES x SLOTS x 32
  extern __shared__ __align__(16) uint4 smem[];
  __shared__ float red[NWARPS][QC];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nc = H / 16;
  const int nseg = (nc + 4 * KC - 1) / (4 * KC);
  const int qbase = blockIdx.y * QC;
  const int n_mt = (tile_n + 15) / 16;
  const int units = warp < n_mt ? ((n_mt - 1 - warp) / NWARPS + 1) * nseg : 0;
  const Rows rw{packed, side, size_t(blockIdx.x) * tile_n, H, N, nc, nseg, tile_n, warp,
                lane >> 2, lane & 3};
  const uint4* qsm = smem;
  const uint4* ring = smem + nseg * KC * 4 * 32 + warp * STAGES * SLOTS * 32 + lane;
  const uint32_t ring_addr = hopper::smem_addr(ring);

  // The first STAGES - 1 units go out before the queries are staged; a
  // group is committed for every unit number, empty past the last, so
  // that wait_group counts the same everywhere.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < units) {
      issue_unit<KC>(rw, s, ring_addr + s * STAGE_BYTES);
    } else {
      hopper::cp_async_commit();
    }
  }

  uint32_t* qw = reinterpret_cast<uint32_t*>(smem);
  for (int idx = threadIdx.x; idx < nseg * KC * 512; idx += NTHREADS) {
    const int m = idx & 3, l = (idx >> 2) & 31, i = (idx >> 7) & 3, J = idx >> 9;
    const int qi = qbase + (l >> 2);
    const int c = 4 * J + (l & 3);
    uint32_t w = 0u;
    if (qi < Q && c < nc) {
      // register m of word i: features f and f + 2, f = 16c + 4i + m / 2 (+ H for odd m)
      const uint16_t* q = queries + size_t(qi) * 2 * H + 16 * c + 4 * i + (m >> 1) + (m & 1) * H;
      w = uint32_t(q[0]) | (uint32_t(q[2]) << 16);
    }
    qw[idx] = w;
  }
  __syncthreads();

  uint32_t bq[KC][16];
  if (nseg == 1) load_b<KC>(qsm, 0, lane, bq);
  float acc[2][4];
  float best[2] = {NEG_INF, NEG_INF};  // queries 2t and 2t + 1
  // units is the same for every lane of a warp: mma.sync needs them all
  for (int u = 0, stage = 0; u < units; ++u, stage = stage + 1 == STAGES ? 0 : stage + 1) {
    const int ahead = u + STAGES - 1;  // into the stage read one unit ago
    const uint32_t refill = ring_addr + (stage == 0 ? STAGES - 1 : stage - 1) * STAGE_BYTES;
    if (ahead < units) {
      issue_unit<KC>(rw, ahead, refill);
    } else {
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait<STAGES - 1>();  // unit u's group has landed
    const uint4* sl = ring + stage * SLOTS * 32;
    const int seg = u % nseg;
    if (nseg > 1) load_b<KC>(qsm, seg, lane, bq);
    if (seg == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] = acc[1][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const uint4 xa = sl[j * 32];
      const uint4 xb = sl[(KC + j) * 32];
      const uint32_t wa[4] = {xa.x, xa.y, xa.z, xa.w};
      const uint32_t wb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a[0], a[2]: row g; a[1], a[3]: row g + 8 (hopper_mma.cuh's layout)
        const uint32_t a0[4] = {codes_bf16x2<0>(wa[i]), codes_bf16x2<0>(wb[i]),
                                codes_bf16x2<4>(wa[i]), codes_bf16x2<4>(wb[i])};
        hopper::mma_bf16(acc[0], a0, bq[j][4 * i], bq[j][4 * i + 1]);
        const uint32_t a1[4] = {codes_bf16x2<8>(wa[i]), codes_bf16x2<8>(wb[i]),
                                codes_bf16x2<12>(wa[i]), codes_bf16x2<12>(wb[i])};
        hopper::mma_bf16(acc[1], a1, bq[j][4 * i + 2], bq[j][4 * i + 3]);
      }
    }
    if (seg == nseg - 1) {
      const uint4 sw = sl[2 * KC * 32];
      const uint32_t words[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // c[2h + e] = C[g + 8h][2t + e]
        const size_t row = rw.row0 + rw.row(u, h);
        const uint32_t valid = words[2 * h + 1] >> half_shift(side + size_t(N) + row);
        if (bf16_bits_to_float(valid & 0xffffu) > 0.f) {
          const float scale = bf16_bits_to_float((words[2 * h] >> half_shift(side + row)) & 0xffffu);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = __fmul_rn(__fadd_rn(acc[0][2 * h + e], acc[1][2 * h + e]), scale);
            best[e] = fmaxf(best[e], s);
          }
        }
      }
    }
  }
  hopper::cp_async_wait<0>();  // the empty groups

  // The 8 row pairs of a warp (lanes with the same t), then the warps.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float b = best[e];
    b = fmaxf(b, __shfl_xor_sync(FULL, b, 4));
    b = fmaxf(b, __shfl_xor_sync(FULL, b, 8));
    b = fmaxf(b, __shfl_xor_sync(FULL, b, 16));
    if (lane < 4) red[warp][2 * lane + e] = b;
  }
  __syncthreads();
  const int nq = min(QC, Q - qbase);
  if (threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    out[size_t(qbase + threadIdx.x) * n_tiles + blockIdx.x] = m;
  }
}

template <int KC>
cudaError_t launch(const uint16_t* queries, const uint8_t* packed, const uint16_t* side, float* out,
                   int Q, int H, int N, int tile_n, int n_tiles, cudaStream_t stream) {
  const int nseg = (H / 16 + 4 * KC - 1) / (4 * KC);
  const size_t smem =
      sizeof(uint4) * (size_t(nseg) * KC * 4 * 32 + size_t(NWARPS) * STAGES * (2 * KC + 1) * 32);
  static std::atomic<int> granted[hopper::kMaxDevices];
  cudaError_t err = hopper::allow_smem(int4_tile_max_mma_kernel<KC>, int(smem), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (Q + QC - 1) / QC);
  int4_tile_max_mma_kernel<KC><<<grid, NTHREADS, smem, stream>>>(queries, packed, side, out, Q, H,
                                                                  N, tile_n, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries (Q, 2H) bf16; packed (N, H) bytes, H a multiple of 16, rows
// 16-byte aligned; side (8, N) bf16 (row 0 scale, row 1 validity); out
// (Q, N / tile_n) fp32, all row-major. Returns the cudaError_t of the
// launch (0 on success).
int int4_tile_max(const void* queries, const void* packed, const void* side, void* out, int Q,
                  int H, int N, int tile_n, void* stream) {
  if (H <= 0 || H % 16 || tile_n <= 0 || N % tile_n) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* q = static_cast<const uint16_t*>(queries);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const uint16_t* s = static_cast<const uint16_t*>(side);
  float* o = static_cast<float*>(out);
  const int n_tiles = N / tile_n;
  // the fewest chunk steps a lane that hold a row (one segment up to D = 512)
  if (H <= 64) return launch<1>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
  if (H <= 128) return launch<2>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
  return launch<4>(q, p, s, o, Q, H, N, tile_n, n_tiles, st);
}

const char* int4_tile_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
