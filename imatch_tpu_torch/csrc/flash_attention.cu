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
// about S operations per element, so with tensor cores it would be bound by
// its bytes below S ~ 300 and by the tensor cores above. This first design
// does the two products on the fp32 CUDA cores (67 TFLOP/s, not the 989 of
// bf16 tensor cores), so it is bound by those operations. What the design
// does about the rest: Q, K and V are read once per (query block, key block)
// and never written back; the S x S logits live only in shared memory; the
// ragged edges (S not a multiple of 64) are masked in the kernel, with no
// padded copies; strided inputs are read in place (Dh contiguous), so the
// caller's fused QKV projection needs no transpose copies.
//
// Layout of one block: 128 threads own a 64-query tile. Thread (ty, tx),
// ty = tid / 8 and tx = tid % 8, owns query rows 4*ty .. 4*ty+3, key columns
// tx + 8*j of each logits tile and output columns tx + 8*j of the
// accumulator. The 8 threads of a row group sit in one warp, so row maxima
// and sums reduce with three xor shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per step
constexpr int NTHREADS = 128;   // 16 row groups x 8 column lanes
constexpr float M_INIT = -1e30f;  // running max before any visible key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                   int kv_len, int causal, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
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
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, H, S, kv_len, causal, strides, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
