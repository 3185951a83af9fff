// K3 and K4: dynamic per-row symmetric int8 quantization, the second with
// an fp32 LayerNorm fused in front, for Hopper (sm_90a), CUDA C++.
//
// Replaces imatch_tpu/ops/pallas/quantize.py::_quant_kernel (K3) and
// ::_ln_quant_kernel (K4), both launched by _run (quant_rows_pallas and
// ln_quant_rows_pallas). For each row x of length D (fp32 or bf16 in,
// fp32 math):
//   K4 first:  y = (x - mean) * rsqrt(var + eps) * gamma + beta, with mean
//              and var = mean((x - mean)^2) over the row (two passes over
//              the row held in registers);
//   then:      amax = max |y|; scale = amax / 127 (1 for a zero row);
//              q = clip(rint(y * (127 / amax)), -127, 127) as int8.
// The reciprocal is one IEEE division a row (the build has no fast math)
// and rint rounds half to even, as jnp.round does; the LayerNorm's
// products and sums use the _rn intrinsics so that nvcc does not contract
// them into FMAs the plain PyTorch version does not have. rsqrtf is not
// correctly rounded: codes may differ from the plain version by one at a
// rounding boundary.
//
// What bounds it on the card: about one operation per byte, so it is bound
// by its bytes over the 3.35 TB/s of HBM3: each input element read once,
// one int8 code written, one fp32 scale a row (K4 also reads gamma and
// beta once). What the design does about that: one block a row, the row
// kept in registers between the reductions (each element crosses HBM once,
// the normalised fp32 row never does), 16-byte vector loads with
// neighbouring threads on neighbouring addresses, and 4- or 8-byte stores
// of the codes. A block holds up to 256 threads, each with 1, 2, 4 or 8
// vectors of the row, so rows of any D that is a multiple of 8 (up to 8192
// vectors) fit; threads past the row's end are masked. The reductions are
// warp shuffles, then one pass through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;  // preferred block width; up to 1024 at NV 8

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + e));
    x[e] = v.x;
    x[e + 1] = v.y;
    x[e + 2] = v.z;
    x[e + 3] = v.w;
  }
}

__device__ __forceinline__ void store(int8_t* p, const int (&c)[4]) {
  const uint32_t w = (uint32_t(uint8_t(c[0]))) | (uint32_t(uint8_t(c[1])) << 8) |
                     (uint32_t(uint8_t(c[2])) << 16) | (uint32_t(uint8_t(c[3])) << 24);
  *reinterpret_cast<uint32_t*>(p) = w;
}

__device__ __forceinline__ void store(int8_t* p, const int (&c)[8]) {
  uint2 w;
  w.x = (uint32_t(uint8_t(c[0]))) | (uint32_t(uint8_t(c[1])) << 8) |
        (uint32_t(uint8_t(c[2])) << 16) | (uint32_t(uint8_t(c[3])) << 24);
  w.y = (uint32_t(uint8_t(c[4]))) | (uint32_t(uint8_t(c[5])) << 8) |
        (uint32_t(uint8_t(c[6])) << 16) | (uint32_t(uint8_t(c[7])) << 24);
  *reinterpret_cast<uint2*>(p) = w;
}

// Sum (MAX false) or max (MAX true, of values >= 0) over the block, returned
// to every thread. blockDim.x is a multiple of 32; `red` holds 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < int(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

template <typename T, int NV, bool LN>
__global__ void quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int8_t* __restrict__ q,
                                  float* __restrict__ scale, int D, float eps) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const int nvec = D / V;
  const T* xr = x + row * size_t(D);

  float v[NV][V];
  bool in_row[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * int(blockDim.x);
    in_row[k] = j < nvec;
    if (in_row[k]) {
      load(xr + size_t(j) * V, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[k][e] = 0.f;
    }
  }

  if (LN) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[k][e];  // masked entries are 0
    const float mean = block_reduce<false>(s, red) / float(D);
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!in_row[k]) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = __fsub_rn(v[k][e], mean);
        s2 += d * d;
      }
    }
    const float var = block_reduce<false>(s2, red) / float(D);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!in_row[k]) continue;
      const int j = threadIdx.x + k * int(blockDim.x);
      float g[V], b[V];
      load_f32<V>(gamma + size_t(j) * V, g);
      load_f32<V>(beta + size_t(j) * V, b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float t = __fmul_rn(__fsub_rn(v[k][e], mean), rstd);
        v[k][e] = __fadd_rn(__fmul_rn(t, g[e]), b[e]);
      }
    }
  }

  float m = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[k][e]));
  const float amax = block_reduce<true>(m, red);
  const bool nonzero = amax > 0.f;
  const float inv = nonzero ? 127.0f / amax : 1.0f;
  if (threadIdx.x == 0) scale[row] = nonzero ? amax / 127.0f : 1.0f;

  int8_t* qr = q + row * size_t(D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!in_row[k]) continue;
    const int j = threadIdx.x + k * int(blockDim.x);
    int c[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int r = __float2int_rn(__fmul_rn(v[k][e], inv));
      c[e] = min(max(r, -127), 127);
    }
    store(qr + size_t(j) * V, c);
  }
}

template <typename T, int NV, bool LN>
cudaError_t launch(const void* x, const float* gamma, const float* beta, int8_t* q, float* scale,
                   int R, int D, int threads, float eps, cudaStream_t stream) {
  quant_rows_kernel<T, NV, LN><<<R, threads, 0, stream>>>(static_cast<const T*>(x), gamma, beta,
                                                          q, scale, D, eps);
  return cudaGetLastError();
}

template <typename T, bool LN>
cudaError_t dispatch(const void* x, const float* gamma, const float* beta, int8_t* q, float* scale,
                     int R, int D, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int nvec = D / V;
  // The fewest vectors a thread that keep the block at most MAX_THREADS
  // wide; past 8 vectors a thread the block grows up to 1024 threads.
  int nv = 1;
  while (nv < 8 && (nvec + nv - 1) / nv > MAX_THREADS) nv *= 2;
  const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  if (threads > 1024 || D % V != 0) return cudaErrorInvalidValue;
  switch (nv) {
    case 1: return launch<T, 1, LN>(x, gamma, beta, q, scale, R, D, threads, eps, stream);
    case 2: return launch<T, 2, LN>(x, gamma, beta, q, scale, R, D, threads, eps, stream);
    case 4: return launch<T, 4, LN>(x, gamma, beta, q, scale, R, D, threads, eps, stream);
    default: return launch<T, 8, LN>(x, gamma, beta, q, scale, R, D, threads, eps, stream);
  }
}

template <typename T>
cudaError_t dispatch_ln(const void* x, const float* gamma, const float* beta, int8_t* q,
                        float* scale, int ln, int R, int D, float eps, cudaStream_t stream) {
  if (ln) return dispatch<T, true>(x, gamma, beta, q, scale, R, D, eps, stream);
  return dispatch<T, false>(x, gamma, beta, q, scale, R, D, eps, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x is (R, D) row-major in that dtype,
// 16-byte aligned, with D a multiple of 8; q is (R, D) int8 and scale (R,)
// fp32. ln = 0 runs K3 (gamma and beta unused, may be null); ln = 1 runs K4
// with fp32 gamma and beta of length D. Returns the cudaError_t of the
// launch (0 on success).
int quant_rows(const void* x, const void* gamma, const void* beta, void* q, void* scale,
               int dtype, int ln, int R, int D, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  if (R <= 0) return cudaSuccess;
  if (dtype == 0) return dispatch_ln<float>(x, g, b, qo, so, ln, R, D, eps, st);
  if (dtype == 1) return dispatch_ln<__nv_bfloat16>(x, g, b, qo, so, ln, R, D, eps, st);
  return cudaErrorInvalidValue;
}

const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
