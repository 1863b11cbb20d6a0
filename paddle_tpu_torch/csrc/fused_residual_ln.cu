// Fused bias + dropout + residual add + LayerNorm for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_residual_ln.py:_kernel
// (launched by _kernel_path): over [N, D] rows of x and residual (f32, bf16
// or f16) with f32 bias, gamma and beta of [D],
//     h = x + bias
//     h = h * keep / (1 - p)          training with p > 0 only
//     h = h + residual
//     y = (h - mean(h)) * rsqrt(mean((h - mean(h))^2) + eps) * gamma + beta
// all in f32, y stored in x's dtype. The dropout mask is the reference's
// counter hash of (seed, global row, column), computed in registers, bit for
// bit: keep = u >= p with u = uint32 hash / 2^32, where the uint32 -> f32
// conversion rounds to nearest as XLA's does (hashes at or above
// 2^32 - 128 give u = 1.0). (1 - p) is the f32 of the host's double 1 - p
// and the kernel divides by it, as the reference does; it does not multiply
// by a reciprocal. The variance takes two passes over the row held in
// registers, mean((h - mu)^2), as the reference does.
//
// What bounds it on the H100: bytes. A bf16 element moves 2 + 2 bytes in
// and 2 out (6 bytes) against ~30 integer and float operations, below the
// card's operations-per-byte line. What the design does about the bound: x
// and residual are read once and y written once, the mask never touches
// memory, and the row stays in registers between the two reductions. One
// block of 256 threads per row; thread t holds columns t, t + 256, ... (VPT
// of them, a template power of two), so D is any width up to 256 * 32 =
// 8192 with ragged columns masked, and N any count up to 2^31 - 1.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int MAX_VPT = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

// the reference's _hash_uniform for one element, in uint32 arithmetic
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row, uint32_t col) {
  uint32_t x = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu);
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return __uint2float_rn(x) / 4294967296.0f;
}

// sum over the block; every thread gets the total
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction has read smem
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float t = lane < NT / 32 ? smem[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(NT)
fused_residual_ln_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                         const T* __restrict__ res, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ out, int d,
                         uint32_t seed, float p, float one_minus_p, float eps,
                         int dropout) {
  __shared__ float smem[NT / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  T* orow = out + row * d;
  float h[VPT];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * NT;
    float v = 0.f;
    if (c < d) {
      v = to_f32(xr[c]) + bias[c];
      if (dropout) {
        const float keep = hash_uniform(seed, (uint32_t)row, (uint32_t)c) >= p ? 1.f : 0.f;
        v = __fdiv_rn(v * keep, one_minus_p);
      }
      v = v + to_f32(rr[c]);
      sum += v;
    }
    h[k] = v;
  }
  const float mu = __fdiv_rn(block_sum(sum, smem), (float)d);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * NT;
    if (c < d) {
      const float t = h[k] - mu;
      sq += t * t;
    }
  }
  const float var = __fdiv_rn(block_sum(sq, smem), (float)d);
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * NT;
    if (c < d) store(orow + c, (h[k] - mu) * inv * gamma[c] + beta[c]);
  }
}

template <typename T, int VPT>
cudaError_t launch(const void* x, const float* bias, const void* res, const float* gamma,
                   const float* beta, void* out, long long n, int d, uint32_t seed, float p,
                   float one_minus_p, float eps, int dropout, cudaStream_t stream) {
  fused_residual_ln_kernel<T, VPT><<<(unsigned)n, NT, 0, stream>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(res), gamma, beta,
      static_cast<T*>(out), d, seed, p, one_minus_p, eps, dropout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* bias, const void* res, const float* gamma,
                     const float* beta, void* out, long long n, int d, uint32_t seed, float p,
                     float one_minus_p, float eps, int dropout, cudaStream_t stream) {
  const int vpt = (d + NT - 1) / NT;
#define PT_LN_CASE(V)                                                                   \
  if (vpt <= V)                                                                         \
    return launch<T, V>(x, bias, res, gamma, beta, out, n, d, seed, p, one_minus_p, eps, \
                        dropout, stream);
  PT_LN_CASE(1)
  PT_LN_CASE(2)
  PT_LN_CASE(4)
  PT_LN_CASE(8)
  PT_LN_CASE(16)
  PT_LN_CASE(MAX_VPT)
#undef PT_LN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (x, residual and out). Returns the CUDA
// error of the launch (0 on success).
int fused_residual_ln(const void* x, const void* bias, const void* res, const void* gamma,
                      const void* beta, void* out, long long n, int d, unsigned int seed,
                      float p, float one_minus_p, float eps, int dropout, int dtype,
                      void* stream) {
  if (n < 1 || n > 0x7fffffffLL || d < 1 || d > NT * MAX_VPT) return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const float*>(bias);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(x, b, res, g, be, out, n, d, seed, p, one_minus_p, eps,
                                  dropout, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, b, res, g, be, out, n, d, seed, p, one_minus_p,
                                          eps, dropout, s);
    case 2:
      return (int)dispatch<__half>(x, b, res, g, be, out, n, d, seed, p, one_minus_p, eps,
                                   dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
