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
// card's operations-per-byte line (bf16 [8192, 2048]: 0.030 ms at 3.35
// TB/s). What the design does about the bound: x and residual are read once
// and y written once, the mask never touches memory, and the row stays in
// registers between the two reductions. Two kernels, one chosen by shape
// before the launch (fused_residual_ln_route in
// ops/kernels/fused_residual_ln.py) and passed in:
//   - warp (D a multiple of one 16-byte chunk, 8 bf16/f16 or 4 f32, rows of
//     up to 2048 elements, 16-byte aligned operands): one warp a row, eight
//     rows a block. Lane l holds chunks l, l + 32, ... (CH of them, a
//     template power of two: at most 64 f32 a lane), loaded and stored as
//     16-byte vectors (a warp moves 512 contiguous bytes a load), with
//     bias, gamma and beta as float4 loads that stay in L1 across the
//     block's rows. Both reductions are warp shuffles: no shared memory and
//     no __syncthreads. The keep test is an integer compare of the hash
//     against the host's threshold t(p), the least uint32 whose
//     round-to-nearest f32 times 2^-32 is >= f32(p); the f32 map is
//     monotone, so hash >= t(p) is the reference's u >= p for every hash
//     (keep_threshold in the wrapper; a CPU test checks it).
//   - block (every other width up to 8192: ragged rows such as D = 2050,
//     and rows too wide for one warp's registers): one block of 256
//     threads a row; thread t holds columns t, t + 256, ... (VPT of them, a
//     template power of two), scalar loads with ragged columns masked, and
//     two block-wide reductions through shared memory.
// N is any count up to 2^31 - 1.
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

// the reference's counter hash of one element, uint32 (hash_uniform
// before its conversion to f32)
__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  uint32_t x = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu);
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the reference's _hash_uniform: the hash in [0, 1], its uint32 -> f32
// conversion rounding to nearest as XLA's does
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row, uint32_t col) {
  return __uint2float_rn(hash_bits(seed, row, col)) / 4294967296.0f;
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

// ---------------------------------------------------------------- warp route
constexpr int WARP_ROWS = 8;        // rows (warps) a block
constexpr int WARP_MAX_ELEMS = 64;  // f32 a lane holds

// 16 bytes of T as f32
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8], __nv_bfloat16) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8], __half) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __half) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 t = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename T> struct Chunk {   // one 16-byte chunk of a row
  static constexpr int V = 16 / sizeof(T);
  static __device__ __forceinline__ void load(uint4 v, float (&f)[V]) {
    if constexpr (V == 4) unpack(v, f); else unpack(v, f, T());
  }
  static __device__ __forceinline__ uint4 store(const float (&f)[V]) {
    if constexpr (V == 4) return pack(f); else return pack(f, T());
  }
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid: ceil(n / 8) blocks of 8 warps; warp w of block b normalises row
// 8b + w. keep_from: the least hash kept (2^32: none); dropped: f32
// 0 / (1 - p) (+0, -0 or NaN), the factor of a dropped element.
template <typename T, int CH, bool DROP>
__global__ void __launch_bounds__(32 * WARP_ROWS)
fused_residual_ln_warp_kernel(const T* __restrict__ x,
                              const float* __restrict__ bias,
                              const T* __restrict__ res,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ out, long long n, int d,
                              uint32_t seed, unsigned long long keep_from,
                              float one_minus_p, float dropped, float eps) {
  constexpr int V = Chunk<T>::V;
  const long long row = static_cast<long long>(blockIdx.x) * WARP_ROWS +
                        threadIdx.x / 32;
  if (row >= n) return;   // a whole warp: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const int chunks = d / V;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  float h[CH][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int q = lane + 32 * i, c0 = q * V;
    if (q < chunks) {
      float xv[V], rv[V], bv[V];
      Chunk<T>::load(ld_stream(xr + c0), xv);
      Chunk<T>::load(ld_stream(rr + c0), rv);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c0 + j));
        bv[j] = b.x, bv[j + 1] = b.y, bv[j + 2] = b.z, bv[j + 3] = b.w;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = xv[j] + bv[j];
        if constexpr (DROP) {
          // the reference's (v * keep) / (1 - p): v / (1 - p) kept, and
          // (v * 0) / (1 - p) = v * dropped (the host's f32 0 / (1 - p))
          // dropped, so no division sees a zero dividend, which would
          // leave div.rn's fast path for every warp with one dropped lane
          const uint32_t u = hash_bits(seed, (uint32_t)row, (uint32_t)(c0 + j));
          const float kept = __fdiv_rn(v, one_minus_p);
          v = (unsigned long long)u >= keep_from ? kept : v * dropped;
        }
        v = v + rv[j];
        sum += v;
        h[i][j] = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) h[i][j] = 0.f;
    }
  }
  const float mu = __fdiv_rn(warp_sum(sum), (float)d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = h[i][j] - mu;
        sq += t * t;
      }
  const float var = __fdiv_rn(warp_sum(sq), (float)d);
  const float inv = rsqrtf(var + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int q = lane + 32 * i, c0 = q * V;
    if (q < chunks) {
      float y[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + c0 + j));
        const float4 b = __ldg(reinterpret_cast<const float4*>(beta + c0 + j));
        y[j] = (h[i][j] - mu) * inv * g.x + b.x;
        y[j + 1] = (h[i][j + 1] - mu) * inv * g.y + b.y;
        y[j + 2] = (h[i][j + 2] - mu) * inv * g.z + b.z;
        y[j + 3] = (h[i][j + 3] - mu) * inv * g.w + b.w;
      }
      *reinterpret_cast<uint4*>(orow + c0) = Chunk<T>::store(y);
    }
  }
}

template <typename T, int CH>
cudaError_t launch_warp(const void* x, const float* bias, const void* res,
                        const float* gamma, const float* beta, void* out,
                        long long n, int d, uint32_t seed,
                        unsigned long long keep_from, float one_minus_p,
                        float dropped, float eps, int dropout,
                        cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + WARP_ROWS - 1) / WARP_ROWS);
  auto args = [&](auto kernel) {
    kernel<<<blocks, 32 * WARP_ROWS, 0, stream>>>(
        static_cast<const T*>(x), bias, static_cast<const T*>(res), gamma,
        beta, static_cast<T*>(out), n, d, seed, keep_from, one_minus_p,
        dropped, eps);
  };
  if (dropout)
    args(fused_residual_ln_warp_kernel<T, CH, true>);
  else
    args(fused_residual_ln_warp_kernel<T, CH, false>);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_warp(const void* x, const float* bias, const void* res,
                          const float* gamma, const float* beta, void* out,
                          long long n, int d, uint32_t seed,
                          unsigned long long keep_from, float one_minus_p,
                          float dropped, float eps, int dropout,
                          cudaStream_t stream) {
  constexpr int V = Chunk<T>::V;
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(res) |
                        reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(bias) |
                        reinterpret_cast<uintptr_t>(gamma) |
                        reinterpret_cast<uintptr_t>(beta);
  if (d % V != 0 || any % 16 != 0) return cudaErrorInvalidValue;
  const int ch = (d / V + 31) / 32;
#define PT_LN_WARP(C)                                                        \
  if (ch <= C) {                                                             \
    if constexpr (C * V <= WARP_MAX_ELEMS)                                   \
      return launch_warp<T, C>(x, bias, res, gamma, beta, out, n, d, seed,   \
                               keep_from, one_minus_p, dropped, eps,        \
                               dropout, stream);                            \
    return cudaErrorInvalidValue;                                            \
  }
  PT_LN_WARP(1)
  PT_LN_WARP(2)
  PT_LN_WARP(4)
  PT_LN_WARP(8)
  PT_LN_WARP(16)
#undef PT_LN_WARP
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- block route
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

// dtype: 0 = f32, 1 = bf16, 2 = f16 (x, residual and out). route: 0 the
// block kernel (keeps hash / 2^32 >= p), 1 the warp kernel (keeps hash >=
// keep_from, multiplies a dropped element by `dropped`; needs D a multiple
// of 16 bytes, at most 2048 elements, and 16-byte aligned operands). Returns the CUDA error of the launch (0 on
// success; 1 for a shape the route cannot take).
int fused_residual_ln(const void* x, const void* bias, const void* res, const void* gamma,
                      const void* beta, void* out, long long n, int d, unsigned int seed,
                      float p, unsigned long long keep_from, float one_minus_p,
                      float dropped, float eps, int dropout, int dtype, int route,
                      void* stream) {
  if (n < 1 || n > 0x7fffffffLL || d < 1 || d > NT * MAX_VPT) return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const float*>(bias);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    switch (dtype) {
      case 0:
        return (int)dispatch_warp<float>(x, b, res, g, be, out, n, d, seed, keep_from,
                                         one_minus_p, dropped, eps, dropout, s);
      case 1:
        return (int)dispatch_warp<__nv_bfloat16>(x, b, res, g, be, out, n, d, seed,
                                                 keep_from, one_minus_p, dropped, eps, dropout, s);
      case 2:
        return (int)dispatch_warp<__half>(x, b, res, g, be, out, n, d, seed, keep_from,
                                          one_minus_p, dropped, eps, dropout, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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
