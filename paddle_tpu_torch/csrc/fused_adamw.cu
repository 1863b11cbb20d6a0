// Fused AdamW for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_adamw.py:_adamw_kernel
// (launched by _fused_update_flat): one pass over a flat leaf of n elements
// reads p, g, m and v and writes p, m and v, with the math of the reference
// in f32:
//     g  = g * grad_scale
//     m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g g
//     p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)
// p is bf16 or f32 (stored back in its own dtype), g is in p's dtype, m and
// v are f32. The seven scalars [lr, b1, b2, eps, 1 - b1^t, 1 - b2^t,
// grad_scale] are read from a [7] f32 device array, as the TPU kernel read
// them from SMEM: the host never waits on the step count, and a CUDA graph
// can capture the launch. p, m and v are updated in place.
//
// What bounds it on the H100: bytes. Each element moves 2 + 2 + 4 + 4 read
// and 2 + 4 + 4 written = 22 bytes for a bf16 p (38 for f32) against about
// 12 floating-point operations, far below the card's ~295 operations per
// byte. What the design does about the bound: every byte is read and
// written once; a grid-stride loop over 8 elements a thread issues 16-byte
// loads and stores (one for 8 bf16 values, two for 8 f32 values) where
// every pointer is 16-byte aligned, with a scalar loop for the ragged tail
// (or the whole leaf when a pointer is not aligned).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int VEC = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void load8(const float* ptr, float* out) {
  const float4 a = reinterpret_cast<const float4*>(ptr)[0];
  const float4 b = reinterpret_cast<const float4*>(ptr)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* ptr, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* ptr, const float* in) {
  reinterpret_cast<float4*>(ptr)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(ptr)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* ptr, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
  *reinterpret_cast<uint4*>(ptr) = raw;
}

struct Scalars {
  float lr, b1, b2, eps, bc1, bc2, gs, ob1, ob2, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Scalars& s) {
  g = g * s.gs;
  const float m2 = s.b1 * m + s.ob1 * g;
  const float v2 = s.b2 * v + s.ob2 * g * g;
  const float upd = (m2 / s.bc1) / (sqrtf(v2 / s.bc2) + s.eps);
  p = p - s.lr * (upd + s.wd * p);
  m = m2;
  v = v2;
}

template <typename T>
__global__ void __launch_bounds__(NT)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ scalars,
             float wd, long long n, int vec) {
  Scalars s;
  s.lr = scalars[0];
  s.b1 = scalars[1];
  s.b2 = scalars[2];
  s.eps = scalars[3];
  s.bc1 = scalars[4];
  s.bc2 = scalars[5];
  s.gs = scalars[6];
  s.ob1 = 1.f - s.b1;
  s.ob2 = 1.f - s.b2;
  s.wd = wd;
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  const long long nvec = vec ? n / VEC : 0;
  for (long long i = first; i < nvec; i += stride) {
    const long long o = i * VEC;
    float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
    load8(p + o, pf);
    load8(g + o, gf);
    load8(m + o, mf);
    load8(v + o, vf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) adamw(pf[e], gf[e], mf[e], vf[e], s);
    store8(p + o, pf);
    store8(m + o, mf);
    store8(v + o, vf);
  }
  for (long long i = nvec * VEC + first; i < n; i += stride) {
    float pf = to_f32(p[i]), mf = m[i], vf = v[i];
    adamw(pf, to_f32(g[i]), mf, vf, s);
    store(p + i, pf);
    m[i] = mf;
    v[i] = vf;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v,
                   const void* scalars, float wd, long long n,
                   cudaStream_t stream) {
  const int vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const long long work = vec ? (n / VEC + n % VEC) : n;
  // enough blocks to fill every SM several times; the loop strides the rest
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  adamw_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<const float*>(scalars), wd, n, vec);
  return cudaGetLastError();
}

}  // namespace

// p, g: [n] bf16 (is_bf16 = 1) or f32; m, v: [n] f32; scalars: [7] f32 on
// the device. Updates p, m and v in place on `stream`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_adamw(void* p, const void* g, void* m, void* v,
                           const void* scalars, float wd, long long n,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(p, g, m, v, scalars, wd, n, s);
  return (int)launch<float>(p, g, m, v, scalars, wd, n, s);
}
