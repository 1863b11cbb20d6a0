// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd): blocked online-softmax attention over
// q [B, H, Sq, D] and k/v [B, H, Skv, D], causal mask aligned bottom-right
// (query row i sees key j iff i + (Skv - Sq) >= j), output in q's dtype and,
// on request, the per-row log-sum-exp [B, H, Sq] in f32 (one value per row:
// the TPU kernel's 128-lane replication was a Mosaic layout, not semantics).
//
// What bounds it on the H100: at prompt lengths the work is 2*B*H*Sq*Skv*D
// multiply-adds for a causal mask (half of the dense 4*B*H*Sq*Skv*D), so the
// kernel is bound by operations, not by the bytes of q, k, v and o. This
// first version does those operations on the CUDA cores in f32 (no wgmma,
// no TMA): it is correct and simple, and far from the 989 TFLOP/s bf16
// tensor-core peak. What the design does about the bound:
//   - one thread block per (q tile of 64 rows, head, batch); the k loop runs
//     inside the block (the TPU's sequential grid axis) and stops at the
//     causal limit, so blocks wholly above the diagonal are never loaded;
//   - q, k and v tiles sit in shared memory as f32 (bf16 is widened once on
//     load), scores and probabilities never reach device memory, and the
//     running max m, normaliser l and accumulator acc stay in registers;
//   - each thread owns a 4 x 8 score micro-tile and a 4 x D/8 accumulator
//     micro-tile over the SAME 4 rows, so the online-softmax rescale is local
//     and a row's max and sum reduce over 8 neighbouring lanes by shuffles;
//   - any Sq and Skv: the ragged last q tile and k tile are masked here, so
//     a 200-token prompt needs no padding (the TPU path needed S % 128 == 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per k tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 col groups
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k padded by one column so that rows fall in different banks
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// Thread t owns rows ty + 16*i (i < 4) of the q tile, with ty = t / 8, and
// columns tx + 8*j of the score tile (j < 8) and of the output (j < D/8),
// with tx = t % 8. The 8 threads of a row group are 8 neighbouring lanes.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv, float scale,
                 int causal) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* ks = qs + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const T* qg = q + bh * Sq * D;
  const T* kg = k + bh * Skv * D;
  const T* vg = v + bh * Skv * D;
  const int offset = Skv - Sq;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    qs[r * DP + c] = (q0 + r < Sq) ? to_f32(qg[(long long)(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the causal limit of the tile's last real row are never read
  int k_end = Skv;
  if (causal) k_end = min(Skv, min(q0 + BQ, Sq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q is stored)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < Skv;
      const long long g = (long long)(k0 + r) * D + c;
      ks[r * DP + c] = in ? to_f32(kg[g]) : 0.f;
      vs[r * D + c] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      unsigned live = 0u;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool ok = col < Skv && (!causal || row + offset >= col);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        live |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // masked keys contribute exactly 0, whatever the running max is
        const float p = ((live >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * i) * (BK + 1) + tx + 8 * j] = p;
      }
      rs = group8_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* og = o + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(og + (long long)row * D + tx + 8 * c, acc[i][c] / l_safe);
    if (lse != nullptr && tx == 0)
      lse[bh * Sq + row] = l[i] == 0.f ? NEG_INF : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Skv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Skv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Sq, int Skv, int D,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, H, Sq, D]; k, v: [B, H, Skv, D], contiguous, all of one dtype
// (is_bf16 = 1 for bf16, 0 for f32); lse: [B, H, Sq] f32 or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int Sq,
                                   int Skv, int D, int is_bf16, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, l, B, H, Sq, Skv, D, scale, causal, s);
  return (int)dispatch_d<float>(q, k, v, o, l, B, H, Sq, Skv, D, scale, causal, s);
}
