// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (launched by _flash_bwd). Given q, o,
// dO [B, H, Sq, D], k, v [B, H, Skv, D], the forward's per-row log-sum-exp
// lse [B, H, Sq] (f32, one value per row) and di = rowsum(dO * O) [B, H, Sq]
// (f32, computed by the wrapper), each tile recomputes
//     p  = exp(q k^T * scale - lse)        dp = dO v^T
//     ds = p * (dp - di) * scale
// and accumulates dq = ds k (dq kernel), dk = ds^T q and dv = p^T dO (dk/dv
// kernel). The causal mask is aligned bottom-right (query row i sees key j
// iff i + (Skv - Sq) >= j). Outputs are in the input dtype; all sums are f32.
//
// What bounds it on the H100: 2*D multiply-adds per (query, key) pair for
// each of s, dp and dq in one kernel and s, dp, dv and dk in the other (14*D
// operations per pair against the 10*D of a single fused pass), against
// 8 [*, D] tensors of bytes: at training lengths it is bound by operations.
// This first version does them on the CUDA cores in f32 (no wgmma, no TMA):
// it is right and simple, and far from the 989 TFLOP/s bf16 tensor-core
// peak. What the design does about the bound:
//   - the TPU's two kernels stay two kernels, so neither needs atomics: the
//     dq kernel has one block per (q tile, head, batch) and loops over k
//     tiles up to the causal limit; the dk/dv kernel has one block per
//     (k tile, head, batch) and loops over the q tiles from the first one
//     that can see its keys. The loop inside the block replaces the TPU's
//     sequential grid axis; blocks run in any order;
//   - p is recomputed per tile from the one-per-row LSE, so no [Sq, Skv]
//     tensor reaches device memory; p and ds stay f32 in shared memory;
//   - 256 threads, each owning 4 rows x 4 columns of the score tile and
//     4 rows x D/16 columns of each accumulator: the dk/dv kernel's two
//     [64, D] f32 accumulators take 64 registers a thread at D = 128, which
//     128 threads could not hold without spilling;
//   - masked positions (above the diagonal, past Sq or past Skv) are
//     predicated to an exact 0; any Sq and Skv, ragged tiles zero-filled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads: 16 row groups x 16 column groups

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [r0, r0 + rows) of a [S, D] matrix into a [rows][D + 1] f32 tile,
// zero past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        (r0 + r < S) ? to_f32(src[(long long)(r0 + r) * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// Thread t owns rows ty + 16*i (i < 4) and score columns tx + 16*j (j < 4),
// output columns tx + 16*c (c < D/16), with ty = t / 16, tx = t % 16.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int H, int Sq, int Skv, float scale,
                    int causal) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][DP]
  float* dos = qs + BQ * DP;      // [BQ][DP]
  float* ks = dos + BQ * DP;      // [BK][DP]
  float* vs = ks + BK * DP;       // [BK][DP]
  float* dss = vs + BK * DP;      // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const T* qg = q + bh * Sq * D;
  const T* dog = dout + bh * Sq * D;
  const T* kg = k + bh * Skv * D;
  const T* vg = v + bh * Skv * D;
  const int offset = Skv - Sq;

  load_tile<T, D>(qs, qg, q0, Sq, BQ);
  load_tile<T, D>(dos, dog, q0, Sq, BQ);
  float lse_r[4], di_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    di_r[i] = row < Sq ? di[bh * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the causal limit of the tile's last real row are never read
  int k_end = Skv;
  if (causal) k_end = min(Skv, min(q0 + BQ, Sq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q, dO are stored)
    load_tile<T, D>(ks, kg, k0, Skv, BK);
    load_tile<T, D>(vs, vg, k0, Skv, BK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * DP + d];
        dov[i] = dos[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * DP + d];
        vv[j] = vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = row < Sq && col < Skv &&
                          (!causal || row + offset >= col);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            p * (dp[i][j] - di_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dqg = dq + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dqg + (long long)row * D + tx + 16 * c, acc[i][c]);
  }
}

// Thread t owns key rows ty + 16*i (i < 4) of the block's k tile, query
// columns tx + 16*j (j < 4) of the transposed score tile, and output
// columns tx + 16*c (c < D/16) of dk and dv.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Skv, float scale,
                     int causal) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [BK][DP]
  float* vs = ks + BK * DP;       // [BK][DP]
  float* qs = vs + BK * DP;       // [BQ][DP]
  float* dos = qs + BQ * DP;      // [BQ][DP]
  float* pt = dos + BQ * DP;      // [BK][BQ + 1]  p transposed
  float* dst = pt + BK * (BQ + 1);  // [BK][BQ + 1]  ds transposed
  float* lse_s = dst + BK * (BQ + 1);  // [BQ]
  float* di_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const T* qg = q + bh * Sq * D;
  const T* dog = dout + bh * Sq * D;
  const T* kg = k + bh * Skv * D;
  const T* vg = v + bh * Skv * D;
  const float* lseg = lse + bh * Sq;
  const float* dig = di + bh * Sq;
  const int offset = Skv - Sq;

  load_tile<T, D>(ks, kg, k0, Skv, BK);
  load_tile<T, D>(vs, vg, k0, Skv, BK);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first query row that sees key k0 is k0 - offset: earlier q tiles
  // lie wholly above the diagonal and are never read
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / BQ * BQ;

  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed (and k, v are stored)
    load_tile<T, D>(qs, qg, q0, Sq, BQ);
    load_tile<T, D>(dos, dog, q0, Sq, BQ);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lseg[q0 + tid] : 0.f;
      di_s[tid] = in ? dig[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * DP + d];
        vv[i] = vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * DP + d];
        dov[j] = dos[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        const bool live = key < Skv && row < Sq &&
                          (!causal || row + offset >= key);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        pt[(ty + 16 * i) * (BQ + 1) + r] = p;
        dst[(ty + 16 * i) * (BQ + 1) + r] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty + 16 * i) * (BQ + 1) + qq];
        dsv[i] = dst[(ty + 16 * i) * (BQ + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float dov = dos[qq * DP + tx + 16 * c];
        const float qv = qs[qq * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

  T* dkg = dk + bh * Skv * D;
  T* dvg = dv + bh * Skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dkg + (long long)key * D + tx + 16 * c, dk_acc[i][c]);
      store(dvg + (long long)key * D + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Sq, int Skv, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, Sq, Skv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Skv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* di,
                        void* dq, int B, int H, int Sq, int Skv, int D,
                        float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* di,
                         void* dk, void* dv, int B, int H, int Sq, int Skv,
                         int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq: [B, H, Sq, D]; k, v: [B, H, Skv, D], contiguous, one dtype
// (is_bf16 = 1 for bf16, 0 for f32); lse, di: [B, H, Sq] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int Sq, int Skv,
                                      int D, int is_bf16, float scale,
                                      int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (is_bf16)
    return (int)dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, B, H, Sq, Skv, D, scale, causal, s);
  return (int)dispatch_dq<float>(q, k, v, dout, l, d, dq, B, H, Sq, Skv, D, scale, causal, s);
}

// As above; dk, dv: [B, H, Skv, D] in the input dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Skv, int D, int is_bf16,
                                       float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (is_bf16)
    return (int)dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, B, H, Sq, Skv, D, scale, causal, s);
  return (int)dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, B, H, Sq, Skv, D, scale, causal, s);
}
