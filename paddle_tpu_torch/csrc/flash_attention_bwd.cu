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
// The TPU's two kernels stay two kernels, so neither needs atomics and the
// result is deterministic: the dq kernel has one block per (q tile, head,
// batch) and loops over k tiles up to the causal limit; the dk/dv kernel
// has one block per (k tile, head, batch) and loops over the q tiles from
// the first one that can see its keys. p is recomputed per tile from the
// one-per-row LSE, so no [Sq, Skv] tensor reaches device memory. Masked
// positions (above the diagonal, past Sq or past Skv) are an exact 0.
//
// Two routes, chosen by dtype (a dispatch, not a fallback):
//
// bf16 — "wgmma": every product on the tensor cores (wgmma, f32
//   accumulators in registers), every tile in by TMA. A block is two
//   consumer warpgroups (64 rows each) and one producer warpgroup. The
//   block keeps its own 128 rows' operands (q and dO, or k and v) in shared
//   memory and the producer streams the other pair, shared by both
//   consumers, through a 2-stage ring of 64-row tiles, each
//   [64 rows][64 columns] box 128-byte swizzled by TMA to match the wgmma
//   descriptors (D = 128 is two boxes side by side; D = 16 and 32 are one
//   box zero-filled past D). The tensor maps are 3-D (D, S, B*H), so a
//   ragged last tile zero-fills at its own head's end. Per k tile the dq
//   kernel runs S = q k^T and dP = dO v^T (both operands from shared
//   memory), forms p and ds in registers, rounds ds to bf16 and runs
//   dq += ds k with ds as the register A operand: the f32 accumulator
//   fragment of one wgmma, packed to bf16x2, is the A fragment of the next,
//   and k (MN-major there) is read through the transpose bit. The dk/dv
//   kernel runs S^T = k q^T and dP^T = v dO^T, reads lse and di per column
//   from the stage (the producer warp stages them), and accumulates
//   dv += bf16(p^T) dO and dk += bf16(ds^T) q the same way. No p or ds
//   tile touches shared memory. setmaxnreg gives the consumers 232
//   registers (dk and dv take 128 a thread at D = 128) and the producer
//   32, out of the 168 a thread the block launches with. Only tiles that
//   cross the diagonal or a ragged edge are masked; a warpgroup skips a
//   tile wholly above its part of the diagonal.
//   Blocks are ordered so that the longest causal loops launch first.
//   Numerics: p and ds are rounded to bf16 before the three products that
//   consume them (the plain versions keep them f32).
// f32 — "cuda-core f32": the first version's kernels, f32 math on the CUDA
//   cores (a tensor-core f32 product would be TF32, three decimal digits).
//   256 threads, each owning 4 rows x 4 columns of the score tile and 4
//   rows x D/16 columns of each accumulator; p and ds stay f32 in shared
//   memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"   // mbarriers, TMA, wgmma, tensor maps, prepare

namespace cuda_core {

constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads: 16 row groups x 16 column groups

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

}  // namespace cuda_core

namespace wgmma_route {

using namespace sm90;

template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + (2 * WGS + 2 * STAGES) * n_boxes<D>() * BOX_BYTES +
         (1 + 2 * STAGES) * sizeof(uint64_t);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + (2 * WGS + 2 * STAGES) * n_boxes<D>() * BOX_BYTES +
         STAGES * 2 * TILE * sizeof(float) +
         (1 + 2 * STAGES) * sizeof(uint64_t);
}

// grid (B*H, 128-row q blocks); the last q blocks (the longest causal
// loops) launch first. Consumer warpgroup w owns q rows q0 + 64w.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mdo,
              const float* __restrict__ lse, const float* __restrict__ di,
              __nv_bfloat16* __restrict__ dq, int Sq, int Skv, float scale,
              int causal) {
  constexpr int NCH = n_boxes<D>();
  constexpr int STAGE_BYTES = 2 * NCH * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);         // [WGS][NCH] boxes
  uint8_t* dos = qs + WGS * NCH * BOX_BYTES;  // [WGS][NCH] boxes
  uint8_t* ring = dos + WGS * NCH * BOX_BYTES;  // stage: k boxes, v boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_ROWS;
  const int offset = Skv - Sq;
  const int k_end =
      causal ? min(Skv, min(q0 + BLOCK_ROWS, Sq) + offset) : Skv;
  const int n_tiles = (k_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: q and dO once, then k and v tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, 2 * WGS * NCH * BOX_BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < NCH; ++c) {
          const int box = (w * NCH + c) * BOX_BYTES;
          tma_load(qs + box, &mq, qbar, 64 * c, q0 + TILE * w, bh);
          tma_load(dos + box, &mdo, qbar, 64 * c, q0 + TILE * w, bh);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, n = t / STAGES;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        uint8_t* ks = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(ks + c * BOX_BYTES, &mk, &full[s], 64 * c, t * TILE, bh);
          tma_load(ks + (NCH + c) * BOX_BYTES, &mv, &full[s], 64 * c,
                   t * TILE, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int qw = q0 + TILE * wg;          // this warpgroup's first row
    const int ra = 16 * warp + lane / 4;    // this thread's rows: ra, ra + 8
    const int cl = 2 * (lane % 4);          // its first column in each n8
    // the warpgroup's last live row sees keys up to k_last
    const int k_last = min(qw + TILE, Sq) - 1 + offset;
    const float scale2 = scale * LOG2E;
    float lse2[2], dir[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qw + ra + 8 * h;
      const long long at = static_cast<long long>(bh) * Sq + row;
      lse2[h] = row < Sq ? lse[at] * LOG2E : 0.f;
      dir[h] = row < Sq ? di[at] : 0.f;
    }
    float acc[32 * NCH];
#pragma unroll
    for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(qs + wg * NCH * BOX_BYTES);
    const uint32_t do_addr = smem_u32(dos + wg * NCH * BOX_BYTES);
    mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, n = t / STAGES;
      const int k0 = t * TILE;
      mbar_wait(&full[s], n & 1);
      // a tile wholly above this warpgroup's diagonal (or rows past Sq)
      // adds nothing: release it untouched
      if (qw >= Sq || (causal && k0 > k_last)) {
        mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_addr = smem_u32(ring + s * STAGE_BYTES);
      const uint32_t v_addr = k_addr + NCH * BOX_BYTES;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      scores<D>(sc, q_addr, k_addr);
      scores<D>(dp, do_addr, v_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge =
          (causal && k0 + TILE - 1 > qw + offset) || k0 + TILE > Skv;
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2_approx(sc[i + e] * scale2 - lse2[h]);
          if (edge) {
            const int col = k0 + 8 * (i / 4) + cl + e;
            const int row = qw + ra + 8 * h;
            if (col >= Skv || (causal && row + offset < col)) p = 0.f;
          }
          v[e] = p * (dp[i + e] - dir[h]) * scale;
        }
        ds[i / 2] = pack_bf16(v[0], v[1]);
      }
      wgmma_fence();
      accumulate<NCH>(acc, ds, k_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* out = dq + static_cast<long long>(bh) * Sq * D;
#pragma unroll
    for (int i = 0; i < 32 * NCH; i += 2) {
      const int row = qw + ra + 8 * ((i >> 1) & 1);
      const int col = 8 * (i / 4) + cl;
      if (row < Sq && col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * D +
                                           col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// grid (B*H, 128-key blocks); the first key blocks (the longest causal
// loops) launch first. Consumer warpgroup w owns keys k0 + 64w.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ lse, const float* __restrict__ di,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int Sq, int Skv, float scale, int causal) {
  constexpr int NCH = n_boxes<D>();
  constexpr int STAGE_BYTES = 2 * NCH * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1024(smem_raw);         // [WGS][NCH] boxes
  uint8_t* vs = ks + WGS * NCH * BOX_BYTES;   // [WGS][NCH] boxes
  uint8_t* ring = vs + WGS * NCH * BOX_BYTES;   // stage: q boxes, dO boxes
  float* stats = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + STAGES * 2 * TILE);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BLOCK_ROWS;
  const int offset = Skv - Sq;
  // the first query row that sees key k0 is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / TILE * TILE : 0;
  const int n_tiles = (Sq - q_begin + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer's first warp
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: k and v once, then q, dO, lse and di through the ring;
    // lane 0 of its first warp issues the TMA loads, each lane of that
    // warp stages two lse and di values
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x - CONSUMERS;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * WGS * NCH * BOX_BYTES);
        for (int w = 0; w < WGS; ++w)
          for (int c = 0; c < NCH; ++c) {
            const int box = (w * NCH + c) * BOX_BYTES;
            tma_load(ks + box, &mk, kvbar, 64 * c, k0 + TILE * w, bh);
            tma_load(vs + box, &mv, kvbar, 64 * c, k0 + TILE * w, bh);
          }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, n = t / STAGES;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        const int q0 = q_begin + t * TILE;
        float* st = stats + s * 2 * TILE;
        for (int r = lane; r < TILE; r += 32) {
          const int row = q0 + r;
          const long long at = static_cast<long long>(bh) * Sq + row;
          st[r] = row < Sq ? lse[at] * LOG2E : 0.f;
          st[TILE + r] = row < Sq ? di[at] : 0.f;
        }
        if (lane == 0) {
          uint8_t* qt = ring + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          for (int c = 0; c < NCH; ++c) {
            tma_load(qt + c * BOX_BYTES, &mq, &full[s], 64 * c, q0, bh);
            tma_load(qt + (NCH + c) * BOX_BYTES, &mdo, &full[s], 64 * c, q0,
                     bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int kw = k0 + TILE * wg;          // this warpgroup's first key
    const int ra = 16 * warp + lane / 4;    // this thread's keys: ra, ra + 8
    const int cl = 2 * (lane % 4);          // its first query column in an n8
    const float scale2 = scale * LOG2E;
    float dk_acc[32 * NCH], dv_acc[32 * NCH];
#pragma unroll
    for (int i = 0; i < 32 * NCH; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_addr = smem_u32(ks + wg * NCH * BOX_BYTES);
    const uint32_t v_addr = smem_u32(vs + wg * NCH * BOX_BYTES);
    mbar_wait(kvbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, n = t / STAGES;
      const int q0 = q_begin + t * TILE;
      mbar_wait(&full[s], n & 1);
      // a q tile whose rows see none of this warpgroup's keys (or keys
      // past Skv) adds nothing: release it untouched
      if (kw >= Skv || (causal && q0 + TILE - 1 + offset < kw)) {
        mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t q_addr = smem_u32(ring + s * STAGE_BYTES);
      const uint32_t do_addr = q_addr + NCH * BOX_BYTES;
      const float* st = stats + s * 2 * TILE;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      scores<D>(sc, k_addr, q_addr);
      scores<D>(dp, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = (causal && q0 + offset < kw + TILE - 1) ||
                        q0 + TILE > Sq || kw + TILE > Skv;
      // n8 block j holds query columns c, c + 1 of keys ra and ra + 8;
      // their lse and di are read per block (the compiler barrier keeps
      // the reads from being hoisted into 32 live registers at once).
      // Blocks 2kk and 2kk + 1 are the query rows of k step kk: once they
      // are packed, that step of dv += p^T dO and dk += ds^T q is issued,
      // so the f32 scores die as they are consumed and the rest of the
      // tile's elementwise work overlaps the products
      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + cl;
        const float2 lse2 = *reinterpret_cast<const float2*>(st + c);
        const float2 di2 = *reinterpret_cast<const float2*>(st + TILE + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const int key = kw + ra + 8 * h;
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p =
                exp2_approx(sc[i + e] * scale2 - (e ? lse2.y : lse2.x));
            if (edge) {
              const int row = q0 + c + e;
              if (row >= Sq || key >= Skv || (causal && row + offset < key))
                p = 0.f;
            }
            pv[e] = p;
            dsv[e] = p * (dp[i + e] - (e ? di2.y : di2.x)) * scale;
          }
          pf[i / 2] = pack_bf16(pv[0], pv[1]);
          dsf[i / 2] = pack_bf16(dsv[0], dsv[1]);
        }
        asm volatile("" ::: "memory");
        if (j % 2 == 1) {
          const int kk = j / 2;
          wgmma_fence();
          accumulate_step<NCH>(dv_acc, pf + 4 * kk, do_addr + kk * 2048);
          accumulate_step<NCH>(dk_acc, dsf + 4 * kk, q_addr + kk * 2048);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
    }

    const long long head = static_cast<long long>(bh) * Skv * D;
#pragma unroll
    for (int i = 0; i < 32 * NCH; i += 2) {
      const int key = kw + ra + 8 * ((i >> 1) & 1);
      const int col = 8 * (i / 4) + cl;
      if (key < Skv && col < D) {
        const long long at = head + static_cast<long long>(key) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dout, int BH, int Sq, int Skv, int D) {
  cudaError_t err;
  if ((err = make_map(&m->q, q, D, Sq, BH)) != cudaSuccess) return err;
  if ((err = make_map(&m->k, k, D, Skv, BH)) != cudaSuccess) return err;
  if ((err = make_map(&m->v, v, D, Skv, BH)) != cudaSuccess) return err;
  return make_map(&m->dout, dout, D, Sq, BH);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Sq, int Skv, float scale,
                      int causal, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, B * H, Sq, Skv, D);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dq_smem_bytes<D>();
  if ((err = prepare(bwd_dq_kernel<D>, smem)) != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS);
  bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, di, static_cast<__nv_bfloat16*>(dq), Sq,
      Skv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       float scale, int causal, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, B * H, Sq, Skv, D);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dkv_smem_bytes<D>();
  if ((err = prepare(bwd_dkv_kernel<D>, smem)) != cudaSuccess) return err;
  dim3 grid(B * H, (Skv + BLOCK_ROWS - 1) / BLOCK_ROWS);
  bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* di,
                        void* dq, int B, int H, int Sq, int Skv, int D,
                        float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 32: return launch_dq<32>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, di, dq, B, H, Sq, Skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* di,
                         void* dk, void* dv, int B, int H, int Sq, int Skv,
                         int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, H, Sq, Skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgmma_route

// q, dout, dq: [B, H, Sq, D]; k, v: [B, H, Skv, D], contiguous, one dtype
// (is_bf16 = 1 for bf16: the wgmma route; 0 for f32: the CUDA-core route);
// lse, di: [B, H, Sq] f32. Returns the cudaError_t of the launch (0 on
// success; 500 when the driver has no cuTensorMapEncodeTiled, 716 when a
// bf16 pointer is not 16-byte aligned, 9 when the kernel was built with too
// few registers for setmaxnreg).
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
    return (int)wgmma_route::dispatch_dq(q, k, v, dout, l, d, dq, B, H, Sq, Skv, D, scale, causal, s);
  return (int)cuda_core::dispatch_dq<float>(q, k, v, dout, l, d, dq, B, H, Sq, Skv, D, scale, causal, s);
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
    return (int)wgmma_route::dispatch_dkv(q, k, v, dout, l, d, dk, dv, B, H, Sq, Skv, D, scale, causal, s);
  return (int)cuda_core::dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, B, H, Sq, Skv, D, scale, causal, s);
}
