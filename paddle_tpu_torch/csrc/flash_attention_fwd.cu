// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd): blocked online-softmax attention over
// q [B, H, Sq, D] and k/v [B, H, Skv, D], causal mask aligned bottom-right
// (query row i sees key j iff i + (Skv - Sq) >= j), output in q's dtype and,
// on request, the per-row log-sum-exp [B, H, Sq] in f32 (one value per row:
// the TPU kernel's 128-lane replication was a Mosaic layout, not semantics),
// in natural-log units of q k^T * scale, as the backward kernels read it.
//
// What bounds it on the H100: at prompt lengths the work is 2*B*H*Sq*Skv*D
// multiply-adds for a causal mask (half of the dense 4*B*H*Sq*Skv*D), so the
// kernel is bound by operations, not by the bytes of q, k, v and o. Scores
// and probabilities never reach device memory; the k loop runs inside the
// block (the TPU's sequential grid axis) and stops at the causal limit.
//
// Two routes, chosen by dtype (a dispatch, not a fallback):
//
// bf16 and f16 — "wgmma": both products on the tensor cores, every tile in
//   by TMA (one template on the 16-bit element E: the instruction's type
//   is f32.bf16.bf16 or f32.f16.f16, the same K of 16, swizzle and
//   fragments; p and o round to E)
//   (FA3's layout, the backward's building blocks in hopper_sm90.cuh). A
//   block is two consumer warpgroups of 64 query rows each and one producer
//   warpgroup; setmaxnreg gives the consumers 232 registers and the
//   producer 32. The producer loads the block's q once and streams k and v
//   through a 3-stage ring of 64-key tiles, each [64][64] box 128-byte
//   swizzled by TMA (D = 128 is two boxes; D = 16 and 32 one box
//   zero-filled past D). The 3-D maps (D, S, B*H) zero-fill a ragged tile
//   at its own head's end, so any Sq and Skv need no padding. Per tile a
//   warpgroup runs S = q k^T (SS wgmma m64n64), then the online softmax on
//   the accumulator fragment: a thread holds 2 rows, a row's max reduces
//   over the 4 lanes of a quad with two shuffles, m and l stay in registers
//   (base-2 units: the scale and log2(e) fold into one multiply), o is
//   rescaled once a tile; then o += p v with p packed to E x 2 as the
//   register A operand and v read MN-major through the transpose bit (p
//   never touches shared memory). A tile wholly above a warpgroup's part
//   of the diagonal is skipped; only diagonal and ragged tiles are masked.
//   The last q blocks (the longest causal loops) launch first. Numerics: p
//   is rounded to E before p v, against the running max; l sums the
//   f32 p.
// f32 — "cuda-core f32": the first version's kernel, f32 math on the CUDA
//   cores (a tensor-core f32 product would be TF32, three decimal digits):
//   one block of 128 threads per (q tile of 64 rows, head, batch); q, k and
//   v tiles in shared memory, each thread a 4 x 8 score micro-tile and a
//   4 x D/8 accumulator micro-tile over the SAME 4 rows, so the rescale is
//   local and a row's max and sum reduce over 8 neighbouring lanes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"   // mbarriers, TMA, wgmma, tensor maps, prepare

namespace cuda_core {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per k tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 col groups
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

}  // namespace cuda_core

namespace wgmma_route {

using namespace sm90;

constexpr float LN2 = 0.6931471805599453f;
constexpr int KV_STAGES = 3;   // k/v ring depth

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 1024 + (WGS + 2 * KV_STAGES) * n_boxes<D>() * BOX_BYTES +
         (1 + 2 * KV_STAGES) * sizeof(uint64_t);
}

// grid (B*H, 128-row q blocks); the last q blocks (the longest causal
// loops) launch first. Consumer warpgroup w owns q rows q0 + 64w.
template <int D, typename E>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           E* __restrict__ o, float* __restrict__ lse, int Sq,
           int Skv, float scale, int causal) {
  constexpr int NCH = n_boxes<D>();
  constexpr int STAGE_BYTES = 2 * NCH * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);           // [WGS][NCH] boxes
  uint8_t* ring = qs + WGS * NCH * BOX_BYTES;   // stage: k boxes, v boxes
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + KV_STAGES * STAGE_BYTES);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + KV_STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_ROWS;
  const int offset = Skv - Sq;
  const int k_end =
      causal ? min(Skv, min(q0 + BLOCK_ROWS, Sq) + offset) : Skv;
  const int n_tiles = (k_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: q once, then k and v tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, WGS * NCH * BOX_BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load(qs + (w * NCH + c) * BOX_BYTES, &mq, qbar, 64 * c,
                   q0 + TILE * w, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % KV_STAGES, n = t / KV_STAGES;
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
    const float scale2 = scale * LOG2E;     // scores in base-2 units
    // running max (base 2) and this thread's part of the row sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[32 * NCH];
#pragma unroll
    for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(qs + wg * NCH * BOX_BYTES);
    mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % KV_STAGES, n = t / KV_STAGES;
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
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
      scores<D, E>(sc, q_addr, k_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale into base 2, mask the diagonal and ragged tiles, row max
      const bool edge =
          (causal && k0 + TILE - 1 > qw + offset) || k0 + TILE > Skv;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float x = sc[i] * scale2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + cl + (i & 1);
          const int row = qw + ra + 8 * h;
          if (col >= Skv || (causal && row + offset < col)) x = -INFINITY;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float base[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // a row with no live key yet keeps p = 0 and alpha = 0 (its o and
        // l are 0) instead of exp2(-inf + inf) = NaN
        base[h] = mx[h] == -INFINITY ? 0.f : mx[h];
        alpha[h] = exp2_approx(m[h] - base[h]);
        m[h] = mx[h];
      }
      uint32_t pf[16];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = exp2_approx(sc[i] - base[h]);
        const float p1 = exp2_approx(sc[i + 1] - base[h]);
        rs[h] += p0 + p1;
        pf[i / 2] = pack2<E>(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int i = 0; i < 32 * NCH; ++i) acc[i] *= alpha[(i >> 1) & 1];
      wgmma_fence();
      accumulate<NCH, E>(acc, pf, v_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    // the quad's four parts of each row sum
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const long long head = static_cast<long long>(bh) * Sq;
    E* out = o + head * D;
#pragma unroll
    for (int i = 0; i < 32 * NCH; i += 2) {
      const int h = (i >> 1) & 1;
      const int row = qw + ra + 8 * h;
      const int col = 8 * (i / 4) + cl;
      const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
      if (row < Sq && col < D)
        store2<E>(out + static_cast<long long>(row) * D + col, acc[i] * inv,
                  acc[i + 1] * inv);
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = qw + ra + 8 * h;
        if (row < Sq)
          lse[head + row] =
              l[h] == 0.f ? cuda_core::NEG_INF : m[h] * LN2 + logf(l[h]);
      }
    }
  }
}

template <int D, typename E>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Sq, int Skv, float scale,
                       int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  constexpr CUtensorMapDataType ty = map_type<E>();
  if ((err = make_map(&mq, q, D, Sq, B * H, ty)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, D, Skv, B * H, ty)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, D, Skv, B * H, ty)) != cudaSuccess) return err;
  constexpr size_t smem = fwd_smem_bytes<D>();
  if ((err = prepare(fwd_kernel<D, E>, smem)) != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS);
  fwd_kernel<D, E><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<E*>(o), lse, Sq, Skv, scale, causal);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Sq, int Skv, int D,
                         float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_fwd<16, E>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, s);
    case 32: return launch_fwd<32, E>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, s);
    case 64: return launch_fwd<64, E>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, s);
    case 128: return launch_fwd<128, E>(q, k, v, o, lse, B, H, Sq, Skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgmma_route

// q, o: [B, H, Sq, D]; k, v: [B, H, Skv, D], contiguous, all of one dtype
// (dtype = 1 for bf16 and 2 for f16: the wgmma route; 0 for f32: the
// CUDA-core route); lse: [B, H, Sq] f32 or null. Returns the cudaError_t
// of the launch (0 on success; 500 when libcuda has no
// cuTensorMapEncodeTiled, 716 when a 16-bit pointer is not 16-byte
// aligned, 9 when the kernel was built with too few registers for
// setmaxnreg).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int Sq,
                                   int Skv, int D, int dtype, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return (int)wgmma_route::dispatch_fwd<__nv_bfloat16>(q, k, v, o, l, B, H, Sq, Skv, D, scale, causal, s);
  if (dtype == 2)
    return (int)wgmma_route::dispatch_fwd<__half>(q, k, v, o, l, B, H, Sq, Skv, D, scale, causal, s);
  return (int)cuda_core::dispatch_d<float>(q, k, v, o, l, B, H, Sq, Skv, D, scale, causal, s);
}
