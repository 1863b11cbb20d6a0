// Weight-only dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py:_qmm_kernel
// (launched by _pallas_quant_matmul): out[M, N] = (x[M, K] @ codes) * step,
// where codes are int8 [K, N] (bits 8) or int4 packed two per byte along K
// [K/2, N] (bits 4; packed row r holds row 2r in its low nibble and row
// 2r+1 in its high nibble, each sign-extended), step is the f32 [N]
// per-column step and the output is f32. The integer codes are exact in
// bf16 and f32, so each product equals the reference's `w.astype(x.dtype)`
// product; the sum is f32 and the step multiplies it once, after the sum.
// x is bf16 or f32, [M, K] contiguous. Any M, K and N: ragged edges are
// masked in the kernels (the TPU path needed every dimension to tile
// evenly and bm >= 8, so a small decode batch never took its kernel).
//
// What bounds it on the H100:
//   - decode (M = 4..8): bytes. 2*M*K*N operations against K*N code bytes
//     is at most 16 operations a byte, far below the ~295 the tensor cores
//     need, so the least time is the codes over 3.35 TB/s (w_in of
//     gpt3_1p3b: 16.8 MB int8, 8.4 MB int4).
//     At M = 8 on the CUDA cores the math is about level with the bytes
//     (M*K*N = 134 M f32 FMAs at w_in, ~0.004 ms on 132 SMs x 128 lanes,
//     plus a conversion a code); measured, such a kernel's time grew
//     with every row of x, so the decode form does its products on the
//     tensor cores.
//   - prefill (M = B*P, hundreds to thousands): operations, 2*M*K*N at
//     989 TFLOP/s bf16.
// What the design does:
//   - qmm_gemv_kernel (the decode form: bf16 x, M <= 8, N % 16 == 0,
//     K % 8 == 0, 16-byte aligned x and codes): mma.sync m16n8k16 (bf16 in,
//     f32 accumulate) with the 8 rows of x (rows past M zero) as the n = 8
//     side and 16 output columns as the m = 16 side, so the time does not
//     grow with M. A cluster of `split` blocks (at most 4) owns 128 output
//     columns and splits K: rank q sums packed code rows
//     [q * rows_per, (q + 1) * rows_per), rows_per whole stages of 128.
//     The wrapper picks split (gemv_split in ops/kernels/quant_matmul.py):
//     the largest power of two up to 4 that keeps all blocks at once, one
//     an SM (w_in: 64 tiles x 2; w_out: 16 tiles x 4). A block of 16 warps
//     streams its rank's rows through a ring of 4 stages of 128 rows x 128
//     bytes (64 KB) in shared memory, filled by cp.async (3 stages, 48 KB,
//     in flight, no registers held); every thread copies two 16-byte
//     chunks a stage, neighbouring threads on neighbouring chunks of a row,
//     so each row is read as one whole 128-byte segment. The K slice of x
//     is copied once into shared memory as bf16 [8][k] (the B operand, 8
//     bytes a thread a k step, as stored). Warp w takes 32 columns and a
//     quarter of each stage's k steps; for a k step thread (gid, tig) loads
//     one 4-byte word of 4 columns from each of its 4 K rows (int4: 2
//     packed rows), byte-transposes them with prmt into K pairs of one
//     column, and converts each pair to bf16x2 exactly: int8, the low 7
//     bits under a bf16 exponent of 2^7 less 128 or 256 by the sign bit;
//     int4, the nibble xor 8 under 2^7 less 136 (one prmt, one or two
//     logic ops and one bf16x2 subtraction a pair). The mma's k order is
//     permuted alike in both operands (its pairs 2 tig, 2 tig + 8 are K
//     rows 4 tig .. 4 tig + 3), so no x value moves. The ring's 16-byte
//     chunks are stored xor-swizzled by row, so a warp's word loads hit 32
//     banks. The partial sums meet in a fixed order, so a result repeats
//     bitwise: the column's 4 warps (shared memory), then the cluster's
//     ranks in rank order through distributed shared memory; the step
//     multiplies each total once. One launch, no atomics, no workspace.
//   - qmm_skinny_kernel (M up to 8 per block, any x dtype): CUDA-core FMAs,
//     no tensor cores (a 16-row MMA tile would be half empty or worse). A
//     block owns 16 output columns, so even N = 2048 gives 128 blocks to
//     stream the codes; its 256 threads split K (rows t, t + 256, ...),
//     each thread loads 16 codes of a row with one 16-byte load (16 int4
//     pairs for bits 4), U rows at a time before any arithmetic, and keeps
//     an f32 accumulator per (row of x, column). The partial sums meet
//     once at the end (warp shuffles, then shared memory) and the step
//     multiplies the total. f32 x (parity runs) takes this kernel at any
//     M, 8 rows of x per block row, and so do the bf16 decode shapes the
//     gemv kernel cannot map.
//   - qmm_wgmma_kernel (bf16 x, M > 8, and shapes TMA can map: N % 16 == 0,
//     K % 8 == 0, 16-byte aligned x and codes): a 128 x BN output tile per
//     block of two consumer warpgroups (64 rows each, one m64nBN f32
//     accumulator in registers) and one producer warpgroup. BN is 256
//     where that still gives every SM a block (it halves how often each x
//     tile is read from L2), else 128 (w_out's N = 2048 at M = 1024). The
//     producer keeps a ring of 3 (BN 256) or 4 stages full: TMA brings the
//     x tile [128 M][64 K] as two 128-byte-swizzled [64][64] boxes (K-major,
//     operand A) and the raw code tile [64 K][BN] int8 (int4: [32 packed
//     rows][BN]); then its 128 threads convert the codes to bf16 into BN/64
//     MN-major [64 K][64 N] boxes in the same 128-byte swizzle that TMA
//     would have written (the 16-byte chunk j of row k lands at chunk
//     j ^ (k % 8)), which the consumers read as operand B through the
//     transpose bit, LBO = the box stride. The conversion is exact: a
//     code's biased byte (int8: c + 128, int4 nibble: c + 8) becomes the
//     mantissa of 2^23, an f32 subtraction of 2^23 + bias leaves c, and a
//     small integer rounds to bf16 exactly. The consumers only issue wgmma
//     m64nBNk16 (4 a stage), keep one stage in flight, and release a stage
//     once its products are done; the step multiplies each column once
//     after the sum, as in the reference.
//   - qmm_wmma_kernel (bf16 x, M > 8, shapes TMA cannot map, such as N % 16
//     != 0): a 64 x 64 output tile per block of four warps, each warp a
//     32 x 32 quarter of 2 x 2 bf16 16x16x16 nvcuda::wmma fragments with f32
//     accumulators. Per 32-deep K step the block stages the x tile and the
//     code tile converted to bf16 (int4 unpacked by the two shifts) in
//     shared memory, synchronously. The epilogue goes through shared
//     memory, multiplies by step[n] and writes the f32 tile with masks.
// The route is chosen by shape before the launch (quant_matmul_route in
// ops/kernels/quant_matmul.py) and passed in; a route that cannot take the
// shape returns an error, never another route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_sm90.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// int4: low nibble of a packed byte sign-extended, and the high nibble
// (b may be the raw byte 0..255 or its signed value; both give the same)
__device__ __forceinline__ int lo4(int b) { return ((b & 0xf) ^ 8) - 8; }
__device__ __forceinline__ int hi4(int b) { return (int)(signed char)b >> 4; }

constexpr int SK_THREADS = 256;
constexpr int SK_BN = 16;   // output columns a skinny block owns

// Loads the 16 codes (bytes) of packed row r at columns n0 .. n0 + 15 into
// c[0..15]; columns past N read as 0. `vec`: one aligned 16-byte load.
__device__ __forceinline__ void load_row16(const int8_t* __restrict__ w,
                                           long long r, int n0, int N,
                                           bool vec, int c[16]) {
  const int8_t* p = w + r * (long long)N + n0;
  if (vec) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i * 4 + j] = (words[i] >> (8 * j)) & 0xff;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = (n0 + j < N) ? (int)(uint8_t)p[j] : 0;
  }
}

// BITS 8: c holds raw bytes; the signed code is (signed char)c.
template <typename XT, int BITS, int MT>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ step, float* __restrict__ out,
                  int M, int K, int N, int vec) {
  constexpr int U = MT >= 8 ? 2 : 4;          // packed rows in flight
  constexpr int R_PER = BITS == 4 ? 2 : 1;    // K rows per packed row
  const int n0 = blockIdx.x * SK_BN;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int R = K / R_PER;                    // packed rows
  const int tid = threadIdx.x;

  float acc[MT][SK_BN];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < SK_BN; ++j) acc[m][j] = 0.f;

  for (int r0 = tid; r0 < R; r0 += SK_THREADS * U) {
    int c[U][16];
    float xv[U][R_PER][MT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * SK_THREADS;
      if (r < R) {
        load_row16(w, r, n0, N, vec != 0, c[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) c[u][j] = 0;
      }
#pragma unroll
      for (int h = 0; h < R_PER; ++h)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[u][h][m] = (r < R && m < mt)
              ? to_f32(x[(long long)(m0 + m) * K + r * R_PER + h]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < SK_BN; ++j) {
        float code[R_PER];
        if constexpr (BITS == 4) {
          code[0] = (float)lo4(c[u][j]);
          code[1] = (float)hi4(c[u][j]);
        } else {
          code[0] = (float)(signed char)c[u][j];
        }
#pragma unroll
        for (int h = 0; h < R_PER; ++h)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m][j] = fmaf(xv[u][h][m], code[h], acc[m][j]);
      }
    }
  }

  // the block's 256 partial sums of each (row, column) meet once
  __shared__ float red[SK_THREADS / 32][MT * SK_BN];
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < SK_BN; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][m * SK_BN + j] = v;
    }
  __syncthreads();
  if (tid < MT * SK_BN) {
    const int m = tid / SK_BN, j = tid % SK_BN, n = n0 + j;
    if (m < mt && n < N) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < SK_THREADS / 32; ++ww) s += red[ww][tid];
      out[(long long)(m0 + m) * N + n] = s * step[n];
    }
  }
}

// ---------------------------------------------------------------- wmma path
constexpr int WM_BM = 64, WM_BN = 64, WM_BK = 32, WM_THREADS = 128;
constexpr int A_LD = WM_BK + 8;    // bf16 elements; rows stay 16-byte aligned
constexpr int B_LD = WM_BN + 8;
constexpr int C_LD = WM_BN + 4;    // f32

template <int BITS>
__global__ void __launch_bounds__(WM_THREADS)
qmm_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ step,
                float* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  // the x and code tiles during the K loop; the f32 output tile (Cs)
  // reuses the same bytes after it. Offsets stay 32-byte aligned, as
  // wmma loads and stores need.
  constexpr int AB_BYTES = (WM_BM * A_LD + WM_BK * B_LD) * 2;
  constexpr int C_BYTES = WM_BM * C_LD * 4;
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES
                                                                   : C_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + WM_BM * A_LD;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * WM_BM, n0 = blockIdx.x * WM_BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += WM_BK) {
    // x tile [64, 32]: neighbouring threads on neighbouring k
    for (int idx = tid; idx < WM_BM * WM_BK; idx += WM_THREADS) {
      const int r = idx / WM_BK, kk = idx % WM_BK;
      const int m = m0 + r, k = k0 + kk;
      As[r * A_LD + kk] = (m < M && k < K) ? x[(long long)m * K + k] : zero;
    }
    // code tile [32, 64] as bf16: neighbouring threads on neighbouring n
    if constexpr (BITS == 8) {
      for (int idx = tid; idx < WM_BK * WM_BN; idx += WM_THREADS) {
        const int kk = idx / WM_BN, nn = idx % WM_BN;
        const int k = k0 + kk, n = n0 + nn;
        const float v = (k < K && n < N)
            ? (float)w[(long long)k * N + n] : 0.f;
        Bs[kk * B_LD + nn] = __float2bfloat16(v);
      }
    } else {
      // k0 is even (WM_BK is), so packed row (k0 + kk) / 2 splits cleanly
      for (int idx = tid; idx < (WM_BK / 2) * WM_BN; idx += WM_THREADS) {
        const int pr = idx / WM_BN, nn = idx % WM_BN;
        const int k = k0 + 2 * pr, n = n0 + nn;
        const int b = (k < K && n < N)
            ? (int)w[(long long)(k / 2) * N + n] : 0;
        Bs[(2 * pr) * B_LD + nn] = __float2bfloat16((float)lo4(b));
        Bs[(2 * pr + 1) * B_LD + nn] = __float2bfloat16((float)hi4(b));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WM_BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < WM_BM * WM_BN; idx += WM_THREADS) {
    const int r = idx / WM_BN, c = idx % WM_BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(long long)m * N + n] = Cs[r * C_LD + c] * step[n];
  }
}

template <typename XT, int BITS, int MT>
cudaError_t launch_skinny(const void* x, const int8_t* w, const float* step,
                          float* out, int M, int K, int N, int vec,
                          cudaStream_t s) {
  dim3 grid((N + SK_BN - 1) / SK_BN, (M + MT - 1) / MT);
  qmm_skinny_kernel<XT, BITS, MT><<<grid, SK_THREADS, 0, s>>>(
      static_cast<const XT*>(x), w, step, out, M, K, N, vec);
  return cudaGetLastError();
}

template <typename XT, int BITS>
cudaError_t dispatch_skinny(const void* x, const int8_t* w, const float* step,
                            float* out, int M, int K, int N, int vec,
                            cudaStream_t s) {
  if (M <= 1) return launch_skinny<XT, BITS, 1>(x, w, step, out, M, K, N, vec, s);
  if (M <= 2) return launch_skinny<XT, BITS, 2>(x, w, step, out, M, K, N, vec, s);
  if (M <= 4) return launch_skinny<XT, BITS, 4>(x, w, step, out, M, K, N, vec, s);
  return launch_skinny<XT, BITS, 8>(x, w, step, out, M, K, N, vec, s);
}

}  // namespace

namespace wgmma_route {

using namespace sm90;

constexpr int QW_BK = 64;       // K rows a stage holds

// a block's output tile is 128 rows x BN columns (BN = 128 or 256: each
// consumer warpgroup one m64nBN accumulator); the ring holds as many
// stages as fit in shared memory
template <int BN>
__host__ __device__ constexpr int qw_stages() { return BN == 256 ? 3 : 4; }

template <int BITS>
__host__ __device__ constexpr int raw_rows() {
  return BITS == 4 ? QW_BK / 2 : QW_BK;   // code rows of a K stage
}

template <int BITS, int BN>
constexpr size_t qmm_smem_bytes() {
  return 1024 + qw_stages<BN>() * (WGS + BN / 64) * BOX_BYTES +
         qw_stages<BN>() * raw_rows<BITS>() * BN +
         3 * qw_stages<BN>() * sizeof(uint64_t);
}

// byte j of w (a biased code, 0..255) in the mantissa of 2^23: 2^23 + byte
__device__ __forceinline__ float biased(uint32_t w, int j) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | j));
}

// 8 biased codes (the bytes of u0, then u1) minus `bias`, as 8 bf16
__device__ __forceinline__ uint4 to_bf16x8(uint32_t u0, uint32_t u1,
                                           float bias) {
  uint4 r;
  r.x = pack_bf16(biased(u0, 0) - bias, biased(u0, 1) - bias);
  r.y = pack_bf16(biased(u0, 2) - bias, biased(u0, 3) - bias);
  r.z = pack_bf16(biased(u1, 0) - bias, biased(u1, 1) - bias);
  r.w = pack_bf16(biased(u1, 2) - bias, biased(u1, 3) - bias);
  return r;
}

// 16-byte chunk `chunk` (8 columns) of row k of a 128-byte-swizzled box
__device__ __forceinline__ void store_chunk(uint8_t* box, int k, int chunk,
                                            uint4 v) {
  *reinterpret_cast<uint4*>(box + k * 128 + ((chunk ^ (k & 7)) << 4)) = v;
}

// the producer's 128 threads: one raw code tile [raw_rows][BN] into the B
// stage, BN/64 [64 K][64 N] bf16 boxes. Unit u is 8 columns of one raw row.
template <int BITS, int BN>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, uint8_t* b,
                                             int pt) {
  constexpr int CHUNKS = BN / 8;   // units a raw row
  constexpr int UNITS = raw_rows<BITS>() * CHUNKS;
#pragma unroll
  for (int j = 0; j < UNITS / 128; ++j) {
    const int u = pt + 128 * j;
    const int r = u / CHUNKS, c8 = u % CHUNKS;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * BN + 8 * c8);
    uint8_t* box = b + (c8 / 8) * BOX_BYTES;
    if constexpr (BITS == 8) {
      store_chunk(box, r, c8 % 8,
                  to_bf16x8(w.x ^ 0x80808080u, w.y ^ 0x80808080u, 8388736.f));
    } else {
      // packed row r holds K row 2r in its low nibbles, 2r + 1 in its high
      const uint32_t m = 0x0F0F0F0Fu, flip = 0x08080808u;
      store_chunk(box, 2 * r, c8 % 8,
                  to_bf16x8((w.x & m) ^ flip, (w.y & m) ^ flip, 8388616.f));
      store_chunk(box, 2 * r + 1, c8 % 8,
                  to_bf16x8(((w.x >> 4) & m) ^ flip, ((w.y >> 4) & m) ^ flip,
                            8388616.f));
    }
  }
}

template <int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
    const uint64_t db = sw128_desc(b + 2048 * kk, BOX_BYTES, 1024);
    if constexpr (BN == 256)
      wgmma_ss_n256_tb(acc, da, db);
    else
      wgmma_ss_n128_tb(acc, da, db);
  }
}

// grid (BN-column blocks, 128-row blocks). Consumer warpgroup w owns rows
// m0 + 64w and all BN columns.
template <int BITS, int BN>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mw,
                 const float* __restrict__ step, float* __restrict__ out,
                 int M, int K, int N) {
  constexpr int STAGES_ = qw_stages<BN>();
  constexpr int RAW_ROWS = raw_rows<BITS>();
  constexpr int RAW_BYTES = RAW_ROWS * BN;
  constexpr int NB = BN / 64;                         // B boxes a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align_1024(smem_raw);                 // [stage][WGS] boxes
  uint8_t* bs = xs + STAGES_ * WGS * BOX_BYTES;       // [stage][NB] boxes
  uint8_t* raw = bs + STAGES_ * NB * BOX_BYTES;       // [stage] code tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw + STAGES_ * RAW_BYTES);
  uint64_t* loaded = bars;               // the raw code tile is in
  uint64_t* full = loaded + STAGES_;     // x is in and the codes converted
  uint64_t* empty = full + STAGES_;      // both warpgroups are done

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BLOCK_ROWS;
  const int n_tiles = (K + QW_BK - 1) / QW_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 1 + 128);   // the x loads' arrival + 128 converters
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    const int pt = threadIdx.x - CONSUMERS;
    if (pt == 0)
      for (int t = 0; t < min(STAGES_, n_tiles); ++t) {
        mbar_expect_tx(&loaded[t], RAW_BYTES);
        tma_load_2d(raw + t * RAW_BYTES, &mw, &loaded[t], n0, t * RAW_ROWS);
      }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES_, n = t / STAGES_;
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      if (pt == 0) {
        mbar_expect_tx(&full[s], WGS * BOX_BYTES);
        for (int w = 0; w < WGS; ++w)
          tma_load_2d(xs + (s * WGS + w) * BOX_BYTES, &mx, &full[s],
                      t * QW_BK, m0 + TILE * w);
      }
      mbar_wait(&loaded[s], n & 1);
      convert_tile<BITS, BN>(raw + s * RAW_BYTES, bs + s * NB * BOX_BYTES, pt);
      fence_proxy_async();   // the wgmma reads these stores (async proxy)
      mbar_arrive(&full[s]);
      // every converter has read raw[s]: refill it with tile t + STAGES_
      named_sync(1, 128);
      if (pt == 0 && t + STAGES_ < n_tiles) {
        mbar_expect_tx(&loaded[s], RAW_BYTES);
        tma_load_2d(raw + s * RAW_BYTES, &mw, &loaded[s], n0,
                    (t + STAGES_) * RAW_ROWS);
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES_, n = t / STAGES_;
      mbar_wait(&full[s], n & 1);
      wgmma_fence();
      mma_stage<BN>(acc, smem_u32(xs + (s * WGS + wg) * BOX_BYTES),
                    smem_u32(bs + s * NB * BOX_BYTES));
      wgmma_commit();
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_regs(acc);
      if (t > 0) mbar_arrive(&empty[(t - 1) % STAGES_]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int row0 = m0 + TILE * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (row < M && col < N)   // N is even: col + 1 < N too
        *reinterpret_cast<float2*>(out + static_cast<long long>(row) * N +
                                   col) =
            make_float2(acc[i] * step[col], acc[i + 1] * step[col + 1]);
    }
  }
}

template <int BITS, int BN>
cudaError_t launch_qmm_tile(const void* x, const int8_t* w,
                            const float* step, float* out, int M, int K,
                            int N, cudaStream_t s) {
  CUtensorMap mx, mw;
  cudaError_t err = make_map_2d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                K, M, 64, TILE, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = make_map_2d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                    BITS == 4 ? K / 2 : K, BN, raw_rows<BITS>(),
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = qmm_smem_bytes<BITS, BN>();
  // attributes set once a template instance, on the first (eager) launch:
  // a launch captured into a CUDA graph then makes no other CUDA call
  static bool ready = false;
  if (!ready) {
    err = cudaFuncSetAttribute(qmm_wgmma_kernel<BITS, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BLOCK_ROWS - 1) / BLOCK_ROWS);
  qmm_wgmma_kernel<BITS, BN><<<grid, THREADS, smem, s>>>(mx, mw, step, out,
                                                         M, K, N);
  return cudaGetLastError();
}

// 256-column tiles halve how often each x tile is read, where they still
// give every SM a block; otherwise 128-column tiles
template <int BITS>
cudaError_t launch_qmm(const void* x, const int8_t* w, const float* step,
                       float* out, int M, int K, int N, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long blocks256 = static_cast<long long>((N + 255) / 256) *
                              ((M + BLOCK_ROWS - 1) / BLOCK_ROWS);
  if (blocks256 >= sms)
    return launch_qmm_tile<BITS, 256>(x, w, step, out, M, K, N, s);
  return launch_qmm_tile<BITS, 128>(x, w, step, out, M, K, N, s);
}

}  // namespace wgmma_route

// ---------------------------------------------------------------- gemv route
namespace gemv_route {

using namespace sm90;

constexpr int GV_THREADS = 512;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_BN = 128;              // columns a cluster owns
constexpr int GV_WARP_COLS = 32;        // columns a warp owns: two mma tiles
constexpr int GV_KQ = GV_WARPS / (GV_BN / GV_WARP_COLS);   // 4 warps a column
constexpr int GV_STAGE_ROWS = 128;      // packed code rows of a ring stage
constexpr int GV_STAGE_BYTES = GV_STAGE_ROWS * GV_BN;      // 16 KB
constexpr int GV_STAGES = 4;            // ring stages (64 KB a block)
constexpr int GV_MAX_SPLIT = 4;         // blocks a cluster
constexpr int GV_MAX_SLICE_K = 4096;    // K rows of x a block stages
constexpr int GV_XPAD = 16;             // bf16 between two staged rows of x
// the warps' partial sums [kq][8][BN] f32 reuse the ring once it is drained
static_assert(GV_KQ * 8 * GV_BN * 4 <= GV_STAGES * GV_STAGE_BYTES, "");

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 16-byte chunk c of ring row r sits at chunk c ^ swizzle(r): the four
// rows a warp's quads read at once (r / 4 or, int4, r / 2 apart by one)
// land in four different pairs of chunks, so a warp's loads touch 32
// different banks
template <int BITS>
__device__ __forceinline__ int swizzle(int r) {
  return 2 * ((r >> (BITS == 8 ? 2 : 1)) & 3);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  return __byte_perm(a, b, sel);
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// two int8 codes (bytes lo, hi of t at 2j, 2j + 1) as bf16x2, exactly:
// with each byte in the low byte of a bf16 of exponent 2^7 (0x43..), the
// low 7 bits give 128 + low7, and the sign bit picks 128 or 256 to take
// away: low7 - 128 s = the code
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t t, int j) {
  const uint32_t h = prmt(t, 0x43434343u, j ? 0x4342u : 0x4140u);
  return sub_bf16x2(h & 0xFF7FFF7Fu, (h & 0x00800080u) | 0x43004300u);
}

// the two nibbles of byte j of v as bf16x2 (low nibble in the low half),
// exactly: s = v >> 4 holds the high nibble in its byte's low bits; each
// biased nibble (n ^ 8) below 0x43 gives 128 + n ^ 8, less 136
__device__ __forceinline__ uint32_t s4x2_bf16(uint32_t v, uint32_t s, int j) {
  const uint32_t h = prmt(v, s, 0x0400u | ((4 + j) << 8) | j);
  return sub_bf16x2((h & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k step (16 K rows) of a warp's 32 columns: two m16n8k16 products,
// D[n][m] += W[k][n] x[m][k], with rows of x as the n = 8 side. Thread
// (group gid = lane / 4, tig = lane % 4) reads one 4-byte word of 4
// columns (cb + 4 gid .. + 3) from each of its rows and the 4 x values
// x[gid][k0 + 4 tig .. + 3]. The mma's k order is permuted alike in both
// operands: its k pairs (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9) are
// K rows k0 + 4 tig .. + 3. Its 16 rows (output columns) are the thread
// group's columns: tile 0 row gid = column cb + 4 gid, row gid + 8 =
// cb + 4 gid + 1; tile 1 the next two.
template <int BITS>
__device__ __forceinline__ void mma_kstep(float (&d)[2][4],
                                          const uint8_t* slot, int s, int cb,
                                          int gid, int tig,
                                          const __nv_bfloat16* xk) {
  const int chunk = cb / 16 + gid / 4, in = 4 * (gid % 4);
  uint32_t a[2][4];
  if constexpr (BITS == 8) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * s + 4 * tig + i;
      u[i] = *reinterpret_cast<const uint32_t*>(
          slot + r * GV_BN + ((chunk ^ swizzle<8>(r)) << 4) + in);
    }
    // [k0 c0, k1 c0, k0 c1, k1 c1] and the same for columns 2, 3 / rows 2, 3
    const uint32_t t01[2] = {prmt(u[0], u[1], 0x5140u),
                             prmt(u[0], u[1], 0x7362u)};
    const uint32_t t23[2] = {prmt(u[2], u[3], 0x5140u),
                             prmt(u[2], u[3], 0x7362u)};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      a[t][0] = s8x2_bf16(t01[t], 0);
      a[t][1] = s8x2_bf16(t01[t], 1);
      a[t][2] = s8x2_bf16(t23[t], 0);
      a[t][3] = s8x2_bf16(t23[t], 1);
    }
  } else {
    // packed rows 8 s + 2 tig (K rows 4 tig, 4 tig + 1) and + 1 (the next 2)
    uint32_t v[2], sh[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 8 * s + 2 * tig + i;
      v[i] = *reinterpret_cast<const uint32_t*>(
          slot + r * GV_BN + ((chunk ^ swizzle<4>(r)) << 4) + in);
      sh[i] = v[i] >> 4;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      a[t][0] = s4x2_bf16(v[0], sh[0], 2 * t);
      a[t][1] = s4x2_bf16(v[0], sh[0], 2 * t + 1);
      a[t][2] = s4x2_bf16(v[1], sh[1], 2 * t);
      a[t][3] = s4x2_bf16(v[1], sh[1], 2 * t + 1);
    }
  }
  const uint2 b = *reinterpret_cast<const uint2*>(xk + 4 * tig);
  mma_bf16(d[0], a[0], b.x, b.y);
  mma_bf16(d[1], a[1], b.x, b.y);
}

// grid (split, column tiles), one cluster of `split` blocks a column tile:
// cluster rank q sums packed code rows [q * rows_per, (q + 1) * rows_per)
// (rows_per a multiple of 128) of columns [n0, n0 + 128). The rank's rows
// stream through a ring of GV_STAGES stages of 128 rows x 128 bytes, every
// thread copying two 16-byte chunks a stage with cp.async (neighbouring
// threads on neighbouring chunks of a row); its K slice of x is staged
// once, bf16 [8][k], rows past M zero. Warp w owns columns
// n0 + 32 (w % 4) .. + 31 and the k steps of every stage's quarter w / 4.
template <int BITS>
__global__ void __launch_bounds__(GV_THREADS, 2)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ step,
                float* __restrict__ out, int M, int K, int N, int rows_per) {
  constexpr int R_PER = BITS == 4 ? 2 : 1;   // K rows a packed row
  constexpr int KSTEPS = GV_STAGE_ROWS * R_PER / 16;   // k steps a stage
  constexpr int OUTS = 8 * GV_BN;                      // partial sums a block
  extern __shared__ float4 gv_smem[];
  // the code ring (then the warps' partials), the x slice, the block's
  // partials [8][BN]
  uint8_t* ring = reinterpret_cast<uint8_t*>(gv_smem);
  float* red = reinterpret_cast<float*>(ring);
  const int kpad = rows_per * R_PER, xstride = kpad + GV_XPAD;
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + GV_STAGES * GV_STAGE_BYTES);
  float* part = reinterpret_cast<float*>(xs + 8 * xstride);

  const int split = gridDim.x;   // the cluster spans the grid's x
  const int rank = cluster_rank();
  const int n0 = blockIdx.y * GV_BN;
  const int R = K / R_PER;
  const int r_lo = min(R, rank * rows_per);
  const int rows = min(R, r_lo + rows_per) - r_lo;
  const int n_stages = (rows + GV_STAGE_ROWS - 1) / GV_STAGE_ROWS;
  const int tid = threadIdx.x;
  const int8_t* wr = w + static_cast<long long>(r_lo) * N + n0;

  // x [M][K] -> xs [8][kpad]: rows past M and K rows past the rank's end
  // are 0 (K % 8 == 0: whole chunks)
  const int kn = rows * R_PER, k_lo = r_lo * R_PER;
  for (int c = tid; c < 8 * (kpad / 8); c += GV_THREADS) {
    const int m = c / (kpad / 8), k = (c % (kpad / 8)) * 8;
    const bool in = m < M && k < kn;
    cp_async16(xs + m * xstride + k,
               in ? x + static_cast<long long>(m) * K + k_lo + k : x,
               in ? 16 : 0);
  }
  cp_async_commit();
  // stage t of the rank's rows into ring slot t % GV_STAGES; rows past the
  // rank's end and columns past N (N % 16 == 0: whole chunks) read as 0
  auto issue = [&](int t) {
    uint8_t* slot = ring + (t % GV_STAGES) * GV_STAGE_BYTES;
#pragma unroll
    for (int h = 0; h < GV_STAGE_BYTES / 16 / GV_THREADS; ++h) {
      const int c = tid + h * GV_THREADS;
      const int row = c / (GV_BN / 16), chunk = c % (GV_BN / 16);
      const int rr = t * GV_STAGE_ROWS + row;
      const bool in = rr < rows && n0 + 16 * chunk < N;
      cp_async16(slot + row * GV_BN + ((chunk ^ swizzle<BITS>(row)) << 4),
                 in ? wr + static_cast<long long>(rr) * N + 16 * chunk : w,
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < GV_STAGES - 1; ++t) {
    if (t < n_stages) issue(t);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cb = GV_WARP_COLS * (warp % (GV_BN / GV_WARP_COLS));
  const int kq = warp / (GV_BN / GV_WARP_COLS);
  float d[2][4] = {};
  for (int t = 0; t < n_stages; ++t) {
    // x and stage t have landed for every thread, and slot
    // (t - 1) % GV_STAGES has been read by every thread: refill it
    cp_async_wait<GV_STAGES - 2>();
    __syncthreads();
    if (t + GV_STAGES - 1 < n_stages) issue(t + GV_STAGES - 1);
    cp_async_commit();
    const uint8_t* slot = ring + (t % GV_STAGES) * GV_STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < KSTEPS / GV_KQ; ++j) {
      const int s = kq * (KSTEPS / GV_KQ) + j;
      mma_kstep<BITS>(d, slot, s, cb, gid, tig,
                      xs + gid * xstride + t * GV_STAGE_ROWS * R_PER + 16 * s);
    }
  }

  // the partial sums meet in a fixed order: the column's four warps
  // kq = 0..3, then the cluster's ranks 0..split-1
  cp_async_wait<0>();   // only empty groups are left
  __syncthreads();      // every thread is done with the ring, which red reuses
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // d[t][i]: column cb + 4 gid + 2 t + i / 2, row of x 2 tig + i % 2
      const int col = cb + 4 * gid + 2 * t + i / 2, m = 2 * tig + i % 2;
      red[(kq * 8 + m) * GV_BN + col] = d[t][i];
    }
  __syncthreads();
  for (int o = tid; o < OUTS; o += GV_THREADS) {
    float sum = red[o];
#pragma unroll
    for (int q = 1; q < GV_KQ; ++q) sum += red[q * OUTS + o];
    part[o] = sum;
  }
  cluster_sync();   // every rank's partials are in its shared memory
  // rank q writes outputs [q * per, (q + 1) * per) of the tile
  const int per = (OUTS + split - 1) / split;
  for (int i = tid; i < per; i += GV_THREADS) {
    const int o = rank * per + i;
    const int m = o / GV_BN, col = n0 + o % GV_BN;
    if (o < OUTS && m < M && col < N) {
      float sum = ld_cluster(part + o, 0);
      for (int q = 1; q < split; ++q) sum += ld_cluster(part + o, q);
      out[static_cast<long long>(m) * N + col] = sum * step[col];
    }
  }
  cluster_sync();   // no block leaves while another reads its partials
}

template <int BITS>
cudaError_t launch_gemv(const void* x, const int8_t* w, const float* step,
                        float* out, int M, int K, int N, int split,
                        cudaStream_t s) {
  if (M > 8 || N % 16 != 0 || K % 8 != 0 || split < 1 ||
      split > GV_MAX_SPLIT || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const int R = BITS == 4 ? K / 2 : K;
  // packed rows a rank, whole stages (gemv_rows_per in the wrapper)
  const int rows_per = ((R + split - 1) / split + GV_STAGE_ROWS - 1) /
                       GV_STAGE_ROWS * GV_STAGE_ROWS;
  const int kpad = rows_per * (BITS == 4 ? 2 : 1);
  if (kpad > GV_MAX_SLICE_K) return cudaErrorInvalidValue;
  auto smem = [](int kp) {
    return (size_t)GV_STAGES * GV_STAGE_BYTES +
           (size_t)8 * (kp + GV_XPAD) * 2 + (size_t)8 * GV_BN * 4;
  };
  auto kernel = qmm_gemv_kernel<BITS>;
  static bool ready = false;   // attributes set once a template instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem(GV_MAX_SLICE_K));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + GV_BN - 1) / GV_BN);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem(kpad);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), w, step, out, M, K,
      N, rows_per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace gemv_route

namespace {

enum Route { SKINNY = 0, WMMA = 1, WGMMA = 2, GEMV = 3 };

template <int BITS>
cudaError_t dispatch(const void* x, const int8_t* w, const float* step,
                     float* out, int M, int K, int N, int is_bf16, int vec,
                     int route, int split, cudaStream_t s) {
  if (route == SKINNY)
    return is_bf16
        ? dispatch_skinny<__nv_bfloat16, BITS>(x, w, step, out, M, K, N, vec, s)
        : dispatch_skinny<float, BITS>(x, w, step, out, M, K, N, vec, s);
  if (!is_bf16) return cudaErrorInvalidValue;
  if (route == GEMV)
    return gemv_route::launch_gemv<BITS>(x, w, step, out, M, K, N, split, s);
  if (route == WGMMA) {
    if (N % 16 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
    return wgmma_route::launch_qmm<BITS>(x, w, step, out, M, K, N, s);
  }
  if (route != WMMA) return cudaErrorInvalidValue;
  dim3 grid((N + WM_BN - 1) / WM_BN, (M + WM_BM - 1) / WM_BM);
  qmm_wmma_kernel<BITS><<<grid, WM_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), w, step, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16 (is_bf16 = 1) or f32; w: int8 codes [K, N] (bits 8) or
// packed int4 [K/2, N] (bits 4, K even); step: [N] f32; out: [M, N] f32;
// all contiguous. vec = 1 when N % 16 == 0 and w is 16-byte aligned.
// route: 0 the skinny kernel (any x dtype), 1 the wmma kernel, 2 the wgmma
// kernel, 3 the gemv kernel (all three bf16 x; wgmma needs N % 16 == 0,
// K % 8 == 0 and 16-byte aligned x and w; gemv M <= 8, N % 16 == 0,
// K % 8 == 0, 16-byte aligned x and w and split, the blocks of a cluster,
// in 1..16, with a K slice of x that fits its 64 KB). Returns the cudaError_t of the launch (0 on success;
// 1 for a route that cannot take the shape, 500 when the driver has no
// cuTensorMapEncodeTiled, 716 for a misaligned pointer on the wgmma route).
extern "C" int quant_matmul(const void* x, const void* w, const void* step,
                            void* out, int M, int K, int N, int bits,
                            int is_bf16, int vec, int route, int split,
                            void* stream) {
  if (M < 1 || K < 1 || N < 1 || (bits == 4 && K % 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wc = static_cast<const int8_t*>(w);
  const float* st = static_cast<const float*>(step);
  float* o = static_cast<float*>(out);
  if (bits == 8) return (int)dispatch<8>(x, wc, st, o, M, K, N, is_bf16, vec, route, split, s);
  if (bits == 4) return (int)dispatch<4>(x, wc, st, o, M, K, N, is_bf16, vec, route, split, s);
  return (int)cudaErrorInvalidValue;
}
