// Length-bounded decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of paddle_tpu/ops/pallas/decode_attention.py:
//   - _decode_kernel, the dense-cache form (C entry decode_attention,
//     launched there by _pallas_decode_attention): a window of Q query rows
//     q [B, H, Q, D] (Q = 1 is a decode tick, Q > 1 a speculative verify
//     window) against a K/V cache [B, H, S, D] in bf16 or f32;
//   - _decode_kernel_q8, the scaled-int8 form (C entry decode_attention_q8):
//     the same over int8 codes [B, H, S, D] and one f32 step per position
//     and head [B, H, S]; each key's and value's codes are multiplied by
//     their position's step in registers as they are loaded, so the cache
//     streams from device memory at one byte an element plus 4 bytes of
//     step per position;
//   - _decode_kernel_paged and _decode_kernel_paged_q8 (C entries
//     decode_attention_paged and decode_attention_paged_q8, launched there
//     by _pallas_paged_decode_attention): the same two forms with the cache
//     in a page pool [P, H, ps, D] (steps [P, H, ps]) read through a page
//     table ptab [B, nb] int32: key j of row b lives on pool page
//     ptab[b, j / ps] at offset j % ps. On the TPU the table rode in as a
//     scalar-prefetch operand of the BlockSpec index maps; here each block
//     loads its own table entries.
// Per-row positions pos [B] int32: query row j of batch row b attends keys
// 0 .. pos[b] + j. Scores, softmax and accumulation run in f32 and the
// output [B, H, Q, D] is f32.
//
// What bounds it on the H100: memory. A decode tick does 2*D multiply-adds
// per key per query row and reads 2*D cache elements per key, far below
// the card's ~295 operations per byte, so the least time is the live K and
// V bytes, 2*B*H*(pos+Q)*D*elem (plus 8 step bytes per position in the
// int8 form, and 4 table bytes per live page in the paged form), over
// 3.35 TB/s. What the design does:
//   - one block per (head, batch row) walks only that row's live keys,
//     [0, min(pos + Q, S)) (S = nb * ps when paged): the work and the bytes
//     follow each row's own length, and the cache tail past it is never
//     read (the TPU kernel predicated those blocks off but still streamed
//     them);
//   - the four warps split the keys in interleaved groups of 8; within a
//     warp each lane holds D/32 consecutive elements of a key row, so a
//     warp reads whole rows with neighbouring lanes on neighbouring
//     addresses (a 128-byte line per int8 row at D = 128), and 8 rows are
//     in flight per warp before any arithmetic. The int8 form keeps that
//     layout rather than 16 codes a lane: 16 elements a lane would need 16
//     accumulators per query row, 256 registers at Q = 8;
//   - the paged form changes only where a key row is loaded from: a warp's
//     8 keys lie on at most two pages when ps >= 8, so it reads those two
//     table entries once per key group (one per key when ps < 8), never
//     per element. Every float operation after the load is the dense
//     form's, in the same order, so over the gathered view the two give
//     bitwise equal results;
//   - each warp keeps its own online-softmax state (m, l, acc) in
//     registers; the four states merge once through shared memory at the
//     end, so nothing but q, the live cache (and its steps and table
//     entries) and the output touches device memory.
// One block per (b, h) leaves the card under-filled when B*H is small and
// the cache is long; splitting the keys across blocks (flash-decoding) is
// the next design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;           // warps per block
constexpr int NT = NW * 32;
constexpr int KG = 8;           // keys a warp loads per step
constexpr int QMAX = 8;         // widest query window
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(signed char x) { return (float)x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane `lane` owns elements lane*E .. lane*E + E - 1 of a D-wide row
// (lanes past D / E own none when D < 32). SCALED: T is int8 and ks / vs
// hold the per-position steps. PAGED: kc, vc (and ks, vs) are page pools
// [P, H, ps, D] read through ptab [B, nb]; S = nb * ps is the row's
// logical length. Dense: caches [B, H, S, D], ptab unused.
template <typename T, int D, bool SCALED, bool PAGED>
__global__ void __launch_bounds__(NT)
decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ ptab,
              const int* __restrict__ pos, float* __restrict__ out, int H,
              int S, int Q, int P, int ps, int nb, float scale) {
  constexpr int E = D >= 32 ? D / 32 : 1;
  __shared__ float sm_m[NW][QMAX];
  __shared__ float sm_l[NW][QMAX];
  __shared__ float sm_acc[NW][QMAX][D];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const long long bh = (long long)b * H + h;
  const int p0 = pos[b];
  const int n_live = min(p0 + Q, S);
  const int* row_tab = PAGED ? ptab + (long long)b * nb : nullptr;

  float qr[QMAX][E], m[QMAX], l[QMAX], acc[QMAX][E];
#pragma unroll
  for (int j = 0; j < QMAX; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int t = 0; t < E; ++t) {
      const int e = lane * E + t;
      qr[j][t] = (j < Q && e < D) ? q[(bh * Q + j) * D + e] : 0.f;
      acc[j][t] = 0.f;
    }
  }

  for (int g0 = w * KG; g0 < n_live; g0 += NW * KG) {
    // PAGED, ps >= KG: the group's keys lie on logical pages i_lo and
    // i_lo + 1 at most, so two table reads serve all 8
    int i_lo = 0, pg_lo = 0, pg_hi = 0;
    if constexpr (PAGED) {
      if (ps >= KG) {
        i_lo = g0 / ps;
        pg_lo = row_tab[i_lo];
        pg_hi = row_tab[min(i_lo + 1, nb - 1)];
      }
    }
    float kr[KG][E], vr[KG][E];
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      const int key = g0 + kk;
      const bool live = key < n_live;
      // the key's row of the cache (and its index in the step planes)
      long long row = bh * S + key;
      if constexpr (PAGED) {
        const int li = key / ps;
        int pg = ps >= KG ? (li == i_lo ? pg_lo : pg_hi)
                          : (live ? row_tab[li] : 0);
        // an entry outside the pool reads the scratch page, not memory
        // past the pool
        if ((unsigned)pg >= (unsigned)P) pg = 0;
        row = ((long long)pg * H + h) * ps + (key - li * ps);
      }
      float k_step = 1.f, v_step = 1.f;
      if constexpr (SCALED) {
        if (live) {
          k_step = ks[row];
          v_step = vs[row];
        }
      }
      const T* kp = kc + row * D;
      const T* vp = vc + row * D;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const int e = lane * E + t;
        const bool in = live && e < D;
        kr[kk][t] = in ? to_f32(kp[e]) : 0.f;
        vr[kk][t] = in ? to_f32(vp[e]) : 0.f;
        if constexpr (SCALED) {   // dequantize in registers
          kr[kk][t] *= k_step;
          vr[kk][t] *= v_step;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QMAX; ++j) {
      if (j >= Q) break;
      float s[KG];
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < E; ++t) part = fmaf(qr[j][t], kr[kk][t], part);
        s[kk] = warp_sum(part) * scale;
        const int key = g0 + kk;
        if (key < n_live && key <= p0 + j) mx = fmaxf(mx, s[kk]);
      }
      const float m_new = fmaxf(m[j], mx);
      const float alpha = expf(m[j] - m_new);
      float rs = 0.f;
      float pk[KG];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const int key = g0 + kk;
        // masked keys contribute exactly 0, whatever the running max is
        pk[kk] = (key < n_live && key <= p0 + j) ? expf(s[kk] - m_new) : 0.f;
        rs += pk[kk];
      }
      l[j] = l[j] * alpha + rs;
      m[j] = m_new;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        float a = acc[j][t] * alpha;
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) a = fmaf(pk[kk], vr[kk][t], a);
        acc[j][t] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QMAX; ++j) {
    if (j >= Q) break;
    if (lane == 0) {
      sm_m[w][j] = m[j];
      sm_l[w][j] = l[j];
    }
#pragma unroll
    for (int t = 0; t < E; ++t) {
      const int e = lane * E + t;
      if (e < D) sm_acc[w][j][e] = acc[j][t];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < Q * D; idx += NT) {
    const int j = idx / D, e = idx % D;
    float mt = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) mt = fmaxf(mt, sm_m[ww][j]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float f = expf(sm_m[ww][j] - mt);
      lt += sm_l[ww][j] * f;
      at += sm_acc[ww][j][e] * f;
    }
    out[(bh * Q + j) * D + e] = at / (lt == 0.f ? 1.f : lt);
  }
}

// The geometry of one call: dense caches use S; paged pools use P, ps, nb
// and ptab (S = nb * ps).
struct Geom {
  int B, H, S, Q, P, ps, nb;
};

template <typename T, int D, bool SCALED, bool PAGED>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* ptab,
                   const int* pos, float* out, Geom g, float scale,
                   cudaStream_t stream) {
  dim3 grid(g.H, g.B);
  decode_kernel<T, D, SCALED, PAGED><<<grid, NT, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, ptab,
      pos, out, g.H, g.S, g.Q, g.P, g.ps, g.nb, scale);
  return cudaGetLastError();
}

template <typename T, bool SCALED, bool PAGED>
cudaError_t dispatch_d(const float* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* ptab,
                       const int* pos, float* out, Geom g, int D,
                       float scale, cudaStream_t stream) {
  if (g.Q < 1 || g.Q > QMAX) return cudaErrorInvalidValue;
  if (PAGED && (g.ps < 1 || g.nb < 1 || g.P < 1)) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<T, 16, SCALED, PAGED>(q, k, v, ks, vs, ptab, pos, out, g, scale, stream);
    case 32: return launch<T, 32, SCALED, PAGED>(q, k, v, ks, vs, ptab, pos, out, g, scale, stream);
    case 64: return launch<T, 64, SCALED, PAGED>(q, k, v, ks, vs, ptab, pos, out, g, scale, stream);
    case 128: return launch<T, 128, SCALED, PAGED>(q, k, v, ks, vs, ptab, pos, out, g, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, H, Q, D] f32; k, v: [B, H, S, D] bf16 (is_bf16 = 1) or f32; pos: [B]
// int32; out: [B, H, Q, D] f32; all contiguous, 1 <= Q <= 8. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, void* out, int B, int H,
                                int S, int Q, int D, int is_bf16, float scale,
                                void* stream) {
  const Geom g{B, H, S, Q, 0, 1, 1};
  auto qf = static_cast<const float*>(q);
  auto p = static_cast<const int*>(pos);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16, false, false>(
        qf, k, v, nullptr, nullptr, nullptr, p, o, g, D, scale, s);
  return (int)dispatch_d<float, false, false>(qf, k, v, nullptr, nullptr,
                                              nullptr, p, o, g, D, scale, s);
}

// The scaled-int8 cache: k, v int8 codes [B, H, S, D]; ks, vs f32 steps
// [B, H, S]; the rest as decode_attention.
extern "C" int decode_attention_q8(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* pos, void* out,
                                   int B, int H, int S, int Q, int D,
                                   float scale, void* stream) {
  const Geom g{B, H, S, Q, 0, 1, 1};
  return (int)dispatch_d<signed char, true, false>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), nullptr, static_cast<const int*>(pos),
      static_cast<float*>(out), g, D, scale,
      static_cast<cudaStream_t>(stream));
}

// The paged pool: k, v [P, H, ps, D] bf16 (is_bf16 = 1) or f32; ptab
// [B, nb] int32 page table, entries in [0, P) (0 is the scratch page);
// ps >= 1 keys a page; the rest as decode_attention, with each row's
// logical length nb * ps.
extern "C" int decode_attention_paged(const void* q, const void* k,
                                      const void* v, const void* ptab,
                                      const void* pos, void* out, int B,
                                      int H, int P, int ps, int nb, int Q,
                                      int D, int is_bf16, float scale,
                                      void* stream) {
  const Geom g{B, H, nb * ps, Q, P, ps, nb};
  auto qf = static_cast<const float*>(q);
  auto t = static_cast<const int*>(ptab);
  auto p = static_cast<const int*>(pos);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16, false, true>(
        qf, k, v, nullptr, nullptr, t, p, o, g, D, scale, s);
  return (int)dispatch_d<float, false, true>(qf, k, v, nullptr, nullptr, t,
                                             p, o, g, D, scale, s);
}

// The paged scaled-int8 pool: k, v int8 codes [P, H, ps, D]; ks, vs f32
// steps [P, H, ps]; the rest as decode_attention_paged.
extern "C" int decode_attention_paged_q8(const void* q, const void* k,
                                         const void* v, const void* ks,
                                         const void* vs, const void* ptab,
                                         const void* pos, void* out, int B,
                                         int H, int P, int ps, int nb, int Q,
                                         int D, float scale, void* stream) {
  const Geom g{B, H, nb * ps, Q, P, ps, nb};
  return (int)dispatch_d<signed char, true, true>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(ptab),
      static_cast<const int*>(pos), static_cast<float*>(out), g, D, scale,
      static_cast<cudaStream_t>(stream));
}
