// Length-bounded decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of paddle_tpu/ops/pallas/decode_attention.py:
//   - _decode_kernel, the dense-cache form (C entry decode_attention,
//     launched there by _pallas_decode_attention): a window of Q query rows
//     q [B, H, Q, D] (Q = 1 is a decode tick, Q > 1 a speculative verify
//     window) against a K/V cache [B, H, S, D] in bf16 or f32;
//   - _decode_kernel_paged (C entry decode_attention_paged, launched there
//     by _pallas_paged_decode_attention): the same with the cache in a page
//     pool [P, H, ps, D] read through a page table ptab [B, nb] int32: key
//     j of row b lives on pool page ptab[b, j / ps] at offset j % ps. On the
//     TPU the table rode in as a scalar-prefetch operand of the BlockSpec
//     index maps; here each block loads its own table entries;
//   - _decode_kernel_q8 and _decode_kernel_paged_q8 (C entries
//     decode_attention_q8 and decode_attention_paged_q8): the two forms over
//     int8 codes and one f32 step per position and head ([B, H, S] or
//     [P, H, ps]), the codes made floats in registers as they are loaded
//     and each key's and value's step applied once a key.
// Per-row positions pos [B]: query row j of batch row b attends keys
// 0 .. pos[b] + j. Scores, softmax and accumulation run in f32 and the
// output [B, H, Q, D] is f32.
//
// What bounds it on the H100: memory. A decode tick does 2*D multiply-adds
// per key per query row and reads 2*D cache elements per key, far below
// the card's ~295 operations per byte, so the least time is the live K and
// V bytes, 2*B*H*(pos+Q)*D*elem (plus 8 step bytes per position in the
// int8 forms, and 4 table bytes per live page in the paged forms), over
// 3.35 TB/s. The four forms are one template, split_decode_kernel, built
// for that:
//   - split-K (flash-decoding): each (b, h) is a cluster of nsplit blocks,
//     and rank r takes keys [r * chunk, (r + 1) * chunk) of the logical
//     range [0, S), cut at the row's live length pos[b] + Q. The TPU walked
//     the keys as a sequential grid axis; here they are spread over
//     B*H*nsplit blocks so that a batch of 64-128 rows fills 132 SMs. A
//     rank whose chunk lies wholly past the live length loads nothing and
//     holds the empty state (but waits at the cluster barriers, so the
//     grid is sized to stay resident). nsplit and chunk come from the
//     caller (decode_split in ops/kernels/decode_attention.py), a function
//     of (B, H, S, Q) only: a dense call over a paged pool's gathered view
//     splits as the paged call does;
//   - the ranks' states meet in rank order through distributed shared
//     memory, after the block's warps met in warp order: one launch, no
//     workspace, no atomics, the same bits every run;
//   - wide loads: a lane loads 16 bytes of a key row (8 bf16, 4 f32, or 16
//     int8 codes; 8 codes in a window wider than one row, which keeps the
//     bf16 register layout), so a key row spans D * elem / that many lanes
//     (16 at D = 128 bf16, 8 in int8) and a key's score is reduced over
//     those lanes only. A lane issues two loads each of K and V per key
//     group (4 keys a warp at D = 128 bf16, 8 in int8), and the next
//     group's loads (with the int8 keys' steps, one broadcast load a key)
//     are in flight while the current one is reduced (two register
//     buffers);
//   - int8 codes become floats exactly and off the conversion pipe: the
//     code with its sign bit flipped is a biased byte, one prmt puts it in
//     the mantissa of 2^23 and one FADD takes 2^23 + 128 away. The key's
//     and the value's steps are factored out of their codes: a score is
//     (q . codes) * k_step * scale and a probability weighs the codes as
//     p * v_step, one product a key instead of one an element;
//   - the register arrays are sized for the window: one instance for
//     Q = 1 (six blocks an SM, five in int8), one for 2 <= Q <= 4, one for
//     5 <= Q <= 8;
//   - the paged forms change only where a key row is loaded from: one
//     table entry for the block when its live keys lie on one page, else
//     two a key group (ps >= the group) or one a key (smaller pages), never
//     one per element; the int8 steps [P, H, ps] are read through the same
//     row as the codes. Every float operation after the load is the dense
//     form's, in the same order, so over the gathered view the two give
//     bitwise equal results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_sm90.cuh"   // cluster rank, barrier and remote loads

namespace split_route {

using namespace sm90;

constexpr int SW = 4;              // warps a block
constexpr int ST = SW * 32;
constexpr int MAX_SPLIT = 8;       // blocks a cluster: the portable limit
constexpr int QMAX = 8;            // widest query window
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// One launch's operands, passed by value as the kernel's parameter.
struct Args {
  const void* q;                // [B, H, Q, D] f32, or bf16 (q_bf16)
  long long q_sb, q_sh, q_sj;   // its element strides; the last dim is dense
  const void* k;                // [B, H, S, D] dense, [P, H, ps, D] paged
  const void* v;
  const float* ks;              // int8 forms: the steps, [B, H, S] or
  const float* vs;              // [P, H, ps], one a row of k and of v
  const int* ptab;              // [B, nb] when paged
  const void* pos;              // [B] int32, or int64 (pos64)
  long long pos_s;              // its element stride (0: one for all rows)
  float* out;                   // [B, H, Q, D] f32, contiguous
  int q_bf16, pos64;
  int B, H, S, Q, P, ps, nb;    // paged: S = nb * ps
  int chunk;                    // keys a cluster rank takes
  float scale;
};

// Bytes a lane loads of a key row: 16, except for int8 codes in a window
// wider than one row (8, so that the window's q and acc arrays stay 8
// floats a row, as in bf16) and at D = 16 (a row spans two lanes at least).
template <typename T, int D, int QN>
__host__ __device__ constexpr int lane_bytes() {
  return sizeof(T) != 1 || (QN == 1 && D >= 32) ? 16 : 8;
}

// Loaded bytes as the floats they hold, exactly: 16 bytes of 8 bf16 or 4
// f32, or 16 (8) bytes of int8 codes, each code with its sign bit flipped
// (a biased byte, 0..255) put by one prmt in the mantissa of 2^23 and
// taken back by one FADD of 2^23 + 128: no conversion instruction
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <int N>
__device__ __forceinline__ void codes(const uint32_t (&w)[N / 4],
                                      float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint32_t biased = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __fsub_rn(
          __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)),
          8388736.f);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  codes<16>(w, f);
}
__device__ __forceinline__ void unpack(const uint2& r, float (&f)[8]) {
  const uint32_t w[2] = {r.x, r.y};
  codes<8>(w, f);
}

// the pool page of table entry i; an entry outside the pool reads the
// scratch page 0, not memory past the pool
__device__ __forceinline__ int page(const int* tab, int i, int P) {
  const int pg = tab[i];
  return (unsigned)pg < (unsigned)P ? pg : 0;
}

// The K and V slices a lane loads for the key group [g, g + U * KPL): key
// g + u * KPL + sub, elements col .. col + EPL - 1 of its row, and in the
// int8 forms the key's K and V steps, read through the same row. Keys at
// or past `end` read as zeros and load nothing. PAGED: the block's one page
// (one_pg >= 0, its first key one_base), else two table entries a group
// when ps covers the group, else one a key.
template <typename T, int D, int U, int KPL, bool PAGED, typename V>
__device__ __forceinline__ void load_group(V (&kr)[U], V (&vr)[U],
                                           float (&ksr)[U], float (&vsr)[U],
                                           const Args& a, long long bh, int h,
                                           const int* tab, int one_pg,
                                           int one_base, int sub, int col,
                                           int g, int end) {
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  int lo_base = 0, pg_lo = 0, pg_hi = 0;
  if constexpr (PAGED) {
    if (one_pg < 0 && a.ps >= U * KPL) {
      const int i_lo = g / a.ps;
      lo_base = i_lo * a.ps;
      pg_lo = page(tab, i_lo, a.P);
      pg_hi = page(tab, min(i_lo + 1, a.nb - 1), a.P);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int key = g + u * KPL + sub;
    const bool live = key < end;
    long long row = bh * a.S + key;
    if constexpr (PAGED) {
      int pg, off;
      if (one_pg >= 0) {
        pg = one_pg;
        off = key - one_base;
      } else if (a.ps >= U * KPL) {
        off = key - lo_base;
        pg = off < a.ps ? pg_lo : pg_hi;
        off = off < a.ps ? off : off - a.ps;
      } else {
        const int li = key / a.ps;
        pg = live ? page(tab, li, a.P) : 0;
        off = key - li * a.ps;
      }
      row = ((long long)pg * a.H + h) * a.ps + off;
    }
    const V zero{};
    kr[u] = live ? __ldg(reinterpret_cast<const V*>(kc + row * D + col))
                 : zero;
    vr[u] = live ? __ldg(reinterpret_cast<const V*>(vc + row * D + col))
                 : zero;
    if constexpr (sizeof(T) == 1) {
      ksr[u] = live ? __ldg(a.ks + row) : 0.f;
      vsr[u] = live ? __ldg(a.vs + row) : 0.f;
    } else {
      ksr[u] = vsr[u] = 0.f;   // no step
    }
  }
}

// The blocks an SM holds at least, by the launch bounds: at QN = 1 six for
// bf16 and f32 (80 registers a thread; bf16 takes 72 without spilling, and
// a cap of 64 spilled and ran slower), five for int8 (96: its 16 codes a
// load double the q and acc arrays, and a cap of 80 left one load a lane
// per group in flight and ran slower); 3 at QN = 4, 2 at QN = 8.
template <typename T, int QN>
__host__ __device__ constexpr int min_blocks() {
  return QN == 1 ? (sizeof(T) == 1 ? 5 : 6) : QN <= 4 ? 3 : 2;
}

// grid (nsplit, H, B), one cluster of nsplit blocks a (b, h); T: bf16, f32
// or signed char (int8 codes, with the steps a.ks, a.vs); QN: the register
// arrays' window (1, 4 for 2 <= Q <= 4, QMAX above). PAGED: k, v (and the
// steps) are page pools read through ptab.
template <typename T, int D, int QN, bool PAGED>
__global__ void __launch_bounds__(ST, min_blocks<T, QN>())
    split_decode_kernel(const Args a) {
  constexpr bool Q8 = sizeof(T) == 1;    // int8 codes with steps
  constexpr int LB = lane_bytes<T, D, QN>();
  using V = std::conditional_t<LB == 16, uint4, uint2>;
  constexpr int EPL = LB / sizeof(T);   // elements in a lane's bytes
  constexpr int LPK = D / EPL;          // lanes across one key row
  constexpr int KPL = 32 / LPK;         // keys one warp-wide load covers
  constexpr int U = 2;                  // loads a lane issues per K (and V)
  constexpr int KW = U * KPL;           // keys of a warp's group
  static_assert(LPK >= 2 && LPK <= 32, "a key row spans 2 to 32 lanes");
  __shared__ float sm_m[SW][QN], sm_l[SW][QN], sm_acc[SW][QN][D];
  __shared__ float bk_m[QN], bk_l[QN], bk_acc[QN][D];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane / LPK;           // the lane's key within a load
  const int col = (lane % LPK) * EPL;   // its first element of the row
  const int rank = cluster_rank();      // = blockIdx.x: x is one cluster
  const int nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int Q = a.Q;
  const int p0 = a.pos64
                     ? (int)static_cast<const long long*>(a.pos)[b * a.pos_s]
                     : static_cast<const int*>(a.pos)[b * a.pos_s];
  const int c0 = rank * a.chunk;
  // the block's keys: its chunk, cut at the row's live length
  const int end = min(min(c0 + a.chunk, p0 + Q), a.S);

  float qr[QN][EPL], m[QN], l[QN], acc[QN][EPL];
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    m[j] = NEG;
    l[j] = 0.f;
#pragma unroll
    for (int t = 0; t < EPL; ++t) {
      const long long o = b * a.q_sb + h * a.q_sh + j * a.q_sj + col + t;
      qr[j][t] = j >= Q ? 0.f
                 : a.q_bf16
                     ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(a.q)[o])
                     : static_cast<const float*>(a.q)[o];
      acc[j][t] = 0.f;
    }
  }
  const int* tab = PAGED ? a.ptab + (long long)b * a.nb : nullptr;
  int one_pg = -1, one_base = 0;
  if constexpr (PAGED) {
    if (c0 < end && c0 / a.ps == (end - 1) / a.ps) {
      one_base = c0 / a.ps * a.ps;
      one_pg = page(tab, c0 / a.ps, a.P);
    }
  }

  // warp w takes groups c0 + (w + SW i) KW; group i + 1 loads into one
  // buffer while group i, in the other, is reduced
  V kb[2][U], vb[2][U];
  float ksb[2][U], vsb[2][U];   // the int8 keys' steps
  int g = c0 + w * KW;
  if (g < end)
    load_group<T, D, U, KPL, PAGED>(kb[0], vb[0], ksb[0], vsb[0], a, bh, h,
                                    tab, one_pg, one_base, sub, col, g, end);
  while (g < end) {
#pragma unroll
    for (int cur = 0; cur < 2; ++cur) {
      if (g < end) {
        const int next = g + SW * KW;
        if (next < end)
          load_group<T, D, U, KPL, PAGED>(kb[cur ^ 1], vb[cur ^ 1],
                                          ksb[cur ^ 1], vsb[cur ^ 1], a, bh,
                                          h, tab, one_pg, one_base, sub, col,
                                          next, end);
        float kf[U][EPL], vf[U][EPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          unpack(kb[cur][u], kf[u]);
          unpack(vb[cur][u], vf[u]);
        }
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          if (j >= Q) break;
          float s[U], pk[U];
          bool ok[U];
          float mx = NEG;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float part = 0.f;
#pragma unroll
            for (int t = 0; t < EPL; ++t) part = fmaf(qr[j][t], kf[u][t], part);
            // the key's LPK lanes: a butterfly leaves the same sum in each
#pragma unroll
            for (int off = LPK / 2; off > 0; off >>= 1)
              part += __shfl_xor_sync(FULL, part, off);
            // int8: the key's step factored out of its codes' sum
            s[u] = __fmul_rn(Q8 ? __fmul_rn(part, ksb[cur][u]) : part,
                             a.scale);
            const int key = g + u * KPL + sub;
            ok[u] = key < end && key <= p0 + j;
            if (ok[u]) mx = fmaxf(mx, s[u]);
          }
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          const float m_new = fmaxf(m[j], mx);
          const float alpha = expf(m[j] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            // masked keys contribute exactly 0, whatever the running max
            pk[u] = ok[u] ? expf(s[u] - m_new) : 0.f;
            rs += pk[u];
          }
          l[j] = fmaf(l[j], alpha, rs);
          m[j] = m_new;
          // int8: the value's step factored out of its codes
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (Q8) pk[u] = __fmul_rn(pk[u], vsb[cur][u]);
#pragma unroll
          for (int t = 0; t < EPL; ++t) {
            float x = __fmul_rn(acc[j][t], alpha);
#pragma unroll
            for (int u = 0; u < U; ++u) x = fmaf(pk[u], vf[u][t], x);
            acc[j][t] = x;
          }
        }
        g = next;
      }
    }
  }

  // a warp's keys went to its KPL lane groups, which share m: add their l
  // and acc (a butterfly: every lane ends with the same bits)
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    if (j >= Q) break;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      l[j] += __shfl_xor_sync(FULL, l[j], off);
#pragma unroll
      for (int t = 0; t < EPL; ++t)
        acc[j][t] += __shfl_xor_sync(FULL, acc[j][t], off);
    }
    if (lane == 0) {
      sm_m[w][j] = m[j];
      sm_l[w][j] = l[j];
    }
    if (sub == 0) {
#pragma unroll
      for (int t = 0; t < EPL; ++t) sm_acc[w][j][col + t] = acc[j][t];
    }
  }
  __syncthreads();
  // the warps' states meet in warp order: the block's state
  for (int i = threadIdx.x; i < Q * D; i += ST) {
    const int j = i / D, e = i % D;
    float mt = NEG;
#pragma unroll
    for (int ww = 0; ww < SW; ++ww) mt = fmaxf(mt, sm_m[ww][j]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int ww = 0; ww < SW; ++ww) {
      const float f = expf(sm_m[ww][j] - mt);
      lt = fmaf(sm_l[ww][j], f, lt);
      at = fmaf(sm_acc[ww][j][e], f, at);
    }
    bk_acc[j][e] = at;
    if (e == 0) {
      bk_m[j] = mt;
      bk_l[j] = lt;
    }
  }
  cluster_sync();   // every rank's state is in its shared memory
  // the ranks' states meet in rank order; rank r writes outputs
  // [r * per, (r + 1) * per)
  const int per = (Q * D + nsplit - 1) / nsplit;
  for (int i = threadIdx.x; i < per; i += ST) {
    const int o = rank * per + i;
    if (o < Q * D) {
      const int j = o / D, e = o % D;
      float mr[MAX_SPLIT];
      float mt = NEG;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        mr[r] = r < nsplit ? ld_cluster(&bk_m[j], r) : NEG;
        mt = fmaxf(mt, mr[r]);
      }
      float lt = 0.f, at = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < nsplit) {
          const float f = expf(mr[r] - mt);
          lt = fmaf(ld_cluster(&bk_l[j], r), f, lt);
          at = fmaf(ld_cluster(&bk_acc[j][e], r), f, at);
        }
      }
      a.out[(bh * Q + j) * D + e] = at / (lt == 0.f ? 1.f : lt);
    }
  }
  cluster_sync();   // no block leaves while another reads its state
}

template <typename T, int D, int QN, bool PAGED>
cudaError_t launch(const Args& a, int nsplit, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, a.H, a.B);
  cfg.blockDim = dim3(ST);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nsplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, split_decode_kernel<T, D, QN, PAGED>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D, bool PAGED>
cudaError_t pick_q(const Args& a, int nsplit, cudaStream_t s) {
  return a.Q == 1   ? launch<T, D, 1, PAGED>(a, nsplit, s)
         : a.Q <= 4 ? launch<T, D, 4, PAGED>(a, nsplit, s)
                    : launch<T, D, QMAX, PAGED>(a, nsplit, s);
}

template <typename T, bool PAGED>
cudaError_t pick_d(const Args& a, int D, int nsplit, cudaStream_t s) {
  switch (D) {
    case 16: return pick_q<T, 16, PAGED>(a, nsplit, s);
    case 32: return pick_q<T, 32, PAGED>(a, nsplit, s);
    case 64: return pick_q<T, 64, PAGED>(a, nsplit, s);
    case 128: return pick_q<T, 128, PAGED>(a, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

// the cache's element type
enum Kind { F32 = 0, BF16 = 1, INT8 = 2 };

template <bool PAGED>
cudaError_t dispatch(const Args& a, int D, int kind, int nsplit,
                     cudaStream_t s) {
  if (a.Q < 1 || a.Q > QMAX || nsplit < 1 || nsplit > MAX_SPLIT ||
      a.chunk < 1 || (long long)nsplit * a.chunk < a.S)
    return cudaErrorInvalidValue;
  if (PAGED && (a.ps < 1 || a.nb < 1 || a.P < 1))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch (kind) {
    case F32: return pick_d<float, PAGED>(a, D, nsplit, s);
    case BF16: return pick_d<__nv_bfloat16, PAGED>(a, D, nsplit, s);
    case INT8:
      if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
      return pick_d<signed char, PAGED>(a, D, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split_route

// q: [B, H, Q, D] f32 (q_bf16 = 0) or bf16, element strides q_sb, q_sh,
// q_sj, last dim dense; k, v: [B, H, S, D] bf16 (is_bf16 = 1) or f32,
// contiguous and 16-byte aligned; pos: [B] int32 (pos64 = 0) or int64,
// element stride pos_s; out:
// [B, H, Q, D] f32, contiguous; 1 <= Q <= 8. nsplit (1..8) blocks of
// chunk keys a (b, h), nsplit * chunk >= S. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int decode_attention(const void* q, int q_bf16, long long q_sb,
                                long long q_sh, long long q_sj,
                                const void* k, const void* v, const void* pos,
                                int pos64, long long pos_s, void* out, int B,
                                int H, int S, int Q, int D, int is_bf16,
                                int nsplit, int chunk, float scale,
                                void* stream) {
  const split_route::Args a{q, q_sb, q_sh, q_sj, k, v, nullptr, nullptr,
                            nullptr, pos, pos_s, static_cast<float*>(out),
                            q_bf16, pos64, B, H, S, Q, 0, 1, 1, chunk,
                            scale};
  return (int)split_route::dispatch<false>(a, D, is_bf16, nsplit,
                                           static_cast<cudaStream_t>(stream));
}

// The scaled-int8 cache: k, v int8 codes [B, H, S, D], contiguous and
// 16-byte aligned; ks, vs f32 steps [B, H, S], contiguous; the rest as
// decode_attention.
extern "C" int decode_attention_q8(const void* q, int q_bf16, long long q_sb,
                                   long long q_sh, long long q_sj,
                                   const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* pos, int pos64,
                                   long long pos_s, void* out, int B, int H,
                                   int S, int Q, int D, int nsplit, int chunk,
                                   float scale, void* stream) {
  const split_route::Args a{q, q_sb, q_sh, q_sj, k, v,
                            static_cast<const float*>(ks),
                            static_cast<const float*>(vs), nullptr, pos,
                            pos_s, static_cast<float*>(out), q_bf16, pos64,
                            B, H, S, Q, 0, 1, 1, chunk, scale};
  return (int)split_route::dispatch<false>(a, D, split_route::INT8, nsplit,
                                           static_cast<cudaStream_t>(stream));
}

// The paged pool: k, v [P, H, ps, D] bf16 (is_bf16 = 1) or f32; ptab
// [B, nb] int32 page table, entries in [0, P) (0 is the scratch page);
// ps >= 1 keys a page; the rest as decode_attention, with each row's
// logical length S = nb * ps (nsplit * chunk >= S).
extern "C" int decode_attention_paged(const void* q, int q_bf16,
                                      long long q_sb, long long q_sh,
                                      long long q_sj, const void* k,
                                      const void* v, const void* ptab,
                                      const void* pos, int pos64,
                                      long long pos_s, void* out, int B,
                                      int H, int P, int ps, int nb, int Q,
                                      int D, int is_bf16, int nsplit,
                                      int chunk, float scale, void* stream) {
  const split_route::Args a{q, q_sb, q_sh, q_sj, k, v, nullptr, nullptr,
                            static_cast<const int*>(ptab), pos, pos_s,
                            static_cast<float*>(out), q_bf16, pos64, B, H,
                            nb * ps, Q, P, ps, nb, chunk, scale};
  return (int)split_route::dispatch<true>(a, D, is_bf16, nsplit,
                                          static_cast<cudaStream_t>(stream));
}

// The paged scaled-int8 pool: k, v int8 codes [P, H, ps, D], 16-byte
// aligned; ks, vs f32 steps [P, H, ps]; the rest as decode_attention_paged.
extern "C" int decode_attention_paged_q8(
    const void* q, int q_bf16, long long q_sb, long long q_sh,
    long long q_sj, const void* k, const void* v, const void* ks,
    const void* vs, const void* ptab, const void* pos, int pos64,
    long long pos_s, void* out, int B, int H, int P, int ps, int nb, int Q,
    int D, int nsplit, int chunk, float scale, void* stream) {
  const split_route::Args a{q, q_sb, q_sh, q_sj, k, v,
                            static_cast<const float*>(ks),
                            static_cast<const float*>(vs),
                            static_cast<const int*>(ptab), pos, pos_s,
                            static_cast<float*>(out), q_bf16, pos64, B, H,
                            nb * ps, Q, P, ps, nb, chunk, scale};
  return (int)split_route::dispatch<true>(a, D, split_route::INT8, nsplit,
                                          static_cast<cudaStream_t>(stream));
}
