// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// forward): softmax(scale * Q K^T) V with an online softmax, causal rows
// at the tail of kv (offset kv_len - q_len), ragged q_len and kv_len
// masked here in the kernel (no host padding), optional lse = m + log(l)
// as [bh, sq] f32.  A row that sees no key gets output 0 and lse -inf.
//
// Two routes behind the one entry point, chosen by the dtype code:
//
// bf16: tensor cores (flash_fwd_kernel<__nv_bfloat16, D>, tc:: below).
//   One CTA of 4 warps per (batch*head, q tile).  FlashAttention-2's shape:
//   - Each warp owns MT m16 row tiles (MT = 2 at D = 64, so 128-row CTAs;
//     MT = 1 at D = 128 and 256, 64-row CTAs): each K/V fragment read from
//     shared memory feeds MT products.
//   - Q is copied once with 16-byte cp.async into bf16 shared memory.
//     Rows are stored with their 16-byte chunks XOR-swizzled by (row % 8),
//     so the 8 row addresses of every ldmatrix fall in 8 distinct bank
//     groups.  At D <= 128 each warp keeps its Q A-fragments in registers
//     for the whole loop; at D = 256 it re-reads them with ldmatrix at
//     each k-step, to stay within 255 registers.
//   - K and V tiles go through a 2-stage cp.async ring in bf16
//     (commit_group / wait_group): the copy of tile t+1 is in flight
//     while tile t is computed.  Two __syncthreads per tile.
//   - S = Q K^T with mma.sync.m16n8k16 bf16 -> f32, K fragments from
//     ldmatrix.  The online softmax runs in registers on the accumulator
//     layout (each thread holds 2 rows of each row tile; row max and sum
//     are quad shuffles); each probability is one FFMA and one MUFU.EX2,
//     exp2(scale * log2(e) * (s - m)).  A row with no visible key yet
//     subtracts 0, so the exponent stays finite.
//   - P stays in registers: the f32 C-fragments of two m16n8 tiles,
//     rounded to bf16, are the A-fragment of one m16n8k16 P.V product;
//     V fragments come from ldmatrix.trans.  Rounding P to bf16 is a
//     deviation from the Pallas kernel, which keeps p in f32: it moves
//     each output by at most one bf16 rounding of each softmax weight,
//     2^-9 * max|v|.  l sums the unrounded p.
//   - Causal and ragged masks are applied only on the tiles that touch
//     the diagonal or the ragged kv edge; a warp whose rows see no key of
//     a tile skips it.  Ragged rows are zero-filled by cp.async with
//     src-size 0 and the store is guarded.
//   - Causal launches take q tiles heaviest-first (blockIdx.x reversed),
//     so the CTAs that loop longest do not start last.
//   Tiles: BK = 64 keys at D = 64 and 128, 32 at D = 256.  Shared memory
//   (rows + 4 BK) * D * 2 bytes: 49,152 B at D = 64, 81,920 B at
//   D = 128, 98,304 B at D = 256.
//   The inputs must be 16-byte aligned with (batch, head, row) strides in
//   multiples of 8 elements; the wrapper copies one that is not.
//
// f32: the original scalar kernel (flash_fwd_kernel<float, D>, scalar::
//   below), kept as it was.  On f32 the tensor cores would run TF32, about
//   three decimal digits, which the f32 route's 1e-4 bound and the f32
//   serving path's token-exact replies do not allow.  It stages f32 tiles
//   in shared memory and runs f32 FMAs on the CUDA cores.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16), bf16 causal, d = 64:
// q, k, v read once and o written once.  Serving prefill [1, 12, 1024, 64]:
// 6.29 MB -> 1.88 us; 1.61 GFLOP over the causal triangle -> 1.63 us; so
// bytes, 0.00188 ms.  Training [16, 12, 1024, 64]: 100.7 MB -> 30.05 us;
// 25.8 GFLOP -> 26.1 us; bytes, 0.03005 ms.
//
// What held the scalar kernel back at bf16, and what this design does:
// scalar f32 FMAs with 12 shared loads per 32 FMAs -> mma.sync on the
// tensor cores; P written to and read back from shared memory -> P in
// registers; one 2-byte element per thread per synchronous copy, converted
// to f32 -> 16-byte cp.async copies in bf16, the next tile's in flight
// during this one's math; three __syncthreads per tile -> two; f32 tiles
// (66.5 KB for 64 q rows at d = 64) -> bf16 tiles (48 KB for 128 rows);
// q tiles launched lightest first under causal masking -> heaviest first.
//
// Launch errors: every launch is followed by cudaGetLastError(), whose
// code the entry point returns; the Python wrapper raises on non-zero
// (this is the ctypes route's counterpart of C10_CUDA_KERNEL_LAUNCH_CHECK).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"  // swizzled tiles, cp.async, ldmatrix, mma.sync

namespace {

constexpr int NT = 128;  // threads per CTA, both routes
constexpr int BQ = 64;   // q rows per CTA of the f32 route

// (batch, head, row) element strides of q, k and v
struct Strides {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
};

// ---------------------------------------------------------------- f32 route

namespace scalar {

constexpr int BK = 64;
constexpr int PS = BK + 1;  // row stride of the probability tile

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

constexpr size_t smem_bytes(int d) {
  return (size_t)(3 * BQ * (d + 1) + BQ * PS) * sizeof(float);
}

// Stages Q once, then loops over 64-row K/V tiles staged in shared memory
// (f32, rows padded by one word), stopping at the causal diagonal.  Warp
// w owns q rows [16w, 16w+16); lane l owns 4 rows (l / 8) and 8 key
// columns (l % 8 + 8j); the probabilities go through shared memory to the
// P.V product, where the same lane owns 4 rows x D/8 output columns.
template <int D>
__device__ __forceinline__ void fwd(
    unsigned char* smem_raw, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int q_len,
    int kv_len, const Strides& st, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DN = D / 8;  // output columns per lane
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * BQ;
  const float* qp = q + b * st.qsb + h * st.qsh;
  const float* kp = k + b * st.ksb + h * st.ksh;
  const float* vp = v + b * st.vsb + h * st.vsh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;                           // key/column group
  const int r0 = (tid >> 5) * 16 + (lane >> 3) * 4;  // first of 4 rows

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - (i / D) * D;
    const int gr = q0 + r;
    Qs[r * DP + c] = gr < q_len ? qp[gr * st.qss + c] : 0.f;
  }

  const int off = kv_len - q_len;  // causal diagonal offset
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_col = min(q0 + BQ, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  float m[4], l[4], acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i - (i / D) * D;
      const int gr = k0 + r;
      const bool ok = gr < kv_len;
      Ks[r * DP + c] = ok ? kp[gr * st.kss + c] : 0.f;
      Vs[r * DP + c] = ok ? vp[gr * st.vss + c] : 0.f;
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
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r0 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(cg + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int grow = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gc = k0 + cg + 8 * j;
        const bool ok = gc < kv_len && (!causal || gc <= grow + off);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      // a row with no visible key yet keeps m = -inf; subtracting 0
      // instead keeps exp() finite (exp(-inf) = 0 for the masked scores)
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(r0 + i) * PS + cg + 8 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r0 + i) * PS + j];
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const float vv = Vs[j * DP + cg + 8 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int grow = q0 + r0 + i;
    if (grow >= q_len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key: 0
    float* orow = o + ((long long)bh * q_len + grow) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) orow[cg + 8 * n] = acc[i][n] * inv;
    if (lse != nullptr && cg == 0)
      lse[(long long)bh * q_len + grow] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

}  // namespace scalar

// ------------------------------------------------------- bf16 tensor cores

namespace tc {

template <int D> struct Tile {
  // m16 row tiles per warp: at d = 64 each K/V fragment read from shared
  // memory feeds two products (128-row CTAs); wider heads have no
  // registers for a second tile's accumulators
  static constexpr int MT = D == 64 ? 2 : 1;
  static constexpr int ROWS = 64 * MT;           // q rows per CTA
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per kv tile
  static constexpr bool Q_IN_REGS = D <= 128;    // Q A-fragments kept
};

template <int D> constexpr size_t smem_bytes() {
  return (size_t)(Tile<D>::ROWS + 4 * Tile<D>::BK) * D * sizeof(bf16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ void fwd(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int q_len,
    int kv_len, const Strides& st, float scale, int causal) {
  constexpr int BK = Tile<D>::BK;
  constexpr int MT = Tile<D>::MT;
  constexpr int ROWS = Tile<D>::ROWS;
  constexpr int WR = 16 * MT;    // q rows per warp
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int NS = BK / 8;     // n-tiles of S (8 keys each)
  constexpr int DS = D / 8;      // n-tiles of O (8 columns each)
  constexpr bool Q_IN_REGS = Tile<D>::Q_IN_REGS;
  constexpr float LOG2E = 1.4426950408889634f;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + ROWS * D;    // 2 stages of [BK, D]
  bf16* Vs = Ks + 2 * BK * D;  // 2 stages of [BK, D]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  // causal: heaviest q tile first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * ROWS;
  const bf16* qp = q + b * st.qsb + h * st.qsh;
  const bf16* kp = k + b * st.ksb + h * st.ksh;
  const bf16* vp = v + b * st.vsb + h * st.vsh;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wr = q0 + warp * WR;           // the warp's first row

  const int off = kv_len - q_len;  // causal diagonal offset
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_col = min(q0 + ROWS, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile<D, ROWS>(Qs, qp, st.qss, q0, q_len, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D, BK>(Ks, kp, st.kss, 0, kv_len, tid);
    load_tile<D, BK>(Vs, vp, st.vss, 0, kv_len, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // Q A-fragment of row tile mt, k-step ks: lane l addresses row l % 16
  // and k-half l / 16
  auto q_frag = [&](uint32_t (&a)[4], int mt, int ks) {
    ldmatrix_x4(a, Qs + swz<D>(warp * WR + 16 * mt + (lane & 15),
                               2 * ks + (lane >> 4)));
  };
  uint32_t qf[MT][Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) q_frag(qf[mt][ks], mt, ks);
  }

  float acc[MT][DS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DS; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  // rows g and g + 8 of each row tile; m the running max of the raw
  // scores, l this thread's partial sum (its quad adds them up at the end)
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy, in flight during this one
      const int nxt = (stage ^ 1) * BK * D;
      load_tile<D, BK>(Ks + nxt, kp, st.kss, k0 + BK, kv_len, tid);
      load_tile<D, BK>(Vs + nxt, vp, st.vss, k0 + BK, kv_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    // a warp whose rows all lie before this tile's first key skips it
    if (!causal || k0 <= wr + WR - 1 + off) {
      const bf16* Kt = Ks + stage * BK * D;
      const bf16* Vt = Vs + stage * BK * D;

      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (Q_IN_REGS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][ks][i];
          } else {
            q_frag(a[mt], mt, ks);
          }
        }
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          // keys 16 n2 + [0, 8) then [8, 16); k-half (lane / 8) % 2
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + swz<D>(16 * n2 + (lane & 7) + ((lane >> 4) << 3),
                                      2 * ks + ((lane >> 3) & 1)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * n2], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * n2 + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // mask only a tile that touches the ragged kv edge or this warp's
      // causal diagonal
      if (k0 + BK > kv_len || (causal && k0 + BK - 1 > wr + off)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * n + 2 * t4 + (e & 1);
              const int row = wr + 16 * mt + g + (e >> 1) * 8;
              if (col >= kv_len || (causal && col > row + off))
                s[mt][n][e] = -INFINITY;
            }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NS; ++n)
            mx = fmaxf(mx, fmaxf(s[mt][n][2 * i], s[mt][n][2 * i + 1]));
          const float m_new = fmaxf(m[mt][i], quad_max(mx));
          // a row with no visible key yet keeps m = -inf; subtracting 0
          // instead keeps exp2() finite (exp2(-inf) = 0 for masked scores)
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          const float neg_m = -m_safe * sl2;
          alpha[i] = fast_exp2(fmaf(m[mt][i], sl2, neg_m));
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            s[mt][n][2 * i] = fast_exp2(fmaf(s[mt][n][2 * i], sl2, neg_m));
            s[mt][n][2 * i + 1] =
                fast_exp2(fmaf(s[mt][n][2 * i + 1], sl2, neg_m));
            rs += s[mt][n][2 * i] + s[mt][n][2 * i + 1];
          }
          l[mt][i] = l[mt][i] * alpha[i] + rs;
          m[mt][i] = m_new;
        }
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
      }

      // O += P V: the C-fragments of S tiles 2kk and 2kk+1, in bf16, are
      // the A-fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int d2 = 0; d2 < DS / 2; ++d2) {
          // keys 16 kk + [0, 8) then [8, 16); columns 16 d2 + 8 (lane / 16)
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, Vt + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                              2 * d2 + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * d2], a[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * d2 + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wr + 16 * mt + g + 8 * i;
      const float li = quad_sum(l[mt][i]);
      if (row >= q_len) continue;
      const float inv = li > 0.f ? 1.f / li : 0.f;  // no visible key: 0
      bf16* orow = o + ((long long)bh * q_len + row) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < DS; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(acc[mt][n][2 * i] * inv, acc[mt][n][2 * i + 1] * inv);
      if (lse != nullptr && t4 == 0)
        lse[(long long)bh * q_len + row] =
            li > 0.f ? m[mt][i] * scale + logf(li) : -INFINITY;
    }
}

}  // namespace tc

// q/k/v are [B, H, len, D] with the last dim contiguous and arbitrary
// batch / head / row strides (in elements); o is contiguous [B*H, q_len, D].
// The dtype picks the route; both keep this name, so a profile or ptxas
// report reads flash_fwd_kernel<T, D> for either.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int q_len, int kv_len,
    Strides st, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, float>::value)
    scalar::fwd<D>(smem, q, k, v, o, lse, H, q_len, kv_len, st, scale, causal);
  else
    tc::fwd<D>(smem, q, k, v, o, lse, H, q_len, kv_len, st, scale, causal);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int q_len, int kv_len, const long long* s,
           float scale, int causal, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = f32 ? scalar::smem_bytes(D) : tc::smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
  const int rows = f32 ? BQ : tc::Tile<D>::ROWS;
  dim3 grid((q_len + rows - 1) / rows, B * H);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)o, lse, H, q_len, kv_len, st, scale,
                                   causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int q_len, int kv_len,
             const long long* st, float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, q_len, kv_len, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, q_len, kv_len, st, scale, causal, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, H, q_len, kv_len, st, scale, causal, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor cores; q, k, v
// 16-byte aligned with strides in multiples of 8 elements).  strides: 9
// element strides (batch, head, row) of q, then k, then v.  lse may be
// null.  Returns 0, a cudaError_t code, or -1 for an unsupported dtype /
// head dim.
extern "C" int flash_fwd(int dtype, int d, const void* q, const void* k,
                         const void* v, void* o, float* lse, int B, int H,
                         int q_len, int kv_len, const long long* strides,
                         float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(d, q, k, v, o, lse, B, H, q_len, kv_len, strides, scale, causal, s);
    case 1: return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, B, H, q_len, kv_len, strides, scale, causal, s);
    default: return -1;
  }
}

extern "C" const char* flash_fwd_error_string(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString((cudaError_t)code);
}
