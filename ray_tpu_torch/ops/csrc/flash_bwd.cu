// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU backward pair of ray_tpu/ops/flash_attention.py:
// _bwd_kv_kernel (dk, dv) and _bwd_dq_kernel (dq), with the shared
// recompute of _recompute_p_ds.  For each (q row, key) pair both kernels
// recompute
//     p  = exp(scale * q.k - lse)                  (f32)
//     ds = (p * (do.v - delta)) * scale            (f32)
// from the forward's saved lse and delta = rowsum(do * o) (a torch
// reduction in the wrapper, as the JAX package computes it outside its
// kernels).  p and ds are rounded to the input dtype before they enter the
// products, as the Pallas kernels do (p.astype(q.dtype), ds.astype(...)),
// and the products accumulate in f32:
//     flash_bwd_kv:  dv += p^T do,  dk += ds^T q    (one CTA per kv tile)
//     flash_bwd_dq:  dq += ds k                     (one CTA per q tile)
// Keeping the two passes apart, like the reference, needs no atomics, so
// the gradients are deterministic.  Ragged lengths are masked here, not
// padded on the host: rows past q_len and keys past kv_len are zero-filled
// while staging and get p = 0.  A row with no visible key (lse = -inf) has
// every key masked; its p is chosen 0 by a select, never multiplied by a
// mask (exp(-inf + inf) would be NaN).  q, k, v and do arrive with
// arbitrary (batch, head, row) strides and a contiguous head dim.
//
// Two routes behind each entry point, both on the tensor cores, chosen by
// the dtype code, both named flash_bwd_kv_kernel<T, D> /
// flash_bwd_dq_kernel<T, D>:
//
// bf16: tensor cores (tc:: below), the forward's machinery (tc.cuh):
//   mma.sync m16n8k16 bf16 -> f32 with ldmatrix / ldmatrix.trans from
//   XOR-swizzled bf16 tiles, filled by 16-byte cp.async copies in a
//   2-stage ring (two __syncthreads per tile), f32 C-fragments repacked in
//   registers as bf16 A-fragments.  That repacking is the reference's own
//   rounding of p and ds to bf16.  Scores and probabilities never touch
//   shared memory.
//   flash_bwd_kv: one CTA per 64-key tile, warp w owning keys
//     16 (w % 4) + [0, 16) and, at d >= 128, half of the head dim of dK and
//     dV (8 warps; the pair sharing 16 keys both compute S^T and dP^T, so
//     the accumulators fit in registers).  K and V are copied once (at
//     d = 64 their A-fragments stay in registers; wider heads re-read them
//     with ldmatrix).  The loop over q tiles, from the first that reaches
//     the causal diagonal, computes the TRANSPOSED scores with the key as
//     the m dimension: S^T = K Q^T and dP^T = V dO^T (Q and dO as B through
//     plain ldmatrix); then P^T = exp2(S^T scale log2e - lse log2e) and
//     dS^T = P^T (dP^T - delta) scale, where lse and delta belong to the
//     C-fragment's columns and are read from the staged per-tile vectors.
//     P^T and dS^T in bf16 are directly the A-fragments of dV += P^T dO and
//     dK += dS^T Q (dO and Q as B through ldmatrix.trans).  Kv tiles run in
//     blockIdx.x order, lowest keys first: under causal masking they see
//     the most q rows, so the longest CTAs start first.
//   flash_bwd_dq: one CTA of 4 warps per 64 q rows, the forward's layout:
//     Q and dO A-fragments in registers at d <= 128 (re-read at d = 256),
//     each thread's two rows of lse and delta read once; K and V tiles
//     through the ring up to the causal diagonal; S = Q K^T and dP = dO V^T
//     (K, V as B through plain ldmatrix), P and dS as above, and dS in bf16
//     as the A-fragment of dQ += dS K (K through ldmatrix.trans).  Causal
//     q tiles run heaviest first (blockIdx.x reversed).
//   Masks are applied only on tiles that touch the causal diagonal or a
//   ragged edge; a tile is fully visible only if its SMALLEST row sees its
//   largest key, so a tile holding a key-less row always takes the masked
//   branch.  A warp whose rows and keys do not meet in a tile skips it.
//   Tiles: flash_bwd_kv 64 keys a CTA and 64 q rows a ring stage (32 at
//   d = 256); flash_bwd_dq 64 q rows a CTA and 64 keys a stage (32 at
//   d >= 128).  Shared memory at d = 64 / 128 / 256: flash_bwd_kv 50,176 /
//   99,328 / 131,584 B, flash_bwd_dq 49,152 / 65,536 / 131,072 B.
//   The inputs must be 16-byte aligned with (batch, head, row) strides in
//   multiples of 8 elements; the wrapper copies one that is not.
//
// f32: tensor cores too (tf32x3:: below), every f32 operand split into two
//   TF32 values and each product taken as three TF32 products, which keeps
//   f32's accuracy; the note at the top of tf32x3:: gives the design, its
//   error, its bound and what held the scalar kernels it replaces back.
//
// Bound at the training shape [16, 12, 1024, 64] bf16 causal, per launch
// (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16): flash_bwd_kv reads q, do, k, v
// (4 x 25.2 MB) plus lse and delta (2 x 0.79 MB) and writes dk, dv
// (2 x 25.2 MB), 152.6 MB -> 45.5 us; its four products over the causal
// triangle are 8 * 192 * (1024 * 1025 / 2) * 64 = 51.6 GFLOP -> 52.2 us,
// so operations bound it.  flash_bwd_dq moves 127.4 MB (38.0 us) and does
// three products, 38.7 GFLOP (39.1 us).
//
// What held the scalar kernels back at bf16, and what the tensor-core
// route does: scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak), about
// 2.7 FMAs per shared-memory load -> mma.sync on the tensor cores; p and
// ds written to and read back from f32 shared memory between the products
// (three __syncthreads per tile) -> C-fragments repacked as A-fragments in
// registers (two __syncthreads per tile, for the ring); one 2-byte element
// per thread per synchronous copy, converted to f32 -> 16-byte cp.async
// copies in bf16, the next tile's in flight during this one's math.
// wgmma, TMA and warp specialisation are later work.
//
// Launch errors: each entry point returns cudaGetLastError() after its
// launch (or -1 for an unsupported dtype / head dim); the Python wrapper
// raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"  // swizzled tiles, cp.async, ldmatrix, mma.sync

namespace {

constexpr int NT = 128;  // threads per CTA of the bf16 flash_bwd_dq

// (batch, head, row) element strides of q, k, v and do
struct Strides {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
};

// ------------------------------------------------------- bf16 tensor cores

namespace tc {

constexpr float LOG2E = 1.4426950408889634f;

// 4-byte async copy (one f32); src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// warps sharing one 16-key row tile of flash_bwd_kv, each with d / DSPLIT
// columns of dK and dV: one warp holds both accumulators of 16 keys only
// at d = 64
__host__ __device__ constexpr int kv_dsplit(int d) {
  return d == 64 ? 1 : 2;
}

template <int D> struct KvTile {
  static constexpr int DSPLIT = kv_dsplit(D);
  static constexpr int WARPS = 4 * DSPLIT;
  static constexpr int BKV = 64;                 // keys per CTA
  static constexpr int BQ = D == 256 ? 32 : 64;  // q rows per ring stage
  static constexpr bool KV_IN_REGS = D == 64;    // K, V A-fragments kept
};

template <int D> struct DqTile {
  static constexpr int ROWS = 64;                // q rows per CTA
  static constexpr int BK = D == 64 ? 64 : 32;   // keys per ring stage
  static constexpr bool QO_IN_REGS = D <= 128;   // Q, dO A-fragments kept
};

// [BKV, D] K and V, 2 stages of [BQ, D] Q and dO, 2 stages of [BQ] lse
// and delta
template <int D> constexpr size_t smem_kv() {
  using K = KvTile<D>;
  return (size_t)(2 * K::BKV + 4 * K::BQ) * D * sizeof(bf16) +
         4 * K::BQ * sizeof(float);
}

// [ROWS, D] Q and dO, 2 stages of [BK, D] K and V
template <int D> constexpr size_t smem_dq() {
  return (size_t)(2 * DqTile<D>::ROWS + 4 * DqTile<D>::BK) * D * sizeof(bf16);
}

template <int D>
__device__ __forceinline__ void bwd_kv(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int q_len, int kv_len, const Strides& st,
    float scale, int causal) {
  using K = KvTile<D>;
  constexpr int BKV = K::BKV, BQ = K::BQ;
  constexpr int THREADS = 32 * K::WARPS;
  constexpr int KS = D / 16;            // k-steps of K.Q^T over the head dim
  constexpr int NQ = BQ / 8;            // n-tiles of S^T (8 q rows each)
  constexpr int DN = D / K::DSPLIT / 8; // n-tiles of this warp's dK / dV
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * D;
  bf16* Qs = Vs + BKV * D;     // 2 stages of [BQ, D]
  bf16* Os = Qs + 2 * BQ * D;  // 2 stages of [BQ, D]
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * D);  // 2 stages of [BQ]
  float* Dl = Ls + 2 * BQ;                                // 2 stages of [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int k0 = blockIdx.x * BKV;
  const bf16* qp = q + b * st.qsb + h * st.qsh;
  const bf16* kp = k + b * st.ksb + h * st.ksh;
  const bf16* vp = v + b * st.vsb + h * st.vsh;
  const bf16* op = dout + b * st.osb + h * st.osh;
  const float* lp = lse + (long long)bh * q_len;
  const float* dp = delta + (long long)bh * q_len;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wk = 16 * (warp & 3);          // the warp's first key in the tile
  const int key0 = k0 + wk;
  const int dc = (warp >> 2) * (8 * DN);   // its first dK / dV column

  // causal: q tiles wholly above the diagonal see none of these keys
  const int off = kv_len - q_len;
  const int first = (causal && k0 - off > 0) ? (k0 - off) / BQ : 0;
  const int nq = (q_len + BQ - 1) / BQ;

  // q tile t into ring stage s: Q and dO rows, lse and delta (f32, 4-byte
  // copies: a head's rows need not start 16-byte aligned); rows at or past
  // q_len are zero-filled
  auto load_q = [&](int t, int s) {
    const int q0 = t * BQ;
    load_tile<D, BQ, THREADS>(Qs + s * BQ * D, qp, st.qss, q0, q_len, tid);
    load_tile<D, BQ, THREADS>(Os + s * BQ * D, op, st.oss, q0, q_len, tid);
    for (int i = tid; i < 2 * BQ; i += THREADS) {
      const int r = i % BQ;
      const bool ok = q0 + r < q_len;
      const float* src = i < BQ ? lp : dp;
      cp_async4((i < BQ ? Ls : Dl) + s * BQ + r, ok ? src + q0 + r : src,
                ok ? 4 : 0);
    }
  };

  load_tile<D, BKV, THREADS>(Ks, kp, st.kss, k0, kv_len, tid);
  load_tile<D, BKV, THREADS>(Vs, vp, st.vss, k0, kv_len, tid);
  cp_async_commit();
  if (first < nq) load_q(first, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();

  // K or V A-fragment of k-step ks: lane l addresses key wk + l % 16 and
  // k-half l / 16
  auto kv_frag = [&](uint32_t (&a)[4], const bf16* X, int ks) {
    ldmatrix_x4(a, X + swz<D>(wk + (lane & 15), 2 * ks + (lane >> 4)));
  };
  uint32_t kf[K::KV_IN_REGS ? KS : 1][4], vf[K::KV_IN_REGS ? KS : 1][4];
  if constexpr (K::KV_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      kv_frag(kf[ks], Ks, ks);
      kv_frag(vf[ks], Vs, ks);
    }
  }

  float adk[DN][4], adv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int t = first; t < nq; ++t) {
    const int q0 = t * BQ;
    const int stage = (t - first) & 1;
    if (t + 1 < nq) load_q(t + 1, stage ^ 1);  // in flight during this tile
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    // a warp whose keys all lie past this tile's last row's diagonal
    // skips it
    if (!causal || key0 <= q0 + BQ - 1 + off) {
      const bf16* Qt = Qs + stage * BQ * D;
      const bf16* Ot = Os + stage * BQ * D;
      const float* Lt = Ls + stage * BQ;
      const float* Dt = Dl + stage * BQ;

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns q rows
      float s[NQ][4], p[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        if constexpr (K::KV_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[ks][i];
            av[i] = vf[ks][i];
          }
        } else {
          kv_frag(ak, Ks, ks);
          kv_frag(av, Vs, ks);
        }
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          // q rows 16 n2 + [0, 8) then [8, 16); k-half (lane / 8) % 2
          const int r = 16 * n2 + (lane & 7) + ((lane >> 4) << 3);
          const int c = 2 * ks + ((lane >> 3) & 1);
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, Qt + swz<D>(r, c));
          ldmatrix_x4(bo, Ot + swz<D>(r, c));
          mma_bf16(s[2 * n2], ak, bq[0], bq[1]);
          mma_bf16(s[2 * n2 + 1], ak, bq[2], bq[3]);
          mma_bf16(p[2 * n2], av, bo[0], bo[1]);
          mma_bf16(p[2 * n2 + 1], av, bo[2], bo[3]);
        }
      }

      // P^T into s, dS^T into p.  Element e of n-tile n is key
      // key0 + g + 8 (e / 2) and q row q0 + 8 n + 2 t4 + e % 2, whose lse
      // and delta sit in the staged vectors.  Fully visible: every row
      // exists and the tile's smallest row sees its largest key
      const bool full = q0 + BQ <= q_len && key0 + 16 <= kv_len &&
                        (!causal || key0 + 15 <= q0 + off);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float pe = fast_exp2(fmaf(s[n][e], sl2, -lv * LOG2E));
          if (!full) {
            const int row = q0 + 8 * n + 2 * t4 + (e & 1);
            const int key = key0 + g + 8 * (e >> 1);
            const bool ok = row < q_len && key < kv_len &&
                            (!causal || key <= row + off);
            pe = ok ? pe : 0.f;  // a select: pe may be +inf (lse -inf)
          }
          s[n][e] = pe;
          p[n][e] = (pe * (p[n][e] - dl)) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the C-fragments of n-tiles 2kk and
      // 2kk+1, in bf16, are the A-fragments of k-step kk (16 q rows)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4];
        ap[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        ap[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        ap[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ap[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        as[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        as[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        as[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        as[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int d2 = 0; d2 < DN / 2; ++d2) {
          // q rows 16 kk + [0, 8) then [8, 16); columns dc + 16 d2 +
          // 8 (lane / 16)
          const int r = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int c = dc / 8 + 2 * d2 + (lane >> 4);
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, Ot + swz<D>(r, c));
          ldmatrix_x4_trans(bq, Qt + swz<D>(r, c));
          mma_bf16(adv[2 * d2], ap, bo[0], bo[1]);
          mma_bf16(adv[2 * d2 + 1], ap, bo[2], bo[3]);
          mma_bf16(adk[2 * d2], as, bq[0], bq[1]);
          mma_bf16(adk[2 * d2 + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= kv_len) continue;
    const long long base = ((long long)bh * kv_len + key) * D + dc + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + 8 * n) =
          pack_bf16(adk[n][2 * i], adk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * n) =
          pack_bf16(adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void bwd_dq(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H,
    int q_len, int kv_len, const Strides& st, float scale, int causal) {
  using Q = DqTile<D>;
  constexpr int ROWS = Q::ROWS, BK = Q::BK;
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NS = BK / 8;  // n-tiles of S (8 keys each)
  constexpr int DS = D / 8;   // n-tiles of dQ (8 columns each)
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + ROWS * D;
  bf16* Ks = Os + ROWS * D;    // 2 stages of [BK, D]
  bf16* Vs = Ks + 2 * BK * D;  // 2 stages of [BK, D]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  // causal: heaviest q tile first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * ROWS;
  const bf16* qp = q + b * st.qsb + h * st.qsh;
  const bf16* kp = k + b * st.ksb + h * st.ksh;
  const bf16* vp = v + b * st.vsb + h * st.vsh;
  const bf16* op = dout + b * st.osb + h * st.osh;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wr = q0 + 16 * warp;           // the warp's first row

  // causal: kv tiles wholly above the diagonal contribute nothing
  const int off = kv_len - q_len;
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_col = min(q0 + ROWS, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile<D, ROWS>(Qs, qp, st.qss, q0, q_len, tid);
  load_tile<D, ROWS>(Os, op, st.oss, q0, q_len, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D, BK>(Ks, kp, st.kss, 0, kv_len, tid);
    load_tile<D, BK>(Vs, vp, st.vss, 0, kv_len, tid);
  }
  cp_async_commit();

  // rows g and g + 8: -lse log2(e) (+inf for a row without keys, whose
  // pairs are all masked) and delta; rows past q_len get 0
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    const bool ok = row < q_len;
    nl[i] = ok ? -lse[(long long)bh * q_len + row] * LOG2E : 0.f;
    dl[i] = ok ? delta[(long long)bh * q_len + row] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  // Q or dO A-fragment of k-step ks: lane l addresses row l % 16 of the
  // warp's rows and k-half l / 16
  auto qo_frag = [&](uint32_t (&a)[4], const bf16* X, int ks) {
    ldmatrix_x4(a, X + swz<D>(16 * warp + (lane & 15), 2 * ks + (lane >> 4)));
  };
  uint32_t qf[Q::QO_IN_REGS ? KS : 1][4], of[Q::QO_IN_REGS ? KS : 1][4];
  if constexpr (Q::QO_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qo_frag(qf[ks], Qs, ks);
      qo_frag(of[ks], Os, ks);
    }
  }

  float acc[DS][4];
#pragma unroll
  for (int n = 0; n < DS; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
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
    if (!causal || k0 <= wr + 15 + off) {
      const bf16* Kt = Ks + stage * BK * D;
      const bf16* Vt = Vs + stage * BK * D;

      // S = Q K^T and dP = dO V^T
      float s[NS][4], p[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t aq[4], ao[4];
        if constexpr (Q::QO_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[ks][i];
            ao[i] = of[ks][i];
          }
        } else {
          qo_frag(aq, Qs, ks);
          qo_frag(ao, Os, ks);
        }
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          // keys 16 n2 + [0, 8) then [8, 16); k-half (lane / 8) % 2
          const int r = 16 * n2 + (lane & 7) + ((lane >> 4) << 3);
          const int c = 2 * ks + ((lane >> 3) & 1);
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, Kt + swz<D>(r, c));
          ldmatrix_x4(bv, Vt + swz<D>(r, c));
          mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
          mma_bf16(p[2 * n2], ao, bv[0], bv[1]);
          mma_bf16(p[2 * n2 + 1], ao, bv[2], bv[3]);
        }
      }

      // dS into p.  Element e of n-tile n is row wr + g + 8 (e / 2) and
      // key k0 + 8 n + 2 t4 + e % 2.  Fully visible: every row exists and
      // the warp's smallest row sees the tile's largest key
      const bool full = k0 + BK <= kv_len && wr + 16 <= q_len &&
                        (!causal || k0 + BK - 1 <= wr + off);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pe = fast_exp2(fmaf(s[n][e], sl2, nl[i]));
          if (!full) {
            const int row = wr + g + 8 * i;
            const int col = k0 + 8 * n + 2 * t4 + (e & 1);
            const bool ok = row < q_len && col < kv_len &&
                            (!causal || col <= row + off);
            pe = ok ? pe : 0.f;  // a select: pe may be +inf (lse -inf)
          }
          p[n][e] = (pe * (p[n][e] - dl[i])) * scale;
        }

      // dQ += dS K: the C-fragments of n-tiles 2kk and 2kk+1, in bf16,
      // are the A-fragment of k-step kk (16 keys)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int d2 = 0; d2 < DS / 2; ++d2) {
          // keys 16 kk + [0, 8) then [8, 16); columns 16 d2 + 8 (lane / 16)
          uint32_t bk[4];
          ldmatrix_x4_trans(
              bk, Kt + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                              2 * d2 + (lane >> 4)));
          mma_bf16(acc[2 * d2], a, bk[0], bk[1]);
          mma_bf16(acc[2 * d2 + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    if (row >= q_len) continue;
    bf16* drow = dq + ((long long)bh * q_len + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DS; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

}  // namespace tc

// ------------------------------------------------ f32 on the tensor cores
//
// Replaces the f32 use of _bwd_kv_kernel and _bwd_dq_kernel, which keep
// q, k, v, do, p and ds in f32 and accumulate in f32.  Same functions as
// the bf16 route above, in f32 in and out, with p and ds kept in f32.
//
// The split (CUTLASS's 3xTF32), as in flash_fwd.cu's f32 route: each f32
// operand x becomes hi = rna(x) and lo = rna(x - hi), and a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi on mma.sync m16n8k8 TF32 -> f32, with
// an error of a few f32 roundings a term.  Every product runs this way:
// S^T and dP^T (or S and dP), and the gradient products with p and ds
// split like any other operand.  dp - delta cancels, so one TF32 product
// for S or dP (about 1e-3 of each operand) would put that error into
// every ds; only the split keeps the 1e-4 bound.  The tensor core
// truncates each sum it forms, so the products of S and dP go into fresh
// accumulators, four k-steps (32 dims) each, added to the scores with
// round-to-nearest, and each tile's gradient products into fresh ones
// (a group of 4 or 8 n-tiles at a time) added to the running dK, dV or
// dQ, which sum over up to a thousand q rows or keys.  Longer fresh sums
// take fewer adds and err more; four k-steps keep the error of q and k
// scaled by 4 (logits beyond +-90) a small part of the bound (PERF.md).
// The exponent is (s scale - lse) log2(e), one rounding of a difference,
// never s scale log2(e) - lse log2(e), whose rounding of lse log2(e)
// grows with |lse|.
//
// Layout.  Both kernels run 8 warps; a warp owns 16 keys (kv) or 16 q rows
// (dq) and 64 columns of the gradients it accumulates, the d / 64 warps
// sharing 16 keys or rows each computing the scores whole.
//   - The stationary operands (K and V in flash_bwd_kv, Q and dO in
//     flash_bwd_dq: 8192 / d rows a CTA) are read from device memory and
//     split once into shared memory; the streamed ones (Q, dO or K, V:
//     2048 / d rows a tile) arrive raw through a 2-stage ring of 16-byte
//     cp.async copies and are split once a tile, both tiles at once, half
//     the CTA each.  No warp splits what it reads, except p and ds, which
//     come out of its own accumulators.
//   - Split tiles are laid out so that every fragment is one load a plane
//     (hi and lo planes apart) straight into the registers mma.sync takes,
//     with no bank conflict (see "Split tiles" below): the A-fragments of
//     the score products in 16-byte loads, the B-fragments in 8-byte
//     loads.  A fragment gathered from (hi, lo) pairs side by side cost a
//     register move for each value.
//   - The score product uses the fragments' own k order; the gradient
//     products take p and ds from the score's C-fragments as they lie,
//     under tc.cuh's relabelling of k (slot t4 <- row 2 t4, slot t4 + 4 <-
//     2 t4 + 1), which the gradient layout's row pairs follow.
//   - flash_bwd_kv: 8192 / d keys a CTA (128 at d = 64), q tiles of
//     2048 / d rows from the first that reaches the causal diagonal:
//     S^T = K Q^T, dP^T = V dO^T with the key as m, P^T =
//     2^((S^T scale - lse) log2 e), dS^T = P^T (dP^T - delta) scale,
//     dV += P^T dO, dK += dS^T Q.  Kv tiles run lowest keys first.
//   - flash_bwd_dq: 8192 / d q rows a CTA, K and V tiles of 2048 / d keys
//     up to the causal diagonal: S = Q K^T, dP = dO V^T, P and dS as
//     above, dQ += dS K.  Causal q tiles run heaviest first.
//   - Both mask only tiles that touch the diagonal or a ragged edge and
//     choose p = 0 by a select (exp2 of a key-less row's +inf is never
//     kept); a warp whose keys and rows do not meet in a tile skips it.
//     Two __syncthreads a tile: the ring's stage has landed, the split is
//     done.
// Shared memory at d = 64, 128 and 256: flash_bwd_kv 230,144 / 229,760 /
// 229,568 B, flash_bwd_dq 212,992 B, one CTA an SM.  The inputs must be
// 16-byte aligned with (batch, head, row) strides in multiples of 4
// elements; the wrapper copies one that is not.
//
// Bound.  f32-accurate products cost three TF32 products, so the least
// time this card can take is max(bytes / 3.35 TB/s, 3 x FLOP / 495
// TFLOP/s).  At [16, 12, 1024, 64] f32 causal: flash_bwd_kv 303.6 MB ->
// 0.0906 ms, 51.59 GFLOP x 3 -> 0.3127 ms; flash_bwd_dq 253.2 MB ->
// 0.0756 ms, 38.69 GFLOP x 3 -> 0.2345 ms; operations bound both (on the
// CUDA cores' 67 TFLOP/s the same FLOPs would take 0.7700 / 0.5775 ms).
// mma.sync does not reach the dense TF32 rate, which takes wgmma.
//
// What held the scalar kernels this replaces back, and what this design
// does about each: f32 FMAs on the CUDA cores, which alone need 2.5x the
// split's bound -> mma.sync TF32 products, three a multiply-add;
// synchronous one-element copies with no copy in flight -> 16-byte
// cp.async copies, the next tile's in flight during this one's math; p and
// ds through shared memory between the products, three __syncthreads a
// tile -> C-fragments reused in registers as A-fragments, two
// __syncthreads; causal dq tiles lightest first -> heaviest first.

namespace tf32x3 {

using namespace tc;  // cp.async, the split, mma_tf32x3_n, ex2

// Tiles.  Both kernels run 8 warps; a warp owns 16 keys (kv) or 16 q rows
// (dq) and 64 columns of the gradients it accumulates, the warps sharing
// 16 keys or rows (d / 64 of them) each computing the scores whole.  The
// stationary operands (K and V in kv, Q and dO in dq) fill 128 KB split,
// so a CTA takes 8192 / d of them; the streamed tiles take 2048 / d rows.
constexpr int THREADS = 256;

template <int D> struct Tile {
  static constexpr int ROWS = 8192 / D;    // keys (kv) or q rows (dq) a CTA
  static constexpr int BS = 2048 / D;      // rows a ring stage
  static constexpr int RG = ROWS / 16;     // groups of 16 keys or rows
  static constexpr int NS = BS / 8;        // n-tiles of the scores
  static constexpr int KF = 4;             // k-steps a fresh score sum takes
};

// shared memory: the stationary operands split ([ROWS, D] hi and lo
// planes each), the streamed ones split (kv: Q and dO, each in the score
// and the gradient layouts; dq: K in both, V in the score layout), 2
// stages of their raw [BS, D] rows, and in kv 2 stages of [BS] lse and
// delta and this tile's
template <int D> constexpr size_t smem_kv() {
  using T = Tile<D>;
  return (size_t)(2 * 2 * T::ROWS * D + 4 * 2 * T::BS * D +
                  2 * 2 * T::BS * D + 6 * T::BS) * sizeof(float);
}
template <int D> constexpr size_t smem_dq() {
  using T = Tile<D>;
  return (size_t)(2 * 2 * T::ROWS * D + 3 * 2 * T::BS * D +
                  2 * 2 * T::BS * D) * sizeof(float);
}

// Split tiles: a hi plane followed by a lo plane of R x D floats, each in
// one of three layouts chosen so that every fragment is one load a plane
// straight into the registers mma.sync takes, and the 16 lanes of each
// half-warp (8 of each quarter-warp for 16-byte loads) hit distinct banks.
//  - score layout (B of S^T, dP^T, S, dP: row 8 n + g, dims 8 ks + t4
//    and + 4): columns c and c + 4 side by side, one 8-byte load; groups
//    of 8 columns XOR-swizzled by the row's low 2 bits;
//  - gradient layout (B of dV, dK, dQ: rows 8 kk + 2 t4 and + 1, column
//    8 n + g): rows 2 m and 2 m + 1 side by side, one 8-byte load;
//    columns' bits 2 and 3 flipped by m % 4;
//  - A layout (K, V in kv; Q, dO in dq: rows g and g + 8 of a 16-row
//    block, dims t4 and t4 + 4): those four side by side, one 16-byte
//    load; groups of 8 columns swapped in pairs for odd g.
template <int D> __device__ __forceinline__ int at_s(int r, int c) {
  return r * D + 8 * ((c >> 3) ^ (r & 3)) + 2 * (c & 3) + ((c >> 2) & 1);
}
template <int D> __device__ __forceinline__ int at_g(int r, int c) {
  return (r >> 1) * 2 * D + 2 * (c ^ (((r >> 1) & 3) << 2)) + (r & 1);
}
template <int D> __device__ __forceinline__ int at_a(int r, int c) {
  const int g = r & 7;
  return (((r >> 4) * 8 + g) * (D / 8) + ((c >> 3) ^ (g & 1))) * 16 +
         4 * (c & 3) + 2 * ((c >> 2) & 1) + ((r >> 3) & 1);
}

// four f32 values split into four hi (h) and four lo (l) TF32 values
__device__ __forceinline__ void split4(const float4& x, float4& h,
                                       float4& l) {
  uint32_t hi, lo;
  split_tf32(x.x, hi, lo);
  h.x = __uint_as_float(hi), l.x = __uint_as_float(lo);
  split_tf32(x.y, hi, lo);
  h.y = __uint_as_float(hi), l.y = __uint_as_float(lo);
  split_tf32(x.z, hi, lo);
  h.z = __uint_as_float(hi), l.z = __uint_as_float(lo);
  split_tf32(x.w, hi, lo);
  h.w = __uint_as_float(hi), l.w = __uint_as_float(lo);
}

// Split a raw [R, D] tile in shared memory (rows D floats apart) into the
// score layout (if s) and the gradient layout (if gl), half the CTA's
// threads (i their index among them) sharing units of rows 2 m and
// 2 m + 1 by 8 columns: two 16-byte loads a row, two 16-byte stores a
// plane and layout row (or row pair).  The two tiles of a stage are split
// at once, one by each half.
template <int D, int R>
__device__ __forceinline__ void split_tile(float* s, float* gl,
                                           const float* src, int i) {
  constexpr int CG = D / 8, PLANE = R * D;
#pragma unroll
  for (; i < R / 2 * CG; i += THREADS / 2) {
    const int m = i / CG, c = 8 * (i % CG);
    float4 h[2][2], l[2][2];  // [row 2 m + k][columns c + 4 j ..]
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split4(*reinterpret_cast<const float4*>(src + (2 * m + k) * D + c +
                                                4 * j),
               h[k][j], l[k][j]);
    if (s != nullptr) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float4* d = reinterpret_cast<float4*>(s + at_s<D>(2 * m + k, c));
        d[0] = make_float4(h[k][0].x, h[k][1].x, h[k][0].y, h[k][1].y);
        d[1] = make_float4(h[k][0].z, h[k][1].z, h[k][0].w, h[k][1].w);
        d = reinterpret_cast<float4*>(s + PLANE + at_s<D>(2 * m + k, c));
        d[0] = make_float4(l[k][0].x, l[k][1].x, l[k][0].y, l[k][1].y);
        d[1] = make_float4(l[k][0].z, l[k][1].z, l[k][0].w, l[k][1].w);
      }
    }
    if (gl != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4* d = reinterpret_cast<float4*>(gl + at_g<D>(2 * m, c + 4 * j));
        d[0] = make_float4(h[0][j].x, h[1][j].x, h[0][j].y, h[1][j].y);
        d[1] = make_float4(h[0][j].z, h[1][j].z, h[0][j].w, h[1][j].w);
        d = reinterpret_cast<float4*>(gl + PLANE + at_g<D>(2 * m, c + 4 * j));
        d[0] = make_float4(l[0][j].x, l[1][j].x, l[0][j].y, l[1][j].y);
        d[1] = make_float4(l[0][j].z, l[1][j].z, l[0][j].w, l[1][j].w);
      }
    }
  }
}

// Split rows [row0, row0 + R) of one head (D floats each) from device
// memory into the A layout; rows at or past limit are zero.  A unit is
// rows g and g + 8 of a 16-row block by 8 columns: four 16-byte loads,
// four 16-byte stores a plane.
template <int D, int R>
__device__ __forceinline__ void split_rows_a(float* a, const float* src,
                                             long long row_stride, int row0,
                                             int limit, int tid) {
  constexpr int CG = D / 8, PLANE = R * D;
#pragma unroll 2
  for (int i = tid; i < R / 2 * CG; i += THREADS) {
    const int u = i / CG, c = 8 * (i % CG);
    const int r = 16 * (u >> 3) + (u & 7);  // rows r and r + 8
    float4 h[2][2], l[2][2];                // [row r + 8 k][columns c + 4 j ..]
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r + 8 * k < limit)
          x = *reinterpret_cast<const float4*>(
              src + (row0 + r + 8 * k) * row_stride + c + 4 * j);
        split4(x, h[k][j], l[k][j]);
      }
    float4* d = reinterpret_cast<float4*>(a + at_a<D>(r, c));
    d[0] = make_float4(h[0][0].x, h[1][0].x, h[0][1].x, h[1][1].x);
    d[1] = make_float4(h[0][0].y, h[1][0].y, h[0][1].y, h[1][1].y);
    d[2] = make_float4(h[0][0].z, h[1][0].z, h[0][1].z, h[1][1].z);
    d[3] = make_float4(h[0][0].w, h[1][0].w, h[0][1].w, h[1][1].w);
    d = reinterpret_cast<float4*>(a + PLANE + at_a<D>(r, c));
    d[0] = make_float4(l[0][0].x, l[1][0].x, l[0][1].x, l[1][1].x);
    d[1] = make_float4(l[0][0].y, l[1][0].y, l[0][1].y, l[1][1].y);
    d[2] = make_float4(l[0][0].z, l[1][0].z, l[0][1].z, l[1][1].z);
    d[3] = make_float4(l[0][0].w, l[1][0].w, l[0][1].w, l[1][1].w);
  }
}

// Where a lane's fragments lie, as offsets into a plane that leave only
// compile-time constants to add: the swizzles depend on g and t4 and on
// the low bits of the k-step or n-tile, so each layout needs a few.
template <int D> struct Lanes {
  int s[4];  // score layout, row g, dims 2 t4 .. of k-step ks: s[ks % 4]
  int a[2];  // A layout, the warp's 16-row block: a[ks % 2]
  int gr[2]; // gradient layout, rows 2 t4, 2 t4 + 1, column c0 + 8 n + g:
             // gr[n % 2]
  __device__ __forceinline__ Lanes(int g, int t4, int r0, int c0) {
#pragma unroll
    for (int b = 0; b < 4; ++b) s[b] = at_s<D>(g, 8 * b + t4);
#pragma unroll
    for (int b = 0; b < 2; ++b) a[b] = at_a<D>(r0 + g, 8 * b + t4);
#pragma unroll
    for (int b = 0; b < 2; ++b) gr[b] = at_g<D>(2 * t4, c0 + 8 * b + g);
  }
  // offset of the score layout's pair for n-tile n, k-step ks
  __device__ __forceinline__ int score(int n, int ks) const {
    return 8 * n * D + 32 * (ks >> 2) + s[ks & 3];
  }
  __device__ __forceinline__ int afrag(int ks) const {
    return 32 * (ks >> 1) + a[ks & 1];
  }
  // offset of the gradient layout's pair for k-step kk, n-tile n
  __device__ __forceinline__ int grad(int kk, int n) const {
    return 8 * kk * D + 32 * (n >> 1) + gr[n & 1];
  }
};

template <typename T> __device__ __forceinline__ const T& ld(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

// acc[n] += A X^T over k-steps ks0 .. ks0 + KF - 1 for N n-tiles: A's
// split fragments from the A layout tile Ax, X in the score layout.  The
// products go into fresh accumulators added with round-to-nearest: the
// tensor core truncates each sum it forms, which against the running
// scores of large logits would cost several times f32's rounding
template <int D, int N, int KF, int PA, int PX>
__device__ __forceinline__ void score_step(float (&acc)[N][4],
                                           const float* Ax, const float* X,
                                           const Lanes<D>& ln, int ks0) {
  float c[N][4] = {};
#pragma unroll
  for (int ks = ks0; ks < ks0 + KF; ++ks) {
    const uint4 ah = ld<uint4>(Ax + ln.afrag(ks));
    const uint4 al = ld<uint4>(Ax + PA + ln.afrag(ks));
    const uint32_t a_hi[4] = {ah.x, ah.y, ah.z, ah.w};
    const uint32_t a_lo[4] = {al.x, al.y, al.z, al.w};
    uint32_t b_hi[N][2], b_lo[N][2];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint2 h = ld<uint2>(X + ln.score(n, ks));
      const uint2 l = ld<uint2>(X + PX + ln.score(n, ks));
      b_hi[n][0] = h.x, b_hi[n][1] = h.y;
      b_lo[n][0] = l.x, b_lo[n][1] = l.y;
    }
    mma_tf32x3_n<N>(c, a_hi, a_lo, b_hi, b_lo);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[n][e];
}

// acc[n] += C X over the N k-steps of 8 rows of C (N C-fragments, p or
// ds, split here into A-fragments: slot t4 of k-step n takes column 2 t4
// of C-tile n, slot t4 + 4 column 2 t4 + 1, which is where the gradient
// layout puts X's rows) for 8 n-tiles (64 columns), DG n-tiles at a time
// in fresh accumulators folded into acc with round-to-nearest
template <int D, int N, int DG, int PX>
__device__ __forceinline__ void grad_product(float (&acc)[8][4],
                                             const float (&cf)[N][4],
                                             const float* X,
                                             const Lanes<D>& ln) {
  uint32_t a_hi[N][4], a_lo[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(cf[n][0], a_hi[n][0], a_lo[n][0]);  // row g, column 2 t4
    split_tf32(cf[n][2], a_hi[n][1], a_lo[n][1]);  // row g + 8
    split_tf32(cf[n][1], a_hi[n][2], a_lo[n][2]);  // row g, column 2 t4 + 1
    split_tf32(cf[n][3], a_hi[n][3], a_lo[n][3]);  // row g + 8
  }
#pragma unroll
  for (int d0 = 0; d0 < 8; d0 += DG) {
    float c[DG][4] = {};
#pragma unroll
    for (int kk = 0; kk < N; ++kk) {
      uint32_t b_hi[DG][2], b_lo[DG][2];
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const uint2 h = ld<uint2>(X + ln.grad(kk, d0 + j));
        const uint2 l = ld<uint2>(X + PX + ln.grad(kk, d0 + j));
        b_hi[j][0] = h.x, b_hi[j][1] = h.y;
        b_lo[j][0] = l.x, b_lo[j][1] = l.y;
      }
      mma_tf32x3_n<DG>(c, a_hi[kk], a_lo[kk], b_hi, b_lo);
    }
#pragma unroll
    for (int j = 0; j < DG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + j][e] += c[j][e];
  }
}

// P = 2^((s scale - lse) log2 e) in place for the C-fragments of N
// n-tiles; lse(n, e) and visible(n, e) give each element's lse and
// whether its pair is seen (asked only where full is false); a masked p
// is chosen 0 by a select, as exp2 of a key-less row's +inf must not be
// kept
template <int N, typename L, typename V>
__device__ __forceinline__ void probabilities(float (&s)[N][4], float scale,
                                             bool full, L lse, V visible) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = fast_exp2(fmaf(s[n][e], scale, -lse(n, e)) * LOG2E);
      s[n][e] = full || visible(n, e) ? pe : 0.f;
    }
}

template <int D>
__device__ __forceinline__ void bwd_kv(
    unsigned char* smem_raw, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int q_len, int kv_len, const Strides& st,
    float scale, int causal) {
  using T = Tile<D>;
  constexpr int BKV = T::ROWS, BQ = T::BS, NQ = T::NS;
  constexpr int PA = BKV * D, PX = BQ * D;  // plane sizes
  float* Ka = reinterpret_cast<float*>(smem_raw);  // A layout [BKV, D]
  float* Va = Ka + 2 * PA;
  float* Qs = Va + 2 * PA;      // score layout [BQ, D]
  float* Os = Qs + 2 * PX;
  float* Qg = Os + 2 * PX;      // gradient layout [BQ, D]
  float* Og = Qg + 2 * PX;
  float* Qr = Og + 2 * PX;      // 2 stages of raw [BQ, D]
  float* Or = Qr + 2 * PX;
  float* Lr = Or + 2 * PX;      // 2 stages of [BQ] lse
  float* Dr = Lr + 2 * BQ;      // 2 stages of [BQ] delta
  float* Lx = Dr + 2 * BQ;      // this tile's [BQ] lse and delta
  float* Dx = Lx + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int k0 = blockIdx.x * BKV;
  const float* qp = q + b * st.qsb + h * st.qsh;
  const float* op = dout + b * st.osb + h * st.osh;
  const float* lp = lse + (long long)bh * q_len;
  const float* dp = delta + (long long)bh * q_len;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wk = 16 * (warp % T::RG);      // the warp's first key in the tile
  const int key0 = k0 + wk;
  const int dc = 64 * (warp / T::RG);      // its first dK / dV column
  const Lanes<D> ln(g, t4, wk, dc);

  // causal: q tiles wholly above the diagonal see none of these keys
  const int off = kv_len - q_len;
  const int first = (causal && k0 - off > 0) ? (k0 - off) / BQ : 0;
  const int nq = (q_len + BQ - 1) / BQ;

  // q tile t into ring stage s: Q and dO rows, lse and delta (4-byte
  // copies: a head's rows need not start 16-byte aligned); rows at or past
  // q_len are zero-filled
  auto load_q = [&](int t, int s) {
    const int q0 = t * BQ;
    load_tile_f32<D, BQ, D, THREADS>(Qr + s * PX, qp, st.qss, q0, q_len, tid);
    load_tile_f32<D, BQ, D, THREADS>(Or + s * PX, op, st.oss, q0, q_len, tid);
    for (int i = tid; i < 2 * BQ; i += THREADS) {
      const int r = i % BQ;
      const bool ok = q0 + r < q_len;
      const float* src = i < BQ ? lp : dp;
      cp_async4((i < BQ ? Lr : Dr) + s * BQ + r, ok ? src + q0 + r : src,
                ok ? 4 : 0);
    }
  };

  // the first q tile's copy in flight while K and V are split
  if (first < nq) load_q(first, 0);
  cp_async_commit();
  split_rows_a<D, BKV>(Ka, k + b * st.ksb + h * st.ksh, st.kss, k0, kv_len,
                       tid);
  split_rows_a<D, BKV>(Va, v + b * st.vsb + h * st.vsh, st.vss, k0, kv_len,
                       tid);

  float adk[8][4] = {}, adv[8][4] = {};

  for (int t = first; t < nq; ++t) {
    const int q0 = t * BQ;
    const int stage = (t - first) & 1;
    if (t + 1 < nq) load_q(t + 1, stage ^ 1);  // in flight during this tile
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();     // ... for every thread; the last tile's readers
                         // are done with the split tiles, Lx and Dx
    if (tid < THREADS / 2)
      split_tile<D, BQ>(Qs, Qg, Qr + stage * PX, tid);
    else
      split_tile<D, BQ>(Os, Og, Or + stage * PX, tid - THREADS / 2);
    for (int i = tid; i < BQ; i += THREADS) {
      Lx[i] = Lr[stage * BQ + i];
      Dx[i] = Dr[stage * BQ + i];
    }
    __syncthreads();

    // a warp whose keys all lie past this tile's last row's diagonal
    // skips it
    if (causal && key0 > q0 + BQ - 1 + off) continue;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns q rows;
    // element e of n-tile n is key key0 + g + 8 (e / 2) and q row
    // q0 + 8 n + 2 t4 + e % 2
    float s[NQ][4] = {}, p[NQ][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ks += T::KF) {
      score_step<D, NQ, T::KF, PA, PX>(s, Ka, Qs, ln, ks);
      score_step<D, NQ, T::KF, PA, PX>(p, Va, Os, ln, ks);
    }
    // P^T into s; fully visible: every row exists and the tile's smallest
    // row sees the warp's largest key
    const bool full = q0 + BQ <= q_len && key0 + 16 <= kv_len &&
                      (!causal || key0 + 15 <= q0 + off);
    probabilities<NQ>(
        s, scale, full,
        [&](int n, int e) { return Lx[8 * n + 2 * t4 + (e & 1)]; },
        [&](int n, int e) {
          const int row = q0 + 8 * n + 2 * t4 + (e & 1);
          const int key = key0 + g + 8 * (e >> 1);
          return row < q_len && key < kv_len && (!causal || key <= row + off);
        });
    // dS^T = P^T (dP^T - delta) scale into p; dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = (s[n][e] * (p[n][e] - Dx[8 * n + 2 * t4 + (e & 1)])) * scale;
    grad_product<D, NQ, 4, PX>(adv, s, Og, ln);
    grad_product<D, NQ, 4, PX>(adk, p, Qg, ln);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= kv_len) continue;
    const long long base = ((long long)bh * kv_len + key) * D + dc + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(dk + base + 8 * n) =
          make_float2(adk[n][2 * i], adk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + base + 8 * n) =
          make_float2(adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void bwd_dq(
    unsigned char* smem_raw, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H,
    int q_len, int kv_len, const Strides& st, float scale, int causal) {
  using T = Tile<D>;
  constexpr int ROWS = T::ROWS, BK = T::BS, NS = T::NS;
  constexpr int PA = ROWS * D, PX = BK * D;  // plane sizes
  float* Qa = reinterpret_cast<float*>(smem_raw);  // A layout [ROWS, D]
  float* Oa = Qa + 2 * PA;
  float* Ks = Oa + 2 * PA;      // score layout [BK, D]
  float* Vs = Ks + 2 * PX;
  float* Kg = Vs + 2 * PX;      // gradient layout [BK, D]
  float* Kr = Kg + 2 * PX;      // 2 stages of raw [BK, D]
  float* Vr = Kr + 2 * PX;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  // causal: heaviest q tile first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * ROWS;
  const float* kp = k + b * st.ksb + h * st.ksh;
  const float* vp = v + b * st.vsb + h * st.vsh;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wq = 16 * (warp % T::RG);      // the warp's first row in the tile
  const int wr = q0 + wq;
  const int dc = 64 * (warp / T::RG);      // its first dQ column
  const Lanes<D> ln(g, t4, wq, dc);

  // causal: kv tiles wholly above the diagonal contribute nothing
  const int off = kv_len - q_len;
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_col = min(q0 + ROWS, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  auto load_kv = [&](int t, int s) {
    load_tile_f32<D, BK, D, THREADS>(Kr + s * PX, kp, st.kss, t * BK, kv_len,
                                     tid);
    load_tile_f32<D, BK, D, THREADS>(Vr + s * PX, vp, st.vss, t * BK, kv_len,
                                     tid);
  };
  // the first kv tile's copy in flight while Q and dO are split
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  split_rows_a<D, ROWS>(Qa, q + b * st.qsb + h * st.qsh, st.qss, q0, q_len,
                        tid);
  split_rows_a<D, ROWS>(Oa, dout + b * st.osb + h * st.osh, st.oss, q0,
                        q_len, tid);

  // rows g and g + 8: lse (-inf for a row without keys, whose pairs are
  // all masked) and delta; rows past q_len get 0
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    const bool ok = row < q_len;
    ls[i] = ok ? lse[(long long)bh * q_len + row] : 0.f;
    dl[i] = ok ? delta[(long long)bh * q_len + row] : 0.f;
  }

  float acc[8][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();     // ... for every thread; the last tile's readers
                         // are done with the split tiles
    if (tid < THREADS / 2)
      split_tile<D, BK>(Ks, Kg, Kr + stage * PX, tid);
    else
      split_tile<D, BK>(Vs, nullptr, Vr + stage * PX, tid - THREADS / 2);
    __syncthreads();

    // a warp whose rows all lie before this tile's first key skips it
    if (causal && k0 > wr + 15 + off) continue;

    // S = Q K^T and dP = dO V^T; element e of n-tile n is row
    // wr + g + 8 (e / 2) and key k0 + 8 n + 2 t4 + e % 2
    float s[NS][4] = {}, p[NS][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 8; ks += T::KF) {
      score_step<D, NS, T::KF, PA, PX>(s, Qa, Ks, ln, ks);
      score_step<D, NS, T::KF, PA, PX>(p, Oa, Vs, ln, ks);
    }
    // P into s; fully visible: every row exists and the warp's smallest
    // row sees the tile's largest key
    const bool full = k0 + BK <= kv_len && wr + 16 <= q_len &&
                      (!causal || k0 + BK - 1 <= wr + off);
    probabilities<NS>(
        s, scale, full, [&](int, int e) { return ls[e >> 1]; },
        [&](int n, int e) {
          const int row = wr + g + 8 * (e >> 1);
          const int col = k0 + 8 * n + 2 * t4 + (e & 1);
          return row < q_len && col < kv_len && (!causal || col <= row + off);
        });
    // dS = P (dP - delta) scale into p; dQ += dS K
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = (s[n][e] * (p[n][e] - dl[e >> 1])) * scale;
    grad_product<D, NS, 8, PX>(acc, p, Kg, ln);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    if (row >= q_len) continue;
    float* drow = dq + ((long long)bh * q_len + row) * D + dc + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

}  // namespace tf32x3

template <typename T> constexpr bool is_f32 = std::is_same<T, float>::value;

// threads per CTA of flash_bwd_kv at head dim d: both routes split the
// head dim of dK and dV over more warps at d >= 128 (one template
// argument, so the __launch_bounds__ macro sees no comma)
template <typename T> __host__ __device__ constexpr int kv_threads(int d) {
  return is_f32<T> ? tf32x3::THREADS : 4 * 32 * tc::kv_dsplit(d);
}

// q, do are [B, H, q_len, D] and k, v [B, H, kv_len, D], each with its own
// (batch, head, row) strides in elements; lse and delta are contiguous
// [B*H, q_len] f32; dk and dv contiguous [B*H, kv_len, D].  The dtype
// picks the route; both keep this name.
template <typename T, int D>
__global__ void __launch_bounds__(kv_threads<T>(D)) flash_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int q_len, int kv_len, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  if constexpr (is_f32<T>)
    tf32x3::bwd_kv<D>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, q_len,
                      kv_len, st, scale, causal);
  else
    tc::bwd_kv<D>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, q_len,
                  kv_len, st, scale, causal);
}

// threads per CTA of flash_bwd_dq at head dim d
template <typename T> __host__ __device__ constexpr int dq_threads(int d) {
  return is_f32<T> ? tf32x3::THREADS : NT;
}

// Same layouts as flash_bwd_kv_kernel; dq is contiguous [B*H, q_len, D].
template <typename T, int D>
__global__ void __launch_bounds__(dq_threads<T>(D)) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int q_len,
    int kv_len, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  if constexpr (is_f32<T>)
    tf32x3::bwd_dq<D>(smem_raw, q, k, v, dout, lse, delta, dq, H, q_len,
                      kv_len, st, scale, causal);
  else
    tc::bwd_dq<D>(smem_raw, q, k, v, dout, lse, delta, dq, H, q_len, kv_len,
                  st, scale, causal);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, q_len, kv_len;
  const long long* st;  // 12 strides: (batch, head, row) of q, k, v, do
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D> constexpr size_t smem_kv() {
  return is_f32<T> ? tf32x3::smem_kv<D>() : tc::smem_kv<D>();
}

template <typename T, int D> constexpr size_t smem_dq() {
  return is_f32<T> ? tf32x3::smem_dq<D>() : tc::smem_dq<D>();
}

template <typename T, int D>
int launch_kv(const Args& a, void* dk, void* dv) {
  auto kern = flash_bwd_kv_kernel<T, D>;
  const size_t smem = smem_kv<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* st = a.st;
  const int rows = is_f32<T> ? tf32x3::Tile<D>::ROWS : tc::KvTile<D>::BKV;
  dim3 grid((a.kv_len + rows - 1) / rows, a.B * a.H);
  kern<<<grid, kv_threads<T>(D), smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)dk, (T*)dv, a.H, a.q_len, a.kv_len, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = smem_dq<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* st = a.st;
  const int rows = is_f32<T> ? tf32x3::Tile<D>::ROWS : tc::DqTile<D>::ROWS;
  dim3 grid((a.q_len + rows - 1) / rows, a.B * a.H);
  kern<<<grid, dq_threads<T>(D), smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)dq, a.H, a.q_len, a.kv_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int kv_d(int d, const Args& a, void* dk, void* dv) {
  switch (d) {
    case 64: return launch_kv<T, 64>(a, dk, dv);
    case 128: return launch_kv<T, 128>(a, dk, dv);
    case 256: return launch_kv<T, 256>(a, dk, dv);
    default: return -1;
  }
}

template <typename T>
int dq_d(int d, const Args& a, void* dq) {
  switch (d) {
    case 64: return launch_dq<T, 64>(a, dq);
    case 128: return launch_dq<T, 128>(a, dq);
    case 256: return launch_dq<T, 256>(a, dq);
    default: return -1;
  }
}

template <typename T> int smem_d(int kernel, int d) {
  switch (d) {
    case 64: return (int)(kernel == 0 ? smem_kv<T, 64>() : smem_dq<T, 64>());
    case 128: return (int)(kernel == 0 ? smem_kv<T, 128>() : smem_dq<T, 128>());
    case 256: return (int)(kernel == 0 ? smem_kv<T, 256>() : smem_dq<T, 256>());
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, both on tensor cores; q, k, v and do
// 16-byte aligned with strides in multiples of 16 bytes (4 f32 or 8 bf16
// elements).  strides: 12 element strides (batch, head, row) of q, then
// k, v and do.  Returns 0, a cudaError_t code, or -1 for an unsupported
// dtype / head dim.
extern "C" int flash_bwd_kv(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int B, int H, int q_len, int kv_len,
                            const long long* strides, float scale,
                            int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, B, H, q_len, kv_len, strides,
               scale, causal, (cudaStream_t)stream};
  switch (dtype) {
    case 0: return kv_d<float>(d, a, dk, dv);
    case 1: return kv_d<__nv_bfloat16>(d, a, dk, dv);
    default: return -1;
  }
}

extern "C" int flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            int B, int H, int q_len, int kv_len,
                            const long long* strides, float scale,
                            int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, B, H, q_len, kv_len, strides,
               scale, causal, (cudaStream_t)stream};
  switch (dtype) {
    case 0: return dq_d<float>(d, a, dq);
    case 1: return dq_d<__nv_bfloat16>(d, a, dq);
    default: return -1;
  }
}

// Dynamic shared memory per CTA (bytes) of flash_bwd_kv (kernel 0) or
// flash_bwd_dq (kernel 1) of the f32 route, or of the bf16 route (kernel
// 2: flash_bwd_kv, 3: flash_bwd_dq), at head dim d; -1 for an unsupported
// kernel or d.
extern "C" int flash_bwd_smem_bytes(int kernel, int d) {
  switch (kernel) {
    case 0: case 1: return smem_d<float>(kernel, d);
    case 2: case 3: return smem_d<__nv_bfloat16>(kernel - 2, d);
    default: return -1;
  }
}

extern "C" const char* flash_bwd_error_string(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString((cudaError_t)code);
}
