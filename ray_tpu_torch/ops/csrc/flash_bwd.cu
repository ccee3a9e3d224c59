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
// Two routes behind each entry point, chosen by the dtype code, both named
// flash_bwd_kv_kernel<T, D> / flash_bwd_dq_kernel<T, D>:
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
// f32: the original scalar kernels (scalar:: below), kept as they were.
//   On f32 the tensor cores would run TF32, about three decimal digits,
//   which the f32 route's 1e-4 bound does not allow.  Tiles are R rows with
//   R * D = 4096 (R = 64, 32, 16 for D = 64, 128, 256), so every thread
//   keeps 32 f32 accumulators per output whatever the head dim, and shared
//   memory stays under 100 KB (f32 tiles, rows padded by one word against
//   bank conflicts).  Thread t owns rows (t / 8) * R/16 + i of a tile and
//   columns (t % 8) + 8 j.  flash_bwd_kv stages its K and V tiles once,
//   then loops over q tiles from the first that reaches the causal
//   diagonal (the Pallas kernel's `live` test), staging q, do, lse and
//   delta for each; S = q K^T and dP = do V^T share one pass over d; p and
//   ds go through shared memory to the dv / dk products.  flash_bwd_dq
//   stages its q, do, lse and delta once and loops over K/V tiles up to the
//   diagonal; ds goes through shared memory to the dq product.
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

constexpr int NT = 128;  // threads per CTA of the f32 route and of bf16 dq

// (batch, head, row) element strides of q, k, v and do
struct Strides {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
};

// ---------------------------------------------------------------- f32 route

namespace scalar {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and back: the rounding point of p and ds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

template <int D> struct Shape {
  static constexpr int R = 4096 / D;  // tile rows, q and kv alike
  static constexpr int DP = D + 1;    // padded row stride of a [R, D] tile
  static constexpr int PS = R + 1;    // padded row stride of a [R, R] tile
  static constexpr int TR = R / 16;   // rows per thread
  static constexpr int TC = R / 8;    // score columns per thread
  static constexpr int DN = D / 8;    // head-dim columns per thread
};

// Stage rows [r0, r0 + R) of one head of x ([len, D] at row stride rs) into
// the f32 tile dst; rows past len are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* x, long long rs,
                                      int r0, int len) {
  using S = Shape<D>;
  for (int i = threadIdx.x; i < S::R * D; i += NT) {
    const int r = i / D, c = i - (i / D) * D;
    const int gr = r0 + r;
    dst[r * S::DP + c] = gr < len ? to_f(x[gr * rs + c]) : 0.f;
  }
}

// lse and delta of rows [r0, r0 + R) of head bh; rows past len are 0
// (every score of theirs is masked).
__device__ __forceinline__ void stage_rows(float* ls, float* dl,
                                           const float* lse,
                                           const float* delta, long long bh,
                                           int r0, int len, int R) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const int gr = r0 + i;
    ls[i] = gr < len ? lse[bh * len + gr] : 0.f;
    dl[i] = gr < len ? delta[bh * len + gr] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T on this thread's TR x TC scores, then p and
// ds as above.  Qs/Os hold q rows q0.., Ks/Vs hold keys k0...
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* Os,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Dl,
                                       int q0, int k0, int q_len, int kv_len,
                                       float scale, int causal,
                                       float (&p)[Shape<D>::TR][Shape<D>::TC],
                                       float (&ds)[Shape<D>::TR][Shape<D>::TC]) {
  using S = Shape<D>;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  float s[S::TR][S::TC], dp[S::TR][S::TC];
#pragma unroll
  for (int i = 0; i < S::TR; ++i)
#pragma unroll
    for (int j = 0; j < S::TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[S::TR], ov[S::TR], kv[S::TC], vv[S::TC];
#pragma unroll
    for (int i = 0; i < S::TR; ++i) {
      qv[i] = Qs[(rg * S::TR + i) * S::DP + d];
      ov[i] = Os[(rg * S::TR + i) * S::DP + d];
    }
#pragma unroll
    for (int j = 0; j < S::TC; ++j) {
      kv[j] = Ks[(cg + 8 * j) * S::DP + d];
      vv[j] = Vs[(cg + 8 * j) * S::DP + d];
    }
#pragma unroll
    for (int i = 0; i < S::TR; ++i)
#pragma unroll
      for (int j = 0; j < S::TC; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const int off = kv_len - q_len;  // causal diagonal offset
#pragma unroll
  for (int i = 0; i < S::TR; ++i) {
    const int r = rg * S::TR + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < S::TC; ++j) {
      const int col = k0 + cg + 8 * j;
      const bool ok = row < q_len && col < kv_len &&
                      (!causal || col <= row + off);
      p[i][j] = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      ds[i][j] = (p[i][j] * (dp[i][j] - Dl[r])) * scale;
    }
  }
}

template <int D> constexpr size_t smem_kv() {
  using S = Shape<D>;
  return (size_t)(4 * S::R * S::DP + 2 * S::R * S::PS + 2 * S::R) * sizeof(float);
}

template <int D> constexpr size_t smem_dq() {
  using S = Shape<D>;
  return (size_t)(4 * S::R * S::DP + S::R * S::PS + 2 * S::R) * sizeof(float);
}

// q, do are [B, H, q_len, D] and k, v [B, H, kv_len, D], each with its own
// (batch, head, row) strides in elements; lse and delta are contiguous
// [B*H, q_len] f32; dk and dv contiguous [B*H, kv_len, D].
template <typename T, int D>
__device__ __forceinline__ void bwd_kv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int q_len, int kv_len,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::R * S::DP;
  float* Qs = Vs + S::R * S::DP;
  float* Os = Qs + S::R * S::DP;
  float* Ps = Os + S::R * S::DP;  // p rounded to T, [q row][key]
  float* Ss = Ps + S::R * S::PS;  // ds rounded to T
  float* Ls = Ss + S::R * S::PS;
  float* Dl = Ls + S::R;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int k0 = blockIdx.x * S::R;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  stage<T, D>(Ks, k + b * ksb + h * ksh, kss, k0, kv_len);
  stage<T, D>(Vs, v + b * vsb + h * vsh, vss, k0, kv_len);

  // causal: q tiles wholly above the diagonal see none of these keys
  const int off = kv_len - q_len;
  const int first = (causal && k0 - off > 0) ? (k0 - off) / S::R : 0;
  const int nq = (q_len + S::R - 1) / S::R;

  float ak[S::TR][S::DN], av[S::TR][S::DN];
#pragma unroll
  for (int i = 0; i < S::TR; ++i)
#pragma unroll
    for (int n = 0; n < S::DN; ++n) ak[i][n] = av[i][n] = 0.f;

  for (int t = first; t < nq; ++t) {
    const int q0 = t * S::R;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Qs, q + b * qsb + h * qsh, qss, q0, q_len);
    stage<T, D>(Os, dout + b * osb + h * osh, oss, q0, q_len);
    stage_rows(Ls, Dl, lse, delta, bh, q0, q_len, S::R);
    __syncthreads();

    float p[S::TR][S::TC], ds[S::TR][S::TC];
    scores<D>(Qs, Os, Ks, Vs, Ls, Dl, q0, k0, q_len, kv_len, scale, causal,
              p, ds);
#pragma unroll
    for (int i = 0; i < S::TR; ++i)
#pragma unroll
      for (int j = 0; j < S::TC; ++j) {
        const int idx = (rg * S::TR + i) * S::PS + cg + 8 * j;
        Ps[idx] = round_to<T>(p[i][j]);
        Ss[idx] = round_to<T>(ds[i][j]);
      }
    __syncthreads();

    // this thread's keys are rows rg * TR + i of the kv tile
#pragma unroll 2
    for (int r = 0; r < S::R; ++r) {
      float pv[S::TR], sv[S::TR];
#pragma unroll
      for (int i = 0; i < S::TR; ++i) {
        pv[i] = Ps[r * S::PS + rg * S::TR + i];
        sv[i] = Ss[r * S::PS + rg * S::TR + i];
      }
#pragma unroll
      for (int n = 0; n < S::DN; ++n) {
        const float ov = Os[r * S::DP + cg + 8 * n];
        const float qv = Qs[r * S::DP + cg + 8 * n];
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          av[i][n] = fmaf(pv[i], ov, av[i][n]);
          ak[i][n] = fmaf(sv[i], qv, ak[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < S::TR; ++i) {
    const int row = k0 + rg * S::TR + i;
    if (row >= kv_len) continue;
    const long long base = ((long long)bh * kv_len + row) * D;
#pragma unroll
    for (int n = 0; n < S::DN; ++n) {
      dk[base + cg + 8 * n] = from_f<T>(ak[i][n]);
      dv[base + cg + 8 * n] = from_f<T>(av[i][n]);
    }
  }
}

// Same layouts as bwd_kv; dq is contiguous [B*H, q_len, D].
template <typename T, int D>
__device__ __forceinline__ void bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int q_len, int kv_len, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + S::R * S::DP;
  float* Ks = Os + S::R * S::DP;
  float* Vs = Ks + S::R * S::DP;
  float* Ss = Vs + S::R * S::DP;  // ds rounded to T, [q row][key]
  float* Ls = Ss + S::R * S::PS;
  float* Dl = Ls + S::R;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * S::R;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  stage<T, D>(Qs, q + b * qsb + h * qsh, qss, q0, q_len);
  stage<T, D>(Os, dout + b * osb + h * osh, oss, q0, q_len);
  stage_rows(Ls, Dl, lse, delta, bh, q0, q_len, S::R);

  // causal: kv tiles wholly above the diagonal contribute nothing
  const int off = kv_len - q_len;
  int n_tiles = (kv_len + S::R - 1) / S::R;
  if (causal) {
    const int last_col = min(q0 + S::R, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / S::R + 1);
  }

  float aq[S::TR][S::DN];
#pragma unroll
  for (int i = 0; i < S::TR; ++i)
#pragma unroll
    for (int n = 0; n < S::DN; ++n) aq[i][n] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * S::R;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Ks, k + b * ksb + h * ksh, kss, k0, kv_len);
    stage<T, D>(Vs, v + b * vsb + h * vsh, vss, k0, kv_len);
    __syncthreads();

    float p[S::TR][S::TC], ds[S::TR][S::TC];
    scores<D>(Qs, Os, Ks, Vs, Ls, Dl, q0, k0, q_len, kv_len, scale, causal,
              p, ds);
#pragma unroll
    for (int i = 0; i < S::TR; ++i)
#pragma unroll
      for (int j = 0; j < S::TC; ++j)
        Ss[(rg * S::TR + i) * S::PS + cg + 8 * j] = round_to<T>(ds[i][j]);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < S::R; ++c) {
      float sv[S::TR];
#pragma unroll
      for (int i = 0; i < S::TR; ++i) sv[i] = Ss[(rg * S::TR + i) * S::PS + c];
#pragma unroll
      for (int n = 0; n < S::DN; ++n) {
        const float kv = Ks[c * S::DP + cg + 8 * n];
#pragma unroll
        for (int i = 0; i < S::TR; ++i) aq[i][n] = fmaf(sv[i], kv, aq[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < S::TR; ++i) {
    const int row = q0 + rg * S::TR + i;
    if (row >= q_len) continue;
    const long long base = ((long long)bh * q_len + row) * D;
#pragma unroll
    for (int n = 0; n < S::DN; ++n) dq[base + cg + 8 * n] = from_f<T>(aq[i][n]);
  }
}

}  // namespace scalar

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

template <typename T> constexpr bool is_f32 = std::is_same<T, float>::value;

// threads per CTA of flash_bwd_kv at head dim d: the bf16 route splits
// the head dim of dK and dV over more warps at d >= 128 (one template
// argument, so the __launch_bounds__ macro sees no comma)
template <typename T> __host__ __device__ constexpr int kv_threads(int d) {
  return is_f32<T> ? NT : 4 * 32 * tc::kv_dsplit(d);
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
  if constexpr (is_f32<T>) {
    scalar::bwd_kv<T, D>(q, k, v, dout, lse, delta, dk, dv, H, q_len, kv_len,
                         qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
                         osh, oss, scale, causal);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Strides st{qsb, qsh, qss, ksb, ksh, kss,
                     vsb, vsh, vss, osb, osh, oss};
    tc::bwd_kv<D>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, q_len,
                  kv_len, st, scale, causal);
  }
}

// Same layouts as flash_bwd_kv_kernel; dq is contiguous [B*H, q_len, D].
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int q_len,
    int kv_len, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal) {
  if constexpr (is_f32<T>) {
    scalar::bwd_dq<T, D>(q, k, v, dout, lse, delta, dq, H, q_len, kv_len,
                         qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
                         osh, oss, scale, causal);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Strides st{qsb, qsh, qss, ksb, ksh, kss,
                     vsb, vsh, vss, osb, osh, oss};
    tc::bwd_dq<D>(smem_raw, q, k, v, dout, lse, delta, dq, H, q_len, kv_len,
                  st, scale, causal);
  }
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
  return is_f32<T> ? scalar::smem_kv<D>() : tc::smem_kv<D>();
}

template <typename T, int D> constexpr size_t smem_dq() {
  return is_f32<T> ? scalar::smem_dq<D>() : tc::smem_dq<D>();
}

template <typename T, int D>
int launch_kv(const Args& a, void* dk, void* dv) {
  auto kern = flash_bwd_kv_kernel<T, D>;
  const size_t smem = smem_kv<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* st = a.st;
  const int rows = is_f32<T> ? scalar::Shape<D>::R : tc::KvTile<D>::BKV;
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
  const int rows = is_f32<T> ? scalar::Shape<D>::R : tc::DqTile<D>::ROWS;
  dim3 grid((a.q_len + rows - 1) / rows, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
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

// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor cores; q, k, v,
// do 16-byte aligned with strides in multiples of 8 elements).  strides:
// 12 element strides (batch, head, row) of q, then k, v and do.  Returns
// 0, a cudaError_t code, or -1 for an unsupported dtype / head dim.
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
