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
// f32: tensor cores too (flash_fwd_kernel<float, D>, tf32x3:: below), with
//   every f32 operand split into two TF32 values and each product taken as
//   three TF32 products, which keeps f32's accuracy; the note at the top of
//   tf32x3:: gives the design, its error and its bound.
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

// (batch, head, row) element strides of q, k and v
struct Strides {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
};

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

// ------------------------------------------------ f32 on the tensor cores
//
// Replaces the f32 use of ray_tpu/ops/flash_attention.py:_fwd_kernel, which
// keeps q, k, v and p in f32 and accumulates in f32.  Same function as the
// bf16 route above, in f32 in and out.
//
// The split (CUTLASS's 3xTF32).  TF32 keeps 10 of f32's 23 mantissa bits,
// so one TF32 product is off by up to 2^-10 of each operand, about three
// decimal digits: too coarse for the f32 route's 1e-4 bound and the f32
// serving path's token-exact replies.  So each f32 operand x becomes
// hi = rna(x) and lo = rna(x - hi) (cvt.rna, round to nearest with ties
// away from zero; x - hi is exact in f32), with x = hi + lo + e,
// |e| <= 2^-22 |x|, and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated in f32 by the tensor core.  Each TF32 x TF32 product is exact
// in f32; what is lost is a_lo b_lo and the two e's, each at most 2^-22 of
// |ab|, a few f32 roundings: the split's error is that of an f32 dot
// product with a few times f32's rounding per term.  The conversion is
// explicit: the tensor core given a raw f32 register drops its low 13
// bits, and truncation doubles the error of each split.  Both products,
// S = Q K^T and O = alpha O + P V, run this way; the probabilities are
// split like any other operand, and l sums the unsplit p.  The route is
// f32-accurate by design and reads no TF32 switch of torch's.
// Three more choices keep it so where the logits are large (|s| ~ 100,
// where an f32 ulp of a score is ~1e-5):
//   - the tensor core truncates each sum it forms, so each k-step's three
//     products of S go into a fresh accumulator that is added to the
//     scores with round-to-nearest, and each tile's P V into a fresh one
//     folded into O by one FFMA with alpha; a running accumulator would
//     take a truncation against its whole size at every product;
//   - the weights are 2^((s - m) scale log2 e): the row's largest score
//     gives exactly 1 and alpha is exactly 1 while m holds, where a fused
//     s sl2 - m sl2 leaves the rounding of m sl2 in every weight and
//     compounds it through alpha tile after tile;
//   - 2^x is ex2.approx.ftz (the instruction behind exp2f, within 2 ulp,
//     about 2.4e-7 relative; results below 2^-126 flush to 0, far below the
//     row's largest weight of 1).
//
// Layout.  One CTA of 4 warps per (batch*head, 32 q rows): two m16 row
// tiles, each shared by two warps that take the two halves of every kv
// tile, each with its own online softmax; at the end the second warp of a
// pair hands its (m, l, O) to the first through shared memory, which
// merges them as two more tiles.  A warp's sweep is a chain of dependent
// loads, splits and products that its one scheduler cannot hide, and the
// heaviest CTA's chain sets the time: halving each warp's keys halves that
// chain, and 32-row CTAs (two an SM) spread a causal sweep over twice the
// warps.  Q, K and V tiles are f32 in shared memory, filled by
// 16-byte cp.async copies, K and V through a 2-stage ring (the copy of
// tile t+1 in flight while tile t is computed; two __syncthreads a tile).
// Fragments come from plain shared loads on padded rows, no ldmatrix
// (whose .trans form moves 16-bit elements only):
//   - S = Q K^T, m16n8k8 k-steps of 8 dims.  The reduction order within a
//     step is free, so slot t4 takes dim 2 t4 and slot t4 + 4 dim 2 t4 + 1,
//     in both Q's A-fragment and K's B-fragment: each row's pair is one
//     8-byte load.  Q and K rows are D + 8 floats apart, so the 16 lanes of
//     each half-warp read 16 distinct 8-byte bank pairs.  Q is split once:
//     at D = 64 its hi/lo A-fragments (64 registers) stay in registers for
//     the whole sweep; at D = 128 and 256 they are re-read from shared
//     memory and split at each k-step.
//   - P V, m16n8k8 k-steps of 8 keys.  P stays in registers: S's
//     C-fragment holds keys (2 t4, 2 t4 + 1) of rows g and g + 8, and is
//     the A-fragment of the step as it lies when key 2 t4 takes slot t4 and
//     key 2 t4 + 1 slot t4 + 4 (the sum over keys does not depend on their
//     order); V's B-fragment reads its rows in that order (b0 row 2 t4, b1
//     row 2 t4 + 1, column g), so no shuffle is needed.  V rows are D + 4
//     floats apart, so those 4-byte reads fall in 32 distinct banks.
//   - Each of the three rounds of products runs over several n-tiles
//     before the next round starts (S: the warp's WK / 8 key n-tiles; P V:
//     4 of O's n-tiles at a time, with the tile's P split in registers,
//     8 NS of them), so consecutive products do not wait on each other;
//     the fresh accumulators of P V take 16 registers, not another O.
//   - The online softmax runs in registers on the accumulator layout, as
//     in the bf16 route (quad shuffles for a row's max and sum).
//   - Causal and ragged masks only on keys that touch the diagonal or the
//     ragged kv edge; a warp whose rows see none of its keys of a tile
//     skips them;
//     causal launches take q tiles heaviest-first (blockIdx.x reversed).
// Tiles: BK = 64 keys at D = 64 (32 a warp), 32 at D = 128 and 256 (16 a
// warp).  Shared memory (32 (D + 8) + 2 BK (2 D + 12)) * 4 bytes: 80,896 B
// at D = 64, 86,016 B at D = 128 (two CTAs an SM), 167,936 B at D = 256.
// The inputs must be 16-byte aligned with (batch, head, row) strides in
// multiples of 4 elements; the wrapper copies one that is not.
//
// Bound.  f32-accurate products cost three TF32 products, so the least
// time this card can take is max(bytes / 3.35 TB/s, 3 x FLOP / 495 TFLOP/s)
// (dense TF32 rate).  Serving prefill [1, 12, 1024, 64] causal: 12.6 MB ->
// 0.00376 ms; 1.612 GFLOP x 3 -> 0.00977 ms; so operations, 0.00977 ms
// (on the CUDA cores' 67 TFLOP/s the same FLOPs would take 0.02406 ms).
//
// What held the scalar kernel this replaces back, and what this design
// does about each: f32 FMAs on the CUDA cores (12 shared loads per 32
// FMAs) -> mma.sync TF32 products on the tensor cores, three per
// multiply-add; P written to and read back from shared memory -> P in
// registers; synchronous one-element copies -> 16-byte cp.async copies,
// the next tile's in flight during this one's math; three __syncthreads a
// tile -> two; q tiles launched lightest-first under causal masking ->
// heaviest-first.

namespace tf32x3 {

using namespace tc;  // cp.async, the split, mma_tf32x3, quad shuffles, ex2

template <int D> struct Tile {
  static constexpr int ROWS = 32;               // q rows per CTA: 2 x m16
  static constexpr int BK = D == 64 ? 64 : 32;  // keys per kv tile
  static constexpr int WK = BK / 2;             // keys per warp in a tile
  static constexpr int QS = D + 8;              // row stride of Q, K tiles
  static constexpr int VS = D + 4;              // row stride of V tiles
  static constexpr bool Q_IN_REGS = D == 64;    // Q hi/lo fragments kept
};

template <int D> constexpr size_t smem_bytes() {
  return (size_t)(Tile<D>::ROWS * Tile<D>::QS +
                  2 * Tile<D>::BK * (Tile<D>::QS + Tile<D>::VS)) *
         sizeof(float);
}

template <int D>
__device__ __forceinline__ void fwd(
    unsigned char* smem_raw, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int q_len,
    int kv_len, const Strides& st, float scale, int causal) {
  constexpr int BK = Tile<D>::BK;
  constexpr int WK = Tile<D>::WK;
  constexpr int ROWS = Tile<D>::ROWS;
  constexpr int QS = Tile<D>::QS;
  constexpr int VS = Tile<D>::VS;
  constexpr int KS = D / 8;   // k-steps of Q.K^T (8 dims each)
  constexpr int NS = WK / 8;  // n-tiles of S = k-steps of P.V (8 keys each)
  constexpr int DS = D / 8;   // n-tiles of O (8 columns each)
  constexpr int DG = 4;       // O's n-tiles a P V pass takes at once
  constexpr bool Q_IN_REGS = Tile<D>::Q_IN_REGS;
  constexpr float LOG2E = 1.4426950408889634f;
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + ROWS * QS;   // 2 stages of [BK, QS]
  float* Vs = Ks + 2 * BK * QS; // 2 stages of [BK, VS]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  // causal: heaviest q tile first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * ROWS;
  const float* qp = q + b * st.qsb + h * st.qsh;
  const float* kp = k + b * st.ksb + h * st.ksh;
  const float* vp = v + b * st.vsb + h * st.vsh;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int rt = warp & 1, half = warp >> 1;  // row tile, half of each kv tile
  const int wr = q0 + 16 * rt;             // the warp's first row

  const int off = kv_len - q_len;  // causal diagonal offset
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_col = min(q0 + ROWS, q_len) - 1 + off;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_f32<D, ROWS, QS>(Qs, qp, st.qss, q0, q_len, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_f32<D, BK, QS>(Ks, kp, st.kss, 0, kv_len, tid);
    load_tile_f32<D, BK, VS>(Vs, vp, st.vss, 0, kv_len, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // Q's A-fragment of k-step ks, split: slot t4 holds dim 8 ks + 2 t4 and
  // slot t4 + 4 dim 8 ks + 2 t4 + 1, one 8-byte load per row
  auto q_frag = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int ks) {
    const float* p = Qs + (16 * rt + g) * QS + 8 * ks + 2 * t4;
    const float2 r0 = *reinterpret_cast<const float2*>(p);           // row g
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * QS);  // g + 8
    split_tf32(r0.x, hi[0], lo[0]);
    split_tf32(r1.x, hi[1], lo[1]);
    split_tf32(r0.y, hi[2], lo[2]);
    split_tf32(r1.y, hi[3], lo[3]);
  };
  uint32_t qhi[Q_IN_REGS ? KS : 1][4], qlo[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag(qhi[ks], qlo[ks], ks);
  }

  float acc[DS][4];
#pragma unroll
  for (int n = 0; n < DS; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows g and g + 8; m the running max of the raw scores, l this
  // thread's partial sum (its quad adds them up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy, in flight during this one
      load_tile_f32<D, BK, QS>(Ks + (stage ^ 1) * BK * QS, kp, st.kss,
                               k0 + BK, kv_len, tid);
      load_tile_f32<D, BK, VS>(Vs + (stage ^ 1) * BK * VS, vp, st.vss,
                               k0 + BK, kv_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    // the warp's WK keys of the tile; a warp whose rows all lie before
    // the first of them skips them
    const int kw = k0 + half * WK;
    if (!causal || kw <= wr + 15 + off) {
      const float* Kt = Ks + (stage * BK + half * WK) * QS;
      const float* Vt = Vs + (stage * BK + half * WK) * VS;

      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a_hi[i] = qhi[ks][i];
            a_lo[i] = qlo[ks][i];
          }
        } else {
          q_frag(a_hi, a_lo, ks);
        }
        // key 8 n + g, dims 8 ks + 2 t4 (slot t4) and + 1 (slot t4 + 4)
        uint32_t b_hi[NS][2], b_lo[NS][2];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Kt + (8 * n + g) * QS + 8 * ks + 2 * t4);
          split_tf32(kv.x, b_hi[n][0], b_lo[n][0]);
          split_tf32(kv.y, b_hi[n][1], b_lo[n][1]);
        }
        // the step's three products in fresh accumulators, added to the
        // scores with round-to-nearest: the tensor core truncates each
        // sum it forms, which against the running scores of large logits
        // would cost several times f32's rounding
        float c[NS][4] = {};
        mma_tf32x3_n<NS>(c, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += c[n][e];
      }

      // mask only keys that touch the ragged kv edge or this warp's
      // causal diagonal
      if (kw + WK > kv_len || (causal && kw + WK - 1 > wr + off)) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kw + 8 * n + 2 * t4 + (e & 1);
            const int row = wr + g + (e >> 1) * 8;
            if (col >= kv_len || (causal && col > row + off))
              s[n][e] = -INFINITY;
          }
      }

      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        // a row with no visible key yet keeps m = -inf; subtracting 0
        // instead keeps exp2() finite (exp2(-inf) = 0 for masked scores)
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        // exponents as (s - m) scale log2(e): the row's largest score
        // gives exactly 1, and alpha is exactly 1 while m holds (a fused
        // s sl2 - m sl2 would leave the rounding of m sl2 in every weight,
        // compounding through alpha from tile to tile)
        alpha[i] = fast_exp2((m[i] - m_safe) * sl2);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[n][2 * i] = fast_exp2((s[n][2 * i] - m_safe) * sl2);
          s[n][2 * i + 1] = fast_exp2((s[n][2 * i + 1] - m_safe) * sl2);
          rs += s[n][2 * i] + s[n][2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + rs;
        m[i] = m_new;
      }

      // O = alpha O + P V.  S tile kk's C-fragment, split, is the
      // A-fragment of k-step kk with key 2 t4 in slot t4 and key 2 t4 + 1
      // in slot t4 + 4
      uint32_t p_hi[NS][4], p_lo[NS][4];
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        split_tf32(s[kk][0], p_hi[kk][0], p_lo[kk][0]);  // row g, key 2 t4
        split_tf32(s[kk][2], p_hi[kk][1], p_lo[kk][1]);  // row g + 8
        split_tf32(s[kk][1], p_hi[kk][2], p_lo[kk][2]);  // row g, 2 t4 + 1
        split_tf32(s[kk][3], p_hi[kk][3], p_lo[kk][3]);  // row g + 8
      }
      const float* vr = Vt + 2 * t4 * VS + g;
#pragma unroll
      for (int d0 = 0; d0 < DS; d0 += DG) {
        // this tile's P V for O's n-tiles d0 .. d0 + DG - 1 in fresh
        // accumulators, folded into O with one rounding (the tensor core
        // truncates its sums: a running O would take that at every
        // product of every tile)
        float c[DG][4] = {};
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          // column 8 dn + g of keys 8 kk + 2 t4 (b0) and 8 kk + 2 t4 + 1
          uint32_t b_hi[DG][2], b_lo[DG][2];
#pragma unroll
          for (int j = 0; j < DG; ++j) {
            const float* vk = vr + 8 * kk * VS + 8 * (d0 + j);
            split_tf32(vk[0], b_hi[j][0], b_lo[j][0]);
            split_tf32(vk[VS], b_hi[j][1], b_lo[j][1]);
          }
          mma_tf32x3_n<DG>(c, p_hi[kk], p_lo[kk], b_hi, b_lo);
        }
#pragma unroll
        for (int j = 0; j < DG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[d0 + j][e] = fmaf(acc[d0 + j][e], alpha[e >> 1], c[j][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // the two warps of a row tile saw disjoint keys: the second hands its
  // (m, l, O) to the first through shared memory (the K ring, free now),
  // lane by lane (a lane of either holds the same rows and columns)
  float* xs = Ks + rt * (4 * DS + 4) * 32;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < DS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * n + e) * 32 + lane] = acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[(4 * DS + i) * 32 + lane] = m[i];
      xs[(4 * DS + 2 + i) * 32 + lane] = l[i];
    }
  }
  __syncthreads();
  if (half == 1) return;
  float a1[2], a2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m2 = xs[(4 * DS + i) * 32 + lane];
    const float m_new = fmaxf(m[i], m2);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    a1[i] = fast_exp2((m[i] - m_safe) * sl2);
    a2[i] = fast_exp2((m2 - m_safe) * sl2);
    l[i] = l[i] * a1[i] + xs[(4 * DS + 2 + i) * 32 + lane] * a2[i];
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < DS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], a1[e >> 1],
                       xs[(4 * n + e) * 32 + lane] * a2[e >> 1]);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    const float li = quad_sum(l[i]);
    if (row >= q_len) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;  // no visible key: 0
    float* orow = o + ((long long)bh * q_len + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DS; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * q_len + row] =
          li > 0.f ? m[i] * scale + logf(li) : -INFINITY;
  }
}

}  // namespace tf32x3

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
    tf32x3::fwd<D>(smem, q, k, v, o, lse, H, q_len, kv_len, st, scale, causal);
  else
    tc::fwd<D>(smem, q, k, v, o, lse, H, q_len, kv_len, st, scale, causal);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int q_len, int kv_len, const long long* s,
           float scale, int causal, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = f32 ? tf32x3::smem_bytes<D>() : tc::smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
  const int rows = f32 ? tf32x3::Tile<D>::ROWS : tc::Tile<D>::ROWS;
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

// dtype: 0 = float32, 1 = bfloat16, both on tensor cores, q, k, v 16-byte
// aligned with strides in multiples of 16 bytes (4 f32 or 8 bf16
// elements).  strides: 9
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
