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
// the gradients are deterministic.
//
// Design.  128 threads per CTA.  Tiles are R rows with R * D = 4096
// (R = 64, 32, 16 for D = 64, 128, 256), so every thread keeps 32 f32
// accumulators per output whatever the head dim, and shared memory stays
// under 100 KB (f32 tiles, rows padded by one word against bank
// conflicts).  Thread t owns rows (t / 8) * R/16 + i of a tile and columns
// (t % 8) + 8 j, the layout of csrc/flash_fwd.cu.
//   flash_bwd_kv: the CTA stages its K and V tiles once, then loops over
//     q tiles from the first one that reaches the causal diagonal (the
//     Pallas kernel's `live` test) to the end, staging q, do, lse and delta
//     for each; S = q K^T and dP = do V^T share one pass over d; p and ds
//     go through shared memory to the dv / dk products.  dk and dv are
//     written once, in the input dtype.
//   flash_bwd_dq: the CTA stages its q, do, lse and delta once and loops
//     over K/V tiles up to the diagonal; ds goes through shared memory to
//     the dq product.
// Ragged lengths are masked here, not padded on the host: rows past q_len
// and keys past kv_len are zero-filled while staging and get p = 0.  A row
// with no visible key (lse = -inf) has every key masked, so p = 0 there
// and no exp(-inf + inf) is ever taken.  q, k, v and do arrive with
// arbitrary (batch, head, row) strides and a contiguous head dim.
//
// Bound at the training shape [16, 12, 1024, 64] bf16 causal, per launch
// (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16): flash_bwd_kv reads q, do, k, v
// (4 x 25.2 MB) plus lse and delta (2 x 0.79 MB) and writes dk, dv
// (2 x 25.2 MB), 152.6 MB -> 45.5 us; its four products over the causal
// triangle are 8 * 192 * (1024 * 1025 / 2) * 64 = 51.6 GFLOP -> 52.2 us,
// so operations bound it.  flash_bwd_dq moves 127.4 MB (38.0 us) and does
// three products, 38.7 GFLOP (39.1 us).  What limits THESE kernels is
// neither: they run scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak),
// about 2.7 FMAs per shared-memory load.  mma.sync / wgmma, TMA and warp
// specialisation are later work.
//
// Launch errors: each entry point returns cudaGetLastError() after its
// launch (or -1 for an unsupported dtype / head dim); the Python wrapper
// raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
__global__ void __launch_bounds__(NT) flash_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int q_len, int kv_len, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal) {
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

// Same layouts as flash_bwd_kv_kernel; dq is contiguous [B*H, q_len, D].
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int q_len,
    int kv_len, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal) {
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, q_len, kv_len;
  const long long* st;  // 12 strides: (batch, head, row) of q, k, v, do
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_kv(const Args& a, void* dk, void* dv) {
  using S = Shape<D>;
  auto kern = flash_bwd_kv_kernel<T, D>;
  const size_t smem = smem_kv<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* st = a.st;
  dim3 grid((a.kv_len + S::R - 1) / S::R, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)dk, (T*)dv, a.H, a.q_len, a.kv_len, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  using S = Shape<D>;
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = smem_dq<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long* st = a.st;
  dim3 grid((a.q_len + S::R - 1) / S::R, a.B * a.H);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides
// (batch, head, row) of q, then k, v and do.  Returns 0, a cudaError_t
// code, or -1 for an unsupported dtype / head dim.
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
// flash_bwd_dq (kernel 1) at head dim d; -1 for an unsupported d.
extern "C" int flash_bwd_smem_bytes(int kernel, int d) {
  switch (d) {
    case 64: return (int)(kernel == 0 ? smem_kv<64>() : smem_dq<64>());
    case 128: return (int)(kernel == 0 ? smem_kv<128>() : smem_dq<128>());
    case 256: return (int)(kernel == 0 ? smem_kv<256>() : smem_dq<256>());
    default: return -1;
  }
}

extern "C" const char* flash_bwd_error_string(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString((cudaError_t)code);
}
