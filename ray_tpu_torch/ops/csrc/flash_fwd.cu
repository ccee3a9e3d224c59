// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// forward): softmax(scale * Q K^T) V with an online softmax, causal rows
// at the tail of kv (offset kv_len - q_len), ragged kv_len masked here in
// the kernel (no host padding), optional lse = m + log(l) as [bh, sq] f32.
//
// Design.  One CTA of 128 threads per (batch*head, 64-row q tile).  The
// CTA stages its Q tile once, then loops over 64-row K/V tiles staged in
// shared memory (f32, rows padded by one word against bank conflicts),
// stopping at the causal diagonal.  Warp w owns q rows [16w, 16w+16);
// inside it lane l owns 4 rows (l / 8) and 8 key columns (l % 8 + 8j),
// so a 4x8 register tile of scores costs 12 shared loads per 32 FMAs.
// Row max and row sum reduce over the 8 lanes of a row with shuffles; the
// probabilities go through shared memory to the P.V product, where the
// same lane owns 4 rows x D/8 output columns in registers.  All math is
// f32 scalar FMA: this is the simple, correct first version.  wgmma, TMA
// and warp specialisation are later work.
//
// Tiles: BQ = BK = 64, 128 threads.  Shared memory is
// (3 * 64 * (D + 1) + 64 * 65) * 4 bytes: 66,560 B at D = 64, 115,712 B
// at D = 128, 214,784 B at D = 256 (dynamic, opted in per launch).
//
// Bound at the serving path's shape, [1, 12, 1024, 64] bf16 causal, one
// launch: the bytes are q, k, v read once and o written once,
// 4 * 12 * 1024 * 64 * 2 B = 6.29 MB, 1.88 us at 3.35 TB/s; the work is
// QK^T and PV over the causal lower triangle, 2 * 2 * 12 * (1024 * 1025 / 2)
// * 64 = 1.61 GFLOP, 1.63 us at the 989 TFLOP/s bf16 tensor-core rate.  So
// the bound is the bytes.  What limits THIS kernel is neither: it runs on
// the f32 CUDA cores (67 TFLOP/s peak) with one shared load per 2.7 FMAs
// in QK^T and 192 CTAs for 132 SMs, so the scalar pipes' instruction
// throughput bounds it, far above the bound.
//
// Launch errors: every launch is followed by cudaGetLastError(), whose
// code the entry point returns; the Python wrapper raises on non-zero
// (this is the ctypes route's counterpart of C10_CUDA_KERNEL_LAUNCH_CHECK).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;
constexpr int PS = BK + 1;  // row stride of the probability tile

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

// q/k/v are [B, H, len, D] with the last dim contiguous and arbitrary
// batch / head / row strides (in elements); o is contiguous [B*H, q_len, D].
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int q_len, int kv_len,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal) {
  constexpr int DP = D + 1;
  constexpr int DN = D / 8;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;                          // key/column group
  const int r0 = (tid >> 5) * 16 + (lane >> 3) * 4;  // first of 4 rows

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - (i / D) * D;
    const int gr = q0 + r;
    Qs[r * DP + c] = gr < q_len ? to_f(qp[gr * qss + c]) : 0.f;
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
      Ks[r * DP + c] = ok ? to_f(kp[gr * kss + c]) : 0.f;
      Vs[r * DP + c] = ok ? to_f(vp[gr * vss + c]) : 0.f;
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
    T* orow = o + ((long long)bh * q_len + grow) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) orow[cg + 8 * n] = from_f<T>(acc[i][n] * inv);
    if (lse != nullptr && cg == 0)
      lse[(long long)bh * q_len + grow] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int q_len, int kv_len, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((q_len + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, q_len, kv_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
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

// dtype: 0 = float32, 1 = bfloat16.  strides: 9 element
// strides (batch, head, row) of q, then k, then v.  lse may be null.
// Returns 0, a cudaError_t code, or -1 for an unsupported dtype / head dim.
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
