// Packed multi-head attention, forward and recompute backward, for sm_90a.
//
// Replaces dtqn_tpu/ops/pallas_attention.py: `_fwd_kernel` (launched by
// `_fwd`) and `_bwd_kernel` (launched by `_bwd`).  Same layout and the same
// arithmetic: q is [B, Lq, H*D], k and v are [B, Lk, H*D], all float32 and
// contiguous; head h owns columns [h*D, (h+1)*D).  Per head:
//   S = Q K^T * scale, masked to -1e30 where causal and col > row (top-left
//   aligned, so the caller requires Lq == Lk when causal), P = softmax(S)
//   with the row max subtracted, O = P V.
// The backward rebuilds P from Q and K and saves neither P nor a logsumexp:
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)), masked and
//   scaled, dQ = dS K, dK = dS^T Q.
//
// Design: one block per (batch element, head).  The head's [L, D] slices of
// Q, K, V (and dO) are copied from the packed layout into shared memory, and
// the [Lq, Lk] score matrix stays there too, so scores never reach device
// memory.  Every block owns its slices of O, dQ, dK and dV, so there are no
// atomics and no second pass.  Sums run in float32 with FMA on the CUDA
// cores: at DTQN's shapes (L = 50, D = 8) a call moves a few MB and does a
// few tens of MFLOP, so it is bound by launch latency and memory, not by the
// tensor cores.  wgmma, TMA and tiling are left for later work.
//
// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes).  Each entry point launches on the given stream and returns
// cudaGetLastError() as an int; the caller raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Copies one head's [rows, d] slice out of a packed [rows, e] matrix.
__device__ void load_head(const float* __restrict__ src, float* dst, int rows,
                          int e, int d, int col0) {
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[idx] = src[(size_t)r * e + col0 + c];
  }
}

// p <- softmax(mask(qs ks^T * scale)) row by row, as `_softmax_scores`.
// Ends with a block barrier.
__device__ void softmax_probs(const float* qs, const float* ks, float* p,
                              int lq, int lk, int d, bool causal,
                              float scale) {
  for (int idx = threadIdx.x; idx < lq * lk; idx += blockDim.x) {
    const int i = idx / lk;
    const int j = idx - i * lk;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qs[i * d + c], ks[j * d + c], acc);
    acc *= scale;
    p[idx] = (!causal || j <= i) ? acc : kMaskValue;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = warp; i < lq; i += warps) {
    float* row = p + (size_t)i * lk;
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float x = expf(row[j] - m);
      row[j] = x;
      s += x;
    }
    s = warp_sum(s);
    for (int j = lane; j < lk; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int lq, int lk, int heads, int d, int causal,
                     float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int e = heads * d;
  float* qs = smem;
  float* ks = qs + lq * d;
  float* vs = ks + lk * d;
  float* p = vs + lk * d;

  load_head(q + (size_t)b * lq * e, qs, lq, e, d, h * d);
  load_head(k + (size_t)b * lk * e, ks, lk, e, d, h * d);
  load_head(v + (size_t)b * lk * e, vs, lk, e, d, h * d);
  __syncthreads();
  softmax_probs(qs, ks, p, lq, lk, d, causal != 0, scale);

  float* out = o + (size_t)b * lq * e + h * d;
  for (int idx = threadIdx.x; idx < lq * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    const float* prow = p + (size_t)i * lk;
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc = fmaf(prow[j], vs[j * d + c], acc);
    out[(size_t)i * e + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int lq,
                     int lk, int heads, int d, int causal, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int e = heads * d;
  float* qs = smem;
  float* ks = qs + lq * d;
  float* vs = ks + lk * d;
  float* dos = vs + lk * d;
  float* p = dos + lq * d;
  float* ds = p + lq * lk;
  float* rowdot = ds + lq * lk;

  load_head(q + (size_t)b * lq * e, qs, lq, e, d, h * d);
  load_head(k + (size_t)b * lk * e, ks, lk, e, d, h * d);
  load_head(v + (size_t)b * lk * e, vs, lk, e, d, h * d);
  load_head(dout + (size_t)b * lq * e, dos, lq, e, d, h * d);
  __syncthreads();
  softmax_probs(qs, ks, p, lq, lk, d, causal != 0, scale);

  // dP = dO V^T
  for (int idx = threadIdx.x; idx < lq * lk; idx += blockDim.x) {
    const int i = idx / lk;
    const int j = idx - i * lk;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(dos[i * d + c], vs[j * d + c], acc);
    ds[idx] = acc;
  }
  __syncthreads();

  // rowsum(dP * P)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = warp; i < lq; i += warps) {
    float s = 0.f;
    for (int j = lane; j < lk; j += 32) s += ds[i * lk + j] * p[i * lk + j];
    s = warp_sum(s);
    if (lane == 0) rowdot[i] = s;
  }
  __syncthreads();

  // dS = P * (dP - rowsum), masked, times scale
  for (int idx = threadIdx.x; idx < lq * lk; idx += blockDim.x) {
    const int i = idx / lk;
    const int j = idx - i * lk;
    const float x = p[idx] * (ds[idx] - rowdot[i]);
    ds[idx] = (!causal || j <= i) ? x * scale : 0.f;
  }
  __syncthreads();

  // dV = P^T dO and dK = dS^T Q, one (key row, column) per thread step
  const size_t kv_off = (size_t)b * lk * e + h * d;
  for (int idx = threadIdx.x; idx < lk * d; idx += blockDim.x) {
    const int j = idx / d;
    const int c = idx - j * d;
    float acc_v = 0.f;
    float acc_k = 0.f;
    for (int i = 0; i < lq; ++i) {
      acc_v = fmaf(p[i * lk + j], dos[i * d + c], acc_v);
      acc_k = fmaf(ds[i * lk + j], qs[i * d + c], acc_k);
    }
    dv[kv_off + (size_t)j * e + c] = acc_v;
    dk[kv_off + (size_t)j * e + c] = acc_k;
  }

  // dQ = dS K
  const size_t q_off = (size_t)b * lq * e + h * d;
  for (int idx = threadIdx.x; idx < lq * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc = fmaf(ds[i * lk + j], ks[j * d + c], acc);
    dq[q_off + (size_t)i * e + c] = acc;
  }
}

size_t fwd_smem_bytes(int lq, int lk, int d) {
  return sizeof(float) * ((size_t)(lq + 2 * lk) * d + (size_t)lq * lk);
}

size_t bwd_smem_bytes(int lq, int lk, int d) {
  return sizeof(float) *
         ((size_t)(2 * lq + 2 * lk) * d + 2 * (size_t)lq * lk + lq);
}

// Above 48 KB a block's dynamic shared memory has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int dtqn_attention_fwd(const void* q, const void* k, const void* v, void* o,
                       int batch, int lq, int lk, int heads, int head_dim,
                       int causal, float scale, void* stream) {
  const size_t smem = fwd_smem_bytes(lq, lk, head_dim);
  cudaError_t err = allow_smem(attention_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<<<batch * heads, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lq, lk,
      heads, head_dim, causal, scale);
  return (int)cudaGetLastError();
}

int dtqn_attention_bwd(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       int batch, int lq, int lk, int heads, int head_dim,
                       int causal, float scale, void* stream) {
  const size_t smem = bwd_smem_bytes(lq, lk, head_dim);
  cudaError_t err = allow_smem(attention_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<<<batch * heads, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (float*)dq, (float*)dk, (float*)dv, lq, lk, heads, head_dim, causal,
      scale);
  return (int)cudaGetLastError();
}

const char* dtqn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
