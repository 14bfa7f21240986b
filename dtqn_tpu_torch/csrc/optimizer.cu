// The learner's step after the gradient, as two kernels for sm_90a: the
// global-norm clip (optax.clip_by_global_norm), Adam (optax.adam), the
// gate on a legal, finite step, the step counters and the hard target swap
// of ``dtqn_tpu_torch/agents/base.py`` (``gated_adam_step``), over a flat
// parameter vector [P] or a stack of them [S, P], one row a seed.
//
// It replaces no TPU kernel: the JAX package leaves this step to XLA,
// which fuses it.  In the port it was ~48 stock PyTorch kernels an update,
// each a launch and a graph node, eight of them broadcasting a per-seed
// value over [S, P] in the non-vectorized elementwise kernel.
//
// What bounds it on an H100: bytes.  Per element the step reads g, p, mu
// and nu and writes p, mu and nu (and p again into the target on a swap):
// 28 bytes and ~20 flops, far below the card's ~20 flops a byte.  At one
// seed of 108k parameters the two launches themselves are the cost.
//
// The design:
//   adam_grad_sumsq   grid (blocks, S): each block sums the squares of its
//                     slice of one seed's gradient row into
//                     partials[s * blocks + b]; no atomics.
//   adam_clip_apply   grid (blocks, S): every block first sums its seed's
//                     partials in one fixed order, so that all blocks of a
//                     seed hold the same norm, then updates its slice.  One
//                     block a seed writes the norm, the gate and the new
//                     counters into fresh buffers: no block reads a counter
//                     that another one has written.
// A block covers THREADS float4 groups of a row, one a thread.  A row
// starts at element s * P, which need not lie on 16 bytes (P is odd in Car
// Flag), so its first ``head`` (< 4) elements go to block 0 and the last
// ``tail`` (< 4) to the last block, element by element, and the groups
// between them are 16-byte loads and stores.  The five vectors' bases lie
// on 16 bytes (``ops/cuda_optimizer.py`` refuses others), so their rows
// share the head.
//
// Rounding: each operation rounds as the plain chain's PyTorch kernel does,
// in the chain's order (``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn``,
// which the compiler never contracts into an FMA), the scalars are float32
// and the bias corrections ``powf``: given the same norm, the parameters,
// moments and target are bit-equal to the chain's.  The norm sums in
// another order than ``torch.linalg.vector_norm``, within a few ulps.
//
// The launches go to the caller's stream, allocate nothing and call no
// synchronizing function, so a CUDA graph captures them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // ops/cuda_optimizer.py: THREADS
constexpr int WARPS = THREADS / 32;

struct AdamScalars {
  float neg_lr, max_norm, b1, one_minus_b1, b2, one_minus_b2, eps;
  int target_update_frequency;
};

// The row's elements before its first 16-byte boundary.
__device__ __forceinline__ long long head_length(const float* row,
                                                 long long p) {
  const long long mis = (reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  const long long head = (4 - mis) & 3;
  return head < p ? head : p;
}

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}

__device__ __forceinline__ void store4(float* x, float4 v) {
  *reinterpret_cast<float4*>(x) = v;
}

// The block's sum of ``v``, in a fixed order (a butterfly in each warp,
// then one over the warps' sums), handed to every thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[WARPS];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float square_sum4(float4 v, float acc) {
  acc = __fmaf_rn(v.x, v.x, acc);
  acc = __fmaf_rn(v.y, v.y, acc);
  acc = __fmaf_rn(v.z, v.z, acc);
  return __fmaf_rn(v.w, v.w, acc);
}

__global__ void __launch_bounds__(THREADS)
adam_grad_sumsq(const float* __restrict__ grads, float* __restrict__ partials,
                long long p, int blocks) {
  const int s = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  const float* row = grads + static_cast<long long>(s) * p;
  const long long head = head_length(row, p);
  const long long groups = (p - head) / 4;
  const long long j = static_cast<long long>(b) * THREADS + t;
  float acc = 0.f;
  if (j < groups) acc = square_sum4(load4(row + head + 4 * j), acc);
  if (b == 0 && t < head) acc = __fmaf_rn(row[t], row[t], acc);
  const long long tail = head + 4 * groups + t;
  if (b == blocks - 1 && tail < p) acc = __fmaf_rn(row[tail], row[tail], acc);
  const float sum = block_sum(acc);
  if (t == 0) partials[static_cast<long long>(s) * blocks + b] = sum;
}

// One element of ``clip_adam_update``: the clip, the moments, the bias
// corrections and the parameter's new value, each rounded as the chain's
// PyTorch kernel rounds it.
__device__ __forceinline__ void adam_element(
    float g, float& p, float& m, float& v, float gnorm, bool clip,
    float bias1, float bias2, const AdamScalars& sc) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), sc.max_norm);
  m = __fadd_rn(__fmul_rn(sc.one_minus_b1, g), __fmul_rn(sc.b1, m));
  v = __fadd_rn(__fmul_rn(__fmul_rn(sc.one_minus_b2, g), g),
                __fmul_rn(sc.b2, v));
  const float m_hat = __fdiv_rn(m, bias1);
  const float v_hat = __fdiv_rn(v, bias2);
  const float step = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), sc.eps));
  p = __fadd_rn(p, __fmul_rn(sc.neg_lr, step));
}

__global__ void __launch_bounds__(THREADS)
adam_clip_apply(const float* __restrict__ grads,
                const float* __restrict__ partials, float* __restrict__ params,
                float* __restrict__ mu, float* __restrict__ nu,
                float* __restrict__ target, const bool* __restrict__ ok,
                const int* __restrict__ count,
                const int* __restrict__ train_steps,
                const int* __restrict__ nonfinite,
                float* __restrict__ gnorm_out, bool* __restrict__ apply_out,
                int* __restrict__ count_out, int* __restrict__ steps_out,
                int* __restrict__ nonfinite_out, long long p, int blocks,
                AdamScalars sc) {
  const int s = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  // The seed's squared norm, summed in the same order by every block.
  const float* part = partials + static_cast<long long>(s) * blocks;
  float acc = 0.f;
  for (int i = t; i < blocks; i += THREADS) acc += part[i];
  const float gnorm = __fsqrt_rn(block_sum(acc));
  const bool legal = ok[s];
  const bool finite = isfinite(gnorm);
  const bool apply = legal && finite;
  const int moments_step = count[s] + 1;
  const int steps = train_steps[s] + (apply ? 1 : 0);
  const bool swap = apply && steps % sc.target_update_frequency == 0;
  if (b == 0 && t == 0) {
    gnorm_out[s] = gnorm;
    apply_out[s] = apply;
    count_out[s] = apply ? moments_step : count[s];
    steps_out[s] = steps;
    nonfinite_out[s] = nonfinite[s] + (legal && !finite ? 1 : 0);
  }
  if (!apply) return;  // the gated seed's state stays as it was
  const float countf = __int2float_rn(moments_step);
  const float bias1 = __fsub_rn(1.f, powf(sc.b1, countf));
  const float bias2 = __fsub_rn(1.f, powf(sc.b2, countf));
  const bool clip = !(gnorm < sc.max_norm);

  const long long off = static_cast<long long>(s) * p;
  const float* g_row = grads + off;
  float* p_row = params + off;
  float* m_row = mu + off;
  float* v_row = nu + off;
  float* t_row = target + off;
  const long long head = head_length(g_row, p);
  const long long groups = (p - head) / 4;
  const long long j = static_cast<long long>(b) * THREADS + t;
  if (j < groups) {
    const long long e = head + 4 * j;
    const float4 g = load4(g_row + e);
    float4 pv = load4(p_row + e), m = load4(m_row + e),
           v = load4(v_row + e);
    adam_element(g.x, pv.x, m.x, v.x, gnorm, clip, bias1, bias2, sc);
    adam_element(g.y, pv.y, m.y, v.y, gnorm, clip, bias1, bias2, sc);
    adam_element(g.z, pv.z, m.z, v.z, gnorm, clip, bias1, bias2, sc);
    adam_element(g.w, pv.w, m.w, v.w, gnorm, clip, bias1, bias2, sc);
    store4(p_row + e, pv);
    store4(m_row + e, m);
    store4(v_row + e, v);
    if (swap) store4(t_row + e, pv);
  }
  // The head's and the tail's elements, one a thread (a block can hold
  // both when a row has a single block).
  const long long tail = head + 4 * groups + t;
  const long long edges[2] = {b == 0 && t < head ? t : -1,
                              b == blocks - 1 && tail < p ? tail : -1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const long long e = edges[k];
    if (e < 0) continue;
    float pv = p_row[e], m = m_row[e], v = v_row[e];
    adam_element(g_row[e], pv, m, v, gnorm, clip, bias1, bias2, sc);
    p_row[e] = pv;
    m_row[e] = m;
    v_row[e] = v;
    if (swap) t_row[e] = pv;
  }
}

}  // namespace

extern "C" {

int dtqn_adam_grad_sumsq(const float* grads, float* partials, long long p,
                         int seeds, int blocks, void* stream) {
  const dim3 grid(blocks, seeds);
  adam_grad_sumsq<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grads, partials, p, blocks);
  return static_cast<int>(cudaGetLastError());
}

int dtqn_adam_clip_apply(const float* grads, const float* partials,
                         float* params, float* mu, float* nu, float* target,
                         const bool* ok, const int* count,
                         const int* train_steps, const int* nonfinite,
                         float* gnorm_out, bool* apply_out, int* count_out,
                         int* steps_out, int* nonfinite_out, long long p,
                         int seeds, int blocks, float neg_lr,
                         float max_norm, float b1, float one_minus_b1,
                         float b2, float one_minus_b2, float eps,
                         int target_update_frequency, void* stream) {
  const AdamScalars sc{neg_lr, max_norm, b1, one_minus_b1, b2,
                       one_minus_b2, eps, target_update_frequency};
  const dim3 grid(blocks, seeds);
  adam_clip_apply<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grads, partials, params, mu, nu, target, ok, count, train_steps,
      nonfinite, gnorm_out, apply_out, count_out, steps_out, nonfinite_out, p,
      blocks, sc);
  return static_cast<int>(cudaGetLastError());
}

const char* dtqn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
