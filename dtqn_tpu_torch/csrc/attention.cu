// Packed multi-head attention, forward and recompute backward, for sm_90a.
//
// Replaces dtqn_tpu/ops/pallas_attention.py: `_fwd_kernel` (launched by
// `_fwd`) and `_bwd_kernel` (launched by `_bwd`).  Same layout and the same
// arithmetic: q is [B, Lq, H*D], k and v are [B, Lk, H*D], contiguous, all
// float32 or all bfloat16; head h owns columns [h*D, (h+1)*D).  As the
// Pallas kernels do, every instance loads its element type into float32
// registers, computes in float32 and stores its outputs (o; dq, dk, dv)
// rounded to its element type (bfloat16: to nearest even, as XLA's
// astype).  Per head:
//   S = Q K^T * scale, masked to -1e30 where causal and col > row (top-left
//   aligned, so the caller requires Lq == Lk when causal), P = softmax(S)
//   with the row max subtracted, O = P V.
// The backward rebuilds P from Q and K and saves neither P nor a logsumexp:
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)), masked and
//   scaled, dQ = dS K, dK = dS^T Q.
//
// What bounds it on an H100: at DTQN's shapes (B = 32..64, L = 50, H = 8,
// D = 8 or 16) a call reads and writes 1-2 MB, well under a microsecond at
// 3.35 TB/s, and does a few MFLOP.  The time goes to the launch and to the
// latency of each warp's dependent chain (load, dot, shuffle, exp), so the
// design keeps that chain short and keeps many warps in flight.  At the bag
// evict forward's B = 1664 (170 MB at D = 16) the bytes bound it, so every
// byte of a head is to be read from device memory once.
//
// Design: keys on lanes.  A warp takes query rows of one (batch, head);
// lane t owns keys j = t, t + 32, ...  A row's scores live in the lanes'
// registers: the row max, the row sum and rowsum(dP * P) are warp shuffles,
// and P V (or dS K) is a per-lane partial of the D columns that a butterfly
// reduce-scatter leaves one column to a lane.  Causally masked keys
// (j > i) are skipped, which is exact: exp(-1e30 - m) is 0 in float32, and
// key 0 is always live.  Three forms, by where a lane's K and V rows live:
//   - Register instances (KPL = 1, 2 keys per lane, KPL * D <= 16): each
//     lane holds its keys' K and V rows (and, backward, its dK and dV sums)
//     in registers for the whole block, loaded once with 16-byte loads.
//     Forward: one block per (batch, head, tile of query rows), a few rows
//     per warp, no shared memory and no barrier.  Backward: one block per
//     (batch, head), the warps share its query rows, and the warps' dK / dV
//     partials are summed through shared memory in warp order after the one
//     barrier.
//   - Staged instances (KPL = 2 with D = 16, any Lk up to 64: 32 floats of
//     K a lane, past the register budget; at Lk <= 32 it also beats a lane
//     holding one key in registers, which the forward re-loaded for every
//     8-row tile): the block copies its head's rows into shared
//     memory once with 16-byte cp.async copies (each head row is 64 bytes at
//     a stride of H * D floats; in bfloat16 each 16-byte load of 8 values
//     goes through registers and is stored converted, so the shared rows
//     are float32 in both types and the bf16 form needs no bank analysis
//     of its own), in rows padded to D + 4 floats so that the
//     8 lanes of a quarter-warp reading neighbouring keys' 16-byte pieces
//     fall on 8 different groups of 4 banks.  Forward: one block per
//     (batch, head, tile of up to 64 query rows), so at Lq <= 64 one block
//     per (batch, head) and every byte of K and V is read once (re-staging
//     K and V per smaller tile would multiply the bytes of the byte-bound
//     B = 1664 call; 8 warps a block keep B = 32's 256 blocks at ~15 warps
//     an SM); a row's scores are computed once, then max and sum by
//     shuffle and P V as per-lane partials: one pass.  Backward: one block
//     per (batch, head) stages Q, dO, K and V, then two phases around one
//     barrier: (a) rows on warps, keys on lanes, each row's P and dS
//     computed once and kept in shared [Lq][Lk] tiles, dQ = dS K by
//     reduce-scatter; (b) the 2 * Lk * D outputs of dK = dS^T Q and
//     dV = P^T dO spread over every thread of the block, four columns a
//     thread, each summed over the rows in order while the dS / P column is
//     read by broadcast.  Both tiles are read along their rows in both
//     phases, so they need no padding.
//   - Streamed instances (KPL = 0, any Lk, D up to 64): a lane re-reads its
//     keys' rows through L1 for each query row, 32 keys at a time, and the
//     row takes two passes (max, then exp / sum / P V); the backward takes
//     four for dQ, keeps each row's max, sum and rowsum(dP * P) in shared
//     memory, and after the one barrier gives each thread a key whose dK and
//     dV it sums over the rows in order.  At D = 16 they take only Lk > 64.
// Every backward sums in a fixed order without atomics, so two launches
// give bit-equal gradients.
// No tensor cores and no TMA: TF32 mma / wgmma keeps about three digits,
// which breaks float32 parity with the plain version (2e-5), and the work
// is small (the B = 1664 forward at D = 16 is 1.09 GFLOP, 0.016 ms at the
// 67 TFLOP/s float32 rate, a third of its byte bound; at B = 32 latency
// bounds it); a TMA box needs a tensor map encoded on the host for every
// call, on a path the host already bounds.  The bfloat16 instances are the
// float32 ones with other loads and stores: a register-keyed head row of 8
// bf16 values is one 16-byte load; the staged form converts while staging
// (below), so its shared memory, its padding and every shared read are
// the float32 form's.  bf16 mma at head width 8-16, where tensor cores
// might pay, is not written.
//
// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes).  The caller works out the launch configuration (instance, warps,
// rows per block, shared bytes; ops/cuda_attention.py `launch_config`).
// Each entry point launches on the given stream and returns
// cudaGetLastError() as an int; the caller raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// The (head width, keys per lane) instances; KPL 0 is the streamed form.
// ops/cuda_attention.py INSTANCES lists the same pairs.
#define DTQN_INSTANCES(X) \
  X(8, 1) X(8, 2) X(16, 2) X(8, 0) X(16, 0) X(32, 0) X(64, 0)

// The element types, by the code the entry points take; every instance is
// built in each.  ops/cuda_attention.py DTYPES lists them in code order.
#define DTQN_DTYPES(X) X(0, float) X(1, __nv_bfloat16)

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int lq, lk, heads, d, causal, rows_per_block, vec;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

// One head's row of DP floats (the first d real, the rest 0).  `vec` holds
// when d == DP and every base pointer is 16-byte aligned (the staged
// backward's dK and dV too: it stores them 16 bytes at a time).
template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int d,
                                         bool vec, float (&r)[DP]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src + c));
      r[c] = x.x;
      r[c + 1] = x.y;
      r[c + 2] = x.z;
      r[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) r[c] = c < d ? __ldg(src + c) : 0.f;
  }
}

// Eight bfloat16 values (one 16-byte word) widened into r[0..8): a bf16 is
// the upper half of the float32 with the same bits.
__device__ __forceinline__ void widen8(const uint4 w, float* r) {
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(x[i] << 16);
    r[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

// The bfloat16 row, widened: with `vec`, DP / 8 16-byte loads.
template <int DP>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ src,
                                         int d, bool vec, float (&r)[DP]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < DP; c += 8) {
      widen8(__ldg(reinterpret_cast<const uint4*>(src + c)), r + c);
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      r[c] = c < d ? __bfloat162float(__ldg(src + c)) : 0.f;
    }
  }
}

// A float32 result as the element type: bfloat16 rounded to nearest even.
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive results to dst (8- or 16-byte aligned): one store.
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(bf16_bits(x.x) | bf16_bits(x.y) << 16,
                 bf16_bits(x.z) | bf16_bits(x.w) << 16);
}

template <int DP>
__device__ __forceinline__ float dot(const float (&a)[DP],
                                     const float (&b)[DP]) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// Butterfly reduce-scatter of v[0..N) over the lanes at xor offsets O, O/2,
// ..., 1: each step hands half of the live values to the partner lane.
// Afterwards v[0..max(DP/32, 1)) hold full warp sums of columns col0, col0+1,
// ... (the return value); for DP < 32, 32/DP neighbouring lanes hold the
// same column.  The order is fixed, so results repeat bit for bit.
template <int N, int O, int DP>
__device__ __forceinline__ int reduce_scatter(float (&v)[DP], int lane) {
  if constexpr (O == 0) {
    return 0;
  } else if constexpr (N == 1) {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    return reduce_scatter<1, O / 2>(v, lane);
  } else {
    constexpr int H = N / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const float send = upper ? v[c] : v[c + H];
      const float keep = upper ? v[c + H] : v[c];
      v[c] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return (upper ? H : 0) + reduce_scatter<H, O / 2>(v, lane);
  }
}

// The staged form: KPL keys a lane whose K and V rows (KPL * DP floats
// each) exceed the 16 floats a lane keeps in registers.
template <int DP, int KPL>
constexpr bool kStaged = KPL > 0 && KPL * DP > 16;

// Floats per staged head row: DP padded by 4, so that the rows of the 8
// keys a quarter-warp reads 16 bytes of start 4 banks apart (at DP = 16:
// banks 0, 20, 8, 28, 16, 4, 24, 12, each 4 wide).
template <int DP>
constexpr int kStagedRow = DP + 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

// Rows [0, n) of one head (d floats at a stride of e) into shared rows of
// kStagedRow<DP> floats, columns d..DP zeroed.  With `vec` (d == DP, every
// base 16-byte aligned) each row goes as DP / 4 asynchronous 16-byte
// copies, neighbouring threads on neighbouring pieces; else a float at a
// time.  staged_barrier() completes the copies.
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n, int d, int e, bool vec) {
  constexpr int kRow = kStagedRow<DP>;
  if (vec) {
    constexpr int kPieces = DP / 4;
    for (int x = threadIdx.x; x < n * kPieces; x += blockDim.x) {
      const int r = x / kPieces;
      const int c = (x - r * kPieces) * 4;
      cp_async16(dst + r * kRow + c, src + (size_t)r * e + c);
    }
  } else {
    for (int x = threadIdx.x; x < n * DP; x += blockDim.x) {
      const int r = x / DP;
      const int c = x - r * DP;
      dst[r * kRow + c] = c < d ? __ldg(src + (size_t)r * e + c) : 0.f;
    }
  }
}

// The bfloat16 rows, widened while staging into the same float32 rows:
// with `vec` each 16-byte load of 8 values goes through registers and is
// stored as two float4, neighbouring threads on neighbouring pieces.
template <int DP>
__device__ __forceinline__ void stage_rows(
    float* dst, const __nv_bfloat16* __restrict__ src, int n, int d, int e,
    bool vec) {
  constexpr int kRow = kStagedRow<DP>;
  if (vec) {
    constexpr int kPieces = DP / 8;
    for (int x = threadIdx.x; x < n * kPieces; x += blockDim.x) {
      const int r = x / kPieces;
      const int c = (x - r * kPieces) * 8;
      float w[8];
      widen8(__ldg(reinterpret_cast<const uint4*>(src + (size_t)r * e + c)),
             w);
      float* to = dst + r * kRow + c;
      *reinterpret_cast<float4*>(to) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(to + 4) = make_float4(w[4], w[5], w[6], w[7]);
    }
  } else {
    for (int x = threadIdx.x; x < n * DP; x += blockDim.x) {
      const int r = x / DP;
      const int c = x - r * DP;
      dst[r * kRow + c] =
          c < d ? __bfloat162float(__ldg(src + (size_t)r * e + c)) : 0.f;
    }
  }
}

// Waits for this thread's copies, then for the whole block's.
__device__ __forceinline__ void staged_barrier() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

// One staged row of DP floats, 16 bytes at a time.
template <int DP>
__device__ __forceinline__ void shared_row(const float* src, float (&r)[DP]) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + c);
    r[c] = x.x;
    r[c + 1] = x.y;
    r[c + 2] = x.z;
    r[c + 3] = x.w;
  }
}

// Sums acc over the warp and writes the row's d columns, divided by `norm`.
template <int DP, typename T>
__device__ __forceinline__ void write_row(float (&acc)[DP], int lane,
                                          T* __restrict__ dst, int d,
                                          float norm) {
  constexpr int kCols = DP >= 32 ? DP / 32 : 1;
  constexpr int kSpan = DP >= 32 ? 1 : 32 / DP;
  const int col0 = reduce_scatter<DP, 16>(acc, lane);
  if ((lane & (kSpan - 1)) == 0) {
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      if (col0 + x < d) dst[col0 + x] = narrow<T>(acc[x] / norm);
    }
  }
}

// Forward of the register and streamed forms.
template <typename T, int DP, int KPL>
__device__ __forceinline__ void fwd_lanes(const T* __restrict__ q,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          T* __restrict__ o, const Dims& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x / s.heads;
  const int h = blockIdx.x - b * s.heads;
  const int e = s.heads * s.d;
  const int row0 = blockIdx.y * s.rows_per_block;
  const int row_end = min(s.lq, row0 + s.rows_per_block);
  const size_t q_base = (size_t)b * s.lq * e + (size_t)h * s.d;
  const T* kh = k + (size_t)b * s.lk * e + (size_t)h * s.d;
  const T* vh = v + (size_t)b * s.lk * e + (size_t)h * s.d;
  const bool vec = s.vec != 0;

  constexpr int kSlots = KPL > 0 ? KPL : 1;
  float kr[kSlots][DP];
  float vr[kSlots][DP];
  if constexpr (KPL > 0) {
    // Keys that some row of this block sees.
    const int nk = s.causal ? min(s.lk, row_end) : s.lk;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      if (j < nk) {
        load_row(kh + (size_t)j * e, s.d, vec, kr[m]);
        load_row(vh + (size_t)j * e, s.d, vec, vr[m]);
      } else {
#pragma unroll
        for (int c = 0; c < DP; ++c) kr[m][c] = vr[m][c] = 0.f;
      }
    }
  }

  for (int i = row0 + warp; i < row_end; i += warps) {
    float qr[DP];
    load_row(q + q_base + (size_t)i * e, s.d, vec, qr);
    const int live = s.causal ? min(s.lk, i + 1) : s.lk;  // keys [0, live)
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
    float mx = -INFINITY;
    float sum = 0.f;
    float norm;
    if constexpr (KPL > 0) {
      float p[KPL];
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        p[m] = -INFINITY;
        if (lane + 32 * m < live) p[m] = dot(qr, kr[m]) * s.scale;
        mx = fmaxf(mx, p[m]);
      }
      mx = warp_max(mx);
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        p[m] = lane + 32 * m < live ? expf(p[m] - mx) : 0.f;
        sum += p[m];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        if (lane + 32 * m < live) {
          const float pm = p[m] / sum;
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] = fmaf(pm, vr[m][c], acc[c]);
        }
      }
      norm = 1.f;
    } else {
      for (int j = lane; j < live; j += 32) {
        float kk[DP];
        load_row(kh + (size_t)j * e, s.d, vec, kk);
        mx = fmaxf(mx, dot(qr, kk) * s.scale);
      }
      mx = warp_max(mx);
      for (int j = lane; j < live; j += 32) {
        float kk[DP], vv[DP];
        load_row(kh + (size_t)j * e, s.d, vec, kk);
        load_row(vh + (size_t)j * e, s.d, vec, vv);
        const float x = expf(dot(qr, kk) * s.scale - mx);
        sum += x;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(x, vv[c], acc[c]);
      }
      norm = warp_sum(sum);
    }
    write_row(acc, lane, o + q_base + (size_t)i * e, s.d, norm);
  }
}

// Forward of the staged form.  Shared memory: the tile's query rows, then
// the head's K and V rows, [rows_per_block + 2 * Lk][DP + 4].
template <typename T, int DP, int KPL>
__device__ __forceinline__ void fwd_staged(const T* __restrict__ q,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           T* __restrict__ o, const Dims& s,
                                           float* smem) {
  constexpr int kRow = kStagedRow<DP>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x / s.heads;
  const int h = blockIdx.x - b * s.heads;
  const int e = s.heads * s.d;
  const int row0 = blockIdx.y * s.rows_per_block;
  const int row_end = min(s.lq, row0 + s.rows_per_block);
  const size_t q_base = (size_t)b * s.lq * e + (size_t)h * s.d;
  const size_t kv_base = (size_t)b * s.lk * e + (size_t)h * s.d;
  const bool vec = s.vec != 0;
  float* qs = smem;
  float* ks = qs + s.rows_per_block * kRow;
  float* vs = ks + s.lk * kRow;
  // Keys that some row of this tile sees.
  const int nk = s.causal ? min(s.lk, row_end) : s.lk;
  stage_rows<DP>(qs, q + q_base + (size_t)row0 * e, row_end - row0, s.d, e,
                 vec);
  stage_rows<DP>(ks, k + kv_base, nk, s.d, e, vec);
  stage_rows<DP>(vs, v + kv_base, nk, s.d, e, vec);
  staged_barrier();

  for (int i = row0 + warp; i < row_end; i += warps) {
    float qr[DP];
    shared_row(qs + (i - row0) * kRow, qr);
    const int live = s.causal ? min(s.lk, i + 1) : s.lk;  // keys [0, live)
    float p[KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      p[m] = -INFINITY;
      if (j < live) {
        float kk[DP];
        shared_row(ks + j * kRow, kk);
        p[m] = dot(qr, kk) * s.scale;
      }
      mx = fmaxf(mx, p[m]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      p[m] = lane + 32 * m < live ? expf(p[m] - mx) : 0.f;
      sum += p[m];
    }
    sum = warp_sum(sum);
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      if (j < live) {
        const float pm = p[m] / sum;
        float vv[DP];
        shared_row(vs + j * kRow, vv);
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(pm, vv[c], acc[c]);
      }
    }
    write_row(acc, lane, o + q_base + (size_t)i * e, s.d, 1.f);
  }
}

// The staged forward launches 256 threads but keeps CUDA's default bound of
// 1024: at a bound of 256, ptxas fits a fifth block an SM into 48 registers
// and spills 8 bytes; at 1024 it takes 58 and spills none.
template <typename T, int DP, int KPL>
__global__ void __launch_bounds__((kStaged<DP, KPL> ? 1024 : 128))
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Dims s) {
  extern __shared__ float4 shared4[];
  if constexpr (kStaged<DP, KPL>) {
    fwd_staged<T, DP, KPL>(q, k, v, o, s, reinterpret_cast<float*>(shared4));
  } else {
    fwd_lanes<T, DP, KPL>(q, k, v, o, s);
  }
}

// Backward with each lane's keys (K, V, dK, dV) in registers.  Shared
// memory: the warps' dK and dV partials, [2][warps][Lk][DP].
template <typename T, int DP, int KPL>
__device__ __forceinline__ void bwd_registers(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ doh, T* __restrict__ dqh,
    T* __restrict__ dkh, T* __restrict__ dvh, const Dims& s, int e,
    float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool vec = s.vec != 0;
  float kr[KPL][DP], vr[KPL][DP];
  float dkr[KPL][DP] = {};
  float dvr[KPL][DP] = {};
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int j = lane + 32 * m;
    if (j < s.lk) {
      load_row(kh + (size_t)j * e, s.d, vec, kr[m]);
      load_row(vh + (size_t)j * e, s.d, vec, vr[m]);
    } else {
#pragma unroll
      for (int c = 0; c < DP; ++c) kr[m][c] = vr[m][c] = 0.f;
    }
  }

  for (int i = warp; i < s.lq; i += warps) {
    float qr[DP], gr[DP];
    load_row(qh + (size_t)i * e, s.d, vec, qr);
    load_row(doh + (size_t)i * e, s.d, vec, gr);
    const int live = s.causal ? min(s.lk, i + 1) : s.lk;
    float p[KPL], ds[KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      p[m] = -INFINITY;
      if (lane + 32 * m < live) p[m] = dot(qr, kr[m]) * s.scale;
      mx = fmaxf(mx, p[m]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      p[m] = lane + 32 * m < live ? expf(p[m] - mx) : 0.f;
      sum += p[m];
    }
    sum = warp_sum(sum);
    float rd = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      ds[m] = 0.f;
      if (lane + 32 * m < live) {
        p[m] = p[m] / sum;
        ds[m] = dot(gr, vr[m]);  // dP
        rd += p[m] * ds[m];
      }
    }
    rd = warp_sum(rd);
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      if (lane + 32 * m < live) {
        ds[m] = p[m] * (ds[m] - rd) * s.scale;
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          acc[c] = fmaf(ds[m], kr[m][c], acc[c]);
          dkr[m][c] = fmaf(ds[m], qr[c], dkr[m][c]);
          dvr[m][c] = fmaf(p[m], gr[c], dvr[m][c]);
        }
      }
    }
    write_row(acc, lane, dqh + (size_t)i * e, s.d, 1.f);
  }

  float* part_k = smem;
  float* part_v = smem + (size_t)warps * s.lk * DP;
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int j = lane + 32 * m;
    if (j < s.lk) {
      const size_t at = ((size_t)warp * s.lk + j) * DP;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        part_k[at + c] = dkr[m][c];
        part_v[at + c] = dvr[m][c];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < s.lk * s.d; idx += blockDim.x) {
    const int j = idx / s.d;
    const int c = idx - j * s.d;
    float sk = 0.f, sv = 0.f;
    for (int w = 0; w < warps; ++w) {
      const size_t at = ((size_t)w * s.lk + j) * DP + c;
      sk += part_k[at];
      sv += part_v[at];
    }
    dkh[(size_t)j * e + c] = narrow<T>(sk);
    dvh[(size_t)j * e + c] = narrow<T>(sv);
  }
}

// Backward for any Lk.  Shared memory: each row's max, sum and
// rowsum(dP * P), [3][Lq].
template <typename T, int DP>
__device__ __forceinline__ void bwd_streamed(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ doh, T* __restrict__ dqh,
    T* __restrict__ dkh, T* __restrict__ dvh, const Dims& s, int e,
    float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool vec = s.vec != 0;
  float* row_max = smem;
  float* row_sum = smem + s.lq;
  float* row_dot = smem + 2 * s.lq;

  // dQ, rows on warps, keys on lanes.
  for (int i = warp; i < s.lq; i += warps) {
    float qr[DP], gr[DP];
    load_row(qh + (size_t)i * e, s.d, vec, qr);
    load_row(doh + (size_t)i * e, s.d, vec, gr);
    const int live = s.causal ? min(s.lk, i + 1) : s.lk;
    float mx = -INFINITY;
    for (int j = lane; j < live; j += 32) {
      float kk[DP];
      load_row(kh + (size_t)j * e, s.d, vec, kk);
      mx = fmaxf(mx, dot(qr, kk) * s.scale);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < live; j += 32) {
      float kk[DP];
      load_row(kh + (size_t)j * e, s.d, vec, kk);
      sum += expf(dot(qr, kk) * s.scale - mx);
    }
    sum = warp_sum(sum);
    float rd = 0.f;
    for (int j = lane; j < live; j += 32) {
      float kk[DP], vv[DP];
      load_row(kh + (size_t)j * e, s.d, vec, kk);
      load_row(vh + (size_t)j * e, s.d, vec, vv);
      const float p = expf(dot(qr, kk) * s.scale - mx) / sum;
      rd += p * dot(gr, vv);
    }
    rd = warp_sum(rd);
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
    for (int j = lane; j < live; j += 32) {
      float kk[DP], vv[DP];
      load_row(kh + (size_t)j * e, s.d, vec, kk);
      load_row(vh + (size_t)j * e, s.d, vec, vv);
      const float p = expf(dot(qr, kk) * s.scale - mx) / sum;
      const float ds = p * (dot(gr, vv) - rd) * s.scale;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds, kk[c], acc[c]);
    }
    write_row(acc, lane, dqh + (size_t)i * e, s.d, 1.f);
    if (lane == 0) {
      row_max[i] = mx;
      row_sum[i] = sum;
      row_dot[i] = rd;
    }
  }
  __syncthreads();

  // dK and dV, one key per thread, summed over the rows in order.
  for (int j = threadIdx.x; j < s.lk; j += blockDim.x) {
    float kk[DP], vv[DP];
    load_row(kh + (size_t)j * e, s.d, vec, kk);
    load_row(vh + (size_t)j * e, s.d, vec, vv);
    float dka[DP], dva[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;
    for (int i = s.causal ? j : 0; i < s.lq; ++i) {
      float qr[DP], gr[DP];
      load_row(qh + (size_t)i * e, s.d, vec, qr);
      load_row(doh + (size_t)i * e, s.d, vec, gr);
      const float p = expf(dot(qr, kk) * s.scale - row_max[i]) / row_sum[i];
      const float ds = p * (dot(gr, vv) - row_dot[i]) * s.scale;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dka[c] = fmaf(ds, qr[c], dka[c]);
        dva[c] = fmaf(p, gr[c], dva[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < s.d) {
        dkh[(size_t)j * e + c] = narrow<T>(dka[c]);
        dvh[(size_t)j * e + c] = narrow<T>(dva[c]);
      }
    }
  }
}

// Backward of the staged form.  Shared memory: Q and dO rows [2][Lq][DP + 4],
// K and V rows [2][Lk][DP + 4], then the P and dS tiles [2][Lq][Lk].
template <typename T, int DP, int KPL>
__device__ __forceinline__ void bwd_staged(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ doh, T* __restrict__ dqh,
    T* __restrict__ dkh, T* __restrict__ dvh, const Dims& s, int e,
    float* smem) {
  constexpr int kRow = kStagedRow<DP>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool vec = s.vec != 0;
  float* qs = smem;
  float* gs = qs + s.lq * kRow;
  float* ks = gs + s.lq * kRow;
  float* vs = ks + s.lk * kRow;
  float* ps = vs + s.lk * kRow;
  float* dss = ps + s.lq * s.lk;
  stage_rows<DP>(qs, qh, s.lq, s.d, e, vec);
  stage_rows<DP>(gs, doh, s.lq, s.d, e, vec);
  stage_rows<DP>(ks, kh, s.lk, s.d, e, vec);
  stage_rows<DP>(vs, vh, s.lk, s.d, e, vec);
  staged_barrier();

  // (a) Rows on warps, keys on lanes: each row's P and dS once, and dQ.
  // Entries (i, j) past a causal row's live keys are never written: phase
  // (b) reads row i of key j only where j <= i.
  for (int i = warp; i < s.lq; i += warps) {
    float qr[DP], gr[DP];
    shared_row(qs + i * kRow, qr);
    shared_row(gs + i * kRow, gr);
    const int live = s.causal ? min(s.lk, i + 1) : s.lk;
    float kk[KPL][DP];
    float p[KPL], ds[KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      p[m] = -INFINITY;
      if (j < live) {
        shared_row(ks + j * kRow, kk[m]);
        p[m] = dot(qr, kk[m]) * s.scale;
      }
      mx = fmaxf(mx, p[m]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      p[m] = lane + 32 * m < live ? expf(p[m] - mx) : 0.f;
      sum += p[m];
    }
    sum = warp_sum(sum);
    float rd = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      ds[m] = 0.f;
      if (j < live) {
        float vv[DP];
        shared_row(vs + j * kRow, vv);
        p[m] = p[m] / sum;
        ds[m] = dot(gr, vv);  // dP
        rd += p[m] * ds[m];
      }
    }
    rd = warp_sum(rd);
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll
    for (int m = 0; m < KPL; ++m) {
      const int j = lane + 32 * m;
      if (j < live) {
        ds[m] = p[m] * (ds[m] - rd) * s.scale;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds[m], kk[m][c], acc[c]);
        ps[i * s.lk + j] = p[m];
        dss[i * s.lk + j] = ds[m];
      }
    }
    write_row(acc, lane, dqh + (size_t)i * e, s.d, 1.f);
  }
  __syncthreads();

  // (b) dK = dS^T Q and dV = P^T dO over every thread: four columns of one
  // key a thread, summed over the rows in order.  A warp covers 8 keys: its
  // dS / P reads are 8 neighbouring words, its Q / dO reads one 64-byte row
  // piece, each shared by broadcast.
  constexpr int kQuads = DP / 4;
  const int tasks = s.lk * kQuads;
  for (int t = threadIdx.x; t < 2 * tasks; t += blockDim.x) {
    const bool is_v = t >= tasks;
    const int r = is_v ? t - tasks : t;
    const int j = r / kQuads;
    const int c = (r - j * kQuads) * 4;
    const float* w = is_v ? ps : dss;
    const float* x = (is_v ? gs : qs) + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = s.causal ? j : 0; i < s.lq; ++i) {
      const float a = w[i * s.lk + j];
      const float4 y = *reinterpret_cast<const float4*>(x + i * kRow);
      acc.x = fmaf(a, y.x, acc.x);
      acc.y = fmaf(a, y.y, acc.y);
      acc.z = fmaf(a, y.z, acc.z);
      acc.w = fmaf(a, y.w, acc.w);
    }
    T* dst = (is_v ? dvh : dkh) + (size_t)j * e + c;
    if (vec) {
      store4(dst, acc);
    } else {
      const float out[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int x4 = 0; x4 < 4; ++x4) {
        if (c + x4 < s.d) dst[x4] = narrow<T>(out[x4]);
      }
    }
  }
}

template <typename T, int DP, int KPL>
__global__ void __launch_bounds__(256)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, Dims s) {
  extern __shared__ float4 shared4[];
  float* smem = reinterpret_cast<float*>(shared4);
  const int b = blockIdx.x / s.heads;
  const int h = blockIdx.x - b * s.heads;
  const int e = s.heads * s.d;
  const size_t q_off = (size_t)b * s.lq * e + (size_t)h * s.d;
  const size_t kv_off = (size_t)b * s.lk * e + (size_t)h * s.d;
  if constexpr (kStaged<DP, KPL>) {
    bwd_staged<T, DP, KPL>(q + q_off, k + kv_off, v + kv_off, dout + q_off,
                        dq + q_off, dk + kv_off, dv + kv_off, s, e, smem);
  } else if constexpr (KPL > 0) {
    bwd_registers<T, DP, KPL>(q + q_off, k + kv_off, v + kv_off, dout + q_off,
                           dq + q_off, dk + kv_off, dv + kv_off, s, e, smem);
  } else {
    bwd_streamed<T, DP>(q + q_off, k + kv_off, v + kv_off, dout + q_off,
                     dq + q_off, dk + kv_off, dv + kv_off, s, e, smem);
  }
}

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, Dims);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const T*, T*, T*,
                           T*, Dims);

template <typename T>
FwdKernel<T> fwd_instance(int dp, int kpl) {
#define DTQN_PICK(D, K) \
  if (dp == D && kpl == K) return attention_fwd_kernel<T, D, K>;
  DTQN_INSTANCES(DTQN_PICK)
#undef DTQN_PICK
  return nullptr;
}

template <typename T>
BwdKernel<T> bwd_instance(int dp, int kpl) {
#define DTQN_PICK(D, K) \
  if (dp == D && kpl == K) return attention_bwd_kernel<T, D, K>;
  DTQN_INSTANCES(DTQN_PICK)
#undef DTQN_PICK
  return nullptr;
}

// Above 48 KB a block's dynamic shared memory has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Dims make_dims(int lq, int lk, int heads, int head_dim, int causal,
               float scale, int dp, int rows_per_block, uintptr_t ptr_bits) {
  Dims s;
  s.lq = lq;
  s.lk = lk;
  s.heads = heads;
  s.d = head_dim;
  s.causal = causal;
  s.rows_per_block = rows_per_block;
  s.vec = head_dim == dp && (ptr_bits & 15u) == 0;
  s.scale = scale;
  return s;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               int batch, int lq, int lk, int heads, int head_dim, int causal,
               float scale, int dp, int kpl, int warps, int rows_per_block,
               int smem_bytes, void* stream) {
  const FwdKernel<T> kernel = fwd_instance<T>(dp, kpl);
  if (kernel == nullptr || rows_per_block < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Dims s = make_dims(
      lq, lk, heads, head_dim, causal, scale, dp, rows_per_block,
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v);
  const dim3 grid(batch * heads, (lq + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, int batch, int lq, int lk,
               int heads, int head_dim, int causal, float scale, int dp,
               int kpl, int warps, int rows_per_block, int smem_bytes,
               void* stream) {
  const BwdKernel<T> kernel = bwd_instance<T>(dp, kpl);
  if (kernel == nullptr || rows_per_block != lq) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Dims s = make_dims(
      lq, lk, heads, head_dim, causal, scale, dp, rows_per_block,
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
          (uintptr_t)dk | (uintptr_t)dv);
  kernel<<<batch * heads, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, (T*)dk,
      (T*)dv, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `dtype` is the element type's code in DTQN_DTYPES.
int dtqn_attention_fwd(const void* q, const void* k, const void* v, void* o,
                       int dtype, int batch, int lq, int lk, int heads,
                       int head_dim, int causal, float scale, int dp, int kpl,
                       int warps, int rows_per_block, int smem_bytes,
                       void* stream) {
#define DTQN_TYPED(CODE, T)                                                 \
  if (dtype == CODE) {                                                      \
    return launch_fwd<T>(q, k, v, o, batch, lq, lk, heads, head_dim, causal, \
                         scale, dp, kpl, warps, rows_per_block, smem_bytes,  \
                         stream);                                           \
  }
  DTQN_DTYPES(DTQN_TYPED)
#undef DTQN_TYPED
  return (int)cudaErrorInvalidValue;
}

int dtqn_attention_bwd(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       int dtype, int batch, int lq, int lk, int heads,
                       int head_dim, int causal, float scale, int dp, int kpl,
                       int warps, int rows_per_block, int smem_bytes,
                       void* stream) {
#define DTQN_TYPED(CODE, T)                                                   \
  if (dtype == CODE) {                                                        \
    return launch_bwd<T>(q, k, v, dout, dq, dk, dv, batch, lq, lk, heads,      \
                         head_dim, causal, scale, dp, kpl, warps,             \
                         rows_per_block, smem_bytes, stream);                 \
  }
  DTQN_DTYPES(DTQN_TYPED)
#undef DTQN_TYPED
  return (int)cudaErrorInvalidValue;
}

const char* dtqn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
