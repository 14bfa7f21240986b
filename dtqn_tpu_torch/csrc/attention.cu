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
// Design (every float32 call, and the bf16 calls that the tensor-core form
// further below does not take): keys on lanes.  A warp takes query rows of
// one (batch, head); lane t owns keys j = t, t + 32, ...  A row's scores
// live in the lanes' registers: the row max, the row sum and
// rowsum(dP * P) are warp shuffles, and P V (or dS K) is a per-lane
// partial of the D columns that a butterfly
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
// No tensor cores in float32 and no TMA: TF32 mma / wgmma keeps about three
// digits, which breaks float32 parity with the plain version (2e-5), and
// the work is small (the B = 1664 forward at D = 16 is 1.09 GFLOP, 0.016 ms
// at the 67 TFLOP/s float32 rate, a third of its byte bound; at B = 32
// latency bounds it); a TMA box needs a tensor map encoded on the host for
// every call, on a path the host already bounds.  The keys-on-lanes
// bfloat16 instances are the float32 ones with other loads and stores: a
// register-keyed head row of 8 bf16 values is one 16-byte load; the staged
// form converts while staging (below), so its shared memory, its padding
// and every shared read are the float32 form's.  They take the bf16 calls
// that the tensor-core form (attention_fwd_mma / attention_bwd_mma, below)
// does not: head widths other than 8 and 16, Lk past 64, and backwards
// past Lq = 64.
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

#include <type_traits>

// The keys-on-lanes (head width, keys per lane) instances; KPL 0 is the
// streamed form.  ops/cuda_attention.py INSTANCES lists the same pairs.
#define DTQN_INSTANCES(X) \
  X(8, 1) X(8, 2) X(16, 2) X(8, 0) X(16, 0) X(32, 0) X(64, 0)

// The tensor-core instances, bfloat16 only, by head width.
// ops/cuda_attention.py MMA_INSTANCES lists the same widths.
#define DTQN_MMA_INSTANCES(X) X(8) X(16)

// The element types, by the code the entry points take; every instance of
// DTQN_INSTANCES is built in each.  ops/cuda_attention.py DTYPES lists them
// in code order.
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

// ---------------------------------------------------------------------------
// The tensor-core form: bfloat16 at head width 8 or 16, Lk <= 64 (and, in the
// backward, Lq <= 64).  It replaces the same two Pallas kernels on the bf16
// calls of every driven path; the keys-on-lanes bf16 instances above keep
// the other shapes.
//
// What bounds it on an H100: the B = 1664 evict forward moves 85 MB (0.025
// ms at 3.35 TB/s) and does ~1 GFLOP; the keys-on-lanes bf16 instance ran it
// at ~10x its byte bound, bound by the issue rate of CUDA-core FMAs,
// shuffles and widening.  Here the products go to the tensor cores with
// mma.sync (m16n8k16, and m16n8k8 for Q K^T and dO V^T at D = 8): a 16-row
// tile of a head is one mma row block at D = 8 or 16 with no padding of the
// depth, where wgmma's 64-row tiles would pad 22% of Lq = 50 and half of
// each product's depth at D = 8, and a TMA tensor map would be encoded on
// the host for every call.  What is left per thread is the softmax of its
// own 2 x 16 scores, two quad shuffles a row statistic, and one 16-byte
// load or store a head row.
//
// Layout: warp w takes query rows 16w..16w+15 of a tile.  The head's Q, K
// and V (backward also dO) rows are staged as bf16 in shared memory by
// 16-byte cp.async, rows past the real ones zero-filled (src-size 0), so a
// padded key gives exactly 0 in P V (0 times a zero row, never 0 times
// garbage).  A staged row is D bf16 padded to an odd multiple of 16 bytes
// (D = 8: 16 bytes; D = 16: 48), so the 8 row addresses of each ldmatrix
// phase fall on 8 different 16-byte bank groups.  Lk is padded to a
// multiple of 16: at most 8 n-tiles of 8 keys, 32 float32 scores a thread.
// The m16n8 accumulator layout of two neighbouring n-tiles is the m16n8k16
// A layout, so P (and dS) feed the next product from registers.
//
// Numerics: Q, K, V and dO are bf16, so the products of Q K^T and dO V^T
// are exact in float32 and only the order of the sums differs from the
// Pallas kernel.  P and dS are float32 there; rounding them once to bf16
// would leave an error of up to 2^-9 sum_j p_j |v_j| in O, more than one
// bf16 ulp of O wherever O cancels.  So each float32 p is split into
// hi = bf16(p) and lo = bf16(p - hi) and both go through the mma into one
// float32 accumulator: the error falls to ~2^-17 sum_j p_j |v_j|.  scale is
// applied in float32 after the product and the softmax uses expf, as the
// other instances do; P is normalised before P V, as the Pallas kernel
// does, but by the reciprocal of the row sum (within an ulp of float32 of
// the division): one division a row.  A division a score put the IEEE
// division's slow path beside each of a thread's 32 scores, and cost the
// forward registers (blocks an SM) and issue slots.
//
// Forward: one block per (batch, head, tile of up to 64 query rows), a warp
// per 16 rows; O goes back through the warp's own staged Q rows so that
// each head row leaves as one 16-byte store.  Backward: one block per
// (batch, head), Lq <= 64.  Phase 1, rows on warps: S and P as the
// forward, dP = dO V^T, rowsum(dP * P) by quad shuffles, dS, dQ = dS K; P
// and dS go to shared [Lq][Lk + 8] tiles as hi / lo bf16 pairs.  One
// barrier.  Phase 2, keys on warps (warp w owns keys 16w..16w+15):
// dV = P^T dO and dK = dS^T Q, the A operands read transposed from the
// tiles by ldmatrix.trans, summed over the row tiles in order.  No atomics:
// two launches give bit-equal gradients.

// keys_per_lane of the tensor-core form in a launch configuration
// (ops/cuda_attention.py MMA_FORM).
constexpr int kMmaForm = -1;
constexpr int kMmaRows = 16;  // query rows of a warp
constexpr int kMmaKeyTiles = 8;  // n-tiles of 8 keys: Lk <= 64

// bf16 per staged head row: an odd multiple of 8 (16 bytes).
template <int D>
constexpr int kMmaPitch = D == 8 ? 8 : D + 8;

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ldmatrix of 2 or 4 8x8 bf16 matrices: lanes 8m..8m+7 give the row
// addresses of matrix m; without .trans lane l receives row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of each; with .trans rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_address(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(shared_address(p))
      : "memory");
}

// d += a b on the tensor cores, float32 accumulator.  m16n8k16: a holds
// rows (g, g + 8) x columns (2t, 2t + 1) and (2t + 8, 2t + 9), b rows
// (2t, 2t + 1) and (2t + 8, 2t + 9) of column g, d rows (g, g + 8) x
// columns (2t, 2t + 1), with g = lane / 4 and t = lane % 4.  m16n8k8 takes
// the first half of a and of b.
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) as hi = bf16 pair rounded to nearest even and lo = the bf16 pair of
// what hi leaves out: hi + lo carries ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - __low2float(h),
                                       y - __high2float(h)));
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// Rows [0, n) of one head (D bf16 at a stride of e) into shared rows of
// kMmaPitch<D> bf16, rows [n, n_pad) zeroed.  With `vec` each row goes as
// D / 8 16-byte copies (zero-filling ones past n); else a value at a time.
// staged_barrier() completes the copies.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int n, int n_pad, int e, bool vec) {
  constexpr int kPitch = kMmaPitch<D>;
  if (vec) {
    constexpr int kPieces = D / 8;
    for (int x = threadIdx.x; x < n_pad * kPieces; x += blockDim.x) {
      const int r = x / kPieces;
      const int c = (x - r * kPieces) * 8;
      const bool live = r < n;
      cp_async16_zfill(dst + r * kPitch + c,
                       live ? src + (size_t)r * e + c : src, live);
    }
  } else {
    for (int x = threadIdx.x; x < n_pad * D; x += blockDim.x) {
      const int r = x / D;
      const int c = x - r * D;
      dst[r * kPitch + c] =
          r < n ? src[(size_t)r * e + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// A 16 x D operand of rows [row, row + 16) of staged rows: Q or dO as the A
// of Q K^T or dO V^T (k = D).
template <int D>
__device__ __forceinline__ void load_rows_a(unsigned (&a)[4],
                                            const __nv_bfloat16* rows,
                                            int lane) {
  constexpr int kPitch = kMmaPitch<D>;
  if constexpr (D == 16) {
    ldmatrix_x4(a, rows + (lane & 15) * kPitch + (lane >> 4) * 8);
  } else {
    unsigned h[2];
    ldmatrix_x2(h, rows + (lane & 15) * kPitch);
    a[0] = h[0];
    a[1] = h[1];
    a[2] = a[3] = 0u;
  }
}

// acc[j] = A B_j for the key n-tiles j < 2 * steps, B_j[k][n] = keys[8j + n][k]
// (K for S = Q K^T, V for dP = dO V^T): two n-tiles per 16 staged keys.
template <int D>
__device__ __forceinline__ void rows_times_keys(
    float (&acc)[kMmaKeyTiles][4], const unsigned (&a)[4],
    const __nv_bfloat16* keys, int steps, int lane) {
  constexpr int kPitch = kMmaPitch<D>;
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kMmaKeyTiles / 2; ++s) {
    if (s < steps) {
      const __nv_bfloat16* kb = keys + 16 * s * kPitch;
      if constexpr (D == 16) {
        // Matrices: keys 0-7 x dims 0-7, 0-7 x 8-15, 8-15 x 0-7, 8-15 x 8-15.
        unsigned b[4];
        ldmatrix_x4(b, kb + ((lane & 7) + ((lane >> 4) << 3)) * kPitch +
                           ((lane >> 3) & 1) * 8);
        mma_k16(acc[2 * s], a, b[0], b[1]);
        mma_k16(acc[2 * s + 1], a, b[2], b[3]);
      } else {
        unsigned b[2];  // keys 0-7, keys 8-15
        ldmatrix_x2(b, kb + (lane & 15) * kPitch);
        mma_k8(acc[2 * s], a[0], a[1], b[0]);
        mma_k8(acc[2 * s + 1], a[0], a[1], b[1]);
      }
    }
  }
}

// out += X V over key steps [0, steps): X (P or dS, float32 in the score
// layout) split into hi and lo bf16 A operands, V (or K for dQ) read
// transposed from staged rows.  out holds D / 8 n-tiles of 8 columns.
template <int D>
__device__ __forceinline__ void scores_times_rows(
    float (&out)[D / 8][4], const float (&x)[kMmaKeyTiles][4],
    const __nv_bfloat16* rows, int steps, int lane) {
  constexpr int kPitch = kMmaPitch<D>;
#pragma unroll
  for (int s = 0; s < kMmaKeyTiles / 2; ++s) {
    if (s < steps) {
      unsigned hi[4], lo[4];
      split_bf16(x[2 * s][0], x[2 * s][1], hi[0], lo[0]);
      split_bf16(x[2 * s][2], x[2 * s][3], hi[1], lo[1]);
      split_bf16(x[2 * s + 1][0], x[2 * s + 1][1], hi[2], lo[2]);
      split_bf16(x[2 * s + 1][2], x[2 * s + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* rb = rows + (16 * s + (lane & 15)) * kPitch;
      if constexpr (D == 16) {
        // Matrices: keys 0-7 x dims 0-7, 8-15 x 0-7, 0-7 x 8-15, 8-15 x 8-15.
        unsigned b[4];
        ldmatrix_x4_trans(b, rb + (lane >> 4) * 8);
        mma_k16(out[0], hi, b[0], b[1]);
        mma_k16(out[0], lo, b[0], b[1]);
        mma_k16(out[1], hi, b[2], b[3]);
        mma_k16(out[1], lo, b[2], b[3]);
      } else {
        unsigned b[2];
        ldmatrix_x2_trans(b, rb);
        mma_k16(out[0], hi, b[0], b[1]);
        mma_k16(out[0], lo, b[0], b[1]);
      }
    }
  }
}

// S (the accumulator of Q K^T) into P in place for the rows ra and ra + 8
// (the thread's c0 / c1 and c2 / c3): scaled, masked where key >= Lk or,
// causal, key > row, softmax over the row with the max subtracted, then
// each p times the reciprocal of the row sum (within an ulp of float32 of
// the division, one division a row instead of one a score).  Key tiles
// past 2 * steps are not touched.
__device__ __forceinline__ void softmax_rows(float (&x)[kMmaKeyTiles][4],
                                             int steps, int ra,
                                             const Dims& s, int lane) {
  const int col0 = 2 * (lane & 3);
  // The last key each row sees.
  const int last_a = s.causal ? min(s.lk - 1, ra) : s.lk - 1;
  const int last_b = s.causal ? min(s.lk - 1, ra + 8) : s.lk - 1;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j) {
    if (j < 2 * steps) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + col0 + c;
        x[j][c] = col <= last_a ? x[j][c] * s.scale : -1e30f;
        x[j][2 + c] = col <= last_b ? x[j][2 + c] * s.scale : -1e30f;
        ma = fmaxf(ma, x[j][c]);
        mb = fmaxf(mb, x[j][2 + c]);
      }
    }
  }
  ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 1));
  ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 2));
  mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 1));
  mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 2));
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j) {
    if (j < 2 * steps) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // A masked score gives exp(-1e30 - m) = 0 exactly.
        x[j][c] = expf(x[j][c] - ma);
        x[j][2 + c] = expf(x[j][2 + c] - mb);
        sa += x[j][c];
        sb += x[j][2 + c];
      }
    }
  }
  sa += __shfl_xor_sync(kFull, sa, 1);
  sa += __shfl_xor_sync(kFull, sa, 2);
  sb += __shfl_xor_sync(kFull, sb, 1);
  sb += __shfl_xor_sync(kFull, sb, 2);
  const float ia = 1.f / sa, ib = 1.f / sb;
#pragma unroll
  for (int j = 0; j < kMmaKeyTiles; ++j) {
    if (j < 2 * steps) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x[j][c] *= ia;
        x[j][2 + c] *= ib;
      }
    }
  }
}

// Rows [0, n) of a warp's 16 staged rows to a head's rows in device memory
// (a stride of e): with `vec` one 16-byte store per 8 values.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* rows, int n,
                                           int e, bool vec, int lane) {
  constexpr int kPitch = kMmaPitch<D>;
  if (vec) {
    constexpr int kPieces = D / 8;
    const int r = lane / kPieces;
    const int c = (lane - r * kPieces) * 8;
    if (r < n) {
      *reinterpret_cast<uint4*>(dst + (size_t)r * e + c) =
          *reinterpret_cast<const uint4*>(rows + r * kPitch + c);
    }
  } else {
    for (int x = lane; x < n * D; x += 32) {
      const int r = x / D;
      const int c = x - r * D;
      dst[(size_t)r * e + c] = rows[r * kPitch + c];
    }
  }
}

// An accumulator of D / 8 n-tiles (rows g and g + 8, columns 2t, 2t + 1 of
// each) into 16 staged rows, rounded to bf16.
template <int D>
__device__ __forceinline__ void accumulator_to_rows(
    __nv_bfloat16* rows, const float (&acc)[D / 8][4], int lane) {
  constexpr int kPitch = kMmaPitch<D>;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(rows + g * kPitch + 8 * n + c) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * kPitch + 8 * n + c) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// Forward.  Shared memory: the tile's query rows, then the head's K and V
// rows, [round16(rows) + 2 * round16(Lk)][kMmaPitch<D>] bf16.
template <int D>
__global__ void __launch_bounds__(128)
attention_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, Dims s) {
  constexpr int kPitch = kMmaPitch<D>;
  extern __shared__ float4 shared4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x / s.heads;
  const int h = blockIdx.x - b * s.heads;
  const int e = s.heads * s.d;
  const int row0 = blockIdx.y * s.rows_per_block;
  const int rows = min(s.lq - row0, s.rows_per_block);
  const int lk16 = round16(s.lk);
  const size_t q_base = ((size_t)b * s.lq + row0) * e + (size_t)h * s.d;
  const size_t kv_base = (size_t)b * s.lk * e + (size_t)h * s.d;
  const bool vec = s.vec != 0;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(shared4);
  __nv_bfloat16* ks = qs + round16(rows) * kPitch;
  __nv_bfloat16* vs = ks + lk16 * kPitch;
  // Keys that some row of this tile sees; the rest of the rows are zeroed.
  const int nk = s.causal ? min(s.lk, row0 + rows) : s.lk;
  stage_bf16<D>(qs, q + q_base, rows, round16(rows), e, vec);
  stage_bf16<D>(ks, k + kv_base, nk, lk16, e, vec);
  stage_bf16<D>(vs, v + kv_base, nk, lk16, e, vec);
  staged_barrier();

  for (int t = warp; t * kMmaRows < rows; t += warps) {
    __nv_bfloat16* tile = qs + t * kMmaRows * kPitch;
    const int ra = row0 + t * kMmaRows + (lane >> 2);
    const int keys = s.causal ? min(s.lk, row0 + (t + 1) * kMmaRows) : s.lk;
    const int steps = (keys + 15) >> 4;
    unsigned a[4];
    load_rows_a<D>(a, tile, lane);
    float x[kMmaKeyTiles][4];
    rows_times_keys<D>(x, a, ks, steps, lane);
    softmax_rows(x, steps, ra, s, lane);
    float acc[D / 8][4] = {};
    scores_times_rows<D>(acc, x, vs, steps, lane);
    // O leaves through the warp's own Q rows, which it no longer reads.
    __syncwarp();
    accumulator_to_rows<D>(tile, acc, lane);
    __syncwarp();
    store_rows<D>(o + q_base + (size_t)t * kMmaRows * e, tile,
                  min(kMmaRows, rows - t * kMmaRows), e, vec, lane);
  }
}

// Backward.  Shared memory: Q and dO rows [2][round16(Lq)][kMmaPitch<D>], K
// and V rows [2][round16(Lk)][kMmaPitch<D>], then the P and dS tiles as hi
// and lo bf16, [4][round16(Lq)][round16(Lk) + 8] (a row of the tiles is an
// odd multiple of 16 bytes, so ldmatrix.trans reads them without bank
// conflicts).
template <int D>
__global__ void __launch_bounds__(128)
attention_bwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, Dims s) {
  constexpr int kPitch = kMmaPitch<D>;
  extern __shared__ float4 shared4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int col0 = 2 * (lane & 3);
  const int b = blockIdx.x / s.heads;
  const int h = blockIdx.x - b * s.heads;
  const int e = s.heads * s.d;
  const size_t q_off = (size_t)b * s.lq * e + (size_t)h * s.d;
  const size_t kv_off = (size_t)b * s.lk * e + (size_t)h * s.d;
  const bool vec = s.vec != 0;
  const int lq16 = round16(s.lq);
  const int lk16 = round16(s.lk);
  const int tp = lk16 + 8;  // tile pitch
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(shared4);
  __nv_bfloat16* gs = qs + lq16 * kPitch;
  __nv_bfloat16* ks = gs + lq16 * kPitch;
  __nv_bfloat16* vs = ks + lk16 * kPitch;
  __nv_bfloat16* p_hi = vs + lk16 * kPitch;
  __nv_bfloat16* p_lo = p_hi + lq16 * tp;
  __nv_bfloat16* ds_hi = p_lo + lq16 * tp;
  __nv_bfloat16* ds_lo = ds_hi + lq16 * tp;
  stage_bf16<D>(qs, q + q_off, s.lq, lq16, e, vec);
  stage_bf16<D>(gs, dout + q_off, s.lq, lq16, e, vec);
  stage_bf16<D>(ks, k + kv_off, s.lk, lk16, e, vec);
  stage_bf16<D>(vs, v + kv_off, s.lk, lk16, e, vec);
  staged_barrier();

  // Phase 1: rows on warps.  A causal row tile sees keys [0, its last row
  // + 1): phase 2 reads key tile w only from row tiles w on, all written.
  for (int t = warp; t * kMmaRows < s.lq; t += warps) {
    const int r0 = t * kMmaRows;
    const int ra = r0 + g;
    const int keys = s.causal ? min(s.lk, r0 + kMmaRows) : s.lk;
    const int steps = (keys + 15) >> 4;
    unsigned a[4];
    load_rows_a<D>(a, qs + r0 * kPitch, lane);
    float x[kMmaKeyTiles][4];  // S, then P
    rows_times_keys<D>(x, a, ks, steps, lane);
    softmax_rows(x, steps, ra, s, lane);
    load_rows_a<D>(a, gs + r0 * kPitch, lane);
    float y[kMmaKeyTiles][4];  // dP, then dS
    rows_times_keys<D>(y, a, vs, steps, lane);
    // Padded query rows take no part: P and dS 0 there.
    const bool live_a = ra < s.lq, live_b = ra + 8 < s.lq;
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaKeyTiles; ++j) {
      if (j < 2 * steps) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (!live_a) x[j][c] = 0.f;
          if (!live_b) x[j][2 + c] = 0.f;
          da += x[j][c] * y[j][c];
          db += x[j][2 + c] * y[j][2 + c];
        }
      }
    }
    da += __shfl_xor_sync(kFull, da, 1);
    da += __shfl_xor_sync(kFull, da, 2);
    db += __shfl_xor_sync(kFull, db, 1);
    db += __shfl_xor_sync(kFull, db, 2);
#pragma unroll
    for (int j = 0; j < kMmaKeyTiles; ++j) {
      if (j < 2 * steps) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // Masked keys have p = 0, so dS = 0 there too.
          y[j][c] = x[j][c] * (y[j][c] - da) * s.scale;
          y[j][2 + c] = x[j][2 + c] * (y[j][2 + c] - db) * s.scale;
        }
        const int at = ra * tp + 8 * j + col0;
        unsigned hi, lo;
        split_bf16(x[j][0], x[j][1], hi, lo);
        *reinterpret_cast<unsigned*>(p_hi + at) = hi;
        *reinterpret_cast<unsigned*>(p_lo + at) = lo;
        split_bf16(x[j][2], x[j][3], hi, lo);
        *reinterpret_cast<unsigned*>(p_hi + at + 8 * tp) = hi;
        *reinterpret_cast<unsigned*>(p_lo + at + 8 * tp) = lo;
        split_bf16(y[j][0], y[j][1], hi, lo);
        *reinterpret_cast<unsigned*>(ds_hi + at) = hi;
        *reinterpret_cast<unsigned*>(ds_lo + at) = lo;
        split_bf16(y[j][2], y[j][3], hi, lo);
        *reinterpret_cast<unsigned*>(ds_hi + at + 8 * tp) = hi;
        *reinterpret_cast<unsigned*>(ds_lo + at + 8 * tp) = lo;
      }
    }
    float acc[D / 8][4] = {};
    scores_times_rows<D>(acc, y, ks, steps, lane);  // dQ = dS K
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        if (r < s.lq) {
          __nv_bfloat16* dst = dq + q_off + (size_t)r * e + 8 * n + col0;
          const __nv_bfloat162 val =
              __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = val;
          } else {
            dst[0] = val.x;
            dst[1] = val.y;
          }
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: keys on warps.  dV = P^T dO and dK = dS^T Q over the row tiles
  // in order; the A operand (16 keys x 16 rows) is a tile block read
  // transposed: matrices rows 0-7 x keys 0-7, rows 0-7 x keys 8-15, rows
  // 8-15 x keys 0-7, rows 8-15 x keys 8-15.
  for (int t = warp; t * kMmaRows < s.lk; t += warps) {
    const int c0 = t * kMmaRows;
    float acc_v[D / 8][4] = {};
    float acc_k[D / 8][4] = {};
    const int tile_at = ((lane & 7) + ((lane >> 4) << 3)) * tp + c0 +
                        ((lane >> 3) & 1) * 8;
    for (int r0 = s.causal ? c0 : 0; r0 < lq16; r0 += kMmaRows) {
      unsigned ph[4], pl[4], dh[4], dl[4];
      ldmatrix_x4_trans(ph, p_hi + r0 * tp + tile_at);
      ldmatrix_x4_trans(pl, p_lo + r0 * tp + tile_at);
      ldmatrix_x4_trans(dh, ds_hi + r0 * tp + tile_at);
      ldmatrix_x4_trans(dl, ds_lo + r0 * tp + tile_at);
      const __nv_bfloat16* gr = gs + (r0 + (lane & 15)) * kPitch;
      const __nv_bfloat16* qr = qs + (r0 + (lane & 15)) * kPitch;
      if constexpr (D == 16) {
        unsigned bg[4], bq[4];
        ldmatrix_x4_trans(bg, gr + (lane >> 4) * 8);
        ldmatrix_x4_trans(bq, qr + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_k16(acc_v[n], ph, bg[2 * n], bg[2 * n + 1]);
          mma_k16(acc_v[n], pl, bg[2 * n], bg[2 * n + 1]);
          mma_k16(acc_k[n], dh, bq[2 * n], bq[2 * n + 1]);
          mma_k16(acc_k[n], dl, bq[2 * n], bq[2 * n + 1]);
        }
      } else {
        unsigned bg[2], bq[2];
        ldmatrix_x2_trans(bg, gr);
        ldmatrix_x2_trans(bq, qr);
        mma_k16(acc_v[0], ph, bg[0], bg[1]);
        mma_k16(acc_v[0], pl, bg[0], bg[1]);
        mma_k16(acc_k[0], dh, bq[0], bq[1]);
        mma_k16(acc_k[0], dl, bq[0], bq[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = c0 + g + 8 * half;
        if (j < s.lk) {
          const size_t at = kv_off + (size_t)j * e + 8 * n + col0;
          const __nv_bfloat162 vk = __floats2bfloat162_rn(
              acc_k[n][2 * half], acc_k[n][2 * half + 1]);
          const __nv_bfloat162 vv = __floats2bfloat162_rn(
              acc_v[n][2 * half], acc_v[n][2 * half + 1]);
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(dk + at) = vk;
            *reinterpret_cast<__nv_bfloat162*>(dv + at) = vv;
          } else {
            dk[at] = vk.x;
            dk[at + 1] = vk.y;
            dv[at] = vv.x;
            dv[at + 1] = vv.y;
          }
        }
      }
    }
  }
}

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, Dims);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const T*, T*, T*,
                           T*, Dims);

template <typename T>
FwdKernel<T> fwd_instance(int dp, int kpl) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#define DTQN_PICK(D) \
  if (dp == D && kpl == kMmaForm) return attention_fwd_mma<D>;
    DTQN_MMA_INSTANCES(DTQN_PICK)
#undef DTQN_PICK
  }
#define DTQN_PICK(D, K) \
  if (dp == D && kpl == K) return attention_fwd_kernel<T, D, K>;
  DTQN_INSTANCES(DTQN_PICK)
#undef DTQN_PICK
  return nullptr;
}

template <typename T>
BwdKernel<T> bwd_instance(int dp, int kpl) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#define DTQN_PICK(D) \
  if (dp == D && kpl == kMmaForm) return attention_bwd_mma<D>;
    DTQN_MMA_INSTANCES(DTQN_PICK)
#undef DTQN_PICK
  }
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
