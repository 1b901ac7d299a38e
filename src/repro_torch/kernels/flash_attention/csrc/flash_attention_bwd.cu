// Backward of the dense flash attention (B3), written for Hopper (sm_90a).
//
// The Pallas TPU kernel it goes with,
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel,
// has no backward: the reference trains through the plain
// common.chunked_attention, which XLA differentiates.  This is that
// gradient for the function B3 computes: for batch b, query head h at
// position q_pos, softmax over the keys k_pos of kv head h / (Hq / Hkv)
// with k_pos < Sk, k_pos <= q_pos when causal and q_pos - k_pos < window
// when window > 0, scale 1/sqrt(DQK).  With P the softmax weights
// (recomputed from the forward's log-sum-exp, lse) and dO the output's
// gradient:
//   D  = rowsum(dO * O)                 (dot_kernel)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = dS^T Q * scale                 (dkdv_kernel)
//   dQ = dS K * scale                   (dq_kernel)
// GQA by the forward's folded rows (row j = position * r + head-in-group,
// one (batch, kv head) per block), so dK and dV sum over the r query heads
// of their kv head inside one block.  Rows that see no key (lse -inf) get
// zero gradient and give none.  dQ is a second pass over the keys rather
// than atomics, so every gradient is summed in one fixed order and a run
// repeats bit for bit.
//
// What bounds it on the H100.  2.5 times the forward's products (five
// products of the forward's size where the forward has two): at
// qwen1.5-0.5b's training shape (B 8, 16 MHA heads, dh 64, S 4096,
// causal, bf16) 6.9e11 FLOP against 0.4 GB of q, k, v, o, dO, lse, D and
// the three gradients, about 1700 FLOP per byte: the tensor cores.
//
// What this design does about it: the forward's mma.sync tile
// (../../csrc/mma_tiles.cuh), right before fast.
//  - bf16: every product is mma.sync.m16n8k16 with fp32 accumulators;
//    operands from shared memory by ldmatrix (.trans where the product
//    runs over rows), P and dS rounded to bf16 in registers as A
//    operands.  fp32: the same tiles as FMAs on the CUDA cores (never
//    TF32), P and dS through shared memory; the dtype alone picks.
//  - dK/dV: a block owns 64 keys (16 per warp) of one (batch, kv head),
//    K and V in shared memory, and walks the tiles of folded query rows
//    (64 rows; 32 at DQK 128, for registers) that can see any of its keys:
//    rows before the first key's position (causal) or past the last key's
//    window are never read.  Q, dO, lse and D tiles come through a
//    two-stage cp.async ring.
//  - dQ: a block owns 64 folded query rows, Q and dO in shared memory, and
//    walks the 64-key tiles (32 in fp32) its rows see, as the forward does.
//  - Instances: (DQK, DV) = (64, 64), (80, 80), (96, 96), (128, 128).
//    MLA's (192, 128) has none; the wrapper refuses it.
// Not yet: wgmma, the dQ pass fused into dK/dV, a persistent schedule.

#include <math.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // keys (dK/dV) or query rows (dQ)
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr int pad_of() {  // 16 bytes of row padding, in elements
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* q;                // (B, Hq, Sq, DQK) by sq
  const void* k;                // (B, Hkv, Sk, DQK) by sk
  const void* v;                // (B, Hkv, Sk, DV) by sv
  const void* dout;             // (B, Hq, Sq, DV) by sdo
  const float* lse;             // (B, Hq, Sq), natural log; -inf: no key
  const float* delta;           // (B, Hq, Sq): rowsum(dO * O)
  void* dq;                     // (B, Hq, Sq, DQK) by sdq
  void* dk;                     // (B, Hkv, Sk, DQK) by sdk
  void* dv;                     // (B, Hkv, Sk, DV) by sdv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int Hq, Sq, Sk, r, M, causal, window;
  float scale, scale_log2;
};

// Copies kN rows of D elements into shared rows of `stride` elements by
// 16-byte cp.async: row i from src(i), zeros where src(i) is null (base is
// any valid address, never read).
template <typename T, int D, int kN, typename Src>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* base,
                                          Src src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
#pragma unroll 4
  for (int c = threadIdx.x; c < kN * kChunks; c += kThreads) {
    const int i = c / kChunks, col = (c % kChunks) * kVec;
    const T* s = src(i);
    cp_async16(dst + i * stride + col, s ? s + col : base, s ? 16 : 0);
  }
}

// c (16 x N, the mma accumulator layout: c[j][e] / c[j][2 + e] is row g /
// g + 8 at column 8 j + 2 t + e) += A B^T, where A is 16 rows at a_s and
// B's N rows are at b_s, both row-major and KD wide in shared memory.
template <typename T, int N, int KD>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const T* a_s,
                                        int as, const T* b_s, int bs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    const float* a0 = a_s + g * as;
    const float* a1 = a0 + 8 * as;
#pragma unroll 2
    for (int d = 0; d < KD; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 y = *reinterpret_cast<const float4*>(
              b_s + (8 * j + 2 * t + e) * bs + d);
          c[j][e] = dot4(x0, y, c[j][e]);
          c[j][2 + e] = dot4(x1, y, c[j][2 + e]);
        }
    }
  } else {
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int acol = (lane >> 4) * 8;
    const int brow = (lane & 7) + ((lane >> 4) << 3);
    const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, a_s + arow * as + 16 * kk + acol);
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b_s + (16 * nn + brow) * bs + 16 * kk + bcol);
        mma_bf16(c[2 * nn], af, bfr[0], bfr[1]);
        mma_bf16(c[2 * nn + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

// o (16 x DN) += P B, where P (16 x KN) is in registers in the
// accumulator layout and B (KN x DN) is row-major at b_s.  bf16: P rounded
// to bf16 as the A operand, o in the accumulator layout.  fp32: P through
// the warp's 16 x (KN + 4) floats at ps; o[2 jj] / o[2 jj + 1] is row g /
// g + 8 at columns 16 jj + 4 t .. + 3.
template <typename T, int KN, int DN>
__device__ __forceinline__ void mma_pb(float (&o)[DN / 8][4],
                                       const float (&p)[KN / 8][4],
                                       const T* b_s, int bs, float* ps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kP = KN + 4;
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) {
      *reinterpret_cast<float2*>(ps + g * kP + 8 * j + 2 * t) =
          make_float2(p[j][0], p[j][1]);
      *reinterpret_cast<float2*>(ps + (g + 8) * kP + 8 * j + 2 * t) =
          make_float2(p[j][2], p[j][3]);
    }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < KN; ++k) {
      const float pa = ps[g * kP + k], pc = ps[(g + 8) * kP + k];
#pragma unroll
      for (int jj = 0; jj < DN / 16; ++jj) {
        const float4 y =
            *reinterpret_cast<const float4*>(b_s + k * bs + 16 * jj + 4 * t);
        o[2 * jj][0] = fmaf(pa, y.x, o[2 * jj][0]);
        o[2 * jj][1] = fmaf(pa, y.y, o[2 * jj][1]);
        o[2 * jj][2] = fmaf(pa, y.z, o[2 * jj][2]);
        o[2 * jj][3] = fmaf(pa, y.w, o[2 * jj][3]);
        o[2 * jj + 1][0] = fmaf(pc, y.x, o[2 * jj + 1][0]);
        o[2 * jj + 1][1] = fmaf(pc, y.y, o[2 * jj + 1][1]);
        o[2 * jj + 1][2] = fmaf(pc, y.z, o[2 * jj + 1][2]);
        o[2 * jj + 1][3] = fmaf(pc, y.w, o[2 * jj + 1][3]);
      }
    }
    __syncwarp();                               // P read before it is rewritten
  } else {
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DN / 16; ++nd) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, b_s + (16 * kk + vrow) * bs + 16 * nd + vcol);
        mma_bf16(o[2 * nd], a, bfr[0], bfr[1]);
        mma_bf16(o[2 * nd + 1], a, bfr[2], bfr[3]);
      }
    }
  }
}

// Rows g and g + 8 of o (in mma_pb's layout) times mul to r0 / r1 (null:
// not written).
template <typename T, int DN>
__device__ __forceinline__ void store_rows(const float (&o)[DN / 8][4],
                                           T* r0, T* r1, float mul) {
  const int t = threadIdx.x & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int jj = 0; jj < DN / 16; ++jj) {
      const int d = 16 * jj + 4 * t;
      if (r0)
        *reinterpret_cast<float4*>(r0 + d) =
            make_float4(o[2 * jj][0] * mul, o[2 * jj][1] * mul,
                        o[2 * jj][2] * mul, o[2 * jj][3] * mul);
      if (r1)
        *reinterpret_cast<float4*>(r1 + d) =
            make_float4(o[2 * jj + 1][0] * mul, o[2 * jj + 1][1] * mul,
                        o[2 * jj + 1][2] * mul, o[2 * jj + 1][3] * mul);
    }
  } else {
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (r0)
        *reinterpret_cast<__nv_bfloat162*>(r0 + d) =
            __floats2bfloat162_rn(o[j][0] * mul, o[j][1] * mul);
      if (r1)
        *reinterpret_cast<__nv_bfloat162*>(r1 + d) =
            __floats2bfloat162_rn(o[j][2] * mul, o[j][3] * mul);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// The keys folded row j sees: [lo, hi), with hi = 0 past the rows.
__device__ __forceinline__ int2 key_range(const Args& a, int j) {
  if (j >= a.M) return make_int2(0, 0);
  const int pos = j / a.r;
  return make_int2(a.window > 0 ? max(0, pos - a.window + 1) : 0,
                   a.causal ? min(a.Sk, pos + 1) : a.Sk);
}

// lse in log2 units (+inf for a row that saw no key, so its P is 0) and D
// of folded row j of (b, kv head hk)
__device__ __forceinline__ float2 row_stats(const Args& a, int b, int hk,
                                            int j) {
  const long long idx =
      (static_cast<long long>(b) * a.Hq + hk * a.r + j % a.r) * a.Sq +
      j / a.r;
  const float l = a.lse[idx];
  return make_float2(l == -INFINITY ? INFINITY : l * kLog2e, a.delta[idx]);
}

// ------------------------------------------------------------ D pass
// One warp per (b, h, position) row: D = sum over DV of dO * O in fp32.
template <typename T>
__global__ void __launch_bounds__(256)
    dot_kernel(const T* out, const T* dout, float* delta, long long so0,
               long long so1, long long so2, long long sd0, long long sd1,
               long long sd2, int Hq, int Sq, int DV, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long pos = row % Sq, bh = row / Sq;
  const long long h = bh % Hq, b = bh / Hq;
  const T* o = out + b * so0 + h * so1 + pos * so2;
  const T* g = dout + b * sd0 + h * sd1 + pos * sd2;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32)
    acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------- dK/dV pass
template <typename T, int DQK, int DV>
struct DkdvLayout {
  static constexpr int kNQ = DQK > 96 ? 32 : 64;    // query rows per tile
  static constexpr int kS = DQK + pad_of<T>();       // Q and K row
  static constexpr int kVS = DV + pad_of<T>();       // V and dO row
  static constexpr size_t kK = size_t(kRows) * kS * sizeof(T);
  static constexpr size_t kV = size_t(kRows) * kVS * sizeof(T);
  static constexpr size_t kQ = size_t(kStages) * kNQ * kS * sizeof(T);
  static constexpr size_t kDO = size_t(kStages) * kNQ * kVS * sizeof(T);
  // per stage and row: lse (log2), D, key lo, key hi
  static constexpr size_t kStat = size_t(kStages) * kNQ * 4 * 4;
  static constexpr size_t kP = std::is_same<T, float>::value
                                   ? size_t(kWarps) * 16 * (kNQ + 4) * 4
                                   : 0;
  static constexpr size_t kBytes = kK + kV + kQ + kDO + kStat + kP;
};

// Grid (Hkv, B, key tiles of 64).  Warp w owns keys n0 + 16 w .. + 15;
// lane (g, t) their rows g and g + 8.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = DkdvLayout<T, DQK, DV>;
  constexpr int kNQ = L::kNQ, kS = L::kS, kVS = L::kVS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + L::kK);
  T* q_s = reinterpret_cast<T*>(smem + L::kK + L::kV);
  T* do_s = reinterpret_cast<T*>(smem + L::kK + L::kV + L::kQ);
  float* st_s =
      reinterpret_cast<float*>(smem + L::kK + L::kV + L::kQ + L::kDO);
  float* p_s = reinterpret_cast<float*>(smem + L::kK + L::kV + L::kQ +
                                        L::kDO + L::kStat);

  const int hk = blockIdx.x, b = blockIdx.y, n0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = a.r, M = a.M;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] +
                static_cast<long long>(hk) * r * a.sq[1];
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo[0] +
                 static_cast<long long>(hk) * r * a.sdo[1];
  const int n_hi = min(n0 + kRows, a.Sk);           // keys [n0, n_hi)

  // the folded rows that see some key of the tile: [j_lo, j_hi)
  const int j_lo = a.causal ? n0 * r : 0;
  const int j_hi =
      a.window > 0
          ? static_cast<int>(min(static_cast<long long>(M),
                                 (static_cast<long long>(n_hi) - 1 +
                                  a.window) * r))
          : M;
  const int qt_lo = j_lo / kNQ;
  const int n_tiles = j_hi > j_lo ? (j_hi + kNQ - 1) / kNQ - qt_lo : 0;

  load_rows<T, DQK, kRows>(k_s, kS, kb, [&](int i) -> const T* {
    return n0 + i < n_hi ? kb + static_cast<long long>(n0 + i) * a.sk[2]
                         : nullptr;
  });
  load_rows<T, DV, kRows>(v_s, kVS, vb, [&](int i) -> const T* {
    return n0 + i < n_hi ? vb + static_cast<long long>(n0 + i) * a.sv[2]
                         : nullptr;
  });
  cp_async_commit();                            // group: K, V

  auto load_q = [&](int it, int stage) {
    const int j0 = (qt_lo + it) * kNQ;
    load_rows<T, DQK, kNQ>(q_s + stage * kNQ * kS, kS, qb,
                           [&](int i) -> const T* {
                             const int j = j0 + i;
                             return j < M ? qb + (j / r) * a.sq[2] +
                                                (j % r) * a.sq[1]
                                          : nullptr;
                           });
    load_rows<T, DV, kNQ>(do_s + stage * kNQ * kVS, kVS, dob,
                          [&](int i) -> const T* {
                            const int j = j0 + i;
                            return j < M ? dob + (j / r) * a.sdo[2] +
                                               (j % r) * a.sdo[1]
                                         : nullptr;
                          });
    float* st = st_s + stage * kNQ * 4;
    for (int i = tid; i < kNQ; i += kThreads) {
      const int j = j0 + i;
      const int2 kr = key_range(a, j);
      const float2 sd = j < M ? row_stats(a, b, hk, j)
                              : make_float2(INFINITY, 0.f);
      st[i] = sd.x;
      st[kNQ + i] = sd.y;
      reinterpret_cast<int*>(st)[2 * kNQ + i] = kr.x;
      reinterpret_cast<int*>(st)[3 * kNQ + i] = kr.y;
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();                            // group: query tile 0

  float dk[DQK / 8][4], dv[DV / 8][4];
  zero(dk);
  zero(dv);
  const int key0 = n0 + 16 * warp + g, key1 = key0 + 8;
  float* ps = p_s + warp * 16 * (kNQ + 4);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();                         // tile it has landed
    __syncthreads();                            // ... for every thread, and
                                                // tile it - 1's stage is free
    if (it + 1 < n_tiles) load_q(it + 1, (it + 1) % kStages);
    cp_async_commit();
    const int stage = it % kStages;
    const T* qs = q_s + stage * kNQ * kS;
    const T* dos = do_s + stage * kNQ * kVS;
    const float* st = st_s + stage * kNQ * 4;
    const int* lo = reinterpret_cast<const int*>(st) + 2 * kNQ;
    const int* hi = reinterpret_cast<const int*>(st) + 3 * kNQ;

    // P^T (keys x rows) = exp2(K Q^T * scale_log2 - lse2), masked
    float s[kNQ / 8][4];
    zero(s);
    mma_abt<T, kNQ, DQK>(s, k_s + 16 * warp * kS, kS, qs, kS);
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = st[c];
        s[j][e] = key0 >= lo[c] && key0 < hi[c]
                      ? ex2(s[j][e] * a.scale_log2 - l2)
                      : 0.f;
        s[j][2 + e] = key1 >= lo[c] && key1 < hi[c]
                          ? ex2(s[j][2 + e] * a.scale_log2 - l2)
                          : 0.f;
      }
    // dP^T = V dO^T; dV += P^T dO
    float dp[kNQ / 8][4];
    zero(dp);
    mma_abt<T, kNQ, DV>(dp, v_s + 16 * warp * kVS, kVS, dos, kVS);
    mma_pb<T, kNQ, DV>(dv, s, dos, kVS, ps);
    // dS^T = P^T * (dP^T - D); dK += dS^T Q (scaled at the end)
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D = st[kNQ + 8 * j + 2 * t + e];
        dp[j][e] = s[j][e] * (dp[j][e] - D);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - D);
      }
    mma_pb<T, kNQ, DQK>(dk, dp, qs, kS, ps);
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(a.dk) + b * a.sdk[0] + hk * a.sdk[1];
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv[0] + hk * a.sdv[1];
  store_rows<T, DQK>(dk, key0 < a.Sk ? dkb + key0 * a.sdk[2] : nullptr,
                     key1 < a.Sk ? dkb + key1 * a.sdk[2] : nullptr, a.scale);
  store_rows<T, DV>(dv, key0 < a.Sk ? dvb + key0 * a.sdv[2] : nullptr,
                    key1 < a.Sk ? dvb + key1 * a.sdv[2] : nullptr, 1.f);
}

// ------------------------------------------------------------- dQ pass
template <typename T, int DQK, int DV>
struct DqLayout {
  static constexpr int kN = std::is_same<T, float>::value ? 32 : 64;  // keys
  static constexpr int kS = DQK + pad_of<T>();
  static constexpr int kVS = DV + pad_of<T>();
  static constexpr size_t kQ = size_t(kRows) * kS * sizeof(T);
  static constexpr size_t kDO = size_t(kRows) * kVS * sizeof(T);
  static constexpr size_t kK = size_t(kStages) * kN * kS * sizeof(T);
  static constexpr size_t kV = size_t(kStages) * kN * kVS * sizeof(T);
  static constexpr size_t kP = std::is_same<T, float>::value
                                   ? size_t(kWarps) * 16 * (kN + 4) * 4
                                   : 0;
  static constexpr size_t kBytes = kQ + kDO + kK + kV + kP;
};

// Grid (Hkv, B, tiles of 64 folded query rows), the last (heaviest under a
// causal mask) tiles first.  Warp w owns rows m0 + 16 w .. + 15; lane
// (g, t) rows g and g + 8 of them.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = DqLayout<T, DQK, DV>;
  constexpr int kN = L::kN, kS = L::kS, kVS = L::kVS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + L::kQ);
  T* k_s = reinterpret_cast<T*>(smem + L::kQ + L::kDO);
  T* v_s = reinterpret_cast<T*>(smem + L::kQ + L::kDO + L::kK);
  float* p_s =
      reinterpret_cast<float*>(smem + L::kQ + L::kDO + L::kK + L::kV);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int m0 = static_cast<int>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = a.r, M = a.M;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] +
                static_cast<long long>(hk) * r * a.sq[1];
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo[0] +
                 static_cast<long long>(hk) * r * a.sdo[1];

  // keys any row of the tile sees: [kbeg, kend)
  const int kend = key_range(a, min(m0 + kRows, M) - 1).y;
  const int kbeg = key_range(a, m0).x;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kN - 1) / kN : 0;

  load_rows<T, DQK, kRows>(q_s, kS, qb, [&](int i) -> const T* {
    const int j = m0 + i;
    return j < M ? qb + (j / r) * a.sq[2] + (j % r) * a.sq[1] : nullptr;
  });
  load_rows<T, DV, kRows>(do_s, kVS, dob, [&](int i) -> const T* {
    const int j = m0 + i;
    return j < M ? dob + (j / r) * a.sdo[2] + (j % r) * a.sdo[1] : nullptr;
  });
  cp_async_commit();                            // group: Q, dO
  auto load_kv = [&](int it, int stage) {
    const int k0 = kbeg + it * kN;
    load_rows<T, DQK, kN>(k_s + stage * kN * kS, kS, kb,
                          [&](int i) -> const T* {
                            return k0 + i < kend
                                       ? kb + static_cast<long long>(k0 + i) *
                                                  a.sk[2]
                                       : nullptr;
                          });
    load_rows<T, DV, kN>(v_s + stage * kN * kVS, kVS, vb,
                         [&](int i) -> const T* {
                           return k0 + i < kend
                                      ? vb + static_cast<long long>(k0 + i) *
                                                 a.sv[2]
                                      : nullptr;
                         });
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();                            // group: key tile 0

  const int j0 = m0 + 16 * warp + g, j1 = j0 + 8;
  const bool warp_live = m0 + 16 * warp < M;
  const int2 kr0 = key_range(a, j0), kr1 = key_range(a, j1);
  const float2 sd0 = j0 < M ? row_stats(a, b, hk, j0)
                            : make_float2(INFINITY, 0.f);
  const float2 sd1 = j1 < M ? row_stats(a, b, hk, j1)
                            : make_float2(INFINITY, 0.f);
  float dq[DQK / 8][4];
  zero(dq);
  float* ps = p_s + warp * 16 * (kN + 4);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();                         // Q, dO and tile it landed
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) % kStages);
    cp_async_commit();
    if (!warp_live) continue;
    const int stage = it % kStages;
    const T* ks = k_s + stage * kN * kS;
    const T* vs = v_s + stage * kN * kVS;
    const int k0 = kbeg + it * kN;

    // P = exp2(Q K^T * scale_log2 - lse2), masked
    float s[kN / 8][4];
    zero(s);
    mma_abt<T, kN, DQK>(s, q_s + 16 * warp * kS, kS, ks, kS);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        s[j][e] = key >= kr0.x && key < kr0.y
                      ? ex2(s[j][e] * a.scale_log2 - sd0.x)
                      : 0.f;
        s[j][2 + e] = key >= kr1.x && key < kr1.y
                          ? ex2(s[j][2 + e] * a.scale_log2 - sd1.x)
                          : 0.f;
      }
    // dP = dO V^T; dS = P * (dP - D); dQ += dS K (scaled at the end)
    float dp[kN / 8][4];
    zero(dp);
    mma_abt<T, kN, DV>(dp, do_s + 16 * warp * kVS, kVS, vs, kVS);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - sd0.y);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - sd1.y);
      }
    mma_pb<T, kN, DQK>(dq, dp, ks, kS, ps);
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  T* dqb = static_cast<T*>(a.dq) + b * a.sdq[0] +
           static_cast<long long>(hk) * r * a.sdq[1];
  store_rows<T, DQK>(
      dq, j0 < M ? dqb + (j0 / r) * a.sdq[2] + (j0 % r) * a.sdq[1] : nullptr,
      j1 < M ? dqb + (j1 / r) * a.sdq[2] + (j1 % r) * a.sdq[1] : nullptr,
      a.scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;          // above 48 KB of shared
  const cudaError_t err = cudaFuncSetAttribute(  // memory only when asked
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int DQK, int DV>
cudaError_t launch_dkdv(const Args& a, int B, int Hkv, cudaStream_t stream) {
  using L = DkdvLayout<T, DQK, DV>;
  static bool configured = false;
  cudaError_t err =
      allow_smem(dkdv_kernel<T, DQK, DV>, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.Sk + kRows - 1) / kRows;
  if (n_kt > 65535) return cudaErrorInvalidValue;
  dkdv_kernel<T, DQK, DV>
      <<<dim3(Hkv, B, n_kt), kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_dq(const Args& a, int B, int Hkv, cudaStream_t stream) {
  using L = DqLayout<T, DQK, DV>;
  static bool configured = false;
  cudaError_t err = allow_smem(dq_kernel<T, DQK, DV>, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.M + kRows - 1) / kRows;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dq_kernel<T, DQK, DV><<<dim3(Hkv, B, n_qt), kThreads, L::kBytes, stream>>>(
      a);
  return cudaGetLastError();
}

// pass 0: dK/dV, pass 1: dQ; the (DQK, DV) pairs the backward is built for
template <typename T>
cudaError_t dispatch(int pass, int dh, int dv, const Args& a, int B, int Hkv,
                     cudaStream_t s) {
  if (dh != dv) return cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return pass ? launch_dq<T, 64, 64>(a, B, Hkv, s)
                  : launch_dkdv<T, 64, 64>(a, B, Hkv, s);
    case 80:
      return pass ? launch_dq<T, 80, 80>(a, B, Hkv, s)
                  : launch_dkdv<T, 80, 80>(a, B, Hkv, s);
    case 96:
      return pass ? launch_dq<T, 96, 96>(a, B, Hkv, s)
                  : launch_dkdv<T, 96, 96>(a, B, Hkv, s);
    case 128:
      return pass ? launch_dq<T, 128, 128>(a, B, Hkv, s)
                  : launch_dkdv<T, 128, 128>(a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run_pass(int pass, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dq, void* dk, void* dv, const long long* strides, int B,
             int Hq, int Hkv, int Sq, int Sk, int dh, int dvw, int causal,
             int window, float scale, int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0 || Sk == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      static_cast<long long>(Sq) * (Hq / Hkv) > (1LL << 30))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sdo[i] = strides[9 + i];
    a.sdq[i] = strides[12 + i];
    a.sdk[i] = strides[15 + i];
    a.sdv[i] = strides[18 + i];
  }
  a.Hq = Hq;
  a.Sq = Sq;
  a.Sk = Sk;
  a.r = Hq / Hkv;
  a.M = Sq * a.r;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(pass, dh, dvw, a, B, Hkv, s);
    case 1:
      return dispatch<bf16>(pass, dh, dvw, a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// D = rowsum(dO * O) in fp32 into delta (B, Hq, Sq), contiguous.  out and
// dout (B, Hq, Sq, dv) by strides (host array of 6: the (B, H, S) axes of
// out, then of dout), head dim contiguous.  dtype: 0 float32, 1 bfloat16.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dot(const void* out, const void* dout,
                                       float* delta,
                                       const long long* strides, int B,
                                       int Hq, int Sq, int dv, int dtype,
                                       void* stream) {
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  if (rows == 0) return 0;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (dtype == 0)
    dot_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, st[0], st[1], st[2], st[3], st[4], st[5], Hq, Sq, dv, rows);
  else if (dtype == 1)
    dot_kernel<bf16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
        st[0], st[1], st[2], st[3], st[4], st[5], Hq, Sq, dv, rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The dK/dV pass: dk (B, Hkv, Sk, dh) and dv (B, Hkv, Sk, dv), every row
// written (zero for a key no row sees).  q, k, v, dout, dq, dk, dv share
// dtype (0 float32, 1 bfloat16) and are read and written by strides (host
// array of 21: the (B, H, S) axes of q, k, v, dout, dq, dk, dv), head dim
// contiguous; lse and delta are the forward's log-sum-exp and the D pass's
// output, (B, Hq, Sq) contiguous fp32.  scale: 1/sqrt(dh).  Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int dh,
    int dvw, int causal, int window, float scale, int dtype, void* stream) {
  return run_pass(0, q, k, v, dout, lse, delta, dq, dk, dv, strides, B, Hq,
                  Hkv, Sq, Sk, dh, dvw, causal, window, scale, dtype, stream);
}

// The dQ pass: dq (B, Hq, Sq, dh), every row written (zero for a row that
// sees no key); arguments as flash_attention_bwd_dkdv's.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int dh,
    int dvw, int causal, int window, float scale, int dtype, void* stream) {
  return run_pass(1, q, k, v, dout, lse, delta, dq, dk, dv, strides, B, Hq,
                  Hkv, Sq, Sk, dh, dvw, causal, window, scale, dtype, stream);
}
