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
//   dK = dS^T Q * scale                 (the dK/dV pass)
//   dQ = dS K * scale                   (the dQ pass)
// Rows that see no key (lse -inf) get zero gradient and give none.  dQ is
// a second pass over the keys rather than atomics, so every gradient is
// summed in one fixed order and a run repeats bit for bit.  (Folding dQ
// into the dK/dV pass, five products instead of seven, needs an ordered
// fp32 reduction across key blocks to stay deterministic.)
//
// What bounds it on the H100.  2.5 times the forward's products (five
// products of the forward's size where the forward has two; the dQ pass
// recomputes S and dP, seven in all): at qwen1.5-0.5b's training shape
// (B 8, 16 MHA heads, dh 64, S 4096, causal, bf16) 6.9e11 FLOP against
// 0.5 GB of q, k, v, o, dO, lse and the three gradients, about 1300 FLOP
// per byte: the tensor cores.
//
// The D pass writes each row's statistics once, (lse in log2 units, +inf
// where the row sees no key; D) as fp32 pairs (B, Hq, Sq_pad), Sq_pad = Sq
// rounded up to 64 and the pad rows (+inf, 0), so a 64-position tile's
// statistics are 512 aligned bytes that exist.
//
// bf16, what this design does about the bound:
//  - Every product is wgmma m64n64k16 (m64n32k16 for S^T and dP^T above
//    dh 64, m64n16k16 for S and dP at (192, 128)) with fp32 accumulators in registers and both operands in
//    shared memory as TMA's 128-byte swizzle leaves them (a 64-column box
//    per 128-byte row chunk; dh 80 and 96 read a second box whose columns
//    past dh TMA fills with zeros, so the products run 128 wide there).
//    P and dS are rounded to bf16 into a swizzled box of the consumer
//    group's own and read back as the A operand: on this card a product
//    with A in registers cost ~4x one with A in shared memory.  B is read
//    MN-major (wgmma's transpose) where the product runs over positions.
//  - Warp-specialised: a producer warpgroup (one thread issuing; its
//    registers go to the consumers by setmaxnreg) keeps TMA loads of the
//    walked tiles in a ring of 3-4 stages, a full/empty mbarrier pair
//    each; the consumers do no address arithmetic, global loads or
//    block-wide barriers in the loop.
//  - Per query head, not folded rows: the dK/dV block owns 128 keys of one
//    (batch, kv head), a consumer warpgroup 64 of them, and walks for each
//    of the r query heads the 64-position tiles that see one of its keys,
//    dK and dV summed over the heads in registers (above dh 64 once per
//    64-column chunk: ptxas compiles a consumer to about the block's 168
//    registers).  The dQ block owns 64 positions per consumer group (three
//    groups at dh 64, two above) of one query head and walks the 64-key
//    tiles they see.  A (batch, head)'s blocks run together (its K/V or
//    Q/dO stay in L2), the heaviest first.  Q, dO, K and V tiles are
//    boxes of 4-D tensor maps (dh, S, H, B) made from the tensors' own
//    strides, so the model's BSHD views are read in place.
//  - Each tile is classed from its positions and keys: interior (every
//    pair visible: no mask code), masked (the diagonal, a window edge, the
//    ragged end, rows that see no key; one branch-free pass over P) or
//    skipped (no visible pair; the group releases the stage its
//    neighbours need).
//  - Instances: DQK == DV in {64, 80, 96, 128}, and MLA's (DQK 192, DV
//    128): S^T and S run over DQK's 64-column chunks, dP^T and dP over
//    DV's; dK and dQ have DQK's chunks, dV DV's.  There dK/dV walks three
//    times (dK's chunks; dV's two in the first two walks) over a 2-stage
//    ring, and dQ's consumers take each tile's keys in four quarters of
//    16 (m64n16k16), so S and dP take 8 + 8 registers beside dQ's 96.
// fp32 keeps the first design: the same tiles as FMAs on the CUDA cores
// (never TF32) over folded GQA rows (row j = position * r +
// head-in-group), 16-byte cp.async loads into a two-stage ring, P and dS
// through shared memory.

#include <math.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;  // a stats pad, a query tile, a warpgroup's keys

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------ D pass
// One warp per (b, h, position) row of the padded statistics: (lse2, D)
// with D = sum over DV of dO * O in fp32.
template <typename T>
__global__ void __launch_bounds__(256)
    dot_kernel(const T* out, const T* dout, const float* lse, float2* stats,
               long long so0, long long so1, long long so2, long long sd0,
               long long sd1, long long sd2, int Hq, int Sq, int Sq_pad,
               int DV, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long pos = row % Sq_pad, bh = row / Sq_pad;
  const long long h = bh % Hq, b = bh / Hq;
  float acc = 0.f, l2 = INFINITY;
  if (pos < Sq) {
    const T* o = out + b * so0 + h * so1 + pos * so2;
    const T* g = dout + b * sd0 + h * sd1 + pos * sd2;
    for (int d = lane; d < DV; d += 32)
      acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float l = lse[bh * Sq + pos];
    l2 = l == -INFINITY ? INFINITY : l * kLog2e;
  }
  if (lane == 0) stats[row] = make_float2(l2, acc);
}

// ================================================= fp32: CUDA-core passes
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // keys (dK/dV) or query rows (dQ)
constexpr int kStages = 2;
constexpr int kPad = 4;             // 16 bytes of row padding, in floats

struct Args {
  const float* q;               // (B, Hq, Sq, DQK) by sq
  const float* k;               // (B, Hkv, Sk, DQK) by sk
  const float* v;               // (B, Hkv, Sk, DV) by sv
  const float* dout;            // (B, Hq, Sq, DV) by sdo
  const float2* stats;          // (B, Hq, Sq_pad): (lse2, D)
  float* dq;                    // (B, Hq, Sq, DQK) by sdq
  float* dk;                    // (B, Hkv, Sk, DQK) by sdk
  float* dv;                    // (B, Hkv, Sk, DV) by sdv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int Hq, Sq, Sk, Sq_pad, r, M, causal, window;
  float scale, scale_log2;
};

// Copies kN rows of D floats into shared rows of `stride` floats by
// 16-byte cp.async: row i from src(i), zeros where src(i) is null (base is
// any valid address, never read).
template <int D, int kN, typename Src>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* base, Src src) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < kN * kChunks; c += kThreads) {
    const int i = c / kChunks, col = (c % kChunks) * 4;
    const float* s = src(i);
    cp_async16(dst + i * stride + col, s ? s + col : base, s ? 16 : 0);
  }
}

// c (16 x N, the mma accumulator layout: c[j][e] / c[j][2 + e] is row g /
// g + 8 at column 8 j + 2 t + e) += A B^T, where A is 16 rows at a_s and
// B's N rows are at b_s, both row-major and KD wide in shared memory.
template <int N, int KD>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4],
                                        const float* a_s, int as,
                                        const float* b_s, int bs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
}

// o (16 x DN) += P B, where P (16 x KN) is in registers in the
// accumulator layout and B (KN x DN) is row-major at b_s; P goes through
// the warp's 16 x (KN + 4) floats at ps.  o[2 jj] / o[2 jj + 1] is row g /
// g + 8 at columns 16 jj + 4 t .. + 3.
template <int KN, int DN>
__device__ __forceinline__ void mma_pb(float (&o)[DN / 8][4],
                                       const float (&p)[KN / 8][4],
                                       const float* b_s, int bs, float* ps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
  __syncwarp();                                 // P read before it is rewritten
}

// Rows g and g + 8 of o (in mma_pb's layout) times mul to r0 / r1 (null:
// not written).
template <int DN>
__device__ __forceinline__ void store_rows(const float (&o)[DN / 8][4],
                                           float* r0, float* r1, float mul) {
  const int t = threadIdx.x & 3;
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

// (lse2, D) of folded row j of (b, kv head hk)
__device__ __forceinline__ float2 row_stats(const Args& a, int b, int hk,
                                            int j) {
  return a.stats[(static_cast<long long>(b) * a.Hq + hk * a.r + j % a.r) *
                     a.Sq_pad +
                 j / a.r];
}

template <int DQK, int DV>
struct DkdvLayout {
  static constexpr int kNQ = DQK > 96 ? 32 : 64;    // query rows per tile
  static constexpr int kS = DQK + kPad;              // Q and K row
  static constexpr int kVS = DV + kPad;              // V and dO row
  static constexpr size_t kK = size_t(kRows) * kS * 4;
  static constexpr size_t kV = size_t(kRows) * kVS * 4;
  static constexpr size_t kQ = size_t(kStages) * kNQ * kS * 4;
  static constexpr size_t kDO = size_t(kStages) * kNQ * kVS * 4;
  // per stage and row: lse (log2), D, key lo, key hi
  static constexpr size_t kStat = size_t(kStages) * kNQ * 4 * 4;
  static constexpr size_t kP = size_t(kWarps) * 16 * (kNQ + 4) * 4;
  // (192, 128): 50,176 + 33,792 + 50,176 + 33,792 + 1,024 + 9,216
  // = 178,176 bytes
  static constexpr size_t kBytes = kK + kV + kQ + kDO + kStat + kP;
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// Grid (Hkv, B, key tiles of 64).  Warp w owns keys n0 + 16 w .. + 15;
// lane (g, t) their rows g and g + 8.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using L = DkdvLayout<DQK, DV>;
  constexpr int kNQ = L::kNQ, kS = L::kS, kVS = L::kVS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = reinterpret_cast<float*>(smem + L::kK);
  float* q_s = reinterpret_cast<float*>(smem + L::kK + L::kV);
  float* do_s = reinterpret_cast<float*>(smem + L::kK + L::kV + L::kQ);
  float* st_s =
      reinterpret_cast<float*>(smem + L::kK + L::kV + L::kQ + L::kDO);
  float* p_s = reinterpret_cast<float*>(smem + L::kK + L::kV + L::kQ +
                                        L::kDO + L::kStat);

  const int hk = blockIdx.x, b = blockIdx.y, n0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = a.r, M = a.M;
  const float* kb = a.k + b * a.sk[0] + hk * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + hk * a.sv[1];
  const float* qb =
      a.q + b * a.sq[0] + static_cast<long long>(hk) * r * a.sq[1];
  const float* dob =
      a.dout + b * a.sdo[0] + static_cast<long long>(hk) * r * a.sdo[1];
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

  load_rows<DQK, kRows>(k_s, kS, kb, [&](int i) -> const float* {
    return n0 + i < n_hi ? kb + static_cast<long long>(n0 + i) * a.sk[2]
                         : nullptr;
  });
  load_rows<DV, kRows>(v_s, kVS, vb, [&](int i) -> const float* {
    return n0 + i < n_hi ? vb + static_cast<long long>(n0 + i) * a.sv[2]
                         : nullptr;
  });
  cp_async_commit();                            // group: K, V

  auto load_q = [&](int it, int stage) {
    const int j0 = (qt_lo + it) * kNQ;
    load_rows<DQK, kNQ>(q_s + stage * kNQ * kS, kS, qb,
                        [&](int i) -> const float* {
                          const int j = j0 + i;
                          return j < M ? qb + (j / r) * a.sq[2] +
                                             (j % r) * a.sq[1]
                                       : nullptr;
                        });
    load_rows<DV, kNQ>(do_s + stage * kNQ * kVS, kVS, dob,
                       [&](int i) -> const float* {
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
    const float* qs = q_s + stage * kNQ * kS;
    const float* dos = do_s + stage * kNQ * kVS;
    const float* st = st_s + stage * kNQ * 4;
    const int* lo = reinterpret_cast<const int*>(st) + 2 * kNQ;
    const int* hi = reinterpret_cast<const int*>(st) + 3 * kNQ;

    // P^T (keys x rows) = exp2(K Q^T * scale_log2 - lse2), masked
    float s[kNQ / 8][4];
    zero(s);
    mma_abt<kNQ, DQK>(s, k_s + 16 * warp * kS, kS, qs, kS);
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
    mma_abt<kNQ, DV>(dp, v_s + 16 * warp * kVS, kVS, dos, kVS);
    mma_pb<kNQ, DV>(dv, s, dos, kVS, ps);
    // dS^T = P^T * (dP^T - D); dK += dS^T Q (scaled at the end)
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D = st[kNQ + 8 * j + 2 * t + e];
        dp[j][e] = s[j][e] * (dp[j][e] - D);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - D);
      }
    mma_pb<kNQ, DQK>(dk, dp, qs, kS, ps);
  }
  cp_async_wait<0>();

  float* dkb = a.dk + b * a.sdk[0] + hk * a.sdk[1];
  float* dvb = a.dv + b * a.sdv[0] + hk * a.sdv[1];
  store_rows<DQK>(dk, key0 < a.Sk ? dkb + key0 * a.sdk[2] : nullptr,
                  key1 < a.Sk ? dkb + key1 * a.sdk[2] : nullptr, a.scale);
  store_rows<DV>(dv, key0 < a.Sk ? dvb + key0 * a.sdv[2] : nullptr,
                 key1 < a.Sk ? dvb + key1 * a.sdv[2] : nullptr, 1.f);
}

template <int DQK, int DV>
struct DqLayout {
  static constexpr int kN = 32;                      // keys per tile
  static constexpr int kS = DQK + kPad;
  static constexpr int kVS = DV + kPad;
  static constexpr size_t kQ = size_t(kRows) * kS * 4;
  static constexpr size_t kDO = size_t(kRows) * kVS * 4;
  static constexpr size_t kK = size_t(kStages) * kN * kS * 4;
  static constexpr size_t kV = size_t(kStages) * kN * kVS * 4;
  static constexpr size_t kP = size_t(kWarps) * 16 * (kN + 4) * 4;
  // (192, 128): 50,176 + 33,792 + 50,176 + 33,792 + 9,216 = 177,152 bytes
  static constexpr size_t kBytes = kQ + kDO + kK + kV + kP;
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// Grid (Hkv, B, tiles of 64 folded query rows), the last (heaviest under a
// causal mask) tiles first.  Warp w owns rows m0 + 16 w .. + 15; lane
// (g, t) rows g and g + 8 of them.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using L = DqLayout<DQK, DV>;
  constexpr int kN = L::kN, kS = L::kS, kVS = L::kVS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = reinterpret_cast<float*>(smem + L::kQ);
  float* k_s = reinterpret_cast<float*>(smem + L::kQ + L::kDO);
  float* v_s = reinterpret_cast<float*>(smem + L::kQ + L::kDO + L::kK);
  float* p_s =
      reinterpret_cast<float*>(smem + L::kQ + L::kDO + L::kK + L::kV);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int m0 = static_cast<int>(gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = a.r, M = a.M;
  const float* kb = a.k + b * a.sk[0] + hk * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + hk * a.sv[1];
  const float* qb =
      a.q + b * a.sq[0] + static_cast<long long>(hk) * r * a.sq[1];
  const float* dob =
      a.dout + b * a.sdo[0] + static_cast<long long>(hk) * r * a.sdo[1];

  // keys any row of the tile sees: [kbeg, kend)
  const int kend = key_range(a, min(m0 + kRows, M) - 1).y;
  const int kbeg = key_range(a, m0).x;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kN - 1) / kN : 0;

  load_rows<DQK, kRows>(q_s, kS, qb, [&](int i) -> const float* {
    const int j = m0 + i;
    return j < M ? qb + (j / r) * a.sq[2] + (j % r) * a.sq[1] : nullptr;
  });
  load_rows<DV, kRows>(do_s, kVS, dob, [&](int i) -> const float* {
    const int j = m0 + i;
    return j < M ? dob + (j / r) * a.sdo[2] + (j % r) * a.sdo[1] : nullptr;
  });
  cp_async_commit();                            // group: Q, dO
  auto load_kv = [&](int it, int stage) {
    const int k0 = kbeg + it * kN;
    load_rows<DQK, kN>(k_s + stage * kN * kS, kS, kb,
                       [&](int i) -> const float* {
                         return k0 + i < kend
                                    ? kb + static_cast<long long>(k0 + i) *
                                               a.sk[2]
                                    : nullptr;
                       });
    load_rows<DV, kN>(v_s + stage * kN * kVS, kVS, vb,
                      [&](int i) -> const float* {
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
    const float* ks = k_s + stage * kN * kS;
    const float* vs = v_s + stage * kN * kVS;
    const int k0 = kbeg + it * kN;

    // P = exp2(Q K^T * scale_log2 - lse2), masked
    float s[kN / 8][4];
    zero(s);
    mma_abt<kN, DQK>(s, q_s + 16 * warp * kS, kS, ks, kS);
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
    mma_abt<kN, DV>(dp, do_s + 16 * warp * kVS, kVS, vs, kVS);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - sd0.y);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - sd1.y);
      }
    mma_pb<kN, DQK>(dq, dp, ks, kS, ps);
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  float* dqb =
      a.dq + b * a.sdq[0] + static_cast<long long>(hk) * r * a.sdq[1];
  store_rows<DQK>(
      dq, j0 < M ? dqb + (j0 / r) * a.sdq[2] + (j0 % r) * a.sdq[1] : nullptr,
      j1 < M ? dqb + (j1 / r) * a.sdq[2] + (j1 % r) * a.sdq[1] : nullptr,
      a.scale);
}

// ======================================= bf16: wgmma fed by TMA, per head
using namespace hopper;

constexpr int kBoxRow = 128;          // bytes of a box row: 64 bf16 columns
constexpr int kBoxA = kTile * kBoxRow;  // a 64 x 64 bf16 box

// The blocks: the producer warpgroup (one thread issues), then NWG
// consumer warpgroups, one block an SM.  The launch bounds start every
// thread at kEntry registers; setmaxnreg leaves the producer 24 and gives
// the rest to the consumers (two groups: 24 x 128 + 240 x 256 = 168 x
// 384; three: 24 x 128 + 160 x 384 <= 128 x 512).  ptxas still compiles
// the consumers near the entry count, so a consumer's accumulators are
// planned to fit it (the dK/dV pass above DH 64 below).
template <int NWG>
struct Block {
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kEntry = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kEntry * kThreads - kProducerRegs * 128) / (128 * NWG) / 8 * 8;
};
// consumer warpgroups of a block of either pass, by 64-column chunks of
// the head dim
template <int KC>
struct Plan {
  static constexpr int kDkdvGroups = 2;
  static constexpr int kDqGroups = KC == 1 ? 3 : 2;
};

struct WArgs {
  const float2* stats;          // (B, Hq, Sq_pad): (lse2, D)
  bf16* dq;                     // (B, Hq, Sq, DQK) by sdq
  bf16* dk;                     // (B, Hkv, Sk, DQK) by sdk
  bf16* dv;                     // (B, Hkv, Sk, DV) by sdv
  long long sdq[3], sdk[3], sdv[3];
  int Hq, Hkv, r, Sq, Sk, Sq_pad, causal, window;
  float scale, scale_log2;
};

// The offsets q_pos - k_pos a row sees: [dmin, dmax]
struct Band {
  int dmin, dmax;
};
__device__ __forceinline__ Band band(const WArgs& a) {
  return {a.causal ? 0 : -(1 << 30), a.window > 0 ? a.window - 1 : 1 << 30};
}

enum TileClass { kSkip = 0, kMasked = 1, kInterior = 2 };

// The class of the tile of positions [q0, q0 + 64) by keys [k0, k0 + 64)
__device__ __forceinline__ int tile_class(const WArgs& a, const Band& w,
                                          int q0, int k0) {
  const int qb = min(q0 + kTile, a.Sq) - 1, kb = min(k0 + kTile, a.Sk) - 1;
  if (qb < q0 || kb < k0) return kSkip;
  const int lo = q0 - kb, hi = qb - k0;     // q_pos - k_pos over the tile
  if (hi < w.dmin || lo > w.dmax) return kSkip;
  const bool full = q0 + kTile <= a.Sq && k0 + kTile <= a.Sk;
  return full && lo >= w.dmin && hi <= w.dmax ? kInterior : kMasked;
}
// Whether position q sees key k (no branches: it runs per element)
__device__ __forceinline__ bool visible(const WArgs& a, const Band& w, int q,
                                        int k) {
  return (q < a.Sq) & (k < a.Sk) & (q - k >= w.dmin) & (q - k <= w.dmax);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) c[i][j] = 0.f;
}

// The warpgroup's 64 x 8 J accumulator d rounded to bf16 into columns
// 8 j0 + [0, 8 J) of a 1024-aligned box of 128-byte rows in TMA's
// 128-byte swizzle: a K-major A operand (conflict-free 4-byte stores).
template <int J>
__device__ __forceinline__ void store_a(unsigned char* box,
                                        const float (&d)[4 * J], int j0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + g;   // row & 7 == g
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<uint32_t*>(box + (row + 8 * i) * kBoxRow +
                                   (((j0 + j) ^ g) << 4) + 4 * t) =
          pack_bf16(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
}
// Makes consumer group wg's shared-memory stores visible to wgmma once all
// four of its warps have stored (named barrier 1 + wg).
__device__ __forceinline__ void publish(int wg) {
  fence_proxy_async();
  bar_sync(1 + wg, 128);
}

// Rows lane / 4 and + 8 of the warp's 16 of acc, columns 64 c + its 64
// below DH, times mul to r0 / r1 (null: not written)
template <int DH>
__device__ __forceinline__ void store_chunk(const float (&acc)[32], int c,
                                            bf16* r0, bf16* r1, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (64 * c + 8 * j >= DH) continue;
    const int d = 64 * c + 8 * j + 2 * t;
    if (r0)
      *reinterpret_cast<__nv_bfloat162*>(r0 + d) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r1)
      *reinterpret_cast<__nv_bfloat162*>(r1 + d) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}
// The same for every 64-column chunk of acc
template <int DH>
__device__ __forceinline__ void store_acc(const float (&acc)[(DH + 63) / 64]
                                                            [32],
                                          bf16* r0, bf16* r1, float mul) {
#pragma unroll
  for (int c = 0; c < (DH + 63) / 64; ++c)
    store_chunk<DH>(acc[c], c, r0, r1, mul);
}

// One arrival of the calling warp on a stage's empty barrier
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------- dK/dV pass
// A consumer warpgroup's tile: 64 keys by 64 positions.  The block walks
// its tiles once for each 64-column chunk c of dK and of dV (KW walks,
// the larger chunk count), summing dK's columns of chunk c while c < KQ
// and dV's while c < KV (S^T over DQK and dP^T over DV each time): above
// 64 columns the chunks' accumulators together would take 128 registers
// or more, so a walk holds 64.
template <int DQK, int DV, int NWG>
struct Dkdv {
  static constexpr int KQ = (DQK + 63) / 64;         // chunks of Q, K, dK
  static constexpr int KV = (DV + 63) / 64;          // of V, dO, dV
  static constexpr int KW = KQ > KV ? KQ : KV;       // walks
  // a tile's positions in NH parts of NP: above 64 columns two halves, so
  // S^T and dP^T take 16 + 16 registers (at 32 + 32 the consumers spilled)
  static constexpr int NH = KQ == 1 ? 1 : 2;
  static constexpr int NP = kTile / NH;
  // ring stages: at (192, 128) three would take 240,696 B, over the
  // 232,448 a block can have
  static constexpr int ST = KQ == 1 ? 4 : KQ + KV <= 4 ? 3 : 2;
  static constexpr int kKeys = NWG * kTile;          // keys a block owns
  static constexpr int kKeyBox = kKeys * kBoxRow;
  static constexpr int kK = 0;                       // KQ key boxes
  static constexpr int kV = kK + KQ * kKeyBox;       // KV
  static constexpr int kQ = kV + KV * kKeyBox;       // ST x KQ boxes
  static constexpr int kDO = kQ + ST * KQ * kBoxA;   // ST x KV
  static constexpr int kSt = kDO + ST * KV * kBoxA;  // ST x 64 (lse2, D)
  static constexpr int kA = (kSt + ST * kTile * 8 + 1023) / 1024 * 1024;
  static constexpr int kBar = kA + 2 * NWG * kBoxA;  // P^T, dS^T per group
  // bytes, two groups: (64, 64) 4 stages K 16,384 + V 16,384 + Q 32,768
  // + dO 32,768 + stats 2,048 + P^T/dS^T 32,768 + barriers and alignment
  // = 134,216; (128, 128) 3 stages 32,768 + 32,768 + 49,152 + 49,152 +
  // 1,536 (to 1,024 B) + 32,768 = 199,736 with them; (192, 128) 2 stages
  // 49,152 + 32,768 + 49,152 + 32,768 + 1,024 + 32,768 = 198,696 with them
  static constexpr int kBytes = kBar + (2 * ST + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// Grid (key blocks, B * Hkv): a (batch, kv head)'s blocks run together,
// so its query heads' Q and dO stay in L2, the heaviest (causal: first)
// block first.
template <int DQK, int DV, int NWG>
__global__ void __launch_bounds__(Block<NWG>::kThreads, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, const WArgs a) {
  using L = Dkdv<DQK, DV, NWG>;
  constexpr int KQ = L::KQ, KV = L::KV, ST = L::ST, NP = L::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* kv_full = empty + ST;

  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int n0 = blockIdx.x * L::kKeys;
  const int n_hi = min(n0 + L::kKeys, a.Sk);        // keys [n0, n_hi)
  // per query head, the 64-position tiles that see one of the keys
  const int qt_lo = a.causal ? n0 / kTile : 0;
  const int q_end = a.window > 0 ? min(a.Sq, n_hi - 1 + a.window) : a.Sq;
  const int per_head =
      q_end > qt_lo * kTile ? (q_end + kTile - 1) / kTile - qt_lo : 0;
  const int n_tiles = a.r * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);           // every consumer warp
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                     // producer
    regs_dec<Block<NWG>::kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(kv_full, (KQ + KV) * L::kKeyBox);
      for (int c = 0; c < KQ; ++c)
        tma_load_4d(sm + L::kK + c * L::kKeyBox, &tk, kv_full, 64 * c, n0,
                    hk, b);
      for (int c = 0; c < KV; ++c)
        tma_load_4d(sm + L::kV + c * L::kKeyBox, &tv, kv_full, 64 * c, n0,
                    hk, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kc = 0; kc < L::KW; ++kc)             // one walk a chunk
        for (int h = hk * a.r; h < (hk + 1) * a.r; ++h) {
          const float2* st =
              a.stats + (static_cast<long long>(b) * a.Hq + h) * a.Sq_pad;
          for (int q0 = qt_lo * kTile; q0 < (qt_lo + per_head) * kTile;
               q0 += kTile) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage],
                                  (KQ + KV) * kBoxA + kTile * 8);
            for (int c = 0; c < KQ; ++c)
              tma_load_4d(sm + L::kQ + (stage * KQ + c) * kBoxA, &tq,
                          &full[stage], 64 * c, q0, h, b);
            for (int c = 0; c < KV; ++c)
              tma_load_4d(sm + L::kDO + (stage * KV + c) * kBoxA, &tdo,
                          &full[stage], 64 * c, q0, h, b);
            bulk_load(sm + L::kSt + stage * kTile * 8, st + q0, kTile * 8,
                      &full[stage]);
            if (++stage == ST) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
    }
  } else {                                     // consumers
    regs_inc<Block<NWG>::kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, t = threadIdx.x % 4;
    const int k0 = n0 + wg * kTile;
    const int key0 = k0 + 16 * warp + (threadIdx.x % 32) / 4,
              key1 = key0 + 8;
    const Band w = band(a);
    // descriptors: d0 + byte offset / 16; this group's keys in each key
    // box and its P^T and dS^T boxes
    const uint32_t d0 = desc_lo(smem_u32(sm));
    const uint32_t dks = d0 + (L::kK + wg * kBoxA) / 16;
    const uint32_t dvs = d0 + (L::kV + wg * kBoxA) / 16;
    unsigned char* pt = sm + L::kA + 2 * wg * kBoxA;
    const uint32_t dpt = d0 + (L::kA + 2 * wg * kBoxA) / 16;
    if (n_tiles > 0) mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
#pragma unroll
    for (int kc = 0; kc < L::KW; ++kc) {    // walk kc: columns 64 kc + 64
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
      // the r heads' tiles in turn: q0 runs over each head's positions
      for (int it = 0, q0 = qt_lo * kTile; it < n_tiles; ++it) {
        mbar_wait(&full[stage], phase);
        const int cls = tile_class(a, w, q0, k0);
        if (cls != kSkip) {
          const uint32_t dqs = d0 + (L::kQ + stage * KQ * kBoxA) / 16;
          const uint32_t dos = d0 + (L::kDO + stage * KV * kBoxA) / 16;
          const float4* st =
              reinterpret_cast<const float4*>(sm + L::kSt + stage * kTile * 8);
#pragma unroll
          for (int hf = 0; hf < L::NH; ++hf) {   // positions q0 + NP hf + NP
            const int p0 = NP * hf;
            // S^T = K Q^T, dP^T = V dO^T (keys x positions), B K-major
            float s[NP / 2], dp[NP / 2];
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < KQ; ++c)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<0>(s, dks + (c * L::kKeyBox + 32 * kk) / 16,
                            dqs + (c * kBoxA + p0 * kBoxRow + 32 * kk) / 16,
                            c + kk);
#pragma unroll
            for (int c = 0; c < KV; ++c)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<0>(dp, dvs + (c * L::kKeyBox + 32 * kk) / 16,
                            dos + (c * kBoxA + p0 * kBoxRow + 32 * kk) / 16,
                            c + kk);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            fence_regs(dp);
            // P^T = exp2(S^T scale_log2 - lse2), zero at the pairs the mask
            // hides only if the tile holds one, and dS^T = P^T (dP^T - D),
            // in place; (lse2, D) of positions q0 + p0 + 8 j + 2 t, + 1
#pragma unroll
            for (int j = 0; j < NP / 8; ++j) {
              const float4 x = st[p0 / 2 + 4 * j + t];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                s[4 * j + i] =
                    ex2(s[4 * j + i] * a.scale_log2 - (i & 1 ? x.z : x.x));
            }
            if (cls == kMasked)
#pragma unroll
              for (int idx = 0; idx < NP / 2; ++idx)
                if (!visible(a, w, q0 + p0 + 8 * (idx / 4) + 2 * t + idx % 2,
                             idx & 2 ? key1 : key0))
                  s[idx] = 0.f;
#pragma unroll
            for (int j = 0; j < NP / 8; ++j) {
              const float4 x = st[p0 / 2 + 4 * j + t];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                dp[4 * j + i] =
                    s[4 * j + i] * (dp[4 * j + i] - (i & 1 ? x.w : x.y));
            }
            // dV += P^T dO, dK += dS^T Q (chunk kc's columns): P^T and
            // dS^T through shared memory, B MN-major
            if (kc < KV) store_a<NP / 8>(pt, s, p0 / 8);
            store_a<NP / 8>(pt + kBoxA, dp, p0 / 8);
            publish(wg);
            wgmma_fence();
#pragma unroll
            for (int kk = p0 / 16; kk < (p0 + NP) / 16; ++kk) {
              if (kc < KV)
                wgmma_ss<1>(dv, dpt + 2 * kk,
                            dos + (kc * kBoxA + 2048 * kk) / 16, 1);
              if (kc < KQ)
                wgmma_ss<1>(dk, dpt + kBoxA / 16 + 2 * kk,
                            dqs + (kc * kBoxA + 2048 * kk) / 16, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dk);
            fence_regs(dv);
          }
        }
        release(&empty[stage]);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
        q0 += kTile;
        if (q0 == (qt_lo + per_head) * kTile) q0 = qt_lo * kTile;
      }
      bf16* dkb = a.dk + b * a.sdk[0] + hk * a.sdk[1];
      bf16* dvb = a.dv + b * a.sdv[0] + hk * a.sdv[1];
      if (kc < KQ)
        store_chunk<DQK>(dk, kc,
                         key0 < a.Sk ? dkb + key0 * a.sdk[2] : nullptr,
                         key1 < a.Sk ? dkb + key1 * a.sdk[2] : nullptr,
                         a.scale);
      if (kc < KV)
        store_chunk<DV>(dv, kc, key0 < a.Sk ? dvb + key0 * a.sdv[2] : nullptr,
                        key1 < a.Sk ? dvb + key1 * a.sdv[2] : nullptr, 1.f);
    }
  }
}

// ------------------------------------------------------------- dQ pass
// A consumer warpgroup's tile: 64 positions by 64 keys.
template <int DQK, int DV, int NWG>
struct Dq {
  static constexpr int KQ = (DQK + 63) / 64;         // chunks of Q, K, dQ
  static constexpr int KV = (DV + 63) / 64;          // of V, dO
  // a tile's keys in NH parts of NK: at three chunks four quarters, so S
  // and dP take 8 + 8 registers beside dQ's 96 (in halves, 16 + 16, the
  // consumers spilled 16 bytes)
  static constexpr int NH = KQ > 2 ? 4 : 1;
  static constexpr int NK = kTile / NH;
  static constexpr int ST = KQ == 1 ? 4 : 3;
  static constexpr int kRows = NWG * kTile;          // positions a block owns
  static constexpr int kRowBox = kRows * kBoxRow;
  static constexpr int kKeyBox = kTile * kBoxRow;    // 64 keys
  static constexpr int kQ = 0;                       // KQ boxes
  static constexpr int kDO = KQ * kRowBox;           // KV
  static constexpr int kK = kDO + KV * kRowBox;      // ST x KQ boxes
  static constexpr int kV = kK + ST * KQ * kKeyBox;  // ST x KV
  static constexpr int kDS = kV + ST * KV * kKeyBox;   // dS per group
  static constexpr int kBar = kDS + NWG * kBoxA;
  // bytes: (64, 64) three groups, 4 stages: Q 24,576 + dO 24,576 + K
  // 32,768 + V 32,768 + dS 24,576 + barriers and alignment = 140,360;
  // (128, 128) two groups, 3 stages: 32,768 + 32,768 + 49,152 + 49,152 +
  // 16,384 = 181,304 with them; (192, 128) 49,152 + 32,768 + 73,728 +
  // 49,152 + 16,384 = 222,264 with them
  static constexpr int kBytes = kBar + (2 * ST + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// Grid (position blocks, B * Hq): a (batch, head)'s blocks run together,
// so its K and V stay in L2, the heaviest (causal: last) block first.
template <int DQK, int DV, int NWG>
__global__ void __launch_bounds__(Block<NWG>::kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const WArgs a) {
  using L = Dq<DQK, DV, NWG>;
  constexpr int KQ = L::KQ, KV = L::KV, ST = L::ST, NK = L::NK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* q_full = empty + ST;

  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq, hk = h / a.r;
  const int m0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * L::kRows;
  const Band w = band(a);
  // the keys positions [m0, min(m0 + kRows, Sq)) see: [kbeg, kend)
  const int kbeg = max(0, m0 - w.dmax);
  const int kend = min(a.Sk, min(m0 + L::kRows, a.Sq) - w.dmin);
  const int kt_lo = kbeg / kTile;
  const int n_tiles = kend > kbeg ? (kend + kTile - 1) / kTile - kt_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);           // every consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                     // producer
    regs_dec<Block<NWG>::kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, (KQ + KV) * L::kRowBox);
      for (int c = 0; c < KQ; ++c)
        tma_load_4d(sm + L::kQ + c * L::kRowBox, &tq, q_full, 64 * c, m0, h,
                    b);
      for (int c = 0; c < KV; ++c)
        tma_load_4d(sm + L::kDO + c * L::kRowBox, &tdo, q_full, 64 * c, m0,
                    h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = kt_lo * kTile; k0 < kend; k0 += kTile) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], (KQ + KV) * L::kKeyBox);
        for (int c = 0; c < KQ; ++c)
          tma_load_4d(sm + L::kK + (stage * KQ + c) * L::kKeyBox, &tk,
                      &full[stage], 64 * c, k0, hk, b);
        for (int c = 0; c < KV; ++c)
          tma_load_4d(sm + L::kV + (stage * KV + c) * L::kKeyBox, &tv,
                      &full[stage], 64 * c, k0, hk, b);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {                                     // consumers
    regs_inc<Block<NWG>::kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, t = threadIdx.x % 4;
    const int p0 = m0 + wg * kTile;            // this group's positions
    const int row0 = p0 + 16 * warp + (threadIdx.x % 32) / 4,
              row1 = row0 + 8;
    const float2* stb =
        a.stats + (static_cast<long long>(b) * a.Hq + h) * a.Sq_pad;
    const float2 none = make_float2(INFINITY, 0.f);  // past the pad
    const float2 st0 = row0 < a.Sq_pad ? stb[row0] : none,
                 st1 = row1 < a.Sq_pad ? stb[row1] : none;
    // descriptors: d0 + byte offset / 16; this group's rows of Q and dO
    // and its dS box (read by dQ's product a tile on)
    const uint32_t d0 = desc_lo(smem_u32(sm));
    const uint32_t dqs = d0 + (L::kQ + wg * kBoxA) / 16;
    const uint32_t ddo = d0 + (L::kDO + wg * kBoxA) / 16;
    unsigned char* dsb = sm + L::kDS + wg * kBoxA;
    const uint32_t dds = d0 + (L::kDS + wg * kBoxA) / 16;
    float dq[KQ][32];
    zero_acc(dq);
    if (n_tiles > 0) mbar_wait(q_full, 0);
    int stage = 0, held = -1;        // held: the stage dQ's product reads
    uint32_t phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = (kt_lo + it) * kTile;
      mbar_wait(&full[stage], phase);
      const int cls = tile_class(a, w, p0, k0);
      if (cls == kSkip) {
        if (held >= 0) {             // the ring must not stall on it
          wgmma_wait<0>();
          release(&empty[held]);
          held = -1;
        }
        release(&empty[stage]);
      } else {
        const uint32_t dks = d0 + (L::kK + stage * KQ * L::kKeyBox) / 16;
        const uint32_t dvs = d0 + (L::kV + stage * KV * L::kKeyBox) / 16;
#pragma unroll 1
        for (int hf = 0; hf < L::NH; ++hf) {   // keys k0 + kp + [0, NK)
          const int kp = NK * hf;
          // S = Q K^T, dP = dO V^T (positions x keys), B K-major
          float s[NK / 2], dp[NK / 2];
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < KQ; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<0>(s, dqs + (c * L::kRowBox + 32 * kk) / 16,
                          dks + (c * L::kKeyBox + kp * kBoxRow + 32 * kk) /
                                    16,
                          c + kk);
          wgmma_commit();
#pragma unroll
          for (int c = 0; c < KV; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<0>(dp, ddo + (c * L::kRowBox + 32 * kk) / 16,
                          dvs + (c * L::kKeyBox + kp * kBoxRow + 32 * kk) /
                                    16,
                          c + kk);
          wgmma_commit();
          // S and every earlier dQ product are done
          wgmma_wait<1>();
          fence_regs(s);
          if (hf == 0 && held >= 0) release(&empty[held]);
          // P = exp2(S scale_log2 - lse2), zero at the pairs the mask
          // hides only if the tile holds one
#pragma unroll
          for (int idx = 0; idx < NK / 2; ++idx)
            s[idx] = ex2(s[idx] * a.scale_log2 - (idx & 2 ? st1.x : st0.x));
          if (cls == kMasked)
#pragma unroll
            for (int idx = 0; idx < NK / 2; ++idx)
              if (!visible(a, w, idx & 2 ? row1 : row0,
                           k0 + kp + 8 * (idx / 4) + 2 * t + idx % 2))
                s[idx] = 0.f;
          wgmma_wait<0>();                     // dP
          fence_regs(dp);
          // dS = P (dP - D); dQ += dS K: dS through shared memory, B
          // MN-major
#pragma unroll
          for (int idx = 0; idx < NK / 2; ++idx)
            dp[idx] = s[idx] * (dp[idx] - (idx & 2 ? st1.y : st0.y));
          store_a<NK / 8>(dsb, dp, kp / 8);
          publish(wg);
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < KQ; ++c)
#pragma unroll
            for (int k2 = 0; k2 < NK / 16; ++k2)
              wgmma_ss<1>(dq[c], dds + 2 * (kp / 16 + k2),
                          dks + (c * L::kKeyBox + 2048 * (kp / 16 + k2)) / 16,
                          1);
          wgmma_commit();
        }
        held = stage;                // released once dQ's product is done
      }
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < KQ; ++c) fence_regs(dq[c]);
    if (held >= 0) release(&empty[held]);
    bf16* dqb = a.dq + b * a.sdq[0] + h * a.sdq[1];
    store_acc<DQK>(dq, row0 < a.Sq ? dqb + row0 * a.sdq[2] : nullptr,
                   row1 < a.Sq ? dqb + row1 * a.sdq[2] : nullptr, a.scale);
  }
}

// ------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;          // above 48 KB of shared
  const cudaError_t err = cudaFuncSetAttribute(  // memory only when asked
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DQK, int DV>
cudaError_t launch_fp32(int pass, const Args& a, int B, int Hkv,
                        cudaStream_t stream) {
  if (pass == 0) {
    using L = DkdvLayout<DQK, DV>;
    static bool configured = false;
    cudaError_t err = allow_smem(dkdv_kernel<DQK, DV>, L::kBytes, configured);
    if (err != cudaSuccess) return err;
    const int n_kt = (a.Sk + kRows - 1) / kRows;
    if (n_kt > 65535) return cudaErrorInvalidValue;
    dkdv_kernel<DQK, DV>
        <<<dim3(Hkv, B, n_kt), kThreads, L::kBytes, stream>>>(a);
  } else {
    using L = DqLayout<DQK, DV>;
    static bool configured = false;
    cudaError_t err = allow_smem(dq_kernel<DQK, DV>, L::kBytes, configured);
    if (err != cudaSuccess) return err;
    const int n_qt = (a.M + kRows - 1) / kRows;
    if (n_qt > 65535) return cudaErrorInvalidValue;
    dq_kernel<DQK, DV>
        <<<dim3(Hkv, B, n_qt), kThreads, L::kBytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bf16(int pass, const void* q, const void* k,
                        const void* v, const void* dout, const WArgs& a,
                        const long long* strides, int B,
                        cudaStream_t stream) {
  using P = Plan<(DQK + 63) / 64>;
  using LK = Dkdv<DQK, DV, P::kDkdvGroups>;
  using LQ = Dq<DQK, DV, P::kDqGroups>;
  using BK = Block<P::kDkdvGroups>;
  using BQ = Block<P::kDqGroups>;
  // boxes: dK/dV reads a block's keys and 64 positions, dQ a block's
  // positions and 64 keys
  const int q_rows = pass == 0 ? kTile : LQ::kRows;
  const int k_rows = pass == 0 ? LK::kKeys : kTile;
  CUtensorMap mq, mk, mv, mdo;
  if (!bf16_map(&mq, q, B, a.Hq, a.Sq, DQK, strides, q_rows) ||
      !bf16_map(&mk, k, B, a.Hkv, a.Sk, DQK, strides + 3, k_rows) ||
      !bf16_map(&mv, v, B, a.Hkv, a.Sk, DV, strides + 6, k_rows) ||
      !bf16_map(&mdo, dout, B, a.Hq, a.Sq, DV, strides + 9, q_rows))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * a.Hq > 65535) return cudaErrorInvalidValue;
  if (pass == 0) {
    static bool configured = false;
    auto kernel = dkdv_wgmma<DQK, DV, P::kDkdvGroups>;
    cudaError_t err = allow_smem(kernel, LK::kBytes, configured);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.Sk + LK::kKeys - 1) / LK::kKeys, B * a.Hkv),
             BK::kThreads, LK::kBytes, stream>>>(mq, mk, mv, mdo, a);
  } else {
    static bool configured = false;
    auto kernel = dq_wgmma<DQK, DV, P::kDqGroups>;
    cudaError_t err = allow_smem(kernel, LQ::kBytes, configured);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.Sq + LQ::kRows - 1) / LQ::kRows, B * a.Hq),
             BQ::kThreads, LQ::kBytes, stream>>>(mq, mk, mv, mdo, a);
  }
  return cudaGetLastError();
}

int sq_pad(int Sq) { return (Sq + kTile - 1) / kTile * kTile; }

// pass 0: dK/dV, pass 1: dQ
int run_pass(int pass, const void* q, const void* k, const void* v,
             const void* dout, const float* stats, void* dq, void* dk,
             void* dv, const long long* strides, int B, int Hq, int Hkv,
             int Sq, int Sk, int dh, int dvw, int causal, int window,
             float scale, int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0 || Sk == 0) return 0;
  // the built (dh, dv) pairs: dh == dv in {64, 80, 96, 128}, MLA's
  // (192, 128)
  const bool built = dh == dvw ? dh == 64 || dh == 80 || dh == 96 ||
                                     dh == 128
                               : dh == 192 && dvw == 128;
  if (!built || Hkv <= 0 || Hq % Hkv != 0 ||
      static_cast<long long>(Sq) * (Hq / Hkv) > (1LL << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    WArgs a;
    a.stats = reinterpret_cast<const float2*>(stats);
    a.dq = static_cast<bf16*>(dq);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    for (int i = 0; i < 3; ++i) {
      a.sdq[i] = strides[12 + i];
      a.sdk[i] = strides[15 + i];
      a.sdv[i] = strides[18 + i];
    }
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.r = Hq / Hkv;
    a.Sq = Sq;
    a.Sk = Sk;
    a.Sq_pad = sq_pad(Sq);
    a.causal = causal;
    a.window = window;
    a.scale = scale;
    a.scale_log2 = scale * kLog2e;
    switch (dh) {
      case 64:
        return launch_bf16<64, 64>(pass, q, k, v, dout, a, strides, B, s);
      case 80:
        return launch_bf16<80, 80>(pass, q, k, v, dout, a, strides, B, s);
      case 96:
        return launch_bf16<96, 96>(pass, q, k, v, dout, a, strides, B, s);
      case 128:
        return launch_bf16<128, 128>(pass, q, k, v, dout, a, strides, B, s);
      default:
        return launch_bf16<192, 128>(pass, q, k, v, dout, a, strides, B, s);
    }
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.stats = reinterpret_cast<const float2*>(stats);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
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
  a.Sq_pad = sq_pad(Sq);
  a.r = Hq / Hkv;
  a.M = Sq * a.r;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  switch (dh) {
    case 64:
      return launch_fp32<64, 64>(pass, a, B, Hkv, s);
    case 80:
      return launch_fp32<80, 80>(pass, a, B, Hkv, s);
    case 96:
      return launch_fp32<96, 96>(pass, a, B, Hkv, s);
    case 128:
      return launch_fp32<128, 128>(pass, a, B, Hkv, s);
    default:
      return launch_fp32<192, 128>(pass, a, B, Hkv, s);
  }
}

}  // namespace

// The D pass: stats (B, Hq, Sq_pad, 2) fp32, Sq_pad = Sq rounded up to 64,
// contiguous: per row (lse in log2 units, +inf where lse is -inf and on
// the pad rows; D = rowsum(dO * O), 0 on the pad).  out and dout
// (B, Hq, Sq, dv) by strides (host array of 6: the (B, H, S) axes of out,
// then of dout), head dim contiguous; lse (B, Hq, Sq) contiguous fp32, the
// forward's natural log-sum-exp.  dtype: 0 float32, 1 bfloat16.  Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dot(const void* out, const void* dout,
                                       const float* lse, float* stats,
                                       const long long* strides, int B,
                                       int Hq, int Sq, int dv, int dtype,
                                       void* stream) {
  const int pad = sq_pad(Sq);
  const long long rows = static_cast<long long>(B) * Hq * pad;
  if (rows == 0) return 0;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  float2* out2 = reinterpret_cast<float2*>(stats);
  if (dtype == 0)
    dot_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), lse,
        out2, st[0], st[1], st[2], st[3], st[4], st[5], Hq, Sq, pad, dv,
        rows);
  else if (dtype == 1)
    dot_kernel<bf16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
        out2, st[0], st[1], st[2], st[3], st[4], st[5], Hq, Sq, pad, dv,
        rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The dK/dV pass: dk (B, Hkv, Sk, dh) and dv (B, Hkv, Sk, dv), every row
// written (zero for a key no row sees).  q, k, v, dout, dq, dk, dv share
// dtype (0 float32, 1 bfloat16) and are read and written by strides (host
// array of 21: the (B, H, S) axes of q, k, v, dout, dq, dk, dv), head dim
// contiguous; bf16 bases and strides on 16 bytes (TMA).  stats: the D
// pass's output.  scale: 1/sqrt(dh).  Returns the launch's
// cudaGetLastError() (0 on success; cudaErrorInvalidValue when a tensor
// map cannot be made).
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* stats, void* dq, void* dk, void* dv,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int dh,
    int dvw, int causal, int window, float scale, int dtype, void* stream) {
  return run_pass(0, q, k, v, dout, stats, dq, dk, dv, strides, B, Hq, Hkv,
                  Sq, Sk, dh, dvw, causal, window, scale, dtype, stream);
}

// The dQ pass: dq (B, Hq, Sq, dh), every row written (zero for a row that
// sees no key); arguments as flash_attention_bwd_dkdv's.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* stats, void* dq, void* dk, void* dv,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int dh,
    int dvw, int causal, int window, float scale, int dtype, void* stream) {
  return run_pass(1, q, k, v, dout, stats, dq, dk, dv, strides, B, Hq, Hkv,
                  Sq, Sk, dh, dvw, causal, window, scale, dtype, stream);
}
