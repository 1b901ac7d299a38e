// One block's attention tile, shared by the port's attention kernels for
// Hopper (sm_90a): the chunked paged prefill's split tile (B1 where a
// (row, kv head) has at most 16 folded rows), its fp32 path and its bf16
// launches at a page the wgmma kernel's boxes do not take; paged decode
// (B2); and dense flash attention's fp32 path (B3).  B1's other bf16
// launches and B3's bf16 forward and backward run TMA-fed wgmma kernels of
// their own (hopper.cuh).  Each kernel supplies a block view ``Blk`` of
// one (batch row, kv head): where its folded query rows, keys, values and
// outputs live, and which keys each row sees.  The tile computes online
// softmax attention of up to 16 * kWarps folded query rows over the keys
// of one span.
//
// Folded rows.  A kv head's r query heads are folded into its rows: row
// j = position * r + head-in-group, so every K/V tile the block loads
// serves all r heads.  Which keys row j sees depends on its position j / r
// only: keys in [key_begin(j), key_end(j)), both nondecreasing in j.
//
// Design (bf16).  Both products on the tensor cores through
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  A warp owns 16 folded
// rows; their Q fragments stay in registers over the key loop.  K comes
// from shared memory with ldmatrix, V with ldmatrix.trans; the online
// softmax runs on the fp32 accumulator fragment in log2 units (row max and
// sum over the 4 threads of a quad), and P is rounded to bf16 in registers
// and used directly as the A operand of P.V (the FlashAttention-2 register
// layout): exactly the references' p.astype(v.dtype), while l sums the
// unrounded fp32 P.  mma.sync rather than wgmma for the tiles it still
// carries: its 16-row tile wastes less on a 5-row decode tile (B1's split
// tile, B2) than wgmma's 64 rows.
//
// Design (fp32).  The same tiles, pipeline and softmax, both products as
// fp32 FMAs on the CUDA cores (never TF32: the 2e-5 tolerance forbids it),
// register-tiled in the same fragment layout; P passes through shared
// memory.  The choice between the two is made by dtype alone.
//
// Pipeline.  K/V tiles (64 keys in bf16, 32 in fp32 and in one-warp split
// tiles) arrive by 16-byte cp.async into a ring of two stages, the next
// tile in flight while the current one is computed.  Shared rows are
// padded by 16 bytes, so the 8 rows of an ldmatrix (and the rows of the
// fp32 float4 reads) fall on distinct bank groups.  The key loop covers
// only keys some row of the tile sees (whole tiles outside are never read);
// probabilities are multiplied by the mask, so a row that has seen no key
// stays exact, and rows with l == 0 write exactly 0.
//
// Splits (Blk::kSplits).  Where a block's keys are cut into spans, each
// block writes fp32 (m, l, acc) partials of its span, and the kernel's
// merge combines the live spans; blocks whose span starts past the tile's
// last visible key exit at once.

#pragma once

#include <math.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace attention_tile {

using namespace mma_tiles;

constexpr int kStages = 2;            // K/V ring depth

// Keys per tile and the shared-row pad (elements, 16 bytes) of each type.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int kN = 64;
  static constexpr int kPad = 8;
};
template <>
struct Tiles<float> {
  static constexpr int kN = 32;
  static constexpr int kPad = 4;
};

// Q and K rows are DQK wide, V and output rows DV (MLA: 192 and 128).
template <typename T, int DQK, int DV, int kWarps>
struct Layout {
  static constexpr int kM = 16 * kWarps;                 // query rows
  // keys: a one-warp split tile takes 32 (its loads, not its products,
  // bound it, and smaller stages let more blocks share an SM)
  static constexpr int kN = kWarps == 1 ? 32 : Tiles<T>::kN;
  static constexpr int kStride = DQK + Tiles<T>::kPad;   // Q and K row
  static constexpr int kVStride = DV + Tiles<T>::kPad;   // V row
  static constexpr int kPStride = kN + 4;                // fp32 P row
  static constexpr size_t kQ = size_t(kM) * kStride * sizeof(T);
  static constexpr size_t kK = size_t(kStages) * kN * kStride * sizeof(T);
  static constexpr size_t kV = size_t(kStages) * kN * kVStride * sizeof(T);
  static constexpr size_t kP =
      std::is_same<T, float>::value ? size_t(kWarps) * 16 * kPStride * 4 : 0;
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

// Whether a block view can write each row's log-sum-exp (Blk::kLse true,
// with lse and lse_row): the dense kernel's, for the backward; the paged
// views have no kLse, and their code is what it was.
template <typename Blk, typename = void>
struct WritesLse : std::false_type {};
template <typename Blk>
struct WritesLse<Blk, std::void_t<decltype(Blk::kLse)>>
    : std::integral_constant<bool, Blk::kLse> {};

// Copies per batch of a tile load: the largest divisor of n up to 8.
__host__ __device__ constexpr int copy_batch(int n) {
  return n % 8 == 0 ? 8 : n % 6 == 0 ? 6 : n % 4 == 0 ? 4 : n % 3 == 0 ? 3
                                                                   : 1;
}

// Query tile qt (rows kM * qt ..) of the block view blk over key span
// ``split``.  Blk provides:
//   M                      folded query rows
//   kLower                 (static) whether key_begin can exceed 0
//   key_begin(j), key_end(j)   the keys row j sees (j < M or past it)
//   q_row(j)               row j of q (DQK contiguous, 16-byte aligned)
//   kv_row(key)            key's row index into K and V (clamped in range)
//   k_row(i), v_row(i)     row i of K, V
//   out_row(j)             row j of the output (DV contiguous)
//   kLse, lse, lse_row(j)  (optional) where row j's log-sum-exp goes;
//                          written when lse is not null
//   scale_log2             log2(e) / sqrt(DQK)
//   kSplits                (static) whether keys may be cut into spans;
//                          then n_splits, span, m_part, l_part, acc_part
//                          and part_base(split): the partials' row 0
// Warp w owns the tile's folded rows 16 w .. 16 w + 15; lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8 of them.  Scores use the mma
// accumulator layout in both types: s[j][e] / s[j][2 + e] is row g / g + 8
// at key 8 j + 2 t + e.
template <typename T, int DQK, int DV, int kWarps, typename Blk>
__device__ __forceinline__ void attend_tile(const Blk& blk, int qt, int split,
                                            unsigned char* smem) {
  using L = Layout<T, DQK, DV, kWarps>;
  constexpr bool kFloat = std::is_same<T, float>::value;
  constexpr int kThreads = kWarps * 32;
  constexpr int kM = L::kM, kN = L::kN, kStride = L::kStride;
  constexpr int kVStride = L::kVStride;
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kChunks = DQK / kVec;            // 16-byte chunks: Q, K row
  constexpr int kVChunks = DV / kVec;            // ... and a V row
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims");

  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + L::kQ);
  T* v_s = reinterpret_cast<T*>(smem + L::kQ + L::kK);
  float* p_s = reinterpret_cast<float*>(smem + L::kQ + L::kK + L::kV);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int M = blk.M;
  const int m0 = qt * kM;
  // keys any row of the tile sees: [kbeg, kend)
  const int kend = max(0, blk.key_end(min(m0 + kM, M) - 1));
  int kbeg = 0;
  if constexpr (Blk::kLower) kbeg = max(0, blk.key_begin(m0));
  int k_lo = kbeg, k_hi = kend;
  if constexpr (Blk::kSplits) {
    k_lo = kbeg + split * blk.span;
    if (blk.n_splits > 1 && k_lo >= kend) return;  // a dead span: never merged
    k_hi = min(kend, k_lo + blk.span);
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kN - 1) / kN : 0;

  // A tile is kN * kChunks 16-byte copies of K, kCopies per thread, and
  // kN * kVChunks of V.  The key rows of a batch are found (for paged
  // keys: table entries read) before any of its copies is issued, so their
  // latencies overlap instead of queueing behind each copy.  Where K and V
  // rows are as wide, one pass copies both from the rows it found.
  constexpr int kCopies = kN * kChunks / kThreads;
  constexpr int kBatch = copy_batch(kCopies);
  static_assert(kCopies * kThreads == kN * kChunks && kCopies % kBatch == 0,
                "tile copies");
  constexpr int kVCopies = kN * kVChunks / kThreads;
  constexpr int kVBatch = copy_batch(kVCopies);
  static_assert(kVCopies * kThreads == kN * kVChunks &&
                    kVCopies % kVBatch == 0,
                "V tile copies");
  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kN;
    T* ks = k_s + stage * kN * kStride;
    T* vs = v_s + stage * kN * kVStride;
#pragma unroll 1
    for (int i0 = 0; i0 < kCopies; i0 += kBatch) {
      size_t row[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = tid + (i0 + i) * kThreads;
        row[i] = blk.kv_row(min(k0 + c / kChunks, k_hi - 1));
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = tid + (i0 + i) * kThreads;
        const int col = (c % kChunks) * kVec;
        const int dst = (c / kChunks) * kStride + col;
        const int bytes = k0 + c / kChunks < k_hi ? 16 : 0;  // else zeros
        cp_async16(ks + dst, blk.k_row(row[i]) + col, bytes);
        if constexpr (DQK == DV)
          cp_async16(vs + dst, blk.v_row(row[i]) + col, bytes);
      }
    }
    if constexpr (DQK != DV) {
#pragma unroll 1
      for (int i0 = 0; i0 < kVCopies; i0 += kVBatch) {
        size_t row[kVBatch];
#pragma unroll
        for (int i = 0; i < kVBatch; ++i) {
          const int c = tid + (i0 + i) * kThreads;
          row[i] = blk.kv_row(min(k0 + c / kVChunks, k_hi - 1));
        }
#pragma unroll
        for (int i = 0; i < kVBatch; ++i) {
          const int c = tid + (i0 + i) * kThreads;
          const int col = (c % kVChunks) * kVec;
          const int dst = (c / kVChunks) * kVStride + col;
          const int bytes = k0 + c / kVChunks < k_hi ? 16 : 0;
          cp_async16(vs + dst, blk.v_row(row[i]) + col, bytes);
        }
      }
    }
  };

  if (n_tiles > 0) {
    for (int c = tid; c < kM * kChunks; c += kThreads) {
      const int row = c / kChunks, col = (c % kChunks) * kVec;
      const int j = m0 + row;
      const T* src = blk.q_row(0);
      int bytes = 0;
      if (j < M) {
        src = blk.q_row(j) + col;
        bytes = 16;
      }
      cp_async16(q_s + row * kStride + col, src, bytes);
    }
    cp_async_commit();                          // group 0: q
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();               // q has landed
    __syncthreads();
  }

  const int wrow = m0 + 16 * warp;              // the warp's first row
  const bool warp_live = wrow < M;
  // keys in [lo, hi) are visible to rows g and g + 8 of the warp; the
  // warp's first row has the least hi and its last live row the most lo
  const int hi0 = blk.key_end(wrow + g), hi1 = blk.key_end(wrow + g + 8);
  const int hi_warp = blk.key_end(wrow);
  int lo0 = 0, lo1 = 0, lo_warp = 0;
  if constexpr (Blk::kLower) {
    lo0 = blk.key_begin(wrow + g);
    lo1 = blk.key_begin(wrow + g + 8);
    lo_warp = blk.key_begin(min(wrow + 15, M - 1));
  }
  auto visible = [&](int key, int lo, int hi) {
    return key < hi && (!Blk::kLower || key >= lo);
  };

  uint32_t qf[kFloat ? 1 : DQK / 16][4];        // Q fragments (bf16)
  if constexpr (!kFloat) {
    if (n_tiles > 0) {
      const int row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + row * kStride + kk * 16 + (lane >> 4) * 8);
    }
  }

  float o[DV / 8][4];   // bf16: mma layout; fp32: o[2jj] / o[2jj + 1] is
                        // row g / g + 8 at columns 16 jj + 4 t .. + 3
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};                  // this thread's share

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();               // tile it has landed
    __syncthreads();                            // ... for every thread, and
                                                // tile it - 1's stage is free
    if (it + kStages - 1 < n_tiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    if (!warp_live) continue;

    const int k0 = k_lo + it * kN;
    const T* ks = k_s + (it % kStages) * kN * kStride;
    const T* vs = v_s + (it % kStages) * kN * kVStride;

    float s[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

    if constexpr (kFloat) {
      const float* qa = q_s + (16 * warp + g) * kStride;
      const float* qc = qa + 8 * kStride;
#pragma unroll 2
      for (int d = 0; d < DQK; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
        const float4 x1 = *reinterpret_cast<const float4*>(qc + d);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv = *reinterpret_cast<const float4*>(
                ks + (8 * j + 2 * t + e) * kStride + d);
            s[j][e] = dot4(x0, kv, s[j][e]);
            s[j][2 + e] = dot4(x1, kv, s[j][2 + e]);
          }
      }
    } else {
      // ldmatrix.x4 of K: keys 16 nn .. + 15, dims 16 kk .. + 15 -> the B
      // fragments of key groups 2 nn and 2 nn + 1
      const int krow = (lane & 7) + ((lane >> 4) << 3);
      const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < kN / 16; ++nn) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, ks + (16 * nn + krow) * kStride + 16 * kk + kcol);
          mma_bf16(s[2 * nn], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], bfr[2], bfr[3]);
        }
    }

    // online softmax on the score fragment, in log2 units.  Keys are
    // masked only where some key of the tile is hidden from some row of
    // the warp; bf16 makes that a warp-uniform branch between two variants,
    // so full tiles issue no mask code (fp32 keeps one variant: a second
    // pushes its tiles into spills)
    const bool full = k0 + kN <= hi_warp && (!Blk::kLower || k0 >= lo_warp);
    float alpha0, alpha1;
    auto softmax = [&](auto maskable) {
      constexpr bool kMaskable = decltype(maskable)::value;
      float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          float a = s[j][e] * blk.scale_log2, c = s[j][2 + e] * blk.scale_log2;
          if (kMaskable && !full) {
            a = visible(key, lo0, hi0) ? a : kNegInf;
            c = visible(key, lo1, hi1) ? c : kNegInf;
          }
          s[j][e] = a;
          s[j][2 + e] = c;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      alpha0 = ex2(m_run[0] - mx0);
      alpha1 = ex2(m_run[1] - mx1);
      m_run[0] = mx0;
      m_run[1] = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          // P times the mask: a row that has seen no key (mx == kNegInf)
          // gets exp2(0) == 1 from a masked key, and must stay at 0
          float a = ex2(s[j][e] - mx0), c = ex2(s[j][2 + e] - mx1);
          if (kMaskable && !full) {
            a = visible(key, lo0, hi0) ? a : 0.f;
            c = visible(key, lo1, hi1) ? c : 0.f;
          }
          s[j][e] = a;
          s[j][2 + e] = c;
          sum0 += a;
          sum1 += c;
        }
      l_run[0] = alpha0 * l_run[0] + sum0;
      l_run[1] = alpha1 * l_run[1] + sum1;
    };
    if (kFloat || !full)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});               // no key masked for the warp

    if constexpr (kFloat) {
#pragma unroll
      for (int jj = 0; jj < DV / 16; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          o[2 * jj][x] *= alpha0;
          o[2 * jj + 1][x] *= alpha1;
        }
      constexpr int kP = L::kPStride;
      float* ps = p_s + warp * 16 * kP;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        *reinterpret_cast<float2*>(ps + g * kP + 8 * j + 2 * t) =
            make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(ps + (g + 8) * kP + 8 * j + 2 * t) =
            make_float2(s[j][2], s[j][3]);
      }
      __syncwarp();
#pragma unroll 4
      for (int k = 0; k < kN; ++k) {
        const float pa = ps[g * kP + k], pc = ps[(g + 8) * kP + k];
#pragma unroll
        for (int jj = 0; jj < DV / 16; ++jj) {
          const float4 v = *reinterpret_cast<const float4*>(
              vs + k * kVStride + 16 * jj + 4 * t);
          o[2 * jj][0] = fmaf(pa, v.x, o[2 * jj][0]);
          o[2 * jj][1] = fmaf(pa, v.y, o[2 * jj][1]);
          o[2 * jj][2] = fmaf(pa, v.z, o[2 * jj][2]);
          o[2 * jj][3] = fmaf(pa, v.w, o[2 * jj][3]);
          o[2 * jj + 1][0] = fmaf(pc, v.x, o[2 * jj + 1][0]);
          o[2 * jj + 1][1] = fmaf(pc, v.y, o[2 * jj + 1][1]);
          o[2 * jj + 1][2] = fmaf(pc, v.z, o[2 * jj + 1][2]);
          o[2 * jj + 1][3] = fmaf(pc, v.w, o[2 * jj + 1][3]);
        }
      }
      __syncwarp();                             // P read before it is rewritten
    } else {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[j][0] *= alpha0;
        o[j][1] *= alpha0;
        o[j][2] *= alpha1;
        o[j][3] *= alpha1;
      }
      // ldmatrix.x4.trans of V: keys 16 kk .. + 15, dims 16 nd .. + 15 ->
      // the B fragments of dim groups 2 nd and 2 nd + 1
      const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vcol = (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        // P in V's type, straight from the accumulator fragment
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < DV / 16; ++nd) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr,
                            vs + (16 * kk + vrow) * kVStride + 16 * nd + vcol);
          mma_bf16(o[2 * nd], a, bfr[0], bfr[1]);
          mma_bf16(o[2 * nd + 1], a, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                           // only empty groups remain
  if (!warp_live) return;

  const float l0 = quad_sum(l_run[0]), l1 = quad_sum(l_run[1]);
  const int j0 = wrow + g, j1 = j0 + 8;
  if constexpr (Blk::kSplits) {
    if (blk.n_splits > 1) {
      // unnormalised partials of this span
      const size_t base = blk.part_base(split);
      if (t == 0 && j0 < M) {
        blk.m_part[base + j0] = m_run[0];
        blk.l_part[base + j0] = l0;
      }
      if (t == 0 && j1 < M) {
        blk.m_part[base + j1] = m_run[1];
        blk.l_part[base + j1] = l1;
      }
      float* a0 = blk.acc_part + (base + j0) * DV;
      float* a1 = blk.acc_part + (base + j1) * DV;
      if constexpr (kFloat) {
#pragma unroll
        for (int jj = 0; jj < DV / 16; ++jj) {
          const int d = 16 * jj + 4 * t;
          if (j0 < M)
            *reinterpret_cast<float4*>(a0 + d) = make_float4(
                o[2 * jj][0], o[2 * jj][1], o[2 * jj][2], o[2 * jj][3]);
          if (j1 < M)
            *reinterpret_cast<float4*>(a1 + d) =
                make_float4(o[2 * jj + 1][0], o[2 * jj + 1][1],
                            o[2 * jj + 1][2], o[2 * jj + 1][3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          const int d = 8 * j + 2 * t;
          if (j0 < M)
            *reinterpret_cast<float2*>(a0 + d) = make_float2(o[j][0], o[j][1]);
          if (j1 < M)
            *reinterpret_cast<float2*>(a1 + d) = make_float2(o[j][2], o[j][3]);
        }
      }
      return;
    }
  }

  // the natural-log log-sum-exp of each row's scaled, masked scores,
  // ln 2 * (m + log2 l); -inf for a row that saw no key
  if constexpr (WritesLse<Blk>::value) {
    if (blk.lse != nullptr && t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      if (j0 < M)
        *blk.lse_row(j0) =
            l0 > 0.f ? (m_run[0] + log2f(l0)) * kLn2 : -INFINITY;
      if (j1 < M)
        *blk.lse_row(j1) =
            l1 > 0.f ? (m_run[1] + log2f(l1)) * kLn2 : -INFINITY;
    }
  }

  // rows with l == 0 saw no key: their acc is exactly 0, and so is 0 / 1
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
  T* r0 = j0 < M ? blk.out_row(j0) : nullptr;
  T* r1 = j1 < M ? blk.out_row(j1) : nullptr;
  if constexpr (kFloat) {
#pragma unroll
    for (int jj = 0; jj < DV / 16; ++jj) {
      const int d = 16 * jj + 4 * t;
      if (r0)
        *reinterpret_cast<float4*>(r0 + d) =
            make_float4(o[2 * jj][0] / d0, o[2 * jj][1] / d0,
                        o[2 * jj][2] / d0, o[2 * jj][3] / d0);
      if (r1)
        *reinterpret_cast<float4*>(r1 + d) =
            make_float4(o[2 * jj + 1][0] / d1, o[2 * jj + 1][1] / d1,
                        o[2 * jj + 1][2] / d1, o[2 * jj + 1][3] / d1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (r0)
        *reinterpret_cast<__nv_bfloat162*>(r0 + d) =
            __floats2bfloat162_rn(o[j][0] / d0, o[j][1] / d0);
      if (r1)
        *reinterpret_cast<__nv_bfloat162*>(r1 + d) =
            __floats2bfloat162_rn(o[j][2] / d1, o[j][3] / d1);
    }
  }
}

}  // namespace attention_tile
