// Chunked paged-prefill attention over the head-granular paged KV pool,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_prefill_attention_kernel
//   (kernel body _paged_prefill_kernel).
// It computes the same function: for row b, kv head h and folded query row
// j = c * r + i (chunk token c, grouped query head i), causal attention
// over the keys k_pos with k_pos <= starts[b] + j / r and k_pos < lengths[b]
// (lengths clamped to the table width), the keys read through
// block_tables[b, h, k_pos / page] (entries clamped into the pool).  Online
// softmax (m, l, acc) in fp32 with scale 1/sqrt(dh); probabilities are
// multiplied by the mask so a row that has seen no key stays exact, l sums
// the unrounded fp32 P, P is rounded to V's type before the PV product, and
// rows with l == 0 write exactly 0.  Every one of the C * r rows is
// computed, padded chunk tokens included.
//
// What bounds it on the H100.  4 * dh FLOPs per (query row, visible key)
// against 2 * dh * sizeof(T) bytes per key, read once per (row, kv head).
// A decode row (C = 1, r = 5 at qwen3-14b) does 5 query rows per key: far
// below the ~295 FLOP/byte ridge, so the bytes bound it.  A decode row
// packed into the fused step's 64-token bucket defines 320 query rows that
// each see the whole context (the padded tokens' positions are past the
// length): about 320 FLOP/byte, at the ridge, so the tensor cores bound it.
//
// What this design does about it.
//  - bf16: both products on the tensor cores through
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  A warp owns 16 folded
//    query rows; their Q fragments stay in registers over the key loop.  K
//    comes from shared memory with ldmatrix, V with ldmatrix.trans; the
//    online softmax runs on the fp32 accumulator fragment (row max and sum
//    over the 4 threads of a quad), and P is rounded to bf16 in registers
//    and used directly as the A operand of P.V (the FlashAttention-2
//    register layout).  mma.sync rather than wgmma: its 16-row tile wastes
//    less on a 5-row decode tile than wgmma's 64 rows.
//  - fp32: the same tiles, pipeline and softmax, both products as fp32 FMAs
//    on the CUDA cores (never TF32: the 2e-5 tolerance forbids it),
//    register-tiled in the same fragment layout; P passes through shared
//    memory.  The choice between the two is made by dtype alone.
//  - Tiles: 64 folded query rows per block (4 warps) and 64-key tiles (32
//    in fp32 and in split tiles).  A key's row address comes from the
//    table per key, so any page size works.  The key loop ends at the
//    tile's last visible key: pages past the length or in every row's
//    future are never read.  Within a row the last query tiles, which see
//    the most keys, launch first.
//  - K/V tiles arrive by 16-byte cp.async into a ring of two stages, the
//    next tile in flight while the current one is computed.  Shared rows
//    are padded by 16 bytes, so the 8 rows of an ldmatrix (and the rows of
//    the fp32 float4 reads) fall on distinct bank groups.
//  - Flash-decoding where a (row, kv head) has one query tile of <= 16 rows
//    (decode rows): one warp per block and the keys split into spans across
//    blocks by a plan the wrapper makes from shapes alone; each block
//    writes fp32 (m, l, acc) partials and a second kernel merges the live
//    spans.  Blocks whose span starts past the last visible key exit at
//    once; with one live span the merge is exact.
//  - q is read through its strides (the model's transposed view needs no
//    copy); the output is written in (B, C, Hkv, r, dh) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kSpanAlign = 64;        // a span is whole key tiles of both types
constexpr int kStages = 2;            // K/V ring depth
constexpr int kMergeThreads = 128;

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

struct Params {
  const void* q;                // (B, Hkv, C, r, dh) by the strides below
  const void* kpool;            // (slots, page, dh)
  const void* vpool;            // (slots, page, dh)
  const int* tables;            // (B, Hkv, max_pages)
  const int* lengths;           // (B,)
  const int* starts;            // (B,)
  void* out;                    // (B, C, Hkv, r, dh)
  float* m_part;                // (B, Hkv, n_splits, M), log2 units
  float* l_part;                // (B, Hkv, n_splits, M)
  float* acc_part;              // (B, Hkv, n_splits, M, dh)
  long long sqb, sqh, sqc, sqr; // q strides, elements
  int Hkv, C, r, M, page, max_pages, slots, n_splits, span;
  float scale_log2;             // log2(e) / sqrt(dh)
};

template <typename T, int DH, int kWarps>
struct Layout {
  static constexpr int kM = 16 * kWarps;                 // query rows
  // keys: a one-warp split tile takes 32 (its loads, not its products,
  // bound it, and smaller stages let more blocks share an SM)
  static constexpr int kN = kWarps == 1 ? 32 : Tiles<T>::kN;
  static constexpr int kStride = DH + Tiles<T>::kPad;    // shared row
  static constexpr int kPStride = kN + 4;                // fp32 P row
  static constexpr size_t kQ = size_t(kM) * kStride * sizeof(T);
  static constexpr size_t kKV = size_t(kStages) * kN * kStride * sizeof(T);
  static constexpr size_t kP =
      std::is_same<T, float>::value ? size_t(kWarps) * 16 * kPStride * 4 : 0;
  static constexpr size_t kBytes = kQ + 2 * kKV + kP;
};

// 16 bytes global -> shared; src_bytes == 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far below what a sum of weights <= 1 can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copies per batch of a tile load: the largest divisor of n up to 8.
__host__ __device__ constexpr int copy_batch(int n) {
  return n % 8 == 0 ? 8 : n % 6 == 0 ? 6 : n % 4 == 0 ? 4 : n % 3 == 0 ? 3
                                                                   : 1;
}

// Keys of row b's table (lengths clamped to it) and, for query rows up to
// m_last, the end of the keys any of them sees.
__device__ __forceinline__ int last_key_end(const Params& p, int b,
                                            int m_last) {
  const int length = max(0, min(p.lengths[b], p.max_pages * p.page));
  return max(0, min(length, p.starts[b] + m_last / p.r + 1));
}

// Offset of folded row j's output row in (B, C, Hkv, r, dh).
__device__ __forceinline__ size_t out_row(const Params& p, int b, int h,
                                          int j) {
  return ((static_cast<size_t>(b) * p.C + j / p.r) * p.Hkv + h) * p.r +
         j % p.r;
}

// One block per (query tile, key span) x kv head x row.  Warp w owns the
// tile's folded rows 16 w .. 16 w + 15; lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 of them.  Scores use the mma accumulator layout
// in both types: s[j][e] / s[j][2 + e] is row g / g + 8 at key 8 j + 2 t + e.
template <typename T, int DH, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
paged_prefill_kernel(const Params p) {
  using L = Layout<T, DH, kWarps>;
  constexpr bool kFloat = std::is_same<T, float>::value;
  constexpr int kThreads = kWarps * 32;
  constexpr int kM = L::kM, kN = L::kN, kStride = L::kStride;
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kChunks = DH / kVec;             // 16-byte chunks per row
  static_assert(DH % 16 == 0, "head dim");

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + L::kQ);
  T* v_s = reinterpret_cast<T*>(smem + L::kQ + L::kKV);
  float* p_s = reinterpret_cast<float*>(smem + L::kQ + 2 * L::kKV);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = static_cast<int>(blockIdx.z);
  const int n_qt = (p.M + kM - 1) / kM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / p.n_splits;
  const int split = static_cast<int>(blockIdx.x) % p.n_splits;
  const int m0 = qt * kM;
  const int kend = last_key_end(p, b, min(m0 + kM, p.M) - 1);
  const int k_lo = split * p.span;
  if (p.n_splits > 1 && k_lo >= kend) return;   // a dead span: never merged
  const int k_hi = min(kend, k_lo + p.span);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kN - 1) / kN : 0;

  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  const int* tb = p.tables + bh * p.max_pages;
  const T* kpool = static_cast<const T*>(p.kpool);
  const T* vpool = static_cast<const T*>(p.vpool);

  // A tile is kN * kChunks 16-byte copies of K and as many of V, kCopies
  // per thread.  The table entries of a batch are read before any of its
  // copies is issued, so their latencies overlap instead of queueing
  // behind each copy.
  constexpr int kCopies = kN * kChunks / kThreads;
  constexpr int kBatch = copy_batch(kCopies);
  static_assert(kCopies * kThreads == kN * kChunks && kCopies % kBatch == 0,
                "tile copies");
  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_lo + tile * kN;
    T* ks = k_s + stage * kN * kStride;
    T* vs = v_s + stage * kN * kStride;
#pragma unroll 1
    for (int i0 = 0; i0 < kCopies; i0 += kBatch) {
      size_t off[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = tid + (i0 + i) * kThreads;
        const int key = min(k0 + c / kChunks, k_hi - 1);
        const int slot = min(max(__ldg(tb + key / p.page), 0), p.slots - 1);
        off[i] = (static_cast<size_t>(slot) * p.page + key % p.page) * DH +
                 (c % kChunks) * kVec;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = tid + (i0 + i) * kThreads;
        const int dst = (c / kChunks) * kStride + (c % kChunks) * kVec;
        const int bytes = k0 + c / kChunks < k_hi ? 16 : 0;  // else zeros
        cp_async16(ks + dst, kpool + off[i], bytes);
        cp_async16(vs + dst, vpool + off[i], bytes);
      }
    }
  };

  if (n_tiles > 0) {
    const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    for (int c = tid; c < kM * kChunks; c += kThreads) {
      const int row = c / kChunks, col = (c % kChunks) * kVec;
      const int j = m0 + row;
      const T* src = qb;
      int bytes = 0;
      if (j < p.M) {
        src = qb + (j / p.r) * p.sqc + (j % p.r) * p.sqr + col;
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
  const bool warp_live = wrow < p.M;
  const int start = p.starts[b];
  const int length = max(0, min(p.lengths[b], p.max_pages * p.page));
  // keys < lim are visible to rows g and g + 8 of the warp; the warp's
  // first row sees the fewest
  const int lim0 = min(length, start + (wrow + g) / p.r + 1);
  const int lim1 = min(length, start + (wrow + g + 8) / p.r + 1);
  const int lim_warp = min(length, start + wrow / p.r + 1);

  uint32_t qf[kFloat ? 1 : DH / 16][4];         // Q fragments (bf16)
  if constexpr (!kFloat) {
    if (n_tiles > 0) {
      const int row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + row * kStride + kk * 16 + (lane >> 4) * 8);
    }
  }

  float o[DH / 8][4];   // bf16: mma layout; fp32: o[2jj] / o[2jj + 1] is
                        // row g / g + 8 at columns 16 jj + 4 t .. + 3
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
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
    const T* vs = v_s + (it % kStages) * kN * kStride;

    float s[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

    if constexpr (kFloat) {
      const float* qa = q_s + (16 * warp + g) * kStride;
      const float* qc = qa + 8 * kStride;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
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
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < kN / 16; ++nn) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, ks + (16 * nn + krow) * kStride + 16 * kk + kcol);
          mma_bf16(s[2 * nn], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], bfr[2], bfr[3]);
        }
    }

    // online softmax on the score fragment, in log2 units
    const bool full = k0 + kN <= lim_warp;      // no key masked for the warp
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        float a = s[j][e] * p.scale_log2, c = s[j][2 + e] * p.scale_log2;
        if (!full) {
          a = key < lim0 ? a : kNegInf;
          c = key < lim1 ? c : kNegInf;
        }
        s[j][e] = a;
        s[j][2 + e] = c;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, c);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = ex2(m_run[0] - mx0);
    const float alpha1 = ex2(m_run[1] - mx1);
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
        if (!full) {
          a = key < lim0 ? a : 0.f;
          c = key < lim1 ? c : 0.f;
        }
        s[j][e] = a;
        s[j][2 + e] = c;
        sum0 += a;
        sum1 += c;
      }
    l_run[0] = alpha0 * l_run[0] + sum0;
    l_run[1] = alpha1 * l_run[1] + sum1;

    if constexpr (kFloat) {
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj)
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
        for (int jj = 0; jj < DH / 16; ++jj) {
          const float4 v = *reinterpret_cast<const float4*>(
              vs + k * kStride + 16 * jj + 4 * t);
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
      for (int j = 0; j < DH / 8; ++j) {
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
        for (int nd = 0; nd < DH / 16; ++nd) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr,
                            vs + (16 * kk + vrow) * kStride + 16 * nd + vcol);
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
  if (p.n_splits > 1) {
    // unnormalised partials of this span
    const size_t base = (bh * p.n_splits + split) * p.M;
    if (t == 0 && j0 < p.M) {
      p.m_part[base + j0] = m_run[0];
      p.l_part[base + j0] = l0;
    }
    if (t == 0 && j1 < p.M) {
      p.m_part[base + j1] = m_run[1];
      p.l_part[base + j1] = l1;
    }
    float* a0 = p.acc_part + (base + j0) * DH;
    float* a1 = p.acc_part + (base + j1) * DH;
    if constexpr (kFloat) {
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj) {
        const int d = 16 * jj + 4 * t;
        if (j0 < p.M)
          *reinterpret_cast<float4*>(a0 + d) = make_float4(
              o[2 * jj][0], o[2 * jj][1], o[2 * jj][2], o[2 * jj][3]);
        if (j1 < p.M)
          *reinterpret_cast<float4*>(a1 + d) =
              make_float4(o[2 * jj + 1][0], o[2 * jj + 1][1],
                          o[2 * jj + 1][2], o[2 * jj + 1][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = 8 * j + 2 * t;
        if (j0 < p.M)
          *reinterpret_cast<float2*>(a0 + d) = make_float2(o[j][0], o[j][1]);
        if (j1 < p.M)
          *reinterpret_cast<float2*>(a1 + d) = make_float2(o[j][2], o[j][3]);
      }
    }
    return;
  }

  // rows with l == 0 saw no key: their acc is exactly 0, and so is 0 / 1
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
  T* out = static_cast<T*>(p.out);
  T* r0 = j0 < p.M ? out + out_row(p, b, h, j0) * DH : nullptr;
  T* r1 = j1 < p.M ? out + out_row(p, b, h, j1) * DH : nullptr;
  if constexpr (kFloat) {
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) {
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
    for (int j = 0; j < DH / 8; ++j) {
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

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Merge the live spans of one (row, kv head): M = max m_s,
// out = sum 2^(m_s - M) acc_s / sum 2^(m_s - M) l_s, 0 where that is 0.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_prefill_merge_kernel(const Params p, int dh) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kend = last_key_end(p, b, p.M - 1);
  const int live = (kend + p.span - 1) / p.span;  // <= n_splits
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < p.M * dh; idx += kMergeThreads) {
    const int j = idx / dh, d = idx % dh;
    float m = kNegInf;
    for (int s = 0; s < live; ++s)
      m = fmaxf(m, p.m_part[(bh * p.n_splits + s) * p.M + j]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t ps = (bh * p.n_splits + s) * p.M + j;
      const float w = exp2f(p.m_part[ps] - m);
      l = fmaf(w, p.l_part[ps], l);
      acc = fmaf(w, p.acc_part[ps * dh + d], acc);
    }
    out[out_row(p, b, h, j) * dh + d] = from_float<T>(l > 0.f ? acc / l : 0.f);
  }
}

template <typename T, int DH, int kWarps>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<T, DH, kWarps>;
  auto* kernel = paged_prefill_kernel<T, DH, kWarps>;
  static bool configured = false;  // once per instance: above 48 KB of
  if (!configured) {               // shared memory only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qt = (p.M + L::kM - 1) / L::kM;
  kernel<<<dim3(n_qt * p.n_splits, p.Hkv, B), kWarps * 32, L::kBytes,
           stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  paged_prefill_merge_kernel<T>
      <<<dim3(p.Hkv, B), kMergeThreads, 0, stream>>>(p, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_rows(const Params& p, int B, cudaStream_t stream) {
  // one warp where a (row, kv head) has a single tile of <= 16 rows
  return p.M <= 16 ? launch<T, DH, 1>(p, B, stream)
                   : launch<T, DH, 4>(p, B, stream);
}

template <typename T>
cudaError_t dispatch_dh(int dh, const Params& p, int B, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return dispatch_rows<T, 64>(p, B, stream);
    case 96:
      return dispatch_rows<T, 96>(p, B, stream);
    case 128:
      return dispatch_rows<T, 128>(p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (tensor cores).  q,
// kpool, vpool and out share it.  q is read through its strides (elements;
// the last dim contiguous), out is (B, C, Hkv, r, dh) contiguous.  With
// n_splits > 1 (only where C * r <= 16) the keys are cut into spans of
// span keys (a multiple of 64) and m_part, l_part (B, Hkv, n_splits, C * r)
// and acc_part (.., dh) are fp32 scratch; with n_splits == 1 they are
// unused and span covers the table.  Returns the launches'
// cudaGetLastError() (0 on success).
extern "C" int paged_prefill_attention(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* lengths, const void* starts, void* out, void* m_part,
    void* l_part, void* acc_part, int B, int Hkv, int C, int r, int dh,
    int page, int max_pages, int slots, long long sqb, long long sqh,
    long long sqc, long long sqr, int n_splits, int span, float scale,
    int dtype, void* stream) {
  if (B == 0 || Hkv == 0 || C == 0 || r == 0) return 0;
  const int M = C * r;
  if (n_splits < 1 || span < 1 || slots < 1 ||
      (n_splits > 1 && (M > 16 || span % kSpanAlign != 0)))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kpool = kpool;
  p.vpool = vpool;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.starts = static_cast<const int*>(starts);
  p.out = out;
  p.m_part = static_cast<float*>(m_part);
  p.l_part = static_cast<float*>(l_part);
  p.acc_part = static_cast<float*>(acc_part);
  p.sqb = sqb;
  p.sqh = sqh;
  p.sqc = sqc;
  p.sqr = sqr;
  p.Hkv = Hkv;
  p.C = C;
  p.r = r;
  p.M = M;
  p.page = page;
  p.max_pages = max_pages;
  p.slots = slots;
  p.n_splits = n_splits;
  p.span = span;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, p, B, s);
    case 1:
      return dispatch_dh<bf16>(dh, p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}
