// The paged pool as the shared attention tile (attention_tile.cuh) sees
// it, for the chunked-prefill kernel (B1, paged_prefill_attention.cu) and
// the decode kernel (B2, paged_attention.cu): launch parameters, the block
// view of one (row, kv head), and the merge of split key spans.

#pragma once

#include "attention_tile.cuh"

namespace paged {

using namespace attention_tile;

constexpr int kSpanAlign = 64;        // a span is whole key tiles of both types
constexpr int kMergeThreads = 128;

struct Params {
  const void* q;                // (B, Hkv, C, r, dh) by the strides below
  const void* kpool;            // (slots, page, dh)
  const void* vpool;            // (slots, page, dh)
  const int* tables;            // (B, Hkv, max_pages)
  const int* lengths;           // (B,)
  const int* starts;            // (B,); unused in decode
  void* out;                    // (B, C, Hkv, r, dh)
  float* m_part;                // (B, Hkv, n_splits, M), log2 units
  float* l_part;                // (B, Hkv, n_splits, M)
  float* acc_part;              // (B, Hkv, n_splits, M, dh)
  long long sqb, sqh, sqc, sqr; // q strides, elements
  int Hkv, C, r, M, page, max_pages, slots, n_splits, span;
  float scale_log2;             // log2(e) / sqrt(dh)
};

// Row b, kv head h of the paged pools: folded row j = c * r + i (chunk
// token c, grouped query head i).  Chunked prefill: token c sits at
// starts[b] + c and sees the keys up to its position.  Decode (kDecode):
// one new token per row, which sees every key below lengths[b] (the
// one-token chunk at starts[b] = lengths[b] - 1; lengths 0 sees none).
// Either way lengths are clamped to the table width, and a key's row is
// read through block_tables[b, h, key / page], the entry clamped into the
// pool.
template <typename T, int DH, bool kDecode>
struct PagedBlock {
  static constexpr bool kLower = false;
  static constexpr bool kSplits = true;
  int M, r, C, Hkv, page, slots, b, h, length, start, n_splits, span;
  size_t bh;
  const int* tb;
  const T* kpool;
  const T* vpool;
  const T* qb;
  long long sqc, sqr;
  T* out;
  float* m_part;
  float* l_part;
  float* acc_part;
  float scale_log2;

  __device__ __forceinline__ PagedBlock(const Params& p, int b_, int h_)
      : M(p.M), r(p.r), C(p.C), Hkv(p.Hkv), page(p.page), slots(p.slots),
        b(b_), h(h_),
        length(max(0, min(p.lengths[b_], p.max_pages * p.page))),
        start(kDecode ? 0 : p.starts[b_]), n_splits(p.n_splits),
        span(p.span), bh(static_cast<size_t>(b_) * p.Hkv + h_),
        tb(p.tables + bh * p.max_pages),
        kpool(static_cast<const T*>(p.kpool)),
        vpool(static_cast<const T*>(p.vpool)),
        qb(static_cast<const T*>(p.q) + b_ * p.sqb + h_ * p.sqh),
        sqc(p.sqc), sqr(p.sqr), out(static_cast<T*>(p.out)),
        m_part(p.m_part), l_part(p.l_part), acc_part(p.acc_part),
        scale_log2(p.scale_log2) {}

  __device__ __forceinline__ int key_begin(int) const { return 0; }
  __device__ __forceinline__ int key_end(int j) const {
    return kDecode ? length : min(length, start + j / r + 1);
  }
  __device__ __forceinline__ const T* q_row(int j) const {
    return qb + (j / r) * sqc + (j % r) * sqr;
  }
  __device__ __forceinline__ size_t kv_row(int key) const {
    const int slot = min(max(__ldg(tb + key / page), 0), slots - 1);
    return static_cast<size_t>(slot) * page + key % page;
  }
  __device__ __forceinline__ const T* k_row(size_t i) const {
    return kpool + i * DH;
  }
  __device__ __forceinline__ const T* v_row(size_t i) const {
    return vpool + i * DH;
  }
  // (B, C, Hkv, r, dh) output
  __device__ __forceinline__ T* out_row(int j) const {
    return out + (((static_cast<size_t>(b) * C + j / r) * Hkv + h) * r +
                  j % r) * DH;
  }
  __device__ __forceinline__ size_t part_base(int split) const {
    return (bh * n_splits + split) * M;
  }
};

// Merge the live spans of one (row, kv head): M = max m_s,
// out = sum 2^(m_s - M) acc_s / sum 2^(m_s - M) l_s, 0 where that is 0.
template <typename T, int DH, bool kDecode>
__device__ __forceinline__ void merge_spans(const Params& p) {
  const PagedBlock<T, DH, kDecode> blk(p, blockIdx.y, blockIdx.x);
  const int kend = max(0, blk.key_end(p.M - 1));
  const int live = (kend + p.span - 1) / p.span;  // <= n_splits
  for (int idx = threadIdx.x; idx < p.M * DH; idx += kMergeThreads) {
    const int j = idx / DH, d = idx % DH;
    float m = kNegInf;
    for (int s = 0; s < live; ++s)
      m = fmaxf(m, p.m_part[blk.part_base(s) + j]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t ps = blk.part_base(s) + j;
      const float w = exp2f(p.m_part[ps] - m);
      l = fmaf(w, p.l_part[ps], l);
      acc = fmaf(w, p.acc_part[ps * DH + d], acc);
    }
    blk.out_row(j)[d] = from_float<T>(l > 0.f ? acc / l : 0.f);
  }
}

}  // namespace paged
