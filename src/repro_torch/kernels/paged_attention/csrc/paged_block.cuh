// The paged pool as the chunked-prefill kernel (B1,
// paged_prefill_attention.cu) and the decode kernel (B2,
// paged_attention.cu) see it: launch parameters, the block view of one
// (row, kv head) for the shared attention tile (attention_tile.cuh), the
// merge of split key spans, and the TMA maps of a layer's pools that both
// libraries' TMA-fed kernels read (one cache of encoded maps a library).

#pragma once

#include <functional>
#include <mutex>
#include <unordered_map>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace paged {

using namespace attention_tile;

constexpr int kSpanAlign = 64;        // a span is whole key tiles of both types
constexpr int kMergeThreads = 128;

// Whether the page cuts a 64-key tile into boxes of whole 1024-byte
// swizzle groups (what the TMA-fed kernels take: B1's wgmma path and the
// decode tile of paged_decode_tma.cuh)
__host__ __device__ constexpr bool wgmma_page(int page) {
  return page == 8 || page == 16 || page == 32 || page == 64;
}

// Whether a bf16 launch of at most 16 folded rows a (row, kv head) runs
// the decode tile (paged_decode_tma.cuh): at a page the boxes take, with
// r > 1 query rows a kv head.  MHA (r = 1) keeps the one-warp split tile:
// a (row, kv head) there carries a row's keys for one query row, so a
// batch is twice to four times the decode tile's segments for the same
// bytes, and the split tile measured 11-17 % faster on an H100 at r = 1
// (dh 64 and 96), against 2-7 % slower at r = 5
__host__ __device__ constexpr bool decode_tile_takes(int page, int r) {
  return wgmma_page(page) && r > 1;
}

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
  float* acc_part;              // (B, Hkv, n_splits, M, dh); the decode
                                // tile: (2 x its grid, M(, dh)) pieces
  int* tickets;                 // the decode tile: (B, Hkv), zero between
                                // launches
  long long sqb, sqh, sqc, sqr; // q strides, elements
  int B, Hkv, C, r, M, page, max_pages, slots, n_splits, span;
  int n_blocks;                 // the decode tile's grid
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

// Above 48 KB of dynamic shared memory only when asked for: once per
// kernel instance (``configured`` its own static)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

// The tensor maps of one layer's K and V pools, (slots, page, dh) as
// 4-D (dh, page, slots, 1): boxes of `cols` columns (64 in the 128-byte
// swizzle, zeros past dh; 32 in the 64-byte swizzle) x one page.  Encoded
// once per pool view: a map holds only the base, the sizes and the
// strides, so an entry is right for any pool with its key (a reused
// address included).
struct MapKey {
  const void* k;
  const void* v;
  int slots, page, dh, cols;
  bool operator==(const MapKey& o) const {
    return k == o.k && v == o.v && slots == o.slots && page == o.page &&
           dh == o.dh && cols == o.cols;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& m) const {
    const std::hash<const void*> hp;
    size_t x = hp(m.k) * 31 + hp(m.v);
    return (((x * 31 + m.slots) * 31 + m.page) * 31 + m.dh) * 31 + m.cols;
  }
};
struct PoolMaps {
  CUtensorMap k, v;
};

// One cache a library (internal linkage: no symbol shared across the
// libraries a process loads)
static bool pool_maps(const Params& p, int dh, int cols, PoolMaps* maps) {
  static std::mutex mu;
  static std::unordered_map<MapKey, PoolMaps, MapKeyHash> cache;
  const MapKey key{p.kpool, p.vpool, p.slots, p.page, dh, cols};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    PoolMaps m;
    const long long st[3] = {0, static_cast<long long>(p.page) * dh, dh};
    if (!hopper::bf16_map(&m.k, p.kpool, 1, p.slots, p.page, dh, st, p.page,
                          cols) ||
        !hopper::bf16_map(&m.v, p.vpool, 1, p.slots, p.page, dh, st, p.page,
                          cols))
      return false;
    if (cache.size() >= 4096) cache.clear();   // pools come and go
    it = cache.emplace(key, m).first;
  }
  *maps = it->second;
  return true;
}

}  // namespace paged
