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
// What this design does about it: the shared tile of
// ../../csrc/attention_tile.cuh (bf16 products on the tensor cores through
// mma.sync, fp32 as CUDA-core FMAs, never TF32, chosen by dtype alone; K/V
// by cp.async into two stages) over the paged block view of
// paged_block.cuh.
//  - Tiles: 64 folded query rows per block (4 warps) and 64-key tiles (32
//    in fp32 and in split tiles).  A key's row address comes from the
//    table per key, so any page size works.  The key loop ends at the
//    tile's last visible key: pages past the length or in every row's
//    future are never read.  Within a row the last query tiles, which see
//    the most keys, launch first.
//  - Flash-decoding where a (row, kv head) has one query tile of <= 16 rows
//    (decode rows): one warp per block and the keys split into spans across
//    blocks by a plan the wrapper makes from shapes alone (ops.split_plan);
//    each block writes fp32 (m, l, acc) partials and a second kernel merges
//    the live spans.  Blocks whose span starts past the last visible key
//    exit at once; with one live span the merge is exact.
//  - q is read through its strides (the model's transposed view needs no
//    copy); the output is written in (B, C, Hkv, r, dh) order.

#include "paged_block.cuh"

namespace {

using namespace paged;

template <typename T, int DH, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
paged_prefill_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PagedBlock<T, DH, false> blk(p, blockIdx.z, blockIdx.y);
  const int n_qt = (p.M + 16 * kWarps - 1) / (16 * kWarps);
  attend_tile<T, DH, DH, kWarps>(
      blk, n_qt - 1 - static_cast<int>(blockIdx.x) / p.n_splits,
      static_cast<int>(blockIdx.x) % p.n_splits, smem);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMergeThreads)
paged_prefill_merge_kernel(const Params p) {
  merge_spans<T, DH, false>(p);
}

template <typename T, int DH, int kWarps>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<T, DH, DH, kWarps>;
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
  paged_prefill_merge_kernel<T, DH>
      <<<dim3(p.Hkv, B), kMergeThreads, 0, stream>>>(p);
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
