// Paged decode attention over the head-granular paged KV pool, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
//   (kernel body _paged_kernel).
// It computes the same function: for row b, kv head h and grouped query row
// i < r (one new token per row), attention over the keys k_pos < lengths[b]
// (lengths clamped to the table width), read through
// block_tables[b, h, k_pos / page] (entries clamped into the pool).  Online
// softmax (m, l, acc) in fp32 with scale 1/sqrt(dh); l sums the unrounded
// fp32 P, P is rounded to V's type before the PV product, and rows with
// l == 0 (lengths 0, the bucket padding) write exactly 0.
//
// What bounds it on the H100.  Decode does r query rows per key: 4 * r * dh
// FLOPs per visible key against 2 * dh * sizeof(T) bytes of K and V, about
// r FLOP/byte in bf16 (5 for qwen3-14b), far below the ~295 FLOP/byte where
// the tensor cores, not HBM, become the limit.  So the bound is the bytes:
// the K/V of every key below lengths[b] read once, plus q, the table
// entries and the output.
//
// What this design does about it, in bf16 at a page of 8, 16, 32 or 64
// keys (every served config: 16) and r > 1: the decode tile of
// paged_decode_tma.cuh, which B1 shares for its launches of at most 16
// folded rows a (row, kv head).  A persistent grid of two blocks an SM splits the live 64-key
// tiles of all (row, kv head)s between them (each (row, kv head)
// weighed as its tiles plus a fixed cost), each block a TMA
// producer warp keeping a ring of page boxes in flight and four mma.sync
// consumer warps, 16 keys of each tile apiece; a (row, kv head) that
// crosses blocks is merged by the last of them, in the same launch.
//
// Elsewhere (fp32, other pages, MHA's r = 1) the chunked-prefill kernel's
// split tile (paged_block.cuh over ../../csrc/attention_tile.cuh), which
// is the same function at C = 1 and starts[b] = lengths[b] - 1.
//  - One warp per (key span, kv head, row): the r <= 16 query rows of the
//    (row, kv head) are one m16 tile, so every K/V tile read serves all r
//    rows.  The spans come from the wrapper's shape-only plan
//    (ops.split_plan with C = 1: about 1024 blocks, spans of whole 64-key
//    multiples), so the bytes of a ragged batch stream in parallel.
//  - 32-key tiles arrive by 16-byte cp.async through the table (one table
//    read per key, the entry clamped into the pool here, not on the host)
//    into two stages; both products run as FMAs on the CUDA cores (never
//    TF32; mma.sync bf16 at another page).
//  - Each block writes its span's fp32 (m, l, acc) partials and a second
//    kernel merges the live spans; blocks whose span starts at or past the
//    length exit at once, so pages past the length are never read, and
//    with one live span the merge is exact.
//  - q is read through its strides (no copy).

#include "paged_block.cuh"
#include "paged_decode_tma.cuh"

namespace {

using namespace paged;

template <typename T, int DH>
__global__ void __launch_bounds__(32) paged_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PagedBlock<T, DH, true> blk(p, blockIdx.z, blockIdx.y);
  attend_tile<T, DH, DH, 1>(blk, 0, blockIdx.x, smem);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge_kernel(const Params p) {
  merge_spans<T, DH, true>(p);
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kBytes = Layout<T, DH, DH, 1>::kBytes;
  auto* kernel = paged_decode_kernel<T, DH>;
  static bool configured = false;  // once per instance
  const cudaError_t e = allow_smem(kernel, kBytes, configured);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.n_splits, p.Hkv, B), 32, kBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  paged_decode_merge_kernel<T, DH>
      <<<dim3(p.Hkv, B), kMergeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// By dtype and shape alone (ops.decode_tile): bf16 at a page the boxes
// take and r > 1 runs the decode tile (paged_decode_tma.cuh), else the
// one-warp split tile
template <typename T, int DH>
cudaError_t dispatch_tile(const Params& p, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    if (decode_tile_takes(p.page, p.r))
      return paged_tma::launch<DH, true>(p, p.n_blocks, stream);
  return launch<T, DH>(p, B, stream);
}

template <typename T>
cudaError_t dispatch_dh(int dh, const Params& p, int B, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return dispatch_tile<T, 64>(p, B, stream);
    case 96:
      return dispatch_tile<T, 96>(p, B, stream);
    case 128:
      return dispatch_tile<T, 128>(p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (tensor cores).  q,
// kpool, vpool and out share it.  q is (B, Hkv, r, dh) read through its
// strides (elements; the last dim contiguous), out is (B, Hkv, r, dh)
// contiguous.  The split tile: the keys are cut into n_splits spans of
// span keys (a multiple of 64 covering the table); with n_splits > 1,
// m_part, l_part (B, Hkv, n_splits, r) and acc_part (.., dh) are fp32
// scratch, else unused.  The decode tile (bf16 at a page in 8, 16, 32,
// 64): a grid of n_blocks; m_part, l_part (2 n_blocks, r) and acc_part
// (.., dh) fp32 scratch, tickets (B, Hkv) int32 zeros, which it leaves
// zero.  Returns the launches' cudaGetLastError() (0 on success).
extern "C" int paged_attention(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* lengths, void* out, void* m_part,
                               void* l_part, void* acc_part, void* tickets,
                               int B, int Hkv, int r, int dh, int page,
                               int max_pages, int slots, long long sqb,
                               long long sqh, long long sqr, int n_splits,
                               int span, int n_blocks, float scale,
                               int dtype, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (r < 1 || r > 16 || n_splits < 1 || span < 1 || slots < 1 ||
      span % kSpanAlign != 0 ||
      static_cast<long long>(n_splits) * span < static_cast<long long>(
                                                    max_pages) * page)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kpool = kpool;
  p.vpool = vpool;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.starts = nullptr;
  p.out = out;
  p.m_part = static_cast<float*>(m_part);
  p.l_part = static_cast<float*>(l_part);
  p.acc_part = static_cast<float*>(acc_part);
  p.tickets = static_cast<int*>(tickets);
  p.sqb = sqb;
  p.sqh = sqh;
  p.sqc = 0;
  p.sqr = sqr;
  p.B = B;
  p.Hkv = Hkv;
  p.C = 1;
  p.r = r;
  p.M = r;
  p.page = page;
  p.max_pages = max_pages;
  p.slots = slots;
  p.n_splits = n_splits;
  p.span = span;
  p.n_blocks = n_blocks;
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
