// Paged decode attention over the head-granular paged KV pool, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
//   (kernel body _paged_kernel).
// It computes the same function: for row b, kv head h and grouped query row
// i < r (one new token per row), attention over the keys k_pos < lengths[b],
// read through block_tables[b, h, k_pos / page].  Online softmax (m, l, acc)
// in fp32 with scale 1/sqrt(dh); masked keys get weight exp(-1e30 - m) == 0
// (no mask multiply is needed: every tile read holds at least one visible
// key), rows with l == 0 (lengths 0, the bucket padding) write exactly 0,
// and P is rounded to V's type before the PV product.
//
// What bounds it on the H100.  Decode does r query rows per key: 4 * r * dh
// FLOPs per visible key against 2 * dh * sizeof(T) bytes of K and V, about
// r FLOP/byte in bf16 (5 for qwen3-14b), far below the ~295 FLOP/byte where
// the tensor cores, not HBM, become the limit.  So the bound is the bytes:
// the K/V of every key below lengths[b] read once, plus q, the table
// entries and the output.
//
// What this first design does about it.  The chunked-prefill kernel (B1)
// runs one block per (row, kv head) over the whole context; at a 16-row
// decode batch that is 128 blocks on 132 SMs, each walking up to 2048 keys
// serially, and it measured 0.73-0.75 ms against a 0.023 ms bound on an
// H100.  B2 splits each context into spans of split_keys keys
// (flash-decoding): one block per (span, kv head, row), so the batch puts
// about sum(lengths) / split_keys * Hkv blocks on the card.  A block keeps
// all r query rows of its (row, kv head), so each K/V tile it reads serves
// r rows.  It loops over 32-key tiles (one key per lane of a warp; warp w
// owns query rows w, w + 4, ...), widens 16-byte K/V loads to fp32 in
// shared memory, runs both products as fp32 FMAs on the CUDA cores (fp32
// inputs never go through TF32), and writes its span's unnormalised
// (m, l, acc) in fp32.  A second kernel merges the spans of each (row, kv
// head): M = max m_s, out = sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s.
// Blocks whose span starts at or past the length exit at once and the merge
// reads only the live spans, so pages past the length are never read.
// With one live span the merge is exact (weights exp(0) == 1).  Tensor
// cores, TMA and cp.async pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 32;                       // keys per tile, one a lane
constexpr int kMaxR = 16;                        // query rows per kv head
constexpr int kRowsPerWarp = kMaxR / kWarps;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec16 {                // elements of T in one 16-byte load
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T from global memory, widened to fp32 in shared memory.
template <typename T>
__device__ __forceinline__ void load_widen(const T* __restrict__ src,
                                           float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_float(e[i]), to_float(e[i + 1]), to_float(e[i + 2]),
                    to_float(e[i + 3]));
  }
}

__device__ __forceinline__ void zero_fill(float* dst, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Keys of row b the function reads: below lengths[b] and inside the table.
__device__ __forceinline__ int visible_keys(const int* lengths, int b,
                                            int page, int max_pages) {
  return max(0, min(lengths[b], max_pages * page));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,          // (B, Hkv, r, DH)
                          const T* __restrict__ kpool,      // (slots, page, DH)
                          const T* __restrict__ vpool,      // (slots, page, DH)
                          const int* __restrict__ tables,   // (B, Hkv, max_pages)
                          const int* __restrict__ lengths,  // (B,)
                          float* __restrict__ m_part,       // (B, Hkv, S, r)
                          float* __restrict__ l_part,       // (B, Hkv, S, r)
                          float* __restrict__ acc_part,     // (B, Hkv, S, r, DH)
                          int Hkv, int r, int page, int max_pages,
                          int split_keys, int n_splits, float scale) {
  static_assert(DH % Vec16<T>::N == 0 && DH % 4 == 0, "head dim");
  // +4 floats per row keeps float4 alignment and puts the 8 key rows of
  // one quarter-warp float4 read on distinct bank groups
  constexpr int kStride = DH + 4;
  constexpr int kVec = Vec16<T>::N;
  constexpr int kChunks = DH / kVec;                  // 16 B loads per row
  constexpr int kAcc = (kMaxR * DH + kThreads - 1) / kThreads;

  __shared__ __align__(16) float q_s[kMaxR][kStride];
  __shared__ __align__(16) float k_s[kTileN][kStride];
  __shared__ __align__(16) float v_s[kTileN][DH];
  __shared__ float p_s[kMaxR][kTileN];
  __shared__ float alpha_s[kMaxR];

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = visible_keys(lengths, b, page, max_pages);
  const int k_begin = split * split_keys;
  if (k_begin >= length) return;           // a dead span: the merge skips it
  const int k_end = min(length, k_begin + split_keys);

  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const T* qb = q + bh * r * DH;
  const int* tb = tables + bh * max_pages;

  for (int c = tid; c < r * kChunks; c += kThreads) {
    const int i = c / kChunks, d = (c % kChunks) * kVec;
    load_widen(qb + static_cast<size_t>(i) * DH + d, &q_s[i][d]);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
  }
  // PV phase: thread owns acc entries idx = j * kThreads + tid < r * DH
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileN) {
    __syncthreads();  // q_s written / previous tile's k_s, v_s, p_s read
    for (int c = tid; c < kTileN * kChunks; c += kThreads) {
      const int j = c / kChunks, d = (c % kChunks) * kVec;
      const int key = k0 + j;
      if (key < k_end) {
        const size_t off =
            (static_cast<size_t>(tb[key / page]) * page + key % page) * DH + d;
        load_widen(kpool + off, &k_s[j][d]);
        load_widen(vpool + off, &v_s[j][d]);
      } else {
        zero_fill(&k_s[j][d], kVec);
        zero_fill(&v_s[j][d], kVec);
      }
    }
    __syncthreads();

    // score phase: lane owns key k0 + lane, warp owns rows warp + 4 * jr
    const bool valid = k0 + lane < k_end;
#pragma unroll
    for (int jr = 0; jr < kRowsPerWarp; ++jr) {
      const int i = warp + kWarps * jr;
      if (i >= r) break;                   // warp-uniform
      const float4* qr = reinterpret_cast<const float4*>(&q_s[i][0]);
      const float4* kr = reinterpret_cast<const float4*>(&k_s[lane][0]);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 a = qr[d4], c = kr[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      s = valid ? s * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // the tile holds a visible key (k0 < k_end), so m_cur is finite and
      // a masked key's weight exp(-1e30 - m_cur) is exactly 0
      const float m_cur = fmaxf(m_run[jr], mx);
      const float p = valid ? expf(s - m_cur) : 0.f;
      const float alpha = expf(m_run[jr] - m_cur);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[jr] = alpha * l_run[jr] + ps;
      m_run[jr] = m_cur;
      p_s[i][lane] = to_float(from_float<T>(p));  // P in V's type
      if (lane == 0) alpha_s[i] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = j * kThreads + tid;
      if (idx < r * DH) {
        const int i = idx / DH, d = idx % DH;
        float a = acc[j] * alpha_s[i];
#pragma unroll 8
        for (int n = 0; n < kTileN; ++n) a = fmaf(p_s[i][n], v_s[n][d], a);
        acc[j] = a;
      }
    }
  }

  const size_t part = (bh * n_splits + split) * r;    // (b, h, split, 0)
  if (lane == 0) {
#pragma unroll
    for (int jr = 0; jr < kRowsPerWarp; ++jr) {
      const int i = warp + kWarps * jr;
      if (i < r) {
        m_part[part + i] = m_run[jr];
        l_part[part + i] = l_run[jr];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = j * kThreads + tid;
    if (idx < r * DH) acc_part[part * DH + idx] = acc[j];
  }
}

// Merge the live spans of one (row, kv head): every thread owns output
// entries idx = i * dh + d of that (b, h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            const float* __restrict__ acc_part,
                            const int* __restrict__ lengths,
                            T* __restrict__ out,            // (B, Hkv, r, dh)
                            int Hkv, int r, int dh, int page, int max_pages,
                            int split_keys, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int length = visible_keys(lengths, b, page, max_pages);
  const int live = (length + split_keys - 1) / split_keys;  // <= n_splits
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  for (int idx = threadIdx.x; idx < r * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx % dh;
    float M = kNegInf;
    for (int s = 0; s < live; ++s)
      M = fmaxf(M, m_part[(bh * n_splits + s) * r + i]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t ps = (bh * n_splits + s) * r + i;
      const float w = expf(m_part[ps] - M);
      L = fmaf(w, l_part[ps], L);
      O = fmaf(w, acc_part[ps * dh + d], O);
    }
    out[bh * r * dh + idx] = from_float<T>(L > 0.f ? O / L : 0.f);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* tables, const int* lengths, void* out,
                   float* m_part, float* l_part, float* acc_part, int B,
                   int Hkv, int r, int page, int max_pages, int split_keys,
                   int n_splits, float scale, cudaStream_t stream) {
  if (n_splits > 0) {
    const dim3 grid(n_splits, Hkv, B);
    paged_decode_split_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kpool),
        static_cast<const T*>(vpool), tables, lengths, m_part, l_part,
        acc_part, Hkv, r, page, max_pages, split_keys, n_splits, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  paged_decode_combine_kernel<T><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, lengths, static_cast<T*>(out), Hkv, r, DH,
      page, max_pages, split_keys, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* kpool,
                        const void* vpool, const int* tables,
                        const int* lengths, void* out, float* m_part,
                        float* l_part, float* acc_part, int B, int Hkv, int r,
                        int page, int max_pages, int split_keys, int n_splits,
                        float scale, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, kpool, vpool, tables, lengths, out, m_part,
                           l_part, acc_part, B, Hkv, r, page, max_pages,
                           split_keys, n_splits, scale, stream);
    case 96:
      return launch<T, 96>(q, kpool, vpool, tables, lengths, out, m_part,
                           l_part, acc_part, B, Hkv, r, page, max_pages,
                           split_keys, n_splits, scale, stream);
    case 128:
      return launch<T, 128>(q, kpool, vpool, tables, lengths, out, m_part,
                            l_part, acc_part, B, Hkv, r, page, max_pages,
                            split_keys, n_splits, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, kpool, vpool and out share it;
// m_part, l_part (B, Hkv, n_splits, r) and acc_part (B, Hkv, n_splits, r,
// dh) are fp32 scratch, n_splits = ceil(max_pages * page / split_keys).
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int paged_attention(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* lengths, void* out, void* m_part,
                               void* l_part, void* acc_part, int B, int Hkv,
                               int r, int dh, int page, int max_pages,
                               int split_keys, int n_splits, float scale,
                               int dtype, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (r < 1 || r > kMaxR || split_keys < 1 || n_splits < 0)
    return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, q, kpool, vpool, t, ln, out, mp, lp, ap,
                                B, Hkv, r, page, max_pages, split_keys,
                                n_splits, scale, s);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, q, kpool, vpool, t, ln, out, mp,
                                        lp, ap, B, Hkv, r, page, max_pages,
                                        split_keys, n_splits, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
