// Chunked paged-prefill attention over the head-granular paged KV pool,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_prefill_attention_kernel
//   (kernel body _paged_prefill_kernel).
// It computes the same function: for row b, kv head h and query row
// j = c * r + i (chunk token c, grouped query head i), causal attention
// over the keys k_pos with k_pos <= starts[b] + j / r and k_pos < lengths[b],
// the keys read through block_tables[b, h, k_pos / page].  Online softmax
// (m, l, acc) in fp32 with scale 1/sqrt(dh); probabilities are multiplied
// by the mask so a row that has seen no key stays exact, rows with l == 0
// write 0, and P is rounded to V's type before the PV product.
//
// What bounds it on the H100.  At the serving shapes (GQA r = 5, dh = 128,
// page 16, bf16 pools, chunks of <= 64 tokens) the work is about
// 4 * dh FLOPs per (query row, visible key) against 2 * dh * 2 bytes per
// key read once per (row, kv head): decode rows do 5 query rows per key,
// prefill chunks <= 320, far below the ~295 FLOP/byte where the tensor
// cores, not HBM, become the limit.  So the bound is the bytes: every K/V
// page below lengths[b] read once, plus q in and out.
//
// What this first design does about it.  One block per (b, h, tile of 16
// query rows); inside it, a loop over 16-key tiles up to the last key the
// tile can see (min(lengths[b], last query position + 1): keys past it are
// masked for every row and leave (m, l, acc) unchanged), so pages past the
// length or in every row's future are never read.  Each thread reads its
// own block-table entries.  K/V tiles are loaded as 16-byte vectors,
// widened to fp32 in shared memory, and both products run as fp32 FMAs on
// the CUDA cores (fp32 inputs never go through TF32).  Query tiles of one
// (b, h) re-read the same pages, mostly from L2.  Tensor cores (wgmma),
// TMA pipelining and splitting long contexts across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockM = 16;   // query rows per block
constexpr int kBlockN = 16;   // keys per tile
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q,          // (B, Hkv, M, DH)
                     const T* __restrict__ kpool,      // (slots, page, DH)
                     const T* __restrict__ vpool,      // (slots, page, DH)
                     const int* __restrict__ tables,   // (B, Hkv, max_pages)
                     const int* __restrict__ lengths,  // (B,)
                     const int* __restrict__ starts,   // (B,)
                     T* __restrict__ out,              // (B, Hkv, M, DH)
                     int Hkv, int M, int r, int page, int max_pages,
                     float scale) {
  static_assert(DH % Vec16<T>::N == 0 && DH % 4 == 0, "head dim");
  static_assert((kBlockM * DH) % kThreads == 0, "accumulator split");
  // +4 floats per row keeps float4 alignment and puts the 16 key rows of
  // one float4 read on distinct bank groups
  constexpr int kStride = DH + 4;
  constexpr int kVec = Vec16<T>::N;
  constexpr int kChunks = DH / kVec;                  // 16 B loads per row
  constexpr int kAcc = kBlockM * DH / kThreads;       // acc entries/thread

  __shared__ __align__(16) float q_s[kBlockM][kStride];
  __shared__ __align__(16) float k_s[kBlockN][kStride];
  __shared__ __align__(16) float v_s[kBlockN][DH];
  __shared__ float p_s[kBlockM][kBlockN];
  __shared__ float alpha_s[kBlockM];
  __shared__ float l_s[kBlockM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // keys past the table are never visible, as in the reference's grid
  const int length = max(0, min(lengths[b], max_pages * page));
  const int start = starts[b];
  const int m_last = min(m0 + kBlockM, M) - 1;
  // last key any row of this tile may see, plus one
  const int kend = min(length, start + m_last / r + 1);

  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const T* qb = q + bh * M * DH;
  T* ob = out + bh * M * DH;
  const int* tb = tables + bh * max_pages;

  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int m = c / kChunks, d = (c % kChunks) * kVec;
    if (m0 + m < M)
      load_widen(qb + static_cast<size_t>(m0 + m) * DH + d, &q_s[m][d]);
    else
      zero_fill(&q_s[m][d], kVec);
  }

  // score phase: half-warp g owns query rows g and g + 8, lane n owns key n
  const int n = tid & 15;
  const int g = tid >> 4;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  // PV phase: thread owns acc entries idx = j * kThreads + tid
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // q_s written / previous tile's k_s, v_s, p_s read
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int j = c / kChunks, d = (c % kChunks) * kVec;
      const int key = k0 + j;
      if (key < kend) {
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

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = g + 8 * i;
      const float4* qr = reinterpret_cast<const float4*>(&q_s[m][0]);
      const float4* kr = reinterpret_cast<const float4*>(&k_s[n][0]);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 a = qr[d4], c = kr[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      s *= scale;
      const int key = k0 + n;
      const int q_pos = start + (m0 + m) / r;
      const bool ok = key <= q_pos && key < length;
      s = ok ? s : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m_run[i], mx);
      const float p = ok ? expf(s - m_cur) : 0.f;
      const float alpha = expf(m_run[i] - m_cur);
      float ps = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[i] = alpha * l_run[i] + ps;
      m_run[i] = m_cur;
      p_s[m][n] = to_float(from_float<T>(p));  // P in V's type
      if (n == 0) alpha_s[m] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = j * kThreads + tid;
      const int m = idx / DH, d = idx % DH;
      float a = acc[j] * alpha_s[m];
#pragma unroll
      for (int nn = 0; nn < kBlockN; ++nn) a = fmaf(p_s[m][nn], v_s[nn][d], a);
      acc[j] = a;
    }
  }

  if (n == 0) {
    l_s[g] = l_run[0];
    l_s[g + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = j * kThreads + tid;
    const int m = idx / DH, d = idx % DH;
    if (m0 + m < M) {
      const float l = l_s[m];
      ob[static_cast<size_t>(m0 + m) * DH + d] =
          from_float<T>(acc[j] / (l > 0.f ? l : 1.f));
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const int* tables, const int* lengths, const int* starts,
                   void* out, int B, int Hkv, int M, int r, int page,
                   int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid((M + kBlockM - 1) / kBlockM, Hkv, B);
  paged_prefill_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), tables, lengths, starts,
      static_cast<T*>(out), Hkv, M, r, page, max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* kpool,
                        const void* vpool, const int* tables,
                        const int* lengths, const int* starts, void* out,
                        int B, int Hkv, int M, int r, int page, int max_pages,
                        float scale, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, kpool, vpool, tables, lengths, starts, out, B,
                           Hkv, M, r, page, max_pages, scale, stream);
    case 96:
      return launch<T, 96>(q, kpool, vpool, tables, lengths, starts, out, B,
                           Hkv, M, r, page, max_pages, scale, stream);
    case 128:
      return launch<T, 128>(q, kpool, vpool, tables, lengths, starts, out, B,
                            Hkv, M, r, page, max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, kpool, vpool and out share it.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int paged_prefill_attention(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* lengths, const void* starts, void* out, int B, int Hkv, int M,
    int r, int dh, int page, int max_pages, float scale, int dtype,
    void* stream) {
  if (B == 0 || M == 0) return 0;
  const int* t = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, q, kpool, vpool, t, ln, st, out, B, Hkv,
                                M, r, page, max_pages, scale, s);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, q, kpool, vpool, t, ln, st, out,
                                        B, Hkv, M, r, page, max_pages, scale,
                                        s);
    default:
      return cudaErrorInvalidValue;
  }
}
