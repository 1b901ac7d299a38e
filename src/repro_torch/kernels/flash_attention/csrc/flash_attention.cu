// Dense flash attention (the dense prefill's attention), written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (kernel body _flash_kernel).
// It computes the same function: for batch b and query head h, attention of
// query row q_pos over the keys k_pos of kv head h / (Hq / Hkv) with
// k_pos < kv_len, k_pos <= q_pos when causal, and q_pos - k_pos < window
// when window > 0.  Online softmax (m, l, acc) in fp32 with scale
// 1/sqrt(dh); P is rounded to V's type before the PV product while l sums
// it unrounded; probabilities are multiplied by the mask, so a row that
// has seen no key stays exact and rows with l == 0 write 0.  Whole key
// tiles that no row of a query tile can see are never read, as pl.when
// skips the TPU's masked blocks.
//
// What bounds it on the H100.  At qwen3-14b's prefill (40 query heads over
// 8 kv heads, dh 128, S up to 1024, bf16) the work is 4 * dh FLOPs per
// (query row, visible key), about 10.7 GFLOP at S = 1024, against 25 MB of
// q, K, V and output: about 430 FLOP per byte, above the H100's ~295 where
// the tensor cores rather than HBM become the limit.  So the bound is the
// operations.
//
// What this first design does about it.  The products run as fp32 FMAs on
// the CUDA cores (fp32 inputs never go through TF32), register-tiled so a
// thread does 16 FMAs per pair of shared-memory loads: one block of 128
// threads per (query head, batch, 64-query tile); the q tile is staged once
// in shared memory (widened to fp32), then a loop over 32-key tiles from
// the first key any row of the tile can see (window) to the last one
// (causal, kv_len).  Each thread owns 4 query rows: in the score phase 4
// keys of each (a 4 x 4 block of S), in the PV phase DH / 8 output columns
// of each, so the row statistics stay in its registers; the 8 threads of a
// row group reduce the row max and sum with shuffles, and P passes through
// shared memory transposed.  Heaviest (last) query tiles are launched
// first.  The r query heads of one kv head re-read its K/V tiles, mostly
// from L2.  Tensor cores (wgmma), TMA pipelining and one block per kv head
// serving its r query heads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 32;   // keys per tile
constexpr int kRows = 4;      // query rows per thread
constexpr int kKeys = 4;      // keys per thread in the score phase
constexpr float kNegInf = -1e30f;

static_assert(kBlockM == kRows * (kThreads / 8), "row groups");
static_assert(kBlockN == kKeys * 8, "key groups");

// element strides of the (B, H, S) axes of q, k, v and out; dh is
// contiguous in all four
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

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

// four consecutive outputs (16 bytes of fp32, 8 of bf16; aligned)
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

template <int DH>
constexpr size_t smem_bytes() {
  // q tile and k tile with rows padded by 4 floats, v tile, P transposed
  return sizeof(float) * (kBlockM * (DH + 4) + kBlockN * (DH + 4)
                          + kBlockN * DH + kBlockN * (kBlockM + 4));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,     // (B, Hq, Sq, DH) by st.q
             const T* __restrict__ k,     // (B, Hkv, Sk, DH) by st.k
             const T* __restrict__ v,     // (B, Hkv, Sk, DH) by st.v
             T* __restrict__ out,         // (B, Hq, Sq, DH) by st.o
             Strides st, int Sq, int group, int nq, int causal, int window,
             int kv_len, float scale) {
  static_assert(DH % 32 == 0 && DH % Vec16<T>::N == 0, "head dim");
  // +4 floats per row keeps float4 alignment and puts the 8 rows one
  // quarter-warp reads on distinct bank groups
  constexpr int kQS = DH + 4;
  constexpr int kPS = kBlockM + 4;
  constexpr int kVec = Vec16<T>::N;
  constexpr int kChunks = DH / kVec;      // 16-byte loads per row
  constexpr int kCols = DH / 32;          // float4 column groups per thread

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kBlockM][kQS]
  float* k_s = q_s + kBlockM * kQS;       // [kBlockN][kQS]
  float* v_s = k_s + kBlockN * kQS;       // [kBlockN][DH]
  float* p_s = v_s + kBlockN * DH;        // [kBlockN][kPS]: P transposed

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kBlockM;
  const int hk = h / group;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];

  // keys any row of this tile can see: [kbeg, kend)
  const int q_last = min(q0 + kBlockM, Sq) - 1;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kend = causal ? min(kv_len, q_last + 1) : kv_len;

  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int m = c / kChunks, d = (c % kChunks) * kVec;
    float* dst = q_s + m * kQS + d;
    if (q0 + m < Sq)
      load_widen(qb + (q0 + m) * st.q[2] + d, dst);
    else
      zero_fill(dst, kVec);
  }

  // thread (rg, cg): query rows r0 .. r0 + 3; score keys cg + 8 j; output
  // columns cg * 4 + 32 c + e
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int r0 = rg * kRows;
  float m_run[kRows], l_run[kRows], acc[kRows][kCols * 4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols * 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // q_s written / previous tile's k_s, v_s, p_s read
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int j = c / kChunks, d = (c % kChunks) * kVec;
      const int key = k0 + j;
      if (key < kend) {
        load_widen(kb + key * st.k[2] + d, k_s + j * kQS + d);
        load_widen(vb + key * st.v[2] + d, v_s + j * DH + d);
      } else {
        zero_fill(k_s + j * kQS + d, kVec);
        zero_fill(v_s + j * DH + d, kVec);
      }
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[kRows], ka[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * kQS + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        ka[j] = *reinterpret_cast<const float4*>(k_s + (cg + 8 * j) * kQS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    float pr[kRows][kKeys];   // P rounded to V's type
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + r0 + i;
      bool ok[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + cg + 8 * j;
        ok[j] = key < kv_len && (!causal || key <= q_pos) &&
                (window <= 0 || q_pos - key < window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_cur) : 0.f;
        ps += p;
        pr[i][j] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[i] = alpha * l_run[i] + ps;
      m_run[i] = m_cur;
#pragma unroll
      for (int c = 0; c < kCols * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(p_s + (cg + 8 * j) * kPS + r0) =
          make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + n * kPS + r0);
      const float pn[kRows] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(v_s + n * DH + cg * 4 + 32 * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][4 * c + 0] = fmaf(pn[i], v4.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pn[i], v4.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pn[i], v4.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pn[i], v4.w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float l = l_run[i] > 0.f ? l_run[i] : 1.f;
    T* orow = ob + row * st.o[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store4(orow + cg * 4 + 32 * c, acc[i][4 * c] / l, acc[i][4 * c + 1] / l,
             acc[i][4 * c + 2] / l, acc[i][4 * c + 3] / l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides& st, int B, int Hq, int Hkv, int Sq, int Sk,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int nq = (Sq + kBlockM - 1) / kBlockM;
  const dim3 grid(Hq, B, nq);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st, Sq, Hq / Hkv, nq,
      causal, window, Sk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v,
                        void* out, const Strides& st, int B, int Hq, int Hkv,
                        int Sq, int Sk, int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, st, B, Hq, Hkv, Sq, Sk, causal,
                           window, scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, st, B, Hq, Hkv, Sq, Sk, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, st, B, Hq, Hkv, Sq, Sk, causal,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v and out share it.  strides:
// host array of 12 element strides, the (B, H, S) axes of q, k, v, out.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B,
                               int Hq, int Hkv, int Sq, int Sk, int dh,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, q, k, v, out, st, B, Hq, Hkv, Sq, Sk,
                                causal, window, scale, s);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, out, st, B, Hq, Hkv, Sq,
                                        Sk, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
