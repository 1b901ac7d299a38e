// Dense flash attention (the dense prefill's attention), written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (kernel body _flash_kernel).
// It computes the same function: for batch b and query head h, attention of
// query row q_pos over the keys k_pos of kv head h / (Hq / Hkv) with
// k_pos < kv_len, k_pos <= q_pos when causal, and q_pos - k_pos < window
// when window > 0.  Q and K rows are DQK wide and V and output rows DV
// (equal, but for MLA's 192 and 128, which the Pallas kernel does not
// take; there the reference is the plain chunked attention the MLA prefill
// calls).  Online softmax (m, l, acc) in fp32 with scale 1/sqrt(DQK); P is
// rounded to V's type before the PV product while l sums
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
// operations.  The other served shapes: hymba's 25 over 5 heads at dh 64
// with a 1024-key window (its keys per row are capped, so the intensity
// stops growing with S), deepseek-v3's MLA at 128 heads, MHA, DQK 192 and
// DV 128 (2 * (192 + 128) FLOPs per visible pair), hubert's 16 MHA heads
// at dh 80, non-causal.
//
// What this design does about it: the shared tile of
// ../../csrc/attention_tile.cuh, the one the paged kernels run.
//  - Folded GQA rows: a block owns one (batch, kv head) and a tile of
//    folded query rows, row = position * r + head-in-group, so every K/V
//    tile it loads serves all r query heads.  q and out are read and
//    written through their strides, and the tiles depend on the shapes
//    alone, so the model's BSHD view and a BHSD copy give the same bits.
//  - bf16: both products as mma.sync.m16n8k16 with fp32 accumulators, Q
//    fragments in registers, K by ldmatrix, V by ldmatrix.trans, P rounded
//    to bf16 in registers as the A operand.  fp32: the same tiles as FMAs
//    on the CUDA cores (never TF32); the dtype alone picks the path.
//  - 64-key tiles (32 in fp32) arrive by 16-byte cp.async into two stages,
//    rows padded by 16 B so ldmatrix is free of bank conflicts.
//  - A tile's key range comes from its first and last position: keys past
//    kv_len, in every row's future (causal) or behind every row's window
//    are never read; rows past kv_len + window write 0.  The heaviest
//    (last) query tiles of all (batch, kv head) launch first.
//  - DV < DQK (MLA): K and V tiles get shared rows of their own widths,
//    Q fragments hold DQK / 16 k-steps and the accumulator DV / 8 column
//    groups, so the PV product and V's loads are DV wide, not padded.  At
//    (192, 128) in bf16 a block holds 109 KB of shared memory (Q 25.6 KB,
//    two K stages 51.2, two V stages 34.8), two blocks per SM; in fp32
//    140 KB, one.

#include "attention_tile.cuh"

namespace {

using namespace attention_tile;

constexpr int kWarps = 4;     // 64 folded query rows per block

// element strides of the (B, H, S) axes of q, k, v and out; the head dim
// contiguous in all four
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

struct Args {
  const void* q;                // (B, Hq, Sq, DQK) by st.q
  const void* k;                // (B, Hkv, Sk, DQK) by st.k
  const void* v;                // (B, Hkv, Sk, DV) by st.v
  void* out;                    // (B, Hq, Sq, DV) by st.o
  float* lse;                   // (B, Hq, Sq) contiguous, or null
  Strides st;
  int Hq, Sq;
  int r, M, kv_len, causal, window;
  float scale_log2;             // log2(e) / sqrt(DQK)
};

// Batch b, kv head hk: folded row j is query head hk * r + j % r at
// position j / r.
template <typename T>
struct DenseBlock {
  static constexpr bool kLower = true;
  static constexpr bool kSplits = false;
  static constexpr bool kLse = true;
  int M, r, kv_len, causal, window;
  const T* qb;
  const T* kb;
  const T* vb;
  T* ob;
  float* lse;                   // (b, head hk * r, position 0), or null
  long long sq_pos, sq_head, sk, sv, so_pos, so_head;
  int Sq;
  float scale_log2;

  __device__ __forceinline__ DenseBlock(const Args& a, int b, int hk)
      : M(a.M), r(a.r), kv_len(a.kv_len), causal(a.causal),
        window(a.window),
        qb(static_cast<const T*>(a.q) + b * a.st.q[0] +
           static_cast<long long>(hk) * a.r * a.st.q[1]),
        kb(static_cast<const T*>(a.k) + b * a.st.k[0] + hk * a.st.k[1]),
        vb(static_cast<const T*>(a.v) + b * a.st.v[0] + hk * a.st.v[1]),
        ob(static_cast<T*>(a.out) + b * a.st.o[0] +
           static_cast<long long>(hk) * a.r * a.st.o[1]),
        lse(a.lse == nullptr
                ? nullptr
                : a.lse + (static_cast<long long>(b) * a.Hq +
                           static_cast<long long>(hk) * a.r) * a.Sq),
        sq_pos(a.st.q[2]), sq_head(a.st.q[1]), sk(a.st.k[2]),
        sv(a.st.v[2]), so_pos(a.st.o[2]), so_head(a.st.o[1]), Sq(a.Sq),
        scale_log2(a.scale_log2) {}

  __device__ __forceinline__ int key_begin(int j) const {
    return window > 0 ? j / r - window + 1 : 0;
  }
  __device__ __forceinline__ int key_end(int j) const {
    return causal ? min(kv_len, j / r + 1) : kv_len;
  }
  __device__ __forceinline__ const T* q_row(int j) const {
    return qb + (j / r) * sq_pos + (j % r) * sq_head;
  }
  __device__ __forceinline__ size_t kv_row(int key) const { return key; }
  __device__ __forceinline__ const T* k_row(size_t i) const {
    return kb + static_cast<long long>(i) * sk;
  }
  __device__ __forceinline__ const T* v_row(size_t i) const {
    return vb + static_cast<long long>(i) * sv;
  }
  __device__ __forceinline__ T* out_row(int j) const {
    return ob + (j / r) * so_pos + (j % r) * so_head;
  }
  __device__ __forceinline__ float* lse_row(int j) const {
    return lse + static_cast<long long>(j % r) * Sq + j / r;
  }
};

// Grid (Hkv, B, query tiles): blocks are dispatched x fastest, so the
// last (heaviest, under a causal mask) query tile of every (batch, kv
// head) launches first.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseBlock<T> blk(a, blockIdx.y, blockIdx.x);
  attend_tile<T, DQK, DV, kWarps>(
      blk, static_cast<int>(gridDim.z - 1 - blockIdx.z), 0, smem);
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  using L = Layout<T, DQK, DV, kWarps>;
  auto* kernel = flash_kernel<T, DQK, DV>;
  static bool configured = false;  // once per instance: above 48 KB of
  if (!configured) {               // shared memory only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qt = (a.M + L::kM - 1) / L::kM;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(Hkv, B, n_qt), kWarps * 32, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// the (DQK, DV) pairs of ops.HEAD_DIMS
template <typename T>
cudaError_t dispatch_dh(int dqk, int dv, const Args& a, int B, int Hkv,
                        cudaStream_t stream) {
  if (dqk == 192 && dv == 128) return launch<T, 192, 128>(a, B, Hkv, stream);
  if (dqk != dv) return cudaErrorInvalidValue;
  switch (dqk) {
    case 64:
      return launch<T, 64, 64>(a, B, Hkv, stream);
    case 80:
      return launch<T, 80, 80>(a, B, Hkv, stream);
    case 96:
      return launch<T, 96, 96>(a, B, Hkv, stream);
    case 128:
      return launch<T, 128, 128>(a, B, Hkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (tensor cores).  q, k,
// v and out share it.  lse: null, or a contiguous fp32 (B, Hq, Sq) array
// that gets each row's log-sum-exp (natural log, of the scaled masked
// scores; -inf where a row sees no key), which the backward reads.
// strides: host array of 12 element strides, the (B, H, S) axes of q, k,
// v, out.  dh: q's and k's head dim; dv: v's and out's.  Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse,
                               const long long* strides, int B,
                               int Hq, int Hkv, int Sq, int Sk, int dh,
                               int dv, int causal, int window, float scale,
                               int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      static_cast<long long>(Sq) * (Hq / Hkv) > (1LL << 30))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  a.Hq = Hq;
  a.Sq = Sq;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  a.r = Hq / Hkv;
  a.M = Sq * a.r;
  a.kv_len = Sk;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, dv, a, B, Hkv, s);
    case 1:
      return dispatch_dh<bf16>(dh, dv, a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}
