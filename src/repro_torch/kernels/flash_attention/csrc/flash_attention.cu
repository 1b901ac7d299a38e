// Dense flash attention (the dense prefill's attention and the training
// forward's), written for Hopper (sm_90a).
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
// at dh 80, non-causal; training's 16 MHA heads at dh 64, S 4096.
//
// bf16, what this design does about it (the step the backward took, in
// flash_attention_bwd.cu, on the same header ../../csrc/hopper.cuh):
//  - Warp-specialised blocks.  A producer warpgroup (one thread issues; its
//    registers go to the consumers by setmaxnreg) keeps TMA loads of K and
//    V tiles in a ring of 3-4 stages (as many as shared memory holds), a
//    full/empty mbarrier pair each.  Two or three consumer warpgroups (by
//    head dim, Fwd::NWG) each own 64 query positions and run both products
//    as wgmma with fp32 accumulators in registers; they do no address
//    arithmetic, global loads or block-wide barriers in the loop.
//  - Per query head, not folded rows: a block owns 64 positions a group
//    of one (batch, query head), its Q one TMA box per 64-column chunk,
//    loaded once.  (Folded rows, position * r + head, would need boxes of r heads
//    by 64 / r positions, which r = 5 does not divide; per-head tiles also
//    put the causal diagonal through tile corners, one masked tile in a
//    row of tiles.)  Q, K and V are boxes of 4-D tensor maps (d, S, H, B)
//    made from the tensors' own strides, so the model's BSHD views are read
//    in place and a BSHD and a BHSD copy give the same bits.
//  - GQA and order: a 1-D grid over groups of (batch, query head) pairs,
//    a group as many (batch, kv head)s' r query heads as keep their K and
//    V within 24 MB of L2 (all of a 1024-token prefill's; 24 of
//    training's 128 at S 4096).  Within a group the position blocks run
//    heaviest (causal: last) first and the group's heads fastest, so the
//    blocks in flight share their K and V in L2 and the longest start
//    first, which shortens the tail when a launch is a few waves.
//  - S = Q K^T: wgmma with A (Q) and B (K) both K-major in TMA's 128-byte
//    swizzle, 64 keys a tile (m64n64k16), 128 at dh 64 (m64n128k16), where
//    the accumulators leave room.  dh 80 and 96 read a second 64-column box
//    that TMA fills with zeros past dh; S's k-steps stop at dh (5 and 6 of
//    8), O's product runs 128 wide on the zeros.
//  - P = exp2(S scale_log2 - m) in fp32 (log2 units), l summed unrounded
//    per thread and reduced over the quad once at the end; O is rescaled
//    only when a row's maximum moved.  P is rounded to bf16 into a swizzled
//    box of the group's own and read back as the A operand of O += P V
//    (m64n128k16 at dv > 64, V MN-major over two 64-column atoms): on this
//    card the backward found a product with A in registers ~4x slower.
//  - Each (64 positions, key tile) is classed from positions alone:
//    interior (every pair visible: no mask code), masked (the diagonal, a
//    window edge, the ragged end past Sq or Sk, Sq > Sk; -inf at hidden
//    pairs), or skipped (no visible pair).  The block's key range is the
//    union of its groups' (tiles outside it are never loaded); a group
//    computes the tiles between its own first and last key, all masked or
//    interior, and releases the walk's others, which its neighbour needs.
//  - Overlap inside a group: it issues S of tile j + 1 and PV of tile j
//    together, waits for S only, and runs tile j + 1's softmax while the
//    tensor cores run PV j; then it waits for PV j, rescales O and
//    releases j's stage.  P has two buffers a group for that; the two
//    groups' softmaxes also fill each other's gaps.
//  - Each row's log-sum-exp (natural log; -inf where a row sees no key)
//    when asked, for the backward.
//
// fp32 keeps the CUDA-core design over the shared tile of
// ../../csrc/attention_tile.cuh (the paged kernels' tile): folded GQA rows
// (row = position * r + head-in-group, so every K/V tile serves the r
// heads), 32-key tiles by 16-byte cp.async into two stages, both products
// as FMAs (never TF32); the tiles depend on the shapes alone.  At (192,
// 128) a block holds 140 KB of shared memory, one a SM.

#include <math.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

using mma_tiles::bf16;

// ================================================= fp32: the shared tile
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
  int Hq, Hkv, Sq;
  int r, M, kv_len, causal, window;
  float scale_log2;             // log2(e) / sqrt(DQK)
};

// Batch b, kv head hk: folded row j is query head hk * r + j % r at
// position j / r.
struct DenseBlock {
  static constexpr bool kLower = true;
  static constexpr bool kSplits = false;
  static constexpr bool kLse = true;
  int M, r, kv_len, causal, window;
  const float* qb;
  const float* kb;
  const float* vb;
  float* ob;
  float* lse;                   // (b, head hk * r, position 0), or null
  long long sq_pos, sq_head, sk, sv, so_pos, so_head;
  int Sq;
  float scale_log2;

  __device__ __forceinline__ DenseBlock(const Args& a, int b, int hk)
      : M(a.M), r(a.r), kv_len(a.kv_len), causal(a.causal),
        window(a.window),
        qb(static_cast<const float*>(a.q) + b * a.st.q[0] +
           static_cast<long long>(hk) * a.r * a.st.q[1]),
        kb(static_cast<const float*>(a.k) + b * a.st.k[0] + hk * a.st.k[1]),
        vb(static_cast<const float*>(a.v) + b * a.st.v[0] + hk * a.st.v[1]),
        ob(static_cast<float*>(a.out) + b * a.st.o[0] +
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
  __device__ __forceinline__ const float* q_row(int j) const {
    return qb + (j / r) * sq_pos + (j % r) * sq_head;
  }
  __device__ __forceinline__ size_t kv_row(int key) const { return key; }
  __device__ __forceinline__ const float* k_row(size_t i) const {
    return kb + static_cast<long long>(i) * sk;
  }
  __device__ __forceinline__ const float* v_row(size_t i) const {
    return vb + static_cast<long long>(i) * sv;
  }
  __device__ __forceinline__ float* out_row(int j) const {
    return ob + (j / r) * so_pos + (j % r) * so_head;
  }
  __device__ __forceinline__ float* lse_row(int j) const {
    return lse + static_cast<long long>(j % r) * Sq + j / r;
  }
};

// Grid (Hkv, B, query tiles): blocks are dispatched x fastest, so the
// last (heaviest, under a causal mask) query tile of every (batch, kv
// head) launches first.
template <int DQK, int DV>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseBlock blk(a, blockIdx.y, blockIdx.x);
  attention_tile::attend_tile<float, DQK, DV, kWarps>(
      blk, static_cast<int>(gridDim.z - 1 - blockIdx.z), 0, smem);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;          // above 48 KB of shared
  const cudaError_t err = cudaFuncSetAttribute(  // memory only when asked
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DQK, int DV>
cudaError_t launch_fp32(const Args& a, int B, cudaStream_t stream) {
  using L = attention_tile::Layout<float, DQK, DV, kWarps>;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_kernel<DQK, DV>, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.M + L::kM - 1) / L::kM;
  if (n_qt > 65535 || a.Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  flash_kernel<DQK, DV>
      <<<dim3(a.Hkv, B, n_qt), kWarps * 32, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// ===================================== bf16: wgmma fed by TMA, per head
using namespace hopper;

constexpr int kRows = 64;               // positions of a consumer group
constexpr int kBoxRow = 128;            // bytes of a box row: 64 columns
constexpr int kBoxA = kRows * kBoxRow;  // a 64 x 64 bf16 box

// The block: the producer warpgroup, then NWG consumer warpgroups, one
// block an SM.  The launch bounds start every thread at kEntry registers;
// setmaxnreg leaves the producer 24 and gives the rest to the consumers
// (two groups: 24 x 128 + 240 x 256 = 168 x 384; three: 24 x 128 + 160 x
// 384 <= 128 x 512).  ptxas still compiles the consumers near the entry
// count, so a consumer's accumulators (O and S) are planned to fit it.
template <int NWG>
struct Block {
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kEntry = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kEntry * kThreads - kProducerRegs * 128) / (128 * NWG) / 8 * 8;
};

// The bf16 forward's tiles and shared memory at (DQK, DV).
template <int DQK, int DV>
struct Fwd {
  // consumer groups: three at dh 64 and 128, where 128 registers a thread
  // hold O and S and a third group ran faster on the card; two at dh 80
  // and 96, which ran slower with three, and at (192, 128), where three
  // leave the ring two stages and ran slower
  static constexpr int NWG = DQK == 64 || DQK == 128 ? 3 : 2;
  // keys a tile: S takes KN / 2 registers a thread beside O's NV / 2
  // (dh 64: 64 + 32; above: 32 + 64)
  static constexpr int KN = DQK == 64 ? 128 : 64;
  static constexpr int KQ = (DQK + 63) / 64;         // chunks of Q, K
  static constexpr int KV = (DV + 63) / 64;          // of V, O
  static constexpr int NV = 64 * KV;                 // O's product width
  static constexpr int KP = KN / 64;                 // boxes of one P
  static constexpr int kPos = NWG * kRows;           // positions a block owns
  static constexpr int kQBox = kPos * kBoxRow;       // a Q chunk
  static constexpr int kKeyBox = KN * kBoxRow;       // a K or V chunk
  static constexpr int kStage = (KQ + KV) * kKeyBox;
  static constexpr int kQ = 0;                       // KQ chunks
  static constexpr int kP = kQ + KQ * kQBox;         // NWG x 2 P, KP boxes
  static constexpr int kK = kP + NWG * 2 * KP * kBoxA;
  // ring stages: as many as the rest of a block's 232,448 B holds, up to 4
  static constexpr int kRoom = 232448 - 1024 - 128 - kK;
  static constexpr int ST = kRoom / kStage < 4 ? kRoom / kStage : 4;
  static constexpr int kV = kK + ST * KQ * kKeyBox;  // ST x KQ K, ST x KV V
  static constexpr int kBar = kV + ST * KV * kKeyBox;
  // bytes: (64, 64) Q 24,576 + P 98,304 + 3 stages of 32,768; (80, 80),
  // (96, 96) 32,768 + 32,768 + 4 of 32,768; (128, 128) 49,152 + 49,152 +
  // 4 of 32,768; (192, 128) 49,152 + 32,768 + 3 of 40,960; each +
  // barriers and alignment
  static constexpr int kBytes = kBar + (2 * ST + 1) * 8 + 1024;
  static_assert(ST >= 2 && kBytes <= 232448, "over a block's shared memory");
};

struct FArgs {
  bf16* out;                    // (B, Hq, Sq, DV) by so
  float* lse;                   // (B, Hq, Sq) contiguous, or null
  long long so[3];
  int Hq, r, Sq, Sk, causal, window;
  int heads;                    // (batch, head) pairs of one launch group
  float scale_log2;             // log2(e) / sqrt(DQK)
};

// The offsets q_pos - k_pos a row sees: [dmin, dmax]
struct Band {
  int dmin, dmax;
};
__device__ __forceinline__ Band band(const FArgs& a) {
  return {a.causal ? 0 : -(1 << 30), a.window > 0 ? a.window - 1 : 1 << 30};
}

enum TileClass { kSkip = 0, kMasked = 1, kInterior = 2 };

// The class of the tile of positions [q0, q0 + 64) by keys [k0, k0 + nk)
__device__ __forceinline__ int tile_class(const FArgs& a, const Band& w,
                                          int q0, int k0, int nk) {
  const int qb = min(q0 + kRows, a.Sq) - 1, kb = min(k0 + nk, a.Sk) - 1;
  if (qb < q0 || kb < k0) return kSkip;
  const int lo = q0 - kb, hi = qb - k0;     // q_pos - k_pos over the tile
  if (hi < w.dmin || lo > w.dmax) return kSkip;
  const bool full = q0 + kRows <= a.Sq && k0 + nk <= a.Sk;
  return full && lo >= w.dmin && hi <= w.dmax ? kInterior : kMasked;
}
// Whether position q sees key k (no branches: it runs per element)
__device__ __forceinline__ bool visible(const FArgs& a, const Band& w, int q,
                                        int k) {
  return (q < a.Sq) & (k < a.Sk) & (q - k >= w.dmin) & (q - k <= w.dmax);
}
// The keys positions [p0, p1) see: [lo, hi), empty when hi <= lo
__device__ __forceinline__ int2 key_span(const FArgs& a, int p0, int p1) {
  p1 = min(p1, a.Sq);
  return make_int2(a.window > 0 ? max(0, p0 - a.window + 1) : 0,
                   p1 <= p0 ? 0 : a.causal ? min(a.Sk, p1) : a.Sk);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The warpgroup's 64 x 64 accumulator d rounded to bf16 into a
// 1024-aligned box of 128-byte rows in TMA's 128-byte swizzle: a K-major
// A operand (conflict-free 4-byte stores).
__device__ __forceinline__ void store_a(unsigned char* box,
                                        const float* d) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + g;   // row & 7 == g
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(box + (row + 8 * i) * kBoxRow +
                                   ((j ^ g) << 4) + 4 * t) =
          mma_tiles::pack_bf16(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
}

// One arrival of the calling warp on a stage's empty barrier
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// A 1-D grid over (batch, head) groups of a.heads pairs: within a group
// position blocks run heaviest (causal: last) first, the group's heads
// fastest, so the blocks that run together share the group's K and V in
// L2 and the longest start first.
template <int DQK, int DV, int NWG>
__global__ void __launch_bounds__(Block<NWG>::kThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const FArgs a) {
  using L = Fwd<DQK, DV>;
  constexpr int KN = L::KN, KQ = L::KQ, KV = L::KV, KP = L::KP, ST = L::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* q_full = empty + ST;

  const int n_pb = (a.Sq + L::kPos - 1) / L::kPos;
  const int per_group = a.heads * n_pb;
  const int grp = blockIdx.x / per_group, i = blockIdx.x % per_group;
  const int g_heads = min(a.heads, static_cast<int>(gridDim.x) / n_pb -
                                       grp * a.heads);
  const int bh = grp * a.heads + i % g_heads;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.r;
  const int m0 = (n_pb - 1 - i / g_heads) * L::kPos;
  // the block's keys, [kbeg, kend), in key tiles from kt_lo
  const int2 span = key_span(a, m0, m0 + L::kPos);
  const int kt_lo = span.x / KN;
  const int n_tiles = span.y > span.x ? (span.y + KN - 1) / KN - kt_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);           // every consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                     // producer
    regs_dec<Block<NWG>::kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, KQ * L::kQBox);
      for (int c = 0; c < KQ; ++c)
        tma_load_4d(sm + L::kQ + c * L::kQBox, &tq, q_full, 64 * c, m0, h,
                    b);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int k0 = (kt_lo + it) * KN;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], L::kStage);
        for (int c = 0; c < KQ; ++c)
          tma_load_4d(sm + L::kK + (stage * KQ + c) * L::kKeyBox, &tk,
                      &full[stage], 64 * c, k0, hk, b);
        for (int c = 0; c < KV; ++c)
          tma_load_4d(sm + L::kV + (stage * KV + c) * L::kKeyBox, &tv,
                      &full[stage], 64 * c, k0, hk, b);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {                                     // consumers
    regs_inc<Block<NWG>::kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, t = threadIdx.x % 4;
    const int p0 = m0 + wg * kRows;            // this group's positions
    const int row0 = p0 + 16 * warp + (threadIdx.x % 32) / 4,
              row1 = row0 + 8;
    const Band w = band(a);
    // the walk's tiles this group computes, [c_lo, c_hi): every tile
    // between its first and last key is masked or interior, the walk's
    // others skipped
    const int2 own = key_span(a, p0, p0 + kRows);
    const int c_lo = own.y > own.x ? own.x / KN - kt_lo : 0;
    const int c_hi = own.y > own.x ? (own.y + KN - 1) / KN - kt_lo : 0;
    // descriptors: base + byte offset / 16; V's with its two 64-column
    // atoms a key box apart
    const uint32_t d0 = desc_lo(smem_u32(sm));
    const uint32_t dv0 = desc_lo(smem_u32(sm), L::kKeyBox);
    const uint32_t dqs = d0 + (L::kQ + wg * kBoxA) / 16;
    unsigned char* pbox = sm + L::kP + wg * 2 * KP * kBoxA;
    const uint32_t dps = d0 + (L::kP + wg * 2 * KP * kBoxA) / 16;
    float o[L::NV / 2], s[KN / 2];
#pragma unroll
    for (int i = 0; i < L::NV / 2; ++i) o[i] = 0.f;
    // rows row0 and row1: running maximum of the scaled scores (log2
    // units) and this thread's share of the sum of P
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    };
    // S = Q K^T (positions x keys) of the tile in `stage`, B K-major,
    // k-steps up to DQK; committed, not waited for
    auto issue_s = [&]() {
      const uint32_t dks = d0 + (L::kK + stage * KQ * L::kKeyBox) / 16;
#pragma unroll
      for (int c = 0; c < KQ; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (64 * c + 16 * kk < DQK)
            wgmma_ss<0>(s, dqs + (c * L::kQBox + 32 * kk) / 16,
                        dks + (c * L::kKeyBox + 32 * kk) / 16, c + kk);
      wgmma_commit();
    };
    // The online softmax of walk tile j's S: P = exp2(S scale_log2 - m)
    // into the group's P buffer pb (bf16, published by the caller), the
    // running maxima and sums updated; returns the factors (al0, al1) O's
    // rows must be scaled by before the tile's PV
    auto softmax = [&](int j, int pb) {
      const int k0 = (kt_lo + j) * KN;
      // -inf at the pairs the mask hides, only if the tile holds one
      if (tile_class(a, w, p0, k0, KN) == kMasked)
#pragma unroll
        for (int idx = 0; idx < KN / 2; ++idx)
          if (!visible(a, w, idx & 2 ? row1 : row0,
                       k0 + 8 * (idx / 4) + 2 * t + idx % 2))
            s[idx] = -INFINITY;
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int idx = 0; idx < KN / 2; ++idx) {
        if (idx & 2)
          t1 = fmaxf(t1, s[idx]);
        else
          t0 = fmaxf(t0, s[idx]);
      }
      t0 = fmaxf(mx0, mma_tiles::quad_max(t0) * a.scale_log2);
      t1 = fmaxf(mx1, mma_tiles::quad_max(t1) * a.scale_log2);
      // a row that has seen no key yet subtracts 0: its P is exp2(-inf)
      const float b0 = t0 == -INFINITY ? 0.f : t0;
      const float b1 = t1 == -INFINITY ? 0.f : t1;
      const float2 al = make_float2(mma_tiles::ex2(mx0 - b0),
                                    mma_tiles::ex2(mx1 - b1));
      mx0 = t0;
      mx1 = t1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int idx = 0; idx < KN / 2; ++idx) {
        s[idx] =
            mma_tiles::ex2(fmaf(s[idx], a.scale_log2, idx & 2 ? -b1 : -b0));
        if (idx & 2)
          r1 += s[idx];
        else
          r0 += s[idx];
      }
      l0 = fmaf(l0, al.x, r0);
      l1 = fmaf(l1, al.y, r1);
#pragma unroll
      for (int c = 0; c < KP; ++c)
        store_a(pbox + (pb * KP + c) * kBoxA, s + 32 * c);
      return al;
    };
    auto publish = [&]() {                    // P stored by the group's
      fence_proxy_async();                    // four warps, for wgmma
      bar_sync(1 + wg, 128);
    };
    auto skip = [&]() {
      mbar_wait(&full[stage], phase);
      release(&empty[stage]);
      advance();
    };

    // O += P V of walk tile j from the ring's stage st (P in buffer j & 1),
    // committed, not waited for
    auto issue_pv = [&](int st, int j) {
      const uint32_t dvs = dv0 + (L::kV + st * KV * L::kKeyBox) / 16;
      const uint32_t dp = dps + (j & 1) * KP * kBoxA / 16;
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_ss<1>(o, dp + ((kk / 4) * kBoxA + (kk % 4) * 32) / 16,
                    dvs + kk * 2048 / 16, 1);
      wgmma_commit();
    };

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < c_lo; ++j) skip();
    if (c_hi > c_lo) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      issue_s();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(c_lo, 0);                        // O is 0: nothing to scale
      publish();
      int cur = stage;                         // the stage PV reads
      advance();
      // tile j's PV runs while tile j + 1's S and softmax do; no wgmma is
      // issued under a branch (ptxas would serialise them)
      for (int j = c_lo; j + 1 < c_hi; ++j) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        issue_s();
        issue_pv(cur, j - c_lo);
        wgmma_wait<1>();                       // S of tile j + 1
        fence_regs(s);
        const float2 al = softmax(j + 1, (j + 1 - c_lo) & 1);
        wgmma_wait<0>();                       // PV of tile j
        fence_regs(o);
        release(&empty[cur]);
        if (__any_sync(0xffffffffu, al.x != 1.f || al.y != 1.f))
#pragma unroll
          for (int idx = 0; idx < L::NV / 2; ++idx)
            o[idx] *= idx & 2 ? al.y : al.x;
        publish();
        cur = stage;
        advance();
      }
      wgmma_fence();
      issue_pv(cur, c_hi - 1 - c_lo);
      wgmma_wait<0>();
      fence_regs(o);
      release(&empty[cur]);
    }
    for (int j = max(c_hi, c_lo); j < n_tiles; ++j) skip();

    l0 = mma_tiles::quad_sum(l0);
    l1 = mma_tiles::quad_sum(l1);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* ob = a.out + b * a.so[0] + h * a.so[1];
    bf16* r0p = row0 < a.Sq ? ob + row0 * a.so[2] : nullptr;
    bf16* r1p = row1 < a.Sq ? ob + row1 * a.so[2] : nullptr;
#pragma unroll
    for (int j = 0; j < L::NV / 8; ++j) {
      if (8 * j >= DV) continue;
      const int d = 8 * j + 2 * t;
      if (r0p)
        *reinterpret_cast<__nv_bfloat162*>(r0p + d) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1p)
        *reinterpret_cast<__nv_bfloat162*>(r1p + d) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (a.lse != nullptr && t == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lb = a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Sq;
      if (row0 < a.Sq)
        lb[row0] = l0 > 0.f ? (mx0 + log2f(l0)) * kLn2 : -INFINITY;
      if (row1 < a.Sq)
        lb[row1] = l1 > 0.f ? (mx1 + log2f(l1)) * kLn2 : -INFINITY;
    }
  }
}

// The three tensor maps (Sk == 0: K's and V's never read, made over q)
// and the launch; the maps are encoded on every call.  A launch group
// holds as many (batch, kv head)s' query heads as keep their K and V
// within 24 MB of the 50 MB L2.
template <int DQK, int DV>
cudaError_t launch_bf16(const Args& a, FArgs fa, int B,
                        cudaStream_t stream) {
  using L = Fwd<DQK, DV>;
  constexpr int NWG = L::NWG;
  const long long blocks = static_cast<long long>(B) * a.Hq *
                           ((a.Sq + L::kPos - 1) / L::kPos);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long kv_bytes =
      static_cast<long long>(a.kv_len > 0 ? a.kv_len : 1) * (DQK + DV) * 2;
  fa.heads = static_cast<int>(
      min(static_cast<long long>(B) * a.Hq,
          max(1LL, (24LL << 20) / kv_bytes) * a.r));
  const bool keys = a.kv_len > 0;
  CUtensorMap mq, mk, mv;
  if (!bf16_map(&mq, a.q, B, a.Hq, a.Sq, DQK, a.st.q, L::kPos) ||
      !bf16_map(&mk, keys ? a.k : a.q, B, keys ? a.Hkv : a.Hq,
                keys ? a.kv_len : a.Sq, DQK, keys ? a.st.k : a.st.q, L::KN) ||
      !bf16_map(&mv, keys ? a.v : a.q, B, keys ? a.Hkv : a.Hq,
                keys ? a.kv_len : a.Sq, keys ? DV : DQK,
                keys ? a.st.v : a.st.q, L::KN))
    return cudaErrorInvalidValue;
  auto kernel = fwd_wgmma<DQK, DV, NWG>;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), Block<NWG>::kThreads, L::kBytes,
           stream>>>(mq, mk, mv, fa);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(int dtype, const Args& a, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_fp32<DQK, DV>(a, B, stream);
  FArgs fa;
  fa.out = static_cast<bf16*>(a.out);
  fa.lse = a.lse;
  for (int i = 0; i < 3; ++i) fa.so[i] = a.st.o[i];
  fa.Hq = a.Hq;
  fa.r = a.r;
  fa.Sq = a.Sq;
  fa.Sk = a.kv_len;
  fa.causal = a.causal;
  fa.window = a.window;
  fa.scale_log2 = a.scale_log2;
  return launch_bf16<DQK, DV>(a, fa, B, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (wgmma fed by TMA).
// q, k, v and out share it; bf16 bases and strides on 16 bytes (TMA).
// lse: null, or a contiguous fp32 (B, Hq, Sq) array that gets each row's
// log-sum-exp (natural log, of the scaled masked scores; -inf where a row
// sees no key), which the backward reads.  strides: host array of 12
// element strides, the (B, H, S) axes of q, k, v, out.  dh: q's and k's
// head dim; dv: v's and out's.  Returns the launch's cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for what the kernel does not take,
// a grid past its limits or a tensor map the driver refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse,
                               const long long* strides, int B,
                               int Hq, int Hkv, int Sq, int Sk, int dh,
                               int dv, int causal, int window, float scale,
                               int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(Sq) * (Hq / Hkv) > (1LL << 30))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  a.Hq = Hq;
  a.Hkv = Hkv;
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
  // the (DQK, DV) pairs of ops.HEAD_DIMS
  if (dh == 192 && dv == 128) return launch<192, 128>(dtype, a, B, s);
  if (dh != dv) return cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return launch<64, 64>(dtype, a, B, s);
    case 80:
      return launch<80, 80>(dtype, a, B, s);
    case 96:
      return launch<96, 96>(dtype, a, B, s);
    case 128:
      return launch<128, 128>(dtype, a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}
