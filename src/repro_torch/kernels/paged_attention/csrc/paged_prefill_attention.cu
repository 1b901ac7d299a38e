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
// softmax (m, l, acc) in fp32 with scale 1/sqrt(dh); a row that has seen
// no key stays exact, l sums the unrounded fp32 P, P is rounded to V's
// type before the PV product, and rows with l == 0 write exactly 0.  Every
// one of the C * r rows is computed, padded chunk tokens included.
//
// What bounds it on the H100.  4 * dh FLOPs per (query row, visible key)
// against 2 * dh * sizeof(T) bytes per key, read once per (row, kv head).
// A decode row (C = 1, r = 5 at qwen3-14b) does 5 query rows per key: far
// below the ~295 FLOP/byte ridge, so the bytes bound it.  A decode row
// packed into the fused step's 64-token bucket defines 320 query rows that
// each see the whole context (the padded tokens' positions are past the
// length): about 320 FLOP/byte, at the ridge, so the tensor cores and the
// bytes bound it about equally.
//
// What this design does about it, in bf16 where a (row, kv head) has more
// than 16 folded rows and the page divides a 64-key tile into boxes of
// whole swizzle groups (page 8, 16, 32 or 64; every served config uses
// 16): paged_prefill_wgmma below, on ../../csrc/hopper.cuh.
//  - Warp-specialised blocks: a producer warp a ring keeps 64-key K/V
//    tiles in flight by TMA (a full/empty mbarrier pair a stage), and
//    consumer warpgroups of 64 folded rows run both products by wgmma.
//    Where M = C * r > 64 a block is one (row, kv head) and three groups
//    (two at dh 96) sharing one ring of four stages, so a 320-row bucket
//    reads its row's K/V twice through L2 (the mma.sync tile read it five
//    times); where blocks of three would leave SMs idle (a launch of few
//    rows), two groups with P in registers and six stages.  Where M <= 64
//    (MHA chunks: bytes bound them) a block is two kv heads of a row, a
//    group and a ring each (three stages at dh 128, four at dh 96, six at
//    dh 64), P kept in registers to leave the rings that room.  These
//    shapes won over the variants timed on the card (PERF.md).
//  - K/V by TMA, one box per page and swizzle atom: 64 columns in the
//    128-byte swizzle (zeros past dh 96), or in the two-head blocks at
//    dh 96 32 columns in the 64-byte swizzle (a stage holds no zeros, so
//    a ring has four stages, not three).  The producer warp reads 32
//    table entries at a time (a lane each, clamped into the pool), and
//    its lanes issue a tile's page x atom x K/V boxes, one each (issued
//    from one lane they held the ring back), of a 4-D map (dh, page,
//    slots, 1) over the layer's pool view.  A tile's pages are read
//    whole; keys past a row's end get P = 0, and in the walk's last tile
//    V's rows past the row's length are cleared before P V, so what a
//    slot holds past the length (non-finite values too) never reaches the
//    output.  The maps are encoded once per pool view (a cache keyed by
//    base, slots, page, dh and box width).
//  - Q once per group, by 16-byte loads through q's strides (64 folded
//    rows straddle chunk tokens, which a TMA box cannot), stored in the
//    atoms' swizzle the wgmma descriptor reads.
//  - S = Q K^T (m64n64k16, K-major) and O += P V (V MN-major: one product
//    over two 64-column atoms, 128 wide on the zeros at dh 96, or one
//    m64n32k16 a 32-column atom) by wgmma; P goes through shared memory
//    in the 128-byte swizzle (two buffers a group) or stays in registers
//    as the A operand, so tile j's PV runs while tile j + 1's S and
//    softmax do.  exp2 in log2 units; O is rescaled only when a row's
//    maximum moved.
//  - Each (group, key tile) is interior (every real row sees every key:
//    no mask code), masked (a uniform branch sets -inf past each row's
//    end) or skipped (no row of the group sees a key of it).  A ring
//    walks to its last row's end; a group whose rows end earlier skips
//    the products and still releases each stage.  No wgmma sits under a
//    data-dependent branch (ptxas would serialise them all).
//  - Blocks of a (row, kv head) launch heaviest (last rows) first, the
//    (row, kv head)'s blocks together so they share its K/V in L2; a
//    block whose rows see no key (lengths 0) writes its zeros and exits.
//  - O from registers in (B, C, Hkv, r, dh) order; rows past M unwritten.
//
// In bf16 where a (row, kv head) has at most 16 folded rows (every fused
// step that packs no prefill chunk) at such a page: the decode tile of
// paged_decode_tma.cuh, which B2 shares (a persistent grid splitting the
// live 64-key tiles, a TMA producer warp and four mma.sync
// consumer warps a block, crossing (row, kv head)s merged in the same
// launch).
//
// Elsewhere the shared tile of ../../csrc/attention_tile.cuh (mma.sync in
// bf16, CUDA-core FMAs in fp32, never TF32; K/V by cp.async into two
// stages, a key's table entry read per key, so any page size works) over
// the paged block view of paged_block.cuh:
//  - M > 16 in fp32 or at another page size: 64 folded query rows per
//    block (4 warps) and 64-key tiles (32 in fp32).  The key loop ends at
//    the tile's last visible key; within a row the last query tiles launch
//    first.
//  - Flash-decoding where a (row, kv head) has one query tile of <= 16 rows
//    (decode rows in fp32 or at another page): one warp per block and the
//    keys split into spans across blocks by a plan the wrapper makes from
//    shapes alone (ops.split_plan); each block writes fp32 (m, l, acc)
//    partials and a second kernel merges the live spans.  Blocks whose
//    span starts past the last visible key exit at once; with one live
//    span the merge is exact.
//  - q is read through its strides (the model's transposed view needs no
//    copy); the output is written in (B, C, Hkv, r, dh) order.

#include "paged_block.cuh"
#include "paged_decode_tma.cuh"

namespace {

using namespace paged;

// ======================================== the shared tile (attention_tile)
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
  static bool configured = false;  // once per instance
  const cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.M + L::kM - 1) / L::kM;
  kernel<<<dim3(n_qt * p.n_splits, p.Hkv, B), kWarps * 32, L::kBytes,
           stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return e;
  paged_prefill_merge_kernel<T, DH>
      <<<dim3(p.Hkv, B), kMergeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ============================ bf16: wgmma consumers sharing one K/V ring
using namespace hopper;

constexpr int kRows = 64;               // folded rows of a consumer group
constexpr int kKeys = 64;               // keys of a tile
constexpr int kBoxRow = 128;            // bytes of a P box row: 64 keys
constexpr int kBox = kRows * kBoxRow;   // a 64 x 64 bf16 P box
constexpr int kStages = 4;              // most stages of a ring, P in smem
constexpr int kPregStages = 6;          // most stages of a ring, P in regs

// Consumer groups of a block where M > 64 (P through shared memory)
template <int DH>
constexpr int big_groups() {
  return DH == 96 ? 2 : 3;
}

// The block and its shared memory at head dim DH: the producer
// warpgroup, then NWG consumer groups of 64 folded rows each, one block an
// SM; P in registers (PREG) or shared memory.  HD == 1: the groups are one
// kv head's and share one ring; HD == NWG: each group is a kv head's, with
// a ring of its own (filled by producer warp g).  The launch bounds start
// every thread at kEntry registers; setmaxnreg leaves the producer
// kProducerRegs and gives the rest to the consumers (ptxas still compiles
// them at kEntry: O, S and P fit it).
template <int DH, int NWG, int PREG, int HD>
struct Wg {
  static_assert(HD == 1 || HD == NWG, "row groups or one group a head");
  // Q, K and V in atoms of AC columns: 64 in TMA's 128-byte swizzle (at
  // dh 96 zeros past dh), or in the two-head blocks at dh 96 (bytes bound
  // them) 32 in its 64-byte swizzle: no zeros in a stage, so four stages
  // a ring, not three, and O's product in three m64n32k16 (row groups
  // near the ridge keep one 128 wide: the 32-column atoms cost them 20 %)
  static constexpr int AC = DH % 64 == 0 || HD == 1 ? 64 : 32;
  static constexpr int AB = 2 * AC;              // bytes of an atom row
  static constexpr int kAtom = kRows * AB;       // 64 rows of an atom
  static constexpr uint32_t kHi = AC == 64 ? kDescHi : kDescHi64;
  static_assert(AC == 64 || (DH % AC == 0 && PREG), "P V by wgmma_rs");
  // the 16-byte piece of an atom row `row` that its piece c lands in
  static __device__ __forceinline__ int swz(int row, int c) {
    return c ^ (AC == 64 ? row & 7 : (row >> 1) & 3);
  }
  static constexpr int NR = HD;                  // rings: one, or a head's
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kFree = 65536 / kThreads / 8 * 8;
  static constexpr int kEntry = kFree < 248 ? kFree : 248;
  static constexpr int kProducerRegs = 32;
  static constexpr int kShare =
      (kEntry * kThreads - kProducerRegs * 128) / (128 * NWG) / 8 * 8;
  static constexpr int kConsumerRegs = kShare < 240 ? kShare : 240;
  static constexpr int KQ = (DH + AC - 1) / AC;  // atoms of a row
  static constexpr int NV = AC * KQ;             // O's product width
  static constexpr int kPos = NWG / HD * kRows;  // folded rows of a block
  static constexpr int kQBox = NWG * kAtom;      // one atom of the groups' Q
  static constexpr int kStage = 2 * KQ * kAtom;  // K and V of a tile
  static constexpr int kQ = 0;                   // KQ atoms
  static constexpr int kP = kQ + KQ * kQBox;     // NWG x 2 P boxes
  static constexpr int kK = kP + (PREG ? 0 : NWG * 2 * kBox);
  static constexpr int kRoom = (232448 - 1024 - 128 - kK) / NR;
  static constexpr int kMaxStages = PREG ? kPregStages : kStages;
  static constexpr int ST = kRoom / kStage < kMaxStages ? kRoom / kStage
                                                         : kMaxStages;
  static constexpr int kV = kK + NR * ST * KQ * kAtom;  // K, V atoms
  static constexpr int kBar = kV + NR * ST * KQ * kAtom;
  // bytes: three groups at dh 128, 49,152 Q + 49,152 P + 4 x 32,768; at
  // dh 64, 24,576 + 49,152 + 4 x 16,384; two at dh 96, 32,768 + 32,768 +
  // 4 x 32,768; two with P in registers at dh 128, 32,768 + 6 x 32,768,
  // at dh 64 16,384 + 6 x 16,384; two heads (P in registers) at dh 128,
  // 32,768 + 2 x 3 x 32,768, at dh 96 24,576 + 2 x 4 x 24,576, at dh 64
  // 16,384 + 2 x 6 x 16,384; each + barriers and alignment
  static constexpr int kBytes = kBar + 2 * NR * ST * 8 + 1024;
  static_assert(ST >= 2 && kBytes <= 232448, "over a block's shared memory");
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The keys folded row j sees: [0, key_end)
__device__ __forceinline__ int key_end(const Params& p, int length,
                                       int start, int j) {
  return max(0, min(length, start + j / p.r + 1));
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

// Grid (row blocks, kv heads / HD, B), x fastest: a (row, kv head)'s
// blocks run together, its last (heaviest) rows first.
template <int DH, int NWG, int PREG, int HD>
__global__ void __launch_bounds__(Wg<DH, NWG, PREG, HD>::kThreads, 1)
    paged_prefill_wgmma(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using L = Wg<DH, NWG, PREG, HD>;
  constexpr int KQ = L::KQ, ST = L::ST, NR = L::NR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + NR * ST;

  // row b; kv heads h0 .. h0 + HD - 1 (those below Hkv)
  const int b = blockIdx.z, h0 = blockIdx.y * HD;
  const int j0 = (gridDim.x - 1 - blockIdx.x) * L::kPos;  // first row
  const int length = max(0, min(p.lengths[b], p.max_pages * p.page));
  const int start = p.starts[b];
  bf16* out = static_cast<bf16*>(p.out);
  // (B, C, Hkv, r, dh) output row j of kv head h
  auto out_row = [&](int j, int h) {
    return out + ((static_cast<size_t>(b) * p.C + j / p.r) * p.Hkv + h) *
                     p.r * DH +
           static_cast<size_t>(j % p.r) * DH;
  };
  // the block walks key tiles [0, n_tiles): its last row's keys
  const int n_tiles =
      (key_end(p, length, start, min(j0 + L::kPos, p.M) - 1) + kKeys - 1) /
      kKeys;
  if (n_tiles == 0) {            // no row sees a key: zeros, and done
    const int rows = min(j0 + L::kPos, p.M) - j0;
    const int n = rows * (DH / 8) * min(HD, p.Hkv - h0);
    for (int i = threadIdx.x; i < n; i += L::kThreads) {
      const int row = i / (DH / 8) % rows;
      *reinterpret_cast<uint4*>(out_row(j0 + row, h0 + i / (DH / 8) / rows) +
                                8 * (i % (DH / 8))) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < NR * ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG / HD);      // every warp of its groups
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                     // producer
    regs_dec<L::kProducerRegs>();
    // warp w fills ring w (kv head h0 + w): lane i holds the slot of page
    // 32 c + i of the table row; the lanes issue a tile's boxes, one each
    const int ring = threadIdx.x / 32;
    if (ring < NR && h0 + ring < p.Hkv) {
      const int lane = threadIdx.x % 32;
      const int* tb = p.tables +
                      (static_cast<size_t>(b) * p.Hkv + h0 + ring) *
                          p.max_pages;
      uint64_t* rfull = full + ring * ST;
      uint64_t* rempty = empty + ring * ST;
      const int kv = ring * ST;                // the ring's first stage
      const int per = kKeys / p.page;          // pages a tile: 1-8
      const int box = p.page * L::AB;          // bytes of a page's box
      const int n_ops = per * KQ * 2;          // boxes a tile: K and V
      int slot = 0;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int pg = it * per;
        if (pg % 32 == 0) {
          const int pi = pg + lane;
          slot = pi < p.max_pages
                     ? min(max(__ldg(tb + pi), 0), p.slots - 1)
                     : 0;
        }
        if (lane == 0) {
          mbar_wait(&rempty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&rfull[stage], L::kStage);
        }
        __syncwarp();
        // a box a lane: (page i, atom c, K or V) of op; a second round
        // only past 32 boxes (page 8 in 32-column atoms).  Straight-line:
        // as a loop the issue cost the kernel 3 %
        auto issue = [&](int op) {
          const int i = op < n_ops ? op / (2 * KQ) : 0, c = op / 2 % KQ;
          const int s = __shfl_sync(0xffffffffu, slot, (pg + i) % 32);
          if (op < n_ops)
            tma_load_4d(sm + (op % 2 ? L::kV : L::kK) +
                            ((kv + stage) * KQ + c) * L::kAtom + i * box,
                        op % 2 ? &tv : &tk, &rfull[stage], L::AC * c, 0, s,
                        0);
        };
        issue(lane);
        if (n_ops > 32) issue(32 + lane);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {                                     // consumers
    regs_inc<L::kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, t = tid % 4;
    // this group's rows and kv head, its ring's barriers and first stage
    const int g0 = j0 + (HD == 1 ? wg * kRows : 0);
    const int h = HD == 1 ? h0 : h0 + wg;
    const int kv = HD == 1 ? 0 : wg * ST;
    full += kv;
    empty += kv;
    // the tiles the group's ring holds (none for a head past Hkv)
    const int n_ring = h < p.Hkv ? n_tiles : 0;
    const int row0 = g0 + 16 * warp + (tid % 32) / 4, row1 = row0 + 8;
    // the walk's tiles this group computes, [0, n_own), the first n_int
    // of them interior, the rest masked; the walk's tiles from n_own on
    // are skipped (the group's rows end before them); rows past M are not
    // the group's
    int n_own = 0, n_int = 0;
    if (g0 < p.M && h < p.Hkv) {
      n_own = (key_end(p, length, start, min(g0 + kRows, p.M) - 1) + kKeys -
               1) / kKeys;
      n_int = min(n_own, key_end(p, length, start, g0) / kKeys);
    }
    // descriptors: base + byte offset / 16; V's with its two 64-column
    // atoms a box apart
    const uint32_t d0 = desc_lo(smem_u32(sm));
    const uint32_t dv0 = desc_lo(smem_u32(sm), L::kAtom);
    const uint32_t dqs = d0 + (L::kQ + wg * L::kAtom) / 16;
    unsigned char* pbox = sm + L::kP + wg * 2 * kBox;
    const uint32_t dps = d0 + (L::kP + wg * 2 * kBox) / 16;

    if (n_own > 0) {
      // Q: the group's 64 rows x DH, 16 bytes a load, zeros past M, into
      // the swizzled atoms the descriptor reads
      constexpr int kPieces = DH / 8;          // 16-byte pieces of a row
      constexpr int kPa = L::AB / 16;          // of an atom row
      const bf16* qb = static_cast<const bf16*>(p.q) + b * p.sqb +
                       h * p.sqh;
#pragma unroll
      for (int i = 0; i < kRows * kPieces / 128; ++i) {
        const int idx = tid + 128 * i;
        const int row = idx / kPieces, pc = idx % kPieces;
        const int j = g0 + row;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (j < p.M)
          v = __ldg(reinterpret_cast<const uint4*>(
              qb + (j / p.r) * p.sqc + (j % p.r) * p.sqr + 8 * pc));
        *reinterpret_cast<uint4*>(sm + L::kQ + (pc / kPa) * L::kQBox +
                                  (wg * kRows + row) * L::AB +
                                  (L::swz(row, pc % kPa) << 4)) = v;
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
    }

    float o[L::NV / 2], s[kKeys / 2];
    uint32_t pk[kKeys / 16][4];                // P as O's A operand (PREG)
#pragma unroll
    for (int i = 0; i < L::NV / 2; ++i) o[i] = 0.f;
    // rows row0 and row1: running maximum of the scaled scores (log2
    // units) and this thread's share of the sum of P
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // the ring's stage and phase of walk tile `tile`
    auto stage_of = [](int tile) { return tile % ST; };
    auto phase_of = [](int tile) {
      return static_cast<uint32_t>(tile / ST) & 1;
    };
    // S = Q K^T (rows x keys) of the tile in stage st, B K-major, k-steps
    // up to DH; committed, not waited for
    auto issue_s = [&](int st) {
      const uint32_t dks = d0 + (L::kK + (kv + st) * KQ * L::kAtom) / 16;
#pragma unroll
      for (int c = 0; c < KQ; ++c)
#pragma unroll
        for (int kk = 0; kk < L::AC / 16; ++kk)
          if (L::AC * c + 16 * kk < DH)
            wgmma_ss<0, L::kHi>(s, dqs + (c * L::kQBox + 32 * kk) / 16,
                                dks + (c * L::kAtom + 32 * kk) / 16, c + kk);
      wgmma_commit();
    };
    // The online softmax of walk tile `tile`: P = exp2(S scale_log2 - m)
    // in s (and, unless PREG, rounded to bf16 into the group's P buffer
    // tile & 1), the running maxima and sums updated; returns the factors
    // (al0, al1) O's rows must be scaled by before the tile's PV
    auto softmax = [&](int tile) {
      // -inf past each row's end, only in a masked tile (uniform branch)
      if (tile >= n_int) {
        // the rows' ends, from the row's length and start read again:
        // nothing held in registers over the walk
        const int len = max(0, min(__ldg(p.lengths + blockIdx.z),
                                   p.max_pages * p.page));
        const int st0 = __ldg(p.starts + blockIdx.z);
        const int ke0 = key_end(p, len, st0, row0);
        const int ke1 = key_end(p, len, st0, row1);
        const int k0 = tile * kKeys + 2 * t;
#pragma unroll
        for (int idx = 0; idx < kKeys / 2; ++idx)
          if (k0 + 8 * (idx / 4) + idx % 2 >= (idx & 2 ? ke1 : ke0))
            s[idx] = -INFINITY;
      }
      float t0m = -INFINITY, t1m = -INFINITY;
#pragma unroll
      for (int idx = 0; idx < kKeys / 2; ++idx) {
        if (idx & 2)
          t1m = fmaxf(t1m, s[idx]);
        else
          t0m = fmaxf(t0m, s[idx]);
      }
      t0m = fmaxf(mx0, mma_tiles::quad_max(t0m) * p.scale_log2);
      t1m = fmaxf(mx1, mma_tiles::quad_max(t1m) * p.scale_log2);
      // a row that has seen no key yet subtracts 0: its P is exp2(-inf)
      const float b0 = t0m == -INFINITY ? 0.f : t0m;
      const float b1 = t1m == -INFINITY ? 0.f : t1m;
      const float2 al = make_float2(mma_tiles::ex2(mx0 - b0),
                                    mma_tiles::ex2(mx1 - b1));
      mx0 = t0m;
      mx1 = t1m;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int idx = 0; idx < kKeys / 2; ++idx) {
        s[idx] =
            mma_tiles::ex2(fmaf(s[idx], p.scale_log2, idx & 2 ? -b1 : -b0));
        if (idx & 2)
          r1 += s[idx];
        else
          r0 += s[idx];
      }
      l0 = fmaf(l0, al.x, r0);
      l1 = fmaf(l1, al.y, r1);
      if constexpr (!PREG) store_a(pbox + (tile & 1) * kBox, s);
      return al;
    };
    // P rounded to bf16 into the A fragments of O's k-steps: columns
    // 16 kk .. 16 kk + 15 of the accumulator layout (PREG)
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pk[kk][i] = mma_tiles::pack_bf16(s[8 * kk + 2 * i],
                                           s[8 * kk + 2 * i + 1]);
    };
    auto publish = [&]() {                    // P for O's product
      if constexpr (PREG) {
        pack_p();
      } else {                                // stored by the group's
        fence_proxy_async();                  // four warps, for wgmma
        bar_sync(1 + wg, 128);
      }
    };
    // O += P V of walk tile `tile` (P in buffer tile & 1), committed, not
    // waited for: one product over V's 64-column atoms (their stride the
    // leading offset), or one per 32-column atom into O's 16 columns
    auto issue_pv = [&](int tile) {
      const uint32_t dvs =
          dv0 + (L::kV + (kv + stage_of(tile)) * KQ * L::kAtom) / 16;
      const uint32_t dp = dps + (tile & 1) * kBox / 16;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t dv = dvs + kk * 16 * L::AB / 16;   // V's 16 keys
        if constexpr (L::AC == 64) {
          if constexpr (PREG)
            wgmma_rs<1>(o, pk[kk], dv, 1);
          else
            wgmma_ss<1>(o, dp + kk * 32 / 16, dv, 1);
        } else {
#pragma unroll
          for (int a = 0; a < KQ; ++a)
            wgmma_rs<1, kDescHi64>(
                *reinterpret_cast<float(*)[16]>(o + 16 * a), pk[kk],
                dv + a * L::kAtom / 16, 1);
        }
      }
      wgmma_commit();
    };

    if (n_own > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);                              // O is 0: nothing to scale
      publish();
      // tile j's PV runs while tile j + 1's S and softmax do; no wgmma is
      // issued under a branch (ptxas would serialise them)
      for (int j = 0; j + 1 < n_own; ++j) {
        mbar_wait(&full[stage_of(j + 1)], phase_of(j + 1));
        wgmma_fence();
        issue_s(stage_of(j + 1));
        issue_pv(j);
        wgmma_wait<1>();                       // S of tile j + 1
        fence_regs(s);
        const float2 al = softmax(j + 1);
        wgmma_wait<0>();                       // PV of tile j
        fence_regs(o);
        if constexpr (PREG)
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk) fence_regs(pk[kk]);
        release(&empty[stage_of(j)]);
        if (__any_sync(0xffffffffu, al.x != 1.f || al.y != 1.f))
#pragma unroll
          for (int idx = 0; idx < L::NV / 2; ++idx)
            o[idx] *= idx & 2 ? al.y : al.x;
        publish();
      }
      // the last tile's keys past the row's length: V's rows cleared
      // before P V (P is 0 there, but a stale or unwritten slot may hold
      // non-finite values, and 0 times those is not 0); each group that
      // computes the tile writes the same zeros
      if (n_own == n_tiles) {
        const int len = max(0, min(__ldg(p.lengths + blockIdx.z),
                                   p.max_pages * p.page));
        const int k0 = max(0, len - (n_tiles - 1) * kKeys);
        if (k0 < kKeys) {
          constexpr int kPa = L::AB / 16;      // pieces of an atom row
          unsigned char* vs =
              sm + L::kV + (kv + stage_of(n_tiles - 1)) * KQ * L::kAtom;
          for (int i = tid; i < (kKeys - k0) * KQ * kPa; i += 128)
            *reinterpret_cast<uint4*>(
                vs + (i / kPa % KQ) * L::kAtom +
                (k0 + i / (kPa * KQ)) * L::AB + 16 * (i % kPa)) =
                make_uint4(0, 0, 0, 0);
          fence_proxy_async();
          bar_sync(1 + wg, 128);
        }
      }
      wgmma_fence();
      issue_pv(n_own - 1);
      wgmma_wait<0>();
      fence_regs(o);
      release(&empty[stage_of(n_own - 1)]);
    }
    for (int tile = n_own; tile < n_ring; ++tile) {   // the walk's others
      mbar_wait(&full[stage_of(tile)], phase_of(tile));
      release(&empty[stage_of(tile)]);
    }

    l0 = mma_tiles::quad_sum(l0);
    l1 = mma_tiles::quad_sum(l1);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (h >= p.Hkv) return;
    bf16* r0p = row0 < p.M ? out_row(row0, h) : nullptr;
    bf16* r1p = row1 < p.M ? out_row(row1, h) : nullptr;
#pragma unroll
    for (int j = 0; j < L::NV / 8; ++j) {
      if (8 * j >= DH) continue;
      const int d = 8 * j + 2 * t;
      if (r0p)
        *reinterpret_cast<__nv_bfloat162*>(r0p + d) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1p)
        *reinterpret_cast<__nv_bfloat162*>(r1p + d) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int DH, int NWG, int PREG, int HD>
cudaError_t launch_groups(const Params& p, int B, cudaStream_t stream) {
  using L = Wg<DH, NWG, PREG, HD>;
  PoolMaps m;
  if (!pool_maps(p, DH, L::AC, &m)) return cudaErrorInvalidValue;
  auto kernel = paged_prefill_wgmma<DH, NWG, PREG, HD>;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_pb = (p.M + L::kPos - 1) / L::kPos;
  kernel<<<dim3(n_pb, (p.Hkv + HD - 1) / HD, B), L::kThreads, L::kBytes,
           stream>>>(m.k, m.v, p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  // one group a block where a (row, kv head)'s rows fit it: those blocks
  // stream bytes (r = 1) and want the deepest ring
  if (p.M <= kRows)
    return launch_groups<DH, 2, 1, 2>(p, B, stream);
  // a launch of few (row, kv head)s: blocks of two groups fill more SMs
  if constexpr (big_groups<DH>() == 3) {
    static int sms[64] = {0};              // SMs of each device
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
      return cudaErrorInvalidValue;
    if (sms[dev] == 0 &&
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return cudaErrorInvalidValue;
    if (static_cast<long long>(B) * p.Hkv * ((p.M + 3 * kRows - 1) /
                                             (3 * kRows)) < sms[dev])
      return launch_groups<DH, 2, 1, 1>(p, B, stream);
  }
  return launch_groups<DH, big_groups<DH>(), 0, 1>(p, B, stream);
}

// By shape and dtype alone (ops.prefill_tile and ops.decode_tile): where
// a (row, kv head) has <= 16 folded rows, the decode tile in bf16 at a
// page the boxes take and r > 1, else one warp of the shared tile; past 16
// rows, the wgmma kernel in bf16 at such a page, else the shared tile's 4
// warps.
template <typename T, int DH>
cudaError_t dispatch_rows(const Params& p, int B, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (p.M <= 16) {
    if (kBf16 && decode_tile_takes(p.page, p.r))
      return paged_tma::launch<DH, false>(p, p.n_blocks, stream);
    return launch<T, DH, 1>(p, B, stream);
  }
  if constexpr (kBf16)
    if (wgmma_page(p.page)) return launch_wgmma<DH>(p, B, stream);
  return launch<T, DH, 4>(p, B, stream);
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
// the last dim contiguous), out is (B, C, Hkv, r, dh) contiguous.  The
// shared tile: with n_splits > 1 (only where C * r <= 16) the keys are cut
// into spans of span keys (a multiple of 64) and m_part, l_part (B, Hkv,
// n_splits, C * r) and acc_part (.., dh) are fp32 scratch; with n_splits
// == 1 they are unused and span covers the table.  The decode tile (bf16,
// C * r <= 16, a page in 8, 16, 32, 64): a grid of n_blocks; m_part,
// l_part (2 n_blocks, C * r) and acc_part (.., dh) fp32 scratch, tickets
// (B, Hkv) int32 zeros, which it leaves zero.  Returns the launches'
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for what the
// kernels do not take, or pool tensor maps cuTensorMapEncodeTiled refuses).
extern "C" int paged_prefill_attention(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* lengths, const void* starts, void* out, void* m_part,
    void* l_part, void* acc_part, void* tickets, int B, int Hkv, int C,
    int r, int dh, int page, int max_pages, int slots, long long sqb,
    long long sqh, long long sqc, long long sqr, int n_splits, int span,
    int n_blocks, float scale, int dtype, void* stream) {
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
  p.tickets = static_cast<int*>(tickets);
  p.sqb = sqb;
  p.sqh = sqh;
  p.sqc = sqc;
  p.sqr = sqr;
  p.B = B;
  p.Hkv = Hkv;
  p.C = C;
  p.r = r;
  p.M = M;
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
