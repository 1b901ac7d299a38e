// The decode tile for Hopper (sm_90a): attention of at most 16 folded
// query rows a (row, kv head) over the head-granular paged pool, in bf16
// at a page of 8, 16, 32 or 64 keys and dh 64, 96 or 128, where a kv head
// has r > 1 query rows (paged_block.cuh's decode_tile_takes: MHA keeps the
// one-warp split tile).  It serves those launches of both paged kernels:
//   B2, paged_attention.cu (decode: one token a row, its r <= 16 query
//   rows), and
//   B1, paged_prefill_attention.cu where C * r <= 16 (every fused step
//   that packs no prefill chunk: its bucket is C = 1),
// replacing, for those calls, the Pallas TPU kernels
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
//   and ::paged_prefill_attention_kernel.
// Folded row j = c * r + i sees the keys [0, key_end(j)): the row's length
// in decode, min(length, start + c + 1) in a chunk, lengths clamped to the
// table width; table entries are clamped into the pool here.  The online
// softmax runs in fp32 in log2 units, l sums the unrounded P, P is rounded
// to bf16 before P V, and rows with l == 0 write exactly 0.
//
// What bounds it on the H100: bytes.  r <= 16 rows do 4 r dh FLOPs a key
// against 4 dh bytes of K and V, r FLOP/byte against the ~295 where the
// tensor cores would bound it: qwen3-14b's decode batch is about 1.2
// GFLOP, a few µs of tensor-core time, against 23 µs of bytes.  So the
// design keeps HBM busy:
//  - A persistent grid of two blocks an SM, each a producer warp and four
//    consumer warps.  The live 64-key tiles of all (row, kv head)s, in
//    (row, kv head, tile) order, are split over the blocks, each
//    (row, kv head) weighed as its tiles plus kHeadCost for its fixed cost
//    (its q, the combine, a piece): block g of G = min(grid, U) walks the
//    tiles of units [g U / G, (g + 1) U / G) of the U in all.  Every block
//    computes the split from lengths (and starts) itself: no
//    device-to-host read, and no tile past a (row, kv head)'s last row's
//    end.
//  - K/V by TMA into a ring of mbarrier-guarded stages (three of 32 KB at
//    dh 96 and 128, six of 16 KB at dh 64: ~192 KB an SM in flight), one
//    box a page and 64-column atom, 128-byte swizzled (zeros past dh 96),
//    of the 4-D pool maps (paged_block.cuh's cache).  The producer's lanes
//    read the table 32 pages at a time, a lane a page (clamped into the
//    pool), a window
//    ahead and the next segment's first window early, and issue a tile's
//    boxes a lane each.
//  - Both products by mma.sync m16n8k16 (bf16 in, fp32 accumulators), K
//    and V through ldmatrix from the swizzled stage (conflict-free): the
//    r <= 16 rows are one m16 tile, where wgmma's 64 rows would waste 48
//    to 63 of theirs.  The m16 tile costs the same at any r, so each
//    consumer warp takes 16 keys of every tile (32 products a tile, not
//    128) with an online softmax of its own, and a segment's four (m, l,
//    acc) are combined in warp order through shared memory, a quarter of
//    the columns at a time (so the ring keeps its third stage).  With one
//    consumer warp a block, the warps' products held the card to 0.39 of
//    the bound at qwen3-14b's decode batch.
//  - A tile that holds some row's end sets S to -inf past it (a select: a
//    NaN read there never counts), and V's fragments are cleared past the
//    row's length before P V (a no-op but in the last tile), so what a
//    slot holds past the length, non-finite values too, never reaches the
//    output.
//  - A (row, kv head) that one block covers is written from the walk's
//    combined (m, l, acc), as an unsplit walk would.  One that crosses
//    blocks leaves fp32 partials (two slots a block: its first and its
//    last segment) and takes a ticket after the block's walk (so no fence
//    or L2 round trip stalls the walk); the block that takes the last one
//    resets it and merges the pieces in span order, in the same launch:
//    the same bits whichever block finishes last.
//  - The producer copies each segment's q rows (bulk copies, a row a
//    lane) into a q buffer ahead of the segment's first tile, so the
//    consumers read q from shared memory when the segment starts.
//  - Rows whose walk has no tile (lengths 0) get their zeros from block
//    b % grid.

#pragma once

#include "hopper.cuh"
#include "paged_block.cuh"

// Internal linkage, like the kernels of each library's source: no state
// (the shared-memory opt-in below) is one symbol across loaded libraries
namespace paged_tma {
namespace {

using namespace hopper;
using mma_tiles::bf16;
using paged::Params;

constexpr int kKeys = 64;                  // keys of a tile
constexpr int kRowBytes = 128;             // an atom row: 64 bf16 columns
constexpr int kAtom = kKeys * kRowBytes;   // a tile's 64-column atom
constexpr int kBlocksPerSm = 2;            // ops.TMA_BLOCKS_PER_SM
constexpr int kConsumers = 4;              // consumer warps
constexpr int kWarpKeys = kKeys / kConsumers;   // a consumer's keys a tile
constexpr int kThreads = 32 * (1 + kConsumers);
constexpr int kCThreads = 32 * kConsumers;      // the consumers' threads
constexpr int kMaxRows = 16;               // folded rows: one m16 tile
constexpr int kMaxStages = 8;
constexpr int kPasses = 4;                 // the combine's column passes
// A (row, kv head)'s fixed cost in tiles (its q, its combine, its piece):
// the split weighs each by its tiles and this (ops.TMA_HEAD_COST)
constexpr int kHeadCost = 1;
static_assert(kWarpKeys % 16 == 0, "whole k16 steps of P V a warp");

// The block's shared memory at head dim DH: K atoms, V atoms, the
// consumers' (acc, m, l) for the combine (acc a quarter of the columns at
// a time) and the tickets taken, the full and empty barriers of the stages
// and of the q buffer, then the q buffer (a segment's rows), in a block's
// share of the SM's 228 KB (less the 1 KB the SM keeps a block, alignment
// and barriers)
template <int DH>
struct Ring {
  static constexpr int KQ = (DH + 63) / 64;       // atoms of a row
  static constexpr int kStage = 2 * KQ * kAtom;   // K and V of a tile
  static constexpr int kXRows = kConsumers * kMaxRows;
  static constexpr int kXCols = DH / kPasses;     // acc columns a pass
  static constexpr int kX = kXRows * (kXCols + 2) * 4 + 16;
  static constexpr int kQBytes = kMaxRows * DH * 2;
  static constexpr int kRoom =
      233472 / kBlocksPerSm - 1024 - 1024 - 144 - kX - kQBytes;
  static constexpr int ST =
      kRoom / kStage < kMaxStages ? kRoom / kStage : kMaxStages;
  static constexpr int kK = 0;
  static constexpr int kV = ST * KQ * kAtom;
  static constexpr int kXAcc = 2 * kV;                // [warp][row][cols]
  static constexpr int kXM = kXAcc + kXRows * kXCols * 4;  // [warp][row]
  static constexpr int kXL = kXM + kXRows * 4;
  static constexpr int kXT = kXL + kXRows * 4;        // the tickets taken
  static constexpr int kBar = kXAcc + kX;
  static constexpr int kQBar = kBar + 2 * ST * 8;     // q full, q empty
  static constexpr int kQ = kQBar + 16;               // 16-byte aligned
  static constexpr int kBytes = kQ + kQBytes + 1024;
  static_assert(ST >= 2 && (kBytes + 1024) * kBlocksPerSm <= 233472,
                "a ring of two stages, kBlocksPerSm blocks an SM");
  static_assert(kXCols % 8 == 0, "whole 8-column fragments a pass");
};

// The byte of the stage `tile` holding (key, column col) in TMA's 128-byte
// swizzle: 16-byte piece (col % 64) / 8 of the row at piece ^ (key & 7)
__device__ __forceinline__ const unsigned char* at(const unsigned char* tile,
                                                   int key, int col) {
  return tile + (col >> 6) * kAtom + key * kRowBytes +
         ((((col & 63) >> 3) ^ (key & 7)) << 4);
}

// Keys of row b's walk: its last folded row's end
template <bool kDecode>
__device__ __forceinline__ int walk_keys(const Params& p, int b) {
  const int len = max(0, min(__ldg(p.lengths + b), p.max_pages * p.page));
  if constexpr (kDecode) return len;
  return max(0, min(len, __ldg(p.starts + b) + p.C));
}
template <bool kDecode>
__device__ __forceinline__ int row_tiles(const Params& p, int b) {
  return (walk_keys<kDecode>(p, b) + kKeys - 1) / kKeys;
}

// The split's units: each (row, kv head) with tiles is kHeadCost units of
// fixed cost, then a unit a tile.  The first unit of block g of G over U
// units, and the block holding unit u
__device__ __forceinline__ int block_start(int g, int U, int G) {
  return static_cast<int>(static_cast<long long>(g) * U / G);
}
__device__ __forceinline__ int block_of(int u, int U, int G) {
  int g = static_cast<int>(static_cast<long long>(u) * G / U);
  while (g + 1 < G && block_start(g + 1, U, G) <= u) ++g;
  while (block_start(g, U, G) > u) --g;
  return g;
}

// A warp's place in the walk: tile tin of the nt tiles of (row b, kv head
// h); base is the unit of (b, 0)'s first unit among all U
struct Cursor {
  int b, h, tin, nt, base;
};
// the first unit of the cursor's (row, kv head), and that of its tile
__device__ __forceinline__ int head_unit(const Cursor& c) {
  return c.base + c.h * (c.nt + kHeadCost);
}
__device__ __forceinline__ int tile_unit(const Cursor& c) {
  return head_unit(c) + kHeadCost + c.tin;
}
template <bool kDecode>
__device__ __forceinline__ int row_units(const Params& p, int b) {
  const int nt = row_tiles<kDecode>(p, b);
  return nt ? nt + kHeadCost : 0;
}

// U, the units of all (row, kv head)s (every lane of a warp)
template <bool kDecode>
__device__ int total_units(const Params& p) {
  const int lane = threadIdx.x & 31;
  int U = 0;
  for (int b0 = 0; b0 < p.B; b0 += 32) {
    const int b = b0 + lane;
    U += __reduce_add_sync(0xffffffffu,
                           b < p.B ? row_units<kDecode>(p, b) : 0);
  }
  return U * p.Hkv;
}

// The cursor at the first tile at or after unit u < U (every lane of a
// warp): a scan of the rows' units, 32 rows at a time
template <bool kDecode>
__device__ Cursor locate(const Params& p, int u) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int b0 = 0; b0 < p.B; b0 += 32) {
    const int b = b0 + lane;
    const int n = b < p.B ? row_units<kDecode>(p, b) * p.Hkv : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const int lo = base + incl - n;
    const unsigned hit =
        __ballot_sync(0xffffffffu, n > 0 && lo <= u && u < base + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      Cursor c;
      c.b = b0 + src;
      c.base = __shfl_sync(0xffffffffu, lo, src);
      c.nt = __shfl_sync(0xffffffffu, n, src) / p.Hkv - kHeadCost;
      c.h = (u - c.base) / (c.nt + kHeadCost);
      c.tin = max(0, (u - c.base) % (c.nt + kHeadCost) - kHeadCost);
      return c;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  return Cursor{p.B, 0, 0, 1, base};          // u >= U: never asked
}

// On to the first tile of the next (row, kv head) that has tiles (b = B
// past the last)
template <bool kDecode>
__device__ __forceinline__ void next_head(const Params& p, Cursor& c) {
  c.tin = 0;
  if (++c.h < p.Hkv) return;
  c.h = 0;
  c.base += (c.nt + kHeadCost) * p.Hkv;
  while (++c.b < p.B && (c.nt = row_tiles<kDecode>(p, c.b)) == 0) {
  }
}

// (B, C, Hkv, r, dh) output row j of (row b, kv head h); B2's (B, Hkv, r,
// dh) is its C = 1 case
template <int DH>
__device__ __forceinline__ bf16* out_row(const Params& p, int b, int h,
                                         int j) {
  return static_cast<bf16*>(p.out) +
         ((static_cast<size_t>(b) * p.C + j / p.r) * p.Hkv + h) * p.r * DH +
         static_cast<size_t>(j % p.r) * DH;
}

// Folded query row j of (row b, kv head h), through q's strides
__device__ __forceinline__ const bf16* q_row(const Params& p, int b, int h,
                                             int j) {
  return static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh +
         (j / p.r) * p.sqc + (j % p.r) * p.sqr;
}

// The consumers (thread tid of kCThreads) merge the np pieces of (row b,
// kv head h), held by blocks ga .. ga + np - 1 (in span order: slot
// 2 ga + 1 where the span is ga's last segment and not its first, else
// 2 g), into the output: M = max m_s, out = sum 2^(m_s - M) acc_s /
// sum 2^(m_s - M) l_s, 0 where that is 0.  Reads bypass L1 (other blocks
// wrote them); a thread's units of 4 columns are independent, so their
// loads overlap.
template <int DH>
__device__ void merge_pieces(const Params& p, int tid, int b, int h, int ga,
                             int np, bool ga_last) {
  const int M = p.M;
  auto piece = [&](int q) {
    return static_cast<size_t>(2 * (ga + q) + (q == 0 && ga_last)) * M;
  };
  constexpr int kU = DH / 4;                          // units a row
  constexpr int kPer = (kMaxRows * kU + kCThreads - 1) / kCThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = tid + kCThreads * i;
    if (u >= M * kU) break;
    const int j = u / kU;
    float mx = -INFINITY;
#pragma unroll 4
    for (int q = 0; q < np; ++q)
      mx = fmaxf(mx, __ldcg(p.m_part + piece(q) + j));
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mx != -INFINITY) {
#pragma unroll 4
      for (int q = 0; q < np; ++q) {
        const size_t row = piece(q) + j;
        const float w = mma_tiles::ex2(__ldcg(p.m_part + row) - mx);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            p.acc_part + row * DH + 4 * (u % kU)));
        l = fmaf(w, __ldcg(p.l_part + row), l);
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out_row<DH>(p, b, h, j) + 4 * (u % kU));
    dst[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    dst[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

template <int DH, bool kDecode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    paged_decode_tma(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const Params p) {
  using R = Ring<DH>;
  constexpr int KQ = R::KQ, ST = R::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + R::kBar);
  uint64_t* empty = full + ST;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + R::kQBar);
  uint64_t* q_empty = q_full + 1;
  const bf16* q_sm = reinterpret_cast<const bf16*>(sm + R::kQ);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);        // every consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  // this block's units [u0, u1) of the U in all: the tiles whose units
  // lie there
  const int U = total_units<kDecode>(p);
  const int G = min(static_cast<int>(gridDim.x), U);
  const int g = blockIdx.x;
  const int u0 = g < G ? block_start(g, U, G) : 0;
  const int u1 = g < G ? block_start(g + 1, U, G) : 0;
  // whether the cursor's (row, kv head) has a tile in the block's units
  auto walks = [&](const Cursor& x) {
    return x.b < p.B && tile_unit(x) < u1;
  };

  if (threadIdx.x < 32) {                      // producer
    if (u0 == u1) return;
    Cursor c = locate<kDecode>(p, u0);
    const int per = kKeys / p.page;            // pages a tile: 1-8
    const int n_ops = per * KQ * 2;            // boxes a tile: <= 32
    // this lane's box of each tile: page i, atom a, K or V
    const int i = lane / (2 * KQ), a = lane / 2 % KQ;
    const bool is_v = lane & 1;
    unsigned char* dst0 = sm + (is_v ? R::kV : R::kK) + a * kAtom +
                          i * p.page * kRowBytes;
    auto row_of = [&](const Cursor& x) {
      return p.tables + (static_cast<size_t>(x.b) * p.Hkv + x.h) *
                            p.max_pages;
    };
    // the slot of page pg of a table row, clamped into the pool (slot 0
    // past the row)
    auto entry = [&](const int* tb, int pg) {
      return pg < p.max_pages ? min(max(__ldg(tb + pg), 0), p.slots - 1)
                              : 0;
    };
    // The table is read 32 pages at a time, a lane a page, a window
    // ahead, and the next segment's first window while this one is issued
    int pre = 0;
    bool have_pre = false;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    while (walks(c)) {
      const int* tb = row_of(c);
      const int n = min(c.nt - c.tin, u1 - tile_unit(c));
      int w = c.tin * per;                     // window: pages w .. w + 31
      int cur = have_pre ? pre : entry(tb, w + lane);
      int nxt = entry(tb, w + 32 + lane);
      Cursor cn = c;
      next_head<kDecode>(p, cn);
      have_pre = walks(cn);
      if (have_pre) pre = entry(row_of(cn), lane);  // its tile 0
      // the segment's q rows into the q buffer, a row a lane, once the
      // consumers hold the last segment's in registers: ahead of its
      // first tile, off the consumers' path
      if (lane == 0) {
        mbar_wait(q_empty, q_phase ^ 1);
        mbar_arrive_expect_tx(q_full, p.M * DH * 2);
      }
      __syncwarp();
      if (lane < p.M)
        bulk_load(sm + R::kQ + lane * DH * 2, q_row(p, c.b, c.h, lane),
                  DH * 2, q_full);
      q_phase ^= 1;
      for (int k = 0; k < n; ++k) {
        const int pg = (c.tin + k) * per;      // the tile's first page
        if (pg >= w + 32) {
          w += 32;
          cur = nxt;
          nxt = entry(tb, w + 32 + lane);
        }
        const int slot = __shfl_sync(0xffffffffu, cur, (pg - w + i) & 31);
        if (lane == 0) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], R::kStage);
        }
        __syncwarp();
        if (lane < n_ops)
          tma_load_4d(dst0 + stage * KQ * kAtom, is_v ? &tv : &tk,
                      &full[stage], 64 * a, 0, slot, 0);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
      c = cn;
    }
    return;
  }

  // consumers: first the zeros of rows whose walk has no tile
  const int tid = threadIdx.x - 32, cw = tid / 32;
  for (int b = g; b < p.B; b += gridDim.x) {
    if (row_tiles<kDecode>(p, b) != 0) continue;
    const int n = p.Hkv * p.M * (DH / 8);
    for (int x = tid; x < n; x += kCThreads) {
      const int row = x / (DH / 8);
      *reinterpret_cast<uint4*>(out_row<DH>(p, b, row / p.M, row % p.M) +
                                8 * (x % (DH / 8))) = make_uint4(0, 0, 0, 0);
    }
  }
  if (u0 == u1) return;

  const int gq = lane >> 2, tq = lane & 3;     // rows gq, gq + 8
  // ldmatrix rows and columns: K (keys x dims), V transposed
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
  const int key0 = cw * kWarpKeys;             // this warp's keys a tile
  float* x_acc = reinterpret_cast<float*>(sm + R::kXAcc);
  float* x_m = reinterpret_cast<float*>(sm + R::kXM);
  float* x_l = reinterpret_cast<float*>(sm + R::kXL);
  int* x_ticket = reinterpret_cast<int*>(sm + R::kXT);
  // the block's pieces (its first and last segment where they do not
  // cover their (row, kv head)): row, kv head, first tile index; their
  // tickets are taken after the walk, so no fence or L2 round trip stalls
  // it
  struct Piece {
    int b, h, u0, nt;
  } pc0 = {0, 0, 0, 0}, pc1 = {0, 0, 0, 0};
  int n_pc = 0;
  Cursor c = locate<kDecode>(p, u0);
  if (!walks(c)) return;                       // no tile in the units
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  bool first = true;
  while (walks(c)) {
    const int n = min(c.nt - c.tin, u1 - tile_unit(c));
    const int b = c.b, h = c.h;
    Cursor cn = c;
    next_head<kDecode>(p, cn);
    const int len = max(0, min(__ldg(p.lengths + b), p.max_pages * p.page));
    const int start = kDecode ? 0 : __ldg(p.starts + b);
    auto key_end = [&](int j) {
      return kDecode ? len : max(0, min(len, start + j / p.r + 1));
    };
    const int ke0 = key_end(gq), ke1 = key_end(gq + 8);
    const int ke_lo = key_end(0);              // the least row end

    // Q fragments of rows gq and gq + 8 (zeros past M) from the q buffer,
    // which the producer filled ahead; then the buffer is free
    uint32_t qf[DH / 16][4];
    mbar_wait(q_full, q_phase);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = gq + 8 * (x & 1);
        const int col = 16 * kk + 2 * tq + 8 * (x >> 1);
        qf[kk][x] = row < p.M ? *reinterpret_cast<const uint32_t*>(
                                    q_sm + row * DH + col)
                              : 0u;
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);
    q_phase ^= 1;

    float o[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int k = 0; k < n; ++k) {
      const int k0 = (c.tin + k) * kKeys;      // the tile's first key
      const int kw = k0 + key0;                // this warp's first key
      mbar_wait(&full[stage], phase);
      const unsigned char* ks = sm + R::kK + stage * KQ * kAtom;
      const unsigned char* vs = sm + R::kV + stage * KQ * kAtom;

      // S = Q K^T over the warp's keys: s[j][e] / s[j][2 + e] is row gq /
      // gq + 8 at key kw + 8 j + 2 tq + e
      float s[kWarpKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < kWarpKeys / 16; ++nn) {
          uint32_t bfr[4];
          mma_tiles::ldmatrix_x4(
              bfr, at(ks, key0 + 16 * nn + krow, 16 * kk + kcol));
          mma_tiles::mma_bf16(s[2 * nn], qf[kk], bfr[0], bfr[1]);
          mma_tiles::mma_bf16(s[2 * nn + 1], qf[kk], bfr[2], bfr[3]);
        }

      // -inf past each row's end, only in a tile that holds one (a
      // block-uniform branch)
      if (k0 + kKeys > ke_lo) {
#pragma unroll
        for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kw + 8 * j + 2 * tq + e;
            if (key >= ke0) s[j][e] = -INFINITY;
            if (key >= ke1) s[j][2 + e] = -INFINITY;
          }
      }
      // online softmax in log2 units: a row that has seen no key yet
      // subtracts 0, so its P is exp2(-inf) = 0
      float t0m = -INFINITY, t1m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j) {
        t0m = fmaxf(t0m, fmaxf(s[j][0], s[j][1]));
        t1m = fmaxf(t1m, fmaxf(s[j][2], s[j][3]));
      }
      t0m = fmaxf(mx0, mma_tiles::quad_max(t0m) * p.scale_log2);
      t1m = fmaxf(mx1, mma_tiles::quad_max(t1m) * p.scale_log2);
      const float b0 = t0m == -INFINITY ? 0.f : t0m;
      const float b1 = t1m == -INFINITY ? 0.f : t1m;
      const float al0 = mma_tiles::ex2(mx0 - b0);
      const float al1 = mma_tiles::ex2(mx1 - b1);
      mx0 = t0m;
      mx1 = t1m;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = mma_tiles::ex2(fmaf(s[j][e], p.scale_log2, -b0));
          s[j][2 + e] = mma_tiles::ex2(fmaf(s[j][2 + e], p.scale_log2, -b1));
          r0 += s[j][e];
          r1 += s[j][2 + e];
        }
      l0 = fmaf(l0, al0, r0);
      l1 = fmaf(l1, al1, r1);
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        o[d][0] *= al0;
        o[d][1] *= al0;
        o[d][2] *= al1;
        o[d][3] *= al1;
      }

      // O += P V, P rounded to bf16 from the accumulator fragment; V's
      // keys past the length cleared in its fragments (this thread's keys
      // kw + 16 kk + 2 tq (+ 1) and + 8)
#pragma unroll
      for (int kk = 0; kk < kWarpKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            mma_tiles::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            mma_tiles::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            mma_tiles::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            mma_tiles::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = kw + 16 * kk + 2 * tq;
        const uint32_t m_lo = (key < len ? 0xffffu : 0u) |
                              (key + 1 < len ? 0xffff0000u : 0u);
        const uint32_t m_hi = (key + 8 < len ? 0xffffu : 0u) |
                              (key + 9 < len ? 0xffff0000u : 0u);
#pragma unroll
        for (int nd = 0; nd < DH / 16; ++nd) {
          uint32_t bfr[4];
          mma_tiles::ldmatrix_x4_trans(
              bfr, at(vs, key0 + 16 * kk + vrow, 16 * nd + vcol));
          mma_tiles::mma_bf16(o[2 * nd], pa, bfr[0] & m_lo, bfr[1] & m_hi);
          mma_tiles::mma_bf16(o[2 * nd + 1], pa, bfr[2] & m_lo,
                              bfr[3] & m_hi);
        }
      }
      __syncwarp();                            // the stage is read: free it
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the segment's end: each warp's (m, l) and a quarter of its acc at a
    // time into shared memory; every consumer combines the quarter's
    // columns over the four warps, in warp order
    l0 = mma_tiles::quad_sum(l0);
    l1 = mma_tiles::quad_sum(l1);
    const int r0w = cw * kMaxRows + gq, r1w = r0w + 8;
    if (tq == 0) {
      x_m[r0w] = mx0;
      x_l[r0w] = l0;
      x_m[r1w] = mx1;
      x_l[r1w] = l1;
    }
    const bool covered = c.tin == 0 && n == c.nt;
    const size_t base = static_cast<size_t>(2 * g + (first ? 0 : 1)) * p.M;
    constexpr int kXC = R::kXCols;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      if (pass > 0) bar_sync(1, kCThreads);    // the last pass is read
#pragma unroll
      for (int d = pass * kXC / 8; d < (pass + 1) * kXC / 8; ++d) {
        const int col = 8 * d + 2 * tq - pass * kXC;
        *reinterpret_cast<float2*>(x_acc + r0w * kXC + col) =
            make_float2(o[d][0], o[d][1]);
        *reinterpret_cast<float2*>(x_acc + r1w * kXC + col) =
            make_float2(o[d][2], o[d][3]);
      }
      bar_sync(1, kCThreads);
      for (int u = tid; u < p.M * (kXC / 2); u += kCThreads) {
        const int j = u / (kXC / 2), cx = 2 * (u % (kXC / 2));
        const int col = pass * kXC + cx;
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          m = fmaxf(m, x_m[w * kMaxRows + j]);
        float l = 0.f, a0 = 0.f, a1 = 0.f;
        if (m != -INFINITY) {
#pragma unroll
          for (int w = 0; w < kConsumers; ++w) {
            const int rw = w * kMaxRows + j;
            const float wt = mma_tiles::ex2(x_m[rw] - m);
            const float2 v =
                *reinterpret_cast<const float2*>(x_acc + rw * kXC + cx);
            l = fmaf(wt, x_l[rw], l);
            a0 = fmaf(wt, v.x, a0);
            a1 = fmaf(wt, v.y, a1);
          }
        }
        if (covered) {
          // the block covers (b, h): its output, as an unsplit walk
          // writes it
          const float inv = l > 0.f ? 1.f / l : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(out_row<DH>(p, b, h, j) + col) =
              __floats2bfloat162_rn(a0 * inv, a1 * inv);
        } else {                               // a piece: fp32 partials
          if (col == 0) {
            p.m_part[base + j] = m;
            p.l_part[base + j] = l;
          }
          *reinterpret_cast<float2*>(p.acc_part + (base + j) * DH + col) =
              make_float2(a0, a1);
        }
      }
    }
    if (!covered) {                            // (b, h)'s first unit, tiles
      const Piece x = {b, h, head_unit(c), c.nt};
      if (n_pc++ == 0)
        pc0 = x;
      else
        pc1 = x;
    }
    bar_sync(1, kCThreads);                    // the combine's memory is free
    first = false;
    c = cn;
  }

  // the pieces' tickets; the block that takes a (row, kv head)'s last
  // merges its pieces
  if (n_pc == 0) return;
  auto ticket = [&](const Piece& x) {
    return p.tickets + static_cast<size_t>(x.b) * p.Hkv + x.h;
  };
  __threadfence();
  bar_sync(1, kCThreads);
  if (tid < n_pc) {
    const Piece x = tid ? pc1 : pc0;
    x_ticket[tid] = atomicAdd(ticket(x), 1);
  }
  bar_sync(1, kCThreads);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == n_pc) break;
    const Piece x = i ? pc1 : pc0;
    // the blocks holding its first and last tile's units; the first's
    // piece is its last segment where its units start before (b, h)'s
    const int ga = block_of(x.u0 + kHeadCost, U, G);
    const int gb = block_of(x.u0 + kHeadCost + x.nt - 1, U, G);
    if (x_ticket[i] != gb - ga) continue;      // not the last piece
    if (tid == 0) atomicExch(ticket(x), 0);
    __threadfence();
    merge_pieces<DH>(p, tid, x.b, x.h, ga, gb - ga + 1,
                     block_start(ga, U, G) < x.u0);
  }
}

// One launch of the decode tile at n_blocks blocks (the wrapper's grid:
// kBlocksPerSm an SM); p.acc_part, p.m_part and p.l_part hold 2 n_blocks
// pieces of M rows, p.tickets (B, Hkv) zeros.
template <int DH, bool kDecode>
cudaError_t launch(const Params& p, int n_blocks, cudaStream_t stream) {
  using R = Ring<DH>;
  if (p.M > kMaxRows || n_blocks < 1 || p.tickets == nullptr ||
      p.acc_part == nullptr || p.m_part == nullptr || p.l_part == nullptr)
    return cudaErrorInvalidValue;
  paged::PoolMaps m;
  if (!paged::pool_maps(p, DH, 64, &m)) return cudaErrorInvalidValue;
  auto kernel = paged_decode_tma<DH, kDecode>;
  static bool configured = false;
  const cudaError_t err = paged::allow_smem(kernel, R::kBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, R::kBytes, stream>>>(m.k, m.v, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paged_tma
