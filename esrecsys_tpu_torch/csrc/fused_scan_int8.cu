// Fused MIPS scan+select for Hopper (sm_90a) over an int8 catalog.
//
// Replaces the int8 (`item_scales`) branch of the Pallas TPU kernel
// `_kernel` of esrecsys_tpu/retrieval/fused.py (:212-225), launched there by
// `binned_candidates` for quantized serving. It computes the same function:
// for each query and catalog item g below `bound` (and eligible under the
// optional mask), score = (q . codes_g) * scale_g, where the bf16 query
// meets the item's int8 codes widened exactly to bf16 (|v| <= 127), the dot
// sums in float32 and the item's float32 scale multiplies the sum BEFORE
// the bound, the mask and the fold. The query stays bf16: an int8 x int8
// product would quantize it, which the reference does not do. Item g falls
// in bin g mod L, and each bin keeps its top two (value, id) pairs, folded
// over the catalog blocks in ascending order with a strict `>`, so the
// earlier block wins ties. Slots never filled keep (-inf, 0). Output: vals
// (B, 2L) float32 and ids (B, 2L) int32, the first L columns each bin's
// best, the next L its runner-up.
//
// What bounds it: bytes. One pass over the int8 catalog with its float32
// scales at D=64 and Mp=2,265,088 moves 154 MB, 46 us at the H100 SXM's
// published 3.35 TB/s; the 2*B*D operations per item are far below the
// tensor cores' rate. One max_batch=8 call streams the catalog once, and
// each further tile of 8 queries once more.
//
// Design. The grid is (L/32) x (ceil(B/8) query tiles), 128 CTAs at
// L=4096, in clusters of two: the two CTAs of a cluster share 64
// neighbouring bins and split the depth, CTA h taking depths h D/2.. and
// folding the pair's bins of parity h. A CTA is one producer warp, eight
// scoring warps and four folding warps.
//   - Copies. An SM keeps a bounded number of L2 line requests in flight,
//     so it streams about one catalog row (a line, however few of its bytes
//     it uses) per 2.5 ns, and it pays about 0.15 us per stage of the copy
//     ring on top. A CTA reading all D rows of 32 bins of every block is
//     therefore held to about 1.7 TB/s over the card. So a CTA reads half
//     the rows, 64 bytes of each, and eight blocks at a time: per stage one
//     TMA copy of a 3-D tensor map (bin, depth, block) whose box is its
//     (D/2 x 64) tiles of eight consecutive blocks, written with the
//     64-byte swizzle so that the eight rows an ldmatrix phase reads fall
//     in distinct banks, and bulk copies of the blocks' 64 scales and 64
//     mask bytes, all completing on the stage's "full" mbarrier, in a ring
//     of up to four stages; each scoring warp releases a stage on its
//     "empty" mbarrier.
//   - Scoring warp (w, p) scores the pair's bins 16 w.. in half p of each
//     stage's blocks over the CTA's depth half, with tensor-core mma.sync
//     (m16n8k16; m16n8k8 at D=16): bins are the rows, queries the columns.
//     The codes are read with ldmatrix.trans as b16 pairs of bins, so a
//     lane gets two neighbouring bins' codes over two depths (accumulator
//     rows group and group + 8 hold bins 2 group and 2 group + 1), and
//     widened exactly to bf16 pairs with no conversion instruction: two
//     LOP3s build 128 + the low seven bits and 128 or 256 by the sign bit
//     as bf16 halves, and one bf16x2 fma subtracts them (seven instructions
//     for four codes, against eleven for byte permutes and a float32
//     magic-number subtraction). Each lane keeps the sums of its bin of
//     parity h in this CTA's ring of sums (with the scale and the validity)
//     and stores the other two into the peer's with st.async, which
//     completes on the peer's "swap-full" mbarrier.
//   - Folding warp w waits on its swap-full barrier for a stage's sums of
//     both depth halves, folds its lanes' bins over the stage's blocks in
//     ascending order, and frees the slot for both CTAs' scoring warps by
//     arrivals on their "swap-empty" barriers. Scoring and folding run on
//     separate warps, so one stage's products overlap another's fold.
//     score = (first-half sum + second-half sum) * scale: the same
//     operations for every item, so copies of one vector in one bin score
//     bit-identically and the tie rule carries over exactly.
// The fold keeps its (m1, id1, m2, id2) in registers and takes the blocks
// in ascending order: no atomics and no merge of top-2 lists. The runner-up
// depends on the order in which items reach a bin, not only on their
// values, so the block range is never split across CTAs. The kernel
// allocates nothing.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit): about
// 60 us at the served shape, 1.3 times the byte bound; its copies alone
// take about 55 us, its arithmetic alone about 49.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 32;        // bins per CTA of the grid
constexpr int kCluster = 2;      // CTAs of a cluster: one per depth half
constexpr int kPairBins = kCluster * kBins;  // bins of a cluster: a TMA row
constexpr int kGroups = 4;       // groups of 16 bins: one folding warp each
constexpr int kScorers = 2;      // scoring warps per bin group
constexpr int kThreads = 32 * (1 + (1 + kScorers) * kGroups);
constexpr int kQueriesPerCta = 8;  // query tile: the mma's N
constexpr int kBlocks = 8;       // catalog blocks per stage
constexpr int kMaxStages = 4;    // stages in the copy ring, at most
constexpr int kSlots = 4;        // stages in the ring of sums
constexpr int kMaxSmem = 232448;  // shared memory a CTA may use

// Shared memory, from a 1024-byte aligned base: kStages stages (each
// kBlocks tiles of this CTA's D/2 rows of the pair's 64 bins, 64-byte
// swizzled, then kBlocks rows of the 64 float32 scales and kBlocks rows of
// the 64 mask bytes, padded to 1024 bytes); the ring of sums (kSlots x
// four bin groups x kBlocks blocks x 32 lanes: the peer's float2 of sums,
// then this CTA's float4 of its sums, the scale and the validity); then
// the barriers: full and empty per stage, swap-full and swap-empty per slot
// and bin group.
template <int D>
struct Layout {
  static constexpr int kTileBytes = D / kCluster * kPairBins;
  static constexpr int kScaleOff = kBlocks * kTileBytes;
  static constexpr int kMaskOff = kScaleOff + kBlocks * kPairBins * 4;
  static constexpr int kStageBytes =
      (kMaskOff + kBlocks * kPairBins + 1023) / 1024 * 1024;
  static constexpr int kSlotCells = kGroups * kBlocks * 32;
  static constexpr int kFixed = kSlots * kSlotCells * (8 + 16) +
                                (2 * kMaxStages + 2 * kSlots * kGroups) *
                                    8 +
                                1024;  // + alignment
  // D=128 fits three stages
  static constexpr int kStages =
      (kMaxSmem - kFixed) / kStageBytes < kMaxStages
          ? (kMaxSmem - kFixed) / kStageBytes
          : kMaxStages;
  static constexpr int kSwap = kStages * kStageBytes;
  static constexpr int kOwn = kSwap + kSlots * kSlotCells * 8;
  static constexpr int kBars = kOwn + kSlots * kSlotCells * 16;
  static constexpr int kBytes =
      kBars + (2 * kStages + 2 * kSlots * kGroups) * 8 + 1024;
  static_assert(kStages >= 2, "shared memory too small for two stages");
  static_assert(kBytes <= kMaxSmem, "shared memory overflow");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The address of `p`'s offset in the shared memory of CTA `rank` of the
// cluster.
__device__ __forceinline__ unsigned remote_addr(const void* p,
                                                unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// Arrive on the barrier at the peer's address `bar`, with no ordering of
// this thread's earlier memory accesses: a caller that frees a buffer by it
// has used every value it read there (a release arrive, which waits for
// them to drain to cluster scope, cost about 0.35 us a stage on an H100).
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile(
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n"
      ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Wait for the phase of `bar` with this parity to complete. CTA scope is
// enough for every barrier here: data that lands on one (a TMA copy, the
// peer's st.async) is visible once its phase completes, and the peer's
// arrivals carry no data (a cluster-scope acquire would invalidate the L1
// cache at every wait). A protocol fault traps after about ten seconds
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  long long start = -1;
  while (true) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1LL << 34)) {
      __trap();
    }
  }
}

// The (64 x D/2 x kBlocks) box at (column `col`, row `row`, block `blk`) of
// the codes' 3-D tensor map into shared memory (kBlocks tiles of D/2 rows
// of 64 bytes, 64-byte swizzled), completing on `bar`'s transaction count.
__device__ __forceinline__ void tile_copy(void* smem, const CUtensorMap* map,
                                          int col, int row, int blk,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(blk),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on
// `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A float2 to the peer's address `dst`, completing 8 bytes of the
// transaction count of the peer's barrier `bar`.
__device__ __forceinline__ void store_remote(unsigned dst, unsigned bar,
                                             float2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// N (1, 2 or 4) 8x8 b16 matrices, transposed on the way into registers;
// lanes 0..8N-1 give the rows' addresses.
template <int N>
__device__ __forceinline__ void ldmatrix_trans(uint32_t* r, unsigned addr) {
  if constexpr (N == 4) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  } else if constexpr (N == 2) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
        : "=r"(r[0])
        : "r"(addr));
  }
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), float32.
__device__ __forceinline__ void mma_k16(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a (16x8 bf16, row-major) * b (8x8 bf16, column-major), float32.
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Bytes 0 and 2 of `r` (int8 codes) as a bf16 pair, exactly: each half is
// (128 + the code's low seven bits) - (128, or 256 when the sign bit is
// set), both exact bf16 values, subtracted by one fma (c * -1 + a) whose
// exact result, an integer in [-128, 127], needs no rounding. `magic`
// holds 0x43004300 (128 in both halves) in a register, so that each half
// takes one LOP3 (mask and or) with the mask as its immediate: three
// instructions for two codes.
__device__ __forceinline__ uint32_t widen_even(uint32_t r, uint32_t magic) {
  uint32_t a, c, d;
  asm("lop3.b32 %0, %1, 0x007F007F, %2, 0xEA;\n"
      : "=r"(a)
      : "r"(r), "r"(magic));
  asm("lop3.b32 %0, %1, 0x00800080, %2, 0xEA;\n"
      : "=r"(c)
      : "r"(r), "r"(magic));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(c), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// Bytes 1 and 3 of `r` as a bf16 pair: one shift more.
__device__ __forceinline__ uint32_t widen_odd(uint32_t r, uint32_t magic) {
  return widen_even(r >> 8, magic);
}

// Scoring warp (w, part). Stage s holds blocks kBlocks s..; the warp
// scores the pair's bins 16 w.. in blocks part kBlocks / kScorers.. of each
// stage over this CTA's depth half, keeps, for folding warp w, each lane's
// sums of its bin of parity H (with the scale and the validity), and stores
// the other two sums into the peer CTA.
template <int D, int H>
__device__ __forceinline__ void score(
    unsigned char* ring, uint64_t* full, uint64_t* empty, uint64_t* xfull,
    uint64_t* xempty, int w, int part, int lane, int pair0,
    const uint16_t* __restrict__ q, const uint8_t* __restrict__ mask, int B,
    int L, int nstages, int bound) {
  using Lay = Layout<D>;
  constexpr int kHalf = D / kCluster;  // depths per CTA
  constexpr int kChunks = kHalf / 8;   // its 8-depth ldmatrix matrices
  constexpr int kPerLoad = kChunks < 4 ? kChunks : 4;
  const int group = lane >> 2;  // accumulator rows group, group + 8
  const int pair = lane & 3;    // accumulator columns 2 pair, 2 pair + 1
  // B operand: query qn, depth pair (2 pair, +1) of chunk j
  uint32_t bq[kChunks];
  const int qn = blockIdx.y * kQueriesPerCta + group;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int d = H * kHalf + 8 * j + 2 * pair;
    bq[j] = qn < B ? *reinterpret_cast<const uint32_t*>(q + qn * D + d) : 0u;
  }
  const int fbin = 16 * w + 2 * group + H;  // the bin this lane keeps
  // ldmatrix row of this lane: row lane of a tile (matrix lane / 8 is
  // chunk lane / 8), 16-byte chunk w of the 64-byte row, moved by the
  // 64-byte swizzle (chunk ^= bits 7-8 of the offset, (d / 2) % 4). Each
  // further matrix lies 8 rows, 512 bytes, further, with the same bits.
  const int lm_d = lane & (8 * kPerLoad - 1);
  const unsigned lm_off = kPairBins * lm_d + 16u * (w ^ ((lm_d >> 1) & 3));
  const unsigned ring_addr = smem_addr(ring);
  const int cell0 = w * kBlocks * 32 + lane;  // this lane's cells of slot 0
  float4* own = reinterpret_cast<float4*>(ring + Lay::kOwn) + cell0;
  // the peer's swap cells of this lane, and its swap-full barriers
  const unsigned peer_swap = remote_addr(
      reinterpret_cast<float2*>(ring + Lay::kSwap) + cell0, 1 - H);
  const unsigned peer_xfull = remote_addr(xfull + w, 1 - H);
  uint32_t magic;  // 128 in both bf16 halves, opaque to the compiler
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));

  for (int s = 0; s < nstages; ++s) {
    const int st = s % Lay::kStages;
    mbar_wait(&full[st], (s / Lay::kStages) & 1);
    const unsigned char* stage = ring + st * Lay::kStageBytes;
    constexpr int kMine = kBlocks / kScorers;  // this warp's blocks
    const int k0 = part * kMine;
    uint32_t r[kMine][kChunks];
    float sc[kMine];
    bool ok[kMine];
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int k = k0 + i;
      const unsigned addr = ring_addr + st * Lay::kStageBytes +
                            k * Lay::kTileBytes + lm_off;
#pragma unroll
      for (int j = 0; j < kChunks; j += kPerLoad) {
        ldmatrix_trans<kPerLoad>(&r[i][j], addr + 8u * kPairBins * j);
      }
      sc[i] = reinterpret_cast<const float*>(stage + Lay::kScaleOff)
          [k * kPairBins + fbin];
      // blocks past the last one (a stage's tail) fail the bound
      ok[i] = (s * kBlocks + k) * L + pair0 + fbin < bound &&
              (mask == nullptr ||
               stage[Lay::kMaskOff + k * kPairBins + fbin] != 0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    float acc[kMine][4];
#pragma unroll
    for (int k = 0; k < kMine; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
      // A fragment of a 16-depth step from chunks j, j + 1: (d, d + 1) of
      // bin 2 group (row group), of bin 2 group + 1 (row group + 8), then
      // (d + 8, d + 9) of each, d = 2 pair
      if constexpr (kChunks == 1) {
        mma_k8(acc[k], widen_even(r[k][0], magic), widen_odd(r[k][0], magic),
               bq[0]);
      } else {
#pragma unroll
        for (int j = 0; j < kChunks; j += 2) {
          mma_k16(acc[k], widen_even(r[k][j], magic),
                  widen_odd(r[k][j], magic), widen_even(r[k][j + 1], magic),
                  widen_odd(r[k][j + 1], magic), bq[j], bq[j + 1]);
        }
      }
    }
    // the slot is free once both folding warps w have read what this warp
    // wrote there kSlots stages ago
    const int slot = s % kSlots;
    if (s >= kSlots) {
      mbar_wait(&xempty[slot * kGroups + w], ((s / kSlots) - 1) & 1);
    }
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int cell = slot * Lay::kSlotCells + 32 * (k0 + i);
      store_remote(peer_swap + 8 * cell, peer_xfull + 8 * slot * kGroups,
                   make_float2(acc[i][2 - 2 * H], acc[i][3 - 2 * H]));
      own[cell] = make_float4(acc[i][2 * H], acc[i][2 * H + 1], sc[i], ok[i]);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(&xfull[slot * kGroups + w], kMine * 32 * 8);
    }
  }
}

// Folding warp w: each lane folds its bin of parity H (bin 16 w + 2 group
// + H of the pair) for queries 2 pair and 2 pair + 1 over every block in
// ascending order, once the stage's sums of both depth halves are in this
// CTA, then writes its slots.
template <int D, int H>
__device__ __forceinline__ void fold(
    unsigned char* ring, uint64_t* xfull, uint64_t* xempty, int w, int lane,
    int pair0, float* __restrict__ vals, int32_t* __restrict__ ids, int B,
    int L, int nstages) {
  using Lay = Layout<D>;
  const int group = lane >> 2;
  const int pair = lane & 3;
  const int fbin = 16 * w + 2 * group + H;
  const int cell0 = w * kBlocks * 32 + lane;
  const float2* swap = reinterpret_cast<const float2*>(ring + Lay::kSwap) +
                       cell0;
  const float4* own = reinterpret_cast<const float4*>(ring + Lay::kOwn) +
                      cell0;
  const unsigned peer_xempty = remote_addr(xempty + w, 1 - H);
  float m1[2], m2[2];
  int id1[2], id2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    m1[j] = -INFINITY;
    m2[j] = -INFINITY;
    id1[j] = 0;
    id2[j] = 0;
  }
  for (int t = 0; t < nstages; ++t) {
    const int slot = t % kSlots;
    mbar_wait(&xfull[slot * kGroups + w], (t / kSlots) & 1);
#pragma unroll
    for (int k = 0; k < kBlocks; ++k) {
      const int cell = slot * Lay::kSlotCells + 32 * k;
      const float2 other = swap[cell];
      const float4 mine = own[cell];
      const int gid = (t * kBlocks + k) * L + pair0 + fbin;
      // the two depth halves' sums (float addition commutes, so both CTAs
      // compute the same bits), times the scale
      const float sum[2] = {mine.x + other.x, mine.y + other.y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sv = mine.w != 0.f ? sum[j] * mine.z : -INFINITY;
        const bool better1 = sv > m1[j];
        const float loser_v = better1 ? m1[j] : sv;
        const int loser_i = better1 ? id1[j] : gid;
        if (better1) {
          m1[j] = sv;
          id1[j] = gid;
        }
        if (loser_v > m2[j]) {
          m2[j] = loser_v;
          id2[j] = loser_i;
        }
      }
    }
    // the fold has used every value read from the slot: free it for this
    // CTA's scoring warp w and the peer's
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&xempty[slot * kGroups + w]);
      mbar_arrive_remote(peer_xempty + 8 * slot * kGroups);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = blockIdx.y * kQueriesPerCta + 2 * pair + j;
    if (qi < B) {
      const int bin = pair0 + fbin;
      const long long row = static_cast<long long>(qi) * 2 * L;
      vals[row + bin] = m1[j];
      vals[row + L + bin] = m2[j];
      ids[row + bin] = id1[j];
      ids[row + L + bin] = id2[j];
    }
  }
}

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fused_scan_int8_kernel(const __grid_constant__ CUtensorMap tile_map,
                       const uint16_t* __restrict__ q,     // (B, D) bf16 bits
                       const float* __restrict__ scales,   // (Mp,)
                       const uint8_t* __restrict__ mask,   // (Mp,) or null
                       float* __restrict__ vals,           // (B, 2L)
                       int32_t* __restrict__ ids,          // (B, 2L)
                       int B, int L, int nblk, int bound) {
  using Lay = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Lay::kBars);
  uint64_t* empty = full + Lay::kStages;
  uint64_t* xfull = empty + Lay::kStages;  // per slot and bin group
  uint64_t* xempty = xfull + kSlots * kGroups;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned rank = cluster_rank();  // this CTA's depth half
  const int pair0 = (blockIdx.x & ~(kCluster - 1)) * kBins;  // first bin
  const int nstages = (nblk + kBlocks - 1) / kBlocks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrive
      mbar_init(&empty[s], kScorers * kGroups);  // each scoring warp
    }
    for (int s = 0; s < kSlots * kGroups; ++s) {
      mbar_init(&xfull[s], kScorers);  // the scoring warps; the peer's stores
      mbar_init(&xempty[s], 2);  // the folding warps of both CTAs
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peer's stores and arrivals find the barriers set

  if (warp == 0) {
    // Producer: stage s % kStages gets blocks kBlocks s.. once the scoring
    // warps have released the stage's previous blocks: one tensor-map copy
    // of this CTA's rows of their tiles (past the catalog's last block the
    // box reads zeros), and the pair's scales and mask bytes of the blocks
    // below nblk.
    if (lane == 0) {
      const int row0 = static_cast<int>(rank) * (D / kCluster);
      for (int s = 0; s < nstages; ++s) {
        const int st = s % Lay::kStages;
        if (s >= Lay::kStages) {
          mbar_wait(&empty[st], ((s / Lay::kStages) - 1) & 1);
        }
        unsigned char* stage = ring + st * Lay::kStageBytes;
        const int b0 = s * kBlocks;
        const int nb = nblk - b0 < kBlocks ? nblk - b0 : kBlocks;
        mbar_arrive_expect_tx(
            &full[st], kBlocks * Lay::kTileBytes +
                           nb * kPairBins * (4 + (mask != nullptr ? 1 : 0)));
        tile_copy(stage, &tile_map, pair0, row0, b0, &full[st]);
        for (int k = 0; k < nb; ++k) {
          const int col = (b0 + k) * L + pair0;
          bulk_copy(stage + Lay::kScaleOff + k * kPairBins * 4, scales + col,
                    kPairBins * 4, &full[st]);
          if (mask != nullptr) {
            bulk_copy(stage + Lay::kMaskOff + k * kPairBins, mask + col,
                      kPairBins, &full[st]);
          }
        }
      }
    }
  } else if (warp <= kScorers * kGroups) {
    // scoring warp: bin group (warp - 1) % 4, blocks (warp - 1) / 4 of a
    // stage's halves
    const int w = (warp - 1) % kGroups;
    const int part = (warp - 1) / kGroups;
    if (rank == 0) {
      score<D, 0>(ring, full, empty, xfull, xempty, w, part, lane, pair0, q,
                  mask, B, L, nstages, bound);
    } else {
      score<D, 1>(ring, full, empty, xfull, xempty, w, part, lane, pair0, q,
                  mask, B, L, nstages, bound);
    }
  } else {
    const int w = warp - 1 - kScorers * kGroups;
    if (rank == 0) {
      fold<D, 0>(ring, xfull, xempty, w, lane, pair0, vals, ids, B, L,
                 nstages);
    } else {
      fold<D, 1>(ring, xfull, xempty, w, lane, pair0, vals, ids, B, L,
                 nstages);
    }
  }
  // no CTA leaves while its peer may still store to it or arrive on it
  cluster_sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The codes (D, Mp) int8 as a 3-D tensor map (bin within a block, depth,
// block) whose box is one CTA's D/2 rows of a pair's 64 bins in kBlocks
// consecutive blocks, written to shared memory in 64-byte swizzled rows.
// cuTensorMapEncodeTiled is looked up with cudaGetDriverEntryPoint, so
// nothing links libcuda.
cudaError_t tile_map(CUtensorMap* map, const void* codes, int D,
                     long long Mp, int L) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Mp / L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Mp),
                                 static_cast<cuuint64_t>(L)};
  const cuuint32_t box[3] = {kPairBins, static_cast<cuuint32_t>(D / kCluster),
                             kBlocks};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* codes, const void* scales,
                   const void* mask, void* vals, void* ids, int B,
                   long long Mp, int L, int nblk, int bound,
                   cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kBytes;
  CUtensorMap map;
  cudaError_t err = tile_map(&map, codes, D, Mp, L);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_scan_int8_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(L / kBins, (B + kQueriesPerCta - 1) / kQueriesPerCta);
  fused_scan_int8_kernel<D><<<grid, kThreads, bytes, stream>>>(
      map, static_cast<const uint16_t*>(q), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(mask), static_cast<float*>(vals),
      static_cast<int32_t*>(ids), B, L, nblk, bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch
// was accepted. Preconditions (checked by the wrapper): B >= 1, D in
// {16, 32, 64, 128}, L a multiple of 128, Mp a multiple of L and below
// 2^31, 16-byte aligned codes, scales and mask, 4-byte aligned q (read as
// bf16 pairs), nblk = ceil(bound / L) <= Mp / L.
int esr_fused_scan_int8(int device, const void* q, const void* codes,
                        const void* scales, const void* mask, void* vals,
                        void* ids, int B, int D, long long Mp, int L,
                        int nblk, int bound, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scales == nullptr || B < 1 || L % kPairBins != 0 || Mp % L != 0 ||
      Mp > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: err = launch<16>(q, codes, scales, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 32: err = launch<32>(q, codes, scales, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 64: err = launch<64>(q, codes, scales, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 128: err = launch<128>(q, codes, scales, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
