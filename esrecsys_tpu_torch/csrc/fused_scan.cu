// Fused MIPS scan+select for Hopper (sm_90a), over a bf16 catalog.
//
// Replaces the bf16 branch of the Pallas TPU kernel `_kernel` of
// esrecsys_tpu/retrieval/fused.py, launched there by `binned_candidates`
// (its int8 branch: csrc/fused_scan_int8.cu). It computes the same
// function: for each query and catalog item g below `bound` (and eligible
// under the optional mask), score = q . item_g with bf16 inputs and float32
// accumulation; item g falls in bin g mod L, and each bin keeps its top two
// (value, id) pairs, folded over the catalog blocks in ascending order with
// a strict `>`, so the earlier block wins ties. Slots never filled keep
// (-inf, 0). Output: vals (B, 2L) float32 and ids (B, 2L) int32, the first
// L columns holding each bin's best, the next L its runner-up.
//
// What bounds it: bytes. One pass over the catalog at D=64 and
// Mp=2,265,088 moves 290 MB, 87 us at the H100 SXM's published 3.35 TB/s.
// The 2*B*D operations per item are far below the tensor cores' rate, so
// the catalog must be read once for as many queries as possible.
//
// Design. A CTA owns a bin tile of 32 bins for one tile of 8 queries. The
// CTAs that share a bin tile and hold different query tiles form a
// thread-block cluster of c = min(8, ceil(B/8)) CTAs along the query axis:
// the grid is (ceil(ceil(B/8)/c) c query tiles) x (L/32 bin tiles), query
// tiles fastest, so the clusters of one bin tile run side by side and the
// later ones find its blocks in the L2 cache (kernels/fused_scan.py
// `launch_plan`).
//   - One pass over the catalog per cluster of up to 64 queries. A stage of
//     the copy ring holds eight consecutive catalog blocks: eight (D x 32)
//     bf16 tiles, each written by a 2-D TMA copy of the items' tensor map
//     with the 64-byte swizzle (64-byte rows, whose 16-byte chunks move by
//     bits 7-8 of the row's offset, so the eight rows an ldmatrix phase
//     reads fall in distinct banks), and the blocks' 32 mask bytes by bulk
//     copies. Each copy is multicast to every CTA of the cluster: CTA r's
//     producer warp starts the copies of the stage's blocks r, r + c, ...,
//     so the cluster reads each block once and each CTA receives all of
//     it. Copying whole blocks instead of 1/c of every tile's rows keeps the
//     layout of a stage the same at every c and D. B > 64 takes further
//     clusters along the query axis, each reading the catalog once; B <= 8
//     is c = 1, one pass on L/32 CTAs as before.
//   - A stage is refilled only after every scoring warp of every CTA of the
//     cluster has released it: each CTA's "empty" barrier counts 4 c
//     arrivals, which lane r of each scoring warp makes on CTA r's barrier
//     through mapa with a relaxed cluster-scope arrive, once the stage's
//     scores are stored (so every value it read there has been used). Each
//     CTA's "full" barrier expects the bytes of the whole stage, from all c
//     CTAs' copies; a peer's bytes may land before this CTA's producer arms
//     it (the transaction count may go below zero). CTAs of the last
//     cluster that hold no query (B = 65, 200, ...) start their copies and
//     arrive like the others and write nothing.
//   - Four scoring warps, (bin half h, block parity e): each scores its 16
//     bins against the 8 queries in the stage's blocks of parity e with
//     tensor-core mma.sync m16n8k16 (bins are the rows, queries the
//     columns, d the depth): the queries sit in registers as the B operand
//     for the whole scan, the tiles are read as the A operand with
//     ldmatrix.trans, which turns the (D, Mp) layout into row-major (bin, d)
//     fragments, and even and odd depth steps sum in two chains added as
//     ca + cb. The bound and the mask turn a score into -inf without a
//     branch, so a warp's four blocks interleave. Two warps per half put the
//     mma.sync work of a block on all four SM sub-partitions.
//   - Four folding warps per bin half, a (bin, query) slot a lane, take a
//     stage's scores of their half from shared memory (named barriers
//     "ready" and "free" with the half's two scoring warps) and fold them.
// The fold is sequential and stays in one thread: each folding lane keeps
// the running (m1, id1, m2, id2) of its slot in registers and folds every
// block of the catalog into it in ascending order, with
// selects and no branch. No CTA folds only part of a bin's block range,
// and there is no merge of top-2 lists and no atomics: the runner-up
// depends on the order in which items reach a bin, not only on their
// values (v@0, v@1, 2v@2 folds to (2v@2, v@1), a merge of per-range top-2
// lists to (2v@2, v@0)). An item's score is the same computation wherever
// its block lies, and the same as the previous design's (the same
// ldmatrix, mma.sync and ca + cb), so copies of one vector in one bin score
// bit-identically and the tie rule carries over exactly. A protocol fault
// on a copy barrier traps after about ten seconds instead of hanging the
// card. The kernel allocates nothing.
//
// Measured (chip_smoke.py over a 2,262,292 x 64 catalog, NVIDIA H100 80GB
// HBM3 at a 700.00 W limit; the previous design, one CTA row of 8 queries
// a catalog pass with cp.async copies, timed in the same call): B=8 at
// L=4096 0.1356 ms (before 0.1379-0.1400), 0.64 of bound speed; B=64
// 0.3601, 0.2242 and 0.2376 ms at L=512, 4096 and 8192 (before
// 1.0298-1.0371, 0.8193-0.8367 and 0.8570-0.8599), 0.24-0.39 of bound
// speed; B=256 0.9084, 0.8039 and 0.8432 ms (before 2.75, 3.25-3.33 and
// 4.19-4.20). At L=512 and B=64 some of the 16 clusters of eight must
// share SMs (one CTA an SM holds too few of them at once), the likely
// reason that shape stays above 0.35 ms.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHalves = 2;       // bin halves of a CTA: one mma M each
constexpr int kScorers = 4;      // scoring warps: two per bin half
constexpr int kFolders = 4;      // folding warps per bin half: a slot a lane
constexpr int kThreads = 32 * (1 + kScorers + kHalves * kFolders);
constexpr int kBins = 16 * kHalves;   // bins per CTA
constexpr int kQueriesPerCta = 8;     // query tile: the mma's N
constexpr int kMaxCluster = 8;   // CTAs of a cluster, at most (portable)
constexpr int kBlocks = 8;       // catalog blocks per stage
constexpr int kRowBytes = kBins * 2;    // a tile row: 64 bytes, swizzled
constexpr int kMaskBytes = kBlocks * kBins;  // a stage's mask bytes
constexpr int kMaxStages = 3;    // stages in the copy ring, at most
// a bin half's scores of a stage: per folder, a float per block and lane
constexpr int kHalfScoreBytes = kFolders * kBlocks * 32 * 4;
constexpr int kMaxSmem = 232448;  // shared memory a CTA may use

// Shared memory, from a 1024-byte aligned base: kStages stages of kBlocks
// tiles of D rows of 64 bytes (64-byte swizzled), kStages rows of the
// stages' mask bytes, each bin half's scores of one stage, then the full
// and empty barriers. At D=64 a CTA takes 106 KB, so two share an SM: at
// one CTA an SM an H100 cannot hold the 16 clusters of eight that L=512
// needs at B=64 at once, and they would take two waves.
template <int D>
struct Layout {
  static constexpr int kTileBytes = D * kRowBytes;  // a multiple of 1024
  static constexpr int kStageBytes = kBlocks * kTileBytes;
  static constexpr int kScores = kHalves * kHalfScoreBytes;
  static constexpr int kFit = (kMaxSmem - 1024 - kScores) /
                              (kStageBytes + kMaskBytes + 16);
  // three stages at every D (at D=128 one CTA takes an SM)
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kMasks = kStages * kStageBytes;
  static constexpr int kScoreOff = kMasks + kStages * kMaskBytes;
  static constexpr int kBars = kScoreOff + kScores;
  static constexpr int kBytes = kBars + kStages * 16 + 1024;  // + alignment
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

// Arrive on the barrier at the cluster address `bar`, with no ordering of
// this thread's earlier memory accesses: a caller that frees a stage by it
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

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Named barrier `id` of `threads` threads: wait for all of them, or arrive
// without waiting. Either orders this thread's earlier shared-memory
// accesses before the barrier for every thread that waits on it.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. CTA scope is
// enough: the copies that land on "full" are visible once its phase
// completes, and the arrivals on "empty" carry no data. A protocol fault
// traps after about ten seconds instead of hanging the card.
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

// The (32 x D) box at column `col` of the items' 2-D tensor map into shared
// memory (D rows of 64 bytes, 64-byte swizzled) of every CTA in `ctas` (a
// bit per cluster rank), completing on each one's barrier at `bar`'s
// offset.
__device__ __forceinline__ void tile_copy(void* smem, const CUtensorMap* map,
                                          int col, uint64_t* bar,
                                          uint16_t ctas) {
  if (ctas == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(smem)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0),
        "r"(smem_addr(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(smem_addr(smem)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0),
        "r"(smem_addr(bar)), "h"(ctas)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global memory into the shared memory of
// every CTA in `ctas`, completing on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar,
                                          uint16_t ctas) {
  if (ctas == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
        "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
            smem_addr(smem)),
        "l"(gmem), "r"(bytes), "r"(smem_addr(bar)), "h"(ctas)
        : "memory");
  }
}

// Four 8x8 bf16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Named barriers of bin half h between its two scoring and four folding
// warps: "ready" when the stage's scores are in, "free" when the folders
// have copied them out (barrier 0 is left to __syncthreads). One stage of
// scores is enough: a folder copies its scores to registers at once and
// folds them while the scorers score the next stage.
constexpr int kHalfThreads = 32 * (kScorers / kHalves + kFolders);
__device__ __forceinline__ int ready_bar(int h) { return 1 + 2 * h; }
__device__ __forceinline__ int free_bar(int h) { return 2 + 2 * h; }

// Scoring warp (h, e): for each stage, the float32 scores of bins 16 h..
// of the CTA's tile against its query tile in the stage's blocks of
// parity e (two independent mma chains, even and odd depth steps, summed:
// the same operations for every block), -inf under the mask or past the
// bound, into its half's scores, accumulator slot f's float for folder f
// per block and lane; then it releases the stage on every CTA of the
// cluster.
template <int D, bool kMasked>
__device__ __forceinline__ void score(
    unsigned char* ring, uint64_t* full, uint64_t* empty, int h, int e,
    int lane, unsigned ncta, const uint16_t* __restrict__ q, int B, int L,
    int nblk, int bound) {
  using Lay = Layout<D>;
  constexpr int kSteps = D / 16;
  constexpr int kMine = kBlocks / 2;  // this warp's blocks of a stage
  const int group = lane >> 2;  // accumulator rows group, group + 8
  const int pair = lane & 3;    // accumulator columns 2 pair, 2 pair + 1
  const int bin0 = blockIdx.y * kBins;
  const int rbin = 16 * h + group;  // the bins of rows group and group + 8
  // B operand: query 8 x + group, depth pairs (2 pair, +1), (+8, +9)
  uint32_t bfrag[kSteps][2];
  const int qn = blockIdx.x * kQueriesPerCta + group;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = k * 16 + i * 8 + 2 * pair;
      bfrag[k][i] =
          qn < B ? *reinterpret_cast<const uint32_t*>(q + qn * D + d) : 0u;
    }
  }
  // ldmatrix row of this lane in a tile: matrix lane / 8 covers bins
  // 8 ((lane / 8) % 2).. and depths 8 (lane / 16).. of a 16x16 step, so
  // the row is depth lm_d of the step and its 16-byte chunk is the bins'
  // (2 h + (lane / 8) % 2), moved by the swizzle (chunk ^= bits 7-8 of the
  // row's offset, (d / 2) % 4; a step is 16 rows, 1024 bytes, and leaves
  // those bits alone)
  const int lm_d = (lane & 7) + 8 * (lane >> 4);
  const int chunk = 2 * h + ((lane >> 3) & 1);
  const unsigned lm_off = smem_addr(ring) + e * Lay::kTileBytes +
                          lm_d * kRowBytes +
                          ((chunk ^ ((lm_d >> 1) & 3)) << 4);
  float* scores = reinterpret_cast<float*>(ring + Lay::kScoreOff) +
                  h * (kHalfScoreBytes / 4) + e * 32 + lane;
  // lane r < c releases stages on CTA r's empty barriers
  const unsigned peer_empty =
      lane < static_cast<int>(ncta) ? remote_addr(empty, lane) : 0u;
  // Row r of block b is valid when b < nblk - 1, or b = nblk - 1 and its
  // item is below the bound: the valid blocks of row lo (hi) in stage s
  // are those below nblk - 1 - s kBlocks + last_lo (last_hi). A compare
  // per block and row, no branch, so the blocks' products interleave.
  const int last_gid = (nblk - 1) * L + bin0 + rbin;
  const int last_lo = last_gid < bound ? 1 : 0;
  const int last_hi = last_gid + 8 < bound ? 1 : 0;
  const int nstages = (nblk + kBlocks - 1) / kBlocks;
  for (int s = 0; s < nstages; ++s) {
    const int st = s % Lay::kStages;
    mbar_wait(&full[st], (s / Lay::kStages) & 1);
    const int b0 = s * kBlocks;
    const int valid_lo = nblk - 1 - b0 + last_lo;
    const int valid_hi = nblk - 1 - b0 + last_hi;
    const unsigned stage = lm_off + st * Lay::kStageBytes;
    const uint8_t* smask = ring + Lay::kMasks + st * kMaskBytes;
    float sc[kMine][4];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int k = 2 * m + e;  // the block within the stage
      uint32_t a[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        ldmatrix_x4_trans(a[j], stage + 2 * m * Lay::kTileBytes +
                                    j * 16 * kRowBytes);
      }
      float ca[4] = {0.f, 0.f, 0.f, 0.f};
      float cb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        mma_bf16(j % 2 == 0 ? ca : cb, a[j], bfrag[j]);
      }
      // the tiles past the last block (the last stage's tail) were never
      // copied: their scores are -inf, which folds as a no-op
      bool ok_lo = k < valid_lo, ok_hi = k < valid_hi;
      if (kMasked) {
        ok_lo = ok_lo && smask[k * kBins + rbin] != 0;
        ok_hi = ok_hi && smask[k * kBins + rbin + 8] != 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[m][i] = (i < 2 ? ok_lo : ok_hi) ? ca[i] + cb[i] : -INFINITY;
      }
    }
    if (s > 0) named_sync(free_bar(h), kHalfThreads);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
#pragma unroll
      for (int f = 0; f < kFolders; ++f) {
        scores[(f * kBlocks + 2 * m) * 32] = sc[m][f];
      }
    }
    named_arrive(ready_bar(h), kHalfThreads);
    // every value read from the stage has been used (the stores above hold
    // all of them): release it on every CTA of the cluster
    __syncwarp();
    if (lane < static_cast<int>(ncta)) mbar_arrive_remote(peer_empty + 8 * st);
  }
  // take the folders' last release, so no barrier is left half arrived
  if (nstages > 0) named_sync(free_bar(h), kHalfThreads);
}

// Folding warp f of bin half h: each lane keeps the running top two
// (m1, id1, m2, id2) of accumulator slot f (bin 16 h + group + 8 (f / 2),
// query 8 x + 2 pair + f % 2) in registers and folds every block of the
// catalog into it in ascending order, with the kernel's tie rule: a strict
// `>`, so the earlier block wins ties, and the loser of the first
// comparison goes on to the runner-up's (selects, no branches). Then it
// writes its slot.
template <int D>
__device__ __forceinline__ void fold(unsigned char* ring, int h, int f,
                                     int lane, float* __restrict__ vals,
                                     int32_t* __restrict__ ids, int B, int L,
                                     int nblk) {
  using Lay = Layout<D>;
  const int bin = blockIdx.y * kBins + 16 * h + (lane >> 2) + 8 * (f >> 1);
  const int qi = blockIdx.x * kQueriesPerCta + 2 * (lane & 3) + (f & 1);
  const float* scores = reinterpret_cast<const float*>(ring + Lay::kScoreOff) +
                        h * (kHalfScoreBytes / 4) + f * kBlocks * 32 + lane;
  float m1 = -INFINITY, m2 = -INFINITY;
  int id1 = 0, id2 = 0;
  const int nstages = (nblk + kBlocks - 1) / kBlocks;
  for (int s = 0; s < nstages; ++s) {
    named_sync(ready_bar(h), kHalfThreads);
    float v[kBlocks];
#pragma unroll
    for (int k = 0; k < kBlocks; ++k) v[k] = scores[k * 32];
    named_arrive(free_bar(h), kHalfThreads);
    // every block of the stage, with no branch: the last stage's tail
    // scores -inf, which moves no slot (its ids, computed modulo 2^32,
    // are never kept)
#pragma unroll
    for (int k = 0; k < kBlocks; ++k) {
      const int gid =
          static_cast<int>(static_cast<unsigned>(s * kBlocks + k) * L + bin);
      const bool better1 = v[k] > m1;
      const float loser_v = better1 ? m1 : v[k];
      const int loser_i = better1 ? id1 : gid;
      m1 = better1 ? v[k] : m1;
      id1 = better1 ? gid : id1;
      const bool better2 = loser_v > m2;
      m2 = better2 ? loser_v : m2;
      id2 = better2 ? loser_i : id2;
    }
  }
  if (qi < B) {
    const long long row = static_cast<long long>(qi) * 2 * L;
    vals[row + bin] = m1;
    vals[row + L + bin] = m2;
    ids[row + bin] = id1;
    ids[row + L + bin] = id2;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM
fused_scan_kernel(const __grid_constant__ CUtensorMap tile_map,
                  const uint16_t* __restrict__ q,      // (B, D) bf16 bits
                  const uint8_t* __restrict__ mask,    // (Mp,) or null
                  float* __restrict__ vals,            // (B, 2L)
                  int32_t* __restrict__ ids,           // (B, 2L)
                  int B, int L, int nblk, int bound) {
  using Lay = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Lay::kBars);
  uint64_t* empty = full + Lay::kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned rank = cluster_rank();
  const unsigned ncta = cluster_size();
  const int bin0 = blockIdx.y * kBins;
  const int nstages = (nblk + kBlocks - 1) / kBlocks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&full[s], 1);  // this CTA's producer arms it
      mbar_init(&empty[s], kScorers * ncta);  // each scoring warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' copies and arrivals find the barriers set

  if (warp == 0) {
    // Producer: stage s % kStages gets blocks kBlocks s.. once every
    // consumer warp of the cluster has released the stage's previous
    // blocks. This CTA arms its "full" barrier for the whole stage and
    // copies blocks rank, rank + c, ... of it to every CTA of the cluster.
    if (lane == 0) {
      const uint16_t ctas = static_cast<uint16_t>((1u << ncta) - 1);
      for (int s = 0; s < nstages; ++s) {
        const int st = s % Lay::kStages;
        if (s >= Lay::kStages) {
          mbar_wait(&empty[st], ((s / Lay::kStages) - 1) & 1);
        }
        const int b0 = s * kBlocks;
        const int nb = nblk - b0 < kBlocks ? nblk - b0 : kBlocks;
        mbar_arrive_expect_tx(
            &full[st],
            nb * (Lay::kTileBytes + (mask != nullptr ? kBins : 0)));
        for (int k = static_cast<int>(rank); k < nb; k += ncta) {
          const int col = (b0 + k) * L + bin0;
          tile_copy(ring + st * Lay::kStageBytes + k * Lay::kTileBytes,
                    &tile_map, col, &full[st], ctas);
          if (mask != nullptr) {
            bulk_copy(ring + Lay::kMasks + st * kMaskBytes + k * kBins,
                      mask + col, kBins, &full[st], ctas);
          }
        }
      }
    }
  } else if (warp <= kScorers) {
    // scoring warp (h, e) = ((warp - 1) % 2, (warp - 1) / 2)
    const int h = (warp - 1) % kHalves, e = (warp - 1) / kHalves;
    if (mask != nullptr) {
      score<D, true>(ring, full, empty, h, e, lane, ncta, q, B, L, nblk,
                     bound);
    } else {
      score<D, false>(ring, full, empty, h, e, lane, ncta, q, B, L, nblk,
                      bound);
    }
  } else {
    // folding warp (h, f) = (g % 2, g / 2)
    const int g = warp - 1 - kScorers;
    fold<D>(ring, g % kHalves, g / kHalves, lane, vals, ids, B, L, nblk);
  }
  // no CTA leaves while a peer may still copy into it or arrive on it
  cluster_sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The items (D, Mp) bf16 as a 2-D tensor map (column, depth) whose box is
// one block's (32 x D) tile of a bin tile, written to shared memory in
// 64-byte swizzled rows. cuTensorMapEncodeTiled is looked up with
// cudaGetDriverEntryPoint, so nothing links libcuda.
cudaError_t tile_map(CUtensorMap* map, const void* items, int D,
                     long long Mp) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Mp),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Mp) * 2};
  const cuuint32_t box[2] = {kBins, static_cast<cuuint32_t>(D)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, const_cast<void*>(items), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* items, const void* mask,
                   void* vals, void* ids, int B, long long Mp, int L,
                   int nblk, int bound, int cluster, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kBytes;
  CUtensorMap map;
  cudaError_t err = tile_map(&map, items, D, Mp);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_scan_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (B + kQueriesPerCta - 1) / kQueriesPerCta;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + cluster - 1) / cluster * cluster, L / kBins, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot hold at once is refused here, not run
  static int fits[kMaxCluster + 1] = {0};
  if (fits[cluster] == 0) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fused_scan_kernel<D>, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    fits[cluster] = active;
  }
  err = cudaLaunchKernelEx(&cfg, fused_scan_kernel<D>, map,
                           static_cast<const uint16_t*>(q),
                           static_cast<const uint8_t*>(mask),
                           static_cast<float*>(vals),
                           static_cast<int32_t*>(ids), B, L, nblk, bound);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch
// was accepted. Preconditions (checked by the wrapper): B >= 1, D in
// {16, 32, 64, 128}, L a multiple of 128, Mp a multiple of L and below
// 2^31, 16-byte aligned items and mask, 4-byte aligned q (read as bf16
// pairs), nblk = ceil(bound / L) <= Mp / L, 1 <= cluster <= min(8,
// ceil(B / 8)) (kernels/fused_scan.py `launch_plan`).
int esr_fused_scan(int device, const void* q, const void* items,
                   const void* mask, void* vals, void* ids, int B, int D,
                   long long Mp, int L, int nblk, int bound, int cluster,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + kQueriesPerCta - 1) / kQueriesPerCta;
  if (B < 1 || L < kBins || L % kBins != 0 || L / kBins > 65535 ||
      Mp % L != 0 || Mp > INT_MAX || nblk < 0 || nblk > Mp / L ||
      cluster < 1 || cluster > kMaxCluster || cluster > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: err = launch<16>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, cluster, s); break;
    case 32: err = launch<32>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, cluster, s); break;
    case 64: err = launch<64>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, cluster, s); break;
    case 128: err = launch<128>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, cluster, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
