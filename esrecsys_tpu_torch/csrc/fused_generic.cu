// Fused scan+select and fused playlist affinity for Hopper (sm_90a) at any
// embedding width D and any number of context slots C.
//
// The tuned kernels (fused_scan.cu, fused_scan_int8.cu, fused_affinity.cu)
// are instantiated for D in {16, 32, 64, 128} (the affinity for D in
// {32, 64, 128} with C <= 8); the TPU kernels they replace take any D and C
// within a VMEM budget. This file runs every other shape. Its three entry
// points compute the same functions as:
//   - esr_fused_scan_generic: the bf16 branch of the Pallas kernel `_kernel`
//     of esrecsys_tpu/retrieval/fused.py:191 (launched at :344 by
//     `binned_candidates`): for each query and catalog item g below `bound`
//     that the optional mask admits, score = q . item_g, bf16 inputs and
//     float32 sums;
//   - esr_fused_scan_int8_generic: its int8 branch (:212-225): the codes
//     widen exactly to bf16 (|v| <= 127) and the item's float32 scale
//     multiplies the whole D-sum, after the last depth chunk;
//   - esr_fused_affinity_generic: `_affinity_kernel` (:453, launched at
//     :575 by `binned_affinity_candidates`): score = max over all C slots of
//     the full-depth dots, then + 0.1 [album_g in album_ctx[b]], then
//     + 0.1 [artist_g in artist_ctx[b]], in float32, in that order.
// Item g falls in bin g mod L and each bin keeps its top two (value, id)
// pairs, folded over the catalog blocks in ascending order with a strict
// `>` (the earlier block wins ties; slots never filled keep (-inf, 0)).
// Items at or past `bound`, or masked out, score -inf by a select. Output:
// vals (B, 2L) float32 and ids (B, 2L) int32, the first L columns each
// bin's best, the next L its runner-up.
//
// What bounds it: bytes for the scans at serving batches (the catalog read
// once: 1.16 GB at 2,262,292 x 256 bf16, 0.35 ms at the H100 SXM's 3.35
// TB/s), operations for the affinity at the eval batch (2 B C D M = 1.19e13
// bf16 operations at B=2048, C=5, D=256: 12 ms at 989 TFLOP/s).
//
// Design, simple first. The grid is (query tiles) x (L / 16W bin tiles), W
// warps a CTA (8 for the affinity, 4 for the scans, halved down to 2 while
// that leaves fewer than 132 CTAs or the ring does not fit); query tiles
// vary fastest, so the CTAs of one bin tile run side by side and share each
// catalog tile through the L2 cache. A CTA owns 16W bins for 8 NQ queries
// (NQ = 1 for B <= 8, 4 above; the affinity 2) and walks the catalog blocks
// in ascending order; warp w owns bins 16 w.. of the tile.
//   - Copies. The depth runs in chunks of KC rows (256 for the scans, 64
//     for the affinity): per chunk one thread copies the (KC x 16W)
//     catalog tile and the matching (rows x KC) query tile into a ring of S
//     shared-memory stages, by TMA tensor-map copies (boxes of at most 128
//     bytes a row) completing on the stage's mbarrier, so no shared-memory
//     budget grows with D or C. A copy that overhangs row D (or the batch,
//     or the slots) fills with zeros, so the (D, Mp) catalog is read as it
//     lies; the wrapper pads the queries to Dq = ceil16(D) zero columns, and
//     a chunk runs only its k16 steps below Dq. When one chunk holds the
//     whole depth (and one pass all the slots) the query tile is copied
//     once. Tiles land 32-, 64- or 128-byte swizzled, so the ldmatrix reads
//     of eight rows meet no bank conflict.
//   - Products: mma.sync m16n8k16, bins as the rows (A from the catalog
//     tile by ldmatrix.trans), queries as the columns (B by ldmatrix),
//     accumulating in float32 registers across the chunks of a block; the
//     scans keep two sums, of the even and the odd k16 steps, for two
//     independent chains. An int8 tile is read as b16 pairs of bins and
//     widened exactly to bf16 in registers (fused_scan_int8.cu's widening),
//     so its accumulator rows hold bins 2 group and 2 group + 1. The
//     affinity's columns are (slot, query) pairs, G = 8 slots a pass; with
//     C > 8 the block's chunks run once per group of 8 slots, and a running
//     max over the slots stays in registers; the tiles of slots at or past
//     C are multiplied too (no branch in the loop) and left out of the max.
//   - Fold. After the last chunk of a block each thread folds the (bin,
//     query) slots its accumulator holds, sequentially over the blocks with
//     the strict `>`, in registers: each slot's fold is one thread's loop.
//     The fold's per-item inputs (mask, scale, album, artist) are loaded a
//     block ahead.
// Every item's score is the same instruction sequence wherever its block
// lies (same chunk order, same k16 order), so copies of one vector score
// bit-identically and the tie rule carries over exactly. The kernel
// allocates nothing.
//
// What the versions before this one taught (chip_smoke.py's check_generic
// and wide phase, NVIDIA H100 80GB HBM3 at 700 W; B=8 over 2,262,292 x 256
// at L=4096): one bulk copy a row held the scan to 6.30 ms (each small bulk
// copy costs the copy engine about as much as a box); 64-row TMA boxes
// 1.00-1.24 ms; 256-row chunks 0.69 ms; the query tile copied once 0.65 ms. The
// int8 scan widened through a shared tile took 1.48 ms, in registers 0.94.
// The affinity (B=2048, C=5) took 447 ms with bulk copies, 141-146 ms with
// TMA, 97 ms with no branch in its product loop, 83 ms at two CTAs an SM.
// ptxas: the scans 52-141 registers, the affinity 128, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQBox = 64;       // query columns of a TMA box: 128 bytes
constexpr int kWarpBins = 16;   // bins a warp: the mma's M
constexpr int kSlotGroup = 8;   // affinity: context slots a pass (G)
constexpr int kMaxWarps = 8;    // the affinity's; the scans take 4
constexpr int kMaxSmem = 232448;

struct Params {
  const void* items;        // (D, Mp) bf16 or int8
  const float* scales;      // int8: (Mp,)
  const uint8_t* mask;      // (Mp,) or null
  const int32_t* album;     // affinity: (Mp,)
  const int32_t* artist;    // affinity: (Mp,)
  const int32_t* album_ctx;   // affinity: (B, C)
  const int32_t* artist_ctx;  // affinity: (B, C)
  float* vals;              // (B, 2L)
  int32_t* ids;             // (B, 2L)
  int B, C, D, Dq;
  long long Mp;
  int L, nblk, bound;
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

// Wait for the phase of `bar` with this parity to complete. A protocol
// fault traps after about ten seconds instead of hanging the card.
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

// The box at coordinates {c0, c1[, c2]} of a tensor map into shared
// memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void tile_copy(void* smem, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tile_copy(void* smem, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// The byte at logical offset `o` of a tile of `row_bytes`-byte rows (32, 64
// or 128) written with the matching TMA swizzle: 16-byte chunk bits 4.. of
// the offset XOR its bits 7.. (CUTLASS's Swizzle<log2(row_bytes / 16), 4,
// 3>), from a base aligned to 1024 bytes.
__host__ __device__ __forceinline__ unsigned swizzle(unsigned o,
                                                     unsigned row_bytes) {
  return o ^ (((o >> 7) & (row_bytes / 16 - 1)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), float32.
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 0 and 2 of `r` (int8 codes) as a bf16 pair, exactly: each half is
// (128 + the code's low seven bits) - (128, or 256 when the sign bit is
// set), both exact bf16 values, subtracted by one fma (c * -1 + a) whose
// exact result, an integer in [-128, 127], needs no rounding. `magic`
// holds 0x43004300 (128 in both halves). (fused_scan_int8.cu's widening.)
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

// Bytes 1 and 3 of `r` as a bf16 pair.
__device__ __forceinline__ uint32_t widen_odd(uint32_t r, uint32_t magic) {
  return widen_even(r >> 8, magic);
}

// The fold of one (bin, query) slot: the reference's two strict compares.
__device__ __forceinline__ void fold(float s, int gid, float& m1, int& id1,
                                     float& m2, int& id2) {
  const bool better1 = s > m1;
  const float loser_v = better1 ? m1 : s;
  const int loser_i = better1 ? id1 : gid;
  m1 = better1 ? s : m1;
  id1 = better1 ? gid : id1;
  const bool better2 = loser_v > m2;
  m2 = better2 ? loser_v : m2;
  id2 = better2 ? loser_i : id2;
}

// Shared-memory geometry of one launch, from a 1024-byte aligned base: S
// stages, each the catalog tile (chunk rows of 16W bf16 or int8, as TMA
// writes it, swizzled, in boxes of at most 128 bytes a row) then the query
// tile (8 NQ G rows of chunk bf16, in boxes of 64 columns, 128-byte
// swizzled); then one mbarrier a stage.
struct Geometry {
  int bins;        // 16W: bins of the CTA's tile
  int sub_bins;    // bins of one TMA box: at most 128 bytes of a row
  int cat_bytes;   // the catalog tile in a stage
  int q_bytes;     // the query tile
  int stage_bytes;
  int bars_off;    // the stages' "full" mbarriers
  int bytes;       // the total, with the base's alignment
};

__host__ __device__ inline Geometry geometry(int warps, bool int8, int rows,
                                             int stages, int chunk) {
  Geometry g;
  g.bins = kWarpBins * warps;
  g.sub_bins = int8 || g.bins <= 64 ? g.bins : 64;
  g.cat_bytes = chunk * g.bins * (int8 ? 1 : 2);
  g.q_bytes = rows * chunk * 2;
  g.stage_bytes = (g.cat_bytes + g.q_bytes + 1023) / 1024 * 1024;
  g.bars_off = stages * g.stage_bytes;
  g.bytes = g.bars_off + stages * 8 + 1024;
  return g;
}

// The kernel. kInt8: the catalog is int8 codes with per-item scales. kAff:
// the affinity (G = kSlotGroup slots a pass, boosts); otherwise a scan
// (G = 1). NQ: query n-tiles of 8 a warp. S: stages of the copy ring.
template <bool kInt8, bool kAff, int NQ, int S, int KC>
__global__ void __launch_bounds__(32 * kMaxWarps, kAff ? 2 : 1)
fused_generic_kernel(const __grid_constant__ CUtensorMap cat_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const Params p) {
  constexpr int G = kAff ? kSlotGroup : 1;
  constexpr int NT = NQ * G;           // n-tiles a warp
  constexpr int kRows = 8 * NT;        // rows of the query tile
  static_assert(NT == 1 || NT % 2 == 0, "n-tiles load in pairs");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int warps = blockDim.x >> 5;
  const Geometry geo = geometry(warps, kInt8, kRows, S, KC);
  const int bins = geo.bins;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = lane >> 2;
  const int pair = lane & 3;
  const int q0 = blockIdx.x * 8 * NQ;
  const int bin0 = blockIdx.y * bins;
  const int C = kAff ? p.C : 1;
  const int ngroups = kAff ? (C + G - 1) / G : 1;
  const int nck = (p.Dq + KC - 1) / KC;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.bars_off);
  // Thread 0 copies the unit (block b, slot group g, depth chunk k) into
  // stage st: the catalog tile at (column b L + bin0, row KC k) and the
  // query tile at (column KC k, query q0[, slot 8 g]), both completing on
  // full[st]; what overhangs D, B or C lands as zeros.
  const int q_rows = 8 * NQ * (C < G ? C : G);  // rows of a query box
  // With one chunk and one slot group a block (Dq <= KC, C <= G) every
  // unit's query tile is the same: it is copied once, with the first unit
  // into stage 0, and read from there by every unit.
  const bool q_once = nck == 1 && ngroups == 1;
  auto load = [&](int b, int g, int k, int st) {
    unsigned char* stage = smem + st * geo.stage_bytes;
    const bool with_q = !q_once || b == 0;
    mbar_arrive_expect_tx(&full[st],
                          geo.cat_bytes + (with_q ? q_rows * KC * 2 : 0));
    const int sub_bytes = KC * geo.sub_bins * (kInt8 ? 1 : 2);
    for (int sub = 0; sub * geo.sub_bins < bins; ++sub) {
      tile_copy(stage + sub * sub_bytes, &cat_map,
                b * p.L + bin0 + sub * geo.sub_bins, k * KC, &full[st]);
    }
    // the query tile in boxes of 64 columns (128-byte swizzled rows)
    for (int c = 0; with_q && c < KC / kQBox; ++c) {
      unsigned char* dst = stage + geo.cat_bytes + c * kRows * kQBox * 2;
      if constexpr (kAff) {
        tile_copy(dst, &q_map, k * KC + c * kQBox, q0, g * G, &full[st]);
      } else {
        tile_copy(dst, &q_map, k * KC + c * kQBox, q0, &full[st]);
      }
    }
  };
  // units run k fastest, then g, then b: (b, g, k) -> the next one
  auto next = [&](int& b, int& g, int& k) {
    if (++k == nck) {
      k = 0;
      if (++g == ngroups) {
        g = 0;
        ++b;
      }
    }
  };

  // the sums: the scans keep two, of the even and of the odd k16 steps
  // (two independent chains of products instead of one), added at the end
  constexpr int kOdd = kAff ? 1 : NT;
  float acc[NT][4];
  float acc_odd[kOdd][4];
#pragma unroll
  for (int j = 0; j < kOdd; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_odd[j][i] = 0.f;
  }
  float run[NQ][4];  // affinity: the running max over slot groups
  float m1[NQ][4], m2[NQ][4];
  int id1[NQ][4], id2[NQ][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run[j][i] = -INFINITY;
      m1[j][i] = -INFINITY;
      m2[j][i] = -INFINITY;
      id1[j][i] = 0;
      id2[j][i] = 0;
    }
  }

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the bin (of the CTA's tile) of this lane's accumulator rows group
  // (h = 0) and group + 8 (h = 1): bins group and group + 8 of the warp's
  // 16; int8 reads bins in pairs (ldmatrix of b16 pairs of codes), so there
  // they hold bins 2 group and 2 group + 1
  auto bin_of = [&](int h) {
    return warp * kWarpBins + (kInt8 ? 2 * group + h : group + 8 * h);
  };
  // the per-item inputs of the fold (mask, scale, album, artist) of this
  // lane's two bins in block b, loaded a block ahead of their use so that
  // their latency hides behind the block's products
  struct Ahead {
    bool keep[2];
    float scale[2];
    int album[2], artist[2];
  };
  auto fetch = [&](int b) {
    Ahead a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = b * p.L + bin0 + bin_of(h);
      a.keep[h] = p.mask == nullptr || p.mask[g] != 0;
      a.scale[h] = kInt8 ? p.scales[g] : 1.f;
      a.album[h] = kAff ? p.album[g] : 0;
      a.artist[h] = kAff ? p.artist[g] : 0;
    }
    return a;
  };
  Ahead ahead = fetch(0);  // block 0 < Mp / L exists even when nblk is 0

  int lb = 0, lg = 0, lk = 0;  // the next unit to copy
  for (int s = 0; s < S - 1 && lb < p.nblk; ++s) {
    if (tid == 0) load(lb, lg, lk, s);
    next(lb, lg, lk);
  }
  // ldmatrix rows of this lane: A (catalog, transposed) depth row
  // (lane & 7) + 8 (lane >> 4) and bins + 8 ((lane >> 3) & 1) of the
  // warp's 16; B (queries) row (lane & 7) of n-tile pair member lane >> 4
  // and columns + 8 ((lane >> 3) & 1)
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = warp * kWarpBins + (((lane >> 3) & 1) << 3);
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;
  const unsigned smem_base = smem_addr(smem);
  uint32_t magic;  // 128 in both bf16 halves, opaque to the compiler
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));
  // a catalog box's rows: 32, 64 or 128 bytes, swizzled to match. This
  // lane's A box and its column in it (bf16):
  const unsigned cat_row = geo.sub_bins * (kInt8 ? 1 : 2);
  const unsigned a_box = (a_col / geo.sub_bins) * KC * cat_row;
  const int a_in = a_col % geo.sub_bins;

  int st = 0;                 // the stage of unit (b, g, k)
  unsigned phase = 0;         // its barrier's phase parity
  int lst = S - 1;            // the stage of the next copy
  for (int b = 0, g = 0, k = 0; b < p.nblk; next(b, g, k)) {
    __syncthreads();  // every thread is done with the last unit's stage
    if (lb < p.nblk) {
      if (tid == 0) load(lb, lg, lk, lst);
      next(lb, lg, lk);
    }
    lst = lst + 1 == S ? 0 : lst + 1;
    mbar_wait(&full[st], phase);
    const unsigned cat = smem_base + st * geo.stage_bytes;
    const unsigned qtile =
        (q_once ? smem_base : cat) + geo.cat_bytes;
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
    // the chunk's k16 steps below Dq
    const int left = (p.Dq - k * KC) / 16;
    const int steps = left < KC / 16 ? left : KC / 16;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (ks == steps) break;
      uint32_t a[4];
      if constexpr (kInt8) {
        // codes as b16 pairs of bins, transposed: a lane's register holds
        // bins 2 group and 2 group + 1 at depths 2 pair, 2 pair + 1 (lanes
        // 0-7 address depths ks 16.., lanes 8-15 depths ks 16 + 8..)
        uint32_t r[2];
        ldmatrix_x2_trans(r, cat + swizzle((ks * 16 + (lane & 15)) * cat_row
                                           + warp * kWarpBins, cat_row));
        a[0] = widen_even(r[0], magic);
        a[1] = widen_odd(r[0], magic);
        a[2] = widen_even(r[1], magic);
        a[3] = widen_odd(r[1], magic);
      } else {
        ldmatrix_x4_trans(a, cat + a_box + swizzle((ks * 16 + a_row) *
                                                   cat_row + a_in * 2,
                                                   cat_row));
      }
      // this lane's query box (64 columns a box) and its column in it
      const unsigned b_box = qtile + (ks * 16 / kQBox) * kRows * kQBox * 2;
      const unsigned b_off = ((ks * 16) % kQBox + b_col) * 2;
      if constexpr (NT == 1) {
        uint32_t bq[2];
        ldmatrix_x2(bq, b_box + swizzle(b_row * 128 + b_off, 128));
        mma_k16(ks % 2 ? acc_odd[0] : acc[0], a, bq[0], bq[1]);
      } else {
        // every n-tile, with no branch (one would keep the compiler from
        // hoisting the loads above the products): the affinity's tiles of
        // slots at or past C hold stale rows, whose sums the running max
        // below leaves out
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bq[4];
          ldmatrix_x4(bq, b_box + swizzle((j * 8 + b_row) * 128 + b_off,
                                          128));
          if constexpr (kAff) {
            mma_k16(acc[j], a, bq[0], bq[1]);
            mma_k16(acc[j + 1], a, bq[2], bq[3]);
          } else {
            mma_k16(ks % 2 ? acc_odd[j] : acc[j], a, bq[0], bq[1]);
            mma_k16(ks % 2 ? acc_odd[j + 1] : acc[j + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
    if (k != nck - 1) continue;
    // the block's (or the slot group's) sums are whole
    if constexpr (kAff) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool live = g * G + j / NQ < C;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          run[j % NQ][i] = live ? fmaxf(run[j % NQ][i], acc[j][i])
                                : run[j % NQ][i];
          acc[j][i] = 0.f;
        }
      }
      if (g != ngroups - 1) continue;
    }
    // score and fold block b: this lane's bins (bin_of) against its
    // queries (columns 2 pair, 2 pair + 1)
    int gid[2], alb[2], art[2];
    bool ok[2];
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gid[h] = b * p.L + bin0 + bin_of(h);
      ok[h] = gid[h] < p.bound && ahead.keep[h];
      scale[h] = ahead.scale[h];
      alb[h] = ahead.album[h];
      art[h] = ahead.artist[h];
    }
    if (b + 1 < p.nblk) ahead = fetch(b + 1);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool in_alb[2] = {false, false}, in_art[2] = {false, false};
        if constexpr (kAff) {
          const int qi = q0 + j * 8 + 2 * pair + e;
          if (qi < p.B) {
            const int32_t* actx =
                p.album_ctx + static_cast<long long>(qi) * C;
            const int32_t* artx =
                p.artist_ctx + static_cast<long long>(qi) * C;
#pragma unroll 4
            for (int c = 0; c < C; ++c) {
              const int32_t a = __ldg(actx + c);
              const int32_t r = __ldg(artx + c);
              in_alb[0] |= a == alb[0];
              in_alb[1] |= a == alb[1];
              in_art[0] |= r == art[0];
              in_art[1] |= r == art[1];
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e;
          float s;
          if constexpr (kAff) {
            s = run[j][i];
            run[j][i] = -INFINITY;
            s = s + (in_alb[h] ? 0.1f : 0.0f);
            s = s + (in_art[h] ? 0.1f : 0.0f);
          } else {
            s = acc[j][i] + acc_odd[j][i];
            acc[j][i] = 0.f;
            acc_odd[j][i] = 0.f;
            if constexpr (kInt8) s = s * scale[h];
          }
          s = ok[h] ? s : -INFINITY;
          fold(s, gid[h], m1[j][i], id1[j][i], m2[j][i], id2[j][i]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + j * 8 + 2 * pair + (i & 1);
      if (qi < p.B) {
        const int bin = bin0 + bin_of(i >> 1);
        const long long row = static_cast<long long>(qi) * 2 * p.L;
        p.vals[row + bin] = m1[j][i];
        p.vals[row + p.L + bin] = m2[j][i];
        p.ids[row + bin] = id1[j][i];
        p.ids[row + p.L + bin] = id2[j][i];
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A tensor map of `rank` dims (innermost first, byte strides of the outer
// ones) whose boxes land in shared memory with `swizzle`; reads past the
// tensor's edges fill with zeros. cuTensorMapEncodeTiled is looked up with
// cudaGetDriverEntryPoint, so nothing links libcuda.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* base, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
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
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// `q`: the scans' (B, Dq) bf16 queries, the affinity's (C, B, Dq) (slots
// outermost, so that a tile's rows of one slot are neighbours).
template <bool kInt8, bool kAff, int NQ, int S, int KC>
cudaError_t launch(const Params& p, const void* q, cudaStream_t stream) {
  constexpr int G = kAff ? kSlotGroup : 1;
  const int qtiles = (p.B + 8 * NQ - 1) / (8 * NQ);
  // the affinity shares each query tile among 8 warps (its copies from the
  // L2 cache bound it), the scans among 4; fewer, down to 2, when the grid
  // would not fill the card's 132 SMs
  int warps = kAff ? kMaxWarps : 4;
  while (warps > 2 &&
         static_cast<long long>(qtiles) * (p.L / (kWarpBins * warps)) < 132) {
    warps /= 2;
  }
  Geometry geo = geometry(warps, kInt8, 8 * NQ * G, S, KC);
  while (geo.bytes > kMaxSmem && warps > 2) {  // the ring must fit
    warps /= 2;
    geo = geometry(warps, kInt8, 8 * NQ * G, S, KC);
  }
  if (geo.bytes > kMaxSmem || p.L % geo.bins != 0 ||
      p.L / geo.bins > 65535) {
    return cudaErrorInvalidValue;
  }
  // the catalog (D rows of Mp), boxes of 64 rows of the CTA's bins
  const int elem = kInt8 ? 1 : 2;
  const cuuint64_t cat_dims[2] = {static_cast<cuuint64_t>(p.Mp),
                                  static_cast<cuuint64_t>(p.D)};
  const cuuint64_t cat_strides[1] = {static_cast<cuuint64_t>(p.Mp) * elem};
  const cuuint32_t cat_box[2] = {static_cast<cuuint32_t>(geo.sub_bins),
                                 static_cast<cuuint32_t>(KC)};
  const int row_bytes = geo.sub_bins * elem;
  const CUtensorMapSwizzle cat_swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap cat_map, q_map;
  cudaError_t err = tensor_map(
      &cat_map,
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, p.items, cat_dims, cat_strides, cat_box, cat_swizzle);
  if (err != cudaSuccess) return err;
  // the queries, boxes of 64 columns of 8 NQ queries (of G slots)
  const cuuint64_t q_dims[3] = {static_cast<cuuint64_t>(p.Dq),
                                static_cast<cuuint64_t>(p.B),
                                static_cast<cuuint64_t>(p.C)};
  const cuuint64_t q_strides[2] = {
      static_cast<cuuint64_t>(p.Dq) * 2,
      static_cast<cuuint64_t>(p.Dq) * 2 * static_cast<cuuint64_t>(p.B)};
  // (of min(C, G) slots: the affinity at C < 8 copies no empty slot)
  const cuuint32_t q_box[3] = {kQBox, 8 * NQ,
                               static_cast<cuuint32_t>(p.C < G ? p.C : G)};
  err = tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kAff ? 3 : 2, q,
                   q_dims, q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = fused_generic_kernel<kInt8, kAff, NQ, S, KC>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(qtiles, p.L / geo.bins);
  kernel<<<grid, 32 * warps, geo.bytes, stream>>>(cat_map, q_map, p);
  return cudaGetLastError();
}

bool valid(const Params& p) {
  return p.B >= 1 && p.D >= 1 && p.Dq % 16 == 0 && p.Dq >= p.D &&
         p.L % 128 == 0 && p.Mp >= p.L && p.Mp % p.L == 0 &&
         p.Mp <= INT_MAX &&
         p.nblk >= 0 && static_cast<long long>(p.nblk) * p.L <= p.Mp;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a CUDA error code: 0 when the
// launch was accepted. Preconditions (checked by the wrapper): B >= 1,
// D >= 1, q padded to Dq = ceil16(D) columns with zeros and 16-byte
// aligned, L a multiple of 128, Mp a multiple of L and below 2^31, a
// 16-byte aligned catalog, nblk = ceil(bound / L) <= Mp / L. The scans take
// B <= 8 in one query tile of 8 a warp, larger B in tiles of 32; the
// affinity tiles of 16.

int esr_fused_scan_generic(int device, const void* q, const void* items,
                           const void* mask, void* vals, void* ids, int B,
                           int D, int Dq, long long Mp, int L, int nblk,
                           int bound, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{items, nullptr, static_cast<const uint8_t*>(mask), nullptr,
           nullptr, nullptr, nullptr, static_cast<float*>(vals),
           static_cast<int32_t*>(ids), B, 1, D, Dq, Mp, L, nblk, bound};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = B <= 8 ? launch<false, false, 1, 8, 256>(p, q, s)
               : launch<false, false, 4, 4, 256>(p, q, s);
  return static_cast<int>(err);
}

int esr_fused_scan_int8_generic(int device, const void* q, const void* codes,
                                const void* scales, const void* mask,
                                void* vals, void* ids, int B, int D, int Dq,
                                long long Mp, int L, int nblk, int bound,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{codes, static_cast<const float*>(scales),
           static_cast<const uint8_t*>(mask), nullptr, nullptr, nullptr,
           nullptr, static_cast<float*>(vals), static_cast<int32_t*>(ids),
           B, 1, D, Dq, Mp, L, nblk, bound};
  if (scales == nullptr || !valid(p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = B <= 8 ? launch<true, false, 1, 8, 256>(p, q, s)
               : launch<true, false, 4, 4, 256>(p, q, s);
  return static_cast<int>(err);
}

// The affinity: q (C, B, Dq) (slots outermost), album and artist (Mp,)
// int32, album_ctx and artist_ctx (B, C) int32; C >= 1.
int esr_fused_affinity_generic(int device, const void* q, const void* items,
                               const void* album, const void* artist,
                               const void* actx, const void* artx,
                               void* vals, void* ids, int B, int C, int D,
                               int Dq, long long Mp, int L, int nblk,
                               int bound, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{items, nullptr, nullptr, static_cast<const int32_t*>(album),
           static_cast<const int32_t*>(artist),
           static_cast<const int32_t*>(actx),
           static_cast<const int32_t*>(artx), static_cast<float*>(vals),
           static_cast<int32_t*>(ids), B, C, D, Dq, Mp, L, nblk, bound};
  if (C < 1 || !valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  err = launch<false, true, 2, 3, 64>(p, q,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
