// Fused playlist-affinity scan+select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_affinity_kernel` of
// esrecsys_tpu/retrieval/fused.py:453 (launched by
// `binned_affinity_candidates`, the full-corpus eval's candidate scan). It
// computes the same function: for each query b with C context slots and
// each catalog item g below `bound`,
//   score = max_c (ctx[b, c] . item_g) + 0.1 [album_g in album_ctx[b]]
//                                      + 0.1 [artist_g in artist_ctx[b]],
// the dot products from bf16 inputs with float32 accumulation and the two
// boosts added in float32 after the max, in that order; items at or past
// `bound` score -inf. Item g falls in bin g mod L and each bin keeps its top
// two (value, id) pairs, folded over the catalog blocks in ascending order
// with a strict `>` (the earlier block wins ties; slots never filled keep
// (-inf, 0)). Output: vals (B, 2L) float32 and ids (B, 2L) int32, the
// first L columns each bin's best, the next L its runner-up.
//
// What bounds it: operations. The eval batch (B=2048, C=5, D=64) against
// the 2,262,292 tracks is 2*B*C*D*M = 2.965e12 bf16 operations, 3.0 ms at
// the H100 SXM's 989 TFLOP/s, while reading the catalog once takes
// 0.09 ms. Besides the products, every (query, item) pair pays the max over
// C slots, two membership boosts and the top-2 fold on the CUDA cores.
//
// Design. The grid is (ceil(B/64) query tiles) x (L/64 bin tiles); a CTA
// owns 64 bins for 64 queries and walks every catalog block in ascending
// order, so each bin's fold is one thread's sequential loop: the tie rule
// holds exactly, with no atomics and no cross-CTA merge. Query tiles vary
// fastest, so the 32 CTAs of one bin tile run side by side and read each
// catalog tile from the L2 cache. A CTA is three warpgroups:
//   - the producer warpgroup. One thread fills a ring of shared-memory
//     stages: per block one TMA tensor-map copy of the (D x 64) catalog tile
//     (128-byte swizzled rows) and two bulk copies of its 64 album and 64
//     artist ids, all completing on the stage's "full" mbarrier. Warps 1-2
//     then write each item's album and artist masks beside the tile
//     ("ready" mbarrier). It lowers its register count (setmaxnreg).
//   - two consumer warpgroups, 32 queries each. Per block a warpgroup
//     issues D/16 `wgmma.m64n{32C}k16`: A is the catalog tile, read by the
//     tensor cores straight from the stage (MN-major, 64 bins as M), B all
//     C slots' 32 queries, resident in shared memory for the whole scan
//     (K-major, 8 x 16-byte core matrices). The accumulator holds the same
//     (bin, query) pair in the same registers for every slot, so the max
//     over C stays inside the thread.
// The four costs of the previous design (an mma.sync kernel, 17.6 ms at
// the eval shape, 5.9 times its bound), and what this one does instead:
//   1. query fragments re-read from shared memory for every block: the
//      tensor cores read both operands from shared memory, one instruction
//      per 16 depths for all slots;
//   2. 2C id compares per pair: at CTA start every (query, slot) context id
//      goes into an open-addressing hash table per kind (64-bit tagged keys,
//      so every int32 is a key and occupancy is the tag bit, not a sentinel)
//      whose value is the 64-bit mask of the CTA's queries holding it, with
//      a 32-bit filter word per slot that answers most absent ids with one
//      load. One lookup per item per kind per CTA gives its mask; a pair
//      tests one bit. When no lane's pairs hold a bit (nearly every block)
//      the boosts reduce to the reference's exact `+ 0.0f`;
//   3. the fold on every pair: branch-free selects, the reference's two
//      strict compares, with both ids of a pair in shared memory (touched
//      on an update only), which keeps the scan free of register spills;
//   4. dependent mma.sync chains at two warps per scheduler: asynchronous
//      wgmma, one warpgroup's products running while the other's epilogue
//      does.
// Every item's score is the same instruction sequence wherever its block
// lies, so copies of one vector score bit-identically and the tie rule
// carries over exactly. The kernel allocates nothing.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 6.86-6.89 ms
// at the eval shape, 2.3 times the operation bound, against 17.6 ms for the
// previous design in the same run. Each warpgroup still waits for its own
// products before its epilogue, so products and epilogue overlap only
// across the two warpgroups; ptxas keeps every thread at 168 registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;          // bins per CTA: the wgmma M
constexpr int kWgQueries = 32;     // queries per consumer warpgroup: wgmma N
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kQueries = kConsumers * kWgQueries;
constexpr int kThreads = 128 * (1 + kConsumers);  // + the producer warpgroup
constexpr int kMaxSlots = 8;       // context slots the kernel takes
constexpr int kTableBits = 10;     // hash slots per id kind: 1024 >= 2 x 512
constexpr int kTable = 1 << kTableBits;
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 56;  // per thread, after setmaxnreg: a scheduler
constexpr int kConsumerRegs = 224; // holds 56 + 2 x 224 of its 512 a lane
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): the stage ring (each stage: the (D x 64) tile in 128-byte rows,
// 16-byte chunks swizzled by TMA, then the 64 album and 64 artist ids, then
// their masks), the two warpgroups' query operands, the two membership
// tables (tagged keys, then masks, per kind) and their filters, the
// consumers' pair ids, the barriers.
template <int D, int C>
struct Layout {
  static constexpr int kSbo = 16 * D;  // bytes between 8-query core groups
  static constexpr int kWgQueryBytes = C * kWgQueries * D * 2;
  static constexpr int kTableBytes = 2 * (2 * kTable * 8 + kTable * 4);
  static constexpr int kTileBytes = D * kBins * 2;
  static constexpr int kStageBytes =
      (kTileBytes + 2 * kBins * 4 + 2 * kBins * 8 + 1023) / 1024 * 1024;
  static constexpr int kIdBytes = 2 * 16 * 128 * kConsumers * 4;
  static constexpr size_t kFixed = kConsumers * kWgQueryBytes + kTableBytes +
                                   kIdBytes + 3 * kMaxStages * 8 + 1024;
  static constexpr int kStages =
      cmin(kMaxStages, static_cast<int>((kMaxSmem - kFixed) / kStageBytes));
  static constexpr size_t kQueryOff = static_cast<size_t>(kStages) * kStageBytes;
  static constexpr size_t kTables = kQueryOff + kConsumers * kWgQueryBytes;
  static constexpr size_t kIds = kTables + kTableBytes;
  static constexpr size_t kBars = kIds + kIdBytes;
  static constexpr size_t kBytes = kBars + 3 * kStages * 8 + 1024;  // + alignment
  // (D, C) = (128, 8) fits one stage: correct, its copies not overlapped
  static_assert(kStages >= 1, "shared memory too small for a stage");
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

// The (D x 64) box at column `col` of the catalog's tensor map into shared
// memory (128-byte swizzled rows), completing on `bar`'s transaction count.
__device__ __forceinline__ void tile_copy(void* smem, const CUtensorMap* map,
                                          int col, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0),
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

// wgmma shared-memory matrix descriptors. The queries (B): no swizzle,
// 8 x 16-byte core matrices `lbo` bytes apart along K and `sbo` bytes
// apart along N. The catalog tile (A, MN-major): rows of 64 bins in
// 128-byte swizzled lines, 8-row groups 1024 bytes apart; with one 64-bin
// atom the two strides are both 1024.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t tile_desc(unsigned addr) {
  return smem_desc(addr, 1024, 1024) | (1ull << 62);  // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to `d` across a wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32C, float32) = a (64 x 16 bf16, MN-major, shared memory) *
// b (16 x 32C bf16, K-major, shared memory) + (accumulate ? d : 0): one
// wgmma for every context slot's 32 queries. Specialised per C because
// the instruction names its width and each accumulator register.
template <int C>
struct Wgmma;

template <>
struct Wgmma<1> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<2> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<3> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<4> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<5> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<6> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<7> {
  static __device__ __forceinline__ void mma(float (&d)[112], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %114, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, %112, %113, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// The table's hash: slot = its top kTableBits bits. The next 5 bits pick
// the key's bit in the filter word of that slot, a 32-bit prefilter that
// answers most absent ids with one shared-memory load.
__device__ __forceinline__ unsigned table_hash(int key) {
  return static_cast<unsigned>(key) * 2654435761u;
}

__device__ __forceinline__ unsigned long long table_tag(int key) {
  return (1ull << 32) | static_cast<unsigned>(key);
}

// OR query bit `bit` into `key`'s mask, inserting the key if it is new.
__device__ void table_insert(unsigned long long* keys,
                             unsigned long long* masks, uint32_t* filter,
                             int key, int bit) {
  const unsigned long long tag = table_tag(key);
  const unsigned h = table_hash(key);
  unsigned s = h >> (32 - kTableBits);
  atomicOr(&filter[s], 1u << ((h >> (27 - kTableBits)) & 31));
  while (true) {
    const unsigned long long old = atomicCAS(&keys[s], 0ull, tag);
    if (old == 0ull || old == tag) {
      atomicOr(&masks[s], 1ull << bit);
      return;
    }
    s = (s + 1) & (kTable - 1);
  }
}

// The mask of the CTA's queries whose context holds `key` (0 if none).
// The table is at most half full, so a probe always meets an empty slot.
__device__ __forceinline__ unsigned long long table_probe(
    const unsigned long long* keys, const unsigned long long* masks,
    int key, unsigned s) {
  const unsigned long long tag = table_tag(key);
  while (true) {
    const unsigned long long k = keys[s];
    if (k == tag) return masks[s];
    if (k == 0ull) return 0ull;
    s = (s + 1) & (kTable - 1);
  }
}

// Masks of two ids, their filter loads issued together.
__device__ __forceinline__ void table_lookup2(
    const unsigned long long* keys, const unsigned long long* masks,
    const uint32_t* filter, int key0, int key1, unsigned long long& m0,
    unsigned long long& m1) {
  const unsigned h0 = table_hash(key0);
  const unsigned h1 = table_hash(key1);
  const unsigned s0 = h0 >> (32 - kTableBits);
  const unsigned s1 = h1 >> (32 - kTableBits);
  const uint32_t f0 = filter[s0] >> ((h0 >> (27 - kTableBits)) & 31);
  const uint32_t f1 = filter[s1] >> ((h1 >> (27 - kTableBits)) & 31);
  m0 = (f0 & 1u) ? table_probe(keys, masks, key0, s0) : 0ull;
  m1 = (f1 & 1u) ? table_probe(keys, masks, key1, s1) : 0ull;
}

// One block's epilogue for a consumer thread's 16 (bin, query) pairs:
// the max over the C slots, the two boosts (bit 8 (r >> 2) + (r & 1) of
// the bin's album and artist words), -inf at or past `bound` (the last
// block only), then the top-2 fold. The pairs' ids live in shared memory
// (`id1[256 r]`, `id2[256 r]`), read and written on a fold update only.
template <int C, bool kLast>
__device__ __forceinline__ void fold_block(
    const float (&acc)[16 * C], uint32_t alb_lo, uint32_t alb_hi,
    uint32_t art_lo, uint32_t art_hi, int gid_lo, int bound,
    float (&m1)[16], float (&m2)[16], int* id1, int* id2) {
  float sv[16];
  // no lane's pairs hold a boost bit (the common case): sv = best + 0.0f,
  // the reference's add of 0.1 * 0.0 twice (x + 0 + 0 == x + 0 exactly)
  const bool boost = __any_sync(
      0xffffffffu, ((alb_lo | alb_hi | art_lo | art_hi) & 0x03030303u) != 0u);
  if (!boost) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float best = acc[r];
#pragma unroll
      for (int c = 1; c < C; ++c) best = fmaxf(best, acc[16 * c + r]);
      sv[r] = best + 0.0f;
      if (kLast && gid_lo + (((r >> 1) & 1) ? 8 : 0) >= bound) sv[r] = -INFINITY;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float best = acc[r];
#pragma unroll
      for (int c = 1; c < C; ++c) best = fmaxf(best, acc[16 * c + r]);
      const int bit = 8 * (r >> 2) + (r & 1);
      const bool hi = (r >> 1) & 1;
      const bool in_alb = ((hi ? alb_hi : alb_lo) >> bit) & 1u;
      const bool in_art = ((hi ? art_hi : art_lo) >> bit) & 1u;
      sv[r] = best + (in_alb ? 0.1f : 0.0f);
      sv[r] = sv[r] + (in_art ? 0.1f : 0.0f);
      if (kLast && gid_lo + (hi ? 8 : 0) >= bound) sv[r] = -INFINITY;
    }
  }
  // The reference's fold, without branches: the loser of (sv, m1) is
  // folded into (m2, id2), each with a strict '>'.
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int gid = gid_lo + (((r >> 1) & 1) ? 8 : 0);
    const bool b1 = sv[r] > m1[r];
    const float lv = b1 ? m1[r] : sv[r];
    int li = gid;
    if (b1) {
      li = id1[r * 128 * kConsumers];
      id1[r * 128 * kConsumers] = gid;
    }
    m1[r] = b1 ? sv[r] : m1[r];
    const bool b2 = lv > m2[r];
    if (b2) id2[r * 128 * kConsumers] = li;
    m2[r] = b2 ? lv : m2[r];
  }
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
fused_affinity_kernel(const __grid_constant__ CUtensorMap tile_map,
                      const uint16_t* __restrict__ q,      // (B, C, D) bf16
                      const int32_t* __restrict__ album,   // (Mp,)
                      const int32_t* __restrict__ artist,  // (Mp,)
                      const int32_t* __restrict__ actx,    // (B, C)
                      const int32_t* __restrict__ artx,    // (B, C)
                      float* __restrict__ vals,            // (B, 2L)
                      int32_t* __restrict__ ids,           // (B, 2L)
                      int B, int L, int nblk, int bound) {
  using Lay = Layout<D, C>;
  constexpr int S = Lay::kStages;
  constexpr int kSteps = D / 16;  // wgmma depth steps
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* queries = ring + Lay::kQueryOff;  // the B operands
  unsigned long long* tables =
      reinterpret_cast<unsigned long long*>(ring + Lay::kTables);
  uint32_t* filters = reinterpret_cast<uint32_t*>(tables + 4 * kTable);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Lay::kBars);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qbase = blockIdx.x * kQueries;
  const int bin0 = blockIdx.y * kBins;

  // The queries, per warpgroup [slot][query][depth] in core matrices of 8
  // queries x 8 depths (zeros past B), and the membership tables.
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < kQueries * C * kPairs; i += kThreads) {
    const int qi = i / (C * kPairs);
    const int rest = i - qi * C * kPairs;
    const int c = rest / kPairs;
    const int d = 2 * (rest - c * kPairs);
    const int gq = qbase + qi;
    uint32_t v = 0u;
    if (gq < B) {
      v = *reinterpret_cast<const uint32_t*>(
          q + (static_cast<long long>(gq) * C + c) * D + d);
    }
    const int n = c * kWgQueries + (qi % kWgQueries);
    const int off = (qi / kWgQueries) * Lay::kWgQueryBytes +
                    (n >> 3) * Lay::kSbo + (d >> 3) * 128 + (n & 7) * 16 +
                    (d & 7) * 2;
    *reinterpret_cast<uint32_t*>(queries + off) = v;
  }
  for (int i = threadIdx.x; i < 5 * kTable; i += kThreads) tables[i] = 0ull;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&ready[s], 64);             // one per lookup lane
      mbar_init(&empty[s], 128 * kConsumers);  // one per consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the queries are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kQueries * C; i += kThreads) {
    const int kind = i / (kQueries * C);
    const int rest = i - kind * kQueries * C;
    const int qi = rest / C;
    const int gq = qbase + qi;
    if (gq < B) {
      const long long at = static_cast<long long>(gq) * C + (rest - qi * C);
      unsigned long long* keys = tables + kind * 2 * kTable;
      table_insert(keys, keys + kTable, filters + kind * kTable,
                   kind ? artx[at] : actx[at], qi);
    }
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // Copies: stage b % S gets block b's tile and ids once the consumers
      // have released the stage's previous block.
      for (int b = 0; b < nblk; ++b) {
        const int st = b % S;
        if (b >= S) mbar_wait(&empty[st], ((b / S) - 1) & 1);
        unsigned char* stage = ring + st * Lay::kStageBytes;
        mbar_arrive_expect_tx(&full[st], Lay::kTileBytes + 2 * kBins * 4);
        const int col = b * L + bin0;
        tile_copy(stage, &tile_map, col, &full[st]);
        bulk_copy(stage + Lay::kTileBytes, album + col, kBins * 4, &full[st]);
        bulk_copy(stage + Lay::kTileBytes + kBins * 4, artist + col,
                  kBins * 4, &full[st]);
      }
    } else if (warp == 1 || warp == 2) {
      // Lookups: warp 1 the albums, warp 2 the artists, two items a lane.
      const int kind = warp - 1;
      const unsigned long long* keys = tables + kind * 2 * kTable;
      const uint32_t* filter = filters + kind * kTable;
      for (int b = 0; b < nblk; ++b) {
        const int st = b % S;
        mbar_wait(&full[st], (b / S) & 1);
        unsigned char* stage = ring + st * Lay::kStageBytes;
        const int32_t* id = reinterpret_cast<const int32_t*>(
            stage + Lay::kTileBytes + kind * kBins * 4);
        unsigned long long* mask = reinterpret_cast<unsigned long long*>(
            stage + Lay::kTileBytes + 2 * kBins * 4 + kind * kBins * 8);
        table_lookup2(keys, keys + kTable, filter, id[lane], id[lane + 32],
                      mask[lane], mask[lane + 32]);
        mbar_arrive(&ready[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumer warpgroup cg: queries cg*32.. of the CTA. Warp w of it holds
  // accumulator rows (bins) 16w + group and 16w + group + 8; register r of
  // a slot's 16 holds bin row (r >> 1) & 1 and query 8 (r >> 2) + 2 pair +
  // (r & 1), the same pair for every slot.
  const int cg = warp / 4 - 1;
  const int w = warp & 3;
  const int group = lane >> 2;
  const int pair = lane & 3;
  const int row_lo = 16 * w + group;
  const unsigned qsmem =
      smem_addr(queries) + static_cast<unsigned>(cg * Lay::kWgQueryBytes);
  // this thread's ids of pair r: id1[256 r] and id2[256 r], conflict-free
  int* id2 = reinterpret_cast<int*>(ring + Lay::kIds) + (threadIdx.x - 128);
  int* id1 = id2 + 16 * 128 * kConsumers;
  float m1[16], m2[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m1[r] = -INFINITY;
    m2[r] = -INFINITY;
    id1[r * 128 * kConsumers] = 0;
    id2[r * 128 * kConsumers] = 0;
  }

  float acc[16 * C];  // slot c's scores in acc[16 c ..], all overwritten
  for (int b = 0; b < nblk; ++b) {
    const int st = b % S;
    mbar_wait(&ready[st], (b / S) & 1);
    const unsigned char* stage = ring + st * Lay::kStageBytes;
    // this warpgroup's 32-bit word of each bin's masks, shifted to this
    // lane's queries: bit 8j + e is query 8j + 2 pair + e
    const uint32_t* mask = reinterpret_cast<const uint32_t*>(
        stage + Lay::kTileBytes + 2 * kBins * 4) + cg;
    const int shift = 2 * pair;
    const uint32_t alb_lo = mask[2 * row_lo] >> shift;
    const uint32_t alb_hi = mask[2 * (row_lo + 8)] >> shift;
    const uint32_t art_lo = mask[2 * (kBins + row_lo)] >> shift;
    const uint32_t art_hi = mask[2 * (kBins + row_lo + 8)] >> shift;

    fence_regs(acc);
    wgmma_fence();
    const unsigned tile = smem_addr(stage);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      Wgmma<C>::mma(acc, tile_desc(tile + k * 2048),
                    smem_desc(qsmem + k * 256, 128, Lay::kSbo), k > 0);
    }
    wgmma_commit_wait();
    fence_regs(acc);
    mbar_arrive(&empty[st]);  // the products have read the tile

    const int gid_lo = b * L + bin0 + row_lo;
    if (b + 1 < nblk) {
      fold_block<C, false>(acc, alb_lo, alb_hi, art_lo, art_hi, gid_lo,
                           bound, m1, m2, id1, id2);
    } else {
      fold_block<C, true>(acc, alb_lo, alb_hi, art_lo, art_hi, gid_lo,
                          bound, m1, m2, id1, id2);
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = qbase + cg * kWgQueries + 8 * (r >> 2) + 2 * pair + (r & 1);
    if (qi < B) {
      const int bin = bin0 + row_lo + 8 * ((r >> 1) & 1);
      const long long row = static_cast<long long>(qi) * 2 * L;
      vals[row + bin] = m1[r];
      vals[row + L + bin] = m2[r];
      ids[row + bin] = id1[r * 128 * kConsumers];
      ids[row + L + bin] = id2[r * 128 * kConsumers];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The catalog (D, Mp) bf16 as a 2-D tensor map whose box is one CTA's
// (D x 64) tile, written to shared memory in 128-byte swizzled rows.
// cuTensorMapEncodeTiled is looked up with cudaGetDriverEntryPoint, so
// nothing links libcuda.
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
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(items),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int C>
cudaError_t launch(const void* q, const void* items, const void* album,
                   const void* artist, const void* actx, const void* artx,
                   void* vals, void* ids, int B, long long Mp, int L,
                   int nblk, int bound, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D, C>::kBytes;
  CUtensorMap map;
  cudaError_t err = tile_map(&map, items, D, Mp);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_affinity_kernel<D, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((B + kQueries - 1) / kQueries, L / kBins);
  fused_affinity_kernel<D, C><<<grid, kThreads, bytes, stream>>>(
      map, static_cast<const uint16_t*>(q),
      static_cast<const int32_t*>(album), static_cast<const int32_t*>(artist),
      static_cast<const int32_t*>(actx), static_cast<const int32_t*>(artx),
      static_cast<float*>(vals), static_cast<int32_t*>(ids), B, L, nblk,
      bound);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const void* q, const void* items, const void* album,
                       const void* artist, const void* actx, const void* artx,
                       void* vals, void* ids, int B, int C, long long Mp,
                       int L, int nblk, int bound, cudaStream_t s) {
#define ESR_SLOTS(n) \
  case n:            \
    return launch<D, n>(q, items, album, artist, actx, artx, vals, ids, B, Mp, L, nblk, bound, s);
  switch (C) {
    ESR_SLOTS(1) ESR_SLOTS(2) ESR_SLOTS(3) ESR_SLOTS(4)
    ESR_SLOTS(5) ESR_SLOTS(6) ESR_SLOTS(7) ESR_SLOTS(8)
    default: return cudaErrorInvalidValue;
  }
#undef ESR_SLOTS
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. Preconditions (checked by the wrapper): B >= 1, 1 <= C <= 8,
// D in {32, 64, 128}, L a multiple of 128, Mp a multiple of L, 16-byte
// aligned items, album and artist, 4-byte aligned q (read as bf16 pairs),
// nblk = ceil(bound / L) <= Mp / L.
int esr_fused_affinity(int device, const void* q, const void* items,
                       const void* album, const void* artist,
                       const void* actx, const void* artx, void* vals,
                       void* ids, int B, int C, int D, long long Mp, int L,
                       int nblk, int bound, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || C < 1 || C > kMaxSlots || L % 128 != 0 || Mp % L != 0 ||
      L / kBins > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: err = launch_dim<32>(q, items, album, artist, actx, artx, vals, ids, B, C, Mp, L, nblk, bound, s); break;
    case 64: err = launch_dim<64>(q, items, album, artist, actx, artx, vals, ids, B, C, Mp, L, nblk, bound, s); break;
    case 128: err = launch_dim<128>(q, items, album, artist, actx, artx, vals, ids, B, C, Mp, L, nblk, bound, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
