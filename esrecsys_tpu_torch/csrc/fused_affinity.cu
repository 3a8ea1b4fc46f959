// Fused playlist-affinity scan+select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_affinity_kernel` of
// esrecsys_tpu/retrieval/fused.py (launched by `binned_affinity_candidates`,
// the full-corpus eval's candidate scan). It computes the same function: for
// each query b with C context slots and each catalog item g below `bound`,
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
// the 2,265,088-column catalog is 2*B*C*D*M = 2.97e12 bf16 operations,
// 3.0 ms at the H100 SXM's 989 TFLOP/s, while reading the catalog once
// takes 0.09 ms. Besides the products, every (query, item) pair pays the
// max over C slots, 2C id compares for the boosts and the top-2 fold on the
// CUDA cores, which costs about as much again.
//
// Design: fused_scan.cu's, widened in queries. The grid is (ceil(B/64)
// query tiles) x (L/32 bin tiles); a CTA owns 32 bins for 64 queries and
// walks every catalog block in ascending order, so each bin's fold is one
// thread's sequential loop: the tie rule holds exactly, with no atomics and
// no cross-CTA merge. A CTA is one producer warp and four consumer warps.
// The producer fills a ring of six shared-memory stages with each block's
// (D x 32) catalog tile and its 32 album and artist ids by 16-byte cp.async
// copies that arrive on the stage's "full" mbarrier; consumers release a
// stage on its "empty" mbarrier once its data sit in registers. The CTA's
// 64 queries (C x 64 x D bf16) and their context ids are copied to shared
// memory once. Consumer warp w scores 16 bins (w mod 2) against 32 queries
// (w div 2) with tensor-core mma.sync m16n8k16: bins are the rows (the
// catalog tile through ldmatrix.trans, as in fused_scan), 8 queries of one
// context slot the columns (ldmatrix from the query rows), d the depth.
// Each lane keeps the running max over the C slots for its 2 bins x 2
// queries of each 8-query group, adds the boosts and folds into the
// (m1, id1, m2, id2) registers it holds for the whole scan. The 32 CTAs of
// one bin tile run side by side (query tiles vary fastest), so each catalog
// tile comes from device memory about once and from the L2 cache for the
// other query tiles: at B=2048 the catalog is read 32 times, 9.3 GB through
// L2. Every item's score is the same instruction sequence wherever its block
// lies, so copies of one vector score bit-identically and the tie rule
// carries over exactly.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit): about
// 17.6 ms at the eval batch, 5.9 times the operation bound. The consumers
// stall on the dependent mma chains, the id compares and the top-2 fold at
// two warps per scheduler (two CTAs per SM, by registers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 6;       // stages in the copy ring
constexpr int kConsumers = 4;    // consumer warps per CTA
constexpr int kThreads = 32 * (1 + kConsumers);  // + one producer warp
constexpr int kBins = 32;        // bins per CTA: two halves of 16 (mma M)
constexpr int kQueries = 64;     // queries per CTA: two halves of 32
constexpr int kGroups = 4;       // 8-query groups (mma N) per consumer warp
constexpr int kMaxSlots = 8;     // context slots the kernel takes
constexpr int kRow = kBins + 8;  // padded catalog tile row, bf16 elements
constexpr size_t kMaxSmem = 232448;

template <int D>
struct Layout {
  static constexpr int kTileBytes = D * kRow * 2;
  static constexpr int kStageBytes = kTileBytes + 2 * kBins * 4;
  static constexpr int kQRow = D + 8;  // padded query row, bf16 elements
  __host__ __device__ static constexpr size_t queries() { return kStages * kStageBytes; }
  __host__ __device__ static size_t ctx(int C) {
    return queries() + static_cast<size_t>(C) * kQueries * kQRow * 2;
  }
  __host__ __device__ static size_t bars(int C) { return ctx(C) + 2 * kQueries * kMaxSlots * 4; }
  __host__ __device__ static size_t bytes(int C) { return bars(C) + 2 * kStages * 8; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
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

// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
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

// Four 8x8 bf16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(smem)));
}

// Four 8x8 bf16 matrices as they lie (rows of 8 consecutive elements).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(smem)));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
fused_affinity_kernel(const uint16_t* __restrict__ q,      // (B, C, D) bf16
                      const uint16_t* __restrict__ items,  // (D, Mp) bf16
                      const int32_t* __restrict__ album,   // (Mp,)
                      const int32_t* __restrict__ artist,  // (Mp,)
                      const int32_t* __restrict__ actx,    // (B, C)
                      const int32_t* __restrict__ artx,    // (B, C)
                      float* __restrict__ vals,            // (B, 2L)
                      int32_t* __restrict__ ids,           // (B, 2L)
                      int B, long long Mp, int L, int nblk, int bound) {
  using Lay = Layout<D>;
  constexpr int kSteps = D / 16;  // mma depth steps
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem + Lay::queries());
  int32_t* sctx = reinterpret_cast<int32_t*>(smem + Lay::ctx(C));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bars(C));
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qbase = blockIdx.x * kQueries;
  const int bin0 = blockIdx.y * kBins;

  // The CTA's queries, [c][query][d] with padded rows (zeros past B), and
  // their context ids, [kind][query][slot] (-1 past B: it never equals a
  // catalog id, whose padding is -2).
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < C * kQueries * kPairs; i += kThreads) {
    const int c = i / (kQueries * kPairs);
    const int rest = i - c * kQueries * kPairs;
    const int qi = rest / kPairs;
    const int dp = rest - qi * kPairs;
    const int gq = qbase + qi;
    uint32_t v = 0u;
    if (gq < B) {
      v = *reinterpret_cast<const uint32_t*>(
          q + (static_cast<long long>(gq) * C + c) * D + 2 * dp);
    }
    *reinterpret_cast<uint32_t*>(
        qs + (static_cast<size_t>(c) * kQueries + qi) * Lay::kQRow + 2 * dp) =
        v;
  }
  for (int i = threadIdx.x; i < kQueries * kMaxSlots; i += kThreads) {
    const int qi = i / kMaxSlots;
    const int c = i - qi * kMaxSlots;
    const int gq = qbase + qi;
    const bool real = gq < B && c < C;
    const long long at = static_cast<long long>(gq) * C + c;
    sctx[i] = real ? actx[at] : -1;
    sctx[kQueries * kMaxSlots + i] = real ? artx[at] : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // one per producer lane
      mbar_init(&empty[s], 32 * kConsumers);  // one per consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: fill stage b % kStages with block b's tile and ids once the
    // consumers have released the stage's previous block.
    constexpr int kChunksPerRow = kBins * 2 / 16;
    for (int b = 0; b < nblk; ++b) {
      const int st = b % kStages;
      if (b >= kStages) mbar_wait(&empty[st], ((b / kStages) - 1) & 1);
      unsigned char* stage = smem + st * Lay::kStageBytes;
      uint16_t* tile = reinterpret_cast<uint16_t*>(stage);
      int32_t* pay = reinterpret_cast<int32_t*>(stage + Lay::kTileBytes);
      const long long col = static_cast<long long>(b) * L + bin0;
#pragma unroll
      for (int c = lane; c < D * kChunksPerRow; c += 32) {
        const int d = c / kChunksPerRow;
        const int part = c % kChunksPerRow;
        cp_async16(tile + d * kRow + part * 8, items + d * Mp + col + part * 8);
      }
      if (lane < 16) {  // 8 copies of album ids, then 8 of artist ids
        const int32_t* src = (lane < 8 ? album : artist) + col + 4 * (lane & 7);
        cp_async16(pay + (lane >> 3) * kBins + 4 * (lane & 7), src);
      }
      cp_async_arrive(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warp: bins wbin.. of the tile, queries qh*32.. of the CTA.
  const int cw = warp - 1;
  const int wbin = 16 * (cw & 1);
  const int qh = cw >> 1;
  const int group = lane >> 2;  // accumulator rows group, group + 8
  const int pair = lane & 3;    // accumulator columns 2*pair, 2*pair + 1
  const int32_t* s_alb = sctx;
  const int32_t* s_art = sctx + kQueries * kMaxSlots;
  // accumulator slot s: bin row group + 8*(s/2), query 2*pair + s%2
  float m1[kGroups][4], m2[kGroups][4];
  int id1[kGroups][4], id2[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      m1[g][s] = -INFINITY;
      m2[g][s] = -INFINITY;
      id1[g][s] = 0;
      id2[g][s] = 0;
    }
  }
  // ldmatrix row address of this lane: for the catalog (A, transposed),
  // matrix lane/8 covers bins 8*((lane/8)%2).. and depths 8*(lane/16)..;
  // for the queries (B), matrix lane/8 covers depths 8*(lane/8).. of row
  // lane%8 (one query each)
  const int lm_d = (lane & 7) + 8 * (lane >> 4);
  const int lm_bin = wbin + 8 * ((lane >> 3) & 1);
  const uint16_t* q_lane = qs + (qh * 32 + (lane & 7)) * Lay::kQRow +
                           8 * (lane >> 3);

  for (int b = 0; b < nblk; ++b) {
    const int st = b % kStages;
    mbar_wait(&full[st], (b / kStages) & 1);
    const unsigned char* stage = smem + st * Lay::kStageBytes;
    const uint16_t* tile = reinterpret_cast<const uint16_t*>(stage);
    const int32_t* pay =
        reinterpret_cast<const int32_t*>(stage + Lay::kTileBytes);
    uint32_t a[kSteps][4];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      ldmatrix_x4_trans(a[k], tile + (k * 16 + lm_d) * kRow + lm_bin);
    }
    const int alb_lo = pay[wbin + group];
    const int alb_hi = pay[wbin + group + 8];
    const int art_lo = pay[kBins + wbin + group];
    const int art_hi = pay[kBins + wbin + group + 8];
    mbar_arrive(&empty[st]);  // the stage's data now sit in registers
    const int gid_lo = b * L + bin0 + wbin + group;
    const bool ok_lo = gid_lo < bound;
    const bool ok_hi = gid_lo + 8 < bound;

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      // C independent mma chains, one per context slot, interleaved over
      // the depth steps so their latencies overlap
      float acc[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[c][s] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps / 2; ++kk) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          uint32_t bq[4];
          ldmatrix_x4(bq, q_lane + (c * kQueries + g * 8) * Lay::kQRow +
                              kk * 32);
          mma_bf16(acc[c], a[2 * kk], bq[0], bq[1]);
          mma_bf16(acc[c], a[2 * kk + 1], bq[2], bq[3]);
        }
      }
      float best[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        best[s] = acc[0][s];
#pragma unroll
        for (int c = 1; c < C; ++c) best[s] = fmaxf(best[s], acc[c][s]);
      }
      // membership boosts of this lane's two queries q0, q0 + 1
      const int q0 = qh * 32 + g * 8 + 2 * pair;
      bool in_alb[4] = {false, false, false, false};
      bool in_art[4] = {false, false, false, false};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int a0 = s_alb[q0 * kMaxSlots + c];
        const int a1 = s_alb[(q0 + 1) * kMaxSlots + c];
        const int r0 = s_art[q0 * kMaxSlots + c];
        const int r1 = s_art[(q0 + 1) * kMaxSlots + c];
        in_alb[0] |= a0 == alb_lo;
        in_alb[1] |= a1 == alb_lo;
        in_alb[2] |= a0 == alb_hi;
        in_alb[3] |= a1 == alb_hi;
        in_art[0] |= r0 == art_lo;
        in_art[1] |= r1 == art_lo;
        in_art[2] |= r0 == art_hi;
        in_art[3] |= r1 == art_hi;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float sv = best[s] + (in_alb[s] ? 0.1f : 0.0f);
        sv = sv + (in_art[s] ? 0.1f : 0.0f);
        sv = (s < 2 ? ok_lo : ok_hi) ? sv : -INFINITY;
        const int gid = gid_lo + 8 * (s >> 1);
        const bool better1 = sv > m1[g][s];
        const float loser_v = better1 ? m1[g][s] : sv;
        const int loser_i = better1 ? id1[g][s] : gid;
        if (better1) {
          m1[g][s] = sv;
          id1[g][s] = gid;
        }
        if (loser_v > m2[g][s]) {
          m2[g][s] = loser_v;
          id2[g][s] = loser_i;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int qi = qbase + qh * 32 + g * 8 + 2 * pair + (s & 1);
      if (qi < B) {
        const int bin = bin0 + wbin + group + 8 * (s >> 1);
        const long long row = static_cast<long long>(qi) * 2 * L;
        vals[row + bin] = m1[g][s];
        vals[row + L + bin] = m2[g][s];
        ids[row + bin] = id1[g][s];
        ids[row + L + bin] = id2[g][s];
      }
    }
  }
}

template <int D, int C>
cudaError_t launch(const void* q, const void* items, const void* album,
                   const void* artist, const void* actx, const void* artx,
                   void* vals, void* ids, int B, long long Mp, int L,
                   int nblk, int bound, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes(C);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_affinity_kernel<D, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((B + kQueries - 1) / kQueries, L / kBins);
  fused_affinity_kernel<D, C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(items),
      static_cast<const int32_t*>(album), static_cast<const int32_t*>(artist),
      static_cast<const int32_t*>(actx), static_cast<const int32_t*>(artx),
      static_cast<float*>(vals), static_cast<int32_t*>(ids), B, Mp, L, nblk,
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
