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
// The 2*B*D operations per item are far below the tensor cores' rate. A
// CTA owns 32 bins for a tile of 8 queries, so one max_batch=8 call streams
// the catalog exactly once, and each further tile of 8 queries streams it
// once more.
//
// Design: the grid is (L/32 bin tiles) x (ceil(B/8) query tiles), 128 CTAs
// at L=4096, about one per SM. A CTA is one producer warp and two consumer
// warps. The producer walks the catalog blocks in ascending order and
// fills a ring of eight shared-memory stages with each block's (D x 32)
// tile (64 contiguous bytes per catalog row d) and its 32 mask bytes,
// using 16-byte cp.async copies that arrive on the stage's "full"
// mbarrier; the consumers release a stage on its "empty" mbarrier. Each
// consumer warp scores its 16 bins against the 8 queries with tensor-core
// mma.sync m16n8k16 (bins are the rows, queries the columns, d the depth):
// the queries sit in registers as the B operand for the whole scan. The
// tile is read from shared memory as the A operand with ldmatrix.trans,
// which turns the (D, Mp) layout into row-major (bin, d) fragments. Each
// lane then holds four (bin, query) scores and folds them into the running
// (m1, id1, m2, id2) it keeps in registers, so no atomics and no cross-CTA
// reduction exist; the fold of block b overlaps the mma of block b+1.
// Shared rows are padded by 16 bytes so that the rows one instruction
// touches fall in distinct banks (the eight rows of an ldmatrix phase, 80
// bytes apart). An item's score is the same computation wherever its block
// lies, so copies of one vector in one bin score bit-identically and the
// tie rule carries over exactly.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit): about
// 134 us at the served shape, 1.55 times its byte bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 8;       // stages in the copy ring
constexpr int kConsumers = 2;    // consumer warps per CTA
constexpr int kThreads = 32 * (1 + kConsumers);  // + one producer warp
constexpr int kBins = 16 * kConsumers;  // bins per CTA: one mma M per warp
constexpr int kQueriesPerCta = 8;       // query tile: the mma's N

// Shared-memory layout: kStages tiles of (D x kBins) bf16 elements in rows
// padded by 16 bytes, then kStages rows of kBins mask bytes, then the full
// and empty barriers.
template <int D>
struct Layout {
  static constexpr int kRowBytes = kBins * 2 + 16;
  static constexpr int kTileBytes = D * kRowBytes;
  static constexpr int kMasks = kStages * kTileBytes;
  static constexpr int kBarriers = kMasks + kStages * kBins;
  static constexpr int kBytes = kBarriers + kStages * 16;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

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
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
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

// Issue the 16-byte copies of catalog block b's (D x kBins) tile for this
// CTA's bins and of its kBins mask bytes into stage `st`.
template <int D>
__device__ __forceinline__ void load_stage(unsigned char* smem, int st,
                                           const uint16_t* items,
                                           const uint8_t* mask, int b,
                                           long long Mp, int L, int bin0,
                                           int lane) {
  using Lay = Layout<D>;
  constexpr int kChunksPerRow = kBins * 2 / 16;
  unsigned char* tile = smem + st * Lay::kTileBytes;
  const long long col = static_cast<long long>(b) * L + bin0;
  const uint16_t* src = items + col;
#pragma unroll
  for (int c = lane; c < D * kChunksPerRow; c += 32) {
    const int d = c / kChunksPerRow;
    const int part = c % kChunksPerRow;
    cp_async16(tile + d * Lay::kRowBytes + part * 16,
               src + d * Mp + part * 8);
  }
  if (mask != nullptr && lane < kBins / 16) {
    cp_async16(smem + Lay::kMasks + st * kBins + 16 * lane,
               mask + col + 16 * lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const uint16_t* __restrict__ q,      // (B, D) bf16 bits
                  const uint16_t* __restrict__ items,  // (D, Mp) bf16 bits
                  const uint8_t* __restrict__ mask,    // (Mp,) or null
                  float* __restrict__ vals,            // (B, 2L)
                  int32_t* __restrict__ ids,           // (B, 2L)
                  int B, long long Mp, int L, int nblk, int bound) {
  using Lay = Layout<D>;
  constexpr int kSteps = D / 16;  // mma depth steps
  extern __shared__ __align__(16) unsigned char smem[];
  auto mtile = reinterpret_cast<uint8_t(*)[kBins]>(smem + Lay::kMasks);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kBarriers);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bin0 = blockIdx.x * kBins;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                // one per producer lane
      mbar_init(&empty[s], 32 * kConsumers);  // one per consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: fill stage b % kStages with block b once the consumers
    // have released the stage's previous block.
    for (int b = 0; b < nblk; ++b) {
      const int st = b % kStages;
      if (b >= kStages) mbar_wait(&empty[st], ((b / kStages) - 1) & 1);
      load_stage<D>(smem, st, items, mask, b, Mp, L, bin0, lane);
      cp_async_arrive(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warp c scores bins 16*c.. of the tile and folds the blocks in
  // ascending order; the mma of block b+1 is in flight while block b folds.
  const int wbin = 16 * (warp - 1);
  const int group = lane >> 2;  // accumulator rows group, group + 8
  const int pair = lane & 3;    // accumulator columns 2*pair, 2*pair + 1
  const int qbase = blockIdx.y * kQueriesPerCta;
  // B operand: query qbase+group, depth pairs (2*pair, +1) and (+8, +9)
  uint32_t bfrag[kSteps][2];
  const int qn = qbase + group;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = k * 16 + h * 8 + 2 * pair;
      bfrag[k][h] = qn < B ? *reinterpret_cast<const uint32_t*>(q + qn * D + d)
                           : 0u;
    }
  }
  // accumulator slot s: row group + 8*(s/2), query 2*pair + s%2
  float m1[4], m2[4];
  int id1[4], id2[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    m1[s] = -INFINITY;
    m2[s] = -INFINITY;
    id1[s] = 0;
    id2[s] = 0;
  }
  // ldmatrix row address of this lane: matrix lane/8 covers bins
  // 8*((lane/8)%2).. and depths 8*(lane/16).. of a 16x16 step.
  const int lm_d = (lane & 7) + 8 * (lane >> 4);
  const int lm_bin = wbin + 8 * ((lane >> 3) & 1);
  // the bins of accumulator rows group and group + 8
  const int rbin = wbin + group;
  constexpr int kRowStep = 8;

  // Block b's scores into (ca + cb), with its two row-validity flags; two
  // independent mma chains (even and odd depth steps).
  float ca[4], cb[4];
  bool ok_lo = false, ok_hi = false;
  auto issue = [&](int b) {
    const int st = b % kStages;
    mbar_wait(&full[st], (b / kStages) & 1);
    const int gid_lo = b * L + bin0 + rbin;
    ok_lo = gid_lo < bound && (mask == nullptr || mtile[st][rbin] != 0);
    ok_hi = gid_lo + kRowStep < bound &&
            (mask == nullptr || mtile[st][rbin + kRowStep] != 0);
    const unsigned char* tile = smem + st * Lay::kTileBytes;
    uint32_t a[kSteps][4];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      ldmatrix_x4_trans(a[k], tile + (k * 16 + lm_d) * Lay::kRowBytes +
                                  lm_bin * 2);
    }
    mbar_arrive(&empty[st]);  // the stage's data now sits in registers
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ca[s] = 0.f;
      cb[s] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      mma_bf16(k % 2 == 0 ? ca : cb, a[k], bfrag[k]);
    }
  };

  // slot s's score of the block just issued: the float32 sum, -inf past
  // the bound or under the mask
  auto score = [&](int s) {
    const float v = ca[s] + cb[s];
    return (s < 2 ? ok_lo : ok_hi) ? v : -INFINITY;
  };
  float cur[4];
  if (nblk > 0) {
    issue(0);
#pragma unroll
    for (int s = 0; s < 4; ++s) cur[s] = score(s);
  }
  for (int b = 0; b < nblk; ++b) {
    if (b + 1 < nblk) issue(b + 1);
    const int gid_lo = b * L + bin0 + rbin;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gid = gid_lo + kRowStep * (s >> 1);
      const float sv = cur[s];
      const bool better1 = sv > m1[s];
      const float loser_v = better1 ? m1[s] : sv;
      const int loser_i = better1 ? id1[s] : gid;
      if (better1) {
        m1[s] = sv;
        id1[s] = gid;
      }
      if (loser_v > m2[s]) {
        m2[s] = loser_v;
        id2[s] = loser_i;
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) cur[s] = score(s);
  }

#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int qi = qbase + 2 * pair + (s & 1);
    if (qi < B) {
      const int bin = bin0 + rbin + kRowStep * (s >> 1);
      const long long row = static_cast<long long>(qi) * 2 * L;
      vals[row + bin] = m1[s];
      vals[row + L + bin] = m2[s];
      ids[row + bin] = id1[s];
      ids[row + L + bin] = id2[s];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* items, const void* mask,
                   void* vals, void* ids, int B, long long Mp, int L,
                   int nblk, int bound, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kBytes;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_scan_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(L / kBins, (B + kQueriesPerCta - 1) / kQueriesPerCta);
  fused_scan_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(items),
      static_cast<const uint8_t*>(mask), static_cast<float*>(vals),
      static_cast<int32_t*>(ids), B, Mp, L, nblk, bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch
// was accepted. Preconditions (checked by the wrapper): B >= 1, D in
// {16, 32, 64, 128}, L a multiple of 128, Mp a multiple of L, 16-byte
// aligned items and mask, 4-byte aligned q (read as bf16 pairs),
// nblk = ceil(bound / L) <= Mp / L.
int esr_fused_scan(int device, const void* q, const void* items,
                   const void* mask, void* vals, void* ids, int B, int D,
                   long long Mp, int L, int nblk, int bound, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || L % kBins != 0 || Mp % L != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: err = launch<16>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 32: err = launch<32>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 64: err = launch<64>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    case 128: err = launch<128>(q, items, mask, vals, ids, B, Mp, L, nblk, bound, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
