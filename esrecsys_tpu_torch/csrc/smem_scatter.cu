// Row scatter-add through per-CTA shared-memory sums, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vmem_scatter_kernel` of
// esrecsys_tpu/ops/scatter.py:240 (launched by `vmem_scatter_add_phys`). It
// computes table.at[ids].add(updates) in float32, in place: unsorted ids,
// duplicates summed. The TPU kernel copies the whole (packed) table into
// VMEM, streams the update rows through once with one serial
// read-modify-write each, and writes the table back. Here the table is cut
// by row range over one wave of CTAs, one CTA per SM, and each CTA sums
// its range's updates in shared memory; a table whose range per CTA does
// not fit one block's opt-in shared memory is refused by the wrapper, as
// the TPU refuses a table past VMEM. Ids outside [0, R) are dropped; the
// TPU kernel does not guard them.
//
// What bounds it: bytes. In place, the function must read and write only
// the rows its ids touch and read the update rows and the ids once: at the
// flagship album table (100,096 x 32 float32) and the train step's 76,288
// uniform ids, 53k distinct rows, 2 x 6.8 MB + 9.8 MB + 0.3 MB, about 7 us
// at the H100 SXM's published 3.35 TB/s.
//
// Two launches on one stream:
//  1. bin_kernel: CTA b takes the b-th chunk of ids, counts them by owner
//     (the CTA whose row range holds the id) with shared-memory integer
//     atomics, and writes them into its chunk of a scratch list sorted by
//     owner, as (update index, row within the owner's range), with a count
//     and an offset for each (owner, chunk). Every id is read by one CTA.
//  2. add_kernel: CTA o asks the L2 cache for chunk o's update rows (one
//     bulk prefetch), fills its slice of shared memory with -0.0, and each
//     warp takes a share of the chunks' lists for owner o and adds their
//     update rows into the slice, four 16-byte loads in flight per lane
//     before their adds. Last, it adds the touched elements of the slice
//     into the table: no untouched row is read or written.
// What that does about the previous design's three costs (it copied the
// whole table in and out, every CTA read every id, and every update was a
// float32 compare-and-swap loop in shared memory with eight rows in flight
// per warp): no whole-table copy; each id read once; a lane's four loads
// are issued before any add, and its pieces of one row (whenever a row's
// pieces divide 32) are one piece of successive hits, so a lane sums a run
// of hits on one row in registers and adds the run with one 64-bit
// compare-and-swap per pair of floats: two per float4 where the previous
// design took four, and one per run where every id is the same.
//
// Numbers: an element of the slice starts at -0.0 because -0.0 + u == u
// exactly and x + -0.0 == x for every x: an element with one update comes
// out bit-equal to table + u, and an element still -0.0 needs no write.
// Elements with duplicates come out as table + (sum of their updates), the
// sum taken in an order that changes from run to run (runs in registers,
// then atomics), where the TPU's serial loop adds each update to the table
// in one order: the two agree to float32 rounding of those sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;  // pieces a lane loads before adding them
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegZero = 0x80000000u;  // bits of -0.0f

// Inclusive prefix sum of v over the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v += y;
  }
  return v;
}

// Exclusive prefix sum of v over the block's threads in order; `sums` is
// shared scratch of kWarps ints. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sums[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kWarps) sums[lane] = wi - w;
  }
  __syncthreads();
  return sums[warp] + incl - v;
}

__global__ void __launch_bounds__(kThreads)
bin_kernel(const int32_t* __restrict__ ids,  // (n,)
           int2* __restrict__ pairs,         // (n,) out
           int* __restrict__ seg,  // (2, owners, chunks) out: counts, offsets
           int n, int R, int rows_per_cta, int ctas, int chunk) {
  __shared__ int cursor[kThreads];  // per owner
  __shared__ int sums[kWarps];
  const int b = blockIdx.x;
  const int c0 = b * chunk;
  const int c1 = min(n, c0 + chunk);
  if (threadIdx.x < ctas) cursor[threadIdx.x] = 0;
  __syncthreads();
  for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
    const int id = __ldg(ids + i);
    if (id >= 0 && id < R) atomicAdd(&cursor[id / rows_per_cta], 1);
  }
  __syncthreads();
  const int o = threadIdx.x;
  const int count = o < ctas ? cursor[o] : 0;
  const int start = block_exclusive_scan(count, sums);
  if (o < ctas) {
    seg[o * ctas + b] = count;
    seg[(ctas + o) * ctas + b] = start;
    cursor[o] = start;
  }
  __syncthreads();
  for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
    const int id = __ldg(ids + i);
    if (id >= 0 && id < R) {
      const int owner = id / rows_per_cta;
      const int p = atomicAdd(&cursor[owner], 1);
      pairs[c0 + p] = make_int2(i, id - owner * rows_per_cta);
    }
  }
}

template <typename V>
struct Piece;

template <>
struct Piece<float> {
  static __device__ __forceinline__ float neg_zero() {
    return __uint_as_float(kNegZero);
  }
  static __device__ __forceinline__ bool touched(float v) {
    return __float_as_uint(v) != kNegZero;
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ void atomic_add(float* at, float v, int) {
    atomicAdd(at, v);
  }
};

template <>
struct Piece<float4> {
  static __device__ __forceinline__ float4 neg_zero() {
    const float z = __uint_as_float(kNegZero);
    return make_float4(z, z, z, z);
  }
  static __device__ __forceinline__ bool touched(float4 v) {
    return (__float_as_uint(v.x) != kNegZero) |
           (__float_as_uint(v.y) != kNegZero) |
           (__float_as_uint(v.z) != kNegZero) |
           (__float_as_uint(v.w) != kNegZero);
  }
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  // adds (x, y) and (z, w), each with one 64-bit compare-and-swap loop,
  // the pair `rot` (mod 2) first
  static __device__ __forceinline__ void atomic_add(float* at, float4 v,
                                                    int rot) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = (k + rot) & 1;
      const float a = e ? v.z : v.x;
      const float b = e ? v.w : v.y;
      auto* p = reinterpret_cast<unsigned long long*>(at + 2 * e);
      unsigned long long old = *p, seen;
      do {
        seen = old;
        const float2 cur = *reinterpret_cast<const float2*>(&seen);
        const float2 sum = make_float2(cur.x + a, cur.y + b);
        old = atomicCAS(p, seen,
                        *reinterpret_cast<const unsigned long long*>(&sum));
      } while (old != seen);
    }
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
add_kernel(float* __restrict__ table,          // (R, D), updated
           const float* __restrict__ updates,  // (n, D)
           const int2* __restrict__ pairs,     // from bin_kernel
           const int* __restrict__ seg,        // from bin_kernel
           int n, int D, int R, int rows_per_cta, int ctas, int chunk) {
  extern __shared__ __align__(16) float slice[];  // (rows, D)
  using P = Piece<V>;
  // ask the L2 cache for this CTA's chunk of update rows (some other
  // CTA's hits, mostly) while the slice fills and the hit lists load
  if (threadIdx.x == 0 && D % 4 == 0) {
    const int c0 = blockIdx.x * chunk;
    const int c1 = min(n, c0 + chunk);
    if (c1 > c0) {
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                       updates + static_cast<long long>(c0) * D),
                   "r"((c1 - c0) * D * 4)
                   : "memory");
    }
  }
  constexpr int kV = sizeof(V) / 4;
  const int o = blockIdx.x;
  const int r0 = o * rows_per_cta;
  const int rows = min(rows_per_cta, R - r0);
  const int per_row = D / kV;  // pieces of a row
  const int pieces = rows * per_row;
  V* sv = reinterpret_cast<V*>(slice);
  for (int e = threadIdx.x; e < pieces; e += kThreads) sv[e] = P::neg_zero();
  __syncthreads();

  // warp w takes the chunks w, w + 32, ...: lane s holds chunk w + 32 s's
  // count and offset for this owner, and the warp walks their hits as one
  // list
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nseg = warp < ctas ? (ctas - warp + kWarps - 1) / kWarps : 0;
  const int my_b = warp + kWarps * lane;
  const int cnt = lane < nseg ? seg[o * ctas + my_b] : 0;
  const int off = lane < nseg ? seg[(ctas + o) * ctas + my_b] : 0;
  const int incl = warp_inclusive_scan(cnt);
  const int excl = incl - cnt;
  const int total = __shfl_sync(kFull, incl, 31);
  // a lane's pieces are one piece of successive hits whenever a row's
  // pieces divide 32: it sums a run of hits on one row in registers and
  // adds the run to the slice once (pile-ups cost one atomic per run)
  int run_at = -1;
  V run = P::neg_zero();
  for (int h0 = 0; h0 < total; h0 += 32) {
    // lane t takes hit h0 + t: its chunk is the last whose list starts at
    // or before it (that one is not empty)
    const int h = h0 + lane;
    int s = 0;
    for (int q = 1; q < nseg; ++q) {
      if (__shfl_sync(kFull, excl, q) <= h) s = q;
    }
    const int s_excl = __shfl_sync(kFull, excl, s);
    const int s_off = __shfl_sync(kFull, off, s);
    int2 hit = make_int2(0, 0);
    if (h < total) {
      hit = pairs[static_cast<long long>(warp + kWarps * s) * chunk + s_off +
                  (h - s_excl)];
    }
    const int items = min(32, total - h0) * per_row;
    for (int w0 = 0; w0 < items; w0 += 32 * kInFlight) {
      V x[kInFlight];
      int at[kInFlight];  // 4 x slice offset + rotation, -1 for none
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int w = w0 + 32 * q + lane;
        const int j = w / per_row;
        const int p = w - j * per_row;
        const int i = __shfl_sync(kFull, hit.x, j & 31);
        const int r = __shfl_sync(kFull, hit.y, j & 31);
        const bool live = w < items;
        x[q] = live ? __ldg(reinterpret_cast<const V*>(
                          updates + static_cast<long long>(i) * D) + p)
                    : P::neg_zero();
        at[q] = live ? (r * per_row + p) * kV * 4 + (j & 3) : -1;
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (at[q] < 0) continue;
        if (at[q] >> 2 == run_at >> 2) {
          run = P::add(run, x[q]);
        } else {
          if (run_at >= 0) {
            P::atomic_add(slice + (run_at >> 2), run, run_at & 3);
          }
          run_at = at[q];
          run = x[q];
        }
      }
    }
  }
  if (run_at >= 0) P::atomic_add(slice + (run_at >> 2), run, run_at & 3);
  __syncthreads();

  // write back the touched pieces: table += slice
  V* tv = reinterpret_cast<V*>(table + static_cast<long long>(r0) * D);
  for (int e0 = threadIdx.x; e0 < pieces; e0 += kThreads * kInFlight) {
    V d[kInFlight], t[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int e = e0 + q * kThreads;
      d[q] = e < pieces ? sv[e] : P::neg_zero();
      if (P::touched(d[q])) t[q] = tv[e];
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (P::touched(d[q])) tv[e0 + q * kThreads] = P::add(t[q], d[q]);
    }
  }
}

template <typename V>
int launch_add(float* table, const float* updates, const int2* pairs,
               const int* seg, int n, int D, int R, int rows_per_cta,
               int ctas, int chunk, cudaStream_t stream) {
  const int bytes = rows_per_cta * D * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      add_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_kernel<V><<<ctas, kThreads, bytes, stream>>>(
      table, updates, pairs, seg, n, D, R, rows_per_cta, ctas, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`: `ctas` CTAs of `rows_per_cta` table
// rows each, with rows_per_cta * D * 4 bytes of dynamic shared memory for
// the second. `scratch` holds n * 2 + 2 * ctas * ctas int32, written
// before it is read: the (update index, row) pairs, then the counts and
// offsets. Returns a CUDA error code: 0 when both launches were accepted.
// Preconditions (checked by the wrapper): n, D, R >= 1; ctas <= 1024;
// ctas * rows_per_cta >= R; contiguous float32 table and updates, 16-byte
// aligned when D % 4 == 0; int32 ids; R * D and n * D below 2^31.
int esr_smem_scatter(int device, void* table, const void* ids,
                     const void* updates, void* scratch, int n, int D, int R,
                     int rows_per_cta, int ctas, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || D < 1 || R < 1 || rows_per_cta < 1 || ctas < 1 ||
      ctas > kThreads || static_cast<long long>(ctas) * rows_per_cta < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = (n + ctas - 1) / ctas;
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  auto* u = static_cast<const float*>(updates);
  auto* p = static_cast<int2*>(scratch);
  auto* g = reinterpret_cast<int*>(p + n);
  bin_kernel<<<ctas, kThreads, 0, s>>>(static_cast<const int32_t*>(ids), p,
                                       g, n, R, rows_per_cta, ctas, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return D % 4 == 0
             ? launch_add<float4>(t, u, p, g, n, D, R, rows_per_cta, ctas,
                                  chunk, s)
             : launch_add<float>(t, u, p, g, n, D, R, rows_per_cta, ctas,
                                 chunk, s);
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
