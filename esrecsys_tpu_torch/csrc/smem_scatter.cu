// Row scatter-add into a table held in shared memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vmem_scatter_kernel` of
// esrecsys_tpu/ops/scatter.py (launched by `vmem_scatter_add_phys`). It
// computes table.at[ids].add(updates) in float32, in place: unsorted ids,
// duplicates summed. The TPU kernel copies the whole (packed) table into
// VMEM once, streams the update rows through once with one serial
// read-modify-write each, and writes the table back once, so no update
// costs a device-memory round trip. That needs the table to fit on chip,
// and so does this kernel: a table larger than the shared memory of one
// wave of CTAs is refused by the wrapper. Ids outside [0, R) are dropped;
// the TPU kernel does not guard them.
//
// What bounds it: bytes. In place, the function must read and write only
// the rows its ids touch and read the update rows and the ids once: at the
// flagship album table (100,096 x 32 float32) and the train step's 76,288
// uniform ids, about 53k distinct rows, 2 x 6.8 MB + 9.8 MB + 0.3 MB, about
// 7 us at the H100 SXM's published 3.35 TB/s. This design also copies the
// untouched rows in and out (the whole 12.8 MB table each way, about 11 us
// in all): that is its cost, not the function's.
//
// Design: the table is cut by row range over one wave of CTAs, one CTA per
// SM, each slice at most the card's opt-in shared memory per block. A CTA
// of 1024 threads (1) copies its slice into shared memory, (2) walks all n
// ids, 512 at a time per warp, gathers the ids in its range into a list
// (ballots, and a shuffle from the lane that read each), and adds their
// update rows into the slice with shared-memory float32 atomics, the whole
// warp on one row at a time (lane e adds element e) with eight rows'
// loads in flight before their atomics, and (3) writes the slice back once.
// Every id is read by every CTA, from the L2 cache after the first; each
// update row is read by the one CTA that owns its id. The atomics sum the
// duplicates of a row in an order that changes from run to run, where the
// TPU's serial loop has one order: results agree to float32 rounding of
// those sums. Shared-memory float32 atomics compile to compare-and-swap
// loops on sm_90 (ATOMS.CAST.SPIN); each lane's address is its own, so
// each loop ends on its first try unless two warps add to one row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 16;   // id batches of 32 a warp reads per pass
constexpr int kInFlight = 8;  // update rows loaded before their atomics
constexpr unsigned kFull = 0xffffffffu;

// Copy `count` floats; as float4 when both sides are 16-byte aligned.
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int count, bool vec4) {
  if (vec4) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 8
    for (int e = threadIdx.x; e < count / 4; e += kThreads) d4[e] = s4[e];
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
  }
}

// Position of the k-th (from 0) set bit of m; m holds more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(kThreads)
smem_scatter_kernel(float* __restrict__ table,          // (R, D), updated
                    const int32_t* __restrict__ ids,    // (n,)
                    const float* __restrict__ updates,  // (n, D)
                    int n, int D, int R, int rows_per_cta) {
  extern __shared__ __align__(16) float slice[];  // (rows, D)
  const int r0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, R - r0);
  float* own = table + static_cast<long long>(r0) * D;
  const bool vec4 = D % 4 == 0;  // rows and slices 16-byte aligned then
  copy_floats(slice, own, rows * D, vec4);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int base = warp * 32 * kWindow; base < n;
       base += kWarps * 32 * kWindow) {
    // this window's ids, each as its slice row or -1 when not ours
    int row[kWindow];
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      const int i = base + 32 * u + lane;
      const int id = i < n ? __ldg(ids + i) : -1;
      row[u] = id >= r0 && id < r0 + rows ? id - r0 : -1;
    }
    int total = 0;
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      total += __popc(__ballot_sync(kFull, row[u] >= 0));
    }
    // the window's hits in id order, 32 at a time: lane t takes hit t0 + t
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int my_i = 0, my_row = 0, before = 0;
#pragma unroll
      for (int u = 0; u < kWindow; ++u) {
        const unsigned hits = __ballot_sync(kFull, row[u] >= 0);
        const int c = __popc(hits);
        const bool in = t >= before && t < before + c;
        const int src = in ? nth_set_bit(hits, t - before) : lane;
        const int r = __shfl_sync(kFull, row[u], src);
        if (in) {
          my_i = base + 32 * u + src;
          my_row = r;
        }
        before += c;
      }
      // the whole warp adds each hit's row: lane e takes element e, so one
      // load is one 128-byte line and 32 atomics fall in 32 banks
      const int count = min(32, total - t0);
      for (int j0 = 0; j0 < count; j0 += kInFlight) {
        for (int e0 = 0; e0 < D; e0 += 32) {
          const int e = e0 + lane;
          float x[kInFlight];
          int at[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            const int j = (j0 + q) & 31;
            const int ii = __shfl_sync(kFull, my_i, j);
            at[q] = __shfl_sync(kFull, my_row, j) * D + e;
            x[q] = j0 + q < count && e < D
                       ? __ldg(updates + static_cast<long long>(ii) * D + e)
                       : 0.f;
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            if (j0 + q < count && e < D) atomicAdd(slice + at[q], x[q]);
          }
        }
      }
    }
  }
  __syncthreads();
  copy_floats(own, slice, rows * D, vec4);
}

}  // namespace

extern "C" {

// Launches `ctas` CTAs of `rows_per_cta` table rows each on `stream`, with
// rows_per_cta * D * 4 bytes of dynamic shared memory, and returns a CUDA
// error code: 0 when the launch was accepted. Preconditions (checked by the
// wrapper): n, D, R >= 1; ctas * rows_per_cta >= R; contiguous float32
// table and updates, int32 ids; R * D below 2^31.
int esr_smem_scatter(int device, void* table, const void* ids,
                     const void* updates, int n, int D, int R,
                     int rows_per_cta, int ctas, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || D < 1 || R < 1 || rows_per_cta < 1 || ctas < 1 ||
      static_cast<long long>(ctas) * rows_per_cta < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = rows_per_cta * D * 4;
  err = cudaFuncSetAttribute(smem_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_scatter_kernel<<<ctas, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(updates), n, D, R, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
