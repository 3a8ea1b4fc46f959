// Row gather and pooled lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pool_kernel` of esrecsys_tpu/ops/lookup.py
// (launched by `fused_lookup_pool` and by `gather_rows`, its K=1 case with
// mask_id=-1). It computes the same function: for each output row b,
//   out[b] = sum over k of table[clamp(ids[b, k], 0, R-1)], slots whose id
//   equals mask_id skipped; with mean pooling, divided by max(count, 1),
// in float32. The TPU kernel's lane-packed slot select (a 128-lane
// physical view of D < 128 tables) is TPU layout only and is not ported.
//
// What bounds it: bytes. Each output row needs K table rows and writes one;
// no arithmetic to speak of. At the train step's shape (76,288 ids of a
// 32-wide float32 table, K=1) that is about 7-10 MB of distinct rows read
// plus 9.8 MB written, a few microseconds at 3.35 TB/s.
//
// Design: one thread per 16-byte piece of an output row, so the D/4 threads
// of a row read one row's pieces side by side (a 32-wide row is 8 threads,
// one 128-byte line; a warp serves four rows). Each thread walks the K ids
// of its row in order, skips masked slots, clamps the id, and sums float4
// pieces read through the read-only cache; no shared memory, no atomics.
// The sum runs in k order, as the reference's pooled sum does.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit): about
// 9 us of device time per launch at the step's shape with the L2 cache
// flushed, 1.8 times the byte bound, a fifth of `index_select`'s time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_pool_kernel(const float4* __restrict__ table,  // (R, D) as (R, P)
                   const int32_t* __restrict__ ids,   // (B, K)
                   float4* __restrict__ out,          // (B, D) as (B, P)
                   int B, int K, int P, long long R, int mask_id,
                   int mean) {
  // 32-bit index math: the launcher keeps B * P below 2^31
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t / P;
  if (b >= B) return;
  const int p = t - b * P;
  const int32_t* row_ids = ids + static_cast<long long>(b) * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int count = 0;
  for (int k = 0; k < K; ++k) {
    const int id = __ldg(row_ids + k);
    if (id == mask_id) continue;
    long long r = id < 0 ? 0 : id;
    r = r >= R ? R - 1 : r;
    const float4 v = __ldg(table + r * P + p);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    ++count;
  }
  if (mean) {
    const float c = static_cast<float>(count > 1 ? count : 1);
    acc.x /= c;
    acc.y /= c;
    acc.z /= c;
    acc.w /= c;
  }
  out[static_cast<long long>(b) * P + p] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. Preconditions (checked by the wrapper): B >= 1, K >= 0, D a
// positive multiple of 4, R >= 1, table and out 16-byte aligned; B * D / 4
// below 2^31.
int esr_gather_pool(int device, const void* table, const void* ids, void* out,
                    long long B, int K, int D, long long R, int mask_id,
                    int mean, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || K < 0 || D < 4 || D % 4 != 0 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = D / 4;
  const long long threads = B * P;
  if (threads + kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  gather_pool_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(ids),
      static_cast<float4*>(out), static_cast<int>(B), K, P, R, mask_id,
      mean);
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
