// Row gather and pooled lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pool_kernel` of esrecsys_tpu/ops/lookup.py
// (launched by `fused_lookup_pool` and by `gather_rows`, its K=1 case with
// mask_id=-1). It computes the same function: for each output row b,
//   out[b] = sum over k of table[clamp(ids[b, k], 0, R-1)], slots whose id
//   equals mask_id skipped; with mean pooling, divided by max(count, 1),
// in float32. The TPU kernel's lane-packed slot select (a 128-lane
// physical view of D < 128 tables) is TPU layout only and is not ported.
// A bf16 table gives float32 sums of its rows widened exactly to float32,
// as the reference's callers widen `take` of bf16 rows
// (esrecsys_tpu/tools/scale_table.py: `.astype(jnp.float32)`).
//
// What bounds it: bytes. Each output row needs K table rows and writes one;
// no arithmetic to speak of. At the train step's shape (76,288 ids of a
// 32-wide float32 table, K=1) that is about 7-10 MB of distinct rows read
// plus 9.8 MB written, a few microseconds at 3.35 TB/s.
//
// Design: three instantiations, no shared memory, no atomics; each thread
// walks the K ids of its row in order, skips masked slots, clamps the id
// and sums in k order, as the reference's pooled sum does. Row offsets are
// 64-bit (a 100M x 32 table passes 2^31 elements).
//  - float32 rows, D a multiple of 4, table 16-byte aligned: one thread
//    per 16-byte piece (float4) of an output row, so the D/4 threads of a
//    row read one row's pieces side by side (a 32-wide row is 8 threads,
//    one 128-byte line; a warp serves four rows), through the read-only
//    cache.
//  - bf16 rows, D a multiple of 8, table 16-byte aligned: one thread per
//    16-byte piece of 8 bf16, widened to float32 in registers (a bf16 is
//    the high half of its float32), two float4 stores. These two are one
//    kernel, templated on the piece.
//  - narrow rows: any D (GloVe's bias table is 1 wide), any 2- or 4-byte
//    aligned table, float32 or bf16: one thread per output element,
//    scalar loads.
// The wrapper (kernels/gather_pool.py `launch_plan`) picks the
// instantiation.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit): about
// 9 us of device time per launch at the step's shape with the L2 cache
// flushed, 1.8 times the byte bound, a fifth of `index_select`'s time
// (float32 instantiation; the others' times are in PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// instantiations, as kernels/gather_pool.py numbers them
constexpr int kF32x4 = 0;
constexpr int kBf16x8 = 1;
constexpr int kNarrowF32 = 2;
constexpr int kNarrowBf16 = 3;

__device__ __forceinline__ long long clamp_row(int id, long long R) {
  long long r = id < 0 ? 0 : id;
  return r >= R ? R - 1 : r;
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A thread's 16-byte piece of a table row: kElems elements, widened to
// float32 and added into `acc` (`add`).
struct F32Piece {  // 4 floats
  static constexpr int kElems = 4;
  __device__ static void add(float* acc, uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
};

struct Bf16Piece {  // 8 bf16
  static constexpr int kElems = 8;
  __device__ static void add(float* acc, uint4 v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[2 * j] += bf16_lo(w[j]);
      acc[2 * j + 1] += bf16_hi(w[j]);
    }
  }
};

template <class Piece>
__global__ void __launch_bounds__(kThreads)
gather_piece_kernel(const uint4* __restrict__ table,  // (R, D) as (R, P)
                    const int32_t* __restrict__ ids,  // (B, K)
                    float4* __restrict__ out,         // (B, D) as float4s
                    int B, int K, int P, long long R, int mask_id,
                    int mean) {
  // 32-bit index math: the launcher keeps B * D below 2^31
  constexpr int kOut = Piece::kElems / 4;  // float4s a thread writes
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t / P;
  if (b >= B) return;
  const int p = t - b * P;
  const int32_t* row_ids = ids + static_cast<long long>(b) * K;
  float acc[Piece::kElems];
#pragma unroll
  for (int j = 0; j < Piece::kElems; ++j) acc[j] = 0.f;
  int count = 0;
  for (int k = 0; k < K; ++k) {
    const int id = __ldg(row_ids + k);
    if (id == mask_id) continue;
    Piece::add(acc, __ldg(table + clamp_row(id, R) * P + p));
    ++count;
  }
  if (mean) {
    const float c = static_cast<float>(count > 1 ? count : 1);
#pragma unroll
    for (int j = 0; j < Piece::kElems; ++j) acc[j] /= c;
  }
  float4* dst = out + (static_cast<long long>(b) * P + p) * kOut;
#pragma unroll
  for (int j = 0; j < kOut; ++j)
    dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                         acc[4 * j + 3]);
}

// kBf16: the table holds bf16 (read as their 16 bits), else float32.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gather_narrow_kernel(const void* __restrict__ table,  // (R, D)
                     const int32_t* __restrict__ ids, // (B, K)
                     float* __restrict__ out,         // (B, D)
                     int B, int K, int D, long long R, int mask_id,
                     int mean) {
  // the launcher keeps B * D below 2^31
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t / D;
  if (b >= B) return;
  const int d = t - b * D;
  const int32_t* row_ids = ids + static_cast<long long>(b) * K;
  float acc = 0.f;
  int count = 0;
  for (int k = 0; k < K; ++k) {
    const int id = __ldg(row_ids + k);
    if (id == mask_id) continue;
    const long long e = clamp_row(id, R) * D + d;
    if constexpr (kBf16) {
      const unsigned short h =
          __ldg(static_cast<const unsigned short*>(table) + e);
      acc += __uint_as_float(static_cast<unsigned>(h) << 16);
    } else {
      acc += __ldg(static_cast<const float*>(table) + e);
    }
    ++count;
  }
  if (mean) acc /= static_cast<float>(count > 1 ? count : 1);
  out[t] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. `kind` names the instantiation: 0 float32 rows (D a multiple
// of 4, table 16-byte aligned), 1 bf16 rows (D a multiple of 8, table
// 16-byte aligned), 2 narrow float32, 3 narrow bf16 (any D). Preconditions
// (checked by the wrapper): B >= 1, K >= 0, D >= 1, R >= 1, out a float32
// (B, D) buffer 16-byte aligned; B * D below 2^31.
int esr_gather_pool(int device, const void* table, const void* ids, void* out,
                    long long B, int K, int D, long long R, int mask_id,
                    int mean, int kind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || K < 0 || D < 1 || R < 1 || kind < kF32x4 ||
      kind > kNarrowBf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int per = 1;  // elements a thread writes
  if (kind == kF32x4) per = 4;
  if (kind == kBf16x8) per = 8;
  if (per > 1 && (D % per != 0 || !aligned)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = D / per;
  const long long threads = B * P;
  if (B * D + kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(ids);
  const int b = static_cast<int>(B);
  switch (kind) {
    case kF32x4:
      gather_piece_kernel<F32Piece><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint4*>(table), i, static_cast<float4*>(out), b,
          K, P, R, mask_id, mean);
      break;
    case kBf16x8:
      gather_piece_kernel<Bf16Piece><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint4*>(table), i, static_cast<float4*>(out), b,
          K, P, R, mask_id, mean);
      break;
    case kNarrowF32:
      gather_narrow_kernel<false><<<blocks, kThreads, 0, s>>>(
          table, i, static_cast<float*>(out), b, K, D, R, mask_id, mean);
      break;
    default:  // kNarrowBf16
      gather_narrow_kernel<true><<<blocks, kThreads, 0, s>>>(
          table, i, static_cast<float*>(out), b, K, D, R, mask_id, mean);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
