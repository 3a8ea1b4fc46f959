// Row scatter-add for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of esrecsys_tpu/ops/scatter.py
// (launched by `scatter_add_rows`). It computes the same function,
// table.at[ids].add(updates): unsorted ids, duplicates summed, float32
// throughout. The TPU kernel sorts the ids outside itself and turns each
// table block's updates into one-hot matrix products split into bf16
// passes; that is a trick of the TPU's matrix unit and is not ported. Ids
// outside [0, R) are dropped, as the TPU kernel's block ranges drop them.
//
// What bounds it: bytes. The updates are read once (76,288 x 32 float32 =
// 9.8 MB at the train step's shape) and each distinct target row is read
// and written once (about 53k album and 67k artist rows of 128 bytes):
// 7.1 and 8.1 us at 3.35 TB/s.
//
// Design: float32 reductions in the L2 cache, in place on the table, no
// sort and no segment boundaries.
//  - Vector instantiations, for rows of 32, 64 or 128 floats with 16-byte
//    aligned table and updates: D/4 lanes share a row, each lane streams
//    one float4 of it (ld.global.cs: read once, first to leave the L2) and
//    issues one 16-byte reduction (red.global.add.v4.f32, one REDG.F32x4
//    in the machine code) instead of four scalar ones. A warp takes
//    32 * 8 * 4 / D rows: each lane loads one of their ids (one coalesced
//    load), the lanes of a row take it by shuffle, and every lane issues
//    all its eight float4 loads before its first reduction, so the whole
//    step's updates are in flight in one wave of CTAs. D is known at
//    compile time: no divide.
//  - Equal ids within a warp are summed in registers before they reach
//    the L2: a row group whose id another group of the same instruction
//    holds too (`__match_any_sync`, a warp-uniform test) adds the others'
//    float4s by shuffle and only the lowest such group reduces, and a lane
//    holds its sum while its next rows have the same id. Uniform ids
//    rarely meet this path; when every id is equal (a pile-up on one row)
//    a warp sends 8 reductions, not 256, to that row's line.
//  - The generic instantiation takes every other D, and misaligned
//    pointers: one float per lane, eight in flight per lane, scalar
//    reductions, the row found by a divide.
// The wrapper (kernels/scatter_add.py) picks the instantiation and the
// grid; every instantiation walks its rows grid-stride, so any grid is
// correct. The price of atomics is order: duplicates of a row sum in an
// order that changes from run to run, so results agree with a sequential
// sum only to float32 rounding of those sums.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W limit), at the
// step's shapes with the L2 cache flushed before each call by an in-place
// pass over 256 MiB: about 12.5 us per launch, mean of the album and
// artist tables, against 15.6 for the previous design (one thread and one
// scalar atomic per element) and 22.4 for `index_add_`; with every id on
// one row, about 10 us against the previous design's 181 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // rows (vector) or floats (generic) per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The vector instantiation's body, for rows of kD = 32, 64 or 128 floats.
template <int kD>
__device__ __forceinline__ void add_rows(float* __restrict__ table,
                                         const int32_t* __restrict__ ids,
                                         const float* __restrict__ updates,
                                         int n, long long R) {
  constexpr int kLanes = kD / 4;                      // lanes of one row
  constexpr int kGroups = 32 / kLanes;                // rows per instruction
  constexpr int kRowsPerWarp = kGroups * kPerLane;    // 32, 16 or 8
  static_assert(kRowsPerWarp <= 32, "one id per lane");
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;
  const int col = lane % kLanes;
  const int warps = gridDim.x * (kThreads / 32);
  for (int base = (blockIdx.x * kThreads + threadIdx.x) / 32 * kRowsPerWarp;
       base < n; base += warps * kRowsPerWarp) {
    // row base + u * kGroups + group is this lane's u-th row
    int my_id = -1;
    if (lane < kRowsPerWarp && base + lane < n) my_id = __ldg(ids + base + lane);
    const float4* src = reinterpret_cast<const float4*>(updates) +
                        static_cast<long long>(base) * kLanes + lane;
    float4 v[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base + u * kGroups + group < n) v[u] = __ldcs(src + u * 32);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int acc_id = -1;  // the row acc is held for, -1 for none
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int id = __shfl_sync(kFull, my_id, u * kGroups + group);
      const int key =
          (base + u * kGroups + group < n && id >= 0 && id < R) ? id : -1;
      float4 val = v[u];
      bool lead = key >= 0;
      if (kGroups > 1) {
        const unsigned same = __match_any_sync(kFull, key);
        if (__any_sync(kFull, __popc(same) > kLanes)) {
          // another row group of this instruction holds the same id
#pragma unroll
          for (int g = 1; g < kGroups; ++g) {
            const int other = (group + g) % kGroups;
            const int from = other * kLanes + col;
            const int okey = __shfl_sync(kFull, key, from);
            float4 o;
            o.x = __shfl_sync(kFull, v[u].x, from);
            o.y = __shfl_sync(kFull, v[u].y, from);
            o.z = __shfl_sync(kFull, v[u].z, from);
            o.w = __shfl_sync(kFull, v[u].w, from);
            if (okey == key) {
              val = add4(val, o);
              if (other < group) lead = false;
            }
          }
        }
      }
      if (!lead) continue;
      if (key == acc_id) {
        acc = add4(acc, val);
      } else {
        if (acc_id >= 0)
          red_add_v4(table + static_cast<long long>(acc_id) * kD + col * 4,
                     acc);
        acc = val;
        acc_id = key;
      }
    }
    if (acc_id >= 0)
      red_add_v4(table + static_cast<long long>(acc_id) * kD + col * 4, acc);
  }
}

// The generic instantiation's body: any D, any 4-byte aligned pointers.
__device__ __forceinline__ void add_elems(float* __restrict__ table,
                                          const int32_t* __restrict__ ids,
                                          const float* __restrict__ updates,
                                          int n, int D, long long R) {
  // 32-bit index math: the launcher keeps n * D and the grid's stride
  // below 2^31, so an element index plus the stride stays below 2^32
  const unsigned total = static_cast<unsigned>(n) * D;
  const unsigned span = kThreads * kPerLane;
  for (unsigned first = blockIdx.x * span + threadIdx.x; first < total;
       first += gridDim.x * span) {
    float v[kPerLane];
    int id[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const unsigned e = first + u * kThreads;
      v[u] = 0.f;
      id[u] = -1;
      if (e < total) {
        id[u] = __ldg(ids + e / D);
        v[u] = __ldcs(updates + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const unsigned e = first + u * kThreads;
      if (id[u] >= 0 && id[u] < R)
        atomicAdd(table + static_cast<long long>(id[u]) * D + e % D, v[u]);
    }
  }
}

// kD = 32, 64 or 128: the vector instantiation; 0: the generic one.
template <int kD>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(float* __restrict__ table, const int32_t* __restrict__ ids,
                   const float* __restrict__ updates, int n, int D,
                   long long R) {
  if constexpr (kD == 0) {
    add_elems(table, ids, updates, n, D, R);
  } else {
    add_rows<kD>(table, ids, updates, n, R);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. `width` names the instantiation: 32, 64 or 128 for the vector
// one (then D == width and table and updates are 16-byte aligned), 0 for
// the generic one; `blocks` CTAs of 256 threads, at most 2^20 (any count
// is correct: each CTA walks its rows grid-stride). Preconditions (checked
// by the wrapper): n >= 1, D >= 1, R >= 1, contiguous float32 table and
// updates, int32 ids; n * D below 2^31.
int esr_scatter_add(int device, void* table, const void* ids,
                    const void* updates, long long n, int D, long long R,
                    int width, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // with n * D and the grid's stride each below 2^31, the generic
  // instantiation's unsigned element index cannot wrap
  if (n < 1 || D < 1 || R < 1 || blocks < 1 || blocks > (1 << 20) ||
      n * D + kThreads * kPerLane > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(updates)) & 15) == 0;
  const bool vector = width == 32 || width == 64 || width == 128;
  if (width != 0 && !(vector && width == D && aligned)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* u = static_cast<const float*>(updates);
  const int rows = static_cast<int>(n);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 0:
      scatter_add_kernel<0><<<blocks, kThreads, 0, s>>>(t, i, u, rows, D, R);
      break;
    case 32:
      scatter_add_kernel<32><<<blocks, kThreads, 0, s>>>(t, i, u, rows, D, R);
      break;
    case 64:
      scatter_add_kernel<64><<<blocks, kThreads, 0, s>>>(t, i, u, rows, D, R);
      break;
    default:  // 128
      scatter_add_kernel<128><<<blocks, kThreads, 0, s>>>(t, i, u, rows, D, R);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
