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
//  - bf16 tables take float32 updates, as the reference's
//    `table.at[ids].add(updates.astype(table.dtype))` does: each update is
//    first rounded to bf16 (round to nearest even). The vector
//    instantiations (rows of 32, 64 or 128 bf16, 16-byte aligned table
//    and updates) give each lane a 16-byte piece of 8 bf16 (two float4
//    update loads) and one 16-byte reduction (red.global.add.noftz.v4.bf16x2,
//    sm_90); at D=32 a warp holds 32 rows, four a lane. Equal ids within a
//    warp are merged as for float32, but the merge adds the bf16-rounded
//    updates in float32 and rounds the sum once to bf16 before its
//    reduction; the L2 then adds in bf16, rounding at each reduction. A
//    row hit once gets exactly round(table + round(update)); a row hit
//    more than once differs from a sequential bf16 sum by the roundings at
//    its duplicates (the reference fixes no order there either). The
//    generic bf16 instantiation rounds each update and adds it with a
//    scalar bf16 atomic.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // rows (vector) or floats (generic) per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int from) {
  return make_float4(__shfl_sync(kFull, v.x, from),
                     __shfl_sync(kFull, v.y, from),
                     __shfl_sync(kFull, v.z, from),
                     __shfl_sync(kFull, v.w, from));
}

// round to bf16 (nearest even) and back: exact in float32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                     bf16_round(v.w));
}

// two floats as one bf16x2 word, each rounded to nearest even; the lower
// address holds `lo`
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// A lane's 16-byte piece of a table row, for the vector walk: its
// elements' updates in float32 registers (`V`), read from the float4s at
// `src` (`load`), summed (`add`), moved between lanes (`shfl`) and
// reduced into the row at `dst` with one 16-byte reduction (`red`).
struct F32Piece {  // 4 floats; red.global.add.v4.f32 (REDG.F32x4)
  using T = float;
  using V = float4;
  static constexpr int kElems = 4;
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static V load(const float4* src) { return __ldcs(src); }
  __device__ static V add(V a, V b) { return add4(a, b); }
  __device__ static V shfl(V v, int from) { return shfl4(v, from); }
  __device__ static void red(T* dst, V v) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
  }
};

// 8 bf16. Each update is rounded to bf16 on load; merged pieces sum those
// in float32 and are rounded once more in `red`, whose bf16 adds round in
// the L2 (red.global.add.noftz.v4.bf16x2, sm_90).
struct Bf16Piece {
  using T = __nv_bfloat16;
  struct V {
    float4 a, b;
  };
  static constexpr int kElems = 8;
  __device__ static V zero() { return {F32Piece::zero(), F32Piece::zero()}; }
  __device__ static V load(const float4* src) {
    return {round4(__ldcs(src)), round4(__ldcs(src + 1))};
  }
  __device__ static V add(V x, V y) { return {add4(x.a, y.a), add4(x.b, y.b)}; }
  __device__ static V shfl(V v, int from) {
    return {shfl4(v.a, from), shfl4(v.b, from)};
  }
  __device__ static void red(T* dst, V v) {
    asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
                 :: "l"(dst), "r"(pack_bf16x2(v.a.x, v.a.y)),
                    "r"(pack_bf16x2(v.a.z, v.a.w)),
                    "r"(pack_bf16x2(v.b.x, v.b.y)),
                    "r"(pack_bf16x2(v.b.z, v.b.w))
                 : "memory");
  }
};

// The vector instantiation's body, for rows of kD = 32, 64 or 128
// elements of P::T, one P piece a lane.
template <class P, int kD>
__device__ __forceinline__ void add_rows(typename P::T* __restrict__ table,
                                         const int32_t* __restrict__ ids,
                                         const float* __restrict__ updates,
                                         int n, long long R) {
  using V = typename P::V;
  constexpr int kLanes = kD / P::kElems;              // lanes of one row
  constexpr int kGroups = 32 / kLanes;                // rows per instruction
  constexpr int kRows = kGroups * kPerLane <= 32 ? kPerLane : 32 / kGroups;
  constexpr int kRowsPerWarp = kGroups * kRows;       // at most 32
  constexpr int kStep = 32 * P::kElems / 4;           // float4s a row step
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;
  const int col = lane % kLanes;
  const int warps = gridDim.x * (kThreads / 32);
  for (int base = (blockIdx.x * kThreads + threadIdx.x) / 32 * kRowsPerWarp;
       base < n; base += warps * kRowsPerWarp) {
    // row base + u * kGroups + group is this lane's u-th row; its piece
    // is elements [col * kElems, (col + 1) * kElems) of that row
    int my_id = -1;
    if (lane < kRowsPerWarp && base + lane < n) my_id = __ldg(ids + base + lane);
    const float4* src = reinterpret_cast<const float4*>(updates) +
                        static_cast<long long>(base) * (kD / 4) +
                        lane * (P::kElems / 4);
    V v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      v[u] = P::zero();
      if (base + u * kGroups + group < n) v[u] = P::load(src + u * kStep);
    }
    V acc = P::zero();
    int acc_id = -1;  // the row acc is held for, -1 for none
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int id = __shfl_sync(kFull, my_id, u * kGroups + group);
      const int key =
          (base + u * kGroups + group < n && id >= 0 && id < R) ? id : -1;
      V val = v[u];
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
            const V o = P::shfl(v[u], from);
            if (okey == key) {
              val = P::add(val, o);
              if (other < group) lead = false;
            }
          }
        }
      }
      if (!lead) continue;
      if (key == acc_id) {
        acc = P::add(acc, val);
      } else {
        if (acc_id >= 0)
          P::red(table + static_cast<long long>(acc_id) * kD +
                     col * P::kElems, acc);
        acc = val;
        acc_id = key;
      }
    }
    if (acc_id >= 0)
      P::red(table + static_cast<long long>(acc_id) * kD + col * P::kElems,
             acc);
  }
}

// one element's reduction: float32, or the update rounded to bf16 and a
// scalar bf16 atomic
__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}

__device__ __forceinline__ void atomic_add(__nv_bfloat16* p, float v) {
  atomicAdd(p, __float2bfloat16_rn(v));
}

// The generic instantiation's body: any D, any element-aligned pointers.
template <class T>
__device__ __forceinline__ void add_elems(T* __restrict__ table,
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
        atomic_add(table + static_cast<long long>(id[u]) * D + e % D, v[u]);
    }
  }
}

// kD = 32, 64 or 128: the vector instantiation; 0: the generic one.
template <class P, int kD>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(typename P::T* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ updates, int n, int D,
                   long long R) {
  if constexpr (kD == 0) {
    add_elems(table, ids, updates, n, D, R);
  } else {
    add_rows<P, kD>(table, ids, updates, n, R);
  }
}

template <class P>
void launch(void* table, const int32_t* ids, const float* updates, int n,
            int D, long long R, int width, int blocks, cudaStream_t s) {
  auto* t = static_cast<typename P::T*>(table);
  switch (width) {
    case 0:
      scatter_add_kernel<P, 0><<<blocks, kThreads, 0, s>>>(t, ids, updates,
                                                           n, D, R);
      break;
    case 32:
      scatter_add_kernel<P, 32><<<blocks, kThreads, 0, s>>>(t, ids, updates,
                                                            n, D, R);
      break;
    case 64:
      scatter_add_kernel<P, 64><<<blocks, kThreads, 0, s>>>(t, ids, updates,
                                                            n, D, R);
      break;
    default:  // 128
      scatter_add_kernel<P, 128><<<blocks, kThreads, 0, s>>>(t, ids, updates,
                                                             n, D, R);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. `width` names the instantiation: 32, 64 or 128 for the vector
// one (then D == width and table and updates are 16-byte aligned), 0 for
// the generic one; `bf16` says the table holds bf16 (else float32);
// `blocks` CTAs of 256 threads, at most 2^20 (any count is correct: each
// CTA walks its rows grid-stride). Preconditions (checked by the wrapper):
// n >= 1, D >= 1, R >= 1, contiguous table and float32 updates, int32 ids;
// n * D below 2^31.
int esr_scatter_add(int device, void* table, const void* ids,
                    const void* updates, long long n, int D, long long R,
                    int width, int blocks, int bf16, void* stream) {
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
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* u = static_cast<const float*>(updates);
  const int rows = static_cast<int>(n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<Bf16Piece>(table, i, u, rows, D, R, width, blocks, s);
  } else {
    launch<F32Piece>(table, i, u, rows, D, R, width, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
