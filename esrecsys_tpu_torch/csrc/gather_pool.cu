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
// 32-wide float32 table, K=1) that is 7-9 MB of distinct rows and ids
// read and 9.8 MB written: 5.0-5.6 us at 3.35 TB/s. Each row costs two
// dependent trips to memory (its id, then its row), so the kernel must
// keep many rows in flight on every SM. Where the L2 cache holds another
// kernel's dirty lines, as in the train step, every line this kernel
// brings in also writes one back: more bytes than the bound counts.
//
// Design: one templated kernel, four instantiations (what a lane reads of
// a row: a 16-byte piece of 4 floats or 8 bf16, or one element of any D
// at any alignment), no shared memory, no atomics, the grid from the
// wrapper's plan (kernels/gather_pool.py `launch_plan`, from the card's SM
// count).
//  - Geometry. A row of P pieces is read by min(P, 32) lanes side by
//    side; a warp instruction covers 32 / min(P, 32) rows. Rows of more
//    than 32 pieces are cut into segments of 32 ("virtual rows", each
//    with its row's id). The launcher computes the geometry; a lane finds
//    its row group by one multiply. Row offsets are 64-bit (a 100M x 32
//    table passes 2^31 elements).
//  - Each warp takes one pass of rows: U rows a lane (1, 2, 4 or 8, a
//    compile-time count, so all U 16-byte row loads of the pass issue
//    before its first store; ld.global.nc, kept in L1, so a row that
//    repeats on an SM, as padding and hot ids do, is served there: with
//    L1::no_allocate an IVF probe of 78 % padding ran at 630 us against
//    430). The plan keeps 32 rows a pass in flight where a row is 128
//    bytes or more and 16 where it is less (random 64-byte rows ran
//    slower at 32).
//  - Ids are loaded once a warp: one coalesced load of the pass's ids, one
//    a lane, each broadcast to its row's lanes with __shfl_sync.
//  - Output rows are written with streaming stores (st.global.cs), so they
//    leave the L2 before the table's rows that later ids read again.
//  - The grid holds a warp for every pass (the launcher refuses a smaller
//    one). A persistent grid of one resident wave, each warp looping over
//    passes, ran slower on long launches: its static split left the SMs
//    that the memory system served last holding the launch's end, where
//    many short CTAs let the hardware's CTA scheduler even that out. A
//    grid capped at 32 resident waves ran no faster than one pass a warp.
//  - Small launches: the plan lowers U and uses one-warp CTAs until the
//    launch spans min(warps needed, SMs) CTAs.
//  - Pooled rows (K != 1): one row a lane, its K ids in chunks of four,
//    the chunk's four row loads issued before their sum, which stays in k
//    order.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit, the previous
// design's source timed in turns in the same run (L2 flushed before each
// call; us): a 100,096 x 32 table at the train step's 76,288 ids 7.47-7.52
// (previous 8.84-8.89; bound 5.0), an IVF-like probe of 3,924,480 rows of
// 2,262,292 x 64 with 13.5 % padding 638.0-650.6 (668.8-668.9; bound
// 439) and with 78 % padding 430.1-430.3 (465.1), the 100M x 32 bf16
// table at 262,144 ids with its write-back 26.0-27.0 (26.6-27.2; bound
// 15.3), 99 ids of a 500,000 x 64 table 2.17-2.30 (2.11-2.14). PERF.md's
// kernel table has chip_smoke.py's times beside the parent commit's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;      // threads a CTA, at most
constexpr int kMaxRowsPerLane = 8;    // U, at most
constexpr int kPoolChunk = 4;         // a pooled row's loads in flight
constexpr unsigned kFull = 0xffffffffu;

// instantiations, as kernels/gather_pool.py numbers them
constexpr int kF32x4 = 0;
constexpr int kBf16x8 = 1;
constexpr int kNarrowF32 = 2;
constexpr int kNarrowBf16 = 3;

__device__ __forceinline__ long long clamp_row(int id, long long R) {
  long long r = id < 0 ? 0 : id;
  return r >= R ? R - 1 : r;
}

// Table loads through the read-only path, kept in L1: a row that another
// warp of the SM reads again (padding ids, hot ids) is served there.
__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_nc(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.nc.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned short load_nc(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];"
               : "=h"(v)
               : "l"(p));
  return v;
}

// What a lane reads of a row: `Raw`, widened to kElems float32 values.
struct F32x4 {  // 16 bytes: 4 floats
  using Raw = uint4;
  using Elem = uint4;
  static constexpr int kElems = 4;
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(Raw v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

struct Bf16x8 {  // 16 bytes: 8 bf16, each the high half of its float32
  using Raw = uint4;
  using Elem = uint4;
  static constexpr int kElems = 8;
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(Raw v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

struct NarrowF32 {  // one float
  using Raw = unsigned;
  using Elem = unsigned;
  static constexpr int kElems = 1;
  __device__ static Raw zero() { return 0u; }
  __device__ static void widen(Raw v, float* f) { f[0] = __uint_as_float(v); }
};

struct NarrowBf16 {  // one bf16
  using Raw = unsigned short;
  using Elem = unsigned short;
  static constexpr int kElems = 1;
  __device__ static Raw zero() { return 0; }
  __device__ static void widen(Raw v, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

// Piece `e` of the table (row * P + piece), in units of Piece::Elem.
template <class Piece>
__device__ __forceinline__ typename Piece::Raw load_piece(const void* table,
                                                          long long e) {
  return load_nc(static_cast<const typename Piece::Elem*>(table) + e);
}

// kElems float32 values to out[at * kElems...], streaming.
template <int kElems>
__device__ __forceinline__ void store_piece(float* out, int at,
                                            const float* f) {
  float* dst = out + static_cast<long long>(at) * kElems;
  if constexpr (kElems == 1) {
    __stcs(dst, f[0]);
  } else {
#pragma unroll
    for (int j = 0; j < kElems / 4; ++j)
      __stcs(reinterpret_cast<float4*>(dst) + j,
             make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2],
                         f[4 * j + 3]));
  }
}

// One launch's shape, computed by the launcher (no divide in the kernel
// but the wide rows' one a pass). A virtual row v is output row
// v / segments and its segment v % segments: pieces
// [segment * lanes, segment * lanes + lanes) of the row.
struct Shape {
  int B, K, P;       // rows, ids a row, pieces a row
  long long R;       // table rows
  int mask_id, mean;
  int lanes;         // lanes a row: min(P, 32)
  int groups;        // rows a warp instruction covers: 32 / lanes
  int segments;      // virtual rows a row: ceil(P / 32)
  int vrows;         // B * segments
  int passes;        // passes of groups * U virtual rows (U = 1 pooled)
  float inv_lanes;   // 1 / lanes: a lane's group by one multiply
};

// This lane's row group and its piece within the group; lanes past
// groups * lanes are idle (`on` false). (lane + 0.5) / lanes is exact
// enough to floor: its fraction lies in [0.5, lanes - 0.5] / lanes.
struct Lane {
  int grp, pl;
  bool on;
  __device__ explicit Lane(const Shape& s) {
    const int lane = threadIdx.x & 31;
    grp = static_cast<int>((lane + 0.5f) * s.inv_lanes);
    pl = lane - grp * s.lanes;
    on = grp < s.groups;
  }
};

// How a K=1 pass finds its rows' ids, by the row's width in pieces:
// kShared (2 to 32 pieces: a row group of `lanes` lanes, each id
// shuffled to its group), kOwn (one piece: one lane a row, U = 1) and
// kWide (more than 32 pieces: segments of 32, their rows' ids shuffled).
// In each, the pass's ids are one coalesced load, one a lane.
constexpr int kShared = 0;
constexpr int kOwn = 1;
constexpr int kWide = 2;

// The id of row row0 + lane (mask_id past B), read once.
__device__ __forceinline__ int load_id(const int32_t* __restrict__ ids,
                                       int B, int mask_id, int row0) {
  const int r = row0 + (threadIdx.x & 31);
  return r < B ? __ldcs(ids + r) : mask_id;
}

// K == 1: kU rows a lane in this warp's pass (a compile-time count, so
// every load of the pass issues before the first store).
template <class Piece, int kMode, int kU>
__device__ __forceinline__ void gather_rows(
    const void* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, const Shape& s, const Lane& l, int pass) {
  const int lane = threadIdx.x & 31;
  const int v0 = pass * s.groups * kU;  // the pass's first virtual row
  const int row0 = kMode == kWide ? v0 / s.segments : v0;
  const int cur = load_id(ids, s.B, s.mask_id, row0);
  int seg = v0 - row0 * s.segments;  // kWide: the running segment
  int wrow = row0;                   // kWide: its row
  typename Piece::Raw raw[kU];
  int at[kU];  // output piece, -1 for no row
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    int row, piece, id;
    bool live;
    if constexpr (kMode == kOwn) {
      row = v0 + lane;
      piece = 0;
      id = cur;
      live = row < s.B;
    } else if constexpr (kMode == kShared) {
      const int slot = u * s.groups + l.grp;
      row = v0 + slot;
      piece = l.pl;
      id = __shfl_sync(kFull, cur, slot & 31);
      live = l.on && row < s.B;
    } else {
      row = wrow;
      piece = seg * 32 + lane;
      id = __shfl_sync(kFull, cur, (row - row0) & 31);
      live = row < s.B && piece < s.P;
      if (++seg == s.segments) {
        seg = 0;
        ++wrow;
      }
    }
    raw[u] = Piece::zero();
    at[u] = -1;
    if (live) {
      if (id != s.mask_id)
        raw[u] = load_piece<Piece>(table, clamp_row(id, s.R) * s.P + piece);
      at[u] = row * s.P + piece;
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (at[u] >= 0) {
      float f[Piece::kElems];
      Piece::widen(raw[u], f);
      store_piece<Piece::kElems>(out, at[u], f);
    }
  }
}

template <class Piece, int kMode>
__device__ __forceinline__ void gather_rows_u(
    const void* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, const Shape& s, const Lane& l, int U,
    int pass) {
  switch (U) {  // warp-uniform; the launcher takes 1, 2, 4 or 8
    case 8:
      gather_rows<Piece, kMode, 8>(table, ids, out, s, l, pass);
      break;
    case 4:
      gather_rows<Piece, kMode, 4>(table, ids, out, s, l, pass);
      break;
    case 2:
      gather_rows<Piece, kMode, 2>(table, ids, out, s, l, pass);
      break;
    default:
      gather_rows<Piece, kMode, 1>(table, ids, out, s, l, pass);
  }
}

// K != 1: one virtual row a lane, its K ids in chunks of
// kPoolChunk (each id read by its row's lanes at once: one address a row
// group), the chunk's row loads issued before the sum, in k order.
template <class Piece>
__device__ __forceinline__ void pool_rows(
    const void* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, const Shape& s, const Lane& l, int pass) {
  const int K = s.K, mask_id = s.mask_id;
  const int v = pass * s.groups + l.grp;
  const int row = s.segments == 1 ? v : v / s.segments;
  const int piece = (v - row * s.segments) * s.lanes + l.pl;
  const bool live = l.on && v < s.vrows && piece < s.P;
  const int32_t* row_ids = ids + static_cast<long long>(row) * K;
  float acc[Piece::kElems];
#pragma unroll
  for (int j = 0; j < Piece::kElems; ++j) acc[j] = 0.f;
  int count = 0;
  for (int k0 = 0; k0 < K; k0 += kPoolChunk) {
    int id[kPoolChunk];
    typename Piece::Raw raw[kPoolChunk];
#pragma unroll
    for (int c = 0; c < kPoolChunk; ++c)
      id[c] = (live && k0 + c < K) ? __ldg(row_ids + k0 + c) : mask_id;
#pragma unroll
    for (int c = 0; c < kPoolChunk; ++c) {
      raw[c] = Piece::zero();
      if (id[c] != mask_id)
        raw[c] = load_piece<Piece>(table,
                                   clamp_row(id[c], s.R) * s.P + piece);
    }
#pragma unroll
    for (int c = 0; c < kPoolChunk; ++c) {
      if (id[c] == mask_id) continue;
      float f[Piece::kElems];
      Piece::widen(raw[c], f);
#pragma unroll
      for (int j = 0; j < Piece::kElems; ++j) acc[j] += f[j];
      ++count;
    }
  }
  if (s.mean) {
    const float c = static_cast<float>(count > 1 ? count : 1);
#pragma unroll
    for (int j = 0; j < Piece::kElems; ++j) acc[j] /= c;
  }
  if (live) store_piece<Piece::kElems>(out, row * s.P + piece, acc);
}

template <class Piece, bool kPooled>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(const void* __restrict__ table,  // (R, P) pieces
              const int32_t* __restrict__ ids,  // (B, K)
              float* __restrict__ out,          // (B, P * kElems)
              Shape s, int U) {
  // 32-bit index math: the launcher keeps B * D below 2^31. One pass a
  // warp; the last CTA's spare warps have none (warp-uniform exit).
  const int pass = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pass >= s.passes) return;
  const Lane l(s);
  if constexpr (kPooled) {
    pool_rows<Piece>(table, ids, out, s, l, pass);
  } else if (s.segments > 1) {
    gather_rows_u<Piece, kWide>(table, ids, out, s, l, U, pass);
  } else if (s.groups == 32) {
    gather_rows<Piece, kOwn, 1>(table, ids, out, s, l, pass);
  } else {
    gather_rows_u<Piece, kShared>(table, ids, out, s, l, U, pass);
  }
}

template <class Piece>
void launch(bool pooled, int ctas, int threads, const void* table,
            const int32_t* ids, float* out, const Shape& shape, int U,
            cudaStream_t st) {
  if (pooled) {
    gather_kernel<Piece, true><<<ctas, threads, 0, st>>>(table, ids, out,
                                                         shape, U);
  } else {
    gather_kernel<Piece, false><<<ctas, threads, 0, st>>>(table, ids, out,
                                                          shape, U);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. `kind` names the instantiation: 0 float32 rows (D a multiple
// of 4, table 16-byte aligned), 1 bf16 rows (D a multiple of 8, table
// 16-byte aligned), 2 narrow float32, 3 narrow bf16 (any D). The grid is
// the plan's: `ctas` CTAs of `threads` (a multiple of 32, at most 256),
// `rows_per_lane` rows a lane a pass (1, 2, 4 or 8; 1 when K != 1 and for
// rows of one piece; at most 32 rows a pass where a row is 32 pieces or
// fewer). Preconditions (checked by the wrapper): B >= 1, K >= 0, D >= 1,
// R >= 1, out a float32 (B, D) buffer 16-byte aligned; B * D below 2^31.
int esr_gather_pool(int device, const void* table, const void* ids, void* out,
                    long long B, int K, int D, long long R, int mask_id,
                    int mean, int kind, int ctas, int threads,
                    int rows_per_lane, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || K < 0 || D < 1 || R < 1 || kind < kF32x4 ||
      kind > kNarrowBf16 || ctas < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || rows_per_lane < 1 ||
      rows_per_lane > kMaxRowsPerLane ||
      (rows_per_lane & (rows_per_lane - 1)) != 0 ||
      (K != 1 && rows_per_lane != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int per = 1;  // elements a piece
  if (kind == kF32x4) per = 4;
  if (kind == kBf16x8) per = 8;
  if (per > 1 && (D % per != 0 || !aligned)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * D + kMaxThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = D / per;
  const bool pooled = K != 1;
  Shape shape;
  shape.B = static_cast<int>(B);
  shape.K = K;
  shape.P = P;
  shape.R = R;
  shape.mask_id = mask_id;
  shape.mean = mean;
  shape.lanes = P < 32 ? P : 32;
  shape.groups = 32 / shape.lanes;
  shape.segments = (P + 31) / 32;
  shape.vrows = shape.B * shape.segments;
  const int per_pass = shape.groups * (pooled ? 1 : rows_per_lane);
  shape.passes = (shape.vrows + per_pass - 1) / per_pass;
  shape.inv_lanes = 1.0f / static_cast<float>(shape.lanes);
  if ((shape.groups == 32 && rows_per_lane != 1) ||
      shape.groups * rows_per_lane > 32 ||
      static_cast<long long>(ctas) * (threads / 32) < shape.passes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  switch (kind) {
    case kF32x4:
      launch<F32x4>(pooled, ctas, threads, table, i, o, shape, rows_per_lane,
                    st);
      break;
    case kBf16x8:
      launch<Bf16x8>(pooled, ctas, threads, table, i, o, shape,
                     rows_per_lane, st);
      break;
    case kNarrowF32:
      launch<NarrowF32>(pooled, ctas, threads, table, i, o, shape,
                        rows_per_lane, st);
      break;
    default:  // kNarrowBf16
      launch<NarrowBf16>(pooled, ctas, threads, table, i, o, shape,
                         rows_per_lane, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* esr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
