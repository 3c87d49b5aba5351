// Fused sparsify + error feedback (and its quantising twin) for sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/sparsify_ef.py:
//   sparsify_ef           (:60, body _kernel :49)
//   sparsify_quantize_ef  (:124, body _kernel_q :102)
//
// Per row (one federated device) of x (rows, cols) with the row's
// threshold t (the segmented entry: per (row, leaf) threshold, step and
// levels, leaf l being the columns [offsets[l], offsets[l+1])):
//   sparsify_ef:           upload = x*[|x| >= t], error = x*[|x| < t]
//   sparsify_quantize_ef:  upload = [|x| >= t] * clip(floor(x/step + u),
//                          -levels, levels) * step, error = x - upload,
//                          u = lowbias32(seed, counter) / 2^32, the
//                          counter base + column (the segmented entry:
//                          the leaf's counter map, below)
//   both:                  count = #{|x| >= t}
// The mask is taken on the f32 value; outputs are stored in x's dtype.
//
// Bound: bytes. Each element is read once and written twice (12 B in f32,
// 6 B in bf16) for a few ALU operations (about 20 integer and float ops
// with the dither hash), below the card's operation rate, so the time
// floor is the HBM rate: 0.4709 ms at (20, 6,573,130) f32 on an H100 SXM.
// The quantising op in bf16 comes close to the issue rate as well (about
// 50 instructions an element with the IEEE divide).
//
// What held the first design (a (blocks_per_row, rows) grid, eight blocks
// a SM assumed, one 16-byte load a thread in a grid-stride loop) to 61-70
// % of the bound at the 20- and 10-row shapes and to 29-41 % at LaneGCN's
// per-rank rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md), and what this
// design does about each:
//  1. A tail wave: 53 blocks a row x 20 rows = 1,060 blocks for 1,056
//     slots, four of them run alone after the first wave (0.6838 ms
//     against 0.4709 at ResNet-9's shape). Here the grid is what the card
//     holds at once of the kernel launched (cudaOccupancyMaxActiveBlocks-
//     PerMultiprocessor x SMs, resident_blocks), every block resident from
//     the start.
//  2. Three device operations a call (a memset of the counts, the kernel,
//     a cast of the int64 counts to f32): most of LaneGCN's per-rank 11-15
//     us against a 4.4 us bound. Here the kernel writes the counts itself:
//     warps add their int64 partials into a per-device accumulator, and
//     the last block to take a ticket (each writer fenced first) reads the
//     totals out, each rounded once to f32 (__ll2float_rn) or as int64,
//     leaving the workspace (ticket, piece counter, accumulator) at zero
//     for the next call.
//  3. One load in flight a thread. Here a register ring: each thread
//     issues kRing independent 16-byte streaming loads before its first
//     store, then drains them a vector a turn (the ring shifted in
//     registers, so that the op's code is emitted once).
//  4. Per-row and per-leaf edges (rows are not 16-byte aligned; the
//     segmented grid cut LaneGCN's small leaves into tiny blocks). Here
//     the rows x cols elements are one flat array, cut into pieces of at
//     most one tile (16-byte aligned) and one (row, leaf) each: a row
//     entry's tile is 16 KB (kTileVecs = kRing x kThreads vectors, one
//     ring turn of the block), the segmented entry's 16 KB in f32 and 32
//     KB in bf16 (a piece's start costs each thread a division to place
//     its counter under the map). Only the < V elements
//     before a piece's first aligned vector and after its last go element
//     by element. The row entries work their pieces out from the tile's
//     index and cols (a tile's pieces are the rows it crosses); the
//     segmented entry reads them from a host table over its leaves
//     (sparsify_ef.py::plan, cached per layout: (flat first, flat end,
//     segment = row * leaves + leaf) a piece). Block b takes units (tiles,
//     or the table's pieces) b and b + G, then the next of 2 G, 2 G + 1,
//     ... from a counter in the workspace, so the grid sweeps the array
//     together (blocks streaming distant runs of their own lose DRAM
//     locality: 60 % of the bound at the bf16 rows, PERF.md) and a slower
//     SM takes fewer (a fixed deal left the slowest SM's blocks as the
//     tail: 2.5-7.6 % at the big shapes). A block keeps its segment's op
//     in registers while its pieces stay in that segment and reads the
//     next unit and the counter a unit ahead, with one block sync a unit.
//     Flat offsets are 64-bit (N x s reaches 3.78e9).
//
// The quantising op in bf16 is close to the issue rate (a few tens of
// instructions an element against the 53 that the bytes bound leaves), so
// its counters are made cheap: a thread's counter is walked from vector
// to vector (kThreads x V columns on) without a division, and within a
// vector column i draws counter v + i, plus the map's jump past the
// column where the run ends (at most one jump in a vector where R >= V;
// a leaf with R < V goes element by element).
//
// The dither counter is a uint32 of the row's column, never of the flat
// index: column c of a row draws lowbias32(seed, (base + c) mod 2^32),
// which is what the reference's int32 index gives once cast to uint32, so
// a row may cross 2^32.
//
// The segmented entry replaces the per-leaf calls of the reference's
// per-layer codec (src/repro/compression/perlayer.py:208, one Pallas call
// per leaf and per device with base = the leaf's offset). The dither
// counter base + index-within-leaf is the flat column, so all leaves of
// all devices go in ONE launch with the dither unchanged.
//
// The counter map. A rank of a (data, model) mesh holds a block of each
// leaf, and its flat row concatenates them; the reference draws from the
// whole model's flat coordinate. The rules cut at most one dim of a leaf,
// so a block is outer x [a0, a1) x inner and its local column c (within
// the leaf's columns) has the global counter g0 + (c / R) * G + c % R,
// with R = (a1 - a0) * inner the block's run, G = extent * inner the
// whole leaf's stride and g0 = the leaf's global offset + a0 * inner
// (all mod 2^32). The map gives (offset of the leaf in the row, g0, R, G,
// owned) per leaf; world 1's is (offset, offset, size, size, 1), which is
// the flat column. A leaf that is not owned (every rank holds it whole
// and another rank counts it) adds nothing to its count, which comes out
// 0.
//
// Counts are exact: int64 atomics commute, so the totals do not depend on
// the order in which warps arrive. The workspace (work: ticket, piece
// counter, accumulator) belongs to one device; two calls must not run at
// the same time on two streams of it.
//
// Bit-exactness with the reference: x/step is an IEEE round-to-nearest
// divide (__fdiv_rn), and every add/multiply/subtract after it is an
// explicit _rn intrinsic so that nothing is contracted into an FMA; the
// error is computed from the upload after its rounding to x's dtype. The
// hash works in uint32, which wraps as the reference's does.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 4;  // 16-byte loads a thread issues before a store
constexpr int kTileVecs = kRing * kThreads;  // vectors a tile (16 KB)

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dither_u01(uint32_t seed, uint32_t idx) {
  uint32_t h = idx ^ seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return __fmul_rn(__uint2float_rn(h), 2.3283064365386963e-10f);  // 2^-32
}

// The dither counters of a 16-byte vector's columns: column i draws at(i).
struct LinearCounter {
  uint32_t v;
  __device__ __forceinline__ uint32_t at(uint32_t i) const { return v + i; }
};

// Under a leaf's map: the run ends w >= 1 columns past the vector's
// first, and the counter jumps by skip = G - R there (once at most: R >=
// V, or the vector is one column).
struct BlockCounter {
  uint32_t v, w, skip;
  __device__ __forceinline__ uint32_t at(uint32_t i) const {
    return v + i + (i >= w ? skip : 0u);
  }
};

// base + column. A walk is a thread's counter from one of its vectors to
// the next, `step` columns on (prepare).
struct Linear {
  uint32_t base, step;
  struct Walk {
    uint32_t v;
  };
  __device__ __forceinline__ void prepare(uint32_t s) { step = s; }
  __device__ __forceinline__ bool vectors(int) const { return true; }
  __device__ __forceinline__ Walk walk(int64_t col) const {
    return {base + static_cast<uint32_t>(col)};
  }
  __device__ __forceinline__ LinearCounter here(Walk w) const { return {w.v}; }
  __device__ __forceinline__ void next(Walk& w) const { w.v += step; }
};

// The counter of a block's columns under the leaf's map (header): the
// walk is the column's (run q, place r in it), stepped by (dq, dr) =
// divmod(step, R) without a division.
struct Blocked {
  int64_t off;  // the leaf's first column in the row
  uint32_t g0, run, stride, dq, dr;
  struct Walk {
    uint32_t q, r;
  };
  __device__ __forceinline__ void prepare(uint32_t s) {
    dq = s / run;
    dr = s - dq * run;
  }
  __device__ __forceinline__ bool vectors(int v) const {
    return run >= static_cast<uint32_t>(v);
  }
  __device__ __forceinline__ Walk walk(int64_t col) const {
    const uint32_t c = static_cast<uint32_t>(col - off);
    const uint32_t q = c < run ? 0u : c / run;
    return {q, c - q * run};
  }
  __device__ __forceinline__ BlockCounter here(Walk w) const {
    return {g0 + w.q * stride + w.r, run - w.r, stride - run};
  }
  __device__ __forceinline__ void next(Walk& w) const {
    w.q += dq;
    w.r += dr;
    if (w.r >= run) {
      w.r -= run;
      ++w.q;
    }
  }
};

struct SparsifyOp {
  float t;
  Linear map;  // unused: the op draws no dither

  template <typename T>
  __device__ __forceinline__ int operator()(T x, uint32_t, T& up,
                                            T& err) const {
    const bool keep = fabsf(to_f32(x)) >= t;
    const T z = from_f32<T>(0.0f);
    up = keep ? x : z;
    err = keep ? z : x;
    return keep;
  }
};

// Params: the op of a segment (row * leaves + leaf) and whether it counts.
struct SparsifyParams {
  const float* t;
  __device__ __forceinline__ SparsifyOp at(int64_t seg) const {
    return {t[seg], Linear{0u, 0u}};
  }
  __device__ __forceinline__ bool owned(int64_t) const { return true; }
};

template <typename Map>
struct QuantizeOp {
  float t, step, levels;
  uint32_t seed;
  Map map;

  template <typename T>
  __device__ __forceinline__ int operator()(T x, uint32_t ctr, T& up,
                                            T& err) const {
    const float xf = to_f32(x);
    const bool keep = fabsf(xf) >= t;
    const float u = dither_u01(seed, ctr);
    float q = floorf(__fadd_rn(__fdiv_rn(xf, step), u));
    q = fminf(fmaxf(q, -levels), levels);
    const T v = from_f32<T>(keep ? __fmul_rn(q, step) : 0.0f);
    up = v;
    err = from_f32<T>(__fsub_rn(xf, to_f32(v)));
    return keep;
  }
};

struct QuantizeParams {
  const float* t;
  const float* step;
  const float* levels;
  const int32_t* seed;
  uint32_t base;
  __device__ __forceinline__ QuantizeOp<Linear> at(int64_t r) const {
    return {t[r], step[r], levels[r], static_cast<uint32_t>(seed[r]),
            Linear{base, 0u}};
  }
  __device__ __forceinline__ bool owned(int64_t) const { return true; }
};

struct SegQuantizeParams {
  const float* t;  // (rows, leaves), like step and levels
  const float* step;
  const float* levels;
  const int32_t* seed;  // (rows,)
  const int64_t* map;  // (leaves, 5): offset, g0, run, stride, owned
  int64_t leaves;
  __device__ __forceinline__ QuantizeOp<Blocked> at(int64_t seg) const {
    const int64_t* m = map + 5 * (seg % leaves);
    return {t[seg], step[seg], levels[seg],
            static_cast<uint32_t>(seed[seg / leaves]),
            Blocked{m[0], static_cast<uint32_t>(m[1]),
                    static_cast<uint32_t>(m[2]), static_cast<uint32_t>(m[3]),
                    0u, 0u}};
  }
  __device__ __forceinline__ bool owned(int64_t seg) const {
    return map[5 * (seg % leaves) + 4] != 0;
  }
};

// A piece: flat [f0, f1) of one segment.
struct Piece {
  int64_t f0, f1, seg;
};

// The row entries' units: tile u is the flat [u T, min((u + 1) T, total))
// of T = kTileVecs x V elements, and its pieces are the rows it crosses.
// A unit's row comes from a double product (exact to one row below
// 2^53 elements, then corrected), not a 64-bit division.
struct Tiles {
  int64_t total, cols, tile;
  double inv_cols;
  __device__ __forceinline__ int64_t count() const {
    return (total + tile - 1) / tile;
  }
  __device__ __forceinline__ Piece load(int64_t u) const {
    const int64_t a = u * tile;
    int64_t r = static_cast<int64_t>(static_cast<double>(a) * inv_cols);
    if (r * cols > a) {
      --r;
    } else if ((r + 1) * cols <= a) {
      ++r;
    }
    return {a, a + tile < total ? a + tile : total, r};
  }
  template <typename F>
  __device__ __forceinline__ void each(Piece p, F&& f) const {
    for (int64_t a = p.f0, r = p.seg; a < p.f1; ++r) {
      const int64_t end = (r + 1) * cols;
      const int64_t b = end < p.f1 ? end : p.f1;
      f(a, b, r);
      a = b;
    }
  }
};

// The segmented entry's units: the host table's pieces (header), one each.
struct Table {
  const int64_t* __restrict__ pieces;
  int64_t n;
  __device__ __forceinline__ int64_t count() const { return n; }
  __device__ __forceinline__ Piece load(int64_t u) const {
    return {pieces[3 * u], pieces[3 * u + 1], pieces[3 * u + 2]};
  }
  template <typename F>
  __device__ __forceinline__ void each(Piece p, F&& f) const {
    f(p.f0, p.f1, p.seg);
  }
};

// A warp's counts of segment seg added into acc[seg] by its lane 0 (if the
// segment is owned and the sum is not zero). Called by every thread of
// the block alike.
template <typename P>
__device__ __forceinline__ void warp_count_add(int64_t seg, int count,
                                               unsigned long long* acc,
                                               const P& params) {
  const int sum = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0 && sum != 0 && params.owned(seg))
    atomicAdd(acc + seg, static_cast<unsigned long long>(sum));
}

// The block's units (header): blockIdx.x and blockIdx.x + gridDim.x, then
// as many as it takes from the counter work[1] (2 G + its value, taken a
// unit ahead, its atomic's latency hidden by a unit's work), so that a
// slower SM takes fewer. A piece's vectors go kRing at a time a thread:
// the kRing loads are issued before the first store, then drained a
// vector a turn, the ring shifted in registers (the op's code emitted
// once). The < V elements before a piece's first vector and after its
// last (all of a piece whose leaf's run is under V) go an element a
// thread. The segment's op and row offset stay in registers, and each
// thread's count in it, while consecutive pieces keep the segment; a
// warp's count goes into work[2 + seg] when it changes. One block sync a
// unit, for the counter's value. Then the ticket work[0], whose last
// taker writes the `segments` totals to counts (f32, rounded once, or
// int64) and leaves the accumulator, the counter and the ticket at zero.
template <typename T, typename P, typename Units>
__device__ __forceinline__ void run_units(
    const T* __restrict__ x, T* __restrict__ up, T* __restrict__ err,
    const Units& units, int64_t cols, int64_t leaves, int64_t segments,
    unsigned long long* work, void* counts, bool f32, const P& params) {
  constexpr int V = Vec<T>::n;
  unsigned long long* grab = work + 1;
  unsigned long long* acc = work + 2;
  int64_t cur = -1, roff = 0;  // the segment (uniform over the block)
  decltype(params.at(0)) op{};
  bool vec = true;  // its pieces' aligned vectors go as vectors
  int cnt = 0;  // this thread's count in it
  __shared__ int64_t s_next[2];

  const int64_t n = units.count();
  int64_t u = blockIdx.x, nu = u + gridDim.x;
  Piece now = u < n ? units.load(u) : Piece{0, 0, 0};
  for (int turn = 0; u < n; turn ^= 1) {
    unsigned long long taken = 0;
    if (threadIdx.x == 0 && nu < n) taken = atomicAdd(grab, 1ull);
    // the next unit, ahead of this one's loads
    const Piece ahead = nu < n ? units.load(nu) : Piece{0, 0, 0};
    units.each(now, [&](int64_t f0, int64_t f1, int64_t seg) {
      if (seg != cur) {
        if (cur >= 0) warp_count_add(cur, cnt, acc, params);
        cur = seg;
        cnt = 0;
        op = params.at(seg);
        op.map.prepare(kThreads * V);
        vec = op.map.vectors(V);
        roff = (seg / leaves) * cols;
      }
      int64_t head = (V - f0 % V) % V;
      if (head > f1 - f0 || !vec) head = f1 - f0;
      const int64_t start = f0 + head;
      const int nvec = static_cast<int>((f1 - start) / V);
      const int64_t tail = start + static_cast<int64_t>(nvec) * V;
      const uint4* xv = reinterpret_cast<const uint4*>(x + start);
      uint4* uv = reinterpret_cast<uint4*>(up + start);
      uint4* ev = reinterpret_cast<uint4*>(err + start);
      auto walk = op.map.walk(start - roff + threadIdx.x * V);
      for (int base = threadIdx.x; base < nvec; base += kRing * kThreads) {
        uint4 in[kRing];
#pragma unroll
        for (int k = 0; k < kRing; ++k) {
          const int v = base + k * kThreads;
          if (v < nvec) in[k] = __ldcs(xv + v);
        }
#pragma unroll 1
        for (int k = 0; k < kRing; ++k) {
          const int v = base + k * kThreads;
          if (v >= nvec) break;
          alignas(16) T xin[V];
          alignas(16) T uo[V];
          alignas(16) T eo[V];
          *reinterpret_cast<uint4*>(xin) = in[0];
#pragma unroll
          for (int r = 0; r + 1 < kRing; ++r) in[r] = in[r + 1];
          const auto ctr = op.map.here(walk);
          op.map.next(walk);
#pragma unroll
          for (int i = 0; i < V; ++i) cnt += op(xin[i], ctr.at(i), uo[i], eo[i]);
          __stcs(uv + v, *reinterpret_cast<uint4*>(uo));
          __stcs(ev + v, *reinterpret_cast<uint4*>(eo));
        }
      }
      // the edges, an element a thread
      const int64_t edges = head + (f1 - tail);
      for (int64_t j = threadIdx.x; j < edges; j += kThreads) {
        const int64_t g = j < head ? f0 + j : tail + (j - head);
        const uint32_t c = op.map.here(op.map.walk(g - roff)).at(0);
        cnt += op(x[g], c, up[g], err[g]);
      }
    });
    now = ahead;
    // two slots: a slot is written again only after the next sync
    if (threadIdx.x == 0) s_next[turn] = 2 * static_cast<int64_t>(gridDim.x) + taken;
    __syncthreads();
    u = nu;
    nu = s_next[turn];
  }
  if (cur >= 0) warp_count_add(cur, cnt, acc, params);

  // every warp's counts land before thread 0 takes the block's ticket
  if ((threadIdx.x & 31) == 0) __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(work, 1ull) == static_cast<unsigned long long>(gridDim.x - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < segments; i += kThreads) {
    const long long v = static_cast<long long>(atomicExch(acc + i, 0ull));
    if (f32)
      static_cast<float*>(counts)[i] = __ll2float_rn(v);
    else
      static_cast<long long*>(counts)[i] = v;
  }
  if (threadIdx.x == 0) {
    atomicExch(work, 0ull);
    atomicExch(grab, 0ull);
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    row_pass(const T* __restrict__ x, T* __restrict__ up, T* __restrict__ err,
             int64_t rows, int64_t cols, unsigned long long* work,
             float* counts, P params) {
  // cols = 0: no tiles, and inv_cols (infinite) is never read
  const Tiles tiles{rows * cols, cols,
                    static_cast<int64_t>(kTileVecs) * Vec<T>::n,
                    1.0 / static_cast<double>(cols)};
  run_units<T>(x, up, err, tiles, cols, 1, rows, work, counts, true, params);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segmented_pass(const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ err, const int64_t* __restrict__ plan,
                   int64_t npieces, int64_t rows, int64_t cols,
                   unsigned long long* work, void* counts, int f32_counts,
                   SegQuantizeParams params) {
  run_units<T>(x, up, err, Table{plan, npieces}, cols, params.leaves,
               rows * params.leaves, work, counts, f32_counts != 0, params);
}

// kind: 0 sparsify_ef, 1 sparsify_quantize_ef, 2 segmented; dtype as below.
template <typename T>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(row_pass<T, SparsifyParams>);
    case 1: return reinterpret_cast<const void*>(row_pass<T, QuantizeParams>);
    case 2: return reinterpret_cast<const void*>(segmented_pass<T>);
    default: return nullptr;
  }
}

template <typename P>
int launch_rows(const void* x, void* up, void* err, float* counts,
                int64_t blocks, unsigned long long* work, int64_t rows,
                int64_t cols, int dtype, P params, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    row_pass<float, P><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(up),
        static_cast<float*>(err), rows, cols, work, counts, params);
  } else if (dtype == 1) {
    row_pass<__nv_bfloat16, P><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(err), rows, cols, work, counts, params);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most blocks of kernel `kind` (0 sparsify_ef, 1 sparsify_quantize_ef,
// 2 segmented) resident on the current device at once: blocks a SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs. A
// negative value is minus a CUDA error.
extern "C" int sparsify_ef_resident_blocks(int kind, int dtype) {
  const void* fn = dtype == 0   ? kernel_of<float>(kind)
                   : dtype == 1 ? kernel_of<__nv_bfloat16>(kind)
                                : nullptr;
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers;
// x, up and err are (rows, cols) row-major and 16-byte aligned; t, step,
// levels, seed and counts are (rows,), counts f32; `blocks` blocks take
// the tiles (header; with cols = 0 there are none, and a call only
// writes zero counts); work is the device's int64 workspace (the ticket,
// the unit counter, then the accumulator) with at least 2 + rows slots,
// all zero (the kernel leaves them so). Returns cudaGetLastError().
extern "C" int sparsify_ef_launch(const void* x, void* up, void* err,
                                  float* counts, const float* t,
                                  int64_t blocks, unsigned long long* work,
                                  int64_t rows, int64_t cols, int dtype,
                                  void* stream) {
  return launch_rows(x, up, err, counts, blocks, work, rows, cols, dtype,
                     SparsifyParams{t}, stream);
}

extern "C" int sparsify_quantize_ef_launch(
    const void* x, void* up, void* err, float* counts, const float* t,
    const float* step, const float* levels, const int32_t* seed,
    uint32_t base, int64_t blocks, unsigned long long* work, int64_t rows,
    int64_t cols, int dtype, void* stream) {
  return launch_rows(x, up, err, counts, blocks, work, rows, cols, dtype,
                     QuantizeParams{t, step, levels, seed, base}, stream);
}

// The segmented entry: t, step and levels are (rows, leaves); plan is the
// table of the header over the leaf boundaries, `npieces` pieces;
// map is the (leaves, 5)
// int64 counter map (header: offset, g0, R, G, owned, with g0 and G taken
// mod 2^32 and 0 < R < 2^32); counts is (rows, leaves), f32 where
// f32_counts else int64, 0 for a leaf that is not owned; work holds at
// least 2 + rows * leaves slots.
extern "C" int sparsify_quantize_ef_segmented_launch(
    const void* x, void* up, void* err, void* counts, int f32_counts,
    const float* t, const float* step, const float* levels,
    const int32_t* seed, const int64_t* plan, int64_t blocks, int64_t npieces,
    const int64_t* map, int64_t leaves, unsigned long long* work,
    int64_t rows, int64_t cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const SegQuantizeParams params{t, step, levels, seed, map, leaves};
  if (dtype == 0) {
    segmented_pass<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(up),
        static_cast<float*>(err), plan, npieces, rows, cols, work, counts,
        f32_counts, params);
  } else if (dtype == 1) {
    segmented_pass<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(err), plan, npieces, rows, cols, work,
        counts, f32_counts, params);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
