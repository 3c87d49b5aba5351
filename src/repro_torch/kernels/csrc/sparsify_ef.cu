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
//                          u = lowbias32(seed, base + column) / 2^32
//   both:                  count = #{|x| >= t}
// The mask is taken on the f32 value; outputs are stored in x's dtype.
//
// Bound: bytes. Each element is read once and written twice (12 B in f32,
// 6 B in bf16) for a few ALU operations (about 20 integer and float ops
// with the dither hash), far below the card's operation rate, so the time
// floor is the HBM rate. Design for that: the whole federation in ONE
// launch (the TPU version is vmapped per device and per leaf); the grid is
// (blocks_per_row, rows) and each block streams its row with 16-byte
// vector loads and stores in a grid-stride loop. Rows need not start on a
// 16-byte boundary (s = 6,573,130 is not a multiple of 4), so the few
// elements before a row's first aligned vector and its ragged tail are
// done one by one. Nothing is padded, so the count needs no correction.
// The count is reduced in registers, by warp shuffles and shared memory,
// with one 64-bit atomicAdd per block into the row's int64 total, so a
// row may hold 2^31 columns and more (a thread's own count stays an int:
// it sees at most a 2^-8 share of a row).
//
// The dither column is a uint32: column c of a call draws
// lowbias32(seed, (base + c) mod 2^32), which is what the reference's
// int32 index gives once it is cast to uint32, so a row may cross 2^32.
// One launch covers the whole call whatever its size.
//
// The segmented entry replaces the per-leaf calls of the reference's
// per-layer codec (src/repro/compression/perlayer.py:208, one Pallas call
// per leaf and per device with base = the leaf's offset). The dither
// counter base + index-within-leaf is the flat column, so all leaves of
// all devices go in ONE launch with the dither unchanged. Its grid is
// (tiles, rows): a host-built table cuts each leaf into column tiles that
// never straddle a leaf boundary, and a block streams its tile of its row
// with the same 16-byte body and scalar edges (leaf starts are not 16-byte
// aligned), then adds its count once into (row, leaf).
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

struct SparsifyOp {
  float t;

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

struct SparsifyParams {
  const float* t;
  __device__ __forceinline__ SparsifyOp row(int r) const { return {t[r]}; }
};

struct QuantizeOp {
  float t, step, levels;
  uint32_t seed, base;

  template <typename T>
  __device__ __forceinline__ int operator()(T x, uint32_t col, T& up,
                                            T& err) const {
    const float xf = to_f32(x);
    const bool keep = fabsf(xf) >= t;
    const float u = dither_u01(seed, base + col);
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
  __device__ __forceinline__ QuantizeOp row(int r) const {
    return {t[r], step[r], levels[r], static_cast<uint32_t>(seed[r]), base};
  }
};

struct SegQuantizeParams {
  const float* t;  // (rows, leaves), like step and levels
  const float* step;
  const float* levels;
  const int32_t* seed;  // (rows,)
  int64_t leaves;
  __device__ __forceinline__ QuantizeOp at(int r, int64_t leaf) const {
    const int64_t i = static_cast<int64_t>(r) * leaves + leaf;
    return {t[i], step[i], levels[i], static_cast<uint32_t>(seed[r]), 0u};
  }
};

// Columns [c0, c1) of one row (xr, ur, er point at the row's column 0,
// whose flat offset is off): vector i = first, first + stride, ... of the
// 16-byte vectors inside the span, and, when `edges`, the < V elements
// before the first aligned vector and the < V after the last one, one per
// thread. Returns this thread's count.
template <typename T, typename Op>
__device__ __forceinline__ int stream_span(const T* xr, T* ur, T* er,
                                           int64_t off, int64_t c0,
                                           int64_t c1, int64_t first,
                                           int64_t stride, bool edges,
                                           const Op& op) {
  constexpr int V = Vec<T>::n;
  // base pointers are 16-byte aligned, so the span's first aligned element
  // is the one whose flat offset is a multiple of V
  int64_t head = (V - (off + c0) % V) % V;
  if (head > c1 - c0) head = c1 - c0;
  const int64_t start = c0 + head;
  const int64_t nvec = (c1 - start) / V;
  const int64_t tail = start + nvec * V;

  int count = 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + start);
  uint4* uv = reinterpret_cast<uint4*>(ur + start);
  uint4* ev = reinterpret_cast<uint4*>(er + start);
  for (int64_t i = first; i < nvec; i += stride) {
    alignas(16) T xin[V];
    alignas(16) T uo[V];
    alignas(16) T eo[V];
    *reinterpret_cast<uint4*>(xin) = __ldcs(xv + i);
    const uint32_t col = static_cast<uint32_t>(start + i * V);
#pragma unroll
    for (int j = 0; j < V; ++j) count += op(xin[j], col + j, uo[j], eo[j]);
    __stcs(uv + i, *reinterpret_cast<uint4*>(uo));
    __stcs(ev + i, *reinterpret_cast<uint4*>(eo));
  }
  if (edges) {
    const int64_t j = threadIdx.x;
    int64_t c = -1;
    if (j < head) {
      c = c0 + j;
    } else if (j - head < c1 - tail) {
      c = tail + (j - head);
    }
    if (c >= 0) count += op(xr[c], static_cast<uint32_t>(c), ur[c], er[c]);
  }
  return count;
}

// The block's total of the threads' counts added once into *dst (by warp
// shuffles and shared memory, in 64 bits).
__device__ __forceinline__ void block_count_add(int thread_count,
                                                unsigned long long* dst) {
  long long count = thread_count;
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  __shared__ long long warp_counts[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? warp_counts[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
    if (lane == 0 && count != 0)
      atomicAdd(dst, static_cast<unsigned long long>(count));
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    row_pass(const T* __restrict__ x, T* __restrict__ up, T* __restrict__ err,
             unsigned long long* __restrict__ counts, int64_t cols,
             P params) {
  const int r = blockIdx.y;
  const int64_t off = static_cast<int64_t>(r) * cols;
  const int count = stream_span<T>(
      x + off, up + off, err + off, off, 0, cols,
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<int64_t>(gridDim.x) * blockDim.x, blockIdx.x == 0,
      params.row(r));
  block_count_add(count, counts + r);
}

// tiles: (gridDim.x, 3) int64 rows of (leaf, first column, end column).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segmented_pass(const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ err,
                   unsigned long long* __restrict__ counts,
                   const int64_t* __restrict__ tiles, int64_t cols,
                   SegQuantizeParams params) {
  const int r = blockIdx.y;
  const int64_t* tile = tiles + 3 * static_cast<int64_t>(blockIdx.x);
  const int64_t leaf = tile[0];
  const int64_t off = static_cast<int64_t>(r) * cols;
  const int count =
      stream_span<T>(x + off, up + off, err + off, off, tile[1], tile[2],
                     threadIdx.x, blockDim.x, true, params.at(r, leaf));
  block_count_add(count, counts + static_cast<int64_t>(r) * params.leaves + leaf);
}

int blocks_per_row(int64_t rows, int64_t cols, int vec) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  // about eight resident blocks per SM over the whole federation
  const int64_t want = (8LL * sms + rows - 1) / rows;
  const int64_t need = (cols / vec + kThreads - 1) / kThreads;
  int64_t b = want < need ? want : need;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <typename P>
int launch(const void* x, void* up, void* err, unsigned long long* counts,
           int64_t rows, int64_t cols, int dtype, P params, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, rows * sizeof(*counts), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0) {
    dim3 grid(blocks_per_row(rows, cols, Vec<float>::n),
              static_cast<unsigned>(rows));
    row_pass<float, P><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(up),
        static_cast<float*>(err), counts, cols, params);
  } else if (dtype == 1) {
    dim3 grid(blocks_per_row(rows, cols, Vec<__nv_bfloat16>::n),
              static_cast<unsigned>(rows));
    row_pass<__nv_bfloat16, P><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(err), counts, cols, params);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_segmented(const void* x, void* up, void* err,
                     unsigned long long* counts,
                     const int64_t* tiles, int64_t ntiles, int64_t rows,
                     int64_t cols, int dtype, SegQuantizeParams params,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaMemsetAsync(counts, 0, rows * params.leaves * sizeof(*counts), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rows == 0 || ntiles == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(rows));
  if (dtype == 0) {
    segmented_pass<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(up),
        static_cast<float*>(err), counts, tiles, cols, params);
  } else if (dtype == 1) {
    segmented_pass<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(err), counts, tiles, cols, params);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers;
// x, up and err are (rows, cols) row-major and 16-byte aligned; t, step,
// levels, seed and counts are (rows,); counts are int64. Returns
// cudaGetLastError().
extern "C" int sparsify_ef_launch(const void* x, void* up, void* err,
                                  unsigned long long* counts, const float* t,
                                  int64_t rows,
                                  int64_t cols, int dtype, void* stream) {
  return launch(x, up, err, counts, rows, cols, dtype, SparsifyParams{t},
                stream);
}

extern "C" int sparsify_quantize_ef_launch(const void* x, void* up, void* err,
                                           unsigned long long* counts,
                                           const float* t,
                                           const float* step,
                                           const float* levels,
                                           const int32_t* seed, uint32_t base,
                                           int64_t rows, int64_t cols,
                                           int dtype, void* stream) {
  return launch(x, up, err, counts, rows, cols, dtype,
                QuantizeParams{t, step, levels, seed, base}, stream);
}

// The segmented entry: t, step and levels are (rows, leaves); tiles is an
// (ntiles, 3) int64 device array of (leaf, first column, end column) that
// covers every column once, no tile crossing a leaf boundary; counts is
// (rows, leaves).
extern "C" int sparsify_quantize_ef_segmented_launch(
    const void* x, void* up, void* err, unsigned long long* counts,
    const float* t, const float* step, const float* levels,
    const int32_t* seed,
    const int64_t* tiles, int64_t ntiles, int64_t leaves, int64_t rows,
    int64_t cols, int dtype, void* stream) {
  return launch_segmented(x, up, err, counts, tiles, ntiles, rows, cols, dtype,
                          SegQuantizeParams{t, step, levels, seed, leaves},
                          stream);
}
