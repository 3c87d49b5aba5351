// Flash-decoding attention: one query token per sequence against a KV
// cache, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py:
//   decode_attn (:64, body _kernel :27)
//
// q (B, H, D), k and v (B, S, KV, D), all f32 or all bf16, contiguous;
// G = H / KV query rows share each KV head (GQA).  Positions >= len are
// masked (the wrapper clamps len to S).  out (B, H, D) in q's dtype:
//   out[b, kh*G + g] = softmax_j(q . k[b, j, kh] * rsqrt(D))  .  v[b, :, kh]
// with scores, softmax and sums in f32.
//
// Bound: bytes.  Every valid K and V row is read once (2 * len * KV * D
// elements per sequence) for 4 * G flops per element pair, far below the
// card's operation rate for G <= 8, so the floor is the HBM rate.
//
// Design.  The TPU grid walks S in order on one core and carries (m, l,
// acc) from block to block.  Here B * KV is small (64 on the serve path),
// so S is split across blocks, flash-decoding style: grid (B * KV, nsplit),
// each block owns one KV head of one sequence and a contiguous share of
// the valid positions, so the whole card is busy and no block reads a
// masked row.  A block keeps its G query rows in shared memory (f32); each
// of its warps takes kKeys keys at a time (loads for all of them issued
// before any is used), lane l holding elements l, l + 32, ... of a row so
// that every load instruction of a warp reads 32 consecutive elements.
// Scores are reduced across the warp with shuffles, and each warp runs its
// own online softmax in registers.  At the end the warps are merged in
// shared memory and the block writes a partial (m, l, acc) to an f32
// workspace; a second small kernel merges the splits and divides.  A
// split or a warp that saw no key has m = -inf and contributes nothing
// (the guards of the TPU kernel's isfinite checks); len = 0 gives zeros,
// as the TPU kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 4;  // keys in flight per warp

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// exp(m_old - m_new), or 0 when m_old is -inf (nothing seen yet).
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f : expf(m_old - m_new);
}

// DL = D / 32 elements per lane; MAXG >= G query rows per KV head.
template <typename T, int DL, int MAXG>
__global__ void __launch_bounds__(kThreads) decode_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ ws_m, float* __restrict__ ws_l,
    float* __restrict__ ws_acc, int S, int KV, int G, int len, int per_split,
    float scale) {
  constexpr int D = DL * 32;
  const int bk = blockIdx.x;  // b * KV + kh
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int b = bk / KV, kh = bk % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* qs = smem;                  // G * D
  float* wm = qs + G * D;            // kWarps * G
  float* wl = wm + kWarps * G;       // kWarps * G
  float* wacc = wl + kWarps * G;     // kWarps * G * D

  const T* qrow = q + (static_cast<size_t>(b) * KV + kh) * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f32(qrow[i]);
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][DL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  const int start = split * per_split;
  const int end = min(start + per_split, len);
  const size_t row = static_cast<size_t>(KV) * D;  // elements between keys
  const T* kbase = k + static_cast<size_t>(b) * S * row + kh * D + lane;
  const T* vbase = v + static_cast<size_t>(b) * S * row + kh * D + lane;

  for (int j0 = start + warp * kKeys; j0 < end; j0 += kWarps * kKeys) {
    float kr[kKeys][DL], vr[kKeys][DL];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const bool ok = j0 + i < end;
      const T* kp = kbase + (j0 + i) * row;
      const T* vp = vbase + (j0 + i) * row;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kr[i][e] = ok ? to_f32(kp[32 * e]) : 0.f;
        vr[i][e] = ok ? to_f32(vp[32 * e]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[kKeys];
      float smax = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) part += qs[g * D + lane + 32 * e] * kr[i][e];
        s[i] = j0 + i < end ? warp_sum(part) * scale : -INFINITY;
        smax = fmaxf(smax, s[i]);
      }
      const float m_new = fmaxf(m[g], smax);  // finite: key j0 is valid
      const float corr = rescale(m[g], m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float p = j0 + i < end ? expf(s[i] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[g][e] += p * vr[i][e];
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
    }
  }

  // merge the warps of the block
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e)
      wacc[(warp * G + g) * D + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bk) * nsplit + split;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(wm[w * G + g], mm);
      ll += wl[w * G + g] * f;
      aa += wacc[(w * G + g) * D + d] * f;
    }
    ws_acc[(part * G + g) * D + d] = aa;
    if (d == 0) {
      ws_m[part * G + g] = mm;
      ws_l[part * G + g] = ll;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) decode_combine(
    const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, T* __restrict__ out, int nsplit, int G,
    int D) {
  const int bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    const size_t p0 = static_cast<size_t>(bk) * nsplit;
    float mm = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, ws_m[(p0 + s) * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = rescale(ws_m[(p0 + s) * G + g], mm);
      ll += ws_l[(p0 + s) * G + g] * f;
      aa += ws_acc[((p0 + s) * G + g) * D + d] * f;
    }
    out[(static_cast<size_t>(bk) * G + g) * D + d] = from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int DL, int MAXG>
int launch_t(const void* q, const void* k, const void* v, void* out,
             float* ws, int B, int S, int KV, int G, int len, int per_split,
             int nsplit, cudaStream_t s) {
  constexpr int D = DL * 32;
  const size_t parts = static_cast<size_t>(B) * KV * nsplit * G;
  float* ws_m = ws;
  float* ws_l = ws + parts;
  float* ws_acc = ws + 2 * parts;
  const size_t shmem = sizeof(float) * (G * D + kWarps * (2 * G + G * D));
  dim3 grid(B * KV, nsplit);
  decode_split<T, DL, MAXG><<<grid, kThreads, shmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws_m, ws_l, ws_acc, S, KV, G, len, per_split,
      1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine<T><<<B * KV, 256, 0, s>>>(ws_m, ws_l, ws_acc,
                                           static_cast<T*>(out), nsplit, G, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DL>
int launch_g(const void* q, const void* k, const void* v, void* out,
             float* ws, int B, int S, int KV, int G, int len, int per_split,
             int nsplit, cudaStream_t s) {
  if (G <= 4)
    return launch_t<T, DL, 4>(q, k, v, out, ws, B, S, KV, G, len, per_split,
                              nsplit, s);
  if (G <= 8)
    return launch_t<T, DL, 8>(q, k, v, out, ws, B, S, KV, G, len, per_split,
                              nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* ws, int B, int S, int KV, int G, int D, int len,
             int per_split, int nsplit, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_g<T, 2>(q, k, v, out, ws, B, S, KV, G, len, per_split, nsplit, s);
    case 128:
      return launch_g<T, 4>(q, k, v, out, ws, B, S, KV, G, len, per_split, nsplit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Device pointers: q and out (B, H, D),
// k and v (B, S, KV, D), contiguous; ws holds B*KV*nsplit*G*(D + 2) f32.
// H = KV * G, D in {64, 128} (the head dims of the ported configs), G <= 8;
// 0 <= len <= S; nsplit * per_split >= len.  Returns cudaGetLastError().
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  void* out, float* ws, int B, int S, int KV,
                                  int G, int D, int len, int per_split,
                                  int nsplit, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, ws, B, S, KV, G, D, len, per_split,
                           nsplit, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, ws, B, S, KV, G, D, len,
                                   per_split, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
