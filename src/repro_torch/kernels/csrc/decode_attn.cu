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
// so the valid positions are split across blocks: grid (B * KV, nsplit),
// each block owns one KV head of one sequence and one long contiguous
// share of the valid positions (the wrapper sizes the split so that one
// wave of blocks, two per SM, fills the card).  A block streams its share
// through a ring of kStages tiles in shared memory, K and V rows copied
// with 16-byte cp.async (zero-filled, never read, at and beyond len), so
// that tens of KB are in flight per SM.  Rows are stored with their
// 16-byte chunks XOR-swizzled by (row & 7), so ldmatrix reads them
// without bank conflicts.
//   bf16: the four warps take 16 keys of a 64-key tile each and run the
//   products on the tensor cores (mma.sync m16n8k16, f32 accumulate), keys
//   as the M dimension: S = K q^T (16 keys x 8 query columns; the G <= 8
//   query rows of a KV head fill n = 8, q^T's fragments live in registers
//   for the whole block), then out^T += V^T P^T, V^T fed by ldmatrix.trans
//   and P^T made from S's accumulator fragment by movmatrix.trans.  The
//   online softmax (m, l) runs per query column on the fragments: three
//   shuffles per column per 16 keys.
//   f32: TF32 would miss the 2e-5 tolerance, so the products stay on FMAs:
//   the warps take 8 keys of a 32-key tile each, lane l holding D / 32
//   consecutive elements of a row (16- or 8-byte shared-memory reads), one
//   warp reduction per key and query row.
// At the end the warps are merged in shared memory.  With one split the
// block writes the output; otherwise it writes a partial (m, l, acc) to
// an f32 workspace and the splits are merged by the last block of the
// (b, kv-head) to finish, which takes an atomic ticket and resets it to 0
// for the next call (on an H100 at the serve shape this beat a second
// merge launch by 1-2 us, PERF.md).  A split or a warp that saw no key has
// m = -inf and weighs 0 (the TPU kernel's isfinite guards); len = 0 gives
// zeros, as the TPU kernel does.
//
// The partials entry (kPartial) is the same kernel with another last
// store: the block that finishes a (b, kv-head) writes its merged f32
// (m, l, acc) in head order, m the max of the scaled scores, l the sum of
// exp(s - m), acc the unnormalised output: the TPU kernel's pallas_call
// outputs before its wrapper divides.  A rank that holds a block of a
// cache's slots attends over them with it, and the ranks' partials are
// merged (sharding/collectives.py); len = 0 gives m = -inf, l = 0, acc = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kMaxG = 8;

template <typename T>
struct Tile;  // keys per pipeline tile: 16 (bf16) or 8 (f32) per warp
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kKeys = 64;
};
template <>
struct Tile<float> {
  static constexpr int kKeys = 32;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of 16-byte chunk c of tile row r (row of RB bytes), swizzled.
template <int RB>
__device__ __forceinline__ int swz(int r, int c) {
  return r * RB + ((c ^ (r & 7)) << 4);
}

// The finished (m, l, acc) of query row o = (b * KV + kh) * G + g at
// element d: normalised into out, or (kPartial) stored as it is.
template <typename T, bool kPartial>
__device__ __forceinline__ void finish(T* out, float* pm, float* pl,
                                       float* pacc, size_t o, int D, int d,
                                       float mm, float ll, float aa) {
  if constexpr (kPartial) {
    pacc[o * D + d] = aa;
    if (d == 0) {
      pm[o] = mm;
      pl[o] = ll;
    }
  } else {
    out[o * D + d] = from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 2) decode_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ pm, float* __restrict__ pl,
    float* __restrict__ pacc, float* __restrict__ ws_m,
    float* __restrict__ ws_l, float* __restrict__ ws_acc,
    int* __restrict__ tickets, int S, int KV, int G, int len, int per_split,
    float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKeys = Tile<T>::kKeys;
  constexpr int RB = D * static_cast<int>(sizeof(T));  // bytes of a row
  constexpr int CPR = RB / 16;                          // chunks of a row
  constexpr int TB = kKeys * RB;                        // bytes of a tile
  constexpr int WK = kKeys / kWarps;                    // keys of a warp
  const int bk = blockIdx.x;  // b * KV + kh
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int b = bk / KV, kh = bk % KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const uint32_t sbase = smem_u32(smem);

  const int start = split * per_split;
  const int end = min(start + per_split, len);
  const int ntiles = end > start ? (end - start + kKeys - 1) / kKeys : 0;
  const size_t row = static_cast<size_t>(KV) * D;  // elements between keys
  const T* kbase = k + static_cast<size_t>(b) * S * row + kh * D;
  const T* vbase = v + static_cast<size_t>(b) * S * row + kh * D;

  auto load_tile = [&](int tile, int slot) {
    const int t0 = start + tile * kKeys;
    const uint32_t ks = sbase + slot * 2 * TB, vs = ks + TB;
#pragma unroll 4
    for (int i = tid; i < kKeys * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = t0 + r < end;
      const size_t off = ok ? (t0 + r) * row + c * (16 / sizeof(T)) : 0;
      cp_async16(ks + swz<RB>(r, c), kbase + off, ok ? 16 : 0);
      cp_async16(vs + swz<RB>(r, c), vbase + off, ok ? 16 : 0);
    }
  };

  const T* qrow = q + static_cast<size_t>(bk) * G * D;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair

  // per-thread state: bf16 keeps two query columns (2tq, 2tq + 1) and the
  // out^T fragments; f32 keeps every query row and D / 32 elements of it.
  constexpr int kMt = kBf16 ? D / 16 : 1;
  constexpr int EPL = D / 32;
  float bm[2] = {-INFINITY, -INFINITY}, bl[2] = {0.f, 0.f};
  float bacc[kMt][4];
  uint32_t qb[kMt][2];
  float fm[kBf16 ? 1 : kMaxG], fl[kBf16 ? 1 : kMaxG];
  float facc[kBf16 ? 1 : kMaxG][EPL], qr[kBf16 ? 1 : kMaxG][EPL];
  if constexpr (kBf16) {
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) bacc[mt][e] = 0.f;
      // q^T as the B operand: q[gq][16 mt + 2tq (+1)] and the same + 8
      const uint32_t* qp =
          reinterpret_cast<const uint32_t*>(qrow + gq * D + mt * 16 + 2 * tq);
      qb[mt][0] = gq < G ? qp[0] : 0u;
      qb[mt][1] = gq < G ? qp[4] : 0u;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      fm[g] = -INFINITY;
      fl[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        facc[g][e] = 0.f;
        qr[g][e] = g < G ? qrow[g * D + lane * EPL + e] : 0.f;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; slot (it - 1) % kStages is free
    if (it + kStages - 1 < ntiles)
      load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int t0 = start + it * kKeys + warp * WK;  // the warp's first key
    if (t0 >= end) continue;                         // warp-uniform
    const int slot = it % kStages;
    const uint32_t ks = sbase + slot * 2 * TB, vs = ks + TB;

    if constexpr (kBf16) {
      const int mat = lane >> 3, mr = lane & 7;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kMt; ++kk) {
        const int r = warp * WK + (mat & 1) * 8 + mr;
        uint32_t a[4];
        ldsm_x4(a, ks + swz<RB>(r, kk * 2 + (mat >> 1)));
        mma_bf16(s, a, qb[kk][0], qb[kk][1]);
      }
      // s[0], s[1]: key t0 + gq, query columns 2tq, 2tq + 1; s[2], s[3]: key + 8
      const bool v0 = t0 + gq < end, v1 = t0 + gq + 8 < end;
      s[0] = v0 ? s[0] * scale : -INFINITY;
      s[1] = v0 ? s[1] * scale : -INFINITY;
      s[2] = v1 ? s[2] * scale : -INFINITY;
      s[3] = v1 ? s[3] * scale : -INFINITY;
      float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
      }
      float p[4], corr[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float mn = fmaxf(bm[c], mx[c]);  // finite: key t0 is valid
        corr[c] = rescale(bm[c], mn);
        p[c] = expf(s[c] - mn);
        p[c + 2] = expf(s[c + 2] - mn);
        bl[c] = bl[c] * corr[c] + p[c] + p[c + 2];
        bm[c] = mn;
      }
      // P^T as the B operand of out^T += V^T P^T
      const uint32_t pb0 = movmatrix_trans(pack_bf16(p[0], p[1]));
      const uint32_t pb1 = movmatrix_trans(pack_bf16(p[2], p[3]));
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        bacc[mt][0] *= corr[0];
        bacc[mt][1] *= corr[1];
        bacc[mt][2] *= corr[0];
        bacc[mt][3] *= corr[1];
        const int r = warp * WK + (mat >> 1) * 8 + mr;
        uint32_t a[4];
        ldsm_x4_trans(a, vs + swz<RB>(r, mt * 2 + (mat & 1)));
        mma_bf16(bacc[mt], a, pb0, pb1);
      }
    } else {
      const unsigned char* kp = smem + slot * 2 * TB;
      const unsigned char* vp = kp + TB;
      const int byte = lane * EPL * 4;
      float kr[WK][EPL], vr[WK][EPL];
#pragma unroll
      for (int j = 0; j < WK; ++j) {
        const int r = warp * WK + j;
        const int o = swz<RB>(r, byte >> 4) + (byte & 15);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[j][e] = reinterpret_cast<const float*>(kp + o)[e];
          vr[j][e] = reinterpret_cast<const float*>(vp + o)[e];
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float s[WK];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < WK; ++j) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part += qr[g][e] * kr[j][e];
          s[j] = t0 + j < end ? warp_sum(part) * scale : -INFINITY;
          mx = fmaxf(mx, s[j]);
        }
        const float mn = fmaxf(fm[g], mx);
        const float corr = rescale(fm[g], mn);
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) facc[g][e] *= corr;
#pragma unroll
        for (int j = 0; j < WK; ++j) {
          const float pj = expf(s[j] - mn);  // 0 for a masked key
          psum += pj;
#pragma unroll
          for (int e = 0; e < EPL; ++e) facc[g][e] += pj * vr[j][e];
        }
        fl[g] = fl[g] * corr + psum;
        fm[g] = mn;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to merge the warps

  float* wm = reinterpret_cast<float*>(smem);  // kWarps x kMaxG
  float* wl = wm + kWarps * kMaxG;             // kWarps x kMaxG
  float* wacc = wl + kWarps * kMaxG;           // kWarps x kMaxG x D
  if constexpr (kBf16) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        bl[c] += __shfl_xor_sync(0xffffffffu, bl[c], off);
      const int g = 2 * tq + c;
      if (g < G) {
        if (gq == 0) {
          wm[warp * kMaxG + g] = bm[c];
          wl[warp * kMaxG + g] = bl[c];
        }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          float* dst = wacc + (warp * kMaxG + g) * D + mt * 16 + gq;
          dst[0] = bacc[mt][c];
          dst[8] = bacc[mt][c + 2];
        }
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      if (lane == 0) {
        wm[warp * kMaxG + g] = fm[g];
        wl[warp * kMaxG + g] = fl[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        wacc[(warp * kMaxG + g) * D + lane * EPL + e] = facc[g][e];
    }
  }
  __syncthreads();

  const size_t part = static_cast<size_t>(bk) * nsplit + split;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kMaxG + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(wm[w * kMaxG + g], mm);
      ll += wl[w * kMaxG + g] * f;
      aa += wacc[(w * kMaxG + g) * D + d] * f;
    }
    if (nsplit == 1) {
      finish<T, kPartial>(out, pm, pl, pacc, static_cast<size_t>(bk) * G + g,
                          D, d, mm, ll, aa);
    } else {
      ws_acc[(part * G + g) * D + d] = aa;
      if (d == 0) {
        ws_m[part * G + g] = mm;
        ws_l[part * G + g] = ll;
      }
    }
  }
  if (nsplit == 1) return;

  // the last split of this (b, kv-head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + bk, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t p0 = static_cast<size_t>(bk) * nsplit;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mm = fmaxf(mm, __ldcg(ws_m + (p0 + s) * G + g));
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = rescale(__ldcg(ws_m + (p0 + s) * G + g), mm);
      ll += __ldcg(ws_l + (p0 + s) * G + g) * f;
      aa += __ldcg(ws_acc + ((p0 + s) * G + g) * D + d) * f;
    }
    finish<T, kPartial>(out, pm, pl, pacc, static_cast<size_t>(bk) * G + g,
                        D, d, mm, ll, aa);
  }
  if (tid == 0) tickets[bk] = 0;
}

template <typename T, int D, bool kPartial>
int launch_t(const void* q, const void* k, const void* v, void* out,
             float* part, float* ws, int* tickets, int B, int S, int KV,
             int G, int len, int per_split, int nsplit, cudaStream_t s) {
  constexpr int smem =
      kStages * 2 * Tile<T>::kKeys * D * static_cast<int>(sizeof(T));
  static_assert(smem >= kWarps * kMaxG * (D + 2) * 4, "merge needs the ring");
  auto kernel = decode_split<T, D, kPartial>;
  // set on every launch: the attribute holds for the current device only
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t parts = static_cast<size_t>(B) * KV * nsplit * G;
  float* ws_m = ws;
  float* ws_l = ws + parts;
  float* ws_acc = ws + 2 * parts;
  // the partials (m (B, H), l (B, H), acc (B, H, D)) one after another
  const size_t rows = static_cast<size_t>(B) * KV * G;
  float* pm = part;
  float* pl = part ? part + rows : nullptr;
  float* pacc = part ? part + 2 * rows : nullptr;
  dim3 grid(B * KV, nsplit);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), pm, pl, pacc, ws_m,
      ws_l, ws_acc, tickets, S, KV, G, len, per_split,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPartial>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* part, float* ws, int* tickets, int B, int S, int KV,
             int G, int D, int len, int per_split, int nsplit,
             cudaStream_t s) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_t<T, 64, kPartial>(q, k, v, out, part, ws, tickets, B, S,
                                       KV, G, len, per_split, nsplit, s);
    case 128:
      return launch_t<T, 128, kPartial>(q, k, v, out, part, ws, tickets, B,
                                        S, KV, G, len, per_split, nsplit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kPartial>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, float* ws, int* tickets, int B, int S, int KV, int G,
           int D, int len, int per_split, int nsplit, int dtype,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, kPartial>(q, k, v, out, part, ws, tickets, B, S,
                                     KV, G, D, len, per_split, nsplit, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, kPartial>(q, k, v, out, part, ws, tickets,
                                             B, S, KV, G, D, len, per_split,
                                             nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Device pointers: q and out (B, H, D),
// k and v (B, S, KV, D), contiguous; ws holds B*KV*nsplit*G*(D + 2) f32
// (unused when nsplit is 1); tickets holds B*KV int32 zeros, and the
// kernel leaves them zero.  H = KV * G, D in {64, 128} (the head dims of
// the ported configs), G <= 8; 0 <= len <= S; nsplit * per_split >= len;
// k and v 16-byte aligned, q 4-byte aligned.  Returns cudaGetLastError().
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  void* out, float* ws, int* tickets, int B,
                                  int S, int KV, int G, int D, int len,
                                  int per_split, int nsplit, int dtype,
                                  void* stream) {
  return launch<false>(q, k, v, out, nullptr, ws, tickets, B, S, KV, G, D,
                       len, per_split, nsplit, dtype, stream);
}

// The partials entry: as decode_attn_launch, with part in place of out:
// B*H*(D + 2) f32, m (B, H), then l (B, H), then acc (B, H, D).
extern "C" int decode_attn_partials_launch(
    const void* q, const void* k, const void* v, float* part, float* ws,
    int* tickets, int B, int S, int KV, int G, int D, int len, int per_split,
    int nsplit, int dtype, void* stream) {
  return launch<true>(q, k, v, nullptr, part, ws, tickets, B, S, KV, G, D,
                      len, per_split, nsplit, dtype, stream);
}
