// Chunked Mamba2 SSD (state-space duality) scan for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:
//   ssd_scan (:60, body _kernel :22)
//
// Per (batch b, head h), over chunks of Q steps of x (B, S, H, P) (dt-scaled
// input), a (B, S, H) (log decays, <= 0) and b, c (B, S, N), all f32, with
// A = cumsum of a within the chunk:
//   y[l]   = sum_{s <= l} (c_l . b_s) exp(A_l - A_s) x[s]     (intra-chunk)
//          + exp(A_l) * state c_l                           (carried state)
//   state <- exp(A_last) state + sum_s exp(A_last - A_s) x[s] b_s^T
// y (B, S, H, P) and the final state (B, H, P, N) in f32.  Every decay is
// exp of a difference (or of A itself, <= 0); never exp(A_l) * exp(-A_s),
// which overflows within a chunk when dt * A reaches -10 per step.  A is
// summed and differenced in f64 (then taken to f32 for exp): in f32 it
// reaches |100| within a chunk of 256 at a ~ -0.4 per step, the
// differences of two such sums carry ~1e-5 of relative rounding, and the
// f32 chunked formula (the reference's, and the plain version here) shows
// it as ~1e-3 of error in y against an f64 evaluation, beyond the 2e-4
// the kernel is held to.
//
// Bound: operations.  The function needs the lower triangle of C B^T once
// per (b, chunk), Q(Q + 1) N flops (b and c have no head axis), and per
// (b, h, chunk) the lower triangle of (C B^T * decay) X, Q(Q + 1) P, plus
// 4QNP for the carried state's term and the new state: on Q(P + 1) + QP
// floats moved per (b, h, chunk), hundreds of f32 flops per byte, above
// the card's 67 TFLOP/s (f32, no tensor cores) / 3.35 TB/s ridge of 20
// flops per byte.  This kernel recomputes C B^T for every head.
//
// Design (a first kernel, right and simple).  The TPU grid walks the
// chunks in order and keeps the (P, N) state in a revisited output block.
// Here one block of 256 threads owns one (b, h) and walks its chunks in a
// loop, with the state in shared memory (64 x 128 f32 = 32 KB at full
// width).  A chunk's b, c and x do not fit in shared memory together at
// Q = 256, N = 128, so the chunk is tiled by 64 rows in both l and s: a C
// tile (64 x N), a B tile and an X tile (64 x P) at a time, and the
// (C B^T) * decay tile (64 x 64) goes through shared memory on its way to
// the product with X.  Tiles above the diagonal (s > l) are skipped.  Each
// thread computes a 4 x 4 (or 4 x 8) register tile, rows and columns
// strided by 16 so that shared-memory reads are conflict-free (rows of N
// are padded to N + 1).  b and c are read as (B, S, N) by every head's
// block: nothing is broadcast over heads in memory.  C B^T is the same for
// every head; sharing it is left to the redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;  // rows of an l or s tile
constexpr int kThreads = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kLd = kMaxN + 1;  // padded row of N
constexpr size_t kSmemBytes = sizeof(double) * kMaxQ +      // Ac
                              sizeof(float) * (3 * kT * kLd +  // Cs, Bs, St
                                               2 * kT * kMaxP);  // Xs, Ws

__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm,
    float* __restrict__ y, float* __restrict__ state, int S, int H, int P,
    int N, int Q) {
  extern __shared__ double smd[];
  double* Ac = smd;            // Q: cumulative log decay in the chunk (f64)
  float* Cs = reinterpret_cast<float*>(Ac + kMaxQ);  // kT x kLd: c rows, l tile
  float* Bs = Cs + kT * kLd;   // kT x kLd: b rows of the s tile
  float* St = Bs + kT * kLd;   // kMaxP x kLd: the carried state [p][n]
  float* Xs = St + kT * kLd;   // kT x kMaxP: x rows of the s tile
  float* Ws = Xs + kT * kMaxP; // kT x kT: (C B^T) * decay, [l][s]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ntiles = (Q + kT - 1) / kT;
  const size_t bS = static_cast<size_t>(b) * S;

  for (int i = tid; i < kMaxP * kLd; i += kThreads) St[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // the previous chunk is done with Ac, Bs, Xs and St
    if (tid < 32) {   // inclusive scan of a over the chunk, by one warp, f64
      double run = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int t = base + tid;
        double v = t < Q ? static_cast<double>(a[(bS + t0 + t) * H + h]) : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += run;
        if (t < Q) Ac[t] = v;
        run = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double a_last = Ac[Q - 1];

    for (int lt = 0; lt < ntiles; ++lt) {
      const int l0 = lt * kT;
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N;
        Cs[r * kLd + n] = l0 + r < Q ? cm[(bS + t0 + l0 + r) * N + n] : 0.f;
      }
      __syncthreads();

      // carried state: y[l][p] = exp(A_l) * sum_n c[l][n] St[p][n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[(tx + 16 * j) * kLd + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        const float e = l < Q ? expf(static_cast<float>(Ac[l])) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk: the s tiles at or below the diagonal
      for (int st = 0; st <= lt; ++st) {
        const int s0 = st * kT;
        for (int i = tid; i < kT * N; i += kThreads) {
          const int r = i / N, n = i % N;
          Bs[r * kLd + n] = s0 + r < Q ? bm[(bS + t0 + s0 + r) * N + n] : 0.f;
        }
        for (int i = tid; i < kT * P; i += kThreads) {
          const int r = i / P, p = i % P;
          Xs[r * kMaxP + p] =
              s0 + r < Q ? x[((bS + t0 + s0 + r) * H + h) * P + p] : 0.f;
        }
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * kLd + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * kLd + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool keep = l < Q && s <= l;
            Ws[(ty + 16 * i) * kT + tx + 16 * j] =
                keep ? w[i][j] * expf(static_cast<float>(Ac[l] - Ac[s])) : 0.f;
          }
        }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * kT + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[s * kMaxP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
        }
        __syncthreads();  // before the next B, X (or C) tile is loaded
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        if (l >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y[((bS + t0 + l) * H + h) * P + p] = acc[i][j];
        }
      }
    }

    // state update: St[p][n] = exp(A_last) St[p][n]
    //                          + sum_s exp(A_last - A_s) x[s][p] b[s][n]
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * kT;
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N;
        Bs[r * kLd + n] = s0 + r < Q ? bm[(bS + t0 + s0 + r) * N + n] : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P, p = i % P;
        Xs[r * kMaxP + p] =
            s0 + r < Q ? x[((bS + t0 + s0 + r) * H + h) * P + p] *
                             expf(static_cast<float>(a_last - Ac[s0 + r]))
                       : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < kT; ++s) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[s * kMaxP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[s * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sacc[i][j] += xv[i] * bv[j];
      }
      __syncthreads();
    }
    const float decay = expf(static_cast<float>(a_last));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) St[p * kLd + n] = St[p * kLd + n] * decay + sacc[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    state[(static_cast<size_t>(bh) * P + p) * N + n] = St[p * kLd + n];
  }
}

}  // namespace

// Device pointers, all f32 and contiguous: x and y (B, S, H, P), a (B, S, H),
// b and c (B, S, N), state (B, H, P, N).  P <= 64, N <= 128, Q <= 1024,
// S % Q == 0.  Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const float* x, const float* a, const float* b,
                               const float* c, float* y, float* state, int B,
                               int S, int H, int P, int N, int Q,
                               void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a, b, c, y, state, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}
