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
// which overflows within a chunk when dt * A reaches -10 per step, and a
// masked decay (s > l) is selected away, never multiplied by 0.  A is
// summed and differenced in f64 (then taken to f32 for exp): in f32 it
// reaches |100| within a chunk of 256 at a ~ -0.4 per step, and the
// differences of two such sums carry ~1e-5 of relative rounding, ~1e-3 of
// error in y against an f64 evaluation, beyond the 2e-4 the kernel is
// held to.
//
// Bound: operations.  The function needs the lower triangle of C B^T once
// per (b, chunk), Q(Q + 1) N flops (b and c have no head axis), and per
// (b, h, chunk) the lower triangle of (C B^T * decay) X, Q(Q + 1) P, plus
// 4QNP for the carried state's term and the new state: 65 GFLOP at the
// serve shape (B 4, S 4096, H 80, P 64, N 128, Q 256), hundreds of flops
// per byte moved.  f32 accuracy on the tensor cores is 3xTF32: each operand
// is split into a TF32 high part and a TF32 low part and the product is
// hi.hi + hi.lo + lo.hi, summed in f32 (the idea of CUTLASS's
// OpMultiplyAddFastF32), three mma.sync m16n8k8 TF32 per product tile, so
// the floor is 3 x 65 GFLOP over the 495 TFLOP/s TF32 rate.  One TF32
// pass keeps 10 mantissa bits (~5e-4 relative per product), too coarse for
// 2e-4 over N = 128.
//
// Design: the upstream chunked SSD (Dao & Gu 2024, the ssd_* kernels of
// state-spaces/mamba) in five launches, each of which fills the card,
// instead of one block per (b, h) walking its chunks in order:
//   1. ssd_cumsum: A (B, nc, Q, H) in f64, one thread per (b, chunk, h)
//      and eighth of the chunk (two passes: segment sums, then prefixes).
//   2. ssd_cb: C B^T (B, nc, Q, Q) once per (b, chunk), shared by all
//      heads; 64 x 64 tiles at or below the diagonal only.
//   3. ssd_states: per (b, h, chunk) the chunk's own state
//      sum_s exp(A_last - A_s) x_s b_s^T, (B, H, nc, P, N).
//   4. ssd_pass: the short sequential pass over the chunks, one thread per
//      (b, h) and 4 consecutive (p, n), 8 chunks' loads in flight:
//      overwrites each chunk's state with the state entering it and writes
//      the final state.
//   5. ssd_out: per (b, h, chunk, 64-row tile of l) the carried state's
//      term exp(A_l) C state^T and the intra-chunk term
//      (C B^T * exp(A_l - A_s)) X, s-tiles at or below the diagonal.
//      (Double-buffering its tiles was slower on an H100: 74 KB a block
//      left 3 blocks per SM instead of 5.)
// The products run in shared-memory tiles of f32, each warp a 32 x 32
// block of the output as 2 x 4 m16n8k8 tiles; row strides are padded
// (4 or 8 mod 32 words) so that every fragment read is free of bank
// conflicts.  Tiles are staged with cp.async (16-byte copies when every row
// is 16-byte aligned, else 4-byte), so a thread's copies are all in flight
// at once and no register waits on a load; what a tile needs besides a copy
// (the decays of x, C B^T into (C B^T * decay)) is applied in shared memory
// after it lands.  Rows and columns beyond Q, P and N are zero-filled, so
// any P <= 64, N <= 128 and Q <= 1024 work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 64;  // rows of an l or s tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kLdN = kMaxN + 4;  // a row of N, for fragments read along N
constexpr int kLdS = kT + 4;     // a row of an s tile, read along s
constexpr int kLdP = kMaxP + 8;  // a row of P, read across s
constexpr int kLdB = kMaxN + 8;  // a row of N, read across s
constexpr int kSegs = 8;         // segments of a chunk in ssd_cumsum

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V floats global -> shared; the source's first `valid` floats are read,
// the rest of the V written as zeros.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  const int bytes = 4 * valid;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over k < K (a multiple of 8) for the warp's 32 x 32 block at
// rows m0, columns n0, in 3xTF32.  A(m, k) = As[m * SAM + k * SAK],
// B(k, n) = Bs[k * SBK + n * SBN].  acc[i][j] is the m16n8 fragment of
// rows m0 + 16i, columns n0 + 8j.
template <int SAM, int SAK, int SBK, int SBN>
__device__ __forceinline__ void warp_gemm(float (&acc)[2][4][4],
                                          const float* As, const float* Bs,
                                          int m0, int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = As + (m0 + 16 * i + g) * SAM + (k0 + t) * SAK;
      split_tf32(a[0], ah[i][0], al[i][0]);
      split_tf32(a[8 * SAM], ah[i][1], al[i][1]);
      split_tf32(a[4 * SAK], ah[i][2], al[i][2]);
      split_tf32(a[8 * SAM + 4 * SAK], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* b = Bs + (k0 + t) * SBK + (n0 + 8 * j + g) * SBN;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4 * SBK], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(acc[i][j], al[i], bh[j]);
        mma_tf32(acc[i][j], ah[i], bl[j]);
        mma_tf32(acc[i][j], ah[i], bh[j]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Calls f(row, col, value) for each element of the warp's 32 x 32 block.
template <typename F>
__device__ __forceinline__ void for_each(const float (&acc)[2][4][4], int m0,
                                         int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + 16 * i + g + 8 * (e >> 1), n0 + 8 * j + 2 * t + (e & 1),
          acc[i][j][e]);
}

// Stage rows [r0, r0 + rows) x columns [0, cols) of a row-major matrix
// (row stride ld, rlimit rows, climit columns) into dst (row stride lds),
// zero outside the matrix; asynchronous (cp_async_wait_all, then a barrier,
// before use).  V = 4 needs ld, lds and cols to be multiples of 4 and src
// 16-byte aligned.
template <int V>
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      size_t ld, int r0, int rows, int rlimit,
                                      int cols, int climit) {
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, col = (i % per_row) * V;
    const int valid = r0 + r < rlimit ? max(0, min(V, climit - col)) : 0;
    cp_async<V>(dst + r * lds + col,
                valid ? src + (r0 + r) * ld + col : src, valid);
  }
}

// 1. A = cumsum of a over each chunk, f64, (B, nc, Q, H).
// grid (B * nc, ceil(H / 32)), block (32, kSegs).
__global__ void __launch_bounds__(32 * kSegs) ssd_cumsum(
    const float* __restrict__ a, double* __restrict__ acum, int S, int H,
    int Q) {
  __shared__ double tot[kSegs][32];
  const int nc = S / Q;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y * 32 + threadIdx.x, seg = threadIdx.y;
  const int len = (Q + kSegs - 1) / kSegs;
  const int t0 = seg * len, t1 = min(Q, t0 + len);
  const float* src = a + (static_cast<size_t>(b) * S + c * Q) * H + h;
  double* dst = acum + (static_cast<size_t>(b) * nc + c) * Q * H + h;
  double run = 0.0;
  if (h < H)
    for (int t = t0; t < t1; ++t) run += static_cast<double>(src[t * H]);
  tot[seg][threadIdx.x] = run;
  __syncthreads();
  if (h >= H) return;
  run = 0.0;
  for (int j = 0; j < seg; ++j) run += tot[j][threadIdx.x];
  for (int t = t0; t < t1; ++t) {
    run += static_cast<double>(src[t * H]);
    dst[t * H] = run;
  }
}

// 2. CB[b, c, l, s] = c_l . b_s for the 64 x 64 tiles with s-tile <= l-tile.
// grid (B * nc * T (T + 1) / 2) with T = ceil(Q / 64), 128 threads.
constexpr size_t kCbSmem = sizeof(float) * 2 * kT * kLdN;
template <int V>
__global__ void __launch_bounds__(128) ssd_cb(const float* __restrict__ bm,
                                              const float* __restrict__ cm,
                                              float* __restrict__ cb, int S,
                                              int N, int Q) {
  extern __shared__ float sm[];
  float* Cs = sm;              // kT x kLdN: c rows of the l tile
  float* Bs = Cs + kT * kLdN;  // kT x kLdN: b rows of the s tile
  const int nc = S / Q, T = (Q + kT - 1) / kT;
  const int tiles = T * (T + 1) / 2;
  const int bc = blockIdx.x / tiles;
  const int b = bc / nc, c = bc % nc;
  int lt = 0, st = blockIdx.x % tiles;
  while (st > lt) st -= ++lt;  // tile index = lt (lt + 1) / 2 + st
  const int l0 = lt * kT, s0 = st * kT;
  const int npad = (N + 7) & ~7;
  const size_t base = (static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q) * N;
  stage<V>(Cs, kLdN, cm + base, N, l0, kT, Q, npad, N);
  stage<V>(Bs, kLdN, bm + base, N, s0, kT, Q, npad, N);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  float acc[2][4][4];
  zero(acc);
  warp_gemm<kLdN, 1, 1, kLdN>(acc, Cs, Bs, m0, n0, npad);
  float* out = cb + static_cast<size_t>(bc) * Q * Q;
  for_each(acc, m0, n0, [&](int r, int col, float val) {
    if (l0 + r < Q && s0 + col < Q) out[(l0 + r) * Q + s0 + col] = val;
  });
}

// 3. states[b, h, c] = sum_s exp(A_last - A_s) x_s b_s^T, (P, N).
// grid (B * H * nc), 256 threads: 8 warps as 2 (p) x 4 (n).
constexpr size_t kStatesSmem = sizeof(float) * (kT * kLdP + kT * kLdB);  // + Q
template <int V>
__global__ void __launch_bounds__(256) ssd_states(
    const float* __restrict__ x, const float* __restrict__ bm,
    const double* __restrict__ acum, float* __restrict__ states, int S, int H,
    int P, int N, int Q) {
  extern __shared__ float sm[];
  float* Xs = sm;               // kT x kLdP: decayed x rows of the s tile
  float* Bs = Xs + kT * kLdP;   // kT x kLdB: b rows of the s tile
  float* dec = Bs + kT * kLdB;  // Q: exp(A_last - A_s)
  const int nc = S / Q;
  const int bhc = blockIdx.x;
  const int c = bhc % nc, bh = bhc / nc, h = bh % H, b = bh / H;
  const double* A = acum + (static_cast<size_t>(b) * nc + c) * Q * H + h;
  const double a_last = A[static_cast<size_t>(Q - 1) * H];
  for (int t = threadIdx.x; t < Q; t += blockDim.x)
    dec[t] = expf(static_cast<float>(a_last - A[static_cast<size_t>(t) * H]));
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  float acc[2][4][4];
  zero(acc);
  for (int s0 = 0; s0 < Q; s0 += kT) {
    __syncthreads();  // the previous tile is consumed
    stage<V>(Xs, kLdP, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, s0,
             kT, Q, kMaxP, P);
    stage<V>(Bs, kLdB, bm + row0 * N, N, s0, kT, Q, kMaxN, N);
    cp_async_wait_all();
    __syncthreads();  // the tile (and, at s0 = 0, dec) has landed
    for (int i = threadIdx.x; i < kT * kMaxP; i += blockDim.x) {
      const int r = i / kMaxP, s = s0 + r;
      if (s < Q) Xs[r * kLdP + i % kMaxP] *= dec[s];
    }
    __syncthreads();
    warp_gemm<1, kLdP, kLdB, 1>(acc, Xs, Bs, m0, n0, kT);
  }
  float* out = states + static_cast<size_t>(bhc) * P * N;
  for_each(acc, m0, n0, [&](int p, int n, float val) {
    if (p < P && n < N) out[p * N + n] = val;
  });
}

// 4. In place: states[b, h, c] <- the state entering chunk c; final state.
// One thread per (b, h) and V consecutive (p, n) (V divides P N).
template <int V>
__global__ void __launch_bounds__(256) ssd_pass(
    float* __restrict__ states, float* __restrict__ final_state,
    const double* __restrict__ acum, int B, int H, int PN, int nc, int Q) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  constexpr int kBatch = 8;  // chunks whose loads are in flight together
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= static_cast<size_t>(B) * H * PN) return;
  const int bh = static_cast<int>(i / PN), pn = static_cast<int>(i % PN);
  const int b = bh / H, h = bh % H;
  float st[V] = {};
  Vec* p = reinterpret_cast<Vec*>(states + static_cast<size_t>(bh) * nc * PN + pn);
  const size_t stride = PN / V;  // one chunk, in Vec
  const double* a_last = acum + (static_cast<size_t>(b) * nc * Q + Q - 1) * H + h;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    Vec own[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool ok = c0 + j < nc;
      own[j] = ok ? p[(c0 + j) * stride] : Vec{};
      decay[j] = ok ? expf(static_cast<float>(
                          a_last[static_cast<size_t>(c0 + j) * Q * H]))
                    : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j >= nc) break;
      const float* o = reinterpret_cast<const float*>(&own[j]);
      Vec prev;
      float* pv = reinterpret_cast<float*>(&prev);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        pv[e] = st[e];
        st[e] = st[e] * decay[j] + o[e];
      }
      p[(c0 + j) * stride] = prev;
    }
  }
  float* out = final_state + i;
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = st[e];
}

// 5. y for one (b, h, chunk) and 64-row tile of l.
// grid (B * H * nc * T), l-tiles of a chunk adjacent (they share its x and
// state in L2); 128 threads: 4 warps as 2 (l) x 2 (p).  The carried
// state's term runs over N in slices of 64, so that its tiles take the
// space of the intra-chunk term's (36 KB, several blocks per SM).
constexpr size_t kOutSmem = sizeof(float) * kT * (kLdS + kLdP);  // + Q doubles
template <int V>
__global__ void __launch_bounds__(128) ssd_out(
    const float* __restrict__ x, const float* __restrict__ cm,
    const float* __restrict__ cb, const double* __restrict__ acum,
    const float* __restrict__ prev, float* __restrict__ y, int S, int H, int P,
    int N, int Q) {
  extern __shared__ double smd[];
  float* Ws = reinterpret_cast<float*>(smd);  // kT x kLdS: (C B^T * decay), [l][s]
  float* Xs = Ws + kT * kLdS;                 // kT x kLdP: x rows of the s tile
  float* Cs = Ws;                // kT x kLdS: c rows, a slice of N
  float* Ps = Xs;                // kMaxP x kLdS: state[p][n], the same slice
  double* Af = reinterpret_cast<double*>(Xs + kT * kLdP);  // A_t, t < l0 + 64
  const int nc = S / Q, T = (Q + kT - 1) / kT;
  const int bhc = blockIdx.x / T, lt = blockIdx.x % T;
  const int c = bhc % nc, bh = bhc / nc, h = bh % H, b = bh / H;
  const int l0 = lt * kT;
  const int lend = min(Q, l0 + kT);
  const double* A = acum + (static_cast<size_t>(b) * nc + c) * Q * H + h;
  for (int t = threadIdx.x; t < lend; t += blockDim.x)
    Af[t] = A[static_cast<size_t>(t) * H];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  float acc[2][4][4];
  zero(acc);

  if (c > 0) {  // carried state: exp(A_l) sum_n c[l][n] state[p][n]
    const float* crow = cm + row0 * N;
    const float* prow = prev + static_cast<size_t>(bhc) * P * N;
    for (int k0 = 0; k0 < N; k0 += kT) {
      const int nk = min(kT, N - k0), kpad = (nk + 7) & ~7;
      __syncthreads();  // the previous slice is consumed
      stage<V>(Cs, kLdS, crow + k0, N, l0, kT, Q, kpad, nk);
      stage<V>(Ps, kLdS, prow + k0, N, 0, kMaxP, P, kpad, nk);
      cp_async_wait_all();
      __syncthreads();
      warp_gemm<kLdS, 1, 1, kLdS>(acc, Cs, Ps, m0, n0, kpad);
    }
    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int l = l0 + m0 + 16 * i + g + 8 * hf;
        const float e = l < Q ? expf(static_cast<float>(Af[l])) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][2 * hf] *= e;
          acc[i][j][2 * hf + 1] *= e;
        }
      }
  }

  // intra-chunk: the s tiles at or below the diagonal
  const float* cbc = cb + (static_cast<size_t>(b) * nc + c) * Q * Q;
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kT;
    __syncthreads();  // the previous tiles are consumed
    stage<V>(Ws, kLdS, cbc + s0, Q, l0, kT, Q, kT, Q - s0);
    stage<V>(Xs, kLdP, x + (row0 * H + h) * P, static_cast<size_t>(H) * P, s0,
             kT, Q, kMaxP, P);
    cp_async_wait_all();
    __syncthreads();  // the tiles (and Af) have landed
    for (int i = threadIdx.x; i < kT * kT; i += blockDim.x) {
      const int r = i / kT, j = i % kT, l = l0 + r, s = s0 + j;
      float& w = Ws[r * kLdS + j];
      w = l < Q && s <= l ? w * expf(static_cast<float>(Af[l] - Af[s])) : 0.f;
    }
    __syncthreads();
    // on the diagonal tile, rows below 32 see only s < 32
    warp_gemm<kLdS, 1, kLdP, 1>(acc, Ws, Xs, m0, n0,
                                st == lt && m0 == 0 ? kT / 2 : kT);
  }
  for_each(acc, m0, n0, [&](int r, int p, float val) {
    const int l = l0 + r;
    if (l < Q && p < P) y[((row0 + l) * H + h) * P + p] = val;
  });
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int V>
int launch(const float* x, const float* a, const float* b, const float* c,
           float* y, float* state, double* acum, float* cb, float* states,
           int B, int S, int H, int P, int N, int Q, cudaStream_t s) {
  // set on every launch: the attributes hold for the current device only
  cudaError_t e = set_smem(reinterpret_cast<const void*>(ssd_cb<V>), kCbSmem);
  if (e == cudaSuccess)
    e = set_smem(reinterpret_cast<const void*>(ssd_states<V>),
                 kStatesSmem + sizeof(float) * kMaxQ);
  if (e == cudaSuccess)
    e = set_smem(reinterpret_cast<const void*>(ssd_out<V>),
                 kOutSmem + sizeof(double) * kMaxQ);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = S / Q, T = (Q + kT - 1) / kT;
  ssd_cumsum<<<dim3(B * nc, (H + 31) / 32), dim3(32, kSegs), 0, s>>>(a, acum,
                                                                      S, H, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_cb<V><<<B * nc * T * (T + 1) / 2, 128, kCbSmem, s>>>(b, c, cb, S, N, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_states<V><<<B * H * nc, 256, kStatesSmem + sizeof(float) * Q, s>>>(
      x, b, acum, states, S, H, P, N, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t threads = static_cast<size_t>(B) * H * P * N / V;
  ssd_pass<V><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      states, state, acum, B, H, P * N, nc, Q);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_out<V><<<B * H * nc * T, 128, kOutSmem + sizeof(double) * Q, s>>>(
      x, c, cb, acum, states, y, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers, all contiguous: x and y (B, S, H, P), a (B, S, H), b and
// c (B, S, N), state (B, H, P, N), f32; scratch acum (B, S / Q, Q, H) f64,
// cb (B, S / Q, Q, Q) f32 and states (B, H, S / Q, P, N) f32, which on
// return holds the state entering each chunk.  P <= 64, N <= 128,
// Q <= 1024, S % Q == 0.  Five launches on the stream; returns the first
// error of cudaGetLastError().
extern "C" int ssd_scan_launch(const float* x, const float* a, const float* b,
                               const float* c, float* y, float* state,
                               double* acum, float* cb, float* states, int B,
                               int S, int H, int P, int N, int Q,
                               void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every staged row 16-byte aligned
  const bool vec = P % 4 == 0 && N % 4 == 0 && Q % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  return vec ? launch<4>(x, a, b, c, y, state, acum, cb, states, B, S, H, P, N, Q, s)
             : launch<1>(x, a, b, c, y, state, acum, cb, states, B, S, H, P, N, Q, s);
}
