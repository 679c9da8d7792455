// Mamba-2 SSD chunked recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (_ssd_kernel /
// ssd_bhtp). Over x [B, H, T, P], a [B, H, T] (log decay, <= 0) and b, c
// [B, T, N] shared across heads (or, in the tensor-core design, [B, T, G, N]
// in G groups, head h reading group h / (H / G)), per (b, h) and chunk of C
// steps, with la the inclusive cumulative sum of a:
//   y     = ((C B^T) o exp(la_t - la_s) o [t >= s]) @ x + exp(la) * (C @ state^T)
//   state = state * exp(la_end) + (x * exp(la_end - la))^T @ B
// The decay exp(la_t - la_s) is computed only for s <= t (its exponent is
// then <= 0, and clamped at 0 besides); the TPU kernel takes exp of the
// whole [C, C] difference and hides the overflow above the diagonal with a
// select, which a mask applied by multiplying would turn into NaN.
//
// Two designs; kernels/ssd.py chooses by a predicate on the inputs
// (tc_eligible): the tensor-core design for f32 with P = N = 64 (every call
// of zamba2), the first design for everything else.
//
// What bounds it: the four products per chunk (C B^T, W @ x, C @ state^T,
// the state update); the operations bound at the model's shapes.
//
// The tensor-core design (namespace tc):
//  - A CTA is one batch row and a group of HG = 2 heads, four warps per
//    head. C B^T is computed once per chunk for the group (the heads share
//    B and C) into shared memory, and each head applies its own decay mask
//    to it as it reads it. With G groups of B and C (the published Zamba2's
//    mamba_ngroups) the pair lies in one group (H / G even; ssd_tc_forward
//    refuses an odd one) and the CTA reads that group's rows.
//  - The chunk axis is a loop inside the CTA, over chunks of L = 32 steps of
//    its own (the function does not depend on the chunk length, so the
//    `chunk` argument selects nothing here; the inter-chunk products cost
//    the same per step at any length, and the short chunk halves the
//    intra-chunk work and the shared memory of the long one). The next
//    chunk's C, B, x and a load by cp.async into a second buffer while this
//    chunk computes; the cumulative sum of a is a warp-wide shuffle scan.
//  - Each warp owns 16 of the head's 64 columns of P: its rows of the [P, N]
//    state stay in registers in f32 for the whole sequence, in the layout
//    in which the state update's mma leaves them and C @ state^T's mma reads
//    them, so the state never goes through shared memory.
//  - The products run on the tensor cores as mma.sync.m16n8k8 in 3xTF32:
//    every f32 operand is split into a TF32 high part and a TF32 remainder,
//    and hi*hi + hi*lo + lo*hi are summed in f32 (a few parts in 10^6 per
//    product; the path is held at 1e-3, and single-pass TF32 is never
//    used); the split and the product are in hopper.cuh.
//  - 79,616 bytes of shared memory and at most 128 registers a thread, so
//    two CTAs fit an SM (ptxas: 128 registers, 28 bytes of spill stores).
//
// The first design (one CTA per (b, h), 256 threads, any P and N that are
// multiples of 4, f32 or bf16 x): the chunk axis a loop inside the CTA with
// the [P, N] f32 state in shared memory (16 KB at P = N = 64), stored
// transposed ([N][P]). C and B are stored transposed ([N][C + 4], t
// contiguous) and the masked weights as W^T ([s][t]), so every product is a
// loop of 4x4 register tiles fed by float4 reads on the CUDA cores. A
// ragged last chunk is zero-padded: a = 0 there keeps la at its last valid
// value, and x = b = 0 adds nothing to the state; the tensor-core design
// pads the same way. See PERF.md for measured times.
//
// C interface (bound with ctypes): ssd_forward (the first design) and
// ssd_tc_forward return cudaGetLastError() after the launch, -1 for a dtype
// there is no instance for, -2 for a shape they do not take. ssd_forward
// takes the chunk length as a runtime argument.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void ld4(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, float a0, float a1, float a2, float a3) {
  *reinterpret_cast<float4*>(p) = make_float4(a0, a1, a2, a3);
}

// Shared-memory layout in floats; CP = C rounded up to 4, CS = CP + 4 (the
// padding spreads the transposed float4 stores over all banks).
struct Layout {
  int CP, CS, P, N;
  __host__ __device__ int x() const { return 0; }                  // [CP][P]
  __host__ __device__ int ct() const { return CP * P; }            // [N][CS]
  __host__ __device__ int bt() const { return ct() + N * CS; }     // [N][CS]
  __host__ __device__ int wt() const { return bt() + N * CS; }     // [CP][CS]
  __host__ __device__ int st() const { return wt() + CP * CS; }    // [N][P]
  __host__ __device__ int la() const { return st() + N * P; }      // [CP]
  __host__ __device__ int total() const { return la() + CP; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ b, const float* __restrict__ c,
           T* __restrict__ y, int H, int T_len, int P, int N, int C) {
  extern __shared__ float smem[];
  const int CP = (C + 3) & ~3;
  const Layout L{CP, CP + 4, P, N};
  const int CS = L.CS;
  float* X = smem + L.x();
  float* CT = smem + L.ct();
  float* BT = smem + L.bt();
  float* WT = smem + L.wt();
  float* ST = smem + L.st();
  float* LA = smem + L.la();

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / H;
  const size_t xbase = (size_t)bh * T_len * P;
  const size_t abase = (size_t)bh * T_len;
  const size_t nbase = (size_t)bi * T_len * N;
  const int nq = CP / 4;          // 4-step groups in a chunk
  const int np = P / 4;
  const int nn = N / 4;
  const int n_tri = nq * (nq + 1) / 2;

  for (int i = tid; i < N * P; i += THREADS) ST[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int nvalid = min(C, T_len - t0);
    __syncthreads();  // the previous chunk is consumed

    for (int i = tid; i < CP * P; i += THREADS) {
      const int t = i / P;
      X[i] = t < nvalid ? to_f32(x[xbase + (size_t)t0 * P + i]) : 0.f;
    }
    // c, b transposed: thread (n, q) gathers steps 4q..4q+3 of column n.
    for (int i = tid; i < nq * N; i += THREADS) {
      const int n = i % N, q = i / N;
      float cv[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * q + j;
        const bool ok = t < nvalid;
        const size_t g = nbase + (size_t)(t0 + t) * N + n;
        cv[j] = ok ? c[g] : 0.f;
        bv[j] = ok ? b[g] : 0.f;
      }
      st4(CT + n * CS + 4 * q, cv[0], cv[1], cv[2], cv[3]);
      st4(BT + n * CS + 4 * q, bv[0], bv[1], bv[2], bv[3]);
    }
    // Inclusive cumulative sum of a over the chunk in the first warp: each
    // lane sums a run of steps, a shuffle scan adds the runs before it.
    if (tid < 32) {
      const int per = (CP + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, CP);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) run += t < nvalid ? a[abase + t0 + t] : 0.f;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = incl - run;
      for (int t = lo; t < hi; ++t) {
        acc += t < nvalid ? a[abase + t0 + t] : 0.f;
        LA[t] = acc;
      }
    }
    __syncthreads();
    const float la_end = LA[CP - 1];

    // W^T[s][t] = (c_t . b_s) exp(la_t - la_s) for s <= t, over the
    // lower-triangular 4x4 tiles (si <= ti); strictly upper pairs are 0.
    for (int i = tid; i < n_tri; i += THREADS) {
      int ti = (int)((sqrtf(8.f * i + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > i) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= i) ++ti;
      const int si = i - ti * (ti + 1) / 2;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cc[4], bb[4];
        ld4(CT + n * CS + 4 * ti, cc);
        ld4(BT + n * CS + 4 * si, bb);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += cc[p] * bb[q];
      }
      float lt[4], ls[4];
      ld4(LA + 4 * ti, lt);
      ld4(LA + 4 * si, ls);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 4 * si + q;
        float w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int t = 4 * ti + p;
          w[p] = s <= t ? acc[p][q] * __expf(fminf(lt[p] - ls[q], 0.f)) : 0.f;
        }
        st4(WT + s * CS + 4 * ti, w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // y = W @ x + exp(la) * (C @ state^T), 4x4 tiles over (t, p).
    for (int i = tid; i < nq * np; i += THREADS) {
      const int ti = i / np, pi = i % np;
      float acc[4][4] = {};
      for (int s = 0; s < 4 * ti + 4; ++s) {
        float ww[4], xx[4];
        ld4(WT + s * CS + 4 * ti, ww);
        ld4(X + s * P + 4 * pi, xx);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += ww[p] * xx[q];
      }
      float inter[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cc[4], ss[4];
        ld4(CT + n * CS + 4 * ti, cc);
        ld4(ST + n * P + 4 * pi, ss);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[p][q] += cc[p] * ss[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int t = 4 * ti + p;
        if (t < nvalid) {
          const float dec = __expf(LA[t]);
          T* o = y + xbase + (size_t)(t0 + t) * P + 4 * pi;
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q] = from_f32<T>(acc[p][q] + dec * inter[p][q]);
        }
      }
    }
    __syncthreads();

    // x <- x * exp(la_end - la), in place.
    for (int i = tid; i < CP * P; i += THREADS) X[i] *= __expf(la_end - LA[i / P]);
    __syncthreads();

    // state^T <- state^T * exp(la_end) + B^T @ x_dec, 4x4 tiles over (n, p);
    // each thread reads and writes only its own tile of the state.
    const float dec_end = __expf(la_end);
    for (int i = tid; i < nn * np; i += THREADS) {
      const int ni = i / np, pi = i % np;
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float ss[4];
        ld4(ST + (4 * ni + p) * P + 4 * pi, ss);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = ss[q] * dec_end;
      }
      for (int s = 0; s < CP; ++s) {
        float bb[4], xx[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) bb[p] = BT[(4 * ni + p) * CS + s];
        ld4(X + s * P + 4 * pi, xx);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += bb[p] * xx[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        st4(ST + (4 * ni + p) * P + 4 * pi, acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* a, const float* b, const float* c, void* y,
           int B, int H, int T_len, int P, int N, int C, cudaStream_t stream) {
  const int CP = (C + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t)Layout{CP, CP + 4, P, N}.total();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), a, b, c, static_cast<T*>(y), H, T_len, P, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core design (P = N = 64, f32): heads share C B^T, the next
// chunk loads while this one computes, 3xTF32 mma.sync for the products.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;   // cp16, cp4, TF, split4, split2, mma3

constexpr int L = 32;            // steps per chunk of the kernel's own loop
constexpr int P = 64, N = 64;    // head size, state size
constexpr int HG = 2;            // heads per CTA: they share C B^T
constexpr int WARPS = 4 * HG;    // four warps per head, 16 columns of P each
constexpr int THREADS = 32 * WARPS;
constexpr int RS = 72;           // row stride (floats) of the C, B and x tiles
constexpr int GS = L + 4;        // row stride of C B^T
// One buffer of a chunk's inputs, in floats: C [L][RS], B [L][RS], x of
// each head [L][RS], a of each head [L].
constexpr int BUF = (2 + HG) * L * RS + HG * L;
constexpr int SMEM_FLOATS = 2 * BUF /* double-buffered */ + L * GS /* C B^T */ +
                            3 * HG * L /* la, exp(la_end - la), exp(la) */;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
constexpr int G_TILES = 6;       // the 16 x 8 tiles of C B^T on or below the diagonal

static_assert(G_TILES <= WARPS - HG, "the scan warps are free of C B^T tiles");

struct Strides {
  long long xb, xh, xt;   // x [B, H, T, P], P contiguous
  long long yb, yh, yt;   // y likewise
  long long ab, ah, at;   // a [B, H, T]
};

// Fragments of mma.m16n8k8 (lane = 4g + t): A a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, col g), b1 (k t + 4, col g);
// D d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1). Where a
// product sums over n, the k slots t and t + 4 carry n = 8i + 2t and
// 8i + 2t + 1 instead: the sum is the same, an operand read from shared
// memory comes as one float2, and the state, held in registers in D's
// layout, is B's fragment as it lies.
__global__ void __launch_bounds__(THREADS, 2)
ssd_tc_kernel(const float* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ y, Strides s, int H, int T, int NG) {
  extern __shared__ __align__(16) float sm[];
  float* G = sm + 2 * BUF;
  float* LA = G + L * GS;        // [HG][L] inclusive cumulative sum of a
  float* DEC = LA + HG * L;      // exp(la_end - la)
  float* EL = DEC + HG * L;      // exp(la)

  const int n_groups = (H + HG - 1) / HG;
  const int bi = blockIdx.x / n_groups, h0 = blockIdx.x % n_groups * HG;
  const int heads = min(HG, H - h0);
  const int grp = h0 / (H / NG);       // the group of B and C both heads read
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int j = warp / 4;              // this warp's head in the group
  const int w = warp % 4;              // ... and its 16 columns of P
  const bool active = j < heads;
  const int n_chunks = (T + L - 1) / L;

  // Chunk ch's C, B, x and a into buffer ch % 2; steps past T and absent
  // heads read zeros.
  auto issue = [&](int ch) {
    float* buf = sm + (ch & 1) * BUF;
    const int t0 = ch * L;
    for (int q = tid; q < 2 * L * 16; q += THREADS) {
      const int which = q / (L * 16), r = q / 16 % L, c4 = q % 16;
      const float* src = which ? bm : cm;
      const bool in = t0 + r < T;
      cp16(buf + which * L * RS + r * RS + 4 * c4,
           in ? src + (((long long)bi * T + t0 + r) * NG + grp) * N + 4 * c4 : src, in);
    }
    for (int q = tid; q < HG * L * 16; q += THREADS) {
      const int jj = q / (L * 16), r = q / 16 % L, c4 = q % 16;
      const bool in = jj < heads && t0 + r < T;
      cp16(buf + (2 + jj) * L * RS + r * RS + 4 * c4,
           in ? x + bi * s.xb + (h0 + jj) * s.xh + (t0 + r) * s.xt + 4 * c4 : x, in);
    }
    for (int q = tid; q < HG * L; q += THREADS) {
      const int jj = q / L, r = q % L;
      const bool in = jj < heads && t0 + r < T;
      cp4(buf + (2 + HG) * L * RS + jj * L + r,
          in ? a + bi * s.ab + (h0 + jj) * s.ah + (t0 + r) * s.at : a, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // This warp's rows of the state, [16 of P] x [N], in D's layout: tile i
  // holds columns 8i .. 8i + 7 of N. f32 throughout.
  float st[N / 8][4];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = 0.f;

  issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L, nvalid = min(L, T - t0);
    if (ch + 1 < n_chunks)
      issue(ch + 1);   // in flight while this chunk computes
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // chunk ch has landed
    __syncthreads();
    const float* buf = sm + (ch & 1) * BUF;
    const float* Cs = buf;
    const float* Bs = buf + L * RS;
    const float* As = buf + (2 + HG) * L * RS;

    // ---- C B^T once for the group's heads: tile (m, jt) is rows 16m ..,
    // columns 8jt .. of G[t][s] = sum_n C[t][n] B[s][n].
    if (warp < G_TILES) {
      const int m = warp < 2 ? 0 : 1, jt = warp < 2 ? warp : warp - 2;
      float d[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < N / 8; ++k) {
        const float2 c0 = *reinterpret_cast<const float2*>(Cs + (16 * m + g) * RS + 8 * k + 2 * t);
        const float2 c1 = *reinterpret_cast<const float2*>(Cs + (16 * m + g + 8) * RS + 8 * k + 2 * t);
        const float2 bb = *reinterpret_cast<const float2*>(Bs + (8 * jt + g) * RS + 8 * k + 2 * t);
        mma3(d, dc, split4(c0.x, c1.x, c0.y, c1.y), split2(bb.x, bb.y));
      }
      *reinterpret_cast<float2*>(G + (16 * m + g) * GS + 8 * jt + 2 * t) =
          make_float2(d[0] + dc[0], d[1] + dc[1]);
      *reinterpret_cast<float2*>(G + (16 * m + g + 8) * GS + 8 * jt + 2 * t) =
          make_float2(d[2] + dc[2], d[3] + dc[3]);
    } else if (warp >= WARPS - HG) {
      // The inclusive cumulative sum of a over the chunk, one warp per head
      // (zeros past T keep la at its last value).
      const int jj = WARPS - 1 - warp;
      const float v = As[jj * L + lane];
      float incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float end = __shfl_sync(0xffffffffu, incl, 31);
      LA[jj * L + lane] = incl;
      DEC[jj * L + lane] = __expf(end - incl);   // exponent <= 0
      EL[jj * L + lane] = __expf(incl);          // exponent <= 0
    }
    __syncthreads();

    if (active) {
      const float* Xs = buf + (2 + j) * L * RS;
      const float* la = LA + j * L;
      const float* el = EL + j * L;
      const float* dec = DEC + j * L;

      // y = exp(la_t) (C @ state^T): rows t in strips m of 16, columns p in
      // tiles q of 8 (p = 16w + 8q ..), summed over n.
      // acc holds the hi*hi terms, accc the corrections (two chains).
      float acc[2][2][4], accc[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][q][e] = accc[m][q][e] = 0.f;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const TF<2> sb0 = split2(st[i][0], st[i][1]), sb1 = split2(st[i][2], st[i][3]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float2 c0 = *reinterpret_cast<const float2*>(Cs + (16 * m + g) * RS + 8 * i + 2 * t);
          const float2 c1 = *reinterpret_cast<const float2*>(Cs + (16 * m + g + 8) * RS + 8 * i + 2 * t);
          const TF<4> af = split4(c0.x, c1.x, c0.y, c1.y);
          mma3(acc[m][0], accc[m][0], af, sb0);
          mma3(acc[m][1], accc[m][1], af, sb1);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float e0 = el[16 * m + g], e1 = el[16 * m + g + 8];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][q][e] *= e < 2 ? e0 : e1;
            accc[m][q][e] *= e < 2 ? e0 : e1;
          }
        }
      }

      // y += W @ x, W[t][s] = G[t][s] exp(la_t - la_s) for s <= t, else 0;
      // the exponent is taken only for s <= t, where it is <= 0 (and clamped
      // at 0 besides), so no overflow reaches a select or a product.
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = 16 * m + g, r1 = r0 + 8;
        const float la0 = la[r0], la1 = la[r1];
#pragma unroll
        for (int kk = 0; kk < 2 * m + 2; ++kk) {
          const int s0 = 8 * kk + t, s1 = s0 + 4;
          const float ls0 = la[s0], ls1 = la[s1];
          const TF<4> af = split4(
              s0 <= r0 ? G[r0 * GS + s0] * __expf(fminf(la0 - ls0, 0.f)) : 0.f,
              s0 <= r1 ? G[r1 * GS + s0] * __expf(fminf(la1 - ls0, 0.f)) : 0.f,
              s1 <= r0 ? G[r0 * GS + s1] * __expf(fminf(la0 - ls1, 0.f)) : 0.f,
              s1 <= r1 ? G[r1 * GS + s1] * __expf(fminf(la1 - ls1, 0.f)) : 0.f);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = 16 * w + 8 * q + g;
            mma3(acc[m][q], accc[m][q], af, split2(Xs[s0 * RS + p], Xs[s1 * RS + p]));
          }
        }
      }

      const int h = h0 + j;
      float* yb = y + bi * s.yb + h * s.yh;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * m + g + 8 * half;
          if (row >= nvalid) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q)
            *reinterpret_cast<float2*>(yb + (t0 + row) * s.yt + 16 * w + 8 * q + 2 * t) =
                make_float2(acc[m][q][2 * half] + accc[m][q][2 * half],
                            acc[m][q][2 * half + 1] + accc[m][q][2 * half + 1]);
        }

      // state <- state exp(la_end) + (x exp(la_end - la))^T @ B: rows p of
      // this warp's 16, columns n in tiles i, summed over the chunk's steps.
      const float eend = el[L - 1];
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] *= eend;
#pragma unroll
      for (int k = 0; k < L / 8; ++k) {
        const int s0 = 8 * k + t, s1 = s0 + 4;
        const float d0 = dec[s0], d1 = dec[s1];
        const int p = 16 * w + g;
        const TF<4> af = split4(Xs[s0 * RS + p] * d0, Xs[s0 * RS + p + 8] * d0,
                                Xs[s1 * RS + p] * d1, Xs[s1 * RS + p + 8] * d1);
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          mma3(st[i], st[i], af, split2(Bs[s0 * RS + 8 * i + g], Bs[s1 * RS + 8 * i + g]));
      }
    }
    __syncthreads();   // this chunk's buffer and C B^T are consumed
  }
}

int launch(const float* x, const float* a, const float* b, const float* c, float* y,
           const long long* strides, int B, int H, int T, int G, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const Strides s{strides[0], strides[1], strides[2], strides[3], strides[4],
                  strides[5], strides[6], strides[7], strides[8]};
  ssd_tc_kernel<<<B * ((H + HG - 1) / HG), THREADS, SMEM_BYTES, stream>>>(x, a, b, c, y,
                                                                         s, H, T, G);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype of x and y: 0 = float32, 1 = bfloat16; a, b and c are float32. All
// tensors contiguous: x/y [B, H, T, P], a [B, H, T], b/c [B, T, N].
extern "C" int ssd_forward(const void* x, const void* a, const void* b,
                           const void* c, void* y, int dtype, int B, int H,
                           int T, int P, int N, int chunk, void* stream) {
  if (P <= 0 || P % 4 != 0 || N <= 0 || N % 4 != 0 || chunk <= 0 || B <= 0 ||
      H <= 0 || T <= 0)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  if (dtype == 0) return launch<float>(x, af, bf, cf, y, B, H, T, P, N, chunk, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, af, bf, cf, y, B, H, T, P, N, chunk, s);
  return -1;
}

// The tensor-core design: x and y f32 with P = 64, a, b, c f32 with N = 64;
// b and c contiguous [B, T, G, N] (G = 1: [B, T, N]), G dividing H and, for
// G > 1, H / G even; strides (in elements) of x (b, h, t), y
// (b, h, t) and a (b, h, t); P contiguous in x and y, their other strides
// multiples of 4 and their bases 16-byte aligned (kernels/ssd.py checks
// this). Returns cudaGetLastError() after the launch, -2 for a shape it
// does not take.
extern "C" int ssd_tc_forward(const void* x, const void* a, const void* b, const void* c,
                              void* y, const long long* strides, int B, int H, int T,
                              int P, int N, int G, void* stream) {
  if (P != tc::P || N != tc::N || B <= 0 || H <= 0 || T <= 0 || G <= 0 || H % G != 0 ||
      (G > 1 && (H / G) % tc::HG != 0))
    return -2;
  return tc::launch(static_cast<const float*>(x), static_cast<const float*>(a),
                    static_cast<const float*>(b), static_cast<const float*>(c),
                    static_cast<float*>(y), strides, B, H, T, G,
                    static_cast<cudaStream_t>(stream));
}
