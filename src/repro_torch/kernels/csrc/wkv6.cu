// RWKV-6 WKV chunked recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:21 (_wkv_kernel /
// wkv6_bhtk). Over [B, H, T, K] tensors, per (b, h) and chunk of C steps,
// with la the inclusive cumulative log decay and la_prev = la - lw:
//   scores[t][s] = sum_c r[t][c] k[s][c] exp(la_prev[t][c] - la[s][c])
//                  for s < t, plus the bonus sum_c r[t][c] u[c] k[t][c] at s == t
//   out          = scores @ v + (r * exp(la_prev)) @ state
//   state        = state * exp(la_end) + (k * exp(la_end - la))^T @ v
// Since lw <= 0, la falls step by step, so la_prev[t] <= la[s] for s < t:
// every exponent the function needs is <= 0. Factoring it naively into
// exp(la_prev) * exp(-la) is not safe: with strong decays exp(-la)
// overflows f32 within one chunk.
//
// What bounds it: operations. At rwkv6's shapes the chunked algorithm does
// about 1.9 GFLOP of f32 work (0.10 G exponentials) on 38 MB at the served
// [8, 32, 192, 64]; see PERF.md for measured times against the bounds.
//
// Two designs; kernels/wkv6.py chooses by a predicate on the inputs
// (tc_eligible): the tensor-core design for K = 64 (every call of rwkv6),
// the first design for every other K.
//
// The tensor-core design (namespace tc), per (b, h), chunks of L = 32 steps
// of its own (the function does not depend on the chunk length), each cut
// into two sub-chunks of 16:
//  - The decays between sub-chunks are factored safely: for t in the second
//    sub-chunk and s in the first, with g = la at the last step before the
//    second sub-chunk, la_prev_t - la_s = (la_prev_t - g) + (g - la_s), and
//    both terms are <= 0, because la falls. So the block is the plain
//    product (r exp(la_prev - g)) (k exp(g - la))^T: nothing overflows, and
//    an underflow drops only terms below f32's least normal.
//  - Inside a sub-chunk (the two diagonal 16 x 16 blocks) the decay of a
//    pair is the product of the step decays exp(lw) <= 1 between them, built
//    as a running product while s walks down from t - 1: one exponential a
//    (step, channel) instead of one a (t, s, channel) (the first design
//    takes 129,024 a 64-step chunk), and still no exponent above 0. Warps 0-3
//    walk the diagonal blocks while warps 4-7 build the other operands.
//  - Every product (the factored block, scores @ v, (r exp(la_prev)) @ state
//    and the state update) runs on the tensor cores as mma.sync.m16n8k8 in
//    3xTF32 (hopper.cuh): operands split into a TF32 high part and remainder
//    by masking bits, f32 sums, never single-pass TF32.
//  - The [K, K] state stays in f32 registers for the whole sequence, held
//    transposed in the layout the update's mma leaves it and the output's
//    mma reads it; eight warps each hold a 16 x 32 block of it.
//  - The next chunk's r, k, v and lw load by cp.async into a second buffer
//    while this one computes, straight from the caller's strides (the
//    model's [B, T, H, K] as ops.wkv6 hands it over), and the output is
//    written in the caller's layout: no copies. bf16 is converted to f32 as
//    it is read from shared memory; the math is f32, as the TPU kernel's.
//  - The cumulative decay: each lane sums 8 steps of a channel, and a
//    shuffle scan over a channel's 4 lanes adds the earlier blocks.
//  - 115,456 bytes of shared memory (f32) and at most 128 registers a
//    thread, so two CTAs of 256 threads fit an SM.
//
// The first design (one CTA per (b, h), 256 threads, K a multiple of
// 4, f32 on the CUDA cores): the chunk axis a loop inside the CTA with the
// [K, K] f32 state in shared memory (16 KB at K = 64). Each chunk's r and k
// are stored transposed ([K][C + 4], t contiguous) so a thread reads four t
// (or s) values as one float4; every product is a loop of 4x4 register
// tiles. The pairwise exponent is built per (t, s, c) and clamped at 0.
//
// Both pad a ragged last chunk with zeros: lw = 0 keeps la at its last valid
// value, and k = 0 adds nothing to the state.
//
// C interface (bound with ctypes): wkv6_forward (the first design) and
// wkv6_tc_forward return cudaGetLastError() after the launch, -1 for a
// dtype there is no instance for, -2 for a shape they do not take.
// wkv6_forward takes the chunk length as a runtime argument.

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
  int CP, CS, K;
  __host__ __device__ int r() const { return 0; }                  // [K][CS]
  __host__ __device__ int k() const { return K * CS; }             // [K][CS]
  __host__ __device__ int la() const { return 2 * K * CS; }        // [K][CS]
  __host__ __device__ int v() const { return 3 * K * CS; }         // [CP][K]
  __host__ __device__ int pt() const { return v() + CP * K; }      // [CP][CS]
  __host__ __device__ int st() const { return pt() + CP * CS; }    // [K][K]
  __host__ __device__ int dg() const { return st() + K * K; }      // [CP]
  __host__ __device__ int le() const { return dg() + CP; }         // [K]
  __host__ __device__ int total() const { return le() + K; }
};

// la_prev of the four steps 4q..4q+3 of channel c: the inclusive sum one
// step back (0 before the chunk's first step).
__device__ __forceinline__ void la_prev4(const float* LA, int row, int q, float (&p)[4]) {
  float a[4];
  ld4(LA + row + 4 * q, a);
  p[0] = q == 0 ? 0.f : LA[row + 4 * q - 1];
  p[1] = a[0]; p[2] = a[1]; p[3] = a[2];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, T* __restrict__ out,
            int H, int T_len, int K, int C) {
  extern __shared__ float smem[];
  const int CP = (C + 3) & ~3;
  const Layout L{CP, CP + 4, K};
  const int CS = L.CS;
  float* R = smem + L.r();
  float* Kf = smem + L.k();
  float* LA = smem + L.la();
  float* V = smem + L.v();
  float* PT = smem + L.pt();
  float* S = smem + L.st();
  float* DG = smem + L.dg();
  float* LE = smem + L.le();

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = (size_t)bh * T_len * K;
  const float* ub = u + (size_t)h * K;
  const int nq = CP / 4;          // 4-step groups in a chunk
  const int nk = K / 4;           // 4-channel groups
  const int n_tri = nq * (nq + 1) / 2;

  for (int i = tid; i < K * K; i += THREADS) S[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int nvalid = min(C, T_len - t0);
    __syncthreads();  // the previous chunk is consumed

    // r, k transposed: thread (c, q) gathers steps 4q..4q+3 of channel c.
    for (int i = tid; i < nq * K; i += THREADS) {
      const int c = i % K, q = i / K;
      float rv[4], kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * q + j;
        const bool ok = t < nvalid;
        const size_t g = base + (size_t)(t0 + t) * K + c;
        rv[j] = ok ? to_f32(r[g]) : 0.f;
        kv[j] = ok ? to_f32(k[g]) : 0.f;
      }
      st4(R + c * CS + 4 * q, rv[0], rv[1], rv[2], rv[3]);
      st4(Kf + c * CS + 4 * q, kv[0], kv[1], kv[2], kv[3]);
    }
    for (int i = tid; i < CP * K; i += THREADS) {
      const int t = i / K;
      V[i] = t < nvalid ? to_f32(v[base + (size_t)t0 * K + i]) : 0.f;
    }
    // Inclusive cumulative log decay per channel, sequential in t as the
    // reference's cumsum; padded steps add 0.
    for (int c = tid; c < K; c += THREADS) {
      float acc = 0.f;
      for (int q = 0; q < nq; ++q) {
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * q + j;
          acc += t < nvalid ? logw[base + (size_t)(t0 + t) * K + c] : 0.f;
          a[j] = acc;
        }
        st4(LA + c * CS + 4 * q, a[0], a[1], a[2], a[3]);
      }
      LE[c] = acc;
    }
    __syncthreads();

    // Diagonal bonus r . u . k at s == t.
    for (int t = tid; t < CP; t += THREADS) {
      float d = 0.f;
      for (int c = 0; c < K; ++c) d += R[c * CS + t] * __ldg(ub + c) * Kf[c * CS + t];
      DG[t] = d;
    }

    // Scores of the lower-triangular 4x4 tiles (si <= ti), stored
    // transposed: PT[s][t]. Strictly upper pairs of a diagonal tile are 0.
    for (int i = tid; i < n_tri; i += THREADS) {
      int ti = (int)((sqrtf(8.f * i + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > i) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= i) ++ti;
      const int si = i - ti * (ti + 1) / 2;
      float acc[4][4] = {};
      for (int c = 0; c < K; ++c) {
        const int row = c * CS;
        float rr[4], pp[4], kk[4], aa[4];
        ld4(R + row + 4 * ti, rr);
        la_prev4(LA, row, ti, pp);
        ld4(Kf + row + 4 * si, kk);
        ld4(LA + row + 4 * si, aa);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] += rr[a] * kk[b] * __expf(fminf(pp[a] - aa[b], 0.f));
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = 4 * si + b;
        float o[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = 4 * ti + a;
          o[a] = s < t ? acc[a][b] : 0.f;
        }
        st4(PT + s * CS + 4 * ti, o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();
    for (int t = tid; t < CP; t += THREADS) PT[t * CS + t] = DG[t];

    // r <- r * exp(la_prev), k <- k * exp(la_end - la), in place.
    for (int i = tid; i < K * nq; i += THREADS) {
      const int c = i / nq, q = i % nq, row = c * CS;
      float rr[4], pp[4], kk[4], aa[4];
      ld4(R + row + 4 * q, rr);
      la_prev4(LA, row, q, pp);
      ld4(Kf + row + 4 * q, kk);
      ld4(LA + row + 4 * q, aa);
      const float le = LE[c];
      st4(R + row + 4 * q, rr[0] * __expf(pp[0]), rr[1] * __expf(pp[1]),
          rr[2] * __expf(pp[2]), rr[3] * __expf(pp[3]));
      st4(Kf + row + 4 * q, kk[0] * __expf(le - aa[0]), kk[1] * __expf(le - aa[1]),
          kk[2] * __expf(le - aa[2]), kk[3] * __expf(le - aa[3]));
    }
    __syncthreads();

    // out = scores @ v + r_dec @ state, 4x4 tiles over (t, j).
    for (int i = tid; i < nq * nk; i += THREADS) {
      const int ti = i / nk, jj = i % nk;
      float acc[4][4] = {};
      for (int s = 0; s < 4 * ti + 4; ++s) {
        float pp[4], vv[4];
        ld4(PT + s * CS + 4 * ti, pp);
        ld4(V + s * K + 4 * jj, vv);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += pp[a] * vv[b];
      }
      for (int c = 0; c < K; ++c) {
        float rr[4], ss[4];
        ld4(R + c * CS + 4 * ti, rr);
        ld4(S + c * K + 4 * jj, ss);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += rr[a] * ss[b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = 4 * ti + a;
        if (t < nvalid) {
          T* o = out + base + (size_t)(t0 + t) * K + 4 * jj;
#pragma unroll
          for (int b = 0; b < 4; ++b) o[b] = from_f32<T>(acc[a][b]);
        }
      }
    }
    __syncthreads();

    // state <- state * exp(la_end) + k_fut^T @ v, 4x4 tiles over (c, j);
    // each thread reads and writes only its own tile of the state.
    for (int i = tid; i < nk * nk; i += THREADS) {
      const int ci = i / nk, jj = i % nk;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float ss[4];
        ld4(S + (4 * ci + a) * K + 4 * jj, ss);
        const float dec = __expf(LE[4 * ci + a]);
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = ss[b] * dec;
      }
      for (int s = 0; s < CP; ++s) {
        float kk[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) kk[a] = Kf[(4 * ci + a) * CS + s];
        ld4(V + s * K + 4 * jj, vv);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += kk[a] * vv[b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        st4(S + (4 * ci + a) * K + 4 * jj, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, void* out, int B, int H, int T_len, int K, int C,
           cudaStream_t stream) {
  const int CP = (C + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t)Layout{CP, CP + 4, K}.total();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      logw, u, static_cast<T*>(out), H, T_len, K, C);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core design (K = 64, f32 or bf16): sub-chunk decay factoring,
// 3xTF32 mma.sync for every product, the state in registers, the next
// chunk loaded by cp.async while this one computes, the caller's layout.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;   // cp16, cp_async_*, TF, split4, split2, mma3

constexpr int L = 32;            // steps per chunk of the kernel's own loop
constexpr int SUB = 16;          // steps per sub-chunk: two per chunk
constexpr int K = 64;            // head size: channels of r, k and v
constexpr int WARPS = 8;         // each owns 16 of the 64 value columns and half of the state's rows
constexpr int THREADS = 32 * WARPS;
constexpr int RS = 72;           // row stride (elements) of every [step][channel] tile
constexpr int PS = L + 4;        // row stride of the scores P
static_assert(L == 2 * SUB, "one off-diagonal block per chunk");
static_assert(WARPS == 8 && K == 64 && L == 32, "the warps' shares of the state and output");
static_assert(4 * 2 * 2 * 4 * 32 <= 2 * SUB * RS, "RED fits where RQ and KQ were");

// One buffer of a chunk's inputs, in bytes: r, k, v [L][RS] of type T and
// lw [L][RS] f32 (the cumulative sum la is scanned into it in place).
template <typename T>
constexpr int kBufBytes = 3 * L * RS * (int)sizeof(T) + L * RS * 4;
// The f32 operands built from a chunk: RD [L][RS], KD [L][RS], RQ [SUB][RS],
// KQ [SUB][RS], W [L][RS], P [L][PS], EE [K].
constexpr int WORK_FLOATS = 3 * L * RS + 2 * SUB * RS + L * PS + K;
template <typename T>
constexpr size_t smem_bytes() { return 2 * (size_t)kBufBytes<T> + 4 * (size_t)WORK_FLOATS; }

struct Strides {   // in elements, of dims (b, h, t); channels contiguous
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt, ob, oh, ot;
};

// Eight channels from shared memory, 16-byte aligned, as f32.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Per (b, h), over chunks of L steps with la the inclusive cumulative sum of
// lw from the chunk's start, la_prev = la - lw, g = la[SUB - 1] (the last
// step before the second sub-chunk) and la_end = la[L - 1]:
//   P[t][s] = sum_c r_t k_s exp(la_prev_t - la_s), s < t in one sub-chunk
//   P[t][t] = sum_c r_t u k_t
//   P[t][s] = sum_c (r_t exp(la_prev_t - g)) (k_s exp(g - la_s)), t in the
//             second sub-chunk, s in the first
//   out     = P @ v + (r exp(la_prev)) @ state
//   state   = state exp(la_end) + (k exp(la_end - la))^T @ v
// Fragments of mma.m16n8k8 as in hopper.cuh (lane = 4g + t). The state is
// held transposed, S^T [j][c]: warp w owns rows j = 16 (w % 4) .. + 15 and
// the half of the columns c = 32 (w / 4) .. + 31, in D's layout (tile i
// holds c = 32 (w / 4) + 8i .. + 7). Where a product sums over c, the k
// slots t and t + 4 carry c = 8i + 2t and 8i + 2t + 1: the sum is the same,
// an operand read from shared memory comes as one float2, and S^T in D's
// layout is B's fragment as it lies. The two warps of a column block each
// sum half of the output's products; the second hands its half to the
// first through shared memory (RED), which stores the sum.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_tc_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, T* __restrict__ out, Strides s,
               int H, int T_len) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int BUF = kBufBytes<T>;
  float* RD = reinterpret_cast<float*>(sm + 2 * BUF);   // r exp(la_prev)
  float* KD = RD + L * RS;                               // k exp(la_end - la)
  float* RQ = KD + L * RS;                               // second sub-chunk's r exp(la_prev - g)
  float* KQ = RQ + SUB * RS;                             // first sub-chunk's k exp(g - la)
  float* W = KQ + SUB * RS;                              // exp(lw), the step decays
  float* P = W + L * RS;
  float* EE = P + L * PS;                                // exp(la_end)
  float* RED = RQ;   // [4][2][2][4][32] partial outputs, once RQ and KQ are consumed

  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int jt = warp % 4, chh = warp / 4;   // this warp's 16 value columns, half of c
  const int n_chunks = (T_len + L - 1) / L;
  const T* rs = r + bi * s.rb + h * s.rh;
  const T* ks = k + bi * s.kb + h * s.kh;
  const T* vs = v + bi * s.vb + h * s.vh;
  const float* ws = lw + bi * s.wb + h * s.wh;
  T* os = out + bi * s.ob + h * s.oh;

  // Chunk ch's r, k, v and lw into buffer ch % 2; steps past T read zeros
  // (lw = 0 keeps la at its last valid value, k = 0 adds nothing).
  auto issue = [&](int ch) {
    unsigned char* buf = sm + (ch & 1) * BUF;
    const int t0 = ch * L;
    constexpr int SEG = K * (int)sizeof(T) / 16;   // 16-byte pieces of a row
    for (int q = tid; q < 3 * L * SEG; q += THREADS) {
      const int which = q / (L * SEG), row = q / SEG % L, sg = q % SEG;
      const T* src = which == 0 ? rs + (t0 + row) * s.rt
                   : which == 1 ? ks + (t0 + row) * s.kt : vs + (t0 + row) * s.vt;
      const bool in = t0 + row < T_len;
      cp16(buf + (which * L + row) * RS * (int)sizeof(T) + 16 * sg,
           in ? reinterpret_cast<const unsigned char*>(src) + 16 * sg
              : reinterpret_cast<const unsigned char*>(r), in);
    }
    for (int q = tid; q < L * 16; q += THREADS) {
      const int row = q / 16, sg = q % 16;
      const bool in = t0 + row < T_len;
      cp16(buf + 3 * L * RS * (int)sizeof(T) + row * RS * 4 + 16 * sg,
           in ? ws + (t0 + row) * s.wt + 4 * sg : lw, in);
    }
    cp_async_commit();
  };

  // This warp's block of S^T, f32 for the whole sequence.
  float st[K / 16][4];
#pragma unroll
  for (int i = 0; i < K / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = 0.f;

  // The diagonal blocks, on warps 0-3: thread (sub-chunk, pair of rows,
  // group of 8 channels); rows pr and SUB - 1 - pr of the sub-chunk, so
  // every thread walks 17 (t, s) pairs, and 8 lanes sum each pair's
  // channels. Warps 4-7 meanwhile build the f32 operands.
  const int dsub = tid / 64, dpr = tid % 64 / 8, dcg = tid % 8;
  float uu[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) uu[e] = u[h * K + 8 * dcg + e];

  issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L, nvalid = min(L, T_len - t0);
    if (ch + 1 < n_chunks)
      issue(ch + 1);   // in flight while this chunk computes
    else
      cp_async_commit();
    cp_async_wait<1>();   // chunk ch has landed
    __syncthreads();
    unsigned char* buf = sm + (ch & 1) * BUF;
    const T* Rs = reinterpret_cast<const T*>(buf);
    const T* Ks = Rs + L * RS;
    const T* Vs = Ks + L * RS;
    float* LA = reinterpret_cast<float*>(buf + 3 * L * RS * sizeof(T));

    // ---- la, the inclusive sum of lw over the chunk, in place of lw, and
    // W = exp(lw). Lane 4cc + q of warp w sums steps 8q .. 8q + 7 of channel
    // 8w + cc; a shuffle scan over the four lanes of a channel adds the
    // blocks before its own. (One step a lane hit 8-way bank conflicts.)
    {
      const int c = K / WARPS * warp + lane / 4, q0 = L / 4 * (lane % 4);
      float run[L / 4], acc = 0.f;
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const float x = LA[(q0 + q) * RS + c];
        W[(q0 + q) * RS + c] = __expf(x);   // lw <= 0
        acc += x;
        run[q] = acc;
      }
      float incl = acc;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off, 4);
        if (lane % 4 >= off) incl += o;
      }
      const float before = incl - acc;
#pragma unroll
      for (int q = 0; q < L / 4; ++q) LA[(q0 + q) * RS + c] = run[q] + before;
      if (lane % 4 == 3) EE[c] = __expf(incl);   // exponent <= 0
    }
    __syncthreads();

    if (warp >= 4) {
      // ---- the f32 operands; every exponent is <= 0.
#pragma unroll 4
      for (int i = tid - THREADS / 2; i < L * K; i += THREADS / 2) {
        const int tt = i / K, c = i % K;
        const float la = LA[tt * RS + c];
        const float lp = tt ? LA[(tt - 1) * RS + c] : 0.f;
        const float rv = to_f32(Rs[tt * RS + c]), kv = to_f32(Ks[tt * RS + c]);
        const float gc = LA[(SUB - 1) * RS + c], le = LA[(L - 1) * RS + c];
        RD[tt * RS + c] = rv * __expf(lp);
        KD[tt * RS + c] = kv * __expf(fminf(le - la, 0.f));
        if (tt >= SUB)
          RQ[(tt - SUB) * RS + c] = rv * __expf(fminf(lp - gc, 0.f));
        else
          KQ[tt * RS + c] = kv * __expf(fminf(gc - la, 0.f));
      }
    } else {
      // ---- the diagonal blocks. For s < t in one sub-chunk the decay
      // exp(la_prev_t - la_s) is the product of the step decays
      // w = exp(lw) <= 1 of the steps s + 1 .. t - 1, so walking s down
      // from t - 1 multiplies it by w_s a step: no exponential, no
      // overflow, and at most SUB - 2 roundings. At s == t, the bonus.
      const int base = SUB * dsub, c0 = 8 * dcg;
      const int ta = base + dpr, tb = base + SUB - 1 - dpr;
      float dec[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) dec[e] = 1.f;
      // Branch-free, so that the unrolled steps overlap: rows switch from
      // ta to tb at n = dpr + 1; j counts down from the row's diagonal.
#pragma unroll
      for (int n = 0; n <= SUB; ++n) {
        const bool first = n <= dpr;
        const int tt = first ? ta : tb;
        const int j = first ? n : n - dpr - 1;   // 0: the bonus at s = t
        const int ss = tt - j;
        float rr[8], kk[8], ww[8];
        load8(Rs + tt * RS + c0, rr);
        load8(Ks + ss * RS + c0, kk);
        load8(W + ss * RS + c0, ww);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum += rr[e] * kk[e] * (j == 0 ? uu[e] : dec[e]);
          dec[e] = j == 0 ? 1.f : dec[e] * ww[e];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (dcg == 0) P[tt * PS + ss] = sum;
      }
    }
    __syncthreads();

    // ---- the off-diagonal block P[SUB + ..][0 .. SUB - 1] = RQ KQ^T: warp
    // 0 columns 0 .. 7, warp 1 columns 8 .. 15.
    if (warp < 2) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K / 8; ++i) {
        const float2 a0 = *reinterpret_cast<const float2*>(RQ + g * RS + 8 * i + 2 * t);
        const float2 a1 = *reinterpret_cast<const float2*>(RQ + (g + 8) * RS + 8 * i + 2 * t);
        const float2 bb = *reinterpret_cast<const float2*>(KQ + (8 * warp + g) * RS + 8 * i + 2 * t);
        mma3(d, dc, split4(a0.x, a1.x, a0.y, a1.y), split2(bb.x, bb.y));
      }
      store2(P + (SUB + g) * PS + 8 * warp + 2 * t, d[0] + dc[0], d[1] + dc[1]);
      store2(P + (SUB + g + 8) * PS + 8 * warp + 2 * t, d[2] + dc[2], d[3] + dc[3]);
    }

    // ---- out = (r exp(la_prev)) @ state, this warp's half of c: rows in
    // strips m of 16, columns j = 16 jt + 8q .. acc holds the hi*hi terms,
    // accc the corrections (two chains).
    float acc[2][2][4], accc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = accc[m][q][e] = 0.f;
#pragma unroll
    for (int i = 0; i < K / 16; ++i) {
      const int c = 32 * chh + 8 * i + 2 * t;
      const TF<2> sb0 = split2(st[i][0], st[i][1]), sb1 = split2(st[i][2], st[i][3]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 a0 = *reinterpret_cast<const float2*>(RD + (16 * m + g) * RS + c);
        const float2 a1 = *reinterpret_cast<const float2*>(RD + (16 * m + g + 8) * RS + c);
        const TF<4> af = split4(a0.x, a1.x, a0.y, a1.y);
        mma3(acc[m][0], accc[m][0], af, sb0);
        mma3(acc[m][1], accc[m][1], af, sb1);
      }
    }
    __syncthreads();   // P is complete; RQ and KQ are consumed

    // ---- out += P @ v over s <= t (lower block-triangular); the two warps
    // of a column block take alternate steps of 8 over s.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r0 = 16 * m + g, r1 = r0 + 8;
#pragma unroll
      for (int kk = chh; kk < 2 * m + 2; kk += 2) {
        const int s0 = 8 * kk + t, s1 = s0 + 4;
        const TF<4> af = split4(s0 <= r0 ? P[r0 * PS + s0] : 0.f, s0 <= r1 ? P[r1 * PS + s0] : 0.f,
                                s1 <= r0 ? P[r0 * PS + s1] : 0.f, s1 <= r1 ? P[r1 * PS + s1] : 0.f);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = 16 * jt + 8 * q + g;
          mma3(acc[m][q], accc[m][q], af, split2(to_f32(Vs[s0 * RS + j]), to_f32(Vs[s1 * RS + j])));
        }
      }
    }
    if (chh == 1) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            RED[(((jt * 2 + m) * 2 + q) * 4 + e) * 32 + lane] = acc[m][q][e] + accc[m][q][e];
    }

    // ---- S^T <- S^T exp(la_end) + v^T @ (k exp(la_end - la)): rows j of
    // this warp's 16, columns c of its half in tiles i, summed over the
    // chunk's steps.
#pragma unroll
    for (int i = 0; i < K / 16; ++i) {
      const int c = 32 * chh + 8 * i + 2 * t;
      const float e0 = EE[c], e1 = EE[c + 1];
      st[i][0] *= e0; st[i][1] *= e1; st[i][2] *= e0; st[i][3] *= e1;
    }
#pragma unroll
    for (int kk = 0; kk < L / 8; ++kk) {
      const int s0 = 8 * kk + t, s1 = s0 + 4, j = 16 * jt + g;
      const TF<4> af = split4(to_f32(Vs[s0 * RS + j]), to_f32(Vs[s0 * RS + j + 8]),
                              to_f32(Vs[s1 * RS + j]), to_f32(Vs[s1 * RS + j + 8]));
#pragma unroll
      for (int i = 0; i < K / 16; ++i) {
        const int c = 32 * chh + 8 * i + g;
        mma3(st[i], st[i], af, split2(KD[s0 * RS + c], KD[s1 * RS + c]));
      }
    }
    __syncthreads();   // this chunk's buffer and operands are consumed; RED is written

    if (chh == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * m + g + 8 * half;
          if (row >= nvalid) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* red = RED + ((jt * 2 + m) * 2 + q) * 4 * 32 + lane;
            store2(os + (t0 + row) * s.ot + 16 * jt + 8 * q + 2 * t,
                   acc[m][q][2 * half] + accc[m][q][2 * half] + red[2 * half * 32],
                   acc[m][q][2 * half + 1] + accc[m][q][2 * half + 1] + red[(2 * half + 1) * 32]);
          }
        }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw, const float* u,
           void* out, const long long* st, int B, int H, int T_len, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const Strides s{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14]};
  wkv6_tc_kernel<T><<<B * H, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), lw, u,
      static_cast<T*>(out), s, H, T_len);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype of r, k, v and out: 0 = float32, 1 = bfloat16; logw and u are
// float32. All tensors contiguous: r/k/v/logw/out [B, H, T, K], u [H, K].
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* logw, const void* u, void* out,
                            int dtype, int B, int H, int T, int K, int chunk,
                            void* stream) {
  if (K <= 0 || K % 4 != 0 || chunk <= 0 || B <= 0 || H <= 0 || T <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  if (dtype == 0) return launch<float>(r, k, v, lw, uu, out, B, H, T, K, chunk, s);
  if (dtype == 1) return launch<__nv_bfloat16>(r, k, v, lw, uu, out, B, H, T, K, chunk, s);
  return -1;
}

// The tensor-core design: K = 64; dtype of r, k, v and out: 0 = float32,
// 1 = bfloat16; logw and u float32, u [H, K] contiguous. strides: (b, h, t)
// in elements of r, k, v, logw and out, in that order; channels contiguous,
// the other strides multiples of 16 bytes, bases 16-byte aligned
// (kernels/wkv6.py checks this). Returns cudaGetLastError() after the
// launch, -1 for a dtype there is no instance for, -2 for a shape it does
// not take.
extern "C" int wkv6_tc_forward(const void* r, const void* k, const void* v,
                               const void* logw, const void* u, void* out,
                               const long long* strides, int dtype, int B, int H, int T,
                               int K, void* stream) {
  if (K != tc::K || B <= 0 || H <= 0 || T <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  if (dtype == 0) return tc::launch<float>(r, k, v, lw, uu, out, strides, B, H, T, s);
  if (dtype == 1) return tc::launch<__nv_bfloat16>(r, k, v, lw, uu, out, strides, B, H, T, s);
  return -1;
}
