// Mamba-2 SSD chunked recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (_ssd_kernel /
// ssd_bhtp). Over x [B, H, T, P], a [B, H, T] (log decay, <= 0) and b, c
// [B, T, N] shared across heads, per (b, h) and chunk of C steps, with la
// the inclusive cumulative sum of a:
//   y     = ((C B^T) o exp(la_t - la_s) o [t >= s]) @ x + exp(la) * (C @ state^T)
//   state = state * exp(la_end) + (x * exp(la_end - la))^T @ B
// The decay exp(la_t - la_s) is computed only for s <= t (its exponent is
// then <= 0, and clamped at 0 besides); the TPU kernel takes exp of the
// whole [C, C] difference and hides the overflow above the diagonal with a
// select, which a mask applied by multiplying would turn into NaN.
//
// Design (simple and right first): one CTA per (b, h), 256 threads, the
// chunk axis a loop inside the CTA with the [P, N] f32 state in shared
// memory (16 KB at P = N = 64), stored transposed ([N][P]). C and B are
// stored transposed ([N][C + 4], t contiguous) and the masked weights as
// W^T ([s][t]), so every product is a loop of 4x4 register tiles fed by
// float4 reads. A ragged last chunk is zero-padded: a = 0 there keeps la at
// its last valid value, and x = b = 0 adds nothing to the state.
//
// What bounds it: the four f32 products per chunk (C B^T, W @ x, C @
// state^T, the state update), on the CUDA cores; the operations bound at
// the model's shapes. Each CTA recomputes C B^T, which the heads of one
// batch row share. Moving the products to wgmma and sharing C B^T across
// heads is later work. See PERF.md for measured times.
//
// C interface (bound with ctypes): ssd_forward returns cudaGetLastError()
// after the launch, -1 for a dtype it has no instance for, -2 for a shape
// it does not take. The chunk length is a runtime argument.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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
