// RWKV-6 WKV chunked recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (_wkv_kernel /
// wkv6_bhtk). Over [B, H, T, K] tensors, per (b, h) and chunk of C steps,
// with la the inclusive cumulative log decay and la_prev = la - lw:
//   scores[t][s] = sum_c r[t][c] k[s][c] exp(min(la_prev[t][c] - la[s][c], 0))
//                  for s < t, plus the bonus sum_c r[t][c] u[c] k[t][c] at s == t
//   out          = scores @ v + (r * exp(la_prev)) @ state
//   state        = state * exp(la_end) + (k * exp(la_end - la))^T @ v
// The pairwise exponent is built per (t, s, c) and clamped at 0, never
// factored into exp(la_prev) * exp(-la): with strong decays exp(-la)
// overflows f32 within one chunk.
//
// Design (simple and right first): one CTA per (b, h), 256 threads. The TPU
// kernel's sequential chunk axis (grid axis 2, state in VMEM scratch)
// becomes a loop over chunks inside the CTA, with the [K, K] f32 state in
// shared memory (16 KB at K = 64). Each chunk's r and k are stored
// transposed ([K][C + 4], t contiguous) so a thread reads four t (or s)
// values as one float4; every product is a loop of 4x4 register tiles.
// A ragged last chunk is zero-padded: lw = 0 there keeps la at its last
// valid value, and k = 0 adds nothing to the state.
//
// What bounds it: the C*C/2*K pairwise exponentials and the three f32
// products, all on the CUDA cores (the operations bound at the model's
// shapes; bytes are one read of r, k, v, logw and one write of out). The
// exponentials go through the SFU (__expf) at 16 a clock per SM; moving
// the products to wgmma is later work. See PERF.md for measured times.
//
// C interface (bound with ctypes): wkv6_forward returns cudaGetLastError()
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
