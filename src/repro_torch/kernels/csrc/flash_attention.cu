// Flash attention forward (GQA, optional causal) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fa_kernel / flash_attention_bhsd). Computes
//   o = softmax(q k^T * D^-0.5  [causal mask at -1e30]) v
// over [B, H, S, D] tensors; query head h reads kv head h / (H / Hkv).
//
// Head sizes: instances at D = 16, 32, 64, 96, 128 and 256; any other
// d <= 256 runs the next instance up. The instance's D sizes the shared
// tiles and the registers; the true d is the rows' stride in device memory,
// columns d .. D-1 of q, k and v are zero-filled in shared memory (they add
// nothing to a dot product or to the output) and the store drops them. The
// caller passes the scale of the true d.
//
// Above 256 no instance's tiles fit a block's shared memory, so d > 256 runs
// fa_fwd_slab_kernel: the head dimension is cut into slabs of DS = 128
// columns. Each CTA owns one slab of output columns (grid z = B x slabs);
// for every kv tile it accumulates q.k^T slab by slab through the shared
// tiles (the same summation order over d as the instances), then carries
// its own slab of the output through the online softmax. The scores are
// thus recomputed once per output slab: right, not fast (see PERF.md).
//
// Design (simple and right first): one CTA per (64-row q tile, head, batch),
// 256 threads, four threads per q row. The CTA loops over 64-row kv tiles
// held in shared memory as f32; the online softmax state (m, l) of each row
// and its share of the f32 accumulator stay in registers. Thread t of a row
// owns score columns t, t+4, ... and output dims t, t+4, ..., so a warp's
// shared-memory reads hit distinct banks. When causal, kv tiles wholly above
// the diagonal are never loaded. All math is f32 on the CUDA cores (no
// wgmma, no TMA yet), so this kernel is bound by f32 FMA issue, far from the
// card's bf16 tensor-core bound; see PERF.md for its measured time.
//
// C interface (bound with ctypes): fa_forward returns cudaGetLastError()
// after the launch, or -1 for a dtype it has no instance for or a head_dim
// below 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int TPR = 4;        // threads per q row
constexpr int THREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], all f32.
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              int H, int Hkv, int Sq, int Sk, int d, float scale, int causal) {
  constexpr int DP = D + 1;       // padded row stride of Qs / Ks
  constexpr int PP = BK + 1;      // padded row stride of Ps
  constexpr int SC = BK / TPR;    // score columns per thread
  constexpr int DT = D / TPR;     // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int qi = q0 + r;

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * d;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * d;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * d;
  T* ob = o + ((size_t)b * H + h) * (size_t)Sq * d;

  // q is scaled in f32 before the dot, as the TPU kernel does.
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D, row = q0 + rr;
    Qs[rr * DP + dd] = row < Sq && dd < d ? to_f32(qb[(size_t)row * d + dd]) * scale : 0.f;
  }

  float acc[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;

  // Causal: tile kt runs iff kt*BK <= q0 + BQ - 1 (the TPU kernel's rule).
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed; Qs is visible
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, dd = i % D, row = k0 + c;
      const bool ok = row < Sk && dd < d;
      Ks[c * DP + dd] = ok ? to_f32(kb[(size_t)row * d + dd]) : 0.f;
      Vs[c * D + dd] = ok ? to_f32(vb[(size_t)row * d + dd]) : 0.f;
    }
    __syncthreads();

    float s[SC];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = t + TPR * j;
      float dot = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) dot += Qs[r * DP + dd] * Ks[c * DP + dd];
      if (causal && qi < k0 + c) dot = NEG_INF;
      s[j] = dot;
      if (k0 + c < Sk) mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = __expf(m - m_new);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = t + TPR * j;
      const float p = (k0 + c < Sk) ? __expf(s[j] - m_new) : 0.f;
      rowsum += p;
      Ps[r * PP + c] = p;
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
    l = l * corr + rowsum;
    m = m_new;
    __syncwarp();  // the row's four threads see each other's Ps entries

#pragma unroll
    for (int e = 0; e < DT; ++e) acc[e] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[e] += p * Vs[c * D + t + TPR * e];
    }
  }

  if (qi < Sq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < DT; ++e)
      if (t + TPR * e < d) ob[(size_t)qi * d + t + TPR * e] = from_f32<T>(acc[e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int d, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, d, scale, causal);
  return (int)cudaGetLastError();
}

constexpr int DS = 128;        // head-dim columns per slab above 256

constexpr size_t slab_smem_bytes() {
  // Qs [BQ][DS+1], Ks [BK][DS+1], Vs [BK][DS], Ps [BQ][BK+1], all f32.
  return sizeof(float) * (size_t)(BQ * (DS + 1) + BK * (DS + 1) + BK * DS + BQ * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_fwd_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   int H, int Hkv, int Sq, int Sk, int d, int n_slabs,
                   float scale, int causal) {
  constexpr int DP = DS + 1;
  constexpr int PP = BK + 1;
  constexpr int SC = BK / TPR;
  constexpr int DT = DS / TPR;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_slabs;
  const int o0 = (blockIdx.z % n_slabs) * DS;   // this CTA's output columns
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int qi = q0 + r;

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * d;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * d;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * d;
  T* ob = o + ((size_t)b * H + h) * (size_t)Sq * d;

  float acc[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    float s[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = 0.f;

    // q.k^T over the head dimension, one slab of DS columns at a time.
    for (int c0 = 0; c0 < d; c0 += DS) {
      __syncthreads();  // the last slab (and the last tile's Vs, Ps) is consumed
      for (int i = tid; i < BQ * DS; i += THREADS) {
        const int rr = i / DS, dd = i % DS, row = q0 + rr, col = c0 + dd;
        Qs[rr * DP + dd] = row < Sq && col < d
            ? to_f32(qb[(size_t)row * d + col]) * scale : 0.f;
      }
      for (int i = tid; i < BK * DS; i += THREADS) {
        const int c = i / DS, dd = i % DS, row = k0 + c, col = c0 + dd;
        Ks[c * DP + dd] = row < Sk && col < d ? to_f32(kb[(size_t)row * d + col]) : 0.f;
        if (c0 == 0) {
          const int oc = o0 + dd;
          Vs[c * DS + dd] = row < Sk && oc < d ? to_f32(vb[(size_t)row * d + oc]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = t + TPR * j;
        float dot = s[j];
#pragma unroll 16
        for (int dd = 0; dd < DS; ++dd) dot += Qs[r * DP + dd] * Ks[c * DP + dd];
        s[j] = dot;
      }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = t + TPR * j;
      if (causal && qi < k0 + c) s[j] = NEG_INF;
      if (k0 + c < Sk) mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = __expf(m - m_new);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = t + TPR * j;
      const float p = (k0 + c < Sk) ? __expf(s[j] - m_new) : 0.f;
      rowsum += p;
      Ps[r * PP + c] = p;
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
    l = l * corr + rowsum;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int e = 0; e < DT; ++e) acc[e] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[e] += p * Vs[c * DS + t + TPR * e];
    }
  }

  if (qi < Sq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      const int oc = o0 + t + TPR * e;
      if (oc < d) ob[(size_t)qi * d + oc] = from_f32<T>(acc[e] * inv);
    }
  }
}

template <typename T>
int launch_slab(const void* q, const void* k, const void* v, void* o, int B, int H,
                int Hkv, int Sq, int Sk, int d, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = slab_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slabs = (d + DS - 1) / DS;
  dim3 grid((Sq + BQ - 1) / BQ, H, B * n_slabs);
  fa_fwd_slab_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, d, n_slabs, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
               int Hkv, int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t stream) {
  // The smallest instance that holds D columns.
  if (D <= 16) return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  if (D <= 96) return launch<T, 96>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  if (D <= 256) return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
  return launch_slab<T>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous [B, H(kv), S, D],
// D >= 1 (above 256 in slabs).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                          float scale, int causal, void* stream) {
  if (D <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, s);
  return -1;
}
