// Rotary position embedding (split-half RoPE) of q and k in one pass, for
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves apply_rope
// (src/repro/models/layers.py) to XLA, which fuses it into one loop over
// the tensor. Eager PyTorch runs models/layers.py::apply_rope as about 18
// kernels a call (the frequencies, the angles, cos and sin, a widening to
// f32, four products on strided halves, a subtract, an add, a cat and a
// cast back), each reading and writing the whole tensor in f32; this
// kernel reads q and k once and writes them once, in their own dtype.
//
// Over q [B, S, H, D] and k [B, S, Kv, D] (contiguous), positions [P, S]
// (P = 1 or B) and freq [D / 2] (models/layers.py::rope_freqs, computed by
// the caller), for every token t and half-index j < D / 2:
//   a        = float(pos[t]) * freq[j]
//   y[j]     = x[j] * cos(a) - x[j + D/2] * sin(a)
//   y[j+D/2] = x[j + D/2] * cos(a) + x[j] * sin(a)
// with every product and sum rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction), the accurate cosf and sinf, and one
// round-to-nearest-even to the output dtype: the operations, in the same
// order, that apply_rope's eager kernels run, so the two agree bit for bit.
//
// What bounds it: bytes. At phi3_mini_3p8b's [4, 2048, 32 + 32, 96] in
// bf16 it moves 201 MB a call (60 us at 3.35 TB/s) against about 25
// operations a pair of elements.
//
// Design: a CTA takes a tile of `tile` tokens (the C entry picks it so that
// a CTA has about four loads of 16 bytes a thread to do). It first computes
// cos and sin once per token and frequency into shared memory, then walks
// the tile's (token, head, chunk) units, the heads of q followed by those
// of k, a chunk being V consecutive pairs (x[j..j+V) with x[j+D/2..j+D/2+V)):
// V = 8 in bf16 and 4 in f32, so every load and store is 16 bytes and
// neighbouring threads touch neighbouring addresses; V = 1 where D / 2 is
// no multiple of that or a base is not 16-byte aligned. The math is f32 in
// registers. Any D that is even, any H and Kv, any number of tokens.
//
// C interface (bound with ctypes): rope_forward returns cudaGetLastError()
// after the launch, -1 for a dtype there is no instance for, -2 for a shape
// it does not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNITS_PER_CTA = 4 * THREADS;   // units a CTA aims for
constexpr int MAX_SMEM = 48 * 1024;          // the static limit, no opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ qo,
            T* __restrict__ ko, const long long* __restrict__ pos,
            const float* __restrict__ freq, int n_tok, int S, int pos_row,
            int H, int Kv, int half, int tile) {
  extern __shared__ float2 cs[];   // [tile][half]: (cos, sin)
  const int t0 = blockIdx.x * tile;
  const int nt = min(tile, n_tok - t0);
  for (int i = threadIdx.x; i < nt * half; i += THREADS) {
    const int t = i / half, j = i - t * half;
    const int tok = t0 + t;
    const int b = tok / S, s = tok - b * S;
    const float a = __fmul_rn((float)pos[(long long)b * pos_row + s], freq[j]);
    cs[i] = make_float2(cosf(a), sinf(a));
  }
  __syncthreads();

  const int chunks = half / V;              // chunks of a head
  const int per_tok = (H + Kv) * chunks;    // units of a token
  const int D = 2 * half;
  for (int u = threadIdx.x; u < nt * per_tok; u += THREADS) {
    const int t = u / per_tok;
    const int r = u - t * per_tok;
    const int h = r / chunks;
    const int c = r - h * chunks;
    const long long tok = t0 + t;
    const long long off = h < H ? (tok * H + h) * D : (tok * Kv + (h - H)) * D;
    const T* src = (h < H ? q : k) + off + c * V;
    T* dst = (h < H ? qo : ko) + off + c * V;
    const Pack<T, V> x1 = *reinterpret_cast<const Pack<T, V>*>(src);
    const Pack<T, V> x2 = *reinterpret_cast<const Pack<T, V>*>(src + half);
    const float2* w = cs + t * half + c * V;
    Pack<T, V> y1, y2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float a1 = to_f32(x1.v[i]), a2 = to_f32(x2.v[i]);
      const float2 e = w[i];
      y1.v[i] = from_f32<T>(__fsub_rn(__fmul_rn(a1, e.x), __fmul_rn(a2, e.y)));
      y2.v[i] = from_f32<T>(__fadd_rn(__fmul_rn(a2, e.x), __fmul_rn(a1, e.y)));
    }
    *reinterpret_cast<Pack<T, V>*>(dst) = y1;
    *reinterpret_cast<Pack<T, V>*>(dst + half) = y2;
  }
}

template <typename T, int V>
int launch(const void* q, const void* k, void* qo, void* ko, const long long* pos,
           const float* freq, int n_tok, int S, int pos_row, int H, int Kv, int half,
           cudaStream_t stream) {
  const int per_tok = (H + Kv) * (half / V);
  int tile = per_tok >= UNITS_PER_CTA ? 1 : UNITS_PER_CTA / per_tok;
  tile = min(tile, MAX_SMEM / (half * (int)sizeof(float2)));
  const int blocks = (n_tok + tile - 1) / tile;
  const size_t smem = (size_t)tile * half * sizeof(float2);
  rope_kernel<T, V><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qo),
      static_cast<T*>(ko), pos, freq, n_tok, S, pos_row, H, Kv, half, tile);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int dispatch(const void* q, const void* k, void* qo, void* ko, const long long* pos,
             const float* freq, int n_tok, int S, int pos_row, int H, int Kv,
             int half, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (half % V == 0 && aligned16(q) && aligned16(k) && aligned16(qo) && aligned16(ko))
    return launch<T, V>(q, k, qo, ko, pos, freq, n_tok, S, pos_row, H, Kv, half, stream);
  return launch<T, 1>(q, k, qo, ko, pos, freq, n_tok, S, pos_row, H, Kv, half, stream);
}

}  // namespace

// q [B, S, H, D], k [B, S, Kv, D] and the outputs qo, ko of the same shapes,
// all contiguous and of one dtype (0 f32, 1 bf16); pos [pos_rows, S] int64
// contiguous, pos_rows 1 (every row at the same positions) or B; freq [D/2]
// f32. Returns cudaGetLastError() after the launch, -1 for another dtype,
// -2 for a shape it does not take.
extern "C" int rope_forward(const void* q, const void* k, void* qo, void* ko,
                            const void* pos, const void* freq, int dtype, int B,
                            int S, int pos_rows, int H, int Kv, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Kv <= 0 || D <= 0 || D % 2 != 0 ||
      (pos_rows != 1 && pos_rows != B) ||
      (long long)B * S > INT32_MAX || (D / 2) * (int)sizeof(float2) > MAX_SMEM)
    return -2;
  const int half = D / 2;
  const int pos_row = pos_rows == 1 ? 0 : S;
  const long long* p = static_cast<const long long*>(pos);
  const float* f = static_cast<const float*>(freq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, qo, ko, p, f, B * S, S, pos_row, H, Kv, half, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, qo, ko, p, f, B * S, S, pos_row, H, Kv, half, s);
  return -1;
}
