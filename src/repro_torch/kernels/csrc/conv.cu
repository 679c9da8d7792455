// The Mamba-2 layers' depthwise causal conv over tokens, its bias and SiLU
// in one pass, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the conv to XLA, which
// fuses it. Eager PyTorch runs models/mamba2.py::_causal_conv as about ten
// kernels a call (a cat with the zero pad, a product a tap on a strided
// slice, the adds, the bias, SiLU), each reading and writing the whole
// activation; this kernel reads x once and writes the output once.
//
// Over x [B, S, C] (channels contiguous, tokens and rows at any stride: the
// in-projection's xBC columns are read where they lie), w [K, C] and bias
// [C] (or none), for every token t and channel c, with x[t'] = 0 for t' < 0:
//   acc = 0
//   acc = acc + x[t - K + 1 + i] * w[i]      for i = 0 .. K - 1
//   acc = acc + bias                          (where given)
//   out = acc / (1 + exp(-acc))               in f32
// with every product and sum rounded to the dtype on its own and SiLU's
// f32 result rounded once: the operations, in the same order, that
// _causal_conv's eager kernels run, so the two agree bit for bit. In f32
// the products and sums are __fmul_rn and __fadd_rn (no FMA contraction).
// In bf16 they are mul.rn.bf16x2 and add.rn.bf16x2, two channels an
// instruction: one rounding of the exact result to bf16, which is what
// PyTorch's f32 operation followed by a rounding to bf16 gives, since f32
// carries more than 2 x 8 + 2 bits (no double-rounding error). SiLU is
// PyTorch's expression on the accurate expf and an IEEE division.
//
// What bounds it: bytes. At zamba2_7b's [4, 4096, 7424] in bf16 it moves
// 486.5 MB a call (0.145 ms at 3.35 TB/s) against 13 operations an element.
//
// Design: a thread owns 8 bytes of channels (4 in bf16, 2 in f32) and walks
// a run of RUN consecutive tokens, keeping the last K - 1 inputs in
// registers; the taps and the bias stay in registers. The K - 1 tokens of
// halo that a run reads again (19% more loads at RUN 16) come mostly from
// L2, as the run before reads them at about the same time. The loads of the
// next UNROLL tokens are issued before this step's UNROLL tokens compute, so
// loads stay in flight through SiLU's arithmetic (about 20 instructions an
// element: expf and an IEEE division). Neighbouring threads own
// neighbouring channels of one token row, so a warp's loads and stores are
// 256 contiguous bytes. 58 registers (bf16, K = 4) let 4 CTAs of 256
// threads share an SM. Of 28 layouts timed on the H100 at zamba2_7b's shape
// (4, 8 or 16 bytes a thread, runs of 16 to 64 tokens, 2 to 16 tokens a
// step, 1 to 6 CTAs an SM) this was the fastest, 0.179 ms; 16 bytes a
// thread over runs of 64 tokens took 0.207 to 0.237 ms (PERF.md). K up to
// MAX_K.
//
// C interface (bound with ctypes): causal_conv_silu_forward returns
// cudaGetLastError() after the launch, -1 for a dtype there is no instance
// for, -2 for a shape or an alignment it does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;   // CTAs an SM: at most 64 registers a thread
constexpr int MAX_K = 4;
constexpr int RUN = 16;         // tokens a thread walks
constexpr int UNROLL = 4;       // tokens loaded a step
constexpr int WORDS = 2;        // 32-bit words a thread owns of a token
constexpr int VEC = 4 * WORDS;  // their bytes

__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// f32: a word is one channel.
struct F32 {
  using Word = float;
  __device__ static Word mul(Word a, Word b) { return __fmul_rn(a, b); }
  __device__ static Word add(Word a, Word b) { return __fadd_rn(a, b); }
  __device__ static Word act(Word a) { return silu(a); }
};

// bf16: a word is two channels, the lower address in the low half.
struct BF16 {
  using Word = uint32_t;
  __device__ static Word mul(Word a, Word b) {
    Word d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static Word add(Word a, Word b) {
    Word d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static Word act(Word a) {
    const float lo = silu(__uint_as_float(a << 16));
    const float hi = silu(__uint_as_float(a & 0xffff0000u));
    Word d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
  }
};

template <typename A>
struct alignas(VEC) Pack {
  typename A::Word w[WORDS];
};

// One token: the taps over the K - 1 inputs before it (h, oldest first) and
// x itself, the bias, SiLU; then x joins the history.
template <typename A, int K>
__device__ __forceinline__ Pack<A> step(Pack<A> (&h)[K], const Pack<A>& x,
                                        const Pack<A> (&wt)[K], const Pack<A>& bs,
                                        bool has_bias) {
  Pack<A> y;
#pragma unroll
  for (int q = 0; q < WORDS; ++q) {
    typename A::Word acc = A::add(typename A::Word(0), A::mul(K > 1 ? h[0].w[q] : x.w[q],
                                                              wt[0].w[q]));
#pragma unroll
    for (int i = 1; i < K; ++i)
      acc = A::add(acc, A::mul(i < K - 1 ? h[i].w[q] : x.w[q], wt[i].w[q]));
    if (has_bias) acc = A::add(acc, bs.w[q]);
    y.w[q] = A::act(acc);
  }
#pragma unroll
  for (int i = 0; i + 2 < K; ++i) h[i] = h[i + 1];
  if constexpr (K > 1) h[K - 2] = x;
  return y;
}

// x, w, bias and out in units of VEC bytes: cp of them a row of C
// channels; x_batch and x_row x's strides, out contiguous [B, S, C].
template <typename A, int K>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
causal_conv_silu_kernel(const Pack<A>* __restrict__ x, const Pack<A>* __restrict__ w,
                        const Pack<A>* __restrict__ bias, Pack<A>* __restrict__ out,
                        long long x_batch, long long x_row, int S, int cp, int runs,
                        long long units) {
  const long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (u >= units) return;
  const int c = (int)(u % cp);
  const long long r = u / cp;
  const int t0 = (int)(r % runs) * RUN;
  const long long b = r / runs;
  const int t1 = min(t0 + RUN, S);

  Pack<A> wt[K], bs = {};
#pragma unroll
  for (int i = 0; i < K; ++i) wt[i] = w[(long long)i * cp + c];
  const bool has_bias = bias != nullptr;
  if (has_bias) bs = bias[c];

  const Pack<A>* xb = x + b * x_batch + c;
  Pack<A>* ob = out + b * S * cp + c;
  Pack<A> h[K];   // the K - 1 inputs before the next token (h[K - 1] unused)
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    h[j] = t >= 0 ? xb[t * x_row] : Pack<A>{};
  }

  // Whole steps of UNROLL tokens, the next step's loads issued before this
  // step computes, so that every thread keeps loads in flight; then the
  // rest one token at a time.
  int t = t0;
  if (t + UNROLL <= t1) {
    Pack<A> cur[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) cur[j] = xb[(t + j) * x_row];
    for (;;) {
      const bool more = t + 2 * UNROLL <= t1;
      Pack<A> nxt[UNROLL];
      if (more) {
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) nxt[j] = xb[(t + UNROLL + j) * x_row];
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        ob[(long long)(t + j) * cp] = step<A, K>(h, cur[j], wt, bs, has_bias);
      t += UNROLL;
      if (!more) break;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) cur[j] = nxt[j];
    }
  }
  for (; t < t1; ++t) ob[(long long)t * cp] = step<A, K>(h, xb[t * x_row], wt, bs, has_bias);
}

template <typename A, int K>
int launch(const void* x, const void* w, const void* bias, void* out, long long x_batch,
           long long x_row, int B, int S, int cp, cudaStream_t stream) {
  const int runs = (S + RUN - 1) / RUN;
  const long long units = (long long)B * runs * cp;
  const long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return -2;
  causal_conv_silu_kernel<A, K><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const Pack<A>*>(x), static_cast<const Pack<A>*>(w),
      static_cast<const Pack<A>*>(bias), static_cast<Pack<A>*>(out), x_batch, x_row, S, cp,
      runs, units);
  return (int)cudaGetLastError();
}

template <typename A>
int dispatch(const void* x, const void* w, const void* bias, void* out, long long x_batch,
             long long x_row, int B, int S, int cp, int K, cudaStream_t s) {
  switch (K) {
    case 1: return launch<A, 1>(x, w, bias, out, x_batch, x_row, B, S, cp, s);
    case 2: return launch<A, 2>(x, w, bias, out, x_batch, x_row, B, S, cp, s);
    case 3: return launch<A, 3>(x, w, bias, out, x_batch, x_row, B, S, cp, s);
    default: return launch<A, 4>(x, w, bias, out, x_batch, x_row, B, S, cp, s);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % VEC == 0; }

}  // namespace

// x [B, S, C] at strides (x_batch, x_row, 1) in elements; w [K, C] and bias
// [C] (null for none) contiguous; out contiguous [B, S, C]; all of one dtype
// (0 f32, 1 bf16). C, x's strides and every base at multiples of 8 bytes.
// Returns cudaGetLastError() after the launch, -1 for another dtype, -2 for
// a shape or an alignment it does not take.
extern "C" int causal_conv_silu_forward(const void* x, const void* w, const void* bias,
                                        void* out, int dtype, int B, int S, int C, int K,
                                        long long x_batch, long long x_row, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const int es = dtype == 0 ? 4 : 2;
  if (B <= 0 || S <= 0 || C <= 0 || K < 1 || K > MAX_K || (long long)C * es % VEC ||
      x_batch * es % VEC || x_row * es % VEC || !aligned(x) || !aligned(w) || !aligned(out) ||
      (bias && !aligned(bias)))
    return -2;
  const int per = VEC / es;   // elements in a Pack
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<F32>(x, w, bias, out, x_batch / per, x_row / per, B, S, C / per, K, s);
  return dispatch<BF16>(x, w, bias, out, x_batch / per, x_row / per, B, S, C / per, K, s);
}
