// relic_matmul and relic_matmul_gated for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/relic_matmul.py:
//   _mm_kernel / relic_matmul          out = x @ w
//   _gated_kernel / relic_matmul_gated out = act(x @ w_gate) * (x @ w_up)
// x [M, K], w [K, N] (gated: w_gate, w_up [K, N]), all row-major and of one
// type (f32 or bf16); the sums are f32 and the output is f32 or bf16. The
// gated form keeps both accumulators in registers and applies the activation
// at the flush, so neither product reaches device memory. Activations:
// 1 = silu, 2 = gelu (tanh form, jax.nn.gelu's default); any other code
// leaves the gate unactivated, as the TPU kernel does.
//
// What bounds it on the H100: at the model's shapes (relic_tiny's MLP,
// [2048, 768] @ [768, 2048]) the product does about 440 bf16 operations per
// byte it must move, above the card's 295 FLOP/byte ridge, so it is bound by
// the tensor cores (989 TFLOP/s bf16); in f32 by the CUDA cores' 67 TFLOP/s.
//
// Design (simple and right first). The TPU kernel's grid walks K innermost
// with an f32 scratch tile that is zeroed at k = 0 and flushed at the last k;
// here one CTA owns one output tile and loops over K itself, with the
// accumulator in registers. Ragged M, N and K are masked in the kernel (loads
// outside the matrices read zero, stores outside are skipped), so every shape
// launches.
//   * bf16: 8 warps, a 128 x BN tile (BN = 128, gated 64 per weight), K in
//     steps of 32. Each step's tiles are loaded into registers while the
//     previous step computes, then stored to shared memory: x row-major, w
//     transposed to [n][k], rows padded to 40 elements so the fragment reads
//     hit distinct banks. The products are mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); each warp owns a 32 x (BN / 2) share of the tile.
//   * f32: IEEE f32 FMA on the CUDA cores, never TF32 (the f32 path is held
//     at rtol 2e-4). 16 x 16 threads, each with an 8 x TN register tile
//     (TN = 8, gated 4 per weight), K in steps of 16 through shared memory.
// Neither uses TMA, a multi-stage ring or wgmma yet; that warp-specialised
// form is later work (ROADMAP.md). See PERF.md for the measured times.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch, or -1 for a dtype it has no instance for.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float activate(int act, float g) {
  if (act == 1) return g * (1.0f / (1.0f + expf(-g)));  // silu
  if (act == 2) {                                        // gelu, tanh form
    const float c = 0.7978845608028654f;                 // sqrt(2 / pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g;
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, size_t i, float v) {
  if (out_bf16)
    static_cast<unsigned short*>(out)[i] = __bfloat16_as_ushort(__float2bfloat16(v));
  else
    static_cast<float*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA
// ---------------------------------------------------------------------------

template <int TN, bool GATED>
__global__ void __launch_bounds__(THREADS)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
              const float* __restrict__ wu, void* __restrict__ out, int out_bf16,
              int M, int N, int K, int act) {
  constexpr int BM = 128, BN = 16 * TN, BK = 16, NW = GATED ? 2 : 1;
  __shared__ __align__(16) float xs[BK][BM + 4];      // x tile, transposed [k][m]
  __shared__ __align__(16) float ws[NW][BK][BN + 4];  // w tile(s) [k][n]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* w[2] = {wg, wu};
  float acc[NW][8][TN];
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[v][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {
      const int e = tid + j * THREADS, r = e / BK, c = e % BK, gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int e = tid + j * THREADS, r = e / BN, c = e % BN, gk = k0 + r, gn = n0 + c;
        ws[v][r][c] = (gk < K && gn < N) ? w[v][(size_t)gk * N + gn] : 0.0f;
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&xs[kk][ty * 8]);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(&xs[kk][ty * 8 + 4]);
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN; j += 4)
          *reinterpret_cast<float4*>(b + j) =
              *reinterpret_cast<const float4*>(&ws[v][kk][tx * TN + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[v][i][j] = fmaf(a[i], b[j], acc[v][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const float y = GATED ? activate(act, acc[0][i][j]) * acc[NW - 1][i][j] : acc[0][i][j];
      store_out(out, out_bf16, (size_t)gm * N + gn, y);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16, f32 accumulators
// ---------------------------------------------------------------------------

// d += a b for one 16 x 8 x 16 tile; a, b, d in the PTX fragment layouts.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

// Eight consecutive bf16 of row `row` (cols col .. col + 7); entries outside
// the matrix read 0. `vec`: the row stride and base are 16-byte aligned.
__device__ __forceinline__ uint4 load8(const unsigned short* __restrict__ p, int row,
                                       int rows, int col, int cols, int vec) {
  Pack8 r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return r.u;
  const unsigned short* src = p + (size_t)row * cols + col;
  if (vec) return *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 8; ++i) r.s[i] = (col + i < cols) ? src[i] : (unsigned short)0;
  return r.u;
}

__device__ __forceinline__ uint32_t lds32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int NT, bool GATED>
__global__ void __launch_bounds__(THREADS)
mm_bf16_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ wg,
               const unsigned short* __restrict__ wu, void* __restrict__ out,
               int out_bf16, int M, int N, int K, int act, int vec) {
  constexpr int BM = 128, WN = 8 * NT, BN = 2 * WN, BK = 32, LD = BK + 8;
  constexpr int NW = GATED ? 2 : 1;
  constexpr int XCH = BM * BK / 8 / THREADS;   // 8-element chunks of x per thread
  constexpr int WCH = BK * BN / 8 / THREADS;   // ... of each w per thread
  __shared__ __align__(16) unsigned short xs[BM][LD];       // [m][k]
  __shared__ __align__(16) unsigned short ws[NW][BN][LD];   // [n][k], transposed

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const unsigned short* w[2] = {wg, wu};

  float acc[NW][2][NT][4];
#pragma unroll
  for (int v = 0; v < NW; ++v)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[v][i][j][c] = 0.0f;

  // The next K step's tiles, staged in registers. x chunk q covers row q / 4,
  // cols 8 (q % 4) ..; w chunk q covers k row q % 32, cols 8 (q / 32) ..
  uint4 xr[XCH], wr[NW][WCH];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int q = tid + j * THREADS;
      xr[j] = load8(x, m0 + q / 4, M, k0 + (q % 4) * 8, K, vec);
    }
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int j = 0; j < WCH; ++j) {
        const int q = tid + j * THREADS;
        wr[v][j] = load8(w[v], k0 + q % BK, K, n0 + (q / BK) * 8, N, vec);
      }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int q = tid + j * THREADS;
      *reinterpret_cast<uint4*>(&xs[q / 4][(q % 4) * 8]) = xr[j];
    }
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int j = 0; j < WCH; ++j) {
        const int q = tid + j * THREADS;
        Pack8 p;
        p.u = wr[v][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) ws[v][(q / BK) * 8 + i][q % BK] = p.s[i];
      }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // the previous step's fragment reads are done
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);   // in flight while this step computes
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = lds32(&xs[r][ks + 2 * t]);
        a[i][1] = lds32(&xs[r + 8][ks + 2 * t]);
        a[i][2] = lds32(&xs[r][ks + 2 * t + 8]);
        a[i][3] = lds32(&xs[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int v = 0; v < NW; ++v)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn + j * 8 + g;
          const uint32_t b0 = lds32(&ws[v][c][ks + 2 * t]);
          const uint32_t b1 = lds32(&ws[v][c][ks + 2 * t + 8]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[v][i][j], a[i], b0, b1);
        }
    }
  }

  // Fragment c of tile (i, j): row g (+8 for c >= 2), col 2t (+1 for odd c).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + wm + i * 16 + g + (c / 2) * 8;
        const int gn = n0 + wn + j * 8 + 2 * t + (c % 2);
        if (gm >= M || gn >= N) continue;
        const float y = GATED ? activate(act, acc[0][i][j][c]) * acc[NW - 1][i][j][c]
                              : acc[0][i][j][c];
        store_out(out, out_bf16, (size_t)gm * N + gn, y);
      }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int launch(const void* x, const void* wg, const void* wu, void* out, int dtype,
           int out_bf16, int M, int N, int K, int act, bool gated, cudaStream_t stream) {
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(wg);
    const float* uf = static_cast<const float*>(wu);
    if (gated) {
      dim3 grid((N + 63) / 64, (M + 127) / 128);
      mm_f32_kernel<4, true><<<grid, THREADS, 0, stream>>>(xf, gf, uf, out, out_bf16, M, N,
                                                           K, act);
    } else {
      dim3 grid((N + 127) / 128, (M + 127) / 128);
      mm_f32_kernel<8, false><<<grid, THREADS, 0, stream>>>(xf, gf, gf, out, out_bf16, M, N,
                                                            K, act);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const unsigned short* xb = static_cast<const unsigned short*>(x);
    const unsigned short* gb = static_cast<const unsigned short*>(wg);
    const unsigned short* ub = static_cast<const unsigned short*>(wu);
    const int vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(wg) &&
                    aligned16(wu);
    if (gated) {
      dim3 grid((N + 63) / 64, (M + 127) / 128);
      mm_bf16_kernel<4, true><<<grid, THREADS, 0, stream>>>(xb, gb, ub, out, out_bf16, M,
                                                            N, K, act, vec);
    } else {
      dim3 grid((N + 127) / 128, (M + 127) / 128);
      mm_bf16_kernel<8, false><<<grid, THREADS, 0, stream>>>(xb, gb, gb, out, out_bf16, M,
                                                             N, K, act, vec);
    }
    return (int)cudaGetLastError();
  }
  return -1;
}

}  // namespace

// dtype (of x and w): 0 = float32, 1 = bfloat16; out_bf16: the output is
// bfloat16 (else float32). All tensors contiguous and row-major.
extern "C" int relic_matmul_forward(const void* x, const void* w, void* out, int dtype,
                                    int out_bf16, int M, int N, int K, void* stream) {
  return launch(x, w, w, out, dtype, out_bf16, M, N, K, 0, false,
                static_cast<cudaStream_t>(stream));
}

// act: 1 = silu, 2 = gelu (tanh form), anything else = no activation.
extern "C" int relic_matmul_gated_forward(const void* x, const void* w_gate,
                                          const void* w_up, void* out, int dtype,
                                          int out_bf16, int M, int N, int K, int act,
                                          void* stream) {
  return launch(x, w_gate, w_up, out, dtype, out_bf16, M, N, K, act, true,
                static_cast<cudaStream_t>(stream));
}
