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
// Design. The TPU kernel's grid walks K innermost with an f32 scratch tile
// that is zeroed at k = 0 and flushed at the last k; here one CTA owns one
// output tile and loops over K itself, with the accumulator in registers.
// Ragged M, N and K are masked in the kernel (loads outside the matrices
// read zero, stores outside are skipped), so every shape launches.
//   * bf16 (relic_matmul takes it only for inputs that a TMA map cannot
//     describe, see relic_matmul_wgmma.cu; the gated form likewise):
//     8 warps, a 128 x BN tile (BN = 128, gated 64 per weight), K in steps
//     of 32. Each step's tiles are loaded into registers while the previous
//     step computes, then stored to shared memory: x row-major, w transposed
//     to [n][k], rows padded to 40 elements so the fragment reads hit
//     distinct banks. The products are mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); each warp owns a 32 x (BN / 2) share of the tile.
//   * f32, relic_matmul: IEEE f32 FMA on the CUDA cores, never TF32 (the f32
//     path is held at rtol 2e-4). The tile is chosen by the caller from the
//     shape (128 x 128 down to 16 x 32), so that a small product still
//     spreads over many SMs: the quickstart's [128, 256] @ [256, 128] runs
//     on 32 CTAs. K runs through a 3-stage cp.async ring (steps of 16 for
//     the largest tile, up to 64 for the smallest), so the loads of step
//     k + 2 are in flight while step k computes. No split of K: the sums do
//     not depend on an order of arrival.
//   * f32, the gated form: 16 x 16 threads, each with an 8 x 4
//     register tile per weight, K in steps of 16 through shared memory.
// See PERF.md for the measured times.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch, -1 for a dtype it has no instance for, -2 for an f32
// tile it has no instance for.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::activate;

constexpr int THREADS = 256;

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
// f32, relic_matmul: tiles chosen by shape, a cp.async ring over K
// ---------------------------------------------------------------------------


// 16 bytes (vec) or four single floats from row `row`, cols col .. col + 3
// of a rows x cols row-major matrix into shared memory at `dst`; entries
// outside the matrix are written as zeros (the copy's source size is 0).
__device__ __forceinline__ void copy4_async(float* dst, const float* __restrict__ src,
                                            int row, int rows, int col, int cols,
                                            int vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec) {   // cols % 4 == 0: the four are all in or all out
    const bool in = row < rows && col < cols;
    const float* g = in ? src + (size_t)row * cols + col : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(g), "r"(in ? 16 : 0) : "memory");
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = row < rows && col + e < cols;
    const float* g = in ? src + (size_t)row * cols + col + e : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d + 4 * e), "l"(g), "r"(in ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A BM x BN output tile per CTA of (BM / TM) x (BN / TN) threads; each thread
// owns TM rows strided by BM / TM and TN columns in float4 groups strided by
// 4 (BN / TN), so the float4 reads of x (along K, rows padded to BK + 4) and
// of w (along N) hit distinct banks. K goes BK at a time through a ring of
// STAGES stages: stage kt + STAGES - 1 loads while stage kt computes. Small
// tiles take a deeper BK, so a short K is a few long steps.
template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct F32Tile {
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int XS = BK + 4, WS = BN + 4;   // smem row strides (floats)
  static constexpr int STAGE = BM * XS + BK * WS;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
};

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__(F32Tile<BM, BN, TM, TN, BK, STAGES>::THREADS)
mm_f32_async_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    void* __restrict__ out, int out_bf16, int M, int N, int K, int vec) {
  using T = F32Tile<BM, BN, TM, TN, BK, STAGES>;
  constexpr int TX = T::TX, TY = T::TY, XS = T::XS, WS = T::WS;
  constexpr int F32_STAGES = STAGES;
  extern __shared__ __align__(16) float f32_smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int kt) {
    float* xs = f32_smem + (kt % F32_STAGES) * T::STAGE;
    float* ws = xs + BM * XS;
    const int k0 = kt * BK;
    for (int q = tid; q < BM * BK / 4; q += T::THREADS) {
      const int r = q / (BK / 4), c = q % (BK / 4) * 4;
      copy4_async(xs + r * XS + c, x, m0 + r, M, k0 + c, K, vec);
    }
    for (int q = tid; q < BK * BN / 4; q += T::THREADS) {
      const int r = q / (BN / 4), c = q % (BN / 4) * 4;
      copy4_async(ws + r * WS + c, w, k0 + r, K, n0 + c, N, vec);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<F32_STAGES - 2>();   // stage kt has landed
    __syncthreads();                   // ... for every thread; stage kt - 1 is consumed
    if (kt + F32_STAGES - 1 < nk) load(kt + F32_STAGES - 1);
    cp_async_commit();
    const float* xs = f32_smem + (kt % F32_STAGES) * T::STAGE;
    const float* ws = xs + BM * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(a[i]) =
            *reinterpret_cast<const float4*>(xs + (ty + i * TY) * XS + kk);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN; j += 4)
          *reinterpret_cast<float4*>(b + j) = *reinterpret_cast<const float4*>(
              ws + (kk + k4) * WS + tx * 4 + j * TX);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][k4], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int gn = n0 + tx * 4 + j * TX;
      const size_t off = (size_t)gm * N + gn;
      if (vec && !out_bf16 && gn < N) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < N) store_out(out, out_bf16, off + e, acc[i][j + e]);
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
int launch_f32(const float* x, const float* w, void* out, int out_bf16, int M, int N,
               int K, int vec, cudaStream_t stream) {
  using T = F32Tile<BM, BN, TM, TN, BK, STAGES>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mm_f32_async_kernel<BM, BN, TM, TN, BK, STAGES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_f32_async_kernel<BM, BN, TM, TN, BK, STAGES><<<grid, T::THREADS, T::SMEM, stream>>>(
      x, w, out, out_bf16, M, N, K, vec);
  return (int)cudaGetLastError();
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
           int out_bf16, int M, int N, int K, int act, int tile, bool gated,
           cudaStream_t stream) {
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(wg);
    const float* uf = static_cast<const float*>(wu);
    if (gated) {
      dim3 grid((N + 63) / 64, (M + 127) / 128);
      mm_f32_kernel<4, true><<<grid, THREADS, 0, stream>>>(xf, gf, uf, out, out_bf16, M, N,
                                                           K, act);
      return (int)cudaGetLastError();
    }
    // The tile, chosen by the caller from the shape (F32_TILES in
    // kernels/relic_matmul.py, in this order).
    const int vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(wg) &&
                    aligned16(out);
    switch (tile) {
      case 0: return launch_f32<128, 128, 8, 8, 16, 3>(xf, gf, out, out_bf16, M, N, K, vec, stream);
      case 1: return launch_f32<64, 128, 4, 8, 32, 3>(xf, gf, out, out_bf16, M, N, K, vec, stream);
      case 2: return launch_f32<32, 32, 2, 4, 64, 3>(xf, gf, out, out_bf16, M, N, K, vec, stream);
      case 3: return launch_f32<16, 32, 1, 4, 64, 3>(xf, gf, out, out_bf16, M, N, K, vec, stream);
      default: return -2;
    }
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
// bfloat16 (else float32); tile: the f32 tile (0: 128 x 128, 1: 64 x 64,
// 2: 32 x 32, 3: 16 x 32; -2 for another), unused for bf16. All tensors
// contiguous and row-major.
extern "C" int relic_matmul_forward(const void* x, const void* w, void* out, int dtype,
                                    int out_bf16, int M, int N, int K, int tile,
                                    void* stream) {
  return launch(x, w, w, out, dtype, out_bf16, M, N, K, 0, tile, false,
                static_cast<cudaStream_t>(stream));
}

// act: 1 = silu, 2 = gelu (tanh form), anything else = no activation.
extern "C" int relic_matmul_gated_forward(const void* x, const void* w_gate,
                                          const void* w_up, void* out, int dtype,
                                          int out_bf16, int M, int N, int K, int act,
                                          void* stream) {
  return launch(x, w_gate, w_up, out, dtype, out_bf16, M, N, K, act, 0, true,
                static_cast<cudaStream_t>(stream));
}
