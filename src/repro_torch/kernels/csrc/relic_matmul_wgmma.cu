// relic_matmul for Hopper, sm_90a: the bf16 design on TMA and wgmma, the
// paper's bounded SPSC pipeline on the card's own lanes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/relic_matmul.py
// (_mm_kernel / relic_matmul and _gated_kernel / relic_matmul_gated) for
// bf16 inputs: out = x @ w, or out = act(x @ w_gate) * (x @ w_up) (GATED),
// x [M, K] and the weights [K, N] row-major bf16, f32 sums, the output in
// f32 or bf16.
//
// What bounds it on the H100: operations. At relic_tiny's MLP shapes the
// product does about 440 operations per byte it must move, above the card's
// 295 FLOP/byte ridge in bf16, so only the tensor cores through wgmma reach
// the rate (989 TFLOP/s).
//
// Design: the TPU kernel's DMA engine feeding the matrix unit through a
// double-buffered block ring (relic_matmul.py:3-9), which is the paper's
// single-producer/single-consumer queue, becomes on Hopper:
//  - one producer thread (in a producer warpgroup that gives its registers
//    to the consumers with setmaxnreg) keeps TMA loads (cp.async.bulk.tensor)
//    in flight into a ring of shared-memory stages (4 at BN = 128, 3 at
//    BN = 256, as many as fit beside the epilogue's buffers); each stage has a
//    `full` mbarrier (the TMA bytes have landed) and an `empty` one (both
//    consumers are done with it): the bounded queue, with fixed roles;
//  - two consumer warpgroups run wgmma.mma_async on 64-row halves of a
//    128 x BN output tile (BN 128 or 256, chosen by the caller from the
//    shape), with the f32 accumulators in registers; each stage is released
//    as soon as the wgmma of the next one has been issued;
//  - x [M, K] is the K-major A operand: TMA writes 128 x 64 tiles, 128-byte
//    swizzled. w [K, N] keeps N contiguous, so it is the MN-major B operand,
//    read through wgmma's transpose bit: TMA writes BN / 64 atoms of 64 K
//    rows x 64 columns; no transposing stores;
//  - the kernel is persistent: one CTA per SM walks output tiles, and the
//    ring runs on across tiles, so one tile's epilogue overlaps the next
//    tile's first loads;
//  - the epilogue converts the accumulators to out's type into a padded
//    shared-memory block per warpgroup, 64 columns at a time, and copies it
//    out in 16-byte row segments, so the stores are coalesced (with the
//    fragments written straight to device memory, 4 or 8 bytes a lane,
//    relic_tiny's up product took 0.0184 ms on an H100, staged 0.0128);
//  - ragged M and K are zero-filled by TMA, and the epilogue drops rows and
//    columns past M and N;
//  - the gated form (GATED): each stage holds the x tile and a tile of each
//    weight, all three announced by one expect_tx; each consumer keeps two
//    f32 accumulators and issues both weights' wgmmas on the same x stage,
//    so x is read once for both products; the staged epilogue writes
//    act(gate) * up (activate, hopper.cuh), so neither product reaches
//    device memory. Two accumulators of 64 registers a thread at 128
//    columns per weight, and 3 stages of 48 KB beside the epilogue's
//    buffers (4 at 64 columns); the caller chooses the width by the same
//    wave-quantisation cost as the plain product's.
// The caller (kernels/relic_matmul.py) sends only what a TMA map can
// describe here: bf16, K and N multiples of 8 (16-byte row strides),
// contiguous, 16-byte aligned bases.
//
// C interface (bound with ctypes): relic_matmul_wgmma_forward returns
// cudaGetLastError() after the launch, or a negative code for a failure
// before it (see the end of the file).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;          // output rows per tile: two consumer warpgroups
constexpr int BK = 64;           // K per stage: one 128-byte bf16 row
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;     // one x tile: 16 KB
constexpr int ATOM_BYTES = BK * 64 * 2;  // one 64-column atom of a w tile: 8 KB
// The epilogue stages 64 x 64 output blocks per warpgroup: rows padded so
// that the fragment writes hit distinct banks (16 bytes for bf16, 32 for
// f32 pairs).
constexpr int OUT_ROW_BF16 = 64 * 2 + 16, OUT_ROW_F32 = 64 * 4 + 32;
constexpr int OUT_BYTES = 64 * OUT_ROW_F32;   // per consumer warpgroup
constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
constexpr int CONSUMER_REGS = ((LAUNCH_REGS * THREADS - 24 * 128) / (128 * CONSUMERS)) / 8 * 8;

// Ring depth: as many stages as fit beside the epilogue's staging (4 at
// BN = 128, 3 at BN = 256; gated, with two weight tiles a stage: 3 at
// BN = 128, 4 at BN = 64).
template <int BN, bool GATED>
constexpr int kStages = (GATED ? 2 * BN : BN) >= 256 ? 3 : 4;
template <int BN, bool GATED>
constexpr int kStageBytes = A_BYTES + (GATED ? 2 : 1) * (BN / 64) * ATOM_BYTES;
template <int BN, bool GATED>
constexpr size_t smem_bytes() {
  return 1024 /* alignment slack */ +
         (size_t)kStages<BN, GATED> * kStageBytes<BN, GATED> +
         CONSUMERS * OUT_BYTES + 8 * 2 * kStages<BN, GATED>;
}
static_assert(smem_bytes<256, false>() <= 232448 && smem_bytes<128, true>() <= 232448 &&
                  smem_bytes<64, true>() <= 232448,
              "a block's shared memory");

// D[64 x BN] (+)= A[64 x 16] * B[16 x BN], B MN-major (transposed).
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_ss_tb(d, desc_a, desc_b, accumulate);
  else if constexpr (BN == 128)
    wgmma_m64n128k16_ss_tb(d, desc_a, desc_b, accumulate);
  else
    wgmma_m64n64k16_ss_tb(d, desc_a, desc_b, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int BN, bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_u, void* __restrict__ out,
                int out_bf16, int M, int N, int K, int act) {
  constexpr int ATOMS = BN / 64;
  constexpr int NW = GATED ? 2 : 1;   // weights: w (the gate), u (the up)
  constexpr int STAGES = kStages<BN, GATED>;
  constexpr int STAGE_BYTES = kStageBytes<BN, GATED>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto a_tile = [&](int s) { return base + STAGE_BYTES * s; };
  auto b_tile = [&](int s, int w) {
    return base + STAGE_BYTES * s + A_BYTES + w * ATOMS * ATOM_BYTES;
  };
  uint8_t* out_stage = base + STAGE_BYTES * STAGES;   // CONSUMERS x OUT_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_tn = (N + BN - 1) / BN;
  const int n_tiles = (M + BM - 1) / BM * n_tn;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
    if (GATED) prefetch_tensormap(&tm_u);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ---------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_tn * BM, n0 = tile % n_tn * BN;
        // Atoms wholly past N are not loaded: they feed only columns the
        // epilogue drops.
        const int atoms = min(ATOMS, (N - n0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, A_BYTES + NW * atoms * ATOM_BYTES);
          tma_load_2d(a_tile(s), &tm_x, full + s, kt * BK, m0);
          for (int w = 0; w < NW; ++w)
            for (int j = 0; j < atoms; ++j)
              tma_load_2d(b_tile(s, w) + j * ATOM_BYTES, w ? &tm_u : &tm_w, full + s,
                          n0 + 64 * j, kt * BK);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 output rows per warpgroup ------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_in_wg = 16 * warp + lane / 4;    // and row_in_wg + 8
  const int col = 2 * (lane % 4);                // within each 8-column block

  float acc[NW][BN / 2];   // [0] x @ w, [1] x @ u (gated)
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[w][i] = 0.f;   // each tile's first wgmma overwrites
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile / n_tn * BM, n0 = tile % n_tn * BN;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      // A: K-major, 16 bf16 of K are 32 bytes along each swizzled row. B:
      // MN-major, atoms 8 KB apart (lbo), 8-row groups 1024 bytes apart
      // (sbo); 16 rows of K are 2048 bytes.
      const uint64_t desc_a = desc_sw128(a_tile(s) + c * 64 * BK * 2, 16, 1024);
      mbar_wait(full + s, (it / STAGES) & 1);
#pragma unroll
      for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          wgmma_tile<BN>(acc[w], desc_a + 2 * kk,
                         desc_sw128(b_tile(s, w), ATOM_BYTES, 1024) + (2048 >> 4) * kk,
                         kt > 0 || kk > 0);
      wgmma_commit();
#pragma unroll
      for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
      // The previous stage's products are done: hand it back to the producer.
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int w = 0; w < NW; ++w) fence_regs(acc[w]);
    if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);

    // ---- epilogue: 64-column blocks through this warpgroup's staging
    // buffer, then out to device memory in 16-byte row segments (coalesced),
    // dropping rows past M and columns past N. The producer meanwhile loads
    // the next tile's first stages.
    uint8_t* stage_out = out_stage + c * OUT_BYTES;
    const int row_bytes = out_bf16 ? OUT_ROW_BF16 : OUT_ROW_F32;
    const int seg_elems = out_bf16 ? 8 : 4;        // elements per 16 bytes
    const int segs = 64 / seg_elems;                // 16-byte segments per row
#pragma unroll
    for (int cb = 0; cb < BN / 64; ++cb) {
      named_barrier(1 + c, 128);   // the last block's copy-out has read the buffer
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * cb + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row_in_wg + 8 * i, cc = 8 * jj + col;
          float v0 = acc[0][4 * j + 2 * i], v1 = acc[0][4 * j + 2 * i + 1];
          if constexpr (GATED) {
            v0 = activate(act, v0) * acc[NW - 1][4 * j + 2 * i];
            v1 = activate(act, v1) * acc[NW - 1][4 * j + 2 * i + 1];
          }
          if (out_bf16)
            *reinterpret_cast<uint32_t*>(stage_out + r * OUT_ROW_BF16 + cc * 2) =
                pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(stage_out + r * OUT_ROW_F32 + cc * 4) =
                make_float2(v0, v1);
        }
      }
      named_barrier(1 + c, 128);
      const int es = out_bf16 ? 2 : 4;
      for (int q = tid; q < 64 * segs; q += 128) {
        const int r = q / segs, sg = q % segs;
        const int gm = m0 + c * 64 + r, gn = n0 + 64 * cb + sg * seg_elems;
        // N % 8 == 0 and gn a multiple of 4: gn < N covers the segment.
        if (gm < M && gn < N)
          *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + ((size_t)gm * N + gn) * es) =
              *reinterpret_cast<const uint4*>(stage_out + r * row_bytes + sg * 16);
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so no -lcuda is needed.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major bf16 matrix of `rows` x `cols` as a 2-D map (cols innermost)
// with boxes of box_cols x box_rows, 128-byte swizzled.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rows, int cols,
            uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int BN, bool GATED>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_u,
           void* out, int out_bf16, int M, int N, int K, int act, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mm_wgmma_kernel<BN, GATED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes<BN, GATED>());
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int sms = n_sms();
  if (sms == 0) return -4;
  const int n_tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  mm_wgmma_kernel<BN, GATED>
      <<<n_tiles < sms ? n_tiles : sms, THREADS, smem_bytes<BN, GATED>(), stream>>>(
          tm_x, tm_w, tm_u, out, out_bf16, M, N, K, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] and w [K, N] bf16, contiguous, 16-byte aligned, K % 8 == 0 and
// N % 8 == 0; out [M, N] f32 (out_bf16 = 0) or bf16; bn: 128 or 256 output
// columns per tile. Returns 0 or cudaGetLastError() after the launch; -1 for
// a bn it has no instance for, -2 if cuTensorMapEncodeTiled cannot be found,
// -3 if a map cannot be encoded, -4 if the SM count cannot be read.
extern "C" int relic_matmul_wgmma_forward(const void* x, const void* w, void* out,
                                          int out_bf16, int M, int N, int K, int bn,
                                          void* stream) {
  if (bn != 128 && bn != 256) return -1;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tm_x, tm_w;
  if (!encode(fn, &tm_x, x, M, K, BK, BM) || !encode(fn, &tm_w, w, K, N, 64, BK))
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch<256, false>(tm_x, tm_w, tm_w, out, out_bf16, M, N, K, 0, s);
  return launch<128, false>(tm_x, tm_w, tm_w, out, out_bf16, M, N, K, 0, s);
}

// The gated form: out = act(x @ w_gate) * (x @ w_up); w_gate and w_up as w
// above, of one shape; bn: 128 or 64 columns per weight and tile; act: 1 =
// silu, 2 = gelu (tanh form), anything else = no activation. Returns as
// relic_matmul_wgmma_forward.
extern "C" int relic_matmul_gated_wgmma_forward(const void* x, const void* w_gate,
                                                const void* w_up, void* out, int out_bf16,
                                                int M, int N, int K, int bn, int act,
                                                void* stream) {
  if (bn != 128 && bn != 64) return -1;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tm_x, tm_g, tm_u;
  if (!encode(fn, &tm_x, x, M, K, BK, BM) || !encode(fn, &tm_g, w_gate, K, N, 64, BK) ||
      !encode(fn, &tm_u, w_up, K, N, 64, BK))
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64, true>(tm_x, tm_g, tm_u, out, out_bf16, M, N, K, act, s);
  return launch<128, true>(tm_x, tm_g, tm_u, out, out_bf16, M, N, K, act, s);
}
