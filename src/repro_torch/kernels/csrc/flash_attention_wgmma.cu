// Flash attention forward (GQA, optional causal) for Hopper, sm_90a: the bf16,
// head_dim 64 design on TMA and wgmma.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fa_kernel / flash_attention_bhsd). Computes
//   o = softmax(q k^T * D^-0.5  [causal mask qpos >= kpos, else -1e30]) v
// with query head h reading kv head h / (H / Hkv), output in bf16.
//
// What bounds it on the H100: operations. Causal attention at the models'
// widths does about 4 * S^2/2 * D flops per head against 8 * S * D bytes, far
// above the card's 295 flop/byte ridge in bf16, so the time goes to the two
// products, and only the tensor cores (wgmma) reach their rate.
//
// Design:
//  - A work item is one (128-row q tile, head, batch). The kernel is
//    persistent: one CTA per SM walks its share of the items, heaviest
//    first (causal items with more kv tiles before lighter ones), so one
//    item's epilogue and the next one's first loads overlap, and no CTA
//    start-up sits between them.
//  - A CTA is a producer warpgroup and two consumer warpgroups of 64 q rows
//    each (384 threads). The producer gives up its registers (setmaxnreg)
//    to the consumers. The two consumers fall out of step by themselves, so
//    one's softmax runs while the other's products use the tensor cores.
//  - One producer thread loads each item's q tile once (as soon as both
//    consumers have finished their last product with the previous one),
//    and keeps K and V tiles of 128 kv rows in flight by TMA
//    (cp.async.bulk.tensor) into a ring of STAGES stages, each with `full`
//    mbarriers (K, V) and an `empty` one that both consumers release; the
//    ring runs on across items. Tiles are 128-byte swizzled: at D = 64 a
//    bf16 row is exactly 128 bytes.
//  - The tensor maps are 4-D (D, H, S, B) over the caller's own byte
//    strides, so [B, S, H, D] (the models' layout) and [B, H, S, D] load with
//    no copy; a box never crosses a head, the hardware zero-fills rows past
//    S, and the kernel masks them to -1e30. The output goes out through its
//    own shared tile by a TMA store in the caller's layout, which drops rows
//    past Sq.
//  - S = Q K^T: wgmma m64n128k16 from shared memory (K stored [kv][D] is the
//    K-major B operand). The online softmax (m, l) stays in registers; the
//    row max is taken on the raw scores and reduced over the 4 lanes that
//    share a row, then p = exp2(s * scale * log2 e - m * scale * log2 e) is
//    one FFMA and one exp2 per score.
//  - O += P V: wgmma m64n64k16 with P from registers: the S accumulator's
//    fragments are rounded to bf16 pairs in place, with no trip through
//    shared memory. V is the MN-major B operand (transpose bit).
//    Unlike the TPU kernel, which keeps P in f32 for this product
//    (flash_attention.py:58), P is rounded to bf16 here; l sums the f32 p.
//  - Causal: kv tiles wholly above the diagonal are never loaded, and only
//    tiles that cross it (or the ragged end of S) are masked.
//  - Shared memory: q and o tiles (16 KB each) and STAGES x (K, V) (32 KB
//    each), 97 KB at two stages. Registers, not shared memory, hold a CTA to
//    one per SM: 168 a thread at launch.
//
// C interface (bound with ctypes): fa_wgmma_forward returns
// cudaGetLastError() after the launch, or a negative code for a failure
// before it (see the end of the file).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;            // head_dim: one 128-byte bf16 row
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup
constexpr int BQ = CONSUMERS * WG_ROWS;          // q rows per CTA
constexpr int BK = 128;          // kv rows per tile
constexpr int STAGES = 2;        // kv ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);   // producer warpgroup + consumers
constexpr int Q_BYTES = BQ * D * 2;              // the q tile
constexpr int TILE_BYTES = BK * D * 2;           // one K or V tile: 16 KB
constexpr int N_BARS = 2 + 3 * STAGES;   // q_full, q_empty, k_full[], v_full[], empty[]
constexpr size_t SMEM_BYTES = 1024 /* alignment slack */ + 2 * Q_BYTES /* q, o */ +
                              (size_t)TILE_BYTES * 2 * STAGES + 8 * N_BARS;
// Registers: the launch gives every thread 65536 / THREADS (a multiple of
// 8); the producer drops to 24 and hands the rest to the consumers.
constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
constexpr int CONSUMER_REGS = ((LAUNCH_REGS * THREADS - 24 * 128) / (128 * CONSUMERS)) / 8 * 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ <= 256 && CONSUMER_REGS <= 256, "one TMA box, setmaxnreg range");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o,
                int B, int H, int Hkv, int Sq, int Sk, float scale_log2,
                int causal) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = base;
  uint8_t* o_tile = base + Q_BYTES;
  auto k_tile = [&](int s) { return base + 2 * Q_BYTES + TILE_BYTES * 2 * s; };
  auto v_tile = [&](int s) { return base + 2 * Q_BYTES + TILE_BYTES * (2 * s + 1); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * Q_BYTES + TILE_BYTES * 2 * STAGES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = bars + 2 + STAGES;
  uint64_t* empty = bars + 2 + 2 * STAGES;

  // Work items, heaviest first: the last q tile of every (b, h), then the
  // second-to-last, ...; CTA i takes items i, 2G-1-i, 2G+i, ... (a snake over
  // rounds of G = gridDim.x), so every CTA gets a like share of heavy items.
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_items = n_qt * B * H;
  const int G = gridDim.x;
  auto item_of = [&](int r) {
    return r * G + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  struct Work { int h, b, hk, q0, n_tiles; };
  auto work_of = [&](int item) {
    Work w;
    const int bh = item % (B * H);
    const int qt = n_qt - 1 - item / (B * H);
    w.h = bh % H;
    w.b = bh / H;
    w.hk = w.h / (H / Hkv);
    w.q0 = qt * BQ;
    const int k_end = causal ? min(Sk, w.q0 + BQ) : Sk;
    w.n_tiles = (k_end + BK - 1) / BK;
    return w;
  };

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tm_q);
    prefetch_tensormap(&tm_k);
    prefetch_tensormap(&tm_v);
    prefetch_tensormap(&tm_o);
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load --------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv_it = 0;
      for (int r = 0; item_of(r) < n_items; ++r) {
        const Work w = work_of(item_of(r));
        mbar_wait(q_empty, (r & 1) ^ 1);   // the consumers are done with the last q
        mbar_arrive_expect_tx(q_full, Q_BYTES);
        tma_load_4d(q_tile, &tm_q, q_full, 0, w.h, w.q0, w.b);
        for (int it = 0; it < w.n_tiles; ++it, ++kv_it) {
          const int s = kv_it % STAGES;
          mbar_wait(empty + s, ((kv_it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(k_full + s, TILE_BYTES);
          tma_load_4d(k_tile(s), &tm_k, k_full + s, 0, w.hk, it * BK, w.b);
          mbar_arrive_expect_tx(v_full + s, TILE_BYTES);
          tma_load_4d(v_tile(s), &tm_v, v_full + s, 0, w.hk, it * BK, w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows per warpgroup -----------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_in_wg = 16 * warp + lane / 4;     // and row_in_wg + 8
  const int col = 2 * (lane % 4);                 // within each 8-column block
  const uint64_t desc_q = desc_sw128(q_tile + c * WG_ROWS * D * 2, 16, 1024);
  uint8_t* o_part = o_tile + c * WG_ROWS * D * 2;

  int kv_it = 0;
  for (int r = 0; item_of(r) < n_items; ++r) {
    const Work w = work_of(item_of(r));
    const int wg_q0 = w.q0 + c * WG_ROWS;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};   // this thread's share of each row's sum

    mbar_wait(q_full, r & 1);
    for (int it = 0; it < w.n_tiles; ++it, ++kv_it) {
      const int s = kv_it % STAGES;
      const uint32_t parity = (kv_it / STAGES) & 1;
      const int k0 = it * BK;

      // S = Q K^T over D = 64: four k16 steps, 32 bytes apart in the swizzled rows.
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      const uint64_t desc_k = desc_sw128(k_tile(s), 16, 1024);
      mbar_wait(k_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(sc, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // The last product that reads q: the producer may load the next one.
      if (it == w.n_tiles - 1 && tid == 0) mbar_arrive(q_empty);

      // Masked where the tile crosses the diagonal or the end of S.
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_q0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_q0 + row_in_wg + 8 * i;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (masked) {
              const int kpos = k0 + 8 * j + col + e;
              if (kpos >= Sk || (causal && kpos > qpos)) sc[4 * j + 2 * i + e] = NEG;
            }
            mx = fmaxf(mx, sc[4 * j + 2 * i + e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float corr = ex2((m[i] - m_new) * scale_log2);
        m[i] = m_new;
        const float mb = m_new * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(sc[4 * j + 2 * i + e], scale_log2, -mb));
            sc[4 * j + 2 * i + e] = p;
            sum += p;
          }
        }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j + 2 * i] *= corr;
          o[4 * j + 2 * i + 1] *= corr;
        }
      }

      // P as bf16 A fragments: k16 step kk takes column blocks 2kk and 2kk+1.
      uint32_t pa[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V over 128 kv rows: eight k16 steps of 16 rows (2048 bytes).
      const uint64_t desc_v = desc_sw128(v_tile(s), 1024, 1024);
      mbar_wait(v_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64k16_rs_tb(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                              pa[4 * kk + 3], desc_v + (2048 >> 4) * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(empty + s);
    }

    // ---- epilogue: O / l in bf16 through this warpgroup's part of the o
    // tile, out by one TMA store; the next item's loads run meanwhile.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[i] = 1.f / sum;
    }
    named_barrier(1 + c, 128);   // the last item's store has read the o tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_in_wg + 8 * i;
        uint32_t off = row * (D * 2) + (8 * j + col) * 2;
        off ^= (row & 7) << 4;   // the 128-byte swizzle TMA reads back
        *reinterpret_cast<uint32_t*>(o_part + off) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (tid == 0) {
      tma_store_4d(&tm_o, o_part, 0, w.h, wg_q0, w.b);
      tma_store_commit_and_wait();
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

// geom: dims (D, H, S, B) then byte strides of H, S, B, as computed by
// flash_attention.tma_geometry; box_s rows of S per box.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
            const int64_t* geom, uint32_t box_s) {
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)geom[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)geom[4 + i];
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, box_s, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q [B, H, Sq, 64], k/v [B, Hkv, Sk, 64], o like q, all bf16 in any layout
// whose last dim is contiguous and other strides are multiples of 16 bytes;
// geom holds 7 int64 per tensor (q, k, v, o). Returns 0 or cudaGetLastError()
// after the launch; -2 if cuTensorMapEncodeTiled cannot be found, -3 - i if
// the map of tensor i (q, k, v, o) cannot be encoded.
extern "C" int fa_wgmma_forward(const void* q, const void* k, const void* v, void* o,
                                const int64_t* geom, int B, int H, int Hkv, int Sq,
                                int Sk, float scale, int causal, void* stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const uint32_t box_s[4] = {BQ, BK, BK, WG_ROWS};
  for (int i = 0; i < 4; ++i)
    if (!encode(fn, &maps[i], ptrs[i], geom + 7 * i, box_s[i])) return -3 - i;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_items = (Sq + BQ - 1) / BQ * B * H;
  fa_wgmma_kernel<<<n_items < n_sm ? n_items : n_sm, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], B, H, Hkv, Sq, Sk, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}
