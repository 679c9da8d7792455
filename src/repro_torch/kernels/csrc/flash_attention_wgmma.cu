// Flash attention forward (GQA, optional causal) for Hopper, sm_90a: the bf16
// design on TMA and wgmma, at head_dim 64, 96, 128, 224 and 256 (one
// template, five instances).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fa_kernel / flash_attention_bhsd). Computes
//   o = softmax(q k^T * scale  [causal mask qpos >= kpos, else -1e30]) v
// with query head h reading kv head h / (H / Hkv), output in bf16; the
// caller gives the scale (D^-0.5 by default, (D/2)^-0.5 in Zamba2's shared
// blocks), which the kernel applies in f32 to the f32 scores.
//
// What bounds it on the H100: operations. Causal attention at the models'
// widths does about 4 * S^2/2 * D flops per head against 8 * S * D bytes, far
// above the card's 295 flop/byte ridge in bf16, so the time goes to the two
// products, and only the tensor cores (wgmma) reach their rate. (At the
// served shapes, S = 192, it is bound by bytes, and the time goes to the
// loads and the launch.)
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
//    ring runs on across items.
//  - Tiles are 128-byte swizzled, and a swizzled row holds 64 bf16: a tile
//    of R rows is ceil(D / 64) atoms of [R rows x 128 bytes], one after the
//    other, each 1024-byte aligned and each loaded (and the output stored)
//    by a TMA box of its own at column 0, 64, 128 or 192. At D = 64 a tile
//    is one atom, at D = 256 four.
//  - D = 96 (phi3_mini) is two atoms, the second half filled: the tensor
//    maps' D extent is 96, so the box at column 64 reads columns 96..127
//    out of bounds, which TMA writes as zeros (and still counts in the
//    barrier's bytes), and the store of O drops them. Q K^T runs 6 k16
//    steps; P V runs at n96 (wgmma m64n96k16), whose MN-major V spans
//    the first atom and the first half of the second. That keeps the D =
//    128 layout and maps (no second swizzle mode, as a 64-column atom
//    beside a 32-column one in a 64-byte swizzle would need). P V at n128
//    over the zeroed columns, which was held to the plain version first,
//    is slower; flash_d96_ab.py at the repository root times the two.
//  - D = 256 (paligemma) does not fit the D = 128 layout: q and o tiles of
//    64 KB each and K plus V at 128 kv rows (128 KB a stage) exceed the
//    232,448 bytes a block may use, and O alone is 128 f32 registers a
//    consumer thread. So K and V tiles are 64 kv rows (BK = 64; S is 32
//    registers, P 16 words), two stages (128 KB) beside the q tile (64
//    KB), and O goes out through the q tile's own buffer: each consumer
//    writes its O rows over its own q rows once its last Q K^T has read
//    them, and only after the TMA store has read them back does it release
//    the q tile to the producer. With one item a CTA at both served shapes
//    nothing is lost by the producer's wait; between items it costs the q
//    load's latency. Splitting O's columns over two consumer warpgroups
//    that share a q row block was the other route: it halves the
//    accumulator but computes S = Q K^T twice, once in each warpgroup.
//  - D = 224 (Zamba2-7B's shared blocks) is the D = 256 layout with its
//    fourth atom half filled, as D = 96 fills its second: the maps' D
//    extent is 224, so the boxes at column 192 read columns 224..255 as
//    TMA's out-of-bounds zeros and the store of O drops them. Q K^T runs 14
//    k16 steps (the last two in the fourth atom's first half); P V runs at
//    n224 (wgmma m64n224k16), whose MN-major V spans three atoms and half a
//    fourth. O is 112 f32 registers a consumer thread; ptxas gives the
//    instance 168 registers a thread at launch and no spills, as the others.
//  - The tensor maps are 4-D (D, H, S, B) over the caller's own byte
//    strides, so [B, S, H, D] (the models' layout) and [B, H, S, D] load with
//    no copy; a box never crosses a head, the hardware zero-fills rows past
//    S, and the kernel masks them to -1e30. The output goes out through its
//    own shared tile by TMA stores in the caller's layout, which drop rows
//    past Sq.
//  - S = Q K^T: wgmma m64n128k16 (m64n64k16 at D = 224 and 256) from shared memory
//    (K stored [kv][D] is the K-major B operand); the k16 steps advance 32
//    bytes inside an atom and move to the next atom's base after four. The
//    online softmax (m, l) stays in registers; the row max is taken on the
//    raw scores and reduced over the 4 lanes that share a row, then p =
//    exp2(s * scale * log2 e - m * scale * log2 e) is one FFMA and one exp2
//    per score.
//  - O += P V: wgmma m64nDk16 with P from registers: the S accumulator's
//    fragments are rounded to bf16 pairs in place, with no trip through
//    shared memory. V is the MN-major B operand (transpose bit); above
//    D = 64 it spans several atoms, a tile's bytes apart (the descriptor's
//    LBO).
//    The TPU kernel keeps P in f32 for this product (flash_attention.py:58).
//    At D = 64, 96, 224 and 256 P is rounded to bf16 (2^-9), which every
//    path at those sizes (dense, hybrid, encoder-decoder, the VLM's text,
//    Zamba2-7B's shared blocks) holds its bars with. At D = 128 P goes in as two bf16 terms, hi = bf16(p)
//    and lo = bf16(p - hi), in two wgmmas a k16 step: p to about 2^-17, for
//    1.5x the tensor work. The D = 128 paths include the MoE families, whose
//    routers are not continuous: on an H100 with bf16 P, arctic_480b's
//    one-layer forward at [8, 192] took other routes and drops and its
//    logits lay 4.53 from the plain forward's (0.03 with f32 P). l sums the
//    f32 p.
//  - Causal: kv tiles wholly above the diagonal are never loaded, and only
//    tiles that cross it (or the ragged end of S) are masked.
//  - Shared memory: q and o tiles (BQ x 64 x atoms each; one tile for both
//    at D = 224 and 256) and STAGES x (K, V) (BK x 64 x atoms each): 97 KB
//    at D = 64, 193 KB at D = 96, 128, 224 and 256. Registers, not shared memory,
//    hold a CTA to one per SM: 168 a thread at launch, 240 for a consumer
//    (O is D / 2 floats a thread, S BK / 2, P BK / 4 words, twice that at
//    D = 128).
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

constexpr int ATOM = 64;         // bf16 columns of a 128-byte swizzled row
constexpr int ATOM_ROW = 128;    // bytes of that row
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup
constexpr int BQ = CONSUMERS * WG_ROWS;          // q rows per CTA
constexpr int STAGES = 2;        // kv ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);   // producer warpgroup + consumers
constexpr int Q_ATOM = BQ * ATOM_ROW;            // one atom of the q (or o) tile
constexpr int N_BARS = 2 + 3 * STAGES;   // q_full, q_empty, k_full[], v_full[], empty[]
// Registers: the launch gives every thread 65536 / THREADS (a multiple of
// 8); the producer drops to 24 and hands the rest to the consumers.
constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
constexpr int CONSUMER_REGS = ((LAUNCH_REGS * THREADS - 24 * 128) / (128 * CONSUMERS)) / 8 * 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ <= 256 && CONSUMER_REGS <= 256, "one TMA box, setmaxnreg range");

// The tiles of the instance at head_dim D, ceil(D / 64) atoms each.
template <int D>
struct Tiles {
  static_assert(D == 64 || D == 96 || D == 128 || D == 224 || D == 256,
                "an instance at head_dim 64, 96, 128, 224 or 256");
  static constexpr int ATOMS = (D + ATOM - 1) / ATOM;
  static constexpr int BK = ATOMS == 4 ? 64 : 128;   // kv rows per tile
  static constexpr int KV_ATOM = BK * ATOM_ROW;      // one atom of a K or V tile
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;     // the q tile; the o tile alike
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;   // one K or V tile
  static constexpr bool P_HI_LO = D == 128;          // P as two bf16 terms
  static constexpr bool O_IN_Q = ATOMS == 4;         // O goes out through the q tile
  static constexpr size_t SMEM_BYTES = 1024 /* alignment slack */ +
                                       (O_IN_Q ? 1 : 2) * Q_BYTES /* q, o */ +
                                       (size_t)KV_BYTES * 2 * STAGES + 8 * N_BARS;
  static_assert(BK <= 256 && SMEM_BYTES <= 232448, "one TMA box, a block's shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What rounding (lo, hi) to the bf16 pair `packed` left, as a bf16 pair
// (the differences are exact in f32).
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  return pack_bf16(lo - __uint_as_float(packed << 16),
                   hi - __uint_as_float(packed & 0xffff0000u));
}

// S[64 x BK] (+)= Q[64 x 16] K[BK x 16]^T, both from shared memory.
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&sc)[Tiles<D>::BK / 2], uint64_t desc_q,
                                         uint64_t desc_k, int accumulate) {
  if constexpr (Tiles<D>::BK == 128)
    wgmma_m64n128k16_ss(sc, desc_q, desc_k, accumulate);
  else
    wgmma_m64n64k16_ss(sc, desc_q, desc_k, accumulate);
}

// O[64 x D] += P[64 x 16] V[16 x D]: P from registers, V MN-major.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_v) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);
  else if constexpr (D == 96)
    wgmma_m64n96k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);
  else if constexpr (D == 128)
    wgmma_m64n128k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);
  else if constexpr (D == 224)
    wgmma_m64n224k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);
  else
    wgmma_m64n256k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o,
                int B, int H, int Hkv, int Sq, int Sk, float scale_log2,
                int causal) {
  using T = Tiles<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int QO_BYTES = (T::O_IN_Q ? 1 : 2) * T::Q_BYTES;
  uint8_t* q_tile = base;
  uint8_t* o_tile = T::O_IN_Q ? base : base + T::Q_BYTES;
  auto k_tile = [&](int s) { return base + QO_BYTES + T::KV_BYTES * 2 * s; };
  auto v_tile = [&](int s) { return base + QO_BYTES + T::KV_BYTES * (2 * s + 1); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + QO_BYTES + T::KV_BYTES * 2 * STAGES);
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
    // ---- producer: one thread issues every load, one box per atom --------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv_it = 0;
      for (int r = 0; item_of(r) < n_items; ++r) {
        const Work w = work_of(item_of(r));
        mbar_wait(q_empty, (r & 1) ^ 1);   // the consumers are done with the last q
        mbar_arrive_expect_tx(q_full, T::Q_BYTES);
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load_4d(q_tile + a * Q_ATOM, &tm_q, q_full, ATOM * a, w.h, w.q0, w.b);
        for (int it = 0; it < w.n_tiles; ++it, ++kv_it) {
          const int s = kv_it % STAGES;
          mbar_wait(empty + s, ((kv_it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(k_full + s, T::KV_BYTES);
          for (int a = 0; a < T::ATOMS; ++a)
            tma_load_4d(k_tile(s) + a * T::KV_ATOM, &tm_k, k_full + s, ATOM * a, w.hk,
                        it * BK, w.b);
          mbar_arrive_expect_tx(v_full + s, T::KV_BYTES);
          for (int a = 0; a < T::ATOMS; ++a)
            tma_load_4d(v_tile(s) + a * T::KV_ATOM, &tm_v, v_full + s, ATOM * a, w.hk,
                        it * BK, w.b);
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
  // This warpgroup's rows of the q tile's first atom; the others lie
  // Q_ATOM bytes on (a descriptor counts 16-byte units).
  const uint64_t desc_q = desc_sw128(q_tile + c * WG_ROWS * ATOM_ROW, 16, 1024);

  int kv_it = 0;
  for (int r = 0; item_of(r) < n_items; ++r) {
    const Work w = work_of(item_of(r));
    const int wg_q0 = w.q0 + c * WG_ROWS;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};   // this thread's share of each row's sum

    mbar_wait(q_full, r & 1);
    for (int it = 0; it < w.n_tiles; ++it, ++kv_it) {
      const int s = kv_it % STAGES;
      const uint32_t parity = (kv_it / STAGES) & 1;
      const int k0 = it * BK;

      // S = Q K^T over D: k16 steps 32 bytes apart in the swizzled rows of
      // an atom, four to an atom.
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      const uint64_t desc_k = desc_sw128(k_tile(s), 16, 1024);
      mbar_wait(k_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int step = 2 * (kk % 4);
        wgmma_qk<D>(sc, desc_q + (Q_ATOM >> 4) * (kk / 4) + step,
                    desc_k + (T::KV_ATOM >> 4) * (kk / 4) + step, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // The last product that reads q: the producer may load the next one
      // (with O_IN_Q once O has gone out through it).
      if (!T::O_IN_Q && it == w.n_tiles - 1 && tid == 0) mbar_arrive(q_empty);

      // Masked where the tile crosses the diagonal or the end of S.
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_q0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_q0 + row_in_wg + 8 * i;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
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
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(sc[4 * j + 2 * i + e], scale_log2, -mb));
            sc[4 * j + 2 * i + e] = p;
            sum += p;
          }
        }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * i] *= corr;
          o[4 * j + 2 * i + 1] *= corr;
        }
      }

      // P as bf16 A fragments: k16 step kk takes column blocks 2kk and 2kk+1;
      // with P_HI_LO, pl holds what that rounding left.
      uint32_t pa[BK / 4], pl[T::P_HI_LO ? BK / 4 : 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
          pa[4 * kk + e] = pack_bf16(x0, x1);
          if constexpr (T::P_HI_LO) pl[4 * kk + e] = pack_bf16_rest(x0, x1, pa[4 * kk + e]);
        }
      }

      // O += P V over BK kv rows: k16 steps of 16 rows (2048 bytes); the V
      // tile's atoms lie KV_ATOM bytes apart along D (LBO).
      const uint64_t desc_v = desc_sw128(v_tile(s), T::KV_ATOM, 1024);
      mbar_wait(v_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_pv<D>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                    desc_v + (2048 >> 4) * kk);
        if constexpr (T::P_HI_LO)
          wgmma_pv<D>(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3],
                      desc_v + (2048 >> 4) * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if constexpr (T::P_HI_LO) fence_regs(pl);
      if (tid == 0) mbar_arrive(empty + s);
    }

    // ---- epilogue: O / l in bf16 through this warpgroup's rows of the o
    // tile's atoms (with O_IN_Q its own rows of the q tile), out by one TMA
    // store per atom; the next item's kv loads run meanwhile.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[i] = 1.f / sum;
    }
    uint8_t* o_part = o_tile + c * WG_ROWS * ATOM_ROW;
    named_barrier(1 + c, 128);   // the last item's stores have read the o tile
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_in_wg + 8 * i;
        uint32_t off = row * ATOM_ROW + (8 * (j % 8) + col) * 2;
        off ^= (row & 7) << 4;   // the 128-byte swizzle TMA reads back
        *reinterpret_cast<uint32_t*>(o_part + (j / 8) * Q_ATOM + off) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_store_4d(&tm_o, o_part + a * Q_ATOM, ATOM * a, w.h, wg_q0, w.b);
      tma_store_commit_and_wait();
      if constexpr (T::O_IN_Q) mbar_arrive(q_empty);   // the store has read O
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
// flash_attention.tma_geometry; a box is one atom wide (64 columns, the
// 128-byte swizzle's limit) and box_s rows of S tall.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
            const int64_t* geom, uint32_t box_s) {
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)geom[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)geom[4 + i];
  const cuuint32_t box[4] = {(cuuint32_t)ATOM, 1, box_s, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
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

// The instance at head_dim D: its tensor maps (K and V boxes BK rows tall)
// and its launch; its shared-memory attribute is set once per instance.
template <int D>
int launch(EncodeTiledFn fn, const void* const (&ptrs)[4], const int64_t* geom, int B,
           int H, int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const uint32_t box_s[4] = {BQ, Tiles<D>::BK, Tiles<D>::BK, WG_ROWS};
  for (int i = 0; i < 4; ++i)
    if (!encode(fn, &maps[i], ptrs[i], geom + 7 * i, box_s[i])) return -3 - i;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(fa_wgmma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Tiles<D>::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int sms = n_sms();
  if (sms == 0) return -7;
  const int n_items = (Sq + BQ - 1) / BQ * B * H;
  fa_wgmma_kernel<D><<<n_items < sms ? n_items : sms, THREADS, Tiles<D>::SMEM_BYTES,
                       stream>>>(maps[0], maps[1], maps[2], maps[3], B, H, Hkv, Sq, Sk,
                                 scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, d], k/v [B, Hkv, Sk, d], o like q, d = 64, 96, 128, 224 or 256, all bf16 in
// any layout whose last dim is contiguous and other strides are multiples of
// 16 bytes; geom holds 7 int64 per tensor (q, k, v, o). Returns 0 or
// cudaGetLastError() after the launch; -1 for a d it has no instance for, -2
// if cuTensorMapEncodeTiled cannot be found, -3 - i if the map of tensor i
// (q, k, v, o) cannot be encoded, -7 if the SM count cannot be read.
extern "C" int fa_wgmma_forward(const void* q, const void* k, const void* v, void* o,
                                const int64_t* geom, int B, int H, int Hkv, int Sq,
                                int Sk, int d, float scale, int causal, void* stream) {
  if (d != 64 && d != 96 && d != 128 && d != 224 && d != 256) return -1;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  const void* const ptrs[4] = {q, k, v, o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(fn, ptrs, geom, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 96: return launch<96>(fn, ptrs, geom, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 128: return launch<128>(fn, ptrs, geom, B, H, Hkv, Sq, Sk, scale, causal, s);
    case 224: return launch<224>(fn, ptrs, geom, B, H, Hkv, Sq, Sk, scale, causal, s);
    default: return launch<256>(fn, ptrs, geom, B, H, Hkv, Sq, Sk, scale, causal, s);
  }
}
