// Fused SwiGLU expert FFN over MoE capacity blocks for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/moe_mlp/kernel.py
// (_expert_mlp_kernel, launched by expert_mlp_fwd).  Same function:
//
//   out[ge, c, :] = sum_f silu(x[ge,c] . wi[e,:,f]) * (x[ge,c] . wg[e,:,f])
//                         * wo[e, f, :],        e = ge % E,
//
// x (G E, C, D), wi/wg (E, D, F), wo (E, F, D), all contiguous, one dtype;
// h = silu(x wi) * (x wg) and the sums in f32; the output in x's dtype.
//
// What bounds it on this card.  A launch does 6 G E C D F flops and must
// read the expert weights (3 E D F values) once, plus x and out.  At the
// olmoe-1b-7b prefill shape (G=1, E=64, C=320, D=2048, F=1024, bf16) that
// is 258 GFLOP (0.26 ms at 989 TFLOP/s) against 0.97 GB (0.29 ms at
// 3.35 TB/s): bytes bound it, barely.  A decode step (G=4, C=1) is the
// weights alone: 0.81 GB, 0.24 ms.
//
// The design.
//  * The accumulator.  The TPU kernel walks d_ff tiles as a sequential
//    grid axis and carries a (128, D) f32 accumulator in VMEM: 1 MB at
//    D = 2048, more than the 227 KB of shared memory a block has.  Here
//    the loop order is turned around so that no (rows, D) accumulator
//    lives across the d_ff loop.  One block owns BC capacity rows of one
//    (group, expert) pair and
//      phase 1  computes h for ALL of d_ff, one 128-column tile at a
//               time, into shared memory in f32 ((BC, F): 128 KB at
//               BC = 32, F = 1024), then
//      phase 2  computes out = h wo one 128-column tile of D at a time,
//               each accumulated in registers over all of d_ff and
//               stored once.
//    h never reaches device memory, as on the TPU, and nothing is
//    recomputed.  All of d_ff fits shared memory up to F = 1152 at
//    BC = 32 and 2944 at BC = 16: olmoe-1b-7b's 1024 takes this one-pass
//    schedule.
//  * Large d_ff (mixtral-8x22b's 16384, jamba-v0.1-52b's 14336): the
//    split schedule.  The wrapper cuts d_ff into tiles of FT columns (at
//    most 1024) and the block runs phases 1 and 2 once per tile, h of one
//    tile in shared memory in f32.  Each tile's h wo goes into an f32
//    (G E, C, D) workspace that the wrapper allocates: the first tile
//    writes it, later tiles add to it (each thread reads back only what
//    it wrote), and the last tile adds its part and stores the output in
//    x's dtype.  So h and the partial sums stay f32 throughout, and the
//    output is rounded once, as in the one-pass schedule.  The workspace
//    costs 2 (F / FT - 1) passes over G E C D f32 values, which the
//    one-pass schedule does not make.
//  * Weight reads.  Each block streams its expert's weights once, so a
//    launch reads them G * ceil(C / BC) times.  The grid is laid out so
//    that the blocks of one expert are adjacent in launch order and run
//    together, and all but the first read of each tile come from L2:
//    device memory sees the weights about once per launch; L2 sees them
//    ten times at C = 320 and four times in a 4-slot decode step.
//  * Staging.  Tiles of x and the weights go through a ring of STAGES
//    shared-memory buffers filled with cp.async (16 bytes a thread),
//    STAGES - 1 steps ahead of the tensor cores.  Phase 1 and phase 2
//    steps run as one flat loop, so the first wo tiles load while the
//    last h tile is computed.
//  * Arithmetic.  bf16 inputs go through mma.sync m16n8k16 (bf16 x bf16
//    -> f32), fragments loaded with ldmatrix.  h stays f32, as in the TPU
//    kernel: for h wo each f32 value of h is split into three bf16 parts,
//    hi + mid + lo, which hold it exactly (24 significant bits in three
//    of 8), and the three products with the bf16 wo are exact in f32.
//    f32 inputs take exact f32 FMAs in a separate kernel (the f32
//    tolerance of 1e-4 excludes TF32).
//  * Ragged C.  Rows past C are loaded as zeros and never stored, so any
//    C >= 1 works (the Pallas kernel asserted C % block_c == 0).  Blocks
//    of 32 rows, or 16 when C <= 16 (decode), which then fit two to an SM.
//    D must be a multiple of 32 and F of 128 (the wrapper checks).
//
// Not yet: wgmma with TMA staging, skipping capacity tiles that hold no
// token, and one read of each expert's weights per decode step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block (8 warps)
constexpr int BN = 128;    // columns of an output tile: d_ff (1), D (2)
constexpr int BK = 32;     // reduction depth of a phase-1 step (over D)
constexpr int BK2 = 64;    // reduction depth of a phase-2 step (over d_ff)

struct Params {
  const void* x;
  const void* wi;
  const void* wg;
  const void* wo;
  void* out;
  float* ws;      // split schedule: f32 (G E, C, D) partial sums
  int g, e, c, d, f;
  int ft;         // d_ff columns per tile: f (one pass) or a divisor of f
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// The rows a block owns.  The grid is (G * ceil(C / bc), E): blockIdx.y
// is the expert, so the blocks that read one expert's weights are
// adjacent in launch order.
struct Tile {
  int ge, ex, c0, rows;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int bc) {
  const int ct = (p.c + bc - 1) / bc;
  Tile t;
  t.ex = blockIdx.y;
  t.ge = (blockIdx.x / ct) * p.e + t.ex;
  t.c0 = (blockIdx.x % ct) * bc;
  t.rows = min(bc, p.c - t.c0);
  return t;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int XS = BK + 8;    // row stride (bf16) of a staged x tile
constexpr int WS = BN + 8;    // row stride (bf16) of a staged weight tile
constexpr int HP = 8;         // f32 row padding of h (conflict-free float2)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (then
// nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 pair (a, b) as three bf16 pairs with hi + mid + lo == (a, b)
// exactly: each remainder is exact in f32 and holds 8 fewer significant
// bits than the one before, so the third fits bf16's 8.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float ra = v.x - hf.x, rb = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// Warps tile a block's BC rows x 128 columns as WM (16 rows each) x WN;
// each warp holds NJ 8-column mma tiles.  A stage holds the x tile and
// the wi and wg tiles of a phase-1 step; a phase-2 step's wo tile (BK2
// rows) takes the place of wi and wg.
template <int BC>
struct Bf16Tiling {
  static constexpr int WM = BC / 16, WN = 8 / WM, NJ = BN / (8 * WN);
  static constexpr int XTILE = BC * XS;
  static constexpr int STAGE = XTILE + 2 * BK * WS;
  static_assert(NJ % 2 == 0 && BK2 <= 2 * BK, "tiling");
};

// Shared memory of a block that holds h for ft columns of d_ff.
template <int BC, int STAGES>
constexpr size_t smem_bf16(int ft) {
  return (size_t)BC * (ft + HP) * sizeof(float) +
         (size_t)STAGES * Bf16Tiling<BC>::STAGE * sizeof(bf16);
}

// The epilogue of a split schedule's output tile: the f32 sum of the
// tiles so far, stored to the workspace, or to out after the last tile.
__device__ __forceinline__ void split_store(float* ws, bf16* out, size_t i,
                                            float a, float b, bool first,
                                            bool last) {
  if (!first) {
    const float2 w = *reinterpret_cast<const float2*>(ws + i);
    a += w.x;
    b += w.y;
  }
  if (last)
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(ws + i) = make_float2(a, b);
}

// SPLIT: d_ff is walked in tiles of p.ft columns, each with its own
// phases 1 and 2 (see the head of this file); otherwise p.ft == p.f and
// the block makes one pass.
template <int BC, int STAGES, int MIN_BLOCKS, bool SPLIT>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
moe_mlp_bf16_kernel(const Params p) {
  using T = Bf16Tiling<BC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.d, F = p.f, FT = SPLIT ? p.ft : p.f, HS = FT + HP;
  float* hs = reinterpret_cast<float*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(hs + (size_t)BC * HS);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int r0 = 16 * wm + g;                 // this thread's rows r0, r0+8
  const int ncol = wn * (T::NJ * 8);          // this warp's first column
  const Tile tl = tile_of(p, BC);

  const bf16* x = static_cast<const bf16*>(p.x) +
                  ((size_t)tl.ge * p.c + tl.c0) * D;
  const size_t wsz = (size_t)D * F;
  const bf16* wi = static_cast<const bf16*>(p.wi) + tl.ex * wsz;
  const bf16* wg = static_cast<const bf16*>(p.wg) + tl.ex * wsz;
  const bf16* wo = static_cast<const bf16*>(p.wo) + tl.ex * wsz;
  bf16* out = static_cast<bf16*>(p.out) + ((size_t)tl.ge * p.c + tl.c0) * D;
  float* wsum = SPLIT ? p.ws + ((size_t)tl.ge * p.c + tl.c0) * D : nullptr;

  // steps of one d_ff tile: phase 1 is (128 columns of h, k over D);
  // phase 2 (D tile, k over the tile's d_ff); SPLIT repeats them per tile
  const int nk1 = D / BK, n1 = (FT / BN) * nk1;
  const int nk2 = FT / BK2, per = n1 + ((D + BN - 1) / BN) * nk2;
  const int ntiles = F / FT, steps = ntiles * per;

  auto load = [&](int s) {
    if (s >= steps) return;
    bf16* xs = ring + (s % STAGES) * T::STAGE;
    bf16* ws = xs + T::XTILE;
    const int fb = SPLIT ? (s / per) * FT : 0, sl = SPLIT ? s % per : s;
    if (sl < n1) {
      const int f0 = fb + (sl / nk1) * BN, k0 = (sl % nk1) * BK;
      for (int i = t; i < BC * (BK / 8); i += NT) {
        const int r = i / (BK / 8), v = (i % (BK / 8)) * 8;
        const bool ok = r < tl.rows;
        cp_async16(xs + r * XS + v, ok ? x + (size_t)r * D + k0 + v : x, ok);
      }
      for (int i = t; i < BK * (BN / 8); i += NT) {
        const int r = i / (BN / 8), v = (i % (BN / 8)) * 8;
        const size_t off = (size_t)(k0 + r) * F + f0 + v;
        cp_async16(ws + r * WS + v, wi + off, true);
        cp_async16(ws + (BK + r) * WS + v, wg + off, true);
      }
    } else {
      const int s2 = sl - n1, d0 = (s2 / nk2) * BN;
      const int k0 = fb + (s2 % nk2) * BK2;
      for (int i = t; i < BK2 * (BN / 8); i += NT) {
        const int r = i / (BN / 8), v = (i % (BN / 8)) * 8;
        const bool ok = d0 + v < D;
        cp_async16(ws + r * WS + v,
                   ok ? wo + (size_t)(k0 + r) * D + d0 + v : wo, ok);
      }
    }
  };

  float acc[2][T::NJ][4];                     // phase 1: x wi, x wg
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();              // step s has landed ...
    __syncthreads();                          // ... for every thread, and
    load(s + STAGES - 1);                     // step s-1's buffer is free
    cp_async_commit();
    const bf16* xs = ring + (s % STAGES) * T::STAGE;
    const bf16* ws = xs + T::XTILE;
    const int lrow = lane & 15, lcol = (lane >> 4) * 8;
    const int ti = SPLIT ? s / per : 0, sl = SPLIT ? s % per : s;

    if (sl < n1) {
      // ---- phase 1: x wi and x wg for one (d_ff tile, k) step ----------
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, xs + (16 * wm + lrow) * XS + kk + lcol);
#pragma unroll
        for (int j = 0; j < T::NJ; j += 2) {
          const bf16* bp = ws + (kk + lrow) * WS + ncol + 8 * j + lcol;
          uint32_t bi[4], bg[4];
          ldsm_x4_t(bi, bp);
          ldsm_x4_t(bg, bp + BK * WS);
          mma_bf16(acc[0][j], a, bi[0], bi[1]);
          mma_bf16(acc[0][j + 1], a, bi[2], bi[3]);
          mma_bf16(acc[1][j], a, bg[0], bg[1]);
          mma_bf16(acc[1][j + 1], a, bg[2], bg[3]);
        }
      }
      if (sl % nk1 == nk1 - 1) {              // 128 columns of h are done
        const int f0 = (sl / nk1) * BN;
#pragma unroll
        for (int j = 0; j < T::NJ; ++j) {
          const int n = f0 + ncol + 8 * j + 2 * tig;
          *reinterpret_cast<float2*>(hs + r0 * HS + n) =
              make_float2(silu(acc[0][j][0]) * acc[1][j][0],
                          silu(acc[0][j][1]) * acc[1][j][1]);
          *reinterpret_cast<float2*>(hs + (r0 + 8) * HS + n) =
              make_float2(silu(acc[0][j][2]) * acc[1][j][2],
                          silu(acc[0][j][3]) * acc[1][j][3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[0][j][q] = acc[1][j][q] = 0.f;
        }
      }
    } else {
      // ---- phase 2: h wo for one (D tile, k) step, h split exactly ------
      const int s2 = sl - n1, k0 = (s2 % nk2) * BK2;
#pragma unroll
      for (int kk = 0; kk < BK2; kk += 16) {
        const float* hp = hs + r0 * HS + k0 + kk + 2 * tig;
        uint32_t hi[4], mid[4], lo[4];
        split3(*reinterpret_cast<const float2*>(hp), hi[0], mid[0], lo[0]);
        split3(*reinterpret_cast<const float2*>(hp + 8 * HS), hi[1], mid[1],
               lo[1]);
        split3(*reinterpret_cast<const float2*>(hp + 8), hi[2], mid[2],
               lo[2]);
        split3(*reinterpret_cast<const float2*>(hp + 8 * HS + 8), hi[3],
               mid[3], lo[3]);
#pragma unroll
        for (int j = 0; j < T::NJ; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, ws + (kk + lrow) * WS + ncol + 8 * j + lcol);
          mma_bf16(acc[0][j], lo, b[0], b[1]);
          mma_bf16(acc[0][j], mid, b[0], b[1]);
          mma_bf16(acc[0][j], hi, b[0], b[1]);
          mma_bf16(acc[0][j + 1], lo, b[2], b[3]);
          mma_bf16(acc[0][j + 1], mid, b[2], b[3]);
          mma_bf16(acc[0][j + 1], hi, b[2], b[3]);
        }
      }
      if (s2 % nk2 == nk2 - 1) {              // the output tile is done
        const int d0 = (s2 / nk2) * BN;
#pragma unroll
        for (int j = 0; j < T::NJ; ++j) {
          const int n = d0 + ncol + 8 * j + 2 * tig;
          if (n < D) {
            if constexpr (SPLIT) {
              const bool first = ti == 0, last = ti == ntiles - 1;
              if (r0 < tl.rows)
                split_store(wsum, out, (size_t)r0 * D + n, acc[0][j][0],
                            acc[0][j][1], first, last);
              if (r0 + 8 < tl.rows)
                split_store(wsum, out, (size_t)(r0 + 8) * D + n, acc[0][j][2],
                            acc[0][j][3], first, last);
            } else {
              if (r0 < tl.rows)
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * D + n) =
                    __floats2bfloat162_rn(acc[0][j][0], acc[0][j][1]);
              if (r0 + 8 < tl.rows)
                *reinterpret_cast<__nv_bfloat162*>(out +
                                                   (size_t)(r0 + 8) * D + n) =
                    __floats2bfloat162_rn(acc[0][j][2], acc[0][j][3]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[0][j][q] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// f32: exact FMAs
// ---------------------------------------------------------------------------

constexpr int BC32 = 16;        // rows per block
constexpr int HPAD32 = 4;       // f32 row padding of h

constexpr size_t smem_f32(int ft) {
  return (size_t)BC32 * (ft + HPAD32) * 4 +
         ((size_t)BC32 * BK + 2 * (size_t)BK * BN) * 4;
}

// Thread (ty, tx) of 2 x 128: column tx of each 128-column tile, rows
// 8 ty .. 8 ty + 7.  Same two phases as the bf16 kernel, with plain loads,
// once per d_ff tile of p.ft columns (SPLIT) or once for all of d_ff.
template <bool SPLIT>
__global__ void __launch_bounds__(NT) moe_mlp_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.d, F = p.f, FT = SPLIT ? p.ft : p.f, HS = FT + HPAD32;
  float* hs = reinterpret_cast<float*>(smem);
  float* xs = hs + (size_t)BC32 * HS;
  float* ws1 = xs + BC32 * BK;
  float* ws2 = ws1 + BK * BN;

  const int t = threadIdx.x, tx = t % BN, ty = t / BN;
  const Tile tl = tile_of(p, BC32);
  const float* x =
      static_cast<const float*>(p.x) + ((size_t)tl.ge * p.c + tl.c0) * D;
  const size_t wsz = (size_t)D * F;
  const float* wi = static_cast<const float*>(p.wi) + tl.ex * wsz;
  const float* wg = static_cast<const float*>(p.wg) + tl.ex * wsz;
  const float* wo = static_cast<const float*>(p.wo) + tl.ex * wsz;
  float* out = static_cast<float*>(p.out) + ((size_t)tl.ge * p.c + tl.c0) * D;
  float* wsum = SPLIT ? p.ws + ((size_t)tl.ge * p.c + tl.c0) * D : nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int fb = 0; fb < F; fb += FT) {
    for (int f0 = fb; f0 < fb + FT; f0 += BN) {
      float ai[8], ag[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) ai[r] = ag[r] = 0.f;
      for (int k0 = 0; k0 < D; k0 += BK) {
        for (int i = t; i < BC32 * (BK / 4); i += NT) {
          const int r = i / (BK / 4), s = (i % (BK / 4)) * 4;
          *reinterpret_cast<float4*>(xs + r * BK + s) =
              r < tl.rows ? *reinterpret_cast<const float4*>(
                                x + (size_t)r * D + k0 + s)
                          : zero;
        }
        for (int i = t; i < BK * (BN / 4); i += NT) {
          const int r = i / (BN / 4), s = (i % (BN / 4)) * 4;
          const size_t off = (size_t)(k0 + r) * F + f0 + s;
          *reinterpret_cast<float4*>(ws1 + r * BN + s) =
              *reinterpret_cast<const float4*>(wi + off);
          *reinterpret_cast<float4*>(ws2 + r * BN + s) =
              *reinterpret_cast<const float4*>(wg + off);
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          const float vi = ws1[k * BN + tx], vg = ws2[k * BN + tx];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float xv = xs[(8 * ty + r) * BK + k];
            ai[r] = fmaf(xv, vi, ai[r]);
            ag[r] = fmaf(xv, vg, ag[r]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        hs[(8 * ty + r) * HS + f0 - fb + tx] = silu(ai[r]) * ag[r];
    }
    __syncthreads();

    for (int d0 = 0; d0 < D; d0 += BN) {
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;
      for (int k0 = 0; k0 < FT; k0 += BK) {
        for (int i = t; i < BK * (BN / 4); i += NT) {
          const int r = i / (BN / 4), s = (i % (BN / 4)) * 4;
          *reinterpret_cast<float4*>(ws1 + r * BN + s) =
              d0 + s < D ? *reinterpret_cast<const float4*>(
                               wo + (size_t)(fb + k0 + r) * D + d0 + s)
                         : zero;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          const float w = ws1[k * BN + tx];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[r] = fmaf(hs[(8 * ty + r) * HS + k0 + k], w, acc[r]);
        }
        __syncthreads();
      }
      const int n = d0 + tx;
      if (n < D)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (8 * ty + r < tl.rows) {
            const size_t i = (size_t)(8 * ty + r) * D + n;
            if constexpr (SPLIT) {
              // the f32 sum of the tiles so far: to the workspace, or to
              // out after the last tile
              const float v = fb == 0 ? acc[r] : acc[r] + wsum[i];
              if (fb + FT == F)
                out[i] = v;
              else
                wsum[i] = v;
            } else {
              out[i] = acc[r];
            }
          }
    }
  }  // d_ff tiles
}

template <typename K>
cudaError_t launch(K kernel, const Params& p, int bc, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.g * ((p.c + bc - 1) / bc), p.e);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The shared memory a block needs (bytes) when it holds h for ft columns
// of d_ff, so that the wrapper can choose the schedule: one pass when
// ft = f fits, else the split schedule.  dtype: 0 = float32, 1 = bfloat16.
extern "C" long long moe_mlp_smem_bytes(int dtype, int c, int ft) {
  if (dtype == 0) return static_cast<long long>(smem_f32(ft));
  return static_cast<long long>(c <= 16 ? smem_bf16<16, 2>(ft)
                                        : smem_bf16<32, 4>(ft));
}

// x (g e, c, d), wi/wg (e, d, f), wo (e, f, d), out (g e, c, d); all
// contiguous, one dtype (0 = float32, 1 = bfloat16).  Needs d % 32 == 0
// and f % 128 == 0.  ft == f runs the one-pass schedule; a proper divisor
// ft of f (a multiple of 128) runs the split schedule, which needs ws, an
// f32 (g e, c, d) workspace.  `device` is the index of the card the
// tensors and `stream` belong to (this library links its own CUDA
// runtime, whose current device is not the caller's).  Returns the CUDA
// error of the launch (0 = cudaSuccess); the launch is asynchronous on
// `stream` and allocates nothing.
extern "C" int moe_mlp_fwd(const void* x, const void* wi, const void* wg,
                           const void* wo, void* out, float* ws, int dtype,
                           int g, int e, int c, int d, int f, int ft,
                           int device, void* stream) {
  const bool split = ft != f;
  if (g < 1 || e < 1 || c < 1 || d < BK || f < BN || d % BK != 0 ||
      f % BN != 0 || ft < BN || ft % BN != 0 || f % ft != 0 ||
      (split && ws == nullptr) || e > 65535 ||
      (long long)g * ((c + 15) / 16) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const Params p{x, wi, wg, wo, out, ws, g, e, c, d, f, ft};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(moe_mlp_smem_bytes(dtype, c, ft));
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      err = split ? launch(moe_mlp_f32_kernel<true>, p, BC32, smem, st)
                  : launch(moe_mlp_f32_kernel<false>, p, BC32, smem, st);
      break;
    case 1:
      if (c <= 16)
        err = split
                  ? launch(moe_mlp_bf16_kernel<16, 2, 2, true>, p, 16, smem, st)
                  : launch(moe_mlp_bf16_kernel<16, 2, 2, false>, p, 16, smem,
                           st);
      else
        err = split
                  ? launch(moe_mlp_bf16_kernel<32, 4, 1, true>, p, 32, smem, st)
                  : launch(moe_mlp_bf16_kernel<32, 4, 1, false>, p, 32, smem,
                           st);
      break;
  }
  return static_cast<int>(err);
}
