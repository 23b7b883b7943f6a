// Fused SwiGLU expert FFN over MoE capacity blocks for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/moe_mlp/kernel.py
// (_expert_mlp_kernel, launched by expert_mlp_fwd).  Same function:
//
//   out[g, e, c, :] = sum_f silu(x[g,e,c] . wi[e,:,f]) * (x[g,e,c] . wg[e,:,f])
//                          * wo[e, f, :],
//
// x (G, E, C, D), wi/wg (E, D, F), wo (E, F, D), all contiguous, one
// dtype; h = silu(x wi) * (x wg) and the sums in f32; the output in x's
// dtype, rounded once.
//
// What bounds it on this card.  A launch does 6 G E C D F flops and must
// read the expert weights (3 E D F values) once, plus x and out.  At the
// olmoe-1b-7b prefill shape (G=1, E=64, C=320, D=2048, F=1024, bf16) that
// is 258 GFLOP (0.26 ms at 989 TFLOP/s) against 0.97 GB (0.29 ms at
// 3.35 TB/s): bytes bound it, barely.  A decode step (G=4, C=1) is the
// weights alone: 0.81 GB, 0.24 ms.
//
// bf16: two wgmma GEMMs per expert (moe_mlp_up_kernel,
// moe_mlp_down_kernel).
//  * Why not one fused pass.  The first version held h for all of d_ff
//    in shared memory, which caps a block at 32 capacity rows; every
//    block then streams its expert's 12.6 MB of weights for 32 rows (32
//    flops per weight byte, where the tensor cores want ~300), so ten
//    blocks per expert at C = 320 move ~8 GB through L2 and a block's
//    own pace (16 mma.sync per barrier) set the time.  Here the rows of
//    an expert form the M dimension of two GEMMs: the up GEMM x [wi | wg]
//    with the SwiGLU in its epilogue, and the down GEMM h wo.  h (E, G C,
//    F) goes to device memory between them, in three bf16 parts (below):
//    126 MB written and 126 MB read back at olmoe's prefill (0.075 ms at
//    the memory rate, partly in L2), where the TPU kernel kept h in
//    VMEM.  Large d_ff needs no schedule of its own: it is the down
//    GEMM's reduction depth.
//  * Rows.  The M dimension of expert e is its G C rows, row m being
//    (g, c) = (m / C, m % C) of x's (G, E, C, D) layout, in tiles of 64
//    rows (rows past G C are zero-filled and never stored).  A decode
//    step (G = 4 slots, C = 1) is one tile of 4 rows per expert, so each
//    block reads its slice of the expert's weights once and the weights
//    cross L2 once per launch; its 256-column tiles (d_ff, then D) give
//    256 and 512 blocks at E = 64.
//  * h at full precision.  The TPU kernel keeps h in f32.  The up
//    GEMM's epilogue splits each f32 h into three bf16 parts whose sum is
//    h exactly (24 significant bits in three of 8), and the down GEMM
//    multiplies every part by the same staged wo tile (three wgmma per
//    k16 step on one B operand); the products are exact in f32 and
//    summed in the f32 accumulator.
//  * Each block: two consumer warpgroups and four producer warps.  In
//    the up GEMM a warpgroup takes 128 columns of both wi and wg as one
//    m64n256k16 product (its wi and wg tiles side by side in shared
//    memory, so the x tile is read once); in the down GEMM, 128 columns
//    of wo as m64n128k16 products.  A is K-major and the weights
//    MN-major through the descriptor's transpose bit, both from shared
//    memory.  The producers stage the tiles with cp.async into the
//    128-byte swizzled layout, through a ring of STAGES buffers with
//    "full" and "empty" mbarriers (common/csrc/sm90.cuh).  The copies'
//    issue rate is what the producers must keep up with: each thread
//    works out its pointers and swizzled offsets once per tile, and four
//    warps issue them (with two, the consumers wait on their data).  One
//    k-step of 64 is 4 (up) or 12 (down) wgmma a warpgroup between
//    barrier waits; one wgmma group stays in flight while the next stage
//    is awaited.  No __syncthreads in the loop.
//  * Any C >= 1, D % 8 == 0 and F % 64 == 0 (the wrapper asks D % 32 and
//    F % 128, as the f32 kernel does): partial tiles of D and d_ff are
//    zero-filled.
//
// f32: exact FMAs (moe_mlp_f32_kernel), the first version of this
// kernel: the f32 tolerance of 1e-4 excludes TF32.  One block owns 16
// capacity rows of one (group, expert) pair and
//   phase 1  computes h for ALL of d_ff (or a tile of FT columns of it),
//            one 128-column tile at a time, into shared memory in f32,
//   phase 2  computes out = h wo one 128-column tile of D at a time.
// When h for all of d_ff does not fit a block's shared memory (F > FT,
// e.g. mixtral-8x22b's 16384), the wrapper cuts d_ff into tiles of FT
// columns and each tile's h wo is summed into an f32 (G E, C, D)
// workspace that the wrapper allocates; the last tile stores the output.
// No main path runs the expert FFN in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// f32: exact FMAs
// ---------------------------------------------------------------------------

namespace exact {

constexpr int NT = 256;    // threads per block (8 warps)
constexpr int BN = 128;    // columns of an output tile: d_ff (1), D (2)
constexpr int BK = 32;     // reduction depth of a step

struct Params {
  const float* x;
  const float* wi;
  const float* wg;
  const float* wo;
  float* out;
  float* ws;      // split schedule: f32 (G E, C, D) partial sums
  int g, e, c, d, f;
  int ft;         // d_ff columns per tile: f (one pass) or a divisor of f
};

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
  const float* x = p.x + ((size_t)tl.ge * p.c + tl.c0) * D;
  const size_t wsz = (size_t)D * F;
  const float* wi = p.wi + tl.ex * wsz;
  const float* wg = p.wg + tl.ex * wsz;
  const float* wo = p.wo + tl.ex * wsz;
  float* out = p.out + ((size_t)tl.ge * p.c + tl.c0) * D;
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


}  // namespace exact

// ---------------------------------------------------------------------------
// bf16: two wgmma GEMMs, fed by producer warps through an mbarrier ring
// ---------------------------------------------------------------------------

namespace tensor {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                      // reduction depth of a k-step
constexpr int CONSUMER_WARPS = 8;           // two warpgroups
constexpr int PRODUCER_WARPS = 4;
constexpr int NT = 32 * (CONSUMER_WARPS + PRODUCER_WARPS);
constexpr int PT = 32 * PRODUCER_WARPS;     // producer threads
constexpr int SMEM_LIMIT = 232448;          // a block's shared memory
constexpr int B_BLOCK = 64 * 128;           // one 64-wide column block of a
                                            // B tile (64 k rows), bytes
constexpr int NS = 3;                       // bf16 parts of h: three hold
                                            // every f32 exactly

struct Params {
  const bf16* x;
  const bf16* wi;
  const bf16* wg;
  const bf16* wo;
  bf16* out;
  bf16* h;        // (NS, E, G C, F): h in NS bf16 parts
  int g, e, c, d, f;
  int m;          // rows of an expert: G C
};

// A block owns BM rows of one expert and BN columns (d_ff in the up
// GEMM, D in the down GEMM); warpgroup w takes all BM rows and columns
// 128 w .. 128 w + 127 (of wi and of wg in the up GEMM).  (Tiles of 128
// rows, one warpgroup per 64, pad more rows at olmoe's capacities (320
// rows take 384) and were no faster at any shape measured.)
constexpr int BM = 64;
constexpr int BN = 256;
constexpr uint32_t A_BYTES = BM * 128;      // an A tile: BM rows x BK
constexpr uint32_t B_BYTES = BK * BN * 2;   // a B tile: BK rows x BN

// Stages of a ring of `stage` bytes that fit a block's shared memory
// (1024 bytes kept for aligning the tiles), at most 4.
constexpr int stages_for(uint32_t stage) {
  return (SMEM_LIMIT - 1024) / stage < 4 ? (SMEM_LIMIT - 1024) / stage : 4;
}

// The x rows of expert ex that producer thread pl copies into an up
// tile: rows pl / 8 + (PT / 8) i of the tile, as element offsets of x
// ((g E + ex) C + c) D for row m = (g, c), or -1 past the expert's rows.
struct XRows {
  static constexpr int N = BM * 8 / PT;
  long long off[N];
};

// The up kernel's A tile (K-major): BM rows x 64 values of x from k0,
// values past D zero.
__device__ __forceinline__ void load_x(uint32_t dst, const bf16* x,
                                       const XRows& rows, int k0, int D,
                                       int pl) {
  const int c8 = pl & 7, r0 = pl >> 3, k = k0 + 8 * c8;
#pragma unroll
  for (int i = 0; i < XRows::N; ++i) {
    const bool ok = k < D && rows.off[i] >= 0;
    sm90::cp_async16(dst + sm90::sw128(r0 + (PT / 8) * i, c8),
                     ok ? x + rows.off[i] + k : x, ok);
  }
}

// The shared memory of a block, its ring and barriers.  The producers
// fill stage s and arrive on full[s] as their copies land; each consumer
// warp arrives on empty[s] once its products have read the stage.
template <int STAGES>
struct Ring {
  uint32_t base;  // 1024-aligned shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
};

template <int STAGES>
__device__ __forceinline__ Ring<STAGES> ring_setup(unsigned char* raw,
                                                   uint64_t* bars) {
  Ring<STAGES> r{(sm90::smem_u32(raw) + 1023) & ~1023u, bars, bars + STAGES};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&r.full[s], PT);
      sm90::mbar_init(&r.empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// Consumer side of k-step kt: wait for its stage (returned), then
// stage_release after the products are queued.
template <int STAGES>
__device__ __forceinline__ uint32_t stage_wait(const Ring<STAGES>& r, int kt,
                                               uint32_t stage_bytes) {
  const int s = kt % STAGES;
  sm90::mbar_wait(&r.full[s], (kt / STAGES) & 1);
  sm90::fence_proxy_async();
  return r.base + s * stage_bytes;
}

// Commit k-step kt's products, wait for k-step kt - 1's (one group stays
// in flight) and release its stage.
template <int STAGES>
__device__ __forceinline__ void stage_release(const Ring<STAGES>& r, int kt) {
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();
  if (kt > 0 && (threadIdx.x & 31) == 0)
    sm90::mbar_arrive(&r.empty[(kt - 1) % STAGES]);
}

// Producer side of k-step kt: wait until the stage is free, `load` it,
// and arrive on its full barrier as the copies land.
template <int STAGES, typename Load>
__device__ __forceinline__ void produce(const Ring<STAGES>& r, int kt,
                                        uint32_t stage_bytes, Load load) {
  const int s = kt % STAGES;
  if (kt >= STAGES) sm90::mbar_wait(&r.empty[s], (kt / STAGES - 1) & 1);
  load(r.base + s * stage_bytes);
  sm90::cp_async_mbar_arrive(&r.full[s]);
}

// ---- up: h = silu(x wi) * (x wg), split into NS bf16 parts ---------------

struct Up {
  static constexpr uint32_t STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = stages_for(STAGE);
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 2 && SMEM + 16 * STAGES <= SMEM_LIMIT,
                "shared memory");
};

__global__ void __launch_bounds__(NT, 1) moe_mlp_up_kernel(const Params p) {
  using U = Up;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * U::STAGES];
  const Ring<U::STAGES> ring = ring_setup<U::STAGES>(smem_raw, bars);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, ex = blockIdx.z;
  const int warp = threadIdx.x >> 5, nk = (p.d + BK - 1) / BK;

  if (warp >= CONSUMER_WARPS) {
    // ---- producers: x rows of expert ex, wi and wg columns n0.. -------
    const int pl = threadIdx.x - 32 * CONSUMER_WARPS;
    XRows rows;
#pragma unroll
    for (int i = 0; i < XRows::N; ++i) {
      const int m = m0 + (pl >> 3) + (PT / 8) * i;
      rows.off[i] = m < p.m ? ((long long)(m / p.c) * p.e * p.c + ex * p.c +
                               m % p.c) * p.d
                            : -1;
    }
    const size_t wsz = (size_t)p.d * p.f;
    const bf16* wi = p.wi + ex * wsz;
    const bf16* wg = p.wg + ex * wsz;
    for (int kt = 0; kt < nk; ++kt)
      produce(ring, kt, U::STAGE, [&](uint32_t st) {
        load_x(st, p.x, rows, kt * BK, p.d, pl);
        // warpgroup w's 128 columns of wi, then of wg: one 256-wide B
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const uint32_t b = st + A_BYTES + 4 * w * B_BLOCK;
          sm90::load_rows<BK, 16, PT, B_BLOCK>(b, wi, p.f, kt * BK, p.d,
                                               n0 + 128 * w, p.f, pl);
          sm90::load_rows<BK, 16, PT, B_BLOCK>(b + 2 * B_BLOCK, wg, p.f,
                                               kt * BK, p.d, n0 + 128 * w,
                                               p.f, pl);
        }
      });
    sm90::cp_async_wait<0>();
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int wg = warp >> 2, col = 128 * wg;
  // 64 x 256 f32: x wi in columns 0..127, x wg in 128..255; the first
  // k-step overwrites it
  float acc[128];
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t st = stage_wait(ring, kt, U::STAGE);
    const uint32_t b = st + A_BYTES + 4 * wg * B_BLOCK;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_m64n256k16_ss<1>(
          acc, sm90::desc_sw128(st + 32 * ks, 16, 1024),
          sm90::desc_sw128(b + 2048 * ks, B_BLOCK, 1024), kt > 0 || ks > 0);
    stage_release(ring, kt);
    sm90::fence_regs(acc);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // epilogue: h in f32, stored as NS bf16 parts
  const int lane = threadIdx.x & 31;
  const int ma = m0 + (warp & 3) * 16 + (lane >> 2), mb = ma + 8;
  const size_t part = (size_t)p.e * p.m * p.f;
  bf16* ha = p.h + ((size_t)ex * p.m + ma) * p.f;
  bf16* hb = ha + (size_t)8 * p.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = n0 + col + 8 * i + 2 * (lane & 3);
    if (n >= p.f) continue;
    uint32_t pa[NS], pb[NS];
    const int j = 4 * i, k = 64 + 4 * i;  // x wi, x wg
    sm90::split_bf16<NS>(silu(acc[j]) * acc[k], silu(acc[j + 1]) * acc[k + 1],
                         pa);
    sm90::split_bf16<NS>(silu(acc[j + 2]) * acc[k + 2],
                         silu(acc[j + 3]) * acc[k + 3], pb);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      if (ma < p.m) *reinterpret_cast<uint32_t*>(ha + q * part + n) = pa[q];
      if (mb < p.m) *reinterpret_cast<uint32_t*>(hb + q * part + n) = pb[q];
    }
  }
}

// ---- down: out = sum over the parts of h_part wo -------------------------

struct Down {
  static constexpr uint32_t STAGE = NS * A_BYTES + B_BYTES;
  static constexpr int STAGES = stages_for(STAGE);
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 2 && SMEM + 16 * STAGES <= SMEM_LIMIT,
                "shared memory");
};

__global__ void __launch_bounds__(NT, 1) moe_mlp_down_kernel(const Params p) {
  using U = Down;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * U::STAGES];
  const Ring<U::STAGES> ring = ring_setup<U::STAGES>(smem_raw, bars);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, ex = blockIdx.z;
  const int warp = threadIdx.x >> 5, nk = p.f / BK;
  const size_t part = (size_t)p.e * p.m * p.f;

  if (warp >= CONSUMER_WARPS) {
    // ---- producers: the NS parts of h's rows, wo columns n0.. ---------
    const int pl = threadIdx.x - 32 * CONSUMER_WARPS;
    const bf16* h = p.h + (size_t)ex * p.m * p.f;
    const bf16* wo = p.wo + (size_t)ex * p.f * p.d;
    for (int kt = 0; kt < nk; ++kt)
      produce(ring, kt, U::STAGE, [&](uint32_t st) {
#pragma unroll
        for (int q = 0; q < NS; ++q)
          sm90::load_rows<BM, 8, PT, 0>(st + q * A_BYTES, h + q * part,
                                        p.f, m0, p.m, kt * BK, p.f, pl);
        sm90::load_rows<BK, BN / 8, PT, B_BLOCK>(
            st + NS * A_BYTES, wo, p.d, kt * BK, p.f, n0, p.d, pl);
      });
    sm90::cp_async_wait<0>();
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int wg = warp >> 2, col = 128 * wg;
  float acc[64];  // 64 x 128 f32; the first k-step overwrites it
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t st = stage_wait(ring, kt, U::STAGE);
    const uint32_t b = st + NS * A_BYTES + (col / 64) * B_BLOCK;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t db = sm90::desc_sw128(b + 2048 * ks, B_BLOCK, 1024);
#pragma unroll
      for (int q = NS - 1; q >= 0; --q)  // the smallest part first
        sm90::wgmma_m64n128k16_ss<1>(
            acc,
            sm90::desc_sw128(st + q * A_BYTES + 32 * ks, 16,
                             1024),
            db, kt > 0 || ks > 0 || q < NS - 1);
    }
    stage_release(ring, kt);
    sm90::fence_regs(acc);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // epilogue: the output rounded once, row m = (g, c) of expert ex
  const int lane = threadIdx.x & 31;
  const int ma = m0 + (warp & 3) * 16 + (lane >> 2), mb = ma + 8;
  bf16* oa = p.out + (((size_t)(ma / p.c) * p.e + ex) * p.c + ma % p.c) * p.d;
  bf16* ob = p.out + (((size_t)(mb / p.c) * p.e + ex) * p.c + mb % p.c) * p.d;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = n0 + col + 8 * i + 2 * (lane & 3);
    if (n >= p.d) continue;
    if (ma < p.m)
      *reinterpret_cast<uint32_t*>(oa + n) =
          sm90::pack_bf16(acc[4 * i], acc[4 * i + 1]);
    if (mb < p.m)
      *reinterpret_cast<uint32_t*>(ob + n) =
          sm90::pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run(const Params& p, cudaStream_t stream) {
  const unsigned mt = (p.m + BM - 1) / BM;
  cudaError_t err = launch(moe_mlp_up_kernel,
                           dim3(mt, (p.f + BN - 1) / BN, p.e), Up::SMEM, p,
                           stream);
  if (err != cudaSuccess) return err;
  return launch(moe_mlp_down_kernel, dim3(mt, (p.d + BN - 1) / BN, p.e),
                Down::SMEM, p, stream);
}

}  // namespace tensor

}  // namespace

// The shared memory an f32 block needs (bytes) when it holds h for ft
// columns of d_ff, so that the wrapper can choose the schedule: one pass
// when ft = f fits, else the split schedule.
extern "C" long long moe_mlp_f32_smem_bytes(int ft) {
  return static_cast<long long>(exact::smem_f32(ft));
}

// f32: x (g e, c, d), wi/wg (e, d, f), wo (e, f, d), out (g e, c, d); all
// contiguous.  Needs d % 32 == 0 and f % 128 == 0.  ft == f runs the
// one-pass schedule; a proper divisor ft of f (a multiple of 128) runs
// the split schedule, which needs ws, an f32 (g e, c, d) workspace.
// `device` is the index of the card the tensors and `stream` belong to
// (this library links its own CUDA runtime, whose current device is not
// the caller's).  Returns the CUDA error of the launch (0 = cudaSuccess);
// the launch is asynchronous on `stream` and allocates nothing.
extern "C" int moe_mlp_f32_fwd(const float* x, const float* wi,
                               const float* wg, const float* wo, float* out,
                               float* ws, int g, int e, int c, int d, int f,
                               int ft, int device, void* stream) {
  using namespace exact;
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
  const size_t smem = smem_f32(ft);
  const cudaError_t err =
      split ? launch(moe_mlp_f32_kernel<true>, p, BC32, smem, st)
            : launch(moe_mlp_f32_kernel<false>, p, BC32, smem, st);
  return static_cast<int>(err);
}

// bf16: x (g, e, c, d), wi/wg (e, d, f), wo (e, f, d), out (g, e, c, d);
// all contiguous, 16-byte aligned.  h is a bf16 workspace of
// 3 * e * (g c) * f values (h in three bf16 parts), written by the up
// kernel and read by the down kernel.  Needs d % 8 == 0 and f % 64 == 0.
// Launches the two kernels on `stream`; returns the first CUDA error
// (0 = cudaSuccess).
extern "C" int moe_mlp_bf16_fwd(const void* x, const void* wi, const void* wg,
                                const void* wo, void* out, void* h, int g,
                                int e, int c, int d, int f, int device,
                                void* stream) {
  using namespace tensor;
  const long long m = (long long)g * c;
  if (g < 1 || e < 1 || c < 1 || d < 8 || f < 64 || d % 8 != 0 ||
      f % 64 != 0 || e > 65535 || m > 0x7fffffffLL || h == nullptr ||
      f / BN + 1 > 65535 ||
      d / BN + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
                 static_cast<const bf16*>(wg), static_cast<const bf16*>(wo),
                 static_cast<bf16*>(out), static_cast<bf16*>(h), g, e, c, d,
                 f, static_cast<int>(m)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(run(p, st));
}
