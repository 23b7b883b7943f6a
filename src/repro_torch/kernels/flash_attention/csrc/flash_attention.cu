// Causal (optionally sliding-window) flash-attention forward for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_fwd_kernel, launched by flash_attention_fwd).  Same function:
// softmax(q k^T / sqrt(d)) v with an index-based mask (causal
// kpos <= qpos, window kpos > qpos - window), an online softmax with f32
// running max m, running sum l and accumulator acc, and no KV tile
// visited that the mask covers entirely.  One mask the TPU kernel lacks:
// causal with a prefix, where keys kpos < prefix are visible to every
// row.  That is the mask of an M-RoPE prefill (Qwen2-VL): its vision
// tokens all sit at temporal position 0, so they see each other both
// ways, and the model masks by temporal position.  And a query-row
// offset: local query row i is row q_offset + i of the sequence the keys
// cover, so that a rank of a context-parallel prefill, holding a slice of
// the query rows and every key, masks its rows where they lie (the mask,
// the causal KV range and the window's edge all take the global row).
//
// Layout.  q/o are read and written in the model layout (b, s, h, d)
// through their strides, k/v in (b, s_kv, kvh, d): no transpose copy.
// Query head h reads kv head h / (H / kvh), which is the JAX package's
// _repeat_kv followed by attention.  Any s >= 1: rows and keys past the
// end are masked here, where the TPU kernel asserted s % block == 0.
// The TPU grid walked the KV blocks as a sequential axis and carried
// m/l/acc in VMEM scratch across grid steps; on Hopper blocks run in no
// order, so a loop inside the block walks the KV tiles from the window's
// first tile to the causal limit.  Work is taken heaviest (last causal)
// q tile first.
//
// What bounds it on this card.  Causal attention does 2 b h s^2 d flops
// on 8 b s h d bytes of bf16 q/k/v/o: s / 4 flops per byte (512 at the
// serving shape s = 2048), far above the card's ~295 flops/byte balance
// point, so the bound is the tensor cores' rate, and the work between
// the two products (the softmax) is what keeps a kernel from it: at
// d = 64 a 128 x 128 tile's 16384 exponentials take the SM's 16-a-clock
// special-function units as long as the tile's two products take its
// tensor cores (1024 clocks each), so the two must overlap.
//
// bf16: the tensor cores (flash_bf16_kernel).
//  * Work item: a 128-row q tile of one (b, h), for two consumer
//    warpgroups of 64 rows each; a producer warpgroup stages the tiles
//    (384 threads).  The kernel is persistent: one block per SM walks
//    the items heaviest first, in a snake over the blocks so that their
//    shares of the causal work even out, and the producers run ahead
//    into the next item (Q in two buffers) while the consumers finish
//    the current one.
//  * Staging: cp.async, 16 bytes a thread, into the 128-byte swizzled
//    layout that wgmma reads (common/csrc/sm90.cuh).  Chosen over TMA
//    because q/k/v are strided views in the model layout (any strides
//    that are multiples of 8 elements) and the kernel runs well under
//    0.1 ms: a TMA tensor map per operand per call would add host work
//    through the driver API on every launch, where cp.async takes the
//    strides as they are and zero-fills the rows past s itself.  K and V
//    tiles of 128 keys go through a ring of STAGES buffers (3, or 2 at
//    d = 128); each producer thread's copies arrive on the stage's
//    "full" mbarrier as they land, and the consumers release a stage on
//    its "empty" mbarrier once their products have read it.  Each
//    producer thread works out its source pointer and swizzled offsets
//    once per tile, so a 16-byte copy costs a few instructions; even so,
//    one producer warp's copies set the pace, and a warpgroup keeps up.
//    No __syncthreads in the loop: the two consumer warpgroups run
//    independently, and one's softmax overlaps the other's products.
//  * S = Q K^T: wgmma m64n128k16, Q and K both from shared memory
//    (K-major), d / 16 steps, into 64 f32 registers a thread.
//  * Online softmax in registers: each thread holds 2 rows x 32 keys;
//    row max across the quad with shuffles, ex2.approx with log2(e)
//    folded into the scale, the sum kept per thread and reduced once at
//    the end.  The mask is applied only on tiles that cross the diagonal,
//    the window edge or the end of s_kv.
//  * O += P V: P rounded to bf16 in registers is the A operand (the
//    score accumulator's layout is the A fragment's), V the B operand
//    from shared memory, MN-major through the descriptor's transpose bit
//    (the same swizzled bytes as a K tile).  O stays in registers and is
//    divided by l once, at the end.
//  * P in bf16: each weight carries a relative error of at most 2^-9,
//    so the output's error is at most 2^-9 max|v|; l sums the f32 p
//    before rounding.
//  * d = 16 and 32 use the d = 64 layout: S takes d / 16 steps; P V
//    takes n = 64, and the columns past d (never loaded) are discarded.
//
// f32: exact FMAs (flash_f32_kernel).  The f32 tolerance of 2e-5
// excludes TF32, so f32 inputs take the first version of this kernel:
// every product with f32 FMAs from shared-memory tiles (a 4x4 register
// micro-tile per thread for q k^T and 4 x d/16 for p v), one block per
// (q tile of 64 rows, b * h).  No main path runs attention in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv, h, kvh;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, prefix;
  int q_offset;  // global index of local query row 0
  float scale;
};

// KV tiles [first, end) that local q rows [q0, q_last] need, before the
// mask: global rows q0 + q_offset .. q_last + q_offset.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int q_last,
                                         int bk, int& first, int& end) {
  int k_begin = 0, k_end = p.skv;
  if (p.causal) {
    k_end = min(k_end, max(q_last + p.q_offset + 1, p.prefix));
    if (p.window > 0) k_begin = max(0, q0 + p.q_offset - p.window + 1);
  }
  first = k_begin / bk;
  end = (k_end + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// f32: exact FMAs
// ---------------------------------------------------------------------------

namespace exact {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int SST = BK + 4;   // row stride of the score tile (bank spread)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * SST + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_f32_kernel(Params p) {
  using T = float;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x (D+1), pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);    // BK x D
  float* Ss = Vs + BK * D;          // BQ x SST: scores, then p
  float* m_s = Ss + BQ * SST;       // running max per row
  float* l_s = m_s + BQ;            // running sum per row
  float* a_s = l_s + BQ;            // this tile's rescale per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kvhi = hi / (p.h / p.kvh);
  const int q0 = qt * BQ;

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvhi * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvhi * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    const float x = qi < p.sq ? qg[qi * p.q_ss + c] : 0.f;
    Qs[r * (D + 1) + c] = x * p.scale;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  int kt_first, kt_end;
  kv_range(p, q0, min(q0 + BQ, p.sq) - 1, BK, kt_first, kt_end);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with Ks, Vs and Ss
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < p.skv;
      Ks[r * (D + 1) + c] = in ? kg[kj * p.k_ss + c] : 0.f;
      Vs[r * D + c] = in ? vg[kj * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r + p.q_offset;  // global row
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j, kj = k0 + cc;
        bool ok = kj < p.skv;
        if (p.causal) {
          ok = ok && (kj <= qi || kj < p.prefix);
          if (p.window > 0) ok = ok && kj > qi - p.window;
        }
        Ss[r * SST + cc] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ss[r * SST + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float x = Ss[r * SST + c];
        // masked keys give 0; a row with no key yet keeps m = -inf
        const float e = x == -INFINITY ? 0.f : expf(x - m_new);
        Ss[r * SST + c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SST + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // a row with no visible key (only when causal with a window and
  // q_offset + s >= s_kv + window, which the wrapper refuses) has l = 0
  // and acc = 0: the floor, which mirrors the TPU kernel, writes 0 there
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= p.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      og[qi * p.o_ss + tx + 16 * j] = acc[i][j] / l;
  }
}


template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
  flash_f32_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace exact

// ---------------------------------------------------------------------------
// bf16: wgmma, fed by a producer warp through an mbarrier ring
// ---------------------------------------------------------------------------

namespace tensor {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                   // query rows per block
constexpr int BK = 128;                   // keys per KV tile
constexpr int CONSUMER_WARPS = 8;         // two warpgroups of 64 rows
constexpr int PT = 128;                   // producer threads: 4 warps
constexpr int NT = 32 * CONSUMER_WARPS + PT;

template <int D>
struct Cfg {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int DP = D < 64 ? 64 : D;  // stored row width (values)
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t T_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr uint32_t STAGE = 2 * T_BYTES;
  // 1024: slack to align the tiles to the swizzle atom; two Q buffers
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE;
};

// One work item: a 128-row q tile of one (b, h) and the KV tiles it needs.
struct Item {
  int bi, hi, kvhi, q0, kt_first, n_tiles;
};

// Work items are numbered heaviest first: w / (b h) counts q tiles down
// from the last (causal: the most KV tiles; a q_offset adds the same
// keys to every tile, so the last is still the heaviest), w % (b h) is
// the (b, h).
__device__ __forceinline__ Item item_of(const Params& p, int w, int nqt) {
  Item it;
  const int bh = w % (p.b * p.h);
  it.bi = bh / p.h;
  it.hi = bh % p.h;
  it.kvhi = it.hi / (p.h / p.kvh);
  it.q0 = (nqt - 1 - w / (p.b * p.h)) * BQ;
  int end;
  kv_range(p, it.q0, min(it.q0 + BQ, p.sq) - 1, BK, it.kt_first, end);
  it.n_tiles = end - it.kt_first;
  return it;
}

// The item a block takes in round r: blocks walk the heaviest-first list
// in a snake (round r, block c takes r G + c, or r G + G - 1 - c when r
// is odd), so every block's rounds add up to about the same work.
__device__ __forceinline__ int item_index(int r) {
  const int g = gridDim.x, c = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - c : c);
}

// Persistent: one block per SM walks work items (see item_index).  The
// producers run ahead across items: the next item's Q goes to the other
// of two Q buffers, its K/V tiles into the same ring, while the consumers
// finish the current one.  PREFIX: whether p.prefix > 0, a template flag
// so that the kernel without one masks exactly as before it existed (on
// an H100, a run-time test in the mask cost 4-7% at s = 2048 and the
// flag nothing).
template <int D, bool PREFIX>
__global__ void __launch_bounds__(NT, 1)
    flash_bf16_kernel(const Params p, int nqt) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_qfull[2];
  __shared__ __align__(8) uint64_t bar_qempty[2];
  __shared__ __align__(8) uint64_t bar_full[C::STAGES];
  __shared__ __align__(8) uint64_t bar_empty[C::STAGES];
  const uint32_t q_tiles = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_ring = q_tiles + 2 * C::Q_BYTES;  // stage s: K, then V
  const int n_items = p.b * p.h * nqt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&bar_qfull[i], PT);
      sm90::mbar_init(&bar_qempty[i], CONSUMER_WARPS);
    }
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&bar_full[s], PT);
      sm90::mbar_init(&bar_empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producers: each item's Q, then its K and V tiles -------------
    const int pt = tid - 32 * CONSUMER_WARPS;
    int t = 0;  // KV tiles staged so far, over all items
    for (int r = 0, n = 0; r * (int)gridDim.x < n_items; ++r) {
      const int w = item_index(r);
      if (w >= n_items) continue;
      const Item it = item_of(p, w, nqt);
      const int qbuf = n & 1;
      if (n >= 2) sm90::mbar_wait(&bar_qempty[qbuf], ((n >> 1) - 1) & 1);
      ++n;
      const bf16* qg =
          static_cast<const bf16*>(p.q) + it.bi * p.q_sb + it.hi * p.q_sh;
      const bf16* kg =
          static_cast<const bf16*>(p.k) + it.bi * p.k_sb + it.kvhi * p.k_sh;
      const bf16* vg =
          static_cast<const bf16*>(p.v) + it.bi * p.v_sb + it.kvhi * p.v_sh;
      sm90::load_rows<BQ, D / 8, PT, BQ * 128>(
          q_tiles + qbuf * C::Q_BYTES, qg, p.q_ss, it.q0, p.sq, 0, D, pt);
      sm90::cp_async_mbar_arrive(&bar_qfull[qbuf]);
      for (int j = 0; j < it.n_tiles; ++j, ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES)
          sm90::mbar_wait(&bar_empty[s], (t / C::STAGES - 1) & 1);
        const int k0 = (it.kt_first + j) * BK;
        const uint32_t kt = kv_ring + s * C::STAGE;
        sm90::load_rows<BK, D / 8, PT, BK * 128>(kt, kg, p.k_ss, k0, p.skv,
                                                 0, D, pt);
        sm90::load_rows<BK, D / 8, PT, BK * 128>(kt + C::T_BYTES, vg, p.v_ss,
                                                 k0, p.skv, 0, D, pt);
        sm90::cp_async_mbar_arrive(&bar_full[s]);
      }
    }
    sm90::cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile --
  const int wg = warp >> 2, g = lane >> 2, qd = lane & 3;
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
  float S[BK / 2];          // scores: n-block i holds S[4i .. 4i+3]
  float O[C::DP / 2];       // output accumulator, same layout
  uint32_t P[BK / 16][4];   // bf16 p: the A fragment of each k16 step
  int t = 0;                // KV tiles consumed so far, over all items
  for (int r = 0, n = 0; r * (int)gridDim.x < n_items; ++r) {
    const int w = item_index(r);
    if (w >= n_items) continue;
    const Item it = item_of(p, w, nqt);
    const int qbuf = n & 1, q_round = n >> 1;
    ++n;
    // local rows qa, qb (the stores); global rows ga, gb and the
    // warpgroup's global rows [wq_lo, wq_hi] (the mask)
    const int qa = it.q0 + wg * 64 + (warp & 3) * 16 + g, qb = qa + 8;
    const int ga = qa + p.q_offset, gb = qb + p.q_offset;
    const int wq_lo = it.q0 + p.q_offset + wg * 64, wq_hi = wq_lo + 63;
    const uint32_t q_wg = q_tiles + qbuf * C::Q_BYTES + wg * 64 * 128;
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) O[i] = 0.f;
    sm90::fence_regs(O);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    sm90::mbar_wait(&bar_qfull[qbuf], q_round & 1);
    for (int j = 0; j < it.n_tiles; ++j, ++t) {
      const int s = t % C::STAGES, k0 = (it.kt_first + j) * BK;
      sm90::mbar_wait(&bar_full[s], (t / C::STAGES) & 1);
      sm90::fence_proxy_async();
      const uint32_t kt = kv_ring + s * C::STAGE, vt = kt + C::T_BYTES;

      // S = Q K^T (both K-major)
      sm90::fence_regs(S);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks & 3) * 32;
        sm90::wgmma_m64n128k16_ss<0>(
            S,
            sm90::desc_sw128(q_wg + (ks >> 2) * (BQ * 128) + col, 16, 1024),
            sm90::desc_sw128(kt + (ks >> 2) * (BK * 128) + col, 16, 1024),
            ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();  // also the previous tile's P V
      sm90::fence_regs(S);
      sm90::fence_regs(O);
      sm90::fence_regs(P);
      if (j > 0 && lane == 0)
        sm90::mbar_arrive(&bar_empty[(t - 1) % C::STAGES]);

      // the mask, only on tiles that cross the end of s_kv, the diagonal
      // (past the prefix) or the window's edge for this warpgroup's rows
      const bool edge =
          k0 + BK > p.skv ||
          (p.causal &&
           ((k0 + BK - 1 > wq_lo && (!PREFIX || k0 + BK > p.prefix)) ||
            (p.window > 0 && k0 <= wq_hi - p.window)));
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * i + 2 * qd + (e & 1);
            const int qi = e < 2 ? ga : gb;
            bool ok = kj < p.skv;
            if (p.causal) {
              ok = ok && (kj <= qi || (PREFIX && kj < p.prefix));
              if (p.window > 0) ok = ok && kj > qi - p.window;
            }
            if (!ok) S[4 * i + e] = -INFINITY;
          }
      }

      // online softmax in the log2 domain; rows qa (e = 0, 1) and qb (2, 3)
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        x0 = fmaxf(x0, fmaxf(S[4 * i], S[4 * i + 1]));
        x1 = fmaxf(x1, fmaxf(S[4 * i + 2], S[4 * i + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0 * sl2), n1 = fmaxf(m1, x1 * sl2);
      // a row with no visible key yet keeps m = -inf and p = 0
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = sm90::ex2(m0 - u0), a1 = sm90::ex2(m1 - u1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = sm90::ex2(fmaf(S[4 * i], sl2, -u0));
        const float p1 = sm90::ex2(fmaf(S[4 * i + 1], sl2, -u0));
        const float p2 = sm90::ex2(fmaf(S[4 * i + 2], sl2, -u1));
        const float p3 = sm90::ex2(fmaf(S[4 * i + 3], sl2, -u1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        P[i >> 1][(i & 1) * 2] = sm90::pack_bf16(p0, p1);
        P[i >> 1][(i & 1) * 2 + 1] = sm90::pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int i = 0; i < C::DP / 8; ++i) {
        O[4 * i] *= a0;
        O[4 * i + 1] *= a0;
        O[4 * i + 2] *= a1;
        O[4 * i + 3] *= a1;
      }

      // O += P V: P from registers, V MN-major (64-wide column blocks
      // BK * 128 bytes apart), 16 keys = 2048 bytes a step
      sm90::fence_regs(O);
      sm90::fence_regs(P);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t dv = sm90::desc_sw128(vt + ks * 2048, BK * 128, 1024);
        if constexpr (C::DP == 64)
          sm90::wgmma_m64n64k16_rs<1>(O, P[ks], dv, 1);
        else
          sm90::wgmma_m64n128k16_rs<1>(O, P[ks], dv, 1);
      }
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(O);
    sm90::fence_regs(P);
    // the item's last stage (if it had a KV tile: a windowed q tile past
    // s_kv + window has none, and the stage before is released already)
    // and its Q buffer are free
    if (lane == 0) {
      if (it.n_tiles > 0) sm90::mbar_arrive(&bar_empty[(t - 1) % C::STAGES]);
      sm90::mbar_arrive(&bar_qempty[qbuf]);
    }

    // a row with no visible key (only when causal with a window and
    // q_offset + s >= s_kv + window, which the wrapper refuses) has l = 0
    // and O = 0: the floor, which mirrors the TPU kernel, writes 0 there
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
    bf16* og = static_cast<bf16*>(p.o) + it.bi * p.o_sb + it.hi * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * qd;
      if (qa < p.sq)
        *reinterpret_cast<uint32_t*>(og + qa * p.o_ss + col) =
            sm90::pack_bf16(O[4 * i] * r0, O[4 * i + 1] * r0);
      if (qb < p.sq)
        *reinterpret_cast<uint32_t*>(og + qb * p.o_ss + col) =
            sm90::pack_bf16(O[4 * i + 2] * r1, O[4 * i + 3] * r1);
    }
  }
}

template <int D, bool PREFIX>
cudaError_t launch_prefix(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D, PREFIX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nqt = (p.sq + BQ - 1) / BQ;
  const long long items = (long long)p.b * p.h * nqt;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_bf16_kernel<D, PREFIX><<<grid, NT, smem, stream>>>(p, nqt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.prefix > 0 ? launch_prefix<D, true>(p, stream)
                      : launch_prefix<D, false>(p, stream);
}

}  // namespace tensor

// The kernel for dtype (0 = float32, 1 = bfloat16) and head dim d.
template <int D>
cudaError_t launch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return exact::launch<D>(p, stream);
    case 1: return tensor::launch<D>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: mask by index, keys below
// `prefix` visible to every row (prefix 0: plain causal; the wrapper
// refuses a prefix with a window); local query row i masks as row
// `q_offset` + i (q_offset >= 0; 0: q holds the sequence's first rows).
// Strides are in elements; the last
// dimension of every tensor must be contiguous; in bf16 the base pointers
// must be 16-byte aligned and the strides multiples of 8 (the wrapper
// checks).  `device` is the index of
// the card the tensors and `stream` belong to (this library links its own
// CUDA runtime, whose current device is not the caller's).  Returns the
// CUDA error of the launch (0 = cudaSuccess); the launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int sq, int skv, int h, int kvh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, int prefix,
    int q_offset, float scale, int device, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      prefix < 0 || (prefix > 0 && window > 0) || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  Params p{q, k, v, o, b, sq, skv, h, kvh,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           causal, window, prefix, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_dtype<16>(p, dtype, st); break;
    case 32: err = launch_dtype<32>(p, dtype, st); break;
    case 64: err = launch_dtype<64>(p, dtype, st); break;
    case 128: err = launch_dtype<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
