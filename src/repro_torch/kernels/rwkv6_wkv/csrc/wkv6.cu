// WKV6 (RWKV-6 time mix) forward for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// (_wkv6_kernel, launched by wkv6_fwd).  Same function, per (batch, head)
// with an (n, n) f32 state S:
//
//   y_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,    w_t = exp(lw_t)
//
// r/k/v/y (b, s, h, n) in the model layout, bf16 or f32; lw (b, s, h, n)
// f32 log decay (<= 0); u (h, n) f32 bonus, indexed by the head; an
// optional initial state (b h, n, n) f32 and the final state written to
// (b h, n, n) f32.  Any s >= 1 (the TPU kernel asserted s % chunk == 0 and
// started from a zero state).
//
// What bounds it on this card.  A token of a head reads r, k, v and lw and
// writes y: 12 bytes per element of (b, s, h, n) in bf16, ~101 MB at
// rwkv6-7b's prefill (b=1, s=2048, h=64, n=64), 0.030 ms at 3.35 TB/s.  The
// recurrence's 4 n^2 f32 operations per token (0.032 ms at the rate outside
// the tensor cores) are chip_smoke.py's yardstick.  The bf16 kernel below
// moves the n^2 terms onto the tensor cores; what sets its pace is the
// chain of dependent steps in each chunk of each head (the decays, the
// splits, the scores inside a sub-chunk, the products, the exchange of y
// between the CTAs of a head), which at b = 1 leaves one CTA per SM, 128
// of the 132, far from either bound.
//
// bf16: the chunked form on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 out), chunks of L = 32 tokens (whatever `chunk` asks for), every
// decay a product of w's (never an exponential of a positive number, so
// nothing overflows; a factor that underflows to 0 stands for a product
// below f32's range):
//
//   r^[t] = r[t] prod_{tau < t} w        K^[m] = k[m] prod_{tau > m} w
//   y     = r^ S + A V                   S <- diag(prod w) S + K^T V
//
// A the (L, L) scores, lower triangular.  Inside a 16-token sub-chunk,
// A[t, m] = sum_i r[t,i] k[m,i] prod_{m < tau < t} w[tau,i] is summed on
// the CUDA cores with the decay carried as a running product, and A[t, t]
// is the bonus r . u . k.  Across sub-chunks (rows in sub-chunk 1, columns
// in sub-chunk 0) the reference point is the end of sub-chunk 0, as in Yang
// et al., arXiv:2312.06635 (secondary chunking): A = Q~ K~^T with Q~[t] =
// r[t] prod w from the start of sub-chunk 1 to t - 1 and K~[m] = k[m] prod
// w from m + 1 to the end of sub-chunk 0, both factors <= 1, one product on
// the tensor cores.
//
// Numerics.  r, k and v are exact in bf16.  Every other operand (r^, K^,
// S, Q~, K~, A) is f32 and enters a product as its two-part bf16 split
// (sm90::split_bf16<2>, 16 significant bits); a product of two split
// operands takes hi.hi + hi.lo + lo.hi.  Held on the CPU with the plain
// transcription of this factorisation (ref.wkv6_chunked_factorised) in
// tests/test_torch_wkv6.py: every split is needed (one part for any of
// them takes y outside bf16's 8e-3 of 1 + |y|), and two parts keep y
// within it and the state within 5e-4 of 1 + |S| over 2048 slowly
// decaying tokens.
//
// Layout.  Every term is a sum over the key channels i, so the CTAs of a
// cluster share a head (2 at n = 64, each with 32 channels; one below):
// each has its own r, k, lw, part of the state and of the scores, and all
// of v.  Each
// sends its part of y for every row to the CTA that finishes the row
// (st.async into that CTA's shared memory, counted on its mbarrier as
// transaction bytes), which sums the parts and rounds y once.  A CTA holds
// 13 warps:
//  * a producer: one thread issues a tensor-map copy (TMA) per tensor and
//    chunk into a ring of 4 stages (rows past s are zeros: r = k = v = 0
//    and lw = 0, w = 1, which change nothing);
//  * 8 preparing warps, chunk c into operand buffer c % 2: warps 0-3 take
//    w = exp(lw), its products (a scan over 4-token groups in 4 lanes) and
//    the split operands r^, K^, Q~, K~, and copy v; warps 4-7 sum the
//    scores inside the sub-chunks over 4 channels each; all 8 add those up
//    over channels and split them;
//  * 4 product warps, chunk c - 1 meanwhile: warp w holds S^T for the value
//    columns [16 w, 16 w + 16) as the accumulator fragments of the state
//    update, which are, as they stand, the B fragments of the next chunk's
//    r^ S (no shuffle, no shared memory); r^ S, A V, Q~ K~^T (kept in
//    registers and reused as an A operand), the parts of y, the state
//    update; then this CTA's rows of y.
// mbarriers hand stages and operand buffers between the three groups.
//
// f32: the exact recurrence token by token in f32 FMAs (a 5e-4 tolerance
// leaves no room for a split product's rounding), in the oracle's own
// order (src/repro/kernels/rwkv6_wkv/ref.py).  The grid is (b h, n / JB):
// a block owns JB columns (32, or n when n < 32) of one head's state; its
// threads are IG = 8 row groups x JB columns, thread (g, j) holding S[i, j]
// for the n / 8 rows i of group g.  The block stages `chunk` tokens at a
// time in shared memory (r, k, w = exp(lw), v, the bonus term), walks
// them, and sums the row groups' parts of y.
//
// Not yet: the preparing and product warps take about the same time a
// chunk and do not fully overlap; wgmma (A read once for a warpgroup),
// a v copy multicast to both CTAs, and the scores of 8-token blocks on the
// tensor cores (halving the CUDA-core scores) are the next levers.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int MAX_CHUNK = 64;  // tokens per chunk asked for, at most

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  const float* state0;  // nullptr: start from zeros
  void* y;
  float* state;
  int b, s, h, chunk;
};

// ---------------------------------------------------------------------------
// f32: the recurrence
// ---------------------------------------------------------------------------

namespace rec {

constexpr int IG = 8;  // row groups of the state

// The columns one block owns.
template <int N>
__host__ __device__ constexpr int cols() {
  return N < 32 ? N : 32;
}

template <int N>
size_t smem_bytes(int chunk) {
  constexpr int JB = cols<N>();
  // r, k, w (chunk, N); v (chunk, JB); parts of y (chunk, IG, JB); the
  // bonus term (chunk); u (N)
  return sizeof(float) *
         ((size_t)chunk * (3 * N + JB + IG * JB + 1) + N);
}

template <int N>
__global__ void __launch_bounds__(IG * cols<N>())
wkv6_recurrence(const Params p) {
  constexpr int JB = cols<N>(), NT = IG * JB, RI = N / IG;
  extern __shared__ __align__(16) float sm[];
  const int L = p.chunk;
  float* rs = sm;                  // (L, N)
  float* ks = rs + L * N;          // (L, N)
  float* ws = ks + L * N;          // (L, N): exp(lw)
  float* vs = ws + L * N;          // (L, JB)
  float* yp = vs + L * JB;         // (L, IG, JB): row groups' parts of y
  float* bonus = yp + L * IG * JB; // (L): r . u . k
  float* us = bonus + L;           // (N)

  const int bh = blockIdx.x, bb = bh / p.h, hh = bh % p.h;
  const int j0 = blockIdx.y * JB;
  const int t = threadIdx.x, g = t / JB, jl = t % JB;
  const int lane = t & 31, warp = t >> 5;
  // element (bb, tok, hh, i) of a (b, s, h, n) tensor
  const size_t row0 = (size_t)bb * p.s * p.h + hh;

  for (int i = t; i < N; i += NT) us[i] = p.u[hh * N + i];

  float S[RI];
  const size_t sbase = (size_t)bh * N * N + j0 + jl;
#pragma unroll
  for (int q = 0; q < RI; ++q)
    S[q] = p.state0 ? p.state0[sbase + (size_t)(g * RI + q) * N] : 0.f;

  const float* r = static_cast<const float*>(p.r);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* y = static_cast<float*>(p.y);

  for (int t0 = 0; t0 < p.s; t0 += L) {
    const int nt = min(L, p.s - t0);
    __syncthreads();  // the previous chunk's shared memory is free
    for (int e = t; e < nt * N; e += NT) {
      const int l = e / N, i = e % N;
      const size_t at = (row0 + (size_t)(t0 + l) * p.h) * N + i;
      rs[e] = r[at];
      ks[e] = k[at];
      ws[e] = expf(p.lw[at]);
    }
    for (int e = t; e < nt * JB; e += NT) {
      const int l = e / JB, c = e % JB;
      vs[e] = v[(row0 + (size_t)(t0 + l) * p.h) * N + j0 + c];
    }
    __syncthreads();
    // the bonus term of each token: one warp per token, lanes over rows
    for (int l = warp; l < nt; l += NT / 32) {
      float acc = 0.f;
      for (int i = lane; i < N; i += 32)
        acc = fmaf(rs[l * N + i] * us[i], ks[l * N + i], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) bonus[l] = acc;
    }

    // the recurrence over the chunk's tokens
    for (int l = 0; l < nt; ++l) {
      const float* rl = rs + l * N + g * RI;
      const float* kl = ks + l * N + g * RI;
      const float* wl = ws + l * N + g * RI;
      const float vj = vs[l * JB + jl];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int q = 0; q < RI; q += 2) {
        a0 = fmaf(rl[q], S[q], a0);
        a1 = fmaf(rl[q + 1], S[q + 1], a1);
      }
#pragma unroll
      for (int q = 0; q < RI; ++q) S[q] = fmaf(S[q], wl[q], kl[q] * vj);
      yp[(l * IG + g) * JB + jl] = a0 + a1;
    }
    __syncthreads();

    // y = the row groups' parts + the bonus term, JB values per token
    for (int e = t; e < nt * JB; e += NT) {
      const int l = e / JB, c = e % JB;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < IG; ++q) acc += yp[(l * IG + q) * JB + c];
      acc = fmaf(bonus[l], vs[e], acc);
      y[(row0 + (size_t)(t0 + l) * p.h) * N + j0 + c] = acc;
    }
  }

#pragma unroll
  for (int q = 0; q < RI; ++q)
    p.state[sbase + (size_t)(g * RI + q) * N] = S[q];
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<N>(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_recurrence<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, N / cols<N>());
  wkv6_recurrence<N><<<grid, IG * cols<N>(), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace rec

// ---------------------------------------------------------------------------
// bf16: the chunked form on the tensor cores
// ---------------------------------------------------------------------------

namespace chunked {

constexpr int SUB = 16;      // tokens per sub-chunk
constexpr int NSUB = 2;      // sub-chunks per chunk
constexpr int STAGES = 4;    // staged chunks
constexpr int NTP = 256;     // preparing threads: 8 warps
constexpr int NTM = 128;     // product threads: 4 warps
constexpr int NT = NTP + NTM + 32;  // and the producer warp
constexpr int MMA_WARP0 = NTP / 32, PRODUCER = (NTP + NTM) / 32;

// Shared memory of one CTA, in bytes from the start.  bf16 tiles have rows
// of 8 values more than they hold (16-byte aligned, and ldmatrix's 8 rows
// of a fragment fall on distinct banks).  The operands the preparing warps
// hand to the product warps are double-buffered (chunk c in buffer c % 2).
template <int N>
struct Cfg {
  static constexpr int NC = N < 32 ? N : 32;  // key channels of this CTA
  static constexpr int CS = N / NC;           // CTAs per (batch, head)
  static constexpr int L = SUB * NSUB;
  static constexpr int RO = L / CS;   // rows of y each CTA finishes
  static constexpr int LDC = NC + 8;  // bf16 row of this CTA's channels
  static constexpr int LDB = N + 8;   // bf16 row of all n channels (v)
  static constexpr int LDS = SUB + 8; // bf16 row of a 16 x 16 score block
  static constexpr int NG = NC / 2;   // channel pairs
  static constexpr int NQ = NC / 4;   // groups of 4 channels
  static constexpr int PT = SUB * NQ + 4;  // f32 partial scores of a row
  // a stage, as the tensor-map copies write it: r, k (L, NC) bf16; v (L,
  // n) bf16; lw (L, NC) f32 (every tile a multiple of 128 bytes)
  static constexpr int S_K = L * NC * 2, S_V = 2 * L * NC * 2;
  static constexpr int S_LW = S_V + L * N * 2, STAGE = S_LW + L * NC * 4;
  // one operand buffer: r^ hi, lo, K^ hi, lo (L, LDC); Q~ hi, lo, K~ hi,
  // lo (SUB, LDC); the sub-chunks' scores hi, lo (NSUB, SUB, LDS); the
  // chunk's decay prod w (NC) f32; v (L, LDB) bf16, copied from the stage
  // so that the stage is free once the preparing warps are done with it
  static constexpr int O_Q = 4 * L * LDC * 2;
  static constexpr int O_A = O_Q + 4 * SUB * LDC * 2;
  static constexpr int O_DEC = O_A + 2 * NSUB * SUB * LDS * 2;
  static constexpr int O_V = O_DEC + NC * 4;
  static constexpr int OPER = O_V + L * LDB * 2;
  static constexpr int W = STAGES * STAGE;          // f32 w (L, NC)
  static constexpr int ESUB = W + L * NC * 4;       // f32 (NSUB, NC)
  static constexpr int PART = ESUB + NSUB * NC * 4;
  static constexpr int OPS = PART + NSUB * SUB * PT * 4;
  static constexpr int YB = OPS + 2 * OPER;  // f32 [2][CS][RO][N]
  static constexpr int U = YB + 2 * CS * RO * N * 4;  // f32 (NC)
  // full, empty [STAGES]; ready, free, ydone [2]
  static constexpr int BAR = U + NC * 4;
  static constexpr int SMEM = BAR + (2 * STAGES + 6) * 8;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, "
               "%2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

// D (16 x 8, f32) += A (16 x 16, bf16) B (16 x 8, bf16).  Not volatile:
// the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The preparing warps' own barrier (the others never wait on it).
__device__ __forceinline__ void sync_prep() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTP) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared address `addr` of this CTA as the same place in CTA `rank`
// of the cluster.
__device__ __forceinline__ uint32_t remote(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// (a, b) to cluster address `addr`, asynchronously; the 8 bytes count as
// complete_tx on the mbarrier at cluster address `bar` (in the same CTA)
// when they have landed.
__device__ __forceinline__ void st_async(uint32_t addr, float a, float b,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// The tensor maps of r, k, v (bf16) and lw (f32), each viewed as (n, h, s,
// b) with a box of this CTA's channels (all n for v) x 1 head x L tokens x
// 1 batch: one copy per tensor and chunk, rows past s filled with zeros.
struct Maps {
  CUtensorMap r, k, v, lw;
};

// The box of `map` at (x0, x1, x2, x3) to shared address `dst`, counted on
// `bar` as complete_tx.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x0, int x1, int x2, int x3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3), "r"(sm90::smem_u32(bar))
      : "memory");
}

// sm90::mbar_wait, acquiring what other CTAs of the cluster wrote.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

// shuffles of a float2 within groups of 4 lanes
__device__ __forceinline__ float2 shfl_up2(float2 v, int d) {
  return make_float2(__shfl_up_sync(0xffffffffu, v.x, d, 4),
                     __shfl_up_sync(0xffffffffu, v.y, d, 4));
}

__device__ __forceinline__ float2 shfl_down2(float2 v, int d) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, d, 4),
                     __shfl_down_sync(0xffffffffu, v.y, d, 4));
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src, 4),
                     __shfl_sync(0xffffffffu, v.y, src, 4));
}

__device__ __forceinline__ float2 bf2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// 4 consecutive bf16 (8-byte aligned) as f32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf2(x.x), b = bf2(x.y);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// 4 consecutive f32 (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// x as two bf16 parts, at element `at` of the hi and lo tiles
__device__ __forceinline__ void store_split(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int at,
                                            float2 x) {
  uint32_t parts[2];
  sm90::split_bf16<2>(x.x, x.y, parts);
  *reinterpret_cast<uint32_t*>(hi + at) = parts[0];
  *reinterpret_cast<uint32_t*>(lo + at) = parts[1];
}

// (a, b) as two bf16 parts, packed
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  uint32_t parts[2];
  sm90::split_bf16<2>(a, b, parts);
  hi = parts[0];
  lo = parts[1];
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
    wkv6_chunked(const __grid_constant__ Maps maps, const Params p) {
  using C = Cfg<N>;
  constexpr int NC = C::NC, CS = C::CS, L = C::L, RO = C::RO;
  constexpr int LDC = C::LDC, LDB = C::LDB, LDS = C::LDS, NG = C::NG;
  constexpr int NQ = C::NQ;
  constexpr int PT = C::PT, NIT = NC / 8, NKS = NC / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* wbuf = reinterpret_cast<float*>(smem + C::W);
  float* esub = reinterpret_cast<float*>(smem + C::ESUB);
  float* part = reinterpret_cast<float*>(smem + C::PART);
  float* ybuf = reinterpret_cast<float*>(smem + C::YB);
  float* us = reinterpret_cast<float*>(smem + C::U);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;
  uint64_t* freed = ready + 2;
  uint64_t* ydone = freed + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = CS > 1 ? cluster_rank() : 0;
  const int bh = blockIdx.x / CS, bb = bh / p.h, hh = bh % p.h;
  const int i0 = rank * NC;  // this CTA's key channels [i0, i0 + NC)
  const long long ld = (long long)p.h * N;  // elements between tokens
  const size_t base = ((size_t)bb * p.s * p.h + hh) * N;
  const int nchunks = (p.s + L - 1) / L;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], NTP);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&ready[b], NTP);
      sm90::mbar_init(&freed[b], NTM);
      sm90::mbar_init(&ydone[b], 1);
    }
    sm90::mbar_init_fence();
  }
  for (int i = tid; i < NC; i += NT) us[i] = p.u[hh * N + i0 + i];
  // every CTA's barriers are ready before any CTA uses them
  if (CS > 1) cluster_sync(); else __syncthreads();

  if (warp == PRODUCER) {
    // chunk by chunk into the ring: r, k and lw of this CTA's channels and
    // v of all n, one tensor-map copy each (rows past the sequence's end
    // are zeros: r = k = v = 0 and lw = 0, w = 1, which change nothing)
    if (lane == 0) {
      for (int c = 0; c < nchunks; ++c) {
        const int st = c % STAGES;
        if (c >= STAGES) sm90::mbar_wait(&empty[st], (c / STAGES - 1) & 1);
        const uint32_t sp = sm90::smem_u32(smem + st * C::STAGE);
        sm90::mbar_arrive_expect_tx(&full[st], C::STAGE);
        tma_load(sp, &maps.r, i0, hh, c * L, bb, &full[st]);
        tma_load(sp + C::S_K, &maps.k, i0, hh, c * L, bb, &full[st]);
        tma_load(sp + C::S_V, &maps.v, 0, hh, c * L, bb, &full[st]);
        tma_load(sp + C::S_LW, &maps.lw, i0, hh, c * L, bb, &full[st]);
      }
    }
  } else if (warp < MMA_WARP0) {
    // ---- the preparing warps: chunk c's operands into buffer c % 2 ----
    // Warps 0-3 (units: channel pair cp, sub-chunk sub, 4-token group gp;
    // the 4 groups of a sub-chunk in 4 consecutive lanes): w = exp(lw),
    // the products of w, the decayed operands, v into the operand buffer.
    // Warps 4-7 (units: 4 channels ig, row pair tp, sub-chunk ps): the
    // scores inside the sub-chunks.  Then all 8: the scores summed over
    // channel groups, split.
    constexpr int NU = NG * NSUB * 4, NPU = NQ * 8 * NSUB;
    static_assert(NU <= 128 && NPU <= 128, "prep units");
    const bool prep = tid < NU;
    const int gp = lane % 4, seg = tid / 4;
    const int sub = seg % NSUB, cp = seg / NSUB, e4 = 4 * sub + gp;
    const int pu = tid - 128;
    const bool pair = pu >= 0 && pu < NPU;
    const int ig = pu % NQ, tp = (pu / NQ) % 8, ps = pu / (8 * NQ);
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % STAGES, b = c & 1;
      sm90::mbar_wait(&full[st], (c / STAGES) & 1);
      const unsigned char* sp = smem + st * C::STAGE;
      const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(sp);
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(sp + C::S_K);
      const float* lws = reinterpret_cast<const float*>(sp + C::S_LW);
      unsigned char* op = smem + C::OPS + b * C::OPER;
      __nv_bfloat16* rh = reinterpret_cast<__nv_bfloat16*>(op);
      __nv_bfloat16* rl = rh + L * LDC;
      __nv_bfloat16* kh = rl + L * LDC;
      __nv_bfloat16* kl = kh + L * LDC;
      __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(op + C::O_Q);
      __nv_bfloat16* ql = qh + SUB * LDC;
      __nv_bfloat16* th = ql + SUB * LDC;
      __nv_bfloat16* tl = th + SUB * LDC;
      __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(op + C::O_A);
      __nv_bfloat16* al = ah + NSUB * SUB * LDS;
      float* dec = reinterpret_cast<float*>(op + C::O_DEC);
      const float2 one = make_float2(1.f, 1.f);

      // 1. w = exp(lw); products of w within the sub-chunk: inside the
      // group before each token (lpre), before the group (pfx), after it
      // (sfx), all of it (esub)
      // (each phase loads what it reads before it stores anything: the
      // compiler cannot tell the tiles apart and would keep the order)
      float2 wv[4], lpre[4], pfx, sfx;
      if (prep) {
        float2 x[4];
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
          x[tt] = *reinterpret_cast<const float2*>(lws + (4 * e4 + tt) * NC +
                                                   2 * cp);
        float2 grp = one;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          wv[tt] = make_float2(expf(x[tt].x), expf(x[tt].y));
          lpre[tt] = grp;
          grp = mul2(grp, wv[tt]);
        }
        float2 inc = grp, sinc = grp;  // inclusive scans over the 4 lanes
#pragma unroll
        for (int d = 1; d < 4; d <<= 1) {
          const float2 o = shfl_up2(inc, d), so = shfl_down2(sinc, d);
          if (gp >= d) inc = mul2(inc, o);
          if (gp + d < 4) sinc = mul2(sinc, so);
        }
        const float2 ip = shfl_up2(inc, 1), sn = shfl_down2(sinc, 1);
        pfx = gp ? ip : one;
        sfx = gp < 3 ? sn : one;
        const float2 tot = shfl2(inc, 3);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
          *reinterpret_cast<float2*>(wbuf + (4 * e4 + tt) * NC + 2 * cp) =
              wv[tt];
        if (gp == 0) *reinterpret_cast<float2*>(esub + sub * NC + 2 * cp) = tot;
      }
      // buffer b is free once the products of chunk c - 2 are done
      if (c >= 2) sm90::mbar_wait(&freed[b], ((c >> 1) - 1) & 1);
      sync_prep();

      if (prep) {
        // 2a. the decayed operands, split
        float2 before = one, after = one, all = one;
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const float2 e = *reinterpret_cast<const float2*>(esub + j * NC +
                                                            2 * cp);
          if (j < sub) before = mul2(before, e);
          if (j > sub) after = mul2(after, e);
          all = mul2(all, e);
        }
        float2 rv[4], kv[4];
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const int at = (4 * e4 + tt) * NC + 2 * cp;
          rv[tt] = bf2(*reinterpret_cast<const uint32_t*>(rs + at));
          kv[tt] = bf2(*reinterpret_cast<const uint32_t*>(ks + at));
        }
        // the prefix within the sub-chunk to token t - 1, the suffix from
        // token t + 1
        float2 suf = sfx;
#pragma unroll
        for (int tt = 3; tt >= 0; --tt) {
          const int t = 4 * e4 + tt, at = t * LDC + 2 * cp;
          const float2 pre = mul2(pfx, lpre[tt]);
          store_split(rh, rl, at, mul2(rv[tt], mul2(before, pre)));
          store_split(kh, kl, at, mul2(kv[tt], mul2(suf, after)));
          if (sub == 1)
            store_split(qh, ql, at - SUB * LDC, mul2(rv[tt], pre));
          else
            store_split(th, tl, at, mul2(kv[tt], suf));
          suf = mul2(suf, wv[tt]);
        }
        if (e4 == 0) *reinterpret_cast<float2*>(dec + 2 * cp) = all;
      }
      if (tid < 128) {
        // v into the operand buffer, 16 bytes at a time
        constexpr int PV = N / 8, NV = L * PV, PERV = (NV + 127) / 128;
        const uint4* vsrc = reinterpret_cast<const uint4*>(sp + C::S_V);
        uint4* vdst = reinterpret_cast<uint4*>(op + C::O_V);
        uint4 vx[PERV];
#pragma unroll
        for (int u = 0; u < PERV; ++u) {
          const int e = tid + 128 * u;
          if (e < NV) vx[u] = vsrc[e];
        }
#pragma unroll
        for (int u = 0; u < PERV; ++u) {
          const int e = tid + 128 * u;
          if (e < NV) vdst[(e / PV) * (LDB / 8) + e % PV] = vx[u];
        }
      } else if (pair) {
        // 2b. scores inside each sub-chunk over 4 channels: rows tp and 15
        // - tp side by side, m from t - 1 down, the decay carried as a
        // running product; the bonus r . u . k on the diagonal
        const int t1 = tp, t2 = SUB - 1 - tp, row0 = SUB * ps, i4 = 4 * ig;
        float uu[4], r1[4], r2[4], k1[4], k2[4];
        load4(us + i4, uu);
        load4(rs + (row0 + t1) * NC + i4, r1);
        load4(rs + (row0 + t2) * NC + i4, r2);
        load4(ks + (row0 + t1) * NC + i4, k1);
        load4(ks + (row0 + t2) * NC + i4, k2);
        float b1 = 0.f, b2 = 0.f, p1[SUB - 1], p2[SUB - 1];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          b1 = fmaf(r1[x] * uu[x], k1[x], b1);
          b2 = fmaf(r2[x] * uu[x], k2[x], b2);
        }
        // from m = 14 down: a row joins at m = t - 1 with run = r[t]
#pragma unroll
        for (int m = SUB - 2; m >= 0; --m) {
          float km[4], wm[4];
          load4(ks + (row0 + m) * NC + i4, km);
          load4(wbuf + (row0 + m) * NC + i4, wm);
          p1[m] = fmaf(r1[0], km[0], r1[1] * km[1]) +
                  fmaf(r1[2], km[2], r1[3] * km[3]);
          p2[m] = fmaf(r2[0], km[0], r2[1] * km[1]) +
                  fmaf(r2[2], km[2], r2[3] * km[3]);
          if (m < t1) {
#pragma unroll
            for (int x = 0; x < 4; ++x) r1[x] *= wm[x];
          }
          if (m < t2) {
#pragma unroll
            for (int x = 0; x < 4; ++x) r2[x] *= wm[x];
          }
        }
        float* pp = part + row0 * PT + ig;
        pp[t1 * PT + t1 * NQ] = b1;
        pp[t2 * PT + t2 * NQ] = b2;
#pragma unroll
        for (int m = 0; m < SUB - 1; ++m) {
          if (m < t1) pp[t1 * PT + m * NQ] = p1[m];
          if (m < t2) pp[t2 * PT + m * NQ] = p2[m];
        }
      }
      sync_prep();
      // the stage is free (v is in the operand buffer)
      sm90::mbar_arrive(&empty[st]);

      // 3. the sub-chunks' scores, summed over channel groups, split
      {
        constexpr int NE = NSUB * SUB * (SUB / 2), PER = (NE + NTP - 1) / NTP;
        float a2[PER][2];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = tid + NTP * u;
          const int mp = e % (SUB / 2), t = (e / (SUB / 2)) % SUB;
          const int s2 = e / (SUB * SUB / 2);
#pragma unroll
          for (int hm = 0; hm < 2; ++hm) {
            const int m = 2 * mp + hm;
            float acc = 0.f;
            if (e < NE && m <= t) {
              const float4* pp = reinterpret_cast<const float4*>(
                  part + (s2 * SUB + t) * PT + m * NQ);
#pragma unroll
              for (int x = 0; x < NQ / 4; ++x) {
                const float4 f = pp[x];
                acc += (f.x + f.y) + (f.z + f.w);
              }
            }
            a2[u][hm] = acc;
          }
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = tid + NTP * u;
          const int mp = e % (SUB / 2), t = (e / (SUB / 2)) % SUB;
          const int s2 = e / (SUB * SUB / 2);
          if (e < NE)
            store_split(ah, al, (s2 * SUB + t) * LDS + 2 * mp,
                        make_float2(a2[u][0], a2[u][1]));
        }
      }
      // buffer b holds chunk c's operands
      sm90::mbar_arrive(&ready[b]);
    }
  } else {
    // ---- the product warps: chunk c from buffer c % 2 ----
    // Warp w < n / 16 holds S^T (value column j, key channel i) for j in
    // [16 w, 16 w + 16) and this CTA's channels: Sc[it] is the m16n8
    // accumulator fragment of channels i0 + [8 it, 8 it + 8): Sc[it][e] =
    // S[i0 + 8 it + 2 q + (e & 1)][16 w + g + 8 (e >> 1)].
    const int mw = warp - MMA_WARP0, mtid = tid - NTP;
    const int g = lane >> 2, q = lane & 3;
    const bool mma_warp = mw < N / 16;
    const int j0 = 16 * mw;
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + base;
    float Sc[NIT][4];
    const size_t sbase = (size_t)bh * N * N + (size_t)i0 * N;
#pragma unroll
    for (int it = 0; it < NIT; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Sc[it][e] = mma_warp && p.state0
                        ? p.state0[sbase + (size_t)(8 * it + 2 * q + (e & 1)) *
                                               N + j0 + g + 8 * (e >> 1)]
                        : 0.f;
    const uint32_t ybuf_u = sm90::smem_u32(ybuf);
    const uint32_t ydone_u = sm90::smem_u32(ydone);
    const uint32_t a_off = ((lane % 16) * LDC + (lane / 16) * 8) * 2;
    const uint32_t b_off =
        (((lane % 8) + (lane / 16) * 8) * LDC + ((lane / 8) % 2) * 8) * 2;
    const uint32_t t_off =
        (((lane % 8) + ((lane / 8) % 2) * 8) * LDB + (lane / 16) * 8) * 2;
    const uint32_t k_off =
        (((lane % 8) + ((lane / 8) % 2) * 8) * LDC + (lane / 16) * 8) * 2;
    const uint32_t d_off = ((lane % 16) * LDS + (lane / 16) * 8) * 2;

    for (int c = 0; c < nchunks; ++c) {
      const int b = c & 1;
      sm90::mbar_wait(&ready[b], (c >> 1) & 1);
      const uint32_t op = sm90::smem_u32(smem + C::OPS + b * C::OPER);
      const uint32_t rh = op, rl = rh + L * LDC * 2;
      const uint32_t kh = rl + L * LDC * 2, kl = kh + L * LDC * 2;
      const uint32_t qh = op + C::O_Q, ql = qh + SUB * LDC * 2;
      const uint32_t th = ql + SUB * LDC * 2, tl = th + SUB * LDC * 2;
      const uint32_t ah = op + C::O_A, al = ah + NSUB * SUB * LDS * 2;
      const float* dec =
          reinterpret_cast<const float*>(smem + C::OPS + b * C::OPER + C::O_DEC);
      const uint32_t vs = op + C::O_V;

      if (mma_warp) {
        // S as the B operand of r^ S: k-step ks (channels i0 + [16 ks, 16
        // ks + 16)), column half nt: b0 from channel tile 2 ks, b1 from
        // 2 ks + 1
        uint32_t sb[NKS][2][2][2];  // [ks][nt][b0, b1][hi, lo]
#pragma unroll
        for (int ks2 = 0; ks2 < NKS; ++ks2)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int bi = 0; bi < 2; ++bi)
              split2(Sc[2 * ks2 + bi][2 * nt], Sc[2 * ks2 + bi][2 * nt + 1],
                     sb[ks2][nt][bi][0], sb[ks2][nt][bi][1]);
        // hi.hi products and the split's corrections, summed at the end
        float yacc[NSUB][2][4], ycor[NSUB][2][4];
#pragma unroll
        for (int mt = 0; mt < NSUB; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) yacc[mt][nt][e] = ycor[mt][nt][e] = 0.f;

        // r^ S
#pragma unroll
        for (int ks2 = 0; ks2 < NKS; ++ks2)
#pragma unroll
          for (int mt = 0; mt < NSUB; ++mt) {
            uint32_t xh[4], xl[4];
            const uint32_t at = a_off + (16 * mt * LDC + 16 * ks2) * 2;
            ldsm_x4(xh, rh + at);
            ldsm_x4(xl, rl + at);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma(yacc[mt][nt], xh, sb[ks2][nt][0][0], sb[ks2][nt][1][0]);
              mma(ycor[mt][nt], xh, sb[ks2][nt][0][1], sb[ks2][nt][1][1]);
              mma(ycor[mt][nt], xl, sb[ks2][nt][0][0], sb[ks2][nt][1][0]);
            }
          }

        // v of each sub-chunk, this warp's columns, transposed: the B
        // fragments (k = token, n = column) of A V, and, reordered as {0,
        // 2, 1, 3}, the A fragment (m = column, k = token) of V^T K^
        uint32_t vf[NSUB][4];
#pragma unroll
        for (int s2 = 0; s2 < NSUB; ++s2)
          ldsm_x4_t(vf[s2], vs + t_off + (16 * s2 * LDB + j0) * 2);

        // A V inside each sub-chunk
#pragma unroll
        for (int s2 = 0; s2 < NSUB; ++s2) {
          uint32_t xh[4], xl[4];
          ldsm_x4(xh, ah + d_off + 16 * s2 * LDS * 2);
          ldsm_x4(xl, al + d_off + 16 * s2 * LDS * 2);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma(yacc[s2][nt], xh, vf[s2][2 * nt], vf[s2][2 * nt + 1]);
            mma(ycor[s2][nt], xl, vf[s2][2 * nt], vf[s2][2 * nt + 1]);
          }
        }

        // A V across the sub-chunks: the scores Q~ K~^T, then their
        // accumulator fragments as the A operand
        float s0[2][4] = {}, s1[2][4] = {};
#pragma unroll
        for (int ks2 = 0; ks2 < NKS; ++ks2) {
          uint32_t xh[4], xl[4], yh[4], yl[4];
          ldsm_x4(xh, qh + a_off + 32 * ks2);
          ldsm_x4(xl, ql + a_off + 32 * ks2);
          ldsm_x4(yh, th + b_off + 32 * ks2);
          ldsm_x4(yl, tl + b_off + 32 * ks2);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma(s0[nt], xh, yh[2 * nt], yh[2 * nt + 1]);
            mma(s1[nt], xh, yl[2 * nt], yl[2 * nt + 1]);
            mma(s1[nt], xl, yh[2 * nt], yh[2 * nt + 1]);
          }
        }
        uint32_t oh[4], ol[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int nt = x >> 1, e = 2 * (x & 1);
          split2(s0[nt][e] + s1[nt][e], s0[nt][e + 1] + s1[nt][e + 1],
                 oh[x], ol[x]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(yacc[1][nt], oh, vf[0][2 * nt], vf[0][2 * nt + 1]);
          mma(ycor[1][nt], ol, vf[0][2 * nt], vf[0][2 * nt + 1]);
        }

        // this CTA's part of y[t, j] into ybuf[b][rank][t % RO][j] of CTA
        // t / RO, counted on that CTA's ydone[b]
#pragma unroll
        for (int mt = 0; mt < NSUB; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = 16 * mt + g + 8 * hr;
            const uint32_t at = remote(
                ybuf_u + (((b * CS + rank) * RO + t % RO) * N + j0 + 2 * q) * 4,
                t / RO);
            const uint32_t bar = remote(ydone_u + 8 * b, t / RO);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              st_async(at + 32 * nt,
                       yacc[mt][nt][2 * hr] + ycor[mt][nt][2 * hr],
                       yacc[mt][nt][2 * hr + 1] + ycor[mt][nt][2 * hr + 1],
                       bar);
          }

        // S <- diag(prod w) S + K^T V, as S^T <- S^T diag(prod w) + V^T K^
#pragma unroll
        for (int it = 0; it < NIT; ++it) {
          const float2 a =
              *reinterpret_cast<const float2*>(dec + 8 * it + 2 * q);
          Sc[it][0] *= a.x;
          Sc[it][1] *= a.y;
          Sc[it][2] *= a.x;
          Sc[it][3] *= a.y;
        }
#pragma unroll
        for (int s2 = 0; s2 < NSUB; ++s2) {
          const uint32_t va[4] = {vf[s2][0], vf[s2][2], vf[s2][1], vf[s2][3]};
#pragma unroll
          for (int pi = 0; pi < NKS; ++pi) {
            uint32_t xh[4], xl[4];
            const uint32_t at = k_off + (16 * s2 * LDC + 16 * pi) * 2;
            ldsm_x4_t(xh, kh + at);
            ldsm_x4_t(xl, kl + at);
            mma(Sc[2 * pi], va, xh[0], xh[1]);
            mma(Sc[2 * pi + 1], va, xh[2], xh[3]);
            mma(Sc[2 * pi], va, xl[0], xl[1]);
            mma(Sc[2 * pi + 1], va, xl[2], xl[3]);
          }
        }
      }
      // buffer b is free
      sm90::mbar_arrive(&freed[b]);

      // 5. this CTA's rows of y: the CS parts summed, rounded once.  The
      // parts come as CS RO n f32 (every CTA writes all its rows), of which
      // one arrival here announces the count: the phase of chunk c - 2 on
      // this buffer completed before the wait of chunk c - 2, and no part
      // of chunk c is sent before every CTA has its parts of chunk c - 1,
      // which this CTA sends after reading those of chunk c - 2.
      if (mtid == 0) sm90::mbar_arrive_expect_tx(&ydone[b], CS * RO * N * 4);
      wait_cluster(&ydone[b], (c >> 1) & 1);
      constexpr int NY = RO * N / 2, PY = (NY + NTM - 1) / NTM;
      float2 acc[PY];
#pragma unroll
      for (int u = 0; u < PY; ++u) {
        const int e = mtid + NTM * u, ro = e / (N / 2), jp = e % (N / 2);
        acc[u] = make_float2(0.f, 0.f);
#pragma unroll
        for (int src = 0; src < CS; ++src)
          if (e < NY) {
            const float2 x = *reinterpret_cast<const float2*>(
                ybuf + ((b * CS + src) * RO + ro) * N + 2 * jp);
            acc[u].x += x.x;
            acc[u].y += x.y;
          }
      }
#pragma unroll
      for (int u = 0; u < PY; ++u) {
        const int e = mtid + NTM * u, ro = e / (N / 2), jp = e % (N / 2);
        const int t = c * L + rank * RO + ro;
        if (e < NY && t < p.s)
          *reinterpret_cast<uint32_t*>(y + t * ld + 2 * jp) =
              sm90::pack_bf16(acc[u].x, acc[u].y);
      }
    }

    if (mma_warp) {
#pragma unroll
      for (int it = 0; it < NIT; ++it)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p.state[sbase + (size_t)(8 * it + 2 * q + (e & 1)) * N + j0 + g +
                  8 * (e >> 1)] = Sc[it][e];
    }
  }
  // no CTA leaves while another may still use its shared memory
  if (CS > 1) cluster_sync();
}

// (n, h, s, b) view of a (b, s, h, n) tensor with a box of `cols`
// channels x 1 x L x 1
cudaError_t encode(CUtensorMap* map, const void* ptr, bool bf16, const Params& p,
                   int n, int cols, int L) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn),
        cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
  }
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)n, (cuuint64_t)p.h, (cuuint64_t)p.s,
                              (cuuint64_t)p.b};
  const cuuint64_t strides[3] = {n * es, p.h * n * es,
                                 (cuuint64_t)p.s * p.h * n * es};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)L, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(ptr), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<N>;
  Maps maps;
  cudaError_t err;
  if ((err = encode(&maps.r, p.r, true, p, N, C::NC, C::L)) != cudaSuccess ||
      (err = encode(&maps.k, p.k, true, p, N, C::NC, C::L)) != cudaSuccess ||
      (err = encode(&maps.v, p.v, true, p, N, N, C::L)) != cudaSuccess ||
      (err = encode(&maps.lw, p.lw, false, p, N, C::NC, C::L)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(
      wkv6_chunked<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.b * p.h * C::CS);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_chunked<N>, maps, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace chunked

template <int N>
cudaError_t dispatch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return rec::launch<N>(p, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  return chunked::launch<N>(p, stream);
}

}  // namespace

// r/k/v/y (b, s, h, n) and lw (b, s, h, n), contiguous, 16-byte aligned;
// u (h, n) f32; state0 (b h, n, n) f32 or null (zeros); state (b h, n, n)
// f32, written.  dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  n in {16,
// 32, 64}; 1 <= chunk <= 64: in f32 the tokens staged at a time (the
// result does not depend on it); bf16 ignores it (chunks of 32 tokens).
// state may alias state0: a thread reads its part
// of the state before it writes it, and no other thread touches that part.
// `device` is the index of the card the tensors and `stream` belong to
// (this library links its own CUDA runtime, whose current device is not
// the caller's).  Returns the CUDA error of the launch (0 = cudaSuccess);
// the launch is asynchronous on `stream` and allocates nothing.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* lw, const float* u, const float* state0,
                        void* y, float* state, int dtype, int b, int s, int h,
                        int n, int chunk, int device, void* stream) {
  if (b < 1 || s < 1 || h < 1 || chunk < 1 || chunk > MAX_CHUNK ||
      (long long)b * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const Params p{r, k, v, lw, u, state0, y, state, b, s, h, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 16: err = dispatch<16>(p, dtype, st); break;
    case 32: err = dispatch<32>(p, dtype, st); break;
    case 64: err = dispatch<64>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
