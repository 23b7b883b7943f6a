// WKV6 recurrence (RWKV-6 time mix) forward for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// (_wkv6_kernel, launched by wkv6_fwd).  Same function, per (batch, head)
// with an (n, n) f32 state S:
//
//   y_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//
// r/k/v/y (b, s, h, n) in the model layout, bf16 or f32; lw (b, s, h, n)
// f32 log decay (<= 0); u (h, n) f32 bonus, indexed by the head; an
// optional initial state (b h, n, n) f32 and the final state written to
// (b h, n, n) f32.  All arithmetic is f32.
//
// What bounds it on this card.  A token of a head reads r, k, v and lw
// and writes y: 12 bytes per element of (b, s, h, n) in bf16, and does
// ~4 n^2 f32 operations on the state (y: n^2 multiply-adds; S: n^2
// multiplies and n^2 multiply-adds).  At rwkv6-7b's prefill (b=1,
// s=2048, h=64, n=64) that is ~101 MB (0.030 ms at 3.35 TB/s) against
// 2.15 G operations (0.032 ms at the f32 rate outside the tensor cores,
// 67 TFLOP/s): n / 3 operations per byte, so the f32 rate bounds it,
// barely.
//
// The design.
//  * Order.  The TPU grid walked the chunks of a sequence as a sequential
//    axis and carried S in VMEM scratch across grid steps.  Blocks on
//    Hopper run in no order, so one block walks the whole sequence of its
//    (batch, head) in a loop and S stays in registers from the first
//    token to the last: 16 KB per head at n = 64, spread over the block.
//  * Arithmetic.  The TPU kernel evaluates a chunk of L tokens as matrix
//    products (pairwise decays exp(cum_prev[l] - cum[m]), an L x L score
//    tile, the chunk's state update) because that is what its matrix unit
//    runs fast.  Here every product is an exact f32 FMA (the f32
//    tolerance of 5e-4 leaves little room for TF32), and at FMA rate the
//    chunked form costs more than the recurrence itself: the scores alone
//    are L n / 2 exponentials and products per token on top of the same
//    three (L, n) x (n, n) products, while the recurrence is 3 n^2
//    instructions per token.  So the kernel runs the recurrence token by
//    token, in the oracle's own order (src/repro/kernels/rwkv6_wkv/ref.py):
//    no exponent is ever positive, and no (L, L, n) decay tensor exists.
//  * Parallel layout.  The columns of S are independent: y[:, j] needs
//    only S[:, j] and v[:, j].  The grid is (b h, n / JB): a block owns JB
//    columns (32, or n when n < 32) of one head's state, so rwkv6-7b's 64
//    heads give 128 blocks at b = 1 for the card's 132 SMs.  Its threads
//    are IG = 8 row groups x JB columns; thread (g, j) holds S[i, j] for
//    the n / 8 rows i of group g.  A warp shares one row group, so the
//    r, k and decay values of a token are one broadcast read for all its
//    lanes, and its v reads are 32 consecutive words.
//  * Staging.  The block stages `chunk` tokens at a time in shared
//    memory: r, k and w = exp(lw) for all n rows, v for its columns, and
//    the bonus term r . u . k of each token.  Each thread then walks the
//    tokens, writing its row group's part of y[t, j] to shared memory, and
//    after the chunk the block sums the 8 parts, adds the bonus term and
//    stores y, JB consecutive values per token.
//  * Any s >= 1: the last chunk is short.  The TPU kernel asserted
//    s % chunk == 0 and started from a zero state.
//
// Not yet: the chunked form on the tensor cores (wgmma, with a 3xTF32 or
// split-bf16 product to keep f32 accuracy) and TMA staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int IG = 8;          // row groups of the state
constexpr int MAX_CHUNK = 64;  // tokens staged at a time, at most

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int N>
__global__ void __launch_bounds__(IG * cols<N>())
wkv6_kernel(const Params p) {
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

  const T* r = static_cast<const T*>(p.r);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* y = static_cast<T*>(p.y);

  for (int t0 = 0; t0 < p.s; t0 += L) {
    const int nt = min(L, p.s - t0);
    __syncthreads();  // the previous chunk's shared memory is free
    for (int e = t; e < nt * N; e += NT) {
      const int l = e / N, i = e % N;
      const size_t at = (row0 + (size_t)(t0 + l) * p.h) * N + i;
      rs[e] = to_f32(r[at]);
      ks[e] = to_f32(k[at]);
      ws[e] = expf(p.lw[at]);
    }
    for (int e = t; e < nt * JB; e += NT) {
      const int l = e / JB, c = e % JB;
      vs[e] = to_f32(v[(row0 + (size_t)(t0 + l) * p.h) * N + j0 + c]);
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
      store(y + (row0 + (size_t)(t0 + l) * p.h) * N + j0 + c, acc);
    }
  }

#pragma unroll
  for (int q = 0; q < RI; ++q)
    p.state[sbase + (size_t)(g * RI + q) * N] = S[q];
}

template <typename T, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<N>(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, N / cols<N>());
  wkv6_kernel<T, N><<<grid, IG * cols<N>(), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const Params& p, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v/y (b, s, h, n) and lw (b, s, h, n), contiguous; u (h, n) f32;
// state0 (b h, n, n) f32 or null (zeros); state (b h, n, n) f32, written.
// dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  n in {16, 32, 64};
// 1 <= chunk <= 64 tokens staged at a time (the result does not depend on
// it).  state may alias state0: a block reads its part before it writes
// it, and no other block touches that part.  `device` is the index of the
// card the tensors and `stream` belong to (this library links its own
// CUDA runtime, whose current device is not the caller's).  Returns the
// CUDA error of the launch (0 = cudaSuccess); the launch is asynchronous
// on `stream` and allocates nothing.
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
  switch (dtype) {
    case 0: err = dispatch_n<float>(p, n, st); break;
    case 1: err = dispatch_n<__nv_bfloat16>(p, n, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
