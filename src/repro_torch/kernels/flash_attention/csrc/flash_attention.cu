// Causal (optionally sliding-window) flash-attention forward for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_fwd_kernel, launched by flash_attention_fwd).  Same function:
// softmax(q k^T / sqrt(d)) v with an index-based mask (causal
// kpos <= qpos, window kpos > qpos - window), an online softmax with f32
// running max m, running sum l and accumulator acc, and no KV tile
// visited that the mask covers entirely.
//
// Layout.  q/o are read and written in the model layout (b, s, h, d)
// through their strides, k/v in (b, s_kv, kvh, d): no transpose copy.
// Query head h reads kv head h / (H / kvh), which is the JAX package's
// _repeat_kv followed by attention.  Any s >= 1: rows and keys past the
// end are masked here, where the TPU kernel asserted s % block == 0.
//
// Parallel layout.  One block per (q tile of 64 rows, b * h).  The TPU
// grid walked the KV blocks as a sequential axis and carried m/l/acc in
// VMEM scratch across grid steps; on Hopper blocks run in no order, so a
// loop inside the block walks the KV tiles from the window's first tile
// to the causal limit and keeps m/l in shared memory, acc in registers.
// Blocks are issued heaviest (last causal) q tile first.
//
// What bounds it on this card.  Causal attention does 2 b h s^2 d flops
// on 8 b s h d bytes of bf16 q/k/v/o: s / 4 flops per byte (512 at the
// serving shape s = 2048), far above the card's ~295 flops/byte balance
// point, so the bound is arithmetic.  This first version computes every
// product with f32 FMAs from shared-memory tiles (a 4x4 register
// micro-tile per thread for q k^T and 4 x d/16 for p v), not on the
// tensor cores: it is limited by shared-memory loads and the f32 FMA
// rate, far from the tensor-core bound.  It keeps f32 inputs exact (the
// f32 tolerance of 2e-5 excludes TF32).  Tensor cores (mma.sync / wgmma)
// and TMA staging are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int SST = BK + 4;   // row stride of the score tile (bank spread)

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
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * SST + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
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
    const float x = qi < p.sq ? to_f32(qg[qi * p.q_ss + c]) : 0.f;
    Qs[r * (D + 1) + c] = x * p.scale;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // KV tiles this q tile needs: [k_begin, k_end) before rounding to tiles
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int k_begin = 0, k_end = p.skv;
  if (p.causal) {
    k_end = min(k_end, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }
  const int kt_end = (k_end + BK - 1) / BK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = k_begin / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with Ks, Vs and Ss
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < p.skv;
      Ks[r * (D + 1) + c] = in ? to_f32(kg[kj * p.k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vg[kj * p.v_ss + c]) : 0.f;
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
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j, kj = k0 + cc;
        bool ok = kj < p.skv;
        if (p.causal) {
          ok = ok && kj <= qi;
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

  // every q row has at least one visible key when causal (itself), so l
  // > 0 for rows that are written; the floor mirrors the TPU kernel
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= p.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      og[qi * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor must be contiguous.  `device` is the index of
// the card the tensors and `stream` belong to (this library links its own
// CUDA runtime, whose current device is not the caller's).  Returns the
// CUDA error of the launch (0 = cudaSuccess); the launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int sq, int skv, int h, int kvh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    int device, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || h < 1 || kvh < 1 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  Params p{q, k, v, o, b, sq, skv, h, kvh,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_d<float>(p, d, st); break;
    case 1: err = dispatch_d<__nv_bfloat16>(p, d, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
