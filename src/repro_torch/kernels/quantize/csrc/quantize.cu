// Int8 block quantization by absmax for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/quantize/kernel.py
// (_quantize_kernel, launched by quantize_fwd).  Same function, row by
// row of x (nb, block) f32:
//
//   scale[r] = max(max_j |x[r, j]| / 127, 1e-12)
//   q[r, j]  = clip(round_half_even(x[r, j] / scale[r]), -127, 127)
//
// q (nb, block) int8, scale (nb,) f32.  The results are bit for bit those
// of the plain version (ref.quantize_plain): both the absmax / 127 and the
// x / scale are IEEE quotients (div.rn.f32; the build uses neither
// --use_fast_math nor -prec-div=false), never products with a
// reciprocal, and the rounding is to nearest even (__float2int_rn).  A
// row holding a NaN gets a NaN scale, as the plain version's does.
//
// What bounds it on this card.  It reads 4 bytes and writes 1 per
// element, plus 4 bytes of scale per row: 5.0156 bytes per element at
// block 256, and a handful of operations per element.  Bytes bound it:
// the largest gradient leaf of stablelm-1.6b (24 x 2048 x 5632 = 276.8 M
// values) moves 1.39 GB, 0.414 ms at 3.35 TB/s.
//
// The design.  The TPU kernel takes a (64, block) tile per grid step.
// Here one warp owns one row: each lane loads block / 32 contiguous
// floats (one or two 16-byte loads), the absmax is a __shfl_xor_sync
// butterfly, and each lane stores its block / 32 int8 values in one 4-
// or 8-byte store.  Warps walk the rows with a grid stride, the grid
// holding one full wave of 256-thread blocks, so any nb >= 1 works and
// every SM keeps its warps' loads in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block (8 warps)
constexpr unsigned FULL = 0xffffffffu;

template <int BLOCK>
__global__ void __launch_bounds__(NT)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long nb) {
  constexpr int PER = BLOCK / 32;       // values per lane: 4 or 8
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (NT / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (NT / 32) +
                       (threadIdx.x >> 5);
       row < nb; row += nwarps) {
    const float* xr = x + row * BLOCK + lane * PER;
    float v[PER];
#pragma unroll
    for (int i = 0; i < PER; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(xr + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
    float m = 0.0f;
    bool nan = false;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      m = fmaxf(m, fabsf(v[i]));
      nan |= isnan(v[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float scale = fmaxf(m / 127.0f, 1e-12f);     // IEEE quotient
    if (__any_sync(FULL, nan)) scale = __int_as_float(0x7fc00000);
    uint32_t packed[PER / 4];
#pragma unroll
    for (int w = 0; w < PER / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = __float2int_rn(v[4 * w + j] / scale);  // half to even
        r = min(max(r, -127), 127);
        word |= (static_cast<uint32_t>(r) & 0xffu) << (8 * j);
      }
      packed[w] = word;
    }
    int8_t* qr = q + row * BLOCK + lane * PER;
    if constexpr (PER == 8) {
      *reinterpret_cast<uint2*>(qr) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr) = packed[0];
    }
    if (lane == 0) scales[row] = scale;
  }
}

template <int BLOCK>
cudaError_t launch(const float* x, int8_t* q, float* scales, long long nb,
                   int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quantize_kernel<BLOCK>, NT, 0);
  if (err != cudaSuccess) return err;
  const long long want = (nb + NT / 32 - 1) / (NT / 32);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(want < wave ? want : wave);
  quantize_kernel<BLOCK><<<grid, NT, 0, stream>>>(x, q, scales, nb);
  return cudaGetLastError();
}

}  // namespace

// x (nb, block) f32, q (nb, block) int8, scales (nb,) f32; all contiguous,
// x 16-byte aligned.  block is 128 or 256.  `device` is the index of the
// card the tensors and `stream` belong to (this library links its own
// CUDA runtime, whose current device is not the caller's).  Returns the
// CUDA error of the launch (0 = cudaSuccess); the launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int quantize_fwd(const void* x, void* q, void* scales,
                            long long nb, int block, int device,
                            void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  int8_t* qi = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: err = launch<128>(xf, qi, sf, nb, device, st); break;
    case 256: err = launch<256>(xf, qi, sf, nb, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
