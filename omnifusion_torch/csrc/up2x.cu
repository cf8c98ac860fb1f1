// Exact 2x bilinear upsample (half-pixel centres, align_corners=False), and
// its adjoint.
//
// Replaces the Pallas kernel omnifusion_tpu/ops/pallas_resize.py:_up2x_kernel
// (reached through upsample2x_bilinear). On (N*C, H, W) planes, separable and
// edge-clamped:
//
//   out[2i]   = 0.25 * in[i-1] + 0.75 * in[i]
//   out[2i+1] = 0.75 * in[i]   + 0.25 * in[i+1]
//
// first along W, then along H, as the TPU kernel orders it.
//
// The adjoint replaces the XLA resize transpose that the Pallas kernel's
// custom VJP borrows (pallas_resize.py:161-170; the JAX package has no Pallas
// kernel for it). Per axis, on a side of n inputs:
//
//   gx[i] = 0.75 * (g[2i] + g[2i+1]) + 0.25 * (g[2i-1] + g[2i+2])
//
// with taps past an edge dropped and the clamped taps added back on the
// border rows (gx[0] += 0.25 * g[0], gx[n-1] += 0.25 * g[2n-1]); in 2-D a
// 4x4 gather per input element, one thread each, no atomics.
//
// Bound on the card, both kernels: bytes. Each output costs 6 (adjoint: up
// to 20) multiply-adds on 4 (16) inputs, so the least time is
// (input + output) / 3.35 TB/s.
//
// Design: one thread per output element, in output order, so neighbouring
// threads write neighbouring addresses and read the same or neighbouring
// input pixels (the 2x2 neighbourhood is served from L1/L2; each input is
// fetched from device memory about once). The clamps are the stencil's edge
// condition, so a 1-pixel side (patch-32 configs reach 1x1 -> 2x2) needs no
// special case. The TPU kernel's row blocks, halo inputs and VMEM budget
// have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The two input taps of output coordinate o along a side of n inputs, with
// their weights: (lo, w_lo) and (hi, w_hi), edge-clamped.
template <typename I>
__device__ __forceinline__ void taps(I o, I n, I& lo, I& hi, float& w_lo, float& w_hi) {
  const I i = o >> 1;
  if (o & 1) {
    lo = i;
    hi = i + 1 < n ? i + 1 : n - 1;
    w_lo = 0.75f;
    w_hi = 0.25f;
  } else {
    lo = i > 0 ? i - 1 : 0;
    hi = i;
    w_lo = 0.25f;
    w_hi = 0.75f;
  }
}

// I: the index type, 32-bit where every offset fits (the divisions and
// remainders of the output index are then 32-bit, several times cheaper
// than 64-bit ones), else 64-bit.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
up2x_kernel(const T* __restrict__ x, T* __restrict__ y, I planes, I h, I w) {
  const I w2 = 2 * w;
  const I h2 = 2 * h;
  const I total = planes * h2 * w2;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < total; i += stride) {
    const I ox = i % w2;
    const I t = i / w2;
    const I oy = t % h2;
    const I plane = t / h2;
    I x_lo, x_hi, y_lo, y_hi;
    float wx_lo, wx_hi, wy_lo, wy_hi;
    taps(ox, w, x_lo, x_hi, wx_lo, wx_hi);
    taps(oy, h, y_lo, y_hi, wy_lo, wy_hi);
    const T* p = x + plane * h * w;
    const float top = wx_lo * to_f32(p[y_lo * w + x_lo]) + wx_hi * to_f32(p[y_lo * w + x_hi]);
    const float bot = wx_lo * to_f32(p[y_hi * w + x_lo]) + wx_hi * to_f32(p[y_hi * w + x_hi]);
    y[i] = from_f32<T>(wy_lo * top + wy_hi * bot);
  }
}

// The four output taps of input coordinate i along a side of n inputs, with
// their adjoint weights; a tap past an edge gets weight 0 and an in-range
// address, and the clamped taps fold into the border weights (n = 1 gives
// weights {0, 1, 1, 0}: gx[0] = g[0] + g[1]).
template <typename I>
__device__ __forceinline__ void adjoint_taps(I i, I n, I (&o)[4], float (&wt)[4]) {
  o[0] = i > 0 ? 2 * i - 1 : 0;
  wt[0] = i > 0 ? 0.25f : 0.0f;
  o[1] = 2 * i;
  wt[1] = i == 0 ? 1.0f : 0.75f;
  o[2] = 2 * i + 1;
  wt[2] = i == n - 1 ? 1.0f : 0.75f;
  o[3] = i < n - 1 ? 2 * i + 2 : 2 * n - 1;
  wt[3] = i < n - 1 ? 0.25f : 0.0f;
}

// One thread per input element, in input order: g (planes, 2h, 2w) ->
// gx (planes, h, w).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
up2x_adjoint_kernel(const T* __restrict__ g, T* __restrict__ gx, I planes, I h, I w) {
  const I w2 = 2 * w;
  const I total = planes * h * w;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < total; i += stride) {
    const I ix = i % w;
    const I t = i / w;
    const I iy = t % h;
    const I plane = t / h;
    I ox[4], oy[4];
    float wx[4], wy[4];
    adjoint_taps(ix, w, ox, wx);
    adjoint_taps(iy, h, oy, wy);
    const T* p = g + plane * (4 * h * w);
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (wy[a] != 0.0f) {
        const T* row = p + oy[a] * w2;
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) s += wx[b] * to_f32(row[ox[b]]);
        acc += wy[a] * s;
      }
    }
    gx[i] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* x, void* y, int64_t planes, int64_t h, int64_t w, cudaStream_t stream) {
  const int64_t total = planes * 4 * h * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;  // grid-stride loop covers the rest
  // 32-bit indices only while i + stride cannot overflow either
  if (total + blocks * kThreads < (int64_t{1} << 31)) {
    up2x_kernel<T, int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<int32_t>(planes),
        static_cast<int32_t>(h), static_cast<int32_t>(w));
  } else {
    up2x_kernel<T, int64_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), planes, h, w);
  }
}

template <typename T>
void launch_adjoint(const void* g, void* gx, int64_t planes, int64_t h, int64_t w,
                    cudaStream_t stream) {
  const int64_t total = planes * h * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;  // grid-stride loop covers the rest
  // 32-bit indices only while every offset into g (4 * total) and i + stride fit
  if (4 * total + blocks * kThreads < (int64_t{1} << 31)) {
    up2x_adjoint_kernel<T, int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(gx), static_cast<int32_t>(planes),
        static_cast<int32_t>(h), static_cast<int32_t>(w));
  } else {
    up2x_adjoint_kernel<T, int64_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(gx), planes, h, w);
  }
}

}  // namespace

// x: contiguous (planes, h, w); y: contiguous (planes, 2h, 2w), same dtype.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_up2x(const void* x, void* y, int dtype, int64_t planes, int64_t h,
                               int64_t w, void* stream) {
  if (planes * h * w == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(x, y, planes, h, w, s);
      break;
    case 1:
      launch<__half>(x, y, planes, h, w, s);
      break;
    case 2:
      launch<__nv_bfloat16>(x, y, planes, h, w, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: contiguous (planes, 2h, 2w); gx: contiguous (planes, h, w), same dtype.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_up2x_adjoint(const void* g, void* gx, int dtype, int64_t planes,
                                       int64_t h, int64_t w, void* stream) {
  if (planes * h * w == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_adjoint<float>(g, gx, planes, h, w, s);
      break;
    case 1:
      launch_adjoint<__half>(g, gx, planes, h, w, s);
      break;
    case 2:
      launch_adjoint<__nv_bfloat16>(g, gx, planes, h, w, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
