// The epilogue of a convolution whose eval-mode BatchNorm is folded into it
// (models/layers.py: conv_bn_relu), in place on the convolution's output y:
//
//   y = relu(y * scale[c] + bias[c])                        no residual
//   y = relu(T(y * scale[c] + bias[c]) + r)                 with a residual
//   r = z, or T(z * z_scale[c] + z_bias[c])                 (a shortcut's)
//
// where c is the element's channel, T() a rounding to y's type, scale and
// bias the BatchNorm's f32 affine map (scale = gamma / sqrt(var + eps), bias
// = beta - mean * scale), z the residual: a BasicBlock's identity, or its
// downsample convolution's output with that BatchNorm's map. One pass where
// the unfolded trunk runs three (BatchNorm, the residual add, ReLU).
//
// The roundings are the trunk's bf16 recipe's: a BatchNorm's output is a bf16
// activation, and so is the residual sum (the result's T, after the ReLU,
// which commutes with it). Summing a block's two branches in f32 and
// rounding once moved the iterative model's pass-2 depth (its input is pass
// 1's) by as much as the recipe's own distance from f32, against the unfolded
// trunk and the benchmark's reference, both of which round there (PERF.md §6).
// Without a residual the one rounding is the recipe's.
//
// Why the scale is here and not in the weight: folding it into the weight
// rounds W * scale to bf16 anew, a rounding of every weight that the trunk's
// bf16 recipe does not make; on some seeds of the iterative model it moved
// the served depth several times farther from the f32 model's (PERF.md §6).
// The weight stays bf16(W) and the convolution's output its bf16 store.
//
// Bound on the card: bytes. y is read and written once and z read once; each
// element costs a few operations, so the least time is (2 + residual) |y| /
// 3.35 TB/s.
//
// Design: one thread per 16-byte vector of y (8 channels in bf16, 4 in
// f32), in memory order, z's vector loaded beside it. In a channels-last y
// (NHWC in memory) a vector holds V consecutive channels of one pixel: its
// scale and bias are V floats each, 16-byte loads that L1 serves to every
// pixel after the first. In a contiguous NCHW y (the geometric embedding's
// maps) a vector holds V pixels of one channel: one float each. The channel
// of a vector is one 32-bit division. Where the vectors do not fit (channels
// or a plane no vector divides, an operand off 16-byte alignment, 2^31
// vectors or more: small maps of other configurations) a second form takes
// one element a thread, in a grid-stride loop, with the same sums.
//
// dtypes: f32 and bf16, the trunk's two (no model runs an f16 trunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 to_f32x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t from_f32x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x rounded to T and back (no change for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The V = 16 / sizeof(T) values of the 16-byte vector at p, as f32, and back
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  } else {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = to_f32x2(u[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint4 q;
  if constexpr (sizeof(T) == 4) {
    q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
  } else {
    q = make_uint4(from_f32x2(v[0], v[1]), from_f32x2(v[2], v[3]), from_f32x2(v[4], v[5]),
                   from_f32x2(v[6], v[7]));
  }
  *reinterpret_cast<uint4*>(p) = q;
}

// V per-channel floats from p + c0 (kNhwc: channels c0 .. c0 + V - 1, 16-byte
// loads) or the one float of channel c0, repeated
template <int V, bool kNhwc>
__device__ __forceinline__ void load_channels(const float* p, uint32_t c0, float* v) {
  if constexpr (kNhwc) {
    const float4* q = reinterpret_cast<const float4*>(p + c0);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = __ldg(q + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
    const float f = __ldg(p + c0);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = f;
  }
}

// n_vec vectors of y (and of z, when there is one). kNhwc: a vector's
// channels start at (v mod per) * V, per = c / V; otherwise its channel is
// (v / per) mod c, per = h w / V.
template <typename T, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(T* __restrict__ y, const T* __restrict__ z, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ z_scale,
                const float* __restrict__ z_bias, uint32_t n_vec, uint32_t per, uint32_t c) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const int64_t at = static_cast<int64_t>(v) * V;
  const uint32_t c0 = kNhwc ? (v % per) * V : (v / per) % c;
  float a[V], s[V], b[V];
  load16(y + at, a);
  load_channels<V, kNhwc>(scale, c0, s);
  load_channels<V, kNhwc>(bias, c0, b);
  // rounded as the plain version rounds, each product and sum on its own (no
  // contraction)
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = __fadd_rn(__fmul_rn(a[k], s[k]), b[k]);
  if (z != nullptr) {
    load16(z + at, b);
    if (z_scale != nullptr) {
      load_channels<V, kNhwc>(z_scale, c0, s);
#pragma unroll
      for (int k = 0; k < V; ++k) b[k] = __fmul_rn(b[k], s[k]);
      load_channels<V, kNhwc>(z_bias, c0, s);
#pragma unroll
      for (int k = 0; k < V; ++k) b[k] = round_to<T>(__fadd_rn(b[k], s[k]));
    }
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = __fadd_rn(round_to<T>(a[k]), b[k]);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = fmaxf(a[k], 0.0f);
  store16(y + at, a);
}

// The same sums one element a thread, for what the vectors do not fit: the
// channel of element i is i mod c (kNhwc) or (i / hw) mod c.
template <typename T, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
epilogue_scalar_kernel(T* __restrict__ y, const T* __restrict__ z,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ z_scale, const float* __restrict__ z_bias,
                       int64_t n, int64_t c, int64_t hw) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t ch = kNhwc ? i % c : (i / hw) % c;
    float a = __fadd_rn(__fmul_rn(to_f32(y[i]), __ldg(scale + ch)), __ldg(bias + ch));
    if (z != nullptr) {
      float r = to_f32(z[i]);
      if (z_scale != nullptr) {
        r = round_to<T>(__fadd_rn(__fmul_rn(r, __ldg(z_scale + ch)), __ldg(z_bias + ch)));
      }
      a = __fadd_rn(round_to<T>(a), r);
    }
    y[i] = from_f32<T>(fmaxf(a, 0.0f));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(void* y, const void* z, const float* scale, const float* bias, const float* z_scale,
           const float* z_bias, int64_t n, int64_t c, int64_t hw, bool nhwc,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (c <= 0 || hw <= 0 || n % (c * hw) != 0) return static_cast<int>(cudaErrorInvalidValue);
  T* dst = static_cast<T*>(y);
  const T* res = static_cast<const T*>(z);
  const int64_t n_vec = n / V;
  // the per-channel floats are read as float4 in the NHWC vector form
  const bool vectors = (nhwc ? c % V : hw % V) == 0 && n_vec < (int64_t{1} << 31) &&
                       aligned16(y) && (z == nullptr || aligned16(z)) &&
                       (!nhwc || (aligned16(scale) && aligned16(bias) &&
                                  (z_scale == nullptr || (aligned16(z_scale) &&
                                                          aligned16(z_bias)))));
  if (vectors) {
    const unsigned blocks = static_cast<unsigned>((n_vec + kThreads - 1) / kThreads);
    const uint32_t per = static_cast<uint32_t>(nhwc ? c / V : hw / V);
    if (nhwc) {
      epilogue_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          dst, res, scale, bias, z_scale, z_bias, static_cast<uint32_t>(n_vec), per,
          static_cast<uint32_t>(c));
    } else {
      epilogue_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
          dst, res, scale, bias, z_scale, z_bias, static_cast<uint32_t>(n_vec), per,
          static_cast<uint32_t>(c));
    }
  } else {
    const unsigned blocks = static_cast<unsigned>(
        std::min<int64_t>((n + kThreads - 1) / kThreads, int64_t{1} << 20));
    if (nhwc) {
      epilogue_scalar_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          dst, res, scale, bias, z_scale, z_bias, n, c, hw);
    } else {
      epilogue_scalar_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
          dst, res, scale, bias, z_scale, z_bias, n, c, hw);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: n elements, channels-last (nhwc = 1) or contiguous NCHW (nhwc = 0),
// updated in place; z: null, or y's shape, memory order and dtype; scale,
// bias: c floats; z_scale, z_bias: both null, or c floats each (only with a
// z: a shortcut's BatchNorm). The 16-byte vector form runs where it fits
// (launch), the element form elsewhere.
// dtype: 0 = float32, 2 = bfloat16 (the codes of ops/_build.py).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_conv_epilogue(void* y, const void* z, int dtype, const void* scale,
                                        const void* bias, const void* z_scale,
                                        const void* z_bias, int64_t n, int64_t c, int64_t hw,
                                        int nhwc, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if ((z_scale == nullptr) != (z_bias == nullptr) || (z_scale != nullptr && z == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const float* zs = static_cast<const float*>(z_scale);
  const float* zb = static_cast<const float*>(z_bias);
  switch (dtype) {
    case 0:
      return launch<float>(y, z, s, b, zs, zb, n, c, hw, nhwc != 0, st);
    case 2:
      return launch<__nv_bfloat16>(y, z, s, b, zs, zb, n, c, hw, nhwc != 0, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
