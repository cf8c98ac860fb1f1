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
// 4x4 gather per input element, one thread (the only writer) each.
//
// Bound on the card, both kernels: bytes. Each output costs 6 (adjoint: up
// to 20) multiply-adds on 4 (16) inputs, so the least time is
// (input + output) / 3.35 TB/s.
//
// Forward design: the time is the bytes only if each output costs little
// more than its store, so a thread makes a 2x4 output block, from two
// neighbouring input pixels of one row and the 3x4 inputs around them (the
// 12 loads of 8 outputs: neighbouring threads read neighbouring inputs,
// which L1 and L2 serve after the first read). Its two output rows are one
// 16-byte (f32) or 8-byte (16-bit) store each, neighbouring threads on
// neighbouring addresses; on an odd side a row's offsets are not aligned and
// it stores element by element. The flat thread index splits into (plane,
// row, pair) with two multiply-shift divisions by divisors the host
// precomputes; the plane's offset is 64-bit, once per thread, and offsets in
// a plane are 32-bit, so every batch, past 2^31 outputs too, takes the same
// code. Threads run in input order over all planes, so a block of 256
// threads covers 32 planes of 4x4 inputs or 8 rows of 64x64: small planes
// fill blocks as large ones do. The clamps are the stencil's edge
// condition, so a 1-pixel side (patch-32 configs reach 1x1 -> 2x2) and odd
// sides need no special case. Each tap is rounded as the plain version
// rounds it (0.25 * a and 0.75 * b, then their sum; no contraction), so the
// kernel gives its bits. The TPU kernel's row blocks, halo inputs and VMEM
// budget have no counterpart here.
//
// Adjoint design: one thread per input element, in input order (below).

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

// n / d and n mod d for n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): mul = ceil(2^(31 + l) / d) with l = ceil(log2 d) fits 32 bits,
// and the quotient is umulhi(n, mul) >> (l - 1); d = 1 is its own case.
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv fast_div(uint32_t d) {
  if (d == 1) return {1, 0, 0};
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint64_t p = uint64_t{1} << (31 + l);
  return {d, static_cast<uint32_t>((p + d - 1) / d), l - 1};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

// The two outputs of input i along an axis, from its neighbours a = in[i-1]
// and c = in[i+1] (edge-clamped), rounded as up2x_plain rounds them
__device__ __forceinline__ float lo_tap(float a, float b) {
  return __fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.75f, b));
}
__device__ __forceinline__ float hi_tap(float b, float c) {
  return __fadd_rn(__fmul_rn(0.75f, b), __fmul_rn(0.25f, c));
}

__device__ __forceinline__ uint32_t bits(__half v) { return __half_as_ushort(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Four outputs at p, 4-element aligned: one 16-byte (f32) or 8-byte store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  const uint32_t lo = bits(from_f32<T>(v[0])) | (bits(from_f32<T>(v[1])) << 16);
  const uint32_t hi = bits(from_f32<T>(v[2])) | (bits(from_f32<T>(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// One thread per pair of neighbouring input pixels (2t, 2t+1) of one input
// row: x (planes, h, w) -> y (planes, 2h, 2w); pairs = ceil(w / 2) per row,
// planes * h * pairs threads in all.
template <typename T>
__global__ void __launch_bounds__(kThreads)
up2x_kernel(const T* __restrict__ x, T* __restrict__ y, uint32_t n_threads, FastDiv pairs,
            FastDiv rows, uint32_t w) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_threads) return;
  const uint32_t r = divide(g, pairs);  // input row over all planes
  const uint32_t t = g - r * pairs.d;
  const uint32_t plane = divide(r, rows);
  const uint32_t iy = r - plane * rows.d;
  const uint32_t h = rows.d;
  const T* p = x + static_cast<int64_t>(plane) * (h * w);
  T* o = y + static_cast<int64_t>(plane) * (4 * h * w);

  const uint32_t c1 = 2 * t;  // the pair's first input column
  const uint32_t cols[4] = {c1 > 0 ? c1 - 1 : 0, c1, c1 + 1 < w ? c1 + 1 : w - 1,
                            c1 + 2 < w ? c1 + 2 : w - 1};
  const uint32_t in_rows[3] = {(iy > 0 ? iy - 1 : 0) * w, iy * w, (iy + 1 < h ? iy + 1 : h - 1) * w};
  // along W: the four outputs of the pair in each of the three input rows
  float hz[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = to_f32(p[in_rows[k] + cols[c]]);
    hz[k][0] = lo_tap(a[0], a[1]);
    hz[k][1] = hi_tap(a[1], a[2]);
    hz[k][2] = lo_tap(a[1], a[2]);
    hz[k][3] = hi_tap(a[2], a[3]);
  }
  // along H: output rows 2 iy and 2 iy + 1
  float top[4], bot[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    top[c] = lo_tap(hz[0][c], hz[1][c]);
    bot[c] = hi_tap(hz[1][c], hz[2][c]);
  }
  const uint32_t w2 = 2 * w;
  T* o_top = o + 2 * iy * w2 + 2 * c1;
  T* o_bot = o_top + w2;
  if ((w & 1) == 0) {  // every row offset is a multiple of 4 elements
    store4(o_top, top);
    store4(o_bot, bot);
  } else {
    const int n = c1 + 1 < w ? 4 : 2;  // the last pair of an odd row has one pixel
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < n) {
        o_top[c] = from_f32<T>(top[c]);
        o_bot[c] = from_f32<T>(bot[c]);
      }
    }
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

// The host checks the sizes: in-plane offsets (4 h w) and the thread count
// fit 31 bits, so the divisions' operands do too.
template <typename T>
int launch(const void* x, void* y, int64_t planes, int64_t h, int64_t w, cudaStream_t stream) {
  const int64_t pairs = (w + 1) / 2;
  const int64_t n_threads = planes * h * pairs;
  if (4 * h * w >= (int64_t{1} << 31) || n_threads >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  up2x_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<uint32_t>(n_threads),
      fast_div(static_cast<uint32_t>(pairs)), fast_div(static_cast<uint32_t>(h)),
      static_cast<uint32_t>(w));
  return static_cast<int>(cudaGetLastError());
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
// x: contiguous (planes, h, w); y: contiguous (planes, 2h, 2w), same dtype,
// 16-byte aligned; 4 h w < 2^31 and planes * h * ceil(w / 2) < 2^31.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_up2x(const void* x, void* y, int dtype, int64_t planes, int64_t h,
                               int64_t w, void* stream) {
  if (planes * h * w == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, planes, h, w, s);
    case 1:
      return launch<__half>(x, y, planes, h, w, s);
    case 2:
      return launch<__nv_bfloat16>(x, y, planes, h, w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
