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
// where the taps past an edge are the clamped ones (g[2i-1] is g[0] at i = 0,
// g[2i+2] is g[2n-1] at i = n-1), first along H, then along W, as
// up2x_adjoint_plain orders it.
//
// Bound on the card, both kernels: bytes. Each output costs 6 (adjoint: 15)
// operations on 4 inputs, so the least time is (input + output) / 3.35 TB/s.
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
// Adjoint design: one thread per output (four runtime divisions and 16
// scalar loads each) is bound by its instructions, not its bytes: bf16
// cotangents, half the bytes, take as long as f32 ones. So a thread makes a
// kAdjRows x kAdjCols (1x4) block of outputs from its cotangent band, rows
// 2iy-1 .. 2iy+2R and columns 2ix-1 .. 2ix+2C, each clamped to the plane.
// Where the width is a multiple of kAdjCols and both tensors are 16-byte
// aligned, a band row's 2C interior columns come in 16-byte loads (two in
// f32, one in 16-bit) and its two halo columns as scalars, 4 load
// instructions per output in f32 and 3 in 16-bit, neighbouring threads'
// overlap left to L1; the block's output row is one 16-byte (f32) or 8-byte
// store. Elsewhere (odd or ragged widths, an unaligned view) the same band
// comes element by element, each column clamped, and the block stores only
// its outputs inside the plane. Taller blocks (2 or 4 rows: fewer loads per
// output) are no faster on the large planes, which run near the bytes'
// bound, and slower on 4x4 planes, which then give too few threads. The
// thread index splits into (plane, row group, column group) with FastDiv,
// as the forward's does, with its 64-bit plane offset and 32-bit offsets in
// a plane. Threads run in output order over all planes, so a block of 256
// threads covers 64 planes of 4x4 outputs. Both passes round as the plain
// version does (each tap 0.75 * (even + odd) + 0.25 * (left + right), no
// contraction; one rounding to the working dtype at the end), so the kernel
// gives its bits.

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

// The adjoint's block of outputs per thread: kAdjRows rows of kAdjCols
// columns. Its vector path needs kAdjCols % 4 == 0: a block row is whole
// 4-output stores and a band row's interior whole 16-byte loads.
constexpr int kAdjRows = 1;
constexpr int kAdjCols = 4;
constexpr bool kAdjVector = kAdjCols % 4 == 0;

// One tap of the adjoint along an axis, from the cotangents l = g[2i-1],
// e = g[2i], o = g[2i+1] and r = g[2i+2] (clamped), rounded as
// up2x_adjoint_plain rounds it
__device__ __forceinline__ float adjoint_tap(float l, float e, float o, float r) {
  return __fadd_rn(__fmul_rn(0.75f, __fadd_rn(e, o)), __fmul_rn(0.25f, __fadd_rn(l, r)));
}

template <typename T>
__device__ __forceinline__ float unpack(uint32_t b);
template <>
__device__ __forceinline__ float unpack<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(uint32_t b) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
}

// N elements at p (16-byte aligned; N * sizeof(T) a multiple of 16) as f32,
// in 16-byte loads
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + k);
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[k + 2 * j] = unpack<T>(u[j] & 0xffffu);
        v[k + 2 * j + 1] = unpack<T>(u[j] >> 16);
      }
    }
  }
}

// N outputs at p (aligned as store4 needs; N a multiple of 4)
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float q[4] = {v[k], v[k + 1], v[k + 2], v[k + 3]};
    store4(p + k, q);
  }
}

// One thread per block of kAdjRows x kAdjCols outputs, in output order over
// all planes: g (planes, 2h, 2w) -> gx (planes, h, w); col_groups =
// ceil(w / kAdjCols) blocks per row group, row_groups = ceil(h / kAdjRows)
// per plane. kVector: w % kAdjCols == 0 and both tensors 16-byte aligned.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
up2x_adjoint_kernel(const T* __restrict__ g, T* __restrict__ gx, uint32_t n_threads,
                    FastDiv col_groups, FastDiv row_groups, uint32_t h, uint32_t w) {
  constexpr int kBandRows = 2 * kAdjRows + 2;
  constexpr int kBandCols = 2 * kAdjCols + 2;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_threads) return;
  const uint32_t r = divide(t, col_groups);  // row group over all planes
  const uint32_t ix = (t - r * col_groups.d) * kAdjCols;
  const uint32_t plane = divide(r, row_groups);
  const uint32_t iy = (r - plane * row_groups.d) * kAdjRows;
  const uint32_t h2 = 2 * h, w2 = 2 * w;
  const T* p = g + static_cast<int64_t>(plane) * (h2 * w2);
  T* o = gx + static_cast<int64_t>(plane) * (h * w);

  // the band: rows 2iy-1 .. 2iy+2R, columns 2ix-1 .. 2ix+2C, clamped
  const uint32_t c_lo = ix > 0 ? 2 * ix - 1 : 0;
  const uint32_t c_hi = min(2 * ix + 2 * kAdjCols, w2 - 1);
  float band[kBandRows][kBandCols];
#pragma unroll
  for (int k = 0; k < kBandRows; ++k) {
    const uint32_t row = 2 * iy + k;  // one past the band row's index
    const T* q = p + (row > 0 ? min(row - 1, h2 - 1) : 0) * w2;
    band[k][0] = to_f32(q[c_lo]);
    band[k][kBandCols - 1] = to_f32(q[c_hi]);
    if constexpr (kVector) {
      load_vec<2 * kAdjCols>(q + 2 * ix, &band[k][1]);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * kAdjCols; ++j) band[k][1 + j] = to_f32(q[min(2 * ix + j, w2 - 1)]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < kAdjRows; ++rr) {
    float hz[kBandCols];  // along H: the block row's band columns
#pragma unroll
    for (int j = 0; j < kBandCols; ++j) {
      hz[j] = adjoint_tap(band[2 * rr][j], band[2 * rr + 1][j], band[2 * rr + 2][j],
                          band[2 * rr + 3][j]);
    }
    float out[kAdjCols];  // along W
#pragma unroll
    for (int c = 0; c < kAdjCols; ++c) {
      out[c] = adjoint_tap(hz[2 * c], hz[2 * c + 1], hz[2 * c + 2], hz[2 * c + 3]);
    }
    if (iy + rr < h) {  // a ragged last row group drops its rows past the plane
      T* o_row = o + (iy + rr) * w + ix;
      if constexpr (kVector) {
        store_vec<kAdjCols>(o_row, out);
      } else {
#pragma unroll
        for (int c = 0; c < kAdjCols; ++c) {
          if (ix + c < w) o_row[c] = from_f32<T>(out[c]);
        }
      }
    }
  }
}

// The host checks the sizes, as the forward's launch does: in-plane offsets
// (4 h w) and the thread count fit 31 bits.
template <typename T>
int launch_adjoint(const void* g, void* gx, int64_t planes, int64_t h, int64_t w,
                   cudaStream_t stream) {
  const int64_t col_groups = (w + kAdjCols - 1) / kAdjCols;
  const int64_t row_groups = (h + kAdjRows - 1) / kAdjRows;
  const int64_t n_threads = planes * row_groups * col_groups;
  if (4 * h * w >= (int64_t{1} << 31) || n_threads >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n_threads + kThreads - 1) / kThreads);
  const T* src = static_cast<const T*>(g);
  T* dst = static_cast<T*>(gx);
  const FastDiv cols = fast_div(static_cast<uint32_t>(col_groups));
  const FastDiv rows = fast_div(static_cast<uint32_t>(row_groups));
  if constexpr (kAdjVector) {
    if (w % kAdjCols == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(gx) % 16 == 0) {
      up2x_adjoint_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          src, dst, static_cast<uint32_t>(n_threads), cols, rows, static_cast<uint32_t>(h),
          static_cast<uint32_t>(w));
      return static_cast<int>(cudaGetLastError());
    }
  }
  up2x_adjoint_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
      src, dst, static_cast<uint32_t>(n_threads), cols, rows, static_cast<uint32_t>(h),
      static_cast<uint32_t>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

// g: contiguous (planes, 2h, 2w); gx: contiguous (planes, h, w), same dtype;
// 4 h w < 2^31 and planes * h * ceil(w / 4) < 2^31.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_up2x_adjoint(const void* g, void* gx, int dtype, int64_t planes,
                                       int64_t h, int64_t w, void* stream) {
  if (planes * h * w == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_adjoint<float>(g, gx, planes, h, w, s);
    case 1:
      return launch_adjoint<__half>(g, gx, planes, h, w, s);
    case 2:
      return launch_adjoint<__nv_bfloat16>(g, gx, planes, h, w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
