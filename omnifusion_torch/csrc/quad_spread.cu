// Transposed static sparse quad gather-blend: the backward of both projections.
//
// Replaces the Pallas kernel omnifusion_tpu/ops/pallas_blend.py:_dm_spread_kernel
// (reached through spread_4plane and transposed_quad_gather_blend_pallas), with
// the overflow scatter and the three corner rolls around it. It computes the
// source gradient g_src = W^T g_out of the forward blend (quad_blend.cu) from
// the transposed tables (projection/spec.py: build_vjp_tables): for every
// source pixel i and row d (one (batch, channel) pair)
//
//   g[d, i] = sum_q  [ sum_k w_t[j_q, k, q] * cot[d, idx_t[j_q, k]]
//                    + sum_{m in over_ptr[j_q] .. over_ptr[j_q+1]-1}
//                          over_w[m, q] * cot[d, over_src[m]] ]
//
// with j_q = (i - off_q) mod N_in and off = {0, 1, row_stride, row_stride + 1}:
// the forward's corner q of the quad at j reads source pixel j + off_q, so
// the gradient of pixel i gathers corner q of the quads keyed at i - off_q.
// Accumulated in f32, stored as f32.
//
// Bound on the card: bytes. Each source pixel does a few multiply-adds per
// table entry on gathered data, far below the H100's ~20 flop/byte balance
// point, so the least time is (cotangent + gradient + tables) / 3.35 TB/s.
// What sets the time is the gathers and their balance over threads. Pixel
// i's load L(i), the summed length of the four overflow segments it reads,
// is 0 for most pixels of the merge but reaches 2,194 at the flagship's
// pole patch borders, where one thread per pixel walked it alone.
//
// Design: two launches on one stream; one writer per sum, the same bits
// every run.
// - The light kernel: one thread owns source pixel i across up to kRows
//   rows and reads the four table rows j_q itself, so the gradient is
//   written once, directly, with no planes and no rolls (the TPU kernel
//   spreads into four corner planes and rolls them: jnp.roll(x, s)[i] =
//   x[(i - s) mod N_in]); zero corner weights skip their gather. It reads
//   its four over_ptr pairs: if L(i) <= threshold it walks the four CSR
//   overflow segments itself, else it leaves them to the heavy kernel.
// - The heavy kernel: the pixels with L(i) > threshold, heaviest first (the
//   host's list), each with a team per row group: a whole block of 256
//   threads for the first n_wide (loads above a warp's share), a warp for
//   the rest, 8 to a block. The team strides over the concatenation of the
//   four segments, entry e to thread e mod team size, with per-row partial
//   sums; an entry's corner q is that of its segment. A __shfl_xor
//   butterfly per warp, then the warps' sums in warp order, fix the order of
//   every sum; one thread per row adds it to the light kernel's result.
//   Heaviest first, the longest walks start in the first wave.
// - What bounds the light kernel now: each dense entry is gathered once per
//   corner, by four threads (8 rows x 4 bytes each time, a 32-byte sector
//   of L2 for 4 useful bytes), up to 52M gathers at the merge's backward at
//   batch 8; a kernel that gathers each entry once and hands its four
//   corner sums to the neighbouring pixels would cut them fourfold.
// - j_q wraps modulo N_in, as the roll does: the quads of the last source row
//   shift their corners 01, 10, 11 onto the first pixels.
// - cot and g are addressed by (batch, channel, pixel) strides, so one
//   kernel serves the channel-first merge and the channel-last equi2pers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float corner(const float4& w, int q) {
  return q == 0 ? w.x : (q == 1 ? w.y : (q == 2 ? w.z : w.w));
}

template <typename T>
__device__ __forceinline__ void add_row(float (&acc)[kRows], const T* __restrict__ cot,
                                        const int64_t (&base)[kRows], int rows, int64_t n,
                                        float w, int64_t c_p) {
  const int64_t off = n * c_p;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) acc[r] += w * to_f32(cot[base[r] + off]);
  }
}

// The first row of blockIdx.y's group, and the group's row count.
__device__ __forceinline__ int row_group(int64_t n_rows, int64_t& d0) {
  d0 = static_cast<int64_t>(blockIdx.y) * kRows;
  return static_cast<int>(n_rows - d0 < kRows ? n_rows - d0 : kRows);
}

// Row d's offset for (batch, channel) strides s_b, s_c.
__device__ __forceinline__ int64_t row_offset(int64_t d, int64_t channels, int64_t s_b,
                                              int64_t s_c) {
  const int64_t b = d / channels;
  return b * s_b + (d - b * channels) * s_c;
}

// Each row of the group's offset in cot (rows past the end repeat the
// first, and are never used).
__device__ __forceinline__ void row_bases(int64_t d0, int rows, int64_t channels, int64_t c_b,
                                          int64_t c_c, int64_t (&base)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) base[r] = row_offset(d0 + (r < rows ? r : 0), channels, c_b, c_c);
}

// The table row j_q = (i - off_q) mod N_in whose corner q pixel i gathers.
__device__ __forceinline__ int64_t quad_row(int64_t i, int q, int64_t n_in, int64_t row_stride) {
  const int64_t off = q == 0 ? 0 : (q == 1 ? 1 : (q == 2 ? row_stride : row_stride + 1));
  const int64_t j = i - off % n_in;
  return j < 0 ? j + n_in : j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_spread_kernel(const T* __restrict__ cot, float* __restrict__ out,
                   const int32_t* __restrict__ idx_t, const float4* __restrict__ w_t, int k_t,
                   const int32_t* __restrict__ over_ptr, const int32_t* __restrict__ over_src,
                   const float4* __restrict__ over_w, int threshold, int64_t n_rows,
                   int64_t channels, int64_t n_in, int64_t row_stride, int64_t c_b, int64_t c_c,
                   int64_t c_p, int64_t o_b, int64_t o_c, int64_t o_p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
  int64_t d0;
  const int rows = row_group(n_rows, d0);
  int64_t base[kRows];
  row_bases(d0, rows, channels, c_b, c_c, base);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  // the pixel's load: a heavy pixel's overflow is the heavy kernel's
  bool light = true;
  if (over_ptr != nullptr) {
    int64_t load = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t j = quad_row(i, q, n_in, row_stride);
      load += over_ptr[j + 1] - over_ptr[j];
    }
    light = load <= threshold;
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t j = quad_row(i, q, n_in, row_stride);
    for (int k = 0; k < k_t; ++k) {
      const int64_t slot = j * k_t + k;
      const float w = corner(w_t[slot], q);
      if (w != 0.0f) add_row(acc, cot, base, rows, static_cast<int64_t>(idx_t[slot]), w, c_p);
    }
    if (light && over_ptr != nullptr) {
      const int32_t m1 = over_ptr[j + 1];
      for (int32_t m = over_ptr[j]; m < m1; ++m) {
        const float w = corner(over_w[m], q);
        if (w != 0.0f) add_row(acc, cot, base, rows, static_cast<int64_t>(over_src[m]), w, c_p);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[row_offset(d0 + r, channels, o_b, o_c) + i * o_p] = acc[r];
  }
}

// The heavy pixels, heaviest first: each of the first n_wide (the loads
// above a warp's share) takes a whole block, the rest a warp each, kWarps to
// a block. A pixel's team strides over its four segments laid end to end
// (entry e < ends[0] is corner 0's, e < ends[1] corner 1's, ...), then sums
// its per-row partials in a fixed order and adds them to out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_spread_heavy_kernel(const T* __restrict__ cot, float* __restrict__ out,
                         const int32_t* __restrict__ heavy, int64_t n_heavy, int64_t n_wide,
                         const int32_t* __restrict__ over_ptr,
                         const int32_t* __restrict__ over_src, const float4* __restrict__ over_w,
                         int64_t n_rows, int64_t channels, int64_t n_in, int64_t row_stride,
                         int64_t c_b, int64_t c_c, int64_t c_p, int64_t o_b, int64_t o_c,
                         int64_t o_p) {
  __shared__ float partial[kWarps][kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool wide = blockIdx.x < n_wide;
  const int64_t h = wide ? static_cast<int64_t>(blockIdx.x)
                         : n_wide + (static_cast<int64_t>(blockIdx.x) - n_wide) * kWarps + warp;
  if (h >= n_heavy) return;  // a warp past the end of the list (never in a wide block)
  const int64_t i = heavy[h];
  const int team = wide ? kThreads : 32;
  const int rank = wide ? static_cast<int>(threadIdx.x) : lane;

  int64_t d0;
  const int rows = row_group(n_rows, d0);
  int64_t base[kRows];
  row_bases(d0, rows, channels, c_b, c_c, base);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  int32_t m0[4], ends[4];
  int32_t end = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t j = quad_row(i, q, n_in, row_stride);
    m0[q] = over_ptr[j];
    end += over_ptr[j + 1] - m0[q];
    ends[q] = end;
  }
  for (int32_t e = rank; e < end; e += team) {
    int q;
    int32_t m;
    if (e < ends[0]) {
      q = 0;
      m = m0[0] + e;
    } else if (e < ends[1]) {
      q = 1;
      m = m0[1] + (e - ends[0]);
    } else if (e < ends[2]) {
      q = 2;
      m = m0[2] + (e - ends[1]);
    } else {
      q = 3;
      m = m0[3] + (e - ends[2]);
    }
    const float w = corner(over_w[m], q);
    if (w != 0.0f) add_row(acc, cot, base, rows, static_cast<int64_t>(over_src[m]), w, c_p);
  }

  // fixed-order sums: a butterfly in each warp (every lane ends with the
  // same bits), then, in a wide block, the warps' sums in warp order
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], s);
  }
  if (wide) {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) partial[warp][r] = acc[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] = 0.0f;
      for (int k = 0; k < kWarps; ++k) acc[r] += partial[k][r];
    }
    if (warp != 0) return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {  // lane r adds row r (r is a constant here)
    if (lane == r && r < rows) out[row_offset(d0 + r, channels, o_b, o_c) + i * o_p] += acc[r];
  }
}

template <typename T>
void launch(const void* cot, float* out, const int32_t* idx_t, const float* w_t, int k_t,
            const int32_t* over_ptr, const int32_t* over_src, const float* over_w,
            int threshold, const int32_t* heavy, int64_t n_heavy, int64_t n_wide,
            int64_t n_rows, int64_t channels, int64_t n_in, int64_t row_stride, int64_t c_b,
            int64_t c_c, int64_t c_p, int64_t o_b, int64_t o_c, int64_t o_p,
            cudaStream_t stream) {
  const unsigned groups = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  const dim3 grid(static_cast<unsigned>((n_in + kThreads - 1) / kThreads), groups);
  quad_spread_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(cot), out, idx_t, reinterpret_cast<const float4*>(w_t), k_t,
      over_ptr, over_src, reinterpret_cast<const float4*>(over_w), threshold, n_rows, channels,
      n_in, row_stride, c_b, c_c, c_p, o_b, o_c, o_p);
  if (n_heavy == 0 || cudaPeekAtLastError() != cudaSuccess) return;
  const int64_t blocks = n_wide + (n_heavy - n_wide + kWarps - 1) / kWarps;
  quad_spread_heavy_kernel<T><<<dim3(static_cast<unsigned>(blocks), groups), kThreads, 0,
                                stream>>>(
      static_cast<const T*>(cot), out, heavy, n_heavy, n_wide, over_ptr, over_src,
      reinterpret_cast<const float4*>(over_w), n_rows, channels, n_in, row_stride, c_b, c_c, c_p,
      o_b, o_c, o_p);
}

}  // namespace

// dtype (of cot): 0 = float32, 1 = float16, 2 = bfloat16. over_ptr == nullptr:
// no overflow. n_rows = B * C rows, each at cot + b*c_b + c*c_c with pixel
// stride c_p over n_cot pixels; out has n_in pixels per row. threshold: the
// light kernel walks the overflow of a pixel whose load is at most this;
// heavy: the n_heavy pixels whose load is above it, heaviest first, of which
// the first n_wide take a block each and the rest a warp each.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int omnifusion_quad_spread(const void* cot, int dtype, float* out,
                                      const int32_t* idx_t, const float* w_t, int k_t,
                                      const int32_t* over_ptr, const int32_t* over_src,
                                      const float* over_w, int threshold, const int32_t* heavy,
                                      int64_t n_heavy, int64_t n_wide, int64_t n_rows,
                                      int64_t channels, int64_t n_cot, int64_t n_in,
                                      int64_t row_stride, int64_t c_b, int64_t c_c, int64_t c_p,
                                      int64_t o_b, int64_t o_c, int64_t o_p, void* stream) {
  (void)n_cot;  // the tables' entries index the cotangent; the wrapper checks its size
  if (n_in == 0 || n_rows == 0) return static_cast<int>(cudaGetLastError());
  if (n_wide < 0 || n_wide > n_heavy || (n_heavy > 0 && over_ptr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, threshold, heavy,
                    n_heavy, n_wide, n_rows, channels, n_in, row_stride, c_b, c_c, c_p,
                    o_b, o_c, o_p, s);
      break;
    case 1:
      launch<__half>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, threshold, heavy,
                     n_heavy, n_wide, n_rows, channels, n_in, row_stride, c_b, c_c, c_p,
                     o_b, o_c, o_p, s);
      break;
    case 2:
      launch<__nv_bfloat16>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, threshold,
                            heavy, n_heavy, n_wide, n_rows, channels, n_in, row_stride,
                            c_b, c_c, c_p, o_b, o_c, o_p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
