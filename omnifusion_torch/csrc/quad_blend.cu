// Static sparse quad gather-blend, the runtime op of both projections.
//
// Replaces the Pallas kernel omnifusion_tpu/ops/pallas_blend.py:_dm_blend_kernel
// (reached through quad_gather_blend_pallas for the merge and
// quad_gather_blend_pallas_cl for equi2pers). For every output pixel n and
// source row d (one (batch, channel) pair):
//
//   out[d, n] = sum_k sum_q w4[n, k, q] * src[d, (idx[n, k] + off_q) mod N_in]
//             + sum_{m in tail_ptr[n] .. tail_ptr[n+1]-1}
//                   sum_q tail_w[m, q] * src[d, (tail_idx[m] + off_q) mod N_in]
//
// with off = {0, 1, row_stride, row_stride + 1}, accumulated in f32 and
// stored as f32.
//
// Bound on the card: bytes. Each output does 4*K (+4 per tail entry)
// multiply-adds on data it gathers, far below the H100's ~20 flop/byte
// balance point, so the least time is (source + output + tables) / 3.35 TB/s.
//
// Design:
// - one thread per output pixel and up to kRows source rows: the thread
//   reads its table row once (one 16-byte load per quad weight) and reads
//   the four corners straight from the source, so there is no packed copy
//   of the source (the TPU kernel's _pack_dmajor and per-K column gathers)
//   and no padding of D;
// - the COO tail is walked as the pixel's own CSR segment, so the sum needs
//   no atomics and is deterministic;
// - corner addresses wrap modulo N_in, exactly as the JAX roll does: the
//   corners idx+1, idx+W, idx+W+1 of the last row of the source point past
//   its end with weight 0;
// - src and out are addressed by (batch, channel, pixel) strides, so one
//   kernel serves the channel-first merge (B, C, N) and the channel-last
//   equi2pers (B, N, C) with no transposes;
// - every offset is 64-bit: B * C * N_in passes 2^31 at large batch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int64_t wrap(int64_t j, int64_t n_in) {
  return j >= n_in ? j - n_in : j;
}

template <typename T>
__device__ __forceinline__ void add_quad(float (&acc)[kRows], const T* __restrict__ src,
                                         const int64_t (&base)[kRows], int rows,
                                         int64_t j, float4 w, int64_t row_stride,
                                         int64_t n_in, int64_t s_p) {
  const int64_t j0 = j * s_p;
  const int64_t j1 = wrap(j + 1, n_in) * s_p;
  const int64_t j2 = wrap(j + row_stride, n_in) * s_p;
  const int64_t j3 = wrap(j + row_stride + 1, n_in) * s_p;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      const T* s = src + base[r];
      acc[r] += w.x * to_f32(s[j0]) + w.y * to_f32(s[j1]) + w.z * to_f32(s[j2]) +
                w.w * to_f32(s[j3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_blend_kernel(const T* __restrict__ src, float* __restrict__ out,
                  const int32_t* __restrict__ idx, const float4* __restrict__ w4, int k_slots,
                  const int32_t* __restrict__ tail_ptr, const int32_t* __restrict__ tail_idx,
                  const float4* __restrict__ tail_w, int64_t n_rows, int64_t channels,
                  int64_t n_in, int64_t n_out, int64_t row_stride, int64_t s_b, int64_t s_c,
                  int64_t s_p, int64_t o_b, int64_t o_c, int64_t o_p) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= n_out) return;
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int rows = static_cast<int>(n_rows - d0 < kRows ? n_rows - d0 : kRows);

  int64_t base[kRows];
  int64_t obase[kRows];
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t d = d0 + (r < rows ? r : 0);
    const int64_t b = d / channels;
    const int64_t c = d - b * channels;
    base[r] = b * s_b + c * s_c;
    obase[r] = b * o_b + c * o_c;
    acc[r] = 0.0f;
  }

  for (int k = 0; k < k_slots; ++k) {
    const int64_t slot = n * k_slots + k;
    add_quad(acc, src, base, rows, static_cast<int64_t>(idx[slot]), w4[slot], row_stride,
             n_in, s_p);
  }
  if (tail_ptr != nullptr) {
    const int32_t m1 = tail_ptr[n + 1];
    for (int32_t m = tail_ptr[n]; m < m1; ++m) {
      add_quad(acc, src, base, rows, static_cast<int64_t>(tail_idx[m]), tail_w[m],
               row_stride, n_in, s_p);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[obase[r] + n * o_p] = acc[r];
  }
}

template <typename T>
void launch(const void* src, float* out, const int32_t* idx, const float* w4, int k_slots,
            const int32_t* tail_ptr, const int32_t* tail_idx, const float* tail_w,
            int64_t n_rows, int64_t channels, int64_t n_in, int64_t n_out, int64_t row_stride,
            int64_t s_b, int64_t s_c, int64_t s_p, int64_t o_b, int64_t o_c, int64_t o_p,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  quad_blend_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), out, idx, reinterpret_cast<const float4*>(w4), k_slots,
      tail_ptr, tail_idx, reinterpret_cast<const float4*>(tail_w), n_rows, channels, n_in,
      n_out, row_stride, s_b, s_c, s_p, o_b, o_c, o_p);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. tail_ptr == nullptr: no tail.
// n_rows = B * C rows, each at src + b*s_b + c*s_c with pixel stride s_p.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_quad_blend(const void* src, int dtype, float* out, const int32_t* idx,
                                     const float* w4, int k_slots, const int32_t* tail_ptr,
                                     const int32_t* tail_idx, const float* tail_w,
                                     int64_t n_rows, int64_t channels, int64_t n_in,
                                     int64_t n_out, int64_t row_stride, int64_t s_b,
                                     int64_t s_c, int64_t s_p, int64_t o_b, int64_t o_c,
                                     int64_t o_p, void* stream) {
  if (n_out == 0 || n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(src, out, idx, w4, k_slots, tail_ptr, tail_idx, tail_w, n_rows, channels,
                    n_in, n_out, row_stride, s_b, s_c, s_p, o_b, o_c, o_p, s);
      break;
    case 1:
      launch<__half>(src, out, idx, w4, k_slots, tail_ptr, tail_idx, tail_w, n_rows, channels,
                     n_in, n_out, row_stride, s_b, s_c, s_p, o_b, o_c, o_p, s);
      break;
    case 2:
      launch<__nv_bfloat16>(src, out, idx, w4, k_slots, tail_ptr, tail_idx, tail_w, n_rows,
                            channels, n_in, n_out, row_stride, s_b, s_c, s_p, o_b, o_c, o_p,
                            s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
