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
//
// Design:
// - the TPU kernel spreads each cotangent into four corner planes in memory
//   and a later pass rolls and sums them (jnp.roll(x, s)[i] = x[(i - s) mod
//   N_in]); here one thread owns source pixel i across up to kRows rows and
//   reads the four table rows j_q itself, so the gradient is written once,
//   directly, with no planes and no rolls;
// - the overflow (sorted by destination) is walked as the CSR segments of
//   the same four j_q, so there are no atomics and the sum is deterministic;
// - zero weights (padding slots, folded corners) skip their gather;
// - j_q wraps modulo N_in, as the roll does: the quads of the last source row
//   shift their corners 01, 10, 11 onto the first pixels;
// - cot and g are addressed by (batch, channel, pixel) strides, so one
//   kernel serves the channel-first merge and the channel-last equi2pers;
// - known cost: a thread whose four segments are long (the merge's heaviest
//   source pixel has ~1000 overflow entries) walks them alone.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_spread_kernel(const T* __restrict__ cot, float* __restrict__ out,
                   const int32_t* __restrict__ idx_t, const float4* __restrict__ w_t, int k_t,
                   const int32_t* __restrict__ over_ptr, const int32_t* __restrict__ over_src,
                   const float4* __restrict__ over_w, int64_t n_rows, int64_t channels,
                   int64_t n_in, int64_t row_stride, int64_t c_b, int64_t c_c, int64_t c_p,
                   int64_t o_b, int64_t o_c, int64_t o_p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_in) return;
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
    base[r] = b * c_b + c * c_c;
    obase[r] = b * o_b + c * o_c;
    acc[r] = 0.0f;
  }

  const int64_t offs[4] = {0, 1, row_stride, row_stride + 1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int64_t j = i - offs[q] % n_in;
    if (j < 0) j += n_in;
    for (int k = 0; k < k_t; ++k) {
      const int64_t slot = j * k_t + k;
      const float w = corner(w_t[slot], q);
      if (w != 0.0f) add_row(acc, cot, base, rows, static_cast<int64_t>(idx_t[slot]), w, c_p);
    }
    if (over_ptr != nullptr) {
      const int32_t m1 = over_ptr[j + 1];
      for (int32_t m = over_ptr[j]; m < m1; ++m) {
        const float w = corner(over_w[m], q);
        if (w != 0.0f) add_row(acc, cot, base, rows, static_cast<int64_t>(over_src[m]), w, c_p);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[obase[r] + i * o_p] = acc[r];
  }
}

template <typename T>
void launch(const void* cot, float* out, const int32_t* idx_t, const float* w_t, int k_t,
            const int32_t* over_ptr, const int32_t* over_src, const float* over_w,
            int64_t n_rows, int64_t channels, int64_t n_in, int64_t row_stride, int64_t c_b,
            int64_t c_c, int64_t c_p, int64_t o_b, int64_t o_c, int64_t o_p,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_in + kThreads - 1) / kThreads),
                  static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  quad_spread_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(cot), out, idx_t, reinterpret_cast<const float4*>(w_t), k_t,
      over_ptr, over_src, reinterpret_cast<const float4*>(over_w), n_rows, channels, n_in,
      row_stride, c_b, c_c, c_p, o_b, o_c, o_p);
}

}  // namespace

// dtype (of cot): 0 = float32, 1 = float16, 2 = bfloat16. over_ptr == nullptr:
// no overflow. n_rows = B * C rows, each at cot + b*c_b + c*c_c with pixel
// stride c_p over n_cot pixels; out has n_in pixels per row.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_quad_spread(const void* cot, int dtype, float* out,
                                      const int32_t* idx_t, const float* w_t, int k_t,
                                      const int32_t* over_ptr, const int32_t* over_src,
                                      const float* over_w, int64_t n_rows, int64_t channels,
                                      int64_t n_cot, int64_t n_in, int64_t row_stride,
                                      int64_t c_b, int64_t c_c, int64_t c_p, int64_t o_b,
                                      int64_t o_c, int64_t o_p, void* stream) {
  (void)n_cot;  // the tables' entries index the cotangent; the wrapper checks its size
  if (n_in == 0 || n_rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, n_rows, channels,
                    n_in, row_stride, c_b, c_c, c_p, o_b, o_c, o_p, s);
      break;
    case 1:
      launch<__half>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, n_rows, channels,
                     n_in, row_stride, c_b, c_c, c_p, o_b, o_c, o_p, s);
      break;
    case 2:
      launch<__nv_bfloat16>(cot, out, idx_t, w_t, k_t, over_ptr, over_src, over_w, n_rows,
                            channels, n_in, row_stride, c_b, c_c, c_p, o_b, o_c, o_p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
