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
// stored as f32 or, on request, rounded once to the source's dtype.
//
// Bound on the card: bytes. Each output does 4 multiply-adds per quad on
// gathered data, far below the H100's ~20 flop/byte balance point, so the
// least time is (source + output + tables) / 3.35 TB/s. At the merge of
// 128 f16 rows that is 0.110 ms, two thirds of it the f32 output.
//
// What held the first design back: one thread per output pixel and 8 rows,
// with grid.y walking the row groups, so the tables were read again for
// every 8 rows (336 MB of L2 reads for the merge's 21 MB at 128 rows), and
// every corner was a scalar 2-byte gather from a plane N_in elements away:
// a warp's 8 loads per row touched ~52 L1 wavefronts where ~15 sectors held
// the data.
//
// Design:
// - one block owns a tile of th x tw output pixels (8 x 32 for the merge,
//   4 x 32 for equi2pers; one pixel per thread, a warp's store is 32
//   consecutive pixels of one output row) and loops over its source rows
//   inside the kernel, so each thread reads its quads (K slots, then its CSR
//   tail, at most `entries` in all) once per call and keeps them in
//   registers;
// - staged = 1 (the merge): the source rows a tile reads
//   are staged through shared memory. The host lists, per tile, the 8-pixel
//   groups its corners touch (the footprint, 1.4 pixels per output pixel at
//   the merge) and the local position of every corner in it (4 int16 per
//   quad), so the corners +1 and +W need no global addresses here. Per chunk
//   of `chunk` units the block copies the footprint's groups with 16-byte
//   cp.async, double-buffered, so the next chunk's copy overlaps this
//   chunk's blend; the gathers then hit shared memory, where the corners of
//   neighbouring pixels sit on neighbouring banks;
// - staged = 0 (equi2pers): the same tiles and
//   registers, every corner gathered from global memory at (idx + off_q)
//   mod N_in. equi2pers samples the ERP at about one pixel in three, so its
//   footprint (4.6 pixels per output pixel) costs more to stage than to
//   gather; a block then takes `unit_block` units (grid.y the rest), so that
//   the units in flight across the card stay in L2;
// - a unit is one source row of a (B, C, N) source, or the C interleaved
//   rows of one batch of a (B, N, C) source: pixel p, channel c of unit u is
//   element (u * N_in + p) * cpu + c of the source, cpu = 1 or C, and the
//   output is addressed the same way, so one kernel serves the channel-first
//   merge and the channel-last equi2pers with no transposes. A unit's
//   channels are unrolled (cpu = 1 known when compiling for the merge);
// - the tail is each pixel's own CSR segment, added after its slots: each
//   output has one writer and a fixed order of summation (slot, corner,
//   then tail), with no atomics, so two calls give the same bits;
// - a corner of zero weight is still read and multiplied, as the plain
//   version does, so a non-finite source gives the same NaN in both;
// - corners wrap modulo N_in, exactly as the JAX roll does: the host's
//   footprint holds the wrapped pixel;
// - a group that is not 16-byte aligned in memory (an odd source stride) or
//   runs past N_in is copied element by element;
// - a pixel keeps at most 8 quads in registers (NE = 2, 4 or 8, the fewest
//   that hold `entries`). Where a pixel holds more (nrows 6, fov 90: 9),
//   one more instantiation (MORE) walks the quads past the 8th from global
//   memory after the register-held ones, in the same row loop, reading their
//   weights and offsets again for every row (L1 holds them): the order of
//   summation stays slots, then tail in CSR order, and the paths with at
//   most 8 quads compile as before.
// What bounds it now (tools/blend_variants.py; numbers in PERF.md): at the
// merge, its stores and staging take most of the time, its gathers from
// shared memory (one 2- or 4-byte load per corner and row) the rest; at
// equi2pers, its gathers from global memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;  // pixels per staged group (ops/quad_blend.py: GROUP)
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 227 * 1024;  // bytes a block may use on an H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Args {
  const float4* w4;        // (N_out, K) quad weights
  const short4* off;       // (N_out, K) corners' local pixels in the tile's footprint
  const int32_t* idx;      // (N_out, K) top-left corners (staged = 0)
  const int32_t* tail_ptr;  // (N_out + 1) CSR pointers of the tail, or null
  const float4* tail_w;
  const short4* tail_off;
  const int32_t* tail_idx;
  const int32_t* grp_ptr;  // (n_tiles + 1) CSR pointers of the footprints
  const int32_t* grp;      // the footprints' 8-pixel groups, ascending per tile
  int k_slots, cpu, tiles_x, pitch, chunk;  // pitch: pixels of a staged unit
  int64_t n_units, unit_block, n_in, n_out, row_stride, out_w;
};

// quad e of pixel n past the register-held ones (MORE), read from global
// memory: its weights, and its corners' element offsets in a unit (staged:
// in the tile's footprint). The kernel's register prologue keeps its own
// copy of these loads: calling this there changed the machine code of the
// instantiations without MORE
template <bool STAGED>
__device__ __forceinline__ float4 quad_from_global(const Args& a, int64_t n, int t0, int e,
                                                   int cpu, int (&off)[4]) {
  const bool slot = e < a.k_slots;
  const int64_t m = slot ? n * a.k_slots + e : t0 + (e - a.k_slots);
  if (STAGED) {
    const short4 o = slot ? a.off[m] : a.tail_off[m];
    off[0] = o.x * cpu;
    off[1] = o.y * cpu;
    off[2] = o.z * cpu;
    off[3] = o.w * cpu;
  } else {
    const int64_t j = slot ? a.idx[m] : a.tail_idx[m];
    const int64_t c[4] = {j, j + 1, j + a.row_stride, j + a.row_stride + 1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      off[q] = static_cast<int>(c[q] >= a.n_in ? c[q] - a.n_in : c[q]) * cpu;
    }
  }
  return slot ? a.w4[m] : a.tail_w[m];
}

// ONE: one element per pixel (cpu = 1, a (B, C, N) source), known when
// compiling, so a unit's blend is straight-line code. MORE: the pixels may
// hold more than NE quads; those past the NE-th are read from global memory
template <typename T, typename O, int NE, bool STAGED, bool ONE, bool MORE>
__global__ void __launch_bounds__(kMaxThreads)
quad_blend_kernel(const T* __restrict__ src, O* __restrict__ out, const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int tile = blockIdx.x;
  const int64_t col = static_cast<int64_t>(tile % a.tiles_x) * blockDim.x + threadIdx.x;
  const int64_t n =
      (static_cast<int64_t>(tile / a.tiles_x) * blockDim.y + threadIdx.y) * a.out_w + col;
  const bool live = col < a.out_w && n < a.n_out;
  const int cpu = ONE ? 1 : a.cpu;

  // the pixel's quads, K slots then its tail: weights, and each corner's
  // element offset in a unit (staged: in the tile's footprint)
  float4 w[NE];
  int off[NE][4];
  int n_e = 0;
  int t0 = 0;
  if (live) {
    if (a.tail_ptr != nullptr) {
      t0 = a.tail_ptr[n];
      n_e = a.tail_ptr[n + 1] - t0;
    }
    n_e += a.k_slots;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    w[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    off[e][0] = off[e][1] = off[e][2] = off[e][3] = 0;
    if (e < n_e) {
      const bool slot = e < a.k_slots;
      const int64_t m = slot ? n * a.k_slots + e : t0 + (e - a.k_slots);
      w[e] = slot ? a.w4[m] : a.tail_w[m];
      if (STAGED) {
        const short4 o = slot ? a.off[m] : a.tail_off[m];
        off[e][0] = o.x * cpu;
        off[e][1] = o.y * cpu;
        off[e][2] = o.z * cpu;
        off[e][3] = o.w * cpu;
      } else {
        const int64_t j = slot ? a.idx[m] : a.tail_idx[m];
        const int64_t c[4] = {j, j + 1, j + a.row_stride, j + a.row_stride + 1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          off[e][q] = static_cast<int>(c[q] >= a.n_in ? c[q] - a.n_in : c[q]) * cpu;
        }
      }
    }
  }

  const int64_t unit_in = a.n_in * cpu;  // elements of one source unit
  const int64_t unit_out = a.n_out * cpu;
  const int pitch = a.pitch * cpu;  // elements of one staged unit
  // this block's units: all, or a slice of unit_block units per grid.y
  const int64_t u_lo = static_cast<int64_t>(blockIdx.y) * a.unit_block;
  const int64_t u_hi = a.n_units - u_lo < a.unit_block ? a.n_units : u_lo + a.unit_block;
  const int64_t n_chunks = (u_hi - u_lo + a.chunk - 1) / a.chunk;
  constexpr int kVec = 16 / sizeof(T);
  int g0 = 0, per_unit = 0, per_group = 1;
  if (STAGED) {
    g0 = a.grp_ptr[tile];
    per_group = kGroup * cpu / kVec;  // 16-byte copies per group
    per_unit = (a.grp_ptr[tile + 1] - g0) * per_group;
  }

  // copy the footprint of chunk c's units into buffer c & 1: each thread
  // takes 16-byte pieces h of groups j, and copies them for every unit
  auto stage_chunk = [&](int64_t c) {
    const int64_t u0 = u_lo + c * a.chunk;
    const int nu = static_cast<int>(u_hi - u0 < a.chunk ? u_hi - u0 : a.chunk);
    T* buf = stage + (c & 1) * a.chunk * pitch;
    for (int i = tid; i < per_unit; i += n_threads) {
      const int j = i / per_group;
      const int h = i - j * per_group;
      const int64_t e = static_cast<int64_t>(a.grp[g0 + j]) * kGroup * cpu + h * kVec;
      const T* g = src + u0 * unit_in + e;
      T* s = buf + j * kGroup * cpu + h * kVec;
      const bool whole = e + kVec <= unit_in;
      for (int r = 0; r < nu; ++r, g += unit_in, s += pitch) {
        if (whole && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
          cp_async16(s, g);
        } else {
          for (int v = 0; v < kVec; ++v) {
            if (e + v < unit_in) s[v] = g[v];
          }
        }
      }
    }
  };

  if (STAGED) {
    stage_chunk(0);
    cp_async_commit();
  }
  for (int64_t c = 0; c < n_chunks; ++c) {
    if (STAGED) {
      if (c + 1 < n_chunks) stage_chunk(c + 1);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
    }
    const int64_t u0 = u_lo + c * a.chunk;
    const int nu = static_cast<int>(u_hi - u0 < a.chunk ? u_hi - u0 : a.chunk);
    if (live) {
      const T* base0 = STAGED ? stage + (c & 1) * a.chunk * pitch : src + u0 * unit_in;
      const int64_t step = STAGED ? pitch : unit_in;
      O* o0 = out + u0 * unit_out + n * cpu;
      // channels 4 at a time, unrolled; the unit loop is not unrolled (it
      // measured slower so on the H100, staged or not)
      for (int c0 = 0; c0 < cpu; c0 += 4) {
#pragma unroll 1
        for (int r = 0; r < nu; ++r) {
          const T* base = base0 + r * step + c0;
          O* o = o0 + r * unit_out + c0;
#pragma unroll
          for (int ch = 0; ch < (ONE ? 1 : 4); ++ch) {
            if (ch == 0 || c0 + ch < cpu) {
              float acc = 0.0f;
#pragma unroll
              for (int e = 0; e < NE; ++e) {
                if (e < n_e) {
                  acc += w[e].x * to_f32(base[off[e][0] + ch]) +
                         w[e].y * to_f32(base[off[e][1] + ch]) +
                         w[e].z * to_f32(base[off[e][2] + ch]) +
                         w[e].w * to_f32(base[off[e][3] + ch]);
                }
              }
              if (MORE) {
                for (int e = NE; e < n_e; ++e) {
                  int off_e[4];
                  const float4 w_e = quad_from_global<STAGED>(a, n, t0, e, cpu, off_e);
                  acc += w_e.x * to_f32(base[off_e[0] + ch]) +
                         w_e.y * to_f32(base[off_e[1] + ch]) +
                         w_e.z * to_f32(base[off_e[2] + ch]) +
                         w_e.w * to_f32(base[off_e[3] + ch]);
                }
              }
              o[ch] = from_f32<O>(acc);
            }
          }
        }
      }
    }
    if (STAGED) __syncthreads();
  }
}

template <typename T, typename O, int NE, bool STAGED, bool ONE, bool MORE>
int launch(const void* src, void* out, const Args& a, int64_t n_tiles, int tile_h, int tile_w,
           cudaStream_t stream) {
  const int64_t smem = STAGED ? 2LL * a.chunk * a.pitch * a.cpu * sizeof(T) : 0;
  const int64_t unit_blocks = (a.n_units + a.unit_block - 1) / a.unit_block;
  if (smem > kMaxSmem || tile_h * tile_w > kMaxThreads || tile_w % 32 != 0 ||
      unit_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = quad_blend_kernel<T, O, NE, STAGED, ONE, MORE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(unit_blocks)),
           dim3(tile_w, tile_h), static_cast<size_t>(smem), stream>>>(static_cast<const T*>(src), static_cast<O*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, int NE, bool MORE = false>
int by_layout(bool staged, const void* src, void* out, const Args& a, int64_t n_tiles,
              int tile_h, int tile_w, cudaStream_t s) {
  if (a.cpu == 1) {
    return staged ? launch<T, O, NE, true, true, MORE>(src, out, a, n_tiles, tile_h, tile_w, s)
                  : launch<T, O, NE, false, true, MORE>(src, out, a, n_tiles, tile_h, tile_w, s);
  }
  return staged ? launch<T, O, NE, true, false, MORE>(src, out, a, n_tiles, tile_h, tile_w, s)
                : launch<T, O, NE, false, false, MORE>(src, out, a, n_tiles, tile_h, tile_w, s);
}

template <typename T, typename O>
int by_entries(int entries, bool staged, const void* src, void* out, const Args& a,
               int64_t n_tiles, int tile_h, int tile_w, cudaStream_t s) {
  if (entries <= 2) return by_layout<T, O, 2>(staged, src, out, a, n_tiles, tile_h, tile_w, s);
  if (entries <= 4) return by_layout<T, O, 4>(staged, src, out, a, n_tiles, tile_h, tile_w, s);
  if (entries <= 8) return by_layout<T, O, 8>(staged, src, out, a, n_tiles, tile_h, tile_w, s);
  return by_layout<T, O, 8, true>(staged, src, out, a, n_tiles, tile_h, tile_w, s);
}

template <typename T>
int by_output(bool same, int entries, bool staged, const void* src, void* out, const Args& a,
              int64_t n_tiles, int tile_h, int tile_w, cudaStream_t s) {
  return same ? by_entries<T, T>(entries, staged, src, out, a, n_tiles, tile_h, tile_w, s)
              : by_entries<T, float>(entries, staged, src, out, a, n_tiles, tile_h, tile_w, s);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; out_dtype: 0 or dtype.
// The source is n_units units of n_in pixels of cpu elements each, the output
// n_units units of n_out pixels. tail_ptr == nullptr: no tail. entries: the
// most quads (slots + tail) of any output pixel (above 8, the quads past the
// 8th are read from global memory for every row). The tile tables
// (off, tail_off, grp_ptr, grp, pitch) come from ops/quad_blend.py:
// tile_tables; staged = 0 reads idx and tail_idx instead. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int omnifusion_quad_blend(
    const void* src, int dtype, void* out, int out_dtype, const float* w4, const int16_t* off,
    const int32_t* idx, int k_slots, const int32_t* tail_ptr, const float* tail_w,
    const int16_t* tail_off, const int32_t* tail_idx, const int32_t* grp_ptr, const int32_t* grp,
    int64_t n_tiles, int tiles_x, int tile_h, int tile_w, int pitch, int64_t n_units,
    int64_t unit_block, int cpu,
    int64_t n_in, int64_t n_out, int64_t row_stride, int64_t out_w, int entries, int chunk,
    int staged, void* stream) {
  if (n_out == 0 || n_units == 0) return static_cast<int>(cudaGetLastError());
  if (chunk < 1 || unit_block < 1 || k_slots > entries ||
      (out_dtype != 0 && out_dtype != dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.w4 = reinterpret_cast<const float4*>(w4);
  a.off = reinterpret_cast<const short4*>(off);
  a.idx = idx;
  a.tail_ptr = tail_ptr;
  a.tail_w = reinterpret_cast<const float4*>(tail_w);
  a.tail_off = reinterpret_cast<const short4*>(tail_off);
  a.tail_idx = tail_idx;
  a.grp_ptr = grp_ptr;
  a.grp = grp;
  a.k_slots = k_slots;
  a.cpu = cpu;
  a.tiles_x = tiles_x;
  a.pitch = pitch;
  a.chunk = chunk;
  a.n_units = n_units;
  a.unit_block = unit_block;
  a.n_in = n_in;
  a.n_out = n_out;
  a.row_stride = row_stride;
  a.out_w = out_w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same = out_dtype != 0;
  switch (dtype) {
    case 0:
      return by_entries<float, float>(entries, staged != 0, src, out, a, n_tiles, tile_h, tile_w,
                                      s);
    case 1:
      return by_output<__half>(same, entries, staged != 0, src, out, a, n_tiles, tile_h, tile_w,
                               s);
    case 2:
      return by_output<__nv_bfloat16>(same, entries, staged != 0, src, out, a, n_tiles, tile_h,
                                      tile_w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
