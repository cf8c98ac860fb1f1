// The fused depth and confidence heads: one 3x3 convolution (zero padding 1)
// from the decoder's 32 channels to NOUT outputs, over an NCHW map or a
// channels-last one (NHWC in memory), with the bias, a ReLU on the first
// NOUT - 1 outputs (or none) and a sigmoid on the last in its epilogue. pred
// (R, NOUT - 1, H, W) and conf (R, 1, H, W), contiguous, are stored in the
// map's dtype: bf16 under the bf16 trunk (the serving recipe), or f32. NOUT
// is 2 (depth and confidence) or 14 (the 13-class segmentation model's
// logits and confidence).
//
// Replaces no Pallas kernel: the JAX package leaves the heads to XLA's
// convolution (omnifusion_tpu/models/spherical_fusion.py:174-175). On the
// card cuDNN ran them as a transpose of the map to NHWC, an implicit GEMM
// whose N is 2 (a tile of padding), a bias pass and two activation passes,
// at about a tenth of the bytes' bound.
//
// Bound on the card: bytes at NOUT = 2. The map is read once and the outputs
// written once: at the flagship's batch 64 in bf16, 1152 x 32 x 128 x 128 x
// 2 B read and 1152 x 2 x 128 x 128 x 2 B written, 1.28 GB over 3.35 TB/s,
// 0.383 ms. The arithmetic, 288 multiply-adds an output, is 10.9 G FMAs
// there, 0.33 ms of the CUDA cores' f32 FMAs at their peak; at NOUT = 14 it
// is 76 G, past what the CUDA cores do in the bytes' time.
//
// Both kernels: a block makes a tile of TH rows x 128 columns of one map
// (neighbouring tiles of a map are neighbouring blocks, so the halo rows
// come from L2), from the tile's input, TH + 2 rows x 130 columns (the halo
// zero outside the map), staged in shared memory. The weights are the
// heads' own f32 parameters, two pointers each for the weights and the
// biases, so nothing is concatenated per call; under a bf16 map they are
// rounded to bf16 first, as the plain version casts them. The sums are f32
// and rounded once, after the bias and the activation; the plain version
// (cuDNN) rounds the convolution's output to the map's dtype before the bias
// and again after it, so in bf16 the two differ by about a bf16 ulp of the
// sum. Where a map row is not a whole number of 16-byte pieces, or the map
// is not 16-byte aligned, the staging and the stores go element by element.
//
// fused_heads3x3_kernel (f32 maps, and bf16 maps at NOUT = 2): f32 FMAs on
// the CUDA cores (the tensor cores' f32 path is TF32, which the f32 plain
// version does not round to). The input is staged kChunk channels at a time
// with cp.async, two buffers, the next chunk's copy running while the
// current one is summed. A thread keeps kP = 8 adjacent pixels of PH rows
// for OPT of the outputs in registers (NOUT = 2: 2 rows, both outputs, TH =
// 16; NOUT = 14: 1 row, 7 outputs, two threads sharing each strip of pixels,
// TH = 4); per channel and staged row it reads its 10 inputs (one 16-byte
// load and two scalars) and the filter rows' weights from shared memory (a
// broadcast), for 3 x 8 x OPT FMAs into each output row the staged row
// reaches. At NOUT = 2 in bf16 this runs at about half the bytes' bound on
// an H100 (700 W); the tensor-core kernel below, whose 8-output tile is 3/4
// padding there and whose staging does not overlap its sums, took 1.7x as
// long.
//
// fused_heads3x3_mma_kernel (bf16 maps at NOUT = 14): an implicit GEMM per
// 16-pixel group of a row, D[16 pixels][8 outputs] += A[16 pixels][16
// channels] x B[16 channels][8 outputs] for each of the 9 taps and both
// halves of the 32 channels, by mma.sync m16n8k16 (bf16 operands, f32
// accumulators), two 8-output tiles. The tile is staged channel-last,
// [row][pixel][32 channels] (64 bytes a pixel), so a tap's A fragment is one
// ldmatrix.x4 of 16 pixel rows at any column offset; the 16-byte pieces of a
// pixel are XOR-swizzled by (pixel / 2) mod 4, so the 8 rows of an 8x8
// matrix fall in distinct banks. The staging reads two channels x 8 pixels
// (two 16-byte loads) and interleaves them into 8 words of channel pairs.
// The B fragments (9 x 2 x 2 registers an output tile) are built once per
// thread from the parameters. TH = 4: 6 staged rows of 130 pixels, 50 KB;
// warp w makes output row w, two groups at a time. The CUDA cores' kernel
// took 2.7x as long at NOUT = 14 on an H100 (700 W).
//
// Channel-last forms (the map NHWC in memory, as the decoder leaves it where
// autograd records nothing, so that no transpose runs before the heads): a
// pixel's 32 channels are 64 (bf16) or 128 (f32) contiguous bytes. Staging
// a chunk of channels of every pixel, as the NCHW kernels do, reads 16 bytes
// of each pixel's run at a time, half of each 32-byte sector, and took 1.4x
// (bf16) and 2.8x (f32) the NCHW kernel's time at NOUT = 2 on an H100 (700
// W). So the memory-bound forms copy whole rows of the map, which are
// contiguous, and walk down it: a block makes kMmaBlockRows (or
// kNhwcBlockRows) rows of 128 columns, a few rows at a time, from a ring of
// staged rows that cp.async fills a step ahead; each input row is copied
// once, with 2 halo rows a block.
// - bf16, NOUT = 2 and 14: fused_heads3x3_mma_kernel<NOUT, true>, its tile
//   staged as the NCHW form stages it (the map's 16-byte pieces copied as
//   they are), so the sums and their bits are the NCHW form's. At NOUT = 2
//   the tensor cores' 8-output tile is 3/4 padding but their instructions
//   few: on the CUDA cores the bf16 unpacking set the pace (0.83 ms at b64
//   against 0.61 here). Steps of 1 row (4 warps a row, NOUT = 2) or 2 rows
//   (NOUT = 14) with one step in flight timed best (kMmaStepRows).
// - f32, NOUT = 2: fused_heads3x3_nhwc_kernel, on the CUDA cores (the
//   plain f32 version is not TF32). Lane = strip * 8 + group: 8 lanes share
//   a strip of kP = 8 pixels, each summing 4 of the 32 channels (one 16-byte
//   load a pixel) for both outputs of 2 rows, with its 72 weights in
//   registers; a butterfly of shuffles gives lane ``group`` the strip's
//   sums at pixel ``group``. Its sums run in another order than the NCHW
//   kernel's, so they round differently.
// - f32, NOUT = 14: fused_heads3x3_kernel<float, 14, true>, the NCHW kernel
//   with its chunks staged from the channel-last map (a pixel's 4 channels
//   loaded together, stored to their 4 planes): bound by its f32 FMAs, it
//   keeps the NCHW form's sums and bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;  // the decoder's last width
constexpr int kThreads = 128;
constexpr int kTileW = 128;  // output columns a block makes

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN stays NaN
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return static_cast<unsigned>(y) < static_cast<unsigned>(h) &&
         static_cast<unsigned>(x) < static_cast<unsigned>(w);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0 fills
// the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- the sums on the tensor cores (bf16) ----

constexpr int kMmaRows = 4;                 // output rows of a step, a warp each
constexpr int kMmaCols = kTileW + 2;        // staged pixels of a row
constexpr int kPixelBytes = 2 * kChannels;  // a staged pixel: 32 bf16 channels
constexpr size_t kMmaSmem = size_t{kMmaRows + 2} * kMmaCols * kPixelBytes;
// channel-last: a block walks down kMmaBlockRows rows of the map in steps
// of kMmaStepRows rows (kMmaRows / kMmaStepRows warps a row), with a ring of
// staged rows: a step's kMmaStepRows + 2 and the next step's kMmaStepRows in
// flight. Timed on an H100 (700 W), b64: 1-row steps over 32 rows at 2
// outputs (0.611 ms; 2-row steps 0.649, a second step in flight 0.662),
// 2-row steps over 64 rows at 14 (0.885 ms; over 32 rows 0.926)
template <int NOUT>
constexpr int kMmaStepRows = NOUT <= 8 ? 1 : 2;
template <int NOUT>
constexpr int kMmaBlockRows = NOUT <= 8 ? 32 : 64;
template <int NOUT>
constexpr int kMmaRing = 2 * kMmaStepRows<NOUT> + 2;
template <int NOUT>
constexpr size_t kMmaRingSmem = size_t{kMmaRing<NOUT>} * kMmaCols * kPixelBytes;

// The byte offset of 16-byte piece ``piece`` (channels 8 piece .. 8 piece +
// 7) of staged pixel ``px`` of staged row ``row``
__device__ __forceinline__ uint32_t staged(int row, int px, int piece) {
  return static_cast<uint32_t>((row * kMmaCols + px) * kPixelBytes +
                               ((piece ^ ((px >> 1) & 3)) << 4));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NOUT, bool kCL>
__global__ void __launch_bounds__(kThreads)
fused_heads3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pred_w,
                          const float* __restrict__ pred_b, const float* __restrict__ conf_w,
                          const float* __restrict__ conf_b, __nv_bfloat16* __restrict__ pred,
                          __nv_bfloat16* __restrict__ conf, int h, int w, int tiles_x, int tiles,
                          bool do_relu, bool vec) {
  constexpr int NT = (NOUT + 7) / 8;  // tiles of 8 outputs
  constexpr int kStripes = kTileW / 8;  // 8-pixel stripes of a staged row
  constexpr int kStepRows = kCL ? kMmaStepRows<NOUT> : kMmaRows;  // output rows of a step
  constexpr int kSteps = kCL ? kMmaBlockRows<NOUT> / kStepRows : 1;
  constexpr int kSlots = kCL ? kMmaRing<NOUT> : kMmaRows + 2;      // staged rows held
  constexpr int kStaged = kStepRows * kSteps + 2;            // staged rows of the block
  constexpr int kRowWarps = kMmaRows / kStepRows;            // warps a row
  extern __shared__ float4 smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_raw);
  const uint32_t smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t blk = blockIdx.x;
  const int64_t r = blk / tiles;
  const int t = static_cast<int>(blk - r * tiles);
  const int y0 = (t / tiles_x) * kStepRows * kSteps;
  const int x0 = (t % tiles_x) * kTileW;
  const unsigned short* xr =
      reinterpret_cast<const unsigned short*>(x) + r * kChannels * h * w;
  auto at = [&](int c, int y, int xx) { return xr + (static_cast<int64_t>(c) * h + y) * w + xx; };

  // staging: a task is channels (2 cp, 2 cp + 1) x the 8 pixels of a stripe
  // of a staged row, stored as 8 words of channel pairs; the 16 lanes of a
  // half-warp take the 16 channel pairs of one stripe, and a thread's tasks
  // are its channel pair in stripes tid / 16 and tid / 16 + 8 of each row
  const int cp = tid & 15;
  auto stage_task = [&](int row, int stripe) {
    const int y = y0 - 1 + row, xx = x0 + stripe * 8;
    uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};  // channel 2 cp, 2 cp + 1
    if (vec) {
      if (inside(y, xx, h, w)) {  // the stripe lies wholly in or out of the map
        const uint4 a = *reinterpret_cast<const uint4*>(at(2 * cp, y, xx));
        const uint4 b = *reinterpret_cast<const uint4*>(at(2 * cp + 1, y, xx));
        lo[0] = a.x, lo[1] = a.y, lo[2] = a.z, lo[3] = a.w;
        hi[0] = b.x, hi[1] = b.y, hi[2] = b.z, hi[3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (inside(y, xx + k, h, w)) {
          lo[k >> 1] |= static_cast<uint32_t>(*at(2 * cp, y, xx + k)) << (16 * (k & 1));
          hi[k >> 1] |= static_cast<uint32_t>(*at(2 * cp + 1, y, xx + k)) << (16 * (k & 1));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<uint32_t*>(sm + staged(row, stripe * 8 + 1 + k, cp >> 2) + (cp & 3) * 4) =
          __byte_perm(lo[k >> 1], hi[k >> 1], (k & 1) ? 0x7632 : 0x5410);
    }
  };
  static_assert(kThreads == 8 * 16 && kStripes == 16, "two stripes of a row per thread");
  if constexpr (!kCL) {
#pragma unroll
    for (int row = 0; row < kMmaRows + 2; ++row) {
      stage_task(row, tid >> 4);
      stage_task(row, (tid >> 4) + 8);
    }
    // the halo columns, x0 - 1 and x0 + 128
    for (int i = tid; i < (kMmaRows + 2) * 2 * 16; i += kThreads) {
      const int side = (i >> 4) & 1, row = i >> 5;
      const int y = y0 - 1 + row, xx = side ? x0 + kTileW : x0 - 1;
      uint32_t word = 0;
      if (inside(y, xx, h, w)) {
        word = static_cast<uint32_t>(*at(2 * cp, y, xx)) |
               (static_cast<uint32_t>(*at(2 * cp + 1, y, xx)) << 16);
      }
      *reinterpret_cast<uint32_t*>(sm + staged(row, side ? kMmaCols - 1 : 0, cp >> 2) +
                                   (cp & 3) * 4) = word;
    }
  }

  // channel-last map: a pixel's 32 channels are 4 contiguous 16-byte pieces,
  // staged as they are (piece k holds channels 8 k .. 8 k + 7, the layout the
  // NCHW staging builds), with cp.async; consecutive threads take consecutive
  // pieces of a staged row, contiguous in the map. Staged rows i .. i + n - 1
  // (input rows y0 - 1 + i ..; none past the block's) go to ring slots
  // i % kSlots, as one group
  auto issue_rows = [&](int i, int n) {
    n = min(n, kStaged - i);
    for (int k = tid; k < n * kMmaCols * 4; k += kThreads) {
      const int piece = k & 3, px = (k >> 2) % kMmaCols, row = i + (k >> 2) / kMmaCols;
      const int y = y0 - 1 + row, xx = x0 - 1 + px;
      const bool in = inside(y, xx, h, w);
      const unsigned short* src =
          in ? xr + (static_cast<int64_t>(y) * w + xx) * kChannels + 8 * piece : xr;
      unsigned char* dst = sm + staged(row % kSlots, px, piece);
      if (vec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        uint32_t u[4] = {0, 0, 0, 0};
        if (in) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            u[e] = static_cast<uint32_t>(src[2 * e]) |
                   (static_cast<uint32_t>(src[2 * e + 1]) << 16);
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    cp_async_commit();
  };
  if constexpr (kCL) issue_rows(0, kStepRows + 2);

  // the B fragments: b[tap][half][tile] = (B[2 q][g], B[2 q + 1][g]) and
  // (B[2 q + 8][g], B[2 q + 9][g]) of k = channel - 16 half, n = 8 tile + g
  const int g = lane >> 2, q = lane & 3;
  uint32_t b[9][2][NT][2];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = half * 16 + 2 * q + 8 * j;
          float v0 = 0.f, v1 = 0.f;
          if (n < NOUT) {
            const float* wp = n < NOUT - 1 ? pred_w + n * kChannels * 9 : conf_w;
            v0 = wp[c * 9 + tap];
            v1 = wp[(c + 1) * 9 + tap];
          }
          b[tap][half][nt][j] = pack_bf16(v0, v1);
        }
      }
    }
  }
  // the lane's outputs 8 nt + 2 q + e: their bias
  float bias[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nt * 8 + 2 * q + e;
      bias[nt][e] = n < NOUT ? bf16_round(n < NOUT - 1 ? pred_b[n] : conf_b[0]) : 0.f;
    }
  }

  // warp w makes columns [kTileW / kRowWarps) of output row w / kRowWarps of
  // a step, two 16-pixel groups at a time. The lane's ldmatrix row is pixel
  // m of a group and channel piece 2 half + lane / 16; a group's pixels
  // start at a multiple of 16, so the swizzle of pixel gx + m + dx is that of
  // m + dx
  static_assert(kThreads / 32 == kMmaRows, "4 warps");
  const int wrow = warp / kRowWarps, gx0 = (warp % kRowWarps) * (kTileW / kRowWarps);
  const int m = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t off[3][2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      off[dx][half] = smem + staged(0, m + dx, 2 * half + (lane >> 4));
    }
  }
#pragma unroll 1
  for (int step = 0; step < kSteps; ++step) {
    if constexpr (kCL) {
      // the step's staged rows have landed; the barrier also frees the
      // slots of the step before's first kStepRows rows, for the next step's
      cp_async_wait<0>();
      __syncthreads();
      issue_rows(kStepRows * (step + 1) + 2, kStepRows);
    } else {
      __syncthreads();
    }
    // where the lane's outputs of row y go (null: no output, or a row past
    // the map)
    const int y = y0 + kStepRows * step + wrow;
    __nv_bfloat16* dst[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * q + e;
        dst[nt][e] = n >= NOUT || y >= h ? nullptr
                     : (n == NOUT - 1 ? conf + r * h * w : pred + (r * (NOUT - 1) + n) * h * w) +
                           static_cast<int64_t>(y) * w + x0;
      }
    }
    uint32_t row_at[3];  // the staged rows y - 1 .. y + 1
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      row_at[dy] = ((kStepRows * step + wrow + dy) % kSlots) * kMmaCols * kPixelBytes;
    }
#pragma unroll 1
    for (int gx = gx0; gx < gx0 + kTileW / kRowWarps; gx += 32) {
      float acc[2][NT][4];
#pragma unroll
      for (int k = 0; k < 2 * NT * 4; ++k) (&acc[0][0][0])[k] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            uint32_t a[4];
            ldmatrix_x4(off[dx][half] + row_at[dy] + (gx + 16 * gi) * kPixelBytes, a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_bf16(acc[gi][nt], a, b[tap][half][nt][0], b[tap][half][nt][1]);
            }
          }
        }
      }
      // acc[gi][nt] = D[g][2 q], D[g][2 q + 1], D[g + 8][2 q], D[g + 8][2 q + 1]
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nt * 8 + 2 * q + (e & 1), xl = gx + 16 * gi + g + (e >> 1) * 8;
            if (dst[nt][e & 1] == nullptr || x0 + xl >= w) continue;
            const float s = acc[gi][nt][e] + bias[nt][e & 1];
            const float v = n == NOUT - 1 ? sigmoid(s) : (do_relu ? relu(s) : s);
            dst[nt][e & 1][xl] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

// ---- the sums on the CUDA cores ----

constexpr int kChunk = 4;  // channels staged at a time
constexpr int kChunks = kChannels / kChunk;
constexpr int kP = 8;  // adjacent output pixels of a row per thread

// A thread makes kP pixels of PH rows for OPT of the NOUT outputs: NSPLIT
// threads share a strip of pixels, each with its own outputs
template <int NOUT>
struct Tile {
  static constexpr int NSPLIT = NOUT <= 2 ? 1 : 2;
  static constexpr int OPT = NOUT / NSPLIT;
  static constexpr int PH = NOUT <= 2 ? 2 : 1;
  static constexpr int kStrips = kTileW / kP;         // strips of a row
  static constexpr int kPerRow = kStrips * NSPLIT;    // threads per row of threads
  static constexpr int TH = kThreads / kPerRow * PH;  // output rows per block
  static constexpr int G = (3 * OPT + 3) / 4 * 4;     // floats per (channel, filter row, split)
  static_assert(NOUT % NSPLIT == 0 && kThreads % kPerRow == 0, "tile");
};

// Elements of T in 16 bytes: a staged row holds column x at x + kOff<T>, so
// the tile's columns start 16-byte aligned and the halo column sits before
template <typename T>
constexpr int kOff = 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kRowStride = kOff<T> + kTileW + kOff<T>;  // a multiple of 16 bytes

template <typename T, int NOUT>
constexpr size_t kSmem = sizeof(float) * kChannels * 3 * Tile<NOUT>::NSPLIT * Tile<NOUT>::G +
                         2 * sizeof(T) * kChunk * (Tile<NOUT>::TH + 2) * kRowStride<T>;

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

// a parameter as the map's dtype rounds it (the plain version's cast)
template <typename T>
__device__ __forceinline__ float as_param(float v) { return to_f32(from_f32<T>(v)); }

// N elements at p (16-byte aligned) as f32
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}
__device__ __forceinline__ void unpack2(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}
// kChunk channels of a channel-last pixel at p (aligned to their size)
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[kChunk]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[kChunk]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  unpack2(q.x, v);
  unpack2(q.y, v + 2);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(N == 8, "8 bf16 values");
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  unpack2(q.x, v);
  unpack2(q.y, v + 2);
  unpack2(q.z, v + 4);
  unpack2(q.w, v + 6);
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(N == 8, "8 bf16 values");
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <typename T, int NOUT, bool kCL>
__global__ void __launch_bounds__(kThreads)
fused_heads3x3_kernel(const T* __restrict__ x, const float* __restrict__ pred_w,
                      const float* __restrict__ pred_b, const float* __restrict__ conf_w,
                      const float* __restrict__ conf_b, T* __restrict__ pred,
                      T* __restrict__ conf, int h, int w, int tiles_x, int tiles, bool do_relu,
                      bool vec) {
  using Shape = Tile<NOUT>;
  constexpr int P = kP, PH = Shape::PH, TH = Shape::TH, G = Shape::G, OPT = Shape::OPT;
  constexpr int NSPLIT = Shape::NSPLIT, kStrips = Shape::kStrips, kPerRow = Shape::kPerRow;
  constexpr int kOffT = kOff<T>, kStride = kRowStride<T>;
  constexpr int kRows = kChunk * (TH + 2);            // staged rows per chunk
  constexpr int kStage = kRows * kStride;             // elements per buffer
  constexpr int kVecPerRow = kTileW / kOffT;          // 16-byte pieces per staged row

  extern __shared__ float4 smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [channel][filter row][split][G]
  T* stage = reinterpret_cast<T*>(w_s + kChannels * 3 * NSPLIT * G);

  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int64_t r = blk / tiles;
  const int t = static_cast<int>(blk - r * tiles);
  const int y0 = (t / tiles_x) * TH;
  const int x0 = (t % tiles_x) * kTileW;
  const T* xr = x + r * kChannels * h * w;

  // the chunk's TH + 2 rows x kTileW + 2 columns of kChunk channels into
  // buffer ``buf``, zero outside the map
  auto issue = [&](int chunk, T* buf) {
    const int c0 = chunk * kChunk;
    if constexpr (kCL) {
      // from a channel-last map: the chunk's kChunk channels of a pixel are
      // contiguous, loaded together and stored to their kChunk planes
      for (int i = tid; i < (TH + 2) * (kTileW + 2); i += kThreads) {
        const int row = i / (kTileW + 2), col = i - row * (kTileW + 2);
        const int y = y0 - 1 + row, xx = x0 - 1 + col;
        float v[kChunk] = {};
        if (inside(y, xx, h, w)) {
          const T* src = xr + (static_cast<int64_t>(y) * w + xx) * kChannels + c0;
          if (vec) {
            load_chunk(src, v);
          } else {
#pragma unroll
            for (int c = 0; c < kChunk; ++c) v[c] = to_f32(src[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          buf[(c * (TH + 2) + row) * kStride + kOffT - 1 + col] = from_f32<T>(v[c]);
        }
      }
    } else if (vec) {
      for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
        const int row = i / kVecPerRow, piece = i - row * kVecPerRow;
        const int c = c0 + row / (TH + 2), y = y0 - 1 + row % (TH + 2);
        const int xx = x0 + piece * kOffT;
        const bool in = inside(y, xx, h, w);
        const T* src = in ? xr + (static_cast<int64_t>(c) * h + y) * w + xx : x;
        cp_async16(buf + row * kStride + kOffT + piece * kOffT, src, in ? 16 : 0);
      }
      for (int i = tid; i < 2 * kRows; i += kThreads) {  // the halo columns
        const int row = i >> 1, side = i & 1;
        const int c = c0 + row / (TH + 2), y = y0 - 1 + row % (TH + 2);
        const int xx = side ? x0 + kTileW : x0 - 1;
        buf[row * kStride + kOffT - 1 + side * (kTileW + 1)] =
            inside(y, xx, h, w) ? xr[(static_cast<int64_t>(c) * h + y) * w + xx] : from_f32<T>(0.f);
      }
    } else {
      for (int i = tid; i < kRows * (kTileW + 2); i += kThreads) {
        const int row = i / (kTileW + 2), col = i - row * (kTileW + 2);
        const int c = c0 + row / (TH + 2), y = y0 - 1 + row % (TH + 2);
        const int xx = x0 - 1 + col;
        buf[row * kStride + kOffT - 1 + col] =
            inside(y, xx, h, w) ? xr[(static_cast<int64_t>(c) * h + y) * w + xx] : from_f32<T>(0.f);
      }
    }
    cp_async_commit();
  };

  issue(0, stage);

  // the weights, as [channel][filter row][split][dx * OPT + output of the
  // split], zero past 3 OPT
  for (int i = tid; i < kChannels * 3 * NSPLIT * G; i += kThreads) {
    const int g = i / G, j = i - g * G;
    const int cdy = g / NSPLIT, split = g - cdy * NSPLIT;
    float v = 0.f;
    if (j < 3 * OPT) {
      const int dx = j / OPT, o = split * OPT + j - dx * OPT, tap = cdy * 3 + dx;  // (c, dy, dx)
      v = as_param<T>(o < NOUT - 1 ? pred_w[o * kChannels * 9 + tap] : conf_w[tap]);
    }
    w_s[i] = v;
  }

  const int tr = tid / kPerRow, in_row = tid - tr * kPerRow;
  const int split = in_row / kStrips, xl = (in_row - split * kStrips) * P;
  float acc[PH][OPT][P];
#pragma unroll
  for (int j = 0; j < PH; ++j) {
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
#pragma unroll
      for (int p = 0; p < P; ++p) acc[j][o][p] = 0.f;
    }
  }

  // the FMAs of one staged input row ``v`` for output row j, filter row dy
  auto fma_row = [&](const float* v, const float* wv, int j) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
#pragma unroll
        for (int p = 0; p < P; ++p) acc[j][o][p] = fmaf(v[p + dx], wv[dx * OPT + o], acc[j][o][p]);
      }
    }
  };

#pragma unroll 1
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    T* buf = stage + (chunk & 1) * kStage;
    if (chunk + 1 < kChunks) {
      issue(chunk + 1, stage + ((chunk + 1) & 1) * kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk's copies, halo stores and (first) the weights
#pragma unroll
    for (int cl = 0; cl < kChunk; ++cl) {
      const T* src = buf + (cl * (TH + 2) + tr * PH) * kStride + kOffT + xl;
      const float* wc = w_s + (chunk * kChunk + cl) * 3 * NSPLIT * G + split * G;
      if constexpr (PH == 1) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float v[P + 2], wv[G];
          v[0] = to_f32(src[dy * kStride - 1]);
          load_vec<P>(src + dy * kStride, v + 1);
          v[P + 1] = to_f32(src[dy * kStride + P]);
          load_vec<G>(wc + dy * NSPLIT * G, wv);
          fma_row(v, wv, 0);
        }
      } else {
        // the channel's three filter rows, each used by PH output rows
        float wv[3][G];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) load_vec<G>(wc + dy * NSPLIT * G, wv[dy]);
#pragma unroll
        for (int i = 0; i < PH + 2; ++i) {  // input rows
          float v[P + 2];
          v[0] = to_f32(src[i * kStride - 1]);
          load_vec<P>(src + i * kStride, v + 1);
          v[P + 1] = to_f32(src[i * kStride + P]);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            if (i - dy >= 0 && i - dy < PH) fma_row(v, wv[dy], i - dy);
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }

  const int xo = x0 + xl;
  if (xo >= w) return;
  // rows of whole 16-byte pieces: vector stores (an NCHW map's vec says so)
  const bool vec_out = kCL ? w % kOffT == 0 : vec;
  float bias[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int oo = split * OPT + o;
    bias[o] = as_param<T>(oo < NOUT - 1 ? pred_b[oo] : conf_b[0]);
  }
#pragma unroll
  for (int j = 0; j < PH; ++j) {
    const int y = y0 + tr * PH + j;
    if (y >= h) break;
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int oo = split * OPT + o;
      float out[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float s = acc[j][o][p] + bias[o];
        out[p] = oo == NOUT - 1 ? sigmoid(s) : (do_relu ? relu(s) : s);
      }
      T* dst = (oo == NOUT - 1 ? conf + r * h * w : pred + (r * (NOUT - 1) + oo) * h * w) +
               static_cast<int64_t>(y) * w + xo;
      if (vec_out && xo + P <= w) {
        store_vec<P>(dst, out);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (xo + p < w) dst[p] = from_f32<T>(out[p]);
        }
      }
    }
  }
}

// ---- the sums on the CUDA cores, from a channel-last f32 map, 2 outputs ----

constexpr int kNhwcBlockRows = 32;  // output rows a block makes, two at a time
constexpr int kNhwcRing = 6;        // staged input rows: 4 read by a step, 2 in flight
constexpr int kLaneChannels = 4;    // channels a lane sums: 8 lanes share a strip
constexpr int kNhwcRowBytes = (kTileW + 2) * kChannels * 4;  // a staged row of f32 pixels
constexpr size_t kNhwcSmem = size_t{kNhwcRing} * kNhwcRowBytes;

// In a strip's 8 lanes, ``v`` (8 pixels of one output, the lane's share of
// the channels) -> the strip's sum at pixel ``lane & 7``: three butterfly
// steps, each keeping half of the pixels and adding the partner lane's share
__device__ __forceinline__ float strip_sum(const float (&v)[kP], int lane) {
  float a[4], b[2];
  const bool hi4 = lane & 4, hi2 = lane & 2, hi1 = lane & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = hi4 ? v[i + 4] : v[i], give = hi4 ? v[i] : v[i + 4];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = hi2 ? a[i + 2] : a[i], give = hi2 ? a[i] : a[i + 2];
    b[i] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
  }
  const float keep = hi1 ? b[1] : b[0], give = hi1 ? b[0] : b[1];
  return keep + __shfl_xor_sync(0xffffffffu, give, 1);
}

__global__ void __launch_bounds__(kThreads)
fused_heads3x3_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ pred_w,
                           const float* __restrict__ pred_b, const float* __restrict__ conf_w,
                           const float* __restrict__ conf_b, float* __restrict__ pred,
                           float* __restrict__ conf, int h, int w, int tiles_x, int tiles,
                           bool do_relu, bool vec) {
  constexpr int P = kP, kE = 4;                 // channels in a 16-byte piece
  constexpr int kPieces = kChannels / kE;       // 16-byte pieces a pixel
  constexpr int kStaged = kNhwcBlockRows + 2;   // input rows the block reads
  constexpr int kCopies = ((kTileW + 2) * kPieces + kThreads - 1) / kThreads;  // a thread's, a row
  extern __shared__ float4 smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t blk = blockIdx.x;
  const int64_t r = blk / tiles;
  const int t = static_cast<int>(blk - r * tiles);
  const int y_first = (t / tiles_x) * kNhwcBlockRows;
  const int x0 = (t % tiles_x) * kTileW;
  const float* xr = x + r * kChannels * h * w;

  // the thread's copies of a staged row: pieces tid, tid + kThreads, ... of
  // its kTileW + 2 pixels from x0 - 1; their offsets in a staged row, and in
  // a map row (-1: outside the map, or past the row's pieces)
  int dst_off[kCopies], src_off[kCopies];
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int k = tid + m * kThreads, px = k / kPieces, piece = k % kPieces, xx = x0 - 1 + px;
    dst_off[m] = 16 * k;
    src_off[m] = k < (kTileW + 2) * kPieces && xx >= 0 && xx < w ? xx * kChannels + piece * kE
                                                                   : -1;
  }
  // staged row i (input row y_first - 1 + i) into ring slot i % kNhwcRing,
  // zero outside the map; consecutive threads copy consecutive 16-byte
  // pieces, contiguous in the map. Every call commits a group, empty past
  // the block's rows
  auto issue = [&](int i) {
    const int y = y_first - 1 + i;
    if (i < kStaged) {
      const bool row_in = y >= 0 && y < h;
      const float* src_row = xr + static_cast<int64_t>(row_in ? y : 0) * w * kChannels;
      unsigned char* dst_row = ring + (i % kNhwcRing) * kNhwcRowBytes;
#pragma unroll
      for (int m = 0; m < kCopies; ++m) {
        if (m < kCopies - 1 || tid + m * kThreads < (kTileW + 2) * kPieces) {
          const bool in = row_in && src_off[m] >= 0;
          const float* src = in ? src_row + src_off[m] : x;
          if (vec) {
            cp_async16(dst_row + dst_off[m], src, in ? 16 : 0);
          } else {
            float* d = reinterpret_cast<float*>(dst_row + dst_off[m]);
#pragma unroll
            for (int e = 0; e < kE; ++e) d[e] = in ? src[e] : 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kNhwcRing - 2; ++i) issue(i);

  // lane = strip * 8 + group: the warp's 32 columns are 4 strips of kP
  // pixels; the lane sums channels 4 group .. 4 group + 3 of its strip, with
  // their weights in registers
  const int group = lane & 7, xl = warp * 32 + (lane >> 3) * P;
  float wt[kLaneChannels][3][3][2];
#pragma unroll
  for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int k = (group * kLaneChannels + c) * 9 + tap;
      wt[c][tap / 3][tap % 3][0] = pred_w[k];
      wt[c][tap / 3][tap % 3][1] = conf_w[k];
    }
  }
  const float bias[2] = {pred_b[0], conf_b[0]};
  const int xo = x0 + xl + group;

#pragma unroll 1
  for (int j = 0; j < kNhwcBlockRows; j += 2) {
    // staged rows j .. j + 3 have landed; the barrier also frees the slots
    // of rows j - 2 and j - 1, read by the step before, for rows j + 4 and
    // j + 5
    static_assert(kNhwcRing == 6, "4 rows read, 2 in flight");
    cp_async_wait<0>();
    __syncthreads();
    issue(j + 4);
    issue(j + 5);
    float acc[2][2][P];  // [output row][output][pixel]
#pragma unroll
    for (int k = 0; k < 2 * 2 * P; ++k) (&acc[0][0][0])[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // staged row j + i: input row y - 1 + i
      const unsigned char* row = ring + ((j + i) % kNhwcRing) * kNhwcRowBytes;
      float v[P + 2][kLaneChannels];
#pragma unroll
      for (int p = 0; p < P + 2; ++p) {
        const float4 q =
            *reinterpret_cast<const float4*>(row + (xl + p) * kChannels * 4 + 16 * group);
        v[p][0] = q.x, v[p][1] = q.y, v[p][2] = q.z, v[p][3] = q.w;
      }
#pragma unroll
      for (int c = 0; c < kLaneChannels; ++c) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int oy = i - dy;  // the output row this filter row reaches
          if (oy < 0 || oy > 1) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
#pragma unroll
              for (int p = 0; p < P; ++p) {
                acc[oy][o][p] = fmaf(v[p + dx][c], wt[c][dy][dx][o], acc[oy][o][p]);
              }
            }
          }
        }
      }
    }
    // the strip's 8 lanes hold 8 shares of each sum: lane ``group`` gets
    // pixel ``group``'s, and stores both outputs there
#pragma unroll
    for (int oy = 0; oy < 2; ++oy) {
      const int y = y_first + j + oy;
      const float s0 = strip_sum(acc[oy][0], lane) + bias[0];
      const float s1 = strip_sum(acc[oy][1], lane) + bias[1];
      if (y < h && xo < w) {
        const int64_t at = r * h * w + static_cast<int64_t>(y) * w + xo;
        pred[at] = do_relu ? relu(s0) : s0;
        conf[at] = sigmoid(s1);
      }
    }
  }
}

// One launch of ``kernel`` over rows x (tiles of th rows x kTileW columns)
// blocks with ``smem`` bytes of dynamic shared memory, on an NCHW map or
// (channels_last) an NHWC one
template <typename T, typename Kernel>
int launch(Kernel kernel, int th, size_t smem, const void* x, const float* pred_w,
           const float* pred_b, const float* conf_w, const float* conf_b, void* pred, void* conf,
           int64_t rows, int64_t h, int64_t w, bool do_relu, bool channels_last,
           cudaStream_t stream) {
  if (rows == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t tiles = (h + th - 1) / th * tiles_x;
  if (h >= (int64_t{1} << 30) || w >= (int64_t{1} << 30) || rows * tiles >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // from a 16-byte aligned map, rows of whole 16-byte pieces (NCHW) or any
  // NHWC map (a pixel is 32 channels): vector loads, and in NCHW vector
  // stores; otherwise element by element
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec =
      aligned && (channels_last || (w * static_cast<int64_t>(sizeof(T))) % 16 == 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows * tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), pred_w, pred_b, conf_w, conf_b, static_cast<T*>(pred),
      static_cast<T*>(conf), static_cast<int>(h), static_cast<int>(w), static_cast<int>(tiles_x),
      static_cast<int>(tiles), do_relu, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NOUT, bool kCL>
int launch_layout(const void* x, int dtype, const float* pred_w, const float* pred_b,
                  const float* conf_w, const float* conf_b, void* pred, void* conf, int64_t rows,
                  int64_t h, int64_t w, bool do_relu, cudaStream_t stream) {
  switch (dtype) {
    case 0:  // f32: on the CUDA cores
      if constexpr (kCL && NOUT <= 2) {
        return launch<float>(fused_heads3x3_nhwc_kernel, kNhwcBlockRows, kNhwcSmem, x, pred_w,
                             pred_b, conf_w, conf_b, pred, conf, rows, h, w, do_relu, kCL, stream);
      } else {
        return launch<float>(fused_heads3x3_kernel<float, NOUT, kCL>, Tile<NOUT>::TH,
                             kSmem<float, NOUT>, x, pred_w, pred_b, conf_w, conf_b, pred, conf,
                             rows, h, w, do_relu, kCL, stream);
      }
    case 2:  // bf16: a channel-last map on the tensor cores; NCHW, 2 outputs on the CUDA cores
      if constexpr (kCL) {
        return launch<__nv_bfloat16>(fused_heads3x3_mma_kernel<NOUT, true>, kMmaBlockRows<NOUT>,
                                     kMmaRingSmem<NOUT>, x, pred_w, pred_b, conf_w, conf_b, pred,
                                     conf, rows, h, w, do_relu, kCL, stream);
      } else if constexpr (NOUT <= 2) {
        return launch<__nv_bfloat16>(fused_heads3x3_kernel<__nv_bfloat16, NOUT, false>,
                                     Tile<NOUT>::TH, kSmem<__nv_bfloat16, NOUT>, x, pred_w, pred_b,
                                     conf_w, conf_b, pred, conf, rows, h, w, do_relu, kCL, stream);
      } else {
        return launch<__nv_bfloat16>(fused_heads3x3_mma_kernel<NOUT, false>, kMmaRows, kMmaSmem,
                                     x, pred_w, pred_b, conf_w, conf_b, pred, conf, rows, h, w,
                                     do_relu, kCL, stream);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NOUT>
int launch_dtype(const void* x, int dtype, const float* pred_w, const float* pred_b,
                 const float* conf_w, const float* conf_b, void* pred, void* conf, int64_t rows,
                 int64_t h, int64_t w, bool do_relu, bool channels_last, cudaStream_t stream) {
  return channels_last
             ? launch_layout<NOUT, true>(x, dtype, pred_w, pred_b, conf_w, conf_b, pred, conf,
                                         rows, h, w, do_relu, stream)
             : launch_layout<NOUT, false>(x, dtype, pred_w, pred_b, conf_w, conf_b, pred, conf,
                                          rows, h, w, do_relu, stream);
}

}  // namespace

// x: (rows, 32, h, w), contiguous (channels_last 0) or channels-last, NHWC in
// memory (channels_last 1), dtype 0 (f32) or 2 (bf16); pred_w (nout - 1, 32,
// 3, 3), pred_b (nout - 1), conf_w (1, 32, 3, 3), conf_b (1): contiguous f32;
// pred (rows, nout - 1, h, w) and conf (rows, 1, h, w): contiguous, x's
// dtype. nout: 2 or 14. Returns the cudaError_t of the launch (0 on success).
extern "C" int omnifusion_fused_heads(const void* x, int dtype, const float* pred_w,
                                      const float* pred_b, const float* conf_w,
                                      const float* conf_b, void* pred, void* conf, int nout,
                                      int64_t rows, int64_t h, int64_t w, int do_relu,
                                      int channels_last, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nout) {
    case 2:
      return launch_dtype<2>(x, dtype, pred_w, pred_b, conf_w, conf_b, pred, conf, rows, h, w,
                             do_relu != 0, channels_last != 0, s);
    case 14:
      return launch_dtype<14>(x, dtype, pred_w, pred_b, conf_w, conf_b, pred, conf, rows, h, w,
                              do_relu != 0, channels_last != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
