// The fused depth and confidence heads: one 3x3 convolution (zero padding 1)
// from the decoder's 32 channels to NOUT outputs, over a channels-last map
// (NHWC in memory, as the decoder leaves it where autograd records nothing,
// so that no transpose runs before the heads), with the bias, a ReLU on the
// first NOUT - 1 outputs (or none) and a sigmoid on the last in its
// epilogue. pred (R, NOUT - 1, H, W) and conf (R, 1, H, W), contiguous NCHW,
// are stored in the map's dtype: bf16 under the bf16 trunk (the serving
// recipe), or f32. NOUT is 2 (depth and confidence) or 14 (the 13-class
// segmentation model's logits and confidence).
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
// Every kernel: a block makes tiles of 128 columns of one map (neighbouring
// tiles of a map are neighbouring blocks, so the halo rows come from L2),
// from the tile's input staged in shared memory, with one halo row and
// column on each side, zero outside the map. The weights are the heads' own
// f32 parameters, two pointers each for the weights and the biases, so
// nothing is concatenated per call; under a bf16 map they are rounded to
// bf16 first, as the plain version casts them. The sums are f32 and rounded
// once, after the bias and the activation; the plain version (cuDNN) rounds
// the convolution's output to the map's dtype before the bias and again
// after it, so in bf16 the two differ by about a bf16 ulp of the sum. Where
// the map is not 16-byte aligned the staging goes element by element.
//
// A pixel's 32 channels are 64 (bf16) or 128 (f32) contiguous bytes.
// Staging a chunk of channels of every pixel reads 16 bytes of each pixel's
// run at a time, half of each 32-byte sector, and took 1.4x (bf16) and 2.8x
// (f32) as long at NOUT = 2 as the same kernel on an NCHW map, on an H100
// (700 W). So the memory-bound kernels copy whole rows of the map, which are
// contiguous, and walk down it: a block makes kMmaBlockRows (or
// kNhwcBlockRows) rows, a few rows at a time, from a ring of staged rows
// that cp.async fills a step ahead; each input row is copied once, with 2
// halo rows a block.
//
// fused_heads3x3_mma_kernel<NOUT> (bf16, NOUT = 2 and 14): an implicit GEMM
// per 16-pixel group of a row, D[16 pixels][8 outputs] += A[16 pixels][16
// channels] x B[16 channels][8 outputs] for each of the 9 taps and both
// halves of the 32 channels, by mma.sync m16n8k16 (bf16 operands, f32
// accumulators), one or two 8-output tiles. A staged row is [pixel][32
// channels] (64 bytes a pixel, the map's 16-byte pieces copied as they
// are), so a tap's A fragment is one ldmatrix.x4 of 16 pixel rows at any
// column offset; the 16-byte pieces of a pixel are XOR-swizzled by (pixel /
// 2) mod 4, so the 8 rows of an 8x8 matrix fall in distinct banks. The B
// fragments (9 x 2 x 2 registers an output tile) are built once per thread
// from the parameters. At NOUT = 2 the 8-output tile is 3/4 padding but the
// instructions few: on the CUDA cores the bf16 unpacking set the pace (0.83
// ms at b64 against 0.61 here); at NOUT = 14 the CUDA cores took 2.7x as
// long, on an H100 (700 W). Steps of 1 row (4 warps a row, NOUT = 2) or 2
// rows (NOUT = 14) with one step in flight timed best (kMmaStepRows).
//
// fused_heads3x3_nhwc_kernel (f32, NOUT = 2): on the CUDA cores (the tensor
// cores' f32 path is TF32, which the f32 plain version does not round to).
// Lane = strip * 8 + group: 8 lanes share a strip of kP = 8 pixels, each
// summing 4 of the 32 channels (one 16-byte load a pixel) for both outputs
// of 2 rows, with its 72 weights in registers; a butterfly of shuffles
// gives lane ``group`` the strip's sums at pixel ``group``.
//
// fused_heads3x3_kernel (f32, NOUT = 14): on the CUDA cores, bound by its
// f32 FMAs, not by its bytes. The input is staged kChunk channels at a
// time, as kChunk planes of TH + 2 rows x 130 columns, in two buffers (a
// pixel's kChunk channels loaded together and stored to their planes). Two
// threads share a strip of kP = 8 adjacent pixels of one row, each with 7
// of the outputs in registers (TH = 4 rows a block); per channel and filter
// row a thread reads its 10 inputs (one pair of 16-byte loads and two
// scalars) and the filter row's weights from shared memory (a broadcast),
// for 3 x 8 x 7 FMAs.

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

constexpr int kMmaRows = 4;                 // output rows of a step's warps
constexpr int kMmaCols = kTileW + 2;        // staged pixels of a row
constexpr int kPixelBytes = 2 * kChannels;  // a staged pixel: 32 bf16 channels
// a block walks down kMmaBlockRows rows of the map in steps of kMmaStepRows
// rows (kMmaRows / kMmaStepRows warps a row), with a ring of staged rows: a
// step's kMmaStepRows + 2 and the next step's kMmaStepRows in flight. Timed
// on an H100 (700 W), b64: 1-row steps over 32 rows at 2 outputs (0.611 ms;
// 2-row steps 0.649, a second step in flight 0.662), 2-row steps over 64
// rows at 14 (0.885 ms; over 32 rows 0.926)
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

template <int NOUT>
__global__ void __launch_bounds__(kThreads)
fused_heads3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pred_w,
                          const float* __restrict__ pred_b, const float* __restrict__ conf_w,
                          const float* __restrict__ conf_b, __nv_bfloat16* __restrict__ pred,
                          __nv_bfloat16* __restrict__ conf, int h, int w, int tiles_x, int tiles,
                          bool do_relu, bool vec) {
  constexpr int NT = (NOUT + 7) / 8;  // tiles of 8 outputs
  constexpr int kStepRows = kMmaStepRows<NOUT>;              // output rows of a step
  constexpr int kSteps = kMmaBlockRows<NOUT> / kStepRows;
  constexpr int kSlots = kMmaRing<NOUT>;                     // staged rows held
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

  // a pixel's 32 channels are 4 contiguous 16-byte pieces, staged as they
  // are (piece k holds channels 8 k .. 8 k + 7), with cp.async; consecutive
  // threads take consecutive pieces of a staged row, contiguous in the map.
  // Staged rows i .. i + n - 1 (input rows y0 - 1 + i ..; none past the
  // block's) go to ring slots i % kSlots, as one group
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
  issue_rows(0, kStepRows + 2);

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
    // the step's staged rows have landed; the barrier also frees the slots
    // of the step before's first kStepRows rows, for the next step's
    cp_async_wait<0>();
    __syncthreads();
    issue_rows(kStepRows * (step + 1) + 2, kStepRows);
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

// ---- the sums on the CUDA cores, f32, 14 outputs, a chunk of channels at a time ----

constexpr int kChunkOut = 14;  // outputs of the kernel
constexpr int kChunk = 4;      // channels staged at a time
constexpr int kChunks = kChannels / kChunk;
constexpr int kP = 8;  // adjacent output pixels of a row per thread
// A thread makes kP pixels of one row for kOpt of the outputs: kSplit
// threads share a strip of pixels, each with its own outputs
constexpr int kSplit = 2;
constexpr int kOpt = kChunkOut / kSplit;
constexpr int kStrips = kTileW / kP;            // strips of a row
constexpr int kPerRow = kStrips * kSplit;       // threads per row of threads
constexpr int kChunkRows = kThreads / kPerRow;  // output rows per block
constexpr int kG = (3 * kOpt + 3) / 4 * 4;      // floats per (channel, filter row, split)
static_assert(kChunkOut % kSplit == 0 && kThreads % kPerRow == 0, "tile");

// A staged row holds column x at x + kOff, so the tile's columns start
// 16-byte aligned and the halo column sits before
constexpr int kOff = 4;                              // floats in 16 bytes
constexpr int kRowStride = kOff + kTileW + kOff;     // a multiple of 16 bytes
constexpr size_t kChunkSmem = sizeof(float) * kChannels * 3 * kSplit * kG +
                              2 * sizeof(float) * kChunk * (kChunkRows + 2) * kRowStride;

// N floats at p (16-byte aligned)
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
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_heads3x3_kernel(const float* __restrict__ x, const float* __restrict__ pred_w,
                      const float* __restrict__ pred_b, const float* __restrict__ conf_w,
                      const float* __restrict__ conf_b, float* __restrict__ pred,
                      float* __restrict__ conf, int h, int w, int tiles_x, int tiles, bool do_relu,
                      bool vec) {
  constexpr int NOUT = kChunkOut, P = kP, TH = kChunkRows, G = kG, OPT = kOpt;
  constexpr int kStage = kChunk * (TH + 2) * kRowStride;  // floats per buffer

  extern __shared__ float4 smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [channel][filter row][split][G]
  float* stage = w_s + kChannels * 3 * kSplit * G;

  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int64_t r = blk / tiles;
  const int t = static_cast<int>(blk - r * tiles);
  const int y0 = (t / tiles_x) * TH;
  const int x0 = (t % tiles_x) * kTileW;
  const float* xr = x + r * kChannels * h * w;

  // the chunk's TH + 2 rows x kTileW + 2 columns of kChunk channels into
  // buffer ``buf``, zero outside the map: the chunk's kChunk channels of a
  // pixel are contiguous, loaded together and stored to their kChunk planes
  auto issue = [&](int chunk, float* buf) {
    const int c0 = chunk * kChunk;
    for (int i = tid; i < (TH + 2) * (kTileW + 2); i += kThreads) {
      const int row = i / (kTileW + 2), col = i - row * (kTileW + 2);
      const int y = y0 - 1 + row, xx = x0 - 1 + col;
      float v[kChunk] = {};
      if (inside(y, xx, h, w)) {
        const float* src = xr + (static_cast<int64_t>(y) * w + xx) * kChannels + c0;
        if (vec) {
          load_vec<kChunk>(src, v);
        } else {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) v[c] = src[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        buf[(c * (TH + 2) + row) * kRowStride + kOff - 1 + col] = v[c];
      }
    }
    cp_async_commit();
  };

  issue(0, stage);

  // the weights, as [channel][filter row][split][dx * OPT + output of the
  // split], zero past 3 OPT
  for (int i = tid; i < kChannels * 3 * kSplit * G; i += kThreads) {
    const int g = i / G, j = i - g * G;
    const int cdy = g / kSplit, split = g - cdy * kSplit;
    float v = 0.f;
    if (j < 3 * OPT) {
      const int dx = j / OPT, o = split * OPT + j - dx * OPT, tap = cdy * 3 + dx;  // (c, dy, dx)
      v = o < NOUT - 1 ? pred_w[o * kChannels * 9 + tap] : conf_w[tap];
    }
    w_s[i] = v;
  }

  const int tr = tid / kPerRow, in_row = tid - tr * kPerRow;
  const int split = in_row / kStrips, xl = (in_row - split * kStrips) * P;
  float acc[OPT][P];
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
#pragma unroll
    for (int p = 0; p < P; ++p) acc[o][p] = 0.f;
  }

#pragma unroll 1
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    float* buf = stage + (chunk & 1) * kStage;
    if (chunk + 1 < kChunks) {
      issue(chunk + 1, stage + ((chunk + 1) & 1) * kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk's stores and (first) the weights
#pragma unroll
    for (int cl = 0; cl < kChunk; ++cl) {
      const float* src = buf + (cl * (TH + 2) + tr) * kRowStride + kOff + xl;
      const float* wc = w_s + (chunk * kChunk + cl) * 3 * kSplit * G + split * G;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[P + 2], wv[G];
        v[0] = src[dy * kRowStride - 1];
        load_vec<P>(src + dy * kRowStride, v + 1);
        v[P + 1] = src[dy * kRowStride + P];
        load_vec<G>(wc + dy * kSplit * G, wv);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int o = 0; o < OPT; ++o) {
#pragma unroll
            for (int p = 0; p < P; ++p) acc[o][p] = fmaf(v[p + dx], wv[dx * OPT + o], acc[o][p]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }

  const int xo = x0 + xl;
  const int y = y0 + tr;
  if (xo >= w || y >= h) return;
  // rows of whole 16-byte pieces: vector stores
  const bool vec_out = w % kOff == 0;
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int oo = split * OPT + o;
    const float bias = oo < NOUT - 1 ? pred_b[oo] : conf_b[0];
    float out[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float s = acc[o][p] + bias;
      out[p] = oo == NOUT - 1 ? sigmoid(s) : (do_relu ? relu(s) : s);
    }
    float* dst = (oo == NOUT - 1 ? conf + r * h * w : pred + (r * (NOUT - 1) + oo) * h * w) +
                 static_cast<int64_t>(y) * w + xo;
    if (vec_out && xo + P <= w) {
      store_vec<P>(dst, out);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (xo + p < w) dst[p] = out[p];
      }
    }
  }
}

// ---- the sums on the CUDA cores, f32, 2 outputs, whole rows at a time ----

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
// blocks with ``smem`` bytes of dynamic shared memory
template <typename T, typename Kernel>
int launch(Kernel kernel, int th, size_t smem, const void* x, const float* pred_w,
           const float* pred_b, const float* conf_w, const float* conf_b, void* pred, void* conf,
           int64_t rows, int64_t h, int64_t w, bool do_relu, cudaStream_t stream) {
  if (rows == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t tiles = (h + th - 1) / th * tiles_x;
  if (h >= (int64_t{1} << 30) || w >= (int64_t{1} << 30) || rows * tiles >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a pixel is 32 channels, a whole number of 16-byte pieces: from a 16-byte
  // aligned map, vector loads; otherwise element by element
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows * tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), pred_w, pred_b, conf_w, conf_b, static_cast<T*>(pred),
      static_cast<T*>(conf), static_cast<int>(h), static_cast<int>(w), static_cast<int>(tiles_x),
      static_cast<int>(tiles), do_relu, vec);
  return static_cast<int>(cudaGetLastError());
}

// the kernel of a (dtype, nout): dtype 0 (f32) or 2 (bf16), nout 2 or 14
constexpr int form(int dtype, int nout) { return dtype * 64 + nout; }

}  // namespace

// x: (rows, 32, h, w), channels-last (NHWC in memory), dtype 0 (f32) or 2
// (bf16); pred_w (nout - 1, 32, 3, 3), pred_b (nout - 1), conf_w (1, 32, 3,
// 3), conf_b (1): contiguous f32; pred (rows, nout - 1, h, w) and conf
// (rows, 1, h, w): contiguous, x's dtype. nout: 2 or 14. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int omnifusion_fused_heads(const void* x, int dtype, const float* pred_w,
                                      const float* pred_b, const float* conf_w,
                                      const float* conf_b, void* pred, void* conf, int nout,
                                      int64_t rows, int64_t h, int64_t w, int do_relu,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool relu = do_relu != 0;
  switch (form(dtype, nout)) {
    case form(2, 2):  // bf16: on the tensor cores
      return launch<__nv_bfloat16>(fused_heads3x3_mma_kernel<2>, kMmaBlockRows<2>,
                                   kMmaRingSmem<2>, x, pred_w, pred_b, conf_w, conf_b, pred, conf,
                                   rows, h, w, relu, s);
    case form(2, 14):
      return launch<__nv_bfloat16>(fused_heads3x3_mma_kernel<14>, kMmaBlockRows<14>,
                                   kMmaRingSmem<14>, x, pred_w, pred_b, conf_w, conf_b, pred,
                                   conf, rows, h, w, relu, s);
    case form(0, 2):  // f32: on the CUDA cores
      return launch<float>(fused_heads3x3_nhwc_kernel, kNhwcBlockRows, kNhwcSmem, x, pred_w,
                           pred_b, conf_w, conf_b, pred, conf, rows, h, w, relu, s);
    case form(0, 14):
      return launch<float>(fused_heads3x3_kernel, kChunkRows, kChunkSmem, x, pred_w, pred_b,
                           conf_w, conf_b, pred, conf, rows, h, w, relu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
