// The toolchain probe: out = 2 * x on float32.
//
// Replaces the Pallas probe of tools/bench_pallas_merge.py:57-63, a lambda
// that doubles a (256, 128) f32 block held whole in VMEM, which the merge
// shootout launches first to fail fast when the toolchain cannot build or
// launch a kernel. omnifusion_torch/tools/bench_merge.py launches this one
// first for the same reason.
//
// Bound on the card: bytes (4 read + 4 written per element over 3.35 TB/s;
// 262,144 bytes at the shootout's shape, about 0.08 us). At that size the
// launch itself, a few microseconds, sets the time.
//
// Design: one thread per element, no shared memory: the kernel exists to be
// built and launched, and to be checked bit for bit against 2 * x.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i];
}

}  // namespace

// x, out: n contiguous float32 values. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int omnifusion_probe(const float* x, float* out, int64_t n, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n);
  return static_cast<int>(cudaGetLastError());
}
