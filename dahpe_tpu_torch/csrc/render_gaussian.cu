// Windowed-Gaussian heatmap rendering for Hopper (sm_90a).
//
// Replaces the TPU kernel dahpe_tpu/ops/pallas/gaussian.py:render_gaussian_pallas
// (body _render_kernel): out[b, y, x, k] = exp(-d2 / (2 sigma^2)) where
// d2 = dx^2 + dy^2, dx = x - mu[b, k, 0], dy = y - mu[b, k, 1], inside the
// square window |dx|, |dy| <= reach of a valid joint, and 0 elsewhere.
//
// What bounds it: the inputs are tiny (B*K peaks and flags) and the output is
// the whole (B, H, W, K) float32 map, so by bytes the op is bound by writing
// its output (B=32, 64x64, K=21: 11.0 MB, ~3.3 us at 3.35 TB/s). The design
// does the least memory work: one thread per output element over the flat
// (b, y, x, k) index, so a warp writes 32 consecutive floats and each element
// is written exactly once; mu and valid are read through the L1 cache (21
// joints share one 168-byte row of mu). Nothing is staged in shared memory:
// the value is computed from the thread's index. The index is decoded in
// 32-bit arithmetic (the wrapper keeps the element count below 2^31): 64-bit
// division is emulated in software on the card.
//
// On the H100 this simple form runs at ~5x its byte bound (PERF.md). Part of
// the gap is the geometry: one scalar store per thread needs many small
// blocks (the yardstick below measures that alone); the rest is the work per
// element (index decode, IEEE division, expf). Several elements per thread
// with vector stores, a per-block table of the 2*reach^2+1 possible values and
// a division-free index are the next steps.
//
// Exactness: dx, dy and d2 are integers and the exponent is
// expf(-(float)d2 / two_sigma_sq) with IEEE division, which matches the
// plain PyTorch version to within expf's 2 ulp. The file must be compiled
// WITHOUT --use_fast_math: __expf would miss the 1e-6 tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void render_gaussian_kernel(const int32_t* __restrict__ mu,
                                       const float* __restrict__ valid,
                                       float* __restrict__ out, int total,
                                       int height, int width, int joints,
                                       float two_sigma_sq, int reach) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % joints;
  int t = i / joints;
  const int x = t % width;
  t /= width;
  const int y = t % height;
  const int bk = (t / height) * joints + k;

  float g = 0.0f;
  if (__ldg(valid + bk) > 0.0f) {
    // 64-bit differences: a far-off peak cannot overflow before the test
    const int64_t dx = (int64_t)x - __ldg(mu + 2 * bk);
    const int64_t dy = (int64_t)y - __ldg(mu + 2 * bk + 1);
    if (dx >= -reach && dx <= reach && dy >= -reach && dy <= reach) {
      const int d2 = (int)(dx * dx + dy * dy);
      g = expf(-(float)d2 / two_sigma_sq);
    }
  }
  out[i] = g;
}

}  // namespace

// C interface, bound with ctypes. mu: (B, K, 2) int32, valid: (B, K) float32,
// out: (B, H, W, K) float32, all contiguous on the current device; stream is a
// cudaStream_t. The caller (ops/gaussian.py) guarantees 0 < B*H*W*K < 2^31.
// Returns the launch's cudaError_t (0 on success).
extern "C" int render_gaussian_f32(const void* mu, const void* valid, void* out,
                                   int batch, int height, int width, int joints,
                                   float two_sigma_sq, int reach, void* stream) {
  const int total = batch * height * width * joints;
  render_gaussian_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)mu, (const float*)valid, (float*)out, total, height,
      width, joints, two_sigma_sq, reach);
  return (int)cudaGetLastError();
}

// Yardstick for the measurement script (chip_smoke.py), not used by the port:
// the kernel's launch geometry (one float per thread, kThreads per block)
// writing zeros. Its time minus the byte bound is what the geometry costs;
// the kernel's time minus its time is what the per-element work costs.
namespace {
__global__ void store_zero_kernel(float* __restrict__ out, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < total) out[i] = 0.0f;
}
}  // namespace

extern "C" int render_gaussian_store_zero_f32(void* out, int total, void* stream) {
  store_zero_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>((float*)out, total);
  return (int)cudaGetLastError();
}
