// Windowed-Gaussian heatmap rendering for Hopper (sm_90a).
//
// Replaces the TPU kernel dahpe_tpu/ops/pallas/gaussian.py:render_gaussian_pallas
// (body _render_kernel): out[b, y, x, k] = exp(-d2 / (2 sigma^2)) where
// d2 = dx^2 + dy^2, dx = x - mu[b, k, 0], dy = y - mu[b, k, 1], inside the
// square window |dx|, |dy| <= reach of a valid joint, and 0 elsewhere.
//
// What bounds it: the inputs are tiny (B*K peaks and flags) and the output is
// the whole (B, H, W, K) float32 map, so by bytes the op is bound by writing
// its output (B=32, 64x64, K=21: 11.0 MB, ~3.3 us at 3.35 TB/s). Almost all
// of the map is zero: a joint's window covers (2 reach + 1)^2 of the H*W
// pixels (169 of 4096 at 64^2), so the work that is not a store lies in a
// few percent of the elements.
//
// The design stores zeros at the rate of a fill and computes only window
// elements:
// - A block owns a run of the flat map, `per_block` floats (a multiple of 4,
//   so every run starts on a 16-byte boundary), sized so that the grid is
//   kBlocksPerSm blocks an SM, and at least kMinFloats (at the small maps a
//   block's fixed latency, not its stores, is what costs).
// - Each thread first loads its (row, joint)'s peak and flag (one round
//   trip), then stores its share of the run's zeros (16-byte stores, a
//   warp's store covering 512 contiguous bytes; a tail of 1-3 floats where
//   B*H*W*K is not a multiple of 4), and tables expf(-(float)d2 /
//   two_sigma_sq) for every d2 <= 2 reach^2 (73 values at reach 6): inside
//   a window d2 is never larger.
// - After one barrier (the zeros are then performed for the block, so no
//   zero lands over a value), a thread per (row (b, y), joint) of the rows
//   the run touches tests the joint's window against the row in 64-bit
//   arithmetic (a far-off peak cannot overflow) and stores the table's values
//   over its columns, cut to the map and to the run: one shared load and one
//   store per window element, nothing per zero. A reach above kTableReach
//   computes the same expression per window element.
// Window elements are stored twice (zero, then value), a few percent of the
// map's bytes, which merge in the L2 cache before they reach device memory.
// Staging the run in shared memory and copying it out whole, by the threads
// or by the Tensor Memory Accelerator's bulk copy (cp.async.bulk), measured
// slower: the copy waits for the windows, where here the zeros do not.
//
// Measured (chip_smoke.py phase 2, beside the earlier per-element design's
// own chip_smoke.py in one call, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6): at (32, 64^2, 21) 0.0057 ms against 0.0172 and a 0.0033 ms
// byte bound (1.7x); its zero-store yardstick 0.0047 ms, the same as a
// PyTorch fill of the map. At 32^2 and 16^2 (0.0039 and 0.0034 ms) it runs
// 1.3 us over the fill: a block's round trip for its peaks, the barrier and
// the windows' dependent table loads, which the small maps cannot hide.
// ptxas (-Xptxas -v): 32 registers, 2052 bytes of static shared memory (the
// table), no spills; the yardstick 14 registers.
//
// Exactness: dx, dy and d2 are integers, d2 wraps as the plain version's
// int32 arithmetic does, and each value is expf(__fdiv_rn(-(float)d2,
// two_sigma_sq)) with IEEE division, in the table or per element alike, so
// the map is bit-identical to the earlier per-element kernel and, at the
// path's sigma 2 (a reciprocal that is exact), to the plain PyTorch version.
// The file must be compiled WITHOUT --use_fast_math (__expf differs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // blocks the grid aims for per SM
constexpr int kMinFloats = 2048;  // a block's run of the map, at least
constexpr int kTableReach = 16;  // the largest reach whose window values are tabled
constexpr int kTableSize = 2 * kTableReach * kTableReach + 1;

__device__ __forceinline__ float window_value(int d2, float two_sigma_sq) {
  return expf(__fdiv_rn(-(float)d2, two_sigma_sq));
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

// Floats a block owns of a map of `total`: a multiple of 4, at least
// kMinFloats, spreading the map over kBlocksPerSm blocks an SM.
int floats_per_block(int total) {
  const int target = sm_count() * kBlocksPerSm;
  int per = (total + target - 1) / target;
  per = per > kMinFloats ? per : kMinFloats;
  return (per + 3) / 4 * 4;
}

// Zeros over run[0, n), run 16-byte aligned: 16-byte stores by all threads,
// then the 1-3 floats after the last whole chunk.
__device__ __forceinline__ void store_zeros(float* __restrict__ run, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    reinterpret_cast<float4*>(run)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if ((int)threadIdx.x < (n & 3)) run[(n & ~3) + threadIdx.x] = 0.0f;
}

// One (row, joint) of a block's rows: the joint's peak and flag, loaded
// together, and where the row's element of the joint lies in the run.
struct Joint {
  long long mx, dy;
  float valid;
  int base;  // run index of the element (row, x = 0, k)
};

__device__ __forceinline__ Joint load_joint(const int32_t* __restrict__ mu,
                                            const float* __restrict__ valid, int i, int joints,
                                            int row0, int height, int row_len, int g0) {
  const int r = i / joints, k = i - r * joints;
  const int row = row0 + r, b = row / height;
  const int bk = b * joints + k;
  const int2 m = __ldg(reinterpret_cast<const int2*>(mu) + bk);
  return {m.x, (long long)(row - b * height) - m.y, __ldg(valid + bk), row * row_len + k - g0};
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads) render_gaussian_kernel(
    const int32_t* __restrict__ mu, const float* __restrict__ valid,
    float* __restrict__ out, int total, int height, int width, int joints,
    int per_block, float two_sigma_sq, int reach) {
  __shared__ float table[kTable ? kTableSize : 1];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int g0 = blockIdx.x * per_block;
  const int n = min(per_block, total - g0);
  const int row_len = width * joints;
  float* run = out + g0;

  // 1. this thread's first (row, joint) of the rows the run touches in
  // flight; the run's zeros, and the table
  const int row0 = g0 / row_len;
  const int items = ((g0 + n - 1) / row_len - row0 + 1) * joints;
  Joint j{};
  if (tid < items) j = load_joint(mu, valid, tid, joints, row0, height, row_len, g0);
  store_zeros(run, n);
  if (kTable)
    for (int d2 = tid; d2 <= 2 * reach * reach; d2 += nt) table[d2] = window_value(d2, two_sigma_sq);
  __syncthreads();

  // 2. a thread a (row, joint): the window's values over its columns, cut
  // to the map and to the run (element (row, x, k) is run[base + x K])
  for (int i = tid; i < items; i += nt) {
    if (i != tid) j = load_joint(mu, valid, i, joints, row0, height, row_len, g0);
    if (!(j.valid > 0.0f) || j.dy < -(long long)reach || j.dy > reach) continue;
    const long long lo = max(max(j.mx - reach, 0LL), (long long)((-j.base + joints - 1) / joints));
    const long long hi = min(min(j.mx + reach, (long long)width - 1),
                             (long long)(n - 1 - j.base >= 0 ? (n - 1 - j.base) / joints : -1));
    // dy^2 as the plain version's int32 product gives it (mod 2^32)
    const unsigned dy2 = (unsigned)j.dy * (unsigned)j.dy;
    for (int x = (int)lo; x <= (int)hi; ++x) {
      const int dx = x - (int)j.mx;
      const unsigned d2 = (unsigned)dx * (unsigned)dx + dy2;
      run[j.base + x * joints] = kTable ? table[d2] : window_value((int)d2, two_sigma_sq);
    }
  }
}

// Yardstick for the measurement script (chip_smoke.py), not used by the port:
// the kernel's launch geometry (the same runs and zero stores) with nothing
// else. Its time minus the byte bound is what the geometry costs; the
// kernel's time minus its time is what the peaks, the table and the windows
// cost.
__global__ void __launch_bounds__(kThreads) store_zero_kernel(float* __restrict__ out,
                                                              int total, int per_block) {
  const int g0 = blockIdx.x * per_block;
  store_zeros(out + g0, min(per_block, total - g0));
}

}  // namespace

// C interface, bound with ctypes. mu: (B, K, 2) int32, 8-byte aligned,
// valid: (B, K) float32, out: (B, H, W, K) float32, 16-byte aligned, all
// contiguous on the current device; stream is a cudaStream_t. The caller
// (ops/gaussian.py) guarantees 0 < B*H*W*K < 2^31. Returns the launch's
// cudaError_t (0 on success).
extern "C" int render_gaussian_f32(const void* mu, const void* valid, void* out,
                                   int batch, int height, int width, int joints,
                                   float two_sigma_sq, int reach, void* stream) {
  const int total = batch * height * width * joints;
  const int per = floats_per_block(total);
  const auto kernel = reach >= 0 && reach <= kTableReach ? render_gaussian_kernel<true>
                                                        : render_gaussian_kernel<false>;
  kernel<<<(total + per - 1) / per, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mu, (const float*)valid, (float*)out, total, height, width, joints,
      per, two_sigma_sq, reach);
  return (int)cudaGetLastError();
}

extern "C" int render_gaussian_store_zero_f32(void* out, int batch, int height, int width,
                                              int joints, void* stream) {
  const int total = batch * height * width * joints;
  const int per = floats_per_block(total);
  store_zero_kernel<<<(total + per - 1) / per, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, total, per);
  return (int)cudaGetLastError();
}
