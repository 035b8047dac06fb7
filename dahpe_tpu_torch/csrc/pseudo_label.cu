// Fused pseudo-labels (GT and ground-false) for Hopper (sm_90a).
//
// Replaces the TPU kernel dahpe_tpu/ops/pallas/pseudo_label.py:pseudo_labels_pallas
// (body _kernel). From integer peaks mu (B, K, 2) it writes, for every
// (b, y, x, k) of an S x S map:
//
//   gt = exp(-d2 / (2 sigma^2)) inside the window |dx|, |dy| <= reach, else 0
//   gf = union_minus:  clip(clip(sum_k gt) - 10 gt)
//        inverse:      clip(1 - 10 gt)
//        union_others: clip(sum_k gt - gt)
//   gf = clip(gf + fused - 100 gt)            with a fused target
//   gf = gf / max(max_{y,x} gf, 1e-12)        per (b, k), when normalizing
//
// (clip to [0, 1]); the plain version is ops/pseudo_label.py:pseudo_labels_plain.
// GT is optional: the training path keeps only GF, so the caller may pass a
// null gt and the kernel writes GF alone.
//
// What bounds it on the H100: bytes. Writing GF (and GT) once and reading the
// fused target once: at B=32, S=64, K=21 each map is 11 MB, so (GT, GF) with
// a fused target is 33 MB, ~9.9 us at 3.35 TB/s, and GF alone 22 MB, ~6.6 us.
// The per-element work (an integer window test, at most one expf, a few
// clips, the union sum's K adds per pixel) is a fraction of that at the
// float32 rate (chip_smoke.py:labels_bound_ms).
//
// What held the previous design back (0.1207 ms at 64^2 with a fused target,
// 12x the bound): one block per batch element put 32 blocks on 132 SMs at
// B = 32, and each block made three passes over its map (the union-sum
// table, a max pass that read the fused target and recomputed GT, a write
// pass that read it again and recomputed everything).
//
// The design: a thread-block cluster of 8 blocks per batch element (grid
// (8, B), 256 blocks at B = 32). Each block owns a contiguous range of
// ceil(S^2 / 8) pixels with all K joints, which in the (B, S, S, K) layout is
// one contiguous run of elements (512 x 21 floats = 43 KB at 64^2). In one
// pass a block fills its pixels' union sums (summed in the order k = 0 ..
// K-1, as the previous kernel summed them; the normalisation below is
// within 2 ulp of its division), reads its run of
// the fused target once with coalesced loads, computes GT and the
// unnormalised GF once per element, writes GT (when asked) and keeps GF in
// shared memory. Each thread keeps one joint (the block has
// (512 / K) * K threads) and its max in a register; a shared atomicMax
// reduces the block's maxima per joint, and after cluster.sync() every block
// reads the 8 blocks' maxima through distributed shared memory
// (cluster.map_shared_rank). Then it scales GF by one reciprocal of the max
// and writes it from shared memory. Every element is computed once and each
// output is written once, fully coalesced. Builds without normalisation
// write GF in the first pass and launch as plain blocks, without the
// cluster. The GF kind, the fused target and the normalisation are template
// parameters (12 instances), so no branch on them is left in a thread's
// loops. The window Gaussians, exp(-d2 / (2 sigma^2)) for the 2 reach^2 + 1
// integer d2 a window holds, are tabulated once per block: a warp's lanes
// span several joints, so most warps have a lane inside some window, and a
// division and an expf there held every lane.
//
// The largest shapes: staging GF takes ceil(S^2 / 8) * K * 4 bytes beside
// the sum table, which fits the 227 KB a block may use at every path shape
// and, at K = 21, for every S <= 90. Where it does not (K = 64 near S = 90:
// ~264 KB), the wrapper (ops/pseudo_label.py:launch_geometry) turns staging
// off and the block recomputes GF in a second pass, reading the fused target
// again (the previous design's cost, for those shapes only).
//
// Measured (chip_smoke.py phase 2, run in turns with the previous design's
// own chip_smoke.py on one card, NVIDIA H100 80GB HBM3, 700.00 W), the
// path's builds writing GF alone: 64^2 with a fused target 0.0224 ms against
// the previous design's 0.1207 (which always wrote GT too) and a 0.0066 ms
// byte bound (3.4x; with GT 0.0238 ms, bound 0.0099); 32^2 0.0090 ms (0.0300
// before, bound 0.0016); 16^2 0.0034 ms (0.0056, bound 0.0002), a launch
// and little else. What holds it: not bytes (writing GT beside GF costs
// 0.0014 ms for 11 MB) but each thread's chain of ~21 elements a pass, with
// 2 blocks of 504 threads an SM.
//
// Exactness: gt uses render_gaussian.cu's arithmetic (integer d2, IEEE
// division, expf) and is bit-identical to the plain version. Products that
// feed a sum use __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// them into an FMA the plain version does not do. The union sum is taken in
// another order than torch.sum, so gf agrees to ~1 ulp of the sum, and the
// normalisation multiplies by a correctly rounded reciprocal where the plain
// version divides (2 ulp at most), inside the JAX suite's atol (1e-6, 1e-5
// with a fused target). The max does not depend on the order of the
// reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxJoints = 64;
constexpr int kClusterBlocks = 8;
constexpr int kThreads = 512;

enum GfKind { kUnionMinus = 0, kInverse = 1, kUnionOthers = 2 };

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

constexpr int kMaxTableReach = 12;  // windows whose Gaussians the block tabulates

// exp(-d2 / (2 sigma^2)) as render_gaussian.cu computes it (IEEE division,
// expf), for an integer squared distance d2.
__device__ __forceinline__ float gaussian_of(int d2, float two_sigma_sq) {
  return expf(-(float)d2 / two_sigma_sq);
}

// The window Gaussian at pixel (x, y) for a peak (mx, my) that clamp_peak has
// brought within reach + 1 of the map, so dx and dy fit int32. table:
// gaussian_of(d2) for d2 in [0, 2 reach^2] (windows of reach <=
// kMaxTableReach, whose d2 is small), else null and d2 is taken in int64 as
// the plain version's arithmetic.
__device__ __forceinline__ float gaussian_at(int x, int y, int mx, int my,
                                             float two_sigma_sq, int reach,
                                             const float* table) {
  const int dx = x - mx, dy = y - my;
  if (dx < -reach || dx > reach || dy < -reach || dy > reach) return 0.0f;
  if (table != nullptr) return table[dx * dx + dy * dy];
  return gaussian_of((int)((int64_t)dx * dx + (int64_t)dy * dy), two_sigma_sq);
}

// A peak coordinate moved into [-reach - 1, size + reach]: a peak outside
// that range has no pixel of [0, size) in its window, and neither has the
// clamped one, so every Gaussian stays the same.
__device__ __forceinline__ int clamp_peak(int v, int size, int reach) {
  const int64_t lo = -(int64_t)reach - 1, hi = (int64_t)size + reach;
  return (int)max(min((int64_t)v, hi), lo);
}

// Dynamic shared memory: the sum table (ceil(S^2 / 8) floats, padded to a
// multiple of 4) and, when staged, the block's run of ceil(S^2 / 8) * K
// floats of unnormalised GF.
// Launched as one cluster of kClusterBlocks blocks per batch element when
// normalizing (the blocks exchange their maxima), as plain blocks otherwise;
// block blockIdx.x of the row owns the blockIdx.x-th range of pixels. One
// instance per GF kind, fused target or none, normalisation or none.
template <int kKind, bool kFused, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
pseudo_labels_kernel(const int32_t* __restrict__ mu, const float* __restrict__ fused,
                     float* __restrict__ gt_out, float* __restrict__ gf_out, int size,
                     int joints, float two_sigma_sq, int reach, int staged) {
  __shared__ int2 peak[kMaxJoints];
  __shared__ unsigned int max_bits[kMaxJoints];
  __shared__ float gauss[2 * kMaxTableReach * kMaxTableReach + 1];
  extern __shared__ __align__(16) float dyn[];

  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int pixels = size * size;
  const int chunk = (pixels + kClusterBlocks - 1) / kClusterBlocks;
  const int p0 = min(rank * chunk, pixels);
  const int count = min(chunk, pixels - p0);  // this block's pixels
  const size_t run0 = ((size_t)b * pixels + p0) * joints;  // the block's first element
  float* table = dyn;
  float* stage = dyn + ((chunk + 3) & ~3);

  for (int k = tid; k < joints; k += blockDim.x) {
    peak[k] = make_int2(clamp_peak(mu[2 * (b * joints + k)], size, reach),
                        clamp_peak(mu[2 * (b * joints + k) + 1], size, reach));
    max_bits[k] = 0u;  // the bits of +0.0f; every gf is >= 0
  }
  const float* table_g = reach >= 0 && reach <= kMaxTableReach ? gauss : nullptr;
  if (table_g != nullptr)
    for (int d2 = tid; d2 <= 2 * reach * reach; d2 += blockDim.x)
      gauss[d2] = gaussian_of(d2, two_sigma_sq);
  __syncthreads();

  if (kKind != kInverse) {
    for (int p = tid; p < count; p += blockDim.x) {
      const int x = (p0 + p) % size, y = (p0 + p) / size;
      float total = 0.0f;
      for (int k = 0; k < joints; ++k) {
        const int2 m = peak[k];
        total = __fadd_rn(total, gaussian_at(x, y, m.x, m.y, two_sigma_sq, reach, table_g));
      }
      table[p] = total;
    }
  }
  __syncthreads();  // the table is complete

  // the thread's joint, its first pixel of the block's range and the stride
  const int k = tid % joints;
  const int first = tid / joints;
  const int step = blockDim.x / joints;
  const int2 pk = peak[k];
  const int step_x = step % size, step_y = step / size;

  auto ground_false = [&](int p, float g) {
    float gf;
    if (kKind == kUnionMinus)
      gf = clip01(__fsub_rn(clip01(table[p]), __fmul_rn(g, 10.0f)));
    else if (kKind == kInverse)
      gf = clip01(__fsub_rn(1.0f, __fmul_rn(g, 10.0f)));
    else
      gf = clip01(__fsub_rn(table[p], g));
    if (kFused) {
      // the block's threads read its run of the target once, coalesced
      const float t = __ldg(fused + run0 + p * joints + k);
      gf = clip01(__fsub_rn(__fadd_rn(gf, t), __fmul_rn(g, 100.0f)));
    }
    return gf;
  };

  float m = 0.0f;
  int x = (p0 + first) % size, y = (p0 + first) / size;
#pragma unroll 4
  for (int p = first; p < count; p += step) {
    const float g = gaussian_at(x, y, pk.x, pk.y, two_sigma_sq, reach, table_g);
    const float gf = ground_false(p, g);
    const size_t at = run0 + p * joints + k;
    if (gt_out != nullptr) gt_out[at] = g;
    if (!kNormalize)
      gf_out[at] = gf;
    else if (staged)
      stage[p * joints + k] = gf;
    m = fmaxf(m, gf);
    x += step_x;
    y += step_y;
    if (x >= size) {
      x -= size;
      ++y;
    }
  }
  if (!kNormalize) return;  // no exchange, no cluster

  atomicMax(&max_bits[k], __float_as_uint(m));
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's maxima are final and visible
  unsigned int bits = 0u;
  for (int r = 0; r < kClusterBlocks; ++r)
    bits = max(bits, *cluster.map_shared_rank(&max_bits[k], r));
  cluster.sync();  // no block leaves while another still reads its maxima
  // one correctly rounded reciprocal, then a product per element: within
  // 2 ulp of the plain version's division
  const float scale = __frcp_rn(fmaxf(__uint_as_float(bits), 1e-12f));

  x = (p0 + first) % size;
  y = (p0 + first) / size;
#pragma unroll 4
  for (int p = first; p < count; p += step) {
    const float gf = staged ? stage[p * joints + k]
                            : ground_false(p, gaussian_at(x, y, pk.x, pk.y, two_sigma_sq,
                                                          reach, table_g));
    gf_out[run0 + p * joints + k] = __fmul_rn(gf, scale);
    x += step_x;
    y += step_y;
    if (x >= size) {
      x -= size;
      ++y;
    }
  }
}

using LabelKernel = void (*)(const int32_t*, const float*, float*, float*, int, int, float,
                             int, int);

LabelKernel kernel_for(int gf_kind, bool fused, bool normalize) {
#define DAHPE_LABELS(kind)                                                        \
  {{pseudo_labels_kernel<kind, false, false>, pseudo_labels_kernel<kind, false, true>}, \
   {pseudo_labels_kernel<kind, true, false>, pseudo_labels_kernel<kind, true, true>}}
  static const LabelKernel kernels[3][2][2] = {DAHPE_LABELS(0), DAHPE_LABELS(1), DAHPE_LABELS(2)};
#undef DAHPE_LABELS
  return kernels[gf_kind][fused][normalize];
}

}  // namespace

// C interface, bound with ctypes. mu: (B, K, 2) int32; fused: (B, S, S, K)
// float32 or null; gt: (B, S, S, K) float32 or null (GF only); gf:
// (B, S, S, K) float32; all contiguous on the current device; stream is a
// cudaStream_t. gf_kind: 0 union_minus, 1 inverse, 2 union_others. staged
// and shared_bytes come from ops/pseudo_label.py:launch_geometry, which also
// guarantees 1 <= K <= 64 and S*S <= 8192. Returns the launch's cudaError_t
// (0 on success).
extern "C" int pseudo_labels_f32(const void* mu, const void* fused, void* gt,
                                 void* gf, int batch, int size, int joints,
                                 float two_sigma_sq, int reach, int gf_kind,
                                 int normalize, int staged, int shared_bytes,
                                 void* stream) {
  if (gf_kind < 0 || gf_kind > 2) return (int)cudaErrorInvalidValue;
  const LabelKernel kernel = kernel_for(gf_kind, fused != nullptr, normalize != 0);
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (kThreads / joints) * joints;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kClusterBlocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterBlocks, batch);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = cluster;
  config.numAttrs = normalize ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, (const int32_t*)mu, (const float*)fused, (float*)gt,
      (float*)gf, size, joints, two_sigma_sq, reach, staged);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
