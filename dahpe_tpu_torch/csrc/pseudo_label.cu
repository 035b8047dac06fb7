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
// Any map size and any joint count: pseudo_labels_wide_kernel. The 8-block
// kernel above takes S^2 <= 8192 and K <= 64 (its sum table holds the whole
// range of ceil(S^2 / 8) pixels beside static arrays of 64 peaks and
// maxima, one joint a thread; every build of the training path is such a
// map), and it stays as it was for them, because the general kernel, with
// the same loops, runs the path's builds slower (its chunked peaks, tiled
// table and 64-bit pixel indices). chip_smoke.py phase 2 times both on the
// path's three builds, B = 32, K = 21, writing GF alone (NVIDIA H100 80GB
// HBM3, 700.00 W): 64^2 0.0224 ms against the general kernel's 0.0300,
// 32^2 0.0090 against 0.0139, 16^2 0.0035 against 0.0040. The two should
// become one kernel once the general one matches there. The general kernel
// takes every other map:
//   - Joints in groups. K > 64 splits into ceil(K / 64) groups of at most 64
//     joints, the grid's third dimension: a block owns its range of pixels
//     for one group, keeps one joint a thread and the group's maxima in its
//     64-entry array, and writes runs of its group's joints inside each
//     pixel's K. Chosen over one thread owning several joints: the joint of
//     a thread stays fixed, so the max stays in a register and the shared
//     atomicMax stays one per thread, and K = 600 (more joints than a block
//     has threads) is ten groups of 60. The union sum still runs over all K
//     peaks, in chunks of 256 staged in shared memory, in the order k = 0 ..
//     K-1, so it equals the 8-block kernel's; every group's block sums them
//     again (K adds a pixel, beside the K elements it writes).
//   - A table of bounded size. The sum table holds at most 8192 pixels (32
//     KB); a block whose range is longer walks it in tiles, filling the
//     table for a tile, then writing that tile's elements.
//   - The same 8-block clusters at every size. GF is staged where it fits
//     beside the table in the 227 KB of a block: at K = 21, 96^2 stages 101
//     KB a block (two blocks an SM) and 128^2 180 KB (one); beyond, as at
//     256^2, the block recomputes GF in a second pass, reading the fused
//     target again.
// Both launch on grid (8, B, groups), B in launches of at most 65535;
// ops/pseudo_label.py:launch_geometry is the one place that picks the
// kernel, groups, threads, tile and staging.
//
// Measured, the 8-block kernel (chip_smoke.py phase 2, run in turns with
// the previous design's own chip_smoke.py on one card, NVIDIA H100 80GB
// HBM3, 700.00 W), the path's builds writing GF alone: 64^2 with a fused
// target 0.0224 ms against the previous design's 0.1207 (which always wrote
// GT too) and a 0.0066 ms byte bound (3.4x; with GT 0.0238 ms, bound
// 0.0099); 32^2 0.0090 ms (0.0300 before, bound 0.0016); 16^2 0.0034 ms
// (0.0056, bound 0.0002), a launch and little else. What holds it: not
// bytes (writing GT beside GF costs 0.0014 ms for 11 MB) but each thread's
// chain of ~21 elements a pass, with 2 blocks of 504 threads an SM.
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

constexpr int kGroupJoints = 64;  // joints a block keeps at most (a group)
constexpr int kPeakChunk = 256;   // peaks of the union sum staged at a time
constexpr int kClusterBlocks = 8;  // blocks of a cluster (one batch element, one group)
constexpr int kThreads = 512;

constexpr int kMaxTableReach = 12;  // windows whose Gaussians the block tabulates
// the kernels' static shared arrays (peak, max_bits, gauss) and padding
constexpr int kStaticBytes =
    kPeakChunk * 8 + kGroupJoints * 4 + (2 * kMaxTableReach * kMaxTableReach + 1) * 4 + 64;
constexpr int kSmallStaticBytes =
    kGroupJoints * 8 + kGroupJoints * 4 + (2 * kMaxTableReach * kMaxTableReach + 1) * 4 + 64;

enum GfKind { kUnionMinus = 0, kInverse = 1, kUnionOthers = 2 };

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

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

__device__ __forceinline__ int2 peak_of(const int32_t* mu, size_t at, int size, int reach) {
  return make_int2(clamp_peak(mu[2 * at], size, reach), clamp_peak(mu[2 * at + 1], size, reach));
}

// The earlier design, kept as it was for the maps it took (S^2 <= 8192, K <=
// 64: every build of the path): one joint a thread, 8 blocks a batch
// element. Dynamic shared memory: the sum table (ceil(S^2 / 8) floats,
// padded to a multiple of 4) and, when staged, the block's run of
// ceil(S^2 / 8) * K floats of unnormalised GF.
// Launched as one cluster of kClusterBlocks blocks per batch element when
// normalizing (the blocks exchange their maxima), as plain blocks otherwise;
// block blockIdx.x of the row owns the blockIdx.x-th range of pixels. One
// instance per GF kind, fused target or none, normalisation or none.
template <int kKind, bool kFused, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
pseudo_labels_kernel(const int32_t* __restrict__ mu, const float* __restrict__ fused,
                     float* __restrict__ gt_out, float* __restrict__ gf_out, int size,
                     int joints, float two_sigma_sq, int reach, int staged) {
  __shared__ int2 peak[kGroupJoints];
  __shared__ unsigned int max_bits[kGroupJoints];
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

// Grid (8, B, groups): block rank = blockIdx.x of batch element b =
// blockIdx.y owns the rank-th range of chunk = ceil(S^2 / 8) pixels
// for joint group blockIdx.z (joints [k0, k0 + kj): base = K / groups each,
// the first K % groups groups one more). Launched as one cluster of
// kClusterBlocks blocks per (element, group) when normalizing (the blocks
// exchange their maxima), as plain blocks otherwise. Dynamic shared memory:
// the sum table (`tile` floats, padded to a multiple of 4) and, when staged,
// the block's ceil(S^2 / 8) * kj floats of unnormalised GF. One
// instance per fused target or none, normalisation or none; the GF kind is
// an argument (a uniform branch), which keeps the file's build time near
// the 8-block kernel's alone.
template <bool kFused, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
pseudo_labels_wide_kernel(int kind, const int32_t* __restrict__ mu,
                          const float* __restrict__ fused, float* __restrict__ gt_out,
                          float* __restrict__ gf_out, int size, int joints,
                          float two_sigma_sq, int reach, int chunk, int base, int tile,
                          int staged) {
  __shared__ int2 peak[kPeakChunk];
  __shared__ unsigned int max_bits[kGroupJoints];
  __shared__ float gauss[2 * kMaxTableReach * kMaxTableReach + 1];
  extern __shared__ __align__(16) float dyn[];

  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  // group blockIdx.z of G: joints [k0, k0 + kj), the first K - G base
  // groups one longer than base
  const int group = blockIdx.z, longer = joints - base * (int)gridDim.z;
  const int k0 = group * base + min(group, longer);
  const int kj = base + (group < longer ? 1 : 0);
  const int tid = threadIdx.x;
  const int64_t pixels = (int64_t)size * size;
  const bool narrow = pixels <= INT32_MAX;  // pixel indices fit 32 bits (S <= 46340)
  const int64_t p0 = min((int64_t)rank * chunk, pixels);
  const int count = (int)min((int64_t)chunk, pixels - p0);  // this block's pixels
  const size_t run0 = ((size_t)b * pixels + p0) * joints + k0;  // element (p0, k0)
  float* table = dyn;
  float* stage = dyn + ((tile + 3) & ~3);
  const bool one_chunk = joints <= kPeakChunk;

  // (x, y) of pixel p0 + p of the map
  auto locate = [&](int p, int& x, int& y) {
    if (narrow) {
      const int q = (int)p0 + p;
      x = q % size;
      y = q / size;
    } else {
      const int64_t q = p0 + p;
      x = (int)(q % size);
      y = (int)(q / size);
    }
  };

  for (int k = tid; k < kj; k += blockDim.x) max_bits[k] = 0u;  // +0.0f; every gf >= 0
  if (one_chunk)
    for (int k = tid; k < joints; k += blockDim.x)
      peak[k] = peak_of(mu, (size_t)b * joints + k, size, reach);
  const float* table_g = reach >= 0 && reach <= kMaxTableReach ? gauss : nullptr;
  if (table_g != nullptr)
    for (int d2 = tid; d2 <= 2 * reach * reach; d2 += blockDim.x)
      gauss[d2] = gaussian_of(d2, two_sigma_sq);

  // the thread's joint of the group, its first pixel of the range and the
  // stride; the threads past step * kj idle in the loops
  const int step = blockDim.x / kj;
  const bool active = tid < step * kj;
  const int kl = tid % kj;
  const int first = active ? tid / kj : count;
  const int step_x = step % size, step_y = step / size;
  const size_t e_step = (size_t)step * joints;  // elements between a thread's pixels
  // the thread's own peak: from the staged peaks, else read while they stage
  int2 pk = one_chunk ? make_int2(0, 0) : peak_of(mu, (size_t)b * joints + k0 + kl, size, reach);
  __syncthreads();
  if (one_chunk) pk = peak[k0 + kl];

  // The union sums of pixels [t0, t0 + n) of the range into table[0, n),
  // over the K peaks in chunks of kPeakChunk (k = 0 .. K-1 in order).
  // Every thread calls it; the caller syncs before (the table is free) and
  // after (the table is complete).
  auto fill_table = [&](int t0, int n) {
    for (int c0 = 0; c0 < joints; c0 += kPeakChunk) {
      const int cn = min(kPeakChunk, joints - c0);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk's peaks are read
        for (int k = tid; k < cn; k += blockDim.x)
          peak[k] = peak_of(mu, (size_t)b * joints + c0 + k, size, reach);
        __syncthreads();
      }
      for (int p = tid; p < n; p += blockDim.x) {
        int x, y;
        locate(t0 + p, x, y);
        float total = c0 == 0 ? 0.0f : table[p];
        for (int k = 0; k < cn; ++k) {
          const int2 m = peak[k];
          total = __fadd_rn(total, gaussian_at(x, y, m.x, m.y, two_sigma_sq, reach, table_g));
        }
        table[p] = total;
      }
    }
  };

  // GF from the Gaussian g, the pixel's union sum at table[tp] and the
  // element e of the fused target
  auto ground_false = [&](int tp, size_t e, float g) {
    float gf;
    if (kind == kUnionMinus)
      gf = clip01(__fsub_rn(clip01(table[tp]), __fmul_rn(g, 10.0f)));
    else if (kind == kInverse)
      gf = clip01(__fsub_rn(1.0f, __fmul_rn(g, 10.0f)));
    else
      gf = clip01(__fsub_rn(table[tp], g));
    if (kFused) {
      // the block's threads read its run of the target once, coalesced
      const float t = __ldg(fused + e);
      gf = clip01(__fsub_rn(__fadd_rn(gf, t), __fmul_rn(g, 100.0f)));
    }
    return gf;
  };

  float m = 0.0f;
  int p = first, x, y;
  locate(p, x, y);
  size_t e = run0 + (size_t)p * joints + kl;  // the element of (p, kl)
  for (int t0 = 0; t0 < count; t0 += tile) {
    const int n = min(tile, count - t0);
    if (kind != kInverse) {
      if (t0 > 0) __syncthreads();  // the previous tile's sums are read
      fill_table(t0, n);
      __syncthreads();
    }
#pragma unroll 4
    for (; p < t0 + n; p += step, e += e_step) {
      const float g = gaussian_at(x, y, pk.x, pk.y, two_sigma_sq, reach, table_g);
      const float gf = ground_false(p - t0, e, g);
      if (gt_out != nullptr) gt_out[e] = g;
      if (!kNormalize)
        gf_out[e] = gf;
      else if (staged)
        stage[p * kj + kl] = gf;
      m = fmaxf(m, gf);
      x += step_x;
      y += step_y;
      if (x >= size) {
        x -= size;
        ++y;
      }
    }
  }
  if (!kNormalize) return;  // no exchange, no cluster

  if (active) atomicMax(&max_bits[kl], __float_as_uint(m));
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's maxima are final and visible
  unsigned int bits = 0u;
  if (active)
    for (int r = 0; r < kClusterBlocks; ++r)
      bits = max(bits, *cluster.map_shared_rank(&max_bits[kl], r));
  cluster.sync();  // no block leaves while another still reads its maxima
  // one correctly rounded reciprocal, then a product per element: within
  // 2 ulp of the plain version's division
  const float scale = __frcp_rn(fmaxf(__uint_as_float(bits), 1e-12f));

  p = first;
  locate(p, x, y);
  e = run0 + (size_t)p * joints + kl;
  for (int t0 = 0; t0 < count; t0 += tile) {
    const int n = min(tile, count - t0);
    // a range of one tile still has its sums in the table
    if (!staged && kind != kInverse && count > tile) {
      __syncthreads();
      fill_table(t0, n);
      __syncthreads();
    }
#pragma unroll 4
    for (; p < t0 + n; p += step, e += e_step) {
      const float gf = staged ? stage[p * kj + kl]
                              : ground_false(p - t0, e, gaussian_at(x, y, pk.x, pk.y,
                                                                    two_sigma_sq, reach, table_g));
      gf_out[e] = __fmul_rn(gf, scale);
      x += step_x;
      y += step_y;
      if (x >= size) {
        x -= size;
        ++y;
      }
    }
  }
}

using LabelKernel = void (*)(const int32_t*, const float*, float*, float*, int, int, float,
                             int, int);
using WideKernel = void (*)(int, const int32_t*, const float*, float*, float*, int, int, float,
                            int, int, int, int, int);

// The instances for a GF kind, a fused target or none, normalisation or none.
LabelKernel small_for(int gf_kind, bool fused, bool normalize) {
#define DAHPE_LABELS(kind)                                                        \
  {{pseudo_labels_kernel<kind, false, false>, pseudo_labels_kernel<kind, false, true>}, \
   {pseudo_labels_kernel<kind, true, false>, pseudo_labels_kernel<kind, true, true>}}
  static const LabelKernel kernels[3][2][2] = {DAHPE_LABELS(0), DAHPE_LABELS(1), DAHPE_LABELS(2)};
#undef DAHPE_LABELS
  return kernels[gf_kind][fused][normalize];
}

WideKernel wide_for(bool fused, bool normalize) {
  static const WideKernel kernels[2][2] = {
      {pseudo_labels_wide_kernel<false, false>, pseudo_labels_wide_kernel<false, true>},
      {pseudo_labels_wide_kernel<true, false>, pseudo_labels_wide_kernel<true, true>}};
  return kernels[fused][normalize];
}

// Lets `kernel` take `shared_bytes` of dynamic shared memory beside its
// static arrays (which count toward the 48 KB a block takes without the
// opt-in). A refused call stays the runtime's last error, so it is taken
// off, or the next launch's check would report it again.
template <class Kernel>
cudaError_t allow(Kernel kernel, int shared_bytes, int static_bytes) {
  if (shared_bytes + static_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes) !=
          cudaSuccess)
    return cudaGetLastError();
  return cudaSuccess;
}

}  // namespace

// C interface, bound with ctypes. mu: (B, K, 2) int32; fused: (B, S, S, K)
// float32 or null; gt: (B, S, S, K) float32 or null (GF only); gf:
// (B, S, S, K) float32; all contiguous on the current device; stream is a
// cudaStream_t. gf_kind: 0 union_minus, 1 inverse, 2 union_others. wide
// (the general kernel, else the 8-block one), groups (of joints), threads
// (a multiple of the largest group's joints, <= 512), tile, staged and
// shared_bytes come from
// ops/pseudo_label.py:launch_geometry. Returns the launch's cudaError_t (0
// on success).
extern "C" int pseudo_labels_f32(const void* mu, const void* fused, void* gt,
                                 void* gf, int batch, int size, int joints,
                                 float two_sigma_sq, int reach, int gf_kind,
                                 int normalize, int wide, int groups, int threads, int tile,
                                 int staged, int shared_bytes, void* stream) {
  if (gf_kind < 0 || gf_kind > 2 || threads < 1 || threads > kThreads ||
      (wide ? groups < 1 || groups > 65535 || tile < 1 ||
                  (joints + groups - 1) / groups > kGroupJoints
            : groups != 1 || joints > kGroupJoints || (int64_t)size * size > 8192))
    return (int)cudaErrorInvalidValue;
  const bool with_fused = fused != nullptr, norm = normalize != 0;
  const LabelKernel small = small_for(gf_kind, with_fused, norm);
  const WideKernel general = wide_for(with_fused, norm);
  cudaError_t err = wide ? allow(general, shared_bytes, kStaticBytes)
                         : allow(small, shared_bytes, kSmallStaticBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t pixels = (int64_t)size * size;
  const int chunk = (int)((pixels + kClusterBlocks - 1) / kClusterBlocks);
  const size_t elements = (size_t)pixels * joints;  // of one batch element
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kClusterBlocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = cluster;
  config.numAttrs = normalize ? 1 : 0;
  // the grid's second dimension takes at most 65535 batch elements a launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = min(batch - b0, 65535);
    config.gridDim = dim3(kClusterBlocks, nb, wide ? groups : 1);
    const size_t off = (size_t)b0 * elements;
    const int32_t* m = (const int32_t*)mu + (size_t)b0 * joints * 2;
    const float* f = with_fused ? (const float*)fused + off : nullptr;
    float* t = gt == nullptr ? nullptr : (float*)gt + off;
    float* g = (float*)gf + off;
    err = wide ? cudaLaunchKernelEx(&config, general, gf_kind, m, f, t, g, size, joints,
                                    two_sigma_sq, reach, chunk, joints / groups, tile, staged)
               : cudaLaunchKernelEx(&config, small, m, f, t, g, size, joints, two_sigma_sq,
                                    reach, staged);
    const cudaError_t last = cudaGetLastError();
    if (err != cudaSuccess || last != cudaSuccess) return (int)(err != cudaSuccess ? err : last);
  }
  return 0;
}
