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
//
// What bounds it: by bytes, writing gt and gf (2 x B*S*S*K floats; B=32, S=64,
// K=21: 22 MB, ~6.6 us at 3.35 TB/s) plus reading the fused target once
// (11 MB). The per-element work is small (an integer window test, at most one
// expf, a few clips), so on paper the op is byte-bound.
//
// Design. The max-normalize needs a reduction over the whole S x S map of a
// (b, k) before any gf can be written, and a 64 x 64 x 21 float tile (344 KB)
// does not fit in one SM's shared memory. So one block owns one batch element
// and makes two passes over its map: pass 1 takes the per-(b, k) max of the
// unnormalized gf, pass 2 recomputes gt and gf and writes both. Nothing of
// the map is staged: gt is recomputed from the K peaks, which sit in shared
// memory. The block has (1024 / K) * K threads, so a thread keeps one joint k
// for the whole block (its max stays in a register, one shared atomicMax per
// thread ends pass 1) while the warp's flat (pixel, k) indices stay
// consecutive and its stores coalesce. The union kinds need the sum over k of
// gt at each pixel; a first pass fills an S x S table of it in shared memory
// (16 KB at S = 64; the wrapper allows S <= 90), summed in order k = 0 .. K-1
// as the TPU kernel writes it.
//
// What holds it back: on the H100 the 64^2 fused build runs at ~12x its byte
// bound (PERF.md). One block per batch element puts 32 blocks on the
// 132 SMs at B = 32, and the fused target is read twice (the second read
// mostly from L2). Splitting a batch element's joints over several blocks,
// each recomputing the sum table, is the next step.
//
// Exactness: gt uses render_gaussian.cu's arithmetic (integer d2, IEEE
// division, expf) and is bit-identical to the plain version. Products that
// feed a sum use __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// them into an FMA the plain version does not do. The union sum is taken in
// another order than torch.sum, so gf agrees to ~1 ulp of the sum, inside the
// JAX suite's atol (1e-6, 1e-5 with a fused target).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 64;
constexpr int kMaxTable = 8192;  // 32 KB of float: S*S for S <= 90

enum GfKind { kUnionMinus = 0, kInverse = 1, kUnionOthers = 2 };

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float gaussian_at(int x, int y, int mx, int my,
                                             float two_sigma_sq, int reach) {
  const int64_t dx = (int64_t)x - mx;
  const int64_t dy = (int64_t)y - my;
  if (dx < -reach || dx > reach || dy < -reach || dy > reach) return 0.0f;
  const int d2 = (int)(dx * dx + dy * dy);
  return expf(-(float)d2 / two_sigma_sq);
}

// up to 1024 threads a block: __launch_bounds__ keeps ptxas at <= 64 registers
__global__ void __launch_bounds__(1024) pseudo_labels_kernel(const int32_t* __restrict__ mu,
                                     const float* __restrict__ fused,
                                     float* __restrict__ gt_out,
                                     float* __restrict__ gf_out, int size,
                                     int joints, float two_sigma_sq, int reach,
                                     int gf_kind, int normalize) {
  __shared__ int peak_x[kMaxJoints];
  __shared__ int peak_y[kMaxJoints];
  __shared__ unsigned int max_bits[kMaxJoints];
  __shared__ float table[kMaxTable];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int pixels = size * size;
  for (int k = tid; k < joints; k += blockDim.x) {
    peak_x[k] = mu[2 * (b * joints + k)];
    peak_y[k] = mu[2 * (b * joints + k) + 1];
    max_bits[k] = 0u;  // the bits of +0.0f; every gf is >= 0
  }
  __syncthreads();

  const bool union_kind = gf_kind != kInverse;
  if (union_kind) {
    for (int p = tid; p < pixels; p += blockDim.x) {
      const int x = p % size, y = p / size;
      float total = 0.0f;
      for (int k = 0; k < joints; ++k)
        total = __fadd_rn(total, gaussian_at(x, y, peak_x[k], peak_y[k],
                                             two_sigma_sq, reach));
      table[p] = total;
    }
    __syncthreads();
  }

  // the thread's joint, and its first pixel and pixel stride
  const int k = tid % joints;
  const int p0 = tid / joints;
  const int stride = blockDim.x / joints;
  const int mx = peak_x[k], my = peak_y[k];
  const size_t base = (size_t)b * pixels * joints + k;

  auto ground_false = [&](int p, float g) {
    float gf;
    if (gf_kind == kUnionMinus)
      gf = clip01(__fsub_rn(clip01(table[p]), __fmul_rn(g, 10.0f)));
    else if (gf_kind == kInverse)
      gf = clip01(__fsub_rn(1.0f, __fmul_rn(g, 10.0f)));
    else
      gf = clip01(__fsub_rn(table[p], g));
    if (fused != nullptr)
      gf = clip01(__fsub_rn(__fadd_rn(gf, fused[base + (size_t)p * joints]),
                            __fmul_rn(g, 100.0f)));
    return gf;
  };

  float denom = 1.0f;
  if (normalize) {
    float m = 0.0f;
    for (int p = p0; p < pixels; p += stride) {
      const float g = gaussian_at(p % size, p / size, mx, my, two_sigma_sq, reach);
      m = fmaxf(m, ground_false(p, g));
    }
    atomicMax(&max_bits[k], __float_as_uint(m));
    __syncthreads();
    denom = fmaxf(__uint_as_float(max_bits[k]), 1e-12f);
  }

  for (int p = p0; p < pixels; p += stride) {
    const float g = gaussian_at(p % size, p / size, mx, my, two_sigma_sq, reach);
    float gf = ground_false(p, g);
    if (normalize) gf = __fdiv_rn(gf, denom);
    gt_out[base + (size_t)p * joints] = g;
    gf_out[base + (size_t)p * joints] = gf;
  }
}

}  // namespace

// C interface, bound with ctypes. mu: (B, K, 2) int32; fused: (B, S, S, K)
// float32 or null; gt, gf: (B, S, S, K) float32; all contiguous on the current
// device; stream is a cudaStream_t. gf_kind: 0 union_minus, 1 inverse,
// 2 union_others. The caller (ops/pseudo_label.py) guarantees 1 <= K <= 64 and
// S*S <= 8192. Returns the launch's cudaError_t (0 on success).
extern "C" int pseudo_labels_f32(const void* mu, const void* fused, void* gt,
                                 void* gf, int batch, int size, int joints,
                                 float two_sigma_sq, int reach, int gf_kind,
                                 int normalize, void* stream) {
  const int threads = (1024 / joints) * joints;
  pseudo_labels_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mu, (const float*)fused, (float*)gt, (float*)gf, size,
      joints, two_sigma_sq, reach, gf_kind, normalize);
  return (int)cudaGetLastError();
}
