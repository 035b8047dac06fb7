// Paeth rotation of uint8 canvases for Hopper (sm_90a).
//
// Replaces the TPU kernel dahpe_tpu/ops/pallas/shear.py:rotate3_fused_pallas
// (body _rotate3_fused_kernel, with _to_fixed and _shear_block), and folds in
// what the JAX package does around it in data/device_aug.py:_rotate_shears:
// the HWC -> CHW transpose and the quarter-turn rot90. Per image b of a
// (B, S, S, C) uint8 batch, with slopes a[b], b[b] and quarter-turn q[b]:
//
//   P0 = the 8.8 fixed-point canvas (value * 256) zero-padded by `pad` on
//        each side, n = S + 2 pad
//   P1 = rot90(P0, q)                     (numpy's rot90 over (rows, cols))
//   S1 = ShX(a) P1,  S2 = ShY(b) S1,  S3 = ShX(a) S2
//   out[b, c, y, x] = S3[c, y + pad, x + pad] / 256     (B, C, S, S) float32
//
// A shear of line l (a row for ShX, a column for ShY) with slope t shifts it
// by d = clip(floor(s), -kmax, kmax), s = t * (l - (n-1)/2), and blends two
// neighbours with w = rint((s - floor s) * 256):
//   out[i] = (in[i+d] * (256 - w) + in[i+d+1] * w + 128) >> 8
// where a neighbour outside the canvas is 0 (data/device_aug.py:_shear_x).
//
// What bounds it: bytes. The input is read once (B=32, S=288: 8.0 MB of
// uint8) and the output written once (31.9 MB of float32): ~12 us at
// 3.35 TB/s. The arithmetic (7 blends a channel, 7 shear lines a pixel) is
// ~6 us even counted at the float32 rate (chip_smoke.py:rotation_bound_ms).
//
// Design. The TPU kernel stages the whole padded canvas and its two
// intermediates in VMEM and shears them with masked static shifts; a Hopper
// SM has no room for a 412^2 x 3 canvas per image and no need for the
// shifts. So one thread computes one output pixel (all C channels) straight
// from the source: the output needs 2 taps of S2, which need 4 of S1, which
// need 8 of P1; the thread computes the 7 lines' shifts and weights, maps
// the 8 P1 taps through rot90 and the padding to source pixels, and replays
// the 7 blends for each channel with the same integer arithmetic. A tap
// outside the canvas (or a source pixel in the padding) is 0, and a blend of
// two zeros is 0, so an out-of-canvas S1 or S2 tap needs no special case.
// Neighbouring threads read neighbouring source pixels, which the L1 cache
// serves; the stores are coalesced along x. Nothing is staged.
//
// What holds it back: on the H100 it runs at ~6.6x its byte bound (PERF.md;
// 64 registers). The per-line shift and weight are recomputed by every
// thread that needs them (7 per pixel) instead of once per line, and the
// 8 taps are byte loads of a channel each. A per-block table of the lines
// and 4-byte loads of whole pixels are the next steps.
//
// Exactness: s, floor and the weight are float32 as in the JAX package, and
// the product a * (l - c) is __fmul_rn, so nvcc cannot contract it with the
// subtraction after it into an FMA; rintf rounds half to even like
// jnp.round / torch.round. The result is bit-identical to
// ops/shear.py:rotate3_fused_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Shear {
  int d;  // integer shift, in [-kmax, kmax]
  int w;  // blend weight of the second neighbour, in [0, 256]
};

__device__ __forceinline__ Shear line_shear(float slope, int line, float center,
                                            int kmax) {
  const float s = __fmul_rn(slope, __fsub_rn((float)line, center));
  const float k = floorf(s);
  const int kk = min(max((int)k + kmax, 0), 2 * kmax);
  const int w = (int)rintf(__fmul_rn(__fsub_rn(s, k), 256.0f));
  return {kk - kmax, w};
}

__device__ __forceinline__ int blend(int lo, int hi, int w) {
  return (lo * (256 - w) + hi * w + 128) >> 8;
}

// source pixel index (y * size + x) of P1[i][j], or -1 for a zero tap
__device__ __forceinline__ int source_pixel(int i, int j, int n, int q, int pad,
                                            int size) {
  if (i < 0 || i >= n || j < 0 || j >= n) return -1;
  int y, x;  // P0 coordinates
  switch (q) {
    case 0: y = i; x = j; break;
    case 1: y = j; x = n - 1 - i; break;
    case 2: y = n - 1 - i; x = n - 1 - j; break;
    default: y = n - 1 - j; x = i; break;
  }
  y -= pad;
  x -= pad;
  if (y < 0 || y >= size || x < 0 || x >= size) return -1;
  return y * size + x;
}

__global__ void rotate3_fused_kernel(const uint8_t* __restrict__ image,
                                     const float* __restrict__ slope_a,
                                     const float* __restrict__ slope_b,
                                     const int32_t* __restrict__ quarter,
                                     float* __restrict__ out, int size,
                                     int channels, int pad, int kmax_a,
                                     int kmax_b) {
  const int xo = blockIdx.x * kBlockX + threadIdx.x;
  const int yo = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (xo >= size || yo >= size) return;

  const int n = size + 2 * pad;
  const float center = 0.5f * (float)(n - 1);  // exact: n - 1 < 2^24
  const float a = slope_a[b], bs = slope_b[b];
  const int q = quarter[b] & 3;
  const int row = yo + pad, col = xo + pad;

  int tap[8];       // source pixel of P1 tap (t, u, v) at 4t + 2u + v, or -1
  int w1[4], w2[2];  // blend weights of the S1 taps (t, u) and S2 taps t
  const Shear l3 = line_shear(a, row, center, kmax_a);
  for (int t = 0; t < 2; ++t) {
    const int c2 = col + l3.d + t;  // S2 tap column
    const bool in2 = c2 >= 0 && c2 < n;
    const Shear l2 = line_shear(bs, c2, center, kmax_b);
    w2[t] = l2.w;
    for (int u = 0; u < 2; ++u) {
      const int r1 = row + l2.d + u;  // S1 tap row
      const bool in1 = in2 && r1 >= 0 && r1 < n;
      const Shear l1 = line_shear(a, r1, center, kmax_a);
      w1[2 * t + u] = l1.w;
      for (int v = 0; v < 2; ++v)
        tap[4 * t + 2 * u + v] =
            in1 ? source_pixel(r1, c2 + l1.d + v, n, q, pad, size) : -1;
    }
  }

  const uint8_t* src = image + (size_t)b * size * size * channels;
  float* dst = out + (size_t)b * channels * size * size + (size_t)yo * size + xo;
  for (int c = 0; c < channels; ++c) {
    int p[8];
    for (int i = 0; i < 8; ++i)
      p[i] = tap[i] < 0 ? 0 : 256 * (int)__ldg(src + (size_t)tap[i] * channels + c);
    int s1[4];
    for (int i = 0; i < 4; ++i) s1[i] = blend(p[2 * i], p[2 * i + 1], w1[i]);
    const int s2a = blend(s1[0], s1[1], w2[0]);
    const int s2b = blend(s1[2], s1[3], w2[1]);
    const int s3 = blend(s2a, s2b, l3.w);
    dst[(size_t)c * size * size] = __fmul_rn((float)s3, 1.0f / 256.0f);
  }
}

}  // namespace

// C interface, bound with ctypes. image: (B, S, S, C) uint8; slope_a, slope_b:
// (B,) float32; quarter: (B,) int32 in [0, 4); out: (B, C, S, S) float32; all
// contiguous on the current device; stream is a cudaStream_t. pad, kmax_a and
// kmax_b are data/device_aug.py's rotation margins for S. Returns the
// launch's cudaError_t (0 on success).
extern "C" int rotate3_fused_u8(const void* image, const void* slope_a,
                                const void* slope_b, const void* quarter,
                                void* out, int batch, int size, int channels,
                                int pad, int kmax_a, int kmax_b, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((size + kBlockX - 1) / kBlockX, (size + kBlockY - 1) / kBlockY,
                  batch);
  rotate3_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)image, (const float*)slope_a, (const float*)slope_b,
      (const int32_t*)quarter, (float*)out, size, channels, pad, kmax_a, kmax_b);
  return (int)cudaGetLastError();
}
