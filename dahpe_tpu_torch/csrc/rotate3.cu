// Paeth rotation and bilinear shears of 8.8 fixed-point canvases for Hopper
// (sm_90a): three kernels that share one walk and one rounding.
//
// Replaces the three TPU kernels of dahpe_tpu/ops/pallas/shear.py:
//
//   rotate3_fused_pallas (:164)  uint8 or float32 (S, S, C) crops in [0, 255]
//       -> to_fixed -> zero pad -> rot90 -> ShX(a) ShY(b) ShX(a) -> centre
//       crop -> / 256, as (C, S, S) float32. The HWC -> CHW transpose and the
//       quarter-turn of data/device_aug.py:_rotate_shears are folded in.
//   rotate3_pallas (:215)        ShX(a) ShY(b) ShX(a) of a (C, H, W) uint16
//       canvas that is already fixed point and padded, H != W allowed.
//   shear_pallas (:92)           one shear of a (C, H, W) uint16 canvas: ShX
//       (axis 2, each row shifted along W) or ShY (axis 1, each column
//       shifted along H).
//
// A shear of line l (a row for ShX, a column for ShY) of a canvas with L such
// lines and slope t shifts it by d = clip(floor(s), -kmax, kmax),
// s = t * (l - (L-1)/2), and blends two neighbours with
// w = rint((s - floor s) * 256):
//   out[i] = (in[i+d] * (256 - w) + in[i+d+1] * w + 128) >> 8
// where a neighbour outside the canvas is 0 (data/device_aug.py:_shear_x).
// Values reach 65535, so the blend stays below 2^24 * 256 < 2^31 in int32.
//
// What bounds them: bytes. rotate3_fused reads 8.0 MB of uint8 (B=32, S=288)
// and writes 31.9 MB of float32, ~12 us at 3.35 TB/s; rotate3 and shear on
// the padded (32, 3, 412, 412) uint16 canvas read and write 32.6 MB each,
// ~19.5 us. The arithmetic is a few us at the float32 rate
// (chip_smoke.py:rotation_bound_ms, u16_bound_ms).
//
// Design. The TPU kernels stage a whole canvas (and the rotation's two
// intermediates) in VMEM and shear it with masked static shifts; a Hopper SM
// has no room for a 412^2 x 3 canvas per image and no need for the shifts.
// One thread computes one output pixel, all C channels, straight from the
// source: ShX's output needs 2 taps of its input, so the rotation's output
// needs 2 taps of S2, 4 of S1 and 8 of P. The thread computes the lines'
// shifts and weights once (walk3), maps the taps to source pixels (the
// canvas classes below: uint8 or float32 HWC through the padding and the
// quarter-turn, or a uint16 CHW canvas as it is), and replays the blends for
// each channel with the same integer arithmetic (replay3). A tap outside the
// canvas is 0, and a blend of two zeros is 0, so an out-of-canvas S1 or S2
// tap needs no special case. The stores write either the float crop or the
// whole uint16 canvas. Neighbouring threads read neighbouring source pixels,
// which the L1 cache serves; the stores are coalesced along x.
//
// What holds it back: the fused uint8 mode runs at ~6.6x its byte bound on
// the H100 (PERF.md; 64 registers). The per-line shift and weight are
// recomputed by every thread that needs them instead of once per line, and
// the taps are loads of one channel each. A per-block table of the lines and
// whole-pixel loads are the next steps.
//
// Exactness, shared by all three kernels through line_shear and blend: s,
// floor and the weight are float32 as in the JAX package, and the product
// t * (l - c) is __fmul_rn, so nvcc cannot contract it with the subtraction
// after it into an FMA; rintf rounds half to even like jnp.round /
// torch.round. The float input converts as clip(rint(x * 256), 0, 65535),
// jnp.round then jnp.clip. Each result is bit-identical to its plain version
// in ops/shear.py.

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

__device__ __forceinline__ int to_fixed(uint8_t v) { return 256 * (int)v; }

__device__ __forceinline__ int to_fixed(float v) {
  const float s = rintf(__fmul_rn(v, 256.0f));
  return (int)fminf(fmaxf(s, 0.0f), 65535.0f);
}

// ---- canvases: where pixel (i, j) of the canvas P lives and its 8.8 value.
// at(b) binds image b of the batch; locate gives a pixel index or -1 for a
// zero tap; load reads channel c of a located pixel.

// P = rot90(pad(to_fixed(image)), q) of an (S, S, C) HWC image in [0, 255],
// n = S + 2 pad on each side; q is the image's quarter-turn.
template <typename T>
struct HwcCanvas {
  const T* image;
  const int32_t* quarter;
  int size, channels, pad;
  int q;

  __device__ int rows() const { return size + 2 * pad; }
  __device__ int cols() const { return size + 2 * pad; }

  __device__ HwcCanvas at(int b) const {
    HwcCanvas c = *this;
    c.image = image + (size_t)b * size * size * channels;
    c.q = quarter[b] & 3;
    return c;
  }

  __device__ int locate(int i, int j) const {
    const int n = size + 2 * pad;
    if (i < 0 || i >= n || j < 0 || j >= n) return -1;
    int y, x;  // coordinates in the padded canvas before the quarter-turn
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

  __device__ int load(int pixel, int c) const {
    return to_fixed(__ldg(image + (size_t)pixel * channels + c));
  }
};

// P is a (C, H, W) uint16 canvas as it is.
struct ChwCanvas {
  const uint16_t* image;
  int height, width, channels;

  __device__ int rows() const { return height; }
  __device__ int cols() const { return width; }

  __device__ ChwCanvas at(int b) const {
    ChwCanvas c = *this;
    c.image = image + (size_t)b * channels * height * width;
    return c;
  }

  __device__ int locate(int i, int j) const {
    if (i < 0 || i >= height || j < 0 || j >= width) return -1;
    return i * width + j;
  }

  __device__ int load(int pixel, int c) const {
    return (int)__ldg(image + (size_t)c * height * width + pixel);
  }
};

// ---- stores: the output grid, its offset into the canvas, and the write.

// (B, C, S, S) float32: the canvas's centre S x S crop (offset pad) / 256.
struct CropStore {
  float* out;
  int size, channels, pad;

  __device__ int height() const { return size; }
  __device__ int width() const { return size; }
  __device__ int offset() const { return pad; }

  __device__ CropStore at(int b) const {
    CropStore s = *this;
    s.out = out + (size_t)b * channels * size * size;
    return s;
  }

  __device__ void store(int c, int y, int x, int v) const {
    out[(size_t)c * size * size + (size_t)y * size + x] =
        __fmul_rn((float)v, 1.0f / 256.0f);
  }
};

// (B, C, H, W) uint16: the whole canvas.
struct U16Store {
  uint16_t* out;
  int h, w, channels;

  __device__ int height() const { return h; }
  __device__ int width() const { return w; }
  __device__ int offset() const { return 0; }

  __device__ U16Store at(int b) const {
    U16Store s = *this;
    s.out = out + (size_t)b * channels * h * w;
    return s;
  }

  __device__ void store(int c, int y, int x, int v) const {
    out[(size_t)c * h * w + (size_t)y * w + x] = (uint16_t)v;
  }
};

// The 8 taps of P and the 7 blend weights behind pixel (row, col) of
// ShX(a) ShY(b) ShX(a) P: tap (t, u, v) at 4t + 2u + v.
struct Walk3 {
  int tap[8];
  int w1[4], w2[2], w3;
};

template <class Canvas>
__device__ __forceinline__ Walk3 walk3(const Canvas& p, int row, int col,
                                       float a, float b, int kmax_a,
                                       int kmax_b) {
  const int n_h = p.rows(), n_w = p.cols();
  // rows shear about the middle row, columns about the middle column; exact:
  // n - 1 < 2^24
  const float c_h = 0.5f * (float)(n_h - 1), c_w = 0.5f * (float)(n_w - 1);
  Walk3 k;
  const Shear l3 = line_shear(a, row, c_h, kmax_a);
  k.w3 = l3.w;
  for (int t = 0; t < 2; ++t) {
    const int c2 = col + l3.d + t;  // S2 tap column
    const bool in2 = c2 >= 0 && c2 < n_w;
    const Shear l2 = line_shear(b, c2, c_w, kmax_b);
    k.w2[t] = l2.w;
    for (int u = 0; u < 2; ++u) {
      const int r1 = row + l2.d + u;  // S1 tap row
      const bool in1 = in2 && r1 >= 0 && r1 < n_h;
      const Shear l1 = line_shear(a, r1, c_h, kmax_a);
      k.w1[2 * t + u] = l1.w;
      for (int v = 0; v < 2; ++v)
        k.tap[4 * t + 2 * u + v] = in1 ? p.locate(r1, c2 + l1.d + v) : -1;
    }
  }
  return k;
}

template <class Canvas>
__device__ __forceinline__ int replay3(const Canvas& p, const Walk3& k, int c) {
  int v[8];
  for (int i = 0; i < 8; ++i) v[i] = k.tap[i] < 0 ? 0 : p.load(k.tap[i], c);
  int s1[4];
  for (int i = 0; i < 4; ++i) s1[i] = blend(v[2 * i], v[2 * i + 1], k.w1[i]);
  const int s2a = blend(s1[0], s1[1], k.w2[0]);
  const int s2b = blend(s1[2], s1[3], k.w2[1]);
  return blend(s2a, s2b, k.w3);
}

template <class Canvas, class Store>
__global__ void rotate3_kernel(Canvas canvas, Store output,
                               const float* __restrict__ slope_a,
                               const float* __restrict__ slope_b, int channels,
                               int kmax_a, int kmax_b) {
  const int xo = blockIdx.x * kBlockX + threadIdx.x;
  const int yo = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (xo >= output.width() || yo >= output.height()) return;
  const Canvas p = canvas.at(b);
  const Store o = output.at(b);
  const Walk3 k = walk3(p, yo + o.offset(), xo + o.offset(), slope_a[b],
                        slope_b[b], kmax_a, kmax_b);
  for (int c = 0; c < channels; ++c) o.store(c, yo, xo, replay3(p, k, c));
}

// One shear: axis 2 shifts row yo along W, axis 1 shifts column xo along H.
template <class Canvas, class Store>
__global__ void shear1_kernel(Canvas canvas, Store output,
                              const float* __restrict__ slope, int channels,
                              int kmax, int axis) {
  const int xo = blockIdx.x * kBlockX + threadIdx.x;
  const int yo = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (xo >= output.width() || yo >= output.height()) return;
  const Canvas p = canvas.at(b);
  const Store o = output.at(b);
  int lo, hi;
  Shear l;
  if (axis == 2) {
    l = line_shear(slope[b], yo, 0.5f * (float)(p.rows() - 1), kmax);
    lo = p.locate(yo, xo + l.d);
    hi = p.locate(yo, xo + l.d + 1);
  } else {
    l = line_shear(slope[b], xo, 0.5f * (float)(p.cols() - 1), kmax);
    lo = p.locate(yo + l.d, xo);
    hi = p.locate(yo + l.d + 1, xo);
  }
  for (int c = 0; c < channels; ++c)
    o.store(c, yo, xo,
            blend(lo < 0 ? 0 : p.load(lo, c), hi < 0 ? 0 : p.load(hi, c), l.w));
}

dim3 grid_of(int height, int width, int batch) {
  return dim3((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY,
              batch);
}

template <typename T>
int launch_fused(const void* image, const void* slope_a, const void* slope_b,
                 const void* quarter, void* out, int batch, int size,
                 int channels, int pad, int kmax_a, int kmax_b, void* stream) {
  const HwcCanvas<T> canvas{(const T*)image, (const int32_t*)quarter, size,
                            channels, pad, 0};
  const CropStore store{(float*)out, size, channels, pad};
  rotate3_kernel<<<grid_of(size, size, batch), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(canvas, store, (const float*)slope_a,
                                           (const float*)slope_b, channels,
                                           kmax_a, kmax_b);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. All arrays are contiguous on the current
// device; stream is a cudaStream_t; each returns the launch's cudaError_t
// (0 on success).
//
// rotate3_fused_u8 / _f32 — image: (B, S, S, C) uint8 / float32 in [0, 255];
// slope_a, slope_b: (B,) float32; quarter: (B,) int32 in [0, 4); out:
// (B, C, S, S) float32. pad, kmax_a and kmax_b are data/device_aug.py's
// rotation margins for S.
extern "C" int rotate3_fused_u8(const void* image, const void* slope_a,
                                const void* slope_b, const void* quarter,
                                void* out, int batch, int size, int channels,
                                int pad, int kmax_a, int kmax_b, void* stream) {
  return launch_fused<uint8_t>(image, slope_a, slope_b, quarter, out, batch,
                               size, channels, pad, kmax_a, kmax_b, stream);
}

extern "C" int rotate3_fused_f32(const void* image, const void* slope_a,
                                 const void* slope_b, const void* quarter,
                                 void* out, int batch, int size, int channels,
                                 int pad, int kmax_a, int kmax_b, void* stream) {
  return launch_fused<float>(image, slope_a, slope_b, quarter, out, batch, size,
                             channels, pad, kmax_a, kmax_b, stream);
}

// rotate3_u16 — image, out: (B, C, H, W) uint16; slope_a, slope_b: (B,)
// float32.
extern "C" int rotate3_u16(const void* image, const void* slope_a,
                           const void* slope_b, void* out, int batch,
                           int channels, int height, int width, int kmax_a,
                           int kmax_b, void* stream) {
  const ChwCanvas canvas{(const uint16_t*)image, height, width, channels};
  const U16Store store{(uint16_t*)out, height, width, channels};
  rotate3_kernel<<<grid_of(height, width, batch), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(canvas, store, (const float*)slope_a,
                                           (const float*)slope_b, channels,
                                           kmax_a, kmax_b);
  return (int)cudaGetLastError();
}

// shear_u16 — image, out: (B, C, H, W) uint16; slope: (B,) float32; axis 2
// (ShX) or 1 (ShY).
extern "C" int shear_u16(const void* image, const void* slope, void* out,
                         int batch, int channels, int height, int width,
                         int kmax, int axis, void* stream) {
  const ChwCanvas canvas{(const uint16_t*)image, height, width, channels};
  const U16Store store{(uint16_t*)out, height, width, channels};
  shear1_kernel<<<grid_of(height, width, batch), dim3(kBlockX, kBlockY), 0,
                  (cudaStream_t)stream>>>(canvas, store, (const float*)slope,
                                          channels, kmax, axis);
  return (int)cudaGetLastError();
}
