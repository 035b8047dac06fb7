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
// and writes 31.9 MB of float32, ~12 us at 3.35 TB/s (float32 input: 31.9 MB
// read, ~19 us); rotate3 and shear on the padded (32, 3, 412, 412) uint16
// canvas read and write 32.6 MB each, ~19.5 us. The arithmetic is a few us at
// the float32 rate (chip_smoke.py:rotation_bound_ms, u16_bound_ms), but the
// tiled kernels spend several instructions per blend on unpacking, indexing
// and shared loads, and it is that work, not bytes, that holds them.
//
// The walk. ShX's output needs 2 taps of its input, so the rotation's output
// pixel needs 2 taps of S2, 4 of S1 and 8 of P. walk3 computes the lines'
// shifts and weights and maps the taps to pixels of a canvas class (where a
// pixel of P lives); replay3 replays the 7 blends per channel with the same
// integer arithmetic. A tap outside the canvas is 0, and a blend of two zeros
// is 0, so an out-of-canvas S1 or S2 tap needs no special case.
//
// rotate3_fused: a tiled rotation from the taps staged in shared memory.
//   What held the previous design back (one thread per output pixel, 32x8
//   blocks, 0.0789 ms = 6.6x the bound at (32, 288^2, 3) uint8): each thread
//   issued 24 one-byte __ldg loads (8 taps x 3 channels), and for odd
//   quarter-turns neighbouring output columns map to source pixels S*C bytes
//   apart, so each tap load of a warp touched up to 32 sectors.
//   The design. One block of 256 threads computes one 32x32 output tile, 4
//   consecutive columns a thread. The shift d(l) = clip(floor(__fmul_rn(t,
//   l - c))) is monotone in l for a fixed slope (a correctly rounded
//   product, floor and clip are all monotone), so the tile's rows give an
//   interval of S2 columns, those an interval of S1 rows (tile_footprint),
//   and each S1 row is read by an interval of those S2 columns (two binary
//   searches in the block's table of column shifts). The block stages one
//   packed word per P tap of each S1 row in that interval, and no other: at
//   most 1666 words at the path's slopes, a third of the rows x columns box
//   of P around them (67 x 77). A word packs the pixel's channels (their bytes
//   in 32 bits for uint8, to_fixed of each in 16 bits of 64 for float32), 0
//   outside the image; rows outside the image share one run of zeros. uint8
//   crops copy the box's source rows (contiguous in HWC) into shared memory
//   first with 16-byte cp.async, and a warp per S1 row packs its words from
//   them, each thread a run of consecutive words (its first row by a binary
//   search), through a per-row affine map of word to source pixel; float32
//   crops pack from global memory. Each tap is then one shared load at
//   A(row) + column with no bounds test; the first blend of the two taps of
//   an S1 value runs on channel pairs (u (256 - w) + v w < 2^16 for bytes,
//   so channels 0 and 2 share the two halves of one 32-bit product), and
//   the crop is stored as float4 runs. A tile whose S2 columns the canvas
//   does not cut (all but edge tiles) takes a copy of the blends without
//   the column test; the path's 3 channels are a compile-time count.
//   Sizing: at the path's slopes (|a| <= tan 22.5, |b| <= sin 45) a tile
//   stages at most 1666 words (6.5 KB uint8, 13 KB float32) beside 18 KB of
//   raw rows (uint8) and 11 KB of tables; ops/shear.py:stage_capacity and
//   stage_raw_bytes size the dynamic shared memory, and 40 registers a
//   thread let 6 blocks share an SM. The kernel takes any slope: a tile
//   whose words would exceed the capacity (or any tile when C > 4) takes
//   the direct walk of the previous design (walk3 with __ldg taps) inside
//   the same kernel, so the result is exact for every input; its tiles can
//   be counted (direct_tiles).
//   Measured (chip_smoke.py phase 2, run in turns with the previous design's
//   own chip_smoke.py on one card, NVIDIA H100 80GB HBM3, 700.00 W):
//   uint8 0.0338 ms against the previous design's 0.0789 and a 0.0119 ms
//   byte bound (2.8x); float32 0.0498 ms against 0.0918 and 0.0190 (2.6x).
//   What holds it: not bytes but per-block work, each step (footprint and
//   tables, staging, blends and stores) a chain of dependent shared loads
//   between barriers, at 40 registers and 11 KB of static tables a block.

// rotate3_u16: the tiled design on the (C, H, W) uint16 canvas as it is.
//   What held the previous design back (one thread per output pixel, 32x8
//   blocks, 8 two-byte __ldg taps per channel from the CHW planes): 0.1134
//   ms at (32, 3, 412^2), 5.8x its byte bound.
//   The design. rotate3_u16_kernel runs rotate3_fused_kernel's steps on P =
//   the canvas: a 32x32 tile of the whole H x W output a block, its
//   footprint from tile_footprint (each axis about its own centre, H != W
//   allowed, no margin: the whole canvas is data and taps outside it are 0),
//   one packed word per tap of each S1 row's interval (Packed<float>'s
//   layout, channel c at bits 16c of 64, packed from the planes in global
//   memory), the same tile_pixels blends, and each thread's 4 columns of a
//   channel stored as one 8-byte store (scalar stores where W is not a
//   multiple of 4). Tiles whose words exceed the capacity, and every tile
//   when C > 4, take the direct walk (walk3 + replay3 on the planes), counted
//   in direct_tiles. At the path's slopes it stages at most 1666 words (13
//   KB) beside 8 KB of tables, six blocks an SM at 40 registers.
//   Copying each plane's rows of the footprint's box into shared memory
//   first (cp.async, as the uint8 crops do) measured slower: the box holds
//   three times the words' pixels, so it tripled the bytes read from L2, and
//   its 60 KB of shared memory a block left room for three blocks an SM.
//   Measured (chip_smoke.py phase 2, beside the per-pixel design's own
//   chip_smoke.py in one call, NVIDIA H100 80GB HBM3, 700.00 W): 0.0686 ms
//   at (32, 3, 412^2) against 0.1133 and a 0.0195 ms byte bound (3.5x).
//   What holds it, as the fused mode: per-tile instruction work, not bytes.
//   The canvas is all output (5,408 tiles against the fused mode's 2,592 at
//   the same store), and each tile runs the footprint, tables and searches,
//   the packing (3 two-byte loads a word) and 14 blends per pixel in
//   tile_pixels. A scratch timing with single steps removed found each of
//   the three a large share; issuing a thread's word loads in groups, or
//   more registers a thread, was no faster. ptxas: 40 registers, 8,224
//   bytes of static tables beside 13,328 bytes of words, 88 bytes of stack
//   at 3 channels.
// shear_u16 keeps the per-pixel design (one thread per output pixel, whole
// canvas stored).
//
// Exactness, shared by all kernels through line_shear and blend: s, floor and
// the weight are float32 as in the JAX package, and the product t * (l - c)
// is __fmul_rn, so nvcc cannot contract it with the subtraction after it into
// an FMA; rintf rounds half to even like jnp.round / torch.round. The float
// input converts as clip(rint(x * 256), 0, 65535), jnp.round then jnp.clip.
// Each result is bit-identical to its plain version in ops/shear.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // the one-shear kernel's blocks
constexpr int kBlockY = 8;
constexpr int kTile = 32;    // rotate3_fused: output tile side
constexpr int kCols = 4;     // output columns per thread
constexpr int kTileThreads = kTile * kTile / kCols;
constexpr int kMaxStagedChannels = 4;

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

// Pixel (i, j) of P = rot90(pad(image), q), n = S + 2 pad on a side, as
// coordinates (y, x) of the unpadded image (possibly outside it); false when
// (i, j) is outside P.
__device__ __forceinline__ bool unturn(int q, int n, int pad, int i, int j,
                                       int& y, int& x) {
  if (i < 0 || i >= n || j < 0 || j >= n) return false;
  switch (q) {
    case 0: y = i; x = j; break;
    case 1: y = j; x = n - 1 - i; break;
    case 2: y = n - 1 - i; x = n - 1 - j; break;
    default: y = n - 1 - j; x = i; break;
  }
  y -= pad;
  x -= pad;
  return true;
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
    int y, x;
    if (!unturn(q, size + 2 * pad, pad, i, j, y, x)) return -1;
    if (y < 0 || y >= size || x < 0 || x >= size) return -1;
    return y * size + x;
  }

  __device__ int load(int pixel, int c) const {
    return to_fixed(__ldg(image + (size_t)pixel * channels + c));
  }
};

// The packed word of a staged pixel.
template <typename T>
struct Packed;

template <>
struct Packed<uint8_t> {  // the channels' bytes, channel c at bits 8c
  using Word = uint32_t;
  using Lane = uint8_t;
  __device__ static Lane lane(uint8_t v) { return v; }
};

template <>
struct Packed<float> {  // to_fixed of the channels, channel c at bits 16c
  using Word = unsigned long long;
  using Lane = uint16_t;
  __device__ static Lane lane(float v) { return (Lane)to_fixed(v); }
};

// ChwCanvas: P is a (C, H, W) uint16 canvas as it is.
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

// (B, C, H, W) uint16: the whole canvas, the one-shear kernel's store.
struct U16Store {
  uint16_t* out;
  int h, w, channels;

  __device__ int height() const { return h; }
  __device__ int width() const { return w; }

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

__device__ __forceinline__ int replay(const int (&v)[8], const Walk3& k) {
  int s1[4];
  for (int i = 0; i < 4; ++i) s1[i] = blend(v[2 * i], v[2 * i + 1], k.w1[i]);
  const int s2a = blend(s1[0], s1[1], k.w2[0]);
  const int s2b = blend(s1[2], s1[3], k.w2[1]);
  return blend(s2a, s2b, k.w3);
}

template <class Canvas>
__device__ __forceinline__ int replay3(const Canvas& p, const Walk3& k, int c) {
  int v[8];
  for (int i = 0; i < 8; ++i) v[i] = k.tap[i] < 0 ? 0 : p.load(k.tap[i], c);
  return replay(v, k);
}

// ---- rotate3_fused: the tiled kernel

// P's shape and where the image lies in it: rows [top, bottom] and columns
// [left, right]; outside, every tap is 0. rotate3_fused: the n x n turned,
// padded canvas with the image at [pad, pad + S); rotate3_u16: the H x W
// canvas, all of it data.
struct Frame {
  int rows, cols;
  int top, bottom, left, right;
};

// What the taps of one output tile (rows [r0, r1], columns [c0, c1] of P)
// can reach, in P's coordinates: the tile's S2 columns [c2lo, c2hi] cut to
// the canvas, its S1 rows [s1lo, s1lo + rows1) (not cut: a row outside the
// image is all zero taps), and the box of P (rows [i0, i0 + h), columns
// [j0, j0 + w)) of their taps cut to the image; h = 0 when no tap lands in
// the image. Rows shear about the middle row, columns about the middle
// column, as in walk3.
struct Footprint {
  int c2lo, c2hi;
  int s1lo, rows1;
  int i0, j0, h, w;
};

__device__ Footprint tile_footprint(const Frame& p, int r0, int r1, int c0, int c1, float a,
                                    float b, int kmax_a, int kmax_b) {
  Footprint f{0, -1, 0, 0, 0, 0, 0, 0};
  const float c_h = 0.5f * (float)(p.rows - 1), c_w = 0.5f * (float)(p.cols - 1);
  // S2 columns of the tile's rows (ShX(a) of rows r0 .. r1)
  const int e0 = line_shear(a, r0, c_h, kmax_a).d, e1 = line_shear(a, r1, c_h, kmax_a).d;
  f.c2lo = max(c0 + min(e0, e1), 0);
  f.c2hi = min(c1 + max(e0, e1) + 1, p.cols - 1);
  if (f.c2lo > f.c2hi) return f;
  // S1 rows of those columns (ShY(b) of columns c2lo .. c2hi)
  const int g0 = line_shear(b, f.c2lo, c_w, kmax_b).d, g1 = line_shear(b, f.c2hi, c_w, kmax_b).d;
  f.s1lo = r0 + min(g0, g1);
  f.rows1 = r1 + max(g0, g1) + 1 - f.s1lo + 1;
  const int rlo = max(f.s1lo, p.top), rhi = min(f.s1lo + f.rows1 - 1, p.bottom);
  if (rlo > rhi) return f;
  // P columns of those rows (ShX(a) of rows rlo .. rhi), cut to the image
  const int h0 = line_shear(a, rlo, c_h, kmax_a).d, h1 = line_shear(a, rhi, c_h, kmax_a).d;
  const int jlo = max(f.c2lo + min(h0, h1), p.left);
  const int jhi = min(f.c2hi + max(h0, h1) + 1, p.right);
  if (jlo > jhi) return f;
  f.i0 = rlo;
  f.j0 = jlo;
  f.h = rhi - rlo + 1;
  f.w = jhi - jlo + 1;
  return f;
}

// A shear line packed in one int for the block's tables: (d + kmax) << 9 | w.
__device__ __forceinline__ int pack_line(Shear l, int kmax) { return (l.d + kmax) << 9 | l.w; }

// One image pixel (C channels of T at p) as a packed word.
template <typename T>
__device__ __forceinline__ typename Packed<T>::Word pack_pixel(const T* __restrict__ p,
                                                               int channels) {
  using Word = typename Packed<T>::Word;
  constexpr int kBits = 8 * sizeof(typename Packed<T>::Lane);
  Word w = 0;
#pragma unroll
  for (int c = 0; c < kMaxStagedChannels; ++c)
    if (c < channels) w |= (Word)Packed<T>::lane(__ldg(p + c)) << (kBits * c);
  return w;
}

// The footprint's box turned back onto the image: source rows [ys0, ys1] and
// columns [xs0, xs1]. Pixel (y, x) of the image is P's (i, j) =
// (pad + y, pad + x) turned by q.
struct SourceBox {
  int ys0, ys1, xs0, xs1;
};

__device__ __forceinline__ SourceBox source_box(int q, int n, int pad, const Footprint& f) {
  const int lo = pad, hi = n - 1 - pad;
  const int i1 = f.i0 + f.h - 1, j1 = f.j0 + f.w - 1;
  switch (q) {
    case 0: return {f.i0 - lo, i1 - lo, f.j0 - lo, j1 - lo};  // i = pad + y, j = pad + x
    case 1: return {f.j0 - lo, j1 - lo, hi - i1, hi - f.i0};  // i = hi - x, j = pad + y
    case 2: return {hi - i1, hi - f.i0, hi - j1, hi - f.j0};  // i = hi - y, j = hi - x
    default: return {hi - j1, hi - f.j0, f.i0 - lo, i1 - lo};  // i = pad + x, j = hi - y
  }
}

__device__ __forceinline__ void copy_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

constexpr int kMaxLines = kTileThreads;  // S1 rows and S2 columns a staged tile spans
// the tiled kernels' static tables (line_b, row_tap, row_words, row_source,
// warp_words): beside them, dynamic shared memory above 48 KB - this needs
// the kernel's opt-in
constexpr size_t kTableBytes =
    kMaxLines * (sizeof(int) + sizeof(int2) + 2 * sizeof(int4)) + kTileThreads / 32 * sizeof(int);

// Lets `kernel` take `smem` bytes of dynamic shared memory beside its tables.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem + kTableBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The first of lines [0, count) whose packed shift (d + kmax) satisfies
// pred, pred being false then true along the lines.
template <class Pred>
__device__ __forceinline__ int first_line(const int* lines, int count, Pred pred) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(lines[mid] >> 9))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Step 2 of the tiled kernels, a thread an S1 row r of the tile's rows1
// (`active`): the S2 columns that read it, an interval [first, last] because
// the shift d2 is monotone in the column (binary searches in line_b), and its
// words, one per P tap: the interval and one more column, or none for a row
// outside the image (`inside` false). Every thread takes part: the words'
// running sum in the warp is `end`, and each warp's total goes to warp_words.
struct RowWords {
  int first, count, end;
};

__device__ __forceinline__ RowWords row_words_of(const int* line_b, int cols2, int r, int r0,
                                                 int r1, int kmax_b, float sb, bool active,
                                                 bool inside, int* warp_words) {
  int first = 0, count = 0;
  if (active) {
    // S2(row, c2) reads S1 rows row + d2 and row + d2 + 1, row in [r0, r1]
    const int lo = r - r1 - 1 + kmax_b, hi = r - r0 + kmax_b;  // on d2 + kmax_b
    int last;
    if (sb >= 0.0f) {  // d2 non-decreasing along the columns
      first = first_line(line_b, cols2, [&](int d) { return d >= lo; });
      last = first_line(line_b, cols2, [&](int d) { return d > hi; }) - 1;
    } else {
      first = first_line(line_b, cols2, [&](int d) { return d <= hi; });
      last = first_line(line_b, cols2, [&](int d) { return d < lo; }) - 1;
    }
    if (inside && first <= last) count = last - first + 2;
  }
  const int lane = threadIdx.x & 31;
  int end = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, end, o);
    if (lane >= o) end += v;
  }
  if (lane == 31) warp_words[threadIdx.x >> 5] = end;
  return {first, count, end};
}

// Step 4: the row of rows [0, rows) that holds staged word `word`, the last
// whose first word is at or before it (a row with no words shares its first
// word with the next row).
__device__ __forceinline__ int row_of_word(const int4* row_words, int rows, int word) {
  int t = 0;
  for (int hi = rows - 1; t < hi;) {
    const int mid = (t + hi + 1) >> 1;
    if (row_words[mid].x <= word)
      t = mid;
    else
      hi = mid - 1;
  }
  return t;
}

// The first blend, ShX(a) of P: S1 = blend(lo, hi, w) per channel of two
// staged words. uint8 words hold the channels' bytes; blend(256 u, 256 v, w)
// is u (256 - w) + v w exactly (the + 128 never reaches bit 8), at most
// 255 * 256 < 2^16, so channels 0 and 2 (1 and 3) blend together in the two
// 16-bit halves of one 32-bit product.
__device__ __forceinline__ void first_blend(uint32_t lo, uint32_t hi, int w, int channels,
                                            int (&s1)[kMaxStagedChannels]) {
  constexpr uint32_t kEven = 0x00FF00FFu;
  const uint32_t wl = (uint32_t)(256 - w), wh = (uint32_t)w;
  const uint32_t even = (lo & kEven) * wl + (hi & kEven) * wh;
  const uint32_t odd = ((lo >> 8) & kEven) * wl + ((hi >> 8) & kEven) * wh;
  s1[0] = (int)(even & 0xFFFFu);
  s1[1] = (int)(odd & 0xFFFFu);
  s1[2] = (int)(even >> 16);
  s1[3] = (int)(odd >> 16);
}

// float32 crops: to_fixed of each channel in a 16-bit lane, any 8.8 value.
__device__ __forceinline__ void first_blend(unsigned long long lo, unsigned long long hi,
                                            int w, int channels,
                                            int (&s1)[kMaxStagedChannels]) {
#pragma unroll
  for (int c = 0; c < kMaxStagedChannels; ++c)
    s1[c] = c < channels ? blend((int)((lo >> (16 * c)) & 0xFFFFu),
                                 (int)((hi >> (16 * c)) & 0xFFFFu), w)
                         : 0;
}

// v / 256 of an integer v in [0, 65535], exactly: 2^23 + v as a float's
// bits, scaled by 2^-8 and less 2^15, in one FMA (no int-to-float convert).
__device__ __forceinline__ float fixed_to_float(int v) {
  return __fmaf_rn(__int_as_float(0x4B000000 | v), 1.0f / 256.0f, -32768.0f);
}

// Four consecutive 8.8 results of one channel at dst: the crop's float32
// (v / 256, one 16-byte store) or the canvas's uint16 (one 8-byte store);
// `whole`: all four lie in the row and dst is aligned, else the first
// `count` are stored one by one.
__device__ __forceinline__ void store4(float* dst, const int (&v)[kCols], bool whole, int count) {
  float f[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) f[i] = fixed_to_float(v[i]);
  if (whole) {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (i < count) dst[i] = f[i];
  }
}

__device__ __forceinline__ void store4(uint16_t* dst, const int (&v)[kCols], bool whole,
                                       int count) {
  if (whole) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2((unsigned)v[0] | (unsigned)v[1] << 16, (unsigned)v[2] | (unsigned)v[3] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (i < count) dst[i] = (uint16_t)v[i];
  }
}

// The output tile's pixels from the staged words: each thread 4 consecutive
// pixels of one row, from the 5 S2 columns they share (output(row, col)
// blends S2(row, col + d3) and S2(row, col + d3 + 1)); S2(row, c2) blends S1
// rows row + d2 and row + d2 + 1 of column c2, each a blend of two staged
// words. kChecked: some column of the block lies outside the canvas (S2 = 0
// there, as in walk3) or outside the output's last tile; otherwise every
// thread's 5 columns are in [c2lo, c2hi] and the loads need no test. The
// output row has `width` pixels, channel c at row_out + c * plane.
template <typename Word, int kC, bool kChecked, typename Out>
__device__ __forceinline__ void tile_pixels(const Word* words, const int* line_b,
                                            const int2* row_tap, int cols2, int c2lo,
                                            int row_origin, int row, int c2base, int w3,
                                            int channels, int width, int xo0, Out* row_out,
                                            size_t plane) {
  const int nc = kC ? kC : channels;
  int s2[kCols + 1][kMaxStagedChannels];
#pragma unroll
  for (int t = 0; t <= kCols; ++t) {
    const int c2 = c2base + t, k2 = c2 - c2lo;
    const bool inside = !kChecked || (unsigned)k2 < (unsigned)cols2;
    const int e2 = line_b[inside ? k2 : 0];
    // the S1 row of u = 0 in row_tap: row + d2 - s1lo, with row_origin =
    // s1lo + kmax_b taking the packing's offset off too
    const int r = row + (e2 >> 9) - row_origin, w2 = e2 & 511;
    int s1[2][kMaxStagedChannels];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int2 tap = row_tap[inside ? r + u : 0];
      const Word* at = words + (inside ? tap.x + c2 : 0);
      first_blend(at[0], at[1], tap.y, nc, s1[u]);
    }
#pragma unroll
    for (int c = 0; c < kMaxStagedChannels; ++c)
      s2[t][c] = c < nc && inside ? blend(s1[0][c], s1[1][c], w2) : 0;
  }
  const bool whole = (width % kCols) == 0 && xo0 + kCols <= width;
#pragma unroll
  for (int c = 0; c < kMaxStagedChannels; ++c) {
    if (c >= nc) break;
    int v[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) v[i] = blend(s2[i][c], s2[i + 1][c], w3);
    store4(row_out + c * plane + xo0, v, whole, width - xo0);
  }
}

// kC: the channel count when known at compile time (3), else 0 and the
// channels argument holds it.
// 6 blocks an SM (40 registers a thread): the phases of a block are short
// chains of dependent loads, so the SM needs the other blocks' warps to
// hide them
template <typename T, int kC>
__global__ void __launch_bounds__(kTileThreads, 6) rotate3_fused_kernel(
    const T* __restrict__ image, const float* __restrict__ slope_a,
    const float* __restrict__ slope_b, const int32_t* __restrict__ quarter,
    float* __restrict__ out, int size, int channels, int pad, int kmax_a,
    int kmax_b, int capacity, int raw_bytes, int* __restrict__ direct_tiles) {
  using Word = typename Packed<T>::Word;
  extern __shared__ __align__(16) unsigned char smem[];
  Word* words = reinterpret_cast<Word*>(smem);
  __shared__ int line_b[kMaxLines];     // ShY(b) of S2 column c2lo + t, packed
  __shared__ int2 row_tap[kMaxLines];   // {A, w1}: tap v of S1 row s1lo + t at column
                                        // c2 is words[A + c2 + v]
  __shared__ int4 row_words[kMaxLines];  // its words: first, count, in-image [lo, hi)
  __shared__ int4 row_source[kMaxLines];  // where word o of it comes from
  __shared__ int warp_words[kTileThreads / 32];
  if (kC) channels = kC;

  const int b = blockIdx.z;
  const int n = size + 2 * pad;
  const float center = 0.5f * (float)(n - 1);
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int r0 = ty0 + pad, r1 = min(ty0 + kTile, size) - 1 + pad;
  const int c0 = tx0 + pad, c1 = min(tx0 + kTile, size) - 1 + pad;
  const float a = slope_a[b], sb = slope_b[b];
  const int q = quarter[b] & 3;
  const T* img = image + (size_t)b * size * size * channels;
  // block-uniform: every thread computes the same footprint
  const Footprint f = tile_footprint(Frame{n, n, pad, pad + size - 1, pad, pad + size - 1}, r0, r1,
                                     c0, c1, a, sb, kmax_a, kmax_b);
  const int cols2 = max(f.c2hi - f.c2lo + 1, 0);
  // the staged words: a run of zeros for the S1 rows outside the image, then
  // each S1 row's interval of taps; each S2 column reads tile_rows + 1 S1
  // rows, and each row's interval is one tap longer than its S2 columns
  const int zero_run = cols2 + 1;
  const int bound = zero_run + cols2 * (r1 - r0 + 2) + f.rows1;
  const SourceBox box = source_box(q, n, pad, f);
  // the raw bytes of each source row of the box (uint8), from its first
  // 16-byte aligned chunk: raw_stride bytes a row, an odd number of chunks
  // (a column of the box, read down the rows for odd quarter-turns, then
  // spreads over 8 of the 16-byte bank groups, not 1)
  const int run = (box.xs1 - box.xs0 + 1) * channels * (int)sizeof(T);
  const int raw_stride = (((run + 15) / 16 + 1) | 1) * 16;
  const int raw_rows = box.ys1 - box.ys0 + 1;
  const bool staged = capacity > 0 && bound <= capacity && cols2 <= kMaxLines &&
                      f.rows1 <= kMaxLines &&
                      (sizeof(T) > 1 || f.h == 0 || raw_rows * raw_stride <= raw_bytes);

  const int yo = ty0 + threadIdx.x / (kTile / kCols);
  const int xo0 = tx0 + (threadIdx.x % (kTile / kCols)) * kCols;
  const size_t plane = (size_t)size * size;
  float* row_out = out + ((size_t)b * channels * size + yo) * size;  // channel 0

  if (!staged) {  // the direct walk: taps straight from the image
    if (threadIdx.x == 0 && direct_tiles != nullptr) atomicAdd(direct_tiles, 1);
    if (yo >= size) return;
    const HwcCanvas<T> p{img, quarter, size, channels, pad, q};
    for (int i = 0; i < kCols; ++i) {
      const int xo = xo0 + i;
      if (xo >= size) break;
      const Walk3 k = walk3(p, yo + pad, xo + pad, a, sb, kmax_a, kmax_b);
      for (int c = 0; c < channels; ++c)
        row_out[c * plane + xo] = __fmul_rn((float)replay3(p, k, c), 1.0f / 256.0f);
    }
    return;
  }

  // 1. the source rows' bytes (uint8) in flight, copied asynchronously in
  // 16-byte chunks (a chunk that holds one byte of the row lies in the same
  // allocation, whose base and size the allocator aligns to far more than 16
  // bytes); the S2 columns' lines meanwhile
  unsigned char* raw = smem + ((capacity * sizeof(Word) + 15) & ~(size_t)15);
  if constexpr (sizeof(T) == 1) {
    const int chunks = raw_stride / 16;
    if (f.h > 0) {
      for (int t = threadIdx.x; t < raw_rows * chunks; t += blockDim.x) {
        const int r = t / chunks, chunk = t - r * chunks;
        const uintptr_t start = reinterpret_cast<uintptr_t>(
            img + ((size_t)(box.ys0 + r) * size + box.xs0) * channels);
        const uintptr_t at = (start & ~(uintptr_t)15) + 16 * (uintptr_t)chunk;
        if (at < start + run) copy_async16(raw + r * raw_stride + 16 * chunk, at);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  if ((int)threadIdx.x < cols2)
    line_b[threadIdx.x] = pack_line(line_shear(sb, f.c2lo + threadIdx.x, center, kmax_b), kmax_b);
  __syncthreads();

  // 2. a thread an S1 row: its words (row_words_of)
  const int t = threadIdx.x;
  const int r = f.s1lo + t;
  const RowWords rw = row_words_of(line_b, cols2, r, r0, r1, kmax_b, sb, t < f.rows1,
                                   r >= pad && r < pad + size, warp_words);
  const int first = rw.first, count = rw.count, end = rw.end;
  __syncthreads();

  // 3. a thread an S1 row: where its words start, which of them lie in the
  // image, and where each comes from; its entry of row_tap
  if (t < f.rows1) {
    int base = zero_run + end - count;
    for (int k = 0; k < (t >> 5); ++k) base += warp_words[k];
    const Shear l1 = line_shear(a, r, center, kmax_a);
    const int c2first = f.c2lo + first;
    row_tap[t] = make_int2(count > 0 ? base - c2first : -f.c2lo, l1.w);
    // word o is P's (r, j0 + o): image pixel (y0 + dy o, x0 + dx o)
    const int j0 = c2first + l1.d, hi = n - 1 - pad;
    int y0, x0, dy = 0, dx = 0;
    switch (q) {
      case 0: y0 = r - pad; x0 = j0 - pad; dx = 1; break;
      case 1: y0 = j0 - pad; x0 = hi - r; dy = 1; break;
      case 2: y0 = hi - r; x0 = hi - j0; dx = -1; break;
      default: y0 = hi - j0; x0 = r - pad; dy = -1; break;
    }
    // the moving coordinate v0 + step o stays in [0, size) for o in [lo, hi)
    const int v0 = dx != 0 ? x0 : y0, step = dx + dy;
    const int lo = max(step > 0 ? -v0 : v0 - size + 1, 0);
    const int in_hi = min(step > 0 ? size - v0 : v0 + 1, count);
    row_words[t] = make_int4(base, count, lo, in_hi);
    if constexpr (sizeof(T) == 1) {
      if ((q & 1) == 0)  // a source row: the byte of word o in the raw rows, affine
        row_source[t] = make_int4(
            (y0 - box.ys0) * raw_stride +
                (((int)(reinterpret_cast<uintptr_t>(img) & 15) + (y0 * size + box.xs0) * channels) &
                 15) +
                (x0 - box.xs0) * channels,
            dx * channels, 0, 0);
      else  // a source column: the row y0 + dy o, at byte (x0 - xs0) C of the box
        row_source[t] = make_int4(y0, dy, (x0 - box.xs0) * channels, 0);
    } else {  // the pixel of word o in the image, affine
      row_source[t] = make_int4((y0 * size + x0) * channels, (dy * size + dx) * channels, 0, 0);
    }
  }
  if constexpr (sizeof(T) == 1) {
    if (f.h > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // 4. the words, a run of consecutive ones a thread (the run's first row by
  // a binary search in the rows' first words): the image's pixels in P's
  // orientation, 0 outside the image (a pixel clamped into the image is read
  // and kept or dropped); the zero run
  {
    const int misalign = (int)(reinterpret_cast<uintptr_t>(img) & 15) + box.xs0 * channels;
    int total = 0;
    for (int k = 0; k < kTileThreads / 32; ++k) total += warp_words[k];
    const int per = (total + kTileThreads - 1) / kTileThreads;
    int at_word = zero_run + (int)threadIdx.x * per;
    const int end_word = min(at_word + per, zero_run + total);
    if (at_word < end_word) {
      int t = row_of_word(row_words, f.rows1, at_word);
      int4 w = row_words[t], src = row_source[t];
      for (; at_word < end_word; ++at_word) {
        int o = at_word - w.x;
        while (o >= w.y) {  // into the next row with words
          ++t;
          w = row_words[t];
          src = row_source[t];
          o = at_word - w.x;
        }
        Word word = 0;
        if (w.z < w.w) {
          const int oc = min(max(o, w.z), w.w - 1);
          Word v;
          if constexpr (sizeof(T) == 1) {
            int at;
            if (q & 1) {
              const int y = src.x + src.y * oc;
              at = (y - box.ys0) * raw_stride + ((misalign + y * size * channels) & 15) + src.z;
            } else {
              at = src.x + src.y * oc;
            }
            // its C <= 4 bytes sit in two aligned 32-bit words of the row's
            // copy, and one byte permute packs them
            const uint32_t* p = reinterpret_cast<const uint32_t*>(raw + (at & ~3));
            v = __byte_perm(p[0], p[1], (unsigned)(at & 3) * 0x1111u + 0x3210u);
          } else {
            v = pack_pixel<T>(img + src.x + src.y * oc, channels);
          }
          word = (unsigned)(o - w.z) < (unsigned)(w.w - w.z) ? v : Word(0);
        }
        words[at_word] = word;
      }
    }
    for (int k = threadIdx.x; k < zero_run; k += blockDim.x) words[k] = 0;
  }
  __syncthreads();
  if (yo >= size) return;

  const int row = yo + pad;
  const Shear l3 = line_shear(a, row, center, kmax_a);
  const int c2base = xo0 + pad + l3.d;
  // every thread's columns in [c2lo, c2hi]: the tile is whole and its S2
  // columns were not cut to the canvas
  const int e0 = line_shear(a, r0, center, kmax_a).d, e1 = line_shear(a, r1, center, kmax_a).d;
  const bool checked = c1 - c0 + 1 < kTile || f.c2lo != c0 + min(e0, e1) ||
                       f.c2hi != c1 + max(e0, e1) + 1;
  if (checked)
    tile_pixels<Word, kC, true>(words, line_b, row_tap, cols2, f.c2lo, f.s1lo + kmax_b, row, c2base,
                                l3.w, channels, size, xo0, row_out, plane);
  else
    tile_pixels<Word, kC, false>(words, line_b, row_tap, cols2, f.c2lo, f.s1lo + kmax_b, row,
                                 c2base, l3.w, channels, size, xo0, row_out, plane);
}

// ---- rotate3_u16: the tiled kernel on a (C, H, W) uint16 canvas
//
// The walk of rotate3_fused_kernel on P = the canvas as it is (no to_fixed,
// pad, quarter-turn or crop; H != W allowed, each axis about its own
// centre): a block computes a 32 x 32 tile of the whole H x W output. Its
// words are Packed<float>'s (channel c's 16 bits at bits 16c of 64), packed
// from the planes in global memory. Each thread stores its 4 columns of
// each channel as one 8-byte store.

template <int kC>
__global__ void __launch_bounds__(kTileThreads, 6) rotate3_u16_kernel(
    const uint16_t* __restrict__ image, const float* __restrict__ slope_a,
    const float* __restrict__ slope_b, uint16_t* __restrict__ out, int channels, int height,
    int width, int kmax_a, int kmax_b, int capacity, int* __restrict__ direct_tiles) {
  using Word = unsigned long long;
  extern __shared__ __align__(16) unsigned char smem[];
  Word* words = reinterpret_cast<Word*>(smem);
  __shared__ int line_b[kMaxLines];      // ShY(b) of S2 column c2lo + t, packed
  __shared__ int2 row_tap[kMaxLines];    // {A, w1} of S1 row s1lo + t, as in rotate3_fused
  __shared__ int4 row_words[kMaxLines];  // its words: first, count, in-canvas [lo, hi)
  __shared__ int row_source[kMaxLines];  // the canvas element (plane 0) of its word 0
  __shared__ int warp_words[kTileThreads / 32];
  if (kC) channels = kC;

  const int b = blockIdx.z;
  const float c_h = 0.5f * (float)(height - 1), c_w = 0.5f * (float)(width - 1);
  const int r0 = blockIdx.y * kTile, r1 = min(r0 + kTile, height) - 1;
  const int c0 = blockIdx.x * kTile, c1 = min(c0 + kTile, width) - 1;
  const float a = slope_a[b], sb = slope_b[b];
  const size_t plane = (size_t)height * width;
  const uint16_t* img = image + (size_t)b * channels * plane;
  const Footprint f = tile_footprint(Frame{height, width, 0, height - 1, 0, width - 1}, r0, r1, c0,
                                     c1, a, sb, kmax_a, kmax_b);
  const int cols2 = max(f.c2hi - f.c2lo + 1, 0);
  const int zero_run = cols2 + 1;
  const int bound = zero_run + cols2 * (r1 - r0 + 2) + f.rows1;
  const bool staged = capacity > 0 && bound <= capacity && cols2 <= kMaxLines &&
                      f.rows1 <= kMaxLines;

  const int yo = r0 + threadIdx.x / (kTile / kCols);
  const int xo0 = c0 + (threadIdx.x % (kTile / kCols)) * kCols;
  uint16_t* row_out = out + (size_t)b * channels * plane + (size_t)yo * width;  // channel 0

  if (!staged) {  // the direct walk: taps straight from the canvas
    if (threadIdx.x == 0 && direct_tiles != nullptr) atomicAdd(direct_tiles, 1);
    if (yo >= height) return;
    const ChwCanvas p{img, height, width, channels};
    for (int i = 0; i < kCols; ++i) {
      const int xo = xo0 + i;
      if (xo >= width) break;
      const Walk3 k = walk3(p, yo, xo, a, sb, kmax_a, kmax_b);
      for (int c = 0; c < channels; ++c) row_out[c * plane + xo] = (uint16_t)replay3(p, k, c);
    }
    return;
  }

  // 1. the S2 columns' lines
  if ((int)threadIdx.x < cols2)
    line_b[threadIdx.x] = pack_line(line_shear(sb, f.c2lo + threadIdx.x, c_w, kmax_b), kmax_b);
  __syncthreads();

  // 2. a thread an S1 row: its words (row_words_of), none for a row outside
  // the canvas
  const int t = threadIdx.x;
  const int r = f.s1lo + t;
  const RowWords rw = row_words_of(line_b, cols2, r, r0, r1, kmax_b, sb, t < f.rows1,
                                   r >= 0 && r < height, warp_words);
  const int first = rw.first, count = rw.count, end = rw.end;
  __syncthreads();

  // 3. a thread an S1 row: where its words start, which lie in the canvas
  // (word o is P's (r, j0 + o)), and the element of word 0
  if (t < f.rows1) {
    int base = zero_run + end - count;
    for (int k = 0; k < (t >> 5); ++k) base += warp_words[k];
    const Shear l1 = line_shear(a, r, c_h, kmax_a);
    const int c2first = f.c2lo + first;
    row_tap[t] = make_int2(count > 0 ? base - c2first : -f.c2lo, l1.w);
    const int j0 = c2first + l1.d;
    row_words[t] = make_int4(base, count, max(-j0, 0), min(width - j0, count));
    row_source[t] = count > 0 ? r * width + j0 : 0;
  }
  __syncthreads();

  // 4. the words, a run of consecutive ones a thread, 0 outside the canvas
  {
    int total = 0;
    for (int k = 0; k < kTileThreads / 32; ++k) total += warp_words[k];
    const int per = (total + kTileThreads - 1) / kTileThreads;
    int at_word = zero_run + (int)threadIdx.x * per;
    const int end_word = min(at_word + per, zero_run + total);
    if (at_word < end_word) {
      int t = row_of_word(row_words, f.rows1, at_word);
      int4 w = row_words[t];
      int src = row_source[t];
      for (; at_word < end_word; ++at_word) {
        int o = at_word - w.x;
        while (o >= w.y) {  // into the next row with words
          ++t;
          w = row_words[t];
          src = row_source[t];
          o = at_word - w.x;
        }
        Word word = 0;
        if (o >= w.z && o < w.w) {
#pragma unroll
          for (int c = 0; c < kMaxStagedChannels; ++c)
            if (c < channels) word |= (Word)__ldg(img + c * plane + src + o) << (16 * c);
        }
        words[at_word] = word;
      }
    }
    for (int k = threadIdx.x; k < zero_run; k += blockDim.x) words[k] = 0;
  }
  __syncthreads();
  if (yo >= height) return;

  const Shear l3 = line_shear(a, yo, c_h, kmax_a);
  const int e0 = line_shear(a, r0, c_h, kmax_a).d, e1 = line_shear(a, r1, c_h, kmax_a).d;
  const bool checked = c1 - c0 + 1 < kTile || f.c2lo != c0 + min(e0, e1) ||
                       f.c2hi != c1 + max(e0, e1) + 1;
  if (checked)
    tile_pixels<Word, kC, true>(words, line_b, row_tap, cols2, f.c2lo, f.s1lo + kmax_b, yo,
                                xo0 + l3.d, l3.w, channels, width, xo0, row_out, plane);
  else
    tile_pixels<Word, kC, false>(words, line_b, row_tap, cols2, f.c2lo, f.s1lo + kmax_b, yo,
                                 xo0 + l3.d, l3.w, channels, width, xo0, row_out, plane);
}

// ---- the per-pixel kernel of the one-shear mode

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
                 int channels, int pad, int kmax_a, int kmax_b, int capacity,
                 int raw_bytes, void* direct_tiles, void* stream) {
  if (channels > kMaxStagedChannels) capacity = raw_bytes = 0;
  // the footprint's words, then the raw rows from a 16-byte boundary
  const size_t smem =
      (((size_t)capacity * sizeof(typename Packed<T>::Word) + 15) & ~(size_t)15) + raw_bytes;
  // the path's three channels as a compile-time count, any other at run time
  const auto kernel = channels == 3 ? rotate3_fused_kernel<T, 3> : rotate3_fused_kernel<T, 0>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (size + kTile - 1) / kTile;
  kernel<<<dim3(tiles, tiles, batch), kTileThreads, smem, (cudaStream_t)stream>>>(
      (const T*)image, (const float*)slope_a, (const float*)slope_b,
      (const int32_t*)quarter, (float*)out, size, channels, pad, kmax_a, kmax_b,
      capacity, raw_bytes, (int*)direct_tiles);
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
// rotation margins for S. capacity: the packed words of shared memory a
// block stages its footprint in, raw_bytes: the bytes it copies the source
// rows into first (ops/shear.py:stage_capacity, stage_raw_bytes; 0 walks
// every tile directly).
// direct_tiles: null, or an int32 the kernel adds 1 to for each tile that
// took the direct walk.
extern "C" int rotate3_fused_u8(const void* image, const void* slope_a,
                                const void* slope_b, const void* quarter,
                                void* out, int batch, int size, int channels,
                                int pad, int kmax_a, int kmax_b, int capacity,
                                int raw_bytes, void* direct_tiles, void* stream) {
  return launch_fused<uint8_t>(image, slope_a, slope_b, quarter, out, batch,
                               size, channels, pad, kmax_a, kmax_b, capacity,
                               raw_bytes, direct_tiles, stream);
}

extern "C" int rotate3_fused_f32(const void* image, const void* slope_a,
                                 const void* slope_b, const void* quarter,
                                 void* out, int batch, int size, int channels,
                                 int pad, int kmax_a, int kmax_b, int capacity,
                                 int raw_bytes, void* direct_tiles, void* stream) {
  return launch_fused<float>(image, slope_a, slope_b, quarter, out, batch, size,
                             channels, pad, kmax_a, kmax_b, capacity, raw_bytes,
                             direct_tiles, stream);
}

// rotate3_u16 — image, out: (B, C, H, W) uint16; slope_a, slope_b: (B,)
// float32. capacity: the packed words a block stages its footprint in
// (ops/shear.py:stage_capacity; 0 walks every tile directly); direct_tiles
// as above.
extern "C" int rotate3_u16(const void* image, const void* slope_a,
                           const void* slope_b, void* out, int batch,
                           int channels, int height, int width, int kmax_a,
                           int kmax_b, int capacity, void* direct_tiles, void* stream) {
  if (channels > kMaxStagedChannels) capacity = 0;
  const size_t smem = (size_t)capacity * sizeof(unsigned long long);
  const auto kernel = channels == 3 ? rotate3_u16_kernel<3> : rotate3_u16_kernel<0>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, batch);
  kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)image, (const float*)slope_a, (const float*)slope_b, (uint16_t*)out,
      channels, height, width, kmax_a, kmax_b, capacity, (int*)direct_tiles);
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
