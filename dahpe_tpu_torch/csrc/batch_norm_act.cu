// Training batch norm of bfloat16 channels-last activations, with the
// residual add and the ReLU that follow it fused in, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses batch norm, the residual add
// and the ReLU into the convolutions' neighbours by itself. Eager PyTorch
// runs them as separate kernels: ATen's own channels-last batch norm for a
// bfloat16 input with float32 parameters, then a ReLU, or an add and a
// ReLU, and in backward a threshold_backward before batch norm's gradient.
// This file computes, for x of R = N*H*W rows by C channels (NHWC), with
// float32 statistics and parameters (ops/batch_norm_act.py holds the plain
// PyTorch sequence it replaces, batch_norm_act_plain):
//
//   t = bf16(((x - mean) * invstd) * weight + bias)     (float32 steps, no FMA)
//   y = t  |  relu(t)  |  relu(bf16(t + residual))      (mode 0, 1, 2)
//
// with the batch's mean and biased variance, and updates the running mean,
// the running (unbiased) variance and num_batches_tracked as nn.BatchNorm2d
// does. t rounds where the plain sequence rounds, so given the same
// statistics the output is bit for bit the plain one's. Backward takes
// g = dy, masked by the ReLU (y <= 0 gives 0, as threshold_backward), and
// returns dx = ((g - mean(g)) - (x - mean) * invstd^2 * mean(g * (x - mean)))
// * invstd * weight in bf16, dweight = sum(g * (x - mean)) * invstd and
// dbias = sum(g) in float32, and, in mode 2, g as the residual's gradient.
//
// What bounds it on the H100: bytes, and at the model's smaller layers the
// latency of dependent steps. Per element, the forward reads x twice
// (statistics, then the normalisation) and writes y, and reads the residual
// in mode 2: 6 B (8 B); the backward reads dy and x twice and writes dx, and
// in mode 2 reads y once and writes g once: 10 B (14 B). The arithmetic, a
// few float32 operations an element, is far below the bandwidth line. Most
// of ResNet-101's batch norms are layer3's, 8,192 rows of 256 or 1,024
// channels (4 or 16 MB): a pass over them takes 1-5 us at the bandwidth,
// about what a kernel launch and its ramp take.
//
// The design: one kernel a direction, three phases separated by grid-wide
// barriers (a cooperative launch: every block resident, two blocks an SM).
// - Every phase tiles the R x C matrix the same way (ops/batch_norm_act.py:
//   plan): a thread owns a vector of 8 channels (one 16-byte load or store;
//   1 where C is not a multiple of 8 or a pointer is not 16-byte aligned)
//   and walks rows; a block of 256 threads is ct vectors along C (ct =
//   min(C / 8, 32): a warp reads 512 contiguous bytes) by rpp = 256 / ct
//   rows, and owns a run of rows_per_block rows of its channel tile; the
//   grid is at most two blocks an SM (264 on the H100). A thread issues 4
//   rows' loads before it uses one, so an SM keeps ~32 KB in flight.
// - Phase 1, statistics: each thread sums x - x[0, c] and its square (the
//   shift keeps E[x^2] - E[x]^2 from cancelling), kUnroll rows at a time in
//   float32 and those sums in double (one float32 sum over the ~60 rows a
//   thread walks at the stem put the variance up to 5e-6 off, 20x ATen's
//   error), the block adds its rows in a fixed tree in shared memory and
//   writes one double partial per channel. (Backward: sum(g) and
//   sum(g * (x - mean)), in float32.)
// - Phase 2, after a barrier: one warp a channel adds the channel's
//   partials in double in a fixed order (lane l: blocks l, l + 32, ...,
//   then a butterfly), so two launches give the same bits, with no
//   floating-point atomics anywhere; it writes mean and invstd for backward,
//   the running statistics and num_batches_tracked (backward: dweight,
//   dbias and phase 3's three factors).
// - Phase 3, after a second barrier: the normalisation and its epilogue
//   (backward: dx), over the block's rows again. Layers of at most ~25 MB
//   (layer2 to layer4) are still in the 50 MB L2 cache then.
// - Backward, mode 1: the ReLU mask is t > 0, recomputed from x with the
//   forward's statistics and the forward's arithmetic, so it is the
//   forward's own mask without reading y; mode 2: phase 1 reads y for the
//   mask and writes g, which phase 3 reads in place of dy and y.
//
// The file must be compiled WITHOUT --use_fast_math: the normalisation's
// rounding steps are written with __fsub_rn/__fmul_rn/__fadd_rn so that no
// FMA contraction changes them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;  // resident blocks an SM: the grid's ceiling
constexpr int kUnroll = 4;       // rows whose loads a thread issues together

enum Mode { kPlain = 0, kRelu = 1, kAddRelu = 2 };

// VEC bf16 values of one row, moved as one load or store
template <int VEC>
union Pack;
template <>
union Pack<8> {
  uint4 u;
  unsigned short s[8];
};
template <>
union Pack<1> {
  unsigned short u;
  unsigned short s[1];
};

// Plain (coherent) loads: phase 3 of the backward reads what phase 1 wrote.
template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const unsigned short* p) {
  Pack<VEC> v;
  if constexpr (VEC == 8)
    v.u = *reinterpret_cast<const uint4*>(p);
  else
    v.u = *p;
  return v;
}

template <int VEC>
__device__ __forceinline__ void store(unsigned short* p, const Pack<VEC>& v) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = v.u;
  else
    *p = v.u;
}

__device__ __forceinline__ float bf(unsigned short s) { return __uint_as_float((unsigned)s << 16); }

__device__ __forceinline__ unsigned short to_bf(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// t = bf16(((x - mean) * invstd) * weight + bias), rounded at every step as
// the plain sequence's float32 operations round
__device__ __forceinline__ unsigned short normalise(float x, float m, float inv, float w, float b) {
  return to_bf(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), inv), w), b));
}

// the ReLU as threshold(0, 0) computes it: v <= 0 gives +0, NaN passes
__device__ __forceinline__ unsigned short relu(unsigned short v) { return bf(v) <= 0.0f ? 0 : v; }

// All blocks of the (cooperative) grid here, and their writes visible.
__device__ __forceinline__ void grid_barrier() {
  __threadfence();
  cooperative_groups::this_grid().sync();
}

// A thread's place in the tiling (module comment).
struct Tile {
  int c0;       // first channel of the thread's vector
  int lane_r;   // row lane, 0 .. rpp - 1
  int r_begin;  // the block's rows
  int r_end;
  bool live;
};

template <int VEC>
__device__ __forceinline__ Tile tile(int rows, int channels, int ct, int rpp, int rows_per_block) {
  Tile t;
  const int lane_c = threadIdx.x % ct;
  t.lane_r = threadIdx.x / ct;
  t.c0 = (blockIdx.y * ct + lane_c) * VEC;
  t.r_begin = blockIdx.x * rows_per_block;
  t.r_end = min(t.r_begin + rows_per_block, rows);
  t.live = t.lane_r < rpp && t.c0 < channels;
  return t;
}

// The offset of row r at the thread's channels.
__device__ __forceinline__ size_t at(const Tile& t, int r, int channels) {
  return (size_t)r * channels + t.c0;
}

// Adds red[j][lane_r * ct + lane_c] over lane_r = 0 .. rpp - 1 into
// lane_r = 0, in a fixed tree, then writes the block's two sums of each
// channel to partial[blockIdx.x][0 | 1][c]. Every thread must call it.
template <int VEC, typename T>
__device__ __forceinline__ void block_partials(T (&red)[2 * VEC][kThreads], const Tile& t,
                                               int ct, int rpp, T* __restrict__ partial,
                                               int channels) {
  int top = 1;
  while (top < rpp) top <<= 1;
  for (int half = top >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if (t.lane_r < half && t.lane_r + half < rpp) {
#pragma unroll
      for (int j = 0; j < 2 * VEC; ++j) red[j][threadIdx.x] += red[j][threadIdx.x + half * ct];
    }
  }
  __syncthreads();
  if (!t.live || t.lane_r != 0) return;
  T* p = partial + (size_t)blockIdx.x * 2 * channels + t.c0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    p[j] = red[j][threadIdx.x];
    p[channels + j] = red[VEC + j][threadIdx.x];
  }
}

// Phase 2's loop: each warp of the grid takes channels warp, warp + warps,
// ... and, for each, the sums of its partials over the row blocks in double
// in a fixed order; `done(c, s0, s1)` runs in lane 0.
template <typename T, class Done>
__device__ __forceinline__ void channel_sums(const T* __restrict__ partial, int row_blocks,
                                             int channels, Done done) {
  const int lane = threadIdx.x % 32;
  const int per_block = blockDim.x / 32;
  const int warps = gridDim.x * gridDim.y * per_block;
  const int warp = (blockIdx.y * gridDim.x + blockIdx.x) * per_block + threadIdx.x / 32;
  for (int c = warp; c < channels; c += warps) {
    double s0 = 0.0, s1 = 0.0;
#pragma unroll 4
    for (int rb = lane; rb < row_blocks; rb += 32) {
      const T* p = partial + (size_t)rb * 2 * channels + c;
      s0 += p[0];
      s1 += p[channels];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane == 0) done(c, s0, s1);
  }
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    batch_norm_act_forward_kernel(const unsigned short* __restrict__ x,
                                  const unsigned short* __restrict__ residual,
                                  unsigned short* __restrict__ y, const float* __restrict__ weight,
                                  const float* __restrict__ bias,
                                  float* __restrict__ running_mean,
                                  float* __restrict__ running_var,
                                  long long* __restrict__ num_batches_tracked,
                                  float* __restrict__ save_mean, float* __restrict__ save_invstd,
                                  double* __restrict__ partial, int rows, int channels, int ct,
                                  int rpp, int row_blocks, int rows_per_block, double eps,
                                  double momentum) {
  __shared__ double red[2 * VEC][kThreads];
  const Tile t = tile<VEC>(rows, channels, ct, rpp, rows_per_block);

  // phase 1: each block's sums of x - x[0, c] and of its square
  double sum[VEC], sq[VEC];
  float shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = sq[j] = 0.0;
  if (t.live) {
    const Pack<VEC> k = load<VEC>(x + t.c0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) shift[j] = bf(k.s[j]);
    for (int r = t.r_begin + t.lane_r; r < t.r_end; r += kUnroll * rpp) {
      Pack<VEC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * rpp < t.r_end) v[u] = load<VEC>(x + at(t, r + u * rpp, channels));
      float gs[VEC], gq[VEC];  // the kUnroll rows' sums
#pragma unroll
      for (int j = 0; j < VEC; ++j) gs[j] = gq[j] = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * rpp >= t.r_end) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = bf(v[u].s[j]) - shift[j];
          gs[j] += d;
          gq[j] = fmaf(d, d, gq[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum[j] += gs[j];
        sq[j] += gq[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[j][threadIdx.x] = sum[j];
    red[VEC + j][threadIdx.x] = sq[j];
  }
  block_partials<VEC>(red, t, ct, rpp, partial, channels);
  grid_barrier();

  // phase 2: mean, invstd and the running statistics of each channel
  channel_sums(partial, row_blocks, channels, [&](int c, double s, double q) {
    const double n = (double)rows;
    const double d = s / n;
    const double var = fmax(q / n - d * d, 0.0);
    const double mean = (double)bf(x[c]) + d;
    save_mean[c] = (float)mean;
    save_invstd[c] = (float)(1.0 / sqrt(var + eps));
    running_mean[c] = (float)((1.0 - momentum) * (double)running_mean[c] + momentum * mean);
    running_var[c] =
        (float)((1.0 - momentum) * (double)running_var[c] + momentum * var * n / (n - 1.0));
    if (c == 0) *num_batches_tracked += 1;
  });
  grid_barrier();

  // phase 3: the normalisation and its epilogue
  if (!t.live) return;
  float m[VEC], inv[VEC], w[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = save_mean[t.c0 + j];
    inv[j] = save_invstd[t.c0 + j];
    w[j] = weight[t.c0 + j];
    b[j] = bias[t.c0 + j];
  }
  for (int r = t.r_begin + t.lane_r; r < t.r_end; r += kUnroll * rpp) {
    Pack<VEC> v[kUnroll], z[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rpp < t.r_end) {
        v[u] = load<VEC>(x + at(t, r + u * rpp, channels));
        if constexpr (MODE == kAddRelu) z[u] = load<VEC>(residual + at(t, r + u * rpp, channels));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rpp >= t.r_end) break;
      Pack<VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        unsigned short h = normalise(bf(v[u].s[j]), m[j], inv[j], w[j], b[j]);
        if constexpr (MODE == kAddRelu) h = to_bf(__fadd_rn(bf(h), bf(z[u].s[j])));
        if constexpr (MODE != kPlain) h = relu(h);
        o.s[j] = h;
      }
      store<VEC>(y + at(t, r + u * rpp, channels), o);
    }
  }
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    batch_norm_act_backward_kernel(const unsigned short* __restrict__ dy,
                                   const unsigned short* __restrict__ x,
                                   const unsigned short* __restrict__ y,
                                   unsigned short* __restrict__ dx,
                                   unsigned short* __restrict__ dresidual,
                                   const float* __restrict__ weight,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ save_mean,
                                   const float* __restrict__ save_invstd,
                                   float* __restrict__ dweight, float* __restrict__ dbias,
                                   float* __restrict__ partial, float* __restrict__ coef,
                                   int rows, int channels, int ct, int rpp, int row_blocks,
                                   int rows_per_block) {
  __shared__ float red[2 * VEC][kThreads];
  const Tile t = tile<VEC>(rows, channels, ct, rpp, rows_per_block);
  float m[VEC], inv[VEC], w[VEC], b[VEC];
  if (t.live) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = save_mean[t.c0 + j];
      inv[j] = save_invstd[t.c0 + j];
      w[j] = weight[t.c0 + j];
      b[j] = bias[t.c0 + j];
    }
  }
  // the ReLU mask of mode 1: t <= 0, t as the forward computed it
  const auto masked = [&](float xj, int j) {
    return bf(normalise(xj, m[j], inv[j], w[j], b[j])) <= 0.0f;
  };

  // phase 1: each block's sums of g and g * (x - mean); mode 2 writes g
  float sg[VEC], sgx[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sg[j] = sgx[j] = 0.0f;
  if (t.live) {
    for (int r = t.r_begin + t.lane_r; r < t.r_end; r += kUnroll * rpp) {
      Pack<VEC> gv[kUnroll], xv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * rpp < t.r_end) {
          gv[u] = load<VEC>(dy + at(t, r + u * rpp, channels));
          xv[u] = load<VEC>(x + at(t, r + u * rpp, channels));
          if constexpr (MODE == kAddRelu) yv[u] = load<VEC>(y + at(t, r + u * rpp, channels));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * rpp >= t.r_end) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xj = bf(xv[u].s[j]);
          if constexpr (MODE == kRelu) {
            if (masked(xj, j)) gv[u].s[j] = 0;
          }
          if constexpr (MODE == kAddRelu) {
            if (bf(yv[u].s[j]) <= 0.0f) gv[u].s[j] = 0;
          }
          const float g = bf(gv[u].s[j]);
          sg[j] += g;
          sgx[j] = fmaf(g, xj - m[j], sgx[j]);
        }
        if constexpr (MODE == kAddRelu)
          store<VEC>(dresidual + at(t, r + u * rpp, channels), gv[u]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[j][threadIdx.x] = sg[j];
    red[VEC + j][threadIdx.x] = sgx[j];
  }
  block_partials<VEC>(red, t, ct, rpp, partial, channels);
  grid_barrier();

  // phase 2: dbias, dweight and the factors of dx, coef[0 | 1 | 2][c] =
  // mean(g), invstd^2 * mean(g * (x - mean)), invstd * weight
  channel_sums(partial, row_blocks, channels, [&](int c, double s, double sx) {
    const double n = (double)rows, iv = (double)save_invstd[c];
    dbias[c] = (float)s;
    dweight[c] = (float)(sx * iv);
    coef[c] = (float)(s / n);
    coef[channels + c] = (float)(iv * iv * sx / n);
    coef[2 * channels + c] = (float)(iv * (double)weight[c]);
  });
  grid_barrier();

  // phase 3: dx; mode 2 reads the g it wrote, mode 1 masks dy again
  if (!t.live) return;
  float k0[VEC], k1[VEC], k2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    k0[j] = coef[t.c0 + j];
    k1[j] = coef[channels + t.c0 + j];
    k2[j] = coef[2 * channels + t.c0 + j];
  }
  const unsigned short* g_in = MODE == kAddRelu ? dresidual : dy;
  for (int r = t.r_begin + t.lane_r; r < t.r_end; r += kUnroll * rpp) {
    Pack<VEC> gv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rpp < t.r_end) {
        gv[u] = load<VEC>(g_in + at(t, r + u * rpp, channels));
        xv[u] = load<VEC>(x + at(t, r + u * rpp, channels));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rpp >= t.r_end) break;
      Pack<VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xj = bf(xv[u].s[j]);
        float g = bf(gv[u].s[j]);
        if constexpr (MODE == kRelu) {
          if (masked(xj, j)) g = 0.0f;
        }
        o.s[j] = to_bf(((g - k0[j]) - (xj - m[j]) * k1[j]) * k2[j]);
      }
      store<VEC>(dx + at(t, r + u * rpp, channels), o);
    }
  }
}

// Launches `kernel` on `s` as a cooperative grid (every block resident, or
// the launch fails), which the grid barriers need.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) cudaGetLastError();  // take a refusal off this library's state
  return err;
}

template <int VEC, int MODE>
cudaError_t forward_mode(dim3 grid, cudaStream_t s, const unsigned short* x,
                         const unsigned short* residual, unsigned short* y, const float* weight,
                         const float* bias, float* running_mean, float* running_var,
                         long long* num_batches, float* save_mean, float* save_invstd,
                         double* partial, int rows, int channels, int ct, int rpp, int row_blocks,
                         int rows_per_block, double eps, double momentum) {
  return launch(batch_norm_act_forward_kernel<VEC, MODE>, grid, s, x, residual, y, weight, bias,
                running_mean, running_var, num_batches, save_mean, save_invstd, partial, rows,
                channels, ct, rpp, row_blocks, rows_per_block, eps, momentum);
}

template <int VEC, int MODE>
cudaError_t backward_mode(dim3 grid, cudaStream_t s, const unsigned short* dy,
                          const unsigned short* x, const unsigned short* y, unsigned short* dx,
                          unsigned short* dresidual, const float* weight, const float* bias,
                          const float* save_mean, const float* save_invstd, float* dweight,
                          float* dbias, float* partial, float* coef, int rows, int channels,
                          int ct, int rpp, int row_blocks, int rows_per_block) {
  return launch(batch_norm_act_backward_kernel<VEC, MODE>, grid, s, dy, x, y, dx, dresidual,
                weight, bias, save_mean, save_invstd, dweight, dbias, partial, coef, rows,
                channels, ct, rpp, row_blocks, rows_per_block);
}

bool valid_plan(int rows, int channels, int vec, int ct, int rpp, int row_blocks, int ch_blocks,
                int rows_per_block, int mode) {
  return (vec == 8 || vec == 1) && channels % vec == 0 && mode >= kPlain && mode <= kAddRelu &&
         rows > 1 && ct >= 1 && rpp >= 1 && ct * rpp <= kThreads && row_blocks >= 1 &&
         ch_blocks >= 1 && ch_blocks <= 65535 && (long long)ch_blocks * ct * vec >= channels &&
         rows_per_block >= 1 && (long long)row_blocks * rows_per_block >= rows;
}

}  // namespace

// The forward (one cooperative launch on `stream`, module comment): x,
// residual (mode 2, else null) and y are (rows, channels) bf16 in row-major
// order; weight, bias, the running statistics and save_mean/save_invstd
// (written) are `channels` float32; partial is 2 * row_blocks * channels
// double scratch. Returns the launch's CUDA error (a grid of more blocks
// than the card holds at once is refused), or cudaErrorInvalidValue for a
// plan the kernel does not take.
extern "C" int batch_norm_act_forward(const void* x, const void* residual, void* y,
                                      const void* weight, const void* bias, void* running_mean,
                                      void* running_var, void* num_batches_tracked,
                                      void* save_mean, void* save_invstd, void* partial, int rows,
                                      int channels, int vec, int ct, int rpp, int row_blocks,
                                      int ch_blocks, int rows_per_block, int mode, double eps,
                                      double momentum, void* stream) {
  if (!valid_plan(rows, channels, vec, ct, rpp, row_blocks, ch_blocks, rows_per_block, mode) ||
      (mode == kAddRelu) != (residual != nullptr))
    return (int)cudaErrorInvalidValue;
  using Fn = cudaError_t (*)(dim3, cudaStream_t, const unsigned short*, const unsigned short*,
                             unsigned short*, const float*, const float*, float*, float*,
                             long long*, float*, float*, double*, int, int, int, int, int, int,
                             double, double);
  static const Fn table[2][3] = {
      {forward_mode<8, kPlain>, forward_mode<8, kRelu>, forward_mode<8, kAddRelu>},
      {forward_mode<1, kPlain>, forward_mode<1, kRelu>, forward_mode<1, kAddRelu>}};
  return (int)table[vec == 8 ? 0 : 1][mode](
      dim3(row_blocks, ch_blocks), (cudaStream_t)stream, static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(residual), static_cast<unsigned short*>(y),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(running_mean), static_cast<float*>(running_var),
      static_cast<long long*>(num_batches_tracked), static_cast<float*>(save_mean),
      static_cast<float*>(save_invstd), static_cast<double*>(partial), rows, channels, ct, rpp,
      row_blocks, rows_per_block, eps, momentum);
}

// The backward (one cooperative launch on `stream`): dy, x, y (mode 2, else
// null), dx and dresidual (mode 2, else null; written) as the forward's
// tensors; dweight and dbias (written) `channels` float32; partial is
// 2 * row_blocks * channels float32 scratch; coef 3 * channels float32.
extern "C" int batch_norm_act_backward(const void* dy, const void* x, const void* y, void* dx,
                                       void* dresidual, const void* weight, const void* bias,
                                       const void* save_mean, const void* save_invstd,
                                       void* dweight, void* dbias, void* partial, void* coef,
                                       int rows, int channels, int vec, int ct, int rpp,
                                       int row_blocks, int ch_blocks, int rows_per_block,
                                       int mode, void* stream) {
  if (!valid_plan(rows, channels, vec, ct, rpp, row_blocks, ch_blocks, rows_per_block, mode) ||
      (mode == kAddRelu) != (y != nullptr) || (mode == kAddRelu) != (dresidual != nullptr))
    return (int)cudaErrorInvalidValue;
  using Fn = cudaError_t (*)(dim3, cudaStream_t, const unsigned short*, const unsigned short*,
                             const unsigned short*, unsigned short*, unsigned short*,
                             const float*, const float*, const float*, const float*, float*,
                             float*, float*, float*, int, int, int, int, int, int);
  static const Fn table[2][3] = {
      {backward_mode<8, kPlain>, backward_mode<8, kRelu>, backward_mode<8, kAddRelu>},
      {backward_mode<1, kPlain>, backward_mode<1, kRelu>, backward_mode<1, kAddRelu>}};
  return (int)table[vec == 8 ? 0 : 1][mode](
      dim3(row_blocks, ch_blocks), (cudaStream_t)stream, static_cast<const unsigned short*>(dy),
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(y),
      static_cast<unsigned short*>(dx), static_cast<unsigned short*>(dresidual),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(save_mean), static_cast<const float*>(save_invstd),
      static_cast<float*>(dweight), static_cast<float*>(dbias), static_cast<float*>(partial),
      static_cast<float*>(coef), rows, channels, ct, rpp, row_blocks, rows_per_block);
}
