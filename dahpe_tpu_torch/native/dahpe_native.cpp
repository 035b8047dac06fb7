// dahpe_tpu_torch native host-side data-loader core.
//
// The reference's input pipeline runs PIL (Python) inside DataLoader worker
// processes (train1.py:76-77). Here the per-image hot path — fused affine
// warp (rotation+crop+resize in one resample), bilinear square resize,
// ImageNet normalization, and Gaussian target rendering — is C++ behind a
// C ABI consumed via ctypes from the threaded BatchLoader. ctypes releases
// the GIL for the duration of each call, so Python worker threads scale
// across cores without worker processes.
//
// Build: dahpe_tpu_torch/utils/native.py compiles this file with
// g++ -O3 -march=native -ffast-math -shared -fPIC into build/native/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Fused affine warp: dst pixel p -> src = M @ (p + 0.5) + off - 0.5,
// bilinear sample with zero outside, then per-channel normalize
// (x/255 - mean) / std. src: H x W x 3 uint8, dst: out_h x out_w x 3 float.
// border_mode: 0 = zero outside the source, 1 = clamp to edge (PIL resize).
void affine_warp_u8_f32(const uint8_t* src, int h, int w,
                        const float* mat,   // 2x2 row-major
                        const float* off,   // 2
                        float* dst, int out_h, int out_w,
                        const float* mean, const float* stddev,
                        int border_mode) {
  const float m00 = mat[0], m01 = mat[1], m10 = mat[2], m11 = mat[3];
  const float inv_std[3] = {1.0f / stddev[0], 1.0f / stddev[1],
                            1.0f / stddev[2]};
  for (int oy = 0; oy < out_h; ++oy) {
    const float py = oy + 0.5f;
    for (int ox = 0; ox < out_w; ++ox) {
      const float px = ox + 0.5f;
      const float sx = m00 * px + m01 * py + off[0] - 0.5f;
      const float sy = m10 * px + m11 * py + off[1] - 0.5f;
      const int x0 = (int)std::floor(sx);
      const int y0 = (int)std::floor(sy);
      const float dx = sx - x0, dy = sy - y0;
      float acc[3] = {0.f, 0.f, 0.f};
      const float wgt[4] = {(1 - dx) * (1 - dy), dx * (1 - dy),
                            (1 - dx) * dy, dx * dy};
      const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
      const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
      for (int t = 0; t < 4; ++t) {
        int tx = xs[t], ty = ys[t];
        if (border_mode == 1) {
          tx = std::min(std::max(tx, 0), w - 1);
          ty = std::min(std::max(ty, 0), h - 1);
        } else if (tx < 0 || tx >= w || ty < 0 || ty >= h) {
          continue;
        }
        const uint8_t* p = src + (ty * (int64_t)w + tx) * 3;
        acc[0] += wgt[t] * p[0];
        acc[1] += wgt[t] * p[1];
        acc[2] += wgt[t] * p[2];
      }
      float* d = dst + (oy * (int64_t)out_w + ox) * 3;
      for (int c = 0; c < 3; ++c)
        d[c] = (acc[c] * (1.0f / 255.0f) - mean[c]) * inv_std[c];
    }
  }
}

// Square bilinear resize (align_corners=false / PIL-like box centers) +
// normalize: the eval path.
void resize_norm_u8_f32(const uint8_t* src, int h, int w, float* dst,
                        int out, const float* mean, const float* stddev) {
  const float mat[4] = {(float)w / out, 0.f, 0.f, (float)h / out};
  const float off[2] = {0.f, 0.f};
  affine_warp_u8_f32(src, h, w, mat, off, dst, out, out, mean, stddev, 1);
}

// Windowed Gaussian target rendering for K joints:
// out: K x H x W float zeroed by caller. mu: K x 2 ints (x, y).
// Matches uda/dataset/util.py:9-68 exactly (value exp(-d2 / (2 sigma^2))
// inside the square |dx|,|dy| <= reach).
void render_gaussian_f32(const int32_t* mu, const float* valid, int K,
                         int H, int W, float sigma, int reach, float* out) {
  const float inv = 1.0f / (2.0f * sigma * sigma);
  for (int k = 0; k < K; ++k) {
    float* plane = out + (int64_t)k * H * W;
    std::memset(plane, 0, sizeof(float) * H * W);
    if (valid[k] <= 0.5f) continue;
    const int mx = mu[2 * k], my = mu[2 * k + 1];
    const int y_lo = std::max(0, my - reach), y_hi = std::min(H - 1, my + reach);
    const int x_lo = std::max(0, mx - reach), x_hi = std::min(W - 1, mx + reach);
    for (int y = y_lo; y <= y_hi; ++y) {
      const int dy2 = (y - my) * (y - my);
      for (int x = x_lo; x <= x_hi; ++x) {
        const int d2 = (x - mx) * (x - mx) + dy2;
        plane[y * (int64_t)W + x] = std::exp(-d2 * inv);
      }
    }
  }
}

// Batched PCK distance computation (eval hot path when run host-side):
// preds/target: B x K x 2; norm: B x 2; dists out: K x B (-1 invalid).
void calc_dists_f32(const float* preds, const float* target,
                    const float* norm, int B, int K, float* dists) {
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < K; ++k) {
      const float tx = target[(b * K + k) * 2], ty = target[(b * K + k) * 2 + 1];
      float* d = dists + (int64_t)k * B + b;
      if (tx > 1.f && ty > 1.f) {
        const float nx = norm[b * 2], ny = norm[b * 2 + 1];
        const float ddx = (preds[(b * K + k) * 2] - tx) / nx;
        const float ddy = (preds[(b * K + k) * 2 + 1] - ty) / ny;
        *d = std::sqrt(ddx * ddx + ddy * ddy);
      } else {
        *d = -1.f;
      }
    }
  }
}

}  // extern "C"

extern "C" {

// Fully fused train-time augmentation for one image:
// affine warp (raw pixels) -> color jitter (ops in given order) ->
// separable 5-tap Gaussian blur -> ImageNet normalize.
// jitter_ops: op ids (0=brightness, 1=contrast, 2=saturation), n_jitter of
// them, each with jitter_factors[i]. blur_sigma <= 0 disables blur.
void augment_u8_f32(const uint8_t* src, int h, int w,
                    const float* mat, const float* off,
                    const int32_t* jitter_ops, const float* jitter_factors,
                    int n_jitter, float blur_sigma,
                    float* dst, int out, const float* mean,
                    const float* stddev, float* tmp /* out*out*3 scratch */) {
  const float raw_mean[3] = {0.f, 0.f, 0.f};
  const float raw_std[3] = {1.f / 255.f, 1.f / 255.f, 1.f / 255.f};
  affine_warp_u8_f32(src, h, w, mat, off, tmp, out, out, raw_mean, raw_std, 0);
  const int64_t n = (int64_t)out * out;

  for (int t = 0; t < n_jitter; ++t) {
    const float f = jitter_factors[t];
    const float g = 1.0f - f;
    switch (jitter_ops[t]) {
      case 0:  // brightness
        for (int64_t i = 0; i < n * 3; ++i)
          tmp[i] = std::min(std::max(tmp[i] * f, 0.f), 255.f);
        break;
      case 1: {  // contrast: blend with mean gray
        double acc = 0.0;
        for (int64_t i = 0; i < n; ++i)
          acc += 0.299f * tmp[i * 3] + 0.587f * tmp[i * 3 + 1] +
                 0.114f * tmp[i * 3 + 2];
        const float gray = (float)(acc / n) * g;
        for (int64_t i = 0; i < n * 3; ++i)
          tmp[i] = std::min(std::max(tmp[i] * f + gray, 0.f), 255.f);
        break;
      }
      case 2:  // saturation: blend with per-pixel gray
        for (int64_t i = 0; i < n; ++i) {
          const float gray = (0.299f * tmp[i * 3] + 0.587f * tmp[i * 3 + 1] +
                              0.114f * tmp[i * 3 + 2]) * g;
          for (int c = 0; c < 3; ++c)
            tmp[i * 3 + c] =
                std::min(std::max(tmp[i * 3 + c] * f + gray, 0.f), 255.f);
        }
        break;
    }
  }

  if (blur_sigma > 1e-2f) {
    const int r = 2;
    float k[2 * r + 1];
    float ksum = 0.f;
    for (int t = -r; t <= r; ++t) {
      k[t + r] = std::exp(-(float)(t * t) /
                          (2.f * std::max(blur_sigma, 1e-3f) *
                           std::max(blur_sigma, 1e-3f)));
      ksum += k[t + r];
    }
    for (int t = 0; t < 2 * r + 1; ++t) k[t] /= ksum;
    // horizontal pass tmp -> dst (edge clamped)
    for (int y = 0; y < out; ++y)
      for (int x = 0; x < out; ++x)
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
          for (int t = -r; t <= r; ++t) {
            const int xx = std::min(std::max(x + t, 0), out - 1);
            acc += k[t + r] * tmp[((int64_t)y * out + xx) * 3 + c];
          }
          dst[((int64_t)y * out + x) * 3 + c] = acc;
        }
    // vertical pass dst -> tmp
    for (int y = 0; y < out; ++y)
      for (int x = 0; x < out; ++x)
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
          for (int t = -r; t <= r; ++t) {
            const int yy = std::min(std::max(y + t, 0), out - 1);
            acc += k[t + r] * dst[((int64_t)yy * out + x) * 3 + c];
          }
          tmp[((int64_t)y * out + x) * 3 + c] = acc;
        }
  }

  const float inv_std[3] = {1.f / stddev[0], 1.f / stddev[1], 1.f / stddev[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c)
      dst[i * 3 + c] =
          (tmp[i * 3 + c] * (1.f / 255.f) - mean[c]) * inv_std[c];
}

}  // extern "C"
