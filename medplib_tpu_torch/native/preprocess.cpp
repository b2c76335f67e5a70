// Native host-side image preprocessing for the data loader: the port's
// own copy of medplib_tpu/native/preprocess.cpp, unchanged in its code (the
// port imports nothing of the JAX package).
//
// C++ counterpart of data/preprocess.py's hot path, the per-sample work of
// the original training data loader. One call fuses: triangle-filter
// (PIL-BILINEAR-compatible) resize of the longest side, center padding,
// and channelwise normalization for both the SAM (normalize-then-pad-zero)
// and CLIP (pad-mean-then-normalize) recipes.
//
// Exposed as a C ABI for ctypes. medplib_tpu_torch/native/__init__.py
// builds it at first use:
//   g++ -O3 -march=native -shared -fPIC preprocess.cpp -o <build dir>/...

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// PIL-style separable triangle-filter resampling weights for one axis.
struct AxisWeights {
  std::vector<int> bounds_lo;   // first source index per output pixel
  std::vector<int> counts;      // number of taps
  std::vector<float> weights;   // taps, normalized, row-major [out][max_taps]
  int max_taps = 0;
};

AxisWeights compute_weights(int in_size, int out_size) {
  AxisWeights aw;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = filterscale;  // triangle filter support = 1.0
  aw.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  aw.bounds_lo.resize(out_size);
  aw.counts.resize(out_size);
  aw.weights.assign(static_cast<size_t>(out_size) * aw.max_taps, 0.f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    double total = 0.0;
    std::vector<double> w(hi - lo);
    for (int k = lo; k < hi; ++k) {
      const double x = (k - center + 0.5) / filterscale;
      const double v = (std::abs(x) < 1.0) ? 1.0 - std::abs(x) : 0.0;
      w[k - lo] = v;
      total += v;
    }
    aw.bounds_lo[i] = lo;
    aw.counts[i] = hi - lo;
    for (int k = 0; k < hi - lo; ++k) {
      aw.weights[static_cast<size_t>(i) * aw.max_taps + k] =
          static_cast<float>(total > 0 ? w[k] / total : 0.0);
    }
  }
  return aw;
}

// Separable resize, float accumulation, channels-last [H, W, C].
void resize_bilinear(const uint8_t* src, int h, int w, int c,
                     float* dst, int oh, int ow) {
  AxisWeights wx = compute_weights(w, ow);
  AxisWeights wy = compute_weights(h, oh);
  // horizontal pass: [h, ow, c]
  std::vector<float> tmp(static_cast<size_t>(h) * ow * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * c;
    for (int x = 0; x < ow; ++x) {
      const int lo = wx.bounds_lo[x];
      const int n = wx.counts[x];
      const float* wgt = &wx.weights[static_cast<size_t>(x) * wx.max_taps];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) {
          acc += wgt[k] * row[(lo + k) * c + ch];
        }
        tmp[(static_cast<size_t>(y) * ow + x) * c + ch] = acc;
      }
    }
  }
  // vertical pass
  for (int y = 0; y < oh; ++y) {
    const int lo = wy.bounds_lo[y];
    const int n = wy.counts[y];
    const float* wgt = &wy.weights[static_cast<size_t>(y) * wy.max_taps];
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) {
          acc += wgt[k] * tmp[(static_cast<size_t>(lo + k) * ow + x) * c + ch];
        }
        dst[(static_cast<size_t>(y) * ow + x) * c + ch] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Longest-side resize to `target`, writing the resized float image and its
// dims. Returns 0 on success.
int pp_resize_longest(const uint8_t* src, int h, int w, int c, int target,
                      float* dst, int* out_h, int* out_w) {
  const double scale = static_cast<double>(target) / std::max(h, w);
  const int nh = static_cast<int>(h * scale + 0.5);
  const int nw = static_cast<int>(w * scale + 0.5);
  *out_h = nh;
  *out_w = nw;
  resize_bilinear(src, h, w, c, dst, nh, nw);
  return 0;
}

// SAM recipe: resize-longest, normalize with mean/std, center-pad zeros to
// [size, size, 3]. dst must hold size*size*3 floats.
int pp_sam_preprocess(const uint8_t* src, int h, int w, int size,
                      const float* mean, const float* std_,
                      float* dst, int* resize_h, int* resize_w) {
  std::vector<float> resized(static_cast<size_t>(size) * size * 3);
  int nh, nw;
  pp_resize_longest(src, h, w, 3, size, resized.data(), &nh, &nw);
  *resize_h = nh;
  *resize_w = nw;
  std::memset(dst, 0, static_cast<size_t>(size) * size * 3 * sizeof(float));
  const int top = (size - nh) / 2, left = (size - nw) / 2;
  for (int y = 0; y < nh; ++y) {
    for (int x = 0; x < nw; ++x) {
      for (int ch = 0; ch < 3; ++ch) {
        const float v = resized[(static_cast<size_t>(y) * nw + x) * 3 + ch];
        dst[((static_cast<size_t>(y + top)) * size + (x + left)) * 3 + ch] =
            (v - mean[ch]) / std_[ch];
      }
    }
  }
  return 0;
}

// CLIP recipe: resize-longest, center-pad with int-truncated mean*255, then
// rescale 1/255 and normalize.
int pp_clip_preprocess(const uint8_t* src, int h, int w, int size,
                       const float* mean, const float* std_, float* dst) {
  std::vector<float> resized(static_cast<size_t>(size) * size * 3);
  int nh, nw;
  pp_resize_longest(src, h, w, 3, size, resized.data(), &nh, &nw);
  const int top = (size - nh) / 2, left = (size - nw) / 2;
  float pad[3];
  for (int ch = 0; ch < 3; ++ch) {
    pad[ch] = std::min(255.f, std::max(0.f,
        std::trunc(mean[ch] * 255.f)));  // CLIP_PAD_VALUE semantics
  }
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      for (int ch = 0; ch < 3; ++ch) {
        float v;
        if (y >= top && y < top + nh && x >= left && x < left + nw) {
          v = resized[(static_cast<size_t>(y - top) * nw + (x - left)) * 3 +
                      ch];
        } else {
          v = pad[ch];
        }
        dst[(static_cast<size_t>(y) * size + x) * 3 + ch] =
            (v / 255.f - mean[ch]) / std_[ch];
      }
    }
  }
  return 0;
}

// Sparse mask encode: write nonzero (y, x) pairs; returns count (capped).
int pp_encode_sparse_mask(const uint8_t* mask, int h, int w,
                          int32_t* coords, int max_coords) {
  int n = 0;
  for (int y = 0; y < h && n < max_coords; ++y) {
    for (int x = 0; x < w && n < max_coords; ++x) {
      if (mask[static_cast<size_t>(y) * w + x]) {
        coords[2 * n] = y;
        coords[2 * n + 1] = x;
        ++n;
      }
    }
  }
  return n;
}

}  // extern "C"
