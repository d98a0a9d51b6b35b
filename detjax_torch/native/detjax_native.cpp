// Native host-side kernels for detjax (SURVEY.md §2a).
//
// The reference's host-side native substrate is pycocotools' C/Cython
// evaluation core and cv2/libjpeg image ops; these are their detjax
// equivalents, exposed through a plain C ABI consumed via ctypes
// (detjax_torch/native/__init__.py; a copy of detjax/native/). Each
// function has a numpy twin in detjax_torch/evaluation/coco_map.py /
// detjax_torch/data/transforms.py that serves as the correctness oracle —
// results must match exactly (matching) or to rounding (resize).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (driven by detjax_torch.native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Pairwise IoU, COCO semantics: crowd GT divides by det area only
// (mirror of coco_map._iou_xyxy; pycocotools maskApi `iou`).
void detjax_iou_xyxy(const double* det, int64_t d_n,
                     const double* gt, int64_t g_n,
                     const uint8_t* iscrowd, double* out) {
  for (int64_t i = 0; i < d_n; ++i) {
    const double dx1 = det[i * 4 + 0], dy1 = det[i * 4 + 1];
    const double dx2 = det[i * 4 + 2], dy2 = det[i * 4 + 3];
    const double da =
        std::max(dx2 - dx1, 0.0) * std::max(dy2 - dy1, 0.0);
    for (int64_t j = 0; j < g_n; ++j) {
      const double gx1 = gt[j * 4 + 0], gy1 = gt[j * 4 + 1];
      const double gx2 = gt[j * 4 + 2], gy2 = gt[j * 4 + 3];
      const double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
      const double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
      const double inter = std::max(iw, 0.0) * std::max(ih, 0.0);
      const double ga =
          std::max(gx2 - gx1, 0.0) * std::max(gy2 - gy1, 0.0);
      const double denom = iscrowd[j] ? da : (da + ga - inter);
      out[i * g_n + j] = inter / std::max(denom, 1e-12);
    }
  }
}

// COCOeval.evaluateImg greedy matching over all IoU thresholds — exact
// mirror of coco_map._evaluate_img's triple loop, including the
// ignored-GT early break and the tie rule (equal IoU prefers later GT).
// Inputs are already GT-sorted (non-ignored first).
//   ious:   [d_n * g_n] row-major
//   dtm:    out [t_n * d_n], 1 + matched gt slot, 0 = unmatched
//   dt_ig:  out [t_n * d_n] detection-ignored flags
void detjax_match_image(const double* ious, const uint8_t* gt_ig,
                        const uint8_t* g_crowd, const double* det_areas,
                        double area_lo, double area_hi,
                        const double* iou_thrs, int64_t t_n,
                        int64_t d_n, int64_t g_n,
                        int64_t* dtm, uint8_t* dt_ig) {
  std::vector<int64_t> gtm(static_cast<size_t>(g_n));
  for (int64_t t = 0; t < t_n; ++t) {
    std::fill(gtm.begin(), gtm.end(), 0);
    for (int64_t d = 0; d < d_n; ++d) {
      double best = std::min(iou_thrs[t], 1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t g = 0; g < g_n; ++g) {
        if (gtm[static_cast<size_t>(g)] > 0 && !g_crowd[g]) continue;
        if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
        const double v = ious[d * g_n + g];
        if (v < best) continue;
        best = v;
        m = g;
      }
      const bool out_rng = det_areas[d] < area_lo || det_areas[d] > area_hi;
      if (m == -1) {
        dtm[t * d_n + d] = 0;
        dt_ig[t * d_n + d] = out_rng ? 1 : 0;
        continue;
      }
      dtm[t * d_n + d] = m + 1;
      dt_ig[t * d_n + d] = gt_ig[m] ? 1 : 0;
      if (!g_crowd[m]) gtm[static_cast<size_t>(m)] = d + 1;
    }
  }
}

// Bilinear resize for uint8 HWC images — BIT-IDENTICAL to PIL's
// Image.resize(..., Image.BILINEAR): the separable triangle filter with
// antialiasing on downscale (filter support scales with 1/scale), Pillow's
// fixed-point 8bpc arithmetic (PRECISION_BITS=22, round-half-away coeff
// quantization, clip8 with pre-added rounding bias), horizontal pass first
// with the intermediate quantized to uint8 — exactly Pillow Resample.c.
// Native replacement for the data loader's PIL resize hot path; parity is
// pinned per-bit in tests/test_native.py (up/downscale, random images).
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

inline uint8_t clip8(int v) {
  if (v >= (1 << (kPrecisionBits + 8))) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc for one axis.
// Returns ksize; fills bounds ([out*2]: xmin, count) and int coeffs
// ([out*ksize], fixed-point 2^22).
int64_t precompute_coeffs(int64_t in_size, int64_t out_size,
                          std::vector<int64_t>& bounds,
                          std::vector<int32_t>& kk_int) {
  const double scale = static_cast<double>(in_size) /
                       static_cast<double>(out_size);
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle support = 1.0
  const int64_t ksize = static_cast<int64_t>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size * 2), 0);
  std::vector<double> k(static_cast<size_t>(ksize));
  kk_int.assign(static_cast<size_t>(out_size * ksize), 0);
  const double ss = 1.0 / filterscale;
  for (int64_t xx = 0; xx < out_size; ++xx) {
    const double center = (static_cast<double>(xx) + 0.5) * scale;
    int64_t xmin = static_cast<int64_t>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = static_cast<int64_t>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int64_t x = 0; x < xmax; ++x) {
      const double w = triangle_filter(
          (static_cast<double>(x + xmin) - center + 0.5) * ss);
      k[static_cast<size_t>(x)] = w;
      ww += w;
    }
    for (int64_t x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[static_cast<size_t>(x)] /= ww;
      const double w = k[static_cast<size_t>(x)];
      // Pillow: round half away from zero into 2^22 fixed point
      kk_int[static_cast<size_t>(xx * ksize + x)] = static_cast<int32_t>(
          w < 0 ? -0.5 + w * (1 << kPrecisionBits)
                : 0.5 + w * (1 << kPrecisionBits));
    }
    bounds[static_cast<size_t>(xx * 2 + 0)] = xmin;
    bounds[static_cast<size_t>(xx * 2 + 1)] = xmax;
  }
  return ksize;
}

}  // namespace

void detjax_resize_bilinear_u8(const uint8_t* src, int64_t sh, int64_t sw,
                               int64_t c, uint8_t* dst, int64_t dh,
                               int64_t dw) {
  // Horizontal pass: [sh, sw, c] -> temp [sh, dw, c] (quantized uint8,
  // exactly Pillow's intermediate image), then vertical -> [dh, dw, c].
  std::vector<int64_t> hb, vb;
  std::vector<int32_t> hk, vk;
  const int64_t hks = precompute_coeffs(sw, dw, hb, hk);
  const int64_t vks = precompute_coeffs(sh, dh, vb, vk);

  std::vector<uint8_t> tmp(static_cast<size_t>(sh * dw * c));
  const int kInit = 1 << (kPrecisionBits - 1);  // rounding bias
  for (int64_t y = 0; y < sh; ++y) {
    const uint8_t* in_row = src + y * sw * c;
    uint8_t* out_row = tmp.data() + y * dw * c;
    for (int64_t xx = 0; xx < dw; ++xx) {
      const int64_t xmin = hb[static_cast<size_t>(xx * 2 + 0)];
      const int64_t xmax = hb[static_cast<size_t>(xx * 2 + 1)];
      const int32_t* k = hk.data() + xx * hks;
      for (int64_t b = 0; b < c; ++b) {
        int ss = kInit;
        for (int64_t x = 0; x < xmax; ++x)
          ss += in_row[(x + xmin) * c + b] * k[x];
        out_row[xx * c + b] = clip8(ss);
      }
    }
  }
  for (int64_t yy = 0; yy < dh; ++yy) {
    const int64_t ymin = vb[static_cast<size_t>(yy * 2 + 0)];
    const int64_t ymax = vb[static_cast<size_t>(yy * 2 + 1)];
    const int32_t* k = vk.data() + yy * vks;
    uint8_t* out_row = dst + yy * dw * c;
    for (int64_t xx = 0; xx < dw; ++xx) {
      for (int64_t b = 0; b < c; ++b) {
        int ss = kInit;
        for (int64_t y = 0; y < ymax; ++y)
          ss += tmp[static_cast<size_t>((y + ymin) * dw * c + xx * c + b)] *
                k[y];
        out_row[xx * c + b] = clip8(ss);
      }
    }
  }
}

}  // extern "C"
