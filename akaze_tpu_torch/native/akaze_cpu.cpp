// Single-core CPU AKAZE detect+describe — the measured reference baseline.
//
// BASELINE.md requires the reference single-core frames/s to be MEASURED on
// this machine (the reference mount was empty, SURVEY.md §0, and the
// reference is Rust which this image cannot build).  This is a faithful
// native implementation of the same behavioral spec the golden NumPy model
// (akaze_tpu/golden/akaze.py) implements — SURVEY.md §2 C1-C11 — so it
// plays the reference's role for the baseline protocol: a single-threaded
// native detect+describe(+match, see hamming.cpp) pipeline, parity-tested
// against the golden oracle.
//
// Deliberately single-threaded and straightforward (like the reference,
// SURVEY.md §1: "single-process, single-threaded CPU library"): -O3 and
// separable filters, no SIMD intrinsics, no threads.
//
// C ABI consumed via ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> d;
  Image() = default;
  Image(int h_, int w_) : h(h_), w(w_), d(static_cast<size_t>(h_) * w_) {}
  float& at(int y, int x) { return d[static_cast<size_t>(y) * w + x]; }
  float at(int y, int x) const { return d[static_cast<size_t>(y) * w + x]; }
};

inline int round_half_up(double x) { return static_cast<int>(std::floor(x + 0.5)); }
inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Correlate along y (axis 0) then x (axis 1), edge padding, f32 accumulate
// in tap order — mirrors golden/image.py separable_filter for parity
// (identical per-pixel accumulation order; zero taps skipped as there).
// Interior pixels take a clamp-free row-contiguous fast path so -O3 can
// vectorize; borders fall back to clamped indexing with the same tap order.
Image filter_y(const Image& img, const std::vector<float>& k) {
  int ks = static_cast<int>(k.size());
  int half = ks / 2;
  Image out(img.h, img.w);
  for (int y = 0; y < img.h; ++y) {
    float* orow = &out.d[static_cast<size_t>(y) * img.w];
    if (y >= half && y < img.h - half) {
      for (int t = 0; t < ks; ++t) {
        float wt = k[t];
        if (wt == 0.0f) continue;
        const float* irow = &img.d[static_cast<size_t>(y + t - half) * img.w];
        for (int x = 0; x < img.w; ++x) orow[x] += wt * irow[x];
      }
    } else {
      for (int x = 0; x < img.w; ++x) {
        float acc = 0.0f;
        for (int t = 0; t < ks; ++t) {
          if (k[t] == 0.0f) continue;
          int yy = clampi(y + t - half, 0, img.h - 1);
          acc += k[t] * img.at(yy, x);
        }
        orow[x] = acc;
      }
    }
  }
  return out;
}

Image filter_x(const Image& img, const std::vector<float>& k) {
  int ks = static_cast<int>(k.size());
  int half = ks / 2;
  Image out(img.h, img.w);
  int xin_end = img.w - half;
  for (int y = 0; y < img.h; ++y) {
    const float* irow = &img.d[static_cast<size_t>(y) * img.w];
    float* orow = &out.d[static_cast<size_t>(y) * img.w];
    for (int t = 0; t < ks; ++t) {
      float wt = k[t];
      if (wt == 0.0f) continue;
      const float* src = irow + (t - half);
      for (int x = half; x < xin_end; ++x) orow[x] += wt * src[x];
    }
    for (int x = 0; x < img.w; ++x) {
      if (x == half && half < xin_end) x = xin_end;  // skip interior span
      if (x >= img.w) break;
      float acc = 0.0f;
      for (int t = 0; t < ks; ++t) {
        if (k[t] == 0.0f) continue;
        int xx = clampi(x + t - half, 0, img.w - 1);
        acc += k[t] * irow[xx];
      }
      orow[x] = acc;
    }
  }
  return out;
}

Image separable(const Image& img, const std::vector<float>& kx,
                const std::vector<float>& ky) {
  Image tmp = filter_y(img, ky);
  return filter_x(tmp, kx);
}

std::vector<float> gaussian_kernel(double sigma) {
  // ksize = ceil(2*(1 + (sigma-0.8)/0.3)), odd, >= 3 (golden/image.py rule).
  int ksize = static_cast<int>(std::ceil(2.0 * (1.0 + (sigma - 0.8) / 0.3)));
  if (ksize % 2 == 0) ksize += 1;
  if (ksize < 3) ksize = 3;
  int half = ksize / 2;
  std::vector<double> kd(ksize);
  double sum = 0.0;
  for (int i = 0; i < ksize; ++i) {
    double x = i - half;
    kd[i] = std::exp(-(x * x) / (2.0 * sigma * sigma));
    sum += kd[i];
  }
  std::vector<float> k(ksize);
  for (int i = 0; i < ksize; ++i) k[i] = static_cast<float>(kd[i] / sum);
  return k;
}

Image gaussian_blur(const Image& img, double sigma) {
  auto k = gaussian_kernel(sigma);
  return separable(img, k, k);
}

Image half_size(const Image& img) {
  int h2 = img.h / 2, w2 = img.w / 2;
  Image out(h2, w2);
  for (int y = 0; y < h2; ++y)
    for (int x = 0; x < w2; ++x)
      out.at(y, x) = 0.25f * (img.at(2 * y, 2 * x) + img.at(2 * y + 1, 2 * x) +
                              img.at(2 * y, 2 * x + 1) +
                              img.at(2 * y + 1, 2 * x + 1));
  return out;
}

void scharr_kernels(int sigma_size, std::vector<float>& deriv,
                    std::vector<float>& smooth) {
  int ksize = 3 + 2 * (sigma_size - 1);
  double w = 10.0 / 3.0;
  double norm = 1.0 / (2.0 * sigma_size * (w + 2.0));
  deriv.assign(ksize, 0.0f);
  smooth.assign(ksize, 0.0f);
  deriv[0] = -1.0f;
  deriv[ksize - 1] = 1.0f;
  smooth[0] = smooth[ksize - 1] = static_cast<float>(norm);
  smooth[ksize / 2] = static_cast<float>(w * norm);
}

Image scharr(const Image& img, int x_order, int y_order, int sigma_size) {
  std::vector<float> deriv, smooth;
  scharr_kernels(sigma_size, deriv, smooth);
  if (x_order == 1) return separable(img, deriv, smooth);
  return separable(img, smooth, deriv);
}

// ---- FED tau schedule (core/fed.py formulas, SURVEY.md §2 C4) ----

bool fed_is_prime(int n) {
  if (n < 2) return false;
  if (n < 4) return true;
  if (n % 2 == 0) return false;
  for (int f = 3; f * f <= n; f += 2)
    if (n % f == 0) return false;
  return true;
}

std::vector<double> fed_tau_by_cycle_time(double t, double tau_max) {
  int n = static_cast<int>(
      std::ceil(std::sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1.0e-8));
  if (n <= 0) return {};
  double scale = 3.0 * t / (tau_max * n * (n + 1));
  double c = 1.0 / (4.0 * n + 2.0);
  double d = scale * tau_max / 2.0;
  std::vector<double> tauh(n);
  for (int j = 0; j < n; ++j) {
    double cs = std::cos(M_PI * (2 * j + 1) * c);
    tauh[j] = d / (cs * cs);
  }
  if (n == 1) return tauh;
  int kappa = n / 2;
  int prime = n + 1;
  while (!fed_is_prime(prime)) ++prime;
  std::vector<double> tau;
  tau.reserve(n);
  int k = 0;
  for (int i = 0; i < n; ++i) {
    int index;
    while (true) {
      index = ((k + 1) * kappa) % prime - 1;
      if (index < n) break;
      ++k;
    }
    tau.push_back(tauh[index]);
    ++k;
  }
  return tau;
}

struct Config {
  int num_octaves = 4;
  int num_sublevels = 4;
  double sigma0 = 1.6;
  double derivative_factor = 1.5;
  double detector_threshold = 1e-3;
  double contrast_percentile = 0.7;
  int contrast_nbins = 300;
  double contrast_fallback = 0.03;
  double contrast_octave_decay = 0.75;
  int diffusivity = 1;  // 0 = g1, 1 = g2, 2 = weickert
  double tau_max = 0.25;
  int min_octave_dim = 40;
  int pattern_size = 10;
  double border_smax = 10.0 * M_SQRT2;
};

struct Evolution {
  int index = 0, octave = 0, sublevel = 0;
  double esigma = 0.0, etime = 0.0;
  int width = 0, height = 0, sigma_size = 0, border = 0;
  std::vector<double> taus;
  Image Lt, Lsmooth, Lx, Ly, Ldet;
  int ratio() const { return 1 << octave; }
};

std::vector<Evolution> allocate_evolutions(int width, int height,
                                           const Config& cfg) {
  std::vector<Evolution> evs;
  double prev_etime = 0.0;
  int w = width, h = height;
  for (int octave = 0; octave < cfg.num_octaves; ++octave) {
    if (octave > 0 && (w < cfg.min_octave_dim || h < cfg.min_octave_dim)) break;
    for (int sub = 0; sub < cfg.num_sublevels; ++sub) {
      Evolution ev;
      ev.octave = octave;
      ev.sublevel = sub;
      ev.esigma = cfg.sigma0 *
                  std::pow(2.0, octave + static_cast<double>(sub) / cfg.num_sublevels);
      ev.etime = 0.5 * ev.esigma * ev.esigma;
      ev.sigma_size =
          round_half_up(ev.esigma * cfg.derivative_factor / (1 << octave));
      ev.border = round_half_up(cfg.border_smax * ev.sigma_size) + 1;
      ev.width = w;
      ev.height = h;
      ev.index = static_cast<int>(evs.size());
      if (ev.index > 0)
        ev.taus = fed_tau_by_cycle_time(ev.etime - prev_etime, cfg.tau_max);
      prev_etime = ev.etime;
      evs.push_back(std::move(ev));
    }
    w /= 2;
    h /= 2;
  }
  return evs;
}

double compute_contrast_factor(const Image& img, const Config& cfg) {
  Image sm = gaussian_blur(img, 1.0);
  Image lx = scharr(sm, 1, 0, 1);
  Image ly = scharr(sm, 0, 1, 1);
  double hmax = 0.0;
  for (int y = 1; y < img.h - 1; ++y)
    for (int x = 1; x < img.w - 1; ++x) {
      double m = std::sqrt(static_cast<double>(lx.at(y, x)) * lx.at(y, x) +
                           static_cast<double>(ly.at(y, x)) * ly.at(y, x));
      if (m > hmax) hmax = m;
    }
  if (hmax == 0.0) return cfg.contrast_fallback;
  std::vector<int64_t> hist(cfg.contrast_nbins, 0);
  int64_t npoints = 0;
  for (int y = 1; y < img.h - 1; ++y)
    for (int x = 1; x < img.w - 1; ++x) {
      // f32 magnitude to match the golden model's float32 modg.
      float m = std::sqrt(lx.at(y, x) * lx.at(y, x) + ly.at(y, x) * ly.at(y, x));
      if (m > 0.0f) {
        int b = static_cast<int>(std::floor(cfg.contrast_nbins * (m / hmax)));
        if (b >= cfg.contrast_nbins) b = cfg.contrast_nbins - 1;
        ++hist[b];
        ++npoints;
      }
    }
  double nthreshold = npoints * cfg.contrast_percentile;
  int64_t csum = 0;
  for (int i = 0; i < cfg.contrast_nbins; ++i) {
    csum += hist[i];
    if (csum >= nthreshold) return hmax * (i + 1) / cfg.contrast_nbins;
  }
  return cfg.contrast_fallback;
}

Image conductivity(const Image& lx, const Image& ly, double k, int kind) {
  Image g(lx.h, lx.w);
  float k2 = static_cast<float>(k * k);
  for (size_t i = 0; i < g.d.size(); ++i) {
    float grad2 = (lx.d[i] * lx.d[i] + ly.d[i] * ly.d[i]) / k2;
    float v;
    if (kind == 1) {  // pm_g2
      v = 1.0f / (1.0f + grad2);
    } else if (kind == 0) {  // pm_g1
      v = std::exp(-grad2);
    } else {  // weickert
      if (grad2 > 0.0f) {
        float g4 = grad2 * grad2;
        g4 = g4 * g4;
        v = 1.0f - std::exp(-3.315f / g4);
      } else {
        v = 1.0f;
      }
    }
    g.d[i] = v;
  }
  return g;
}

void diffusion_step(Image& lt, const Image& g, double tau) {
  // L += 0.5*tau * sum_n (g_c + g_n)(L_n - L_c), replicate borders.
  // Interior rows run clamp-free over contiguous neighbor rows (vectorizes);
  // border rows/columns use the same expression with clamped indices.
  Image out(lt.h, lt.w);
  float ht = static_cast<float>(0.5 * tau);
  int w = lt.w;
  auto edge = [&](int y, int x) {
    int ym = y > 0 ? y - 1 : 0, yp = y < lt.h - 1 ? y + 1 : lt.h - 1;
    int xm = x > 0 ? x - 1 : 0, xp = x < w - 1 ? x + 1 : w - 1;
    float c = lt.at(y, x), cg = g.at(y, x);
    float step = (cg + g.at(y, xp)) * (lt.at(y, xp) - c) +
                 (cg + g.at(y, xm)) * (lt.at(y, xm) - c) +
                 (cg + g.at(yp, x)) * (lt.at(yp, x) - c) +
                 (cg + g.at(ym, x)) * (lt.at(ym, x) - c);
    out.at(y, x) = c + ht * step;
  };
  for (int y = 0; y < lt.h; ++y) {
    if (y == 0 || y == lt.h - 1) {
      for (int x = 0; x < w; ++x) edge(y, x);
      continue;
    }
    const float* lc = &lt.d[static_cast<size_t>(y) * w];
    const float* lu = lc - w;
    const float* ld = lc + w;
    const float* gc = &g.d[static_cast<size_t>(y) * w];
    const float* gu = gc - w;
    const float* gd = gc + w;
    float* o = &out.d[static_cast<size_t>(y) * w];
    edge(y, 0);
    for (int x = 1; x < w - 1; ++x) {
      float c = lc[x], cg = gc[x];
      float step = (cg + gc[x + 1]) * (lc[x + 1] - c) +
                   (cg + gc[x - 1]) * (lc[x - 1] - c) +
                   (cg + gd[x]) * (ld[x] - c) +
                   (cg + gu[x]) * (lu[x] - c);
      o[x] = c + ht * step;
    }
    edge(y, w - 1);
  }
  lt = std::move(out);
}

void create_nonlinear_scale_space(const Image& img, const Config& cfg,
                                  std::vector<Evolution>& evs) {
  Image lt = gaussian_blur(img, cfg.sigma0);
  evs[0].Lt = lt;
  evs[0].Lsmooth = lt;
  double k = compute_contrast_factor(img, cfg);
  for (size_t i = 1; i < evs.size(); ++i) {
    Evolution& ev = evs[i];
    const Evolution& prev = evs[i - 1];
    if (ev.octave > prev.octave) {
      lt = half_size(prev.Lt);
      k *= cfg.contrast_octave_decay;
    } else {
      lt = prev.Lt;
    }
    ev.Lsmooth = gaussian_blur(lt, 1.0);
    Image lx = scharr(ev.Lsmooth, 1, 0, 1);
    Image ly = scharr(ev.Lsmooth, 0, 1, 1);
    Image g = conductivity(lx, ly, k, cfg.diffusivity);
    for (double tau : ev.taus) diffusion_step(lt, g, tau);
    ev.Lt = lt;
  }
}

void detector_response(std::vector<Evolution>& evs) {
  for (Evolution& ev : evs) {
    int s = ev.sigma_size;
    Image lx = scharr(ev.Lsmooth, 1, 0, s);
    Image ly = scharr(ev.Lsmooth, 0, 1, s);
    Image lxx = scharr(lx, 1, 0, s);
    Image lyy = scharr(ly, 0, 1, s);
    Image lxy = scharr(lx, 0, 1, s);
    float sf = static_cast<float>(s), s2 = sf * sf;
    ev.Lx = lx;
    ev.Ly = ly;
    for (size_t i = 0; i < lx.d.size(); ++i) {
      ev.Lx.d[i] = lx.d[i] * sf;
      ev.Ly.d[i] = ly.d[i] * sf;
    }
    ev.Ldet = Image(ev.height, ev.width);
    for (size_t i = 0; i < ev.Ldet.d.size(); ++i)
      ev.Ldet.d[i] =
          (lxx.d[i] * s2) * (lyy.d[i] * s2) - (lxy.d[i] * s2) * (lxy.d[i] * s2);
  }
}

struct Keypoint {
  double x = 0, y = 0;  // octave-0 coords
  float response = 0;
  double size = 0;
  int octave = 0, class_id = 0;
  double angle = 0;
};

// Sequential extrema + dedup + second pass + sub-pixel, mirroring the golden
// model's reference semantics exactly (golden/akaze.py
// find_scale_space_extrema / do_subpixel_refinement).
std::vector<Keypoint> find_scale_space_extrema(const std::vector<Evolution>& evs,
                                               const Config& cfg) {
  std::vector<Keypoint> aux;
  for (const Evolution& ev : evs) {
    const Image& ld = ev.Ldet;
    int border = ev.border;
    if (ev.height - 2 * border <= 0 || ev.width - 2 * border <= 0) continue;
    double size = ev.esigma * cfg.derivative_factor;
    double radius2 = (0.5 * size) * (0.5 * size);
    double ratio = ev.ratio();
    for (int y = border; y < ev.height - border; ++y) {
      for (int x = border; x < ev.width - border; ++x) {
        float v = ld.at(y, x);
        if (v <= cfg.detector_threshold) continue;
        bool is_max = true;
        for (int dy = -1; dy <= 1 && is_max; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            if (ld.at(y + dy, x + dx) >= v) {
              is_max = false;
              break;
            }
          }
        if (!is_max) continue;
        Keypoint point;
        point.x = x * ratio;
        point.y = y * ratio;
        point.response = v;
        point.size = size;
        point.octave = ev.octave;
        point.class_id = ev.index;
        bool is_extremum = true;
        int repeated_idx = -1;
        for (size_t idx = 0; idx < aux.size(); ++idx) {
          const Keypoint& other = aux[idx];
          if (other.class_id == ev.index || other.class_id == ev.index - 1) {
            double dx = point.x - other.x, dy = point.y - other.y;
            if (dx * dx + dy * dy <= radius2) {
              if (point.response > other.response)
                repeated_idx = static_cast<int>(idx);
              else
                is_extremum = false;
              break;
            }
          }
        }
        if (is_extremum) {
          if (repeated_idx >= 0)
            aux[static_cast<size_t>(repeated_idx)] = point;
          else
            aux.push_back(point);
        }
      }
    }
  }
  // Second pass: drop if a later-level (class_id+1) point within radius has
  // strictly greater response.
  std::vector<Keypoint> kept;
  for (size_t i = 0; i < aux.size(); ++i) {
    const Keypoint& p = aux[i];
    double radius2 = (0.5 * p.size) * (0.5 * p.size);
    bool repeated = false;
    for (size_t j = i + 1; j < aux.size(); ++j) {
      const Keypoint& o = aux[j];
      if (o.class_id == p.class_id + 1) {
        double dx = p.x - o.x, dy = p.y - o.y;
        if (dx * dx + dy * dy <= radius2 && p.response < o.response) {
          repeated = true;
          break;
        }
      }
    }
    if (!repeated) kept.push_back(p);
  }
  // Sub-pixel refinement.
  std::vector<Keypoint> out;
  for (const Keypoint& kp : kept) {
    const Evolution& ev = evs[kp.class_id];
    const Image& ld = ev.Ldet;
    double ratio = ev.ratio();
    int x = round_half_up(kp.x / ratio);
    int y = round_half_up(kp.y / ratio);
    double dx = 0.5 * (ld.at(y, x + 1) - ld.at(y, x - 1));
    double dy = 0.5 * (ld.at(y + 1, x) - ld.at(y - 1, x));
    double dxx = ld.at(y, x + 1) + ld.at(y, x - 1) - 2.0 * ld.at(y, x);
    double dyy = ld.at(y + 1, x) + ld.at(y - 1, x) - 2.0 * ld.at(y, x);
    double dxy = 0.25 * (ld.at(y + 1, x + 1) + ld.at(y - 1, x - 1) -
                         ld.at(y - 1, x + 1) - ld.at(y + 1, x - 1));
    double det = dxx * dyy - dxy * dxy;
    if (std::abs(det) < 1e-30) continue;
    double ox = (-dx * dyy + dy * dxy) / det;
    double oy = (-dy * dxx + dx * dxy) / det;
    if (std::abs(ox) > 1.0 || std::abs(oy) > 1.0) continue;
    Keypoint r = kp;
    r.x = (x + ox) * ratio;
    r.y = (y + oy) * ratio;
    out.push_back(r);
  }
  return out;
}

double compute_main_orientation(const Keypoint& kp,
                                const std::vector<Evolution>& evs) {
  const Evolution& ev = evs[kp.class_id];
  double ratio = ev.ratio();
  int s = round_half_up(0.5 * kp.size / ratio);
  if (s < 1) s = 1;
  double xf = kp.x / ratio, yf = kp.y / ratio;
  int h = ev.Lx.h, w = ev.Lx.w;
  std::vector<double> res_x, res_y, ang;
  for (int i = -6; i <= 6; ++i) {
    for (int j = -6; j <= 6; ++j) {
      if (i * i + j * j >= 36) continue;
      int ix = clampi(round_half_up(xf + i * s), 0, w - 1);
      int iy = clampi(round_half_up(yf + j * s), 0, h - 1);
      double gweight = std::exp(-(i * i + j * j) / (2.0 * 2.5 * 2.5));
      double rx = gweight * ev.Lx.at(iy, ix);
      double ry = gweight * ev.Ly.at(iy, ix);
      res_x.push_back(rx);
      res_y.push_back(ry);
      double a = std::fmod(std::atan2(ry, rx), 2.0 * M_PI);
      if (a < 0.0) a += 2.0 * M_PI;
      ang.push_back(a);
    }
  }
  double best_norm = -1.0, best_angle = 0.0;
  for (double ang1 = 0.0; ang1 < 2.0 * M_PI; ang1 += 0.15) {
    double ang2 = ang1 + M_PI / 3.0;
    bool wrap = ang2 > 2.0 * M_PI;
    if (wrap) ang2 -= 2.0 * M_PI;
    double sum_x = 0.0, sum_y = 0.0;
    for (size_t t = 0; t < ang.size(); ++t) {
      bool inside = !wrap ? (ang1 < ang[t] && ang[t] < ang2)
                          : (ang[t] > ang1 || ang[t] < ang2);
      if (inside) {
        sum_x += res_x[t];
        sum_y += res_y[t];
      }
    }
    double norm = sum_x * sum_x + sum_y * sum_y;
    if (norm > best_norm) {
      best_norm = norm;
      best_angle = std::fmod(std::atan2(sum_y, sum_x), 2.0 * M_PI);
      if (best_angle < 0.0) best_angle += 2.0 * M_PI;
    }
  }
  return best_angle;
}

void mldb_fill_values(const Keypoint& kp, const Evolution& ev, int sample_step,
                      double co, double si, int scale, int pattern_size,
                      std::vector<double>& values /* cells x 3 */) {
  double ratio = ev.ratio();
  double xf = kp.x / ratio, yf = kp.y / ratio;
  int h = ev.Lt.h, w = ev.Lt.w;
  values.clear();
  for (int i = -pattern_size; i < pattern_size; i += sample_step) {
    for (int j = -pattern_size; j < pattern_size; j += sample_step) {
      double di = 0.0, dx = 0.0, dy = 0.0;
      int nsamples = 0;
      for (int k = i; k < i + sample_step; ++k) {
        for (int l = j; l < j + sample_step; ++l) {
          double sample_y = yf + (l * co + k * si) * scale;
          double sample_x = xf + (-l * si + k * co) * scale;
          int y1 = clampi(round_half_up(sample_y), 0, h - 1);
          int x1 = clampi(round_half_up(sample_x), 0, w - 1);
          double ri = ev.Lt.at(y1, x1);
          double rx = ev.Lx.at(y1, x1);
          double ry = ev.Ly.at(y1, x1);
          di += ri;
          dx += rx * co + ry * si;
          dy += -rx * si + ry * co;
          ++nsamples;
        }
      }
      values.push_back(di / nsamples);
      values.push_back(dx / nsamples);
      values.push_back(dy / nsamples);
    }
  }
}

void get_mldb_descriptor(const Keypoint& kp, const std::vector<Evolution>& evs,
                         const Config& cfg, uint8_t* desc /* 61 bytes */) {
  const Evolution& ev = evs[kp.class_id];
  double ratio = ev.ratio();
  int scale = round_half_up(0.5 * kp.size / ratio);
  if (scale < 1) scale = 1;
  double co = std::cos(kp.angle), si = std::sin(kp.angle);
  int p = cfg.pattern_size;
  std::memset(desc, 0, 61);
  int dpos = 0;
  int steps[3] = {p, static_cast<int>(std::ceil(2.0 * p / 3.0)), p / 2};
  std::vector<double> values;
  for (int g = 0; g < 3; ++g) {
    mldb_fill_values(kp, ev, steps[g], co, si, scale, p, values);
    int count = static_cast<int>(values.size() / 3);
    for (int ch = 0; ch < 3; ++ch) {
      for (int a = 0; a < count; ++a) {
        for (int b = a + 1; b < count; ++b) {
          if (values[a * 3 + ch] > values[b * 3 + ch])
            desc[dpos >> 3] |= static_cast<uint8_t>(1u << (dpos & 7));
          ++dpos;
        }
      }
    }
  }
}

int extract_impl(const float* img_data, int h, int w, const Config& cfg,
                 int max_out, float* out_kps, uint8_t* out_desc) {
  Image img(h, w);
  std::memcpy(img.d.data(), img_data, sizeof(float) * img.d.size());
  std::vector<Evolution> evs = allocate_evolutions(w, h, cfg);
  create_nonlinear_scale_space(img, cfg, evs);
  detector_response(evs);
  std::vector<Keypoint> kps = find_scale_space_extrema(evs, cfg);
  int n = static_cast<int>(kps.size());
  if (n > max_out) n = max_out;
  for (int i = 0; i < n; ++i) {
    Keypoint& kp = kps[i];
    kp.angle = compute_main_orientation(kp, evs);
    if (out_kps) {
      float* o = out_kps + static_cast<size_t>(i) * 7;
      o[0] = static_cast<float>(kp.x);
      o[1] = static_cast<float>(kp.y);
      o[2] = kp.response;
      o[3] = static_cast<float>(kp.size);
      o[4] = static_cast<float>(kp.octave);
      o[5] = static_cast<float>(kp.class_id);
      o[6] = static_cast<float>(kp.angle);
    }
    if (out_desc) get_mldb_descriptor(kp, evs, cfg, out_desc + static_cast<size_t>(i) * 61);
  }
  return n;
}

Config config_from_args(int num_octaves, int num_sublevels, float sigma0,
                        float derivative_factor, float threshold,
                        float percentile, int nbins, float fallback,
                        float octave_decay, int diffusivity, float tau_max,
                        int min_octave_dim, int pattern_size) {
  Config cfg;
  cfg.num_octaves = num_octaves;
  cfg.num_sublevels = num_sublevels;
  cfg.sigma0 = sigma0;
  cfg.derivative_factor = derivative_factor;
  cfg.detector_threshold = threshold;
  cfg.contrast_percentile = percentile;
  cfg.contrast_nbins = nbins;
  cfg.contrast_fallback = fallback;
  cfg.contrast_octave_decay = octave_decay;
  cfg.diffusivity = diffusivity;
  cfg.tau_max = tau_max;
  cfg.min_octave_dim = min_octave_dim;
  cfg.pattern_size = pattern_size;
  return cfg;
}

}  // namespace

// Matcher shared with this translation unit via the hamming.cpp C symbol.
extern "C" int akaze_match_hamming(const uint32_t* a, int na, const uint32_t* b,
                                   int nb, int words, float ratio, int mutual,
                                   int max_distance, int32_t* out_idx,
                                   int32_t* out_dist, uint8_t* out_accepted);

extern "C" {

// Full single-core CPU AKAZE extract (detect + orient + describe).
// out_kps: max_out x 7 floats (x, y, response, size, octave, class_id, angle);
// out_desc: max_out x 61 bytes.  Returns the number of keypoints written.
int akaze_cpu_extract(const float* img, int h, int w, int num_octaves,
                      int num_sublevels, float sigma0, float derivative_factor,
                      float threshold, float percentile, int nbins,
                      float fallback, float octave_decay, int diffusivity,
                      float tau_max, int min_octave_dim, int pattern_size,
                      int max_out, float* out_kps, uint8_t* out_desc) {
  Config cfg = config_from_args(num_octaves, num_sublevels, sigma0,
                                derivative_factor, threshold, percentile, nbins,
                                fallback, octave_decay, diffusivity, tau_max,
                                min_octave_dim, pattern_size);
  return extract_impl(img, h, w, cfg, max_out, out_kps, out_desc);
}

// BASELINE.md measurement: single-core detect+describe+match over an
// image pair, reference config with the requested conductivity variant
// (0 = g1, 1 = g2 default, 2 = weickert) so each BASELINE.json config-3
// variant compares against a same-variant CPU baseline.  Returns seconds
// per frame (extract both + brute-force Hamming match, / 2 frames),
// averaged over `reps` repetitions.  This IS the reference baseline number —
// the same protocol the TPU headline metric uses (BASELINE.json config 1+2).
double akaze_cpu_bench_pipeline(const float* img_a, const float* img_b, int h,
                                int w, int reps, int diffusivity) {
  Config cfg;
  cfg.diffusivity = diffusivity;
  const int max_out = 4096;
  std::vector<float> kps_a(max_out * 7), kps_b(max_out * 7);
  std::vector<uint8_t> desc_a(max_out * 61), desc_b(max_out * 61);
  double total = 0.0;
  for (int r = 0; r < reps; ++r) {
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    int na = extract_impl(img_a, h, w, cfg, max_out, kps_a.data(), desc_a.data());
    int nb = extract_impl(img_b, h, w, cfg, max_out, kps_b.data(), desc_b.data());
    // Pack 61 bytes -> 16 little-endian uint32 words for the matcher.
    std::vector<uint32_t> pa(static_cast<size_t>(na) * 16, 0),
        pb(static_cast<size_t>(nb) * 16, 0);
    for (int i = 0; i < na; ++i)
      std::memcpy(&pa[static_cast<size_t>(i) * 16], &desc_a[static_cast<size_t>(i) * 61], 61);
    for (int i = 0; i < nb; ++i)
      std::memcpy(&pb[static_cast<size_t>(i) * 16], &desc_b[static_cast<size_t>(i) * 61], 61);
    std::vector<int32_t> idx(na), dist(na);
    std::vector<uint8_t> acc(na);
    if (na && nb)
      akaze_match_hamming(pa.data(), na, pb.data(), nb, 16, 0.8f, 1, 486,
                          idx.data(), dist.data(), acc.data());
    clock_gettime(CLOCK_MONOTONIC, &t1);
    total += (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
  }
  return total / (2.0 * reps);  // seconds per frame
}

}  // extern "C"
