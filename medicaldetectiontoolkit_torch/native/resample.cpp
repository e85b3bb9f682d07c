// Host-side augmentation kernels: the input-pipeline hot path that feeds the
// card during training. The port's copy of
// medicaldetectiontoolkit_tpu/native/resample.cpp, with the same ABI and the
// same code. scipy's map_coordinates/gaussian_filter (float64, per-call
// Python overhead) cap a worker at a few augmented 128^3 patches/s; these
// fused float32 loops with OpenMP across grid lines remove that ceiling.
//
// Semantics mirror scipy.ndimage exactly (pinned by
// tests/test_torch_native.py):
//   * resample_linear_f32  == map_coordinates(order=1, mode='constant', cval)
//     - each of the 2^dim corner neighbors outside the volume contributes cval
//   * resample_nearest_u8  == map_coordinates(order=0, mode='constant', cval=0)
//     - scipy rounds with floor(c + 0.5); out-of-range -> cval
//   * gaussian_f64         == gaussian_filter(sigma, mode='constant', cval=0)
//     - separable FIR, radius = int(truncate*sigma + 0.5), normalized kernel,
//       symmetric-pair accumulation like scipy's correlate1d
//
// Built at first use by native/__init__.py (g++ -O3 -march=native -fPIC
// -fopenmp -shared) and loaded through ctypes; no pybind11 dependency.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// --- order-1 (bi/trilinear) resample, constant border ---------------------
// src: (n0[,n1[,n2]]) float32; coords: (dim, npts) float64; out: (npts,) f32
void resample_linear_f32(const float *src, const int64_t *shape, int dim,
                         const double *coords, int64_t npts, float cval,
                         float *out) {
  const int64_t n0 = shape[0];
  const int64_t n1 = dim > 1 ? shape[1] : 1;
  const int64_t n2 = dim > 2 ? shape[2] : 1;
  const int64_t s0 = n1 * n2, s1 = n2;

#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < npts; ++p) {
    const int64_t n[3] = {n0, n1, n2};
    double c[3] = {0.0, 0.0, 0.0};
    // scipy 'constant': NO interpolation beyond the edges — a raw
    // coordinate outside [0, n-1] on any axis yields cval outright
    bool outside = false;
    for (int d = 0; d < dim; ++d) {
      c[d] = coords[(int64_t)d * npts + p];
      if (c[d] < 0.0 || c[d] > (double)(n[d] - 1)) outside = true;
    }
    if (outside) {
      out[p] = cval;
      continue;
    }
    int64_t f[3];
    double t[3];
    for (int d = 0; d < dim; ++d) {
      double fl = std::floor(c[d]);
      f[d] = (int64_t)fl;
      t[d] = c[d] - fl;
    }
    double acc = 0.0;
    const int corners = 1 << dim;
    for (int m = 0; m < corners; ++m) {
      double w = 1.0;
      int64_t idx[3] = {0, 0, 0};
      bool valid = true;
      for (int d = 0; d < dim; ++d) {
        const int hi = (m >> d) & 1;
        w *= hi ? t[d] : 1.0 - t[d];
        idx[d] = f[d] + hi;
        if (idx[d] < 0 || idx[d] >= n[d]) valid = false;  // e.g. c == n-1
      }
      if (w != 0.0 && valid)
        acc += w * (double)src[idx[0] * s0 + idx[1] * s1 + idx[2]];
    }
    out[p] = (float)acc;
  }
}

// --- order-0 (nearest) resample for uint8 seg, constant border ------------
void resample_nearest_u8(const uint8_t *src, const int64_t *shape, int dim,
                         const double *coords, int64_t npts, uint8_t cval,
                         uint8_t *out) {
  const int64_t n0 = shape[0];
  const int64_t n1 = dim > 1 ? shape[1] : 1;
  const int64_t n2 = dim > 2 ? shape[2] : 1;
  const int64_t s0 = n1 * n2, s1 = n2;
  const int64_t n[3] = {n0, n1, n2};

#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < npts; ++p) {
    int64_t idx[3] = {0, 0, 0};
    bool inside = true;
    for (int d = 0; d < dim; ++d) {
      // scipy 'constant': the RAW coordinate must lie in [0, n-1]
      // (2.49 in a length-3 axis is cval, even though it rounds to 2);
      // inside, round half up (floor(c + 0.5))
      const double c = coords[(int64_t)d * npts + p];
      if (c < 0.0 || c > (double)(n[d] - 1)) inside = false;
      idx[d] = (int64_t)std::floor(c + 0.5);
    }
    out[p] = inside ? src[idx[0] * s0 + idx[1] * s1 + idx[2]] : cval;
  }
}

// --- separable gaussian smoothing, float64, constant-0 border -------------
// In-place on buf (n0[,n1[,n2]]). Matches scipy.ndimage.gaussian_filter
// (truncate=4.0 default) including the symmetric-pair accumulation order.
static void gauss_kernel(double sigma, double truncate, std::vector<double> &k) {
  const int radius = (int)(truncate * sigma + 0.5);
  k.assign(radius + 1, 0.0);  // k[0]=center .. k[radius]
  double sum = 0.0;
  const double denom = -0.5 / (sigma * sigma);
  for (int i = 0; i <= radius; ++i) {
    k[i] = std::exp(denom * (double)i * (double)i);
    sum += (i == 0) ? k[i] : 2.0 * k[i];
  }
  for (int i = 0; i <= radius; ++i) k[i] /= sum;
}

static void smooth_axis(double *buf, int64_t nlines, int64_t n, int64_t stride,
                        int64_t line_stride_outer, int64_t inner,
                        const std::vector<double> &k) {
  const int radius = (int)k.size() - 1;
#pragma omp parallel
  {
    // gather each line contiguous (+ zero apron) first: the FIR then runs
    // branch-free over unit-stride data regardless of the axis stride
    std::vector<double> in(n + 2 * radius, 0.0);
    std::vector<double> tmp(n);
#pragma omp for schedule(static)
    for (int64_t li = 0; li < nlines; ++li) {
      // line li: decompose into (outer, inner) so lines cover the axis
      const int64_t o = li / inner, r = li % inner;
      double *line = buf + o * line_stride_outer + r;
      for (int64_t i = 0; i < n; ++i) in[radius + i] = line[i * stride];
      const double *x = in.data() + radius;
      // tap-outer / element-inner: each j-pass is a unit-stride FMA loop the
      // compiler vectorizes (AVX-512: 8 f64/lane). Accumulation order per
      // element differs from scipy's tap-inner loop only in f64 rounding
      // (parity pinned at rtol 1e-10).
      for (int64_t i = 0; i < n; ++i) tmp[i] = k[0] * x[i];
      for (int j = 1; j <= radius; ++j) {
        const double kj = k[j];
        const double *lo = x - j, *hi = x + j;
        for (int64_t i = 0; i < n; ++i) tmp[i] += kj * (lo[i] + hi[i]);
      }
      for (int64_t i = 0; i < n; ++i) line[i * stride] = tmp[i];
    }
  }
}

void gaussian_f64(double *buf, const int64_t *shape, int dim, double sigma,
                  double truncate) {
  std::vector<double> k;
  gauss_kernel(sigma, truncate, k);
  const int64_t n0 = shape[0];
  const int64_t n1 = dim > 1 ? shape[1] : 1;
  const int64_t n2 = dim > 2 ? shape[2] : 1;
  // axis 0: lines over (n1*n2), stride n1*n2
  smooth_axis(buf, n1 * n2, n0, n1 * n2, 0, n1 * n2, k);
  if (dim > 1)  // axis 1: outer n0 (stride n1*n2), inner n2, stride n2
    smooth_axis(buf, n0 * n2, n1, n2, n1 * n2, n2, k);
  if (dim > 2)  // axis 2: outer n0*n1 (stride n2), inner 1, stride 1
    smooth_axis(buf, n0 * n1, n2, 1, n2, 1, k);
}

// --- fused sampling-grid construction -------------------------------------
// out[d, p] = center_in[d] + scale * sum_e rot[d,e] * (grid_e(p) - c_e + E[e,p])
// where grid_e(p) is the row-major index grid over `patch`, c_e its center,
// E the (optional) smoothed elastic displacement (already * alpha).
// Replaces the NumPy meshgrid/stack/matmul temporaries (~25 MB x several
// passes per 128^3 patch) with one fused pass.
void build_coords_f64(const double *E, const double *rot, double scale,
                      const int64_t *patch, int dim, const double *center_in,
                      double *out) {
  const int64_t p0 = patch[0];
  const int64_t p1 = dim > 1 ? patch[1] : 1;
  const int64_t p2 = dim > 2 ? patch[2] : 1;
  const int64_t npts = p0 * p1 * p2;
  double c[3] = {0.0, 0.0, 0.0};
  for (int d = 0; d < dim; ++d) c[d] = (double)(patch[d] - 1) / 2.0;

#pragma omp parallel for schedule(static)
  for (int64_t i0 = 0; i0 < p0; ++i0) {
    for (int64_t i1 = 0; i1 < p1; ++i1) {
      const int64_t base = (i0 * p1 + i1) * p2;
      for (int64_t i2 = 0; i2 < p2; ++i2) {
        const int64_t p = base + i2;
        double g[3] = {(double)i0 - c[0], (double)i1 - c[1], (double)i2 - c[2]};
        if (E != nullptr)
          for (int e = 0; e < dim; ++e) g[e] += E[(int64_t)e * npts + p];
        for (int d = 0; d < dim; ++d) {
          double acc = 0.0;
          for (int e = 0; e < dim; ++e) acc += rot[d * dim + e] * g[e];
          out[(int64_t)d * npts + p] = center_in[d] + scale * acc;
        }
      }
    }
  }
}

int native_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
