// Native spherical-harmonics density-field generator (host code).
//
// The on-the-fly SphericalHarmonicDataset computes one field per sample on
// the host (reference synthetic.py:81-124 calls scipy.special.sph_harm per
// sample): this C++ implementation computes the same field —
// |Y_l^m(theta, phi) * r| after the reference's complex lexicographic
// min-max normalisation — several times faster than the scipy path and with
// no Python-object overhead in the inner loop. It is the same source as the
// JAX package's rho_diffusion_tpu/native/ylm.cpp, built with the same flags,
// so both packages' native fields agree bitwise.
//
// Math (legacy scipy convention, matching the reference's call
// sph_harm(|m|, l, theta, phi) where theta is used as the azimuthal and phi
// as the polar argument):
//   Y_l^m(theta, phi) = K_lm * P_l^m(cos(phi)) * exp(i m theta)
//   K_lm = sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!)
// with Condon-Shortley phase inside P_l^m (upward recurrence).
//
// Build (rho_diffusion_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -o build/native/libylm-<hash>.so ylm.cpp
// ABI: plain C, driven through ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Associated Legendre P_l^m(x) with Condon-Shortley phase, m >= 0.
double legendre_plm(int l, int m, double x) {
    // P_m^m = (-1)^m (2m-1)!! (1 - x^2)^{m/2}
    double pmm = 1.0;
    if (m > 0) {
        double somx2 = std::sqrt((1.0 - x) * (1.0 + x));
        double fact = 1.0;
        for (int i = 1; i <= m; ++i) {
            pmm *= -fact * somx2;
            fact += 2.0;
        }
    }
    if (l == m) return pmm;
    // P_{m+1}^m = x (2m+1) P_m^m
    double pmmp1 = x * (2.0 * m + 1.0) * pmm;
    if (l == m + 1) return pmmp1;
    double pll = 0.0;
    for (int ll = m + 2; ll <= l; ++ll) {
        pll = (x * (2.0 * ll - 1.0) * pmmp1 - (ll + m - 1.0) * pmm) /
              (ll - m);
        pmm = pmmp1;
        pmmp1 = pll;
    }
    return pll;
}

double norm_klm(int l, int m) {
    // sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!) via a running product to avoid
    // factorial overflow
    double ratio = 1.0;
    for (int k = l - m + 1; k <= l + m; ++k) ratio /= static_cast<double>(k);
    return std::sqrt((2.0 * l + 1.0) / (4.0 * M_PI) * ratio);
}

}  // namespace

extern "C" {

// Compute the reference-normalised |Y_lm * r| field on the cartesian
// meshgrid of (x, y, z) 1-D axes (numpy meshgrid indexing="xy" semantics:
// grid[i][j][k] pairs (x_j, y_i, z_k)).
// out must hold n^3 floats. Returns 0 on success.
int ylm_field_ex(const double* xs, const double* ys, const double* zs, int n,
                 int l, int m_signed, int normalize, float* out) {
    if (l < 0 || n <= 0) return 1;
    const int m = m_signed < 0 ? -m_signed : m_signed;
    if (m > l) return 2;
    const double klm = norm_klm(l, m);
    const int64_t total = static_cast<int64_t>(n) * n * n;

    std::vector<double> re(total), im(total);
    // lexicographic (re, then im) min/max, replicating numpy's complex
    // ordering used by the reference's min-max normalisation
    double min_re = 0, min_im = 0, max_re = 0, max_im = 0;
    bool first = true;

    int64_t idx = 0;
    for (int i = 0; i < n; ++i) {        // y index (meshgrid "xy")
        const double y = ys[i];
        for (int j = 0; j < n; ++j) {    // x index
            const double x = xs[j];
            const double rho = std::sqrt(x * x + y * y);
            const double phi_az = std::atan(y / x);   // reference's phi
            for (int k = 0; k < n; ++k, ++idx) {      // z index
                const double z = zs[k];
                const double theta = std::atan(rho / z);  // reference theta
                const double r = std::sqrt(x * x + y * y + z * z);
                // legacy sph_harm(theta=azimuth, phi=polar):
                //   exp(i m theta) * P_l^m(cos(phi))
                const double plm = legendre_plm(l, m, std::cos(phi_az));
                const double mag = klm * plm * r;
                const double vr = mag * std::cos(m * theta);
                const double vi = mag * std::sin(m * theta);
                re[idx] = vr;
                im[idx] = vi;
                if (first || vr < min_re || (vr == min_re && vi < min_im)) {
                    min_re = vr;
                    min_im = vi;
                }
                if (first || vr > max_re || (vr == max_re && vi > max_im)) {
                    max_re = vr;
                    max_im = vi;
                }
                first = false;
            }
        }
    }

    if (!normalize) {
        for (int64_t t = 0; t < total; ++t) {
            out[t] = static_cast<float>(
                std::sqrt(re[t] * re[t] + im[t] * im[t]));
        }
        return 0;
    }
    // complex (v - min) / (max - min), then magnitude
    const double dr = max_re - min_re;
    const double di = max_im - min_im;
    const double denom = dr * dr + di * di;
    if (denom == 0.0) {
        for (int64_t t = 0; t < total; ++t) out[t] = 0.0f;
        return 0;
    }
    for (int64_t t = 0; t < total; ++t) {
        const double nr = re[t] - min_re;
        const double ni = im[t] - min_im;
        const double qr = (nr * dr + ni * di) / denom;
        const double qi = (ni * dr - nr * di) / denom;
        out[t] = static_cast<float>(std::sqrt(qr * qr + qi * qi));
    }
    return 0;
}

int ylm_field(const double* xs, const double* ys, const double* zs, int n,
              int l, int m_signed, float* out) {
    return ylm_field_ex(xs, ys, zs, n, l, m_signed, 1, out);
}

// Batched variant: fills num fields for (l[i], m[i]) pairs.
int ylm_fields(const double* xs, const double* ys, const double* zs, int n,
               const int* ls, const int* ms, int num, float* out) {
    const int64_t stride = static_cast<int64_t>(n) * n * n;
    for (int i = 0; i < num; ++i) {
        int rc = ylm_field(xs, ys, zs, n, ls[i], ms[i], out + i * stride);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // extern "C"
