// Native batch CKKS encoder: slots -> rounded int32 coefficient vectors.
//
// The port's copy of fhe_spear_tpu/native/batch_encoder.cpp (host code, not
// a device kernel).  Pre-encoding a 24-block RWKV-7 model means ~400k
// canonical-embedding FFTs; this runs them multithreaded in C++ instead of
// through numpy's single-threaded C API dispatch.
//
// Math (mirrors fhe_spear_tpu_torch/ckks/encoding.py):
//   vals[t_slot[j]]  = z_j
//   vals[t_conj[j]]  = conj(z_j)          (conjugate symmetry)
//   b = FFT_n(vals) / n                   (forward FFT, e^{-2pi i kt/n})
//   coeff_k = round( Re(b_k * zeta^{-k}) * scale )
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libbatchenc.so
//        batch_encoder.cpp
// Loaded via ctypes (fhe_spear_tpu_torch/native/__init__.py) with a numpy
// fallback when the shared object is missing.

#include <cmath>
#include <complex>
#include <cstdint>
#include <vector>

using cd = std::complex<double>;

namespace {

// iterative radix-2 DIT FFT, negative-exponent convention (numpy fft)
void fft_inplace(cd* a, int n, const cd* twiddle /* [n/2] */) {
    // bit-reversal permutation
    for (int i = 1, j = 0; i < n; ++i) {
        int bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    for (int len = 2; len <= n; len <<= 1) {
        int step = n / len;
        for (int i = 0; i < n; i += len) {
            for (int k = 0; k < len / 2; ++k) {
                cd w = twiddle[(size_t)k * step];
                cd u = a[i + k];
                cd v = a[i + k + len / 2] * w;
                a[i + k] = u + v;
                a[i + k + len / 2] = u - v;
            }
        }
    }
}

}  // namespace

extern "C" {

// slots_re/slots_im: [rows, s] packed row-major; out: [rows, n] int32.
// t_slot/t_conj: [s] target indices; s = n/2.
// Returns 0 on success, 1 if any rounded coefficient overflowed int32.
int batch_encode(const double* slots_re, const double* slots_im,
                 long long rows, int n, double scale,
                 const int64_t* t_slot, const int64_t* t_conj,
                 int32_t* out) {
    const int s = n / 2;
    // twiddles: e^{-2pi i k / n}, k < n/2
    std::vector<cd> twiddle(s);
    for (int k = 0; k < s; ++k) {
        double ang = -2.0 * M_PI * k / n;
        twiddle[k] = cd(std::cos(ang), std::sin(ang));
    }
    // zeta^{-k} = e^{-i pi k / n}
    std::vector<cd> zinv(n);
    for (int k = 0; k < n; ++k) {
        double ang = -M_PI * k / n;
        zinv[k] = cd(std::cos(ang), std::sin(ang));
    }
    int overflow = 0;
#pragma omp parallel
    {
        std::vector<cd> vals(n);
#pragma omp for schedule(static)
        for (long long r = 0; r < rows; ++r) {
            const double* zre = slots_re + (size_t)r * s;
            const double* zim = slots_im + (size_t)r * s;
            for (int k = 0; k < n; ++k) vals[k] = cd(0.0, 0.0);
            for (int j = 0; j < s; ++j) {
                vals[t_slot[j]] = cd(zre[j], zim[j]);
                vals[t_conj[j]] = cd(zre[j], -zim[j]);
            }
            fft_inplace(vals.data(), n, twiddle.data());
            int32_t* o = out + (size_t)r * n;
            const double inv_n_scale = scale / n;
            for (int k = 0; k < n; ++k) {
                double re = (vals[k] * zinv[k]).real() * inv_n_scale;
                double v = std::nearbyint(re);
                if (v >= 2147483647.0 || v <= -2147483648.0) {
#pragma omp atomic write
                    overflow = 1;
                    v = 0.0;
                }
                o[k] = (int32_t)v;
            }
        }
    }
    return overflow;
}

}  // extern "C"
