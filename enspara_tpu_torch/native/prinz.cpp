// Detailed-balance maximum-likelihood transition-matrix estimator
// (Prinz et al., J. Chem. Phys. 134, 174105 (2011), algorithm 1).
//
// Host-native replacement for the reference's Cython kernel
// (enspara/msm/libmsm.pyx:15 _mle_prinz_dense): the Gauss-Seidel sweep
// over the diagonal and all (i, j>i) pairs is inherently sequential, so
// it stays on the host in C++ (SURVEY.md §2.10 item 3). A Jacobi-style
// device reformulation lives in enspara_tpu/msm/builders.py (mle_device).
//
// C = row-major (n x n) transition counts (double).
// Outputs: T = row-normalized reversible transition matrix,
//          pi = equilibrium populations.
// Returns the number of sweeps used, or -1 on invalid input.

#include <cmath>
#include <cstdlib>
#include <cstring>

extern "C" {

long mle_prinz_dense(const double* Cin, long n, double tol, long max_iter,
                     double* T, double* pi) {
    double* X = (double*)std::malloc(sizeof(double) * n * n);
    double* C = (double*)std::malloc(sizeof(double) * n * n);
    double* X_rs = (double*)std::malloc(sizeof(double) * n);
    double* C_rs = (double*)std::malloc(sizeof(double) * n);
    if (!X || !C || !X_rs || !C_rs) {
        std::free(X); std::free(C); std::free(X_rs); std::free(C_rs);
        return -1;
    }

    std::memcpy(C, Cin, sizeof(double) * n * n);
    for (long i = 0; i < n; ++i) {
        X_rs[i] = 0.0;
        C_rs[i] = 0.0;
        for (long j = 0; j < n; ++j) {
            X[i * n + j] = C[i * n + j] + C[j * n + i];
            X_rs[i] += X[i * n + j];
            C_rs[i] += C[i * n + j];
        }
    }
    for (long i = 0; i < n; ++i) {
        if (X_rs[i] <= 0.0 || C_rs[i] <= 0.0) {
            std::free(X); std::free(C); std::free(X_rs); std::free(C_rs);
            return -1;
        }
    }

    double oldlogl = 0.0;
    long n_iter = 0;
    for (n_iter = 0; n_iter < max_iter; ++n_iter) {
        double logl = 0.0;

        // diagonal pass
        for (long i = 0; i < n; ++i) {
            const double tmp = X[i * n + i];
            const double denom = C_rs[i] - C[i * n + i];
            if (denom > 0.0) {
                X[i * n + i] = C[i * n + i] * (X_rs[i] - X[i * n + i])
                               / denom;
            }
            X_rs[i] += (X[i * n + i] - tmp);
            if (X[i * n + i] > 0.0) {
                // log10: the reference's stopping metric base
                // (libmsm.pyx:46)
                logl += C[i * n + i] * std::log10(X[i * n + i] / X_rs[i]);
            }
        }

        // off-diagonal Gauss-Seidel pass over (i, j>i)
        for (long i = 0; i < n - 1; ++i) {
            for (long j = i + 1; j < n; ++j) {
                const double cij = C[i * n + j];
                const double cji = C[j * n + i];
                const double xij = X[i * n + j];

                const double a = (C_rs[i] - cij) + (C_rs[j] - cji);
                const double b = C_rs[i] * (X_rs[j] - xij)
                               + C_rs[j] * (X_rs[i] - xij)
                               - (cij + cji)
                                 * (X_rs[i] + X_rs[j] - 2.0 * xij);
                const double c = -(cij + cji) * (X_rs[i] - xij)
                                 * (X_rs[j] - xij);

                double v;
                if (a == 0.0) {
                    v = X[j * n + i];
                } else {
                    v = (-b + std::sqrt(b * b - 4.0 * a * c)) / (2.0 * a);
                }

                X_rs[i] += (v - X[i * n + j]);
                X_rs[j] += (v - X[j * n + i]);
                X[i * n + j] = v;
                X[j * n + i] = v;

                if (v > 0.0) {
                    // REFERENCE-FAITHFUL quirk: the reference's
                    // off-diagonal term (libmsm.pyx:78) divides
                    // OUTSIDE the log (c*log(x)/X_rs, not
                    // c*log(x/X_rs)). logl is only the stopping
                    // metric, so we keep the exact convention for
                    // oracle parity.
                    logl += cij * std::log10(v) / X_rs[i]
                          + cji * std::log10(v) / X_rs[j];
                }
            }
        }

        if (std::fabs(logl - oldlogl) > tol) {
            oldlogl = logl;
        } else {
            break;
        }
    }

    double x_total = 0.0;
    for (long i = 0; i < n; ++i) x_total += X_rs[i];
    for (long i = 0; i < n; ++i) {
        pi[i] = X_rs[i] / x_total;
        const double inv = 1.0 / X_rs[i];
        for (long j = 0; j < n; ++j) {
            T[i * n + j] = X[i * n + j] * inv;
        }
    }

    std::free(X); std::free(C); std::free(X_rs); std::free(C_rs);
    return n_iter;
}

}  // extern "C"
