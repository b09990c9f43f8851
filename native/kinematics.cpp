// Native runtime: planar-chain kinematics + LQT Riccati reference.
//
// Host-side counterpart of the reference's only native dependency —
// Pinocchio (C++ rigid-body kinematics, SURVEY §2.2): an n-link planar
// revolute chain FK / world-aligned translational Jacobian, batched for
// host-side Monte-Carlo validation, plus an independent C++ LQT Riccati
// backward pass used as a cross-language test oracle for the JAX scan
// implementation. Exposed via a plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libilqr_native.so kinematics.cpp

#include <cmath>
#include <cstddef>
#include <vector>

extern "C" {

// Forward kinematics of an n-link planar chain (revolute z-joints, links
// along local +x). q: (n,) joint angles; lengths: (n,). out: (3,) [x, y, 0].
void planar_fk(const double* lengths, int n, const double* q, double* out) {
  double c = 0.0, x = 0.0, y = 0.0;
  for (int i = 0; i < n; ++i) {
    c += q[i];
    x += lengths[i] * std::cos(c);
    y += lengths[i] * std::sin(c);
  }
  out[0] = x;
  out[1] = y;
  out[2] = 0.0;
}

// Batched FK: qs (batch, n) row-major -> outs (batch, 3).
void planar_fk_batch(const double* lengths, int n, const double* qs,
                     int batch, double* outs) {
  for (int b = 0; b < batch; ++b) {
    planar_fk(lengths, n, qs + (size_t)b * n, outs + (size_t)b * 3);
  }
}

// World-aligned translational Jacobian (3, n) row-major:
//   J[0][j] = -sum_{k>=j} l_k sin(c_k);  J[1][j] = sum_{k>=j} l_k cos(c_k).
void planar_jacobian(const double* lengths, int n, const double* q,
                     double* out) {
  std::vector<double> cum(n);
  double c = 0.0;
  for (int i = 0; i < n; ++i) {
    c += q[i];
    cum[i] = c;
  }
  double sx = 0.0, sy = 0.0;
  for (int j = n - 1; j >= 0; --j) {
    sx += lengths[j] * std::sin(cum[j]);
    sy += lengths[j] * std::cos(cum[j]);
    out[0 * n + j] = -sx;
    out[1 * n + j] = sy;
    out[2 * n + j] = 0.0;
  }
}

void planar_jacobian_batch(const double* lengths, int n, const double* qs,
                           int batch, double* outs) {
  for (int b = 0; b < batch; ++b) {
    planar_jacobian(lengths, n, qs + (size_t)b * n, outs + (size_t)b * 3 * n);
  }
}

}  // extern "C"

namespace {

// Dense helper (row-major, small fixed sizes)
inline double& at(double* M, int cols, int i, int j) {
  return M[(size_t)i * cols + j];
}

// Solve S x = b for symmetric positive definite S (in-place Cholesky).
void spd_solve(std::vector<double> S, int n, std::vector<double>& b, int nrhs) {
  // Cholesky S = L L^T
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = at(S.data(), n, i, j);
      for (int k = 0; k < j; ++k) s -= at(S.data(), n, i, k) * at(S.data(), n, j, k);
      if (i == j) {
        at(S.data(), n, i, j) = std::sqrt(s);
      } else {
        at(S.data(), n, i, j) = s / at(S.data(), n, j, j);
      }
    }
  }
  // forward/backward substitution per rhs (b is (n, nrhs) row-major)
  for (int r = 0; r < nrhs; ++r) {
    for (int i = 0; i < n; ++i) {
      double s = b[(size_t)i * nrhs + r];
      for (int k = 0; k < i; ++k) s -= at(S.data(), n, i, k) * b[(size_t)k * nrhs + r];
      b[(size_t)i * nrhs + r] = s / at(S.data(), n, i, i);
    }
    for (int i = n - 1; i >= 0; --i) {
      double s = b[(size_t)i * nrhs + r];
      for (int k = i + 1; k < n; ++k) s -= at(S.data(), n, k, i) * b[(size_t)k * nrhs + r];
      b[(size_t)i * nrhs + r] = s / at(S.data(), n, i, i);
    }
  }
}

}  // namespace

extern "C" {

// Independent LQT Riccati backward pass (cost convention of the JAX core:
// sum (x - xd)^T Q (x - xd) + u^T R u, final-step gains zero).
// A: (N, d, d), B: (N, d, m), Q: (N, d, d), xd: (N, d), R: (N, m, m),
// outputs K: (N, m, d), k: (N, m) — all row-major.
void lqt_backward_ref(const double* A, const double* B, const double* Q,
                      const double* xd, const double* R, int N, int d, int m,
                      double* K_out, double* k_out) {
  std::vector<double> V((size_t)d * d), v(d);
  // terminal: V = 2 Q_{N-1}, v = -2 Q_{N-1} xd_{N-1}
  for (int i = 0; i < d; ++i) {
    v[i] = 0.0;
    for (int j = 0; j < d; ++j) {
      V[(size_t)i * d + j] = 2.0 * Q[((size_t)(N - 1) * d + i) * d + j];
      v[i] -= 2.0 * Q[((size_t)(N - 1) * d + i) * d + j] * xd[(size_t)(N - 1) * d + j];
    }
  }
  // zero final-step gains
  for (int i = 0; i < m; ++i) {
    k_out[(size_t)(N - 1) * m + i] = 0.0;
    for (int j = 0; j < d; ++j) K_out[((size_t)(N - 1) * m + i) * d + j] = 0.0;
  }

  std::vector<double> qx(d), qu(m), Qxx((size_t)d * d), Qux((size_t)m * d),
      Quu((size_t)m * m), rhs;
  for (int t = N - 2; t >= 0; --t) {
    const double* At = A + (size_t)t * d * d;
    const double* Bt = B + (size_t)t * d * m;
    const double* Qt = Q + (size_t)t * d * d;
    const double* Rt = R + (size_t)t * m * m;
    const double* xdt = xd + (size_t)t * d;

    // qx = -2 Q xd + A^T v ; qu = B^T v
    for (int i = 0; i < d; ++i) {
      double s = 0.0;
      for (int j = 0; j < d; ++j) s += -2.0 * Qt[(size_t)i * d + j] * xdt[j];
      for (int j = 0; j < d; ++j) s += At[(size_t)j * d + i] * v[j];
      qx[i] = s;
    }
    for (int i = 0; i < m; ++i) {
      double s = 0.0;
      for (int j = 0; j < d; ++j) s += Bt[(size_t)j * m + i] * v[j];
      qu[i] = s;
    }
    // VA = V A ; Qxx = 2Q + A^T V A ; Qux = B^T V A ; Quu = 2R + B^T V B
    std::vector<double> VA((size_t)d * d, 0.0), VB((size_t)d * m, 0.0);
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) {
        double s = 0.0;
        for (int l = 0; l < d; ++l) s += V[(size_t)i * d + l] * At[(size_t)l * d + j];
        VA[(size_t)i * d + j] = s;
      }
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < m; ++j) {
        double s = 0.0;
        for (int l = 0; l < d; ++l) s += V[(size_t)i * d + l] * Bt[(size_t)l * m + j];
        VB[(size_t)i * m + j] = s;
      }
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j) {
        double s = 2.0 * Qt[(size_t)i * d + j];
        for (int l = 0; l < d; ++l) s += At[(size_t)l * d + i] * VA[(size_t)l * d + j];
        Qxx[(size_t)i * d + j] = s;
      }
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < d; ++j) {
        double s = 0.0;
        for (int l = 0; l < d; ++l) s += Bt[(size_t)l * m + i] * VA[(size_t)l * d + j];
        Qux[(size_t)i * d + j] = s;
      }
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j) {
        double s = 2.0 * Rt[(size_t)i * m + j];
        for (int l = 0; l < d; ++l) s += Bt[(size_t)l * m + i] * VB[(size_t)l * m + j];
        Quu[(size_t)i * m + j] = s;
      }
    // solve Quu [K k] = -[Qux qu]
    rhs.assign((size_t)m * (d + 1), 0.0);
    for (int i = 0; i < m; ++i) {
      for (int j = 0; j < d; ++j) rhs[(size_t)i * (d + 1) + j] = -Qux[(size_t)i * d + j];
      rhs[(size_t)i * (d + 1) + d] = -qu[i];
    }
    spd_solve(Quu, m, rhs, d + 1);
    for (int i = 0; i < m; ++i) {
      for (int j = 0; j < d; ++j)
        K_out[((size_t)t * m + i) * d + j] = rhs[(size_t)i * (d + 1) + j];
      k_out[(size_t)t * m + i] = rhs[(size_t)i * (d + 1) + d];
    }
    // V_new = Qxx + Qux^T K + K^T Qux + K^T Quu K;  v_new = qx + Qux^T k + K^T qu + K^T Quu k
    std::vector<double> Vn((size_t)d * d, 0.0), vn(d, 0.0), QuuK((size_t)m * d, 0.0),
        Quuk(m, 0.0);
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < d; ++j) {
        double s = 0.0;
        for (int l = 0; l < m; ++l)
          s += Quu[(size_t)i * m + l] * rhs[(size_t)l * (d + 1) + j];
        QuuK[(size_t)i * d + j] = s;
      }
    for (int i = 0; i < m; ++i) {
      double s = 0.0;
      for (int l = 0; l < m; ++l) s += Quu[(size_t)i * m + l] * rhs[(size_t)l * (d + 1) + d];
      Quuk[i] = s;
    }
    for (int i = 0; i < d; ++i) {
      for (int j = 0; j < d; ++j) {
        double s = Qxx[(size_t)i * d + j];
        for (int l = 0; l < m; ++l) {
          s += Qux[(size_t)l * d + i] * rhs[(size_t)l * (d + 1) + j];  // Qux^T K
          s += rhs[(size_t)l * (d + 1) + i] * Qux[(size_t)l * d + j];  // K^T Qux
          s += rhs[(size_t)l * (d + 1) + i] * QuuK[(size_t)l * d + j];  // K^T Quu K
        }
        Vn[(size_t)i * d + j] = s;
      }
      double s = qx[i];
      for (int l = 0; l < m; ++l) {
        s += Qux[(size_t)l * d + i] * rhs[(size_t)l * (d + 1) + d];  // Qux^T k
        s += rhs[(size_t)l * (d + 1) + i] * qu[l];                   // K^T qu
        s += rhs[(size_t)l * (d + 1) + i] * Quuk[l];                 // K^T Quu k
      }
      vn[i] = s;
    }
    V.swap(Vn);
    v.swap(vn);
  }
}

}  // extern "C"
