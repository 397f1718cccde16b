// Independent float64 QP oracle for the condensed MPC problem — C++.
//
// Role (SURVEY.md §2.3): a native host reference implementation, fully
// independent of the Python/numpy oracle (oracle/npref.py), used by tests to
// cross-certify the certified optimum.  Two independently-written solvers in
// two languages agreeing to ~1e-8 closes the "oracle validates the oracle"
// loop from the other side.
//
// Problem (mirrors ref linear_mpc/mpc.py:237-260 semantics, in the masked
// form the engine uses — swing variables pinned to zero via identity
// rows/cols of H):
//
//     min_U 0.5 U^T H U + g^T U
//     s.t. per stance (step, leg):  |fx| <= mu fz, |fy| <= mu fz,
//                                   0 <= fz <= fz_max
//
// Algorithm: long-iteration primal-dual interior point (Mehrotra predictor-
// corrector) with dense float64 Cholesky, run to KKT residuals ~1e-10.
// Everything is written from scratch here — no BLAS/LAPACK dependency.
//
// C ABI:
//   int qp_oracle_solve(int horizon, const double* H, const double* g,
//                       const double* gait_table,  // (4*horizon) 1=stance
//                       double mu, double fz_max,
//                       int max_iter, double tol,
//                       double* U_out,             // (12*horizon)
//                       double* kkt_out);          // (3) residuals
// Returns 0 on success, 1 if tolerance not reached (kkt_out still filled).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Dense Cholesky factorization (lower). Returns false if not SPD.
bool cholesky(std::vector<double>& A, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
    if (d <= 0.0) return false;
    const double Ljj = std::sqrt(d);
    A[j * n + j] = Ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s / Ljj;
    }
  }
  return true;
}

void chol_solve(const std::vector<double>& L, int n, std::vector<double>& x) {
  for (int i = 0; i < n; ++i) {  // L y = b
    double s = x[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
    x[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {  // L^T x = y
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

}  // namespace

extern "C" int qp_oracle_solve(int horizon, const double* Hin, const double* g,
                               const double* gait_table, double mu,
                               double fz_max, int max_iter, double tol,
                               double* U_out, double* kkt_out) {
  const int n = 12 * horizon;
  const int blocks = 4 * horizon;        // (step, leg) blocks of 3 variables
  const int m = 6 * blocks;              // 6 inequality rows per block

  // Mask the cost exactly like the engine: swing rows/cols of H -> identity,
  // swing g -> 0 (cones.mask_cost), so swing variables solve to 0.
  std::vector<double> H(Hin, Hin + (size_t)n * n);
  std::vector<double> gm(g, g + n);
  std::vector<char> stance(blocks);
  for (int b = 0; b < blocks; ++b) stance[b] = gait_table[b] > 0.5 ? 1 : 0;
  for (int b = 0; b < blocks; ++b) {
    if (stance[b]) continue;
    for (int c = 0; c < 3; ++c) {
      const int v = 3 * b + c;
      for (int j = 0; j < n; ++j) H[v * n + j] = H[j * n + v] = 0.0;
      H[v * n + v] = 1.0;
      gm[v] = 0.0;
    }
  }

  // Constraint rows, block b, vars (x,y,z) = (3b, 3b+1, 3b+2):
  //   r0:  x - mu z <= 0      r1: -x - mu z <= 0
  //   r2:  y - mu z <= 0      r3: -y - mu z <= 0
  //   r4: -z <= 0             r5:  z <= fz_max
  // Swing blocks get trivial rows 0 <= 1.
  auto Gx = [&](const std::vector<double>& x, std::vector<double>& out) {
    for (int b = 0; b < blocks; ++b) {
      const double fx = x[3 * b], fy = x[3 * b + 1], fz = x[3 * b + 2];
      double* r = &out[6 * b];
      if (stance[b]) {
        r[0] = fx - mu * fz;  r[1] = -fx - mu * fz;
        r[2] = fy - mu * fz;  r[3] = -fy - mu * fz;
        r[4] = -fz;           r[5] = fz;
      } else {
        for (int k = 0; k < 6; ++k) r[k] = 0.0;
      }
    }
  };
  auto GTy = [&](const std::vector<double>& y, std::vector<double>& out) {
    std::fill(out.begin(), out.end(), 0.0);
    for (int b = 0; b < blocks; ++b) {
      if (!stance[b]) continue;
      const double* r = &y[6 * b];
      out[3 * b]     += r[0] - r[1];
      out[3 * b + 1] += r[2] - r[3];
      out[3 * b + 2] += -mu * (r[0] + r[1] + r[2] + r[3]) - r[4] + r[5];
    }
  };
  std::vector<double> h(m);
  for (int b = 0; b < blocks; ++b) {
    double* r = &h[6 * b];
    if (stance[b]) {
      r[0] = r[1] = r[2] = r[3] = r[4] = 0.0;
      r[5] = fz_max;
    } else {
      for (int k = 0; k < 6; ++k) r[k] = 1.0;  // trivially satisfied
    }
  }

  // Primal-dual IPM state.
  std::vector<double> x(n, 0.0), s(m), lam(m, 1.0);
  for (int i = 0; i < m; ++i) s[i] = std::max(h[i], 1.0);

  std::vector<double> gx(m), rp(m), rd(n), tmpn(n), M((size_t)n * n);
  std::vector<double> dxa(n), dsa(m), dla(m), dx(n), ds(m), dl(m), rhs(n);

  auto residuals = [&](double* out3) {
    Gx(x, gx);
    double rdmax = 0, rpmax = 0, compmax = 0;
    std::vector<double> gl(n);
    GTy(lam, gl);
    for (int i = 0; i < n; ++i) {
      double v = gm[i];
      for (int j = 0; j < n; ++j) v += H[i * n + j] * x[j];
      v += gl[i];
      rdmax = std::max(rdmax, std::fabs(v));
    }
    for (int i = 0; i < m; ++i) {
      rpmax = std::max(rpmax, std::fabs(gx[i] + s[i] - h[i]));
      compmax = std::max(compmax, std::fabs(s[i] * lam[i]));
    }
    out3[0] = rdmax; out3[1] = rpmax; out3[2] = compmax;
  };

  auto max_step = [&](const std::vector<double>& z, const std::vector<double>& dz) {
    double a = 1.0;
    for (int i = 0; i < m; ++i)
      if (dz[i] < 0.0) a = std::min(a, -z[i] / dz[i]);
    return a;
  };

  for (int it = 0; it < max_iter; ++it) {
    double res[3];
    residuals(res);
    if (std::max(std::max(res[0], res[1]), res[2]) < tol) break;

    Gx(x, gx);
    for (int i = 0; i < m; ++i) rp[i] = gx[i] + s[i] - h[i];
    {  // rd = H x + g + G^T lam
      std::vector<double> gl(n);
      GTy(lam, gl);
      for (int i = 0; i < n; ++i) {
        double v = gm[i];
        for (int j = 0; j < n; ++j) v += H[i * n + j] * x[j];
        rd[i] = v + gl[i];
      }
    }
    const double mu_gap = [&] {
      double v = 0;
      for (int i = 0; i < m; ++i) v += s[i] * lam[i];
      return v / m;
    }();

    // Normal matrix M = H + G^T D G, D = lam/s (block-diagonal structure).
    std::memcpy(M.data(), H.data(), sizeof(double) * (size_t)n * n);
    for (int b = 0; b < blocks; ++b) {
      if (!stance[b]) continue;
      // Rows of G for this block map onto vars (3b..3b+2); accumulate
      // r^T d r for each of the 6 rows.
      const double dvals[6] = {lam[6 * b] / s[6 * b],
                               lam[6 * b + 1] / s[6 * b + 1],
                               lam[6 * b + 2] / s[6 * b + 2],
                               lam[6 * b + 3] / s[6 * b + 3],
                               lam[6 * b + 4] / s[6 * b + 4],
                               lam[6 * b + 5] / s[6 * b + 5]};
      const double rows[6][3] = {{1, 0, -mu}, {-1, 0, -mu}, {0, 1, -mu},
                                 {0, -1, -mu}, {0, 0, -1},  {0, 0, 1}};
      for (int r = 0; r < 6; ++r)
        for (int a = 0; a < 3; ++a)
          for (int c = 0; c < 3; ++c)
            M[(size_t)(3 * b + a) * n + (3 * b + c)] +=
                dvals[r] * rows[r][a] * rows[r][c];
    }
    for (int i = 0; i < n; ++i) M[(size_t)i * n + i] += 1e-13;
    if (!cholesky(M, n)) return 2;

    auto kkt = [&](const std::vector<double>& rc, std::vector<double>& odx,
                   std::vector<double>& ods, std::vector<double>& odl) {
      // rhs = -rd - G^T ((lam*rp - rc)/s)
      std::vector<double> w(m);
      for (int i = 0; i < m; ++i) w[i] = (lam[i] * rp[i] - rc[i]) / s[i];
      GTy(w, tmpn);
      for (int i = 0; i < n; ++i) rhs[i] = -rd[i] - tmpn[i];
      odx = rhs;
      chol_solve(M, n, odx);
      std::vector<double> gdx(m);
      Gx(odx, gdx);  // NOTE: G is linear, so G(dx) works via the same map
      for (int i = 0; i < m; ++i) ods[i] = -rp[i] - gdx[i];
      for (int i = 0; i < m; ++i) odl[i] = (-rc[i] - lam[i] * ods[i]) / s[i];
    };

    // Affine predictor.
    std::vector<double> rc(m);
    for (int i = 0; i < m; ++i) rc[i] = s[i] * lam[i];
    kkt(rc, dxa, dsa, dla);
    const double aff = std::min(max_step(s, dsa), max_step(lam, dla));
    double mu_aff = 0;
    for (int i = 0; i < m; ++i)
      mu_aff += (s[i] + aff * dsa[i]) * (lam[i] + aff * dla[i]);
    mu_aff /= m;
    const double sigma = std::pow(std::max(mu_aff, 1e-16) / std::max(mu_gap, 1e-14), 3.0);

    // Corrector.
    for (int i = 0; i < m; ++i)
      rc[i] = s[i] * lam[i] + dsa[i] * dla[i] - sigma * mu_gap;
    kkt(rc, dx, ds, dl);
    double alpha = 0.995 * std::min(max_step(s, ds), max_step(lam, dl));
    alpha = std::min(alpha, 1.0);
    for (int i = 0; i < n; ++i) x[i] += alpha * dx[i];
    for (int i = 0; i < m; ++i) {
      s[i] = std::max(s[i] + alpha * ds[i], 1e-300);
      lam[i] = std::max(lam[i] + alpha * dl[i], 1e-300);
    }
  }

  double res[3];
  residuals(res);
  std::memcpy(kkt_out, res, sizeof(res));
  std::memcpy(U_out, x.data(), sizeof(double) * n);
  return (std::max(std::max(res[0], res[1]), res[2]) < tol) ? 0 : 1;
}
