// Per-scenario arithmetic of the sparse Riccati-ADMM solve.
//
// One call solves one scenario b of a batch-minor problem: every operand is
// a (rows, B) float32 array, element (r, b) at r * B + b, so the CUDA kernel
// (riccati_admm.cu, one thread per scenario) reads and writes neighbouring
// addresses across a warp.  The code is plain C++ marked __host__
// __device__, so a host compiler can run the same arithmetic on the CPU.
//
// Math: pympc_quadruped_tpu/ops/qp/riccati_pallas.py::_solve_kernel (and the
// batch-major plain version pympc_quadruped_tpu_torch/ops/qp/riccati.py):
//   1. backward Riccati factorization over h steps: P, masked B_k,
//      M_k = Hu_k + B_k^T P B_k, pivot-free Gauss-Jordan M_k^-1,
//      K_k = M_k^-1 G_k with G_k = B_k^T P A, P <- 2Q + A^T P A - G_k^T K_k,
//      with M_k and P symmetrized as the plain version does;
//   2. `iterations` over-relaxed ADMM sweeps: cone adjoint, backward affine
//      sweep, forward rollout, cone forward, clip, dual update, with a
//      per-scenario rho.
// Exact f32 arithmetic only (build without fast-math).
#pragma once

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#endif

namespace riccati_admm {

constexpr int NS = 13;                  // states
constexpr int NU = 12;                  // inputs
constexpr int RPL = 5;                  // cone rows per leg
constexpr int RPS = 20;                 // cone rows per step
constexpr int K_SIZE = NU * NS;         // K_k, row-major 12x13
constexpr int FAC = K_SIZE + NU * NU;   // K_k then M_k^-1 (row-major 12x12)
// Scratch rows per step: the factors, the affine terms d_k and the split z_k.
constexpr int SCRATCH_ROWS_PER_STEP = FAC + NU + RPS;

struct Operands {
  const float* A;      // (13*13, B) Ad, row-major per scenario
  const float* Bd;     // (13*12, B) Bd, row-major per scenario
  const float* hu;     // (h*12, B) diagonal input cost
  const float* mask;   // (h*12, B) stance variable mask
  const float* q2;     // (13,) 2 * diag(Q), shared
  const float* mu;     // (1,) friction coefficient, shared
  const float* rho;    // (1, B) per-scenario ADMM step size
  const float* qx;     // (h*13, B) -2 Q r_k
  const float* xt;     // (13, B) initial state
  const float* gate;   // (h*20, B) stance cone rows
  const float* lo;     // (h*20, B) lower row bounds
  const float* hi;     // (h*20, B) upper row bounds (+inf passes through)
  const float* u0;     // (h*12, B) warm start
  const float* z0;     // (h*20, B)
  const float* y0;     // (h*20, B)
  float* U;            // (h*12, B) out: raw u (swing components included)
  float* Y;            // (h*20, B) out: duals
  float* scratch;      // (h*SCRATCH_ROWS_PER_STEP, B)
  int B;
  int h;
  int iterations;
  float sigma;
  float alpha;
};

// jnp.clip semantics: a NaN input stays NaN (the controller's non-finite
// hold relies on it); +inf upper bounds pass values through.
__host__ __device__ inline float clip(float v, float lo, float hi) {
  float c = fminf(fmaxf(v, lo), hi);
  return v != v ? v : c;
}

// X <- (X + X^T) / 2 on the leading n x n block of a row-major (n, ld)
// array.  The f32 recursion loses the symmetry of M_k and P_k to rounding;
// left alone, the asymmetry grows over a 16-step horizon into errors of
// tens of newtons on random problems (the plain version symmetrizes too).
template <int n, int ld>
__host__ __device__ inline void symmetrize(float* X) {
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) {
      const float s = 0.5f * (X[i * ld + j] + X[j * ld + i]);
      X[i * ld + j] = s;
      X[j * ld + i] = s;
    }
}

__host__ __device__ inline void solve_one(const Operands& o, int b) {
  const size_t B = (size_t)o.B;
  const int h = o.h;
#define AT(ptr, r) (ptr)[(size_t)(r) * B + b]
  float* fac = o.scratch;                               // h*FAC rows
  float* dsc = o.scratch + (size_t)h * FAC * B;         // h*NU rows
  float* zsc = dsc + (size_t)h * NU * B;                // h*RPS rows
  const float mu = o.mu[0];
  const float rho = AT(o.rho, 0);
  const float rhoinv = 1.0f / rho;
  const float sigma = o.sigma, alpha = o.alpha;

  float a[NS * NS], bm[NS * NU];
  for (int i = 0; i < NS * NS; ++i) a[i] = AT(o.A, i);
  for (int i = 0; i < NS * NU; ++i) bm[i] = AT(o.Bd, i);

  // ---------------- Riccati factorization, k = h-1 .. 0 ----------------
  float P[NS * NS];
  for (int i = 0; i < NS; ++i)
    for (int j = 0; j < NS; ++j) P[i * NS + j] = (i == j) ? o.q2[i] : 0.0f;

  for (int k = h - 1; k >= 0; --k) {
    float mk[NU], huk[NU];
    for (int j = 0; j < NU; ++j) {
      mk[j] = AT(o.mask, k * NU + j);
      huk[j] = AT(o.hu, k * NU + j);
    }
    float PA[NS * NS], PB[NS * NU];
    for (int i = 0; i < NS; ++i) {
      for (int j = 0; j < NS; ++j) {
        float acc = P[i * NS] * a[j];
#pragma unroll
        for (int m = 1; m < NS; ++m) acc = fmaf(P[i * NS + m], a[m * NS + j], acc);
        PA[i * NS + j] = acc;
      }
      for (int j = 0; j < NU; ++j) {
        float acc = P[i * NS] * bm[j];
#pragma unroll
        for (int m = 1; m < NS; ++m) acc = fmaf(P[i * NS + m], bm[m * NU + j], acc);
        PB[i * NU + j] = acc * mk[j];
      }
    }
    // A^T P A overwrites P (P itself is no longer needed).
    for (int i = 0; i < NS; ++i)
      for (int j = 0; j < NS; ++j) {
        float acc = a[i] * PA[j];
#pragma unroll
        for (int m = 1; m < NS; ++m) acc = fmaf(a[m * NS + i], PA[m * NS + j], acc);
        P[i * NS + j] = acc;
      }
    // [M | I] with M = Hu + B_k^T P B_k (row mask folded in).
    float aug[NU][2 * NU];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) {
        float acc = bm[i] * PB[j];
#pragma unroll
        for (int m = 1; m < NS; ++m) acc = fmaf(bm[m * NU + i], PB[m * NU + j], acc);
        aug[i][j] = acc * mk[i];
        aug[i][NU + j] = (i == j) ? 1.0f : 0.0f;
      }
    symmetrize<NU, 2 * NU>(&aug[0][0]);
    for (int i = 0; i < NU; ++i) aug[i][i] += huk[i];
    // Pivot-free Gauss-Jordan (M is SPD): the right half becomes M^-1.
    for (int kk = 0; kk < NU; ++kk) {
      const float pinv = 1.0f / aug[kk][kk];
      for (int j = 0; j < 2 * NU; ++j) aug[kk][j] *= pinv;
      for (int i = 0; i < NU; ++i) {
        if (i == kk) continue;
        const float f = aug[i][kk];
        for (int j = 0; j < 2 * NU; ++j) aug[i][j] = fmaf(-f, aug[kk][j], aug[i][j]);
      }
    }
    // G = B_k^T P A (12x13, rows masked), K = M^-1 G.
    float G[NU * NS], K[NU * NS];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NS; ++j) {
        float acc = bm[i] * PA[j];
#pragma unroll
        for (int m = 1; m < NS; ++m) acc = fmaf(bm[m * NU + i], PA[m * NS + j], acc);
        G[i * NS + j] = acc * mk[i];
      }
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NS; ++j) {
        float acc = aug[i][NU] * G[j];
#pragma unroll
        for (int m = 1; m < NU; ++m) acc = fmaf(aug[i][NU + m], G[m * NS + j], acc);
        K[i * NS + j] = acc;
      }
    // P <- A^T P A - G^T K + 2Q.
    for (int i = 0; i < NS; ++i)
      for (int j = 0; j < NS; ++j) {
        float acc = G[i] * K[j];
#pragma unroll
        for (int m = 1; m < NU; ++m) acc = fmaf(G[m * NS + i], K[m * NS + j], acc);
        P[i * NS + j] = P[i * NS + j] - acc;
      }
    symmetrize<NS, NS>(P);
    for (int i = 0; i < NS; ++i) P[i * NS + i] += o.q2[i];
    for (int r = 0; r < K_SIZE; ++r) AT(fac, k * FAC + r) = K[r];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) AT(fac, k * FAC + K_SIZE + i * NU + j) = aug[i][NU + j];
  }

  // ------------------------- ADMM iterations ---------------------------
  for (int r = 0; r < h * NU; ++r) AT(o.U, r) = AT(o.u0, r);
  for (int r = 0; r < h * RPS; ++r) {
    AT(o.Y, r) = AT(o.y0, r);
    AT(zsc, r) = AT(o.z0, r);
  }

  for (int it = 0; it < o.iterations; ++it) {
    // Backward affine sweep: p_h = qx[h-1]; k = h-1 .. 0.
    float p[NS];
    for (int i = 0; i < NS; ++i) p[i] = AT(o.qx, (h - 1) * NS + i);
    for (int k = h - 1; k >= 0; --k) {
      const float* Kk = fac + (size_t)k * FAC * B;
      const float* Mk = Kk + (size_t)K_SIZE * B;
      // m_k = P0^T (gate (y - rho z)) - sigma u_prev + mask (B^T p).
      float m[NU];
      for (int leg = 0; leg < 4; ++leg) {
        float w[RPL];
        for (int r = 0; r < RPL; ++r) {
          const int row = k * RPS + RPL * leg + r;
          w[r] = AT(o.gate, row) * (AT(o.Y, row) - rho * AT(zsc, row));
        }
        const float qu[3] = {w[0] - w[1], w[2] - w[3],
                             mu * (w[0] + w[1] + w[2] + w[3]) + w[4]};
        for (int c = 0; c < 3; ++c)
          m[3 * leg + c] = qu[c] - sigma * AT(o.U, k * NU + 3 * leg + c);
      }
      for (int j = 0; j < NU; ++j) {
        float acc = bm[j] * p[0];
#pragma unroll
        for (int i = 1; i < NS; ++i) acc = fmaf(bm[i * NU + j], p[i], acc);
        m[j] += AT(o.mask, k * NU + j) * acc;
      }
      for (int i = 0; i < NU; ++i) {
        float acc = AT(Mk, i * NU) * m[0];
#pragma unroll
        for (int j = 1; j < NU; ++j) acc = fmaf(AT(Mk, i * NU + j), m[j], acc);
        AT(dsc, k * NU + i) = acc;
      }
      float pn[NS];
      for (int j = 0; j < NS; ++j) {
        float ktm = AT(Kk, j) * m[0];
#pragma unroll
        for (int i = 1; i < NU; ++i) ktm = fmaf(AT(Kk, i * NS + j), m[i], ktm);
        float ap = a[j] * p[0];
#pragma unroll
        for (int i = 1; i < NS; ++i) ap = fmaf(a[i * NS + j], p[i], ap);
        pn[j] = (k >= 1 ? AT(o.qx, (k - 1) * NS + j) : 0.0f) + ap - ktm;  // p_0 unused
      }
      for (int j = 0; j < NS; ++j) p[j] = pn[j];
    }

    // Forward rollout, with the per-step z/y/u update folded in: step k's
    // update reads only step k's values, all of which the backward sweep
    // above has finished with.
    float x[NS];
    for (int i = 0; i < NS; ++i) x[i] = AT(o.xt, i);
    for (int k = 0; k < h; ++k) {
      const float* Kk = fac + (size_t)k * FAC * B;
      float ut[NU], um[NU];
      for (int i = 0; i < NU; ++i) {
        float acc = AT(Kk, i * NS) * x[0];
#pragma unroll
        for (int j = 1; j < NS; ++j) acc = fmaf(AT(Kk, i * NS + j), x[j], acc);
        ut[i] = -acc - AT(dsc, k * NU + i);
        um[i] = ut[i] * AT(o.mask, k * NU + i);
      }
      float xn[NS];
      for (int i = 0; i < NS; ++i) {
        float ax = a[i * NS] * x[0];
#pragma unroll
        for (int j = 1; j < NS; ++j) ax = fmaf(a[i * NS + j], x[j], ax);
        float bu = bm[i * NU] * um[0];
#pragma unroll
        for (int j = 1; j < NU; ++j) bu = fmaf(bm[i * NU + j], um[j], bu);
        xn[i] = ax + bu;
      }
      for (int i = 0; i < NS; ++i) x[i] = xn[i];

      for (int leg = 0; leg < 4; ++leg) {
        const float fx = ut[3 * leg], fy = ut[3 * leg + 1], fz = ut[3 * leg + 2];
        const float mfz = mu * fz;
        const float zt[RPL] = {fx + mfz, mfz - fx, fy + mfz, mfz - fy, fz};
        for (int r = 0; r < RPL; ++r) {
          const int row = k * RPS + RPL * leg + r;
          const float y = AT(o.Y, row);
          const float zbar = alpha * (AT(o.gate, row) * zt[r]) + (1.0f - alpha) * AT(zsc, row);
          const float z_new = clip(zbar + y * rhoinv, AT(o.lo, row), AT(o.hi, row));
          AT(zsc, row) = z_new;
          AT(o.Y, row) = y + rho * (zbar - z_new);
        }
      }
      for (int i = 0; i < NU; ++i) {
        const int row = k * NU + i;
        AT(o.U, row) = alpha * ut[i] + (1.0f - alpha) * AT(o.U, row);
      }
    }
  }
#undef AT
}

}  // namespace riccati_admm
