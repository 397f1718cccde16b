// Per-scenario arithmetic of the sparse Riccati-ADMM solve.
//
// One group of NL lanes solves one scenario b of a batch-major problem:
// every operand is a (B, rows) float32 array, so scenario b's rows are
// contiguous at b * rows.  The group keeps Ad, Bd, the per-step factors,
// the per-step operands its sweeps wait on and the iteration state in a
// block of shared memory of its own (`sm`, laid out below) and splits every
// loop over rows among its lanes, with Team::sync() between dependent
// phases.  The CUDA kernel (riccati_admm.cu)
// instantiates it with NL = 16 and a warp barrier; riccati_admm_host.cpp
// with NL = 1 and no barrier, so a host compiler runs the same arithmetic on
// the CPU.  Each output element is one lane's fmaf chain over m in
// increasing order, so the result does not depend on NL.
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

#ifdef __CUDA_ARCH__
#define RICCATI_LDG(p) __ldg(p)
#else
#define RICCATI_LDG(p) (*(p))
#endif

namespace riccati_admm {

constexpr int NS = 13;                  // states
constexpr int NU = 12;                  // inputs
constexpr int RPL = 5;                  // cone rows per leg
constexpr int RPS = 20;                 // cone rows per step
constexpr int K_SIZE = NU * NS;         // K_k, row-major 12x13
constexpr int FAC = K_SIZE + NU * NU;   // K_k then M_k^-1 transposed (12x12)
// Row stride in shared memory, chosen so that the 13 lanes reading one
// element of each row hit 13 different banks.
constexpr int LDB = NS;                 // Bd and P B rows (13 x 12 in 13 x 13)
// Largest dynamic shared memory a block may use on sm_90 (227 KB).
constexpr long long SMEM_LIMIT = 232448;

// Shared-memory floats of one scenario: the sweep's vectors (p and x twice
// each, m, u~, mask * u~; 16 floats each, 16-byte aligned, read as float4),
// Ad and Bd, the h steps' factors and read-only operands, then one region
// that first holds the factorization's work matrices (P, PA, PB, G, the
// unsymmetrized P update, two pivot rows) and then the iteration state (u,
// z, y, d).  Rounded to 16 mod 32 floats, so the two groups of a warp fall
// on different banks.
constexpr int VEC = 16;                 // a vector's floats in shared memory
constexpr int VECS = 7 * VEC;

__host__ __device__ inline int work_floats(int h) {
  const int factor = 4 * NS * NS + K_SIZE + 2 * 2 * NU;
  const int sweep = (2 * NU + 2 * RPS) * h;
  return factor > sweep ? factor : sweep;
}

// Per step, the read-only operands on the sweeps' dependency chains: mask,
// qx, gate.  (The clip bounds lo and hi are read from device memory: no
// chain waits on them, and without them 8 scenarios fit a block.)
constexpr int OPS_PER_STEP = NU + NS + RPS;

__host__ __device__ inline long long group_floats(int h) {
  const long long raw =
      VECS + 2LL * NS * NS + (long long)(FAC + OPS_PER_STEP) * h + work_floats(h);
  return raw + ((16 - raw % 32) + 32) % 32;
}

struct Operands {
  const float* A;      // (B, 13*13) Ad, row-major per scenario
  const float* Bd;     // (B, 13*12) Bd, row-major per scenario
  const float* hu;     // (B, h*12) diagonal input cost
  const float* mask;   // (B, h*12) stance variable mask
  const float* q2;     // (13,) 2 * diag(Q), shared
  const float* mu;     // (1,) friction coefficient, shared
  const float* rho;    // (B,) per-scenario ADMM step size
  const float* qx;     // (B, h*13) -2 Q r_k
  const float* xt;     // (B, 13) initial state
  const float* gate;   // (B, h*20) stance cone rows
  const float* lo;     // (B, h*20) lower row bounds
  const float* hi;     // (B, h*20) upper row bounds (+inf passes through)
  const float* u0;     // (B, h*12) warm start
  const float* z0;     // (B, h*20)
  const float* y0;     // (B, h*20)
  float* U;            // (B, h*12) out: raw u (swing components included)
  float* Y;            // (B, h*20) out: duals
  int B;
  int h;
  int iterations;
  float sigma;
  float alpha;
};

// The lanes of one scenario.  On the card they are half a warp, and
// sync() is a barrier over the whole warp: its two groups run the same
// code, so they meet at every barrier, and a constant full mask keeps the
// barrier one instruction (a mask computed at run time costs a match and
// a reduction per barrier).
template <int NL>
struct Team {
  int lane;
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

// jnp.clip semantics: a NaN input stays NaN (the controller's non-finite
// hold relies on it); +inf upper bounds pass values through.
__host__ __device__ inline float clip(float v, float lo, float hi) {
  float c = fminf(fmaxf(v, lo), hi);
  return v != v ? v : c;
}

// v[0..N) <- s[0..N) for a 16-byte aligned shared array s, N a multiple
// of 4: one 16-byte load per four floats on the card.
template <int N>
__host__ __device__ inline void load_vec(const float* s, float* v) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
#ifdef __CUDA_ARCH__
    const float4 q = *reinterpret_cast<const float4*>(s + e);
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
#else
    for (int c = 0; c < 4; ++c) v[e + c] = s[e + c];
#endif
  }
}

// One lane's row of a product: acc[j] = sum_m x[m xs] Y[m ldy + j] for j < N,
// each output one fmaf chain over m in increasing order with a product
// first.  The N accumulators stay in registers and each Y row is read once,
// so the loads run ahead of the arithmetic.
template <int K, int N>
__host__ __device__ inline void row_times(const float* x, int xs, const float* Y, int ldy,
                                          float* acc) {
  const float x0 = x[0];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = x0 * Y[j];
#pragma unroll
  for (int m = 1; m < K; ++m) {
    const float xm = x[m * xs];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = fmaf(xm, Y[m * ldy + j], acc[j]);
  }
}

// Solve scenario b with the lanes of t in the shared block sm
// (group_floats(h) floats); write U and Y only when `store` (a lane group
// past the batch's end runs on a clamped b and stores nothing).  Every
// phase reads what it needs before it writes, and a barrier separates a
// phase's writes from the next phase's reads of other lanes' rows.
//
// The f32 recursion loses the symmetry of M_k and P_k to rounding; left
// alone, the asymmetry grows over a 16-step horizon into errors of tens of
// newtons on random problems, so both are symmetrized as (X + X^T) / 2, as
// the plain version does.
template <int NL>
__host__ __device__ void solve_one(const Team<NL>& t, const Operands& o, long long b, float* sm,
                                   bool store) {
  constexpr int ROWS = (NU + NL - 1) / NL;   // rows of 12-row objects a lane owns
  constexpr int ROWS13 = (NS + NL - 1) / NL;  // of 13-row objects
  constexpr int ROWSC = (RPS + NL - 1) / NL;  // of a step's cone rows
  const int h = o.h, L = t.lane;
  float* pv = sm;                         // p, two buffers
  float* xv = pv + 2 * VEC;               // x, two buffers
  float* mv = xv + 2 * VEC;               // m_k
  float* ut = mv + VEC;                   // u~_k
  float* um = ut + VEC;                   // mask * u~_k
  float* a = sm + VECS;                   // Ad, 13 x 13
  float* bm = a + NS * NS;                // Bd, 13 x 12 at stride LDB
  float* fac = bm + NS * LDB;             // per step: K_k, then M_k^-1 transposed
  float* mask = fac + (long long)FAC * h;  // per-step operands: mask, qx, gate
  float* qx = mask + h * NU;
  float* gate = qx + h * NS;
  float* work = gate + h * RPS;
  const float* lo = o.lo + b * h * RPS;
  const float* hi = o.hi + b * h * RPS;

  const float* gA = o.A + b * NS * NS;
  const float* gB = o.Bd + b * NS * NU;
  const float* hu = o.hu + b * h * NU;
  for (int e = L; e < NS * NS; e += NL) a[e] = RICCATI_LDG(gA + e);
  for (int e = L; e < NS * NU; e += NL) bm[(e / NU) * LDB + e % NU] = RICCATI_LDG(gB + e);
  for (int e = L; e < h * NU; e += NL) mask[e] = RICCATI_LDG(o.mask + b * h * NU + e);
  for (int e = L; e < h * NS; e += NL) qx[e] = RICCATI_LDG(o.qx + b * h * NS + e);
  for (int e = L; e < h * RPS; e += NL) gate[e] = RICCATI_LDG(o.gate + b * h * RPS + e);

  // ---------------- Riccati factorization, k = h-1 .. 0 ----------------
  // Pt holds the P update before symmetrization; each step starts by
  // symmetrizing it (Pt = 0 gives P_h = 2Q).
  float* P = work;                        // A^T P A, 13 x 13
  float* PA = P + NS * NS;                // 13 x 13
  float* PB = PA + NS * NS;               // 13 x 12 at stride LDB
  float* Pt = PB + NS * LDB;              // 13 x 13
  float* G = Pt + NS * NS;                // 12 x 13
  float* piv = G + K_SIZE;                // two pivot rows of [M | I]
  for (int e = L; e < NS * NS; e += NL) Pt[e] = 0.0f;
  t.sync();

  for (int k = h - 1; k >= 0; --k) {
    const float* mk = mask + k * NU;
    float* Kk = fac + (long long)k * FAC;
    float* Mt = Kk + K_SIZE;              // the raw M_k first, M_k^-1 transposed last
    // P = sym(Pt) + 2Q, row by row; PA = P A; PB = P B, columns masked.
    for (int i = L; i < NS; i += NL) {
      float Pi[NS], pa[NS], pb[NU];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        Pi[j] = (j == i) ? Pt[i * NS + i] + o.q2[i] : 0.5f * (Pt[i * NS + j] + Pt[j * NS + i]);
      row_times<NS, NS>(Pi, 1, a, NS, pa);
      row_times<NS, NU>(Pi, 1, bm, LDB, pb);
#pragma unroll
      for (int j = 0; j < NS; ++j) PA[i * NS + j] = pa[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) PB[i * LDB + j] = pb[j] * mk[j];
    }
    t.sync();
    // A^T P A; the raw M = B_k^T P B_k and G = B_k^T P A, rows masked.
    for (int i = L; i < NS; i += NL) {
      float ata[NS], m[NU], g[NS];
      row_times<NS, NS>(a + i, NS, PA, NS, ata);
      if (i < NU) {
        row_times<NS, NU>(bm + i, LDB, PB, LDB, m);
        row_times<NS, NS>(bm + i, LDB, PA, NS, g);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) P[i * NS + j] = ata[j];
      if (i < NU) {
        const float mi = mk[i];
#pragma unroll
        for (int j = 0; j < NU; ++j) Mt[i * NU + j] = m[j] * mi;
#pragma unroll
        for (int j = 0; j < NS; ++j) G[i * NS + j] = g[j] * mi;
      }
    }
    t.sync();
    // Each lane's rows of [M | I] in registers: M symmetrized, then Hu on
    // its diagonal.
    float R[ROWS][2 * NU];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = L + q * NL;
      if (i >= NU) continue;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        R[q][j] = (j == i) ? Mt[i * NU + i] + hu[k * NU + i]
                           : 0.5f * (Mt[i * NU + j] + Mt[j * NU + i]);
        R[q][NU + j] = (j == i) ? 1.0f : 0.0f;
      }
    }
    // Pivot-free Gauss-Jordan (M is SPD): the right half becomes M^-1.  The
    // pivot row's owner scales it and publishes it; the other rows
    // eliminate with it.  Columns left of the pivot are never read again,
    // so they are not updated.
#pragma unroll
    for (int kk = 0; kk < NU; ++kk) {
      float* pr = piv + (kk & 1) * 2 * NU;
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        if (L + q * NL != kk) continue;
        const float pinv = 1.0f / R[q][kk];
#pragma unroll
        for (int j = kk + 1; j < 2 * NU; ++j) {
          R[q][j] *= pinv;
          pr[j] = R[q][j];
        }
      }
      t.sync();
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = L + q * NL;
        if (i >= NU || i == kk) continue;
        const float f = R[q][kk];
#pragma unroll
        for (int j = kk + 1; j < 2 * NU; ++j) R[q][j] = fmaf(-f, pr[j], R[q][j]);
      }
    }
    // K = M^-1 G into the step's factors; M^-1 stored transposed, so that
    // lane i reads its row with neighbouring lanes on neighbouring floats.
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = L + q * NL;
      if (i >= NU) continue;
      float kr[NS];
      row_times<NU, NS>(R[q] + NU, 1, G, NS, kr);
#pragma unroll
      for (int j = 0; j < NS; ++j) Kk[i * NS + j] = kr[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Mt[j * NU + i] = R[q][NU + j];
    }
    t.sync();
    // Pt = A^T P A - G^T K, symmetrized at the next step (or unused).
    for (int i = L; i < NS; i += NL) {
      float gk[NS];
      row_times<NU, NS>(G + i, NS, Kk, NS, gk);
#pragma unroll
      for (int j = 0; j < NS; ++j) Pt[i * NS + j] = P[i * NS + j] - gk[j];
    }
    t.sync();
  }

  // ------------------------- ADMM iterations ---------------------------
  float* u = work;                        // h x 12
  float* z = u + h * NU;                  // h x 20
  float* y = z + h * RPS;                 // h x 20
  float* d = y + h * RPS;                 // h x 12 affine terms d_k
  const float* u0 = o.u0 + b * h * NU;
  const float* z0 = o.z0 + b * h * RPS;
  const float* y0 = o.y0 + b * h * RPS;
  for (int e = L; e < h * NU; e += NL) u[e] = RICCATI_LDG(u0 + e);
  for (int e = L; e < h * RPS; e += NL) {
    z[e] = RICCATI_LDG(z0 + e);
    y[e] = RICCATI_LDG(y0 + e);
  }
  const float mu = o.mu[0];
  const float rho = RICCATI_LDG(o.rho + b);
  const float rhoinv = 1.0f / rho;
  const float sigma = o.sigma, alpha = o.alpha;
  const float* xt = o.xt + b * NS;
  // The lane's rows and columns of Ad and Bd, in registers for the sweeps.
  float a_row[ROWS13][NS], a_col[ROWS13][NS], b_row[ROWS13][NU], b_col[ROWS][NS];
#pragma unroll
  for (int q = 0; q < ROWS13; ++q) {
    const int i = L + q * NL;
    if (i >= NS) continue;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      a_row[q][j] = a[i * NS + j];
      a_col[q][j] = a[j * NS + i];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) b_row[q][j] = bm[i * LDB + j];
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int i = L + q * NL;
    if (i >= NU) continue;
#pragma unroll
    for (int r = 0; r < NS; ++r) b_col[q][r] = bm[r * LDB + i];
  }

  for (int it = 0; it < o.iterations; ++it) {
    // Backward affine sweep: p_h = qx[h-1]; k = h-1 .. 0.
    for (int i = L; i < NS; i += NL) pv[i] = qx[(h - 1) * NS + i];
    t.sync();
    for (int k = h - 1; k >= 0; --k) {
      const float* Kk = fac + (long long)k * FAC;
      const float* Mt = Kk + K_SIZE;
      float p[VEC];
      load_vec<VEC>(pv + ((h - 1 - k) & 1) * VEC, p);
      // m_k = P0^T (gate (y - rho z)) - sigma u_prev + mask (B^T p); lane i
      // takes its leg's five cone rows.
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = L + q * NL;
        if (i >= NU) continue;
        const int c = i % 3, row = k * RPS + RPL * (i / 3);
        float w[RPL];
#pragma unroll
        for (int r = 0; r < RPL; ++r) w[r] = gate[row + r] * (y[row + r] - rho * z[row + r]);
        const float qu = c == 0 ? w[0] - w[1]
                       : c == 1 ? w[2] - w[3]
                                : mu * (w[0] + w[1] + w[2] + w[3]) + w[4];
        const float mi = qu - sigma * u[k * NU + i];
        float acc = b_col[q][0] * p[0];
#pragma unroll
        for (int r = 1; r < NS; ++r) acc = fmaf(b_col[q][r], p[r], acc);
        mv[i] = mi + mask[k * NU + i] * acc;
      }
      t.sync();
      // p_k = qx[k-1] + A^T p - K_k^T m_k (p_0 unused); d_k = M_k^-1 m_k.
      float m[VEC];
      load_vec<VEC>(mv, m);
      float* pn = pv + ((h - k) & 1) * VEC;
#pragma unroll
      for (int q = 0; q < ROWS13; ++q) {
        const int j = L + q * NL;
        if (j >= NS) continue;
        float ktm = Kk[j] * m[0];
#pragma unroll
        for (int i = 1; i < NU; ++i) ktm = fmaf(Kk[i * NS + j], m[i], ktm);
        float ap = a_col[q][0] * p[0];
#pragma unroll
        for (int i = 1; i < NS; ++i) ap = fmaf(a_col[q][i], p[i], ap);
        float dj = 0.0f;
        if (j < NU) {
          dj = Mt[j] * m[0];
#pragma unroll
          for (int i = 1; i < NU; ++i) dj = fmaf(Mt[i * NU + j], m[i], dj);
        }
        pn[j] = (k >= 1 ? qx[(k - 1) * NS + j] : 0.0f) + ap - ktm;
        if (j < NU) d[k * NU + j] = dj;
      }
      t.sync();
    }

    // Forward rollout, with the per-step z/y/u update folded in: step k's
    // update reads only step k's values, all of which the backward sweep
    // above has finished with.
    for (int i = L; i < NS; i += NL) xv[i] = RICCATI_LDG(xt + i);
    t.sync();
    for (int k = 0; k < h; ++k) {
      const float* Kk = fac + (long long)k * FAC;
      float x[VEC];
      load_vec<VEC>(xv + (k & 1) * VEC, x);
      for (int i = L; i < NU; i += NL) {
        float acc = Kk[i * NS] * x[0];
#pragma unroll
        for (int j = 1; j < NS; ++j) acc = fmaf(Kk[i * NS + j], x[j], acc);
        const float uti = -acc - d[k * NU + i];
        ut[i] = uti;
        um[i] = uti * mask[k * NU + i];
      }
      t.sync();
      // Lane r: cone row r of step k, and row r of x_{k+1} and of u.
      float umv[VEC];
      load_vec<VEC>(um, umv);
      float zn[ROWSC], yn[ROWSC], xr[ROWS13], ur[ROWS];
#pragma unroll
      for (int q = 0; q < ROWSC; ++q) {
        const int r = L + q * NL;
        if (r >= RPS) continue;
        const int leg = r / RPL, rr = r % RPL;
        const float fx = ut[3 * leg], fy = ut[3 * leg + 1], fz = ut[3 * leg + 2];
        const float mfz = mu * fz;
        const float zt = rr == 0 ? fx + mfz : rr == 1 ? mfz - fx : rr == 2 ? fy + mfz
                       : rr == 3 ? mfz - fy : fz;
        const int row = k * RPS + r;
        const float yv = y[row];
        const float zbar = alpha * (gate[row] * zt) + (1.0f - alpha) * z[row];
        zn[q] = clip(zbar + yv * rhoinv, RICCATI_LDG(lo + row), RICCATI_LDG(hi + row));
        yn[q] = yv + rho * (zbar - zn[q]);
      }
#pragma unroll
      for (int q = 0; q < ROWS13; ++q) {
        if (L + q * NL >= NS) continue;
        float ax = a_row[q][0] * x[0];
#pragma unroll
        for (int j = 1; j < NS; ++j) ax = fmaf(a_row[q][j], x[j], ax);
        float bu = b_row[q][0] * umv[0];
#pragma unroll
        for (int j = 1; j < NU; ++j) bu = fmaf(b_row[q][j], umv[j], bu);
        xr[q] = ax + bu;
      }
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = L + q * NL;
        if (i < NU) ur[q] = alpha * ut[i] + (1.0f - alpha) * u[k * NU + i];
      }
      float* xn = xv + ((k + 1) & 1) * VEC;
#pragma unroll
      for (int q = 0; q < ROWSC; ++q) {
        const int r = L + q * NL;
        if (r >= RPS) continue;
        z[k * RPS + r] = zn[q];
        y[k * RPS + r] = yn[q];
      }
#pragma unroll
      for (int q = 0; q < ROWS13; ++q)
        if (L + q * NL < NS) xn[L + q * NL] = xr[q];
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        if (L + q * NL < NU) u[k * NU + L + q * NL] = ur[q];
      t.sync();
    }
  }

  if (!store) return;
  float* U = o.U + b * h * NU;
  float* Y = o.Y + b * h * RPS;
  for (int e = L; e < h * NU; e += NL) U[e] = u[e];
  for (int e = L; e < h * RPS; e += NL) Y[e] = y[e];
}

// Largest horizon at which the two scenarios of a warp fit in one block's
// shared memory (SMEM_LIMIT); the launcher refuses a longer one.
inline int max_horizon() {
  int h = 0;
  while (2 * 4 * group_floats(h + 1) <= SMEM_LIMIT) ++h;
  return h;
}

}  // namespace riccati_admm

// Exported by every library built from this header (the CUDA kernel, its
// host builds), so that the wrapper can refuse a horizon with a message.
extern "C" int riccati_admm_max_horizon() { return riccati_admm::max_horizon(); }
