// Per-scenario arithmetic of the condensed ADMM kernels (admm.cu).
//
// One thread block solves one scenario: its NL threads ("lanes") share the
// scenario's matrices and split every loop as `for (e = lane; e < N; e +=
// NL)`, with Team::sync() as the barrier between dependent steps.  The code
// is plain C++ marked __host__ __device__: the CUDA kernels instantiate it
// with NL = 256 and __syncthreads(); admm_host.cpp instantiates it with
// NL = 1 and a no-op barrier, so a host compiler runs the same arithmetic on
// the CPU.  Each output element of a matrix product is one lane's fmaf chain
// over k in increasing order, so the result does not depend on NL.
//
// Math (JAX package, pympc_quadruped_tpu/ops/qp/admm_pallas.py, and the
// port's plain versions in pympc_quadruped_tpu_torch/ops/qp/admm_fast.py):
//   spd_inverse      X = sym(K); 2x2 block Schur recursion split at n/2 to
//                    Gauss-Jordan leaves <= 16 wide, symmetrizing every
//                    Schur complement and top-left block; then ns_iters
//                    Newton-Schulz steps X <- sym(X (2I - K X));
//   admm_iterations  over-relaxed ADMM sweeps on the scaled problem with the
//                    friction-pyramid pattern P0 applied block by block
//                    (rows [1,0,mu] [-1,0,mu] [0,1,mu] [0,-1,mu] [0,0,1]);
//   full_setup       Ruiz scaling, cone-row scaling, per-row rho and the
//                    block-diagonal K = Hs + A^T rho A + sigma I.
// Exact f32 arithmetic only (build without fast-math): the u = +inf cone
// bounds must pass through the clip.
#pragma once

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#endif

// The matrix products and each recursion level stay out-of-line: inlined,
// the level templates multiply the code (nvcc took minutes and 190
// registers a thread), while calls keep it small with a static stack.
#ifdef __CUDACC__
#define ADMM_NOINLINE __noinline__
#else
#define ADMM_NOINLINE
#endif

namespace admm {

// Matrix products: TM x TM output tiles, k in chunks of TK, each of the
// tile's 256 (TM/MT)^2 "virtual threads" owning an MT x MT micro-tile.
constexpr int TM = 64;
constexpr int TK = 32;
constexpr int MT = 4;
constexpr int VT = (TM / MT) * (TM / MT);       // 256
constexpr int LDT = TM + 4;                      // tile row stride, 16-byte aligned
constexpr int TILE_FLOATS = 2 * TK * LDT;        // the A and B tiles
constexpr int GJ_LEAF = 16;                     // Gauss-Jordan leaf size
// Recursion levels above the leaves: n <= GJ_LEAF << MAX_LEVELS = 1024.
constexpr int MAX_LEVELS = 6;
constexpr int MAX_N = GJ_LEAF << MAX_LEVELS;
constexpr int GJ_FLOATS = GJ_LEAF * 2 * GJ_LEAF + 3 * GJ_LEAF;
constexpr int SCRATCH_FLOATS = TILE_FLOATS > GJ_FLOATS ? TILE_FLOATS : GJ_FLOATS;
constexpr int RPB = 5;                          // cone rows per 3-variable block
// Largest dynamic shared memory a block may use on sm_90 (227 KB).
constexpr long long SMEM_LIMIT = 232448;

enum Kernel { INVERT = 0, ITERATE = 1, FUSED = 2, FULL = 3 };

template <int NL>
struct Team {
  int lane;
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

// jnp.clip semantics: a NaN input stays NaN (the controller's non-finite
// reset relies on it); +inf upper bounds pass values through.
__host__ __device__ inline float clip(float v, float lo, float hi) {
  float c = fminf(fmaxf(v, lo), hi);
  return v != v ? v : c;
}

// Floats of the Schur recursion's W stack for an n x n inverse: one m x r
// block per level (both children of a level reuse the next level's block,
// and the larger child, r >= m, needs the most below it).
__host__ __device__ inline long long stack_floats(int n) {
  long long s = 0;
  for (; n > GJ_LEAF; n -= n / 2) s += (long long)(n / 2) * (n - n / 2);
  return s;
}

// Shared-memory floats of a kernel's block with Kinv (n x (n+1)) on chip.
__host__ __device__ inline long long smem_floats(int kernel, int n, int m) {
  const long long kinv = (long long)n * (n + 1);
  switch (kernel) {
    case ITERATE: return kinv + 5LL * n + 6LL * m;
    case FUSED:   return SCRATCH_FLOATS + kinv + 5LL * n + 6LL * m;
    case FULL:    return SCRATCH_FLOATS + kinv + 6LL * n + 6LL * m;
    default:      return SCRATCH_FLOATS;
  }
}

// Whether Kinv fits in shared memory: at h=16 it does; from h=19 (fused,
// full) or h=20 (iterate) it does not, and the kernels keep it in device
// memory instead.
__host__ __device__ inline bool kinv_on_chip(int kernel, int n, int m) {
  return smem_floats(kernel, n, m) * 4 <= SMEM_LIMIT;
}

__host__ __device__ inline long long smem_bytes(int kernel, int n, int m) {
  const long long kinv = (long long)n * (n + 1);
  const long long f = smem_floats(kernel, n, m);
  return 4 * (kinv_on_chip(kernel, n, m) || kernel == INVERT ? f : f - kinv);
}

// Per-scenario device-memory workspace floats of each kernel.
__host__ __device__ inline long long workspace_floats(int kernel, int n, int m) {
  const long long nn = (long long)n * n;
  const long long kinv = kinv_on_chip(kernel, n, m) ? 0 : (long long)n * (n + 1);
  switch (kernel) {
    case INVERT:  return 2 * nn + stack_floats(n);
    case FUSED:   return 2 * nn + stack_floats(n) + kinv;
    case FULL:    return 3 * nn + stack_floats(n) + kinv;
    default:      return 0;  // ITERATE reads Kinv in place when it is off chip
  }
}

// Four consecutive floats of a tile row: one 16-byte shared-memory load on
// the card (the tile rows are 16-byte aligned).
__host__ __device__ inline void load4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

// C = beta C + alpha op(A) op(B), with op(A) M x Kd and op(B) Kd x N, all
// row-major with leading dimensions; tA / tB read A / B transposed.  beta
// is 0 (C is not read) or 1; alpha is +-1 wherever the recursion calls it,
// so alpha * sum is exact.  C must not alias A or B.  Tiles go through
// `smem` (16-byte aligned); lanes load them along contiguous addresses of
// A and B, into registers one k-chunk ahead, so the loads of the next
// chunk are in flight while the current one is multiplied.  Each lane
// accumulates its micro-tiles in registers: per k, one 4-float load of A
// and one of B feed 16 FMAs.
template <int NL>
__host__ __device__ ADMM_NOINLINE void gemm(const Team<NL>& t, int M, int N, int Kd, float alpha,
                                            const float* A, int lda, bool tA,
                                            const float* B, int ldb, bool tB,
                                            float beta, float* C, int ldc, float* smem) {
  constexpr int VPL = VT / NL;       // virtual threads per lane
  constexpr int TW = TM / MT;        // micro-tiles per tile row
  constexpr int PF = TM * TK / NL;   // tile elements each lane loads
  float* As = smem;                  // As[k][i] = op(A)(i0 + i, k0 + k)
  float* Bs = smem + TK * LDT;       // Bs[k][j] = op(B)(k0 + k, j0 + j)
  float pa[PF], pb[PF];
  // Element e of a chunk: op(A)(i, k) and op(B)(k, j), with the fast index
  // along the operand's contiguous axis.
  auto a_at = [&](int e, int& i, int& k) { i = tA ? e % TM : e / TK; k = tA ? e / TM : e % TK; };
  auto b_at = [&](int e, int& k, int& j) { j = tB ? e / TK : e % TM; k = tB ? e % TK : e / TM; };
  auto fetch = [&](int i0, int j0, int k0) {
    for (int q = 0; q < PF; ++q) {
      const int e = t.lane + NL * q;
      int i, k, kb, j;
      a_at(e, i, k);
      b_at(e, kb, j);
      const int gi = i0 + i, gk = k0 + k, gj = j0 + j, gkb = k0 + kb;
      pa[q] = (gi < M && gk < Kd)
          ? (tA ? A[(long long)gk * lda + gi] : A[(long long)gi * lda + gk]) : 0.0f;
      pb[q] = (gj < N && gkb < Kd)
          ? (tB ? B[(long long)gj * ldb + gkb] : B[(long long)gkb * ldb + gj]) : 0.0f;
    }
  };
  for (int i0 = 0; i0 < M; i0 += TM)
    for (int j0 = 0; j0 < N; j0 += TM) {
      float acc[VPL][MT][MT];
      for (int v = 0; v < VPL; ++v)
        for (int r = 0; r < MT; ++r)
          for (int c = 0; c < MT; ++c) acc[v][r][c] = 0.0f;
      fetch(i0, j0, 0);
      for (int k0 = 0; k0 < Kd; k0 += TK) {
        const int kc = Kd - k0 < TK ? Kd - k0 : TK;
        t.sync();  // the previous chunk's readers are done
        for (int q = 0; q < PF; ++q) {
          const int e = t.lane + NL * q;
          int i, k, kb, j;
          a_at(e, i, k);
          b_at(e, kb, j);
          As[k * LDT + i] = pa[q];
          Bs[kb * LDT + j] = pb[q];
        }
        t.sync();
        if (k0 + TK < Kd) fetch(i0, j0, k0 + TK);
        for (int v = 0; v < VPL; ++v) {
          const int vt = t.lane + NL * v, ty = vt / TW, tx = vt % TW;
          for (int k = 0; k < kc; ++k) {
            float a[MT], b[MT];
            load4(As + k * LDT + ty * MT, a);
            load4(Bs + k * LDT + tx * MT, b);
            for (int r = 0; r < MT; ++r)
              for (int c = 0; c < MT; ++c) acc[v][r][c] = fmaf(a[r], b[c], acc[v][r][c]);
          }
        }
      }
      for (int v = 0; v < VPL; ++v) {
        const int vt = t.lane + NL * v, ty = vt / TW, tx = vt % TW;
        for (int r = 0; r < MT; ++r)
          for (int c = 0; c < MT; ++c) {
            const int gi = i0 + ty * MT + r, gj = j0 + tx * MT + c;
            if (gi < M && gj < N) {
              const float val = alpha * acc[v][r][c];
              float* cp = C + (long long)gi * ldc + gj;
              *cp = beta == 0.0f ? val : *cp + val;
            }
          }
      }
    }
  t.sync();
}

// X <- (X + X^T) / 2 on an n x n block, in place.
template <int NL>
__host__ __device__ void symmetrize(const Team<NL>& t, float* X, int ld, int n) {
  for (int e = t.lane; e < n * n; e += NL) {
    const int i = e / n, j = e % n;
    if (i < j) {
      const float s = 0.5f * (X[i * ld + j] + X[j * ld + i]);
      X[i * ld + j] = s;
      X[j * ld + i] = s;
    }
  }
  t.sync();
}

// Out = X^-1 for a k x k SPD block, k <= GJ_LEAF: pivot-free Gauss-Jordan on
// [X | I] in shared memory, the same steps as riccati._gauss_jordan_inv.
template <int NL>
__host__ __device__ ADMM_NOINLINE void gj_inverse(const Team<NL>& t, const float* X, int ldx, int k,
                                    float* Out, int ldo, float* smem) {
  const int w = 2 * k;
  float* aug = smem;                        // k x 2k
  float* prow = smem + GJ_LEAF * 2 * GJ_LEAF;   // normalized pivot row, 2k
  float* fac = prow + 2 * GJ_LEAF;          // pivot column, k
  t.sync();  // smem may still hold a product's tiles
  for (int e = t.lane; e < k * w; e += NL) {
    const int i = e / w, j = e % w;
    aug[e] = j < k ? X[i * ldx + j] : (j - k == i ? 1.0f : 0.0f);
  }
  t.sync();
  for (int p = 0; p < k; ++p) {
    for (int e = t.lane; e < w + k; e += NL) {
      if (e < w) prow[e] = aug[p * w + e] / aug[p * w + p];
      else fac[e - w] = aug[(e - w) * w + p];
    }
    t.sync();
    for (int e = t.lane; e < k * w; e += NL) {
      const int i = e / w, j = e % w;
      aug[e] = i == p ? prow[j] : aug[e] - fac[i] * prow[j];
    }
    t.sync();
  }
  for (int e = t.lane; e < k * k; e += NL) Out[(e / k) * ldo + e % k] = aug[(e / k) * w + k + e % k];
  t.sync();
}

// Out = X^-1 by the symmetrized 2x2 block Schur recursion.  X (symmetric,
// n x n) is overwritten: each level computes its Schur complement in place
// of its C block.  `ws` holds stack_floats(n) floats.  The recursion depth
// is a template parameter, so the compiler sees no runtime recursion and
// the device stack stays static; n <= GJ_LEAF << LEVELS.
template <int NL, int LEVELS = MAX_LEVELS>
__host__ __device__ ADMM_NOINLINE void schur_inverse(const Team<NL>& t, float* X, int ldx, int n,
                                       float* Out, int ldo, float* ws, float* smem) {
  if constexpr (LEVELS == 0) {
    gj_inverse(t, X, ldx, n, Out, ldo, smem);
    return;
  } else {
  if (n <= GJ_LEAF) {
    gj_inverse(t, X, ldx, n, Out, ldo, smem);
    return;
  }
  const int m = n / 2, r = n - m;
  float* W = ws;                                   // m x r
  float* next = ws + (long long)m * r;
  float* Bm = X + m;                               // X[:m, m:]
  float* C = X + (long long)m * ldx + m;           // X[m:, m:]
  float* Otr = Out + m;                            // Out[:m, m:]
  float* Obr = Out + (long long)m * ldo + m;       // Out[m:, m:]
  schur_inverse<NL, LEVELS - 1>(t, X, ldx, m, Out, ldo, next, smem);    // Ai
  gemm(t, m, r, m, 1.0f, Out, ldo, false, Bm, ldx, false, 0.0f, W, r, smem);  // W = Ai B
  gemm(t, r, r, m, -1.0f, Bm, ldx, true, W, r, false, 1.0f, C, ldx, smem);    // C - B^T W
  symmetrize(t, C, ldx, r);                                              // S
  schur_inverse<NL, LEVELS - 1>(t, C, ldx, r, Obr, ldo, next, smem);    // S^-1
  gemm(t, m, r, r, -1.0f, W, r, false, Obr, ldo, false, 0.0f, Otr, ldo, smem);  // -W S^-1
  // Ai + (W S^-1) W^T, as Ai - (-W S^-1) W^T: negation is exact.
  gemm(t, m, m, r, -1.0f, Otr, ldo, false, W, r, true, 1.0f, Out, ldo, smem);
  symmetrize(t, Out, ldo, m);
  for (int e = t.lane; e < m * r; e += NL) {
    const int i = e / r, j = e % r;
    Out[(long long)(m + j) * ldo + i] = Otr[(long long)i * ldo + j];
  }
  t.sync();
  }
}

// dst = spd_inverse(K): the recursion on sym(K), then ns_iters Newton-Schulz
// steps with the unsymmetrized K.  xw, tw: n x n workspaces; ws: the
// recursion's stack.  dst may be in shared memory (ldd = n + 1).
template <int NL>
__host__ __device__ ADMM_NOINLINE void spd_inverse(const Team<NL>& t, const float* K, int ldk, int n,
                                     int ns_iters, float* dst, int ldd, float* xw,
                                     float* tw, float* ws, float* smem) {
  for (int e = t.lane; e < n * n; e += NL) {
    const int i = e / n, j = e % n;
    xw[e] = 0.5f * (K[(long long)i * ldk + j] + K[(long long)j * ldk + i]);
  }
  t.sync();
  schur_inverse(t, xw, n, n, dst, ldd, ws, smem);
  for (int it = 0; it < ns_iters; ++it) {
    gemm(t, n, n, n, -1.0f, K, ldk, false, dst, ldd, false, 0.0f, tw, n, smem);  // -K X
    for (int i = t.lane; i < n; i += NL) tw[(long long)i * n + i] += 2.0f;    // 2I - K X
    t.sync();
    gemm(t, n, n, n, 1.0f, dst, ldd, false, tw, n, false, 0.0f, xw, n, smem);
    for (int e = t.lane; e < n * n; e += NL) {
      const int i = e / n, j = e % n;
      dst[(long long)i * ldd + j] = 0.5f * (xw[e] + xw[(long long)j * n + i]);
    }
    t.sync();
  }
}

// Row r of one pyramid block times a 3-vector s, in the summation order of
// the dense (m, n) pattern product (zero terms drop out exactly).
__host__ __device__ inline float pyramid_row(int r, float mu, const float* s) {
  switch (r) {
    case 0: return s[0] + mu * s[2];
    case 1: return -s[0] + mu * s[2];
    case 2: return s[1] + mu * s[2];
    case 3: return -s[1] + mu * s[2];
    default: return s[2];
  }
}

// The per-scenario vectors of the sweeps (n- and m-long), wherever they live.
struct Vecs {
  float *q, *d, *x, *rhs, *xt;          // n
  float *es, *rho, *lo, *hi, *z, *y;    // m
};

// `iterations` over-relaxed ADMM sweeps, in place on v.x, v.z, v.y:
//   rhs = sigma x - q + d (P0^T (es (rho z - y)))
//   xt  = Kinv rhs,   zt = es (P0 (d xt))
//   x   = alpha xt + (1 - alpha) x,   zbar = alpha zt + (1 - alpha) z
//   z   = clip(zbar + y / rho, lo, hi),   y = y + rho (zbar - z)
template <int NL>
__host__ __device__ ADMM_NOINLINE void admm_iterations(const Team<NL>& t, const float* Kinv, int ldk,
                                         int n, float mu, const Vecs& v, int iterations,
                                         float sigma, float alpha) {
  const int nb = n / 3;
  for (int it = 0; it < iterations; ++it) {
    for (int b = t.lane; b < nb; b += NL) {
      float w[RPB];
      for (int r = 0; r < RPB; ++r) {
        const int row = RPB * b + r;
        w[r] = v.es[row] * (v.rho[row] * v.z[row] - v.y[row]);
      }
      const float pv[3] = {w[0] - w[1], w[2] - w[3],
                           (((mu * w[0] + mu * w[1]) + mu * w[2]) + mu * w[3]) + w[4]};
      for (int c = 0; c < 3; ++c) {
        const int j = 3 * b + c;
        v.rhs[j] = (sigma * v.x[j] - v.q[j]) + v.d[j] * pv[c];
      }
    }
    t.sync();
    for (int i = t.lane; i < n; i += NL) {
      const float* row = Kinv + (long long)i * ldk;
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc = fmaf(row[k], v.rhs[k], acc);
      v.xt[i] = acc;
    }
    t.sync();
    for (int b = t.lane; b < nb; b += NL) {
      float s[3];
      for (int c = 0; c < 3; ++c) s[c] = v.d[3 * b + c] * v.xt[3 * b + c];
      for (int r = 0; r < RPB; ++r) {
        const int row = RPB * b + r;
        const float zt = v.es[row] * pyramid_row(r, mu, s);
        const float zbar = alpha * zt + (1.0f - alpha) * v.z[row];
        const float znew = clip(zbar + v.y[row] / v.rho[row], v.lo[row], v.hi[row]);
        v.y[row] = v.y[row] + v.rho[row] * (zbar - znew);
        v.z[row] = znew;
      }
      for (int c = 0; c < 3; ++c) {
        const int j = 3 * b + c;
        v.x[j] = alpha * v.xt[j] + (1.0f - alpha) * v.x[j];
      }
    }
    t.sync();
  }
}

// Carve a block's vectors out of `f` (n-long ones first); returns the end.
__host__ __device__ inline float* carve(float* f, int n, int m, Vecs& v) {
  float** nv[5] = {&v.q, &v.d, &v.x, &v.rhs, &v.xt};
  float** mv[6] = {&v.es, &v.rho, &v.lo, &v.hi, &v.z, &v.y};
  for (float** p : nv) { *p = f; f += n; }
  for (float** p : mv) { *p = f; f += m; }
  return f;
}

// Operands of one scenario for the iterate and fused kernels.
struct IterArgs {
  const float *q, *d, *es, *rho, *lo, *hi, *x0, *z0, *y0;
  float *x, *y;
};

template <int NL>
__host__ __device__ void load_iter_vectors(const Team<NL>& t, const IterArgs& a, int n,
                                           int m, const Vecs& v) {
  for (int i = t.lane; i < n; i += NL) {
    v.q[i] = a.q[i]; v.d[i] = a.d[i]; v.x[i] = a.x0[i];
  }
  for (int i = t.lane; i < m; i += NL) {
    v.es[i] = a.es[i]; v.rho[i] = a.rho[i]; v.lo[i] = a.lo[i]; v.hi[i] = a.hi[i];
    v.z[i] = a.z0[i]; v.y[i] = a.y0[i];
  }
  t.sync();
}

template <int NL>
__host__ __device__ void store_iter_result(const Team<NL>& t, const IterArgs& a, int n,
                                           int m, const Vecs& v) {
  for (int i = t.lane; i < n; i += NL) a.x[i] = v.x[i];
  for (int i = t.lane; i < m; i += NL) a.y[i] = v.y[i];
}

// Kernel 3, one scenario: Kinv (n x n, ld n) to chip (ld n + 1) unless
// `kinv_smem` is null, then the sweeps.  `smem` holds the vectors.
template <int NL>
__host__ __device__ void iterate_one(const Team<NL>& t, const float* Kinv, float* kinv_smem,
                                     const IterArgs& a, int n, int m, float mu,
                                     int iterations, float sigma, float alpha, float* smem) {
  Vecs v;
  carve(smem, n, m, v);
  const float* Kv = Kinv;
  int ldk = n;
  if (kinv_smem) {
    for (int e = t.lane; e < n * n; e += NL) kinv_smem[(e / n) * (n + 1) + e % n] = Kinv[e];
    Kv = kinv_smem;
    ldk = n + 1;
  }
  load_iter_vectors(t, a, n, m, v);
  admm_iterations(t, Kv, ldk, n, mu, v, iterations, sigma, alpha);
  store_iter_result(t, a, n, m, v);
}

// Kernel 4, one scenario: invert K into `kinv` (ld n + 1, on chip or in
// the workspace), then the sweeps.  ws: 2 n^2 + stack_floats(n) floats.
template <int NL>
__host__ __device__ void fused_one(const Team<NL>& t, const float* K, float* kinv,
                                   const IterArgs& a, int n, int m, float mu, int iterations,
                                   float sigma, float alpha, int ns_iters, float* ws,
                                   float* scratch, float* vecs) {
  Vecs v;
  carve(vecs, n, m, v);
  const long long nn = (long long)n * n;
  spd_inverse(t, K, n, n, ns_iters, kinv, n + 1, ws, ws + nn, ws + 2 * nn, scratch);
  load_iter_vectors(t, a, n, m, v);
  admm_iterations(t, kinv, n + 1, n, mu, v, iterations, sigma, alpha);
  store_iter_result(t, a, n, m, v);
}

// Operands of one scenario for the full kernel.
struct FullArgs {
  const float *H, *g, *srow, *l, *u, *U0, *lam0;
  float *U, *lam;
};

// Kernel 5, one scenario: Ruiz scaling, cone-row scaling, per-row rho,
// K = Hs + A^T rho A + sigma I, inversion, the warm-start map, the sweeps
// and the unscaling.  ws: 3 n^2 + stack_floats(n) floats (K first).
template <int NL>
__host__ __device__ void full_one(const Team<NL>& t, const FullArgs& a, float* kinv, int n,
                                  int m, float mu, int iterations, float sigma, float alpha,
                                  int ns_iters, int ruiz_iters, float rho_ineq, float rho_eq,
                                  float* ws, float* scratch, float* vecs) {
  Vecs v;
  float* extra = carve(vecs, n, m, v);
  float* delta = extra;          // n
  const long long nn = (long long)n * n;
  float* Kw = ws;
  const int nb = n / 3;

  // Ruiz equilibration: Hs = D H D, d = prod of the deltas.
  for (long long e = t.lane; e < nn; e += NL) Kw[e] = a.H[e];
  for (int i = t.lane; i < n; i += NL) v.d[i] = 1.0f;
  t.sync();
  for (int pass = 0; pass < ruiz_iters; ++pass) {
    for (int i = t.lane; i < n; i += NL) {
      float col = 0.0f;
      for (int j = 0; j < n; ++j) col = fmaxf(col, fabsf(Kw[(long long)i * n + j]));
      const float dl = 1.0f / sqrtf(fmaxf(col, 1e-8f));
      delta[i] = fminf(fmaxf(dl, 1e-4f), 1e4f);
    }
    t.sync();
    for (long long e = t.lane; e < nn; e += NL) Kw[e] = Kw[e] * delta[e / n] * delta[e % n];
    for (int i = t.lane; i < n; i += NL) v.d[i] = v.d[i] * delta[i];
    t.sync();
  }
  for (int i = t.lane; i < n; i += NL) v.q[i] = a.g[i] * v.d[i];

  // Cone-row scaling E, per-row rho and the 3x3 blocks of A^T rho A.
  for (int b = t.lane; b < nb; b += NL) {
    const float dx = v.d[3 * b], dy = v.d[3 * b + 1], dz = v.d[3 * b + 2];
    const float mdz = mu * dz;
    const float nr[RPB] = {fmaxf(dx, mdz), fmaxf(dx, mdz), fmaxf(dy, mdz), fmaxf(dy, mdz), dz};
    float wr[RPB];
    for (int r = 0; r < RPB; ++r) {
      const int row = RPB * b + r;
      const float e = 1.0f / fmaxf(nr[r], 1e-8f);
      v.es[row] = e * a.srow[row];
      v.lo[row] = a.l[row] * e;
      v.hi[row] = a.u[row] * e;
      v.rho[row] = (v.hi[row] - v.lo[row]) < 1e-6f ? rho_eq : rho_ineq;
      wr[r] = v.rho[row] * v.es[row] * v.es[row];
    }
    // pat^T diag(w) pat per block, scaled by d on both sides.
    const float pat[RPB][3] = {{1.f, 0.f, mu}, {-1.f, 0.f, mu}, {0.f, 1.f, mu},
                               {0.f, -1.f, mu}, {0.f, 0.f, 1.f}};
    const float db[3] = {dx, dy, dz};
    for (int c = 0; c < 3; ++c)
      for (int c2 = 0; c2 < 3; ++c2) {
        float core = 0.0f;
        for (int r = 0; r < RPB; ++r) core += pat[r][c] * wr[r] * pat[r][c2];
        float* k = Kw + (long long)(3 * b + c) * n + 3 * b + c2;
        float kv = *k + core * db[c] * db[c2];
        if (c == c2) kv += sigma;
        *k = kv;
      }
  }
  t.sync();

  spd_inverse(t, Kw, n, n, ns_iters, kinv, n + 1, ws + nn, ws + 2 * nn, ws + 3 * nn, scratch);

  // Warm start in scaled coordinates: x0 = U0 / d,
  // z0 = clip(es (P0 U0), lo, hi), y0 = lam0 / es on gated rows, else 0
  // (the Pallas kernel's srow lam0 norms, in the plain version's form).
  for (int b = t.lane; b < nb; b += NL) {
    const float s[3] = {a.U0[3 * b], a.U0[3 * b + 1], a.U0[3 * b + 2]};
    for (int c = 0; c < 3; ++c) v.x[3 * b + c] = s[c] / v.d[3 * b + c];
    for (int r = 0; r < RPB; ++r) {
      const int row = RPB * b + r;
      v.z[row] = clip(v.es[row] * pyramid_row(r, mu, s), v.lo[row], v.hi[row]);
      v.y[row] = v.es[row] > 0.0f ? a.lam0[row] / v.es[row] : 0.0f;
    }
  }
  t.sync();
  admm_iterations(t, kinv, n + 1, n, mu, v, iterations, sigma, alpha);
  for (int i = t.lane; i < n; i += NL) a.U[i] = v.x[i] * v.d[i];
  for (int i = t.lane; i < m; i += NL) a.lam[i] = v.es[i] * v.y[i];
}

}  // namespace admm
