// Per-scenario arithmetic of the condensed ADMM kernels (admm.cu).
//
// One thread block solves one scenario: its NL threads ("lanes") share the
// scenario's matrices and split every loop as `for (e = lane; e < N; e +=
// NL)`, with Team::sync() as the barrier between dependent steps.  The code
// is plain C++ marked __host__ __device__: the CUDA kernels instantiate it
// with NL = 512 (invert) or 256 (the others) and __syncthreads();
// admm_host.cpp instantiates it with NL = 1 and a no-op barrier, so a host
// compiler runs the same arithmetic on the CPU.  Each output element of a
// matrix product is one lane's fmaf chain over k in increasing order, so
// the result does not depend on NL or on how a product is tiled.
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

// The staged products and each recursion level stay out-of-line: inlined,
// the level templates multiply the code (nvcc took minutes and 190
// registers a thread), while calls keep it small with a static stack.
#ifdef __CUDACC__
#define ADMM_NOINLINE __noinline__
#else
#define ADMM_NOINLINE
#endif

namespace admm {

// Staged products (gemm): TM x TM output tiles, k in chunks of TK, each of
// the tile's 256 (TM/MT)^2 "virtual threads" owning an MT x MT micro-tile.
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

// Columns of the Newton-Schulz panel: T[:, J] = 2I[:, J] - K X[:, J], one
// product tile wide.
constexpr int PANEL = TM;

// The in-place inverse's buffer X (n x (n+1): rows padded by one float, so
// a warp's reads down a column, and the iterate sweeps' row reads, fall in
// 32 banks) and the Newton-Schulz panel (n x PANEL).
__host__ __device__ inline long long x_floats(int n) { return (long long)n * (n + 1); }
__host__ __device__ inline long long panel_floats(int n) { return (long long)n * PANEL; }

// Shared-memory floats of a kernel's block with its buffers on chip: the
// product tiles, X (Kinv of the iterate, fused and full kernels), the
// panel, and the sweeps' vectors.
__host__ __device__ inline long long smem_floats(int kernel, int n, int m) {
  const long long inv = SCRATCH_FLOATS + x_floats(n) + panel_floats(n);
  switch (kernel) {
    case ITERATE: return x_floats(n) + 5LL * n + 6LL * m;
    case FUSED:   return inv + 5LL * n + 6LL * m;
    case FULL:    return inv + 6LL * n + 6LL * m;
    default:      return inv;
  }
}

// Whether a kernel's buffers fit in one block's shared memory.  At h <= 16
// they do for every kernel, and the inverting kernels run one block per
// SM.  From h = 17 X and the panel of the invert, fused and full kernels
// move to the device-memory workspace (the same code, other pointers);
// from h = 20 the iterate kernel reads Kinv from device memory.
__host__ __device__ inline bool on_chip(int kernel, int n, int m) {
  return smem_floats(kernel, n, m) * 4 <= SMEM_LIMIT;
}

// Floats that leave shared memory for the workspace when they do not fit
// (the iterate kernel reads Kinv in place instead).
__host__ __device__ inline long long moved_floats(int kernel, int n, int m) {
  if (on_chip(kernel, n, m)) return 0;
  return kernel == ITERATE ? x_floats(n) : x_floats(n) + panel_floats(n);
}

__host__ __device__ inline long long smem_bytes(int kernel, int n, int m) {
  return 4 * (smem_floats(kernel, n, m) - moved_floats(kernel, n, m));
}

// Per-scenario device-memory workspace floats of each kernel: the fused
// and full kernels' Newton-Schulz product R (n x n: it is read whole while
// X is still needed, and X and R do not both fit on chip), the full
// kernel's K, and X and the panel where they do not fit.  The invert
// kernel writes R into its output.
__host__ __device__ inline long long workspace_floats(int kernel, int n, int m) {
  const long long nn = (long long)n * n;
  switch (kernel) {
    case INVERT:  return moved_floats(kernel, n, m);
    case FUSED:   return nn + moved_floats(kernel, n, m);
    case FULL:    return 2 * nn + moved_floats(kernel, n, m);
    default:      return 0;  // ITERATE reads Kinv in place when it is off chip
  }
}

// Where one scenario's buffers lie in the inverting kernels (invert,
// fused, full), from its block's shared memory and its workspace: in
// shared memory the product tiles, then X and the panel when OnChip, then
// the vectors; in the workspace K (full), R (fused, full), then X and the
// panel when they do not fit.
struct Layout {
  float *tiles, *X, *T, *vecs, *Kw, *R;
};

template <bool OnChip>
__host__ __device__ inline Layout layout(int kernel, int n, float* smem, float* ws) {
  const long long nn = (long long)n * n;
  Layout l{smem, nullptr, nullptr, nullptr, nullptr, nullptr};
  smem += SCRATCH_FLOATS;
  if (kernel == FULL) { l.Kw = ws; ws += nn; }
  if (kernel == FUSED || kernel == FULL) { l.R = ws; ws += nn; }
  l.X = OnChip ? smem : ws;
  l.T = l.X + x_floats(n);
  l.vecs = OnChip ? l.T + panel_floats(n) : smem;
  return l;
}

template <bool B>
struct Placement {
  static constexpr bool on_chip = B;
};

// f(layout, placement) with the placement a compile-time constant.  The
// inverse's functions are instantiated per placement, so that in the
// on-chip instantiation every pointer into X and the panel visibly comes
// from shared memory, and the compiler emits shared-memory loads and
// stores for them instead of generic ones (measured in PERF.md).
template <class F>
__host__ __device__ inline void with_layout(int kernel, int n, int m, float* smem, float* ws,
                                            F f) {
  if (on_chip(kernel, n, m))
    f(layout<true>(kernel, n, smem, ws), Placement<true>{});
  else
    f(layout<false>(kernel, n, smem, ws), Placement<false>{});
}

// Two consecutive floats of a tile row: one 8-byte shared-memory load on
// the card.
__host__ __device__ inline void load2(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
#else
  v[0] = p[0]; v[1] = p[1];
#endif
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
template <int NL, bool OnChip>
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

// One block of outputs of gemm_resident: rows i0 + ty + 32 r (r < MR) and
// columns j0 + tx + 16 c (c < MC) for the 32 x 16 virtual lanes (ty, tx).
template <int NL, int MR, int MC>
__host__ __device__ inline void resident_block(const Team<NL>& t, int i0, int j0, int M, int N,
                                               int Kd, float alpha, const float* A,
                                               long long sai, long long sak, const float* B,
                                               long long sbk, long long sbj, float beta,
                                               float* C, int ldc) {
  constexpr int VPL = 512 / NL > 0 ? 512 / NL : 1;  // virtual lanes per lane
  for (int v = 0; v < VPL; ++v) {
    const int vt = t.lane + NL * v, ty = vt / 16, tx = vt % 16;
    if (i0 + ty >= M || j0 + tx >= N) continue;
    const float* ap[MR];
    const float* bp[MC];
    for (int r = 0; r < MR; ++r) {
      const int gi = i0 + ty + 32 * r;
      ap[r] = A + (gi < M ? gi : i0) * sai;
    }
    for (int c = 0; c < MC; ++c) {
      const int gj = j0 + tx + 16 * c;
      bp[c] = B + (gj < N ? gj : j0) * sbj;
    }
    float acc[MR][MC];
    for (int r = 0; r < MR; ++r)
      for (int c = 0; c < MC; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < Kd; ++k) {
      float a[MR], b[MC];
      for (int r = 0; r < MR; ++r) a[r] = ap[r][k * sak];
      for (int c = 0; c < MC; ++c) b[c] = bp[c][k * sbk];
      for (int r = 0; r < MR; ++r)
        for (int c = 0; c < MC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    for (int r = 0; r < MR; ++r)
      for (int c = 0; c < MC; ++c) {
        const int gi = i0 + ty + 32 * r, gj = j0 + tx + 16 * c;
        if (gi < M && gj < N) {
          const float val = alpha * acc[r][c];
          float* cp = C + (long long)gi * ldc + gj;
          *cp = beta == 0.0f ? val : *cp + val;
        }
      }
  }
}

// C = beta C + alpha op(A) op(B), as gemm, with both operands read where
// they lie: in the inverse's buffer, which is in shared memory on the
// card.  No tiles are copied and no barrier is passed but the last.  The
// block's lanes form a 32 x 16 grid over the output, each lane owning an
// MR x MC micro-tile sized to the product (12 x 12: 1 x 1 ... 96 x 96:
// 3 x 6), with rows 32 and columns 16 apart, so a warp's reads of op(A)
// touch two addresses and its reads of op(B) sixteen in distinct banks
// (rows of the buffer are n + 1 floats apart).  Each output is the same
// fmaf chain over k in order as gemm's.
template <int NL>
__host__ __device__ inline void gemm_resident(const Team<NL>& t, int M, int N, int Kd,
                                              float alpha, const float* A, int lda, bool tA,
                                              const float* B, int ldb, bool tB, float beta,
                                              float* C, int ldc) {
  const long long sai = tA ? 1 : lda, sak = tA ? lda : 1;
  const long long sbk = tB ? 1 : ldb, sbj = tB ? ldb : 1;
  const int mr = (M + 31) / 32, mc = (N + 15) / 16;
  if (mr <= 1 && mc <= 1)
    resident_block<NL, 1, 1>(t, 0, 0, M, N, Kd, alpha, A, sai, sak, B, sbk, sbj, beta, C, ldc);
  else if (mr <= 1 && mc <= 2)
    resident_block<NL, 1, 2>(t, 0, 0, M, N, Kd, alpha, A, sai, sak, B, sbk, sbj, beta, C, ldc);
  else if (mr <= 2 && mc <= 3)
    resident_block<NL, 2, 3>(t, 0, 0, M, N, Kd, alpha, A, sai, sak, B, sbk, sbj, beta, C, ldc);
  else if (mr <= 3 && mc <= 6)
    resident_block<NL, 3, 6>(t, 0, 0, M, N, Kd, alpha, A, sai, sak, B, sbk, sbj, beta, C, ldc);
  else
    for (int i0 = 0; i0 < M; i0 += 32 * 6)
      for (int j0 = 0; j0 < N; j0 += 16 * 6)
        resident_block<NL, 6, 6>(t, i0, j0, M, N, Kd, alpha, A, sai, sak, B, sbk, sbj, beta, C,
                                 ldc);
  t.sync();
}

// C = alpha A B for the Newton-Schulz panels: A (M x Kd) row-major, B
// (Kd x N, N <= PANEL) row-major, C (M x N).  The block's lanes tile rows
// of PR_ROWS = 192 at once, as 32 x 16 virtual lanes each owning 6 rows and
// 4 columns (rows 6 ty + r, columns tx + 16 c), so per k a lane's three
// 8-byte reads of A and four reads of B feed 24 FMAs.  A is staged through
// the tiles in chunks of PK columns with the next chunk in registers; B is
// read where it lies (in shared memory on the card).  Each output is the
// same fmaf chain over k in order as gemm's.
constexpr int PK = 16, PR_ROWS = 192, PLDA = PR_ROWS + 4;
static_assert(PK * PLDA <= SCRATCH_FLOATS, "panel chunk exceeds the tiles");
template <int NL, bool OnChip>
__host__ __device__ ADMM_NOINLINE void gemm_panel(const Team<NL>& t, int M, int N, int Kd,
                                                  float alpha, const float* A, int lda,
                                                  const float* B, int ldb, float* C, int ldc,
                                                  float* smem) {
  constexpr int VL = 512;                              // virtual lanes: 32 x 16
  constexpr int VPL = VL / NL > 0 ? VL / NL : 1;
  constexpr int RPL = PR_ROWS / 32, CPL = 4;           // 6 rows, 4 columns
  constexpr int PF = PK * PR_ROWS / NL < 1 ? 1 : PK * PR_ROWS / NL;
  float* As = smem;                                    // As[k][i] = A(i0 + i, k0 + k)
  float pa[PF];
  auto fetch = [&](int i0, int k0) {
    for (int q = 0; q < PF; ++q) {
      const int e = t.lane + NL * q, k = e % PK, i = e / PK;
      const int gi = i0 + i, gk = k0 + k;
      pa[q] = (i < PR_ROWS && gi < M && gk < Kd) ? A[(long long)gi * lda + gk] : 0.0f;
    }
  };
  for (int i0 = 0; i0 < M; i0 += PR_ROWS) {
    float acc[VPL][RPL][CPL];
    for (int v = 0; v < VPL; ++v)
      for (int r = 0; r < RPL; ++r)
        for (int c = 0; c < CPL; ++c) acc[v][r][c] = 0.0f;
    fetch(i0, 0);
    for (int k0 = 0; k0 < Kd; k0 += PK) {
      const int kc = Kd - k0 < PK ? Kd - k0 : PK;
      t.sync();  // the previous chunk's readers are done
      for (int q = 0; q < PF; ++q) {
        const int e = t.lane + NL * q, k = e % PK, i = e / PK;
        if (i < PR_ROWS) As[k * PLDA + i] = pa[q];
      }
      t.sync();
      if (k0 + PK < Kd) fetch(i0, k0 + PK);
      for (int v = 0; v < VPL; ++v) {
        const int vt = t.lane + NL * v, ty = vt / 16, tx = vt % 16;
        const float* bk = B + (long long)k0 * ldb + tx;
        auto step = [&](int k) {
          float a[RPL], b[CPL];
          for (int r = 0; r < RPL; r += 2) load2(As + k * PLDA + ty * RPL + r, a + r);
          for (int c = 0; c < CPL; ++c) b[c] = bk[(long long)k * ldb + 16 * c];
          for (int r = 0; r < RPL; ++r)
            for (int c = 0; c < CPL; ++c) acc[v][r][c] = fmaf(a[r], b[c], acc[v][r][c]);
        };
        if (kc == PK) {
#pragma unroll
          for (int k = 0; k < PK; ++k) step(k);
        } else {
          for (int k = 0; k < kc; ++k) step(k);
        }
      }
    }
    for (int v = 0; v < VPL; ++v) {
      const int vt = t.lane + NL * v, ty = vt / 16, tx = vt % 16;
      for (int r = 0; r < RPL; ++r)
        for (int c = 0; c < CPL; ++c) {
          const int gi = i0 + ty * RPL + r, gj = tx + 16 * c;
          if (gi < M && gj < N) C[(long long)gi * ldc + gj] = alpha * acc[v][r][c];
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
template <int NL, bool OnChip>
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
  const int ei = t.lane / w, ej = t.lane % w;
  for (int p = 0; p < k; ++p) {
    for (int e = t.lane; e < w + k; e += NL) {
      if (e < w) prow[e] = aug[p * w + e] / aug[p * w + p];
      else fac[e - w] = aug[(e - w) * w + p];
    }
    t.sync();
    if constexpr (NL >= 2 * GJ_LEAF * GJ_LEAF) {
      // One element a lane, at (ei, ej) for every pivot.
      if (t.lane < k * w) aug[t.lane] = ei == p ? prow[ej] : aug[t.lane] - fac[ei] * prow[ej];
    } else {
      for (int e = t.lane; e < k * w; e += NL) {
        const int i = e / w, j = e % w;
        aug[e] = i == p ? prow[j] : aug[e] - fac[i] * prow[j];
      }
    }
    t.sync();
  }
  for (int e = t.lane; e < k * k; e += NL) Out[(e / k) * ldo + e % k] = aug[(e / k) * w + k + e % k];
  t.sync();
}

// X <- X^-1 in place, by the symmetrized 2x2 block Schur recursion on
// [A B; . C] (m = n/2, r = n - m).  X is symmetric on entry; only its
// upper block triangle is read, so each level keeps its operands in the
// one buffer:
//   A <- Ai = A^-1                       (the recursion, in place)
//   L <- W^T = (Ai B)^T                  (the dead lower-left block, r x m)
//   C <- S = sym(C - B^T W), then S^-1   (the recursion, in place)
//   B <- Otr = -W S^-1                   (B is dead after the C update)
//   A <- sym(Ai - Otr W^T)
//   L <- Otr^T                           (W is dead)
// W is kept transposed, so it fits the r x m block at odd n too (m < r).
// No product aliases its output with an input, and each output element
// is the same fmaf chain over k as with W, Ai and Out in buffers of their
// own (fmaf is exact in the order of its two factors).  The recursion
// depth is a template parameter, so the compiler sees no runtime recursion
// and the device stack stays static; n <= GJ_LEAF << LEVELS.
template <int NL, bool OnChip, int LEVELS = MAX_LEVELS>
__host__ __device__ ADMM_NOINLINE void schur_inverse(const Team<NL>& t, float* X, int ld, int n,
                                                     float* smem) {
  if constexpr (LEVELS == 0) {
    gj_inverse<NL, OnChip>(t, X, ld, n, X, ld, smem);
    return;
  } else {
  if (n <= GJ_LEAF) {
    gj_inverse<NL, OnChip>(t, X, ld, n, X, ld, smem);
    return;
  }
  const int m = n / 2, r = n - m;
  float* Bm = X + m;                               // X[:m, m:]
  float* L = X + (long long)m * ld;                // X[m:, :m]
  float* C = L + m;                                // X[m:, m:]
  schur_inverse<NL, OnChip, LEVELS - 1>(t, X, ld, m, smem);                               // Ai
  gemm_resident(t, r, m, m, 1.0f, Bm, ld, true, X, ld, true, 0.0f, L, ld);        // W^T
  gemm_resident(t, r, r, m, -1.0f, Bm, ld, true, L, ld, true, 1.0f, C, ld);       // C - B^T W
  symmetrize(t, C, ld, r);                                                       // S
  schur_inverse<NL, OnChip, LEVELS - 1>(t, C, ld, r, smem);                               // S^-1
  gemm_resident(t, m, r, r, -1.0f, L, ld, true, C, ld, false, 0.0f, Bm, ld);      // -W S^-1
  // Ai + (W S^-1) W^T, as Ai - (-W S^-1) W^T: negation is exact.
  gemm_resident(t, m, m, r, -1.0f, Bm, ld, false, L, ld, false, 1.0f, X, ld);
  symmetrize(t, X, ld, m);
  for (int e = t.lane; e < m * r; e += NL) {
    const int i = e / r, j = e % r;
    L[(long long)j * ld + i] = Bm[(long long)i * ld + j];
  }
  t.sync();
  }
}

// dst = (R + R^T) / 2 (dst may be R), by pairs of TS x TS tiles staged
// through `smem`, so that every read and write of R and dst runs along
// rows (both may lie in device memory).
template <int NL>
__host__ __device__ void symmetrize_to(const Team<NL>& t, const float* R, int ldr, float* dst,
                                       int ldd, int n, float* smem) {
  constexpr int TS = 32, LS = TS + 1;
  static_assert(2 * TS * LS <= SCRATCH_FLOATS, "symmetrize tiles exceed the scratch");
  float* S1 = smem;            // R[I.., J..]
  float* S2 = smem + TS * LS;  // R[J.., I..]
  for (int I = 0; I < n; I += TS)
    for (int J = I; J < n; J += TS) {
      const int mi = n - I < TS ? n - I : TS, mj = n - J < TS ? n - J : TS;
      for (int e = t.lane; e < TS * TS; e += NL) {
        const int a = e / TS, b = e % TS;
        if (a < mi && b < mj) S1[a * LS + b] = R[(long long)(I + a) * ldr + J + b];
        if (a < mj && b < mi) S2[a * LS + b] = R[(long long)(J + a) * ldr + I + b];
      }
      t.sync();
      for (int e = t.lane; e < TS * TS; e += NL) {
        const int a = e / TS, b = e % TS;
        if (a < mi && b < mj)
          dst[(long long)(I + a) * ldd + J + b] = 0.5f * (S1[a * LS + b] + S2[b * LS + a]);
        if (a < mj && b < mi)
          dst[(long long)(J + a) * ldd + I + b] = 0.5f * (S2[a * LS + b] + S1[b * LS + a]);
      }
      t.sync();
    }
}

// dst = spd_inverse(K): X = sym(K), the in-place recursion on X, then
// ns_iters Newton-Schulz steps X <- sym(X (2I - K X)) with the
// unsymmetrized K, by column panels J of PANEL columns:
//   T = 2I[:, J] - K X[:, J]   (the panel buffer T, n x PANEL)
//   R[:, J] = X T              (R: n x n, ld ldr, not X: X is read whole
//                               by every panel)
// and then sym(R) into X (between steps) or dst (after the last).  X has
// ld n + 1; dst may be X (ld n + 1), or R itself.  With ns_iters = 0, X
// is copied to dst.  The panel products run as gemm_panel in a block of
// 512 lanes (the invert kernel) and as the staged gemm with fewer.
template <int NL, bool OnChip>
__host__ __device__ ADMM_NOINLINE void spd_inverse(const Team<NL>& t, const float* K, int ldk,
                                                   int n, int ns_iters, float* X, float* T,
                                                   float* R, int ldr, float* dst, int ldd,
                                                   float* smem) {
  const int ldx = n + 1;
  // K to X row by row, many 16-byte loads in flight per lane (n = 12h and
  // ldk = n keep K's rows 16-byte aligned), then X = sym(X) in place.
  {
    constexpr int QB = 6;                        // float4 loads in flight per lane
    const int q4 = n / 4, nq = n * q4;           // float4s of a row, of K
    for (int e0 = t.lane; e0 < nq; e0 += NL * QB) {
      float v[QB][4];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = e0 + NL * u;
        if (e < nq) load4(K + (long long)(e / q4) * ldk + 4 * (e % q4), v[u]);
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = e0 + NL * u;
        if (e < nq)
          for (int c = 0; c < 4; ++c) X[(long long)(e / q4) * ldx + 4 * (e % q4) + c] = v[u][c];
      }
    }
  }
  t.sync();
  for (int e = t.lane; e < n * n; e += NL) {
    const int i = e / n, j = e % n;
    if (i <= j) {
      const float s = 0.5f * (X[(long long)i * ldx + j] + X[(long long)j * ldx + i]);
      X[(long long)i * ldx + j] = s;
      X[(long long)j * ldx + i] = s;
    }
  }
  t.sync();
  schur_inverse<NL, OnChip>(t, X, ldx, n, smem);
  if (ns_iters == 0 && dst != X) {
    for (int e = t.lane; e < n * n; e += NL)
      dst[(long long)(e / n) * ldd + e % n] = X[(long long)(e / n) * ldx + e % n];
    t.sync();
  }
  for (int it = 0; it < ns_iters; ++it) {
    for (int j0 = 0; j0 < n; j0 += PANEL) {
      const int w = n - j0 < PANEL ? n - j0 : PANEL;
      // C (n x w) = alpha A B, for A n x n and B n x w.
      auto product = [&](float alpha, const float* A, int lda, const float* B, int ldb, float* C,
                         int ldc) {
        if constexpr (NL >= 512)
          gemm_panel<NL, OnChip>(t, n, w, n, alpha, A, lda, B, ldb, C, ldc, smem);
        else
          gemm<NL, OnChip>(t, n, w, n, alpha, A, lda, false, B, ldb, false, 0.0f, C, ldc, smem);
      };
      product(-1.0f, K, ldk, X + j0, ldx, T, PANEL);                        // -K X
      for (int j = t.lane; j < w; j += NL) T[(long long)(j0 + j) * PANEL + j] += 2.0f;
      t.sync();
      product(1.0f, X, ldx, T, PANEL, R + j0, ldr);                         // X T
    }
    if (it + 1 < ns_iters) symmetrize_to(t, R, ldr, X, ldx, n, smem);
    else symmetrize_to(t, R, ldr, dst, ldd, n, smem);
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
// `kinv_smem` is null, then the sweeps.  `smem` holds the vectors.  The
// kernel passes its shared-memory array itself (not a pointer chosen at
// run time), so the copy compiles to shared-memory stores.
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

// Kernel 4, one scenario: invert K in place into l.X (Kinv, ld n + 1),
// then the sweeps.
template <int NL, bool OnChip>
__host__ __device__ void fused_one(const Team<NL>& t, const float* K, const Layout& l,
                                   const IterArgs& a, int n, int m, float mu, int iterations,
                                   float sigma, float alpha, int ns_iters) {
  Vecs v;
  carve(l.vecs, n, m, v);
  spd_inverse<NL, OnChip>(t, K, n, n, ns_iters, l.X, l.T, l.R, n, l.X, n + 1, l.tiles);
  load_iter_vectors(t, a, n, m, v);
  admm_iterations(t, l.X, n + 1, n, mu, v, iterations, sigma, alpha);
  store_iter_result(t, a, n, m, v);
}

// Operands of one scenario for the full kernel.
struct FullArgs {
  const float *H, *g, *srow, *l, *u, *U0, *lam0;
  float *U, *lam;
};

// Kernel 5, one scenario: Ruiz scaling, cone-row scaling, per-row rho,
// K = Hs + A^T rho A + sigma I, inversion, the warm-start map, the sweeps
// and the unscaling.  K is assembled in l.Kw and inverted into l.X.
template <int NL, bool OnChip>
__host__ __device__ void full_one(const Team<NL>& t, const FullArgs& a, const Layout& l, int n,
                                  int m, float mu, int iterations, float sigma, float alpha,
                                  int ns_iters, int ruiz_iters, float rho_ineq, float rho_eq) {
  Vecs v;
  float* extra = carve(l.vecs, n, m, v);
  float* delta = extra;          // n
  const long long nn = (long long)n * n;
  float* Kw = l.Kw;
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

  spd_inverse<NL, OnChip>(t, Kw, n, n, ns_iters, l.X, l.T, l.R, n, l.X, n + 1, l.tiles);

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
  admm_iterations(t, l.X, n + 1, n, mu, v, iterations, sigma, alpha);
  for (int i = t.lane; i < n; i += NL) a.U[i] = v.x[i] * v.d[i];
  for (int i = t.lane; i < m; i += NL) a.lam[i] = v.es[i] * v.y[i];
}

}  // namespace admm

// Exported by every library built from this header (the CUDA kernels,
// their host builds), so that the wrapper refuses a larger n with a
// message.
extern "C" int admm_max_n() { return admm::MAX_N; }
