// Per-scenario arithmetic of the condensing kernel (condense.cu): the
// masked condensed QP of one scenario, (Ad, Bd, x_t, X_ref, mv) -> (H, g),
// what cones.mask_cost(*condense.condense(...), mv) returns in
// pympc_quadruped_tpu_torch/ops (the JAX package's ops/condense.py and
// ops/qp/cones.py, plain XLA there).
//
// One thread block builds one scenario: its NL lanes split each phase as
// `for (e = lane; e < N; e += NL)`, with Team::sync() between dependent
// phases.  The code is plain C++ marked __host__ __device__: condense.cu
// instantiates it with NL = 256 and __syncthreads(), condense_host.cpp with
// NL = 1 and a no-op barrier, so a host compiler runs the same arithmetic on
// the CPU.  Every output is one lane's sum in a fixed order (a 13-long fmaf
// chain a step, added to a running sum over the steps: the running sum
// meets a few rounding errors per step, not thirteen), so the result does
// not depend on NL.
//
// Math (k < h, i < h; W_k = sqrt(Q) M_k, M_k = Ad^k Bd, z_i = sqrt(Q) (x_{i+1}
// - X_ref_i) with x_0 = x_t, x_{i+1} = Ad x_i the free trajectory):
//   Su is block-Toeplitz, block (i, j) = M_{i-j} for i >= j, so block (j, j')
//   of Su^T Qbar Su, j <= j', is
//     S(d, e) = sum_{c=0..e} W_{c+d}^T W_c,   d = j' - j, e = h-1-j',
//   a running sum over c for each d: h(h+1)/2 distinct 12 x 12 blocks, one
//   for each block of H's upper triangle, and no structural zero multiplied;
//   the blocks below the diagonal are their mirrors' transposes, so H is
//   exactly symmetric (S(0, e) is too: its (a, b) and (b, a) chains multiply
//   the same pairs in the same order);
//   H = 2 S + 2 Rbar, then masked:  H_pq mv_p mv_q + [p == q] (1 - mv_p);
//   g_j = 2 sum_{i >= j} W_{i-j}^T z_i, then g mv.
// Exact f32 FMA only (no fast-math, no tensor cores).
#pragma once

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#endif

namespace condense {

constexpr int NX = 13;               // state rows
constexpr int NU = 12;               // inputs a step
constexpr int MB = NX * NU;          // floats of one M_k or W_k, row-major [s][a]
constexpr int TILE = 4;              // S's register micro-tile: 4 x 4 of a 12 x 12 block
constexpr int TILES = (NU / TILE) * (NU / TILE);
// The largest horizon at which two blocks stay resident on an SM (114 KB of
// shared memory a block at h = 18; S alone takes 72 h(h+1) floats).  Past
// it a block would have an SM to itself, and build_qp keeps the plain
// condensing there (PERF.md, section 6).
constexpr int MAX_H = 18;
constexpr long long SMEM_LIMIT = 232448;

template <int NL>
struct Team {
  int lane;
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

__host__ __device__ inline int round4(int f) { return (f + 3) & ~3; }

// Shared-memory layout of one block, in floats, every part 16-byte aligned:
// S (h(h+1)/2 blocks of 144, d-major), W (h x 156), M (two 156 buffers),
// Ad, Bd, the free state (two buffers of 16), z (h x 13), sqrt(q), mv.
struct Layout {
  float *S, *W, *M, *Ad, *Bd, *x, *z, *sq, *mv;
};

__host__ __device__ inline int s_blocks(int h) { return h * (h + 1) / 2; }

__host__ __device__ inline long long smem_floats(int h) {
  return (long long)s_blocks(h) * NU * NU + (long long)h * MB + 2 * MB + round4(NX * NX) +
         MB + 32 + round4(h * NX) + 16 + round4(NU * h);
}

__host__ __device__ inline Layout layout(float* smem, int h) {
  Layout l;
  l.S = smem;
  l.W = l.S + s_blocks(h) * NU * NU;
  l.M = l.W + h * MB;
  l.Ad = l.M + 2 * MB;
  l.Bd = l.Ad + round4(NX * NX);
  l.x = l.Bd + MB;
  l.z = l.x + 32;
  l.sq = l.z + round4(h * NX);
  l.mv = l.sq + 16;
  return l;
}

// Block (d, e) of S: the d-th run holds e = 0 .. h-1-d.
__host__ __device__ inline float* s_block(const Layout& l, int h, int d, int e) {
  return l.S + (long long)(d * h - d * (d - 1) / 2 + e) * NU * NU;
}

// One scenario's operands: Ad (13 x 13), Bd (13 x 12), x_t (13), X_ref
// (h x 13), mv (12 h), and the outputs H (12h x 12h) and g (12 h); q, r the
// cost's diagonals (13, 12), shared by every scenario.
struct Args {
  const float *Ad, *Bd, *x_t, *X_ref, *mv, *q, *r;
  float *H, *g;
};

__host__ __device__ inline Args scenario_args(const Args& a, long long b, int h) {
  const long long n = (long long)NU * h;
  return Args{a.Ad + b * NX * NX, a.Bd + b * MB,  a.x_t + b * NX, a.X_ref + b * NX * h,
              a.mv + b * n,       a.q,            a.r,            a.H + b * n * n,
              a.g + b * n};
}

// Four floats from a 16-byte aligned address; one 16-byte load on the card.
__host__ __device__ inline void load4(const float* src, float* v) {
#ifdef __CUDA_ARCH__
  const float4 f = *reinterpret_cast<const float4*>(src);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
#else
  for (int k = 0; k < 4; ++k) v[k] = src[k];
#endif
}

// Four floats to a 16-byte aligned shared-memory address.
__host__ __device__ inline void store_s(float* dst, const float* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int k = 0; k < 4; ++k) dst[k] = v[k];
#endif
}

// Four floats to a 16-byte aligned address; on the card one streaming
// store (H is read by the next kernel, not by this one).
__host__ __device__ inline void store4(float* dst, const float* v) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
#else
  for (int k = 0; k < 4; ++k) dst[k] = v[k];
#endif
}

// Four floats of H's row p = 12 j + ai from column q0 = 12 jq + b0 on (b0 a
// multiple of 4, so the four share jq), masked.
__host__ __device__ inline void h_quad(const Layout& l, const float* r, int h, int p, int q0,
                                       float* out) {
  const int j = p / NU, ai = p % NU, jq = q0 / NU, b0 = q0 % NU;
  float v[4];
  if (j <= jq) {
    load4(s_block(l, h, jq - j, h - 1 - jq) + ai * NU + b0, v);
  } else {
    const float* s = s_block(l, h, j - jq, h - 1 - j) + b0 * NU + ai;
    for (int k = 0; k < 4; ++k) v[k] = s[k * NU];
  }
  const float mp = l.mv[p];
  for (int k = 0; k < 4; ++k) {
    const int q = q0 + k;
    float hv = 2.0f * v[k];
    if (q == p) hv += 2.0f * r[ai];
    out[k] = hv * mp * l.mv[q] + (q == p ? 1.0f - mp : 0.0f);
  }
}

template <int NL>
__host__ __device__ void condense_one(const Team<NL>& t, const Args& a, float* smem, int h) {
  const Layout l = layout(smem, h);
  const int n = NU * h;

  // Operands in; W_0 = sqrt(q) Bd, M_0 = Bd.
  for (int e = t.lane; e < NX * NX; e += NL) l.Ad[e] = a.Ad[e];
  for (int e = t.lane; e < MB; e += NL) l.Bd[e] = a.Bd[e];
  for (int e = t.lane; e < NX; e += NL) {
    l.sq[e] = sqrtf(a.q[e]);
    l.x[e] = a.x_t[e];
  }
  for (int e = t.lane; e < n; e += NL) l.mv[e] = a.mv[e];
  t.sync();
  for (int e = t.lane; e < MB; e += NL) {
    l.M[e] = l.Bd[e];
    l.W[e] = l.sq[e / NU] * l.Bd[e];
  }

  // Step k: M_k = Ad M_{k-1} (k >= 1) into M's buffer k % 2, and the free
  // state x_{k+1} = Ad x_k into x's buffer (k + 1) % 2, z_k = sqrt(q)
  // (x_{k+1} - X_ref_k).
  for (int k = 0; k < h; ++k) {
    const float* Mp = l.M + ((k + 1) & 1) * MB;
    float* Mk = l.M + (k & 1) * MB;
    const float* xp = l.x + (k & 1) * 16;
    float* xk = l.x + ((k + 1) & 1) * 16;
    for (int e = t.lane; e < MB + NX; e += NL) {
      if (e < MB) {
        if (k == 0) continue;
        const int s = e / NU, ai = e % NU;
        float acc = 0.0f;
        for (int c = 0; c < NX; ++c) acc = fmaf(l.Ad[s * NX + c], Mp[c * NU + ai], acc);
        Mk[e] = acc;
        l.W[k * MB + e] = l.sq[s] * acc;
      } else {
        const int s = e - MB;
        float acc = 0.0f;
        for (int c = 0; c < NX; ++c) acc = fmaf(l.Ad[s * NX + c], xp[c], acc);
        xk[s] = acc;
        l.z[k * NX + s] = l.sq[s] * (acc - a.X_ref[k * NX + s]);
      }
    }
    t.sync();
  }

  // g (n items) first, then S in 4 x 4 tiles, d-major (the long runs, small
  // d, start on the lanes past g's).
  const int n_s = h * TILES;
  for (int it = t.lane; it < n + n_s; it += NL) {
    if (it < n) {
      const int j = it / NU, ai = it % NU;
      float acc = 0.0f;
      for (int i = j; i < h; ++i) {
        const float* Wk = l.W + (i - j) * MB + ai;
        const float* zi = l.z + i * NX;
        float part = 0.0f;
        for (int s = 0; s < NX; ++s) part = fmaf(Wk[s * NU], zi[s], part);
        acc += part;
      }
      a.g[it] = (2.0f * acc) * l.mv[it];
      continue;
    }
    const int item = it - n;
    const int d = item / TILES, tile = item % TILES;
    const int a0 = (tile / (NU / TILE)) * TILE, b0 = (tile % (NU / TILE)) * TILE;
    float acc[TILE][TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u)
#pragma unroll
      for (int v = 0; v < TILE; ++v) acc[u][v] = 0.0f;
    for (int e = 0; e + d < h; ++e) {
      const float* Wl = l.W + (e + d) * MB + a0;
      const float* Wr = l.W + e * MB + b0;
      float part[TILE][TILE];
#pragma unroll
      for (int u = 0; u < TILE; ++u)
#pragma unroll
        for (int v = 0; v < TILE; ++v) part[u][v] = 0.0f;
#pragma unroll
      for (int s = 0; s < NX; ++s) {
        float wl[TILE], wr[TILE];
        load4(Wl + s * NU, wl);
        load4(Wr + s * NU, wr);
#pragma unroll
        for (int u = 0; u < TILE; ++u)
#pragma unroll
          for (int v = 0; v < TILE; ++v) part[u][v] = fmaf(wl[u], wr[v], part[u][v]);
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u)
#pragma unroll
        for (int v = 0; v < TILE; ++v) acc[u][v] += part[u][v];
      float* dst = s_block(l, h, d, e);
#pragma unroll
      for (int u = 0; u < TILE; ++u) store_s(dst + (a0 + u) * NU + b0, acc[u]);
    }
  }
  t.sync();

  // H, written once in row order, four floats a store.
  const int q4 = n / 4;
  for (int e = t.lane; e < n * q4; e += NL) {
    const int p = e / q4, q0 = (e % q4) * 4;
    float v[4];
    h_quad(l, a.r, h, p, q0, v);
    store4(a.H + (long long)p * n + q0, v);
  }
}

}  // namespace condense
