// Device helpers shared by the dense sweeps (pairs.cu) and the
// interacting-tile-list sweeps (tiles.cu): the spline constants and lookup,
// minimum image, the Born sweep's pair, and the warp reductions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AGBNP_NA 16          // spline nodes (models/constants.py)
#define FULL_MASK 0xffffffffu

// spline grid step h = AGBNP_I4LOOKUP_MAXA / (NA - 1) = 2 / 15 nm, and the
// derived constants in the order the JAX kernel forms them
__device__ __forceinline__ float spline_h() { return (float)(2.0 / 15.0); }
__device__ __forceinline__ float spline_inv_h() { return 7.5f; }
__device__ __forceinline__ float spline_hh() {
  return (float)((2.0 / 15.0) * (2.0 / 15.0));
}
__device__ __forceinline__ float spline_h6() { return (float)((2.0 / 15.0) / 6.0); }

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Minimum image of dx = pos_j - pos_i.  box_mode 0: none; 1: orthorhombic
// box[0..2]; 2: reduced triclinic rows a;b;c in box[0..8], wrapped along c,
// then b, then a (ops/born.py::min_image).  rintf rounds half to even like
// jnp.round / torch.round.
__device__ __forceinline__ void min_image(int box_mode, const float* box,
                                          float& dx, float& dy, float& dz) {
  if (box_mode == 1) {
    dx -= box[0] * rintf(dx * (1.0f / box[0]));
    dy -= box[1] * rintf(dy * (1.0f / box[1]));
    dz -= box[2] * rintf(dz * (1.0f / box[2]));
  } else if (box_mode == 2) {
    float k = rintf(dz * (1.0f / box[8]));
    dx -= k * box[6]; dy -= k * box[7]; dz -= k * box[8];
    k = rintf(dy * (1.0f / box[4]));
    dx -= k * box[3]; dy -= k * box[4];
    dx -= box[0] * rintf(dx * (1.0f / box[0]));
  }
}

// Copy the [Ti, Tj, NA] y and y2 tables (ntab floats each) into shared
// memory: y at tab[0, ntab), y2 at tab[ntab, 2 ntab).  The caller
// synchronises.
__device__ __forceinline__ void stage_tables(float* tab,
                                             const float* __restrict__ yval,
                                             const float* __restrict__ y2val,
                                             int ntab) {
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) {
    tab[k] = yval[k];
    tab[ntab + k] = y2val[k];
  }
}

// Q and dQ/dd of the cubic spline at distance d for the type pair whose
// node row starts at tab[tpair * NA] (tpair = type_row * Tj + type_col).
__device__ __forceinline__ void spline_qdq(const float* tab, int ntab,
                                           int tpair, float d, float& q,
                                           float& dq) {
  const float h = spline_h(), inv_h = spline_inv_h();
  int seg = (int)(d * inv_h);
  seg = min(max(seg, 0), AGBNP_NA - 2);
  const int base = tpair * AGBNP_NA + seg;
  const float y0 = tab[base], y1 = tab[base + 1];
  const float y20 = tab[ntab + base], y21 = tab[ntab + base + 1];
  const float a = ((float)seg * h + h - d) * inv_h;
  const float b = 1.0f - a;
  q = a * y0 + b * y1
      + ((a * a * a - a) * y20 + (b * b * b - b) * y21) * spline_hh() / 6.0f;
  dq = (y1 - y0) * inv_h
       + ((3.0f * b * b - 1.0f) * y21 - (3.0f * a * a - 1.0f) * y20) * spline_h6();
}

// What a recomputing descreening sweep needs to re-evaluate the Born sweep's
// masked spline: screener permuted-row ids, row and column radius types, the
// [Ti, Tj, NA] tables (ntab = Ti Tj NA floats each), n and the horizon.
struct SplineRefs {
  const int* hids;
  const int* trow;
  const int* tcol;
  const float* yval;
  const float* y2val;
  int ntab;
  int ntj;
  int n;
  float horizon;
};

// The Born sweep's pair mask: a real screened row i, a real heavy screener
// column (permuted-row id gj >= 0) that is not the row itself, inside the
// horizon.
__device__ __forceinline__ bool born_pair_live(int i, int gj, int n, float d,
                                               float horizon) {
  return i < n && gj >= 0 && gj != i && d < horizon;
}

// One pair of the Born sweep: row i (position xi, yi, zi; its type row
// starts at tbase) and a column at col.xyz with screening factor col.w,
// permuted-row id gj and type tcj.  Q and dQ/dd where the Born mask accepts
// the pair (else zero), and its term added to row i's sum.
__device__ __forceinline__ void born_pair(const float* tab,
                                          const SplineRefs& sp, int i,
                                          int tbase, float xi, float yi,
                                          float zi, float4 col, int gj,
                                          int tcj, int box_mode,
                                          const float* box, float& acc,
                                          float& qv, float& dqv) {
  float dx = col.x - xi, dy = col.y - yi, dz = col.z - zi;
  min_image(box_mode, box, dx, dy, dz);
  const float d = sqrtf(dx * dx + dy * dy + dz * dz);
  qv = 0.0f;
  dqv = 0.0f;
  if (born_pair_live(i, gj, sp.n, d, sp.horizon)) {
    spline_qdq(tab, sp.ntab, tbase + tcj, d, qv, dqv);
    acc += qv * col.w;
  }
}
