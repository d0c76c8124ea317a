// AGBNP1 O(N^2) pair sweeps for Hopper (sm_90a), f32.
//
// Three sweeps with a data dependency between them (Born radii -> GB pair
// energy -> descreening derivatives), each launched from its Python wrapper
// in ops/kernels/pairs.py, which also holds the plain PyTorch twin of each:
//
//   agbnp_born_sums     raw_i = sum_j s_j Q4(d_ij), saving Q and dQ/dd
//   agbnp_gb_pair       GB pair energy, Y accumulators, direct forces,
//                       optionally with the OPLS LJ + Coulomb sum fused in
//   agbnp_descreening   W_j/U_j column sums + direct descreening forces
//                       from the saved Q/dQ
//
// Layouts are the JAX wrappers' (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py):
// positions [3, NP] (Morton-permuted rows, NP padded) and [3, NHP]
// (heavy-atom screener columns, -1 ids on padding), row outputs [NP],
// column outputs [NHP], Q/dQ [NP, NHP] row-major.
//
// Determinism: no float atomics anywhere.  A row sum is owned by one warp
// (lanes stride the columns, then a fixed shuffle tree); a column sum is
// owned by one thread per row chunk, and the chunk partials are summed in
// chunk order by a small reduction kernel.  Energies and forces are
// therefore bitwise identical from run to run.
//
// Each host function launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define AGBNP_NA 16          // spline nodes (models/constants.py)
#define WARPS_PER_BLOCK 8
#define COL_THREADS 128
#define ROW_CHUNK 64

// spline grid step h = AGBNP_I4LOOKUP_MAXA / (NA - 1) = 2 / 15 nm, and the
// derived constants in the order the JAX kernel forms them
__device__ __forceinline__ float spline_h() { return (float)(2.0 / 15.0); }
__device__ __forceinline__ float spline_inv_h() { return 7.5f; }
__device__ __forceinline__ float spline_hh() {
  return (float)((2.0 / 15.0) * (2.0 / 15.0));
}
__device__ __forceinline__ float spline_h6() { return (float)((2.0 / 15.0) / 6.0); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // complete in lane 0
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

// ---------------------------------------------------------------------------
// Born sums.  Replaces _born_kernel / born_sums
// (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:353-447).
//
// Bound on the H100: at 1li2 shapes (NP 1536, NHP 768) it does ~1.2M pair
// evaluations of ~40 flops plus 4 table reads each, and writes Q and dQ
// (9.4 MB), which is the largest traffic; everything fits L2.  Design: the
// TPU's 16-step one-hot matmul node selection becomes direct loads from the
// [Ti, Tj, NA] y/y2 tables staged in shared memory (exact by construction);
// one warp per row, lanes over columns, so Q/dQ stores are coalesced and the
// row sum needs no atomics.
// ---------------------------------------------------------------------------
__global__ void born_rows_kernel(const float* __restrict__ pos, int np,
                                 const float* __restrict__ posh, int nhp,
                                 const int* __restrict__ hids,
                                 const int* __restrict__ trow,
                                 const int* __restrict__ tcol,
                                 const float* __restrict__ yval,
                                 const float* __restrict__ y2val,
                                 int ntab, int ntj,
                                 const float* __restrict__ s, int n,
                                 float horizon, int box_mode,
                                 const float* __restrict__ box,
                                 float* __restrict__ raw,
                                 float* __restrict__ q_out,
                                 float* __restrict__ dq_out) {
  extern __shared__ float tab[];  // y [ntab] then y2 [ntab]
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) {
    tab[k] = yval[k];
    tab[ntab + k] = y2val[k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (i >= np) return;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const int tbase = trow[i] * ntj;
  const bool row_ok = i < n;
  const float h = spline_h(), inv_h = spline_inv_h();
  float acc = 0.0f;
  for (int j = lane; j < nhp; j += 32) {
    float dx = posh[j] - xi, dy = posh[nhp + j] - yi, dz = posh[2 * nhp + j] - zi;
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    const int gj = hids[j];
    float qv = 0.0f, dqv = 0.0f;
    if (row_ok && gj >= 0 && gj != i && d < horizon) {
      int seg = (int)(d * inv_h);
      seg = min(max(seg, 0), AGBNP_NA - 2);
      const int base = (tbase + tcol[j]) * AGBNP_NA + seg;
      const float y0 = tab[base], y1 = tab[base + 1];
      const float y20 = tab[ntab + base], y21 = tab[ntab + base + 1];
      const float a = ((float)seg * h + h - d) * inv_h;
      const float b = 1.0f - a;
      qv = a * y0 + b * y1
           + ((a * a * a - a) * y20 + (b * b * b - b) * y21) * spline_hh() / 6.0f;
      dqv = (y1 - y0) * inv_h
            + ((3.0f * b * b - 1.0f) * y21 - (3.0f * a * a - 1.0f) * y20) * spline_h6();
      acc += qv * s[j];
    }
    if (q_out != nullptr) {
      q_out[(size_t)i * nhp + j] = qv;
      dq_out[(size_t)i * nhp + j] = dqv;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) raw[i] = acc;
}

extern "C" int agbnp_born_sums(const float* pos, int np, const float* posh,
                               int nhp, const int* hids, const int* trow,
                               const int* tcol, const float* yval,
                               const float* y2val, int nti, int ntj,
                               const float* s, int n, float horizon,
                               int box_mode, const float* box, float* raw,
                               float* q_out, float* dq_out, void* stream) {
  const int ntab = nti * ntj * AGBNP_NA;
  const size_t smem = 2 * (size_t)ntab * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(born_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const int blocks = (np + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  born_rows_kernel<<<blocks, 32 * WARPS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      pos, np, posh, nhp, hids, trow, tcol, yval, y2val, ntab, ntj, s, n,
      horizon, box_mode, box, raw, q_out, dq_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GB pair sweep.  Replaces _gb_kernel / gb_pair
// (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:454-593).
//
// Bound on the H100: ~2.4M ordered pairs at NP 1536, each an exp, a sqrt and
// two divisions (plus the LJ/Coulomb terms and an E-wide exclusion scan with
// MM), so it is bound by special-function and issue throughput, not memory
// (inputs are a few KB per row and stay in L1/L2).  Design: the TPU kernel
// deposits each unordered pair on both sides into VMEM-resident full-width
// accumulators, which relies on its serial grid; here every ordered pair is
// evaluated on its own row (the full square, twice the pair work) so each
// row's sums belong to one warp and no column scatter is needed.  The
// per-pair values are symmetric bit for bit, so the result equals the
// triangular deposit.  Exclusions: the row's E-wide list sits in shared
// memory and is scanned per pair.
// ---------------------------------------------------------------------------
__global__ void gb_rows_kernel(const float* __restrict__ pos, int np,
                               const float* __restrict__ charge,
                               const float* __restrict__ born,
                               const float* __restrict__ sig,
                               const float* __restrict__ epsq,
                               const int* __restrict__ excl, int ne, int n,
                               float cutoff2, int box_mode,
                               const float* __restrict__ box, float dfac,
                               float ke, float* __restrict__ erow,
                               float* __restrict__ yrow,
                               float* __restrict__ force,
                               float* __restrict__ mmrow) {
  extern __shared__ int sh_excl[];  // [WARPS_PER_BLOCK, ne]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS_PER_BLOCK + warp;
  const bool with_mm = mmrow != nullptr;
  int* my_excl = sh_excl + warp * ne;
  if (with_mm && i < np) {
    for (int k = lane; k < ne; k += 32) my_excl[k] = excl[(size_t)i * ne + k];
  }
  __syncwarp();
  if (i >= np) return;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const float qi = charge[i], bi = born[i];
  const float si = with_mm ? sig[i] : 0.0f, ei = with_mm ? epsq[i] : 0.0f;
  const bool row_ok = i < n;
  float e = 0.0f, y = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f, mm = 0.0f;
  for (int j = lane; j < np; j += 32) {
    if (!row_ok || j >= n || j == i) continue;
    float dx = pos[j] - xi, dy = pos[np + j] - yi, dz = pos[2 * np + j] - zi;
    min_image(box_mode, box, dx, dy, dz);
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (cutoff2 >= 0.0f && !(d2 < cutoff2)) continue;
    const float bb = bi * born[j];
    const float etij = expf(-0.25f * d2 / bb);
    const float fgb = 1.0f / sqrtf(d2 + bb * etij);
    const float qq_f = qi * charge[j];
    const float qq = dfac * qq_f;
    const float fgb3 = fgb * fgb * fgb;
    float mw = -2.0f * qq * (1.0f - 0.25f * etij) * fgb3;
    e += qq * fgb;
    y += qq_f * (bb + 0.25f * d2) * etij * fgb3;
    if (with_mm) {
      bool excluded = false;
      for (int k = 0; k < ne; ++k) excluded |= (my_excl[k] == j);
      if (!excluded) {
        const float inv2 = 1.0f / d2;
        const float sr2 = (si * sig[j]) * inv2;
        const float sr6 = sr2 * sr2 * sr2;
        const float epsij = ei * epsq[j];
        const float ecoul = ke * qq_f * (1.0f / sqrtf(d2));
        const float elj = 4.0f * epsij * (sr6 * sr6 - sr6);
        mm += elj + ecoul;
        const float dmm = (4.0f * epsij * (-6.0f * sr6 * sr6 + 3.0f * sr6)
                           - 0.5f * ecoul) * inv2;
        mw = mw + 2.0f * dmm;
      }
    }
    fx += dx * mw;
    fy += dy * mw;
    fz += dz * mw;
  }
  e = warp_sum(e);
  y = warp_sum(y);
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  mm = warp_sum(mm);
  if (lane == 0) {
    erow[i] = e;
    yrow[i] = y;
    force[3 * (size_t)i] = fx;
    force[3 * (size_t)i + 1] = fy;
    force[3 * (size_t)i + 2] = fz;
    if (with_mm) mmrow[i] = mm;
  }
}

extern "C" int agbnp_gb_pair(const float* pos, int np, const float* charge,
                             const float* born, const float* sig,
                             const float* epsq, const int* excl, int ne, int n,
                             float cutoff2, int box_mode, const float* box,
                             float dfac, float ke, float* erow, float* yrow,
                             float* force, float* mmrow, void* stream) {
  const size_t smem = (size_t)WARPS_PER_BLOCK * (mmrow != nullptr ? ne : 0) * sizeof(int);
  const int blocks = (np + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  gb_rows_kernel<<<blocks, 32 * WARPS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      pos, np, charge, born, sig, epsq, excl, mmrow != nullptr ? ne : 0, n,
      cutoff2, box_mode, box, dfac, ke, erow, yrow, force, mmrow);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Descreening from the saved Q/dQ.  Replaces _descreen_qd_kernel /
// descreening (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:654-757).
//
// Bound on the H100: it streams Q and dQ (9.4 MB at 1li2 shapes, L2
// resident after the Born pass) twice, once per orientation, with a few
// flops per pair: memory/latency bound.  Design: the TPU kernel keeps the
// [1, NHP] column accumulators resident across its serial grid; here the
// row forces come from one warp per row (as in the Born sweep), and the
// column sums (W, U, force on the screeners) from one thread per column
// over a chunk of ROW_CHUNK rows, writing [chunks, 5, NHP] partials that a
// third kernel adds in chunk order.  Q and dQ reads are coalesced in both.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float inv_or_zero(float d) {
  return d > 0.0f ? 1.0f / d : 0.0f;
}

__global__ void descreen_rows_kernel(const float* __restrict__ pos, int np,
                                     const float* __restrict__ posh, int nhp,
                                     const float* __restrict__ dq,
                                     const float* __restrict__ s,
                                     const float* __restrict__ brw,
                                     const float* __restrict__ bru,
                                     int box_mode,
                                     const float* __restrict__ box,
                                     float* __restrict__ f_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (i >= np) return;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const float bsum = brw[i] + bru[i];
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int j = lane; j < nhp; j += 32) {
    const float dqv = dq[(size_t)i * nhp + j];
    if (dqv == 0.0f) continue;
    float dx = posh[j] - xi, dy = posh[nhp + j] - yi, dz = posh[2 * nhp + j] - zi;
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    const float c = bsum * s[j] * dqv * inv_or_zero(d);
    fx += c * dx;
    fy += c * dy;
    fz += c * dz;
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  if (lane == 0) {
    f_rows[3 * (size_t)i] = fx;
    f_rows[3 * (size_t)i + 1] = fy;
    f_rows[3 * (size_t)i + 2] = fz;
  }
}

__global__ void descreen_cols_kernel(const float* __restrict__ pos, int np,
                                     const float* __restrict__ posh, int nhp,
                                     const float* __restrict__ q,
                                     const float* __restrict__ dq,
                                     const float* __restrict__ s,
                                     const float* __restrict__ brw,
                                     const float* __restrict__ bru,
                                     int box_mode,
                                     const float* __restrict__ box,
                                     float* __restrict__ partial) {
  const int j = blockIdx.x * COL_THREADS + threadIdx.x;
  const int chunk = blockIdx.y;
  if (j >= nhp) return;
  const float xj = posh[j], yj = posh[nhp + j], zj = posh[2 * nhp + j];
  const float sj = s[j];
  float w = 0.0f, u = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
  const int i1 = min(np, (chunk + 1) * ROW_CHUNK);
  for (int i = chunk * ROW_CHUNK; i < i1; ++i) {
    const float qv = q[(size_t)i * nhp + j];
    const float dqv = dq[(size_t)i * nhp + j];
    const float bw = brw[i], bu = bru[i];
    w += bw * qv;
    u += bu * qv;
    if (dqv == 0.0f) continue;
    float dx = xj - pos[i], dy = yj - pos[np + i], dz = zj - pos[2 * np + i];
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    const float c = (bw + bu) * sj * dqv * inv_or_zero(d);
    fx -= c * dx;
    fy -= c * dy;
    fz -= c * dz;
  }
  float* p = partial + (size_t)chunk * 5 * nhp;
  p[j] = w;
  p[nhp + j] = u;
  p[2 * nhp + j] = fx;
  p[3 * nhp + j] = fy;
  p[4 * nhp + j] = fz;
}

__global__ void descreen_reduce_kernel(const float* __restrict__ partial,
                                       int nchunks, int nhp,
                                       float* __restrict__ w_out,
                                       float* __restrict__ u_out,
                                       float* __restrict__ f_cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nhp) return;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < nchunks; ++c) {
    const float* p = partial + (size_t)c * 5 * nhp;
    for (int k = 0; k < 5; ++k) acc[k] += p[(size_t)k * nhp + j];
  }
  w_out[j] = acc[0];
  u_out[j] = acc[1];
  f_cols[3 * (size_t)j] = acc[2];
  f_cols[3 * (size_t)j + 1] = acc[3];
  f_cols[3 * (size_t)j + 2] = acc[4];
}

extern "C" int agbnp_descreen_chunks(int np) {
  return (np + ROW_CHUNK - 1) / ROW_CHUNK;
}

extern "C" int agbnp_descreening(const float* pos, int np, const float* posh,
                                 int nhp, const float* q, const float* dq,
                                 const float* s, const float* brw,
                                 const float* bru, int box_mode,
                                 const float* box, float* partial,
                                 float* w_out, float* u_out, float* f_rows,
                                 float* f_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int row_blocks = (np + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  descreen_rows_kernel<<<row_blocks, 32 * WARPS_PER_BLOCK, 0, st>>>(
      pos, np, posh, nhp, dq, s, brw, bru, box_mode, box, f_rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int nchunks = agbnp_descreen_chunks(np);
  dim3 grid((nhp + COL_THREADS - 1) / COL_THREADS, nchunks);
  descreen_cols_kernel<<<grid, COL_THREADS, 0, st>>>(
      pos, np, posh, nhp, q, dq, s, brw, bru, box_mode, box, partial);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  descreen_reduce_kernel<<<(nhp + 127) / 128, 128, 0, st>>>(
      partial, nchunks, nhp, w_out, u_out, f_cols);
  return (int)cudaGetLastError();
}
