// AGBNP1 O(N^2) pair sweeps for Hopper (sm_90a), f32.
//
// Three sweeps with a data dependency between them (Born radii -> GB pair
// energy -> descreening derivatives), each launched from its Python wrapper
// in ops/kernels/pairs.py, which also holds the plain PyTorch twin of each.
// Two of them have their dense-grid kernel here:
//
//   agbnp_born_sums     raw_i = sum_j s_j Q4(d_ij), saving Q and dQ/dd
//   agbnp_descreening   W_j/U_j column sums + direct descreening forces
//                       with the spline recomputed
//
// tiles.cu holds the same sweeps over interacting-tile lists; the GB pair
// sweep and the descreening sweep that reloads the saved Q/dQ run over the
// dense grid as its list kernels over a list of every tile pair.
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

#include "common.cuh"

#define WARPS_PER_BLOCK 8
#define COL_THREADS 128
#define ROW_CHUNK 64

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
  stage_tables(tab, yval, y2val, ntab);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (i >= np) return;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const int tbase = trow[i] * ntj;
  float acc = 0.0f;
  for (int j = lane; j < nhp; j += 32) {
    float dx = posh[j] - xi, dy = posh[nhp + j] - yi, dz = posh[2 * nhp + j] - zi;
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    float qv = 0.0f, dqv = 0.0f;
    if (born_pair_live(i, hids[j], n, d, horizon)) {
      spline_qdq(tab, ntab, tbase + tcol[j], d, qv, dqv);
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
// The GB pair sweep over the dense grid (gb_pair, which replaces _gb_kernel
// / gb_pair, openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:454-593) has no
// kernel of its own: it is tiles.cu's sub-tile GB kernel over the list of
// every tile pair ti <= tj (ops/kernels/pairs.py::gb_pair), which takes
// each unordered pair once, skips the 32x32 sub-tile pairs beyond the
// cutoff before it walks them, and tests exclusions as one bit a pair.
//
// agbnp_empty_launch: one launch of a kernel that does nothing, the floor
// under any kernel's time, for a tool to put beside a bound of a few tenths
// of a microsecond.
// ---------------------------------------------------------------------------
__global__ void empty_kernel() {}

extern "C" int agbnp_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Descreening with the spline recomputed.  Replaces descreening's
// _descreen_kernel (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:600-651,
// pallas_call at :740 with qd=None: Q/dQ would not fit the 1 GB budget, or
// sharing is switched off).  The variant that reloads the Born pass's saved
// Q/dQ (_descreen_qd_kernel) runs tiles.cu's sub-tile kernel over the
// full-grid list (ops/kernels/pairs.py::descreening).
//
// Bound on the H100: it reads no [NP, NHP] array and evaluates the spline
// twice per pair (rows pass and columns pass): issue bound, like the Born
// sweep.  Design: the TPU kernel keeps the [1, NHP] column accumulators
// resident across its serial grid; here the row forces come from one warp
// per row (as in the Born sweep), and the column sums (W, U, force on the
// screeners) from one thread per column over a chunk of ROW_CHUNK rows,
// writing [chunks, 5, NHP] partials that a third kernel adds in chunk
// order.  Both stage the spline tables in shared memory and apply the Born
// sweep's own mask and spline.
// ---------------------------------------------------------------------------
__global__ void descreen_rows_kernel(const float* __restrict__ pos, int np,
                                     const float* __restrict__ posh, int nhp,
                                     const float* __restrict__ s,
                                     const float* __restrict__ brw,
                                     const float* __restrict__ bru,
                                     int box_mode,
                                     const float* __restrict__ box,
                                     SplineRefs sp,
                                     float* __restrict__ f_rows) {
  extern __shared__ float tab[];  // y [ntab] then y2 [ntab]
  stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (i >= np) return;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const float bsum = brw[i] + bru[i];
  const int tbase = sp.trow[i] * sp.ntj;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int j = lane; j < nhp; j += 32) {
    float dx = posh[j] - xi, dy = posh[nhp + j] - yi, dz = posh[2 * nhp + j] - zi;
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    if (!born_pair_live(i, sp.hids[j], sp.n, d, sp.horizon)) continue;
    float qv, dqv;
    spline_qdq(tab, sp.ntab, tbase + sp.tcol[j], d, qv, dqv);
    const float c = bsum * s[j] * dqv * (1.0f / d);
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
                                     const float* __restrict__ s,
                                     const float* __restrict__ brw,
                                     const float* __restrict__ bru,
                                     int box_mode,
                                     const float* __restrict__ box,
                                     SplineRefs sp,
                                     float* __restrict__ partial) {
  extern __shared__ float tab[];  // y [ntab] then y2 [ntab]
  stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  __syncthreads();
  const int j = blockIdx.x * COL_THREADS + threadIdx.x;
  const int chunk = blockIdx.y;
  if (j >= nhp) return;
  const float xj = posh[j], yj = posh[nhp + j], zj = posh[2 * nhp + j];
  const float sj = s[j];
  const int gj = sp.hids[j];
  const int tcj = sp.tcol[j];
  float w = 0.0f, u = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
  const int i1 = min(np, (chunk + 1) * ROW_CHUNK);
  for (int i = chunk * ROW_CHUNK; i < i1; ++i) {
    const float bw = brw[i], bu = bru[i];
    float dx = xj - pos[i], dy = yj - pos[np + i], dz = zj - pos[2 * np + i];
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    if (!born_pair_live(i, gj, sp.n, d, sp.horizon)) continue;
    float qv, dqv;
    spline_qdq(tab, sp.ntab, sp.trow[i] * sp.ntj + tcj, d, qv, dqv);
    w += bw * qv;
    u += bu * qv;
    const float c = (bw + bu) * sj * dqv * (1.0f / d);
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

// partial [agbnp_descreen_chunks(np), 5, NHP] is scratch.
extern "C" int agbnp_descreening(const float* pos, int np, const float* posh,
                                 int nhp, const float* s, const float* brw,
                                 const float* bru, int box_mode,
                                 const float* box, const int* hids,
                                 const int* trow, const int* tcol,
                                 const float* yval, const float* y2val,
                                 int nti, int ntj, int n, float horizon,
                                 float* partial, float* w_out, float* u_out,
                                 float* f_rows, float* f_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  const size_t smem = 2 * (size_t)sp.ntab * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(descreen_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncSetAttribute(descreen_cols_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const int row_blocks = (np + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  descreen_rows_kernel<<<row_blocks, 32 * WARPS_PER_BLOCK, smem, st>>>(
      pos, np, posh, nhp, s, brw, bru, box_mode, box, sp, f_rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 grid((nhp + COL_THREADS - 1) / COL_THREADS, agbnp_descreen_chunks(np));
  descreen_cols_kernel<<<grid, COL_THREADS, smem, st>>>(
      pos, np, posh, nhp, s, brw, bru, box_mode, box, sp, partial);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  descreen_reduce_kernel<<<(nhp + 127) / 128, 128, 0, st>>>(
      partial, agbnp_descreen_chunks(np), nhp, w_out, u_out, f_cols);
  return (int)cudaGetLastError();
}
