// AGBNP1 pair sweeps over interacting-tile lists for Hopper (sm_90a), f32.
//
// The same three sweeps as pairs.cu, but over a compacted list of tile
// pairs instead of the dense tile grid.  The list comes from
// build_tile_list (ops/kernels/tiles.py), rebuilt on the device at every
// evaluation: tl [2, lmax] int32 (row tile; column tile, i-major) and
// nv [1] int32, the number of valid entries.  Each launch has one block per
// list entry (grid = the static budget lmax); a block reads nv[0] on the
// device and an entry at l >= nv exits, so the host never waits for the
// count.
//
//   agbnp_born_sums_tiles     replaces _born_kernel_tl / born_sums_tiles
//                             (openmm_agbnp_plugin_tpu/ops/pallas/
//                             pairs.py:769-857)
//   agbnp_gb_pair_tiles       replaces _gb_kernel_tl / gb_pair_tiles
//                             (:860-982), triangular list, MM fused
//   agbnp_descreening_tiles   replaces _descreen_qd_kernel_tl and
//                             _descreen_kernel_tl / descreening_tiles
//                             (:985-1125)
//
// Determinism without float atomics: the TPU grid is serial and adds each
// entry into full-width VMEM rows in list order.  Here the entries run in
// parallel, so each writes its own partial sums, [lmax, K, T] for its row
// tile and (where the sweep deposits on both sides) [lmax, K, T] for its
// column tile, and tile_reduce_kernel adds them up: one block per output
// tile walks the list in order and adds every valid entry whose row (or
// column) tile is its own.  Results are bitwise repeatable.
//
// Bound on the H100, at 2clr shapes (NP 6144, NHP 3328, T 256, ~300
// entries, ~20M pairs a sweep): the Born sweep is issue bound on the spline
// and writes the per-entry Q/dQ tiles (164 MB); the GB sweep is bound by its
// exp/sqrt/divisions and, with MM, the E-wide exclusion scan per pair; the
// reloading descreening sweep streams the Q/dQ tiles back but, with one
// block per entry (~2.4 per SM), its loads are latency bound (~0.7 TB/s
// measured, slower than the recomputing sweep, which is issue bound like
// the Born sweep).  Simple first: per-pair scalar code, operands staged in
// shared memory, no tensor cores.
//
// Each host function launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include "common.cuh"

#define BORN_THREADS 256
#define MAX_K 6
#define GB_K 6       // GB partial components: E, Y, fx, fy, fz, MM
#define DS_ROW_K 3   // descreening row side: fx, fy, fz
#define DS_COL_K 5   // descreening column side: W, U, fx, fy, fz

// Where tile_reduce_kernel writes component m of output row g:
// p[m][g * stride[m]] (skipped when p[m] is null).
struct Dest {
  float* p[MAX_K];
  int stride[MAX_K];
};

// One block per output tile t, one thread per row x of the tile: adds, in
// list order, the row partials of every valid entry whose row tile is t and
// the column partials of every valid entry whose column tile is t (row
// first, as the TPU kernels deposit them).  prow / pcol: [lmax, k, T] or
// null.  Tiles no entry touches come out zero.
__global__ void tile_reduce_kernel(const float* __restrict__ prow,
                                   const float* __restrict__ pcol, int k,
                                   const int* __restrict__ nv,
                                   const int* __restrict__ tl, int lmax,
                                   Dest dst) {
  const int t = blockIdx.x, x = threadIdx.x, tile = blockDim.x;
  const int nvl = min(nv[0], lmax);
  float acc[MAX_K];
#pragma unroll
  for (int m = 0; m < MAX_K; ++m) acc[m] = 0.0f;
  for (int l = 0; l < nvl; ++l) {
    const size_t base = (size_t)l * k * tile + x;
    if (prow != nullptr && tl[l] == t) {
#pragma unroll
      for (int m = 0; m < MAX_K; ++m)
        if (m < k) acc[m] += prow[base + (size_t)m * tile];
    }
    if (pcol != nullptr && tl[lmax + l] == t) {
#pragma unroll
      for (int m = 0; m < MAX_K; ++m)
        if (m < k) acc[m] += pcol[base + (size_t)m * tile];
    }
  }
  const size_t g = (size_t)t * tile + x;
#pragma unroll
  for (int m = 0; m < MAX_K; ++m)
    if (m < k && dst.p[m] != nullptr) dst.p[m][g * dst.stride[m]] = acc[m];
}

static int reduce_tiles(const float* prow, const float* pcol, int k,
                        const int* nv, const int* tl, int lmax, int tile,
                        int ntiles, const Dest& dst, cudaStream_t st) {
  tile_reduce_kernel<<<ntiles, tile, 0, st>>>(prow, pcol, k, nv, tl, lmax,
                                              dst);
  return (int)cudaGetLastError();
}

static void allow_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
}

// ---------------------------------------------------------------------------
// Born sums over the list.  One block per entry, one warp per tile row,
// lanes over the tile's columns (staged in shared memory with the spline
// tables), as in pairs.cu's dense sweep.  With q_out, the entry's [T, T]
// Q and dQ/dd tiles are written in full: the spline value where the Born
// mask accepts a pair, zero everywhere else, and all zero for an entry past
// nv, so the descreening reload needs no mask of its own.
// ---------------------------------------------------------------------------
__global__ void born_tiles_kernel(const int* __restrict__ nv,
                                  const int* __restrict__ tl, int lmax,
                                  int tile, const float* __restrict__ pos,
                                  int np, const float* __restrict__ posh,
                                  int nhp, const int* __restrict__ hids,
                                  const int* __restrict__ trow,
                                  const int* __restrict__ tcol,
                                  const float* __restrict__ yval,
                                  const float* __restrict__ y2val, int ntab,
                                  int ntj, const float* __restrict__ s, int n,
                                  float horizon, int box_mode,
                                  const float* __restrict__ box,
                                  float* __restrict__ prow,
                                  float* __restrict__ q_out,
                                  float* __restrict__ dq_out) {
  extern __shared__ float sh[];
  float* tab = sh;               // y [ntab], y2 [ntab]
  float* cx = sh + 2 * ntab;     // column x, y, z, s [tile] each
  float* cy = cx + tile;
  float* cz = cy + tile;
  float* cs = cz + tile;
  int* chid = (int*)(cs + tile);  // column permuted-row ids, types [tile]
  int* ctc = chid + tile;
  const int l = blockIdx.x;
  const size_t tt = (size_t)tile * tile;
  float* qt = q_out == nullptr ? nullptr : q_out + (size_t)l * tt;
  float* dqt = dq_out == nullptr ? nullptr : dq_out + (size_t)l * tt;
  if (l >= nv[0]) {
    if (qt != nullptr) {
      for (size_t k = threadIdx.x; k < tt; k += blockDim.x) {
        qt[k] = 0.0f;
        dqt[k] = 0.0f;
      }
    }
    return;
  }
  const int i0 = tl[l] * tile, j0 = tl[lmax + l] * tile;
  stage_tables(tab, yval, y2val, ntab);
  for (int c = threadIdx.x; c < tile; c += blockDim.x) {
    const int j = j0 + c;
    cx[c] = posh[j];
    cy[c] = posh[nhp + j];
    cz[c] = posh[2 * nhp + j];
    cs[c] = s[j];
    chid[c] = hids[j];
    ctc[c] = tcol[j];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < tile; r += nw) {
    const int i = i0 + r;
    const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
    const int tbase = trow[i] * ntj;
    float acc = 0.0f;
    for (int c = lane; c < tile; c += 32) {
      float dx = cx[c] - xi, dy = cy[c] - yi, dz = cz[c] - zi;
      min_image(box_mode, box, dx, dy, dz);
      const float d = sqrtf(dx * dx + dy * dy + dz * dz);
      float qv = 0.0f, dqv = 0.0f;
      if (born_pair_live(i, chid[c], n, d, horizon)) {
        spline_qdq(tab, ntab, tbase + ctc[c], d, qv, dqv);
        acc += qv * cs[c];
      }
      if (qt != nullptr) {
        qt[(size_t)r * tile + c] = qv;
        dqt[(size_t)r * tile + c] = dqv;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) prow[(size_t)l * tile + r] = acc;
  }
}

extern "C" int agbnp_born_sums_tiles(
    const int* nv, const int* tl, int lmax, int tile, const float* pos,
    int np, const float* posh, int nhp, const int* hids, const int* trow,
    const int* tcol, const float* yval, const float* y2val, int nti, int ntj,
    const float* s, int n, float horizon, int box_mode, const float* box,
    float* prow, float* raw, float* q_out, float* dq_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntab = nti * ntj * AGBNP_NA;
  const size_t smem = (2 * (size_t)ntab + 6 * (size_t)tile) * sizeof(float);
  allow_smem((const void*)born_tiles_kernel, smem);
  born_tiles_kernel<<<lmax, BORN_THREADS, smem, st>>>(
      nv, tl, lmax, tile, pos, np, posh, nhp, hids, trow, tcol, yval, y2val,
      ntab, ntj, s, n, horizon, box_mode, box, prow, q_out, dq_out);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Dest dst{};
  dst.p[0] = raw;
  dst.stride[0] = 1;
  return reduce_tiles(prow, nullptr, 1, nv, tl, lmax, tile, np / tile, dst,
                      st);
}

// ---------------------------------------------------------------------------
// GB pair sweep over the triangular list (tj >= ti): every unordered pair
// once, on the entry whose tiles hold it, with gi < gj inside a diagonal
// entry.  One block per entry, one thread per tile column j, a loop over the
// tile's rows i (staged in shared memory with their exclusion lists).  The
// column side accumulates in registers; each row's sums over the block's
// columns come from a shuffle tree per warp into shared memory, then one
// thread per row adds the warps in order.  Each pair is deposited on both
// sides: E, Y and MM with the same sign, the force with opposite signs.
// ---------------------------------------------------------------------------
__global__ void gb_tiles_kernel(const int* __restrict__ nv,
                                const int* __restrict__ tl, int lmax,
                                const float* __restrict__ pos, int np,
                                const float* __restrict__ charge,
                                const float* __restrict__ born,
                                const float* __restrict__ sig,
                                const float* __restrict__ epsq,
                                const int* __restrict__ excl, int ne,
                                int with_mm, int n, float cutoff2,
                                int box_mode, const float* __restrict__ box,
                                float dfac, float ke,
                                float* __restrict__ prow,
                                float* __restrict__ pcol) {
  extern __shared__ float sh[];
  const int tile = blockDim.x, nw = tile >> 5;
  float* rx = sh;  // row x, y, z, charge, Born radius, sigma, sqrt(eps)
  float* ry = rx + tile;
  float* rz = ry + tile;
  float* rq = rz + tile;
  float* rb = rq + tile;
  float* rsg = rb + tile;
  float* rep = rsg + tile;
  float* rowpart = rep + tile;  // [tile][nw][GB_K]
  int* rex = (int*)(rowpart + (size_t)tile * nw * GB_K);  // [tile][ne]
  const int l = blockIdx.x, c = threadIdx.x;
  if (l >= nv[0]) return;
  const int i0 = tl[l] * tile, j0 = tl[lmax + l] * tile;
  {
    const int i = i0 + c;
    rx[c] = pos[i];
    ry[c] = pos[np + i];
    rz[c] = pos[2 * np + i];
    rq[c] = charge[i];
    rb[c] = born[i];
    rsg[c] = with_mm ? sig[i] : 0.0f;
    rep[c] = with_mm ? epsq[i] : 0.0f;
  }
  if (with_mm) {
    for (int k = c; k < tile * ne; k += tile) rex[k] = excl[(size_t)i0 * ne + k];
  }
  __syncthreads();
  const int warp = c >> 5, lane = c & 31;
  const int j = j0 + c;
  const float xj = pos[j], yj = pos[np + j], zj = pos[2 * np + j];
  const float qj = charge[j], bj = born[j];
  const float sgj = with_mm ? sig[j] : 0.0f, epj = with_mm ? epsq[j] : 0.0f;
  float col[GB_K];
#pragma unroll
  for (int m = 0; m < GB_K; ++m) col[m] = 0.0f;
  for (int r = 0; r < tile; ++r) {
    const int i = i0 + r;
    float dx = xj - rx[r], dy = yj - ry[r], dz = zj - rz[r];
    min_image(box_mode, box, dx, dy, dz);
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = i < j && j < n && (cutoff2 < 0.0f || d2 < cutoff2);
    float v[GB_K];  // this pair's E, Y, fx, fy, fz, MM (row side)
#pragma unroll
    for (int m = 0; m < GB_K; ++m) v[m] = 0.0f;
    if (live) {
      const float bb = rb[r] * bj;
      const float etij = expf(-0.25f * d2 / bb);
      const float fgb = 1.0f / sqrtf(d2 + bb * etij);
      const float qq_f = rq[r] * qj;
      const float qq = dfac * qq_f;
      const float fgb3 = fgb * fgb * fgb;
      float mw = -2.0f * qq * (1.0f - 0.25f * etij) * fgb3;
      v[0] = qq * fgb;
      v[1] = qq_f * (bb + 0.25f * d2) * etij * fgb3;
      if (with_mm) {
        bool excluded = false;
        const int* ex = rex + r * ne;
        for (int k = 0; k < ne; ++k) excluded |= (ex[k] == j);
        if (!excluded) {
          const float inv2 = 1.0f / d2;
          const float sr2 = (rsg[r] * sgj) * inv2;
          const float sr6 = sr2 * sr2 * sr2;
          const float epsij = rep[r] * epj;
          const float ecoul = ke * qq_f * (1.0f / sqrtf(d2));
          const float elj = 4.0f * epsij * (sr6 * sr6 - sr6);
          v[5] = elj + ecoul;
          const float dmm = (4.0f * epsij * (-6.0f * sr6 * sr6 + 3.0f * sr6)
                             - 0.5f * ecoul) * inv2;
          mw = mw + 2.0f * dmm;
        }
      }
      v[2] = dx * mw;
      v[3] = dy * mw;
      v[4] = dz * mw;
    }
    col[0] += v[0];
    col[1] += v[1];
    col[2] -= v[2];
    col[3] -= v[3];
    col[4] -= v[4];
    col[5] += v[5];
    if (__any_sync(0xffffffffu, live)) {
#pragma unroll
      for (int m = 0; m < GB_K; ++m) v[m] = warp_sum(v[m]);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < GB_K; ++m)
        rowpart[((size_t)r * nw + warp) * GB_K + m] = v[m];
    }
  }
  __syncthreads();
  float rsum[GB_K];
#pragma unroll
  for (int m = 0; m < GB_K; ++m) rsum[m] = 0.0f;
  for (int w = 0; w < nw; ++w) {
#pragma unroll
    for (int m = 0; m < GB_K; ++m)
      rsum[m] += rowpart[((size_t)c * nw + w) * GB_K + m];
  }
#pragma unroll
  for (int m = 0; m < GB_K; ++m) {
    prow[((size_t)l * GB_K + m) * tile + c] = rsum[m];
    pcol[((size_t)l * GB_K + m) * tile + c] = col[m];
  }
}

extern "C" int agbnp_gb_pair_tiles(
    const int* nv, const int* tl, int lmax, int tile, const float* pos,
    int np, const float* charge, const float* born, const float* sig,
    const float* epsq, const int* excl, int ne, int n, float cutoff2,
    int box_mode, const float* box, float dfac, float ke, float* prow,
    float* pcol, float* erow, float* yrow, float* force, float* mmrow,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int with_mm = mmrow != nullptr;
  const int ne_used = with_mm ? ne : 0;
  const size_t nw = (size_t)tile / 32;
  const size_t smem = (7 * (size_t)tile + (size_t)tile * nw * GB_K) * sizeof(float)
                      + (size_t)tile * ne_used * sizeof(int);
  allow_smem((const void*)gb_tiles_kernel, smem);
  gb_tiles_kernel<<<lmax, tile, smem, st>>>(
      nv, tl, lmax, pos, np, charge, born, sig, epsq, excl, ne_used, with_mm,
      n, cutoff2, box_mode, box, dfac, ke, prow, pcol);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Dest dst{};
  float* outs[GB_K] = {erow, yrow, force, force + 1, force + 2, mmrow};
  const int strides[GB_K] = {1, 1, 3, 3, 3, 1};
  for (int m = 0; m < GB_K; ++m) {
    dst.p[m] = outs[m];
    dst.stride[m] = strides[m];
  }
  return reduce_tiles(prow, pcol, GB_K, nv, tl, lmax, tile, np / tile, dst,
                      st);
}

// ---------------------------------------------------------------------------
// Descreening over the Born list.  One block per entry, one thread per
// screener column j, a loop over the tile's rows i (positions and chain
// factors staged in shared memory).  The reloading variant reads the
// entry's saved Q/dQ tile (coalesced along j) and guards only d > 0, as the
// TPU kernel does; the recomputing variant (RECOMPUTE) re-evaluates the
// Born mask and spline from the staged tables.  W, U and the screener force
// accumulate per column in registers; the row force goes through the same
// per-warp shuffle tree and in-order warp sum as the GB sweep.
// ---------------------------------------------------------------------------
template <bool RECOMPUTE>
__global__ void descreen_tiles_kernel(const int* __restrict__ nv,
                                      const int* __restrict__ tl, int lmax,
                                      const float* __restrict__ pos, int np,
                                      const float* __restrict__ posh, int nhp,
                                      const float* __restrict__ q,
                                      const float* __restrict__ dq,
                                      const float* __restrict__ s,
                                      const float* __restrict__ brw,
                                      const float* __restrict__ bru,
                                      int box_mode,
                                      const float* __restrict__ box,
                                      SplineRefs sp,
                                      float* __restrict__ prow,
                                      float* __restrict__ pcol) {
  extern __shared__ float sh[];
  const int tile = blockDim.x, nw = tile >> 5;
  float* tab = sh;  // RECOMPUTE: y [ntab], y2 [ntab]
  float* rx = sh + (RECOMPUTE ? 2 * sp.ntab : 0);  // row x, y, z, BrW, BrU
  float* ry = rx + tile;
  float* rz = ry + tile;
  float* rbw = rz + tile;
  float* rbu = rbw + tile;
  float* rowpart = rbu + tile;  // [tile][nw][DS_ROW_K]
  int* rtype = (int*)(rowpart + (size_t)tile * nw * DS_ROW_K);  // [tile]
  const int l = blockIdx.x, c = threadIdx.x;
  if (l >= nv[0]) return;
  const int i0 = tl[l] * tile, j0 = tl[lmax + l] * tile;
  if (RECOMPUTE) stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  {
    const int i = i0 + c;
    rx[c] = pos[i];
    ry[c] = pos[np + i];
    rz[c] = pos[2 * np + i];
    rbw[c] = brw[i];
    rbu[c] = bru[i];
    if (RECOMPUTE) rtype[c] = sp.trow[i];
  }
  __syncthreads();
  const int warp = c >> 5, lane = c & 31;
  const int j = j0 + c;
  const float xj = posh[j], yj = posh[nhp + j], zj = posh[2 * nhp + j];
  const float sj = s[j];
  const int gj = RECOMPUTE ? sp.hids[j] : 0;
  const int tcj = RECOMPUTE ? sp.tcol[j] : 0;
  const size_t tt = (size_t)tile * tile;
  const float* qt = RECOMPUTE ? nullptr : q + (size_t)l * tt;
  const float* dqt = RECOMPUTE ? nullptr : dq + (size_t)l * tt;
  float w = 0.0f, u = 0.0f, fcx = 0.0f, fcy = 0.0f, fcz = 0.0f;
  for (int r = 0; r < tile; ++r) {
    const int i = i0 + r;
    float dx = xj - rx[r], dy = yj - ry[r], dz = zj - rz[r];
    min_image(box_mode, box, dx, dy, dz);
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    float qv = 0.0f, dqv = 0.0f, inv_d = 0.0f;
    if (RECOMPUTE) {
      if (born_pair_live(i, gj, sp.n, d, sp.horizon)) {
        spline_qdq(tab, sp.ntab, rtype[r] * sp.ntj + tcj, d, qv, dqv);
        inv_d = 1.0f / d;
      }
    } else {
      qv = qt[(size_t)r * tile + c];
      dqv = dqt[(size_t)r * tile + c];
      inv_d = inv_or_zero(d);
    }
    const float bw = rbw[r], bu = rbu[r];
    w += bw * qv;
    u += bu * qv;
    const float cc = (bw + bu) * sj * dqv * inv_d;
    float fx = cc * dx, fy = cc * dy, fz = cc * dz;
    fcx -= fx;
    fcy -= fy;
    fcz -= fz;
    if (__any_sync(0xffffffffu, dqv != 0.0f)) {
      fx = warp_sum(fx);
      fy = warp_sum(fy);
      fz = warp_sum(fz);
    }
    if (lane == 0) {
      float* rp = rowpart + ((size_t)r * nw + warp) * DS_ROW_K;
      rp[0] = fx;
      rp[1] = fy;
      rp[2] = fz;
    }
  }
  __syncthreads();
  float f[DS_ROW_K] = {0.0f, 0.0f, 0.0f};
  for (int wp = 0; wp < nw; ++wp) {
    const float* rp = rowpart + ((size_t)c * nw + wp) * DS_ROW_K;
    f[0] += rp[0];
    f[1] += rp[1];
    f[2] += rp[2];
  }
  for (int m = 0; m < DS_ROW_K; ++m)
    prow[((size_t)l * DS_ROW_K + m) * tile + c] = f[m];
  const float cols[DS_COL_K] = {w, u, fcx, fcy, fcz};
  for (int m = 0; m < DS_COL_K; ++m)
    pcol[((size_t)l * DS_COL_K + m) * tile + c] = cols[m];
}

template <bool RECOMPUTE>
static int launch_descreen_tiles(const int* nv, const int* tl, int lmax,
                                 int tile, const float* pos, int np,
                                 const float* posh, int nhp, const float* q,
                                 const float* dq, const float* s,
                                 const float* brw, const float* bru,
                                 int box_mode, const float* box,
                                 const SplineRefs& sp, float* prow,
                                 float* pcol, cudaStream_t st) {
  const size_t nw = (size_t)tile / 32;
  const size_t smem = ((RECOMPUTE ? 2 * (size_t)sp.ntab : 0) + 5 * (size_t)tile
                       + (size_t)tile * nw * DS_ROW_K) * sizeof(float)
                      + (RECOMPUTE ? (size_t)tile * sizeof(int) : 0);
  allow_smem((const void*)descreen_tiles_kernel<RECOMPUTE>, smem);
  descreen_tiles_kernel<RECOMPUTE><<<lmax, tile, smem, st>>>(
      nv, tl, lmax, pos, np, posh, nhp, q, dq, s, brw, bru, box_mode, box, sp,
      prow, pcol);
  return (int)cudaGetLastError();
}

// q == nullptr selects the recomputing variant, which then reads hids, trow,
// tcol, the tables, n and horizon; the reloading variant ignores them.
extern "C" int agbnp_descreening_tiles(
    const int* nv, const int* tl, int lmax, int tile, const float* pos,
    int np, const float* posh, int nhp, const float* q, const float* dq,
    const float* s, const float* brw, const float* bru, int box_mode,
    const float* box, const int* hids, const int* trow, const int* tcol,
    const float* yval, const float* y2val, int nti, int ntj, int n,
    float horizon, float* prow, float* pcol, float* w_out, float* u_out,
    float* f_rows, float* f_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  int err = q == nullptr
      ? launch_descreen_tiles<true>(nv, tl, lmax, tile, pos, np, posh, nhp, q,
                                    dq, s, brw, bru, box_mode, box, sp, prow,
                                    pcol, st)
      : launch_descreen_tiles<false>(nv, tl, lmax, tile, pos, np, posh, nhp,
                                     q, dq, s, brw, bru, box_mode, box, sp,
                                     prow, pcol, st);
  if (err != 0) return err;
  Dest rows{};
  for (int m = 0; m < DS_ROW_K; ++m) {
    rows.p[m] = f_rows + m;
    rows.stride[m] = 3;
  }
  err = reduce_tiles(prow, nullptr, DS_ROW_K, nv, tl, lmax, tile, np / tile,
                     rows, st);
  if (err != 0) return err;
  Dest cols{};
  float* couts[DS_COL_K] = {w_out, u_out, f_cols, f_cols + 1, f_cols + 2};
  const int cstrides[DS_COL_K] = {1, 1, 3, 3, 3};
  for (int m = 0; m < DS_COL_K; ++m) {
    cols.p[m] = couts[m];
    cols.stride[m] = cstrides[m];
  }
  return reduce_tiles(nullptr, pcol, DS_COL_K, nv, tl, lmax, tile,
                      nhp / tile, cols, st);
}
