// AGBNP1 dense-grid Born and descreening sweeps for Hopper (sm_90a), f32,
// over per-sub-tile interacting-column chunks.
//
//   agbnp_subtile_columns   the chunk list: for each 32-row sub-tile, the
//                           heavy columns that can hold a live Born pair
//   agbnp_born_sums         raw_i = sum_j s_j Q4(d_ij), optionally saving
//                           Q and dQ/dd of the listed slots.  Replaces
//                           _born_kernel / born_sums
//                           (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:
//                           353-447, pallas_call at :420)
//   agbnp_descreening       W_j/U_j column sums + direct descreening
//                           forces, reloading born_sums' Q/dQ or with the
//                           spline recomputed.  Replaces _descreen_qd_kernel
//                           and _descreen_kernel / descreening (:600-757,
//                           pallas_call at :740)
//
// The GB pair sweep over the dense grid runs tiles.cu's sub-tile GB kernel
// over the list of every tile pair ti <= tj (ops/kernels/pairs.py::gb_pair).
//
// Layouts are the JAX wrappers' (openmm_agbnp_plugin_tpu/ops/pallas/pairs.py)
// at the boundary: positions [3, NP] (Morton-permuted rows, NP padded) and
// [3, NHP] (heavy-atom screener columns, -1 ids on padding), row outputs
// [NP], column outputs [NHP].  S = NP / 32 sub-tiles.
//
// What held the first dense kernels back, and what bounds the work: one
// warp per row walked all NHP columns (at 1li2, NP 1536 x NHP 768, 1.18M
// distances, masks and square roots for ~168k live pairs); the Born sweep
// stored Q and dQ for every slot of the grid, 9.4 MB at 1li2 against ~1.3
// MB for its live pairs; and the recomputing descreening evaluated the
// spline twice a pair (a row pass and a serial 64-row column pass) and
// added a [NP / 64, 5, NHP] partial in a one-thread-a-column reduce.  The
// Born sweep is bound by bytes (its Q/dQ, 8 a live pair), the recomputing
// descreening by operations (~62 FP32 a live pair), both a few tenths of a
// microsecond at 1li2; the launch (~2 us) is the floor.  The design, after
// OpenMM's interacting-atom tiles:
//
//   * The chunk list.  For each sub-tile a, one block forms the box of its
//     valid rows (center and half-diagonal, as tiles.py::tile_bounds at 32)
//     and keeps each real heavy column j with |x_j - c_a|_image - r_a <
//     horizon + CHUNK_MARGIN (1e-3 nm; the wrapper passes the sum as lim),
//     the distance to the nearest image (image_distance_rn): no pair the
//     Born mask accepts is dropped.  Columns go to cols [S, NHP] in
//     ascending j (order from warp ballots and __popc, a block prefix over
//     the warps), -1 past ncols [S]; the ballots themselves are bits [S,
//     NHP / 32], the transposed list.  The capacity per sub-tile is NHP, so
//     the list cannot overflow.  Every product, sum and square root of the
//     test is rounded on its own (no FMA contraction), so the torch twin
//     reproduces it bit for bit on the card.  Unless it is given a list,
//     the Born kernel builds its sub-tile's list at the head of its block
//     while its tables land, and writes it out for the reload: the dense
//     evaluation runs no launch for the list (a launch of its own took
//     ~0.004 ms at 1li2).  The recomputing descreening, which walks the
//     list without the Born kernel's Q/dQ, takes it from
//     agbnp_subtile_columns.
//   * Work.  One block per sub-tile a with G warps (ops/kernels/pairs.py::
//     chunk_warps: 16 where a sub-tile can have 16 chunks); warp w walks
//     chunks w, w + G, ... of a's list, 32 listed columns each, whose
//     positions, s, ids and types it stages in shared memory.  Rows' sums
//     add over the block's warps in warp order, so a sub-tile's row outputs
//     need no second pass.  A warp's walk is a chain of dependent loads and
//     spline steps, so the most warps a block run fastest; the spline is
//     evaluated only where the Born mask accepts the pair (evaluating it
//     for every slot, without a branch, measured 1.1-1.7x slower on the
//     H100).  Descreening keeps four rows a step in flight, and the
//     reload's Q/dQ of a whole chunk are loaded first (loading them a step
//     at a time measured 5-13% slower).  The time follows the longest
//     warp's walk, not the SMs a sub-tile reaches: spreading a sub-tile's
//     16 warps over a cluster of four blocks changed nothing at 1li2 and
//     cost 5-14% at 2clr, and 32 warps a sub-tile in a cluster of blocks
//     sped the Born sweep up 11-21% but slowed the reload 16-78%.  The
//     Born sweep's sub-tile stays one block; the descreening sweeps give
//     a sub-tile more warps as plain blocks, their row forces added in the
//     column-sum launch they already have (below).
//   * Born: lane x holds row 32 a + x and its sum in a register; the staged
//     columns reach it as shared-memory broadcasts.  Q/dQ go to the chunk
//     layout [S, NHP, 32]: slot (a, k) of row 32 a + x at (a NHP + k) 32 +
//     x, so a warp writes 128 contiguous bytes a column.  Every slot of a
//     walked chunk is written (zero past ncols); slots of unwalked chunks
//     are not, and stay undefined on the card.
//   * Descreening: lane (g = x >> 3, r4 = x & 7) covers rows 4 r4 .. 4 r4 +
//     3 of columns 4 k + g, k = 0..7 of a chunk; the reload reads each
//     column's four rows of Q and of dQ as one float4 (8 lanes cover 128
//     bytes).  The spline is evaluated once a pair.  Row forces stay in
//     registers and add over g, then over the warps.  A column's sums (W,
//     U, screener force) add the four rows in a lane and the 8 lanes r4 in
//     a fixed shuffle tree, and land in a per-(sub-tile, column) partial
//     [S, 5, NHP] (one writer each); column_sums_kernel adds them over the
//     sub-tiles whose bit is set in ascending a (one block per 32 columns,
//     its warps striding a, added in warp order).  A second pass with rows
//     and columns swapped would evaluate the spline again and need the
//     transposed list anyway; the partials cost 20 bytes a listed column.
//     A sub-tile's chunks are split over P blocks of G warps (P from the
//     shape: enough that P G warps cover NHP / 32 chunks, at most 4), so
//     that at 1li2, where 15 of 48 sub-tiles hold 17-21 chunks, no warp
//     walks two: the reload's sweep took 15.5 us with one block a
//     sub-tile and 10.7 with two (H100, profile_port_step.py 1li2
//     --list-kernels).  The row forces of the P blocks go to a [P, NP, 3]
//     partial that column_sums_kernel adds in block order.  The Born
//     sweep keeps one block a sub-tile, so that its row sums need no
//     second launch.
//
// Replicas.  Every launch serves B replicas of one system (a batched
// evaluation: conformers, replica-ensemble or REMD replicas): the replica b
// is the grid's last axis (blockIdx.y or .z), and each block first moves its
// per-replica pointers by b times the replica's extent: positions [B, 3,
// NP] and [B, 3, NHP], screening factors [B, NHP], BrW/BrU [B, NP], the
// chunk lists [B, S, ...], Q/dQ [B, S, NHP, 32], the scratch and every
// output.  The tables shared by the replicas (screener ids, radius types,
// the spline) carry no replica axis and are read by all.  A block's work
// inside its replica is the B = 1 block's, so replica b of a batch is
// bitwise its own B = 1 launch, and B = 1 is the unbatched launch.
//
// Determinism: no float atomics; every sum is in an order fixed by the
// shapes (S, NHP, G, P), so results are bitwise repeatable.
//
// Each host function launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include "common.cuh"

#define SUB 32                // sub-tile edge: a warp's rows, a chunk's columns
#define MAX_CHUNK_WARPS 16    // warps of a sweep block (one sub-tile)
#define BUILD_THREADS 1024    // block of the chunk-list kernel
#define DS_COL_K 5            // descreening column partials: W, U, fx, fy, fz
#define COLSUM_WARPS 32       // warps of a column-sum block
#define MAX_CHUNK_PARTS 4     // blocks a descreening sub-tile is split over

static void allow_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
}

// ---------------------------------------------------------------------------
// The chunk list
// ---------------------------------------------------------------------------

// d - L round(d (1 / L)), each operation rounded on its own
__device__ __forceinline__ float wrap_rn(float d, float len) {
  return __fsub_rn(d, __fmul_rn(len, rintf(__fmul_rn(d, __frcp_rn(len)))));
}

// Minimum image of dx = pos_j - pos_i as common.cuh's min_image, with every
// operation rounded on its own (torch's order: k = round(d * (1 / L)), d -=
// k * L); the reciprocal is the correctly rounded 1 / L.
__device__ __forceinline__ void min_image_rn(int box_mode, const float* box,
                                             float& dx, float& dy,
                                             float& dz) {
  if (box_mode == 1) {
    dx = wrap_rn(dx, box[0]);
    dy = wrap_rn(dy, box[1]);
    dz = wrap_rn(dz, box[2]);
  } else if (box_mode == 2) {
    float k = rintf(__fmul_rn(dz, __frcp_rn(box[8])));
    dx = __fsub_rn(dx, __fmul_rn(k, box[6]));
    dy = __fsub_rn(dy, __fmul_rn(k, box[7]));
    dz = __fsub_rn(dz, __fmul_rn(k, box[8]));
    k = rintf(__fmul_rn(dy, __frcp_rn(box[4])));
    dx = __fsub_rn(dx, __fmul_rn(k, box[3]));
    dy = __fsub_rn(dy, __fmul_rn(k, box[4]));
    dx = wrap_rn(dx, box[0]);
  }
}

// (x x + y y) + z z, rounded at each step
__device__ __forceinline__ float norm2_rn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The distance of the nearest image of (dx, dy, dz) = x_j - c: the
// orthorhombic wrap finds it; the triclinic sequential wrap need not, so
// the 27 images one lattice step around the wrapped one are tried (their
// least squared length, then one square root).  A pair within the horizon
// is then never further from c than its distance plus r.
__device__ __forceinline__ float image_distance_rn(int box_mode,
                                                   const float* box,
                                                   float dx, float dy,
                                                   float dz) {
  min_image_rn(box_mode, box, dx, dy, dz);
  float best = norm2_rn(dx, dy, dz);
  if (box_mode == 2) {
    for (int kc = -1; kc <= 1; ++kc) {
      for (int kb = -1; kb <= 1; ++kb) {
        for (int ka = -1; ka <= 1; ++ka) {
          const float fa = (float)ka, fb = (float)kb, fc = (float)kc;
          const float sx = __fadd_rn(
              __fadd_rn(__fadd_rn(dx, __fmul_rn(fa, box[0])),
                        __fmul_rn(fb, box[3])),
              __fmul_rn(fc, box[6]));
          const float sy = __fadd_rn(__fadd_rn(dy, __fmul_rn(fb, box[4])),
                                     __fmul_rn(fc, box[7]));
          const float sz = __fadd_rn(dz, __fmul_rn(fc, box[8]));
          best = fminf(best, norm2_rn(sx, sy, sz));
        }
      }
    }
  }
  return __fsqrt_rn(best);
}

// Sub-tile a's chunk list, built by the whole block (any whole number of
// warps up to BUILD_THREADS; every thread calls it).  Warp 0 forms the box
// of the valid rows (i < n); then the block tests the columns blockDim.x at
// a time, each warp's ballot is its word of bits, and the listed columns are
// placed at the block's running count plus the earlier warps' counts plus
// the earlier lanes' bits.  The tail of cols past ncols is -1.  Every
// thread gets ncols[a], and the block's writes are visible to it on return.
__device__ int build_chunk_list(int a, const float* __restrict__ pos, int np,
                                const float* __restrict__ posh, int nhp,
                                const int* __restrict__ hids, int n,
                                float lim, int box_mode,
                                const float* __restrict__ box, int* cols,
                                int* ncols, unsigned* bits) {
  __shared__ float sbox[4];  // center x, y, z, half-diagonal
  __shared__ int shas;
  __shared__ int wcount[BUILD_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (warp == 0) {
    const int i = a * SUB + lane;
    const bool valid = i < n;
    const float x = pos[i], y = pos[np + i], z = pos[2 * np + i];
    const bool has = __any_sync(FULL_MASK, valid);
    const float lx = warp_min(valid ? x : 1e30f);
    const float ly = warp_min(valid ? y : 1e30f);
    const float lz = warp_min(valid ? z : 1e30f);
    const float hx = warp_max(valid ? x : -1e30f);
    const float hy = warp_max(valid ? y : -1e30f);
    const float hz = warp_max(valid ? z : -1e30f);
    if (lane == 0) {
      shas = has;
      sbox[0] = __fmul_rn(0.5f, __fadd_rn(lx, hx));
      sbox[1] = __fmul_rn(0.5f, __fadd_rn(ly, hy));
      sbox[2] = __fmul_rn(0.5f, __fadd_rn(lz, hz));
      sbox[3] = __fmul_rn(0.5f, __fsqrt_rn(norm2_rn(__fsub_rn(hx, lx),
                                                    __fsub_rn(hy, ly),
                                                    __fsub_rn(hz, lz))));
    }
  }
  __syncthreads();
  const bool has = shas != 0;
  const float cx = sbox[0], cy = sbox[1], cz = sbox[2], r = sbox[3];
  int* crow = cols + (size_t)a * nhp;
  int base = 0;
  for (int j0 = 0; j0 < nhp; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    bool ok = false;
    if (has && j < nhp) {
      // the id and the position are loaded side by side
      const int id = hids[j];
      const float d = image_distance_rn(
          box_mode, box, __fsub_rn(posh[j], cx),
          __fsub_rn(posh[nhp + j], cy), __fsub_rn(posh[2 * nhp + j], cz));
      ok = id >= 0 && __fsub_rn(d, r) < lim;
    }
    const unsigned ballot = __ballot_sync(FULL_MASK, ok);
    // NHP is a multiple of 32: a warp's columns are all inside or all out
    if (lane == 0 && j < nhp) bits[(size_t)a * (nhp / SUB) + j / SUB] = ballot;
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) off += wcount[w];
      total += wcount[w];
    }
    if (ok) crow[off + __popc(ballot & ((1u << lane) - 1u))] = j;
    base += total;
    __syncthreads();
  }
  for (int k = base + threadIdx.x; k < nhp; k += blockDim.x) crow[k] = -1;
  if (threadIdx.x == 0) ncols[a] = base;
  __syncthreads();
  return base;
}

// One block of BUILD_THREADS per (sub-tile a, replica blockIdx.y).
__global__ void __launch_bounds__(BUILD_THREADS)
subtile_columns_kernel(const float* __restrict__ pos, int np,
                       const float* __restrict__ posh, int nhp,
                       const int* __restrict__ hids, int n, float lim,
                       int box_mode, const float* __restrict__ box,
                       int* __restrict__ cols, int* __restrict__ ncols,
                       unsigned* __restrict__ bits) {
  const size_t b = blockIdx.y, nsub = np / SUB;
  build_chunk_list(blockIdx.x, pos + b * 3 * np, np, posh + b * 3 * nhp, nhp,
                   hids, n, lim, box_mode, box, cols + b * nsub * nhp,
                   ncols + b * nsub, bits + b * nsub * (nhp / SUB));
}

// nb replicas.  lim: horizon + CHUNK_MARGIN as one f32.  cols [B, S,
// NHP], ncols [B, S] and bits [B, S, NHP / 32] are written in full.
extern "C" int agbnp_subtile_columns(int nb, const float* pos, int np,
                                     const float* posh, int nhp,
                                     const int* hids, int n, float lim,
                                     int box_mode, const float* box,
                                     int* cols, int* ncols, unsigned* bits,
                                     void* stream) {
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  subtile_columns_kernel<<<dim3(np / SUB, nb), BUILD_THREADS, 0,
                           (cudaStream_t)stream>>>(
      pos, np, posh, nhp, hids, n, lim, box_mode, box, cols, ncols, bits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Born sums over the chunks.  Shared memory: the tables, the warps' row
// partials [G][32], then per warp the staged chunk: x, y, z, s (float4) and
// screener id, type (int2) of its 32 columns.
// ---------------------------------------------------------------------------

// Stage chunk slot lane's column jh (-1: a dead slot, which the Born mask
// rejects through its id -1) as float4 (x, y, z, s) and its ids.
__device__ __forceinline__ float4 stage_column(const float* __restrict__ posh,
                                               int nhp,
                                               const float* __restrict__ s,
                                               int jh) {
  return jh >= 0 ? make_float4(posh[jh], posh[nhp + jh], posh[2 * nhp + jh],
                               s[jh])
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// build != 0: the block first builds its sub-tile's chunk list
// (build_chunk_list at lim, into cols, ncols and bits), then walks it;
// build == 0: it walks the list given in cols and ncols.  Replica
// blockIdx.y.
__global__ void __launch_bounds__(MAX_CHUNK_WARPS * 32)
born_chunks_kernel(const float* __restrict__ pos, int np,
                   const float* __restrict__ posh, int nhp,
                   const float* __restrict__ s, SplineRefs sp, int box_mode,
                   const float* __restrict__ box, float lim, int build,
                   int* cols, int* ncols, unsigned* bits,
                   float* __restrict__ raw, float* __restrict__ q_out,
                   float* __restrict__ dq_out) {
  {
    const size_t b = blockIdx.y, nsub = np / SUB;
    pos += b * 3 * np;
    posh += b * 3 * nhp;
    s += b * nhp;
    cols += b * nsub * nhp;
    ncols += b * nsub;
    bits += b * nsub * (nhp / SUB);
    raw += b * np;
    if (q_out != nullptr) {
      q_out += b * nsub * nhp * SUB;
      dq_out += b * nsub * nhp * SUB;
    }
  }
  extern __shared__ float sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* tab = sh;                                   // y, y2 [ntab] each
  float* part = sh + 2 * sp.ntab;                    // [G][32]
  float4* colf = (float4*)(part + nw * SUB) + warp * SUB;
  int2* coli = (int2*)((float4*)(part + nw * SUB) + nw * SUB) + warp * SUB;
  stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  const int a = blockIdx.x;
  // the list is built while the tables land; it ends on a block barrier
  const int nc = build ? build_chunk_list(a, pos, np, posh, nhp, sp.hids,
                                          sp.n, lim, box_mode, box, cols,
                                          ncols, bits)
                       : ncols[a];
  __syncthreads();
  const int i = a * SUB + lane;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const int tbase = sp.trow[i] * sp.ntj;
  const int nch = (nc + SUB - 1) / SUB;
  float acc = 0.0f;
  for (int c = warp; c < nch; c += nw) {
    const int k0 = c * SUB;
    const int jh = cols[(size_t)a * nhp + k0 + lane];
    colf[lane] = stage_column(posh, nhp, s, jh);
    coli[lane] = jh >= 0 ? make_int2(sp.hids[jh], sp.tcol[jh])
                         : make_int2(-1, 0);
    __syncwarp();
    const size_t qoff = ((size_t)a * nhp + k0) * SUB + lane;
#pragma unroll 4
    for (int cc = 0; cc < SUB; ++cc) {
      const int2 ci = coli[cc];
      float qv, dqv;
      born_pair(tab, sp, i, tbase, xi, yi, zi, colf[cc], ci.x, ci.y,
                box_mode, box, acc, qv, dqv);
      if (q_out != nullptr) {
        q_out[qoff + cc * SUB] = qv;
        dq_out[qoff + cc * SUB] = dqv;
      }
    }
    __syncwarp();  // the chunk is read before the next one lands
  }
  part[warp * SUB + lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float sum = 0.0f;
    for (int w = 0; w < nw; ++w) sum += part[w * SUB + lane];
    raw[i] = sum;
  }
}

// nb replicas (pos [B, 3, NP], posh [B, 3, NHP], s [B, NHP], raw [B, NP]).
// warps: G, at most MAX_CHUNK_WARPS.  build != 0: the kernel builds the
// chunk list (as agbnp_subtile_columns at lim) into cols [B, S, NHP], ncols
// [B, S] and bits [B, S, NHP / 32], written in full; build == 0: cols/ncols
// from agbnp_subtile_columns at this horizon and box (bits unread, may be
// null).  q_out/dq_out [B, S, NHP, 32] (or null): written on the chunks
// below ncols only.
extern "C" int agbnp_born_sums(int nb, const float* pos, int np,
                               const float* posh,
                               int nhp, const int* hids, const int* trow,
                               const int* tcol, const float* yval,
                               const float* y2val, int nti, int ntj,
                               const float* s, int n, float horizon,
                               int box_mode, const float* box, float lim,
                               int build, int* cols, int* ncols,
                               unsigned* bits, int warps, float* raw,
                               float* q_out, float* dq_out, void* stream) {
  if (warps < 1 || warps > MAX_CHUNK_WARPS || nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  const size_t smem =
      (2 * (size_t)sp.ntab + warps * SUB + warps * SUB * 6) * sizeof(float);
  allow_smem((const void*)born_chunks_kernel, smem);
  born_chunks_kernel<<<dim3(np / SUB, nb), warps * 32, smem,
                       (cudaStream_t)stream>>>(
      pos, np, posh, nhp, s, sp, box_mode, box, lim, build, cols, ncols,
      bits, raw, q_out, dq_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Descreening over the chunks.  Shared memory: the tables (RECOMPUTE), the
// sub-tile's rows (x, y, z, BrW, BrU, type), the warps' row-force partials
// [G][32][3], then per warp the staged chunk: x, y, z, s (float4) and
// column id, screener id, type (int4) of its 32 columns.
// ---------------------------------------------------------------------------
template <bool RECOMPUTE>
__global__ void __launch_bounds__(MAX_CHUNK_WARPS * 32)
descreen_chunks_kernel(const float* __restrict__ pos, int np,
                       const float* __restrict__ posh, int nhp,
                       const float* __restrict__ q,
                       const float* __restrict__ dq,
                       const float* __restrict__ s,
                       const float* __restrict__ brw,
                       const float* __restrict__ bru, int box_mode,
                       const float* __restrict__ box, SplineRefs sp,
                       const int* __restrict__ cols,
                       const int* __restrict__ ncols,
                       float* __restrict__ f_rows,
                       float* __restrict__ pcol) {
  // block (a, p, b) of P = gridDim.y walks chunks p G + w, p G + w + P G,
  // ... of replica b; with P > 1, f_rows is the [B, P, NP, 3] partial
  // column_sums_kernel adds
  {
    const size_t b = blockIdx.z, nsub = np / SUB;
    pos += b * 3 * np;
    posh += b * 3 * nhp;
    if (!RECOMPUTE) {
      q += b * nsub * nhp * SUB;
      dq += b * nsub * nhp * SUB;
    }
    s += b * nhp;
    brw += b * np;
    bru += b * np;
    cols += b * nsub * nhp;
    ncols += b * nsub;
    f_rows += b * gridDim.y * 3 * np;
    pcol += b * nsub * DS_COL_K * nhp;
  }
  extern __shared__ float sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* tab = sh;  // RECOMPUTE: y, y2 [ntab] each
  float* rx = sh + (RECOMPUTE ? 2 * sp.ntab : 0);
  float* ry = rx + SUB;
  float* rz = ry + SUB;
  float* rbw = rz + SUB;
  float* rbu = rbw + SUB;
  int* rtype = (int*)(rbu + SUB);
  float* part = (float*)(rtype + SUB);               // [G][32][3]
  float4* colf = (float4*)(part + nw * SUB * 3) + warp * SUB;
  int4* coli = (int4*)((float4*)(part + nw * SUB * 3) + nw * SUB) + warp * SUB;
  const int a = blockIdx.x;
  const int r0 = a * SUB;
  if (RECOMPUTE) stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  if (warp == 0) {
    const int ih = r0 + lane;
    rx[lane] = pos[ih];
    ry[lane] = pos[np + ih];
    rz[lane] = pos[2 * np + ih];
    rbw[lane] = brw[ih];
    rbu[lane] = bru[ih];
    rtype[lane] = RECOMPUTE ? sp.trow[ih] : 0;
  }
  __syncthreads();
  const int g = lane >> 3, r4 = lane & 7;
  float xi[4], yi[4], zi[4], bw[4], bu[4];
  int tbase[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = 4 * r4 + r;
    xi[r] = rx[rr];
    yi[r] = ry[rr];
    zi[r] = rz[rr];
    bw[r] = rbw[rr];
    bu[r] = rbu[rr];
    tbase[r] = rtype[rr] * sp.ntj;
  }
  float fr[4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) fr[r][0] = fr[r][1] = fr[r][2] = 0.0f;
  const int nch = (ncols[a] + SUB - 1) / SUB;
  const int part0 = blockIdx.y * nw, stride = gridDim.y * nw;
  for (int c = part0 + warp; c < nch; c += stride) {
    const int k0 = c * SUB;
    // the reload's Q/dQ of the whole chunk are loaded first, beside the
    // column data
    float4 q4[SUB / 4], dq4[SUB / 4];
    if constexpr (!RECOMPUTE) {
#pragma unroll
      for (int k = 0; k < SUB / 4; ++k) {
        const size_t o = ((size_t)a * nhp + k0 + 4 * k + g) * SUB + 4 * r4;
        q4[k] = *(const float4*)(q + o);
        dq4[k] = *(const float4*)(dq + o);
      }
    }
    const int jh = cols[(size_t)a * nhp + k0 + lane];
    colf[lane] = stage_column(posh, nhp, s, jh);
    coli[lane] = make_int4(jh, jh >= 0 && RECOMPUTE ? sp.hids[jh] : -1,
                           jh >= 0 && RECOMPUTE ? sp.tcol[jh] : 0, 0);
    __syncwarp();
    // the reload unrolled in full (its loads are in flight), the recompute
    // in pairs (its spline takes the registers)
#pragma unroll (RECOMPUTE ? 2 : 8)
    for (int k = 0; k < SUB / 4; ++k) {
      const int cc = 4 * k + g;
      const float4 cf = colf[cc];
      const int4 ci = coli[cc];
      float cw = 0.0f, cu = 0.0f, cfx = 0.0f, cfy = 0.0f, cfz = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float dx = cf.x - xi[r], dy = cf.y - yi[r], dz = cf.z - zi[r];
        min_image(box_mode, box, dx, dy, dz);
        const float d = sqrtf(dx * dx + dy * dy + dz * dz);
        float qv, dqv, inv_d;
        if constexpr (RECOMPUTE) {
          qv = dqv = inv_d = 0.0f;
          if (born_pair_live(r0 + 4 * r4 + r, ci.y, sp.n, d, sp.horizon)) {
            spline_qdq(tab, sp.ntab, tbase[r] + ci.z, d, qv, dqv);
            inv_d = __fdividef(1.0f, d);
          }
        } else {
          qv = lane4(q4[k], r);
          dqv = lane4(dq4[k], r);
          inv_d = d > 0.0f ? __fdividef(1.0f, d) : 0.0f;
        }
        cw += bw[r] * qv;
        cu += bu[r] * qv;
        const float cc_ = (bw[r] + bu[r]) * cf.w * dqv * inv_d;
        const float fx = cc_ * dx, fy = cc_ * dy, fz = cc_ * dz;
        cfx -= fx;
        cfy -= fy;
        cfz -= fz;
        fr[r][0] += fx;
        fr[r][1] += fy;
        fr[r][2] += fz;
      }
      // the column's 32 rows: the 8 lanes r4 in a fixed tree
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        cw += __shfl_xor_sync(FULL_MASK, cw, o);
        cu += __shfl_xor_sync(FULL_MASK, cu, o);
        cfx += __shfl_xor_sync(FULL_MASK, cfx, o);
        cfy += __shfl_xor_sync(FULL_MASK, cfy, o);
        cfz += __shfl_xor_sync(FULL_MASK, cfz, o);
      }
      if (r4 == 0 && ci.x >= 0) {
        float* pc = pcol + (size_t)a * DS_COL_K * nhp + ci.x;
        pc[0] = cw;
        pc[nhp] = cu;
        pc[2 * (size_t)nhp] = cfx;
        pc[3 * (size_t)nhp] = cfy;
        pc[4 * (size_t)nhp] = cfz;
      }
    }
    __syncwarp();  // the chunk is read before the next one lands
  }
  // row forces: the 4 column groups g (lanes r4, r4 + 8, r4 + 16, r4 + 24)
  // in a fixed tree, then the warps in order
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float v = fr[r][m];
      v += __shfl_xor_sync(FULL_MASK, v, 8);
      v += __shfl_xor_sync(FULL_MASK, v, 16);
      if (g == 0) part[(warp * SUB + 4 * r4 + r) * 3 + m] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float* out = f_rows + 3 * ((size_t)blockIdx.y * np + r0 + lane);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float sum = 0.0f;
      for (int w = 0; w < nw; ++w) sum += part[(w * SUB + lane) * 3 + m];
      out[m] = sum;
    }
  }
}

// Column sums: one block per 32 columns j (lane) of replica blockIdx.z,
// COLSUM_WARPS warps; warp w adds the partials of sub-tiles a = w, w +
// COLSUM_WARPS, ... whose bit for j is set, and the warps' sums are added in
// warp order.  With parts > 1, the blocks past NHP / 32 add the row forces'
// [parts, NP, 3] partials in part order, a thread an element.
__global__ void __launch_bounds__(COLSUM_WARPS * 32)
column_sums_kernel(const float* __restrict__ pcol,
                   const unsigned* __restrict__ bits, int nsub, int nhp,
                   const float* __restrict__ f_part, int parts, int np,
                   float* __restrict__ w_out, float* __restrict__ u_out,
                   float* __restrict__ f_cols, float* __restrict__ f_rows) {
  {
    const size_t b = blockIdx.z;
    pcol += b * nsub * DS_COL_K * nhp;
    bits += b * nsub * (nhp / SUB);
    if (f_part != nullptr) f_part += b * parts * 3 * np;
    w_out += b * nhp;
    u_out += b * nhp;
    f_cols += b * 3 * nhp;
    f_rows += b * 3 * np;
  }
  __shared__ float part[COLSUM_WARPS][DS_COL_K][SUB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jb = blockIdx.x, j = jb * SUB + lane;
  if (jb >= nhp / SUB) {
    const int e = (jb - nhp / SUB) * blockDim.x + threadIdx.x;
    if (e < 3 * np) {
      float sum = 0.0f;
      for (int p = 0; p < parts; ++p) sum += f_part[(size_t)p * 3 * np + e];
      f_rows[e] = sum;
    }
    return;
  }
  const int nwords = nhp / SUB;
  float acc[DS_COL_K];
#pragma unroll
  for (int m = 0; m < DS_COL_K; ++m) acc[m] = 0.0f;
#pragma unroll 2
  for (int a = warp; a < nsub; a += COLSUM_WARPS) {
    if ((bits[(size_t)a * nwords + jb] >> lane) & 1u) {
      const float* p = pcol + (size_t)a * DS_COL_K * nhp + j;
#pragma unroll
      for (int m = 0; m < DS_COL_K; ++m) acc[m] += p[(size_t)m * nhp];
    }
  }
#pragma unroll
  for (int m = 0; m < DS_COL_K; ++m) part[warp][m][lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
    float sum[DS_COL_K];
#pragma unroll
    for (int m = 0; m < DS_COL_K; ++m) {
      sum[m] = 0.0f;
      for (int w = 0; w < COLSUM_WARPS; ++w) sum[m] += part[w][m][lane];
    }
    w_out[j] = sum[0];
    u_out[j] = sum[1];
    f_cols[3 * (size_t)j] = sum[2];
    f_cols[3 * (size_t)j + 1] = sum[3];
    f_cols[3 * (size_t)j + 2] = sum[4];
  }
}

// nb replicas: every array but the spline's carries a leading [B] axis.
// q == nullptr selects the recomputing variant, which reads hids, trow,
// tcol, the tables, n and horizon; the reloading variant reads q/dq [B, S,
// NHP, 32] from agbnp_born_sums on the same chunks (16-byte aligned) and
// no spline argument.  warps: G; parts: P, the blocks a sub-tile's chunks
// are split over (at most MAX_CHUNK_PARTS).  pcol [B, S, 5, NHP] is
// scratch, written for the listed (sub-tile, column) pairs only; f_part
// [B, P, NP, 3] is scratch when P > 1 (may be null when P == 1).
extern "C" int agbnp_descreening(
    int nb, const float* pos, int np, const float* posh, int nhp,
    const float* q, const float* dq, const float* s, const float* brw,
    const float* bru, int box_mode, const float* box, const int* hids,
    const int* trow, const int* tcol, const float* yval, const float* y2val,
    int nti, int ntj, int n, float horizon, const int* cols, const int* ncols,
    const unsigned* bits, int warps, int parts, float* pcol, float* f_part,
    float* w_out, float* u_out, float* f_rows, float* f_cols, void* stream) {
  if (warps < 1 || warps > MAX_CHUNK_WARPS || parts < 1
      || parts > MAX_CHUNK_PARTS || (parts > 1 && f_part == nullptr)
      || nb < 1 || nb > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  const bool recompute = q == nullptr;
  const size_t smem =
      ((recompute ? 2 * (size_t)sp.ntab : 0) + 6 * SUB + warps * SUB * 3
       + warps * SUB * 8) * sizeof(float);
  const int nsub = np / SUB;
  const dim3 grid(nsub, parts, nb);
  float* rows_out = parts > 1 ? f_part : f_rows;
  if (recompute) {
    allow_smem((const void*)descreen_chunks_kernel<true>, smem);
    descreen_chunks_kernel<true><<<grid, warps * 32, smem, st>>>(
        pos, np, posh, nhp, q, dq, s, brw, bru, box_mode, box, sp, cols,
        ncols, rows_out, pcol);
  } else {
    allow_smem((const void*)descreen_chunks_kernel<false>, smem);
    descreen_chunks_kernel<false><<<grid, warps * 32, smem, st>>>(
        pos, np, posh, nhp, q, dq, s, brw, bru, box_mode, box, sp, cols,
        ncols, rows_out, pcol);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int threads = COLSUM_WARPS * 32;
  const int row_blocks = parts > 1 ? (3 * np + threads - 1) / threads : 0;
  column_sums_kernel<<<dim3(nhp / SUB + row_blocks, 1, nb), threads, 0,
                       st>>>(
      pcol, bits, nsub, nhp, f_part, parts, np, w_out, u_out, f_cols,
      f_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// agbnp_empty_launch: one launch of a kernel that does nothing, the floor
// under any kernel's time, for a tool to put beside a bound of a few tenths
// of a microsecond.
// ---------------------------------------------------------------------------
__global__ void empty_kernel() {}

extern "C" int agbnp_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
