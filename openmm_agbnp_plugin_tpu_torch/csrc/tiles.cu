// AGBNP1 pair sweeps over interacting-tile lists for Hopper (sm_90a), f32.
//
// The same three sweeps as pairs.cu, but over a compacted list of tile
// pairs instead of the dense tile grid.  The list comes from
// build_tile_list (ops/kernels/tiles.py), rebuilt on the device at every
// evaluation: tl [2, lmax] int32 (row tile; column tile, i-major) and
// nv [1] int32, the number of valid entries.  Every launch is sized by the
// static budget lmax; work at an entry l >= nv[0] exits on the device, so
// the host never waits for the count.
//
//   agbnp_born_sums_tiles     replaces _born_kernel_tl / born_sums_tiles
//                             (openmm_agbnp_plugin_tpu/ops/pallas/
//                             pairs.py:804-857, pallas_call at :842)
//   agbnp_gb_pair_tiles       replaces _gb_kernel_tl / gb_pair_tiles
//                             (:860-982, pallas_call at :966), triangular
//                             list, MM fused
//   agbnp_descreening_tiles   replaces _descreen_qd_kernel_tl and
//                             _descreen_kernel_tl / descreening_tiles
//                             (:985-1125, pallas_call at :1114)
//
// Determinism without float atomics: the TPU grid is serial and adds each
// entry into full-width VMEM rows in list order.  Here the work runs in
// parallel, so each unit writes its own partial sums and subtile_reduce_
// kernel adds them up in a fixed order.  Results are bitwise repeatable.
//
// The three sweeps (redesigned for the H100).  What held the first versions
// back (one 256-thread block per list entry): at 2clr the GB block staged
// 79 KB of shared memory, so two blocks fit an SM and ~290 entries ran in
// two waves; each tile row cost a per-warp shuffle tree; every slot of the
// 256x256 entry was swept though ~7% are live; every live pair scanned its
// 24-wide exclusion list; the Born sweep wrote the full [T, T] Q/dQ tiles of
// every entry, zeros past nv included (164 MB at 2clr, of which the reload
// reads about half); the reloading descreening sweep kept two scalar loads
// in flight a thread (~0.7 TB/s) and streamed every Q/dQ value; at 1li2 a
// launch had at most 21 blocks for 132 SMs; and the reduce walked the whole
// list serially in one block per output tile.  What bounds them: the GB
// sweep and the recomputing descreening sweep are bound by operations (live
// pairs x ~46-74 FP32 operations, a few us at 2clr); the Born sweep and the
// reload by bytes, 8 of Q/dQ per live pair, in practice by the 8 KB of each
// kept 32x32 sub-tile pair, which is what the Born sweep stores.  The
// design:
//
//   * The unit of work is one warp on (entry l, 32-row sub-tile a, column
//     group grp): it walks the group's T/32/ng column sub-tiles b in
//     order, so the budget lmax gives lmax T/32 ng independent warps.  The
//     GB sweep always takes ng = T/32, one warp per sub-tile pair (its
//     fastest split at 1li2's and 2clr's shapes: 1li2's 21 entries give 1344
//     warps for 132 SMs).  For Born and descreening, ng (tiles.py::
//     column_groups, from the budget, the tile and the card) cuts 1li2's 18
//     entries into single sub-tile pairs and 2clr's list into halves; both
//     take the same ng on the same list.
//   * Sub-tile pruning with the list's own rule: each warp forms the
//     32-atom box of its rows and of each column sub-tile (warp min/max, the
//     numbers of tile_bounds(pos, valid, 32)) and skips (a, b) when
//     |c_a - c_b|_minimage - r_a - r_b >= rng + SUBTILE_MARGIN, rng being
//     the range the list was built with; in a diagonal GB entry it also
//     skips b < a, which holds no pair with gi < gj.  A skipped pair adds
//     exactly what the twin adds for it: zero.  tiles.py::subtile_live is
//     the torch mirror of the decision.
//   * GB, OpenMM style: each lane holds one row atom and one column atom;
//     the column data and the column sums rotate through the 32 lanes with
//     __shfl_sync, the row sums stay in registers.  Exclusions become one
//     32-bit mask per row and column sub-tile, built once from the E-wide
//     list, then one bit test per pair.
//   * Born: lane x holds row 32 a + x and its sum in a register; the column
//     data reach it as shared-memory broadcasts, one column a step (faster
//     than rotating them through the lanes as GB does: 2 loads a step
//     against 6 shuffles).  Q and dQ/dd of a kept sub-tile pair pass through
//     a per-warp shared-memory tile so that each store writes whole 64-byte
//     pieces of Q/dQ rows.  Only kept sub-tile pairs are written: on the
//     card, Q/dQ outside them are undefined, entries past nv included.  The
//     keep bits it writes tell the reload which sub-tile pairs hold Q/dQ,
//     so no second box computation on other validity rules can disagree.
//   * Descreening: each lane covers 4 columns (one 16-byte load of Q and
//     of dQ along j) of 8 rows; the reload reads only the Q/dQ of the kept
//     sub-tile pairs: those of the Born sweep's keep bits when it has them,
//     else of its own boxes (Q/dQ written in full, zero outside the Born
//     mask: a twin's).  Column sums (W, U, screener force) add the 4 row
//     groups in a fixed shuffle tree; row forces stay in registers across b
//     and add the 8 column quads in a fixed tree at the end.
//   * Partials: rows [lmax, ng, K, T] per (l, grp) that kept a sub-tile
//     pair, columns [lmax, T/32, K, T] per (l, a) and kept b, with the kept
//     bits keep[l, a, grp].  subtile_reduce_kernel has one block per
//     32-row output sub-tile (192 for 2clr's rows, not 24 tiles): it lists
//     its terms in list order with a block-wide prefix sum, deals them
//     round-robin to its warps with four loads in flight each, and adds the
//     warps in order.
//
//   * Replicas.  One launch serves B replicas of one system: the replica
//     b is the grid's blockIdx.z, and each block moves its per-replica
//     pointers by b times the replica's extent (positions, screening
//     factors, Born radii, BrW/BrU, the list tl [B, 2, lmax] and nv [B],
//     Q/dQ, keep bits, scratch and outputs).  The tables the replicas share
//     (charges, LJ parameters, exclusion rows, screener ids, radius types,
//     the spline) carry no replica axis.  The dense GB sweep's list
//     (every tile pair) is one list for all replicas (shared_list).  A
//     block's work inside its replica is the B = 1 block's, so replica b
//     of a batch is bitwise its own B = 1 launch.
//
// Each host function launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include "common.cuh"

#define BORN_WARPS 4         // Born units a block (they share the tables)
#define BORN_CHUNK 16        // Born, column walk: columns staged at a time
#define BORN_LD (BORN_CHUNK + 1)  // and the staging row stride
#define SUB 32               // sub-tile edge: one warp's rows, one column block
#define MAX_K 6
#define GB_K 6               // GB partial components: E, Y, fx, fy, fz, MM
#define DS_ROW_K 3           // descreening row side: fx, fy, fz
#define DS_COL_K 5           // descreening column side: W, U, fx, fy, fz
#define REDUCE_WARPS 8
#define REDUCE_SMEM_MAX (200 * 1024)  // the term list of one output sub-tile
#define DS_ROWS_IN_FLIGHT 2  // descreening: rows of Q/dQ loads a lane issues
                             // before it uses them (the compiler may hoist)
// nm added to the range before a sub-tile pair is dropped, far above the
// f32 rounding of the boxes and distances (tiles.py SUBTILE_MARGIN)
#define SUBTILE_MARGIN 1e-3f

// Where subtile_reduce_kernel writes component m of output row g of
// replica b: p[m][b * rstride[m] + g * stride[m]] (skipped when p[m] is
// null).
struct Dest {
  float* p[MAX_K];
  int stride[MAX_K];
  size_t rstride[MAX_K];
};

// Move nv and tl to the list of replica blockIdx.z: tl [2, lmax] and nv
// [1] of the [B, 2, lmax] and [B] arrays, unless every replica shares one
// list (shared_list).
#define REPLICA_LIST(nv, tl, lmax, shared_list)      \
  if (!(shared_list)) {                              \
    nv += blockIdx.z;                                \
    tl += (size_t)blockIdx.z * 2 * (lmax);           \
  }

// ---------------------------------------------------------------------------
// Sub-tile boxes and the pruning test
// ---------------------------------------------------------------------------

// Axis-aligned box of the valid atoms among the warp's 32 (one per lane):
// center and half-diagonal as tile_bounds forms them, the same in every
// lane; has is false when no lane holds a valid atom.
struct SubBox {
  float cx, cy, cz, r;
  bool has;
};

__device__ __forceinline__ SubBox warp_box(float x, float y, float z,
                                           bool valid) {
  SubBox b;
  b.has = __any_sync(FULL_MASK, valid);
  const float lx = warp_min(valid ? x : 1e30f);
  const float ly = warp_min(valid ? y : 1e30f);
  const float lz = warp_min(valid ? z : 1e30f);
  const float hx = warp_max(valid ? x : -1e30f);
  const float hy = warp_max(valid ? y : -1e30f);
  const float hz = warp_max(valid ? z : -1e30f);
  b.cx = 0.5f * (lx + hx);
  b.cy = 0.5f * (ly + hy);
  b.cz = 0.5f * (lz + hz);
  const float ex = hx - lx, ey = hy - ly, ez = hz - lz;
  b.r = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
  return b;
}

// Whether a sub-tile pair may hold a pair within rng (the list's rule
// with the margin).  Warp-uniform: both boxes are.
__device__ __forceinline__ bool subtiles_near(const SubBox& a,
                                              const SubBox& b, float rng,
                                              int box_mode,
                                              const float* box) {
  if (!(a.has && b.has)) return false;
  float dx = b.cx - a.cx, dy = b.cy - a.cy, dz = b.cz - a.cz;
  min_image(box_mode, box, dx, dy, dz);
  return sqrtf(dx * dx + dy * dy + dz * dz) - a.r - b.r
         < rng + SUBTILE_MARGIN;
}

__device__ __forceinline__ int lane4(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

static void allow_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
}

// ---------------------------------------------------------------------------
// The reduce
// ---------------------------------------------------------------------------

// One output of the reduce: row and column partials (either may be null),
// k components, extent rows (NP or NHP), at most cap terms an output
// sub-tile, and where the sums go.
struct ReduceJob {
  const float* prow;
  const float* pcol;
  int k, extent, cap;
  Dest dst;
};

// One block per 32-row output sub-tile s of job j0, then of job j1 (tile
// t = s / S, sub-tile b = s % S), one lane of each warp per row.  Its
// terms, in list order: for
// every valid entry l whose row tile is t, the row partials prow[l, g, m,
// 32 b + x] of each column group g < ng that kept a sub-tile pair
// (keep[l, b, g] != 0), then, if its column tile is t, the column partials
// pcol[l, a, m, 32 b + x] of each row sub-tile a whose group g = b /
// (S / ng) kept b (bit b of keep[l, a, g]), in order of a.  The Born sweep
// has row partials only.
//
// First the block lists the terms in shared memory: each thread takes one
// entry, counts its terms, and a block-wide prefix sum over the entries
// places them in list order.  Then warp w of the REDUCE_WARPS adds terms
// w, w + nw, w + 2 nw, ... (four loads in flight), and the warps' sums are
// added in warp order.
__global__ void subtile_reduce_kernel(const ReduceJob j0, const ReduceJob j1,
                                      const int* __restrict__ keep, int ng,
                                      const int* __restrict__ nv,
                                      const int* __restrict__ tl, int lmax,
                                      int tile, int shared_list) {
  extern __shared__ int terms[];  // [cap]: (partial index << 1) | column
  __shared__ int wtot[REDUCE_WARPS];
  __shared__ float part[REDUCE_WARPS][MAX_K][SUB];
  const int n0 = j0.extent / SUB;
  const ReduceJob job = blockIdx.x < n0 ? j0 : j1;
  const int k = job.k;
  const int s = blockIdx.x < n0 ? blockIdx.x : blockIdx.x - n0;
  const int S = tile / SUB;
  // replica blockIdx.z: its list, keep bits and partials
  const size_t rb = blockIdx.z;
  REPLICA_LIST(nv, tl, lmax, shared_list);
  keep += rb * lmax * S * ng;
  const float* __restrict__ prow =
      job.prow == nullptr ? nullptr : job.prow + rb * lmax * ng * k * tile;
  const float* __restrict__ pcol =
      job.pcol == nullptr ? nullptr : job.pcol + rb * lmax * S * k * tile;
  const int t = s / S, b = s - t * S;
  const int gb = b / (S / ng);  // the column group that holds b
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int nvl = min(nv[0], lmax);
  int nterms = 0;
  for (int c0 = 0; c0 < nvl; c0 += blockDim.x) {
    const int l = c0 + threadIdx.x;
    unsigned rbits = 0, cbits = 0;
    if (l < nvl) {
      if (prow != nullptr && tl[l] == t) {
        for (int g = 0; g < ng; ++g)
          if (keep[(l * S + b) * ng + g] != 0) rbits |= 1u << g;
      }
      if (pcol != nullptr && tl[lmax + l] == t) {
        for (int a = 0; a < S; ++a)
          if ((keep[(l * S + a) * ng + gb] >> b) & 1) cbits |= 1u << a;
      }
    }
    const int cnt = __popc(rbits) + __popc(cbits);
    int inc = cnt;  // inclusive prefix sum over the warp's entries
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) wtot[warp] = inc;
    __syncthreads();
    int off = nterms + inc - cnt, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) off += wtot[w];
      total += wtot[w];
    }
    while (rbits != 0) {
      const int g = __ffs(rbits) - 1;
      rbits &= rbits - 1;
      terms[off++] = (l * ng + g) << 1;
    }
    while (cbits != 0) {
      const int a = __ffs(cbits) - 1;
      cbits &= cbits - 1;
      terms[off++] = ((l * S + a) << 1) | 1;
    }
    nterms += total;
    __syncthreads();
  }
  const size_t x = (size_t)b * SUB + lane;
  float acc[MAX_K];
#pragma unroll
  for (int m = 0; m < MAX_K; ++m) acc[m] = 0.0f;
  int q = warp;
  for (; q + 3 * nw < nterms; q += 4 * nw) {
    float v[4][MAX_K];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = terms[q + u * nw];
      const float* p = (d & 1 ? pcol : prow) + (size_t)(d >> 1) * k * tile + x;
#pragma unroll
      for (int m = 0; m < MAX_K; ++m)
        v[u][m] = m < k ? p[(size_t)m * tile] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < MAX_K; ++m) acc[m] += v[u][m];
  }
  for (; q < nterms; q += nw) {
    const int d = terms[q];
    const float* p = (d & 1 ? pcol : prow) + (size_t)(d >> 1) * k * tile + x;
#pragma unroll
    for (int m = 0; m < MAX_K; ++m)
      if (m < k) acc[m] += p[(size_t)m * tile];
  }
#pragma unroll
  for (int m = 0; m < MAX_K; ++m)
    if (m < k) part[warp][m][lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
    const size_t g = (size_t)t * tile + x;
#pragma unroll
    for (int m = 0; m < MAX_K; ++m) {
      if (m < k && job.dst.p[m] != nullptr) {
        float sum = 0.0f;
        for (int w = 0; w < nw; ++w) sum += part[w][m][lane];
        job.dst.p[m][rb * job.dst.rstride[m] + g * job.dst.stride[m]] = sum;
      }
    }
  }
}

// A job over extent output rows; nrow_tiles / ncol_tiles, the list's row
// and column tile counts, bound an output sub-tile's terms: an entry per
// column tile with the row tile, up to ng terms each, and one per row
// tile with the column tile, up to T / 32 each.
static ReduceJob reduce_job(const float* prow, const float* pcol, int k,
                            int extent, int nrow_tiles, int ncol_tiles,
                            int ng, int tile, const Dest& dst) {
  const int cap = (prow != nullptr ? ncol_tiles * ng : 0)
                  + (pcol != nullptr ? nrow_tiles * (tile / SUB) : 0);
  return ReduceJob{prow, pcol, k, extent, cap, dst};
}

// One launch for j0 and j1 (j1.extent 0: none), nb replicas.
static int reduce_subtiles(const ReduceJob& j0, const ReduceJob& j1,
                           const int* keep, int ng, const int* nv,
                           const int* tl, int lmax, int tile, int nb,
                           int shared_list, cudaStream_t st) {
  const size_t smem = (size_t)max(max(j0.cap, j1.cap), 1) * sizeof(int);
  if (smem > REDUCE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  allow_smem((const void*)subtile_reduce_kernel, smem);
  subtile_reduce_kernel<<<dim3((j0.extent + j1.extent) / SUB, 1, nb),
                          REDUCE_WARPS * 32, smem, st>>>(
      j0, j1, keep, ng, nv, tl, lmax, tile, shared_list);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Born sums over the list.  One warp per (entry l, row sub-tile a, column
// group grp), BORN_WARPS of them a block sharing the spline tables staged in
// shared memory.  Lane x holds row i = ti T + 32 a + x and its sum over the
// group's kept column sub-tiles b.  Per kept b the warp walks the 32
// columns, one a step for every lane, read from shared memory as a
// broadcast.  With q_out, the sub-tile pair's Q and dQ/dd (the spline value
// where the Born mask accepts a pair, zero elsewhere) go to a shared tile
// BORN_CHUNK columns at a time (row stride BORN_LD, one bank a lane), then
// out as 64-byte row pieces (8 columns a store were slower at 2clr, and 32
// take 17 KB of shared memory a warp, too many for the warps the walk needs
// in flight).  Nothing outside the kept sub-tile pairs is written.
// ---------------------------------------------------------------------------

// floats of shared memory each Born warp uses beyond the tables: column
// data, then the Q and dQ staging tiles
#define BORN_WARP_FLOATS (6 * SUB + 2 * SUB * BORN_LD)

__global__ void __launch_bounds__(BORN_WARPS * 32)
born_subtiles_kernel(const int* __restrict__ nv, const int* __restrict__ tl,
                     int lmax, int tile, int ng,
                     const float* __restrict__ pos, int np,
                     const float* __restrict__ posh, int nhp,
                     const float* __restrict__ s, SplineRefs sp, int box_mode,
                     const float* __restrict__ box, float* __restrict__ prow,
                     int* __restrict__ keep, float* __restrict__ q_out,
                     float* __restrict__ dq_out) {
  {
    const size_t b = blockIdx.z, S = tile / SUB;
    REPLICA_LIST(nv, tl, lmax, 0);
    pos += b * 3 * np;
    posh += b * 3 * nhp;
    s += b * nhp;
    prow += b * lmax * ng * tile;
    keep += b * lmax * S * ng;
    if (q_out != nullptr) {
      q_out += b * lmax * tile * tile;
      dq_out += b * lmax * tile * tile;
    }
  }
  extern __shared__ float sh[];
  float* tab = sh;  // y [ntab], y2 [ntab]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wsh = sh + 2 * sp.ntab + warp * BORN_WARP_FLOATS;
  float4* colf = (float4*)wsh;          // column x, y, z, s [32]
  int2* coli = (int2*)(wsh + 4 * SUB);  // column screener id, type [32]
  float* qs = wsh + 6 * SUB;            // Q [32 rows][BORN_LD]
  float* dqs = qs + SUB * BORN_LD;      // dQ/dd [32 rows][BORN_LD]
  stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  __syncthreads();
  const int S = tile / SUB, G = S / ng;
  const int unit = blockIdx.x * BORN_WARPS + warp;
  const int l = unit / (S * ng);
  const int a = (unit / ng) % S, grp = unit % ng;
  if (l >= lmax || l >= nv[0]) return;
  const int ti = tl[l], tj = tl[lmax + l];
  const int i = ti * tile + a * SUB + lane;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const int tbase = sp.trow[i] * sp.ntj;
  const SubBox rbox = warp_box(xi, yi, zi, i < sp.n);
  float acc = 0.0f;
  unsigned kept = 0;
  for (int b = grp * G; b < (grp + 1) * G; ++b) {
    const int jh = tj * tile + b * SUB + lane;
    const float xj = posh[jh], yj = posh[nhp + jh], zj = posh[2 * nhp + jh];
    const int gj = sp.hids[jh];
    if (!subtiles_near(rbox, warp_box(xj, yj, zj, gj >= 0), sp.horizon,
                       box_mode, box))
      continue;
    kept |= 1u << b;
    colf[lane] = make_float4(xj, yj, zj, s[jh]);
    coli[lane] = make_int2(gj, sp.tcol[jh]);
    __syncwarp();
    // Q/dQ of row 32 a, column 32 b of this entry
    const size_t qoff = (size_t)l * tile * tile + (size_t)a * SUB * tile
                        + b * SUB;
    for (int c0 = 0; c0 < SUB; c0 += BORN_CHUNK) {
#pragma unroll
      for (int cc = 0; cc < BORN_CHUNK; ++cc) {
        const int2 ci = coli[c0 + cc];
        float qv, dqv;
        born_pair(tab, sp, i, tbase, xi, yi, zi, colf[c0 + cc], ci.x, ci.y,
                  box_mode, box, acc, qv, dqv);
        if (q_out != nullptr) {
          qs[lane * BORN_LD + cc] = qv;
          dqs[lane * BORN_LD + cc] = dqv;
        }
      }
      if (q_out != nullptr) {
        __syncwarp();
        // lanes over the chunk's columns, SUB / BORN_CHUNK rows a store
        const int rr = lane / BORN_CHUNK, cc = lane % BORN_CHUNK;
#pragma unroll
        for (int r0 = 0; r0 < SUB; r0 += SUB / BORN_CHUNK) {
          const int r = r0 + rr;
          const size_t o = qoff + (size_t)r * tile + c0 + cc;
          q_out[o] = qs[r * BORN_LD + cc];
          dq_out[o] = dqs[r * BORN_LD + cc];
        }
        __syncwarp();
      }
    }
    __syncwarp();  // the column data are read before the next b's land
  }
  if (kept != 0) prow[((size_t)l * ng + grp) * tile + a * SUB + lane] = acc;
  if (lane == 0) keep[(l * S + a) * ng + grp] = (int)kept;
}

// nb replicas, each with its own list (nv [B], tl [B, 2, lmax]) and every
// other array but the spline's with a leading [B] axis.  groups: ng, as for
// the descreening sweep on the same list.  horizon is also the list's
// range.  prow [B, lmax, ng, 1, T] is scratch; keep [B, lmax, T/32, ng] is
// written for the entries below nv, and tells the reload which sub-tile
// pairs of q_out/dq_out [B, lmax, T, T] hold Q/dQ.
extern "C" int agbnp_born_sums_tiles(
    int nb, const int* nv, const int* tl, int lmax, int tile, int groups,
    const float* pos, int np, const float* posh, int nhp, const int* hids,
    const int* trow, const int* tcol, const float* yval, const float* y2val,
    int nti, int ntj, const float* s, int n, float horizon, int box_mode,
    const float* box, float* prow, int* keep, float* raw, float* q_out,
    float* dq_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  const size_t smem =
      (2 * (size_t)sp.ntab + BORN_WARPS * BORN_WARP_FLOATS) * sizeof(float);
  allow_smem((const void*)born_subtiles_kernel, smem);
  const int units = lmax * (tile / SUB) * groups;
  born_subtiles_kernel<<<dim3((units + BORN_WARPS - 1) / BORN_WARPS, 1, nb),
                         BORN_WARPS * 32, smem, st>>>(
      nv, tl, lmax, tile, groups, pos, np, posh, nhp, s, sp, box_mode, box,
      prow, keep, q_out, dq_out);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Dest dst{};
  dst.p[0] = raw;
  dst.stride[0] = 1;
  dst.rstride[0] = np;
  return reduce_subtiles(reduce_job(prow, nullptr, 1, np, np / tile,
                                    nhp / tile, groups, tile, dst),
                         ReduceJob{}, keep, groups, nv, tl, lmax, tile, nb, 0,
                         st);
}

// ---------------------------------------------------------------------------
// GB pair sweep over the triangular list (tj >= ti): every unordered pair
// once, on the entry whose tiles hold it, with gi < gj inside a diagonal
// entry.  One warp per (entry l, row sub-tile a, column group grp): lane x
// holds row i = ti T + 32 a + x for the whole walk over the group's column
// sub-tiles b (b >= a in a diagonal entry) and, for each kept b, starts
// with column j0 + x.  Step k pairs the lane's row with column j0 + ((x +
// k) & 31); then every lane takes its right neighbour's column data and
// column sums, so after 32 steps each column's sums are home.  Each pair is
// deposited on both sides: E, Y and MM with the same sign, the force with
// opposite signs.  Reciprocals and reciprocal square roots are the fast
// approximate ones (a few ulp; the twin's tolerance is 1e-5).
// ---------------------------------------------------------------------------
template <bool MM>
__global__ void __launch_bounds__(32, 24)
gb_subtiles_kernel(const int* __restrict__ nv, const int* __restrict__ tl,
                   int lmax, int tile, int ng,
                   const float* __restrict__ pos, int np,
                   const float* __restrict__ charge,
                   const float* __restrict__ born,
                   const float* __restrict__ sig,
                   const float* __restrict__ epsq,
                   const int* __restrict__ excl, int ne, int n,
                   float cutoff2, float rng, int box_mode,
                   const float* __restrict__ box, float dfac, float ke,
                   float* __restrict__ prow, float* __restrict__ pcol,
                   int* __restrict__ keep, int shared_list) {
  const int S = tile / SUB, G = S / ng;
  {
    const size_t b = blockIdx.z;
    REPLICA_LIST(nv, tl, lmax, shared_list);
    pos += b * 3 * np;
    born += b * np;
    prow += b * lmax * ng * GB_K * tile;
    pcol += b * lmax * S * GB_K * tile;
    keep += b * lmax * S * ng;
  }
  const int l = blockIdx.x / (S * ng);
  const int a = (blockIdx.x / ng) % S, grp = blockIdx.x % ng;
  const int lane = threadIdx.x;
  if (l >= nv[0]) return;
  const int ti = tl[l], tj = tl[lmax + l];
  const int i = ti * tile + a * SUB + lane;
  const float xi = pos[i], yi = pos[np + i], zi = pos[2 * np + i];
  const float qi = charge[i], bi = born[i];
  const float sgi = MM ? sig[i] : 0.0f, epi = MM ? epsq[i] : 0.0f;
  const SubBox rbox = warp_box(xi, yi, zi, i < n);
  float racc[GB_K];
#pragma unroll
  for (int m = 0; m < GB_K; ++m) racc[m] = 0.0f;
  unsigned kept = 0;
  const int b0 = grp * G;
  for (int b = ti == tj ? max(a, b0) : b0; b < b0 + G; ++b) {
    const int j0 = tj * tile + b * SUB;
    const int jh = j0 + lane;
    float xj = pos[jh], yj = pos[np + jh], zj = pos[2 * np + jh];
    if (!subtiles_near(rbox, warp_box(xj, yj, zj, jh < n), rng, box_mode,
                       box))
      continue;
    kept |= 1u << b;
    float qj = charge[jh], bj = born[jh];
    float sgj = MM ? sig[jh] : 0.0f, epj = MM ? epsq[jh] : 0.0f;
    unsigned exm = 0;  // bit c: row i excludes column j0 + c
    if (MM) {
      const int* ex = excl + (size_t)i * ne;
      for (int e = 0; e < ne; ++e) {
        const unsigned off = (unsigned)(ex[e] - j0);
        if (off < SUB) exm |= 1u << off;
      }
    }
    float cacc[GB_K];
#pragma unroll
    for (int m = 0; m < GB_K; ++m) cacc[m] = 0.0f;
    const int src = (lane + 1) & 31;
#pragma unroll 4
    for (int k = 0; k < SUB; ++k) {
      const int c = (lane + k) & 31;
      const int j = j0 + c;
      float dx = xj - xi, dy = yj - yi, dz = zj - zi;
      min_image(box_mode, box, dx, dy, dz);
      const float d2 = dx * dx + dy * dy + dz * dz;
      const bool live = i < j && j < n && (cutoff2 < 0.0f || d2 < cutoff2);
      if (live) {
        const float bb = bi * bj;
        const float etij = expf(__fdividef(-0.25f * d2, bb));
        const float fgb = rsqrtf(d2 + bb * etij);
        const float qq_f = qi * qj;
        const float qq = dfac * qq_f;
        const float fgb3 = fgb * fgb * fgb;
        float mw = -2.0f * qq * (1.0f - 0.25f * etij) * fgb3;
        const float e_gb = qq * fgb;
        const float y_gb = qq_f * (bb + 0.25f * d2) * etij * fgb3;
        float e_mm = 0.0f;
        if (MM && !((exm >> c) & 1u)) {
          const float inv2 = __fdividef(1.0f, d2);
          const float sr2 = (sgi * sgj) * inv2;
          const float sr6 = sr2 * sr2 * sr2;
          const float epsij = epi * epj;
          const float ecoul = ke * qq_f * rsqrtf(d2);
          const float elj = 4.0f * epsij * (sr6 * sr6 - sr6);
          e_mm = elj + ecoul;
          const float dmm = (4.0f * epsij * (-6.0f * sr6 * sr6 + 3.0f * sr6)
                             - 0.5f * ecoul) * inv2;
          mw = mw + 2.0f * dmm;
        }
        const float fx = dx * mw, fy = dy * mw, fz = dz * mw;
        racc[0] += e_gb;
        racc[1] += y_gb;
        racc[2] += fx;
        racc[3] += fy;
        racc[4] += fz;
        racc[5] += e_mm;
        cacc[0] += e_gb;
        cacc[1] += y_gb;
        cacc[2] -= fx;
        cacc[3] -= fy;
        cacc[4] -= fz;
        cacc[5] += e_mm;
      }
      xj = __shfl_sync(FULL_MASK, xj, src);
      yj = __shfl_sync(FULL_MASK, yj, src);
      zj = __shfl_sync(FULL_MASK, zj, src);
      qj = __shfl_sync(FULL_MASK, qj, src);
      bj = __shfl_sync(FULL_MASK, bj, src);
      if (MM) {
        sgj = __shfl_sync(FULL_MASK, sgj, src);
        epj = __shfl_sync(FULL_MASK, epj, src);
      }
#pragma unroll
      for (int m = 0; m < GB_K; ++m)
        if (MM || m != 5) cacc[m] = __shfl_sync(FULL_MASK, cacc[m], src);
    }
    float* pc = pcol + ((size_t)l * S + a) * GB_K * tile + b * SUB + lane;
#pragma unroll
    for (int m = 0; m < GB_K; ++m) pc[(size_t)m * tile] = cacc[m];
  }
  if (kept != 0) {
    float* pr = prow + ((size_t)l * ng + grp) * GB_K * tile + a * SUB + lane;
#pragma unroll
    for (int m = 0; m < GB_K; ++m) pr[(size_t)m * tile] = racc[m];
  }
  if (lane == 0) keep[(l * S + a) * ng + grp] = (int)kept;
}

// nb replicas: positions [B, 3, NP], Born radii [B, NP], every output and
// scratch array with a leading [B] axis; charges, LJ parameters and
// exclusion rows are shared.  shared_list: one list (nv [1], tl [2, lmax])
// for every replica (the dense sweep's), else nv [B], tl [B, 2, lmax].
// groups: ng, the column groups of T / 32 / ng sub-tiles each that split
// every (entry, row sub-tile); prow [B, lmax, ng, 6, T], pcol [B, lmax,
// T/32, 6, T] and keep [B, lmax, T/32, ng] are scratch.
extern "C" int agbnp_gb_pair_tiles(
    int nb, int shared_list, const int* nv, const int* tl, int lmax, int tile,
    int groups,
    const float* pos, int np, const float* charge, const float* born,
    const float* sig, const float* epsq, const int* excl, int ne, int n,
    float cutoff2, float rng, int box_mode, const float* box, float dfac,
    float ke, float* prow, float* pcol, int* keep, float* erow, float* yrow,
    float* force, float* mmrow, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(lmax * (tile / SUB) * groups, 1, nb);
  if (mmrow != nullptr) {
    gb_subtiles_kernel<true><<<grid, SUB, 0, st>>>(
        nv, tl, lmax, tile, groups, pos, np, charge, born, sig, epsq, excl,
        ne, n, cutoff2, rng, box_mode, box, dfac, ke, prow, pcol, keep,
        shared_list);
  } else {
    gb_subtiles_kernel<false><<<grid, SUB, 0, st>>>(
        nv, tl, lmax, tile, groups, pos, np, charge, born, sig, epsq, excl,
        0, n, cutoff2, rng, box_mode, box, dfac, ke, prow, pcol, keep,
        shared_list);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Dest dst{};
  float* outs[GB_K] = {erow, yrow, force, force + 1, force + 2, mmrow};
  const int strides[GB_K] = {1, 1, 3, 3, 3, 1};
  for (int m = 0; m < GB_K; ++m) {
    dst.p[m] = outs[m];
    dst.stride[m] = strides[m];
    dst.rstride[m] = (size_t)strides[m] * np;
  }
  return reduce_subtiles(reduce_job(prow, pcol, GB_K, np, np / tile,
                                    np / tile, groups, tile, dst),
                         ReduceJob{}, keep, groups, nv, tl, lmax, tile, nb,
                         shared_list, st);
}

// ---------------------------------------------------------------------------
// Descreening over the Born list.  One warp per (entry l, row sub-tile a,
// column group grp).  For each kept column sub-tile b of the group, lane
// (g = x >> 3, c4 = x & 7) covers columns j0 + 4 c4 .. + 3 of rows 32 a +
// g + 4 k, k = 0..7.  The reloading variant reads the entry's saved Q/dQ
// as one float4 per row (coalesced: 8 lanes cover a 128-byte row) and
// guards only d > 0, as the TPU kernel does; with keep_in (the Born
// sweep's keep bits) it visits exactly the sub-tile pairs those name and
// forms no box.  Entry l's Q/dQ tile starts at l T T with row stride T.
// The recomputing variant (RECOMPUTE) re-evaluates the Born mask and spline
// from tables staged in shared memory.  Row data sits in shared memory,
// column data in registers.
// ---------------------------------------------------------------------------
template <bool RECOMPUTE>
__global__ void __launch_bounds__(32, 16)
descreen_subtiles_kernel(const int* __restrict__ nv,
                         const int* __restrict__ tl, int lmax, int tile,
                         int ng, const float* __restrict__ pos, int np,
                         const float* __restrict__ posh, int nhp,
                         const float* __restrict__ q,
                         const float* __restrict__ dq,
                         const int* __restrict__ keep_in,
                         const float* __restrict__ s,
                         const float* __restrict__ brw,
                         const float* __restrict__ bru, int box_mode,
                         const float* __restrict__ box, SplineRefs sp,
                         float rng, float* __restrict__ prow,
                         float* __restrict__ pcol, int* __restrict__ keep) {
  {
    const size_t b = blockIdx.z, S = tile / SUB;
    REPLICA_LIST(nv, tl, lmax, 0);
    pos += b * 3 * np;
    posh += b * 3 * nhp;
    if (!RECOMPUTE) {
      q += b * lmax * tile * tile;
      dq += b * lmax * tile * tile;
      if (keep_in != nullptr) keep_in += b * lmax * S * ng;
    }
    s += b * nhp;
    brw += b * np;
    bru += b * np;
    prow += b * lmax * ng * DS_ROW_K * tile;
    pcol += b * lmax * S * DS_COL_K * tile;
    keep += b * lmax * S * ng;
  }
  extern __shared__ float sh[];
  float* tab = sh;  // RECOMPUTE: y [ntab], y2 [ntab]
  float* rx = sh + (RECOMPUTE ? 2 * sp.ntab : 0);  // rows x, y, z, BrW, BrU
  float* ry = rx + SUB;
  float* rz = ry + SUB;
  float* rbw = rz + SUB;
  float* rbu = rbw + SUB;
  int* rtype = (int*)(rbu + SUB);
  const int S = tile / SUB, G = S / ng;
  const int l = blockIdx.x / (S * ng);
  const int a = (blockIdx.x / ng) % S, grp = blockIdx.x % ng;
  const int lane = threadIdx.x;
  if (l >= nv[0]) return;
  const int ti = tl[l], tj = tl[lmax + l];
  const int r0 = ti * tile + a * SUB;
  if (RECOMPUTE) stage_tables(tab, sp.yval, sp.y2val, sp.ntab);
  const int ih = r0 + lane;
  const float xh = pos[ih], yh = pos[np + ih], zh = pos[2 * np + ih];
  rx[lane] = xh;
  ry[lane] = yh;
  rz[lane] = zh;
  rbw[lane] = brw[ih];
  rbu[lane] = bru[ih];
  if (RECOMPUTE) rtype[lane] = sp.trow[ih];
  const bool given = !RECOMPUTE && keep_in != nullptr;  // warp-uniform
  const unsigned want = given ? keep_in[(l * S + a) * ng + grp] : 0u;
  SubBox rbox{};
  if (!given) rbox = warp_box(xh, yh, zh, ih < sp.n);
  __syncthreads();
  const int g = lane >> 3, c4 = lane & 7;
  float fr[8][DS_ROW_K];  // rows g + 4k, over this lane's columns
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < DS_ROW_K; ++m) fr[k][m] = 0.0f;
  unsigned kept = 0;
  const size_t qbase = (size_t)l * tile * tile;
  for (int b = grp * G; b < (grp + 1) * G; ++b) {
    const int j0 = tj * tile + b * SUB;
    if (given) {
      if (!((want >> b) & 1u)) continue;
    } else {
      const int jh = j0 + lane;
      const bool jvalid = sp.hids == nullptr || sp.hids[jh] >= 0;
      if (!subtiles_near(rbox, warp_box(posh[jh], posh[nhp + jh],
                                        posh[2 * nhp + jh], jvalid),
                         rng, box_mode, box))
        continue;
    }
    kept |= 1u << b;
    const int jq = j0 + 4 * c4;
    const float4 cx = *(const float4*)(posh + jq);
    const float4 cy = *(const float4*)(posh + nhp + jq);
    const float4 cz = *(const float4*)(posh + 2 * nhp + jq);
    const float4 cs = *(const float4*)(s + jq);
    int4 cg = make_int4(0, 0, 0, 0), ct = make_int4(0, 0, 0, 0);
    if (RECOMPUTE) {
      cg = *(const int4*)(sp.hids + jq);
      ct = *(const int4*)(sp.tcol + jq);
    }
    float cw[4], cu[4], cfx[4], cfy[4], cfz[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) cw[c] = cu[c] = cfx[c] = cfy[c] = cfz[c] = 0.0f;
    // Q/dQ of row r, columns jq..jq+3 of this entry
    const size_t qoff = qbase + (size_t)(a * SUB + g) * tile + b * SUB
                        + 4 * c4;
#pragma unroll
    for (int k0 = 0; k0 < 8; k0 += DS_ROWS_IN_FLIGHT) {
      float4 q4[DS_ROWS_IN_FLIGHT], dq4[DS_ROWS_IN_FLIGHT];
      if (!RECOMPUTE) {
#pragma unroll
        for (int kk = 0; kk < DS_ROWS_IN_FLIGHT; ++kk) {
          const size_t o = qoff + (size_t)(4 * (k0 + kk)) * tile;
          q4[kk] = *(const float4*)(q + o);
          dq4[kk] = *(const float4*)(dq + o);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DS_ROWS_IN_FLIGHT; ++kk) {
        const int k = k0 + kk;
        const int r = g + 4 * k;
        const int i = r0 + r;
        const float xi = rx[r], yi = ry[r], zi = rz[r];
        const float bw = rbw[r], bu = rbu[r];
        const int tbase = RECOMPUTE ? rtype[r] * sp.ntj : 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float dx = lane4(cx, c) - xi, dy = lane4(cy, c) - yi,
                dz = lane4(cz, c) - zi;
          min_image(box_mode, box, dx, dy, dz);
          const float d = sqrtf(dx * dx + dy * dy + dz * dz);
          float qv = 0.0f, dqv = 0.0f, inv_d = 0.0f;
          if (RECOMPUTE) {
            if (born_pair_live(i, lane4(cg, c), sp.n, d, sp.horizon)) {
              spline_qdq(tab, sp.ntab, tbase + lane4(ct, c), d, qv, dqv);
              inv_d = __fdividef(1.0f, d);
            }
          } else {
            qv = lane4(q4[kk], c);
            dqv = lane4(dq4[kk], c);
            inv_d = d > 0.0f ? __fdividef(1.0f, d) : 0.0f;
          }
          cw[c] += bw * qv;
          cu[c] += bu * qv;
          const float cc = (bw + bu) * lane4(cs, c) * dqv * inv_d;
          const float fx = cc * dx, fy = cc * dy, fz = cc * dz;
          cfx[c] -= fx;
          cfy[c] -= fy;
          cfz[c] -= fz;
          fr[k][0] += fx;
          fr[k][1] += fy;
          fr[k][2] += fz;
        }
      }
    }
    // column sums: add the 4 row groups (lanes c4, c4 + 8, c4 + 16,
    // c4 + 24) in a fixed tree; lanes 0-7 write them
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int o = 8; o <= 16; o <<= 1) {
        cw[c] += __shfl_xor_sync(FULL_MASK, cw[c], o);
        cu[c] += __shfl_xor_sync(FULL_MASK, cu[c], o);
        cfx[c] += __shfl_xor_sync(FULL_MASK, cfx[c], o);
        cfy[c] += __shfl_xor_sync(FULL_MASK, cfy[c], o);
        cfz[c] += __shfl_xor_sync(FULL_MASK, cfz[c], o);
      }
    }
    if (g == 0) {
      float* pc = pcol + ((size_t)l * S + a) * DS_COL_K * tile + b * SUB
                  + 4 * c4;
      *(float4*)pc = make_float4(cw[0], cw[1], cw[2], cw[3]);
      *(float4*)(pc + tile) = make_float4(cu[0], cu[1], cu[2], cu[3]);
      *(float4*)(pc + 2 * (size_t)tile) =
          make_float4(cfx[0], cfx[1], cfx[2], cfx[3]);
      *(float4*)(pc + 3 * (size_t)tile) =
          make_float4(cfy[0], cfy[1], cfy[2], cfy[3]);
      *(float4*)(pc + 4 * (size_t)tile) =
          make_float4(cfz[0], cfz[1], cfz[2], cfz[3]);
    }
  }
  // row forces: add the 8 column quads (lanes 8g .. 8g + 7) in a fixed
  // tree; lane c4 == k writes row g + 4k
  if (kept != 0) {
    float* pr = prow + ((size_t)l * ng + grp) * DS_ROW_K * tile + a * SUB;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int m = 0; m < DS_ROW_K; ++m) {
        float v = fr[k][m];
        v += __shfl_xor_sync(FULL_MASK, v, 1);
        v += __shfl_xor_sync(FULL_MASK, v, 2);
        v += __shfl_xor_sync(FULL_MASK, v, 4);
        if (c4 == k) pr[(size_t)m * tile + g + 4 * k] = v;
      }
    }
  }
  if (lane == 0) keep[(l * S + a) * ng + grp] = (int)kept;
}

template <bool RECOMPUTE>
static int launch_descreen_subtiles(int nb, const int* nv, const int* tl,
                                    int lmax,
                                    int tile, int ng, const float* pos,
                                    int np,
                                    const float* posh, int nhp,
                                    const float* q, const float* dq,
                                    const int* keep_in,
                                    const float* s, const float* brw,
                                    const float* bru, int box_mode,
                                    const float* box, const SplineRefs& sp,
                                    float rng, float* prow, float* pcol,
                                    int* keep, cudaStream_t st) {
  const size_t smem = ((RECOMPUTE ? 2 * (size_t)sp.ntab : 0) + 5 * SUB)
                          * sizeof(float) + SUB * sizeof(int);
  allow_smem((const void*)descreen_subtiles_kernel<RECOMPUTE>, smem);
  descreen_subtiles_kernel<RECOMPUTE>
      <<<dim3(lmax * (tile / SUB) * ng, 1, nb), SUB, smem, st>>>(
          nv, tl, lmax, tile, ng, pos, np, posh, nhp, q, dq, keep_in, s, brw,
          bru, box_mode, box, sp, rng, prow, pcol, keep);
  return (int)cudaGetLastError();
}

// nb replicas, each with its own list (nv [B], tl [B, 2, lmax]) and every
// other array but the spline's with a leading [B] axis.  q == nullptr
// selects the recomputing variant, which reads hids, trow, tcol, the
// tables, n and horizon.  The reloading variant takes the Born sweep's keep
// bits keep_in [B, lmax, T/32, groups] (from agbnp_born_sums_tiles on the
// same lists) or, with keep_in null, forms the sub-tile boxes from n (rows
// i >= n are padding) and hids (null: every column is real).  rng is the
// range the lists were built with.  groups: ng, as for the GB sweep; prow
// [B, lmax, ng, 3, T], pcol [B, lmax, T/32, 5, T] and keep [B, lmax, T/32,
// ng] are scratch.
extern "C" int agbnp_descreening_tiles(
    int nb, const int* nv, const int* tl, int lmax, int tile, int groups,
    const float* pos, int np, const float* posh, int nhp, const float* q,
    const float* dq, const int* keep_in, const float* s, const float* brw,
    const float* bru, int box_mode, const float* box, const int* hids, const int* trow, const int* tcol,
    const float* yval, const float* y2val, int nti, int ntj, int n,
    float horizon, float rng, float* prow, float* pcol, int* keep,
    float* w_out, float* u_out, float* f_rows, float* f_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const SplineRefs sp{hids, trow, tcol, yval, y2val, nti * ntj * AGBNP_NA, ntj,
                      n, horizon};
  int err = q == nullptr
      ? launch_descreen_subtiles<true>(nb, nv, tl, lmax, tile, groups, pos, np,
                                       posh, nhp, q, dq, nullptr, s, brw, bru,
                                       box_mode, box, sp, rng, prow, pcol,
                                       keep, st)
      : launch_descreen_subtiles<false>(nb, nv, tl, lmax, tile, groups, pos,
                                        np,
                                        posh, nhp, q, dq, keep_in, s, brw,
                                        bru, box_mode, box, sp, rng, prow,
                                        pcol, keep, st);
  if (err != 0) return err;
  Dest rows{};
  for (int m = 0; m < DS_ROW_K; ++m) {
    rows.p[m] = f_rows + m;
    rows.stride[m] = 3;
    rows.rstride[m] = 3 * (size_t)np;
  }
  Dest cols{};
  float* couts[DS_COL_K] = {w_out, u_out, f_cols, f_cols + 1, f_cols + 2};
  const int cstrides[DS_COL_K] = {1, 1, 3, 3, 3};
  for (int m = 0; m < DS_COL_K; ++m) {
    cols.p[m] = couts[m];
    cols.stride[m] = cstrides[m];
    cols.rstride[m] = (size_t)cstrides[m] * nhp;
  }
  const int row_tiles = np / tile, col_tiles = nhp / tile;
  return reduce_subtiles(
      reduce_job(prow, nullptr, DS_ROW_K, np, row_tiles, col_tiles, groups,
                 tile, rows),
      reduce_job(nullptr, pcol, DS_COL_K, nhp, row_tiles, col_tiles, groups,
                 tile, cols),
      keep, groups, nv, tl, lmax, tile, nb, 0, st);
}
