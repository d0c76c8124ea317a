// Row moves of the overlap tree's passes, as CUDA kernels for sm_90a with a
// plain C interface (built by runtime/build.py, bound with ctypes in
// ops/kernels/rows.py).
//
// They replace the two Pallas probes of the JAX package's
// benchmarks/micro_pallas_gather.py:
//
//   take_kernel (pallas_call at :99)   out[r] = table[ids[r]]: the tree's
//       parent -> child broadcast (ops/tree.py::_parent_gather).  The TPU
//       kernel holds the whole table in VMEM for each 2,048-row block.
//   cum_kernel (pallas_call at :145)   inclusive prefix sum down the rows of
//       a [R, C] matrix: with boundary diffs at the segment starts it is the
//       gather-free form of the same broadcast.  The TPU kernel leans on its
//       grid running the 2,048-row blocks in order, with the last row
//       carried in a VMEM scratch.
//
// Both are bound by bytes: at the probe's shape (85,504 rows from 34,816
// parents, 8 f32 columns) the gather moves 4.2 MB and the prefix sum 5.5 MB,
// ~1.3 and ~1.6 us at HBM's rate, and both arrays fit the 50 MB L2.
//
// take_rows: no staging.  The table of a tree level (19 MB at 2clr's widest
// level of 26 columns, 1.1 MB at the probe's shape) lives in L2, so a
// thread moves one piece of one output row: it reads its row's id, loads
// the piece through the read-only path and stores it.  The piece is the
// widest of 16, 8 and 4 bytes that divides the row and that the three
// arrays are aligned to: the tree's tables are 1, 6, 12, 13 and 26 columns
// wide, so rows of 12 columns move as float4, of 6 and 26 as float2, of 1
// and 13 as single words.  The thread's index is the flat index of its
// piece in the output, so a warp writes 128 to 512 contiguous bytes and
// reads from at most a few source rows; ids need not be sorted, and an id
// outside [0, P) gives a zero row.
//
// cumsum_rows: CUDA blocks run in no order, so the carry of the TPU kernel
// becomes two passes whose float association is fixed by the shapes alone
// (no atomics, no look-back that depends on timing: two launches give the
// same bits).  A block owns a tile of nseg x 33 rows, staged in shared
// memory with coalesced loads; thread (segment, column) walks its 33 rows
// of one column in order.  33 rows a segment make the 32 lanes of a warp
// hit 32 different banks for every C.
//   pass 1: segment totals -> the tile's column totals, bsum[tile, C];
//   pass 2: each tile adds up bsum of the tiles before it, left to right
//           (so every tile forms the same chain of partial sums), then the
//           totals of the segments before each segment, then the running
//           sum down the segment, and stores the tile coalesced.
// The matrix is read twice (the second time from L2) and written once.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_THREADS 256
#define SEG_ROWS 33

__device__ __forceinline__ void zero_piece(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero_piece(float2& v) {
  v = make_float2(0.0f, 0.0f);
}
__device__ __forceinline__ void zero_piece(float4& v) {
  v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// V: the piece a thread moves (float, float2 or float4); cv: pieces a row.
template <typename V>
__global__ void take_rows_kernel(const V* __restrict__ table,
                                 const int* __restrict__ ids, unsigned npieces,
                                 int nparents, unsigned cv,
                                 V* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= npieces) return;
  const unsigned r = t / cv;
  const unsigned piece = t - r * cv;
  const int id = __ldg(ids + r);
  V v;
  zero_piece(v);
  if (id >= 0 && id < nparents) v = __ldg(table + (unsigned)id * cv + piece);
  out[t] = v;
}

// Piece indices are 32-bit: a table or an output of 2^31 pieces or more is
// refused.
template <typename V>
static int launch_take_rows(const float* table, int nparents, int cv,
                            const int* ids, int nrows, float* out,
                            cudaStream_t stream) {
  const long long npieces = (long long)nrows * cv;
  const long long reach = (long long)(nparents > nrows ? nparents : nrows) * cv;
  if (reach >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((npieces + ROWS_THREADS - 1) / ROWS_THREADS);
  take_rows_kernel<V><<<blocks, ROWS_THREADS, 0, stream>>>(
      (const V*)table, ids, (unsigned)npieces, nparents, (unsigned)cv,
      (V*)out);
  return (int)cudaGetLastError();
}

// The bytes of the pieces that rows of ncols floats move in: the widest of
// 16, 8 and 4 that divides a row and that both arrays are aligned to.
static int take_rows_piece_bytes(int ncols, const float* table,
                                 const float* out) {
  const uintptr_t where = (uintptr_t)table | (uintptr_t)out;
  if (ncols % 4 == 0 && where % 16 == 0) return 16;
  if (ncols % 2 == 0 && where % 8 == 0) return 8;
  return 4;
}

// One tile of nseg * SEG_ROWS rows.  WRITE false: pass 1 (bsum out).  WRITE
// true: pass 2 (bsum in, out written).
template <bool WRITE>
__global__ void cumsum_tile_kernel(const float* __restrict__ d, int nrows,
                                   int ncols, int nseg,
                                   float* __restrict__ bsum,
                                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tile = smem;                                  // [nseg * 33, C]
  float* segtot = smem + nseg * SEG_ROWS * ncols;      // [nseg, C]
  float* before = segtot + nseg * ncols;               // [C]
  const int tid = threadIdx.x;
  const int tile_rows = nseg * SEG_ROWS;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int rows_here = (int)min((long long)tile_rows, nrows - r0);
  const int nel = rows_here * ncols;
  const float* src = d + r0 * ncols;
  for (int e = tid; e < nel; e += ROWS_THREADS) tile[e] = src[e];
  if (WRITE && tid < ncols) {
    // the column totals of every tile before this one, in tile order
    float run = 0.0f;
    for (int b = 0; b < (int)blockIdx.x; ++b) run += bsum[b * ncols + tid];
    before[tid] = run;
  }
  __syncthreads();

  const bool worker = tid < nseg * ncols;
  const int seg = tid / ncols, c = tid - seg * ncols;
  const int row_lo = seg * SEG_ROWS;
  const int row_hi = min(row_lo + SEG_ROWS, rows_here);
  if (worker) {
    float run = 0.0f;
    for (int r = row_lo; r < row_hi; ++r) {
      run += tile[r * ncols + c];
      if (WRITE) tile[r * ncols + c] = run;
    }
    segtot[tid] = run;
  }
  __syncthreads();

  if (!WRITE) {
    if (tid < ncols) {
      float tot = 0.0f;
      for (int s = 0; s < nseg; ++s) tot += segtot[s * ncols + tid];
      bsum[blockIdx.x * ncols + tid] = tot;
    }
    return;
  }
  if (worker) {
    float pre = before[c];
    for (int s = 0; s < seg; ++s) pre += segtot[s * ncols + c];
    for (int r = row_lo; r < row_hi; ++r) tile[r * ncols + c] += pre;
  }
  __syncthreads();
  float* dst = out + r0 * ncols;
  for (int e = tid; e < nel; e += ROWS_THREADS) dst[e] = tile[e];
}

static size_t cumsum_smem_bytes(int ncols, int nseg) {
  return (size_t)(nseg * SEG_ROWS * ncols + nseg * ncols + ncols)
         * sizeof(float);
}

extern "C" {

// out[r, :] = table[ids[r], :] (zero where ids[r] is outside [0, nparents));
// any ncols >= 1, the three arrays 4-byte aligned.
int agbnp_take_rows(const float* table, int nparents, int ncols,
                    const int* ids, int nrows, float* out,
                    cudaStream_t stream) {
  if (ncols <= 0) return (int)cudaErrorInvalidValue;
  if (nrows <= 0) return (int)cudaSuccess;
  switch (take_rows_piece_bytes(ncols, table, out)) {
    case 16:
      return launch_take_rows<float4>(table, nparents, ncols / 4, ids, nrows,
                                      out, stream);
    case 8:
      return launch_take_rows<float2>(table, nparents, ncols / 2, ids, nrows,
                                      out, stream);
    default:
      return launch_take_rows<float>(table, nparents, ncols, ids, nrows, out,
                                     stream);
  }
}

// Rows of one tile: floor(256 / ncols) segments of 33 rows (1 <= ncols <=
// 256).
int agbnp_cumsum_tile_rows(int ncols) {
  return (ROWS_THREADS / ncols) * SEG_ROWS;
}

// out[r, c] = sum of d[0..r, c].  bsum: scratch of ceil(nrows / tile rows)
// x ncols floats.
int agbnp_cumsum_rows(const float* d, int nrows, int ncols, float* bsum,
                      float* out, cudaStream_t stream) {
  if (nrows <= 0) return (int)cudaSuccess;
  const int nseg = ROWS_THREADS / ncols;
  const int tile_rows = nseg * SEG_ROWS;
  const unsigned blocks = (unsigned)((nrows + tile_rows - 1) / tile_rows);
  const size_t smem = cumsum_smem_bytes(ncols, nseg);
  cumsum_tile_kernel<false><<<blocks, ROWS_THREADS, smem, stream>>>(
      d, nrows, ncols, nseg, bsum, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cumsum_tile_kernel<true><<<blocks, ROWS_THREADS, smem, stream>>>(
      d, nrows, ncols, nseg, bsum, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
