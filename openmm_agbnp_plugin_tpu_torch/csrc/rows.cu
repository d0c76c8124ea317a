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
// cumsum_rows: one launch.  CUDA blocks run in no order, so the carry of the
// TPU kernel becomes a look-back whose float association the shapes alone
// fix (no float atomics, no look-back depth that depends on timing: every
// launch gives the same bits).  A tile is P = floor(256 / C) parts of 32
// rows (32 P rows, at most 8,192 values: 84 tiles at the probe's shape).
//   * A block takes its tile's index from an integer ticket (atomicAdd on an
//     int), so tiles start in order and a block only ever waits on tiles
//     that are already running.
//   * The tile is staged with 16-byte loads (a tile of rows is contiguous)
//     into shared memory, each part padded to a stride of 32C + pad with
//     stride = C (mod 32), so thread (part p, column c) walks its 32 rows
//     with no bank conflict; the part totals take a Hillis-Steele scan over
//     the parts in shared memory.
//   * The tile publishes its column totals behind a flag, then adds the
//     totals of the tiles before it with warp-parallel trees (lane j adds
//     every 32nd value from j, then an xor butterfly) whose shape depends on
//     the tile's index alone: over every tile before it while ntiles * C <=
//     4,096, else over the group totals of the complete groups of 32 tiles
//     before its group plus the totals of its own group's tiles before it.
//     The tile that closes a group publishes the group's total behind a
//     second flag, from its group's tile totals alone and before it waits
//     on any group total: no chain of waits runs from group to group.
//   * One warp a block polls, each flag on a 128-byte line of its own:
//     flags that share a line queue the polls of every waiting block on it,
//     and the look-back then takes most of a tile's time.  Flags are
//     written with release and read with acquire at GPU scope.
//   * The flags and the ticket belong to one stream (the wrapper keeps a
//     zeroed buffer a stream), and the last tile to finish zeroes them
//     again, so no call needs a host sync or a clearing launch.
// The matrix is read once and written once.  rows.py::cumsum_rows_mirror
// states the same order in plain torch.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_THREADS 256
#define SCAN_THREADS 256
#define PART_ROWS 32
#define GROUP_TILES 32
#define FLAT_VALUES 4096
#define FLAG_STRIDE 32

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

// The tile's layout: P parts of PART_ROWS rows, P = SCAN_THREADS / C.
__host__ __device__ __forceinline__ int scan_parts(int ncols) {
  return SCAN_THREADS / ncols;
}

// Padding after each part in shared memory: the part stride
// PART_ROWS * C + pad is C modulo 32, so thread t = p * C + c reads bank
// (t + i * C) mod 32.
__host__ __device__ __forceinline__ int scan_pad(int ncols) {
  return (32 - ((PART_ROWS - 1) * ncols) % 32) % 32;
}

// The state's ints: the ticket and the done count, then one flag a tile
// and one a group, each on a 128-byte line of its own (flags that share a
// line make the polls of every waiting block queue on it).
__host__ __device__ __forceinline__ int flag_slot(int k) {
  return FLAG_STRIDE * (2 + k);
}

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The flags publish with release and are read with acquire at GPU scope.
// __threadfence() is a sequentially consistent fence, which every block of
// a look-back would pay several times over; acquire/release order only
// what the look-back needs.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One lane's share of a wait: flags k = first, first + 32, ... < end set,
// then an acquire of what their setters wrote.  A tile waits only on tiles
// with smaller tickets, which are running, so a wait lasts microseconds; one
// that outlasts ~2^24 polls (about a second) is a fault, and the kernel
// traps (an error the next synchronisation reports) instead of holding the
// card.
__device__ __forceinline__ void wait_flags(const int* state, int first,
                                           int end) {
  for (unsigned polls = 0;; ++polls) {
    bool all = true;
    for (int k = first; k < end; k += 32)
      all &= ld_relaxed(state + flag_slot(k)) != 0;
    if (all) break;
    if (polls > (1u << 24)) __trap();
    __nanosleep(64);
  }
  fence_acq_rel();
}

// scratch: tile totals [ntiles, C] then group totals [ngroups, C].  VEC: d
// and out 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
    cumsum_lookback_kernel(const float* __restrict__ d, int nrows, int ncols,
                           int ntiles, int* state, float* scratch,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tile;
  const int C = ncols;
  const int P = scan_parts(C);
  const int pad = scan_pad(C);
  const int span = PART_ROWS * C;     // values of one part
  const int stride = span + pad;      // its stride in shared memory
  const int tile_rows = PART_ROWS * P;
  float* tile = smem;                 // [P * stride]
  float* parts = tile + P * stride;   // two buffers of [P * C]
  float* carry = parts + 2 * P * C;   // [C]
  const int ngroups = (ntiles + GROUP_TILES - 1) / GROUP_TILES;
  float* agg = scratch;
  float* gsum = scratch + (size_t)ntiles * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) s_tile = atomicAdd(state, 1);
  __syncthreads();
  const int b = s_tile;
  const long long r0 = (long long)b * tile_rows;
  const int rows_here = (int)min((long long)tile_rows, (long long)nrows - r0);
  const int nel = rows_here * C;
  const float* src = d + r0 * C;

  // stage the tile, rows past the end as zeros
  int e0 = 0;
  if (VEC) {
    const int nq = nel >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = tid; q < nq; q += SCAN_THREADS) {
      const float4 v = __ldcs(src4 + q);
      const int e = q << 2;  // a part holds 32C values: e..e+3 stay in it
      float* dst = tile + e + (e / span) * pad;
      if ((pad & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    }
    e0 = nq << 2;
  }
  for (int e = e0 + tid; e < nel; e += SCAN_THREADS)
    tile[e + (e / span) * pad] = __ldcs(src + e);
  for (int e = nel + tid; e < tile_rows * C; e += SCAN_THREADS)
    tile[e + (e / span) * pad] = 0.0f;
  __syncthreads();

  // each thread: a running sum down its part's rows of one column
  const bool worker = tid < P * C;
  const int p = tid / C, c = tid - p * C;
  float run[PART_ROWS];
  if (worker) {
    const float* my = tile + p * stride + c;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < PART_ROWS; ++i) {
      acc += my[i * C];
      run[i] = acc;
    }
    parts[tid] = acc;
  }
  __syncthreads();
  // inclusive scan of the part totals over the parts (Hillis-Steele)
  int cur = 0;
  for (int o = 1; o < P; o <<= 1) {
    if (worker) {
      float v = parts[cur * P * C + tid];
      if (p >= o) v += parts[cur * P * C + tid - o * C];
      parts[(cur ^ 1) * P * C + tid] = v;
    }
    cur ^= 1;
    __syncthreads();
  }
  const float* incl = parts + cur * P * C;

  // publish the tile's column totals: warp 0 writes them and raises the
  // flag behind a release fence
  if (warp == 0) {
    for (int col = lane; col < C; col += 32)
      __stcg(agg + (size_t)b * C + col, incl[(P - 1) * C + col]);
    fence_acq_rel();
    __syncwarp();
    if (lane == 0) st_relaxed(state + flag_slot(b), 1);
  }

  // the carry: the column totals of the tiles before this one.  Warp 0
  // polls every flag the tile reads (the other warps read the data after
  // the barrier behind its acquire).  Few tiles (ntiles * C <=
  // FLAT_VALUES): one warp tree a column over them all.  Else carry =
  // (group totals before this tile's group) + (tile totals of its group
  // before it), the in-group part first: a tile that closes its group
  // publishes the group's total from its group's tile totals alone, before
  // it waits on any group total, so no chain of waits runs from group to
  // group.
  if (ntiles * C <= FLAT_VALUES) {
    if (warp == 0) wait_flags(state, lane, b);
    __syncthreads();
    for (int col = warp; col < C; col += SCAN_THREADS / 32) {
      float a = 0.0f;
      for (int k = lane; k < b; k += 32)
        a += __ldcg(agg + (size_t)k * C + col);
      a = warp_tree(a);
      if (lane == 0) carry[col] = a;
    }
  } else {
    const int g = b / GROUP_TILES, j0 = b - g * GROUP_TILES;
    const bool closes = j0 == GROUP_TILES - 1;
    if (warp == 0)
      wait_flags(state, g * GROUP_TILES + lane, g * GROUP_TILES + j0);
    __syncthreads();
    for (int col = warp; col < C; col += SCAN_THREADS / 32) {
      float in_group = 0.0f;
      float mine = 0.0f;
      if (lane < j0) {
        mine = __ldcg(agg + (size_t)(g * GROUP_TILES + lane) * C + col);
        in_group += mine;
      }
      in_group = warp_tree(in_group);
      if (lane == 0) carry[col] = in_group;
      if (closes) {
        float tot = 0.0f;
        tot += lane == GROUP_TILES - 1 ? incl[(P - 1) * C + col] : mine;
        tot = warp_tree(tot);
        if (lane == 0) {
          __stcg(gsum + (size_t)g * C + col, tot);
          fence_acq_rel();
        }
      }
    }
    __syncthreads();
    if (tid == 0 && closes) {
      fence_acq_rel();
      st_relaxed(state + flag_slot(ntiles + g), 1);
    }
    if (warp == 0) wait_flags(state, ntiles + lane, ntiles + g);
    __syncthreads();
    for (int col = warp; col < C; col += SCAN_THREADS / 32) {
      float a = 0.0f;
      for (int k = lane; k < g; k += 32)
        a += __ldcg(gsum + (size_t)k * C + col);
      a = warp_tree(a);
      if (lane == 0) carry[col] = a + carry[col];
    }
  }
  __syncthreads();

  // out = running sum + (the parts before + the tiles before)
  if (worker) {
    const float base = (p > 0 ? incl[(p - 1) * C + c] : 0.0f) + carry[c];
    float* my = tile + p * stride + c;
#pragma unroll
    for (int i = 0; i < PART_ROWS; ++i) my[i * C] = run[i] + base;
  }
  __syncthreads();
  float* dst = out + r0 * C;
  e0 = 0;
  if (VEC) {
    const int nq = nel >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int q = tid; q < nq; q += SCAN_THREADS) {
      const int e = q << 2;
      const float* s4 = tile + e + (e / span) * pad;
      float4 v;
      if ((pad & 3) == 0) {
        v = *reinterpret_cast<const float4*>(s4);
      } else {
        v = make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
      __stcs(dst4 + q, v);
    }
    e0 = nq << 2;
  }
  for (int e = e0 + tid; e < nel; e += SCAN_THREADS)
    __stcs(dst + e, tile[e + (e / span) * pad]);

  // every read of this tile's look-back is done: count the tile, and the
  // last one clears the flags for the next call on this stream (its
  // acquire sees every other tile's flags, so no flag lands after it).
  // Built with -DCUMSUM_NO_RESET (profile_port_step.py --row-probes times
  // it) the kernel leaves its state set, and each call needs a zeroed one:
  // the design the reset replaces.
#ifndef CUMSUM_NO_RESET
  __shared__ int s_last;
  if (tid == 0) {
    fence_acq_rel();
    s_last = atomicAdd(state + FLAG_STRIDE, 1) == ntiles - 1;
    if (s_last) fence_acq_rel();
  }
  __syncthreads();
  if (s_last) {
    for (int k = tid; k < ntiles + ngroups; k += SCAN_THREADS)
      state[flag_slot(k)] = 0;
    if (tid == 0) {
      state[0] = 0;
      state[FLAG_STRIDE] = 0;
    }
  }
#endif
}

static size_t cumsum_smem_bytes(int ncols) {
  const int P = scan_parts(ncols);
  return (size_t)(P * (PART_ROWS * ncols + scan_pad(ncols)) + 2 * P * ncols +
                  ncols) *
         sizeof(float);
}

static int cumsum_tiles(int nrows, int ncols) {
  const int tile_rows = PART_ROWS * scan_parts(ncols);
  return (nrows + tile_rows - 1) / tile_rows;
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

// Rows of one tile: 32 floor(256 / ncols) (1 <= ncols <= 256).
int agbnp_cumsum_tile_rows(int ncols) {
  return PART_ROWS * scan_parts(ncols);
}

// Ints of the state cumsum_rows needs for nrows x ncols: the ticket and the
// done count, then a flag a tile and a group, each on a line of its own.
int agbnp_cumsum_state_ints(int nrows, int ncols) {
  const int ntiles = cumsum_tiles(nrows, ncols);
  return flag_slot(ntiles + (ntiles + GROUP_TILES - 1) / GROUP_TILES);
}

// out[r, c] = sum of d[0..r, c], in one launch (1 <= ncols <= 256).  state:
// agbnp_cumsum_state_ints ints, zero (the kernel leaves them zero again),
// kept by one stream; scratch: (ntiles + ngroups) * ncols floats, where
// ntiles = ceil(nrows / tile rows) and ngroups = ceil(ntiles / 32).
int agbnp_cumsum_rows(const float* d, int nrows, int ncols, int* state,
                      float* scratch, float* out, cudaStream_t stream) {
  if (ncols < 1 || ncols > SCAN_THREADS || nrows < 0)
    return (int)cudaErrorInvalidValue;
  if (nrows == 0) return (int)cudaSuccess;
  const int ntiles = cumsum_tiles(nrows, ncols);
  const size_t smem = cumsum_smem_bytes(ncols);
  const bool vec = ((uintptr_t)d | (uintptr_t)out) % 16 == 0;
  if (vec) {
    cumsum_lookback_kernel<true><<<ntiles, SCAN_THREADS, smem, stream>>>(
        d, nrows, ncols, ntiles, state, scratch, out);
  } else {
    cumsum_lookback_kernel<false><<<ntiles, SCAN_THREADS, smem, stream>>>(
        d, nrows, ncols, ntiles, state, scratch, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
