// The overlap tree's fixed-topology passes as CUDA kernels for sm_90a, one
// launch a level, with a plain C interface (built by runtime/build.py, bound
// with ctypes in ops/kernels/tree.py):
//
//   agbnp_tree_rescan    one level of the downward volume rescan
//                        (ops/tree.py::rescan_volumes / rescan_volumes2)
//   agbnp_tree_reduce    one level of the upward reduction (reduce_tree /
//                        reduce_tree2): each parent's children, their
//                        deposit rows and the parent's accumulator
//   agbnp_tree_deposit   the deposits summed onto their atoms, with the
//                        level-1 terms (dr, e_psi, self volume)
//
// They replace no TPU kernel.  The JAX package's tree passes are plain jnp
// (openmm_agbnp_plugin_tpu/ops/tree.py), which XLA fuses into a few
// programs; in the port the same passes ran as about 150 small torch
// launches a level, some 2,300 a MD step, and on an H100 the host's
// launches of the tree passes left the device idle for 63-69% of every
// step of the MD benchmark cells (27-31 ms of a 41-44 ms step).  Between
// two rebuilds the topology does not change, so each level is one launch
// in each direction, and a pass is 15 launches: 7 down, 7 up, 1 deposit.
//
// What bounds them: bytes.  A level row is 13 values a parameterization;
// 1li2's ~100k tree rows, read and written a few times, are tens of MB in
// all, microseconds at 3.35 TB/s, and they sit in the 50 MB L2.  The
// launches themselves (~2 us each) are the floor.
//
// Design:
//   * Down.  One thread a row: it reads the parent's packed row (the level-1
//     table [N, 6] at the first stored level, the previous level's output
//     [P, 13] after) and its atom's level-1 row by the int32 ids the
//     topology carries, forms the two-Gaussian product of ops/tree.py::
//     _cand_dat for K = 1 or 2 parameterizations (the large and vdW radii
//     in one launch), and writes the packed [cap, 13] rows; invalid rows are
//     zero, as rescan_volumes makes them.  An id outside its table reads a
//     zero row, as take_rows gives it.
//   * Up.  One thread a parent row of the level above (an atom at the first
//     stored level): it walks its children over [starts[p], starts[p + 1]),
//     a contiguous run of the parent-sorted level, forms each child's
//     channel row (the 5-channel energy family a parameterization, then
//     the self-volume psi channel where asked, plus the child's
//     accumulator from the level below), writes the child's deposit row and
//     adds its upward row into the parent's sum in row order.  No float
//     atomics: every sum is taken in one fixed order, run after run.
//   * Deposits.  One thread an atom: it walks the topology's list of the
//     deposit rows that land on it (deepest level first, row order within,
//     the order of the torch twin's stable argsort), adds them from zero and
//     adds the level-1 terms.
// T is float or double; K parameterizations; SV: the self-volume channel of
// the last parameterization.

#include <cuda_runtime.h>
#include <stdint.h>

#define TREE_THREADS 128
#define TREE_D 13  // packed level row (ops/tree.py _D)
#define AT_D 6     // packed level-1 row: gv, ga, gc, gamma
#define MAX_K 2

// models/constants.py: PI; the switching window [VOLMINA, VOLMINB]
#define TREE_PI 3.141592653589793
#define TREE_VOLMINA (0.01 * 0.001)
#define TREE_VOLMINB (0.1 * 0.001)

template <typename T>
struct RescanArgs {
  const T* par[MAX_K];  // parent tables, pstride values a row
  const T* at[MAX_K];   // level-1 tables [natoms, AT_D]
  T* out[MAX_K];        // [nrows, TREE_D]
  const int* pid;       // parent ids [nrows]
  const int* aid;       // atom ids [nrows]
  const uint8_t* valid; // [nrows]
  int nrows, nparents, natoms, pstride, pgam;
};

template <typename T>
struct ReduceArgs {
  const T* dat[MAX_K];  // the level's packed rows [nrows, TREE_D]
  const T* gam[MAX_K];  // the level's gammas, gstride[k] apart
  int gstride[MAX_K];
  const int* starts;    // [nparents + 1]: children of p are rows
                        // starts[p] .. starts[p + 1] - 1
  const T* acc_in;      // children's accumulators [nrows, C] or null
  T* acc_out;           // [nparents, C]
  T* dep;               // the level's deposit rows [nrows, DC]
  int nparents;
  T volcoeffp;
};

template <typename T>
struct DepositArgs {
  const int* order;     // deposit rows by atom
  const int* dstarts;   // [natoms + 1]
  const T* dep;         // every level's deposit rows, deepest level first
  const T* acc;         // the atoms' accumulators [natoms, C]
  const T* gam[MAX_K];  // level-1 gammas [natoms]
  const T* gv[MAX_K];   // level-1 volumes [natoms]
  T* dr[MAX_K];         // [natoms, 3]
  T* epsi[MAX_K];       // [natoms]
  T* sv;                // [natoms] (SV)
  int natoms;
};

// ops/gaussians.py::pol_switchfunc: (s, ds/dV) of the quintic switch.
template <typename T>
__device__ __forceinline__ void pol_switch(T gvol, T& s, T& sp) {
  const T volmina = (T)TREE_VOLMINA, volminb = (T)TREE_VOLMINB;
  T swu = (gvol - volmina) / (T)(TREE_VOLMINB - TREE_VOLMINA);
  swu = swu < (T)0 ? (T)0 : (swu > (T)1 ? (T)1 : swu);
  const T swu2 = swu * swu;
  const T swu3 = swu * swu2;
  s = swu3 * (((T)10 - (T)15 * swu) + (T)6 * swu2);
  const bool in_window = gvol > volmina && gvol < volminb;
  sp = in_window ? (T)(1.0 / (TREE_VOLMINB - TREE_VOLMINA) * 30.0) * swu2
                       * (((T)1 - (T)2 * swu) + swu2)
                 : (T)0;
}

// ops/tree.py::_cand_dat for one row: the s side (gv, ga, gc, gamma) times
// the atomic row a (AT_D values) -> the packed row out (TREE_D values).
template <typename T>
__device__ __forceinline__ void cand_dat(T s_gv, T s_ga, T sx, T sy, T sz,
                                         T s_gam, const T* a, T* out) {
  const T a_gv = a[0], a_ga = a[1];
  const T dx = a[2] - sx, dy = a[3] - sy, dz = a[4] - sz;
  const T d2 = (dx * dx + dy * dy) + dz * dz;
  const T a12 = s_ga + a_ga;
  const bool ok = s_ga > (T)0 && a_ga > (T)0;
  const T deltai = (T)1 / (a12 > (T)0 ? a12 : (T)1);
  const T df = s_ga * a_ga * deltai;
  const T ef = exp(-df * d2);
  const T t = (ok ? df : (T)1) / (T)TREE_PI;
  const T gvol = ok ? (s_gv * a_gv * (t * sqrt(t))) * ef : (T)0;
  const T dgvol = (T)(-2) * df * gvol;
  T s, sp;
  pol_switch(gvol, s, sp);
  out[0] = gvol;
  out[1] = a12;
  out[2] = (sx * s_ga + a[2] * a_ga) * deltai;
  out[3] = (sy * s_ga + a[3] * a_ga) * deltai;
  out[4] = (sz * s_ga + a[4] * a_ga) * deltai;
  out[5] = s * gvol;
  out[6] = sp * gvol + s;
  out[7] = s_gv > (T)0 ? gvol / s_gv : (T)0;
  out[8] = dx * -dgvol;
  out[9] = dy * -dgvol;
  out[10] = dz * -dgvol;
  out[11] = s_gam + a[5];
  out[12] = a_ga;
}

template <typename T, int K>
__global__ void __launch_bounds__(TREE_THREADS)
    tree_rescan_kernel(RescanArgs<T> a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.nrows) return;
  T row[TREE_D];
  if (!a.valid[r]) {
#pragma unroll
    for (int j = 0; j < TREE_D; ++j) row[j] = (T)0;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < TREE_D; ++j) a.out[k][(size_t)r * TREE_D + j] = row[j];
    return;
  }
  const int p = __ldg(a.pid + r), i = __ldg(a.aid + r);
  const bool p_in = p >= 0 && p < a.nparents, i_in = i >= 0 && i < a.natoms;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s[AT_D], at[AT_D];
    const T* prow = a.par[k] + (size_t)(p_in ? p : 0) * a.pstride;
    const T* arow = a.at[k] + (size_t)(i_in ? i : 0) * AT_D;
#pragma unroll
    for (int j = 0; j < 5; ++j) s[j] = p_in ? __ldg(prow + j) : (T)0;
    s[5] = p_in ? __ldg(prow + a.pgam) : (T)0;
#pragma unroll
    for (int j = 0; j < AT_D; ++j) at[j] = i_in ? __ldg(arow + j) : (T)0;
    cand_dat(s[0], s[1], s[2], s[3], s[4], s[5], at, row);
#pragma unroll
    for (int j = 0; j < TREE_D; ++j) a.out[k][(size_t)r * TREE_D + j] = row[j];
  }
}

template <typename T, int K, bool SV>
__global__ void __launch_bounds__(TREE_THREADS)
    tree_reduce_kernel(ReduceArgs<T> a) {
  constexpr int C = 5 * K + (SV ? 1 : 0);
  constexpr int DC = 3 * K + (SV ? 1 : 0);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.nparents) return;
  const int lo = __ldg(a.starts + p), hi = __ldg(a.starts + p + 1);
  const T vc = a.volcoeffp;
  T sum[C];
#pragma unroll
  for (int j = 0; j < C; ++j) sum[j] = (T)0;
  for (int c = lo; c < hi; ++c) {
    T tot[C], dep[DC];
    T dv1[K][3], dvv1[K], c2[K], c2p[K], vol = (T)0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T* d = a.dat[k] + (size_t)c * TREE_D;
      const T g = __ldg(a.gam[k] + (size_t)c * a.gstride[k]);
      const T a1i = __ldg(d + 1), ai = __ldg(d + 12);
      vol = __ldg(d + 5);
      tot[5 * k] = vc * g * vol;
      tot[5 * k + 1] = vc * __ldg(d + 6) * g;
      tot[5 * k + 2] = tot[5 * k + 3] = tot[5 * k + 4] = (T)0;
      dvv1[k] = __ldg(d + 7);
#pragma unroll
      for (int x = 0; x < 3; ++x) dv1[k][x] = __ldg(d + 8 + x);
      c2[k] = ai / a1i;
      c2p[k] = (a1i - ai) / a1i;
    }
    if constexpr (SV) tot[5 * K] = vc * vol;  // the last parameterization's volume
    if (a.acc_in != nullptr) {
#pragma unroll
      for (int j = 0; j < C; ++j) tot[j] += __ldg(a.acc_in + (size_t)c * C + j);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T e_f = tot[5 * k + 1];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const T e_p = tot[5 * k + 2 + x];
        dep[3 * k + x] = -dv1[k][x] * e_f + e_p * c2[k];
        sum[5 * k + 2 + x] += dv1[k][x] * e_f + e_p * c2p[k];
      }
      sum[5 * k] += tot[5 * k];
      sum[5 * k + 1] += dvv1[k] * e_f;
    }
    if constexpr (SV) {
      dep[3 * K] = tot[5 * K];
      sum[5 * K] += tot[5 * K];
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) a.dep[(size_t)c * DC + j] = dep[j];
  }
#pragma unroll
  for (int j = 0; j < C; ++j) a.acc_out[(size_t)p * C + j] = sum[j];
}

template <typename T, int K, bool SV>
__global__ void __launch_bounds__(TREE_THREADS)
    tree_deposit_kernel(DepositArgs<T> a) {
  constexpr int C = 5 * K + (SV ? 1 : 0);
  constexpr int DC = 3 * K + (SV ? 1 : 0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.natoms) return;
  T d[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) d[j] = (T)0;
  const int lo = __ldg(a.dstarts + i), hi = __ldg(a.dstarts + i + 1);
  for (int n = lo; n < hi; ++n) {
    const T* row = a.dep + (size_t)__ldg(a.order + n) * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) d[j] += __ldg(row + j);
  }
  const T* acc = a.acc + (size_t)i * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a.epsi[k][i] = __ldg(a.gam[k] + i) * __ldg(a.gv[k] + i) + acc[5 * k];
#pragma unroll
    for (int x = 0; x < 3; ++x)
      a.dr[k][(size_t)i * 3 + x] = d[3 * k + x] + acc[5 * k + 2 + x];
  }
  if constexpr (SV) a.sv[i] = (__ldg(a.gv[K - 1] + i) + acc[5 * K]) + d[3 * K];
}

static unsigned tree_blocks(int n) {
  return (unsigned)((n + TREE_THREADS - 1) / TREE_THREADS);
}

template <typename T>
static int rescan(int k, const void* const* par, int pstride, int pgam,
                  int nparents, const void* const* at, int natoms,
                  const int* pid, const int* aid, const uint8_t* valid,
                  int nrows, void* const* out, cudaStream_t stream) {
  RescanArgs<T> a;
  for (int j = 0; j < MAX_K; ++j) {
    a.par[j] = (const T*)par[j < k ? j : 0];
    a.at[j] = (const T*)at[j < k ? j : 0];
    a.out[j] = (T*)out[j < k ? j : 0];
  }
  a.pid = pid;
  a.aid = aid;
  a.valid = valid;
  a.nrows = nrows;
  a.nparents = nparents;
  a.natoms = natoms;
  a.pstride = pstride;
  a.pgam = pgam;
  if (k == 1)
    tree_rescan_kernel<T, 1><<<tree_blocks(nrows), TREE_THREADS, 0, stream>>>(a);
  else
    tree_rescan_kernel<T, 2><<<tree_blocks(nrows), TREE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static void launch_reduce(bool sv, const ReduceArgs<T>& a,
                          cudaStream_t stream) {
  if (sv)
    tree_reduce_kernel<T, K, true>
        <<<tree_blocks(a.nparents), TREE_THREADS, 0, stream>>>(a);
  else
    tree_reduce_kernel<T, K, false>
        <<<tree_blocks(a.nparents), TREE_THREADS, 0, stream>>>(a);
}

template <typename T>
static int reduce(int k, int sv, double volcoeffp, const void* const* dat,
                  const void* const* gam, const int* gstride,
                  const int* starts, int nparents, const void* acc_in,
                  void* acc_out, void* dep, cudaStream_t stream) {
  ReduceArgs<T> a;
  for (int j = 0; j < MAX_K; ++j) {
    a.dat[j] = (const T*)dat[j < k ? j : 0];
    a.gam[j] = (const T*)gam[j < k ? j : 0];
    a.gstride[j] = gstride[j < k ? j : 0];
  }
  a.starts = starts;
  a.acc_in = (const T*)acc_in;
  a.acc_out = (T*)acc_out;
  a.dep = (T*)dep;
  a.nparents = nparents;
  a.volcoeffp = (T)volcoeffp;
  if (k == 1)
    launch_reduce<T, 1>(sv != 0, a, stream);
  else
    launch_reduce<T, 2>(sv != 0, a, stream);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static void launch_deposit(bool sv, const DepositArgs<T>& a,
                           cudaStream_t stream) {
  if (sv)
    tree_deposit_kernel<T, K, true>
        <<<tree_blocks(a.natoms), TREE_THREADS, 0, stream>>>(a);
  else
    tree_deposit_kernel<T, K, false>
        <<<tree_blocks(a.natoms), TREE_THREADS, 0, stream>>>(a);
}

template <typename T>
static int deposit(int k, int sv, const int* order, const int* dstarts,
                   int natoms, const void* dep, const void* acc,
                   const void* const* gam, const void* const* gv,
                   void* const* dr, void* const* epsi, void* svol,
                   cudaStream_t stream) {
  DepositArgs<T> a;
  for (int j = 0; j < MAX_K; ++j) {
    const int s = j < k ? j : 0;
    a.gam[j] = (const T*)gam[s];
    a.gv[j] = (const T*)gv[s];
    a.dr[j] = (T*)dr[s];
    a.epsi[j] = (T*)epsi[s];
  }
  a.order = order;
  a.dstarts = dstarts;
  a.dep = (const T*)dep;
  a.acc = (const T*)acc;
  a.sv = (T*)svol;
  a.natoms = natoms;
  if (k == 1)
    launch_deposit<T, 1>(sv != 0, a, stream);
  else
    launch_deposit<T, 2>(sv != 0, a, stream);
  return (int)cudaGetLastError();
}

static bool tree_args_ok(int dbl, int k) {
  return (dbl == 0 || dbl == 1) && (k == 1 || k == 2);
}

extern "C" {

// One level of the downward rescan for k parameterizations: out[j] [nrows,
// 13] from the parent tables par[j] (pstride values a row, the gamma at
// column pgam) and the level-1 tables at[j] [natoms, 6].  dbl: float64.
int agbnp_tree_rescan(int dbl, int k, const void* const* par, int pstride,
                      int pgam, int nparents, const void* const* at,
                      int natoms, const int* pid, const int* aid,
                      const uint8_t* valid, int nrows, void* const* out,
                      cudaStream_t stream) {
  if (!tree_args_ok(dbl, k) || pgam < 5 || pgam >= pstride)
    return (int)cudaErrorInvalidValue;
  if (nrows <= 0) return (int)cudaSuccess;
  return dbl ? rescan<double>(k, par, pstride, pgam, nparents, at, natoms,
                              pid, aid, valid, nrows, out, stream)
             : rescan<float>(k, par, pstride, pgam, nparents, at, natoms,
                             pid, aid, valid, nrows, out, stream);
}

// One level of the upward reduction: acc_out [nparents, 5k + sv] and the
// level's deposit rows dep [rows, 3k + sv] from its packed rows dat[j],
// gammas gam[j] (gstride[j] apart) and its children's accumulators acc_in
// (null at the deepest level).
int agbnp_tree_reduce(int dbl, int k, int sv, double volcoeffp,
                      const void* const* dat, const void* const* gam,
                      const int* gstride, const int* starts, int nparents,
                      const void* acc_in, void* acc_out, void* dep,
                      cudaStream_t stream) {
  if (!tree_args_ok(dbl, k)) return (int)cudaErrorInvalidValue;
  if (nparents <= 0) return (int)cudaSuccess;
  return dbl ? reduce<double>(k, sv, volcoeffp, dat, gam, gstride, starts,
                              nparents, acc_in, acc_out, dep, stream)
             : reduce<float>(k, sv, volcoeffp, dat, gam, gstride, starts,
                             nparents, acc_in, acc_out, dep, stream);
}

// The deposits of every level on their atoms and the level-1 terms: dr[j]
// [natoms, 3], epsi[j] [natoms] and, with sv, the last parameterization's
// self volumes svol [natoms].
int agbnp_tree_deposit(int dbl, int k, int sv, const int* order,
                       const int* dstarts, int natoms, const void* dep,
                       const void* acc, const void* const* gam,
                       const void* const* gv, void* const* dr,
                       void* const* epsi, void* svol, cudaStream_t stream) {
  if (!tree_args_ok(dbl, k)) return (int)cudaErrorInvalidValue;
  if (natoms <= 0) return (int)cudaSuccess;
  return dbl ? deposit<double>(k, sv, order, dstarts, natoms, dep, acc, gam,
                               gv, dr, epsi, svol, stream)
             : deposit<float>(k, sv, order, dstarts, natoms, dep, acc, gam,
                              gv, dr, epsi, svol, stream);
}

}  // extern "C"
