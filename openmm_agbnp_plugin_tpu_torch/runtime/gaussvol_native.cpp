// Native (C++) GaussVol overlap-tree engine.
//
// A copy of the JAX package's runtime/gaussvol_native.cpp: a fast float64
// implementation of the recursive Gaussian overlap tree used for
//   (a) the capacity sizing pre-pass that dimensions the padded TPU tree
//       (the analogue of the reference's CPU GaussVol pre-pass,
//       reference OpenCLAGBNPKernels.cpp:566-655), and
//   (b) a fast golden oracle for validation on large systems where the
//       Python reference implementation is too slow.
//
// This is an independent implementation of the model described in the JAX
// package's models/oracle.py (same math, same tree semantics as the reference
// plugin's gaussvol: 2-Gaussian products, quintic switching, volume-sorted
// children, MAX_ORDER=8, inclusion-exclusion reduction with (psi, F, P)
// gradient back-propagation).
//
// Build: make -C openmm_agbnp_plugin_tpu_torch/runtime OUT=<library path>
// (native.py builds it at first use into the package's _build/ directory)
// Used through ctypes (see native.py).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double KFC = 2.2269859253;
constexpr double PI_ = 3.14159265358979323846;
constexpr double VOLMINA = 0.01 * 0.001;
constexpr double VOLMINB = 0.1 * 0.001;
constexpr double MIN_GVOL = FLT_MIN;
constexpr int MAX_ORDER = 8;

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
};

struct Node {
  int level = 0;
  double gv = 0;   // unswitched product volume
  double ga = 0;   // exponent
  Vec3 gc;         // center
  double volume = 0;  // switched volume
  double dvv1 = 0;
  Vec3 dv1;
  double gamma1i = 0;
  double sfp = 1.0;
  int atom = -1;
  int parent = -1;
  int child_start = -1;
  int child_count = -1;
};

double pol_switchfunc(double gvol, double& sp) {
  double swf = 0.0, swfp = 1.0;
  if (gvol > VOLMINB) {
    swf = 1.0;
    swfp = 0.0;
  } else if (gvol < VOLMINA) {
    swf = 0.0;
    swfp = 0.0;
  }
  double swd = 1.0 / (VOLMINB - VOLMINA);
  double swu = (gvol - VOLMINA) * swd;
  double swu2 = swu * swu;
  double swu3 = swu * swu2;
  sp = swfp * swd * 30.0 * swu2 * (1.0 - 2.0 * swu + swu2);
  return swf + swfp * swu3 * (10.0 - 15.0 * swu + 6.0 * swu2);
}

// product of two Gaussians; returns switched volume, fills raw product and
// derivative factors
double ogauss(double v1, double a1, const Vec3& c1, double v2, double a2,
              const Vec3& c2, double& gv, double& ga, Vec3& gc, double& dVdr,
              double& dVdV, double& sfp) {
  Vec3 dist = c2 - c1;
  double d2 = dist.dot(dist);
  double a12 = a1 + a2;
  double deltai = 1.0 / a12;
  double df = a1 * a2 * deltai;
  double ef = std::exp(-df * d2);
  double gvol = (v1 * v2 / std::pow(PI_ / df, 1.5)) * ef;
  dVdr = -2.0 * df * gvol;
  dVdV = v1 > 0 ? gvol / v1 : 0.0;
  gc = (c1 * a1 + c2 * a2) * deltai;
  ga = a12;
  gv = gvol;
  double sp;
  double s = pol_switchfunc(gvol, sp);
  sfp = sp * gvol + s;
  return s * gvol;
}

struct GaussVolCtx {
  int natoms;
  std::vector<int> ishydrogen;
  std::vector<Node> nodes;

  void seed_level1(const double* pos, const double* radii,
                   const double* volumes, const double* gammas) {
    nodes.clear();
    Node root;
    root.level = 0;
    root.child_start = 1;
    root.child_count = natoms;
    root.sfp = 1.0;
    nodes.push_back(root);
    for (int i = 0; i < natoms; ++i) {
      Node nd;
      nd.level = 1;
      nd.gv = ishydrogen[i] ? 0.0 : volumes[i];
      nd.ga = KFC / (radii[i] * radii[i]);
      nd.gc = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
      nd.volume = nd.gv;
      nd.dvv1 = 1.0;
      nd.gamma1i = gammas[i];
      nd.sfp = 1.0;
      nd.atom = i;
      nd.parent = 0;
      nodes.push_back(nd);
    }
  }

  void grow(int slot) {
    // children of `slot`: overlaps with the last atoms of its later
    // siblings; volume-sorted before insertion, then recurse
    Node root = nodes[slot];
    if (root.parent < 0 || root.level >= MAX_ORDER) return;
    const Node& par = nodes[root.parent];
    int sib_end = par.child_start + par.child_count;
    std::vector<Node> children;
    for (int sj = slot + 1; sj < sib_end; ++sj) {
      int atom2 = nodes[sj].atom;
      const Node& g2 = nodes[atom2 + 1];
      Node nd;
      double dVdr, dVdV, sfp;
      double sv = ogauss(root.gv, root.ga, root.gc, g2.gv, g2.ga, g2.gc,
                         nd.gv, nd.ga, nd.gc, dVdr, dVdV, sfp);
      if (sv > MIN_GVOL) {
        nd.level = root.level + 1;
        nd.volume = sv;
        nd.dv1 = (g2.gc - root.gc) * (-dVdr);
        nd.dvv1 = dVdV;
        nd.sfp = sfp;
        nd.gamma1i = root.gamma1i + g2.gamma1i;
        nd.atom = atom2;
        nd.parent = slot;
        children.push_back(nd);
      }
    }
    if (children.empty()) return;
    std::sort(children.begin(), children.end(),
              [](const Node& a, const Node& b) { return a.volume > b.volume; });
    int start = (int)nodes.size();
    nodes[slot].child_start = start;
    nodes[slot].child_count = (int)children.size();
    for (auto& c : children) nodes.push_back(c);
    for (int c = start; c < start + (int)children.size(); ++c) grow(c);
  }

  void compute_tree(const double* pos, const double* radii,
                    const double* volumes, const double* gammas) {
    seed_level1(pos, radii, volumes, gammas);
    for (int slot = 1; slot <= natoms; ++slot) grow(slot);
  }

  void rescan_volumes(const double* pos, const double* radii,
                      const double* volumes, const double* gammas) {
    // fixed topology, new level-1 data; top-down recompute
    for (int i = 0; i < natoms; ++i) {
      Node& nd = nodes[i + 1];
      nd.gv = ishydrogen[i] ? 0.0 : volumes[i];
      nd.ga = KFC / (radii[i] * radii[i]);
      nd.gc = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
      nd.volume = nd.gv;
      nd.dvv1 = 1.0;
      nd.dv1 = {0, 0, 0};
      nd.sfp = 1.0;
      nd.gamma1i = gammas[i];
    }
    for (size_t s = (size_t)natoms + 1; s < nodes.size(); ++s) {
      Node& nd = nodes[s];
      const Node& par = nodes[nd.parent];
      const Node& g2 = nodes[nd.atom + 1];
      double dVdr, dVdV, sfp;
      double sv = ogauss(par.gv, par.ga, par.gc, g2.gv, g2.ga, g2.gc, nd.gv,
                         nd.ga, nd.gc, dVdr, dVdV, sfp);
      nd.volume = sv;
      nd.dv1 = (g2.gc - par.gc) * (-dVdr);
      nd.dvv1 = dVdV;
      nd.sfp = sfp;
      nd.gamma1i = par.gamma1i + g2.gamma1i;
    }
  }

  void rescan_gammas(const double* gammas) {
    for (int i = 0; i < natoms; ++i) nodes[i + 1].gamma1i = gammas[i];
    for (size_t s = (size_t)natoms + 1; s < nodes.size(); ++s) {
      Node& nd = nodes[s];
      nd.gamma1i = nodes[nd.parent].gamma1i + nodes[nd.atom + 1].gamma1i;
    }
    // note: nodes are appended depth-first so parents always precede
    // children; a linear sweep is a valid top-down order
  }

  struct Acc {
    double psi = 0, f = 0;
    Vec3 p;
    double psip = 0;
    double e = 0, fe = 0;
    Vec3 pe;
  };

  Acc reduce_node(int slot, double* dr, double* dv, double* free_vol,
                  double* self_vol) {
    const Node& nd = nodes[slot];
    double cf = nd.level % 2 == 0 ? -1.0 : 1.0;
    double vc = nd.level > 0 ? cf : 0.0;
    double vcp = nd.level > 0 ? vc / nd.level : 0.0;

    Acc acc;
    acc.psi = vc * nd.volume;
    acc.f = vc * nd.sfp;
    acc.psip = vcp * nd.volume;
    acc.e = vcp * nd.gamma1i * nd.volume;
    acc.fe = vcp * nd.sfp * nd.gamma1i;

    if (nd.child_start >= 0) {
      for (int c = nd.child_start; c < nd.child_start + nd.child_count; ++c) {
        Acc t = reduce_node(c, dr, dv, free_vol, self_vol);
        acc.psi += t.psi;
        acc.f += t.f;
        acc.p = acc.p + t.p;
        acc.psip += t.psip;
        acc.e += t.e;
        acc.fe += t.fe;
        acc.pe = acc.pe + t.pe;
      }
    }

    if (nd.level > 0) {
      int atom = nd.atom;
      double ai = nodes[atom + 1].ga;
      double a1i = nd.ga;
      double c2 = ai / a1i;
      free_vol[atom] += acc.psi;
      self_vol[atom] += acc.psip;
      Vec3 g = nd.dv1 * (-acc.fe) + acc.pe * c2;
      dr[3 * atom] += g.x;
      dr[3 * atom + 1] += g.y;
      dr[3 * atom + 2] += g.z;
      dv[atom] += nd.gv * acc.fe;
      double c2p = (a1i - ai) / a1i;
      acc.p = nd.dv1 * acc.f + acc.p * c2p;
      acc.pe = nd.dv1 * acc.fe + acc.pe * c2p;
      acc.f = nd.dvv1 * acc.f;
      acc.fe = nd.dvv1 * acc.fe;
    }
    return acc;
  }

  void compute_volume(double* energy, double* volume, double* dr, double* dv,
                      double* free_vol, double* self_vol) {
    std::memset(dr, 0, sizeof(double) * 3 * natoms);
    std::memset(dv, 0, sizeof(double) * natoms);
    std::memset(free_vol, 0, sizeof(double) * natoms);
    std::memset(self_vol, 0, sizeof(double) * natoms);
    Acc acc = reduce_node(0, dr, dv, free_vol, self_vol);
    *energy = acc.e;
    *volume = acc.psi;
  }
};

// ---------------------------------------------------------------------------
// Full AGBNP1 pipeline (host f64): Born radii through the I4 spline lookup,
// GB self/pair energy, vdW dispersion, descreening derivative chain, and the
// W/U gamma-rescan force pass — the native independent ground truth for the
// TPU path at benchmark scale, mirroring the semantics of
// reference ReferenceAGBNPKernels.cpp:274-795 (independent implementation,
// same published model).
// ---------------------------------------------------------------------------

constexpr double I4_MAXA = 2.0;                 // AGBNPUtils.h:122-126
constexpr int I4_NA = 16;
constexpr int RADIUS_PRECISION = 10000;         // AGBNPUtils.h:155
constexpr double TOKJMOL = 4.184 * 332.0 / 10.0;
constexpr double DIELECTRIC_FACTOR = TOKJMOL * (-0.5) * (1.0 - 1.0 / 80.0);
constexpr double PIFAC = 1.0 / (4.0 * PI_);
constexpr double HB_RADIUS = 0.14;              // AGBNPForce.h:33

// analytic integral of 1/r^4 over sphere j outside sphere i
// (three branches + removable-singularity expansion, AGBNPUtils.cpp:34-85)
double i4_closed(double rij, double Ri, double Rj) {
  const double twopi = 2.0 * PI_;
  double rij2 = rij * rij;
  if (rij > Ri + Rj) {
    double u1 = rij + Rj, u2 = rij - Rj;
    return twopi * (Rj / (u1 * u2) - 0.5 * std::log(u1 / u2) / rij);
  }
  double w = Rj - Ri;
  if (rij2 > w * w) {
    double u1 = rij + Rj, u2 = rij - Rj;
    double u3 = u1 * u2;
    double u4 = 1.0 / u1, u5 = 1.0 / Ri;
    double u6 = 0.5 * std::log(u1 / Ri);
    return twopi * (-(u4 - u5)
                    + (0.25 * u3 * (u4 * u4 - u5 * u5) - u6) / rij);
  }
  if (Ri > Rj) return 0.0;
  double u1 = rij + Rj, u2 = Rj - rij;
  double u3 = -u1 * u2;  // rij^2 - Rj^2
  if (rij < 0.001 * Rj) {
    double a = rij / Rj;
    double u6 = (1.0 + (2.0 / 3.0) * a * a) / Rj;
    return twopi * (2.0 / Ri + Rj / u3 - u6);
  }
  return twopi * (2.0 / Ri + Rj / u3 - 0.5 * std::log(u1 / u2) / rij);
}

// quintic 1 -> 0 switch on [xa, xb] (AGBNPUtils.cpp:13-25)
double switch_1to0(double x, double xa, double xb) {
  if (x > xb) return 0.0;
  if (x < xa) return 1.0;
  double u = (x - xa) / (xb - xa);
  double u2 = u * u, u3 = u * u2;
  return 1.0 - u3 * (10.0 - 15.0 * u + 6.0 * u2);
}

// natural cubic spline through uniform nodes (SplineFitter analogue)
void natural_spline_y2(const std::vector<double>& x,
                       const std::vector<double>& y,
                       std::vector<double>& y2) {
  int n = (int)x.size();
  y2.assign(n, 0.0);
  std::vector<double> u(n, 0.0);
  for (int i = 1; i < n - 1; ++i) {
    double sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1]);
    double p = sig * y2[i - 1] + 2.0;
    y2[i] = (sig - 1.0) / p;
    double t = (y[i + 1] - y[i]) / (x[i + 1] - x[i])
             - (y[i] - y[i - 1]) / (x[i] - x[i - 1]);
    u[i] = (6.0 * t / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p;
  }
  for (int k = n - 2; k >= 0; --k) y2[k] = y2[k] * y2[k + 1] + u[k];
}

struct I4Spline {
  // uniform grid on [0, I4_MAXA]
  std::vector<double> y, y2;
  void eval(double t, double& v, double& dv) const {
    double h = I4_MAXA / (I4_NA - 1);
    int k = (int)(t / h);
    if (k < 0) k = 0;
    if (k > I4_NA - 2) k = I4_NA - 2;
    double a = ((k + 1) * h - t) / h;
    double b = 1.0 - a;
    v = a * y[k] + b * y[k + 1]
      + ((a * a * a - a) * y2[k] + (b * b * b - b) * y2[k + 1]) * h * h / 6.0;
    dv = (y[k + 1] - y[k]) / h
       + ((3.0 * b * b - 1.0) * y2[k + 1] - (3.0 * a * a - 1.0) * y2[k])
         * h / 6.0;
  }
};

struct AGBNP1Ctx {
  int natoms;
  std::vector<int> ishydrogen;
  std::vector<double> radius, gamma, alpha, charge;
  double roffset;
  std::vector<int> type_i, type_j;  // screened / screener radius types
  std::vector<I4Spline> tables;     // [ntype_i * ntype_j]
  int ntj = 0;
  GaussVolCtx tree;

  void build_tables() {
    // unique radii quantized at 1e-4 nm define the types
    // (AGBNPI42DLookupTable, AGBNPUtils.cpp:134-214); hydrogens never
    // screen (screener type -1)
    std::vector<long> qi, qj;
    std::vector<double> rep_i, rep_j;
    type_i.resize(natoms);
    type_j.resize(natoms);
    auto quant = [](double r) { return (long)(r * RADIUS_PRECISION); };
    std::vector<long> uq_i, uq_j;
    for (int k = 0; k < natoms; ++k) {
      long q = quant(radius[k]);
      if (std::find(uq_i.begin(), uq_i.end(), q) == uq_i.end())
        uq_i.push_back(q);
      if (!ishydrogen[k]
          && std::find(uq_j.begin(), uq_j.end(), q) == uq_j.end())
        uq_j.push_back(q);
    }
    std::sort(uq_i.begin(), uq_i.end());
    std::sort(uq_j.begin(), uq_j.end());
    rep_i.assign(uq_i.size(), 0.0);
    rep_j.assign(uq_j.size(), 0.0);
    std::vector<int> seen_i(uq_i.size(), 0), seen_j(uq_j.size(), 0);
    for (int k = 0; k < natoms; ++k) {
      long q = quant(radius[k]);
      int ti = (int)(std::lower_bound(uq_i.begin(), uq_i.end(), q)
                     - uq_i.begin());
      type_i[k] = ti;
      if (!seen_i[ti]) { rep_i[ti] = radius[k]; seen_i[ti] = 1; }
      if (ishydrogen[k]) {
        type_j[k] = -1;
      } else {
        int tj = (int)(std::lower_bound(uq_j.begin(), uq_j.end(), q)
                       - uq_j.begin());
        type_j[k] = tj;
        if (!seen_j[tj]) { rep_j[tj] = radius[k]; seen_j[tj] = 1; }
      }
    }
    ntj = (int)uq_j.size();
    int nti = (int)uq_i.size();
    double dr = I4_MAXA / (I4_NA - 1);
    double xa = 0.5 * I4_MAXA, xb = I4_MAXA;
    std::vector<double> xn(I4_NA);
    for (int s = 0; s < I4_NA; ++s) xn[s] = s * dr;
    tables.assign(nti * ntj, {});
    for (int ti = 0; ti < nti; ++ti)
      for (int tj = 0; tj < ntj; ++tj) {
        I4Spline& sp = tables[ti * ntj + tj];
        sp.y.resize(I4_NA);
        for (int s = 0; s < I4_NA; ++s)
          sp.y[s] = switch_1to0(xn[s], xa, xb)
                  * i4_closed(xn[s], rep_i[ti], rep_j[tj]);
        natural_spline_y2(xn, sp.y, sp.y2);
      }
  }

  // full AGBNP1 energy + analytic forces (the reference pipeline,
  // ReferenceAGBNPKernels.cpp:274-795).  cutoff <= 0: NoCutoff GB;
  // horizon <= 0: the 2 nm LUT horizon for the descreening sweeps.
  void energy_forces(const double* pos, double cutoff, double horizon,
                     double* energy, double* force, double* born_out,
                     double* selfvol_out, double* components) {
    int n = natoms;
    double hmax = horizon > 0 ? std::min(horizon, I4_MAXA) : I4_MAXA;
    std::vector<double> vol_l(n), vol_v(n), gdr(n), volall(n);
    for (int i = 0; i < n; ++i) {
      double rl = radius[i] + roffset;
      vol_l[i] = ishydrogen[i] ? 0.0 : 4.0 * PI_ * rl * rl * rl / 3.0;
      double rv = radius[i];
      volall[i] = 4.0 * PI_ * rv * rv * rv / 3.0;
      vol_v[i] = ishydrogen[i] ? 0.0 : volall[i];
      gdr[i] = gamma[i] / roffset;
    }
    std::vector<double> rl(n);
    for (int i = 0; i < n; ++i) rl[i] = radius[i] + roffset;

    std::vector<double> dr(3 * n), dv(n), fv(n), sv(n);
    double e1, vol1;
    tree.natoms = n;
    tree.ishydrogen = ishydrogen;
    tree.compute_tree(pos, rl.data(), vol_l.data(), gdr.data());
    tree.compute_volume(&e1, &vol1, dr.data(), dv.data(), fv.data(),
                        sv.data());
    std::vector<double> f(3 * n);
    for (int k = 0; k < 3 * n; ++k) f[k] = -dr[k];

    std::vector<double> ngdr(n);
    for (int i = 0; i < n; ++i) ngdr[i] = -gdr[i];
    double e2, vol2;
    tree.rescan_volumes(pos, radius.data(), vol_v.data(), ngdr.data());
    tree.compute_volume(&e2, &vol2, dr.data(), dv.data(), fv.data(),
                        sv.data());
    for (int k = 0; k < 3 * n; ++k) f[k] -= dr[k];
    double e_cav = e1 + e2;

    // volume scaling factors (cpp:420-430)
    std::vector<double> s(n);
    for (int i = 0; i < n; ++i) s[i] = sv[i] / volall[i];

    // Born radii (cpp:437-454): Q/dQ cached for the descreening sweep
    std::vector<double> Q((size_t)n * n, 0.0), dQ((size_t)n * n, 0.0);
    std::vector<double> br(n), fp(n);
    for (int i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int j = 0; j < n; ++j) {
        if (j == i || type_j[j] < 0) continue;
        double dx = pos[3 * j] - pos[3 * i];
        double dy = pos[3 * j + 1] - pos[3 * i + 1];
        double dz = pos[3 * j + 2] - pos[3 * i + 2];
        double d = std::sqrt(dx * dx + dy * dy + dz * dz);
        if (d >= hmax) continue;
        double q, dq;
        tables[type_i[i] * ntj + type_j[j]].eval(d, q, dq);
        Q[(size_t)i * n + j] = q;
        dQ[(size_t)i * n + j] = dq;
        acc += s[j] * q;
      }
      double beta = 1.0 / radius[i] - PIFAC * acc;
      // soft filter on the inverse Born radius (cpp:41-55)
      double a = 1.0 / I4_MAXA, a2 = a * a;
      double filt, fpi;
      if (beta >= 0.0) {
        double t = std::sqrt(a2 + beta * beta);
        filt = t;
        fpi = beta / t;
      } else {
        filt = a;
        fpi = 0.0;
      }
      br[i] = 1.0 / filt;
      fp[i] = fpi;
    }

    // GB self + pair energy, direct forces, Y accumulators (cpp:464-504)
    double gb_self = 0.0, gb_pair = 0.0;
    std::vector<double> Y(n, 0.0);
    for (int i = 0; i < n; ++i)
      gb_self += DIELECTRIC_FACTOR * charge[i] * charge[i] / br[i];
    for (int i = 0; i < n; ++i) {
      for (int j = i + 1; j < n; ++j) {
        double dx = pos[3 * j] - pos[3 * i];
        double dy = pos[3 * j + 1] - pos[3 * i + 1];
        double dz = pos[3 * j + 2] - pos[3 * i + 2];
        double d2 = dx * dx + dy * dy + dz * dz;
        if (cutoff > 0 && d2 >= cutoff * cutoff) continue;
        double bb = br[i] * br[j];
        double etij = std::exp(-0.25 * d2 / bb);
        double fgb = 1.0 / std::sqrt(d2 + bb * etij);
        double qq_f = charge[i] * charge[j];
        double qq = DIELECTRIC_FACTOR * qq_f;
        gb_pair += 2.0 * qq * fgb;
        double fgb3 = fgb * fgb * fgb;
        double mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3;
        f[3 * i] += dx * mw;      f[3 * j] -= dx * mw;
        f[3 * i + 1] += dy * mw;  f[3 * j + 1] -= dy * mw;
        f[3 * i + 2] += dz * mw;  f[3 * j + 2] -= dz * mw;
        double ypair = qq_f * (bb + 0.25 * d2) * etij * fgb3;
        Y[i] += ypair;
        Y[j] += ypair;
      }
    }

    // vdW dispersion + chain factors (cpp:513-549)
    double e_vdw = 0.0;
    std::vector<double> brw(n), bru(n);
    for (int i = 0; i < n; ++i) {
      double b = br[i] + HB_RADIUS;
      e_vdw += alpha[i] / (b * b * b);
      brw[i] = -PIFAC * 3.0 * alpha[i] * br[i] * br[i] * fp[i]
             / (b * b * b * b);
      bru[i] = -PIFAC * DIELECTRIC_FACTOR
             * (charge[i] * charge[i] + Y[i] * br[i]) * fp[i];
    }

    // descreening derivative sweep (cpp:555-586)
    std::vector<double> W(n, 0.0), U(n, 0.0);
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        if (j == i || type_j[j] < 0) continue;
        double q = Q[(size_t)i * n + j];
        double dq = dQ[(size_t)i * n + j];
        if (q == 0.0 && dq == 0.0) continue;
        W[j] += brw[i] * q;
        U[j] += bru[i] * q;
        double dx = pos[3 * j] - pos[3 * i];
        double dy = pos[3 * j + 1] - pos[3 * i + 1];
        double dz = pos[3 * j + 2] - pos[3 * i + 2];
        double d = std::sqrt(dx * dx + dy * dy + dz * dz);
        double c = (brw[i] + bru[i]) * s[j] * dq / d;
        f[3 * i] += c * dx;      f[3 * j] -= c * dx;
        f[3 * i + 1] += c * dy;  f[3 * j + 1] -= c * dy;
        f[3 * i + 2] += c * dz;  f[3 * j + 2] -= c * dz;
      }
    }

    // self-volume-gradient forces via the fused W+U gamma rescan
    // (the two passes of cpp:713-747, linear in gamma so one pass)
    std::vector<double> gwu(n);
    for (int i = 0; i < n; ++i) gwu[i] = (W[i] + U[i]) / volall[i];
    tree.rescan_gammas(gwu.data());
    double ewu, volwu;
    tree.compute_volume(&ewu, &volwu, dr.data(), dv.data(), fv.data(),
                        sv.data());
    for (int k = 0; k < 3 * n; ++k) f[k] -= dr[k];
    // note: the WU compute_volume overwrote sv with the WU-pass psip;
    // recompute the reported self volumes from the s factors kept above
    for (int i = 0; i < n; ++i) selfvol_out[i] = s[i] * volall[i];

    *energy = e_cav + gb_self + gb_pair + e_vdw;
    std::memcpy(force, f.data(), sizeof(double) * 3 * n);
    std::memcpy(born_out, br.data(), sizeof(double) * n);
    components[0] = e_cav;
    components[1] = gb_self;
    components[2] = gb_pair;
    components[3] = e_vdw;
  }
};

}  // namespace

extern "C" {

void* agbnp1_create(int natoms, const double* radius, const double* gamma,
                    const double* alpha, const double* charge,
                    const int* ishydrogen, double roffset) {
  auto* ctx = new AGBNP1Ctx();
  ctx->natoms = natoms;
  ctx->radius.assign(radius, radius + natoms);
  ctx->gamma.assign(gamma, gamma + natoms);
  // hydrogen gammas are zeroed (ReferenceAGBNPKernels.cpp:96-118)
  for (int i = 0; i < natoms; ++i)
    if (ishydrogen[i]) ctx->gamma[i] = 0.0;
  ctx->alpha.assign(alpha, alpha + natoms);
  ctx->charge.assign(charge, charge + natoms);
  ctx->ishydrogen.assign(ishydrogen, ishydrogen + natoms);
  ctx->roffset = roffset;
  ctx->build_tables();
  return ctx;
}

void agbnp1_destroy(void* h) { delete (AGBNP1Ctx*)h; }

void agbnp1_energy_forces(void* h, const double* pos, double cutoff,
                          double horizon, double* energy, double* force,
                          double* born, double* selfvol,
                          double* components) {
  ((AGBNP1Ctx*)h)->energy_forces(pos, cutoff, horizon, energy, force, born,
                                 selfvol, components);
}


void* gv_create(int natoms, const int* ishydrogen) {
  auto* ctx = new GaussVolCtx();
  ctx->natoms = natoms;
  ctx->ishydrogen.assign(ishydrogen, ishydrogen + natoms);
  return ctx;
}

void gv_destroy(void* h) { delete (GaussVolCtx*)h; }

void gv_compute_tree(void* h, const double* pos, const double* radii,
                     const double* volumes, const double* gammas) {
  ((GaussVolCtx*)h)->compute_tree(pos, radii, volumes, gammas);
}

void gv_rescan_volumes(void* h, const double* pos, const double* radii,
                       const double* volumes, const double* gammas) {
  ((GaussVolCtx*)h)->rescan_volumes(pos, radii, volumes, gammas);
}

void gv_rescan_gammas(void* h, const double* gammas) {
  ((GaussVolCtx*)h)->rescan_gammas(gammas);
}

void gv_compute_volume(void* h, double* energy, double* volume, double* dr,
                       double* dv, double* free_vol, double* self_vol) {
  ((GaussVolCtx*)h)->compute_volume(energy, volume, dr, dv, free_vol,
                                    self_vol);
}

// per-level node counts [MAX_ORDER+1] and max surviving siblings per parent
void gv_level_stats(void* h, int* counts, int* max_siblings) {
  auto* ctx = (GaussVolCtx*)h;
  for (int i = 0; i <= MAX_ORDER; ++i) counts[i] = max_siblings[i] = 0;
  for (const auto& nd : ctx->nodes) {
    if (nd.level <= MAX_ORDER) counts[nd.level]++;
    if (nd.child_count > 0 && nd.level + 1 <= MAX_ORDER)
      max_siblings[nd.level + 1] =
          std::max(max_siblings[nd.level + 1], nd.child_count);
  }
}

int gv_total_nodes(void* h) { return (int)((GaussVolCtx*)h)->nodes.size(); }
}
