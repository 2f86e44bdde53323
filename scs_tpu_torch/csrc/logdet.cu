// The logarithmic (vector) cone projection of the log-determinant cone:
// damped Newton, SCS's KKT gate, and the primal-dual IPM in both variants
// for the cones that fail it.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA
// (scs_tpu/cones/spectral.py: log_cone_newton :193, check_logdet_opt
// :346, log_cone_ipm :385, the cascade :700-766), which compiles each
// loop into one program. In PyTorch the same loops are thousands of small
// launches: one Newton iteration is ~220 kernels over all cones, one IPM
// iteration ~1200, and the IPM often runs its full 100 iterations on the
// cones that need it, so a projection that needs the IPM would cost ~10^5
// launches.
//
// What bounds it on an H100: neither bytes nor the card's peak rate. Each
// cone reads n + 2 values and writes n + 3, but runs up to 100 Newton
// iterations (each a line search of up to 61 trial points of n logs) and,
// where the gate fails, up to 2 x 100 IPM iterations (two structured KKT
// solves of three refinement passes and two line searches of up to 60
// merit evaluations each), all dependent: the slowest cone's chain of
// dependent steps sets the launch time. At 1024 cones of order 6, 3 IPM
// cones took 3.09 ms of a 3.10 ms launch and the Newton-only cones 0.49
// ms, in the earlier design of one warp a cone with every vector in a
// global scratch (PERF.md, tools/torch_logdet_chain.py); inside a cone,
// the two KKT solves and the two line searches take about a third of an
// IPM iteration each (tools/torch_logdet_profile.py reads the stages'
// cycles).
//
// What the design does about that chain:
//
// (a) A cone's vectors (every (n + 3)-vector of the cascade, indexed
//     (t, v, x_0 .. x_{n-1}, r): entry 1 is Newton's v, entries 2 ..
//     n + 1 its x) are held by a group of G lanes, lane l holding entries
//     l, l + G, ... in E "slots". The kernel is built for E = 1 and 2
//     (n + 3 <= 32 and <= 64), which keep the vectors in registers, and
//     for E = 0, which keeps them in shared memory (or, for a cone too
//     large for 227 KB, in a global scratch), each warp its own copy;
//     and for each G (below) as a compile-time constant, which folds the
//     butterflies' steps and every slot's entry. Lanes exchange single
//     entries by shuffles.
// (b) G is the least power of two >= n + 3, at most 32, so a sum over a
//     cone takes log2 G shuffle steps, written out. A cone has Q groups,
//     each a full copy of its vectors that computes every scalar of the
//     cascade: the sums are butterflies, which leave every lane of a group
//     the same value bit for bit, so all groups take the same branches.
//     They differ only in the line searches, where group q evaluates trial
//     point k0 + q: Q consecutive trial points at once, the first that
//     passes chosen by __ballot_sync (across the warps of a block through
//     shared memory). The trial steps are multiplied out in index order,
//     as the serial search and the plain version's cumprod form them, so
//     the step taken is the serial search's. Where n + 3 <= 32 the 32 / G
//     groups of one warp take a cone; beyond, a block of W warps takes it,
//     one group each.
// (c) The IPM runs in a launch of its own: the Newton + gate launch
//     appends the cones that fail the gate to a device list, and the IPM
//     launch, one block of four warps a cone (8 trial points at once at
//     n = 6, against 2 in the Newton launch), runs over that list. Its
//     grid is sized from the count of cones; blocks beyond the list return
//     at once. Each cone's arithmetic is independent of its place in the
//     list. (With the IPM in the Newton launch, two trial points at a
//     time, its cones still took the whole launch, and it ran longer:
//     PERF.md.)
// Within a step, every lane runs the same instructions: the entries of a
// lane that are special (t, v, r) or past the cone take selects, not
// branches (a branch on which a warp's lanes diverge runs each side in
// turn), and every slot holds a finite value (0 past the cone). A divisor
// fixed for an IPM iteration (coeff, z0, Tp1, R20, R11, R02) or a Newton
// iteration (the Hessian's diagonal) is inverted once and multiplied by:
// the divisions are most of the KKT solves' chain.
//
// The arithmetic follows the plain version (`scs_tpu_torch/cones/
// spectral.py`) operation for operation but for those reciprocals (one
// rounding more each) and the sums' order (a tree of shuffles), so the
// two agree to round-off where Newton converges inside its cap; where
// Newton stops at its 100-iteration cap or at v's floor, or the IPM runs,
// round-off moves the point within the gate's tolerance (both pass the
// gate), and may change the IPM's iteration count: an IPM cone near its
// stopping test may run 30 iterations on one build and its cap of 100 on
// another. The results repeat bit for bit from run to
// run: no sum depends on timing, and a line search takes the first
// passing index whatever Q is.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// log_cone_Newton.c:20-31
constexpr int kLcMaxIter = 100;
constexpr double kLcAlpha = 0.01;
constexpr double kLcBeta = 0.8;
constexpr double kLcTol = 1e-12;
constexpr int kLcMaxGradSteps = 5;
constexpr double kLcMinInit = 1.0;
constexpr double kLcMinDenom = 1e-14;
constexpr double kLcMinX = 1e-17;
constexpr double kLcMinV = 1e-14;
constexpr double kLcLsRelTol = 1e-14;
constexpr int kLcMaxLs = 60;
// log_cone_wrapper.c:8-12
constexpr double kLwDualFeasTol = 1e-2;
constexpr double kLwPriFeasTol = 1e-2;
constexpr double kLwCompTol = 1e-2;
constexpr double kLwDualTThreshold = 1e-8;
constexpr double kLwDualXThreshold = 1e-8;
// log_cone_IPM.c:20-27
constexpr double kIpmFeasTol = 1e-7;
constexpr double kIpmAbsTol = 1e-7;
constexpr double kIpmRelTol = 1e-6;
constexpr int kIpmMaxIter = 100;
constexpr double kIpmBeta = 0.5;
constexpr double kIpmStep = 0.99;
constexpr double kIpmAlpha = 0.01;
constexpr int kIpmMaxRelaxed = 8;
constexpr int kIpmMaxLs = 60;

// arrays of the E = 0 layout (memory), each of 32 x slots doubles a warp;
// Newton's five share their places with the IPM's first five
enum {
  kX0, kBase, kXp,                                 // the cone
  kX = 3, kGrad, kD, kW, kDu,                      // Newton
  kU1 = 3, kSu1, kSdu1, kG0, kG1, kG0s, kG1s, kGc0, kGc1, kRx, kDua, kDuc,
  kBnew, kRes, kGres, kTmp, kXinv, kTp1, kTp2, kRTp1,  // IPM
  kArrays
};

// what a launch runs
enum { kNewtonGate, kIpmList };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 128;

__device__ __forceinline__ double sq(double x) { return x * x; }

// one vector of the cone: E slots of this lane in registers...
template <int E> struct Vec {
  double s[E];
  __device__ __forceinline__ double& operator[](int j) { return s[j]; }
  __device__ __forceinline__ double operator[](int j) const { return s[j]; }
};
// ... or (E = 0) in memory, slot j of this lane at p[32 j]
template <> struct Vec<0> {
  double* p;
  __device__ __forceinline__ double& operator[](int j) { return p[j * 32]; }
  __device__ __forceinline__ double operator[](int j) const {
    return p[j * 32];
  }
};

// a group of G lanes holding one copy of a cone; Q groups a cone
template <int E> struct Grp {
  int n, m;       // order, m = n + 3 entries a vector
  int G, lg;      // lanes a group, log2 G
  int l, lb;      // this lane in its group, the group's first lane
  int q, Q, W;    // this group, groups a cone, warps a cone
  int ne;         // slots a lane
  double* mem;    // E = 0: this lane's slot 0 of array 0
  int stride;     // E = 0: doubles an array of a warp
  double* xch;    // W > 1: line-search exchange, 2 x 32 x 4
  int parity;

  __device__ __forceinline__ Vec<E> vec(int a) const {
    if constexpr (E > 0) {
      (void)a;
      return Vec<E>{};
    } else {
      return Vec<0>{mem + a * stride};
    }
  }

  // f(slot, entry) for this lane's entries below lim
  template <class F> __device__ __forceinline__ void each(int lim, F f) const {
    if constexpr (E > 0) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int i = l + j * G;
        if (i < lim) f(j, i);
      }
    } else {
      for (int j = 0; j < ne; ++j) {
        const int i = l + j * 32;
        if (i < lim) f(j, i);
      }
    }
  }

  // f(slot, entry) for every slot of this lane, entries past the cone's
  // included: the hot loops run every lane through the same instructions
  // and mask those entries with selects (a divergent branch costs more
  // than its arithmetic; every slot holds a finite value, 0 past the cone)
  template <class F> __device__ __forceinline__ void every(F f) const {
    if constexpr (E > 0) {
#pragma unroll
      for (int j = 0; j < E; ++j) f(j, l + j * G);
    } else {
      for (int j = 0; j < ne; ++j) f(j, l + j * 32);
    }
  }

  // sums, minima and maxima over the group by a butterfly: every lane
  // ends with the same value, bit for bit. The steps are written out (G
  // >= 4): a loop over them costs more than the shuffles.
  template <class Op>
  __device__ __forceinline__ double reduce(double x, Op op) const {
    if (G == 32) x = op(x, __shfl_xor_sync(kFull, x, 16));
    if (G >= 16) x = op(x, __shfl_xor_sync(kFull, x, 8));
    if (G >= 8) x = op(x, __shfl_xor_sync(kFull, x, 4));
    x = op(x, __shfl_xor_sync(kFull, x, 2));
    return op(x, __shfl_xor_sync(kFull, x, 1));
  }
  __device__ __forceinline__ double sum(double x) const {
    return reduce(x, [](double a, double b) { return a + b; });
  }
  __device__ __forceinline__ double min(double x) const {
    return reduce(x, [](double a, double b) { return fmin(a, b); });
  }
  __device__ __forceinline__ double max(double x) const {
    return reduce(x, [](double a, double b) { return fmax(a, b); });
  }
  // every group of the warp holds the same cone, so the warp's vote is
  // the group's
  __device__ __forceinline__ bool all(bool p) const {
    return __all_sync(kFull, p);
  }

  // entry k of v, to every lane (k the same in all lanes)
  __device__ __forceinline__ double at(const Vec<E>& v, int k) const {
    double x = 0;
    if constexpr (E > 0) {
      const int j = k >> lg;
#pragma unroll
      for (int s = 0; s < E; ++s)
        if (s == j) x = v[s];
    } else {
      x = v[k >> 5];
    }
    return __shfl_sync(kFull, x, lb + (k & (G - 1)));
  }

  // The first group of the cone with `take` set, its (st, a, b) to every
  // lane; false where no group takes.
  __device__ __forceinline__ bool pick(bool take, double& st, double& a,
                                       double& b) {
    if (Q == 1) return take;
    const unsigned lead = __ballot_sync(kFull, take && l == 0);
    if (W == 1) {
      if (!lead) return false;
      const int src = __ffs(lead) - 1;
      st = __shfl_sync(kFull, st, src);
      a = __shfl_sync(kFull, a, src);
      b = __shfl_sync(kFull, b, src);
      return true;
    }
    // two buffers in turn: a buffer is written again only after the next
    // pick's barrier, which every warp passes after reading it
    double* x = xch + parity * 128;
    parity ^= 1;
    if (l == 0) {
      x[4 * q] = take ? 1.0 : 0.0;
      x[4 * q + 1] = st;
      x[4 * q + 2] = a;
      x[4 * q + 3] = b;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const unsigned any = __ballot_sync(kFull, lane < Q && x[4 * lane] != 0);
    if (!any) return false;
    const int s = __ffs(any) - 1;
    st = x[4 * s + 1];
    a = x[4 * s + 2];
    b = x[4 * s + 3];
    return true;
  }

  // The backtracking line search over steps step0 beta^k, k = 0, 1, ...
  // (multiplied out one factor at a time in k's order): the first k < N
  // whose eval(step, &a, &b) passes, else k = N untested. Group q
  // evaluates k0 + q. Returns the step; a, b what eval gave there.
  template <class F>
  __device__ __forceinline__ double search(double step0, double beta, int N,
                                           F eval, double* a, double* b) {
    double base = step0;
    for (int k0 = 0;; k0 += Q) {
      double st = base;
      for (int i = 0; i < q; ++i) st = st * beta;
      double va = 0, vb = 0;
      const bool ok = eval(st, &va, &vb);
      const int k = k0 + q;
      if (pick(k < N ? ok : k == N, st, va, vb)) {
        *a = va;
        *b = vb;
        return st;
      }
      for (int i = 0; i < Q; ++i) base = base * beta;
    }
  }
};

// ---- damped Newton (log_cone_Newton.c:58-302; spectral.py:193-323) ----

template <int E>
__device__ __forceinline__ double newton_obj(const Grp<E>& g,
                                             const Vec<E>& X,
                                             const Vec<E>& du,
                                             const Vec<E>& X0, double safe_v,
                                             double du_v, double step,
                                             double t0, double v0) {
  const double vn = fmax(safe_v + step * du_v, kLcMinV);
  double sumlog = 0, dist = 0;
  g.every([&](int j, int i) {
    const bool x = i >= 2 && i < g.n + 2;
    const double xn = fmax(X[j] + step * du[j], kLcMinX);
    sumlog += log(x ? xn : 1.0);
    dist += x ? sq(xn - X0[j]) : 0.0;
  });
  sumlog = g.sum(sumlog);
  dist = g.sum(dist);
  const double sx = -(vn * sumlog - double(g.n) * vn * log(vn));
  return 0.5 * sq(sx - t0) + 0.5 * sq(vn - v0) + 0.5 * dist;
}

template <int E>
__device__ __forceinline__ int newton(Grp<E>& g, const Vec<E>& X0,
                                      Vec<E>& Xp, double t0, double v0,
                                      double* t_out, double* v_out) {
  const int n = g.n, lim = n + 2;   // entries 1 (v) .. n + 1 (x)
  const double nf = double(n);
  Vec<E> X = g.vec(kX), grad = g.vec(kGrad), d = g.vec(kD), w = g.vec(kW),
         du = g.vec(kDu);
  bool all_pos = true, all_nonneg = true, all_neg = true;
  double sumlog_x0 = 0, sumlog_ratio = 0;
  g.each(lim, [&](int j, int i) {
    if (i < 2) return;
    const double x = X0[j];
    all_pos &= x > 0;
    all_nonneg &= x >= 0;
    all_neg &= x < 0;
    sumlog_x0 += log(x > 0 ? x : 1.0);
    const double ratio = (x < 0 && t0 < 0) ? x / t0 : 1.0;
    sumlog_ratio += log(ratio);
  });
  all_pos = g.all(all_pos);
  all_nonneg = g.all(all_nonneg);
  all_neg = g.all(all_neg);
  sumlog_x0 = g.sum(sumlog_x0);
  sumlog_ratio = g.sum(sumlog_ratio);
  bool in_cone = v0 > 0 && all_pos &&
                 -v0 * (sumlog_x0 - nf * log(v0 > 0 ? v0 : 1.0)) <= t0;
  in_cone |= v0 == 0 && all_nonneg && t0 >= 0;
  const double dual_sum = t0 * (-nf - sumlog_ratio);
  const bool in_neg_dual = t0 < 0 && all_neg && v0 <= dual_sum;
  const bool analytic = v0 <= 0 && t0 >= 0;

  double v = fmax(v0, kLcMinInit);
  double obj_old;
  {
    double sumlog = 0, dist = 0;
    g.each(lim, [&](int j, int i) {
      if (i < 2) return;
      X[j] = fmax(X0[j], kLcMinInit);
      sumlog += log(X[j]);
      dist += sq(X[j] - X0[j]);
    });
    sumlog = g.sum(sumlog);
    dist = g.sum(dist);
    const double sx = -(v * sumlog - nf * v * log(v));
    obj_old = 0.5 * sq(sx - t0) + 0.5 * sq(v - v0) + 0.5 * dist;
  }
  int it = 0, ngrad = 0;
  bool done = false, failed = false;
  while (it < kLcMaxIter && !done && !failed) {
    failed |= v < kLcMinV;
    const double safe_v = fmax(v, kLcMinV);
    double sumlog = 0;
    g.every([&](int j, int i) {
      const bool x = i >= 2 && i < lim;
      X[j] = x ? fmax(X[j], kLcMinX) : 1.0;
      sumlog += log(X[j]);
    });
    sumlog = g.sum(sumlog);
    const double temp0 = -sumlog + nf * log(safe_v);
    const double a = safe_v * temp0 - t0;
    const double cc = temp0 + nf;
    const double v_inv = 1.0 / safe_v;
    const double av = a * safe_v;
    // entry 1 (v)
    const double grad_v = a * cc + safe_v - v0;
    const double d_v =
        1.0 + a * (-a * v_inv * v_inv + nf * v_inv - 2.0 * cc * v_inv);
    const double w_v = -(a + safe_v * cc) * v_inv;
    double nominator = 0, wt = 0;
    g.every([&](int j, int i) {
      const bool in = i >= 1 && i < lim, vl = i == 1;
      const double x_inv = 1.0 / X[j];
      grad[j] = vl ? grad_v : in ? -av * x_inv + X[j] - X0[j] : 0.0;
      // d holds the reciprocal of the Hessian's diagonal
      d[j] = 1.0 / (vl ? d_v : in ? 1.0 + av * x_inv * x_inv : 1.0);
      w[j] = vl ? w_v : in ? safe_v * x_inv : 0.0;
      du[j] = -grad[j] * d[j];
      nominator += w[j] * du[j];
      wt += w[j] * (w[j] * d[j]);
    });
    nominator = g.sum(nominator);
    const double denominator = 1.0 + g.sum(wt);
    failed |= fabs(denominator) < kLcMinDenom;
    const double coef = -nominator / denominator;
    double dir_der = 0;
    g.every([&](int j, int) {
      du[j] = du[j] + coef * (w[j] * d[j]);
      dir_der += grad[j] * du[j];
    });
    dir_der = g.sum(dir_der);
    const bool use_grad = dir_der > 0;
    failed |= use_grad && ngrad >= kLcMaxGradSteps;
    ngrad += use_grad;
    if (use_grad) {
      double gg = 0;
      g.each(lim, [&](int j, int i) {
        if (i == 0) return;
        du[j] = -grad[j];
        gg += grad[j] * grad[j];
      });
      dir_der = -g.sum(gg);
    }
    const bool done_now = -dir_der <= 2.0 * kLcTol;
    if (!done_now && !failed) {
      // largest domain-feasible step
      double step = 1.0;
      g.every([&](int j, int i) {
        const bool neg = i >= 1 && i < lim && du[j] < 0;
        const double q = -0.99 * (i == 1 ? safe_v : X[j]) /
                         (neg ? du[j] : -1.0);
        step = fmin(step, neg ? q : 1.0);
      });
      step = g.min(step);
      const double du_v = g.at(du, 1);
      // backtracking: at most 61 trial steps, the last taken if none
      // passes
      double new_obj, unused;
      step = g.search(
          step, kLcBeta, kLcMaxLs,
          [&](double st, double* o, double*) {
            *o = newton_obj(g, X, du, X0, safe_v, du_v, st, t0, v0);
            return !((1.0 - kLcLsRelTol) * *o >
                     obj_old + kLcAlpha * st * dir_der);
          },
          &new_obj, &unused);
      v = safe_v + step * du_v;
      g.every([&](int j, int) { X[j] = X[j] + step * du[j]; });
      obj_old = new_obj;
    }
    done |= done_now;
    ++it;
  }
  double sumlog = 0;
  g.each(lim, [&](int j, int i) {
    if (i < 2) return;
    X[j] = fmax(X[j], kLcMinX);
    sumlog += log(X[j]);
  });
  sumlog = g.sum(sumlog);
  v = fmax(v, kLcMinV);
  const double t_n = -v * (sumlog - nf * log(v));
  g.each(lim, [&](int j, int i) {
    if (i < 2) return;
    Xp[j] = in_cone       ? X0[j]
            : in_neg_dual ? 0.0
            : analytic    ? fmax(X0[j], 0.0)
                          : X[j];
  });
  *t_out = in_cone ? t0 : in_neg_dual ? 0.0 : analytic ? t0 : t_n;
  *v_out = in_cone ? v0 : in_neg_dual ? 0.0 : analytic ? 0.0 : v;
  return it;
}

// ---- the KKT gate (log_cone_wrapper.c:47-204; spectral.py:346-378) ----

template <int E>
__device__ __forceinline__ bool gate(const Grp<E>& g, const Vec<E>& Xp,
                                     const Vec<E>& X0, double tp, double vp,
                                     double t0, double v0) {
  const double nf = double(g.n);
  double dualt = tp - t0;
  if (fabs(dualt) < kLwDualTThreshold) dualt = kLwDualTThreshold;
  const double dualv = vp - v0;
  double dx_xp = 0, dx_dx = 0, xp_xp = 0, slog_xp = 0, slog_dx = 0,
         neg_xp = 0, neg_dx = 0;
  bool xp_pos = true, dx_pos = true;
  g.each(g.n + 2, [&](int j, int i) {
    if (i < 2) return;
    const double xp = Xp[j];
    double dualx = xp - X0[j];
    if (fabs(dualx) < kLwDualXThreshold) dualx = kLwDualXThreshold;
    dx_xp += dualx * xp;
    dx_dx += dualx * dualx;
    xp_xp += xp * xp;
    xp_pos &= xp > 0;
    dx_pos &= dualx > 0;
    slog_xp += log(xp > 0 ? xp : 1.0);
    slog_dx += log(dualx > 0 ? dualx : 1.0);
    neg_xp += xp < 0 ? xp * xp : 0.0;
    neg_dx += dualx < 0 ? dualx * dualx : 0.0;
  });
  dx_xp = g.sum(dx_xp);
  dx_dx = g.sum(dx_dx);
  xp_xp = g.sum(xp_xp);
  slog_xp = g.sum(slog_xp);
  slog_dx = g.sum(slog_dx);
  neg_xp = g.sum(neg_xp);
  neg_dx = g.sum(neg_dx);
  xp_pos = g.all(xp_pos);
  dx_pos = g.all(dx_pos);
  const double comp = tp * dualt + vp * dualv + dx_xp;
  const double slog_vp = log(vp > 0 ? vp : 1.0);
  const double pri_res =
      (vp > 0 && xp_pos) ? -vp * (slog_xp - nf * slog_vp) - tp
                         : vp * vp + (tp < 0 ? tp * tp : 0.0) + neg_xp;
  const double slog_dt = log(dualt > 0 ? dualt : 1.0);
  const double dual_res =
      (dualt > 0 && dx_pos)
          ? dualt * (nf * slog_dt - nf - slog_dx) - dualv
          : dualt * dualt + (dualv < 0 ? dualv * dualv : 0.0) + neg_dx;
  const double dual_norm = sqrt(sq(dualt) + sq(dualv) + dx_dx);
  const double pri_norm = sqrt(sq(tp) + sq(vp) + xp_xp);
  const double pn1 = fmax(pri_norm, 1.0);
  const double dres = dual_res / fmax(dual_norm, 1.0);
  const double pres = pri_res / pn1;
  const double cres = comp / fmax(pn1, dual_norm);
  return tp >= t0 - 0.1 * fabs(t0) && dres < kLwDualFeasTol &&
         pres < kLwPriFeasTol && fabs(cres) < kLwCompTol;
}

// ---- the IPM (log_cone_IPM.c:338-713; spectral.py:385-697) ----

template <int E> struct Ipm {
  Grp<E>& g;
  const Vec<E>& Base;   // (t0, v0, x0) / scale
  int n, ri;            // ri = n + 2, the index of r
  double scale;
  Vec<E> U1, Su1, Sdu1, G0, G1, G0s, G1s, Gc0, Gc1, Rx, Dua, Duc, Bnew,
      Res, Gres, Tmp, Xinv, Tp1, Tp2, RTp1;
  double z[3], s[3], r, w[3], lm[3];
  double R00, R01, R02, R10, R11, R20, coeff, v;
  // reciprocals of the divisors fixed for an iteration
  double rz0, rcoeff, rR20, rR11, rR02;

  __device__ __forceinline__ Ipm(Grp<E>& g_, const Vec<E>& base, double sc)
      : g(g_), Base(base), n(g_.n), ri(g_.n + 2), scale(sc),
        U1(g_.vec(kU1)), Su1(g_.vec(kSu1)), Sdu1(g_.vec(kSdu1)),
        G0(g_.vec(kG0)), G1(g_.vec(kG1)), G0s(g_.vec(kG0s)),
        G1s(g_.vec(kG1s)), Gc0(g_.vec(kGc0)), Gc1(g_.vec(kGc1)),
        Rx(g_.vec(kRx)), Dua(g_.vec(kDua)), Duc(g_.vec(kDuc)),
        Bnew(g_.vec(kBnew)), Res(g_.vec(kRes)), Gres(g_.vec(kGres)),
        Tmp(g_.vec(kTmp)), Xinv(g_.vec(kXinv)), Tp1(g_.vec(kTp1)),
        Tp2(g_.vec(kTp2)), RTp1(g_.vec(kRTp1)) {}

  // (phi, gap) of the merit function at (u1 + st du, rr + st dr, zz + st
  // dz, ss + st ds); u0, uv are entries 0 and 1 of u1, d0, dv, dr those of
  // du and its entry ri
  __device__ __forceinline__ void merit(
      double st, const Vec<E>& u1, double u0, double uv, double rr,
      const double* zz, const double* ss, const Vec<E>& du, double d0,
      double dv, double dr, const double* dz, const double* ds, double th1,
      double th2, double th3, double* phi, double* gap) const {
    const double nf = double(n);
    double zn[3], sn[3];
    for (int j = 0; j < 3; ++j) {
      zn[j] = zz[j] + st * dz[j];
      sn[j] = ss[j] + st * ds[j];
    }
    const double rn = rr + st * dr;
    double slog = 0, dd = 0;
    g.every([&](int j, int i) {
      const double ui = u1[j] + st * du[j];
      dd += i < ri ? sq(ui - Base[j]) : 0.0;
      slog += log(i >= 2 && i < ri ? ui : 1.0);
    });
    dd = g.sum(dd);
    slog = g.sum(slog);
    const double un0 = u0 + st * d0, un1 = uv + st * dv;
    slog = slog - nf * log(un1);
    const double f0 = 0.5 * dd - rn, f1 = -un1 * slog - un0, f2 = -un1;
    // rx = z0 g0 + z1 g1, then rx[1] -= z2, rx[ri] += 1
    double rx2 = 0;
    g.every([&](int j, int i) {
      // entries 0 and 1 of u1 + st du are un0 and un1
      const double ui = u1[j] + st * du[j];
      const double q = -un1 / (i >= 2 && i < ri ? ui : 1.0);
      const double g0 = i == ri ? -1.0 : ui - Base[j];
      const double g1 = i == ri  ? 0.0
                        : i == 0 ? -1.0
                        : i == 1 ? nf - slog
                                 : q;
      double rx = zn[0] * g0 + zn[1] * g1;
      rx = i == 1 ? rx - zn[2] : rx;
      rx = i == ri ? rx + 1.0 : rx;
      rx2 += i <= ri ? rx * rx : 0.0;
    });
    rx2 = g.sum(rx2);
    const double rz2 = sq(f0 + sn[0]) + sq(f1 + sn[1]) + sq(f2 + sn[2]);
    *gap = zn[0] * sn[0] + zn[1] * sn[1] + zn[2] * sn[2];
    *phi = th1 * *gap + th2 * sqrt(rx2) + th3 * sqrt(rz2);
  }

  __device__ __forceinline__ void ginv(const Vec<E>& b, Vec<E>& out) const {
    double acc = 0;
    g.every([&](int j, int i) {
      acc += i >= 2 && i < ri ? b[j] * Tp2[j] : 0.0;
    });
    acc = g.sum(acc);
    const double y1 = (g.at(b, 1) + z[1] * acc) * rcoeff;
    g.every([&](int j, int i) {
      const bool x = i >= 2 && i < ri;
      const double q = (x ? b[j] + z[1] * y1 * Xinv[j] : b[j]) *
                       (x ? RTp1[j] : rz0);
      out[j] = i == 1 ? y1 : i == ri ? -b[j] : i < ri ? q : 0.0;
    });
  }

  // out = G du + C C' du
  __device__ __forceinline__ void gapply_cct(const Vec<E>& du,
                                             Vec<E>& out) const {
    const double nf = double(n);
    double c0 = 0, c1 = 0, xd = 0;
    g.every([&](int j, int i) {
      c0 += i <= ri ? G0s[j] * du[j] : 0.0;
      c1 += i <= ri ? G1s[j] * du[j] : 0.0;
      xd += i >= 2 && i < ri ? Xinv[j] * du[j] : 0.0;
    });
    c0 = g.sum(c0);
    c1 = g.sum(c1);
    xd = g.sum(xd);
    const double du1 = g.at(du, 1);
    const double a1 = z[0] + 1.0 / (w[2] * w[2]), nfv = nf / v;
    g.every([&](int j, int i) {
      const double xi = Xinv[j];
      const double gx =
          z[0] * du[j] + z[1] * (-du1 * xi + v * du[j] * xi * xi);
      const double gd = i == 0    ? z[0] * du[j]
                        : i == 1  ? a1 * du[j] + z[1] * (nfv * du[j] - xd)
                        : i == ri ? -du[j]
                                  : gx;
      double c = c0 * G0s[j] + c1 * G1s[j];
      c = i == ri ? c + du[j] : c;
      out[j] = i <= ri ? gd + c : 0.0;
    });
  }

  // KKT_solve (:202-331): rhs1 = f * [-rx; -rznl], rhs2; out = (du1, dr)
  __device__ __forceinline__ void kkt_solve(double f, const double* rznl,
                                            const double* rhs2, Vec<E>& out,
                                            double* dz, double* ds) {
    double tail[3];
    for (int j = 0; j < 3; ++j)
      tail[j] = f * -rznl[j] - w[j] * (rhs2[j] / lm[j]);
    const double t0w = tail[0] / w[0], t1w = tail[1] / w[1],
                 b1 = -tail[2] / (w[2] * w[2]);
    g.every([&](int j, int i) {
      double b = f * -Rx[j] + t0w * G0s[j] + t1w * G1s[j];
      b = i == 1 ? b + b1 : b;
      b = i <= ri ? b : 0.0;
      Bnew[j] = b;
      Res[j] = b;
      out[j] = 0.0;
    });
    for (int pass = 0; pass < 3; ++pass) {
      ginv(Res, Gres);
      double CT0 = 0, CT1 = 0;
      g.every([&](int j, int i) {
        CT0 += i <= ri ? G0s[j] * Gres[j] : 0.0;
        CT1 += i <= ri ? G1s[j] * Gres[j] : 0.0;
      });
      CT0 = g.sum(CT0);
      CT1 = g.sum(CT1);
      const double CT2 = g.at(Gres, ri);
      const double q0 = CT2 * rR20;
      const double q1 = (CT1 - R10 * q0) * rR11;
      const double q2 = (CT0 - R00 * q0 - R01 * q1) * rR02;
      g.every([&](int j, int i) {
        double dd = Gres[j] - q0 * Gc0[j] - q1 * Gc1[j];
        dd = i == ri ? dd + q2 : dd;
        out[j] = i <= ri ? out[j] + dd : 0.0;
      });
      gapply_cct(out, Tmp);
      g.every([&](int j, int) { Res[j] = Bnew[j] - Tmp[j]; });
    }
    double c0 = 0, c1 = 0;
    g.every([&](int j, int i) {
      c0 += i <= ri ? G0s[j] * out[j] : 0.0;
      c1 += i <= ri ? G1s[j] * out[j] : 0.0;
    });
    c0 = g.sum(c0);
    c1 = g.sum(c1);
    dz[0] = tail[0] + -w[0] * c0;
    dz[1] = tail[1] + -w[1] * c1;
    dz[2] = tail[2] + g.at(out, 1);
    for (int j = 0; j < 3; ++j) {
      dz[j] = -dz[j] / (w[j] * w[j]);
      ds[j] = w[j] * (rhs2[j] / lm[j] - w[j] * dz[j]);
    }
  }

  // find_max_step_size (:90-126), with the halving of spectral.py:541-545
  __device__ __forceinline__ double max_step(const Vec<E>& du,
                                             const double* dz,
                                             const double* ds) const {
    double smz = 10.0, sms = 10.0;
    for (int j = 0; j < 3; ++j) {
      smz = fmin(smz, dz[j] < 0 ? -z[j] / dz[j] : 10.0);
      sms = fmin(sms, ds[j] < 0 ? -s[j] / ds[j] : 10.0);
    }
    const double sm = fmin(fmin(smz, sms), 10.0);
    double dom = 10.0;
    g.every([&](int j, int i) {
      const bool neg = i >= 1 && i < ri && du[j] < 0;
      const double q = -U1[j] / (neg ? du[j] : -1.0);
      dom = fmin(dom, neg ? q : 10.0);
    });
    dom = g.min(dom);
    double step = fmin(kIpmStep * sm, 1.0);
    if (step > dom) {
      if (dom > 0) {
        while (step > dom) step = step * 0.5;
      } else {
        step = 0.0;
      }
    }
    return step;
  }

  // log_cone_ipm's loop; the result into (t, v, Xp) (scaled back)
  __device__ __forceinline__ void run(bool mehrotra, double* t_out,
                                      double* v_out, Vec<E>& Xp) {
    const double nf = double(n);
    g.each(ri + 1, [&](int j, int i) {
      U1[j] = i < ri ? 1.0 : 0.0;
      Su1[j] = i < ri ? 1.0 : 0.0;
      Sdu1[j] = 0.0;
    });
    for (int j = 0; j < 3; ++j) z[j] = s[j] = 1.0;
    r = 0;
    double sv_r = 0, sv_z[3] = {1, 1, 1}, sv_s[3] = {1, 1, 1},
           sv_dz[3] = {0, 0, 0}, sv_ds[3] = {0, 0, 0}, sv_phi = 0,
           sv_dphi = 0, sv_step = 0;
    double th1 = 1, th2 = 1, th3 = 1, pres0 = 1, dres0 = 1;
    int relaxed = 0;
    for (int it = 0; it < kIpmMaxIter; ++it) {
      v = g.at(U1, 1);
      const double u0 = g.at(U1, 0);
      // oracle and residuals at the iterate
      double slog = 0, dd = 0;
      g.every([&](int j, int i) {
        const double du = U1[j] - Base[j];
        dd += i < ri ? du * du : 0.0;
        G0[j] = i < ri ? du : 0.0;
        slog += log(i >= 2 && i < ri ? U1[j] : 1.0);
      });
      slog = g.sum(slog) - nf * log(v);
      dd = g.sum(dd);
      const double f[3] = {0.5 * dd - r, -v * slog - u0, -v};
      double rx2 = 0;
      g.every([&](int j, int i) {
        const bool x = i >= 2 && i < ri;
        const double q = -v / (x ? U1[j] : 1.0);
        G0[j] = i == ri ? -1.0 : G0[j];
        const double g1 = i == 0   ? -1.0
                          : i == 1 ? nf - slog
                          : x      ? q
                                   : 0.0;
        G1[j] = g1;
        double rx = z[0] * G0[j] + z[1] * g1;
        rx = i == 1 ? rx - z[2] : rx;
        rx = i == ri ? rx + 1.0 : rx;
        rx = i <= ri ? rx : 0.0;
        Rx[j] = rx;
        rx2 += rx * rx;
      });
      rx2 = g.sum(rx2);
      const double rznl[3] = {f[0] + s[0], f[1] + s[1], f[2] + s[2]};
      const double gap = z[0] * s[0] + z[1] * s[1] + z[2] * s[2];
      const double mu = gap / 3.0;
      const double dres_raw = sqrt(rx2);
      const double pres_raw = sqrt(sq(rznl[0]) + sq(rznl[1]) + sq(rznl[2]));
      if (it == 0) {
        pres0 = fmax(pres_raw, 1.0);
        dres0 = fmax(dres_raw, 1.0);
        th1 = 1.0 / gap;
        th2 = 1.0 / dres0;
        th3 = 1.0 / pres0;
      }
      const double relgap = gap / fmax(r, 1.0);
      if (dres_raw / dres0 < kIpmFeasTol && pres_raw / pres0 < kIpmFeasTol &&
          (gap < kIpmAbsTol || relgap <= kIpmRelTol))
        break;
      for (int j = 0; j < 3; ++j) {
        w[j] = sqrt(s[j] / z[j]);
        lm[j] = sqrt(s[j] * z[j]);
      }
      // structured KKT factor (KKT_precompute, :149-200)
      double acc = 0;
      g.every([&](int j, int i) {
        const bool x = i >= 2 && i < ri;
        G0s[j] = G0[j] / w[0];
        G1s[j] = G1[j] / w[1];
        const double xi = 1.0 / (x ? U1[j] : 1.0);
        Xinv[j] = xi;
        Tp1[j] = z[0] + z[1] * v * xi * xi;
        RTp1[j] = 1.0 / Tp1[j];
        Tp2[j] = xi * RTp1[j];
        acc += x ? xi * xi * RTp1[j] : 0.0;
      });
      coeff = z[0] + 1.0 / (w[2] * w[2]) + z[1] * nf / v -
              sq(z[1]) * g.sum(acc);
      rcoeff = 1.0 / coeff;
      rz0 = 1.0 / z[0];
      ginv(G0s, Gc0);
      ginv(G1s, Gc1);
      double a00 = 0, a01 = 0, a10 = 0, a11 = 0;
      g.every([&](int j, int i) {
        a00 += i <= ri ? G0s[j] * Gc0[j] : 0.0;
        a01 += i <= ri ? G0s[j] * Gc1[j] : 0.0;
        a10 += i <= ri ? G1s[j] * Gc0[j] : 0.0;
        a11 += i <= ri ? G1s[j] * Gc1[j] : 0.0;
      });
      R00 = 1.0 + g.sum(a00);
      R01 = g.sum(a01);
      R02 = -g.at(G0s, ri);
      R10 = g.sum(a10);
      R11 = 1.0 + g.sum(a11);
      R20 = g.at(Gc0, ri);
      rR20 = 1.0 / R20;
      rR11 = 1.0 / R11;
      rR02 = 1.0 / R02;

      const double phi = th1 * gap + th2 * dres_raw + th3 * pres_raw;
      const double dphi = -phi;
      const double rhs2_aff[3] = {-(lm[0] * lm[0]), -(lm[1] * lm[1]),
                                  -(lm[2] * lm[2])};
      // affine pass: direction and centering parameter; 60 trial steps,
      // the 61st taken if none passes
      double dz_a[3], ds_a[3];
      kkt_solve(1.0, rznl, rhs2_aff, Dua, dz_a, ds_a);
      double gap_a, phi_a;
      {
        const double d0 = g.at(Dua, 0), dv = g.at(Dua, 1),
                     dr = g.at(Dua, ri);
        g.search(
            max_step(Dua, dz_a, ds_a), kIpmBeta, kIpmMaxLs,
            [&](double st, double* ph, double* gp) {
              merit(st, U1, u0, v, r, z, s, Dua, d0, dv, dr, dz_a, ds_a, th1,
                    th2, th3, ph, gp);
              return *ph <= (1.0 - kIpmAlpha * st) * phi;
            },
            &phi_a, &gap_a);
      }
      double sigma = gap_a / gap;
      sigma = sigma < 1.0 ? sigma * sigma * sigma : sigma;
      // corrector / search direction
      double rhs2_c[3], dz_c[3], ds_c[3];
      for (int j = 0; j < 3; ++j)
        rhs2_c[j] = mehrotra ? rhs2_aff[j] + (sigma * mu - ds_a[j] * dz_a[j])
                             : rhs2_aff[j] + 0.0;
      kkt_solve(mehrotra ? 1.0 - sigma : 1.0, rznl, rhs2_c, Duc, dz_c, ds_c);
      double step = max_step(Duc, dz_c, ds_c);

      // nonmonotone line search (log_cone_IPM.c:640-692): its first
      // evaluation runs the relaxed-window state machine; where it is left
      // backtracking (plain mode, or the saved iterate restored), the
      // remaining evaluations are a plain backtracking search
      const double c0 = g.at(Duc, 0), cv = g.at(Duc, 1), cr = g.at(Duc, ri);
      bool restored = false;
      double unused_a, unused_b;
      if (relaxed == -1) {
        // plain mode: 60 trial steps from step, the 61st if none passes
        step = g.search(
            step, kIpmBeta, kIpmMaxLs,
            [&](double st, double* ph, double* gp) {
              merit(st, U1, u0, v, r, z, s, Duc, c0, cv, cr, dz_c, ds_c, th1,
                    th2, th3, ph, gp);
              return *ph <= phi + kIpmAlpha * st * dphi;
            },
            &unused_a, &unused_b);
      } else {
        double phi_n, gdummy;
        merit(step, U1, u0, v, r, z, s, Duc, c0, cv, cr, dz_c, ds_c, th1, th2,
              th3, &phi_n, &gdummy);
        const bool armijo = phi_n <= phi + kIpmAlpha * step * dphi;
        const bool armijo0 =
            phi_n <= sv_phi + kIpmAlpha * sv_step * sv_dphi;
        if (relaxed == 0) {
          if (!armijo) {
            relaxed = 1;
            g.each(ri + 1, [&](int j, int i) {
              if (i < ri) Su1[j] = U1[j];
              Sdu1[j] = Duc[j];
            });
            sv_r = r;
            for (int j = 0; j < 3; ++j) {
              sv_z[j] = z[j];
              sv_s[j] = s[j];
              sv_dz[j] = dz_c[j];
              sv_ds[j] = ds_c[j];
            }
            sv_phi = phi;
            sv_dphi = dphi;
            sv_step = step;
          }
        } else if (relaxed < kIpmMaxRelaxed) {
          relaxed = armijo0 ? 0 : relaxed + 1;
        } else if (!armijo0) {
          // restore the saved iterate: 59 trial steps from sv_step, the
          // 60th if none passes
          restored = true;
          relaxed = -1;
          const double s0 = g.at(Su1, 0), sv = g.at(Su1, 1),
                       d0 = g.at(Sdu1, 0), dv = g.at(Sdu1, 1),
                       dr = g.at(Sdu1, ri);
          step = g.search(
              sv_step, kIpmBeta, kIpmMaxLs - 1,
              [&](double st, double* ph, double* gp) {
                merit(st, Su1, s0, sv, sv_r, sv_z, sv_s, Sdu1, d0, dv, dr,
                      sv_dz, sv_ds, th1, th2, th3, ph, gp);
                return *ph <= sv_phi + kIpmAlpha * st * sv_dphi;
              },
              &unused_a, &unused_b);
        }
      }
      if (restored) {
        const double dr = g.at(Sdu1, ri);
        g.every([&](int j, int i) {
          U1[j] = i < ri ? Su1[j] + step * Sdu1[j] : 0.0;
        });
        r = sv_r + step * dr;
        for (int j = 0; j < 3; ++j) {
          z[j] = sv_z[j] + step * sv_dz[j];
          s[j] = sv_s[j] + step * sv_ds[j];
        }
      } else {
        g.every([&](int j, int i) {
          U1[j] = i < ri ? U1[j] + step * Duc[j] : 0.0;
        });
        r = r + step * cr;
        for (int j = 0; j < 3; ++j) {
          z[j] = z[j] + step * dz_c[j];
          s[j] = s[j] + step * ds_c[j];
        }
      }
    }
    *t_out = g.at(U1, 0) * scale;
    *v_out = g.at(U1, 1) * scale;
    g.each(ri, [&](int j, int i) {
      if (i >= 2) Xp[j] = U1[j] * scale;
    });
  }
};

// Launch `what` = kNewtonGate: cone c = blockIdx.x * cpb + warp / W runs
// Newton and the gate, writes its result and info = Newton iterations,
// and appends itself to `list` (list[0] the count, the cones after it)
// where the gate fails. kIpmList: block b < list[0] takes cone
// list[1 + b], runs the IPM (variant 0, then 1 while the gate fails),
// writes its result and adds 1000 x variants to info. scratch: E = 0
// only, null where the arrays go to shared memory.
template <int E, int kG>
__global__ void __launch_bounds__(kMaxThreads)
logdet_cone_kernel(const double* __restrict__ t0_in,
                   const double* __restrict__ v0_in,
                   const double* __restrict__ x0_in,
                   double* __restrict__ t_out, double* __restrict__ v_out,
                   double* __restrict__ x_out, int* __restrict__ info,
                   double* scratch, int* list, long long count, int n, int W,
                   int cpb, int what) {
  __shared__ double xch[2 * 32 * 4];
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long c;
  if (what == kIpmList) {
    if (static_cast<int>(blockIdx.x) >= list[0]) return;
    c = list[1 + blockIdx.x];
  } else {
    c = static_cast<long long>(blockIdx.x) * cpb + warp / W;
    if (c >= count) return;  // a cone's warps leave together
  }
  const int wc = warp % W;   // this warp in its cone
  Grp<E> g;
  g.n = n;
  g.m = n + 3;
  // a constant through the inlined cascade: the butterflies' steps and
  // the slots' entries fold at compile time
  constexpr int G = kG;
  g.G = G;
  g.lg = G == 32 ? 5 : G == 16 ? 4 : G == 8 ? 3 : 2;
  g.l = lane & (G - 1);
  g.lb = lane & ~(G - 1);
  g.q = wc * (32 / G) + lane / G;
  g.Q = W * (32 / G);
  g.W = W;
  g.ne = E > 0 ? E : (g.m + 31) / 32;
  g.stride = g.ne * 32;
  g.xch = xch;
  g.parity = 0;
  g.mem = nullptr;
  if constexpr (E == 0) {
    const long long region = static_cast<long long>(kArrays) * g.stride;
    g.mem = (scratch ? scratch + (c * W + wc) * region : smem + wc * region) +
            g.l;
  }
  if constexpr (E == 0) {
    // every slot finite, 0 past the cone, as registers start
    for (int a = 0; a < kArrays; ++a)
      for (int j = 0; j < g.ne; ++j) g.mem[a * g.stride + j * 32] = 0.0;
  }
  const double t0 = t0_in[c], v0 = v0_in[c];
  Vec<E> X0 = g.vec(kX0), Xp = g.vec(kXp);
  g.each(g.m, [&](int j, int i) {
    X0[j] = (i >= 2 && i < n + 2) ? x0_in[c * n + i - 2] : 0.0;
  });
  double tp, vp;
  int its = 0, variants = 0;
  if (what == kNewtonGate) {
    its = newton(g, X0, Xp, t0, v0, &tp, &vp);
    if (!gate(g, Xp, X0, tp, vp, t0, v0) && g.q == 0 && g.l == 0)
      list[1 + atomicAdd(list, 1)] = static_cast<int>(c);
  } else {
    double scale = 0;
    g.each(n + 2, [&](int j, int i) {
      if (i >= 2) scale = fmax(scale, fabs(X0[j]));
    });
    scale = g.max(scale);  // the maximum is exact in any order
    scale = fmax(scale, fmax(t0, v0));
    scale = fmax(scale, 1e-100);
    Vec<E> Base = g.vec(kBase);
    const double b0 = t0 / scale, b1 = v0 / scale;
    g.each(g.m, [&](int j, int i) {
      Base[j] = i == 0 ? b0 : i == 1 ? b1 : i < n + 2 ? X0[j] / scale : 0.0;
    });
    Ipm<E> ipm(g, Base, scale);
    // variant 0 (Mehrotra), then variant 1 if the gate still fails; a
    // cone whose attempts all fail keeps the last (log_cone_wrapper.c:
    // 80-103)
    for (int var = 0; var < 2; ++var) {
      ++variants;
      ipm.run(var == 0, &tp, &vp, Xp);
      if (gate(g, Xp, X0, tp, vp, t0, v0)) break;
    }
  }
  if (g.q == 0 && g.l == 0)
    info[c] = (what == kIpmList ? info[c] : its) + 1000 * variants;
  if (g.q == 0) {
    g.each(n + 2, [&](int j, int i) {
      if (i >= 2) x_out[c * n + i - 2] = Xp[j];
    });
    if (g.l == 0) {
      t_out[c] = tp;
      v_out[c] = vp;
    }
  }
}

template <int E, int G>
int launch(const void* t0, const void* v0, const void* x0, void* t, void* v,
           void* x, void* info, void* scratch, void* list, long long count,
           int n, int W, int cpb, int smem, int ipm_W, void* stream) {
  if (count <= 0) return 0;
  auto kernel = logdet_cone_kernel<E, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pt0 = static_cast<const double*>(t0);
  const auto* pv0 = static_cast<const double*>(v0);
  const auto* px0 = static_cast<const double*>(x0);
  auto* pt = static_cast<double*>(t);
  auto* pv = static_cast<double*>(v);
  auto* px = static_cast<double*>(x);
  auto* pinfo = static_cast<int*>(info);
  auto* pscr = static_cast<double*>(scratch);
  auto* plist = static_cast<int*>(list);
  const dim3 grid(static_cast<unsigned>((count + cpb - 1) / cpb));
  kernel<<<grid, 32 * W * cpb, smem, st>>>(pt0, pv0, px0, pt, pv, px, pinfo,
                                           pscr, plist, count, n, W, cpb,
                                           kNewtonGate);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the IPM over the listed cones, one cone a block; the shared memory of
  // E = 0 is that of one cone, as in the first launch (cpb = 1 there)
  kernel<<<static_cast<unsigned>(count), 32 * ipm_W, smem, st>>>(
      pt0, pv0, px0, pt, pv, px, pinfo, pscr, plist, count, n, ipm_W, 1,
      kIpmList);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error as an int (0 =
// both launches were accepted). Does not synchronise. t0, v0 (count,), x0
// (count, n) contiguous float64 in, t, v (count,), x (count, n) out, info
// (count,) int32 = Newton iterations + 1000 x IPM variants run; list
// (count + 1,) int32, list[0] zero on entry. The layout (ops/logdet.py's
// launch_config): entries a lane E (1 or 2 in registers, 0 in memory),
// lanes a group G, warps a cone W, cones a block cpb (1 unless W = 1),
// dynamic shared memory smem bytes (E = 0 without scratch), warps a cone
// of the IPM launch ipm_W; scratch holds scs_logdet_scratch_len(count, n,
// W) float64 values where the layout needs it, else it is null.
int scs_logdet_cone(const void* t0, const void* v0, const void* x0, void* t,
                    void* v, void* x, void* info, void* scratch, void* list,
                    long long count, int n, int E, int G, int W, int cpb,
                    int smem, int ipm_W, void* stream) {
  // the layouts launch_config gives: E = 1 with G = 4 .. 32, E = 2 and
  // E = 0 with G = 32
  const auto go = [&](auto kernel_launch) {
    return kernel_launch(t0, v0, x0, t, v, x, info, scratch, list, count, n,
                         W, cpb, smem, ipm_W, stream);
  };
  if (E == 1 && G == 4) return go(launch<1, 4>);
  if (E == 1 && G == 8) return go(launch<1, 8>);
  if (E == 1 && G == 16) return go(launch<1, 16>);
  if (E == 1 && G == 32) return go(launch<1, 32>);
  if (E == 2 && G == 32) return go(launch<2, 32>);
  if (E == 0 && G == 32) return go(launch<0, 32>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// doubles an array set of one warp takes in memory (E = 0), and the
// global scratch of `count` cones of W warps
long long scs_logdet_warp_doubles(int n) {
  return static_cast<long long>(kArrays) * ((n + 3 + 31) / 32) * 32;
}

long long scs_logdet_scratch_len(long long count, int n, int W) {
  return scs_logdet_warp_doubles(n) * W * count;
}

const char* scs_logdet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
