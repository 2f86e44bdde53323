// The logarithmic (vector) cone projection of the log-determinant cone:
// damped Newton, SCS's KKT gate, and the primal-dual IPM in both variants
// for the cones that fail it, one warp per cone.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA
// (scs_tpu/cones/spectral.py: log_cone_newton :193, check_logdet_opt
// :346, log_cone_ipm :385, the cascade :700-766), which compiles each
// loop into one program. In PyTorch the same loops are thousands of small
// launches: one Newton iteration is ~220 kernels over all cones, one IPM
// iteration ~1200, and the IPM often runs its full 100 iterations on the
// cones that need it (1-14 % of the logdet cones in the spectral
// configurations' solves), so a projection that needs the IPM would cost
// ~10^5 launches. Here each cone's whole cascade runs in one warp, the
// loops in registers and in the cone's slice of a scratch buffer.
//
// What bounds it: neither bytes nor the card's peak rate. Each cone reads
// n + 2 values and writes n + 3, but its warp runs up to 100 Newton
// iterations (each a line search of up to 61 trial points of n logs) and,
// where the gate fails, up to 2 x 100 IPM iterations, all dependent:
// latency-bound arithmetic, the slowest cone setting the time. The design
// shortens that chain: the 32 threads of a warp split every loop over the
// n + 3 entries of a cone (thread l takes entries l, l + 32, ...) and sum
// with a butterfly of shuffles, which leaves every thread of the warp the
// same total, bit for bit, so all of them take the same branches on the
// scalars they all compute; each thread reads back only the entries it
// wrote itself, except for a few single entries, read after __syncwarp.
// Four warps a block, one cone each, spread the cones over the SMs.
// Array a of cone c lives at scratch[(c * kArrays + a) * (n + 6)], so a
// warp's accesses are contiguous.
//
// The arithmetic follows the plain version (`scs_tpu_torch/cones/
// spectral.py`) operation for operation, the sums in another order (a
// tree of shuffles), so the two agree to round-off where Newton converges
// inside its cap; where Newton stops at its 100-iteration cap or the IPM
// runs to its cap, round-off moves the point within the gate's tolerance
// (both pass the gate).

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

// scratch arrays, each of `width` = n + 6 entries per cone. The Newton
// vectors are indexed like (v, x): entry 0 is v, entry 1 + i is x_i; the
// IPM vectors like (t, v, x, r): entry 2 + i is x_i, entry n + 2 is r.
enum {
  kX, kGrad, kD, kW, kDu,                          // Newton
  kU1, kSu1, kSdu1, kG0, kG1, kG0s, kG1s, kGc0, kGc1, kRx, kDua, kDuc,
  kBnew, kRes, kGres, kTmp, kXinv, kTp1, kTp2,     // IPM
  kXp,                                             // the cascade's x
  kArrays
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// sums and minima over the warp by a butterfly: every thread ends with
// the same value, bit for bit (each step adds a pair in both orders)
template <typename T> __device__ T wsum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
template <typename T> __device__ T wmin(T x) {
  for (int o = 16; o > 0; o >>= 1) x = fmin(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ bool wall(bool p) { return __all_sync(kFull, p); }

template <typename T> __device__ T sq(T x) { return x * x; }

// one cone: its arrays, its thread of the warp (l) and its size
template <typename T>
struct Cone {
  T* base;      // scratch of this cone: kArrays arrays of n + 6
  int n, l;
  long long width;
  __device__ T* a(int k) const { return base + k * width; }
};

// ---- damped Newton (log_cone_Newton.c:58-302; spectral.py:193-323) ----

template <typename T>
__device__ T newton_obj(const Cone<T>& cn, T safe_v, T step, T t0, T v0,
                        const T* x0) {
  const T* X = cn.a(kX);
  const T* du = cn.a(kDu);
  const int n = cn.n;
  const T vn = fmax(safe_v + step * du[0], T(kLcMinV));
  T sumlog = 0, dist = 0;
  for (int g = cn.l; g <= n; g += 32) {
    if (g == 0) continue;
    const T xn = fmax(X[g] + step * du[g], T(kLcMinX));
    sumlog += log(xn);
    dist += sq(xn - x0[g - 1]);
  }
  sumlog = wsum(sumlog);
  dist = wsum(dist);
  const T sx = -(vn * sumlog - T(n) * vn * log(vn));
  return T(0.5) * sq(sx - t0) + T(0.5) * sq(vn - v0) + T(0.5) * dist;
}

template <typename T>
__device__ int newton(const Cone<T>& cn, T t0, T v0, const T* x0, T* t_out,
                      T* v_out) {
  const int n = cn.n, l = cn.l;
  const T nf = T(n);
  T *X = cn.a(kX), *grad = cn.a(kGrad), *d = cn.a(kD), *w = cn.a(kW),
    *du = cn.a(kDu), *xp = cn.a(kXp);
  bool all_pos = true, all_nonneg = true, all_neg = true;
  T sumlog_x0 = 0, sumlog_ratio = 0;
  for (int i = l; i < n; i += 32) {
    all_pos &= x0[i] > 0;
    all_nonneg &= x0[i] >= 0;
    all_neg &= x0[i] < 0;
    sumlog_x0 += log(x0[i] > 0 ? x0[i] : T(1));
    const T ratio = (x0[i] < 0 && t0 < 0) ? x0[i] / t0 : T(1);
    sumlog_ratio += log(ratio);
  }
  all_pos = wall(all_pos);
  all_nonneg = wall(all_nonneg);
  all_neg = wall(all_neg);
  sumlog_x0 = wsum(sumlog_x0);
  sumlog_ratio = wsum(sumlog_ratio);
  bool in_cone = v0 > 0 && all_pos &&
                 -v0 * (sumlog_x0 - nf * log(v0 > 0 ? v0 : T(1))) <= t0;
  in_cone |= v0 == 0 && all_nonneg && t0 >= 0;
  const T dual_sum = t0 * (-nf - sumlog_ratio);
  const bool in_neg_dual = t0 < 0 && all_neg && v0 <= dual_sum;
  const bool analytic = v0 <= 0 && t0 >= 0;

  T v = fmax(v0, T(kLcMinInit));
  T obj_old;
  {
    T sumlog = 0, dist = 0;
    for (int g = l; g <= n; g += 32) {
      if (g == 0) continue;
      X[g] = fmax(x0[g - 1], T(kLcMinInit));
      sumlog += log(X[g]);
      dist += sq(X[g] - x0[g - 1]);
    }
    sumlog = wsum(sumlog);
    dist = wsum(dist);
    const T sx = -(v * sumlog - nf * v * log(v));
    obj_old = T(0.5) * sq(sx - t0) + T(0.5) * sq(v - v0) + T(0.5) * dist;
  }
  int it = 0, ngrad = 0;
  bool done = false, failed = false;
  while (it < kLcMaxIter && !done && !failed) {
    failed |= v < T(kLcMinV);
    const T safe_v = fmax(v, T(kLcMinV));
    T sumlog = 0;
    for (int g = l; g <= n; g += 32) {
      if (g == 0) continue;
      X[g] = fmax(X[g], T(kLcMinX));
      sumlog += log(X[g]);
    }
    sumlog = wsum(sumlog);
    const T temp0 = -sumlog + nf * log(safe_v);
    const T a = safe_v * temp0 - t0;
    const T cc = temp0 + nf;
    const T v_inv = T(1) / safe_v;
    const T av = a * safe_v;
    T nominator = 0, wt = 0;
    for (int g = l; g <= n; g += 32) {
      if (g == 0) {
        grad[0] = a * cc + safe_v - v0;
        d[0] = T(1) + a * (-a * v_inv * v_inv + nf * v_inv -
                           T(2) * cc * v_inv);
        w[0] = -(a + safe_v * cc) * v_inv;
      } else {
        const T x_inv = T(1) / X[g];
        grad[g] = -av * x_inv + X[g] - x0[g - 1];
        d[g] = T(1) + av * x_inv * x_inv;
        w[g] = safe_v * x_inv;
      }
      du[g] = -grad[g] / d[g];
      nominator += w[g] * du[g];
      wt += w[g] * (w[g] / d[g]);
    }
    nominator = wsum(nominator);
    const T denominator = T(1) + wsum(wt);
    failed |= fabs(denominator) < T(kLcMinDenom);
    const T coef = -nominator / denominator;
    T dir_der = 0;
    for (int g = l; g <= n; g += 32) {
      du[g] = du[g] + coef * (w[g] / d[g]);
      dir_der += grad[g] * du[g];
    }
    dir_der = wsum(dir_der);
    const bool use_grad = dir_der > 0;
    failed |= use_grad && ngrad >= kLcMaxGradSteps;
    ngrad += use_grad;
    if (use_grad) {
      T gg = 0;
      for (int g = l; g <= n; g += 32) {
        du[g] = -grad[g];
        gg += grad[g] * grad[g];
      }
      dir_der = -wsum(gg);
    }
    const bool done_now = -dir_der <= T(2.0 * kLcTol);
    // largest domain-feasible step
    T step = T(1);
    for (int g = l; g <= n; g += 32) {
      if (du[g] < 0) {
        const T u = g == 0 ? safe_v : X[g];
        step = fmin(step, T(-0.99) * u / du[g]);
      }
    }
    step = wmin(step);
    __syncwarp();
    // backtracking: at most 61 trial steps, the last taken if none passes
    T new_obj = newton_obj(cn, safe_v, step, t0, v0, x0);
    for (int k = 0; k < kLcMaxLs; ++k) {
      if (!(T(1.0 - kLcLsRelTol) * new_obj >
            obj_old + T(kLcAlpha) * step * dir_der))
        break;
      step = step * T(kLcBeta);
      new_obj = newton_obj(cn, safe_v, step, t0, v0, x0);
    }
    if (!done_now && !failed) {
      v = safe_v + step * du[0];
      for (int g = l; g <= n; g += 32)
        if (g > 0) X[g] = X[g] + step * du[g];
      obj_old = new_obj;
    }
    done |= done_now;
    ++it;
    __syncwarp();
  }
  T sumlog = 0;
  for (int g = l; g <= n; g += 32) {
    if (g == 0) continue;
    X[g] = fmax(X[g], T(kLcMinX));
    sumlog += log(X[g]);
  }
  sumlog = wsum(sumlog);
  __syncwarp();
  v = fmax(v, T(kLcMinV));
  const T t_n = -v * (sumlog - nf * log(v));
  for (int i = l; i < n; i += 32) {
    xp[i] = in_cone       ? x0[i]
            : in_neg_dual ? T(0)
            : analytic    ? fmax(x0[i], T(0))
                          : X[i + 1];
  }
  *t_out = in_cone ? t0 : in_neg_dual ? T(0) : analytic ? t0 : t_n;
  *v_out = in_cone ? v0 : in_neg_dual ? T(0) : analytic ? T(0) : v;
  __syncwarp();
  return it;
}

// ---- the KKT gate (log_cone_wrapper.c:47-204; spectral.py:346-378) ----

template <typename T>
__device__ bool gate(const Cone<T>& cn, T tp, T vp, T t0, T v0,
                     const T* x0) {
  const int n = cn.n;
  const T nf = T(n);
  const T* xp = cn.a(kXp);
  T dualt = tp - t0;
  if (fabs(dualt) < T(kLwDualTThreshold)) dualt = T(kLwDualTThreshold);
  const T dualv = vp - v0;
  T dx_xp = 0, dx_dx = 0, xp_xp = 0, slog_xp = 0, slog_dx = 0, neg_xp = 0,
    neg_dx = 0;
  bool xp_pos = true, dx_pos = true;
  for (int i = cn.l; i < n; i += 32) {
    T dualx = xp[i] - x0[i];
    if (fabs(dualx) < T(kLwDualXThreshold)) dualx = T(kLwDualXThreshold);
    dx_xp += dualx * xp[i];
    dx_dx += dualx * dualx;
    xp_xp += xp[i] * xp[i];
    xp_pos &= xp[i] > 0;
    dx_pos &= dualx > 0;
    slog_xp += log(xp[i] > 0 ? xp[i] : T(1));
    slog_dx += log(dualx > 0 ? dualx : T(1));
    neg_xp += xp[i] < 0 ? xp[i] * xp[i] : T(0);
    neg_dx += dualx < 0 ? dualx * dualx : T(0);
  }
  dx_xp = wsum(dx_xp);
  dx_dx = wsum(dx_dx);
  xp_xp = wsum(xp_xp);
  slog_xp = wsum(slog_xp);
  slog_dx = wsum(slog_dx);
  neg_xp = wsum(neg_xp);
  neg_dx = wsum(neg_dx);
  xp_pos = wall(xp_pos);
  dx_pos = wall(dx_pos);
  const T comp = tp * dualt + vp * dualv + dx_xp;
  const T slog_vp = log(vp > 0 ? vp : T(1));
  const T pri_res =
      (vp > 0 && xp_pos) ? -vp * (slog_xp - nf * slog_vp) - tp
                         : vp * vp + (tp < 0 ? tp * tp : T(0)) + neg_xp;
  const T slog_dt = log(dualt > 0 ? dualt : T(1));
  const T dual_res =
      (dualt > 0 && dx_pos)
          ? dualt * (nf * slog_dt - nf - slog_dx) - dualv
          : dualt * dualt + (dualv < 0 ? dualv * dualv : T(0)) + neg_dx;
  const T dual_norm = sqrt(sq(dualt) + sq(dualv) + dx_dx);
  const T pri_norm = sqrt(sq(tp) + sq(vp) + xp_xp);
  const T pn1 = fmax(pri_norm, T(1));
  const T dres = dual_res / fmax(dual_norm, T(1));
  const T pres = pri_res / pn1;
  const T cres = comp / fmax(pn1, dual_norm);
  return tp >= t0 - T(0.1) * fabs(t0) && dres < T(kLwDualFeasTol) &&
         pres < T(kLwPriFeasTol) && fabs(cres) < T(kLwCompTol);
}

// ---- the IPM (log_cone_IPM.c:338-713; spectral.py:385-697) ----

template <typename T>
struct Ipm {
  Cone<T> cn;
  int n, l, ri;     // ri = n + 2, the index of r in a (n + 3)-vector
  T base0, base1;   // scaled t0, v0; scaled x0 = x0[i] / scale
  const T* x0;
  T scale;
  T z[3], s[3], r;
  T w[3], lm[3];
  T R00, R01, R02, R10, R11, R20;
  T coeff;
  T *U1, *G0, *G1, *G0s, *G1s, *Gc0, *Gc1, *Xinv, *Tp1, *Tp2;

  __device__ T base(int i) const {
    return i == 0 ? base0 : i == 1 ? base1 : x0[i - 2] / scale;
  }

  // (phi, gap) of the merit function at (u1 + st du1, r + st dr, z + st
  // dz, s + st ds); du holds (du1, dr)
  __device__ void merit(const T* u1, T rr, const T* zz, const T* ss,
                        const T* du, const T* dz, const T* ds, T st, T th1,
                        T th2, T th3, T* phi, T* gap) const {
    const T nf = T(n);
    T zn[3], sn[3];
    for (int j = 0; j < 3; ++j) {
      zn[j] = zz[j] + st * dz[j];
      sn[j] = ss[j] + st * ds[j];
    }
    const T rn = rr + st * du[ri];
    T slog = 0, dd = 0;
    for (int i = l; i < ri; i += 32) {
      const T ui = u1[i] + st * du[i];
      dd += sq(ui - base(i));
      if (i >= 2) slog += log(ui);
    }
    dd = wsum(dd);
    slog = wsum(slog);
    const T un0 = u1[0] + st * du[0], un1 = u1[1] + st * du[1];
    slog = slog - nf * log(un1);
    const T f0 = T(0.5) * dd - rn, f1 = -un1 * slog - un0, f2 = -un1;
    // rx = z0 g0 + z1 g1, then rx[1] -= z2, rx[ri] += 1
    T rx2 = 0;
    for (int i = l; i <= ri; i += 32) {
      T g0, g1;
      if (i == ri) {
        g0 = T(-1);
        g1 = T(0);
      } else if (i == 0) {
        g0 = un0 - base0;
        g1 = T(-1);
      } else if (i == 1) {
        g0 = un1 - base1;
        g1 = nf - slog;
      } else {
        const T ui = u1[i] + st * du[i];
        g0 = ui - base(i);
        g1 = -un1 / ui;
      }
      T rx = zn[0] * g0 + zn[1] * g1;
      if (i == 1) rx -= zn[2];
      if (i == ri) rx += T(1);
      rx2 += rx * rx;
    }
    rx2 = wsum(rx2);
    const T rz2 = sq(f0 + sn[0]) + sq(f1 + sn[1]) + sq(f2 + sn[2]);
    *gap = zn[0] * sn[0] + zn[1] * sn[1] + zn[2] * sn[2];
    *phi = th1 * *gap + th2 * sqrt(rx2) + th3 * sqrt(rz2);
  }

  __device__ void ginv(const T* b, T* out) const {
    T acc = 0;
    for (int i = l; i < ri; i += 32)
      if (i >= 2) acc += b[i] * Tp2[i];
    acc = wsum(acc);
    const T y1 = (b[1] + z[1] * acc) / coeff;
    for (int i = l; i <= ri; i += 32) {
      out[i] = i == 0    ? b[0] / z[0]
               : i == 1  ? y1
               : i == ri ? -b[ri]
                         : (b[i] + z[1] * y1 * Xinv[i]) / Tp1[i];
    }
    __syncwarp();
  }

  // out = G du + C C' du
  __device__ void gapply_cct(const T* du, T* out) const {
    const T nf = T(n), v = U1[1];
    T c0 = 0, c1 = 0, xd = 0;
    for (int i = l; i <= ri; i += 32) {
      c0 += G0s[i] * du[i];
      c1 += G1s[i] * du[i];
      if (i >= 2 && i < ri) xd += Xinv[i] * du[i];
    }
    c0 = wsum(c0);
    c1 = wsum(c1);
    xd = wsum(xd);
    for (int i = l; i <= ri; i += 32) {
      T g;
      if (i == 0) {
        g = z[0] * du[0];
      } else if (i == 1) {
        g = (z[0] + T(1) / (w[2] * w[2])) * du[1] +
            z[1] * (nf / v * du[1] - xd);
      } else if (i == ri) {
        g = -du[ri];
      } else {
        const T xi = Xinv[i];
        g = z[0] * du[i] + z[1] * (-du[1] * xi + v * du[i] * xi * xi);
      }
      T c = c0 * G0s[i] + c1 * G1s[i];
      if (i == ri) c += du[ri];
      out[i] = g + c;
    }
    __syncwarp();
  }

  // KKT_solve (:202-331): rhs1 = f * [-rx; -rznl], rhs2; out = (du1, dr)
  __device__ void kkt_solve(T f, const T* rx, const T* rznl, const T* rhs2,
                            T* out, T* dz, T* ds) const {
    T *bnew = cn.a(kBnew), *res = cn.a(kRes), *gres = cn.a(kGres),
      *tmp = cn.a(kTmp);
    T tail[3];
    for (int j = 0; j < 3; ++j)
      tail[j] = f * -rznl[j] - w[j] * (rhs2[j] / lm[j]);
    for (int i = l; i <= ri; i += 32) {
      T b = f * -rx[i] + (tail[0] / w[0]) * G0s[i] +
            (tail[1] / w[1]) * G1s[i];
      if (i == 1) b += -tail[2] / (w[2] * w[2]);
      bnew[i] = b;
      res[i] = b;
      out[i] = 0;
    }
    __syncwarp();
    for (int pass = 0; pass < 3; ++pass) {
      ginv(res, gres);
      T CT0 = 0, CT1 = 0;
      for (int i = l; i <= ri; i += 32) {
        CT0 += G0s[i] * gres[i];
        CT1 += G1s[i] * gres[i];
      }
      CT0 = wsum(CT0);
      CT1 = wsum(CT1);
      const T CT2 = gres[ri];
      const T q0 = CT2 / R20;
      const T q1 = (CT1 - R10 * q0) / R11;
      const T q2 = (CT0 - R00 * q0 - R01 * q1) / R02;
      for (int i = l; i <= ri; i += 32) {
        T dd = gres[i] - q0 * Gc0[i] - q1 * Gc1[i];
        if (i == ri) dd += q2;
        out[i] = out[i] + dd;
      }
      __syncwarp();
      gapply_cct(out, tmp);
      for (int i = l; i <= ri; i += 32) res[i] = bnew[i] - tmp[i];
      __syncwarp();
    }
    T c0 = 0, c1 = 0;
    for (int i = l; i <= ri; i += 32) {
      c0 += G0s[i] * out[i];
      c1 += G1s[i] * out[i];
    }
    c0 = wsum(c0);
    c1 = wsum(c1);
    dz[0] = tail[0] + -w[0] * c0;
    dz[1] = tail[1] + -w[1] * c1;
    dz[2] = tail[2] + out[1];
    for (int j = 0; j < 3; ++j) {
      dz[j] = -dz[j] / (w[j] * w[j]);
      ds[j] = w[j] * (rhs2[j] / lm[j] - w[j] * dz[j]);
    }
  }

  // find_max_step_size (:90-126), with the halving of spectral.py:541-545
  __device__ T max_step(const T* du, const T* dz, const T* ds) const {
    T smz = T(10), sms = T(10);
    for (int j = 0; j < 3; ++j) {
      smz = fmin(smz, dz[j] < 0 ? -z[j] / dz[j] : T(10));
      sms = fmin(sms, ds[j] < 0 ? -s[j] / ds[j] : T(10));
    }
    const T sm = fmin(fmin(smz, sms), T(10));
    T dom = T(10);
    for (int i = l; i < ri; i += 32)
      if (i >= 1) dom = fmin(dom, du[i] < 0 ? -U1[i] / du[i] : T(10));
    dom = wmin(dom);
    T step = fmin(T(kIpmStep) * sm, T(1));
    if (step > dom) {
      if (dom > 0) {
        while (step > dom) step = step * T(0.5);
      } else {
        step = T(0);
      }
    }
    return step;
  }

  // log_cone_ipm's loop; the result into (t, v, xout) (scaled back)
  __device__ void run(bool mehrotra, T* t_out, T* v_out, T* xout) {
    const T nf = T(n);
    T *Su1 = cn.a(kSu1), *Sdu1 = cn.a(kSdu1), *Rx = cn.a(kRx),
      *Dua = cn.a(kDua), *Duc = cn.a(kDuc);
    for (int i = l; i <= ri; i += 32) {
      if (i < ri) {
        U1[i] = T(1);
        Su1[i] = T(1);
      }
      Sdu1[i] = T(0);
    }
    __syncwarp();
    for (int j = 0; j < 3; ++j) z[j] = s[j] = T(1);
    r = 0;
    T sv_r = 0, sv_z[3] = {1, 1, 1}, sv_s[3] = {1, 1, 1}, sv_dz[3] = {0, 0, 0},
      sv_ds[3] = {0, 0, 0}, sv_phi = 0, sv_dphi = 0, sv_step = 0;
    T th1 = 1, th2 = 1, th3 = 1, pres0 = 1, dres0 = 1;
    int relaxed = 0;
    for (int it = 0; it < kIpmMaxIter; ++it) {
      const T v = U1[1];
      // oracle and residuals at the iterate
      T slog = 0, dd = 0;
      for (int i = l; i < ri; i += 32) {
        const T du = U1[i] - base(i);
        dd += du * du;
        G0[i] = du;
        if (i >= 2) slog += log(U1[i]);
      }
      slog = wsum(slog) - nf * log(U1[1]);
      dd = wsum(dd);
      const T f[3] = {T(0.5) * dd - r, -U1[1] * slog - U1[0], -U1[1]};
      T rx2 = 0;
      for (int i = l; i <= ri; i += 32) {
        if (i == ri) G0[i] = T(-1);
        const T g1 = i == 0 ? T(-1) : i == 1 ? nf - slog
                     : i == ri ? T(0) : -U1[1] / U1[i];
        G1[i] = g1;
        T rx = z[0] * G0[i] + z[1] * g1;
        if (i == 1) rx -= z[2];
        if (i == ri) rx += T(1);
        Rx[i] = rx;
        rx2 += rx * rx;
      }
      rx2 = wsum(rx2);
      const T rznl[3] = {f[0] + s[0], f[1] + s[1], f[2] + s[2]};
      const T gap = z[0] * s[0] + z[1] * s[1] + z[2] * s[2];
      const T mu = gap / T(3);
      const T dres_raw = sqrt(rx2);
      const T pres_raw = sqrt(sq(rznl[0]) + sq(rznl[1]) + sq(rznl[2]));
      if (it == 0) {
        pres0 = fmax(pres_raw, T(1));
        dres0 = fmax(dres_raw, T(1));
        th1 = T(1) / gap;
        th2 = T(1) / dres0;
        th3 = T(1) / pres0;
      }
      const T relgap = gap / fmax(r, T(1));
      if (dres_raw / dres0 < T(kIpmFeasTol) &&
          pres_raw / pres0 < T(kIpmFeasTol) &&
          (gap < T(kIpmAbsTol) || relgap <= T(kIpmRelTol)))
        break;
      for (int j = 0; j < 3; ++j) {
        w[j] = sqrt(s[j] / z[j]);
        lm[j] = sqrt(s[j] * z[j]);
      }
      // structured KKT factor (KKT_precompute, :149-200)
      T acc = 0;
      for (int i = l; i <= ri; i += 32) {
        G0s[i] = G0[i] / w[0];
        G1s[i] = G1[i] / w[1];
        if (i >= 2 && i < ri) {
          const T xi = T(1) / U1[i];
          Xinv[i] = xi;
          Tp1[i] = z[0] + z[1] * v * xi * xi;
          Tp2[i] = xi / Tp1[i];
          acc += xi * xi / Tp1[i];
        }
      }
      __syncwarp();
      coeff = z[0] + T(1) / (w[2] * w[2]) + z[1] * nf / v - sq(z[1]) *
              wsum(acc);
      ginv(G0s, Gc0);
      ginv(G1s, Gc1);
      T a00 = 0, a01 = 0, a10 = 0, a11 = 0;
      for (int i = l; i <= ri; i += 32) {
        a00 += G0s[i] * Gc0[i];
        a01 += G0s[i] * Gc1[i];
        a10 += G1s[i] * Gc0[i];
        a11 += G1s[i] * Gc1[i];
      }
      R00 = T(1) + wsum(a00);
      R01 = wsum(a01);
      R02 = -G0s[ri];
      R10 = wsum(a10);
      R11 = T(1) + wsum(a11);
      R20 = Gc0[ri];

      const T phi = th1 * gap + th2 * dres_raw + th3 * pres_raw;
      const T dphi = -phi;
      const T rhs2_aff[3] = {-(lm[0] * lm[0]), -(lm[1] * lm[1]),
                             -(lm[2] * lm[2])};
      // affine pass: direction and centering parameter
      T dz_a[3], ds_a[3];
      kkt_solve(T(1), Rx, rznl, rhs2_aff, Dua, dz_a, ds_a);
      T step = max_step(Dua, dz_a, ds_a);
      T phi_n, gap_a;
      bool ok = false;
      for (int k = 0; k < kIpmMaxLs; ++k) {
        merit(U1, r, z, s, Dua, dz_a, ds_a, step, th1, th2, th3, &phi_n,
              &gap_a);
        if (phi_n <= (T(1) - T(kIpmAlpha) * step) * phi) {
          ok = true;
          break;
        }
        step = step * T(kIpmBeta);
      }
      if (!ok)
        merit(U1, r, z, s, Dua, dz_a, ds_a, step, th1, th2, th3, &phi_n,
              &gap_a);
      T sigma = gap_a / gap;
      sigma = sigma < T(1) ? sigma * sigma * sigma : sigma;
      // corrector / search direction
      T rhs2_c[3], dz_c[3], ds_c[3];
      for (int j = 0; j < 3; ++j)
        rhs2_c[j] = mehrotra ? rhs2_aff[j] + (sigma * mu - ds_a[j] * dz_a[j])
                             : rhs2_aff[j] + T(0);
      kkt_solve(mehrotra ? T(1) - sigma : T(1), Rx, rznl, rhs2_c, Duc, dz_c,
                ds_c);
      step = max_step(Duc, dz_c, ds_c);

      // nonmonotone line search (log_cone_IPM.c:640-692)
      bool restored = false, bt = true;
      for (int k = 0; bt && k < kIpmMaxLs; ++k) {
        const T cphi = restored ? sv_phi : phi;
        const T cdphi = restored ? sv_dphi : dphi;
        T gdummy;
        if (restored)
          merit(Su1, sv_r, sv_z, sv_s, Sdu1, sv_dz, sv_ds, step, th1, th2,
                th3, &phi_n, &gdummy);
        else
          merit(U1, r, z, s, Duc, dz_c, ds_c, step, th1, th2, th3, &phi_n,
                &gdummy);
        const bool armijo = phi_n <= cphi + T(kIpmAlpha) * step * cdphi;
        const bool armijo0 =
            phi_n <= sv_phi + T(kIpmAlpha) * sv_step * sv_dphi;
        if (relaxed == -1) {
          bt = !armijo;
          if (!armijo) step = step * T(kIpmBeta);
        } else if (relaxed == 0) {
          bt = false;
          if (!armijo) {
            relaxed = 1;
            for (int i = l; i <= ri; i += 32) {
              if (i < ri) Su1[i] = U1[i];
              Sdu1[i] = Duc[i];
            }
            __syncwarp();
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
          bt = false;
          relaxed = armijo0 ? 0 : relaxed + 1;
        } else {
          bt = !armijo0;
          if (!armijo0) {
            restored = true;
            relaxed = -1;
            step = sv_step;
          }
        }
      }
      if (restored) {
        for (int i = l; i <= ri; i += 32)
          if (i < ri) U1[i] = Su1[i] + step * Sdu1[i];
        r = sv_r + step * Sdu1[ri];
        for (int j = 0; j < 3; ++j) {
          z[j] = sv_z[j] + step * sv_dz[j];
          s[j] = sv_s[j] + step * sv_ds[j];
        }
      } else {
        for (int i = l; i <= ri; i += 32)
          if (i < ri) U1[i] = U1[i] + step * Duc[i];
        r = r + step * Duc[ri];
        for (int j = 0; j < 3; ++j) {
          z[j] = z[j] + step * dz_c[j];
          s[j] = s[j] + step * ds_c[j];
        }
      }
      __syncwarp();
    }
    *t_out = U1[0] * scale;
    *v_out = U1[1] * scale;
    for (int i = l; i < n; i += 32) xout[i] = U1[i + 2] * scale;
    __syncwarp();
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
logdet_cone_kernel(const T* __restrict__ t0_in, const T* __restrict__ v0_in,
                   const T* __restrict__ x0_in, T* __restrict__ t_out,
                   T* __restrict__ v_out, T* __restrict__ x_out,
                   int* __restrict__ info, T* scratch, long long count,
                   int n) {
  const long long c = blockIdx.x * static_cast<long long>(kWarpsPerBlock) +
                      (threadIdx.x >> 5);
  if (c >= count) return;  // whole warps leave together
  const int l = threadIdx.x & 31;
  const long long width = n + 6;
  const Cone<T> cn{scratch + c * kArrays * width, n, l, width};
  const T t0 = t0_in[c], v0 = v0_in[c];
  const T* x0 = x0_in + c * n;
  T tp, vp;
  const int its = newton(cn, t0, v0, x0, &tp, &vp);
  T* xp = cn.a(kXp);
  int variants = 0;
  if (!gate(cn, tp, vp, t0, v0, x0)) {
    Ipm<T> ipm{};
    ipm.cn = cn;
    ipm.n = n;
    ipm.l = l;
    ipm.ri = n + 2;
    T scale = 0;
    for (int i = l; i < n; i += 32) scale = fmax(scale, fabs(x0[i]));
    // the maximum is exact in any order
    for (int o = 16; o > 0; o >>= 1)
      scale = fmax(scale, __shfl_xor_sync(kFull, scale, o));
    scale = fmax(scale, fmax(t0, v0));
    scale = fmax(scale, T(1e-100));
    ipm.scale = scale;
    ipm.base0 = t0 / scale;
    ipm.base1 = v0 / scale;
    ipm.x0 = x0;
    ipm.U1 = cn.a(kU1);
    ipm.G0 = cn.a(kG0);
    ipm.G1 = cn.a(kG1);
    ipm.G0s = cn.a(kG0s);
    ipm.G1s = cn.a(kG1s);
    ipm.Gc0 = cn.a(kGc0);
    ipm.Gc1 = cn.a(kGc1);
    ipm.Xinv = cn.a(kXinv);
    ipm.Tp1 = cn.a(kTp1);
    ipm.Tp2 = cn.a(kTp2);
    // variant 0 (Mehrotra), then variant 1 if the gate still fails; a
    // cone whose attempts all fail keeps the last (log_cone_wrapper.c:
    // 80-103)
    for (int var = 0; var < 2; ++var) {
      ++variants;
      ipm.run(var == 0, &tp, &vp, xp);
      if (gate(cn, tp, vp, t0, v0, x0)) break;
    }
  }
  for (int i = l; i < n; i += 32) x_out[c * n + i] = xp[i];
  if (l == 0) {
    t_out[c] = tp;
    v_out[c] = vp;
    info[c] = its + 1000 * variants;
  }
}

template <typename T>
int launch(const void* t0, const void* v0, const void* x0, void* t, void* v,
           void* x, void* info, void* scratch, long long count, int n,
           void* stream) {
  if (count <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (count + kWarpsPerBlock - 1) / kWarpsPerBlock));
  logdet_cone_kernel<T><<<grid, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t0), static_cast<const T*>(v0),
      static_cast<const T*>(x0), static_cast<T*>(t), static_cast<T*>(v),
      static_cast<T*>(x), static_cast<int*>(info), static_cast<T*>(scratch),
      count, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. t0, v0 (count,), x0 (count,
// n) contiguous float64 in, t, v (count,), x (count, n) out, info (count,)
// int32 = Newton iterations + 1000 x IPM variants run; scratch holds
// scs_logdet_scratch_len(count, n) float64 values.
int scs_logdet_cone(const void* t0, const void* v0, const void* x0, void* t,
                    void* v, void* x, void* info, void* scratch,
                    long long count, int n, void* stream) {
  return launch<double>(t0, v0, x0, t, v, x, info, scratch, count, n,
                        stream);
}

long long scs_logdet_scratch_len(long long count, int n) {
  return static_cast<long long>(kArrays) * (n + 6) * count;
}

const char* scs_logdet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
