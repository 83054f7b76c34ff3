// The biconvex centroidal ADMM of one MPC problem on the 32 lanes of a warp:
// the per-problem device code that K1 (csrc/admm.cu) and K3 (csrc/fused.cu)
// share, counterpart of bunmpc_tpu/solvers/pallas_admm.py:_admm_core.
//
//   F-step  projected FISTA with a power-iteration step, the reference
//           momentum t+ = 1 + sqrt(1 + 4 t^2) / 2 and the exact friction-cone
//           projection;
//   X-step  x_solver "thomas": the exact block-tridiagonal solve (block-Thomas
//           sweep of 9x9 Cholesky blocks) clipped to the kinematic box;
//           "fista": power iteration on 2(W y + rho A_f'A_f y) and projected
//           FISTA onto the box;
//   both FISTA solves optionally in a Jacobi metric (precondition: per-contact
//           isotropic for F, pallas_admm.py:507-519; per coordinate for X,
//           :537-557): D = lam d0, lam the power-iteration estimate of the
//           largest eigenvalue of d0^-1/2 H d0^-1/2;
//   outer   over-relaxed dual update, stall-gated rho escalation/backoff with
//           dual rescaling, per-problem convergence (NaN freezes a problem).
//
// Design: the 32 lanes of a warp share one problem — the operators by knot,
// each F-step FISTA iteration by knot in one phase (a knot's gradient reads
// its own forces only, so its lane takes them through the cone projection
// and the momentum update), the norms as per-lane partial sums, the Thomas
// sweep's block solve by column with the Schur update of that column, each
// lane building only the entries of M_{k+1} and U_k it needs; the sweep's 9x9
// Cholesky runs on one lane in registers (thomas_x says why) — with a warp
// barrier between phases, so problems never wait for each other. The Pallas
// kernel freezes a lane once it converges, so a problem's result depends on
// its own data only; here each problem leaves its loops on its own. A
// problem's work arrays and its inputs (staged once) live in its slice of the
// block's shared memory (admm_layout; opted in past 48 KB), so the dependent
// accesses of every phase cost shared-memory latency, not a device-memory
// round trip; the per-problem code is force-inlined (common.cuh: HD), so
// those accesses compile to shared-memory loads. The knot sweep stays
// sequential. Compiled with g++ (no __CUDACC__) the same phases run on the
// host with the lanes of a phase one after another and the slice a plain
// array, for the CPU tests.

#pragma once

#include "common.cuh"

namespace bk {

constexpr int NE = 4;  // feet (the wrappers check)
constexpr double G_ACC = 9.81;
// profiling-build phase slots (common.cuh: Prof)
enum { PH_TOTAL, PH_F_POWER, PH_F_FISTA, PH_THOMAS, PH_CHOL, PH_DUAL, PH_X_FISTA, PH_PROLOGUE };

template <typename T>
struct AdmmParams {
  int H, max_admm_iters, fista_max_iters, power_iters, rho_growth_every, rho_stall_gate,
      x_fista, precondition;
  T m, inv_m2, rho, fista_tol, exit_tol, mu, power_safety, dual_relax, rho_growth,
      rho_max_scale, rho_stall_improve, rho_backoff_thresh;
};

// read-only inputs of one problem (staged in its shared-memory slice)
template <typename T>
struct AdmmInputs {
  const T *cnt, *r, *dt, *x_init, *W, *ql, *WF, *qF, *lb, *ub;
};

// One problem's work arrays, in its slice of the block's shared memory.
template <typename T>
struct AdmmWork {
  T *X, *P, *Xn, *bP, *dk, *v, *F, *xk, *yk, *g, *z;
  T* part;      // per lane: partial sums (2 * LANES)
  T *Fu, *Fd;   // F-step: preconditioned operand, metric
  // the X-step's arrays, by x_solver ("thomas" and "fista" share the room):
  T *Wk, *Cm, *Lm, *yv;  // the sweep's W_k; the current knot's block, its factor, y
  T *Xy, *Xg, *Xz, *Xu, *Xd;  // X-FISTA: momentum point, gradient, power vector, operand, metric
};

// Element offsets of one problem's shared-memory slice: the work arrays,
// then the inputs, staged there once (AdmmInputs, in its order).
struct AdmmLayout {
  long X, P, Xn, bP, dk, v, F, xk, yk, g, z, part, Fu, Fd, Wk, Cm, Lm, yv, Xy, Xg, Xz, Xu, Xd;
  long cnt, r, dt, x_init, W, ql, WF, qF, lb, ub, n;
};

HD AdmmLayout admm_layout(int H) {
  const long nX = (H + 1) * 9L, nF = H * NE * 3L;
  long o = 0;
  auto take = [&](long n) {
    const long at = o;
    o += n;
    return at;
  };
  AdmmLayout L;
  L.X = take(nX); L.P = take(nX); L.Xn = take(nX); L.bP = take(nX); L.dk = take(nX);
  L.v = take(nX); L.F = take(nF); L.xk = take(nF); L.yk = take(nF); L.g = take(nF);
  L.z = take(nF); L.part = take(2 * LANES); L.Fu = take(nF); L.Fd = take(nF);
  const long xstep = o;
  L.Wk = take(H * 81L); L.Cm = take(81); L.Lm = take(81); L.yv = take(9);
  const long thomas_end = o;
  o = xstep;
  L.Xy = take(nX); L.Xg = take(nX); L.Xz = take(nX); L.Xu = take(nX); L.Xd = take(nX);
  o = s_max(o, thomas_end);
  L.cnt = take(H * NE); L.r = take(nF); L.dt = take(H); L.x_init = take(9); L.W = take(nX);
  L.ql = take(nX); L.WF = take(nF); L.qF = take(nF); L.lb = take(nX); L.ub = take(nX);
  L.n = o;
  return L;
}

template <typename T>
HD AdmmWork<T> admm_work(T* sh, const AdmmLayout& L) {
  AdmmWork<T> w;
  w.X = sh + L.X; w.P = sh + L.P; w.Xn = sh + L.Xn; w.bP = sh + L.bP; w.dk = sh + L.dk;
  w.v = sh + L.v; w.F = sh + L.F; w.xk = sh + L.xk; w.yk = sh + L.yk; w.g = sh + L.g;
  w.z = sh + L.z; w.part = sh + L.part; w.Fu = sh + L.Fu; w.Fd = sh + L.Fd;
  w.Wk = sh + L.Wk; w.Cm = sh + L.Cm; w.Lm = sh + L.Lm; w.yv = sh + L.yv;
  w.Xy = sh + L.Xy; w.Xg = sh + L.Xg; w.Xz = sh + L.Xz; w.Xu = sh + L.Xu; w.Xd = sh + L.Xd;
  return w;
}

// the staged inputs (the staging itself is the caller's)
template <typename T>
HD AdmmInputs<T> admm_inputs(T* sh, const AdmmLayout& L) {
  return AdmmInputs<T>{sh + L.cnt, sh + L.r,  sh + L.dt, sh + L.x_init, sh + L.W,
                       sh + L.ql,  sh + L.WF, sh + L.qF, sh + L.lb,     sh + L.ub};
}

// sum of the lanes' partial sums part[off .. off + LANES)
template <typename T>
HD T sum_parts(const T* part, int off) {
  T s = T(0);
  for (int l = 0; l < LANES; ++l) s += part[off + l];
  return s;
}

// knot t's rows of 2 (WF y + rho A_x(X)^T (A_x(X) y + bP)) [+ qF] into out
// (the knot's NE * 3 entries); bP and qF optional. A_x rows 0..2 are zero and
// A_x^T reads rows 3..8 of knots t < H only, so the two stencils fuse per
// knot, and knot t's rows read y at knot t only.
template <typename T>
HD void f_operator_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* X,
                        const T* y, const T* bP, T rho, bool add_qF,
                        T* out, int t) {
  const T dt = in.dt[t];
  const T com[3] = {X[t * 9 + 0], X[t * 9 + 1], X[t * 9 + 2]};
  T lin[3] = {0, 0, 0}, ang[3] = {0, 0, 0};
  for (int n = 0; n < NE; ++n) {
    const T c = in.cnt[t * NE + n];
    const int i0 = (t * NE + n) * 3;
    T cf[3], arm[3], cr[3];
    for (int k = 0; k < 3; ++k) {
      cf[k] = c * y[i0 + k];
      arm[k] = in.r[i0 + k] - com[k];
    }
    cross3(arm, cf, cr);
    for (int k = 0; k < 3; ++k) {
      lin[k] += cf[k];
      ang[k] += cr[k];
    }
  }
  T yl[3], ya[3];
  for (int k = 0; k < 3; ++k) {
    yl[k] = dt * lin[k] / pr.m;
    ya[k] = dt * ang[k];
    if (bP) {
      yl[k] += bP[t * 9 + 3 + k];
      ya[k] += bP[t * 9 + 6 + k];
    }
  }
  for (int n = 0; n < NE; ++n) {
    const T c = in.cnt[t * NE + n];
    const int i0 = (t * NE + n) * 3;
    T arm[3], cr[3];
    for (int k = 0; k < 3; ++k) arm[k] = in.r[i0 + k] - com[k];
    cross3(ya, arm, cr);
    for (int k = 0; k < 3; ++k) {
      const T o = c * (dt * (yl[k] / pr.m + cr[k]));
      T val = T(2) * (in.WF[i0 + k] * y[i0 + k] + rho * o);
      if (add_qF) val += in.qF[i0 + k];
      out[n * 3 + k] = val;
    }
  }
}

// element i of b_x(X) (rows t < H; the terminal row is zero)
template <typename T>
HD T bx_el(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* X, int i) {
  const int t = i / 9, k = i % 9;
  if (t == pr.H || k < 3) return T(0);
  T d = X[(t + 1) * 9 + k] - X[t * 9 + k];
  if (k == 5) d += T(G_ACC) * in.dt[t];
  return d;
}

template <typename T>
HD void cf_total(const AdmmInputs<T>& in, const T* F, int t, T* cF) {
  cF[0] = cF[1] = cF[2] = T(0);
  for (int n = 0; n < NE; ++n) {
    const T c = in.cnt[t * NE + n];
    for (int k = 0; k < 3; ++k) cF[k] += c * F[(t * NE + n) * 3 + k];
  }
}

// b_f(F): rows t < H [0, -dt sum(cF)/m + g dt e_z, dt sum cF x r], row H x_init
template <typename T>
HD void bf_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F, int t,
               T* row) {
  if (t == pr.H) {
    for (int k = 0; k < 9; ++k) row[k] = in.x_init[k];
    return;
  }
  const T dt = in.dt[t];
  T s[3] = {0, 0, 0}, a[3] = {0, 0, 0};
  for (int n = 0; n < NE; ++n) {
    const T c = in.cnt[t * NE + n];
    const int i0 = (t * NE + n) * 3;
    T cf[3], cr[3];
    for (int k = 0; k < 3; ++k) cf[k] = c * F[i0 + k];
    cross3(cf, in.r + i0, cr);
    for (int k = 0; k < 3; ++k) {
      s[k] += cf[k];
      a[k] += cr[k];
    }
  }
  for (int k = 0; k < 3; ++k) {
    row[k] = T(0);
    row[3 + k] = -dt * s[k] / pr.m;
    row[6 + k] = dt * a[k];
  }
  row[5] += T(G_ACC) * dt;
}

// A_f(F) X, row t
template <typename T>
HD void af_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F, const T* X,
               int t, T* row) {
  if (t == pr.H) {
    for (int k = 0; k < 9; ++k) row[k] = X[k];
    return;
  }
  const T dt = in.dt[t];
  T cF[3], com[3], cr[3];
  cf_total(in, F, t, cF);
  for (int k = 0; k < 3; ++k) com[k] = X[t * 9 + k];
  cross3(cF, com, cr);
  for (int k = 0; k < 3; ++k) {
    row[k] = X[t * 9 + k] - X[(t + 1) * 9 + k] + dt * X[(t + 1) * 9 + 3 + k];
    row[3 + k] = X[t * 9 + 3 + k] - X[(t + 1) * 9 + 3 + k];
    row[6 + k] = X[t * 9 + 6 + k] - X[(t + 1) * 9 + 6 + k] + dt * cr[k];
  }
}

// row t of A_f(F)^T Y: the contributions of constraint rows t-1 and t, and
// for t = 0 of the pinning row
template <typename T>
HD void af_applyT_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F,
                      const T* Y, int t, T* row) {
  const int H = pr.H;
  for (int k = 0; k < 9; ++k) row[k] = T(0);
  if (t > 0) {
    const T dt = in.dt[t - 1];
    const int s = (t - 1) * 9;
    for (int k = 0; k < 3; ++k) {
      row[k] += -Y[s + k];
      row[3 + k] += dt * Y[s + k] - Y[s + 3 + k];
      row[6 + k] += -Y[s + 6 + k];
    }
  }
  if (t < H) {
    const T dt = in.dt[t];
    T cF[3], ya[3], cr[3];
    cf_total(in, F, t, cF);
    for (int k = 0; k < 3; ++k) ya[k] = Y[t * 9 + 6 + k];
    cross3(ya, cF, cr);
    for (int k = 0; k < 3; ++k) {
      row[k] += Y[t * 9 + k] + dt * cr[k];
      row[3 + k] += Y[t * 9 + 3 + k];
      row[6 + k] += Y[t * 9 + 6 + k];
    }
  }
  if (t == 0)
    for (int k = 0; k < 9; ++k) row[k] += Y[H * 9 + k];
}

// rows of knot t of v <- A_f(F) y [+ bP]
template <typename T>
HD void x_residual_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F,
                        const T* y, const T* bP, T* v, int t) {
  T row[9];
  af_row(pr, in, F, y, t, row);
  for (int k = 0; k < 9; ++k) v[t * 9 + k] = bP ? row[k] + bP[t * 9 + k] : row[k];
}

// rows of knot t of out <- 2 (W y + rho A_f(F)^T v) [+ q]
template <typename T>
HD void x_operator_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F,
                        const T* y, const T* v, T rho, bool add_q, T* out, int t) {
  T row[9];
  af_applyT_row(pr, in, F, v, t, row);
  for (int k = 0; k < 9; ++k) {
    const int i = t * 9 + k;
    T val = T(2) * (in.W[i] * y[i] + rho * row[k]);
    if (add_q) val += in.ql[i];
    out[i] = val;
  }
}

// element i (knot t, component k) of diag(A_f(F)^T A_f(F)) (centroidal.af_diag)
template <typename T>
HD T af_diag_el(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* F, int i) {
  const int H = pr.H, t = i / 9, k = i % 9, grp = k / 3;
  const T lt = t < H ? T(1) : T(0), ge = t >= 1 ? T(1) : T(0), eq = t == 0 ? T(1) : T(0);
  if (grp == 0) {
    T cross = T(0);
    if (t < H) {
      T cF[3];
      cf_total(in, F, t, cF);
      const T cf2 = cF[0] * cF[0] + cF[1] * cF[1] + cF[2] * cF[2];
      const T dt = in.dt[t];
      cross = dt * dt * (cf2 - cF[k] * cF[k]);
    }
    return lt * (T(1) + cross) + ge + eq;
  }
  if (grp == 1) {
    const T dtp = t >= 1 ? in.dt[t - 1] : T(0);
    return lt + ge * (T(1) + dtp * dtp) + eq;
  }
  return lt + ge + eq;
}

// the F-step metric d0 of contact (t, n): 2 (mean(WF) + rho cnt dt^2
// (1/m^2 + 2|arm|^2/3)) + 1e-12 (centroidal.ax_diag_iso)
template <typename T>
HD T f_metric(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* X, T rho, int c) {
  const int t = c / NE, i0 = c * 3;
  T arm2 = T(0);
  for (int k = 0; k < 3; ++k) {
    const T a = in.r[i0 + k] - X[t * 9 + k];
    arm2 += a * a;
  }
  const T dt = in.dt[t];
  const T wf_iso = (in.WF[i0] + in.WF[i0 + 1] + in.WF[i0 + 2]) / T(3);
  const T d = in.cnt[c] * (dt * dt) * (pr.inv_m2 + T(2) * arm2 / T(3));
  return T(2) * (wf_iso + rho * d) + T(1e-12);
}

// exact per-foot friction-cone projection (pallas_admm.py:218-228)
template <typename T>
HD void soc_project(T mu, T* f) {
  const T fx = f[0], fy = f[1], fz = f[2];
  const T s = s_sqrt(fx * fx + fy * fy + T(1e-30));
  const bool inside = s <= mu * fz;
  const bool polar = mu * s <= -fz;
  const T coef = (mu * mu * s + mu * fz) / ((mu * mu + T(1)) * s);
  const T fz_surf = (mu * s + fz) / (mu * mu + T(1));
  if (inside) return;
  if (polar) {
    f[0] = f[1] = f[2] = T(0);
    return;
  }
  f[0] = fx * coef;
  f[1] = fy * coef;
  f[2] = fz_surf;
}

// Largest-eigenvalue estimate times power_safety of the PSD operator that
// apply(y, out) computes over n variables; with PRE, of the operator
// d^-1/2 H d^-1/2 for the metric d. power_iters normalised applications from
// a vector of ones, then the Rayleigh quotient. z, g, u: work arrays of n
// elements (u only with PRE).
template <bool PRE, typename T, class Apply, class Exec>
HD T power_lambda(const AdmmParams<T>& pr, int n, const T* d, T* z, T* g, T* u, T* part,
                  const Apply& apply, const Exec& exec) {
  exec([&](int lane) {
    for (int i = lane; i < n; i += LANES) z[i] = T(1);
  });
  auto step = [&]() {  // g <- op(z)
    if (PRE) {
      exec([&](int lane) {
        for (int i = lane; i < n; i += LANES) u[i] = z[i] / s_sqrt(d[i]);
      });
      apply(u, g);
      exec([&](int lane) {
        for (int i = lane; i < n; i += LANES) g[i] = g[i] / s_sqrt(d[i]);
      });
    } else {
      apply(z, g);
    }
  };
  for (int p = 0; p < pr.power_iters; ++p) {
    step();
    exec([&](int lane) {
      T s = T(0);
      for (int i = lane; i < n; i += LANES) s += g[i] * g[i];
      part[lane] = s;
    });
    const T nrm = s_sqrt(sum_parts(part, 0)) + T(1e-30);
    exec([&](int lane) {
      for (int i = lane; i < n; i += LANES) z[i] = g[i] / nrm;
    });
  }
  step();
  exec([&](int lane) {
    T num = T(0), den = T(0);
    for (int i = lane; i < n; i += LANES) {
      num += z[i] * g[i];
      den += z[i] * z[i];
    }
    part[lane] = num;
    part[LANES + lane] = den;
  });
  return pr.power_safety * sum_parts(part, 0) / (sum_parts(part, LANES) + T(1e-30));
}

// Projected FISTA iterations from x = y = the values already in xk and yk.
// grad() writes the gradient at yk; step(lane, beta) takes the lane's
// elements of yk to the projected step yn, leaves their squared change in
// part[lane] and applies the momentum update to them at once (yk <- yn +
// beta (yn - xk), xk <- yn: an element's update reads no other element).
// Returns the iterations run.
template <typename T, class Grad, class Step, class Exec>
HD int fista_loop(const AdmmParams<T>& pr, const T* part, const Grad& grad, const Step& step,
                  const Exec& exec) {
  const T tol2 = pr.fista_tol * pr.fista_tol;
  T tk = T(1);
  int k = 0;
  while (k < pr.fista_max_iters) {
    const T tn = T(1) + s_sqrt(T(1) + T(4) * tk * tk) / T(2);  // reference momentum
    const T beta = (tk - T(1)) / tn;
    grad();
    exec([&](int lane) { step(lane, beta); });
    const T g2 = sum_parts(part, 0);
    tk = tn;
    ++k;
    if (!(g2 >= tol2)) break;
  }
  return k;
}

// The F subproblem from the current X, P: w.xk <- F_new, in the Jacobi
// metric with PRE. Returns the FISTA iterations run.
template <bool PRE, typename T, class Exec>
HD int f_step(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w, T rho,
              const Exec& exec) {
  const int H = pr.H;
  const int nX = (H + 1) * 9, nF = H * NE * 3;
  long long t = exec.prof.now();
  exec([&](int lane) {
    for (int i = lane; i < nX; i += LANES) w.bP[i] = w.P[i] - bx_el(pr, in, w.X, i);
    if (PRE) {
      for (int c = lane; c < H * NE; c += LANES) {
        const T d0 = f_metric(pr, in, w.X, rho, c);
        for (int q = 0; q < 3; ++q) w.Fd[c * 3 + q] = d0;
      }
    }
  });
  auto apply = [&](const T* y, T* out) {
    exec([&](int lane) {
      for (int t = lane; t < H; t += LANES)
        f_operator_knot(pr, in, w.X, y, (const T*)nullptr, rho, false, out + t * NE * 3, t);
    });
  };
  const T Lf = power_lambda<PRE>(pr, nF, w.Fd, w.z, w.g, w.Fu, w.part, apply, exec);
  exec.prof.add(PH_F_POWER, t);
  t = exec.prof.now();
  exec([&](int lane) {
    for (int i = lane; i < nF; i += LANES) {
      w.xk[i] = w.yk[i] = w.F[i];
      if (PRE) {
        w.Fd[i] = Lf * w.Fd[i];
      }
    }
  });
  // a FISTA iteration is one phase, a knot per lane: knot t's gradient reads
  // the forces at knot t only, so its lane takes them on through the step
  auto step = [&](int lane, T beta) {  // y_next = proj(y - grad / D) of the knot's feet
    T s = T(0);
    for (int t = lane; t < H; t += LANES) {
      T gk[NE * 3];
      f_operator_knot(pr, in, w.X, w.yk, w.bP, rho, true, gk, t);
      for (int n = 0; n < NE; ++n) {
        const int c = t * NE + n;
        T f[3];
        for (int q = 0; q < 3; ++q) {
          if (PRE) {
            f[q] = w.yk[c * 3 + q] - gk[n * 3 + q] / w.Fd[c * 3 + q];
          } else {
            f[q] = w.yk[c * 3 + q] - gk[n * 3 + q] / Lf;
          }
        }
        soc_project(pr.mu, f);
        for (int q = 0; q < 3; ++q) {
          const int i = c * 3 + q;
          const T yn = f[q], dd = yn - w.yk[i];
          s += dd * dd;
          w.yk[i] = yn + beta * (yn - w.xk[i]);
          w.xk[i] = yn;
        }
      }
    }
    w.part[lane] = s;
  };
  const int k = fista_loop(pr, w.part, [] {}, step, exec);
  exec.prof.add(PH_F_FISTA, t);
  return k;
}

// The X subproblem by projected FISTA onto the box from x = X: w.Xn <- X_new,
// in the Jacobi metric with PRE.
template <bool PRE, typename T, class Exec>
HD void fista_x(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                const T* F, T rho, const Exec& exec) {
  const int H = pr.H;
  const int nX = (H + 1) * 9;
  exec([&](int lane) {  // bP <- P - b_f(F), the metric, the start point
    for (int t = lane; t <= H; t += LANES) {
      T row[9];
      bf_row(pr, in, F, t, row);
      for (int k = 0; k < 9; ++k) w.bP[t * 9 + k] = w.P[t * 9 + k] - row[k];
    }
    for (int i = lane; i < nX; i += LANES) {
      w.Xn[i] = w.Xy[i] = w.X[i];
      if (PRE) {
        w.Xd[i] = T(2) * (in.W[i] + rho * af_diag_el(pr, in, F, i)) + T(1e-12);
      }
    }
  });
  auto apply = [&](const T* y, T* out) {
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES)
        x_residual_knot(pr, in, F, y, (const T*)nullptr, w.v, t);
    });
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES) x_operator_knot(pr, in, F, y, w.v, rho, false, out, t);
    });
  };
  const T Lx = power_lambda<PRE>(pr, nX, w.Xd, w.Xz, w.Xg, w.Xu, w.part, apply, exec);
  if (PRE) {
    exec([&](int lane) {
      for (int i = lane; i < nX; i += LANES) w.Xd[i] = Lx * w.Xd[i];
    });
  }
  auto grad = [&]() {
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES) x_residual_knot(pr, in, F, w.Xy, w.bP, w.v, t);
    });
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES) x_operator_knot(pr, in, F, w.Xy, w.v, rho, true, w.Xg, t);
    });
  };
  auto step = [&](int lane, T beta) {  // y_next = clip(y - grad / D, lb, ub)
    T s = T(0);
    for (int i = lane; i < nX; i += LANES) {
      const T y = w.Xy[i];
      T yn;
      if (PRE) {
        yn = y - w.Xg[i] / w.Xd[i];
      } else {
        yn = y - w.Xg[i] / Lx;
      }
      yn = s_min(s_max(yn, in.lb[i]), in.ub[i]);
      s += (yn - y) * (yn - y);
      w.Xy[i] = yn + beta * (yn - w.Xn[i]);
      w.Xn[i] = yn;
    }
    w.part[lane] = s;
  };
  fista_loop(pr, w.part, grad, step, exec);
}

// solve (L L') y = y in place for one 9-vector, L lower (only the lower
// triangle is read)
template <typename T>
HD void chol_solve9(const T* L, T* y) {
  BK_UNROLL
  for (int j = 0; j < 9; ++j) {
    const T yj = y[j] / L[j * 9 + j];
    BK_UNROLL
    for (int i = j + 1; i < 9; ++i) y[i] -= L[i * 9 + j] * yj;
    y[j] = yj;
  }
  BK_UNROLL
  for (int j = 8; j >= 0; --j) {
    const T yj = y[j] / L[j * 9 + j];
    BK_UNROLL
    for (int i = 0; i < j; ++i) y[i] -= L[j * 9 + i] * yj;
    y[j] = yj;
  }
}

// G = dt skew(cF_t)
template <typename T>
HD void g_block(const AdmmInputs<T>& in, const T* F, int t, T* G) {
  T c[3];
  cf_total(in, F, t, c);
  const T dt = in.dt[t];
  G[0] = T(0);       G[1] = -dt * c[2]; G[2] = dt * c[1];
  G[3] = dt * c[2];  G[4] = T(0);       G[5] = -dt * c[0];
  G[6] = -dt * c[1]; G[7] = dt * c[0];  G[8] = T(0);
}

// entry (i, j) of M_k = 2 W_k + 2 rho A, A = 1_{k<H} D_k'D_k + 1_{k>0}
// E_{k-1}'E_{k-1} + 1_{k=0} I, with G = g_block(k) for k < H:
//   D'D = [[I+G'G, 0, G'],[0,I,0],[G,0,I]],
//   E'E = [[I, -dt I, 0],[-dt I, (1+dt^2) I, 0],[0,0,I]]
// (each entry gets its terms in this order)
template <typename T>
HD T m_el(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const T* G, int k, T rho, int i,
          int j) {
  T A = T(0);
  if (k < pr.H) {
    if (i < 3 && j < 3) {
      T gtg = T(0);
      for (int r = 0; r < 3; ++r) gtg += G[r * 3 + i] * G[r * 3 + j];
      A = (i == j ? T(1) : T(0)) + gtg;
    } else if (i < 3 && j >= 6) {
      A = G[(j - 6) * 3 + i];
    } else if (i >= 6 && j < 3) {
      A = G[(i - 6) * 3 + j];
    }
    if (i == j && i >= 3) A += T(1);
  }
  if (k > 0) {
    const T dt = in.dt[k - 1];
    if (i == j) A += (i >= 3 && i < 6) ? T(1) + dt * dt : T(1);
    if ((i < 3 && j == i + 3) || (j < 3 && i == j + 3)) A += -dt;
  }
  if (k == 0 && i == j) A += T(1);
  return (i == j ? T(2) * in.W[k * 9 + i] : T(0)) + T(2) * rho * A;
}

// entry (i, j) of U_k = 2 rho D_k'E_k = 2 rho [[-I, dt I, -G'],[0,-I,0],[0,0,-I]]
template <typename T>
HD T u_el(const AdmmInputs<T>& in, const T* G, int k, T rho, int i, int j) {
  T u = T(0);
  if (i == j)
    u = -T(1);
  else if (i < 3 && j == i + 3)
    u = in.dt[k];
  else if (i < 3 && j >= 6)
    u = -G[(j - 6) * 3 + i];
  return u * (T(2) * rho);
}

// exact X-subproblem minimizer clipped to the box -> w.Xn. The knot sweep is
// sequential. Within a knot: the 9x9 Cholesky of C_k (right-looking,
// pallas_admm.py:316-331) on one lane with the block's lower triangle in
// registers (a 9x9 factor is ~300 operations on a chain of square roots and
// divisions: split over the lanes, one barrier-separated phase per column,
// it took 2.6x longer on the card); the [U | y] solve a column per lane; the
// Schur update of the next block's lower triangle and right-hand side by the
// lane that solved the column it reads, building only the entries of M_{k+1}
// and U_k it needs;
// the back-substitution by row. Two phases a knot.
template <typename T, class Exec>
HD void thomas_x(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                 const T* F, T rho, const Exec& exec) {
  const int H = pr.H;
  // rhs = -q + 2 rho A_f'(b_f - P), kept in w.dk and overwritten by d_k
  exec([&](int lane) {
    for (int t = lane; t <= H; t += LANES) {
      T row[9];
      bf_row(pr, in, F, t, row);
      for (int k = 0; k < 9; ++k) w.v[t * 9 + k] = row[k] - w.P[t * 9 + k];
    }
  });
  exec([&](int lane) {
    T G[9];
    g_block(in, F, 0, G);
    for (int t = lane; t <= H; t += LANES) {
      T row[9];
      af_applyT_row(pr, in, F, w.v, t, row);
      for (int k = 0; k < 9; ++k) w.dk[t * 9 + k] = -in.ql[t * 9 + k] + T(2) * rho * row[k];
    }
    for (int e = lane; e < 81; e += LANES)  // C_0 = M_0 (the factor reads the lower triangle)
      if (e % 9 <= e / 9) w.Cm[e] = m_el(pr, in, G, 0, rho, e / 9, e % 9);
  });
  exec([&](int lane) {
    for (int a = lane; a < 9; a += LANES) w.yv[a] = w.dk[a];
  });
  for (int k = 0; k <= H; ++k) {
    const long long t_chol = exec.prof.now();
    exec([&](int lane) {  // the factor on one lane, in registers
      if (lane != 0) return;
      T A[45];  // the lower triangle, packed by rows
      BK_UNROLL
      for (int a = 0; a < 9; ++a) {
        BK_UNROLL
        for (int b = 0; b <= a; ++b) A[a * (a + 1) / 2 + b] = w.Cm[a * 9 + b];
      }
      BK_UNROLL
      for (int j = 0; j < 9; ++j) {
        const T d = s_sqrt(s_max(A[j * (j + 1) / 2 + j], T(1e-30)));
        T col[9];
        BK_UNROLL
        for (int i = j + 1; i < 9; ++i) col[i] = A[i * (i + 1) / 2 + j] / d;
        w.Lm[j * 9 + j] = d;
        BK_UNROLL
        for (int i = j + 1; i < 9; ++i) w.Lm[i * 9 + j] = col[i];
        BK_UNROLL
        for (int a = j + 1; a < 9; ++a) {
          BK_UNROLL
          for (int b = j + 1; b <= a; ++b) A[a * (a + 1) / 2 + b] -= col[a] * col[b];
        }
      }
    });
    exec.prof.add(PH_CHOL, t_chol);
    if (k == H) {
      exec([&](int lane) {
        if (lane != 0) return;
        T y[9];
        for (int a = 0; a < 9; ++a) y[a] = w.yv[a];
        chol_solve9(w.Lm, y);
        for (int a = 0; a < 9; ++a) w.dk[H * 9 + a] = y[a];
      });
      break;
    }
    exec([&](int lane) {
      // column c of C_k^-1 [U_k | y_k] on lane c, and what it alone feeds:
      // for c < 9 column c of W_k and the lower entries of column c of
      // C_{k+1} = M_{k+1} - U_k' W_k; for c = 9 d_k and y_{k+1} = rhs_{k+1} -
      // U_k' d_k
      T G[9], G1[9];
      g_block(in, F, k, G);
      if (k + 1 < H) g_block(in, F, k + 1, G1);
      for (int c = lane; c < 10; c += LANES) {
        T col[9];
        BK_UNROLL
        for (int i = 0; i < 9; ++i) col[i] = c < 9 ? u_el(in, G, k, rho, i, c) : w.yv[i];
        chol_solve9(w.Lm, col);
        BK_UNROLL
        for (int a = 0; a < 9; ++a) {  // col stays in registers: constant indices only
          if (c < 9)
            w.Wk[k * 81 + a * 9 + c] = col[a];
          else
            w.dk[k * 9 + a] = col[a];
        }
        for (int a = c < 9 ? c : 0; a < 9; ++a) {
          T s = T(0);
          BK_UNROLL
          for (int j = 0; j < 9; ++j) s += u_el(in, G, k, rho, j, a) * col[j];
          if (c < 9)
            w.Cm[a * 9 + c] = m_el(pr, in, G1, k + 1, rho, a, c) - s;
          else
            w.yv[a] = w.dk[(k + 1) * 9 + a] - s;
        }
      }
    });
  }
  // back-substitution x_k = d_k - W_k x_{k+1}, then the box clip
  exec([&](int lane) {
    for (int a = lane; a < 9; a += LANES) w.Xn[H * 9 + a] = w.dk[H * 9 + a];
  });
  for (int k = H - 1; k >= 0; --k)
    exec([&](int lane) {
      for (int a = lane; a < 9; a += LANES) {
        T s = T(0);
        for (int j = 0; j < 9; ++j) s += w.Wk[k * 81 + a * 9 + j] * w.Xn[(k + 1) * 9 + j];
        w.Xn[k * 9 + a] = w.dk[k * 9 + a] - s;
      }
    });
  exec([&](int lane) {
    for (int i = lane; i < (H + 1) * 9; i += LANES)
      w.Xn[i] = s_min(s_max(w.Xn[i], in.lb[i]), in.ub[i]);
  });
}

// The ADMM of one problem on LANES lanes from the warm start already in w.X
// and w.F, with the X-step by FISTA (XF) or block-Thomas and the FISTA solves
// in the Jacobi metric (PRE) or not; exec(f) calls f(lane) on every lane and
// then waits for all of them (a warp barrier on the card, a loop over the
// lanes on the host). Code outside exec runs on every lane alike: the loop
// decisions are taken from partial sums the lanes left in w.part, so the
// lanes of a problem always agree; problems never wait for
// each other. Leaves X, F in w.X, w.F; fista_out counts the F-step's FISTA
// iterations.
template <bool XF, bool PRE, typename T, class Exec>
HD void admm_branch(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                    T* viol_out, int* iters_out, int* fista_out, const Exec& exec) {
  const int H = pr.H;
  const int nX = (H + 1) * 9, nF = H * NE * 3;
  exec([&](int lane) {
    for (int i = lane; i < nX; i += LANES) w.P[i] = T(0);
  });
  T rho = pr.rho, viol2 = T(3.0e38), chk = T(3.0e38);
  int iters = 0, fista_total = 0;
  const T exit2 = pr.exit_tol * pr.exit_tol;
  const long long t_all = exec.prof.now();
  for (int it = 0; it < pr.max_admm_iters; ++it) {
    fista_total += f_step<PRE>(pr, in, w, rho, exec);
    long long t = exec.prof.now();
    if (XF) {
      fista_x<PRE>(pr, in, w, w.xk, rho, exec);
      exec.prof.add(PH_X_FISTA, t);
    } else {
      thomas_x(pr, in, w, w.xk, rho, exec);
      exec.prof.add(PH_THOMAS, t);
    }
    t = exec.prof.now();

    // ---- dual update, convergence, rho schedule ----
    exec([&](int lane) {
      T s = T(0);
      for (int t = lane; t <= H; t += LANES) {
        T a[9], b[9];
        af_row(pr, in, w.xk, w.Xn, t, a);
        bf_row(pr, in, w.xk, t, b);
        for (int k = 0; k < 9; ++k) {
          const T vv = a[k] - b[k];
          s += vv * vv;
          w.P[t * 9 + k] += pr.dual_relax * vv;
        }
      }
      w.part[lane] = s;
    });
    const T v2 = sum_parts(w.part, 0);
    exec([&](int lane) {
      for (int i = lane; i < nX; i += LANES) w.X[i] = w.Xn[i];
      for (int i = lane; i < nF; i += LANES) w.F[i] = w.xk[i];
    });
    viol2 = v2;
    iters += 1;
    const bool act = (viol2 >= exit2) && (viol2 == viol2);
    if (pr.rho_growth != T(1)) {
      const bool cond = ((it + 1) % pr.rho_growth_every) == 0;
      const bool capok = rho * pr.rho_growth <= pr.rho * pr.rho_max_scale;
      T g;
      if (pr.rho_stall_gate) {
        const T si = pr.rho_stall_improve, bt = pr.rho_backoff_thresh;
        const bool stalled = viol2 > si * si * chk;
        const bool diverged = viol2 > bt * bt * chk;
        const bool flook = rho >= pr.rho * pr.rho_growth * T(0.999);
        const bool grow = cond && act && stalled && !diverged && capok;
        const bool back = cond && act && diverged && flook;
        g = (grow ? pr.rho_growth : T(1)) * (back ? T(1) / pr.rho_growth : T(1));
        if (cond) chk = viol2;
      } else {
        g = (cond && capok && act) ? pr.rho_growth : T(1);
      }
      rho = rho * g;
      exec([&](int lane) {
        for (int i = lane; i < nX; i += LANES) w.P[i] = w.P[i] / g;
      });
    }
    if (it == 0) chk = s_min(chk, viol2);  // seed the stall checkpoint
    exec.prof.add(PH_DUAL, t);
    if (!act) break;
  }
  exec.prof.add(PH_TOTAL, t_all);
  exec([&](int lane) {
    if (lane != 0) return;
    *viol_out = s_sqrt(viol2);
    *iters_out = iters;
    *fista_out = fista_total;
  });
}

// admm_branch with the configuration's branch: each of the four is compiled
// on its own, so the flags cost the main path's branch nothing
template <typename T, class Exec>
HD void admm_problem(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                     T* viol_out, int* iters_out, int* fista_out, const Exec& exec) {
  if (pr.x_fista) {
    if (pr.precondition)
      admm_branch<true, true>(pr, in, w, viol_out, iters_out, fista_out, exec);
    else
      admm_branch<true, false>(pr, in, w, viol_out, iters_out, fista_out, exec);
  } else {
    if (pr.precondition)
      admm_branch<false, true>(pr, in, w, viol_out, iters_out, fista_out, exec);
    else
      admm_branch<false, false>(pr, in, w, viol_out, iters_out, fista_out, exec);
  }
}

template <typename T>
AdmmParams<T> make_params(int H, int max_admm_iters, int fista_max_iters, int power_iters,
                          int rho_growth_every, int rho_stall_gate, int x_fista, int precondition,
                          double m, double rho, double fista_tol, double exit_tol, double mu,
                          double power_safety, double dual_relax, double rho_growth,
                          double rho_max_scale, double rho_stall_improve,
                          double rho_backoff_thresh) {
  return AdmmParams<T>{H, max_admm_iters, fista_max_iters, power_iters, rho_growth_every,
                       rho_stall_gate, x_fista, precondition, T(m), T(1.0 / (m * m)), T(rho),
                       T(fista_tol), T(exit_tol), T(mu), T(power_safety), T(dual_relax),
                       T(rho_growth), T(rho_max_scale), T(rho_stall_improve),
                       T(rho_backoff_thresh)};
}

}  // namespace bk

// The scalar ADMM settings of a C entry point, in this order (both kernels).
#define ADMM_CFG_ARGS                                                                     \
  int H, int max_admm_iters, int fista_max_iters, int power_iters, int rho_growth_every,  \
      int rho_stall_gate, int x_fista, int precondition, double m, double rho,            \
      double fista_tol, double exit_tol, double mu, double power_safety, double dual_relax, \
      double rho_growth, double rho_max_scale, double rho_stall_improve,                  \
      double rho_backoff_thresh
#define ADMM_PARAMS(T)                                                                      \
  bk::make_params<T>(H, max_admm_iters, fista_max_iters, power_iters, rho_growth_every,     \
                     rho_stall_gate, x_fista, precondition, m, rho, fista_tol, exit_tol, mu, \
                     power_safety, dual_relax, rho_growth, rho_max_scale, rho_stall_improve, \
                     rho_backoff_thresh)
