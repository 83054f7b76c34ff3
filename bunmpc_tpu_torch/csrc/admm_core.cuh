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
// the cone projection by foot, the norms as per-lane partial sums, the Thomas
// sweep's block solve by column and its Schur update by entry — with a warp
// barrier between phases, so problems never wait for each other. The Pallas
// kernel freezes a lane once it converges, so a problem's result depends on
// its own data only; here each problem leaves its loops on its own. The
// per-problem work arrays live in a batch-last scratch buffer (element i of
// problem b at i*B + b); each 9x9 Cholesky runs on one lane, the knot sweep
// stays sequential. Compiled with g++ (no __CUDACC__) the same phases run on
// the host with the lanes of a phase one after another, for the CPU tests.

#pragma once

#include "common.cuh"

namespace bk {

constexpr int NE = 4;  // feet (the wrappers check)
constexpr int LANES = 32;  // threads per problem: one warp
constexpr double G_ACC = 9.81;

template <typename T>
struct AdmmParams {
  int H, max_admm_iters, fista_max_iters, power_iters, rho_growth_every, rho_stall_gate,
      x_fista, precondition;
  T m, inv_m2, rho, fista_tol, exit_tol, mu, power_safety, dual_relax, rho_growth,
      rho_max_scale, rho_stall_improve, rho_backoff_thresh;
};

// read-only inputs of one problem, (B, ...) row-major, offset to problem b
template <typename T>
struct AdmmInputs {
  const T *cnt, *r, *dt, *x_init, *W, *ql, *WF, *qF, *lb, *ub;
};

// per-problem work arrays (batch-last scratch)
template <typename T>
struct AdmmWork {
  Strided<T> X, P, Xn, bP, dk, v, F, xk, yk, g, z, Wk;
  Strided<T> part;          // per lane: partial sums (2 * LANES)
  Strided<T> Cm, Lm, Sol, yv;  // the current knot's block, factor, [U | y], y
  Strided<T> Fu, Fd;        // F-step: preconditioned operand, metric
  Strided<T> Xy, Xg, Xz, Xu, Xd;  // X-step FISTA: momentum point, gradient, power vector, operand, metric
};

// Scratch elements per problem of the layout make_work cuts.
HD long admm_scratch_elems(int H) {
  const long nX = (H + 1) * 9L, nF = H * NE * 3L;
  return 11 * nX + 7 * nF + H * 81L + 2L * LANES + 81 + 81 + 90 + 9;
}

// The work arrays of problem b in a batch-last scratch buffer of B problems.
template <typename T>
HD AdmmWork<T> make_work(T* scratch, int b, int B, int H) {
  const long nX = (H + 1) * 9L, nF = H * NE * 3L;
  long off = 0;
  auto take = [&](long n) {
    Strided<T> s{scratch + off * B + b, B};
    off += n;
    return s;
  };
  AdmmWork<T> w;
  w.X = take(nX); w.P = take(nX); w.Xn = take(nX); w.bP = take(nX); w.dk = take(nX);
  w.v = take(nX); w.F = take(nF); w.xk = take(nF); w.yk = take(nF); w.g = take(nF);
  w.z = take(nF); w.Wk = take(H * 81L);
  w.part = take(2 * LANES); w.Cm = take(81); w.Lm = take(81); w.Sol = take(90); w.yv = take(9);
  w.Fu = take(nF); w.Fd = take(nF);
  w.Xy = take(nX); w.Xg = take(nX); w.Xz = take(nX); w.Xu = take(nX); w.Xd = take(nX);
  return w;
}

// sum of the lanes' partial sums part[off .. off + LANES)
template <typename T>
HD T sum_parts(const Strided<T>& part, int off) {
  T s = T(0);
  for (int l = 0; l < LANES; ++l) s += part[off + l];
  return s;
}

// rows of knot t of out <- 2 (WF y + rho A_x(X)^T (A_x(X) y + bP)) [+ qF]; bP
// and qF optional. A_x rows 0..2 are zero and A_x^T reads rows 3..8 of knots
// t < H only, so the two stencils fuse per knot.
template <typename T>
HD void f_operator_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& X,
                        const Strided<T>& y, const Strided<T>* bP, T rho, bool add_qF,
                        const Strided<T>& out, int t) {
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
      yl[k] += (*bP)[t * 9 + 3 + k];
      ya[k] += (*bP)[t * 9 + 6 + k];
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
      out[i0 + k] = val;
    }
  }
}

// element i of b_x(X) (rows t < H; the terminal row is zero)
template <typename T>
HD T bx_el(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& X, int i) {
  const int t = i / 9, k = i % 9;
  if (t == pr.H || k < 3) return T(0);
  T d = X[(t + 1) * 9 + k] - X[t * 9 + k];
  if (k == 5) d += T(G_ACC) * in.dt[t];
  return d;
}

template <typename T>
HD void cf_total(const AdmmInputs<T>& in, const Strided<T>& F, int t, T* cF) {
  cF[0] = cF[1] = cF[2] = T(0);
  for (int n = 0; n < NE; ++n) {
    const T c = in.cnt[t * NE + n];
    for (int k = 0; k < 3; ++k) cF[k] += c * F[(t * NE + n) * 3 + k];
  }
}

// b_f(F): rows t < H [0, -dt sum(cF)/m + g dt e_z, dt sum cF x r], row H x_init
template <typename T>
HD void bf_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F, int t,
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
HD void af_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F,
               const Strided<T>& X, int t, T* row) {
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
HD void af_applyT_row(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F,
                      const Strided<T>& Y, int t, T* row) {
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
HD void x_residual_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F,
                        const Strided<T>& y, const Strided<T>* bP, const Strided<T>& v, int t) {
  T row[9];
  af_row(pr, in, F, y, t, row);
  for (int k = 0; k < 9; ++k) v[t * 9 + k] = bP ? row[k] + (*bP)[t * 9 + k] : row[k];
}

// rows of knot t of out <- 2 (W y + rho A_f(F)^T v) [+ q]
template <typename T>
HD void x_operator_knot(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F,
                        const Strided<T>& y, const Strided<T>& v, T rho, bool add_q,
                        const Strided<T>& out, int t) {
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
HD T af_diag_el(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F, int i) {
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
HD T f_metric(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& X, T rho, int c) {
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
HD T power_lambda(const AdmmParams<T>& pr, int n, const Strided<T>& d, const Strided<T>& z,
                  const Strided<T>& g, const Strided<T>& u, const Strided<T>& part,
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
// grad() writes the gradient at yk into g; step(lane) overwrites the lane's
// elements of g with the projected step from yk and leaves their squared
// change in part[lane]. Returns the iterations run.
template <typename T, class Grad, class Step, class Exec>
HD int fista_loop(const AdmmParams<T>& pr, int n, const Strided<T>& xk, const Strided<T>& yk,
                  const Strided<T>& g, const Strided<T>& part, const Grad& grad,
                  const Step& step, const Exec& exec) {
  const T tol2 = pr.fista_tol * pr.fista_tol;
  T tk = T(1);
  int k = 0;
  while (k < pr.fista_max_iters) {
    grad();
    exec(step);
    const T g2 = sum_parts(part, 0);
    const T tn = T(1) + s_sqrt(T(1) + T(4) * tk * tk) / T(2);  // reference momentum
    const T beta = (tk - T(1)) / tn;
    exec([&](int lane) {
      for (int i = lane; i < n; i += LANES) {
        const T yn = g[i];
        yk[i] = yn + beta * (yn - xk[i]);
        xk[i] = yn;
      }
    });
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
  exec([&](int lane) {
    for (int i = lane; i < nX; i += LANES) w.bP[i] = w.P[i] - bx_el(pr, in, w.X, i);
    if (PRE) {
      for (int c = lane; c < H * NE; c += LANES) {
        const T d0 = f_metric(pr, in, w.X, rho, c);
        for (int q = 0; q < 3; ++q) w.Fd[c * 3 + q] = d0;
      }
    }
  });
  auto apply = [&](const Strided<T>& y, const Strided<T>& out) {
    exec([&](int lane) {
      for (int t = lane; t < H; t += LANES)
        f_operator_knot(pr, in, w.X, y, (const Strided<T>*)nullptr, rho, false, out, t);
    });
  };
  const T Lf = power_lambda<PRE>(pr, nF, w.Fd, w.z, w.g, w.Fu, w.part, apply, exec);
  exec([&](int lane) {
    for (int i = lane; i < nF; i += LANES) {
      w.xk[i] = w.yk[i] = w.F[i];
      if (PRE) {
        w.Fd[i] = Lf * w.Fd[i];
      }
    }
  });
  auto grad = [&]() {
    exec([&](int lane) {
      for (int t = lane; t < H; t += LANES)
        f_operator_knot(pr, in, w.X, w.yk, &w.bP, rho, true, w.g, t);
    });
  };
  auto step = [&](int lane) {  // y_next = proj(y - grad / D), a foot per lane
    T s = T(0);
    for (int c = lane; c < H * NE; c += LANES) {
      T f[3];
      for (int q = 0; q < 3; ++q) {
        if (PRE) {
          f[q] = w.yk[c * 3 + q] - w.g[c * 3 + q] / w.Fd[c * 3 + q];
        } else {
          f[q] = w.yk[c * 3 + q] - w.g[c * 3 + q] / Lf;
        }
      }
      soc_project(pr.mu, f);
      for (int q = 0; q < 3; ++q) {
        w.g[c * 3 + q] = f[q];
        const T dd = f[q] - w.yk[c * 3 + q];
        s += dd * dd;
      }
    }
    w.part[lane] = s;
  };
  return fista_loop(pr, nF, w.xk, w.yk, w.g, w.part, grad, step, exec);
}

// The X subproblem by projected FISTA onto the box from x = X: w.Xn <- X_new,
// in the Jacobi metric with PRE.
template <bool PRE, typename T, class Exec>
HD void fista_x(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                const Strided<T>& F, T rho, const Exec& exec) {
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
  auto apply = [&](const Strided<T>& y, const Strided<T>& out) {
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES)
        x_residual_knot(pr, in, F, y, (const Strided<T>*)nullptr, w.v, t);
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
      for (int t = lane; t <= H; t += LANES) x_residual_knot(pr, in, F, w.Xy, &w.bP, w.v, t);
    });
    exec([&](int lane) {
      for (int t = lane; t <= H; t += LANES) x_operator_knot(pr, in, F, w.Xy, w.v, rho, true, w.Xg, t);
    });
  };
  auto step = [&](int lane) {  // y_next = clip(y - grad / D, lb, ub)
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
      w.Xg[i] = yn;
      s += (yn - y) * (yn - y);
    }
    w.part[lane] = s;
  };
  fista_loop(pr, nX, w.Xn, w.Xy, w.Xg, w.part, grad, step, exec);
}

// lower Cholesky factor of a 9x9 SPD block, right-looking (pallas_admm.py:316-331)
template <typename T>
HD void chol9(const T* A_in, T* L) {
  T A[81];
  for (int i = 0; i < 81; ++i) {
    A[i] = A_in[i];
    L[i] = T(0);
  }
  for (int j = 0; j < 9; ++j) {
    const T d = s_sqrt(s_max(A[j * 9 + j], T(1e-30)));
    T col[9];
    for (int i = 0; i < 9; ++i) col[i] = i > j ? A[i * 9 + j] / d : (i == j ? d : T(0));
    for (int i = 0; i < 9; ++i) L[i * 9 + j] = col[i];
    for (int i = 0; i < 9; ++i)
      for (int k = 0; k < 9; ++k) A[i * 9 + k] -= col[i] * col[k];
  }
}

// solve (L L') Y = Y in place, Y (9, m) row-major with row stride ld
template <typename T>
HD void chol_solve9(const T* L, T* Y, int m, int ld) {
  for (int j = 0; j < 9; ++j) {
    const T dj = L[j * 9 + j];
    for (int c = 0; c < m; ++c) {
      const T yj = Y[j * ld + c] / dj;
      for (int i = j + 1; i < 9; ++i) Y[i * ld + c] -= L[i * 9 + j] * yj;
      Y[j * ld + c] = yj;
    }
  }
  for (int j = 8; j >= 0; --j) {
    const T dj = L[j * 9 + j];
    for (int c = 0; c < m; ++c) {
      const T yj = Y[j * ld + c] / dj;
      for (int i = 0; i < j; ++i) Y[i * ld + c] -= L[j * 9 + i] * yj;
      Y[j * ld + c] = yj;
    }
  }
}

// G = dt skew(cF_t)
template <typename T>
HD void g_block(const AdmmInputs<T>& in, const Strided<T>& F, int t, T* G) {
  T c[3];
  cf_total(in, F, t, c);
  const T dt = in.dt[t];
  G[0] = T(0);       G[1] = -dt * c[2]; G[2] = dt * c[1];
  G[3] = dt * c[2];  G[4] = T(0);       G[5] = -dt * c[0];
  G[6] = -dt * c[1]; G[7] = dt * c[0];  G[8] = T(0);
}

// M_k = 2 W_k + 2 rho (1_{k<H} D_k'D_k + 1_{k>0} E_{k-1}'E_{k-1} + 1_{k=0} I)
template <typename T>
HD void m_block(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const Strided<T>& F, int k,
                T rho, T* M) {
  T A[81];
  for (int i = 0; i < 81; ++i) A[i] = T(0);
  if (k < pr.H) {  // D'D = [[I+G'G, 0, G'],[0,I,0],[G,0,I]]
    T G[9];
    g_block(in, F, k, G);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T gtg = T(0);
        for (int r = 0; r < 3; ++r) gtg += G[r * 3 + i] * G[r * 3 + j];
        A[i * 9 + j] = (i == j ? T(1) : T(0)) + gtg;
        A[i * 9 + 6 + j] = G[j * 3 + i];
        A[(6 + i) * 9 + j] = G[i * 3 + j];
      }
    for (int i = 3; i < 9; ++i) A[i * 9 + i] += T(1);
  }
  if (k > 0) {  // E'E = [[I, -dt I, 0],[-dt I, (1+dt^2) I, 0],[0,0,I]]
    const T dt = in.dt[k - 1];
    for (int i = 0; i < 3; ++i) {
      A[i * 9 + i] += T(1);
      A[i * 9 + 3 + i] += -dt;
      A[(3 + i) * 9 + i] += -dt;
      A[(3 + i) * 9 + 3 + i] += T(1) + dt * dt;
      A[(6 + i) * 9 + 6 + i] += T(1);
    }
  }
  if (k == 0)
    for (int i = 0; i < 9; ++i) A[i * 9 + i] += T(1);
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j)
      M[i * 9 + j] = (i == j ? T(2) * in.W[k * 9 + i] : T(0)) + T(2) * rho * A[i * 9 + j];
}

// U_k = 2 rho D_k'E_k = 2 rho [[-I, dt I, -G'],[0,-I,0],[0,0,-I]]
template <typename T>
HD void u_block(const AdmmInputs<T>& in, const Strided<T>& F, int k, T rho, T* U) {
  T G[9];
  g_block(in, F, k, G);
  const T dt = in.dt[k];
  for (int i = 0; i < 81; ++i) U[i] = T(0);
  for (int i = 0; i < 3; ++i) {
    U[i * 9 + i] = -T(1);
    U[i * 9 + 3 + i] = dt;
    for (int j = 0; j < 3; ++j) U[i * 9 + 6 + j] = -G[j * 3 + i];
    U[(3 + i) * 9 + 3 + i] = -T(1);
    U[(6 + i) * 9 + 6 + i] = -T(1);
  }
  for (int i = 0; i < 81; ++i) U[i] *= T(2) * rho;
}

// exact X-subproblem minimizer clipped to the box -> w.Xn. The knot sweep is
// sequential; within a knot the lanes share the [U | y] solve (a column
// each), the Schur update of the next block and the back-substitution rows;
// the 9x9 Cholesky is lane 0's.
template <typename T, class Exec>
HD void thomas_x(const AdmmParams<T>& pr, const AdmmInputs<T>& in, const AdmmWork<T>& w,
                 const Strided<T>& F, T rho, const Exec& exec) {
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
    for (int t = lane; t <= H; t += LANES) {
      T row[9];
      af_applyT_row(pr, in, F, w.v, t, row);
      for (int k = 0; k < 9; ++k) w.dk[t * 9 + k] = -in.ql[t * 9 + k] + T(2) * rho * row[k];
    }
  });
  exec([&](int lane) {
    T M[81];
    m_block(pr, in, F, 0, rho, M);
    for (int e = lane; e < 81; e += LANES) w.Cm[e] = M[e];
    for (int a = lane; a < 9; a += LANES) w.yv[a] = w.dk[a];
  });
  for (int k = 0; k <= H; ++k) {
    exec([&](int lane) {
      if (lane != 0) return;
      T C[81], L[81];
      for (int e = 0; e < 81; ++e) C[e] = w.Cm[e];
      chol9(C, L);
      for (int e = 0; e < 81; ++e) w.Lm[e] = L[e];
    });
    if (k == H) {
      exec([&](int lane) {
        if (lane != 0) return;
        T L[81], y[9];
        for (int e = 0; e < 81; ++e) L[e] = w.Lm[e];
        for (int a = 0; a < 9; ++a) y[a] = w.yv[a];
        chol_solve9(L, y, 1, 1);
        for (int a = 0; a < 9; ++a) w.dk[H * 9 + a] = y[a];
      });
      break;
    }
    exec([&](int lane) {  // [U_k | y_k]
      T U[81];
      u_block(in, F, k, rho, U);
      for (int e = lane; e < 90; e += LANES) {
        const int i = e / 10, j = e % 10;
        w.Sol[e] = j < 9 ? U[i * 9 + j] : w.yv[i];
      }
    });
    exec([&](int lane) {  // C_k^-1 [U_k | y_k], a column per lane
      for (int c = lane; c < 10; c += LANES) {
        T L[81], col[9];
        for (int e = 0; e < 81; ++e) L[e] = w.Lm[e];
        for (int i = 0; i < 9; ++i) col[i] = w.Sol[i * 10 + c];
        chol_solve9(L, col, 1, 1);
        for (int i = 0; i < 9; ++i) w.Sol[i * 10 + c] = col[i];
      }
    });
    exec([&](int lane) {
      // W_k, d_k; C_{k+1} = M_{k+1} - U_k' W_k ; y_{k+1} = rhs_{k+1} - U_k' d_k
      T U[81], M[81];
      u_block(in, F, k, rho, U);
      m_block(pr, in, F, k + 1, rho, M);
      for (int e = lane; e < 81; e += LANES) {
        const int a = e / 9, b = e % 9;
        w.Wk[k * 81 + e] = w.Sol[a * 10 + b];
        T s = T(0);
        for (int j = 0; j < 9; ++j) s += U[j * 9 + a] * w.Sol[j * 10 + b];
        w.Cm[e] = M[e] - s;
      }
      for (int a = lane; a < 9; a += LANES) {
        w.dk[k * 9 + a] = w.Sol[a * 10 + 9];
        T s = T(0);
        for (int j = 0; j < 9; ++j) s += U[j * 9 + a] * w.Sol[j * 10 + 9];
        w.yv[a] = w.dk[(k + 1) * 9 + a] - s;
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
// decisions are taken from partial sums the lanes left in the scratch
// buffer, so the lanes of a problem always agree; problems never wait for
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
  for (int it = 0; it < pr.max_admm_iters; ++it) {
    fista_total += f_step<PRE>(pr, in, w, rho, exec);
    if (XF) {
      fista_x<PRE>(pr, in, w, w.xk, rho, exec);
    } else {
      thomas_x(pr, in, w, w.xk, rho, exec);
    }

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
    if (!act) break;
  }
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

#ifdef __CUDACC__
// a warp is one problem, a thread one lane; a phase ends at a warp barrier
struct DeviceExec {
  int lane;
  template <class F>
  __device__ void operator()(const F& f) const {
    f(lane);
    __syncwarp();
  }
};
#else
struct HostExec {
  template <class F>
  void operator()(const F& f) const {
    for (int lane = 0; lane < LANES; ++lane) f(lane);
  }
};
#endif

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
