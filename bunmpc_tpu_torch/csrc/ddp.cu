// K2: the whole kinematic Gauss-Newton DDP (the MPC's IK) of one problem per
// group of 16 CUDA threads.
//
// Replaces bunmpc_tpu/solvers/pallas_ddp.py:_build_kernel/solve_ik_batch:
// for n_iters iterations — Gauss-Newton stage data at every knot (FK, body
// velocities, centroidal momentum; the residual Jacobians from one
// hand-written 18-direction tangent pass through the same recursions, the
// momentum matrix from a velocity-tangent pass, the SE(3) chart blocks in
// closed form), a Riccati backward sweep with an 18x18 Cholesky of Quu
// (clamp rsqrt(max(d, 1e-20)), Levenberg term reg*I, symmetrized Vxx), then a
// line search: one cost-only rollout per alpha, the earliest alpha with the
// strictly lowest cost wins, and one storing rollout that is kept only if its
// cost is below the current one. The first rollout uses zero controls.
//
// What bounds it on an H100: about 2,050 floats in and out per problem (about
// 4.2 MB at B=512), so it is bound by f32 arithmetic: per iteration and knot
// the 18-direction tangent FK pass, the Gauss-Newton products and the Riccati
// step (Quu solve, Kfb'Qux update); per iteration len(alphas)+1 cost-only/storing
// rollouts. Design: LANES threads per problem run the DDP as phases separated
// by block barriers: the knots' Gauss-Newton data (independent per knot) and
// the alphas' cost-only rollouts are split over the lanes; lane 0 runs the
// serial Riccati sweep and the line-search decision. The robot constants come
// from the port's RobotModel as one small argument buffer (every thread reads
// the same address, so each load is a broadcast); per-problem trajectories,
// gains, the knots' 36x36 curvatures and the Riccati matrices live in a
// batch-last scratch buffer (element i of problem b at i*B + b), the FK caches
// and Jacobian rows in registers/local memory. The Riccati products use the
// block structure of the step Jacobians (6x6 base blocks plus scaled
// identities, as the Pallas kernel does). Splitting the Riccati step itself
// over the lanes is the next step.
//
// Built by bunmpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// (no fast math). Compiled with g++ instead (no __CUDACC__) it exports host
// loops over the same per-problem phases (the lanes of a phase run one after
// another), in float and double, for the CPU tests.

#include "common.cuh"

namespace bk {

constexpr int NJ = 12, NB = 13, NE = 4;
constexpr int NQ = 19, NV = 18, NX = 37, NDX = 36;
constexpr int NR = 3 * NE + 9 + NDX;  // 57 stage residual rows
constexpr int NRT = 9 + NDX;          // 45 terminal rows
constexpr int MAX_ALPHAS = 8;
constexpr int LANES = 16;  // threads per problem (>= H+1 knots, >= alphas)

// ---------------------------------------------------------------- model ----

// The buffer solvers/cuda_ddp.pack_model writes.
template <typename T>
struct ModelView {
  const T* b;
  HD int parent(int j) const { return (int)b[j]; }
  HD const T* jrot(int j) const { return b + 12 + 9 * j; }
  HD const T* jpos(int j) const { return b + 120 + 3 * j; }
  HD const T* axis(int j) const { return b + 156 + 3 * j; }
  HD T mass(int i) const { return b[192 + i]; }
  HD const T* com(int i) const { return b + 205 + 3 * i; }
  HD const T* inertia(int i) const { return b + 244 + 9 * i; }
  HD int foot_body(int f) const { return (int)b[361 + f]; }
  HD const T* foot_pos(int f) const { return b + 365 + 3 * f; }
  HD T total_mass() const { return b[377]; }
};

// ------------------------------------------------------- small 3D algebra --

template <typename T>
HD void mv3(const T* M, const T* v, T* o) {  // o = M v
  T a = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  T b = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  T c = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
  o[0] = a; o[1] = b; o[2] = c;
}
template <typename T>
HD void mtv3(const T* M, const T* v, T* o) {  // o = M' v
  T a = M[0] * v[0] + M[3] * v[1] + M[6] * v[2];
  T b = M[1] * v[0] + M[4] * v[1] + M[7] * v[2];
  T c = M[2] * v[0] + M[5] * v[1] + M[8] * v[2];
  o[0] = a; o[1] = b; o[2] = c;
}
template <typename T>
HD void mm3(const T* A, const T* B, T* C) {  // C = A B (C may not alias)
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j] + A[i * 3 + 2] * B[6 + j];
}
template <typename T>
HD void skew3(const T* w, T* K) {
  K[0] = T(0);  K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = T(0);  K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = T(0);
}

template <typename T>
HD void quat_to_rot(const T* q, T* R) {
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz);     R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);     R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);     R[7] = 2 * (yz + wx);     R[8] = 1 - 2 * (xx + yy);
}
template <typename T>
HD void quat_mul(const T* a, const T* b, T* o) {
  T x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  T y = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  T z = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  T w = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
  o[0] = x; o[1] = y; o[2] = z; o[3] = w;
}
template <typename T>
HD void exp3(const T* w, T* q) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-12);
  const T th = s_sqrt(small ? T(1) : sq);
  const T s = small ? T(0.5) - sq / T(48) : s_sin(T(0.5) * th) / th;
  const T c = small ? T(1) - sq / T(8) : s_cos(T(0.5) * th);
  q[0] = w[0] * s; q[1] = w[1] * s; q[2] = w[2] * s; q[3] = c;
}
template <typename T>
HD void log3(const T* q_in, T* w) {
  const T sg = q_in[3] < T(0) ? T(-1) : T(1);
  const T q[4] = {sg * q_in[0], sg * q_in[1], sg * q_in[2], sg * q_in[3]};
  const T sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
  const bool small = sq < T(1e-12);
  const T vn = s_sqrt(small ? T(1) : sq);
  const T angle = T(2) * s_atan2(vn, q[3]);
  const T ws = s_max(q[3], T(1e-9));
  const T scale = small ? (T(2) / ws) * (T(1) - sq / (T(3) * ws * ws)) : angle / vn;
  w[0] = q[0] * scale; w[1] = q[1] * scale; w[2] = q[2] * scale;
}

// SO(3) left Jacobian V(w) and its inverse
template <typename T>
HD void so3_V(const T* w, T* V) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-10);
  const T sqs = small ? T(1) : sq;
  const T t = s_sqrt(sqs);
  T K[9], K2[9];
  skew3(w, K);
  mm3(K, K, K2);
  const T a = small ? T(0.5) - sq / T(24) : (T(1) - s_cos(t)) / sqs;
  const T b = small ? T(1) / T(6) - sq / T(120) : (t - s_sin(t)) / (sqs * t);
  for (int i = 0; i < 9; ++i) V[i] = (i % 4 == 0 ? T(1) : T(0)) + a * K[i] + b * K2[i];
}
template <typename T>
HD void so3_Vinv(const T* w, T* Vi) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-10);
  const T sqs = small ? T(1) : sq;
  const T t = s_sqrt(sqs);
  T K[9], K2[9];
  skew3(w, K);
  mm3(K, K, K2);
  const T cot = (T(1) + s_cos(t)) / (T(2) * t * s_sin(t));
  const T b = small ? T(1) / T(12) + sq / T(720) : T(1) / sqs - cot;
  for (int i = 0; i < 9; ++i) Vi[i] = (i % 4 == 0 ? T(1) : T(0)) - T(0.5) * K[i] + b * K2[i];
}
// Barfoot's Q(rho, w) block of the SE(3) left Jacobian
template <typename T>
HD void se3_Q(const T* rho, const T* w, T* Q) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-8);
  const T sqs = small ? T(1) : sq;
  const T t = s_sqrt(sqs);
  T rx[9], wx[9], wxrx[9], rxwx[9], wxrxwx[9], A[9], Bm[9], C[9], D[9];
  skew3(rho, rx);
  skew3(w, wx);
  mm3(wx, rx, wxrx);
  mm3(rx, wx, rxwx);
  mm3(wxrx, wx, wxrxwx);
  const T c1 = small ? T(1) / T(6) - sq / T(120) : (t - s_sin(t)) / (sqs * t);
  const T c2 = small ? T(1) / T(24) - sq / T(720) : (sq / T(2) + s_cos(t) - T(1)) / (sqs * sqs);
  const T c3 = small ? T(-1) / T(120) + sq / T(5040)
                     : (t - s_sin(t) - t * sq / T(6)) / (sqs * sqs * t);
  mm3(wx, wxrx, A);
  mm3(rxwx, wx, Bm);
  mm3(wxrxwx, wx, C);
  mm3(wx, wxrxwx, D);
  for (int i = 0; i < 9; ++i)
    Q[i] = T(0.5) * rx[i] + c1 * (wxrx[i] + rxwx[i] + wxrxwx[i]) +
           c2 * (A[i] + Bm[i] - T(3) * wxrxwx[i]) + T(0.5) * (c2 + T(3) * c3) * (C[i] + D[i]);
}

// 6x6 blocks (row-major) from 3x3 quadrants
template <typename T>
HD void block6(const T* A, const T* B, const T* D, T* M) {  // [[A, B], [0, D]]
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      M[i * 6 + j] = A[i * 3 + j];
      M[i * 6 + 3 + j] = B[i * 3 + j];
      M[(3 + i) * 6 + j] = T(0);
      M[(3 + i) * 6 + 3 + j] = D[i * 3 + j];
    }
}
// Jr6(rho, w)^-1 = Jl6(-rho, -w)^-1 = [[Ji, -Ji Q Ji], [0, Ji]]
template <typename T>
HD void se3_Jr_inv(const T* rho, const T* w, T* M) {
  const T nr[3] = {-rho[0], -rho[1], -rho[2]}, nw[3] = {-w[0], -w[1], -w[2]};
  T Ji[9], Q[9], T1[9], T2[9];
  so3_Vinv(nw, Ji);
  se3_Q(nr, nw, Q);
  mm3(Ji, Q, T1);
  mm3(T1, Ji, T2);
  for (int i = 0; i < 9; ++i) T2[i] = -T2[i];
  block6(Ji, T2, Ji, M);
}
// Jr6(rho, w) = Jl6(-rho, -w) = [[V, Q], [0, V]]
template <typename T>
HD void se3_Jr(const T* rho, const T* w, T* M) {
  const T nr[3] = {-rho[0], -rho[1], -rho[2]}, nw[3] = {-w[0], -w[1], -w[2]};
  T V[9], Q[9];
  so3_V(nw, V);
  se3_Q(nr, nw, Q);
  block6(V, Q, V, M);
}
// Ad(Exp([rho, w])) = [[R, t^ R], [0, R]], R = exp(w^), t = V(w) rho
template <typename T>
HD void se3_adjoint_exp(const T* rho, const T* w, T* M) {
  T q[4], R[9], V[9], t[3], tx[9], tR[9];
  exp3(w, q);
  quat_to_rot(q, R);
  so3_V(w, V);
  mv3(V, rho, t);
  skew3(t, tx);
  mm3(tx, R, tR);
  block6(R, tR, R, M);
}

template <typename T>
HD void se3_integrate(const T* p, const T* q, const T* dv, const T* dw, T* p_out, T* q_out) {
  T R[9], V[9], a[3], b[3], e[4], qn[4];
  quat_to_rot(q, R);
  so3_V(dw, V);
  mv3(V, dv, a);
  mv3(R, a, b);
  exp3(dw, e);
  quat_mul(q, e, qn);
  const T n = s_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
  for (int k = 0; k < 3; ++k) p_out[k] = p[k] + b[k];
  for (int k = 0; k < 4; ++k) q_out[k] = qn[k] / n;
}
// local twist (dv, dw) with integrate(x1, (dv, dw)) == x2
template <typename T>
HD void se3_difference(const T* p1, const T* q1, const T* p2, const T* q2, T* dv, T* dw) {
  const T c1[4] = {-q1[0], -q1[1], -q1[2], q1[3]};
  T qr[4], R1[9], dp[3], dl[3], Vi[9];
  quat_mul(c1, q2, qr);
  log3(qr, dw);
  quat_to_rot(q1, R1);
  for (int k = 0; k < 3; ++k) dp[k] = p2[k] - p1[k];
  mtv3(R1, dp, dl);
  so3_Vinv(dw, Vi);
  mv3(Vi, dl, dv);
}

// x2 (-) x1 in the 2nv tangent
template <typename T>
HD void state_diff(const T* x1, const T* x2, T* d) {
  se3_difference(x1, x1 + 3, x2, x2 + 3, d, d + 3);
  for (int j = 0; j < NJ; ++j) d[6 + j] = x2[7 + j] - x1[7 + j];
  for (int i = 0; i < NV; ++i) d[NV + i] = x2[NQ + i] - x1[NQ + i];
}

// semi-implicit Euler: v+ = v + u dt, q+ = integrate(q, v+ dt)
template <typename T>
HD void step(const T* x, const T* u, T dt, T* xn) {
  T vn[NV], dv[3], dw[3];
  for (int i = 0; i < NV; ++i) vn[i] = x[NQ + i] + u[i] * dt;
  for (int k = 0; k < 3; ++k) {
    dv[k] = vn[k] * dt;
    dw[k] = vn[3 + k] * dt;
  }
  T p[3], q[4];
  se3_integrate(x, x + 3, dv, dw, p, q);
  for (int j = 0; j < NJ; ++j) xn[7 + j] = x[7 + j] + vn[6 + j] * dt;
  for (int k = 0; k < 3; ++k) xn[k] = p[k];
  for (int k = 0; k < 4; ++k) xn[3 + k] = q[k];
  for (int i = 0; i < NV; ++i) xn[NQ + i] = vn[i];
}

// --------------------------------------------------- kinematics + momentum --

template <typename T>
struct Kin {
  T R[NB][9], p[NB][3], om[NB][3], vel[NB][3], aw[NJ][3], rj[NJ][3];
  T c_off[NB][3], c_w[NB][3], v_com[NB][3], Iw[NB][9];
  T com[3], h[6];
};

template <typename T>
HD void kinematics(const ModelView<T>& mv, const T* x, Kin<T>& k) {
  const T* q = x;
  const T* v = x + NQ;
  quat_to_rot(q + 3, k.R[0]);
  for (int i = 0; i < 3; ++i) k.p[0][i] = q[i];
  for (int j = 0; j < NJ; ++j) {
    const int b = mv.parent(j), body = j + 1;
    const T* a = mv.axis(j);
    const T c = s_cos(q[7 + j]), s = s_sin(q[7 + j]);
    T Ka[9], Rrot[9], T1[9];
    skew3(a, Ka);
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        Rrot[r * 3 + cc] =
            (r == cc ? c : T(0)) + s * Ka[r * 3 + cc] + (T(1) - c) * a[r] * a[cc];
    mm3(k.R[b], mv.jrot(j), T1);
    mm3(T1, Rrot, k.R[body]);
    mv3(k.R[b], mv.jpos(j), k.rj[j]);
    for (int i = 0; i < 3; ++i) k.p[body][i] = k.p[b][i] + k.rj[j][i];
  }
  mv3(k.R[0], v, k.vel[0]);
  mv3(k.R[0], v + 3, k.om[0]);
  for (int j = 0; j < NJ; ++j) {
    const int b = mv.parent(j), body = j + 1;
    mv3(k.R[body], mv.axis(j), k.aw[j]);
    T cr[3];
    cross3(k.om[b], k.rj[j], cr);
    for (int i = 0; i < 3; ++i) {
      k.om[body][i] = k.om[b][i] + k.aw[j][i] * v[6 + j];
      k.vel[body][i] = k.vel[b][i] + cr[i];
    }
  }
  // centroidal state about the CoM
  T com[3] = {0, 0, 0};
  for (int b = 0; b < NB; ++b) {
    T cr[3], T1[9], Rt[9];
    mv3(k.R[b], mv.com(b), k.c_off[b]);
    cross3(k.om[b], k.c_off[b], cr);
    for (int i = 0; i < 3; ++i) {
      k.c_w[b][i] = k.p[b][i] + k.c_off[b][i];
      k.v_com[b][i] = k.vel[b][i] + cr[i];
      com[i] += mv.mass(b) * k.c_w[b][i];
    }
    mm3(k.R[b], mv.inertia(b), T1);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rt[r * 3 + c] = k.R[b][c * 3 + r];
    mm3(T1, Rt, k.Iw[b]);
  }
  for (int i = 0; i < 3; ++i) k.com[i] = com[i] / mv.total_mass();
  for (int i = 0; i < 6; ++i) k.h[i] = T(0);
  for (int b = 0; b < NB; ++b) {
    T Io[3], d[3], cr[3];
    mv3(k.Iw[b], k.om[b], Io);
    for (int i = 0; i < 3; ++i) d[i] = k.c_w[b][i] - k.com[i];
    cross3(d, k.v_com[b], cr);
    for (int i = 0; i < 3; ++i) {
      k.h[i] += mv.mass(b) * k.v_com[b][i];
      k.h[3 + i] += Io[i] + mv.mass(b) * cr[i];
    }
  }
}

template <typename T>
HD void foot_pos(const ModelView<T>& mv, const Kin<T>& k, int f, T* pf) {
  const int fb = mv.foot_body(f);
  T a[3];
  mv3(k.R[fb], mv.foot_pos(f), a);
  for (int i = 0; i < 3; ++i) pf[i] = k.p[fb][i] + a[i];
}

// stage residual [ee(12) | com(3) | h(6) | sdiff(36)]; terminal skips ee
template <typename T>
HD void residual(const ModelView<T>& mv, const Kin<T>& k, const T* x, const T* ee_t,
                 const T* com_t, const T* mom_t, const T* xr, bool terminal, T* r) {
  int o = 0;
  if (!terminal) {
    for (int f = 0; f < NE; ++f) {
      T pf[3];
      foot_pos(mv, k, f, pf);
      for (int i = 0; i < 3; ++i) r[o++] = pf[i] - ee_t[f * 3 + i];
    }
  }
  for (int i = 0; i < 3; ++i) r[o++] = k.com[i] - com_t[i];
  for (int i = 0; i < 6; ++i) r[o++] = k.h[i] - mom_t[i];
  state_diff(xr, x, r + o);
}

// Jacobians wrt the configuration tangent (18 directions), one forward
// tangent pass per direction through fk / velocities / centroidal / feet:
// Jee (12 x 18), Jcom (3 x 18), Jh (6 x 18); and Ag = dh/dv (6 x 18)
template <typename T>
HD void tangent_rows(const ModelView<T>& mv, const Kin<T>& k, const T* x, bool with_ee,
                     T (*Jee)[NV], T (*Jcom)[NV], T (*Jh)[NV], T (*Ag)[NV]) {
  const T* v = x + NQ;
  const T M = mv.total_mass();
  for (int d = 0; d < NV; ++d) {
    T wt[NB][3], dp[NB][3], dom[NB][3], dvel[NB][3];
    for (int i = 0; i < 3; ++i) {
      dp[0][i] = d < 3 ? k.R[0][i * 3 + d] : T(0);
      wt[0][i] = (d >= 3 && d < 6) ? k.R[0][i * 3 + d - 3] : T(0);
    }
    for (int j = 0; j < NJ; ++j) {
      const int b = mv.parent(j), body = j + 1;
      T cr[3];
      cross3(wt[b], k.rj[j], cr);
      for (int i = 0; i < 3; ++i) {
        wt[body][i] = wt[b][i] + (d == 6 + j ? k.aw[j][i] : T(0));
        dp[body][i] = dp[b][i] + cr[i];
      }
    }
    cross3(wt[0], k.om[0], dom[0]);
    cross3(wt[0], k.vel[0], dvel[0]);
    for (int j = 0; j < NJ; ++j) {
      const int b = mv.parent(j), body = j + 1;
      T daw[3], c1[3], c2[3], ddp[3];
      cross3(wt[body], k.aw[j], daw);
      cross3(dom[b], k.rj[j], c1);
      for (int i = 0; i < 3; ++i) ddp[i] = dp[body][i] - dp[b][i];
      cross3(k.om[b], ddp, c2);
      for (int i = 0; i < 3; ++i) {
        dom[body][i] = dom[b][i] + daw[i] * v[6 + j];
        dvel[body][i] = dvel[b][i] + c1[i] + c2[i];
      }
    }
    T dc_w[NB][3], dv_com[NB][3], dcom[3] = {0, 0, 0};
    for (int b = 0; b < NB; ++b) {
      T dc_off[3], c1[3], c2[3];
      cross3(wt[b], k.c_off[b], dc_off);
      cross3(dom[b], k.c_off[b], c1);
      cross3(k.om[b], dc_off, c2);
      for (int i = 0; i < 3; ++i) {
        dc_w[b][i] = dp[b][i] + dc_off[i];
        dv_com[b][i] = dvel[b][i] + c1[i] + c2[i];
        dcom[i] += mv.mass(b) * dc_w[b][i];
      }
    }
    for (int i = 0; i < 3; ++i) dcom[i] /= M;
    T dhl[3] = {0, 0, 0}, dha[3] = {0, 0, 0};
    for (int b = 0; b < NB; ++b) {
      const T m = mv.mass(b);
      T Io[3], a1[3], wo[3], a2[3], a3[3], dd[3], a4[3], cc[3], a5[3];
      mv3(k.Iw[b], k.om[b], Io);
      cross3(wt[b], Io, a1);  // (w~ I_w - I_w w~) om + I_w dom
      cross3(wt[b], k.om[b], wo);
      mv3(k.Iw[b], wo, a2);
      mv3(k.Iw[b], dom[b], a3);
      for (int i = 0; i < 3; ++i) dd[i] = dc_w[b][i] - dcom[i];
      cross3(dd, k.v_com[b], a4);
      for (int i = 0; i < 3; ++i) cc[i] = k.c_w[b][i] - k.com[i];
      cross3(cc, dv_com[b], a5);
      for (int i = 0; i < 3; ++i) {
        dhl[i] += m * dv_com[b][i];
        dha[i] += a1[i] - a2[i] + a3[i] + m * a4[i] + m * a5[i];
      }
    }
    for (int i = 0; i < 3; ++i) {
      Jcom[i][d] = dcom[i];
      Jh[i][d] = dhl[i];
      Jh[3 + i][d] = dha[i];
    }
    if (with_ee) {
      for (int f = 0; f < NE; ++f) {
        const int fb = mv.foot_body(f);
        T a[3], cr[3];
        mv3(k.R[fb], mv.foot_pos(f), a);
        cross3(wt[fb], a, cr);
        for (int i = 0; i < 3; ++i) Jee[f * 3 + i][d] = dp[fb][i] + cr[i];
      }
    }
  }
  // momentum matrix: velocity tangents (h is linear in v)
  for (int d = 0; d < NV; ++d) {
    T dom[NB][3], dvel[NB][3];
    for (int i = 0; i < 3; ++i) {
      dvel[0][i] = d < 3 ? k.R[0][i * 3 + d] : T(0);
      dom[0][i] = (d >= 3 && d < 6) ? k.R[0][i * 3 + d - 3] : T(0);
    }
    for (int j = 0; j < NJ; ++j) {
      const int b = mv.parent(j), body = j + 1;
      T cr[3];
      cross3(dom[b], k.rj[j], cr);
      for (int i = 0; i < 3; ++i) {
        dom[body][i] = dom[b][i] + (d == 6 + j ? k.aw[j][i] : T(0));
        dvel[body][i] = dvel[b][i] + cr[i];
      }
    }
    T dhl[3] = {0, 0, 0}, dha[3] = {0, 0, 0};
    for (int b = 0; b < NB; ++b) {
      const T m = mv.mass(b);
      T c1[3], dvc[3], Id[3], cc[3], c2[3];
      cross3(dom[b], k.c_off[b], c1);
      for (int i = 0; i < 3; ++i) dvc[i] = dvel[b][i] + c1[i];
      mv3(k.Iw[b], dom[b], Id);
      for (int i = 0; i < 3; ++i) cc[i] = k.c_w[b][i] - k.com[i];
      cross3(cc, dvc, c2);
      for (int i = 0; i < 3; ++i) {
        dhl[i] += m * dvc[i];
        dha[i] += Id[i] + m * c2[i];
      }
    }
    for (int i = 0; i < 3; ++i) {
      Ag[i][d] = dhl[i];
      Ag[3 + i][d] = dha[i];
    }
  }
}

// ------------------------------------------------------------ the DDP ------

template <typename T>
struct DdpInputs {
  const T *x0, *ee_t, *com_ref, *mom_ref, *x_reg, *w_stage, *w_term, *wu, *dts;
};

template <typename T>
struct DdpWork {
  Strided<T> xs, us, kff, Kfb;              // trajectory and gains
  Strided<T> Lx, Lxx, Fb;                   // per knot: GN gradient, curvature, [A6 | Jr6]
  Strided<T> Vx, Vxx, Qx, Qu, Qux, Quu, Lc;  // the Riccati step
  Strided<T> Tmp, T1;                       // its 18x18 and 36x36 temporaries
  Strided<T> ca, xsA, usA;                  // per alpha: cost and candidate trajectory
};

template <typename T>
HD T stage_cost(const ModelView<T>& mv, const DdpInputs<T>& in, const T* x, const T* u, int k) {
  Kin<T> kin;
  kinematics(mv, x, kin);
  T r[NR];
  residual(mv, kin, x, in.ee_t + k * NE * 3, in.com_ref + k * 3, in.mom_ref + k * 6,
           in.x_reg + k * NX, false, r);
  const T* w = in.w_stage + k * NR;
  const T* wu = in.wu + k * NV;
  T s1 = T(0), s2 = T(0);
  for (int i = 0; i < NR; ++i) s1 += w[i] * r[i] * r[i];
  for (int i = 0; i < NV; ++i) s2 += wu[i] * u[i] * u[i];
  return in.dts[k] * T(0.5) * (s1 + s2);
}

template <typename T>
HD T term_cost(const ModelView<T>& mv, const DdpInputs<T>& in, const T* x, int H) {
  Kin<T> kin;
  kinematics(mv, x, kin);
  T r[NRT];
  residual(mv, kin, x, (const T*)nullptr, in.com_ref + H * 3, in.mom_ref + H * 6,
           in.x_reg + H * NX, true, r);
  T s = T(0);
  for (int i = 0; i < NRT; ++i) s += in.w_term[i] * r[i] * r[i];
  return T(0.5) * s;
}

// forward rollout u_k = us_k + alpha kff_k + Kfb_k (x (-) xs_k); returns the
// total cost and writes the trajectory into xs_out/us_out
template <typename T>
HD T rollout(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
             T alpha, bool zero_controls, const Strided<T>& xs_out, const Strided<T>& us_out) {
  T x[NX], xn[NX], u[NV], xr[NX], dx[NDX];
  for (int i = 0; i < NX; ++i) x[i] = in.x0[i];
  for (int i = 0; i < NX; ++i) xs_out[i] = x[i];
  T c = T(0);
  for (int k = 0; k < H; ++k) {
    if (zero_controls) {
      for (int i = 0; i < NV; ++i) u[i] = T(0);
    } else {
      for (int i = 0; i < NX; ++i) xr[i] = w.xs[k * NX + i];
      state_diff(xr, x, dx);
      for (int i = 0; i < NV; ++i) {
        T s = w.us[k * NV + i] + alpha * w.kff[k * NV + i];
        for (int j = 0; j < NDX; ++j) s += w.Kfb[(k * NV + i) * NDX + j] * dx[j];
        u[i] = s;
      }
    }
    c += stage_cost(mv, in, x, u, k);
    step(x, u, in.dts[k], xn);
    for (int i = 0; i < NV; ++i) us_out[k * NV + i] = u[i];
    for (int i = 0; i < NX; ++i) xs_out[(k + 1) * NX + i] = xn[i];
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
  return c + term_cost(mv, in, x, H);
}

// Gauss-Newton gradient g (36) and curvature Hm (36x36, into scratch) of
// 0.5 r'Wr at x: rows [ee | com | h | sdiff] (stage) or [com | h | sdiff]
// (terminal); the sdiff q-rows are B6 = Jr^-1(sdiff base) for the base and
// identity for the joints, its v-rows identity
template <typename T>
HD void gn_accumulate(const ModelView<T>& mv, const Kin<T>& k, const T* x, const T* r,
                      const T* wts, bool terminal, T scale, T* g, const Strided<T>& Hm) {
  T Jee[3 * NE][NV], Jcom[3][NV], Jh[6][NV], Ag[6][NV];
  tangent_rows(mv, k, x, !terminal, Jee, Jcom, Jh, Ag);
  for (int i = 0; i < NDX; ++i) g[i] = T(0);
  for (int i = 0; i < NDX * NDX; ++i) Hm[i] = T(0);
  const int off = terminal ? 0 : 3 * NE;
  // rows with a q-part only: ee, com, base sdiff
  auto add_q_row = [&](const T* row, T wr, T rr) {
    for (int a = 0; a < NV; ++a) {
      if (row[a] == T(0)) continue;
      g[a] += row[a] * (wr * rr);
      const T ra = row[a] * wr;
      for (int b = 0; b < NV; ++b) Hm[a * NDX + b] += ra * row[b];
    }
  };
  if (!terminal)
    for (int i = 0; i < 3 * NE; ++i) add_q_row(Jee[i], wts[i], r[i]);
  for (int i = 0; i < 3; ++i) add_q_row(Jcom[i], wts[off + i], r[off + i]);
  for (int i = 0; i < 6; ++i) {  // momentum rows: q-part Jh, v-part Ag
    const T wr = wts[off + 3 + i], rr = r[off + 3 + i];
    for (int a = 0; a < NV; ++a) {
      g[a] += Jh[i][a] * (wr * rr);
      g[NV + a] += Ag[i][a] * (wr * rr);
      const T qa = Jh[i][a] * wr, va = Ag[i][a] * wr;
      for (int b = 0; b < NV; ++b) {
        Hm[a * NDX + b] += qa * Jh[i][b];
        Hm[a * NDX + NV + b] += qa * Ag[i][b];
        Hm[(NV + a) * NDX + NV + b] += va * Ag[i][b];
      }
    }
  }
  const int so = off + 9;
  const T* rs = r + so;
  const T* ws = wts + so;
  T B6[36];
  se3_Jr_inv(rs, rs + 3, B6);
  for (int i = 0; i < 6; ++i) {
    T row[NV];
    for (int a = 0; a < NV; ++a) row[a] = a < 6 ? B6[i * 6 + a] : T(0);
    add_q_row(row, ws[i], rs[i]);
  }
  for (int a = 6; a < NV; ++a) {  // joint identity rows
    g[a] += ws[a] * rs[a];
    Hm[a * NDX + a] += ws[a];
  }
  for (int a = 0; a < NV; ++a) {  // velocity identity rows
    g[NV + a] += ws[NV + a] * rs[NV + a];
    Hm[(NV + a) * NDX + NV + a] += ws[NV + a];
  }
  for (int a = 0; a < NV; ++a)  // H_vq = H_qv'
    for (int b = 0; b < NV; ++b) Hm[(NV + a) * NDX + b] = Hm[b * NDX + NV + a];
  for (int i = 0; i < NDX; ++i) g[i] *= scale;
  for (int i = 0; i < NDX * NDX; ++i) Hm[i] *= scale;
}

// the view of s starting at element o
template <typename T>
HD Strided<T> sub(const Strided<T>& s, long o) {
  return Strided<T>{s.base + o * s.stride, s.stride};
}

// element (i, j) of blk(M6, s)' X, X an 18x18 block with row stride ld
template <typename T>
HD T blkT_el(const T* M6, T s, const Strided<T>& X, int ld, int i, int j) {
  if (i >= 6) return s * X[i * ld + j];
  T v = T(0);
  for (int k = 0; k < 6; ++k) v += M6[k * 6 + i] * X[k * ld + j];
  return v;
}

// element (i, j) of X blk(M6, s)
template <typename T>
HD T blk_el(const Strided<T>& X, int ld, const T* M6, T s, int i, int j) {
  if (j >= 6) return s * X[i * ld + j];
  T v = T(0);
  for (int k = 0; k < 6; ++k) v += X[i * ld + k] * M6[k * 6 + j];
  return v;
}

// Gauss-Newton data of knot k (k == H: the terminal cost) at the current
// trajectory: w.Lx[k], w.Lxx[k]; for k < H also the 6x6 base blocks of the
// step Jacobians, w.Fb[k] = [A6 | Jr6]. Knots are independent of each other.
template <typename T>
HD void knot_derivs(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
                    int k) {
  T x[NX], r[NR], g[NDX];
  Kin<T> kin;
  const bool term = k == H;
  for (int i = 0; i < NX; ++i) x[i] = w.xs[k * NX + i];
  kinematics(mv, x, kin);
  residual(mv, kin, x, term ? (const T*)nullptr : in.ee_t + k * NE * 3, in.com_ref + k * 3,
           in.mom_ref + k * 6, in.x_reg + k * NX, term, r);
  gn_accumulate(mv, kin, x, r, term ? in.w_term : in.w_stage + k * NR, term,
                term ? T(1) : in.dts[k], g, sub(w.Lxx, (long)k * NDX * NDX));
  for (int i = 0; i < NDX; ++i) w.Lx[k * NDX + i] = g[i];
  if (term) return;
  // the step x+ = (q (+) v+ dt, v+), v+ = v + u dt: Fx = [[A, Bd], [0, I]],
  // Fu = [[C], [dt I]] with A = blk(A6, 1), Bd = blk(Jr6 dt, dt),
  // C = blk(Jr6 dt^2, dt^2), where blk(M6, s) is a 6x6 base block followed by
  // s times the 12x12 identity on the joints
  const T dt = in.dts[k];
  T w6[6], A6[36], Jr6[36];
  for (int i = 0; i < 6; ++i) w6[i] = (x[NQ + i] + w.us[k * NV + i] * dt) * dt;
  const T nw[6] = {-w6[0], -w6[1], -w6[2], -w6[3], -w6[4], -w6[5]};
  se3_adjoint_exp(nw, nw + 3, A6);
  se3_Jr(w6, w6 + 3, Jr6);
  for (int i = 0; i < 36; ++i) {
    w.Fb[k * 72 + i] = A6[i];
    w.Fb[k * 72 + 36 + i] = Jr6[i];
  }
}

// knot k's A6, B6 = Jr6 dt, C6 = Jr6 dt^2
template <typename T>
HD void step_blocks(const DdpWork<T>& w, int k, T dt, T* A6, T* B6, T* C6) {
  for (int i = 0; i < 36; ++i) {
    A6[i] = w.Fb[k * 72 + i];
    const T jr = w.Fb[k * 72 + 36 + i];
    B6[i] = jr * dt;
    C6[i] = jr * (dt * dt);
  }
}

// One knot of the Riccati sweep, split over the lanes in six barrier-separated
// steps: the quadrant products of Vxx with the step blocks; Qxx, Quu, Qux,
// Qx, Qu; the Cholesky of Quu (lane 0, clamp rsqrt(max(d, 1e-20))); the gains
// [kff | Kfb] = -Quu^-1 [Qu | Qux] column by column; Vx and Qxx + Kfb'Qux;
// the symmetrized Vxx.
template <typename T, class Exec>
HD void riccati_knot(const DdpInputs<T>& in, const DdpWork<T>& w, int k, T reg,
                     const Exec& exec) {
  const T dt = in.dts[k], dt2 = dt * dt;
  const T* wu = in.wu + k * NV;
  const Strided<T> Qxx = sub(w.Lxx, (long)k * NDX * NDX);  // Lxx, made Qxx in place
  const Strided<T> V11 = w.Vxx, V12 = sub(w.Vxx, NV), V21 = sub(w.Vxx, NV * NDX),
                   V22 = sub(w.Vxx, NV * NDX + NV);
  const Strided<T> AtV = w.Tmp, BtV = sub(w.Tmp, NV * NV), CtV = sub(w.Tmp, 2 * NV * NV),
                   D = sub(w.Tmp, 3 * NV * NV);
  exec([&](int lane) {
    T A6[36], B6[36], C6[36];
    step_blocks(w, k, dt, A6, B6, C6);
    for (int e = lane; e < NV * NV; e += LANES) {
      const int i = e / NV, j = e % NV;
      AtV[e] = blkT_el(A6, T(1), V11, NDX, i, j);
      BtV[e] = blkT_el(B6, dt, V11, NDX, i, j);
      const T c = blkT_el(C6, dt2, V11, NDX, i, j);
      CtV[e] = c;
      D[e] = c + dt * V21[i * NDX + j];  // Fu' [V11; V21]
    }
  });
  exec([&](int lane) {
    T A6[36], B6[36], C6[36];
    step_blocks(w, k, dt, A6, B6, C6);
    for (int e = lane; e < NV * NV; e += LANES) {
      const int i = e / NV, j = e % NV;
      // Qxx = Lxx + Fx' Vxx Fx
      const T qq = blk_el(AtV, NV, A6, T(1), i, j);
      const T qv = blk_el(AtV, NV, B6, dt, i, j) + blkT_el(A6, T(1), V12, NDX, i, j);
      const T vv = blk_el(BtV, NV, B6, dt, i, j) + blkT_el(B6, dt, V12, NDX, i, j) +
                   blk_el(V21, NDX, B6, dt, i, j) + V22[i * NDX + j];
      Qxx[i * NDX + j] += qq;
      Qxx[i * NDX + NV + j] += qv;
      Qxx[(NV + j) * NDX + i] += qv;
      Qxx[(NV + i) * NDX + NV + j] += vv;
      // Quu = Luu + Fu' Vxx Fu + reg I ; Qux = Fu' Vxx Fx
      T quu = blk_el(CtV, NV, C6, dt2, i, j) + dt * blkT_el(C6, dt2, V12, NDX, i, j) +
              dt * blk_el(V21, NDX, C6, dt2, i, j) + dt2 * V22[i * NDX + j];
      if (i == j) quu += dt * wu[i] + reg;
      w.Quu[e] = quu;
      w.Qux[i * NDX + j] = blk_el(D, NV, A6, T(1), i, j);
      w.Qux[i * NDX + NV + j] = blk_el(D, NV, B6, dt, i, j) +
                                blkT_el(C6, dt2, V12, NDX, i, j) + dt * V22[i * NDX + j];
    }
    // Qx = Lx + Fx' Vx ; Qu = Lu + Fu' Vx
    for (int a = lane; a < NV; a += LANES) {
      T ax = w.Vx[a], bx = dt * w.Vx[a], cx = dt2 * w.Vx[a];
      if (a < 6) {
        ax = bx = cx = T(0);
        for (int m = 0; m < 6; ++m) {
          ax += A6[m * 6 + a] * w.Vx[m];
          bx += B6[m * 6 + a] * w.Vx[m];
          cx += C6[m * 6 + a] * w.Vx[m];
        }
      }
      w.Qx[a] = w.Lx[k * NDX + a] + ax;
      w.Qx[NV + a] = w.Lx[k * NDX + NV + a] + bx + w.Vx[NV + a];
      w.Qu[a] = dt * wu[a] * w.us[k * NV + a] + cx + dt * w.Vx[NV + a];
    }
  });
  exec([&](int lane) {  // Cholesky of Quu, column by column with rank-1 updates
    if (lane != 0) return;
    for (int i = 0; i < NV * NV; ++i) w.Lc[i] = T(0);
    for (int j = 0; j < NV; ++j) {
      const T inv = s_rsqrt(s_max(w.Quu[j * NV + j], T(1e-20)));
      for (int i = j; i < NV; ++i) w.Lc[i * NV + j] = w.Quu[i * NV + j] * inv;
      for (int a = j; a < NV; ++a)
        for (int b = j; b < NV; ++b) w.Quu[a * NV + b] -= w.Lc[a * NV + j] * w.Lc[b * NV + j];
    }
  });
  exec([&](int lane) {  // [kff | Kfb] = -Quu^-1 [Qu | Qux]
    for (int c = lane; c <= NDX; c += LANES) {
      T y[NV];
      for (int i = 0; i < NV; ++i) {
        T s = c == 0 ? w.Qu[i] : w.Qux[i * NDX + c - 1];
        for (int m = 0; m < i; ++m) s -= w.Lc[i * NV + m] * y[m];
        y[i] = s / w.Lc[i * NV + i];
      }
      for (int i = NV - 1; i >= 0; --i) {
        T s = y[i];
        for (int m = i + 1; m < NV; ++m) s -= w.Lc[m * NV + i] * y[m];
        y[i] = s / w.Lc[i * NV + i];
      }
      for (int i = 0; i < NV; ++i) {
        if (c == 0)
          w.kff[k * NV + i] = -y[i];
        else
          w.Kfb[(k * NV + i) * NDX + c - 1] = -y[i];
      }
    }
  });
  exec([&](int lane) {  // Vx = Qx + Kfb'Qu ; T1 = Qxx + Kfb'Qux
    for (int a = lane; a < NDX; a += LANES) {
      T s = w.Qx[a];
      for (int i = 0; i < NV; ++i) s += w.Kfb[(k * NV + i) * NDX + a] * w.Qu[i];
      w.Vx[a] = s;
    }
    for (int e = lane; e < NDX * NDX; e += LANES) {
      const int a = e / NDX, b = e % NDX;
      T s = Qxx[e];
      for (int i = 0; i < NV; ++i) s += w.Kfb[(k * NV + i) * NDX + a] * w.Qux[i * NDX + b];
      w.T1[e] = s;
    }
  });
  exec([&](int lane) {  // Vxx = sym(T1)
    for (int e = lane; e < NDX * NDX; e += LANES) {
      const int a = e / NDX, b = e % NDX;
      w.Vxx[e] = T(0.5) * (w.T1[e] + w.T1[b * NDX + a]);
    }
  });
}

// The DDP of one problem as a sequence of phases run by LANES lanes; exec(f)
// calls f(lane) on every lane and then waits for all of them (a block barrier
// on the card, a loop over the lanes on the host). Lane 0 owns the serial
// steps and the cost; the knots' Gauss-Newton data, the Riccati step's
// products and solves, and the alphas' rollouts are split over the lanes.
// Lanes exchange data through the scratch buffer only.
template <typename T, class Exec>
HD void ddp_problem(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
                    int n_iters, int n_alpha, const T* alphas, T reg, T* cost_out,
                    const Exec& exec) {
  const long nxs = (H + 1L) * NX, nus = (long)H * NV;
  T cost = T(0);  // lane 0's
  exec([&](int lane) {
    if (lane != 0) return;
    cost = rollout(mv, in, w, H, T(0), true, w.xsA, w.usA);  // zero controls
    for (long i = 0; i < nxs; ++i) w.xs[i] = w.xsA[i];
    for (long i = 0; i < nus; ++i) w.us[i] = w.usA[i];
  });
  for (int it = 0; it < n_iters; ++it) {
    exec([&](int lane) {
      for (int k = lane; k <= H; k += LANES) knot_derivs(mv, in, w, H, k);
    });
    exec([&](int lane) {
      for (int i = lane; i < NDX; i += LANES) w.Vx[i] = w.Lx[H * NDX + i];
      for (int i = lane; i < NDX * NDX; i += LANES) w.Vxx[i] = w.Lxx[(long)H * NDX * NDX + i];
    });
    for (int k = H - 1; k >= 0; --k) riccati_knot(in, w, k, reg, exec);
    exec([&](int lane) {  // every alpha's rollout, each into its own candidate
      for (int a = lane; a < n_alpha; a += LANES)
        w.ca[a] = rollout(mv, in, w, H, alphas[a], false, sub(w.xsA, a * nxs),
                          sub(w.usA, a * nus));
    });
    exec([&](int lane) {
      if (lane != 0) return;
      int best = -1;
      T best_cost = T(3.0e38);
      for (int a = 0; a < n_alpha; ++a) {
        if (w.ca[a] < best_cost) {  // strict: the earliest alpha wins a tie
          best_cost = w.ca[a];
          best = a;
        }
      }
      // the best candidate; with none below 3e38 the rollout at alpha 0
      T c_store = best_cost;
      if (best < 0) {
        best = 0;
        c_store = rollout(mv, in, w, H, T(0), false, w.xsA, w.usA);
      }
      if (c_store < cost) {
        for (long i = 0; i < nxs; ++i) w.xs[i] = w.xsA[best * nxs + i];
        for (long i = 0; i < nus; ++i) w.us[i] = w.usA[best * nus + i];
      }
      // cost = min(cost, c_store), NaN-propagating like jnp.minimum
      cost = (cost != cost || c_store != c_store) ? cost + c_store
                                                  : (c_store < cost ? c_store : cost);
    });
  }
  exec([&](int lane) {
    if (lane == 0) *cost_out = cost;
  });
}

template <typename T, class Exec>
HD void ddp_one(int b, int B, int H, int n_iters, int n_alpha, T reg, const T* model,
                const T* alphas, const T* x0, const T* ee_t, const T* com_ref, const T* mom_ref,
                const T* x_reg, const T* w_stage, const T* w_term, const T* wu, const T* dts,
                T* xs_out, T* us_out, T* cost, T* scratch, const Exec& exec) {
  const ModelView<T> mv{model};
  const DdpInputs<T> in{x0 + (long)b * NX,
                        ee_t + (long)b * H * NE * 3,
                        com_ref + (long)b * (H + 1) * 3,
                        mom_ref + (long)b * (H + 1) * 6,
                        x_reg + (long)b * (H + 1) * NX,
                        w_stage + (long)b * H * NR,
                        w_term + (long)b * NRT,
                        wu + (long)b * H * NV,
                        dts + (long)b * H};
  long off = 0;
  auto take = [&](long n) {
    Strided<T> s{scratch + off * B + b, B};
    off += n;
    return s;
  };
  DdpWork<T> w;
  w.xs = take((H + 1) * NX); w.us = take(H * NV); w.kff = take(H * NV);
  w.Kfb = take((long)H * NV * NDX);
  w.Lx = take((H + 1) * NDX); w.Lxx = take((long)(H + 1) * NDX * NDX); w.Fb = take(H * 72);
  w.Vx = take(NDX); w.Vxx = take(NDX * NDX); w.Qx = take(NDX); w.Qu = take(NV);
  w.Qux = take(NDX * NV); w.Quu = take(NV * NV); w.Lc = take(NV * NV);
  w.Tmp = take(4 * NV * NV); w.T1 = take(NDX * NDX);
  w.ca = take(MAX_ALPHAS); w.xsA = take(MAX_ALPHAS * (H + 1L) * NX);
  w.usA = take(MAX_ALPHAS * (long)H * NV);
  ddp_problem(mv, in, w, H, n_iters, n_alpha, alphas, reg, cost + b, exec);
  exec([&](int lane) {
    if (lane != 0) return;
    for (long i = 0; i < (H + 1) * NX; ++i) xs_out[(long)b * (H + 1) * NX + i] = w.xs[i];
    for (long i = 0; i < H * NV; ++i) us_out[(long)b * H * NV + i] = w.us[i];
  });
}

#ifdef __CUDACC__
// a thread is one lane of one problem; a phase ends at a block barrier, which
// every thread of the block reaches (the lanes of a problem past B skip the work)
struct DeviceExec {
  int lane;
  bool active;
  template <class F>
  __device__ void operator()(const F& f) const {
    if (active) f(lane);
    __syncthreads();
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

}  // namespace bk

// Number of scratch elements per problem.
extern "C" long ddp_scratch_size(int H) {
  using namespace bk;
  return (H + 1L) * NX + 2L * H * NV + (long)H * NV * NDX + (H + 1L) * NDX +
         (H + 1L) * NDX * NDX + 72L * H + 2L * NDX + NV + 3L * NDX * NDX + NDX * NV +
         2L * NV * NV + MAX_ALPHAS * (1 + (H + 1L) * NX + (long)H * NV);
}

#define DDP_ARGS(T)                                                                        \
  int B, int H, int n_iters, int n_alpha, double reg, const T *model, const T *alphas,    \
      const T *x0, const T *ee_t, const T *com_ref, const T *mom_ref, const T *x_reg,      \
      const T *w_stage, const T *w_term, const T *wu, const T *dts, T *xs, T *us, T *cost, \
      T *scratch
#define DDP_CALL(T, b, exec)                                                              \
  bk::ddp_one<T>(b, B, H, n_iters, n_alpha, T(reg), model, alphas, x0, ee_t, com_ref,     \
                 mom_ref, x_reg, w_stage, w_term, wu, dts, xs, us, cost, scratch, exec)

#ifdef __CUDACC__

__global__ void ddp_kernel(DDP_ARGS(float)) {
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + threadIdx.x / bk::LANES;
  const bk::DeviceExec exec{(int)(threadIdx.x % bk::LANES), b < B};
  DDP_CALL(float, b < B ? b : B - 1, exec);
}

// Launch on the caller's stream with `problems` problems (LANES threads each)
// per block; returns cudaGetLastError() (0 = launched).
extern "C" int ddp_launch_f32(DDP_ARGS(float), int problems, void* stream) {
  const int blocks = (B + problems - 1) / problems;
  ddp_kernel<<<blocks, problems * bk::LANES, 0, (cudaStream_t)stream>>>(
      B, H, n_iters, n_alpha, reg, model, alphas, x0, ee_t, com_ref, mom_ref, x_reg, w_stage,
      w_term, wu, dts, xs, us, cost, scratch);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

extern "C" int ddp_host_f32(DDP_ARGS(float)) {
  for (int b = 0; b < B; ++b) DDP_CALL(float, b, bk::HostExec{});
  return 0;
}

extern "C" int ddp_host_f64(DDP_ARGS(double)) {
  for (int b = 0; b < B; ++b) DDP_CALL(double, b, bk::HostExec{});
  return 0;
}

#endif
