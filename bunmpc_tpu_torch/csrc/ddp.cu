// K2: the whole kinematic Gauss-Newton DDP (the MPC's IK) of one problem per
// CUDA warp.
//
// Replaces bunmpc_tpu/solvers/pallas_ddp.py:_build_kernel/solve_ik_batch:
// for n_iters iterations — Gauss-Newton stage data at every knot (FK, body
// velocities, centroidal momentum; the residual Jacobians from hand-written
// tangent passes through the same recursions, one per configuration
// direction, the momentum matrix from the velocity directions, the SE(3)
// chart blocks in closed form), a Riccati backward sweep with an 18x18
// Cholesky of Quu (clamp rsqrt(max(d, 1e-20)), Levenberg term reg*I,
// symmetrized Vxx), then a line search: one cost-only rollout per alpha, the
// earliest alpha with the strictly lowest cost wins, and one storing rollout
// that is kept only if its cost is below the current one. The first rollout
// uses zero controls.
//
// What bounds it on an H100: about 2,050 floats in and out per problem (about
// 4.2 MB at B=512), so it is bound by f32 arithmetic: per iteration and knot
// the tangent passes, the Gauss-Newton products and the Riccati step (Quu
// solve, Kfb'Qux update); per iteration len(alphas)+1 rollouts. What held
// the first design back was not arithmetic but chains of dependent accesses
// to a batch-last device-memory scratch, on 2 warps an SM. Design: the 32
// lanes of a warp share one problem, with a warp barrier between phases, so
// problems never wait for each other. A problem's work set — trajectory,
// gains, the current knot's Gauss-Newton data, the Riccati matrices — and its
// inputs live in its slice of the block's shared memory (ddp_layout; opted in
// past 48 KB), so a phase's dependent accesses cost shared-memory latency. In
// device memory, problem-major, stay the alphas' candidate trajectories and
// each knot's record (FK cache, residual, B6, step blocks), computed for all
// knots at once, a knot per lane, at the start of an iteration. The backward
// sweep then runs knot by knot and builds each knot's Gauss-Newton data just
// before its Riccati step, so no (H+1)-knot curvature array exists: the
// knot's record copied into shared memory, its 36 tangent directions over
// the lanes (each in registers: the tree is chains off the base), the 36x36
// Gauss-Newton products by entry (each entry summed in the order of a
// row-by-row accumulation); the Riccati products by entry, the Cholesky a
// phase per pair of columns with the trailing update by entry, the gains a
// column per lane. A rollout's state recursion takes a lane (the alphas' side
// by side), its knots' costs go over the lanes. The per-problem code is
// force-inlined (common.cuh: HD), so the work arrays' pointers stay in
// registers and their accesses compile to shared-memory loads. The Riccati
// products use the block structure of the step Jacobians (6x6 base blocks
// plus scaled identities, as the Pallas kernel does). The robot constants
// come from the port's RobotModel as one small argument buffer (every lane
// reads the same address: a broadcast).
//
// Built by bunmpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// (no fast math). Compiled with g++ instead (no __CUDACC__) it exports host
// loops over the same per-problem phases (the lanes of a phase run one after
// another, the shared-memory slice is a plain array), in float and double,
// for the CPU tests.

#include "common.cuh"

namespace bk {

constexpr int NJ = 12, NB = 13, NE = 4;
constexpr int NQ = 19, NV = 18, NX = 37, NDX = 36;
constexpr int NR = 3 * NE + 9 + NDX;  // 57 stage residual rows
constexpr int NRT = 9 + NDX;          // 45 terminal rows
constexpr int MAX_ALPHAS = 8;
static_assert(LANES >= MAX_ALPHAS, "the alphas' rollouts take a lane each");
// profiling-build phase slots (common.cuh: Prof)
enum {
  PH_TOTAL, PH_ROLLOUT0, PH_DERIVS, PH_RICCATI, PH_CHOL, PH_ALPHAS, PH_DECISION,
  PH_DERIVS_COPY, PH_DERIVS_TANGENT, PH_DERIVS_GN, PH_RIC_PRODUCTS, PH_RIC_GAINS, PH_RIC_VXX,
  PH_DERIVS_REC
};

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

// One tangent direction of the Gauss-Newton rows at a knot, from its FK
// cache k: d < NV a configuration direction (a forward tangent pass through
// fk / velocities / centroidal / feet: column d of Jq = [Jee (12, with_ee
// only) | Jcom (3) | Jh (6)] x 18), d >= NV a velocity direction (column
// d - NV of the momentum matrix Ag = dh/dv, 6 x 18; h is linear in v). Row
// stride NV. The tree is chains off the base (joint j's parent body is the
// base or body j, the body of joint j-1; solvers/cuda_ddp.pack_model checks),
// so the recursion keeps only the base's and the previous body's tangents,
// in registers. A configuration direction runs it twice: the momentum rows
// need the CoM tangent, a sum over every body.
template <typename T>
HD void tangent_dir(const ModelView<T>& mv, const Kin<T>& k, const T* x, bool with_ee, int d,
                    T* Jq, T* Ag) {
  const T* v = x + NQ;
  const bool config = d < NV;
  if (!config) d -= NV;
  T wt0[3], dp0[3], dom0[3], dvel0[3];  // the base's tangents
  for (int i = 0; i < 3; ++i) {
    const T tr = d < 3 ? k.R[0][i * 3 + d] : T(0);
    const T rot = (d >= 3 && d < 6) ? k.R[0][i * 3 + d - 3] : T(0);
    if (config) {
      dp0[i] = tr;
      wt0[i] = rot;
    } else {
      dvel0[i] = tr;
      dom0[i] = rot;
    }
  }
  if (config) {
    cross3(wt0, k.om[0], dom0);
    cross3(wt0, k.vel[0], dvel0);
  }
  T dcom[3] = {0, 0, 0}, dhl[3] = {0, 0, 0}, dha[3] = {0, 0, 0};
  for (int pass = 0; pass < (config ? 2 : 1); ++pass) {
    const bool first = pass == 0, last = pass == (config ? 1 : 0);
    T wt[3], dp[3], dom[3], dvel[3];  // the current body's tangents
    BK_UNROLL
    for (int b = 0; b < NB; ++b) {
      if (b == 0) {
        for (int i = 0; i < 3; ++i) {
          wt[i] = wt0[i];
          dp[i] = dp0[i];
          dom[i] = dom0[i];
          dvel[i] = dvel0[i];
        }
      } else {  // body b = j + 1 from its parent: the base or the previous body
        const int j = b - 1, pb = mv.parent(j);
        const bool from_base = pb == 0;
        T qwt[3], qdp[3], qdom[3], qdvel[3];
        for (int i = 0; i < 3; ++i) {
          qwt[i] = from_base ? wt0[i] : wt[i];
          qdp[i] = from_base ? dp0[i] : dp[i];
          qdom[i] = from_base ? dom0[i] : dom[i];
          qdvel[i] = from_base ? dvel0[i] : dvel[i];
        }
        const T e = d == 6 + j ? T(1) : T(0);
        if (config) {
          T cr[3], daw[3], c1[3], c2[3], ddp[3];
          cross3(qwt, k.rj[j], cr);
          for (int i = 0; i < 3; ++i) {
            wt[i] = qwt[i] + (e != T(0) ? k.aw[j][i] : T(0));
            dp[i] = qdp[i] + cr[i];
          }
          cross3(wt, k.aw[j], daw);
          cross3(qdom, k.rj[j], c1);
          for (int i = 0; i < 3; ++i) ddp[i] = dp[i] - qdp[i];
          cross3(k.om[pb], ddp, c2);
          for (int i = 0; i < 3; ++i) {
            dom[i] = qdom[i] + daw[i] * v[6 + j];
            dvel[i] = qdvel[i] + c1[i] + c2[i];
          }
        } else {
          T cr[3];
          cross3(qdom, k.rj[j], cr);
          for (int i = 0; i < 3; ++i) {
            dom[i] = qdom[i] + (e != T(0) ? k.aw[j][i] : T(0));
            dvel[i] = qdvel[i] + cr[i];
          }
        }
      }
      const T m = mv.mass(b);
      T cc[3];
      for (int i = 0; i < 3; ++i) cc[i] = k.c_w[b][i] - k.com[i];
      if (!config) {
        T c1[3], dvc[3], Id[3], c2[3];
        cross3(dom, k.c_off[b], c1);
        for (int i = 0; i < 3; ++i) dvc[i] = dvel[i] + c1[i];
        mv3(k.Iw[b], dom, Id);
        cross3(cc, dvc, c2);
        for (int i = 0; i < 3; ++i) {
          dhl[i] += m * dvc[i];
          dha[i] += Id[i] + m * c2[i];
        }
        continue;
      }
      T dc_off[3], c1[3], c2[3], dcw[3], dvc[3];
      cross3(wt, k.c_off[b], dc_off);
      cross3(dom, k.c_off[b], c1);
      cross3(k.om[b], dc_off, c2);
      for (int i = 0; i < 3; ++i) {
        dcw[i] = dp[i] + dc_off[i];
        dvc[i] = dvel[i] + c1[i] + c2[i];
      }
      if (first) {
        for (int i = 0; i < 3; ++i) dcom[i] += m * dcw[i];
        if (with_ee)
          for (int f = 0; f < NE; ++f) {
            if (mv.foot_body(f) != b) continue;
            T a[3], cr[3];
            mv3(k.R[b], mv.foot_pos(f), a);
            cross3(wt, a, cr);
            for (int i = 0; i < 3; ++i) Jq[(f * 3 + i) * NV + d] = dp[i] + cr[i];
          }
      } else {  // (w~ I_w - I_w w~) om + I_w dom, and the momentum about the CoM
        T Io[3], a1[3], wo[3], a2[3], a3[3], dd[3], a4[3], a5[3];
        mv3(k.Iw[b], k.om[b], Io);
        cross3(wt, Io, a1);
        cross3(wt, k.om[b], wo);
        mv3(k.Iw[b], wo, a2);
        mv3(k.Iw[b], dom, a3);
        for (int i = 0; i < 3; ++i) dd[i] = dcw[i] - dcom[i];
        cross3(dd, k.v_com[b], a4);
        cross3(cc, dvc, a5);
        for (int i = 0; i < 3; ++i) {
          dhl[i] += m * dvc[i];
          dha[i] += a1[i] - a2[i] + a3[i] + m * a4[i] + m * a5[i];
        }
      }
    }
    if (config && first)
      for (int i = 0; i < 3; ++i) dcom[i] /= mv.total_mass();
    if (!last) continue;
    for (int i = 0; i < 3; ++i) {
      if (config) {
        Jq[(3 * NE + i) * NV + d] = dcom[i];
        Jq[(3 * NE + 3 + i) * NV + d] = dhl[i];
        Jq[(3 * NE + 6 + i) * NV + d] = dha[i];
      } else {
        Ag[i * NV + d] = dhl[i];
        Ag[(3 + i) * NV + d] = dha[i];
      }
    }
  }
}

// ------------------------------------------------------------ the DDP ------

template <typename T>
struct DdpInputs {
  const T *x0, *ee_t, *com_ref, *mom_ref, *x_reg, *w_stage, *w_term, *wu, *dts;
};

// One problem's work arrays: all but the alphas' candidates in its slice of
// the block's shared memory (a plain array in the host build).
template <typename T>
struct DdpWork {
  T *xs, *us, *kff, *Kfb;              // trajectory and gains
  T *Lx, *Qxx, *Fb;  // the current knot: GN gradient, curvature (made Qxx), [A6 | Jr6]
  T *Vx, *Vxx, *Qx, *Qu, *Qux, *Quu, *Lc;  // the Riccati step
  T *U;   // the knot's FK cache and rows | the step's 18x18 products | its 36x36 T1
  T *kc;  // per alpha and knot: the rollouts' costs
  // device memory, problem-major: per alpha, the candidate trajectory; per
  // knot, the record of what its Gauss-Newton data needs from the trajectory
  T *xsA, *usA, *rec;
};

constexpr int KIN_N = (int)(sizeof(Kin<float>) / sizeof(float));
constexpr int JQ_ROWS = 3 * NE + 3 + 6;  // [ee | com | h]
// a knot's record: [FK cache | residual | B6 = Jr^-1(sdiff base) | A6 | Jr6]
constexpr int REC_N = KIN_N + NR + 36 + 72;
static_assert(KIN_N + NR + 36 + (JQ_ROWS + 6) * NV <= NDX * NDX, "the knot's data fits in U");

// Element offsets of one problem's shared-memory slice: the work arrays,
// then the inputs, staged there once.
struct DdpLayout {
  long xs, us, kff, Kfb, Lx, Qxx, Fb, Vx, Vxx, Qx, Qu, Qux, Quu, Lc, U, kc;
  long x0, ee_t, com_ref, mom_ref, x_reg, w_stage, w_term, wu, dts, n;
};

HD DdpLayout ddp_layout(int H) {
  long o = 0;
  auto take = [&](long n) {
    const long at = o;
    o += n;
    return at;
  };
  DdpLayout L;
  L.xs = take((H + 1L) * NX); L.us = take((long)H * NV); L.kff = take((long)H * NV);
  L.Kfb = take((long)H * NV * NDX);
  L.Lx = take(NDX); L.Qxx = take(NDX * NDX); L.Fb = take(72);
  L.Vx = take(NDX); L.Vxx = take(NDX * NDX); L.Qx = take(NDX); L.Qu = take(NV);
  L.Qux = take(NDX * NV); L.Quu = take(NV * NV); L.Lc = take(NV * NV);
  L.U = take(NDX * NDX); L.kc = take(MAX_ALPHAS * (H + 1L));
  L.x0 = take(NX); L.ee_t = take((long)H * NE * 3); L.com_ref = take((H + 1L) * 3);
  L.mom_ref = take((H + 1L) * 6); L.x_reg = take((H + 1L) * NX); L.w_stage = take((long)H * NR);
  L.w_term = take(NRT); L.wu = take((long)H * NV); L.dts = take(H);
  L.n = o;
  return L;
}

// device-memory elements per problem: the alphas' candidate trajectories,
// the knots' records
HD long ddp_global_elems(int H) {
  return MAX_ALPHAS * ((H + 1L) * NX + (long)H * NV) + (H + 1L) * REC_N;
}

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

// the states and controls of a forward rollout u_k = us_k + alpha kff_k +
// Kfb_k (x (-) xs_k) (or zero controls) into xs_out/us_out; its cost is
// knot_cost's, knot by knot, summed by total_cost
template <typename T>
HD void rollout(const DdpInputs<T>& in, const DdpWork<T>& w, int H, T alpha, bool zero_controls,
                T* xs_out, T* us_out) {
  T x[NX], xn[NX], u[NV], dx[NDX];
  for (int i = 0; i < NX; ++i) x[i] = in.x0[i];
  for (int i = 0; i < NX; ++i) xs_out[i] = x[i];
  for (int k = 0; k < H; ++k) {
    if (zero_controls) {
      for (int i = 0; i < NV; ++i) u[i] = T(0);
    } else {
      state_diff(w.xs + k * NX, x, dx);
      for (int i = 0; i < NV; ++i) {
        T s = w.us[k * NV + i] + alpha * w.kff[k * NV + i];
        for (int j = 0; j < NDX; ++j) s += w.Kfb[(k * NV + i) * NDX + j] * dx[j];
        u[i] = s;
      }
    }
    step(x, u, in.dts[k], xn);
    for (int i = 0; i < NV; ++i) us_out[k * NV + i] = u[i];
    for (int i = 0; i < NX; ++i) xs_out[(k + 1) * NX + i] = xn[i];
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
}

// the cost of knot k of a stored trajectory (k == H: the terminal cost)
template <typename T>
HD T knot_cost(const ModelView<T>& mv, const DdpInputs<T>& in, const T* xs, const T* us, int H,
               int k) {
  return k < H ? stage_cost(mv, in, xs + k * NX, us + k * NV, k)
               : term_cost(mv, in, xs + H * NX, H);
}

// a trajectory's cost from its knots' costs, summed in knot order
template <typename T>
HD T total_cost(const T* kc, int H) {
  T c = T(0);
  for (int k = 0; k < H; ++k) c += kc[k];
  return c + kc[H];
}

// A knot's Gauss-Newton rows: Jq = [ee | com | h] (q-part), Ag (the h rows'
// v-part), the residual r, B6 = Jr^-1(sdiff base), the weights and scale.
template <typename T>
struct GnRows {
  const T *Jq, *Ag, *r, *B6, *wts;
  bool terminal;
  T scale;
};

// Entry (a, b) of the Gauss-Newton curvature of 0.5 r'Wr: rows [ee | com | h
// | sdiff] (stage) or [com | h | sdiff] (terminal); the sdiff q-rows are B6
// for the base and identity for the joints, its v-rows identity. Each
// entry's terms are summed in the order a row-by-row accumulation adds them
// (rows with a q-part only skip a zero factor, as it does: by a select, not
// a branch the lanes would take apart), then scaled.
template <typename T>
HD T gn_curv(const GnRows<T>& G, int a, int b) {
  const int off = G.terminal ? 0 : 3 * NE;
  const T* ws = G.wts + off + 9;  // the sdiff rows' weights
  const T* wh = G.wts + off + 3;  // the momentum rows' weights
  const T* Jh = G.Jq + (3 * NE + 3) * NV;
  T s = T(0);
  if (a < NV && b < NV) {
    if (!G.terminal)
      for (int i = 0; i < 3 * NE; ++i) {
        const T ra = G.Jq[i * NV + a], t = s + (ra * G.wts[i]) * G.Jq[i * NV + b];
        s = ra != T(0) ? t : s;
      }
    for (int i = 0; i < 3; ++i) {
      const T ra = G.Jq[(3 * NE + i) * NV + a];
      const T t = s + (ra * G.wts[off + i]) * G.Jq[(3 * NE + i) * NV + b];
      s = ra != T(0) ? t : s;
    }
    for (int i = 0; i < 6; ++i) s += (Jh[i * NV + a] * wh[i]) * Jh[i * NV + b];
    if (a < 6)
      for (int i = 0; i < 6; ++i) {
        const T ra = G.B6[i * 6 + a], t = s + (ra * ws[i]) * (b < 6 ? G.B6[i * 6 + b] : T(0));
        s = ra != T(0) ? t : s;
      }
    if (a == b && a >= 6) s += ws[a];  // joint identity rows
  } else if (a < NV || b < NV) {  // H_qv, and H_vq = H_qv'
    const int q = a < NV ? a : b, v = (a < NV ? b : a) - NV;
    for (int i = 0; i < 6; ++i) s += (Jh[i * NV + q] * wh[i]) * G.Ag[i * NV + v];
  } else {
    for (int i = 0; i < 6; ++i) s += (G.Ag[i * NV + a - NV] * wh[i]) * G.Ag[i * NV + b - NV];
    if (a == b) s += ws[a];  // velocity identity rows
  }
  return s * G.scale;
}

// entry a of the Gauss-Newton gradient, in the same order
template <typename T>
HD T gn_grad(const GnRows<T>& G, int a) {
  const int off = G.terminal ? 0 : 3 * NE;
  const T *ws = G.wts + off + 9, *rs = G.r + off + 9;
  const T *wh = G.wts + off + 3, *rh = G.r + off + 3;
  const T* Jh = G.Jq + (3 * NE + 3) * NV;
  T s = T(0);
  if (a < NV) {
    if (!G.terminal)
      for (int i = 0; i < 3 * NE; ++i) {
        const T ra = G.Jq[i * NV + a], t = s + ra * (G.wts[i] * G.r[i]);
        s = ra != T(0) ? t : s;
      }
    for (int i = 0; i < 3; ++i) {
      const T ra = G.Jq[(3 * NE + i) * NV + a], t = s + ra * (G.wts[off + i] * G.r[off + i]);
      s = ra != T(0) ? t : s;
    }
    for (int i = 0; i < 6; ++i) s += Jh[i * NV + a] * (wh[i] * rh[i]);
    if (a < 6) {
      for (int i = 0; i < 6; ++i) {
        const T ra = G.B6[i * 6 + a], t = s + ra * (ws[i] * rs[i]);
        s = ra != T(0) ? t : s;
      }
    } else {
      s += ws[a] * rs[a];
    }
  } else {
    for (int i = 0; i < 6; ++i) s += G.Ag[i * NV + a - NV] * (wh[i] * rh[i]);
    s += ws[a] * rs[a];
  }
  return s * G.scale;
}

// Knot k's record at the current trajectory: its kinematics (the FK
// cache), its residual, B6 = Jr^-1(sdiff base) and, for k < H, the 6x6 base
// blocks of the step Jacobians [A6 | Jr6]. Knots are independent of each
// other and of the backward sweep.
template <typename T>
HD void knot_record(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
                    int k) {
  const bool term = k == H;
  const T* x = w.xs + k * NX;
  T* rec = w.rec + (long)k * REC_N;
  Kin<T>& kin = *reinterpret_cast<Kin<T>*>(rec);
  T* r = rec + KIN_N;
  kinematics(mv, x, kin);
  residual(mv, kin, x, term ? (const T*)nullptr : in.ee_t + k * NE * 3, in.com_ref + k * 3,
           in.mom_ref + k * 6, in.x_reg + k * NX, term, r);
  const T* rs = r + (term ? 0 : 3 * NE) + 9;
  se3_Jr_inv(rs, rs + 3, r + NR);
  if (term) return;
  // the step x+ = (q (+) v+ dt, v+), v+ = v + u dt: Fx = [[A, Bd], [0, I]],
  // Fu = [[C], [dt I]] with A = blk(A6, 1), Bd = blk(Jr6 dt, dt),
  // C = blk(Jr6 dt^2, dt^2), where blk(M6, s) is a 6x6 base block followed
  // by s times the 12x12 identity on the joints
  const T dt = in.dts[k];
  T w6[6];
  for (int i = 0; i < 6; ++i) w6[i] = (x[NQ + i] + w.us[k * NV + i] * dt) * dt;
  const T nw[6] = {-w6[0], -w6[1], -w6[2], -w6[3], -w6[4], -w6[5]};
  se3_adjoint_exp(nw, nw + 3, r + NR + 36);
  se3_Jr(w6, w6 + 3, r + NR + 72);
}

// Gauss-Newton data of knot k (k == H: the terminal cost) at the current
// trajectory, from its record: the curvature into Hm, the gradient into g,
// for k < H the step blocks into w.Fb. Three phases: every lane copies part
// of the record into shared memory (w.U, w.Fb); every lane takes tangent
// directions (36: 18 configuration, 18 velocity); every lane takes entries
// of Hm and g.
template <typename T, class Exec>
HD void knot_derivs(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
                    int k, T* Hm, T* g, const Exec& exec) {
  const bool term = k == H;
  const T* x = w.xs + k * NX;
  const Kin<T>& kin = *reinterpret_cast<const Kin<T>*>(w.U);
  const T* r = w.U + KIN_N;
  const T* B6 = r + NR;
  T* Jq = w.U + KIN_N + NR + 36;
  T* Ag = Jq + JQ_ROWS * NV;
  long long t = exec.prof.now();
  exec([&](int lane) {
    const T* rec = w.rec + (long)k * REC_N;
    for (int i = lane; i < KIN_N + NR + 36; i += LANES) w.U[i] = rec[i];
    if (!term)
      for (int i = lane; i < 72; i += LANES) w.Fb[i] = rec[KIN_N + NR + 36 + i];
  });
  exec.prof.add(PH_DERIVS_COPY, t);
  t = exec.prof.now();
  exec([&](int lane) {
    for (int d = lane; d < NDX; d += LANES) tangent_dir(mv, kin, x, !term, d, Jq, Ag);
  });
  exec.prof.add(PH_DERIVS_TANGENT, t);
  t = exec.prof.now();
  const GnRows<T> G{Jq, Ag, r, B6, term ? in.w_term : in.w_stage + k * NR, term,
                    term ? T(1) : in.dts[k]};
  exec([&](int lane) {
    // the entries quadrant by quadrant (qq, qv, vq, vv), so that a warp's
    // lanes mostly take the same branch of gn_curv
    for (int e = lane; e < NDX * NDX; e += LANES) {
      const int quad = e / (NV * NV), i = e % (NV * NV);
      const int a = i / NV + (quad >= 2 ? NV : 0), b = i % NV + (quad % 2 ? NV : 0);
      Hm[a * NDX + b] = gn_curv(G, a, b);
    }
    for (int a = lane; a < NDX; a += LANES) g[a] = gn_grad(G, a);
  });
  exec.prof.add(PH_DERIVS_GN, t);
}

// element (i, j) of blk(M6 f, s)' X, X an 18x18 block with row stride ld;
// M6 f is the 6x6 block scaled element by element
template <typename T>
HD T blkT_el(const T* M6, T f, T s, const T* X, int ld, int i, int j) {
  if (i >= 6) return s * X[i * ld + j];
  T v = T(0);
  for (int k = 0; k < 6; ++k) v += (M6[k * 6 + i] * f) * X[k * ld + j];
  return v;
}

// element (i, j) of X blk(M6 f, s)
template <typename T>
HD T blk_el(const T* X, int ld, const T* M6, T f, T s, int i, int j) {
  if (j >= 6) return s * X[i * ld + j];
  T v = T(0);
  for (int k = 0; k < 6; ++k) v += X[i * ld + k] * (M6[k * 6 + j] * f);
  return v;
}

// One knot of the Riccati sweep, every step split over the lanes: the
// quadrant products of Vxx with the step blocks (A6, B6 = Jr6 dt, C6 = Jr6
// dt^2); Qxx, Quu, Qux, Qx, Qu; the Cholesky of Quu (clamp rsqrt(max(d,
// 1e-20))), a phase per pair of columns: the columns of L and the rank-1
// updates of the trailing lower block, entry by entry; the gains [kff | Kfb]
// = -Quu^-1 [Qu | Qux], a column per lane; Vx and Qxx + Kfb'Qux; the
// symmetrized Vxx.
template <typename T, class Exec>
HD void riccati_knot(const DdpInputs<T>& in, const DdpWork<T>& w, int k, T reg,
                     const Exec& exec) {
  const T dt = in.dts[k], dt2 = dt * dt;
  const T* wu = in.wu + k * NV;
  const T *A6 = w.Fb, *J6 = w.Fb + 36;
  T* Qxx = w.Qxx;  // Lxx, made Qxx in place
  const T *V11 = w.Vxx, *V12 = w.Vxx + NV, *V21 = w.Vxx + NV * NDX,
          *V22 = w.Vxx + NV * NDX + NV;
  T *AtV = w.U, *BtV = w.U + NV * NV, *CtV = w.U + 2 * NV * NV, *D = w.U + 3 * NV * NV;
  long long t = exec.prof.now();
  exec([&](int lane) {
    for (int e = lane; e < NV * NV; e += LANES) {
      const int i = e / NV, j = e % NV;
      AtV[e] = blkT_el(A6, T(1), T(1), V11, NDX, i, j);
      BtV[e] = blkT_el(J6, dt, dt, V11, NDX, i, j);
      const T c = blkT_el(J6, dt2, dt2, V11, NDX, i, j);
      CtV[e] = c;
      D[e] = c + dt * V21[i * NDX + j];  // Fu' [V11; V21]
    }
  });
  exec([&](int lane) {
    for (int e = lane; e < NV * NV; e += LANES) {
      const int i = e / NV, j = e % NV;
      // Qxx = Lxx + Fx' Vxx Fx
      const T qq = blk_el(AtV, NV, A6, T(1), T(1), i, j);
      const T qv = blk_el(AtV, NV, J6, dt, dt, i, j) + blkT_el(A6, T(1), T(1), V12, NDX, i, j);
      const T vv = blk_el(BtV, NV, J6, dt, dt, i, j) + blkT_el(J6, dt, dt, V12, NDX, i, j) +
                   blk_el(V21, NDX, J6, dt, dt, i, j) + V22[i * NDX + j];
      Qxx[i * NDX + j] += qq;
      Qxx[i * NDX + NV + j] += qv;
      Qxx[(NV + j) * NDX + i] += qv;
      Qxx[(NV + i) * NDX + NV + j] += vv;
      // Quu = Luu + Fu' Vxx Fu + reg I ; Qux = Fu' Vxx Fx
      T quu = blk_el(CtV, NV, J6, dt2, dt2, i, j) + dt * blkT_el(J6, dt2, dt2, V12, NDX, i, j) +
              dt * blk_el(V21, NDX, J6, dt2, dt2, i, j) + dt2 * V22[i * NDX + j];
      if (i == j) quu += dt * wu[i] + reg;
      w.Quu[e] = quu;
      w.Qux[i * NDX + j] = blk_el(D, NV, A6, T(1), T(1), i, j);
      w.Qux[i * NDX + NV + j] = blk_el(D, NV, J6, dt, dt, i, j) +
                                blkT_el(J6, dt2, dt2, V12, NDX, i, j) + dt * V22[i * NDX + j];
    }
    // Qx = Lx + Fx' Vx ; Qu = Lu + Fu' Vx
    for (int a = lane; a < NV; a += LANES) {
      T ax = w.Vx[a], bx = dt * w.Vx[a], cx = dt2 * w.Vx[a];
      if (a < 6) {
        ax = bx = cx = T(0);
        for (int m = 0; m < 6; ++m) {
          ax += A6[m * 6 + a] * w.Vx[m];
          bx += (J6[m * 6 + a] * dt) * w.Vx[m];
          cx += (J6[m * 6 + a] * dt2) * w.Vx[m];
        }
      }
      w.Qx[a] = w.Lx[a] + ax;
      w.Qx[NV + a] = w.Lx[NV + a] + bx + w.Vx[NV + a];
      w.Qu[a] = dt * wu[a] * w.us[k * NV + a] + cx + dt * w.Vx[NV + a];
    }
  });
  exec.prof.add(PH_RIC_PRODUCTS, t);
  const long long t_chol = exec.prof.now();
  static_assert(NV % 2 == 0, "the factor takes its columns in pairs");
  for (int j = 0; j < NV; j += 2)
    exec([&](int lane) {
      // columns j and j+1 of L, and the two rank-1 updates of the rows and
      // columns > j+1 (the lower triangle: all the factor reads). Column j+1
      // after column j's update, q1(a), is recomputed where needed, by the
      // same expression as the update, so each entry of Quu and L gets the
      // operations of the one-column-a-phase factor in the same order.
      const T* Q = w.Quu;
      const T inv0 = s_rsqrt(s_max(Q[j * NV + j], T(1e-20)));
      const T l10 = Q[(j + 1) * NV + j] * inv0;
      auto q1 = [&](int a) {
        T q = Q[a * NV + j + 1];
        q -= (Q[a * NV + j] * inv0) * l10;
        return q;
      };
      const T inv1 = s_rsqrt(s_max(q1(j + 1), T(1e-20)));
      const int m0 = NV - j, m1 = NV - j - 1, n = NV - j - 2;
      for (int e = lane; e < m0 + m1 + n * n; e += LANES) {
        if (e < m0) {
          w.Lc[(j + e) * NV + j] = Q[(j + e) * NV + j] * inv0;
        } else if (e < m0 + m1) {
          const int i = j + 1 + e - m0;
          w.Lc[i * NV + j + 1] = q1(i) * inv1;
        } else {
          const int a = j + 2 + (e - m0 - m1) / n, b = j + 2 + (e - m0 - m1) % n;
          if (b > a) continue;
          T q = Q[a * NV + b];
          q -= (Q[a * NV + j] * inv0) * (Q[b * NV + j] * inv0);
          q -= (q1(a) * inv1) * (q1(b) * inv1);
          w.Quu[a * NV + b] = q;
        }
      }
    });
  exec.prof.add(PH_CHOL, t_chol);
  t = exec.prof.now();
  exec([&](int lane) {  // [kff | Kfb] = -Quu^-1 [Qu | Qux]
    for (int c = lane; c <= NDX; c += LANES) {
      T y[NV];  // in registers: every loop below unrolls
      BK_UNROLL
      for (int i = 0; i < NV; ++i) {
        T s = c == 0 ? w.Qu[i] : w.Qux[i * NDX + c - 1];
        BK_UNROLL
        for (int m = 0; m < i; ++m) s -= w.Lc[i * NV + m] * y[m];
        y[i] = s / w.Lc[i * NV + i];
      }
      BK_UNROLL
      for (int i = NV - 1; i >= 0; --i) {
        T s = y[i];
        BK_UNROLL
        for (int m = i + 1; m < NV; ++m) s -= w.Lc[m * NV + i] * y[m];
        y[i] = s / w.Lc[i * NV + i];
      }
      BK_UNROLL
      for (int i = 0; i < NV; ++i) {
        if (c == 0)
          w.kff[k * NV + i] = -y[i];
        else
          w.Kfb[(k * NV + i) * NDX + c - 1] = -y[i];
      }
    }
  });
  exec.prof.add(PH_RIC_GAINS, t);
  t = exec.prof.now();
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
      w.U[e] = s;  // T1
    }
  });
  exec([&](int lane) {  // Vxx = sym(T1)
    for (int e = lane; e < NDX * NDX; e += LANES) {
      const int a = e / NDX, b = e % NDX;
      w.Vxx[e] = T(0.5) * (w.U[e] + w.U[b * NDX + a]);
    }
  });
  exec.prof.add(PH_RIC_VXX, t);
}

// The costs of n stored trajectories (candidate a at xs + a nxs, us + a nus),
// knot by knot over the lanes, into w.kc[a (H+1) + k].
template <typename T, class Exec>
HD void rollout_costs(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w,
                      int H, int n, const T* xs, const T* us, const Exec& exec) {
  const int nk = H + 1;
  exec([&](int lane) {
    for (int e = lane; e < n * nk; e += LANES) {
      const int a = e / nk;
      w.kc[e] = knot_cost(mv, in, xs + a * nk * (long)NX, us + a * (long)H * NV, H, e % nk);
    }
  });
}

// The DDP of one problem as a sequence of phases run by LANES lanes; exec(f)
// calls f(lane) on every lane and then waits for all of them (a warp barrier
// on the card, a loop over the lanes on the host). The backward sweep runs
// knot by knot from the terminal cost: each knot's Gauss-Newton data, then
// its Riccati step, both split over the lanes. A rollout's state recursion
// takes a lane (the alphas' side by side); its knots' costs, which no later
// state depends on, go over the lanes. Lanes exchange data through the work
// arrays only; code outside exec runs on every lane alike and reads values
// every lane sees the same (the costs, the line-search decision), so the
// lanes always agree.
template <typename T, class Exec>
HD void ddp_problem(const ModelView<T>& mv, const DdpInputs<T>& in, const DdpWork<T>& w, int H,
                    int n_iters, int n_alpha, const T* alphas, T reg, T* cost_out,
                    const Exec& exec) {
  const long nxs = (H + 1L) * NX, nus = (long)H * NV;
  const long long t_all = exec.prof.now();
  long long t = t_all;
  exec([&](int lane) {  // zero controls, straight into the trajectory
    if (lane == 0) rollout(in, w, H, T(0), true, w.xs, w.us);
  });
  rollout_costs(mv, in, w, H, 1, w.xs, w.us, exec);
  T cost = total_cost(w.kc, H);
  exec.prof.add(PH_ROLLOUT0, t);
  for (int it = 0; it < n_iters; ++it) {
    t = exec.prof.now();
    exec([&](int lane) {  // every knot's record, a knot per lane
      for (int k = lane; k <= H; k += LANES) knot_record(mv, in, w, H, k);
    });
    exec.prof.add(PH_DERIVS_REC, t);
    t = exec.prof.now();
    knot_derivs(mv, in, w, H, H, w.Vxx, w.Vx, exec);  // Vx, Vxx from the terminal cost
    exec.prof.add(PH_DERIVS, t);
    for (int k = H - 1; k >= 0; --k) {
      t = exec.prof.now();
      knot_derivs(mv, in, w, H, k, w.Qxx, w.Lx, exec);
      exec.prof.add(PH_DERIVS, t);
      t = exec.prof.now();
      riccati_knot(in, w, k, reg, exec);
      exec.prof.add(PH_RICCATI, t);
    }
    t = exec.prof.now();
    exec([&](int lane) {  // every alpha's rollout, each into its own candidate
      for (int a = lane; a < n_alpha; a += LANES)
        rollout(in, w, H, alphas[a], false, w.xsA + a * nxs, w.usA + a * nus);
    });
    rollout_costs(mv, in, w, H, n_alpha, w.xsA, w.usA, exec);
    exec.prof.add(PH_ALPHAS, t);
    t = exec.prof.now();
    int best = -1;
    T best_cost = T(3.0e38);
    for (int a = 0; a < n_alpha; ++a) {
      const T c = total_cost(w.kc + a * (H + 1), H);
      if (c < best_cost) {  // strict: the earliest alpha wins a tie
        best_cost = c;
        best = a;
      }
    }
    // the best candidate; with none below 3e38 the rollout at alpha 0
    T c_store = best_cost;
    if (best < 0) {
      best = 0;
      exec([&](int lane) {
        if (lane == 0) rollout(in, w, H, T(0), false, w.xsA, w.usA);
      });
      rollout_costs(mv, in, w, H, 1, w.xsA, w.usA, exec);
      c_store = total_cost(w.kc, H);
    }
    if (c_store < cost) {
      exec([&](int lane) {
        for (long i = lane; i < nxs; i += LANES) w.xs[i] = w.xsA[best * nxs + i];
        for (long i = lane; i < nus; i += LANES) w.us[i] = w.usA[best * nus + i];
      });
    }
    // cost = min(cost, c_store), NaN-propagating like jnp.minimum
    cost = (cost != cost || c_store != c_store) ? cost + c_store
                                                : (c_store < cost ? c_store : cost);
    exec.prof.add(PH_DECISION, t);
  }
  exec([&](int lane) {
    if (lane == 0) *cost_out = cost;
  });
  exec.prof.add(PH_TOTAL, t_all);
}

// Problem b: stage its inputs into its slice sh of shared memory, solve,
// write its trajectory. scratch: the batch's device-memory work arrays,
// problem-major (ddp_global_elems each).
template <typename T, class Exec>
HD void ddp_one(int b, int H, int n_iters, int n_alpha, T reg, const T* model, const T* alphas,
                const T* x0, const T* ee_t, const T* com_ref, const T* mom_ref, const T* x_reg,
                const T* w_stage, const T* w_term, const T* wu, const T* dts, T* xs_out,
                T* us_out, T* cost, T* sh, T* scratch, const Exec& exec) {
  const ModelView<T> mv{model};
  const DdpLayout L = ddp_layout(H);
  const long nxs = (H + 1L) * NX, nus = (long)H * NV;
  const T* src[9] = {x0 + (long)b * NX,           ee_t + (long)b * H * NE * 3,
                     com_ref + (long)b * (H + 1) * 3, mom_ref + (long)b * (H + 1) * 6,
                     x_reg + (long)b * nxs,       w_stage + (long)b * H * NR,
                     w_term + (long)b * NRT,      wu + (long)b * nus,
                     dts + (long)b * H};
  const long dst[9] = {L.x0, L.ee_t, L.com_ref, L.mom_ref, L.x_reg, L.w_stage, L.w_term, L.wu,
                       L.dts};
  const long len[9] = {NX,  (long)H * NE * 3, (H + 1L) * 3, (H + 1L) * 6, nxs, (long)H * NR,
                       NRT, nus,              H};
  exec([&](int lane) {
    for (int q = 0; q < 9; ++q)
      for (long i = lane; i < len[q]; i += LANES) sh[dst[q] + i] = src[q][i];
  });
  const DdpInputs<T> in{sh + L.x0,    sh + L.ee_t,    sh + L.com_ref, sh + L.mom_ref, sh + L.x_reg,
                        sh + L.w_stage, sh + L.w_term, sh + L.wu,     sh + L.dts};
  DdpWork<T> w;
  w.xs = sh + L.xs; w.us = sh + L.us; w.kff = sh + L.kff; w.Kfb = sh + L.Kfb;
  w.Lx = sh + L.Lx; w.Qxx = sh + L.Qxx; w.Fb = sh + L.Fb;
  w.Vx = sh + L.Vx; w.Vxx = sh + L.Vxx; w.Qx = sh + L.Qx; w.Qu = sh + L.Qu;
  w.Qux = sh + L.Qux; w.Quu = sh + L.Quu; w.Lc = sh + L.Lc; w.U = sh + L.U; w.kc = sh + L.kc;
  w.xsA = scratch + (long)b * ddp_global_elems(H);
  w.usA = w.xsA + MAX_ALPHAS * nxs;
  w.rec = w.usA + MAX_ALPHAS * nus;
  ddp_problem(mv, in, w, H, n_iters, n_alpha, alphas, reg, cost + b, exec);
  exec([&](int lane) {
    for (long i = lane; i < nxs; i += LANES) xs_out[(long)b * nxs + i] = w.xs[i];
    for (long i = lane; i < nus; i += LANES) us_out[(long)b * nus + i] = w.us[i];
  });
}

}  // namespace bk

// Elements per problem: of shared memory, and of the device-memory scratch.
extern "C" long ddp_shared_size(int H) { return bk::ddp_layout(H).n; }
extern "C" long ddp_scratch_size(int H) { return bk::ddp_global_elems(H); }

#define DDP_ARGS(T)                                                                        \
  int B, int H, int n_iters, int n_alpha, double reg, const T *model, const T *alphas,    \
      const T *x0, const T *ee_t, const T *com_ref, const T *mom_ref, const T *x_reg,      \
      const T *w_stage, const T *w_term, const T *wu, const T *dts, T *xs, T *us, T *cost, \
      T *scratch
#define DDP_CALL(T, b, sh, exec)                                                            \
  bk::ddp_one<T>(b, H, n_iters, n_alpha, T(reg), model, alphas, x0, ee_t, com_ref, mom_ref, \
                 x_reg, w_stage, w_term, wu, dts, xs, us, cost, sh, scratch, exec)

#ifdef __CUDACC__

__global__ void ddp_kernel(DDP_ARGS(float)) {
  extern __shared__ float smem[];
  const int p = threadIdx.x / bk::LANES, lane = threadIdx.x % bk::LANES;
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + p;
  if (b >= B) return;  // the whole warp: no barrier is left waiting
  float* sh = smem + (long)p * bk::ddp_layout(H).n;
  DDP_CALL(float, b, sh, (bk::DeviceExec{lane, bk::make_prof(b, lane == 0)}));
}

BK_SET_PROFILE(ddp)

// Launch on the caller's stream with `problems` problems (a warp and a
// shared-memory slice each) per block; returns cudaGetLastError() or the
// refusal of the block's shared memory (0 = launched).
extern "C" int ddp_launch_f32(DDP_ARGS(float), int problems, void* stream) {
  const int blocks = (B + problems - 1) / problems;
  const size_t bytes = (size_t)problems * bk::ddp_layout(H).n * sizeof(float);
  const cudaError_t e =
      cudaFuncSetAttribute(ddp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ddp_kernel<<<blocks, problems * bk::LANES, bytes, (cudaStream_t)stream>>>(
      B, H, n_iters, n_alpha, reg, model, alphas, x0, ee_t, com_ref, mom_ref, x_reg, w_stage,
      w_term, wu, dts, xs, us, cost, scratch);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: the shared-memory slice is a plain array

#include <vector>

template <typename T>
int ddp_host(DDP_ARGS(T)) {
  std::vector<T> sh(bk::ddp_layout(H).n);
  for (int b = 0; b < B; ++b) DDP_CALL(T, b, sh.data(), bk::HostExec{});
  return 0;
}

extern "C" int ddp_host_f32(DDP_ARGS(float)) {
  return ddp_host<float>(B, H, n_iters, n_alpha, reg, model, alphas, x0, ee_t, com_ref, mom_ref,
                         x_reg, w_stage, w_term, wu, dts, xs, us, cost, scratch);
}

extern "C" int ddp_host_f64(DDP_ARGS(double)) {
  return ddp_host<double>(B, H, n_iters, n_alpha, reg, model, alphas, x0, ee_t, com_ref,
                          mom_ref, x_reg, w_stage, w_term, wu, dts, xs, us, cost, scratch);
}

#endif
