// K4: one 1 ms substep of the closed loop (sim/rollout.py: _substep) for
// every episode of a batch, in one launch, in place on the loop's buffers.
//
// K4 replaces no TPU kernel: the JAX package writes the substep in plain jnp
// inside its scan (bunmpc_tpu/sim/rollout.py), and the port's plain version,
// replayed as one CUDA graph, is ~2,670 small PyTorch kernels a step (~4.2 ms
// at B=512 on an H100). One substep of an episode: the measured state (sensor
// bias, the quaternion renormalised); the ID controller (desired-state FK and
// RNEA, the four foot Jacobians and J^T f with force_gate, PD feedback with
// swing_blend on the gait's stance clock, saturation); the physics step (FK
// and body velocities, foot kinematics on flat ground or a heightfield, the
// mass matrix as RNEA columns and the RNEA bias, one Cholesky factor of M for
// M^-1 (tau - bias) and M^-1 J^T, the implicit contact system
// (I + dt D G) f = k - D u_free solved by LU with partial pivoting, the
// unilateral and friction-cone projection, the push, semi-implicit Euler and
// quaternion integration); the failure predicate; the eight records at step
// k; failed episodes frozen; i, k and the previous contact advanced. The
// same mathematics as the plain version, in the buffers' dtype.
//
// What bounds it on an H100: an episode reads and writes about 1 KB and
// does about 7e4 floating-point operations (cuda_substep.substep_ops, most
// of them the 18 RNEA columns of M), so B=512 needs ~0.5 us of the card's
// f32 rate: less than a launch costs. The work is a chain of small dependent
// steps (a kinematic tree, an 18x18 factor, a 12x12 pivoted solve), so the
// kernel is bound by latency. Design: a warp per episode (its 32 lanes share
// one episode's phases, a warp barrier between phases; episodes never wait
// for each other), its work set in its slice of the block's shared memory
// (the W_* layout, ~9.6 KB at 12 joints, 4 episodes a block under 48 KB, so
// the launch needs no opt-in); per phase the lanes take what is
// independent: the three kinematic passes side by side, the 18 mass-matrix
// columns beside the bias, the controller's RNEA, the Jacobians and the foot
// forces; the Cholesky a column at a time over the rows; the triangular
// solves a right-hand side per lane; the pivoted LU a column at a time over
// the rows. i and k are device scalars that every block reads at its start;
// the last block to finish (an atomic count) advances them, so a CUDA graph
// of this one launch replays the loop's steps.
//
// Built by bunmpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DBK_SUB_NJ=<nj>
// once per joint count (12: Solo12 and the Go2, 8: Solo8; a tree of chains
// off the base with four feet), float only. Compiled with g++ instead (no
// __CUDACC__) it exports a host loop over the same per-episode phases, in
// float and double, for the CPU tests. The gait clock (swing_blend's stance
// flags) and every division by a configuration number follow the plain
// version on the card: each product and sum rounded on its own (mul_rn,
// add_rn), a division by a Python number a product with its rounded
// reciprocal, as PyTorch computes it there.

#include "common.cuh"

namespace bk {

constexpr int SNE = 4;         // feet
constexpr int SNC = 3 * SNE;   // contact rows

HD float s_asin(float x) { return asinf(x); }
HD double s_asin(double x) { return asin(x); }
HD float s_floor(float x) { return floorf(x); }
HD double s_floor(double x) { return floor(x); }
template <typename T>
HD T s_abs(T x) { return x < T(0) ? -x : x; }
// torch.clamp: NaN stays NaN
template <typename T>
HD T s_clamp(T x, T lo, T hi) { return x < lo ? lo : (x > hi ? hi : x); }
// x / c for a number c of the configuration, as PyTorch divides a tensor by
// a Python number on the card: a product with the reciprocal
template <typename T>
HD T div_c(T x, double c) { return x * (T(1) / T(c)); }

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
// SO(3) left Jacobian V(w): exp6's translation is V v
template <typename T>
HD void so3_V(const T* w, T* V) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-10);
  const T sqs = small ? T(1) : sq;
  const T t = s_sqrt(sqs);
  const T K[9] = {T(0), -w[2], w[1], w[2], T(0), -w[0], -w[1], w[0], T(0)};
  T K2[9];
  mm3(K, K, K2);
  const T a = small ? T(0.5) - sq / T(24) : (T(1) - s_cos(t)) / sqs;
  const T b = small ? T(1) / T(6) - sq / T(120) : (t - s_sin(t)) / (sqs * t);
  for (int i = 0; i < 9; ++i) V[i] = (i % 4 == 0 ? T(1) : T(0)) + a * K[i] + b * K2[i];
}

// The arguments of a launch: pointers (null where an option is absent), the
// configuration's numbers and the sizes. cuda_substep.py passes them as three
// arrays in the orders of the enums below (PTRS, SCALARS, INTS there).
enum {
  A_MODEL, A_GAIT, A_PARAMS, A_Q, A_V, A_QNOISE, A_VNOISE, A_XS, A_US, A_FI, A_FAILED,
  A_MPC_BAD, A_FAIL_STEP, A_SIM_T, A_PREV_CNT, A_PUSH, A_VDES, A_WDES, A_HEIGHTS, A_SWING,
  A_GATE, A_LEG_MASK, A_I, A_K, A_DONE, A_STATES, A_ACTIONS, A_VC, A_BASE, A_COM, A_CF, A_CP,
  A_INC, N_PTRS
};
enum {
  S_DT, S_SIM_DT, S_ACT_KP, S_ACT_KD, S_GAIT_ID, S_FAIL_AFTER, S_FAIL_ANGLE, S_GOAL_PERIOD,
  S_GAIT_PERIOD, S_ORIGIN_X, S_ORIGIN_Y, S_CELL, N_SCALARS
};
enum { I_B, I_T, I_NINT, I_ACTION, I_PUSH_STRIDE, I_HN, I_HM, N_INTS };
// the columns of the per-episode parameter table (B, N_PARAMS)
enum { PR_RADIUS, PR_KN, PR_DN, PR_MU, PR_KT, PR_DAMPING, PR_LIMIT, PR_KP, PR_KD, PR_STEP0,
       N_PARAMS };
enum { ACT_TORQUE, ACT_PD_TARGET, ACT_STRUCTURED };

template <typename T>
struct SubArgs {
  const T *model, *gait, *params, *q_noise, *v_noise, *xs, *us, *fi, *sim_t, *push, *v_des,
      *w_des, *heights, *swing, *gate, *leg_mask;
  T *q, *v, *states, *actions, *vc, *base, *com, *cf, *cp;
  const unsigned char* mpc_bad;
  unsigned char *failed, *prev_cnt, *in_contact;
  int* fail_step;
  long long *i, *k;
  unsigned int* done;
  double dt, sim_dt, act_kp, act_kd, gait_id, fail_after, fail_angle, goal_period, gait_period,
      origin_x, origin_y, cell;
  int B, T_, n_int, action, push_stride, hn, hm;
};

template <typename T>
SubArgs<T> sub_args(void* const* p, const double* s, const int* n) {
  SubArgs<T> a;
  a.model = (const T*)p[A_MODEL]; a.gait = (const T*)p[A_GAIT]; a.params = (const T*)p[A_PARAMS];
  a.q = (T*)p[A_Q]; a.v = (T*)p[A_V];
  a.q_noise = (const T*)p[A_QNOISE]; a.v_noise = (const T*)p[A_VNOISE];
  a.xs = (const T*)p[A_XS]; a.us = (const T*)p[A_US]; a.fi = (const T*)p[A_FI];
  a.failed = (unsigned char*)p[A_FAILED]; a.mpc_bad = (const unsigned char*)p[A_MPC_BAD];
  a.fail_step = (int*)p[A_FAIL_STEP]; a.sim_t = (const T*)p[A_SIM_T];
  a.prev_cnt = (unsigned char*)p[A_PREV_CNT]; a.push = (const T*)p[A_PUSH];
  a.v_des = (const T*)p[A_VDES]; a.w_des = (const T*)p[A_WDES];
  a.heights = (const T*)p[A_HEIGHTS]; a.swing = (const T*)p[A_SWING];
  a.gate = (const T*)p[A_GATE]; a.leg_mask = (const T*)p[A_LEG_MASK];
  a.i = (long long*)p[A_I]; a.k = (long long*)p[A_K]; a.done = (unsigned int*)p[A_DONE];
  a.states = (T*)p[A_STATES]; a.actions = (T*)p[A_ACTIONS]; a.vc = (T*)p[A_VC];
  a.base = (T*)p[A_BASE]; a.com = (T*)p[A_COM]; a.cf = (T*)p[A_CF]; a.cp = (T*)p[A_CP];
  a.in_contact = (unsigned char*)p[A_INC];
  a.dt = s[S_DT]; a.sim_dt = s[S_SIM_DT]; a.act_kp = s[S_ACT_KP]; a.act_kd = s[S_ACT_KD];
  a.gait_id = s[S_GAIT_ID]; a.fail_after = s[S_FAIL_AFTER]; a.fail_angle = s[S_FAIL_ANGLE];
  a.goal_period = s[S_GOAL_PERIOD]; a.gait_period = s[S_GAIT_PERIOD];
  a.origin_x = s[S_ORIGIN_X]; a.origin_y = s[S_ORIGIN_Y]; a.cell = s[S_CELL];
  a.B = n[I_B]; a.T_ = n[I_T]; a.n_int = n[I_NINT]; a.action = n[I_ACTION];
  a.push_stride = n[I_PUSH_STRIDE]; a.hn = n[I_HN]; a.hm = n[I_HM];
  return a;
}

// ------------------------------------------- the substep over a joint count -

// Everything below depends on the joint count NJ_ (12: Solo12 and the Go2,
// 8: Solo8), so it lives in a struct templated on it, used as a namespace.
template <int NJ_>
struct Sub {
static constexpr int NJ = NJ_, NB = NJ + 1, NQ = NJ + 7, NV = NJ + 6;
static constexpr int NSTATE = NV + 2 * SNE + NQ - 2;  // state features (43 at 12 joints)
static constexpr int KIN = 18 * NB;                  // per body: R(9) p(3) om(3) vel(3)
static constexpr int DER = 12 * NB + 3 * NJ;         // per body: c_off(3) Iw(9); per joint aw(3)
static constexpr int NR = 1 + SNC;                   // right-hand sides: tau - bias, J^T
static_assert(NV + 14 <= LANES, "the dynamics phase takes NV + 14 lanes");

// The buffer solvers/cuda_ddp.pack_model writes: parent[NJ], joint_rot[NJ][9],
// joint_pos[NJ][3], axis[NJ][3], mass[NB], com[NB][3], inertia[NB][9],
// foot_body[NE], foot_pos[NE][3], total_mass.
template <typename T>
struct ModelView {
  const T* b;
  HD int parent(int j) const { return (int)b[j]; }
  HD const T* jrot(int j) const { return b + NJ + 9 * j; }
  HD const T* jpos(int j) const { return b + 10 * NJ + 3 * j; }
  HD const T* axis(int j) const { return b + 13 * NJ + 3 * j; }
  HD T mass(int i) const { return b[16 * NJ + i]; }
  HD const T* com(int i) const { return b + 16 * NJ + NB + 3 * i; }
  HD const T* inertia(int i) const { return b + 16 * NJ + 4 * NB + 9 * i; }
  HD int foot_body(int f) const { return (int)b[16 * NJ + 13 * NB + f]; }
  HD const T* foot_pos(int f) const { return b + 16 * NJ + 13 * NB + SNE + 3 * f; }
  HD T total_mass() const { return b[16 * NJ + 13 * NB + 4 * SNE]; }
};

// An episode's slice of shared memory (elements): the true, measured and
// desired states, the plan's acceleration and forces, three kinematic passes
// (measured, desired, true) and the derived data of two (desired, true), M
// (factored in place), the right-hand sides (solved in place), J, the
// controller's parts, the contact data and the contact solve.
enum : int {
  W_QT = 0, W_VT = W_QT + NQ, W_QM = W_VT + NV, W_VM = W_QM + NQ, W_QD = W_VM + NV,
  W_VD = W_QD + NQ, W_AD = W_VD + NV, W_FF = W_AD + NV,
  W_KM = W_FF + SNC, W_KD = W_KM + KIN, W_KT = W_KD + KIN,
  W_DD = W_KT + KIN, W_DT = W_DD + DER,
  W_M = W_DT + DER, W_TMP = W_M + NV * NV, W_RHS = W_TMP + NV, W_J = W_RHS + NV * NR,
  W_TEFF = W_J + SNC * NV, W_TID = W_TEFF + SNE * NV, W_BIAS = W_TID + NV,
  W_TAU = W_BIAS + NV, W_TFF = W_TAU + NJ,
  W_POS = W_TFF + NJ, W_PEN = W_POS + SNC, W_ACT = W_PEN + SNE, W_FEETM = W_ACT + SNE,
  W_VF = W_FEETM + SNC, W_A = W_VF + NV, W_BV = W_A + SNC * SNC, W_F = W_BV + SNC,
  W_VN = W_F + SNC, W_N = W_VN + NV
};

// views of a kinematic pass and of its derived data
template <typename T> static HD T* kR(T* K, int b) { return K + 18 * b; }
template <typename T> static HD T* kp(T* K, int b) { return K + 18 * b + 9; }
template <typename T> static HD T* kom(T* K, int b) { return K + 18 * b + 12; }
template <typename T> static HD T* kvel(T* K, int b) { return K + 18 * b + 15; }
template <typename T> static HD T* dcoff(T* D, int b) { return D + 12 * b; }
template <typename T> static HD T* dIw(T* D, int b) { return D + 12 * b + 3; }
template <typename T> static HD T* daw(T* D, int j) { return D + 12 * NB + 3 * j; }

// FK and body velocities (kin/algorithms.py: fk, body_velocities)
template <typename T>
static HD void kinematics(const ModelView<T>& mv, const T* q, const T* v, T* K) {
  quat_to_rot(q + 3, kR(K, 0));
  for (int i = 0; i < 3; ++i) kp(K, 0)[i] = q[i];
  for (int j = 0; j < NJ; ++j) {
    const int b = mv.parent(j), body = j + 1;
    const T* a = mv.axis(j);
    const T c = s_cos(q[7 + j]), s = s_sin(q[7 + j]);
    const T Ka[9] = {T(0), -a[2], a[1], a[2], T(0), -a[0], -a[1], a[0], T(0)};
    T Rrot[9], T1[9], off[3];
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        Rrot[r * 3 + cc] =
            (r == cc ? c : T(0)) + s * Ka[r * 3 + cc] + (T(1) - c) * (a[r] * a[cc]);
    mm3(kR(K, b), mv.jrot(j), T1);
    mm3(T1, Rrot, kR(K, body));
    mv3(kR(K, b), mv.jpos(j), off);
    for (int i = 0; i < 3; ++i) kp(K, body)[i] = kp(K, b)[i] + off[i];
  }
  mv3(kR(K, 0), v + 3, kom(K, 0));
  mv3(kR(K, 0), v, kvel(K, 0));
  for (int j = 0; j < NJ; ++j) {
    const int b = mv.parent(j), body = j + 1;
    T aw[3], r[3], cr[3];
    mv3(kR(K, body), mv.axis(j), aw);
    for (int i = 0; i < 3; ++i) r[i] = kp(K, body)[i] - kp(K, b)[i];
    cross3(kom(K, b), r, cr);
    for (int i = 0; i < 3; ++i) {
      kom(K, body)[i] = kom(K, b)[i] + aw[i] * v[6 + j];
      kvel(K, body)[i] = kvel(K, b)[i] + cr[i];
    }
  }
}

// what a pass gives every RNEA: body b's c_off and Iw = R I R', joint j's aw
template <typename T>
static HD void derived(const ModelView<T>& mv, T* K, T* D, int b) {
  T T1[9], Rt[9];
  const T* R = kR(K, b);
  mv3(R, mv.com(b), dcoff(D, b));
  mm3(R, mv.inertia(b), T1);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Rt[r * 3 + c] = R[c * 3 + r];
  mm3(T1, Rt, dIw(D, b));
  if (b > 0) mv3(R, mv.axis(b - 1), daw(D, b - 1));
}

// Recursive Newton-Euler (kin/algorithms.py: rnea_from_kin) on a pass K and
// its derived data D; `moving` false drops the velocity terms (the mass
// matrix's columns: zero velocities, whose terms are exact zeros there)
template <typename T>
static HD void rnea(const ModelView<T>& mv, T* K, T* D, const T* v, const T* a, bool moving,
                    T g, T* tau) {
  T acc[NB][3], alpha[NB][3], F[NB][3], N[NB][3];
  T* R0 = kR(K, 0);
  mv3(R0, a, acc[0]);
  if (moving) {
    T cr[3];
    cross3(kom(K, 0), kvel(K, 0), cr);
    for (int i = 0; i < 3; ++i) acc[0][i] = acc[0][i] + cr[i];
  }
  mv3(R0, a + 3, alpha[0]);
  for (int j = 0; j < NJ; ++j) {
    const int b = mv.parent(j), body = j + 1;
    const T* aw = daw(D, j);
    T r[3], c1[3];
    for (int i = 0; i < 3; ++i) r[i] = kp(K, body)[i] - kp(K, b)[i];
    cross3(alpha[b], r, c1);
    for (int i = 0; i < 3; ++i) {
      alpha[body][i] = alpha[b][i] + aw[i] * a[6 + j];
      acc[body][i] = acc[b][i] + c1[i];
    }
    if (moving) {
      const T* wp = kom(K, b);
      T c2[3], c3[3], c4[3];
      cross3(wp, aw, c2);
      cross3(wp, r, c3);
      cross3(wp, c3, c4);
      for (int i = 0; i < 3; ++i) {
        alpha[body][i] = alpha[body][i] + c2[i] * v[6 + j];
        acc[body][i] = acc[body][i] + c4[i];
      }
    }
  }
  for (int b = 0; b < NB; ++b) {
    const T* co = dcoff(D, b);
    const T* Iw = dIw(D, b);
    T ac[3], c1[3];
    cross3(alpha[b], co, c1);
    for (int i = 0; i < 3; ++i) ac[i] = acc[b][i] + c1[i];
    mv3(Iw, alpha[b], N[b]);
    if (moving) {
      const T* w = kom(K, b);
      T c2[3], c3[3], Io[3], c4[3];
      cross3(w, co, c2);
      cross3(w, c2, c3);
      for (int i = 0; i < 3; ++i) ac[i] = ac[i] + c3[i];
      mv3(Iw, w, Io);
      cross3(w, Io, c4);
      for (int i = 0; i < 3; ++i) N[b][i] = N[b][i] + c4[i];
    }
    ac[2] = ac[2] + g;
    for (int i = 0; i < 3; ++i) F[b][i] = mv.mass(b) * ac[i];
  }
  // backward: the wrench each body gets from its parent (F, N hold f, n once
  // the body is done; its children are done before it)
  for (int b = NB - 1; b >= 0; --b) {
    T nb[3], fb[3], c1[3];
    cross3(dcoff(D, b), F[b], c1);
    for (int i = 0; i < 3; ++i) {
      nb[i] = N[b][i] + c1[i];
      fb[i] = F[b][i];
    }
    for (int j = 0; j < NJ; ++j) {
      if (mv.parent(j) != b) continue;
      const int cb = j + 1;
      T r[3], c2[3];
      for (int i = 0; i < 3; ++i) r[i] = kp(K, cb)[i] - kp(K, b)[i];
      cross3(r, F[cb], c2);
      for (int i = 0; i < 3; ++i) {
        fb[i] = fb[i] + F[cb][i];
        nb[i] = nb[i] + N[cb][i] + c2[i];
      }
    }
    for (int i = 0; i < 3; ++i) {
      F[b][i] = fb[i];
      N[b][i] = nb[i];
    }
  }
  mtv3(R0, F[0], tau);
  mtv3(R0, N[0], tau + 3);
  for (int j = 0; j < NJ; ++j) {
    const T* aw = daw(D, j);
    tau[6 + j] = aw[0] * N[j + 1][0] + aw[1] * N[j + 1][1] + aw[2] * N[j + 1][2];
  }
}

// foot e's world position on a pass
template <typename T>
static HD void foot_pos(const ModelView<T>& mv, T* K, int e, T* pf) {
  const int fb = mv.foot_body(e);
  T off[3];
  mv3(kR(K, fb), mv.foot_pos(e), off);
  for (int i = 0; i < 3; ++i) pf[i] = kp(K, fb)[i] + off[i];
}

// foot e's translation Jacobian column c (kin/algorithms.py: frame_jacobian)
template <typename T>
static HD void jac_col(const ModelView<T>& mv, T* K, T* D, const T* pf, int e, int c, T* col) {
  const T* R0 = kR(K, 0);
  col[0] = col[1] = col[2] = T(0);
  if (c < 3) {
    for (int i = 0; i < 3; ++i) col[i] = R0[i * 3 + c];
  } else if (c < 6) {
    const T ax[3] = {R0[c - 3], R0[3 + c - 3], R0[6 + c - 3]};
    T rel[3];
    for (int i = 0; i < 3; ++i) rel[i] = pf[i] - kp(K, 0)[i];
    cross3(ax, rel, col);
  } else {
    const int j = c - 6;
    for (int bb = mv.foot_body(e); bb != 0; bb = mv.parent(bb - 1)) {
      if (bb - 1 != j) continue;
      T d[3];
      for (int i = 0; i < 3; ++i) d[i] = pf[i] - kp(K, j + 1)[i];
      cross3(daw(D, j), d, col);
    }
  }
}

// the swing clock of the gait (mpc/gait.py: in_stance) at t: 1 where foot e
// is in stance
template <typename T>
static HD bool in_stance(const T* gait, double period, T t, int e) {
  const T P = T(period);
  const T ph = s_mod(add_rn(t, mul_rn(gait[e], P)), P);
  return ph <= add_rn(mul_rn(gait[SNE + e], P), T(1e-4));
}

// Episode b's substep at the window's substep ii and the episode's step kk,
// in its slice w of shared memory.
template <typename T, class Exec>
static HD void substep_one(int b, const SubArgs<T>& a, long long ii, long long kk, T* w,
                           const Exec& exec) {
  const ModelView<T> mv{a.model};
  const T* par = a.params + (long)b * N_PARAMS;
  const T dt = T(a.dt);
  const bool biased = a.q_noise != nullptr || a.v_noise != nullptr;
  const long xrow = ((long)b * a.n_int + ii);
  const long rec = (long)b * a.T_ + kk;
  T* qt = w + W_QT; T* vt = w + W_VT; T* qm = w + W_QM; T* vm = w + W_VM;
  T* qd = w + W_QD; T* vd = w + W_VD; T* ad = w + W_AD; T* ff = w + W_FF;
  T* Km = w + W_KM; T* Kd = w + W_KD; T* Kt = biased ? w + W_KT : Km;
  T* Dd = w + W_DD; T* Dt = w + W_DT;
  T* M = w + W_M; T* tmp = w + W_TMP; T* rhs = w + W_RHS; T* J = w + W_J;
  T* teff = w + W_TEFF; T* tid = w + W_TID; T* bias = w + W_BIAS;
  T* tau = w + W_TAU; T* tff = w + W_TFF;
  T* pos = w + W_POS; T* pen = w + W_PEN; T* act = w + W_ACT; T* feetm = w + W_FEETM;
  T* vf = w + W_VF; T* A = w + W_A; T* bv = w + W_BV; T* f = w + W_F; T* vn = w + W_VN;

  // the state and the plan's row at substep ii
  exec([&](int lane) {
    for (int i = lane; i < NQ; i += LANES) {
      qt[i] = a.q[(long)b * NQ + i];
      qd[i] = a.xs[xrow * (NQ + NV) + i];
    }
    for (int i = lane; i < NV; i += LANES) {
      vt[i] = a.v[(long)b * NV + i];
      vd[i] = a.xs[xrow * (NQ + NV) + NQ + i];
      ad[i] = a.us[xrow * NV + i];
    }
    for (int i = lane; i < SNC; i += LANES) ff[i] = a.fi[xrow * SNC + i];
  });
  // the measured state (rollout.py: _measure)
  exec([&](int lane) {
    if (lane != 0) return;
    for (int i = 0; i < NQ; ++i)
      qm[i] = a.q_noise ? qt[i] + a.q_noise[(long)b * NQ + i] : qt[i];
    if (a.q_noise) {
      const T n = s_sqrt(qm[3] * qm[3] + qm[4] * qm[4] + qm[5] * qm[5] + qm[6] * qm[6]);
      for (int i = 3; i < 7; ++i) qm[i] = qm[i] / n;
    }
    for (int i = 0; i < NV; ++i)
      vm[i] = a.v_noise ? vt[i] + a.v_noise[(long)b * NV + i] : vt[i];
  });
  // three kinematic passes side by side
  exec([&](int lane) {
    if (lane == 0) kinematics(mv, qm, vm, Km);
    if (lane == 1) kinematics(mv, qd, vd, Kd);
    if (lane == 2 && biased) kinematics(mv, qt, vt, Kt);
  });
  exec([&](int lane) {
    if (lane < NB) derived(mv, Kd, Dd, lane);
    else if (lane < 2 * NB) derived(mv, Kt, Dt, lane - NB);
  });
  // the dynamics: M's columns, the bias, the controller's RNEA, the feet
  exec([&](int lane) {
    if (lane < NV) {  // M e_c = ID(q, 0, e_c) without gravity
      T e[NV], zero[NV], col[NV];
      for (int i = 0; i < NV; ++i) {
        e[i] = i == lane ? T(1) : T(0);
        zero[i] = T(0);
      }
      rnea(mv, Kt, Dt, zero, e, false, T(0), col);
      for (int r = 0; r < NV; ++r) M[r * NV + lane] = col[r];
    } else if (lane == NV) {  // the bias ID(q, v, 0)
      T zero[NV];
      for (int i = 0; i < NV; ++i) zero[i] = T(0);
      rnea(mv, Kt, Dt, vt, zero, true, T(9.81), bias);
    } else if (lane == NV + 1) {  // the controller's feed-forward ID(q_des, v_des, a_des)
      rnea(mv, Kd, Dd, vd, ad, true, T(9.81), tid);
    } else if (lane < NV + 6) {  // foot e: J's rows, position, penetration
      const int e = lane - NV - 2;
      T pf[3];
      foot_pos(mv, Kt, e, pf);
      for (int c = 0; c < NV; ++c) {
        T col[3];
        jac_col(mv, Kt, Dt, pf, e, c, col);
        for (int i = 0; i < 3; ++i) J[(3 * e + i) * NV + c] = col[i];
      }
      for (int i = 0; i < 3; ++i) pos[3 * e + i] = pf[i];
      T h = pf[2];
      if (a.heights) {  // sim/physics.py: Terrain.height_at
        const int n = a.hn, m = a.hm;
        const T gx = div_c(pf[0] - T(a.origin_x), a.cell);
        const T gy = div_c(pf[1] - T(a.origin_y), a.cell);
        const long long fx0 = (long long)s_floor(gx), fy0 = (long long)s_floor(gy);
        const int i0 = (int)(fx0 < 0 ? 0 : (fx0 > n - 2 ? n - 2 : fx0));
        const int j0 = (int)(fy0 < 0 ? 0 : (fy0 > m - 2 ? m - 2 : fy0));
        const T fx = s_clamp(gx - T(i0), T(0), T(1)), fy = s_clamp(gy - T(j0), T(0), T(1));
        const long at = (long)i0 * m + j0;
        const T h00 = a.heights[at], h10 = a.heights[at + m], h01 = a.heights[at + 1],
                h11 = a.heights[at + m + 1];
        const T hg = h00 * (T(1) - fx) * (T(1) - fy) + h10 * fx * (T(1) - fy) +
                     h01 * (T(1) - fx) * fy + h11 * fx * fy;
        h = pf[2] - hg;
      }
      pen[e] = par[PR_RADIUS] - h;
      act[e] = pen[e] > T(0) ? T(1) : T(0);
    } else if (lane < NV + 10) {  // foot e's share of J^T f_ff at the desired state
      const int e = lane - NV - 6;
      T pf[3], fs[3];
      foot_pos(mv, Kd, e, pf);
      for (int i = 0; i < 3; ++i) fs[i] = ff[3 * e + i];
      if (a.gate && !a.prev_cnt[(long)b * SNE + e]) {  // force_gate on a foot measured airborne
        for (int i = 0; i < 3; ++i) fs[i] = fs[i] * a.gate[b];
      }
      for (int c = 0; c < NV; ++c) {
        T col[3];
        jac_col(mv, Kd, Dd, pf, e, c, col);
        teff[e * NV + c] = col[0] * fs[0] + col[1] * fs[1] + col[2] * fs[2];
      }
    } else if (lane < NV + 14) {  // foot e's position at the measured state
      foot_pos(mv, Km, lane - NV - 10, feetm + 3 * (lane - NV - 10));
    }
  });
  // row r: the controller's torque (joint rows), the right-hand sides
  exec([&](int lane) {
    const int r = lane;
    if (r >= NV) return;
    const T lim = par[PR_LIMIT];
    T t0 = T(0);
    if (r >= 6) {
      const int j = r - 6;
      const T te = ((teff[j + 6] + teff[NV + j + 6]) + teff[2 * NV + j + 6]) + teff[3 * NV + j + 6];
      const T t_ff = tid[r] - te;
      T t_fb = (-par[PR_KP]) * (qm[7 + j] - qd[7 + j]) - par[PR_KD] * (vm[r] - vd[r]);
      if (a.swing) {  // release the joints of a planned-swing leg measured in contact
        const T t_ms = add_rn(a.sim_t[b], mul_rn(T(ii), T(a.sim_dt)));
        T s = T(0);
        for (int e = 0; e < SNE; ++e) {
          const T gate =
              (!in_stance(a.gait, a.gait_period, t_ms, e) && a.prev_cnt[(long)b * SNE + e])
                  ? T(1) : T(0);
          s = s + gate * a.leg_mask[e * NJ + j];
        }
        s = s_clamp(s, T(0), T(1));
        t_fb = (T(1) - (T(1) - a.swing[b]) * s) * t_fb;
      }
      const T tq = s_clamp(t_ff + t_fb, -lim, lim);
      tau[j] = tq;
      tff[j] = t_ff;
      t0 = s_clamp(tq, -lim, lim) - par[PR_DAMPING] * vt[r];
    } else if (r < 3 && a.push) {  // the push at step kk, R0' f_ext on the base's force
      const T* pk = a.push + (long)b * a.push_stride + 3 * kk;
      const T* R0 = kR(Kt, 0);
      t0 = t0 + (R0[r] * pk[0] + R0[3 + r] * pk[1] + R0[6 + r] * pk[2]);
    }
    rhs[r * NR] = t0 - bias[r];
    for (int c = 0; c < SNC; ++c) rhs[r * NR + 1 + c] = J[c * NV + r];
  });
  // M = L L', L in place of M's lower triangle, a column at a time
  for (int k = 0; k < NV; ++k) {
    exec([&](int lane) {
      const int i = lane;
      if (i < k || i >= NV) return;
      T s = M[i * NV + k];
      for (int j = 0; j < k; ++j) s = s - M[i * NV + j] * M[k * NV + j];
      tmp[i] = s;
    });
    exec([&](int lane) {
      const int i = lane;
      if (i < k || i >= NV) return;
      const T d = s_sqrt(tmp[k]);
      M[i * NV + k] = i == k ? d : tmp[i] / d;
    });
  }
  // L' \ (L \ rhs): a right-hand side per lane
  exec([&](int lane) {
    const int c = lane;
    if (c >= NR) return;
    for (int i = 0; i < NV; ++i) {
      T s = rhs[i * NR + c];
      for (int j = 0; j < i; ++j) s = s - M[i * NV + j] * rhs[j * NR + c];
      rhs[i * NR + c] = s / M[i * NV + i];
    }
    for (int i = NV - 1; i >= 0; --i) {
      T s = rhs[i * NR + c];
      for (int j = i + 1; j < NV; ++j) s = s - M[j * NV + i] * rhs[j * NR + c];
      rhs[i * NR + c] = s / M[i * NV + i];
    }
  });
  exec([&](int lane) {
    for (int r = lane; r < NV; r += LANES) vf[r] = vt[r] + dt * rhs[r * NR];
  });
  // the contact system A f = k - D u_free, A = I + dt D G, G = J M^-1 J'
  exec([&](int lane) {
    for (int idx = lane; idx < SNC * SNC; idx += LANES) {
      const int r = idx / SNC, c = idx % SNC, e = r / 3;
      T g = T(0);
      for (int k = 0; k < NV; ++k) g = g + J[r * NV + k] * rhs[k * NR + 1 + c];
      const T Dr = (r % 3 == 2 ? par[PR_DN] : par[PR_KT]) * act[e];
      A[idx] = (r == c ? T(1) : T(0)) + (dt * Dr) * g;
    }
    if (lane < SNC) {
      const int r = lane, e = r / 3;
      T u = T(0);
      for (int k = 0; k < NV; ++k) u = u + J[r * NV + k] * vf[k];
      const T Dr = (r % 3 == 2 ? par[PR_DN] : par[PR_KT]) * act[e];
      const T kv = r % 3 == 2 ? par[PR_KN] * pen[e] * act[e] : T(0);
      bv[r] = kv - Dr * u;
    }
  });
  // LU with partial pivoting (the first largest pivot), a column at a time
  for (int k = 0; k < SNC; ++k) {
    int p = k;
    T best = s_abs(A[k * SNC + k]);
    for (int i = k + 1; i < SNC; ++i) {
      const T x = s_abs(A[i * SNC + k]);
      if (x > best) {
        best = x;
        p = i;
      }
    }
    if (p != k) {
      exec([&](int lane) {
        if (lane < SNC) {
          const T x = A[k * SNC + lane];
          A[k * SNC + lane] = A[p * SNC + lane];
          A[p * SNC + lane] = x;
        } else if (lane == SNC) {
          const T x = bv[k];
          bv[k] = bv[p];
          bv[p] = x;
        }
      });
    }
    exec([&](int lane) {
      const int i = lane;
      if (i <= k || i >= SNC) return;
      const T l = A[i * SNC + k] / A[k * SNC + k];
      A[i * SNC + k] = l;
      for (int j = k + 1; j < SNC; ++j) A[i * SNC + j] = A[i * SNC + j] - l * A[k * SNC + j];
      bv[i] = bv[i] - l * bv[k];
    });
  }
  exec([&](int lane) {
    if (lane != 0) return;
    for (int i = SNC - 1; i >= 0; --i) {
      T s = bv[i];
      for (int j = i + 1; j < SNC; ++j) s = s - A[i * SNC + j] * f[j];
      f[i] = s / A[i * SNC + i];
    }
  });
  // the unilateral normal and the friction cone, a foot per lane
  exec([&](int lane) {
    if (lane >= SNE) return;
    const int e = lane;
    T* fe = f + 3 * e;
    const T fz = fe[2];
    const T fn = (fz < T(0) ? T(0) : fz) * act[e];
    const T tn = s_sqrt(fe[0] * fe[0] + fe[1] * fe[1] + T(1e-12));
    T sc = par[PR_MU] * fn / tn;
    sc = sc > T(1) ? T(1) : sc;
    fe[0] = fe[0] * sc;
    fe[1] = fe[1] * sc;
    fe[2] = fn;
  });
  exec([&](int lane) {
    for (int r = lane; r < NV; r += LANES) {
      T s = T(0);
      for (int c = 0; c < SNC; ++c) s = s + rhs[r * NR + 1 + c] * f[c];
      vn[r] = vf[r] + dt * s;
    }
  });
  // the step's end: the new state (frozen where failed), the records at kk
  exec([&](int lane) {
    if (lane == 0) {
      // the failure predicate (rollout.py: failed_state) on the measured state
      T R[9];
      quat_to_rot(qm + 3, R);
      const T pitch = -s_asin(s_clamp(R[6], T(-1), T(1)));
      const T roll = s_atan2(R[7], R[8]);
      const T ang = T(a.fail_angle);
      const bool bad = qm[2] < T(0.1) || qm[2] > T(2.0) || s_abs(roll) > ang ||
                       s_abs(pitch) > ang;
      const bool was = a.failed[b] != 0;
      const bool now = was || (bad && (double)kk > a.fail_after) || a.mpc_bad[b] != 0;
      if (now && !was) a.fail_step[b] = (int)kk;
      a.failed[b] = now ? 1 : 0;
      if (!now) {  // q+ = integrate(q, v+ dt)
        T dq[NV];
        for (int i = 0; i < NV; ++i) dq[i] = vn[i] * dt;
        T Rq[9], V[9], t1[3], t2[3], e4[4], qn[4];
        quat_to_rot(qt + 3, Rq);
        so3_V(dq + 3, V);
        mv3(V, dq, t1);
        mv3(Rq, t1, t2);
        exp3(dq + 3, e4);
        quat_mul(qt + 3, e4, qn);
        const T n = s_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
        T* qo = a.q + (long)b * NQ;
        for (int i = 0; i < 3; ++i) qo[i] = qt[i] + t2[i];
        for (int i = 0; i < 4; ++i) qo[3 + i] = qn[i] / n;
        for (int j = 0; j < NJ; ++j) qo[7 + j] = qt[7 + j] + dq[6 + j];
        for (int i = 0; i < NV; ++i) a.v[(long)b * NV + i] = vn[i];
      }
      // the vc goal: [phase, v_des, w_des, gait id]
      const T step = add_rn(par[PR_STEP0], T(kk));
      const T ph = div_c(s_mod(mul_rn(step, T(a.sim_dt)), T(a.goal_period)), a.goal_period);
      T* vc = a.vc + rec * 5;
      vc[0] = ph;
      vc[1] = a.v_des[3 * b];
      vc[2] = a.v_des[3 * b + 1];
      vc[3] = a.w_des[b];
      vc[4] = T(a.gait_id);
    } else if (lane == 1) {  // the CoM of the measured state
      T s[3] = {T(0), T(0), T(0)};
      for (int bb = 0; bb < NB; ++bb) {
        T off[3];
        mv3(kR(Km, bb), mv.com(bb), off);
        for (int i = 0; i < 3; ++i) s[i] = s[i] + mv.mass(bb) * (kp(Km, bb)[i] + off[i]);
      }
      const T tm = mv.total_mass();
      for (int i = 0; i < 3; ++i) a.com[rec * 3 + i] = s[i] * (T(1) / tm);
    } else if (lane == 2) {
      for (int i = 0; i < 3; ++i) a.base[rec * 3 + i] = qm[i];
    } else if (lane < 3 + SNE) {  // foot e: force, position, contact
      const int e = lane - 3;
      const bool in = pen[e] > T(0);
      for (int i = 0; i < 3; ++i) {
        a.cf[(rec * SNE + e) * 3 + i] = f[3 * e + i];
        a.cp[(rec * SNE + e) * 3 + i] = pos[3 * e + i];
      }
      a.in_contact[rec * SNE + e] = in ? 1 : 0;
      a.prev_cnt[(long)b * SNE + e] = in ? 1 : 0;
    }
    // the state features [v, base xy - foot xy, q[2:]]
    T* st = a.states + rec * NSTATE;
    for (int i = lane; i < NSTATE; i += LANES) {
      T x;
      if (i < NV) {
        x = vm[i];
      } else if (i < NV + 2 * SNE) {
        const int e = (i - NV) / 2, c = (i - NV) % 2;
        x = qm[c] - feetm[3 * e + c];
      } else {
        x = qm[2 + i - NV - 2 * SNE];
      }
      st[i] = x;
    }
    // the action: torque, pd_target, or [tau_ff, q_des, v_des]
    const int na = a.action == ACT_STRUCTURED ? 3 * NJ : NJ;
    T* ac = a.actions + rec * na;
    for (int i = lane; i < na; i += LANES) {
      T x;
      if (a.action == ACT_TORQUE) {
        x = tau[i];
      } else if (a.action == ACT_PD_TARGET) {
        x = div_c(tau[i] + T(a.act_kd) * vm[6 + i], a.act_kp) + qm[7 + i];
      } else {
        x = i < NJ ? tff[i] : (i < 2 * NJ ? qd[7 + i - NJ] : vd[6 + i - 2 * NJ]);
      }
      ac[i] = x;
    }
  });
}

};  // struct Sub

}  // namespace bk

// The joint counts a build holds (cuda_substep.JOINT_COUNTS): with
// -DBK_SUB_NJ=n only n, without it every count (the g++ test build).
template <class F, class R>
R with_nj(int nj, R refused, const F& f) {
  switch (nj) {
#if !defined(BK_SUB_NJ) || BK_SUB_NJ == 12
    case 12: return f(bk::Sub<12>{});
#endif
#if !defined(BK_SUB_NJ) || BK_SUB_NJ == 8
    case 8: return f(bk::Sub<8>{});
#endif
    default: return refused;
  }
}

constexpr int NJ_REFUSED = -2;

// Shared-memory elements an episode takes (-1 for a joint count not built).
extern "C" long substep_work_size(int nj) {
  return with_nj(nj, -1L, [&](auto d) { return (long)decltype(d)::W_N; });
}

#ifdef __CUDACC__

template <int NJ>
__global__ void substep_kernel(bk::SubArgs<float> a) {
  using S = bk::Sub<NJ>;
  extern __shared__ float smem[];
  __shared__ bool last;
  const int p = threadIdx.x / bk::LANES, lane = threadIdx.x % bk::LANES;
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + p;
  const long long ii = *a.i, kk = *a.k;
  if (b < a.B) {
    S::template substep_one<float>(b, a, ii, kk, smem + (long)p * S::W_N,
                                   bk::DeviceExec{lane, bk::make_prof(b, lane == 0)});
  }
  // the last block to finish advances the substep and the step
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    *a.i = ii + 1;
    *a.k = kk + 1;
    *a.done = 0u;
    __threadfence();
  }
}

// Launch one substep of the nj-joint kernel on the caller's stream, `per_block`
// episodes (a warp and a shared-memory slice each) a block; returns
// cudaGetLastError() or NJ_REFUSED (0 = launched).
extern "C" int substep_launch_f32(int nj, void* const* ptrs, const double* scalars,
                                  const int* ints, int per_block, void* stream) {
  const bk::SubArgs<float> a = bk::sub_args<float>(ptrs, scalars, ints);
  return with_nj(nj, NJ_REFUSED, [&](auto d) {
    using S = decltype(d);
    const int blocks = (a.B + per_block - 1) / per_block;
    const size_t bytes = (size_t)per_block * S::W_N * sizeof(float);
    substep_kernel<S::NJ><<<blocks, per_block * bk::LANES, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  });
}

#else  // host build for the CPU tests: the shared-memory slice is a plain array

#include <vector>

template <class S, typename T>
int substep_host(void* const* ptrs, const double* scalars, const int* ints) {
  const bk::SubArgs<T> a = bk::sub_args<T>(ptrs, scalars, ints);
  std::vector<T> w(S::W_N);
  const long long ii = *a.i, kk = *a.k;
  for (int b = 0; b < a.B; ++b) S::template substep_one<T>(b, a, ii, kk, w.data(), bk::HostExec{});
  *a.i = ii + 1;
  *a.k = kk + 1;
  return 0;
}

extern "C" int substep_host_f32(int nj, void* const* ptrs, const double* scalars, const int* ints) {
  return with_nj(nj, NJ_REFUSED,
                 [&](auto d) { return substep_host<decltype(d), float>(ptrs, scalars, ints); });
}

extern "C" int substep_host_f64(int nj, void* const* ptrs, const double* scalars, const int* ints) {
  return with_nj(nj, NJ_REFUSED,
                 [&](auto d) { return substep_host<decltype(d), double>(ptrs, scalars, ints); });
}

#endif
