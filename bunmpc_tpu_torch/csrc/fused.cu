// K3: problem assembly and the biconvex centroidal ADMM of one MPC problem
// per CUDA warp.
//
// Replaces bunmpc_tpu/solvers/pallas_admm.py:solve_from_state ->
// _kernel_fused (prologue prep_values :765-984, then _admm_core). From its
// compact state (gait clock, world-frame command, yaw rate, centroidal state,
// feet, yaw-frame hips, orientation-correction momentum: 41 floats) a
// problem's warp builds
//   the contact plan: phase machine, Raibert touchdowns and swing points,
//     the sequential foot-location carry, the first-knot dt;
//   the dynamics costs (X_ref, W, q, W_F, q_F), the kinematic CoM box and
//     the warm starts;
// straight into the problem's shared-memory slice, where the ADMM of
// admm_core.cuh — the code K1 (admm.cu) runs — reads its inputs, runs it,
// and writes X, F, cnt, r, dt (and swing) to their outputs. Only the
// prologue's temporaries go to a wrapper-allocated workspace.
//
// What bounds it on an H100: like K1, f32 arithmetic; the prologue adds a
// few thousand operations to the ADMM's millions, and the kernel reads 41
// floats a problem where K1 reads ~2,000. Design: knots (and knot-foot pairs)
// go elementwise over the 32 lanes; the two sequential recurrences — the
// foot-location carry and the prefix sum of dt — run one lane per foot and
// one lane for the sum, side by side; warp barriers between the phases.
// The gait clock is rounded product by product (mul_rn/add_rn), as the
// plain version rounds it, so contact flags on a phase boundary agree; the
// first-knot dt rounds half to even (rint), as jnp.round does.
//
// Built by bunmpc_tpu_torch/_build.py like admm.cu; the g++ build (no
// __CUDACC__) exports host loops over the same phases in float and double.

#include "admm_core.cuh"

namespace bk {

// The prologue's constants, each a product or sum of the PrepConsts fields
// taken in double and then rounded to T, as the plain version takes them.
template <typename T>
struct PrepParams {
  T P, gdt, foot_size, nom_ht, hz, izz_yaw, mg, big;
  T st[NE], st_tol[NE], p_st[NE], off[NE], sp[NE];
  T oc[3], blo[3], bhi[3];
  T W_X[9], W_X_ter[9], W_F[NE * 3];
  int vdes, f_reg_weight;
};

// c: PrepConsts.as_array() (52 doubles): gait_period, gait_dt,
// stance_percent[4], phase_offset[4], foot_size, nom_ht, ori_correction[3],
// gait_horizon, izz_yaw, W_X[9], W_X_ter[9], W_F[12], bx, by, bz,
// warm_start_vdes, f_reg_weight
template <typename T>
PrepParams<T> make_prep(const double* c, double m) {
  PrepParams<T> p;
  const double P = c[0];
  p.P = T(P);
  p.gdt = T(c[1]);
  for (int e = 0; e < NE; ++e) {
    const double st = c[2 + e] * P;
    p.sp[e] = T(c[2 + e]);
    p.st[e] = T(st);
    p.st_tol[e] = T(st + 1e-4);
    p.p_st[e] = T(P - st);
    p.off[e] = T(c[6 + e] * P);
  }
  p.foot_size = T(c[10]);
  p.nom_ht = T(c[11]);
  for (int k = 0; k < 3; ++k) p.oc[k] = T(c[12 + k]);
  p.hz = T(c[15] * P);
  p.izz_yaw = T(c[16]);
  for (int k = 0; k < 9; ++k) {
    p.W_X[k] = T(c[17 + k]);
    p.W_X_ter[k] = T(c[26 + k]);
  }
  for (int k = 0; k < NE * 3; ++k) p.W_F[k] = T(c[35 + k]);
  p.blo[0] = T(-c[47]);
  p.blo[1] = T(-c[48]);
  p.blo[2] = T(0);
  p.bhi[0] = T(c[47]);
  p.bhi[1] = T(c[48]);
  p.bhi[2] = T(c[49]);
  p.vdes = c[50] != 0.0;
  p.f_reg_weight = c[51] != 0.0;
  p.mg = T(m * G_ACC);
  p.big = T(3.4e38);
  return p;
}

// One problem's compact state, (B, ...) row-major, offset to problem b.
template <typename T>
struct PrepInputs {
  const T *t, *vdes, *wdes, *x_init, *ee, *hip, *amom;
};

// The first knot's dt: gait_dt - round(mod(t, gait_dt), 2), gait_dt where
// that is 0 (abstract_cyclic_gen.py:385-390)
template <typename T>
HD T first_dt(const PrepParams<T>& pp, T t1) {
  const T d = pp.gdt - s_rint(s_mod(t1, pp.gdt) * T(100)) / T(100);
  return d == T(0) ? pp.gdt : d;
}

// What the prologue builds besides the plan: the ADMM's costs and box (in
// the shared-memory slice), and its own temporaries (touchdown and swing
// locations, the dt prefix sum; in the device-memory workspace).
template <typename T>
struct PrepWork {
  T *W, *ql, *lb, *ub, *WF, *qF, *tdx, *tdy, *swx, *swy, *cum;
};

HD long prep_work_elems(int H) { return 4L * H * NE + H; }

// The prologue: the plan into cnt/r/dt (the ADMM's plan inputs) and swing,
// the costs and box into pw, the warm starts into w.X and w.F.
template <typename T, class Exec>
HD void prep_problem(const AdmmParams<T>& pr, const PrepParams<T>& pp, const PrepInputs<T>& s,
                     T* cnt, T* r, T* dt, T* swing, const PrepWork<T>& pw,
                     const AdmmWork<T>& w, const Exec& exec) {
  T *tdx = pw.tdx, *tdy = pw.tdy, *swx = pw.swx, *swy = pw.swy, *cum = pw.cum;
  const int H = pr.H;
  const T t1 = s.t[0], wd = s.wdes[0], vx = s.vdes[0], vy = s.vdes[1];
  const T* com = s.x_init;
  // ---- phase machine, Raibert touchdowns and swing points, a knot-foot pair per lane ----
  exec([&](int lane) {
    const T dt0 = first_dt(pp, t1);
    const T ang_c = T(0.5) * s_sqrt(com[2] / T(G_ACC));
    const T asx = ang_c * vy * wd, asy = -(ang_c * vx) * wd;
    for (int c = lane; c < H * NE; c += LANES) {
      const int k = c / NE, e = c % NE;
      const T kg = mul_rn(T(k), pp.gdt);
      const T ph = s_mod(add_rn(add_rn(t1, kg), pp.off[e]), pp.P);
      const bool stance = ph <= pp.st_tol[e];
      const T per = stance ? ph / pp.st[e] : (ph - pp.st[e]) / pp.p_st[e];
      const T hipx = com[0] + s.hip[e * 3 + 0] + kg * vx;
      const T hipy = com[1] + s.hip[e * 3 + 1] + kg * vy;
      const T rbx = T(0.5) * vx * pp.P * pp.sp[e], rby = T(0.5) * vy * pp.P * pp.sp[e];
      tdx[c] = hipx + (rbx + asx);
      tdy[c] = hipy + (rby + asy);
      const bool early = per < T(0.5);
      swx[c] = early ? hipx + asx : tdx[c];
      swy[c] = early ? hipy + asy : tdy[c];
      cnt[c] = stance ? T(1) : T(0);
      swing[c] = (k > 0 && !stance && per - T(0.5) < T(0.02)) ? T(1) : T(0);
    }
    for (int k = lane; k < H; k += LANES) dt[k] = k == 0 ? dt0 : pp.gdt;
  });
  // ---- the two recurrences: the location carry (a lane per foot), the dt prefix sum ----
  exec([&](int lane) {
    if (lane < NE) {
      const int e = lane;
      T prev[3] = {s.ee[e * 3], s.ee[e * 3 + 1], s.ee[e * 3 + 2]};
      for (int q = 0; q < 3; ++q) r[e * 3 + q] = prev[q];
      T prev_c = cnt[e];
      for (int i = 1; i < H; ++i) {
        const int c = i * NE + e;
        const T ci = cnt[c];
        const T landed = ci * (T(1) - prev_c);
        const T td[3] = {tdx[c], tdy[c], pp.foot_size};
        const T sw[3] = {swx[c], swy[c], pp.foot_size};
        for (int q = 0; q < 3; ++q) {
          const T stay = landed > T(0) ? td[q] : prev[q];
          prev[q] = ci > T(0) ? stay : sw[q];
          r[c * 3 + q] = prev[q];
        }
        prev_c = ci;
      }
    } else if (lane == NE) {
      T acc = T(0);
      for (int i = 0; i < H; ++i) {
        acc = acc + dt[i];
        cum[i] = acc;
      }
    }
  });
  // ---- costs, box and warm starts, a knot per lane ----
  exec([&](int lane) {
    const T dt0 = first_dt(pp, t1);
    const T yaw = pp.izz_yaw * wd;
    for (int k = lane; k <= H; k += LANES) {
      T xr[9];
      T *Wr = pw.W + k * 9, *qr = pw.ql + k * 9, *lb = pw.lb + k * 9, *ub = pw.ub + k * 9;
      if (k < H) {
        xr[0] = com[0] + vx * (cum[k] - dt0);
        xr[1] = com[1] + vy * (cum[k] - dt0);
        xr[2] = pp.nom_ht;
        xr[6] = s.amom[0] * pp.oc[0];
        xr[7] = s.amom[1] * pp.oc[1];
        xr[8] = wd == T(0) ? s.amom[2] * pp.oc[2] : yaw;
        for (int j = 0; j < 9; ++j) Wr[j] = pp.W_X[j];
        // kinematic CoM box around the knot's feet, free without contact
        T nc = T(0), rmax[3], rmin[3];
        for (int a = 0; a < 3; ++a) {
          rmax[a] = r[(k * NE) * 3 + a];
          rmin[a] = rmax[a];
        }
        for (int e = 0; e < NE; ++e) {
          nc += cnt[k * NE + e];
          for (int a = 0; a < 3; ++a) {
            rmax[a] = s_max(rmax[a], r[(k * NE + e) * 3 + a]);
            rmin[a] = s_min(rmin[a], r[(k * NE + e) * 3 + a]);
          }
        }
        for (int a = 0; a < 3; ++a) {
          lb[a] = nc > T(0) ? rmax[a] + pp.blo[a] : -pp.big;
          ub[a] = nc > T(0) ? rmin[a] + pp.bhi[a] : pp.big;
        }
        // force weights, the linear force cost, the zero force warm start
        const T fz = pp.mg / s_max(nc, T(1));
        for (int e = 0; e < NE; ++e)
          for (int a = 0; a < 3; ++a) {
            const int i = (k * NE + e) * 3 + a;
            const T wf = pp.W_F[e * 3 + a];
            const T freg = a == 2 ? cnt[k * NE + e] * fz : T(0);
            pw.WF[i] = wf;
            pw.qF[i] = pp.f_reg_weight ? T(-2) * wf * freg : T(0);
            w.F[i] = T(0);
          }
      } else {
        xr[0] = com[0] + pp.hz * s.vdes[0];
        xr[1] = com[1] + pp.hz * s.vdes[1];
        xr[2] = pp.nom_ht;
        xr[6] = s.amom[0];
        xr[7] = s.amom[1];
        xr[8] = wd == T(0) ? s.amom[2] : yaw;
        for (int j = 0; j < 9; ++j) Wr[j] = pp.W_X_ter[j];
        for (int a = 0; a < 3; ++a) {
          lb[a] = -pp.big;
          ub[a] = pp.big;
        }
      }
      for (int a = 3; a < 9; ++a) {
        lb[a] = -pp.big;
        ub[a] = pp.big;
      }
      for (int a = 0; a < 3; ++a) xr[3 + a] = s.vdes[a];
      for (int j = 0; j < 9; ++j) qr[j] = T(-2) * Wr[j] * xr[j];
      // the ADMM's warm start: x_init tiled, or riding the command; a zero dual
      for (int j = 0; j < 9; ++j) {
        w.X[k * 9 + j] = s.x_init[j];
        w.P[k * 9 + j] = T(0);
      }
      if (pp.vdes) {
        const T tg = k == 0 ? T(0) : cum[k - 1];
        w.X[k * 9 + 0] = s.x_init[0] + tg * vx;
        w.X[k * 9 + 1] = s.x_init[1] + tg * vy;
        for (int a = 0; a < 3; ++a) w.X[k * 9 + 3 + a] = s.vdes[a];
      }
    }
  });
}

// Problem b: build its problem in its shared-memory slice sh, solve, write
// its outputs.
template <typename T, class Exec>
HD void fused_one(int b, const AdmmParams<T>& pr, const PrepParams<T>& pp, const T* t,
                  const T* vdes, const T* wdes, const T* x_init, const T* ee, const T* hip,
                  const T* amom, T* Xo, T* Fo, T* viol, int* iters, T* cnt, T* r, T* dt,
                  T* swing, int* fista, T* work, T* sh, const Exec& exec) {
  const int H = pr.H;
  const long nX = (H + 1) * 9, nF = H * NE * 3, nC = H * NE;
  const AdmmLayout L = admm_layout(H);
  T* tmp = work + b * prep_work_elems(H);
  const PrepWork<T> pw{sh + L.W,     sh + L.ql,    sh + L.lb,   sh + L.ub,
                       sh + L.WF,    sh + L.qF,    tmp,         tmp + nC,
                       tmp + 2 * nC, tmp + 3 * nC, tmp + 4 * nC};
  const PrepInputs<T> s{t + b, vdes + b * 3, wdes + b, x_init + b * 9, ee + b * NE * 3,
                        hip + b * NE * 3, amom + b * 3};
  const AdmmInputs<T> in = admm_inputs(sh, L);
  const AdmmWork<T> w = admm_work(sh, L);
  const long long t_prep = exec.prof.now();
  exec([&](int lane) {
    for (int i = lane; i < 9; i += LANES) sh[L.x_init + i] = s.x_init[i];
  });
  prep_problem(pr, pp, s, sh + L.cnt, sh + L.r, sh + L.dt, swing + b * nC, pw, w, exec);
  exec.prof.add(PH_PROLOGUE, t_prep);
  admm_problem(pr, in, w, viol + b, iters + b, fista + b, exec);
  exec([&](int lane) {
    for (long i = lane; i < nX; i += LANES) Xo[b * nX + i] = w.X[i];
    for (long i = lane; i < nF; i += LANES) {
      Fo[b * nF + i] = w.F[i];
      r[b * nF + i] = in.r[i];
    }
    for (long i = lane; i < nC; i += LANES) cnt[b * nC + i] = in.cnt[i];
    for (long i = lane; i < H; i += LANES) dt[b * H + i] = in.dt[i];
  });
}

}  // namespace bk

// Elements per problem: of the device-memory workspace, and of shared memory
// (K1's layout).
extern "C" long fused_work_size(int H) { return bk::prep_work_elems(H); }
extern "C" long fused_shared_size(int H) { return bk::admm_layout(H).n; }

#define FUSED_ARGS(T)                                                                     \
  int B, ADMM_CFG_ARGS, const double *consts, const T *t, const T *vdes, const T *wdes,   \
      const T *x_init, const T *ee, const T *hip, const T *amom, T *Xo, T *Fo, T *viol,   \
      int *iters, T *cnt, T *r, T *dt, T *swing, int *fista, T *work
#define FUSED_CALL(T, b, sh, exec)                                                      \
  bk::fused_one<T>(b, pr, pp, t, vdes, wdes, x_init, ee, hip, amom, Xo, Fo, viol, iters, \
                   cnt, r, dt, swing, fista, work, sh, exec)

#ifdef __CUDACC__

__global__ void fused_kernel(bk::AdmmParams<float> prm, bk::PrepParams<float> ppm, int B,
                             const float* t, const float* vdes, const float* wdes,
                             const float* x_init, const float* ee, const float* hip,
                             const float* amom, float* Xo, float* Fo, float* viol, int* iters,
                             float* cnt, float* r, float* dt, float* swing, int* fista,
                             float* work) {
  extern __shared__ float smem[];
  // local copies: a kernel parameter's address goes to the stack
  const bk::AdmmParams<float> pr = prm;
  const bk::PrepParams<float> pp = ppm;
  const int p = threadIdx.x / bk::LANES, lane = threadIdx.x % bk::LANES;
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + p;
  if (b >= B) return;  // the whole warp: no barrier is left waiting
  float* sh = smem + (long)p * bk::admm_layout(pr.H).n;
  FUSED_CALL(float, b, sh, (bk::DeviceExec{lane, bk::make_prof(b, lane == 0)}));
}

BK_SET_PROFILE(fused)

// Launch on the caller's stream with `problems` problems (a warp and a
// shared-memory slice each, K1's layout) per block; `consts` is host memory,
// read before the launch. Returns cudaGetLastError() or the refusal of the
// block's shared memory (0 = launched).
extern "C" int fused_launch_f32(FUSED_ARGS(float), int problems, void* stream) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  const bk::PrepParams<float> pp = bk::make_prep<float>(consts, m);
  const int blocks = (B + problems - 1) / problems;
  const size_t bytes = (size_t)problems * bk::admm_layout(H).n * sizeof(float);
  const cudaError_t e =
      cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  fused_kernel<<<blocks, problems * bk::LANES, bytes, (cudaStream_t)stream>>>(
      pr, pp, B, t, vdes, wdes, x_init, ee, hip, amom, Xo, Fo, viol, iters, cnt, r, dt, swing,
      fista, work);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: the shared-memory slice is a plain array

#include <vector>

extern "C" int fused_host_f32(FUSED_ARGS(float)) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  const bk::PrepParams<float> pp = bk::make_prep<float>(consts, m);
  std::vector<float> sh(bk::admm_layout(H).n);
  for (int b = 0; b < B; ++b) FUSED_CALL(float, b, sh.data(), bk::HostExec{});
  return 0;
}

extern "C" int fused_host_f64(FUSED_ARGS(double)) {
  const bk::AdmmParams<double> pr = ADMM_PARAMS(double);
  const bk::PrepParams<double> pp = bk::make_prep<double>(consts, m);
  std::vector<double> sh(bk::admm_layout(H).n);
  for (int b = 0; b < B; ++b) FUSED_CALL(double, b, sh.data(), bk::HostExec{});
  return 0;
}

#endif
