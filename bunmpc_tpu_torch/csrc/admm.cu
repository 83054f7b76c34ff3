// K1: the whole biconvex centroidal ADMM of one MPC problem per CUDA warp.
//
// Replaces bunmpc_tpu/solvers/pallas_admm.py:_kernel/_admm_core, every branch
// (x_solver "thomas" and "fista", with and without precondition): the
// per-problem code is admm_core.cuh, which K3 (fused.cu) runs as well. This
// file reads the problem's inputs from device memory, runs it, and writes
// X, F, viol = sqrt(viol2) of the last active iteration, iters (the active
// count) and, for measuring the work, the F-step's FISTA iterations.
//
// What bounds it on an H100: it reads about 2,000 floats and writes about 430
// per problem (about 5 MB at B=512, 1.5 us of HBM time), so it is bound by
// f32 arithmetic, and the amount depends on the data: ADMM iterations x
// (<= fista_max_iters FISTA iterations + power_iters+1 operator applications
// + one (H+1)-knot Thomas sweep, or the X-step's power iteration and FISTA).
// The design against that bound is admm_core.cuh's: a warp per problem, the
// lanes split each phase, problems leave their loops on their own.
//
// Built by bunmpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// (no fast math: the cone projection and the Cholesky factors are
// precision-sensitive). Compiled with g++ instead (no __CUDACC__) it exports
// host loops over the same per-problem phases (the lanes of a phase run one
// after another), in float and double, for the CPU tests.

#include "admm_core.cuh"

namespace bk {

// the per-problem views for problem b of a batch of B
template <typename T, class Exec>
HD void admm_one(int b, int B, const AdmmParams<T>& pr, const T* cnt, const T* r, const T* dt,
                 const T* x_init, const T* W, const T* ql, const T* WF, const T* qF,
                 const T* lb, const T* ub, const T* X0, const T* F0, T* Xo, T* Fo, T* viol,
                 int* iters, int* fista, T* scratch, const Exec& exec) {
  const int H = pr.H;
  const long nX = (H + 1) * 9, nF = H * NE * 3;
  AdmmInputs<T> in{cnt + b * H * NE, r + b * nF, dt + b * H, x_init + b * 9,
                   W + b * nX, ql + b * nX, WF + b * nF, qF + b * nF, lb + b * nX, ub + b * nX};
  const AdmmWork<T> w = make_work(scratch, b, B, H);
  exec([&](int lane) {
    for (long i = lane; i < nX; i += LANES) w.X[i] = X0[b * nX + i];
    for (long i = lane; i < nF; i += LANES) w.F[i] = F0[b * nF + i];
  });
  admm_problem(pr, in, w, viol + b, iters + b, fista + b, exec);
  exec([&](int lane) {
    for (long i = lane; i < nX; i += LANES) Xo[b * nX + i] = w.X[i];
    for (long i = lane; i < nF; i += LANES) Fo[b * nF + i] = w.F[i];
  });
}

}  // namespace bk

// Number of scratch elements per problem.
extern "C" long admm_scratch_size(int H) { return bk::admm_scratch_elems(H); }

#define ADMM_ARGS(T)                                                                       \
  int B, ADMM_CFG_ARGS, const T *cnt, const T *r, const T *dt, const T *x_init, const T *W, \
      const T *ql, const T *WF, const T *qF, const T *lb, const T *ub, const T *X0,        \
      const T *F0, T *Xo, T *Fo, T *viol, int *iters, int *fista, T *scratch
#define ADMM_CALL(T, b, exec)                                                              \
  bk::admm_one<T>(b, B, pr, cnt, r, dt, x_init, W, ql, WF, qF, lb, ub, X0, F0, Xo, Fo, viol, \
                  iters, fista, scratch, exec)

#ifdef __CUDACC__

__global__ void admm_kernel(bk::AdmmParams<float> pr, int B, const float* cnt, const float* r,
                            const float* dt, const float* x_init, const float* W,
                            const float* ql, const float* WF, const float* qF,
                            const float* lb, const float* ub, const float* X0,
                            const float* F0, float* Xo, float* Fo, float* viol, int* iters,
                            int* fista, float* scratch) {
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + threadIdx.x / bk::LANES;
  if (b >= B) return;  // the whole warp: no barrier is left waiting
  ADMM_CALL(float, b, bk::DeviceExec{(int)(threadIdx.x % bk::LANES)});
}

// Launch on the caller's stream with `problems` problems (a warp each) per
// block; returns cudaGetLastError() (0 = launched).
extern "C" int admm_launch_f32(ADMM_ARGS(float), int problems, void* stream) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  const int blocks = (B + problems - 1) / problems;
  admm_kernel<<<blocks, problems * bk::LANES, 0, (cudaStream_t)stream>>>(
      pr, B, cnt, r, dt, x_init, W, ql, WF, qF, lb, ub, X0, F0, Xo, Fo, viol, iters, fista,
      scratch);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

extern "C" int admm_host_f32(ADMM_ARGS(float)) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  for (int b = 0; b < B; ++b) ADMM_CALL(float, b, bk::HostExec{});
  return 0;
}

extern "C" int admm_host_f64(ADMM_ARGS(double)) {
  const bk::AdmmParams<double> pr = ADMM_PARAMS(double);
  for (int b = 0; b < B; ++b) ADMM_CALL(double, b, bk::HostExec{});
  return 0;
}

#endif
