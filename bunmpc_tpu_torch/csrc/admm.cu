// K1: the whole biconvex centroidal ADMM of one MPC problem per CUDA warp.
//
// Replaces bunmpc_tpu/solvers/pallas_admm.py:_kernel/_admm_core, every branch
// (x_solver "thomas" and "fista", with and without precondition): the
// per-problem code is admm_core.cuh, which K3 (fused.cu) runs as well. This
// file reads the problem's inputs from device memory, runs it, and writes
// X, F, the scaled dual P at the base rho, viol = sqrt(viol2) of the last
// active iteration, iters (the active count) and, for measuring the work, the
// F-step's FISTA iterations. The dual starts from P0 where the caller carries
// one (a receding-horizon warm start, read at the base rho as the plain
// version reads P_wm), from zero where P0 is null.
//
// What bounds it on an H100: it reads about 2,000 floats and writes about 430
// per problem (about 5 MB at B=512, 1.5 us of HBM time), so it is bound by
// f32 arithmetic, and the amount depends on the data: ADMM iterations x
// (<= fista_max_iters FISTA iterations + power_iters+1 operator applications
// + one (H+1)-knot Thomas sweep, or the X-step's power iteration and FISTA).
// The design against that bound is admm_core.cuh's: a warp per problem, the
// lanes split each phase, problems leave their loops on their own, and a
// problem's work arrays and inputs sit in its slice of the block's shared
// memory; this file stages the inputs and the warm start there once.
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

// Problem b: stage its inputs and warm start into its shared-memory slice
// sh, solve, write its outputs.
template <typename T, class Exec>
HD void admm_one(int b, const AdmmParams<T>& pr, const T* cnt, const T* r, const T* dt,
                 const T* x_init, const T* W, const T* ql, const T* WF, const T* qF,
                 const T* lb, const T* ub, const T* X0, const T* F0, const T* P0, T* Xo,
                 T* Fo, T* Po, T* viol, int* iters, int* fista, T* sh, const Exec& exec) {
  const int H = pr.H;
  const long nX = (H + 1) * 9, nF = H * NE * 3;
  const AdmmLayout L = admm_layout(H);
  const AdmmWork<T> w = admm_work(sh, L);
  const T* src[12] = {cnt + b * H * NE, r + b * nF,  dt + b * H,   x_init + b * 9,
                      W + b * nX,       ql + b * nX, WF + b * nF,  qF + b * nF,
                      lb + b * nX,      ub + b * nX, X0 + b * nX,  F0 + b * nF};
  const long dst[12] = {L.cnt, L.r, L.dt, L.x_init, L.W, L.ql, L.WF, L.qF, L.lb, L.ub, L.X, L.F};
  const long len[12] = {H * NE, nF, H, 9, nX, nX, nF, nF, nX, nX, nX, nF};
  exec([&](int lane) {
    for (int q = 0; q < 12; ++q)
      for (long i = lane; i < len[q]; i += LANES) sh[dst[q] + i] = src[q][i];
    for (long i = lane; i < nX; i += LANES) w.P[i] = P0 ? P0[b * nX + i] : T(0);
  });
  const AdmmInputs<T> in = admm_inputs(sh, L);
  admm_problem(pr, in, w, viol + b, iters + b, fista + b, exec);
  exec([&](int lane) {
    for (long i = lane; i < nX; i += LANES) Xo[b * nX + i] = w.X[i];
    for (long i = lane; i < nF; i += LANES) Fo[b * nF + i] = w.F[i];
    for (long i = lane; i < nX; i += LANES) Po[b * nX + i] = w.P[i];
  });
}

}  // namespace bk

// Shared-memory elements per problem.
extern "C" long admm_shared_size(int H) { return bk::admm_layout(H).n; }

#define ADMM_ARGS(T)                                                                       \
  int B, ADMM_CFG_ARGS, const T *cnt, const T *r, const T *dt, const T *x_init, const T *W, \
      const T *ql, const T *WF, const T *qF, const T *lb, const T *ub, const T *X0,        \
      const T *F0, const T *P0, T *Xo, T *Fo, T *Po, T *viol, int *iters, int *fista
#define ADMM_CALL(T, b, sh, exec)                                                          \
  bk::admm_one<T>(b, pr, cnt, r, dt, x_init, W, ql, WF, qF, lb, ub, X0, F0, P0, Xo, Fo, Po, \
                  viol, iters, fista, sh, exec)

#ifdef __CUDACC__

__global__ void admm_kernel(bk::AdmmParams<float> prm, int B, const float* cnt, const float* r,
                            const float* dt, const float* x_init, const float* W,
                            const float* ql, const float* WF, const float* qF,
                            const float* lb, const float* ub, const float* X0,
                            const float* F0, const float* P0, float* Xo, float* Fo,
                            float* Po, float* viol, int* iters, int* fista) {
  extern __shared__ float smem[];
  const bk::AdmmParams<float> pr = prm;  // a local copy: a kernel parameter's address goes to the stack
  const int p = threadIdx.x / bk::LANES, lane = threadIdx.x % bk::LANES;
  const int b = blockIdx.x * (blockDim.x / bk::LANES) + p;
  if (b >= B) return;  // the whole warp: no barrier is left waiting
  float* sh = smem + (long)p * bk::admm_layout(pr.H).n;
  ADMM_CALL(float, b, sh, (bk::DeviceExec{lane, bk::make_prof(b, lane == 0)}));
}

BK_SET_PROFILE(admm)

// Launch on the caller's stream with `problems` problems (a warp and a
// shared-memory slice each) per block; returns cudaGetLastError() or the
// refusal of the block's shared memory (0 = launched).
extern "C" int admm_launch_f32(ADMM_ARGS(float), int problems, void* stream) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  const int blocks = (B + problems - 1) / problems;
  const size_t bytes = (size_t)problems * bk::admm_layout(H).n * sizeof(float);
  const cudaError_t e =
      cudaFuncSetAttribute(admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  admm_kernel<<<blocks, problems * bk::LANES, bytes, (cudaStream_t)stream>>>(
      pr, B, cnt, r, dt, x_init, W, ql, WF, qF, lb, ub, X0, F0, P0, Xo, Fo, Po, viol, iters,
      fista);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: the shared-memory slice is a plain array

#include <vector>

extern "C" int admm_host_f32(ADMM_ARGS(float)) {
  const bk::AdmmParams<float> pr = ADMM_PARAMS(float);
  std::vector<float> sh(bk::admm_layout(H).n);
  for (int b = 0; b < B; ++b) ADMM_CALL(float, b, sh.data(), bk::HostExec{});
  return 0;
}

extern "C" int admm_host_f64(ADMM_ARGS(double)) {
  const bk::AdmmParams<double> pr = ADMM_PARAMS(double);
  std::vector<double> sh(bk::admm_layout(H).n);
  for (int b = 0; b < B; ++b) ADMM_CALL(double, b, sh.data(), bk::HostExec{});
  return 0;
}

#endif
