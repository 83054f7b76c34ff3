// Shared helpers of the hand-written kernels (csrc/admm.cu, csrc/fused.cu,
// csrc/ddp.cu).
//
// The per-problem math is written once, templated on the scalar type, as
// __host__ __device__ functions: nvcc builds the float instantiation into the
// kernels for sm_90a, and a test build with g++ (no __CUDACC__) compiles the
// same functions for the host, in float and double, so the kernel math is
// checked on a CPU against the plain PyTorch versions.
#pragma once

#include <cmath>

#ifdef __CUDACC__
// forced inline: a phase's lambdas, the work arrays' pointers and the
// parameter structs stay in registers (a struct whose address escapes into
// a call is kept on the stack, and a pointer loaded from there loses its
// shared-memory address space)
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace bk {

HD float s_sqrt(float x) { return sqrtf(x); }
HD double s_sqrt(double x) { return sqrt(x); }
HD float s_sin(float x) { return sinf(x); }
HD double s_sin(double x) { return sin(x); }
HD float s_cos(float x) { return cosf(x); }
HD double s_cos(double x) { return cos(x); }
HD float s_atan2(float y, float x) { return atan2f(y, x); }
HD double s_atan2(double y, double x) { return atan2(y, x); }
HD float s_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
HD double s_rsqrt(double x) { return 1.0 / sqrt(x); }

// round half to even, as jnp.round and torch.round do
HD float s_rint(float x) { return rintf(x); }
HD double s_rint(double x) { return rint(x); }
HD float s_fmod(float x, float y) { return fmodf(x, y); }
HD double s_fmod(double x, double y) { return fmod(x, y); }

// floor modulo (the sign of y), as jnp.mod computes it
template <typename T>
HD T s_mod(T x, T y) {
  const T r = s_fmod(x, y);
  return (r != T(0) && ((r < T(0)) != (y < T(0)))) ? r + y : r;
}

// a * b and a + b each rounded on its own: nvcc contracts a * b + c into
// one fused multiply-add, which would round the gait clock differently from
// the plain version and move a contact flag that sits on a phase boundary
HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
HD double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
HD double add_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

// Phase clocks of the profiling build (nvcc -DBK_PROFILE, built and read by
// `python -m bunmpc_tpu_torch.profile_kernels --phases`): lane 0 of each
// problem adds the clock64() cycles of a phase to its problem's row of a
// (B, PROF_SLOTS) int64 buffer that <kernel>_set_profile installs. In every
// other build a Prof is empty and its calls compile to nothing.
constexpr int PROF_SLOTS = 16;
#if defined(BK_PROFILE) && defined(__CUDACC__)
__device__ long long* bk_prof_rows;
struct Prof {
  long long* row;  // lane 0 of a problem: its row; every other lane: nullptr
  __device__ long long now() const { return clock64(); }
  __device__ void add(int slot, long long t0) const {
    if (row) row[slot] += clock64() - t0;
  }
};
__device__ inline Prof make_prof(int b, bool lane0) {
  return Prof{lane0 ? bk_prof_rows + (long)PROF_SLOTS * b : nullptr};
}
#define BK_SET_PROFILE(name)                                              \
  extern "C" int name##_set_profile(void* rows) {                         \
    return (int)cudaMemcpyToSymbol(bk::bk_prof_rows, &rows, sizeof(rows)); \
  }
#else
struct Prof {
  HD long long now() const { return 0; }
  HD void add(int, long long) const {}
};
HD Prof make_prof(int, bool) { return Prof{}; }
#define BK_SET_PROFILE(name)
#endif

// fully unroll the next loop in the device build
#ifdef __CUDACC__
#define BK_UNROLL _Pragma("unroll")
#else
#define BK_UNROLL
#endif

template <typename T>
HD T s_max(T a, T b) { return a > b ? a : b; }
template <typename T>
HD T s_min(T a, T b) { return a < b ? a : b; }

template <typename T>
HD void cross3(const T* a, const T* b, T* out) {
  T o0 = a[1] * b[2] - a[2] * b[1];
  T o1 = a[2] * b[0] - a[0] * b[2];
  T o2 = a[0] * b[1] - a[1] * b[0];
  out[0] = o0;
  out[1] = o1;
  out[2] = o2;
}

// Every kernel runs one problem on the LANES threads of a warp, as phases:
// exec(f) calls f(lane) on every lane of the problem and then waits for all
// of them. Lanes hand data to each other only through the problem's work
// arrays, between phases.
constexpr int LANES = 32;

#ifdef __CUDACC__
// a warp is one problem, a thread one lane; a phase ends at a warp barrier
struct DeviceExec {
  int lane;
  Prof prof;
  template <class F>
  __device__ void operator()(const F& f) const {
    f(lane);
    __syncwarp();
  }
};
#else
// the host build runs the lanes of a phase one after another
struct HostExec {
  Prof prof;
  template <class F>
  void operator()(const F& f) const {
    for (int lane = 0; lane < LANES; ++lane) f(lane);
  }
};
#endif

}  // namespace bk
