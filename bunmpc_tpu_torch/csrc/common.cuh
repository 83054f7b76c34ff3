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
#define HD __host__ __device__ inline
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

template <typename T>
HD T s_max(T a, T b) { return a > b ? a : b; }
template <typename T>
HD T s_min(T a, T b) { return a < b ? a : b; }

// A per-problem view of a batch-last scratch array: element i of problem b
// lives at base[i * stride + b], so neighbouring threads touch neighbouring
// addresses.
template <typename T>
struct Strided {
  T* base;
  long stride;
  HD T& operator[](long i) const { return base[i * stride]; }
};

template <typename T>
HD void cross3(const T* a, const T* b, T* out) {
  T o0 = a[1] * b[2] - a[2] * b[1];
  T o1 = a[2] * b[0] - a[0] * b[2];
  T o2 = a[0] * b[1] - a[1] * b[0];
  out[0] = o0;
  out[1] = o1;
  out[2] = o2;
}

}  // namespace bk
