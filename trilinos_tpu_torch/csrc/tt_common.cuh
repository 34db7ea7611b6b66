// Shared by the hand-written kernels of csrc/: the stencil's terms as a
// kernel argument and the round-to-nearest arithmetic that keeps each
// kernel bitwise equal to its plain PyTorch version.
//
// The parity rule: every multiply and add goes through an _rn intrinsic,
// which the compiler may not contract into a fused multiply-add, and each
// coefficient is rounded to the data type once, on the host, as the plain
// version's tensor of coefficients is.
//
// ops/_build.py hashes this header with each source, so editing it
// rebuilds every kernel.
#pragma once

#include <cuda_runtime.h>

#define TT_MAX_TERMS 32

// A constant-coefficient stencil: term k reads the neighbour at
// (dx, dy, dz), lin = dx + nx·(dy + ny·dz) rows away, with coefficient c.
// Passed by value, so the terms are constant-bank operands.
template <typename T>
struct StencilTerms {
  int n;
  int dx[TT_MAX_TERMS];
  int dy[TT_MAX_TERMS];
  int dz[TT_MAX_TERMS];
  long long lin[TT_MAX_TERMS];
  T c[TT_MAX_TERMS];
};

// Fill `t` from the host arrays; cudaErrorInvalidValue when n_terms is
// outside 0..TT_MAX_TERMS.
template <typename T>
static int fill_terms(StencilTerms<T>* t, int n_terms, const int* dx,
                      const int* dy, const int* dz, const long long* lin,
                      const double* coeff) {
  if (n_terms < 0 || n_terms > TT_MAX_TERMS) return (int)cudaErrorInvalidValue;
  t->n = n_terms;
  for (int k = 0; k < n_terms; ++k) {
    t->dx[k] = dx[k];
    t->dy[k] = dy[k];
    t->dz[k] = dz[k];
    t->lin[k] = lin[k];
    t->c[k] = (T)coeff[k];  // round to nearest, as the device would
  }
  return 0;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
