// Cholesky factor and its inverse of a small SPD matrix, (L, L⁻¹) with
// g = L·Lᵀ, k ≤ 32, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel chol_inv_small (_chol_inv_kernel) of
// trilinos_tpu/ops/smalldense.py. CholQR calls it on every block
// normalisation, between the Gram GEMM and the panel-scaling GEMM.
//
// Bound on an H100: g read once and L, L⁻¹ written once, 3·k²·sizeof(T)
// bytes (12 KB at k = 32 in f32), and about 2k³/3 flops: nanoseconds of
// work, so the launch floor sets its time. The point, as on the TPU, is one
// launch in place of the ~2k dependent small operations of the plain
// version (chol_inv_small_plain: one matvec, rsqrt and column write per
// Cholesky column, one row update per row of the inverse).
//
// Design: one block of one warp. g is staged in shared memory and factored
// in place, column by column (Cholesky–Banachiewicz, as the plain version):
// thread i owns row i, forms s_i = g[i][j] − Σ_{p<j} L[i][p]·L[j][p], and
// after a barrier scales it by rsqrt(s_j). Then thread c owns column c of
// L⁻¹ and runs forward substitution down it, X[i][c] = (δ_ic −
// Σ_{m<i} L[i][m]·X[m][c]) / L[i][i]; a column reads only itself, so that
// loop needs no barrier. The sums run in the plain version's order, but the
// plain version's matvecs go through the BLAS, so the two agree to a
// tolerance, not to the bit.
#include <cuda_runtime.h>

#define TT_MAX_K 32

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__global__ void chol_inv_kernel(const T* __restrict__ g, T* __restrict__ l_out,
                                T* __restrict__ linv_out, int k) {
  __shared__ T sl[TT_MAX_K][TT_MAX_K + 1];  // g, then L in place
  __shared__ T sx[TT_MAX_K][TT_MAX_K + 1];  // L⁻¹
  __shared__ T piv;
  const int t = threadIdx.x;
  if (t < k)
    for (int p = 0; p < k; ++p) sl[t][p] = g[t * k + p];
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    T s = T(0);
    if (t >= j && t < k) {
      T acc = T(0);
      for (int p = 0; p < j; ++p) acc += sl[t][p] * sl[j][p];
      s = sl[t][j] - acc;
      if (t == j) piv = s;
    }
    __syncthreads();
    if (t >= j && t < k) sl[t][j] = s * rsqrt_t(piv);
    __syncthreads();
  }
  if (t < k) {
    for (int p = 0; p < k; ++p) l_out[t * k + p] = p <= t ? sl[t][p] : T(0);
    for (int i = 0; i < k; ++i) {
      T acc = T(0);
      for (int m = 0; m < i; ++m) acc += sl[i][m] * sx[m][t];
      sx[i][t] = ((i == t ? T(1) : T(0)) - acc) / sl[i][i];
      linv_out[i * k + t] = sx[i][t];
    }
  }
}

// The launch floor that bounds chol_inv_kernel's time in practice.
__global__ void empty_kernel() {}

template <typename T>
static int launch(const void* g, void* l, void* linv, int k, void* stream) {
  if (k < 1 || k > TT_MAX_K) return (int)cudaErrorInvalidValue;
  chol_inv_kernel<T><<<1, 32, 0, (cudaStream_t)stream>>>(
      (const T*)g, (T*)l, (T*)linv, k);
  return (int)cudaGetLastError();
}

extern "C" {

int chol_inv_small_f32(const void* g, void* l, void* linv, int k,
                       void* stream) {
  return launch<float>(g, l, linv, k, stream);
}

int chol_inv_small_f64(const void* g, void* l, void* linv, int k,
                       void* stream) {
  return launch<double>(g, l, linv, k, stream);
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
