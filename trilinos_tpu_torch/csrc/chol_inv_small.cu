// Cholesky factor and its inverse of a small SPD matrix, (L, L⁻¹) with
// g = L·Lᵀ, k ≤ 32, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel chol_inv_small (_chol_inv_kernel) of
// trilinos_tpu/ops/smalldense.py. CholQR calls it on every block
// normalisation, between the Gram GEMM and the panel-scaling GEMM.
//
// Bound on an H100: g read once and L, L⁻¹ written once, 3·k²·sizeof(T)
// bytes (12 KB at k = 32 in f32), and about 2k³/3 flops: nanoseconds of
// work, so the launch and the chain of dependent steps set its time (3.72
// µs at k = 16 and 7.17 µs at k = 32 in f32 against an empty kernel's 1.52
// µs, device time of CUDA-graph replays, NVIDIA H100 80GB HBM3, 700.00 W).
// The point, as on the TPU, is one launch in place of the ~2k dependent
// small operations of the plain version (chol_inv_small_plain: one matvec,
// rsqrt and column write per Cholesky column, one row update per row of the
// inverse).
//
// Design: one warp, no shared memory and no barrier. Lane i holds row i of
// g in registers and factors it in place, column by column
// (Cholesky–Banachiewicz, as the plain version): at column j lane i forms
// s_i = g[i][j] − Σ_{p<j} L[i][p]·L[j][p], row j's entries broadcast from
// lane j by __shfl_sync, then scales it by rsqrt(s_j), the pivot broadcast
// the same way (a non-positive pivot gives NaN, as in the plain version).
// Lane c also owns column c of L⁻¹: in the same step it forms row j by
// forward substitution, X[j][c] = (δ_jc − Σ_{m<j} L[j][m]·X[m][c]) / L[j][j],
// from the same broadcasts of row j, the division a multiply by 1 / L[j][j]
// formed beside the factor's chain (a non-positive pivot makes it NaN too).
// Every loop is unrolled to a compile-time bound K (8, 16 or 32, the
// smallest that holds k) without a branch, so the compiler can overlap a
// column's broadcasts and the head of its sums with the previous column's
// pivot: the chain that remains is one multiply-add, two shuffles and an
// rsqrt a column. Steps past k run on zero rows; none of their values is
// stored or read by a stored one. The old design staged g in shared
// memory, took 2k barriers, and ran the substitution after the factor,
// each multiply-add through two shared-memory loads (12.2 µs at k = 16,
// 26.5 µs at k = 32 in f32, device time, NVIDIA H100 80GB HBM3, 700.00 W).
// The sums run in the plain version's order, but the plain version's
// matvecs go through the BLAS and the kernel contracts its multiply-adds,
// so the two agree to a tolerance, not to the bit.
#include <cuda_runtime.h>

#define TT_MAX_K 32
#define TT_FULL_WARP 0xffffffffu

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T, int K>
__global__ void __launch_bounds__(32)
    chol_inv_kernel(const T* __restrict__ g, T* __restrict__ l_out,
                    T* __restrict__ linv_out, int k) {
  const int i = threadIdx.x;  // row i of g and L, column i of L⁻¹
  const bool mine = i < k;
  T a[K];   // row i of g, then of L in place
  T xc[K];  // column i of L⁻¹
#pragma unroll
  for (int p = 0; p < K; ++p) a[p] = mine && p < k ? g[i * k + p] : T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T dot = T(0), acc = T(0);
#pragma unroll
    for (int p = 0; p < j; ++p) {
      const T ljp = __shfl_sync(TT_FULL_WARP, a[p], j);  // L[j][p]
      dot += a[p] * ljp;
      acc += ljp * xc[p];
    }
    const T s = a[j] - dot;
    const T pivot = __shfl_sync(TT_FULL_WARP, s, j);
    const T r = rsqrt_t(pivot);
    a[j] = i >= j ? s * r : T(0);
    xc[j] = ((j == i ? T(1) : T(0)) - acc) * (T(1) / (pivot * r));
  }
  if (mine) {
#pragma unroll
    for (int p = 0; p < K; ++p)
      if (p < k) l_out[i * k + p] = a[p];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) linv_out[j * k + i] = xc[j];
  }
}

// The launch floor that bounds chol_inv_kernel's time in practice.
__global__ void empty_kernel() {}

template <typename T>
static int launch(const void* g, void* l, void* linv, int k, void* stream) {
  if (k < 1 || k > TT_MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* gs = (const T*)g;
  if (k <= 8)
    chol_inv_kernel<T, 8><<<1, 32, 0, s>>>(gs, (T*)l, (T*)linv, k);
  else if (k <= 16)
    chol_inv_kernel<T, 16><<<1, 32, 0, s>>>(gs, (T*)l, (T*)linv, k);
  else
    chol_inv_kernel<T, TT_MAX_K><<<1, 32, 0, s>>>(gs, (T*)l, (T*)linv, k);
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
