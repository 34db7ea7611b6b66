// Stencil polynomial (a chain of up to 8 three-term stages) on a
// matrix-free constant-coefficient stencil, for Hopper (sm_90a).
//
// Replaces the TPU kernel _poly_call (_poly_kernel, _stage_strip) of
// trilinos_tpu/ops/pallas/stencil_poly.py, behind both of its public
// functions: stencil_poly_apply (returns u_s) and stencil_powers_apply
// (returns every u_1..u_s, the matrix-powers basis of s-step GMRES).
//
//   u_0 = x
//   u_j = alpha_j·(A u_{j-1}) + beta_j·u_{j-1} + gamma_j·u_{j-2} + zeta_j·x
//
// Bound on an H100: bytes. The fused work reads x once and writes n_out
// vectors ((1 + n_out)·n·sizeof(T)); the arithmetic (2 flops a term a
// stage) is far below the card's rate. This first design launches one
// stage kernel per stage, so it moves about (2 + zeta reads)·n per stage
// instead: u_{j-1} (with its neighbours through L1/L2), u_{j-2} and x where
// their coefficients are not zero, and u_j. The TPU kernel keeps the
// intermediates on chip with a wavefront over row strips; the Hopper
// counterpart (temporal blocking along z in shared memory) is later work.
//
// Each stage kernel is one thread per grid point on a 3-D launch grid,
// x fastest, as the stencil SpMV kernel (stencil_spmv.cu). A term whose
// coefficient is exactly 0.0 (tested in double, as the host code tests the
// Python float) is skipped, and every coefficient is rounded to T once.
// Terms are summed in offset order and the stage adds its parts in the
// order alpha, beta, gamma, zeta with round-to-nearest multiplies and adds
// that the compiler may not fuse, so each stage is bitwise the plain
// PyTorch version's (stencil_poly_plain). A neighbour counts when it lies
// on the grid and its plane iz + dz lies in [z_lo, z_hi), for every term:
// the semantics of the JAX package's XLA reference (_spmv_xla_zb). Its
// Pallas kernel masks only the terms with dz != 0, so the two differ on
// rows whose own plane lies outside [z_lo, z_hi). Pad rows
// (gid >= n) carry u_{j-1}, hence x, through every stage: one device copy
// of x's pad rows into each stage's output.
//
// Poly mode writes the last stage into `out` and the others into three
// rotating scratch vectors (stage j writes slot (j-1) % 3 and reads
// u_{j-1}, u_{j-2} from the other two slots). Powers mode writes stage j
// into row j-1 of the (s, n_pad) `out`.
#include "tt_common.cuh"

#define TT_MAX_STAGES 8

enum { HAS_ALPHA = 1, HAS_BETA = 2, HAS_GAMMA = 4, HAS_ZETA = 8 };

template <typename T>
struct Stage {
  T alpha, beta, gamma, zeta;
  int flags;
};

template <typename T>
__global__ void stage_kernel(const T* __restrict__ prev,
                             const T* __restrict__ prev2,
                             const T* __restrict__ x, T* __restrict__ out,
                             int nx, int ny, int z_lo, int z_hi,
                             StencilTerms<T> t, Stage<T> st) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  const long long gid = ix + (long long)nx * (iy + (long long)ny * iz);
  T acc = T(0);
  if (st.flags & HAS_ALPHA) {
#pragma unroll
    for (int k = 0; k < TT_MAX_TERMS; ++k) {
      if (k >= t.n) break;
      const unsigned jx = ix + t.dx[k], jy = iy + t.dy[k];
      const int jz = iz + t.dz[k];
      if (jx < (unsigned)nx && jy < (unsigned)ny && jz >= z_lo && jz < z_hi)
        acc = add_rn(acc, mul_rn(t.c[k], prev[gid + t.lin[k]]));
    }
    acc = mul_rn(st.alpha, acc);
  }
  if (st.flags & HAS_BETA) acc = add_rn(acc, mul_rn(st.beta, prev[gid]));
  if (st.flags & HAS_GAMMA) acc = add_rn(acc, mul_rn(st.gamma, prev2[gid]));
  if (st.flags & HAS_ZETA) acc = add_rn(acc, mul_rn(st.zeta, x[gid]));
  out[gid] = acc;
}

template <typename T>
static int launch(const void* xv, void* outv, void* scratchv, long long n,
                  long long n_pad, int nx, int ny, int nz, int z_lo, int z_hi,
                  int n_terms, const int* dx, const int* dy, const int* dz,
                  const long long* lin, const double* coeff, int n_stages,
                  const double* stage_coeffs, int all_outputs, void* stream) {
  if (n_stages < 1 || n_stages > TT_MAX_STAGES || z_lo < 0 || z_lo > z_hi ||
      z_hi > nz || n != (long long)nx * ny * nz || n_pad < n ||
      stage_coeffs[2] != 0.0)  // gamma_1: u_{-1} does not exist
    return (int)cudaErrorInvalidValue;
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  const T* x = (const T*)xv;
  T* out = (T*)outv;
  T* scratch = (T*)scratchv;
  cudaStream_t s = (cudaStream_t)stream;
  const int bx = nx >= 128 ? 128 : ((nx + 31) / 32) * 32;
  int by = 256 / bx;
  if (by > ny) by = ny;
  const dim3 block(bx, by, 1);
  const dim3 grid((nx + bx - 1) / bx, (ny + by - 1) / by, nz);
  const T* u[TT_MAX_STAGES + 1];  // u[j] = stage j's output, u[0] = x
  u[0] = x;
  for (int j = 1; j <= n_stages; ++j) {
    T* dst = all_outputs ? out + (long long)(j - 1) * n_pad
             : j == n_stages ? out
                             : scratch + (long long)((j - 1) % 3) * n_pad;
    const double* sc = stage_coeffs + 4 * (j - 1);
    Stage<T> st;
    st.alpha = (T)sc[0];
    st.beta = (T)sc[1];
    st.gamma = (T)sc[2];
    st.zeta = (T)sc[3];
    st.flags = (sc[0] != 0.0 ? HAS_ALPHA : 0) | (sc[1] != 0.0 ? HAS_BETA : 0) |
               (sc[2] != 0.0 ? HAS_GAMMA : 0) | (sc[3] != 0.0 ? HAS_ZETA : 0);
    stage_kernel<T><<<grid, block, 0, s>>>(u[j - 1], j >= 2 ? u[j - 2] : x,
                                           x, dst, nx, ny, z_lo, z_hi, t, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_pad > n) {
      err = cudaMemcpyAsync(dst + n, x + n, (n_pad - n) * sizeof(T),
                            cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return (int)err;
    }
    u[j] = dst;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int stencil_poly_f32(const void* x, void* out, void* scratch, long long n,
                     long long n_pad, int nx, int ny, int nz, int z_lo,
                     int z_hi, int n_terms, const int* dx, const int* dy,
                     const int* dz, const long long* lin, const double* coeff,
                     int n_stages, const double* stage_coeffs,
                     int all_outputs, void* stream) {
  return launch<float>(x, out, scratch, n, n_pad, nx, ny, nz, z_lo, z_hi,
                       n_terms, dx, dy, dz, lin, coeff, n_stages,
                       stage_coeffs, all_outputs, stream);
}

int stencil_poly_f64(const void* x, void* out, void* scratch, long long n,
                     long long n_pad, int nx, int ny, int nz, int z_lo,
                     int z_hi, int n_terms, const int* dx, const int* dy,
                     const int* dz, const long long* lin, const double* coeff,
                     int n_stages, const double* stage_coeffs,
                     int all_outputs, void* stream) {
  return launch<double>(x, out, scratch, n, n_pad, nx, ny, nz, z_lo, z_hi,
                        n_terms, dx, dy, dz, lin, coeff, n_stages,
                        stage_coeffs, all_outputs, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
