// Matrix-free constant-coefficient stencil SpMV, y = A·x, for Hopper (sm_90a).
//
// Replaces the TPU kernels stencil_spmv_planes (_plane_kernel) and
// stencil_spmv_masked (_dma_kernel) of trilinos_tpu/ops/pallas/stencil_op.py.
//
// Bound on an H100: bytes. Each x and y element is read or written once
// (2·n·sizeof(T)); the arithmetic (2 flops a term) is far below the card's
// rate. One thread per grid point on a 3-D launch grid, x fastest, so a
// warp reads consecutive x and the neighbours at ±1, ±nx, ±nx·ny come
// through L1/L2. Validity against the grid faces comes from ix, iy, iz with
// no integer division. The term loop is unrolled to TT_MAX_TERMS with an
// early exit, so each term's offsets and coefficient (already in T) are
// constant-bank operands rather than indexed loads. Rows gid >= n are
// identity rows (y = x), copied by one device-to-device copy on the same
// stream.
//
// Terms are summed in offset order with round-to-nearest multiplies and
// adds that the compiler may not fuse, so the result is bitwise the plain
// PyTorch version's (stencil_spmv_plain).
//
// Multivector apply, Y = A·X (stencil_mv_kernel, entry points
// stencil_spmm_*): replaces stencil_spmm_packed (_plane_kernel_mv,
// _plane_compute_mv) of the same Pallas module. X and Y are (n_pad, k)
// row-major, the layout of the package's public functions; the TPU kernel's
// (k, R, 128) packing was lane layout work and has no counterpart here.
// Bound on an H100: bytes, 2·n_pad·k·sizeof(T) (0.641 ms for 256³, k = 16,
// f32). One thread per (row, column) with the column fastest: a block is
// (k, rx, ry) threads over rx·ry consecutive grid points, so a warp reads
// whole contiguous rows of X and every neighbour row at ±1, ±nx, ±nx·ny is
// one contiguous k-element run. ix, iy, iz come from the launch grid once
// per row. Same term order and rounding as the single-vector kernel, so the
// result is bitwise the plain version's.
#include "tt_common.cuh"

#define TT_MAX_COLS 1024  // threads per block: k·rx·ry ≤ 1024

template <typename T>
__global__ void stencil_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int nx, int ny, int nz, StencilTerms<T> t) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  const long long gid = ix + (long long)nx * (iy + (long long)ny * iz);
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < TT_MAX_TERMS; ++k) {
    if (k >= t.n) break;
    const unsigned jx = ix + t.dx[k], jy = iy + t.dy[k], jz = iz + t.dz[k];
    if (jx < (unsigned)nx && jy < (unsigned)ny && jz < (unsigned)nz)
      acc = add_rn(acc, mul_rn(t.c[k], x[gid + t.lin[k]]));
  }
  y[gid] = acc;
}

template <typename T>
__global__ void stencil_mv_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  int nx, int ny, int nz, int k,
                                  StencilTerms<T> t) {
  const int col = threadIdx.x;
  const int ix = blockIdx.x * blockDim.y + threadIdx.y;
  const int iy = blockIdx.y * blockDim.z + threadIdx.z;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  const long long gid = ix + (long long)nx * (iy + (long long)ny * iz);
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < TT_MAX_TERMS; ++s) {
    if (s >= t.n) break;
    const unsigned jx = ix + t.dx[s], jy = iy + t.dy[s], jz = iz + t.dz[s];
    if (jx < (unsigned)nx && jy < (unsigned)ny && jz < (unsigned)nz)
      acc = add_rn(acc, mul_rn(t.c[s], x[(gid + t.lin[s]) * k + col]));
  }
  y[gid * k + col] = acc;
}

// Rows gid >= n are identity rows (y = x): one contiguous device copy of
// (n_pad - n)·k elements on the same stream.
template <typename T>
static cudaError_t copy_pad_rows(const void* x, void* y, long long n,
                                 long long n_pad, long long k, cudaStream_t s) {
  if (n_pad <= n) return cudaSuccess;
  return cudaMemcpyAsync((T*)y + n * k, (const T*)x + n * k,
                         (n_pad - n) * k * sizeof(T), cudaMemcpyDeviceToDevice,
                         s);
}

template <typename T>
static int launch(const void* x, void* y, long long n, long long n_pad, int nx,
                  int ny, int nz, int n_terms, const int* dx, const int* dy,
                  const int* dz, const long long* lin, const double* coeff,
                  void* stream) {
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const int bx = nx >= 128 ? 128 : ((nx + 31) / 32) * 32;
  int by = 256 / bx;
  if (by > ny) by = ny;
  const dim3 block(bx, by, 1);
  const dim3 grid((nx + bx - 1) / bx, (ny + by - 1) / by, nz);
  stencil_kernel<T><<<grid, block, 0, s>>>((const T*)x, (T*)y, nx, ny, nz, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = copy_pad_rows<T>(x, y, n, n_pad, 1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_mv(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int k, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, void* stream) {
  if (k < 1 || k > TT_MAX_COLS) return (int)cudaErrorInvalidValue;
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  // about 256 threads a block: k columns × rx points along x × ry along y
  int rx = 256 / k;
  if (rx < 1) rx = 1;
  if (rx > nx) rx = nx;
  int ry = 256 / (k * rx);
  if (ry < 1) ry = 1;
  if (ry > ny) ry = ny;
  const dim3 block(k, rx, ry);
  const dim3 grid((nx + rx - 1) / rx, (ny + ry - 1) / ry, nz);
  stencil_mv_kernel<T><<<grid, block, 0, s>>>((const T*)x, (T*)y, nx, ny, nz,
                                               k, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = copy_pad_rows<T>(x, y, n, n_pad, k, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

int stencil_spmv_f32(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, void* stream) {
  return launch<float>(x, y, n, n_pad, nx, ny, nz, n_terms, dx, dy, dz, lin,
                       coeff, stream);
}

int stencil_spmv_f64(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, void* stream) {
  return launch<double>(x, y, n, n_pad, nx, ny, nz, n_terms, dx, dy, dz, lin,
                        coeff, stream);
}

int stencil_spmm_f32(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int k, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, void* stream) {
  return launch_mv<float>(x, y, n, n_pad, nx, ny, nz, k, n_terms, dx, dy, dz,
                          lin, coeff, stream);
}

int stencil_spmm_f64(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int k, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, void* stream) {
  return launch_mv<double>(x, y, n, n_pad, nx, ny, nz, k, n_terms, dx, dy, dz,
                           lin, coeff, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
