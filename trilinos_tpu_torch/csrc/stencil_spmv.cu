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
// f32). One thread per (row, vw columns), the columns fastest: a block is
// (k / vw, rx, ry) threads over rx·ry consecutive grid points of one plane,
// so a warp reads whole contiguous rows of X and every neighbour row at
// ±1, ±nx, ±nx·ny is one contiguous run. Each thread moves its vw columns
// as one load per term and one store: 16 bytes (4 × f32, 2 × f64) where k
// and the pointers allow it, narrower otherwise. The host picks vw from k
// and the pointers' alignment and plans the launch (ops/stencil_op.py
// spmm_plan); each vw is a template instance of the same kernel. With
// 4-byte loads (one thread per column) the kernel issued 16× the load
// instructions of k = 1 and read 2.4358 ms at 256³ × 16; the 16-byte
// loads cut the instructions 4×. A z-marching shared-memory tile (each
// plane of X loaded once with its halo) was measured beside this design
// and was not faster on the H100 (PERF.md §6), so the simpler design
// stays. Same term order and rounding as the single-vector kernel, so the
// result is bitwise the plain version's.
#include <cstdint>

#include "tt_common.cuh"

#define TT_MAX_COLS 1024

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

// Block (k / VW, rx, ry): threadIdx.x is the column lane (VW columns
// each), threadIdx.y the point along x, threadIdx.z along y.
template <typename T, int VW>
__global__ void stencil_mv_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  int nx, int ny, int nz, int k,
                                  StencilTerms<T> t) {
  using V = Vec<T, VW>;
  const int col = threadIdx.x * VW;
  const int ix = blockIdx.x * blockDim.y + threadIdx.y;
  const int iy = blockIdx.y * blockDim.z + threadIdx.z;
  const int iz = blockIdx.z;
  if (ix >= nx || iy >= ny) return;
  const long long gid = ix + (long long)nx * (iy + (long long)ny * iz);
  T acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = T(0);
#pragma unroll
  for (int s = 0; s < TT_MAX_TERMS; ++s) {
    if (s >= t.n) break;
    const unsigned jx = ix + t.dx[s], jy = iy + t.dy[s], jz = iz + t.dz[s];
    if (jx < (unsigned)nx && jy < (unsigned)ny && jz < (unsigned)nz) {
      const V xv =
          *reinterpret_cast<const V*>(x + (gid + t.lin[s]) * k + col);
#pragma unroll
      for (int v = 0; v < VW; ++v)
        acc[v] = add_rn(acc[v], mul_rn(t.c[s], xv.v[v]));
    }
  }
  V out;
#pragma unroll
  for (int v = 0; v < VW; ++v) out.v[v] = acc[v];
  *reinterpret_cast<V*>(y + gid * k + col) = out;
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

// The launch as ops/stencil_op.py spmm_plan gives it: an int32 array
// [vw, blockDim.x, .y, .z, gridDim.x, .y, .z]. Checked here, so that a plan
// that does not fit the shape, the pointers or CUDA's per-axis limits
// (blockDim.x, .y <= 1024, .z <= 64) fails the launch.
template <typename T>
static bool mv_plan_ok(const int* p, const void* x, const void* y, int nx,
                       int ny, int nz, int k) {
  const int vw = p[0];
  const uintptr_t align = (uintptr_t)vw * sizeof(T);
  const long long threads = (long long)p[1] * p[2] * p[3];
  return (vw == 1 || vw == 2 || vw * (int)sizeof(T) == 16) &&
         vw * (int)sizeof(T) <= 16 && k % vw == 0 && p[1] * vw == k &&
         (uintptr_t)x % align == 0 && (uintptr_t)y % align == 0 &&
         threads >= 1 && threads <= 1024 && p[1] <= 1024 && p[2] <= 1024 &&
         p[3] <= 64 && p[5] <= 65535 && p[6] <= 65535 &&
         (long long)p[4] * p[2] >= nx && (long long)p[5] * p[3] >= ny &&
         p[6] == nz;
}

template <typename T>
static int launch_mv(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int k, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, const int* plan, void* stream) {
  if (k < 1 || k > TT_MAX_COLS) return (int)cudaErrorInvalidValue;
  if (!mv_plan_ok<T>(plan, x, y, nx, ny, nz, k))
    return (int)cudaErrorInvalidConfiguration;
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(plan[1], plan[2], plan[3]);
  const dim3 grid(plan[4], plan[5], plan[6]);
  const T* xs = (const T*)x;
  T* ys = (T*)y;
  if (plan[0] == 1)
    stencil_mv_kernel<T, 1><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, k, t);
  else if (plan[0] == 2)
    stencil_mv_kernel<T, 2><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, k, t);
  else
    stencil_mv_kernel<T, 16 / sizeof(T)><<<grid, block, 0, s>>>(
        xs, ys, nx, ny, nz, k, t);
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
                     const double* coeff, const int* plan, void* stream) {
  return launch_mv<float>(x, y, n, n_pad, nx, ny, nz, k, n_terms, dx, dy, dz,
                          lin, coeff, plan, stream);
}

int stencil_spmm_f64(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int k, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, const int* plan, void* stream) {
  return launch_mv<double>(x, y, n, n_pad, nx, ny, nz, k, n_terms, dx, dy, dz,
                           lin, coeff, plan, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
