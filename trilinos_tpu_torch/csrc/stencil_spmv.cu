// Matrix-free constant-coefficient stencil SpMV, y = A·x, for Hopper (sm_90a).
//
// Replaces the TPU kernels stencil_spmv_planes (_plane_kernel) and
// stencil_spmv_masked (_dma_kernel) of trilinos_tpu/ops/pallas/stencil_op.py.
//
// Bound on an H100: bytes. Each x and y element is read or written once
// (2·n·sizeof(T), 0.0401 ms for 256³ f32 at 3.35 TB/s); the arithmetic (2
// flops a term) is far below the card's rate. Three things keep a kernel
// with one thread per point, one 4-byte load per term, from that bound:
// few loads in flight (a term's load sits under its own bounds branch, and
// its add consumes it before the next term's load is issued), L2 → SM
// traffic of several times x (the ±nx·ny neighbours of a plane tile come
// from L2 once more each), and one load instruction per term and point.
// stencil_kernel answers each:
//
// - A thread owns VW consecutive points along x (4 in f32, 2 in f64: 16
//   bytes; 1 where nx or a pointer does not allow it) and moves them as one
//   load or store. Its x±1 terms come from its own vector and its warp
//   neighbours' (__shfl_sync); only a thread whose neighbour along x is not
//   the next lane of its warp loads that one value itself.
// - For Galeri's 7-point cross (galeri/stencils.py cross3d_stencil, in its
//   term order) the terms' places are compile-time, and a block of
//   TT_SPMV_THREADS threads marches a z-chunk of its xy tile: each thread
//   keeps planes z − 1, z and z + 1 of its points in registers (a register
//   queue), so a ±nx·ny term costs no load and x crosses from L2 to the SM
//   about (1 + halo share) times. Each step loads plane z + 2 ahead of its
//   use and rows y ± 1 of plane z, then adds. No branch per term: an
//   out-of-range neighbour reads a clamped in-range address and contributes
//   a selected +0. A round-to-nearest sum that starts at +0 is never −0, so
//   adding +0 leaves it as the plain version's masked sum leaves it.
// - Any other stencil of at most TT_MAX_TERMS terms takes the generic
//   instance, stencil_point_kernel (the one-thread-a-point kernel of
//   earlier versions): one plane a block, the term loop unrolled to
//   TT_MAX_TERMS with an early exit at t.n and each term's load under its
//   bounds test. Two variants read slower on every stencil timed (PERF.md
//   §6): the terms padded to a compile-time count with every load issued
//   before the first add, and this same loop as an instance of the
//   cross's kernel template; as a kernel of its own it reads the earlier
//   kernel's time.
//
// The host picks the instance, VW, the block, the grid and the z-chunk
// (ops/stencil_op.py spmv_plan) and the launcher checks them
// (spmv_plan.cuh). At 256³ f32 (device time of CUDA-graph replays, NVIDIA
// H100 80GB HBM3, 700.00 W; bound 0.0401 ms): one plane a block 0.0648
// ms; the z-march 0.0509 ms at a z-chunk of 4 (the plan halves the chunk
// from TT_SPMV_ZC until the launch has 4096 blocks), 0.0517–0.0539 ms at
// 2, 8, 16, 32; the generic instance 0.1304 ms. Terms are summed in offset
// order with round-to-nearest multiplies and adds that the compiler may
// not fuse, so the result is bitwise the plain PyTorch version's
// (stencil_spmv_plain). Rows gid >= n are identity rows (y = x), copied by
// one device-to-device copy on the same stream.
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

#include "spmv_plan.cuh"
#include "tt_common.cuh"

#define TT_MAX_COLS 1024
#define TT_FULL_WARP 0xffffffffu

// Lanes of this thread's warp that exist: the block's last warp may be cut.
__device__ __forceinline__ unsigned warp_lanes() {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int left = blockDim.x * blockDim.y - (tid & ~31);
  return left >= 32 ? TT_FULL_WARP : (1u << left) - 1u;
}

template <typename T, int VW>
__device__ __forceinline__ Vec<T, VW> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, VW>*>(p);
}

// c·v where the term is in range, else +0.
template <typename T>
__device__ __forceinline__ T term(bool ok, T c, T v) {
  return ok ? mul_rn(c, v) : T(0);
}

// Galeri's 7-point cross: centre, −x, +x, −y, +y, −z, +z, each term's
// coefficient t.c[k]. Block (bx, by): thread (tx, ty) owns points
// ix .. ix + VW − 1 of row iy and marches planes z0 .. z1 − 1.
template <typename T, int VW>
__device__ __forceinline__ void cross_march(const T* __restrict__ x,
                                            T* __restrict__ y, int nx,
                                            int ny, int nz, int zc,
                                            const StencilTerms<T>& t) {
  using V = Vec<T, VW>;
  const unsigned lanes = warp_lanes();
  const int lane = (threadIdx.x + blockDim.x * threadIdx.y) & 31;
  const int ix = (blockIdx.x * blockDim.x + threadIdx.x) * VW;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const bool in = ix < nx && iy < ny;
  // threads past the grid read in-range addresses and store nothing; they
  // stay in the loop for their warp's shuffles
  const int cx = min(ix, nx - VW), cy = min(iy, ny - 1);
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const long long plane = (long long)nx * ny;
  const T* const col = x + (long long)cy * nx + cx;  // plane 0
  T* const out = y + (long long)cy * nx + cx;
  const bool ok_ym = cy > 0, ok_yp = cy + 1 < ny;
  const bool ok_xm = cx > 0, ok_xp = cx + VW < nx;
  const int off_ym = ok_ym ? -nx : 0, off_yp = ok_yp ? nx : 0;
  // the x−1 and x+1 values of this thread's first and last point: from
  // the neighbouring lane where it holds the next points along x, else
  // one scalar load (clamped in range)
  const bool own_xm = lane == 0 || threadIdx.x == 0;
  const bool own_xp = lane == 31 || threadIdx.x + 1 == blockDim.x;
  const int off_xm = ok_xm ? -1 : 0, off_xp = ok_xp ? VW : VW - 1;
  const T c0 = t.c[0], c1 = t.c[1], c2 = t.c[2], c3 = t.c[3], c4 = t.c[4],
          c5 = t.c[5], c6 = t.c[6];
  V prev = load_vec<T, VW>(col + plane * max(z0 - 1, 0));
  V cur = load_vec<T, VW>(col + plane * z0);
  V next = load_vec<T, VW>(col + plane * min(z0 + 1, nz - 1));
  for (int z = z0; z < z1; ++z) {
    const T* const row = col + plane * z;
    V ahead{};
    if (z + 1 < z1) ahead = load_vec<T, VW>(col + plane * min(z + 2, nz - 1));
    const V ym = load_vec<T, VW>(row + off_ym);
    const V yp = load_vec<T, VW>(row + off_yp);
    const T xm_own = own_xm ? row[off_xm] : T(0);
    const T xp_own = own_xp ? row[off_xp] : T(0);
    const T xm_lane = __shfl_up_sync(lanes, cur.v[VW - 1], 1);
    const T xp_lane = __shfl_down_sync(lanes, cur.v[0], 1);
    const T xm = own_xm ? xm_own : xm_lane;
    const T xp = own_xp ? xp_own : xp_lane;
    const bool ok_zm = z > 0, ok_zp = z + 1 < nz;
    V o;
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      const T left = v > 0 ? cur.v[v - 1] : xm;
      const T right = v + 1 < VW ? cur.v[v + 1] : xp;
      T acc = add_rn(T(0), mul_rn(c0, cur.v[v]));
      acc = add_rn(acc, term(v > 0 || ok_xm, c1, left));
      acc = add_rn(acc, term(v + 1 < VW || ok_xp, c2, right));
      acc = add_rn(acc, term(ok_ym, c3, ym.v[v]));
      acc = add_rn(acc, term(ok_yp, c4, yp.v[v]));
      acc = add_rn(acc, term(ok_zm, c5, prev.v[v]));
      acc = add_rn(acc, term(ok_zp, c6, next.v[v]));
      o.v[v] = acc;
    }
    if (in) *reinterpret_cast<V*>(out + plane * z) = o;
    prev = cur;
    cur = next;
    next = ahead;
  }
}

// The 7-point cross, VW points a thread, marching zc planes.
template <typename T, int VW>
__global__ void __launch_bounds__(TT_SPMV_THREADS)
    stencil_kernel(const T* __restrict__ x, T* __restrict__ y, int nx, int ny,
                   int nz, int zc, StencilTerms<T> t) {
  cross_march<T, VW>(x, y, nx, ny, nz, zc, t);
}

// The generic instance: any stencil, one point a thread, one plane a block
// (blockIdx.z); the term loop stops at t.n, and a term out of range adds
// nothing.
template <typename T>
__global__ void stencil_point_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, int nx, int ny,
                                     int nz, StencilTerms<T> t) {
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

// Galeri's 7-point cross in its own term order (galeri/stencils.py
// cross3d_stencil): centre, −x, +x, −y, +y, −z, +z.
static bool is_cross(int n_terms, const int* dx, const int* dy,
                     const int* dz) {
  static const int cx[7] = {0, -1, 1, 0, 0, 0, 0};
  static const int cy[7] = {0, 0, 0, -1, 1, 0, 0};
  static const int cz[7] = {0, 0, 0, 0, 0, -1, 1};
  if (n_terms != 7) return false;
  for (int k = 0; k < 7; ++k)
    if (dx[k] != cx[k] || dy[k] != cy[k] || dz[k] != cz[k]) return false;
  return true;
}

template <typename T>
static int launch(const void* x, void* y, long long n, long long n_pad, int nx,
                  int ny, int nz, int n_terms, const int* dx, const int* dy,
                  const int* dz, const long long* lin, const double* coeff,
                  const int* plan, void* stream) {
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  if (!tt_spmv_plan_ok(plan, (int)sizeof(T), (uintptr_t)x, (uintptr_t)y, nx,
                       ny, nz, is_cross(n_terms, dx, dy, dz)))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(plan[2], plan[3], plan[4]);
  const dim3 grid(plan[5], plan[6], plan[7]);
  const int vw = plan[0], zc = plan[8];
  const T* xs = (const T*)x;
  T* ys = (T*)y;
  constexpr int W = 16 / sizeof(T);  // 16 bytes: 4 × f32, 2 × f64
  if (!plan[1])
    stencil_point_kernel<T><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, t);
  else if (vw == W)
    stencil_kernel<T, W><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, zc, t);
  else if (vw == 2)
    stencil_kernel<T, 2><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, zc, t);
  else
    stencil_kernel<T, 1><<<grid, block, 0, s>>>(xs, ys, nx, ny, nz, zc, t);
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
                     const double* coeff, const int* plan, void* stream) {
  return launch<float>(x, y, n, n_pad, nx, ny, nz, n_terms, dx, dy, dz, lin,
                       coeff, plan, stream);
}

int stencil_spmv_f64(const void* x, void* y, long long n, long long n_pad,
                     int nx, int ny, int nz, int n_terms, const int* dx,
                     const int* dy, const int* dz, const long long* lin,
                     const double* coeff, const int* plan, void* stream) {
  return launch<double>(x, y, n, n_pad, nx, ny, nz, n_terms, dx, dy, dz, lin,
                        coeff, plan, stream);
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
