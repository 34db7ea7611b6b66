// Stored-DIA SpMV, y[i] = Σ_d data[d, i] · x[i + off_d], for Hopper (sm_90a).
//
// Replaces the TPU kernels dia_spmm_ring (_kernel_ring, k = 1) and the
// window kernel dia_spmv_pallas (_kernel) of
// trilinos_tpu/ops/pallas/dia_spmv.py.
//
// Bound on an H100: bytes. The diagonals are read once (nd·n elements),
// x and y once each: (nd·sizeof(data) + 2·sizeof(x))·n bytes; 2 flops per
// stored element is far below the card's rate. One thread per row loops
// over the diagonals, so each data[d, :] read is coalesced across a warp.
// The TPU ring kernel kept x strips resident from one grid step to the next;
// GPU blocks run in no order, so every block reads its own x neighbourhood
// (through L1/L2). Positions with i + off_d outside [0, n_pad) are skipped:
// DIA stores zeros there, so the sum equals the plain version's cyclic one.
//
// Types: f32 data/x/y, f64 data/x/y, and bf16 data with f32 x/y. The sum is
// in f32 (f64 for f64), in diagonal order, with round-to-nearest multiplies
// and adds that the compiler may not fuse: bitwise the plain version's.
//
// Multivector apply, Y[i, :] = Σ_d data[d, i] · X[i + off_d, :]
// (dia_mv_kernel, entry points dia_spmm_*): replaces dia_spmm_ring
// (_kernel_ring) at k > 1 and the window kernel dia_spmm_packed
// (_kernel_mv). X and Y are (n_pad, k) row-major. Bound on an H100: bytes,
// (nd·sizeof(data) + 2·k·sizeof(x))·n_pad (0.163 ms at level 1 of the 256³
// hierarchy, 128³ rows × 33 diagonals, k = 16, f32). The TPU kernels read
// each diagonal once for all k columns; here one thread per (row, column),
// column fastest, in blocks of (k, rows): the k threads of a row read the
// same data[d, i] (one broadcast load) and k contiguous x values. Same
// order, widening and rounding as the single-vector kernel.
#include <cuda_bf16.h>

#include "tt_common.cuh"

#define TT_MAX_DIAGS 512
#define TT_MAX_COLS 1024  // threads per block: k·rows ≤ 1024

struct DiaOffsets {
  int n;
  int off[TT_MAX_DIAGS];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TD, typename TX>
__global__ void dia_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                           TX* __restrict__ y, long long n_pad, DiaOffsets o) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  TX acc = TX(0);
  for (int d = 0; d < o.n; ++d) {
    const long long j = i + o.off[d];
    if (j >= 0 && j < n_pad)
      acc = add_rn(acc, mul_rn((TX)widen(data[d * n_pad + i]), x[j]));
  }
  y[i] = acc;
}

template <typename TD, typename TX>
__global__ void dia_mv_kernel(const TD* __restrict__ data,
                              const TX* __restrict__ x, TX* __restrict__ y,
                              long long n_pad, int k, DiaOffsets o) {
  const int col = threadIdx.x;
  const long long i = blockIdx.x * (long long)blockDim.y + threadIdx.y;
  if (i >= n_pad) return;
  TX acc = TX(0);
  for (int d = 0; d < o.n; ++d) {
    const long long j = i + o.off[d];
    if (j >= 0 && j < n_pad)
      acc = add_rn(acc, mul_rn((TX)widen(data[d * n_pad + i]), x[j * k + col]));
  }
  y[i * k + col] = acc;
}

static int fill_offsets(DiaOffsets* o, int n_diags, const int* offsets) {
  if (n_diags < 0 || n_diags > TT_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  o->n = n_diags;
  for (int d = 0; d < n_diags; ++d) o->off[d] = offsets[d];
  return 0;
}

template <typename TD, typename TX>
static int launch(const void* data, const void* x, void* y, long long n_pad,
                  int n_diags, const int* offsets, void* stream) {
  DiaOffsets o;
  int rc = fill_offsets(&o, n_diags, offsets);
  if (rc) return rc;
  const int threads = 256;
  const long long blocks = (n_pad + threads - 1) / threads;
  dia_kernel<TD, TX><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const TD*)data, (const TX*)x, (TX*)y, n_pad, o);
  return (int)cudaGetLastError();
}

template <typename TD, typename TX>
static int launch_mv(const void* data, const void* x, void* y, long long n_pad,
                     int k, int n_diags, const int* offsets, void* stream) {
  if (k < 1 || k > TT_MAX_COLS) return (int)cudaErrorInvalidValue;
  DiaOffsets o;
  int rc = fill_offsets(&o, n_diags, offsets);
  if (rc) return rc;
  int rows = 256 / k;  // about 256 threads a block
  if (rows < 1) rows = 1;
  const long long blocks = (n_pad + rows - 1) / rows;
  dia_mv_kernel<TD, TX><<<(unsigned)blocks, dim3(k, rows), 0,
                          (cudaStream_t)stream>>>(
      (const TD*)data, (const TX*)x, (TX*)y, n_pad, k, o);
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmv_f32(const void* data, const void* x, void* y, long long n_pad,
                 int n_diags, const int* offsets, void* stream) {
  return launch<float, float>(data, x, y, n_pad, n_diags, offsets, stream);
}

int dia_spmv_f64(const void* data, const void* x, void* y, long long n_pad,
                 int n_diags, const int* offsets, void* stream) {
  return launch<double, double>(data, x, y, n_pad, n_diags, offsets, stream);
}

int dia_spmv_bf16f32(const void* data, const void* x, void* y,
                     long long n_pad, int n_diags, const int* offsets,
                     void* stream) {
  return launch<__nv_bfloat16, float>(data, x, y, n_pad, n_diags, offsets,
                                      stream);
}

int dia_spmm_f32(const void* data, const void* x, void* y, long long n_pad,
                 int k, int n_diags, const int* offsets, void* stream) {
  return launch_mv<float, float>(data, x, y, n_pad, k, n_diags, offsets,
                                 stream);
}

int dia_spmm_f64(const void* data, const void* x, void* y, long long n_pad,
                 int k, int n_diags, const int* offsets, void* stream) {
  return launch_mv<double, double>(data, x, y, n_pad, k, n_diags, offsets,
                                   stream);
}

int dia_spmm_bf16f32(const void* data, const void* x, void* y,
                     long long n_pad, int k, int n_diags, const int* offsets,
                     void* stream) {
  return launch_mv<__nv_bfloat16, float>(data, x, y, n_pad, k, n_diags,
                                         offsets, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
