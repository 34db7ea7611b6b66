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
// each diagonal once for all k columns. Here a thread owns VW adjacent
// columns of one row and moves them as one load of X and one store of Y:
// 16 bytes (4 × f32, 2 × f64) where k and the pointers allow it, narrower
// otherwise; it reads data[d, i] once for its VW columns. A block is
// (k / VW, rows) threads over `rows` consecutive rows. The host picks VW
// from k and the pointers' alignment and plans the launch (ops/dia_spmv.py
// dia_spmm_plan); each VW is a template instance of the same kernel, and
// the launcher refuses a plan that does not fit the shape, the pointers or
// CUDA's per-axis block limits. The first design, one thread per (row,
// column), issued two 4-byte loads per element and diagonal and read
// 1.1438 ms at level 1; this one reads about 0.55 ms, and neither two
// rows a thread nor an unrolled diagonal loop moved it (PERF.md §6). X is
// re-read once per diagonal from L1/L2: the diagonals come in runs of
// adjacent offsets (one per (dz, dy) of the coarse stencil), so a run's
// re-reads mostly hit L1, but each run's window comes from L2 again. Same
// order, widening and rounding as the single-vector kernel.
#include <cstdint>

#include "tt_common.cuh"

#define TT_MAX_DIAGS 512
#define TT_MAX_COLS 1024

struct DiaOffsets {
  int n;
  int off[TT_MAX_DIAGS];
};

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

template <typename TD, typename TX, int VW>
__global__ void dia_mv_kernel(const TD* __restrict__ data,
                              const TX* __restrict__ x, TX* __restrict__ y,
                              long long n_pad, int k, DiaOffsets o) {
  using V = Vec<TX, VW>;
  const int col = threadIdx.x * VW;
  const long long i = blockIdx.x * (long long)blockDim.y + threadIdx.y;
  if (i >= n_pad) return;
  TX acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = TX(0);
  for (int d = 0; d < o.n; ++d) {
    const long long j = i + o.off[d];
    if (j >= 0 && j < n_pad) {
      const TX dv = (TX)widen(data[d * n_pad + i]);
      const V xv = *reinterpret_cast<const V*>(x + j * k + col);
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = add_rn(acc[v], mul_rn(dv, xv.v[v]));
    }
  }
  V out;
#pragma unroll
  for (int v = 0; v < VW; ++v) out.v[v] = acc[v];
  *reinterpret_cast<V*>(y + i * k + col) = out;
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

// The launch as ops/dia_spmv.py dia_spmm_plan gives it: an int32 array
// [vw, blockDim.x, .y, .z, gridDim.x, .y, .z]. Checked here, so that a
// plan that does not fit the shape, the pointers or CUDA's per-axis limits
// fails the launch.
template <typename TX>
static bool mv_plan_ok(const int* p, const void* x, const void* y,
                       long long n_pad, int k) {
  const int vw = p[0];
  const uintptr_t align = (uintptr_t)vw * sizeof(TX);
  const long long threads = (long long)p[1] * p[2] * p[3];
  return (vw == 1 || vw == 2 || vw * (int)sizeof(TX) == 16) &&
         vw * (int)sizeof(TX) <= 16 && k % vw == 0 && p[1] * vw == k &&
         (uintptr_t)x % align == 0 && (uintptr_t)y % align == 0 &&
         threads >= 1 && threads <= 1024 && p[2] <= 1024 && p[3] == 1 &&
         p[5] == 1 && p[6] == 1 && p[4] >= 1 &&
         (long long)p[4] * p[2] >= n_pad &&
         (long long)(p[4] - 1) * p[2] < n_pad;
}

template <typename TD, typename TX, int VW>
static void launch_mv_vw(const int* plan, const void* data, const void* x,
                         void* y, long long n_pad, int k, const DiaOffsets& o,
                         cudaStream_t s) {
  dia_mv_kernel<TD, TX, VW>
      <<<dim3(plan[4], plan[5], plan[6]), dim3(plan[1], plan[2], plan[3]), 0,
         s>>>((const TD*)data, (const TX*)x, (TX*)y, n_pad, k, o);
}

template <typename TD, typename TX>
static int launch_mv(const void* data, const void* x, void* y, long long n_pad,
                     int k, int n_diags, const int* offsets, const int* plan,
                     void* stream) {
  if (k < 1 || k > TT_MAX_COLS) return (int)cudaErrorInvalidValue;
  if (!mv_plan_ok<TX>(plan, x, y, n_pad, k))
    return (int)cudaErrorInvalidConfiguration;
  DiaOffsets o;
  int rc = fill_offsets(&o, n_diags, offsets);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan[0] == 1)
    launch_mv_vw<TD, TX, 1>(plan, data, x, y, n_pad, k, o, s);
  else if (plan[0] == 2)
    launch_mv_vw<TD, TX, 2>(plan, data, x, y, n_pad, k, o, s);
  else
    launch_mv_vw<TD, TX, 16 / sizeof(TX)>(plan, data, x, y, n_pad, k, o, s);
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
                 int k, int n_diags, const int* offsets, const int* plan,
                 void* stream) {
  return launch_mv<float, float>(data, x, y, n_pad, k, n_diags, offsets,
                                 plan, stream);
}

int dia_spmm_f64(const void* data, const void* x, void* y, long long n_pad,
                 int k, int n_diags, const int* offsets, const int* plan,
                 void* stream) {
  return launch_mv<double, double>(data, x, y, n_pad, k, n_diags, offsets,
                                   plan, stream);
}

int dia_spmm_bf16f32(const void* data, const void* x, void* y,
                     long long n_pad, int k, int n_diags, const int* offsets,
                     const int* plan, void* stream) {
  return launch_mv<__nv_bfloat16, float>(data, x, y, n_pad, k, n_diags,
                                         offsets, plan, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
