// Block-DIA (block-stencil) apply for Hopper (sm_90a):
//
//   y[q, i, m] = Σ_d Σ_j data[d, i, j, q] · x[q + off_d, j, m]
//
// for a BdiaMatrix with b ≤ 8 dofs per block row, nd ≤ TT_BDIA_MAX_OFFSETS
// block offsets, nbr padded block rows and k right-hand sides. Replaces the
// TPU kernel bdia_spmm_packed (_kernel) of trilinos_tpu/ops/pallas/bdia_spmv.py
// and its wrappers bdia_spmm_pallas, bdia_spmv_pallas and the plane-layout
// op of bdia_plane_solver_op.
//
// Layouts. x and y are read and written through element strides
// (s_q, s_j, s_m) of block row q, component j and column m, so one kernel
// serves both layouts of the JAX package: interleaved (n_pad,) or
// (n_pad, k) row-major, strides (b·k, k, 1), and packed planes
// (b·k, nbr), plane p = j·k + m, strides (1, k·nbr, nbr). The TPU kernel
// needed the planes (its de-interleave cost more than the apply); here the
// interleaved apply reads x in place.
//
// Bound on an H100: bytes, (nd·b²·sizeof(data) + 2·b·k·sizeof(x))·nbr.
// Threads: one per (q, i, m) and offset slice s, q fastest within a warp, so
// each data[d, i, j, :] read is coalesced. The S slices of a block split the
// offsets (slice s takes d = s, s + S, ...) and are summed in slice order
// through shared memory; the host picks S so that the small coarse levels
// (nbr·b of about 10⁴) still fill the card. Terms whose block row q + off_d
// lies outside [0, nbr) are skipped: their data is zero, and x is not read
// there.
//
// Types: f32 data and x, f64 data and x, bf16 data with f32 x. Sums in f32
// (f64 for f64), in offset order within a slice; the plain PyTorch version
// sums in another order, so the two agree to rounding, not to the bit.
#include "tt_common.cuh"

#define TT_BDIA_MAX_OFFSETS 512
#define TT_BDIA_MAX_B 8
#define TT_BDIA_THREADS 256

struct BdiaOffsets {
  int n;
  int off[TT_BDIA_MAX_OFFSETS];
};

template <int B, typename TD, typename TX>
__global__ void bdia_kernel(const TD* __restrict__ data,
                            const TX* __restrict__ x, TX* __restrict__ y,
                            long long nbr, long long s_q, long long s_j,
                            long long s_m, BdiaOffsets o) {
  extern __shared__ unsigned char smem[];
  TX* part = reinterpret_cast<TX*>(smem);  // [S][blockDim.x]
  const int slices = blockDim.y;
  const int s = threadIdx.y;
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int i = blockIdx.y % B;
  const int m = blockIdx.y / B;
  TX acc = TX(0);
  if (q < nbr) {
    const TX* xm = x + m * s_m;
    for (int d = s; d < o.n; d += slices) {
      const long long qq = q + o.off[d];
      if (qq < 0 || qq >= nbr) continue;
      const TD* dp = data + ((long long)(d * B + i) * B) * nbr + q;
      const TX* xp = xm + qq * s_q;
#pragma unroll
      for (int j = 0; j < B; ++j)
        acc += (TX)widen(dp[j * nbr]) * xp[j * s_j];
    }
  }
  if (slices == 1) {
    if (q < nbr) y[q * s_q + i * s_j + m * s_m] = acc;
    return;
  }
  part[s * blockDim.x + threadIdx.x] = acc;
  __syncthreads();
  if (s == 0 && q < nbr) {
    TX sum = part[threadIdx.x];
    for (int t = 1; t < slices; ++t) sum += part[t * blockDim.x + threadIdx.x];
    y[q * s_q + i * s_j + m * s_m] = sum;
  }
}

// Slices per block: the fewest (a power of two ≤ 32 and ≤ nd) that give
// the card about 2¹⁸ threads.
static int pick_slices(long long work, int nd) {
  int s = 1;
  while (s < 32 && s * 2 <= nd && work * s < (1LL << 18)) s *= 2;
  return s;
}

template <int B, typename TD, typename TX>
static int launch_b(const void* data, const void* x, void* y, long long nbr,
                    int k, long long s_q, long long s_j, long long s_m,
                    const BdiaOffsets& o, void* stream) {
  const int slices = pick_slices(nbr * B * (long long)k, o.n);
  // at least a warp along q, so that every data read stays coalesced
  const int tq = slices >= 8 ? 32 : TT_BDIA_THREADS / slices;
  const dim3 block(tq, slices);
  const dim3 grid((unsigned)((nbr + tq - 1) / tq), (unsigned)(B * k));
  const size_t shared = slices > 1 ? sizeof(TX) * tq * slices : 0;
  bdia_kernel<B, TD, TX><<<grid, block, shared, (cudaStream_t)stream>>>(
      (const TD*)data, (const TX*)x, (TX*)y, nbr, s_q, s_j, s_m, o);
  return (int)cudaGetLastError();
}

template <typename TD, typename TX>
static int launch(const void* data, const void* x, void* y, long long nbr,
                  int b, int k, long long s_q, long long s_j, long long s_m,
                  int nd, const int* offsets, void* stream) {
  if (b < 1 || b > TT_BDIA_MAX_B || nd < 0 || nd > TT_BDIA_MAX_OFFSETS ||
      k < 1 || k > 65535 / b || nbr < 0)
    return (int)cudaErrorInvalidValue;
  if (nbr == 0) return 0;
  BdiaOffsets o;
  o.n = nd;
  for (int d = 0; d < nd; ++d) o.off[d] = offsets[d];
  switch (b) {
#define TT_BDIA_CASE(BB)                                                    \
  case BB:                                                                  \
    return launch_b<BB, TD, TX>(data, x, y, nbr, k, s_q, s_j, s_m, o, stream);
    TT_BDIA_CASE(1)
    TT_BDIA_CASE(2)
    TT_BDIA_CASE(3)
    TT_BDIA_CASE(4)
    TT_BDIA_CASE(5)
    TT_BDIA_CASE(6)
    TT_BDIA_CASE(7)
    TT_BDIA_CASE(8)
#undef TT_BDIA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

#define TT_BDIA_ENTRY(NAME, TD, TX)                                           \
  int NAME(const void* data, const void* x, void* y, long long nbr, int b,   \
           int k, long long s_q, long long s_j, long long s_m, int nd,       \
           const int* offsets, void* stream) {                               \
    return launch<TD, TX>(data, x, y, nbr, b, k, s_q, s_j, s_m, nd, offsets, \
                          stream);                                           \
  }

TT_BDIA_ENTRY(bdia_spmm_f32, float, float)
TT_BDIA_ENTRY(bdia_spmm_f64, double, double)
TT_BDIA_ENTRY(bdia_spmm_bf16f32, __nv_bfloat16, float)
#undef TT_BDIA_ENTRY

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
