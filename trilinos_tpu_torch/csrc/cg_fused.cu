// One single-reduce (Chronopoulos-Gear) CG iteration on a matrix-free
// constant-coefficient stencil in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel cg_fused_iteration (_kernel) of
// trilinos_tpu/ops/pallas/cg_fused.py. State (identity preconditioner):
// x, r, w = A r, p, q = A p and scal = [rz, delta, rz_prev, alpha_prev].
// Every thread forms, with the guards of the TPU kernel,
//   beta  = rz / rz_prev            (0 when rz_prev <= 0)
//   alpha = rz / (delta − beta·rz / alpha_prev)   (0 when that is 0)
// and at its grid point i
//   p' = r + beta·p,  q' = w + beta·q,  x' = x + alpha·p',
//   r' = r − alpha·(w + beta·q),  w' = Σ_t c_t·r'[i + o_t].
// Each in-range neighbour's r' is recomputed from r, w, q there with the
// same formula, so it equals the stored r' bit for bit (the TPU kernel does
// the same over its halo window). The dots r'·r' and r'·w' are summed per
// block in double (warp shuffles, then the block's warps in order) into a
// partials buffer; the last block to finish (__threadfence + an atomic
// ticket, which the launcher zeroes with one memset) sums the partials in a
// fixed order and writes scal' = [rz', delta', rz, alpha]. The result is
// the same from run to run and the iteration is one kernel launch.
//
// Bound on an H100: bytes, 10·n·sizeof(T) (x, r, w, p, q read once, five
// vectors written; 0.200 ms for 256³ f32 at 3.35 TB/s). The r, w, q
// neighbours at ±1, ±nx come through L1, those at ±nx·ny through L2. The
// vector arithmetic uses round-to-nearest operations the compiler may not
// fuse, so the five vectors of one iteration equal the plain PyTorch
// version's (cg_fused_iteration_plain) given the same scal; the dots are
// summed in another order than torch.sum, so scal' agrees to a tolerance.
#include "tt_common.cuh"

#define TT_BX 32  // block: TT_BX × TT_BY grid points of one z-plane
#define TT_BY 8

// Sum of v over the block, every warp's shuffle tree then the warps in
// order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* shared) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) shared[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0)
    for (int w = 0; w < nthreads / 32; ++w) total += shared[w];
  __syncthreads();
  return total;
}

template <typename T>
__global__ void cg_fused_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ p, const T* __restrict__ q,
    const T* __restrict__ scal, T* __restrict__ xo, T* __restrict__ ro,
    T* __restrict__ wo, T* __restrict__ po, T* __restrict__ qo,
    T* __restrict__ scal_out, double* __restrict__ partials,
    unsigned* __restrict__ ticket, int nx, int ny, int nz,
    StencilTerms<T> t) {
  __shared__ double shared[2][32];
  __shared__ bool last;
  const T rz = scal[0], delta = scal[1], rz_prev = scal[2];
  const T alpha_prev = scal[3];
  const T beta = rz_prev > T(0) ? div_rn(rz, rz_prev) : T(0);
  const T denom = sub_rn(delta, div_rn(mul_rn(beta, rz),
                                       alpha_prev != T(0) ? alpha_prev : T(1)));
  const T alpha = denom != T(0) ? div_rn(rz, denom) : T(0);

  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const int iz = blockIdx.z;
  double rr = 0.0, rw = 0.0;
  if (ix < nx && iy < ny) {
    const long long gid = ix + (long long)nx * (iy + (long long)ny * iz);
    const T pn = add_rn(r[gid], mul_rn(beta, p[gid]));
    const T qn = add_rn(w[gid], mul_rn(beta, q[gid]));
    const T rn = sub_rn(r[gid], mul_rn(alpha, qn));
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < TT_MAX_TERMS; ++k) {
      if (k >= t.n) break;
      const unsigned jx = ix + t.dx[k], jy = iy + t.dy[k], jz = iz + t.dz[k];
      if (jx < (unsigned)nx && jy < (unsigned)ny && jz < (unsigned)nz) {
        const long long j = gid + t.lin[k];
        const T rj = sub_rn(r[j], mul_rn(alpha, add_rn(w[j],
                                                       mul_rn(beta, q[j]))));
        acc = add_rn(acc, mul_rn(t.c[k], rj));
      }
    }
    xo[gid] = add_rn(x[gid], mul_rn(alpha, pn));
    ro[gid] = rn;
    wo[gid] = acc;
    po[gid] = pn;
    qo[gid] = qn;
    rr = (double)rn * (double)rn;
    rw = (double)rn * (double)acc;
  }
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const long long nblocks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long bid =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y *
                                                            blockIdx.z);
  rr = block_sum(rr, shared[0]);
  rw = block_sum(rw, shared[1]);
  if (tid == 0) {
    partials[2 * bid] = rr;
    partials[2 * bid + 1] = rw;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partials are visible (each fenced
  // before taking its ticket); read them past L1
  const int nthreads = blockDim.x * blockDim.y;
  double sr = 0.0, sw = 0.0;
  for (long long b = tid; b < nblocks; b += nthreads) {
    sr += __ldcg(partials + 2 * b);
    sw += __ldcg(partials + 2 * b + 1);
  }
  sr = block_sum(sr, shared[0]);
  sw = block_sum(sw, shared[1]);
  if (tid == 0) {
    scal_out[0] = (T)sr;
    scal_out[1] = (T)sw;
    scal_out[2] = rz;
    scal_out[3] = alpha;
  }
}

template <typename T>
static int launch(const void* x, const void* r, const void* w, const void* p,
                  const void* q, const void* scal, void* xo, void* ro,
                  void* wo, void* po, void* qo, void* scal_out, void* work,
                  long long work_len, int nx, int ny, int nz, int n_terms,
                  const int* dx, const int* dy, const int* dz,
                  const long long* lin, const double* coeff, void* stream) {
  const dim3 block(TT_BX, TT_BY, 1);
  const dim3 grid((nx + TT_BX - 1) / TT_BX, (ny + TT_BY - 1) / TT_BY, nz);
  const long long nblocks = (long long)grid.x * grid.y * grid.z;
  // work: 2·nblocks partials, then one double whose first word is the ticket
  if (work_len < 2 * nblocks + 1) return (int)cudaErrorInvalidValue;
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  double* partials = (double*)work;
  unsigned* ticket = (unsigned*)(partials + 2 * nblocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  cg_fused_kernel<T><<<grid, block, 0, s>>>(
      (const T*)x, (const T*)r, (const T*)w, (const T*)p, (const T*)q,
      (const T*)scal, (T*)xo, (T*)ro, (T*)wo, (T*)po, (T*)qo, (T*)scal_out,
      partials, ticket, nx, ny, nz, t);
  return (int)cudaGetLastError();
}

extern "C" {

int cg_fused_f32(const void* x, const void* r, const void* w, const void* p,
                 const void* q, const void* scal, void* xo, void* ro, void* wo,
                 void* po, void* qo, void* scal_out, void* work,
                 long long work_len, int nx, int ny, int nz, int n_terms,
                 const int* dx, const int* dy, const int* dz,
                 const long long* lin, const double* coeff, void* stream) {
  return launch<float>(x, r, w, p, q, scal, xo, ro, wo, po, qo, scal_out,
                       work, work_len, nx, ny, nz, n_terms, dx, dy, dz, lin,
                       coeff, stream);
}

int cg_fused_f64(const void* x, const void* r, const void* w, const void* p,
                 const void* q, const void* scal, void* xo, void* ro, void* wo,
                 void* po, void* qo, void* scal_out, void* work,
                 long long work_len, int nx, int ny, int nz, int n_terms,
                 const int* dx, const int* dy, const int* dz,
                 const long long* lin, const double* coeff, void* stream) {
  return launch<double>(x, r, w, p, q, scal, xo, ro, wo, po, qo, scal_out,
                        work, work_len, nx, ny, nz, n_terms, dx, dy, dz, lin,
                        coeff, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
