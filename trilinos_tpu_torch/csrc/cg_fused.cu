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
//
// Bound on an H100: bytes, 10·n·sizeof(T) (x, r, w, p, q read once, five
// vectors written; 0.200 ms for 256³ f32 at 3.35 TB/s). A design with one
// thread per point recomputes r' at every in-range neighbour from r, w and
// q there: 3 arrays × 6 neighbours per point, the ±nx and ±nx·ny ones from
// L2, about 12 L2 loads per point beyond the 10 vectors, so L2 traffic and
// not HBM bounds it. The TPU kernel instead forms r' once over a halo
// window in VMEM. This kernel does the same in shared memory, as a
// z-marching plane tile:
//
// - A block owns a TILE_X × TILE_Y tile of the xy plane (one thread per
//   point) and the output planes z0 .. z1 − 1 of one z-chunk, and marches
//   along z.
// - Each plane of r, w and q enters a ring of plane tiles in shared memory
//   once, with its rx/ry halo (x and p at the tile's own points), by
//   asynchronous copies (cp.async) that all threads issue as contiguous
//   runs, x fastest, TT_DEPTH planes ahead of the plane the block waits
//   for. The ring holds the 2·rz + 1 planes an output plane reads and the
//   TT_DEPTH in flight; one __syncthreads per plane.
// - The output plane zo is written once plane zo + rz is in the ring: it
//   forms r' = r − alpha·(w + beta·q) at each term's neighbour from the
//   ring, writes the five vectors and sums the stencil.
//
// So r, w and q cross from L2 to the SM about (1 + halo share) times, not
// once per term, and HBM traffic stays the 10 vectors plus the z-chunk's
// 2·rz halo planes of r, w, q. The host plans the geometry
// (ops/cg_fused.py cg_fused_plan) and the launcher checks it; the radii are
// the operator's largest |offset| along each axis. Tiles at the grid faces
// mask the ragged edge when a plane enters the ring: a halo point or a
// plane outside the grid (found from its coordinates, with no integer
// division) is filled with +0, so its r' is +0 and a term reading it adds
// c·(+0) = ±0, which leaves every sum as the plain version's masked sum
// leaves it (a sum of round-to-nearest adds that starts at +0 is never
// −0). The terms then need no per-point masks, and each term's place in a
// ring plane is one offset computed on the host (TileTerms), so nothing
// per term stays live in registers across the march.
//
// Every neighbour's r' is formed with the expression of the stored r', and
// the vector arithmetic uses round-to-nearest operations the compiler may
// not fuse, so the five vectors of one iteration equal the plain PyTorch
// version's (cg_fused_iteration_plain) bit for bit given the same scal.
// The dots r'·r' and r'·w' are summed per thread over its planes and then
// per block in double (warp shuffles, then the block's warps in order) into
// a partials buffer; the last block to finish (__threadfence + an atomic
// ticket, which the launcher zeroes with one memset) sums the partials in a
// fixed order and writes scal' = [rz', delta', rz, alpha]. The result is
// the same from run to run and the iteration is one kernel launch; scal'
// agrees with torch.sum's to a tolerance.
#include <cuda_pipeline.h>

#include "tt_common.cuh"

// The tile and the planes in flight; ops/cg_fused.py plans with the same
// TILE_X, TILE_Y and DEPTH (a CPU test reads them from here).
#define TT_TILE_X 32
#define TT_TILE_Y 8
#define TT_CG_THREADS (TT_TILE_X * TT_TILE_Y)
#define TT_CG_BLOCKS 4  // blocks an SM holds: at most 64 registers a thread
#define TT_DEPTH 2  // planes in flight ahead of the one the block waits for

// What the host chooses, as ops/cg_fused.py TilePlan passes it: an int32
// array with the fields in this order.
struct TilePlan {
  int zc;          // output planes of a z-chunk
  int rx, ry, rz;  // the stencil's radius along each axis
  int smem;        // dynamic shared memory, bytes
  int grid[3];     // gridDim
};

static TilePlan read_plan(const int* f) {
  TilePlan p;
  p.zc = f[0]; p.rx = f[1]; p.ry = f[2]; p.rz = f[3]; p.smem = f[4];
  for (int i = 0; i < 3; ++i) p.grid[i] = f[5 + i];
  return p;
}

__host__ __device__ __forceinline__ int halo_x(const TilePlan& p) {
  return TT_TILE_X + 2 * p.rx;
}
__host__ __device__ __forceinline__ int halo_y(const TilePlan& p) {
  return TT_TILE_Y + 2 * p.ry;
}
__host__ __device__ __forceinline__ int ring_slots(const TilePlan& p) {
  return 2 * p.rz + 1 + TT_DEPTH;
}

// The stencil's terms as the kernel reads them: each term's plane (dz) and
// its place in a ring plane relative to the output point. Passed by value:
// constant-bank operands.
template <typename T>
struct TileTerms {
  int n;
  int dz[TT_MAX_TERMS];
  int off[TT_MAX_TERMS];
  T c[TT_MAX_TERMS];
};

template <typename T>
static TileTerms<T> tile_terms(const StencilTerms<T>& t, const TilePlan& p) {
  TileTerms<T> tt;
  tt.n = t.n;
  for (int k = 0; k < t.n; ++k) {
    tt.dz[k] = t.dz[k];
    tt.off[k] = t.dy[k] * halo_x(p) + t.dx[k];
    tt.c[k] = t.c[k];
  }
  return tt;
}

// The slot of plane (centre + dz), −slots ≤ dz < slots, from the centre's.
__device__ __forceinline__ int ring_at(int centre, int dz, int slots) {
  int s = centre + dz;
  if (s < 0) s += slots;
  else if (s >= slots) s -= slots;
  return s;
}

// Start an asynchronous copy of one value from device memory into shared
// memory, or fill it with zeros where `in` is false (nothing is read then).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool in) {
  __pipeline_memcpy_async(dst, src, sizeof(T), in ? 0 : sizeof(T));
}

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

// Block (tx, ty): thread (lx, ly) owns point (x0 + lx, y0 + ly) of every
// output plane. Shared memory, per ring slot: the halo tiles of r, w and q,
// then x and p at the tile's points.
template <typename T>
__global__ void __launch_bounds__(TT_CG_THREADS, TT_CG_BLOCKS)
    cg_fused_kernel(const T* __restrict__ x, const T* __restrict__ r,
                    const T* __restrict__ w, const T* __restrict__ p,
                    const T* __restrict__ q, const T* __restrict__ scal,
                    T* __restrict__ xo, T* __restrict__ ro,
                    T* __restrict__ wo, T* __restrict__ po,
                    T* __restrict__ qo, T* __restrict__ scal_out,
                    double* __restrict__ partials,
                    unsigned* __restrict__ ticket, int nx, int ny, int nz,
                    TilePlan tp, TileTerms<T> t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double shared[2][32];
  __shared__ bool last;
  // the tile's width and height (TT_TILE_X, TT_TILE_Y) read at run time:
  // folded as constants, the f32 instance spilled and ran 10% slower
  const int tx = blockDim.x, ty = blockDim.y;
  const int hxn = tx + 2 * tp.rx, hyn = ty + 2 * tp.ry;
  const int slots = ring_slots(tp);
  const int plane = hxn * hyn, tile = tx * ty;
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* ws = rs + slots * plane;
  T* qs = ws + slots * plane;
  T* xs = qs + slots * plane;
  T* ps = xs + slots * tile;
  const T rz = scal[0], delta = scal[1], rz_prev = scal[2];
  const T alpha_prev = scal[3];
  const T beta = rz_prev > T(0) ? div_rn(rz, rz_prev) : T(0);
  const T denom = sub_rn(delta, div_rn(mul_rn(beta, rz),
                                       alpha_prev != T(0) ? alpha_prev : T(1)));
  const T alpha = denom != T(0) ? div_rn(rz, denom) : T(0);

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const int z0 = blockIdx.z * tp.zc;
  const int z1 = min(z0 + tp.zc, nz);
  const int ix = x0 + lx, iy = y0 + ly;
  const bool own = ix < nx && iy < ny;
  const int own_at = ly * tx + lx;
  const int here = (ly + tp.ry) * hxn + lx + tp.rx;  // in a ring plane
  const long long plane_n = (long long)nx * ny;

  // Start the copies of plane zn into ring slot `slot` (+0 outside the
  // grid) and of x, p at the tile's points of output plane zn − rz.
  auto issue = [&](int zn, int slot) {
    const bool z_in = zn >= 0 && zn < nz;
    const int base = slot * plane;
    for (int hy = ly; hy < hyn; hy += ty)
      for (int hx = lx; hx < hxn; hx += tx) {
        const unsigned gx = x0 - tp.rx + hx, gy = y0 - tp.ry + hy;
        const bool in = z_in && gx < (unsigned)nx && gy < (unsigned)ny;
        const long long j = in ? gx + nx * (long long)gy + plane_n * zn : 0;
        const int e = base + hy * hxn + hx;
        copy_async(rs + e, r + j, in);
        copy_async(ws + e, w + j, in);
        copy_async(qs + e, q + j, in);
      }
    const int zo = zn - tp.rz;
    if (own && zo >= z0 && zo < z1) {
      const long long gid = ix + nx * (long long)iy + plane_n * zo;
      const int at = ring_at(slot, -tp.rz, slots) * tile + own_at;
      copy_async(xs + at, x + gid, true);
      copy_async(ps + at, p + gid, true);
    }
  };

  // The march: planes z0 − rz .. z1 + rz − 1 enter the ring in order, plane
  // zl into slot (zl − z0 + rz) mod slots. Every thread commits one copy
  // group per plane, empty or not, so "all but the newest TT_DEPTH − 1
  // groups have landed" means "plane zl has landed".
  double rr = 0.0, rw = 0.0;
  const int z_end = z1 + tp.rz;  // one past the last plane to load
#pragma unroll
  for (int d = 0; d < TT_DEPTH; ++d) {
    if (z0 - tp.rz + d < z_end) issue(z0 - tp.rz + d, d);
    __pipeline_commit();
  }
  int slot = 0;  // the slot of plane zl
  for (int zl = z0 - tp.rz; zl < z_end; ++zl) {
    __pipeline_wait_prior(TT_DEPTH - 1);
    __syncthreads();  // plane zl is in; every thread is past output zl-1-rz
    // plane zl + TT_DEPTH goes where plane zl − 2·rz − 1 was, which output
    // plane zl − 1 − rz read last
    if (zl + TT_DEPTH < z_end)
      issue(zl + TT_DEPTH, ring_at(slot, TT_DEPTH - slots, slots));
    __pipeline_commit();
    const int zo = zl - tp.rz;
    if (zo < z0 || !own) {
      slot = slot + 1 == slots ? 0 : slot + 1;
      continue;
    }
    const int centre = ring_at(slot, -tp.rz, slots);
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < TT_MAX_TERMS; ++k) {
      if (k >= t.n) break;
      // r' at the neighbour, by the expression of the stored r'
      const int e = here + t.off[k] + ring_at(centre, t.dz[k], slots) * plane;
      const T rj = sub_rn(rs[e], mul_rn(alpha, add_rn(ws[e],
                                                      mul_rn(beta, qs[e]))));
      acc = add_rn(acc, mul_rn(t.c[k], rj));
    }
    const int e = here + centre * plane;
    const int at = centre * tile + own_at;
    const T qn = add_rn(ws[e], mul_rn(beta, qs[e]));
    const T rn = sub_rn(rs[e], mul_rn(alpha, qn));
    const T pn = add_rn(rs[e], mul_rn(beta, ps[at]));
    const long long gid = ix + nx * (long long)iy + plane_n * zo;
    xo[gid] = add_rn(xs[at], mul_rn(alpha, pn));
    ro[gid] = rn;
    wo[gid] = acc;
    po[gid] = pn;
    qo[gid] = qn;
    rr += (double)rn * (double)rn;
    rw += (double)rn * (double)acc;
    slot = slot + 1 == slots ? 0 : slot + 1;
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

// The plan must be the one ops/cg_fused.py cg_fused_plan makes: a grid of
// tiles and z-chunks that covers the grid points, the ring's bytes.
template <typename T>
static bool plan_ok(const TilePlan& p, int nx, int ny, int nz) {
  const long long bytes =
      (3LL * halo_x(p) * halo_y(p) + 2LL * TT_CG_THREADS) * ring_slots(p) *
      (long long)sizeof(T);
  return p.zc >= 1 && p.rx >= 0 && p.ry >= 0 && p.rz >= 0 &&
         bytes == p.smem && p.smem <= 232448 && p.grid[1] <= 65535 &&
         p.grid[2] <= 65535 && (long long)p.grid[0] * TT_TILE_X >= nx &&
         (long long)p.grid[1] * TT_TILE_Y >= ny &&
         (long long)p.grid[2] * p.zc >= nz;
}

template <typename T>
static int launch(const void* x, const void* r, const void* w, const void* p,
                  const void* q, const void* scal, void* xo, void* ro,
                  void* wo, void* po, void* qo, void* scal_out, void* work,
                  long long work_len, int nx, int ny, int nz, int n_terms,
                  const int* dx, const int* dy, const int* dz,
                  const long long* lin, const double* coeff, const int* plan,
                  void* stream) {
  const TilePlan tp = read_plan(plan);
  if (!plan_ok<T>(tp, nx, ny, nz)) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(TT_TILE_X, TT_TILE_Y, 1);
  const dim3 grid(tp.grid[0], tp.grid[1], tp.grid[2]);
  const long long nblocks = (long long)grid.x * grid.y * grid.z;
  // work: 2·nblocks partials, then one double whose first word is the ticket
  if (work_len < 2 * nblocks + 1) return (int)cudaErrorInvalidValue;
  StencilTerms<T> st;
  int rc = fill_terms(&st, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  const TileTerms<T> t = tile_terms(st, tp);
  cudaStream_t s = (cudaStream_t)stream;
  double* partials = (double*)work;
  unsigned* ticket = (unsigned*)(partials + 2 * nblocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  // dynamic shared memory above 48 KB (with the static) needs the
  // attribute, which is the current device's: set it on every launch
  err = cudaFuncSetAttribute(cg_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tp.smem);
  if (err != cudaSuccess) return (int)err;
  cg_fused_kernel<T><<<grid, block, tp.smem, s>>>(
      (const T*)x, (const T*)r, (const T*)w, (const T*)p, (const T*)q,
      (const T*)scal, (T*)xo, (T*)ro, (T*)wo, (T*)po, (T*)qo, (T*)scal_out,
      partials, ticket, nx, ny, nz, tp, t);
  return (int)cudaGetLastError();
}

extern "C" {

int cg_fused_f32(const void* x, const void* r, const void* w, const void* p,
                 const void* q, const void* scal, void* xo, void* ro, void* wo,
                 void* po, void* qo, void* scal_out, void* work,
                 long long work_len, int nx, int ny, int nz, int n_terms,
                 const int* dx, const int* dy, const int* dz,
                 const long long* lin, const double* coeff, const int* plan,
                 void* stream) {
  return launch<float>(x, r, w, p, q, scal, xo, ro, wo, po, qo, scal_out,
                       work, work_len, nx, ny, nz, n_terms, dx, dy, dz, lin,
                       coeff, plan, stream);
}

int cg_fused_f64(const void* x, const void* r, const void* w, const void* p,
                 const void* q, const void* scal, void* xo, void* ro, void* wo,
                 void* po, void* qo, void* scal_out, void* work,
                 long long work_len, int nx, int ny, int nz, int n_terms,
                 const int* dx, const int* dy, const int* dz,
                 const long long* lin, const double* coeff, const int* plan,
                 void* stream) {
  return launch<double>(x, r, w, p, q, scal, xo, ro, wo, po, qo, scal_out,
                        work, work_len, nx, ny, nz, n_terms, dx, dy, dz, lin,
                        coeff, plan, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
