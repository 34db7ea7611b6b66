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
// stage) is far below the card's rate. The TPU kernel keeps the
// intermediates in VMEM with a wavefront over row strips. This kernel
// does the same in shared memory, blocking in time along z on the
// z-marching ring of cg_fused.cu: one launch computes every stage, reads
// x once and writes only the outputs.
//
// - A block owns a tx × ty tile of the xy plane and the output planes
//   z0 .. z1 − 1 of one z-chunk, and marches along z. Its 8 warps walk each
//   stage's region row by row, 32 columns at a time, four points a thread
//   in flight.
// - Overlapped tiling: stage m works on the tile grown by reach[m] times
//   the radii (rx, ry), reach[m] being the number of alpha != 0 stages
//   after it in the launch, so every neighbour a later stage reads was
//   computed by this block. That redundant halo work is the price
//   (1.11× for the Chebyshev smoother, 1.19× for the s-step basis at
//   256³ f32, PERF.md §6).
// - The wavefront: stage m runs rz·(reach[0] − reach[m]) planes behind
//   the input, i.e. rz more behind for each earlier alpha != 0 stage, so
//   the planes it reads of stage m − 1 are computed by the time it needs
//   them. A stage with alpha == 0 (Chebyshev stage 1) reads no neighbours
//   and adds no reach and no lag.
// - Ring m (m = 0: the launch's input; m >= 1: stage m's output) holds
//   slots[m] plane tiles: the planes a later stage still reads (stage
//   m + 1's neighbours, stage m + 2's gamma term and, on x, each stage's
//   zeta term). The input enters its ring by asynchronous copies
//   (cp.async), TT_POLY_DEPTH planes ahead, with the full halo; the last
//   stage keeps no ring. One __syncthreads per plane and one between
//   stages. Every plane has rows of the input region's width, which the
//   host makes a whole number of warps (64 columns on the main paths).
// - The time goes to instructions, not bytes: each stage point is a few
//   shared-memory loads and their address arithmetic. So the point loop
//   is specialised on the stage's flags (no branch), the terms are
//   padded to a compile-time count (their places and coefficients are
//   registers), and for Galeri's 7-point cross, the stencil of the main
//   paths, the terms' places are compile-time offsets on 64-column rows.
// The host plans the geometry (ops/stencil_poly.py stencil_poly_plan:
// tile, z-chunk, reach, ring slots, shared bytes, grid) and cuts the chain
// into consecutive launches where all s stages do not fit one block's
// shared memory; a later launch reads its input u_first and, for its first
// stage's gamma term, u_{first−1} from device memory. The launcher checks
// the plan against its own reckoning of the same geometry.
//
// Each stage is bitwise the plain PyTorch version's (stencil_poly_plain):
// terms summed in offset order, a term or stage coefficient of exactly 0.0
// (tested in double, as the host code tests the Python float) skipped,
// every coefficient rounded to T once, the parts added in the order alpha,
// beta, gamma, zeta, with round-to-nearest operations the compiler may not
// fuse. Out-of-grid halo points hold +0 (the copy fills the input's; a
// stage stores +0 there), so a term reading one adds c·(±0), which leaves
// a round-to-nearest sum that started at +0 unchanged. Planes outside
// z_bounds (z_lo, z_hi) are not zero-filled: under the semantics of the
// JAX package's XLA reference (_spmv_xla_zb), which the port follows, a
// neighbour counts when its plane iz + dz lies in [z_lo, z_hi), while the
// row's own u_{j−1}, u_{j−2} and x are read as they are. So each stage
// masks its neighbour terms by one flag per term and plane. (The Pallas
// kernel masks only the terms with dz != 0, so the two differ on rows
// whose own plane lies outside [z_lo, z_hi).) Pad rows (gid >= n) carry x
// through every stage: one device copy of x's pad rows into each output.
#include <cuda_pipeline.h>

#include <algorithm>
#include <cstdlib>

#include "tt_common.cuh"

#define TT_MAX_STAGES 8
#define TT_POLY_THREADS 256
#define TT_POLY_DEPTH 2  // input planes in flight ahead of the one awaited

enum { HAS_ALPHA = 1, HAS_BETA = 2, HAS_GAMMA = 4, HAS_ZETA = 8 };

// What the host chooses, as ops/stencil_poly.py PolyPlan.fields passes it:
// an int32 array with the fields in this order.
struct PolyPlan {
  int tx, ty;      // the output tile
  int zc;          // output planes of a z-chunk
  int rx, ry, rz;  // the stencil's radius along each axis
  int threads;     // a block
  int smem;        // dynamic shared memory, bytes
  int grid[3];
  int first;       // stages before this launch
  int count;       // stages in this launch
  int slots[TT_MAX_STAGES];  // ring m's plane tiles, m < count
};

static PolyPlan read_plan(const int* f) {
  PolyPlan p;
  p.tx = f[0]; p.ty = f[1]; p.zc = f[2];
  p.rx = f[3]; p.ry = f[4]; p.rz = f[5];
  p.threads = f[6]; p.smem = f[7];
  for (int i = 0; i < 3; ++i) p.grid[i] = f[8 + i];
  p.first = f[11]; p.count = f[12];
  for (int m = 0; m < TT_MAX_STAGES; ++m) p.slots[m] = f[13 + m];
  return p;
}

// What the kernel reads, by value (constant-bank operands). Index m runs
// over rings and stages: ring m is the input (m = 0) or stage m's output;
// the stage arrays are indexed by stage m − 1. Every ring plane and the
// zero plane have rows of `pitch` = w[0] elements (region 0's width; the
// regions of later stages are narrower), so a term's place in a plane is
// dy·pitch + dx whatever the ring.
template <typename T>
struct PolyArgs {
  int tx, ty, zc, rx, ry, rz, pitch;
  int count, n_terms, z_lo, z_hi, from_x;  // from_x: the input is x
  int reach[TT_MAX_STAGES + 1];
  int w[TT_MAX_STAGES + 1], h[TT_MAX_STAGES + 1];  // region m's extent
  int slots[TT_MAX_STAGES], base[TT_MAX_STAGES];   // ring m in shared mem
  int zero;  // the zero plane (pitch × h[0]) in shared memory
  int flags[TT_MAX_STAGES];
  T coef[TT_MAX_STAGES][4];  // alpha, beta, gamma, zeta
  int dz[TT_MAX_TERMS];
  int off[TT_MAX_TERMS];  // term k in a ring plane: dy·pitch + dx
  T c[TT_MAX_TERMS];
  T* out[TT_MAX_STAGES];  // stage m's output in device memory, or null
};

// The slot of plane (centre + d), −slots < d < slots, from the centre's.
__device__ __forceinline__ int ring_at(int centre, int d, int slots) {
  int s = centre + d;
  if (s < 0) s += slots;
  else if (s >= slots) s -= slots;
  return s;
}

// The Galeri 7-point cross in its own term order (galeri/stencils.py
// cross3d_stencil): centre, −x, +x, −y, +y, −z, +z. For it the kernel
// takes each term's place from compile-time offsets on rows of
// TT_CROSS_PITCH elements.
#define TT_CROSS_PITCH 64
__host__ __device__ constexpr int cross_dx(int k) {
  return k == 1 ? -1 : k == 2 ? 1 : 0;
}
__host__ __device__ constexpr int cross_dy(int k) {
  return k == 3 ? -1 : k == 4 ? 1 : 0;
}
__host__ __device__ constexpr int cross_dz(int k) {
  return k == 5 ? -1 : k == 6 ? 1 : 0;
}

// One stage on one plane, as the block's threads see it: where its reads
// and writes lie in shared memory and device memory. Built per stage and
// plane from the kernel's arguments; held in registers. Shared-memory
// places are bytes from the start of the dynamic shared memory.
template <typename T, int NT>
struct StagePlane {
  char* sm;         // shared memory
  int toff[NT];     // term k from the point's place (generic instances)
  int zoff[3];      // plane p + dz of ring m − 1, dz = −1, 0, 1, or the
                    // zero plane where masked (the cross instance)
  T cs[NT];         // term k's coefficient (0 for a pad term)
  T alpha, beta, gamma, zeta;
  int flags;        // read at run time by the generic instance
  int w, hgt;       // region m's extent
  int beta_at;      // ring m − 1 at plane p
  int g_at;         // gamma's ring at plane p, or −1: device memory
  int x_at;         // zeta's ring at plane p, or −1: device memory
  int ring;         // ring m's plane, or −1
  T* out;           // stage m's output, or null off the own planes
  int ox, oy, ix0, iy0, tx, ty;  // region m's origin; the tile inside it
  long long plane;  // first element of plane p in device memory
};

// Stage points of the rows of region m that thread (lane, row) owns: RW
// rows (`rows` apart) × PTS columns (32 apart) in flight, every load of
// them before any store. F is the stage's flags, so that the point loop
// has no branch, or −1 for the instance that reads them at run time (a
// later launch of a split chain: gamma's u_{first−1} and zeta's x come
// from device memory there). PITCH is the rows' pitch, or 0 for one read
// at run time; CROSS takes the terms of the 7-point cross as immediates.
template <int F, bool CROSS, int PITCH, typename T, int NT, int PTS, int RW>
__device__ __forceinline__ void stage_rows(const StagePlane<T, NT>& s,
                                           int pitch_rt,
                                           const T* __restrict__ prev2,
                                           const T* __restrict__ x,
                                           int lane, int row, int rows,
                                           int nx, int ny) {
  const int flags = F >= 0 ? F : s.flags;
  const int pitch = PITCH > 0 ? PITCH : pitch_rt;
  constexpr int B = (int)sizeof(T);
  for (int hy0 = row; hy0 < s.hgt; hy0 += RW * rows) {
    for (int c0 = 0; c0 < s.w; c0 += 32 * PTS) {
      T acc[RW][PTS];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        // rows past the region's end repeat its last row; not stored
        const int hy = min(hy0 + r * rows, s.hgt - 1);
        const unsigned gy = s.oy + hy;
        const bool in_y = gy < (unsigned)ny;
        const long long grow = s.plane + nx * (long long)gy;
#pragma unroll
        for (int u = 0; u < PTS; ++u) {
          // lanes past the row's end repeat its last point; not stored
          const int hx = min(c0 + 32 * u + lane, s.w - 1);
          const unsigned gx = s.ox + hx;
          const bool in = in_y && gx < (unsigned)nx;
          const int at = (hy * pitch + hx) * B;
          const char* pt = s.sm + at;
          T v = T(0);
          if (flags & HAS_ALPHA) {
            if constexpr (CROSS) {
#pragma unroll
              for (int k = 0; k < 7; ++k)
                v = add_rn(v, mul_rn(s.cs[k], *reinterpret_cast<const T*>(
                                                  pt + s.zoff[cross_dz(k) + 1] +
                                                  (cross_dy(k) * PITCH +
                                                   cross_dx(k)) * B)));
            } else {
#pragma unroll
              for (int k = 0; k < NT; ++k)
                v = add_rn(v, mul_rn(s.cs[k], *reinterpret_cast<const T*>(
                                                  pt + s.toff[k])));
            }
            v = mul_rn(s.alpha, v);
          }
          if (flags & HAS_BETA)
            v = add_rn(v, mul_rn(s.beta, *reinterpret_cast<const T*>(
                                             pt + s.beta_at)));
          if (flags & HAS_GAMMA)
            v = add_rn(v, mul_rn(s.gamma,
                                 F >= 0 || s.g_at >= 0
                                     ? *reinterpret_cast<const T*>(pt +
                                                                   s.g_at)
                                     : in ? prev2[grow + gx] : T(0)));
          if (flags & HAS_ZETA)
            v = add_rn(v, mul_rn(s.zeta,
                                 F >= 0 || s.x_at >= 0
                                     ? *reinterpret_cast<const T*>(pt +
                                                                   s.x_at)
                                     : in ? x[grow + gx] : T(0)));
          acc[r][u] = in ? v : T(0);
        }
      }
      // ring m: every point of the region; out: the tile's own points
      if (s.ring >= 0) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int hy = hy0 + r * rows;
          if (hy >= s.hgt) break;
          T* ring_row = reinterpret_cast<T*>(s.sm + s.ring) + hy * pitch;
#pragma unroll
          for (int u = 0; u < PTS; ++u) {
            const int hx = c0 + 32 * u + lane;
            if (hx >= s.w) break;
            ring_row[hx] = acc[r][u];
          }
        }
      }
      if (s.out) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int hy = hy0 + r * rows;
          if (hy >= s.hgt) break;
          if ((unsigned)(hy - s.iy0) >= (unsigned)s.ty || s.oy + hy >= ny)
            continue;
          T* out_row = s.out + s.plane + nx * (long long)(s.oy + hy) + s.ox;
#pragma unroll
          for (int u = 0; u < PTS; ++u) {
            const int hx = c0 + 32 * u + lane;
            if (hx >= s.w) break;
            if ((unsigned)(hx - s.ix0) < (unsigned)s.tx && s.ox + hx < nx)
              out_row[hx] = acc[r][u];
          }
        }
      }
    }
  }
}

// Block (32, TT_POLY_THREADS / 32). The stencil's terms are padded to NT
// (a compile-time count, so each term's place in shared memory and its
// coefficient are registers and the term loop has no branch): a pad term
// has coefficient 0 and reads the zero plane, adding +0 to a sum that is
// never −0, which leaves it unchanged. A thread keeps RW × PTS points in
// flight, so their loads overlap. CROSS: the 7-point cross on rows of
// TT_CROSS_PITCH elements, its terms' places compile-time offsets.
template <typename T, int NT, int PTS, int RW, bool CROSS>
__global__ void __launch_bounds__(TT_POLY_THREADS)
    poly_kernel(const T* __restrict__ src, const T* __restrict__ prev2,
                const T* __restrict__ x, int nx, int ny, int nz,
                PolyArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x, row = threadIdx.y, rows = blockDim.y;
  const int tid = lane + 32 * row, nthr = 32 * rows;
  const int x0 = blockIdx.x * a.tx, y0 = blockIdx.y * a.ty;
  const int z0 = blockIdx.z * a.zc;
  const int z1 = min(z0 + a.zc, nz);
  const long long plane_n = (long long)nx * ny;
  const int n_terms = a.n_terms;
  const int pitch = a.pitch;
  // the input ring: region 0, its first input plane and one past the last
  const int w0 = a.w[0], np0 = pitch * a.h[0], slots0 = a.slots[0];
  const int base0 = a.base[0];
  const int ox0 = x0 - a.reach[0] * a.rx, oy0 = y0 - a.reach[0] * a.ry;
  const int zs = z0 - a.rz * a.reach[0];
  const int ze = z1 + a.rz * a.reach[0];
  // a masked neighbour term reads the zero plane: c·(+0) adds nothing
  for (int e = tid; e < np0; e += nthr) sm[a.zero + e] = T(0);

  // Start the copies of input plane zn into its slot: the region of ring
  // 0 (w0 = pitch columns), +0 outside the grid. Thread t takes points t,
  // t + nthr, ... in order, x fastest.
  const int sy0 = nthr / w0, sx0 = nthr - sy0 * w0;
  const int ty0 = tid / w0, tx0 = tid - ty0 * w0;
  auto issue = [&](int zn) {
    const bool z_in = zn >= 0 && zn < nz;
    T* dst = sm + base0 + ((zn - zs) % slots0) * np0;
    int hy = ty0, hx = tx0;
    for (int e = tid; e < np0; e += nthr) {
      const unsigned gx = ox0 + hx, gy = oy0 + hy;
      const bool in = z_in && gx < (unsigned)nx && gy < (unsigned)ny;
      const long long j = in ? gx + nx * (long long)gy + plane_n * zn : 0;
      __pipeline_memcpy_async(dst + e, src + j, sizeof(T),
                              in ? 0 : sizeof(T));
      hx += sx0;
      hy += sy0;
      if (hx >= w0) {
        hx -= w0;
        ++hy;
      }
    }
  };

  // The march: input planes zs .. ze − 1 enter ring 0 in order; at step zl
  // stage m computes plane zl − rz·(reach[0] − reach[m]) where that plane
  // is one of its own (its z-chunk grown by rz·reach[m], inside the grid).
  // Every thread commits one copy group per plane, empty or not, so "all
  // but the newest TT_POLY_DEPTH − 1 groups have landed" means "plane zl
  // has landed".
#pragma unroll
  for (int d = 0; d < TT_POLY_DEPTH; ++d) {
    if (zs + d < ze) issue(zs + d);
    __pipeline_commit();
  }
  constexpr int B = (int)sizeof(T);
  for (int zl = zs; zl < ze; ++zl) {
    __pipeline_wait_prior(TT_POLY_DEPTH - 1);
    __syncthreads();  // plane zl is in; every thread is past step zl − 1
    // plane zl + DEPTH takes the slot of the plane no stage reads any more
    if (zl + TT_POLY_DEPTH < ze) issue(zl + TT_POLY_DEPTH);
    __pipeline_commit();
    for (int m = 1; m <= a.count; ++m) {
      if (m > 1) __syncthreads();  // stage m − 1's plane is in its ring
      const int p = zl - a.rz * (a.reach[0] - a.reach[m]);
      const int g = a.rz * a.reach[m];
      if (p < max(0, z0 - g) || p >= min(nz, z1 + g)) continue;
      // Stage m on plane p: every point of region m, written into ring m
      // (m < count; +0 outside the grid) and, at the block's own points
      // and planes, to out[m − 1]. Places in shared memory are bytes.
      StagePlane<T, NT> s;
      s.sm = reinterpret_cast<char*>(smem_raw);
      s.w = a.w[m];
      s.hgt = a.h[m];
      const int pi = pitch * a.h[m - 1];  // a plane of ring m − 1
      s.flags = a.flags[m - 1];
      s.alpha = a.coef[m - 1][0];
      s.beta = a.coef[m - 1][1];
      s.gamma = a.coef[m - 1][2];
      s.zeta = a.coef[m - 1][3];
      // ring m − 1 at plane p, shifted to region m's first point
      const int in_slot = (p - zs) % a.slots[m - 1];
      const int in_inset =
          (a.reach[m - 1] - a.reach[m]) * (a.ry * pitch + a.rx);
      s.beta_at = (a.base[m - 1] + in_slot * pi + in_inset) * B;
      // each neighbour plane, or the zero plane where iz + dz lies outside
      // [z_lo, z_hi) (and for the pad terms)
      auto plane_at = [&](int dz) {
        const int jz = p + dz;
        return (jz >= a.z_lo && jz < a.z_hi
                    ? a.base[m - 1] +
                          ring_at(in_slot, dz, a.slots[m - 1]) * pi
                    : a.zero) +
               in_inset;
      };
      if constexpr (CROSS) {
#pragma unroll
        for (int d = 0; d < 3; ++d) s.zoff[d] = plane_at(d - 1) * B;
      } else {
#pragma unroll
        for (int k = 0; k < NT; ++k)
          s.toff[k] = (k < n_terms ? plane_at(a.dz[k]) + a.off[k]
                                   : a.zero + in_inset) *
                      B;
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) s.cs[k] = k < n_terms ? a.c[k] : T(0);
      // gamma's u_{m−2}: ring m − 2, or device memory for the first stage
      s.g_at = m >= 2 ? (a.base[m - 2] +
                         ((p - zs) % a.slots[m - 2]) * pitch * a.h[m - 2] +
                         (a.reach[m - 2] - a.reach[m]) *
                             (a.ry * pitch + a.rx)) *
                            B
                      : -1;
      // zeta's x: ring 0 when the input is x, device memory otherwise
      s.x_at = a.from_x ? (base0 + ((p - zs) % slots0) * np0 +
                           (a.reach[0] - a.reach[m]) * (a.ry * pitch + a.rx)) *
                              B
                        : -1;
      s.ring = m < a.count
                   ? (a.base[m] + ((p - zs) % a.slots[m]) * pitch * s.hgt) * B
                   : -1;
      s.out = p >= z0 && p < z1 ? a.out[m - 1] : nullptr;
      s.ox = x0 - a.reach[m] * a.rx;
      s.oy = y0 - a.reach[m] * a.ry;
      s.ix0 = a.reach[m] * a.rx;
      s.iy0 = a.reach[m] * a.ry;
      s.tx = a.tx;
      s.ty = a.ty;
      s.plane = plane_n * p;
      constexpr int P = CROSS ? TT_CROSS_PITCH : 0;
#define TT_STAGE(F)                                                          \
  case F:                                                                    \
    stage_rows<F, CROSS, P, T, NT, PTS, RW>(s, pitch, prev2, x, lane, row,   \
                                            rows, nx, ny);                   \
    break;
      if (!a.from_x) {
        stage_rows<-1, CROSS, P, T, NT, PTS, RW>(s, pitch, prev2, x, lane,
                                                 row, rows, nx, ny);
      } else {
        switch (s.flags) {
          TT_STAGE(0) TT_STAGE(1) TT_STAGE(2) TT_STAGE(3)
          TT_STAGE(4) TT_STAGE(5) TT_STAGE(6) TT_STAGE(7)
          TT_STAGE(8) TT_STAGE(9) TT_STAGE(10) TT_STAGE(11)
          TT_STAGE(12) TT_STAGE(13) TT_STAGE(14) TT_STAGE(15)
        }
      }
#undef TT_STAGE
    }
  }
}

// The launch's geometry by the rule of ops/stencil_poly.py
// _launch_geometry, filled into `a`; false where the plan disagrees with
// it or breaks a limit.
template <typename T>
static bool plan_ok(const PolyPlan& p, const double* sc, const int* dx,
                    const int* dy, const int* dz, int n_terms, int nx, int ny,
                    int nz, PolyArgs<T>* a) {
  if (p.count < 1 || p.count > TT_MAX_STAGES || p.first < 0 ||
      p.first + p.count > TT_MAX_STAGES || p.threads != TT_POLY_THREADS ||
      p.threads % 32 ||
      p.tx < 1 || p.ty < 1 || p.zc < 1 || p.grid[1] > 65535 ||
      p.grid[2] > 65535 || (long long)p.grid[0] * p.tx < nx ||
      (long long)p.grid[1] * p.ty < ny || (long long)p.grid[2] * p.zc < nz)
    return false;
  int rx = 0, ry = 0, rz = 0;
  for (int k = 0; k < n_terms; ++k) {
    rx = std::max(rx, std::abs(dx[k]));
    ry = std::max(ry, std::abs(dy[k]));
    rz = std::max(rz, std::abs(dz[k]));
  }
  if (rx != p.rx || ry != p.ry || rz != p.rz) return false;
  const int ns = p.count;
  int al[TT_MAX_STAGES + 2] = {0};  // al[m]: stage m has alpha != 0
  for (int m = 1; m <= ns; ++m) al[m] = sc[4 * (m - 1)] != 0.0;
  a->reach[ns] = 0;
  for (int m = ns - 1; m >= 0; --m) a->reach[m] = a->reach[m + 1] + al[m + 1];
  long long bytes = 0;
  for (int m = 0; m <= ns; ++m) {
    a->w[m] = p.tx + 2 * a->reach[m] * rx;
    a->h[m] = p.ty + 2 * a->reach[m] * ry;
  }
  a->pitch = a->w[0];
  for (int m = 0; m < ns; ++m) {
    int d = 2 * rz * al[m + 1];
    if (m + 2 <= ns && sc[4 * (m + 1) + 2] != 0.0)
      d = std::max(d, rz * (al[m + 1] + al[m + 2]));
    if (m == 0 && p.first == 0)
      for (int j = 1; j <= ns; ++j)
        if (sc[4 * (j - 1) + 3] != 0.0)
          d = std::max(d, rz * (a->reach[0] - a->reach[j]));
    if (p.slots[m] != d + 1 + (m == 0 ? TT_POLY_DEPTH : 0)) return false;
    a->slots[m] = p.slots[m];
    a->base[m] = (int)bytes / (int)sizeof(T);
    bytes += (long long)p.slots[m] * a->pitch * a->h[m] * sizeof(T);
  }
  a->zero = (int)bytes / (int)sizeof(T);
  bytes += (long long)a->pitch * a->h[0] * sizeof(T);
  return bytes == p.smem && p.smem <= 232448;
}

template <typename T>
static int launch(const void* src, const void* prev2, const void* x,
                  const unsigned long long* outs, long long n,
                  long long n_pad, int nx, int ny, int nz, int z_lo, int z_hi,
                  int n_terms, const int* dx, const int* dy, const int* dz,
                  const long long* lin, const double* coeff,
                  const double* stage_coeffs, const int* plan, void* stream) {
  const PolyPlan p = read_plan(plan);
  if (z_lo < 0 || z_lo > z_hi || z_hi > nz || n != (long long)nx * ny * nz ||
      n_pad < n || n_terms < 0 || n_terms > TT_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  PolyArgs<T> a;
  if (!plan_ok<T>(p, stage_coeffs, dx, dy, dz, n_terms, nx, ny, nz, &a))
    return (int)cudaErrorInvalidConfiguration;
  // gamma_1: u_{-1} does not exist; a later launch's first gamma reads
  // u_{first-1} from device memory
  const double gamma_first = stage_coeffs[2];
  if ((p.first == 0 && gamma_first != 0.0) ||
      (p.first > 0 && gamma_first != 0.0 && prev2 == nullptr))
    return (int)cudaErrorInvalidValue;
  StencilTerms<T> t;
  int rc = fill_terms(&t, n_terms, dx, dy, dz, lin, coeff);
  if (rc) return rc;
  a.tx = p.tx; a.ty = p.ty; a.zc = p.zc;
  a.rx = p.rx; a.ry = p.ry; a.rz = p.rz;
  a.count = p.count; a.n_terms = n_terms;
  a.z_lo = z_lo; a.z_hi = z_hi;
  a.from_x = p.first == 0;
  for (int m = 0; m < p.count; ++m) {
    const double* sc = stage_coeffs + 4 * m;
    a.flags[m] = (sc[0] != 0.0 ? HAS_ALPHA : 0) |
                 (sc[1] != 0.0 ? HAS_BETA : 0) |
                 (sc[2] != 0.0 ? HAS_GAMMA : 0) |
                 (sc[3] != 0.0 ? HAS_ZETA : 0);
    for (int i = 0; i < 4; ++i) a.coef[m][i] = (T)sc[i];
    a.out[m] = (T*)outs[m];
  }
  bool cross = n_terms == 7 && a.pitch == TT_CROSS_PITCH;
  for (int k = 0; k < n_terms; ++k) {
    a.dz[k] = dz[k];
    a.off[k] = dy[k] * a.pitch + dx[k];
    a.c[k] = t.c[k];
    cross = cross && dx[k] == cross_dx(k) && dy[k] == cross_dy(k) &&
            dz[k] == cross_dz(k);
  }
  cudaStream_t s = (cudaStream_t)stream;
  // dynamic shared memory above 48 KB needs the attribute, which is the
  // current device's: set it on every launch
  // the 7-point cross, or the terms padded to 7, 16 or 32
  auto kernel = cross           ? poly_kernel<T, 7, 2, 2, true>
                : n_terms <= 7  ? poly_kernel<T, 7, 2, 2, false>
                : n_terms <= 16 ? poly_kernel<T, 16, 2, 1, false>
                                : poly_kernel<T, TT_MAX_TERMS, 1, 1, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.grid[0], p.grid[1], p.grid[2]), dim3(32, p.threads / 32),
           p.smem, s>>>((const T*)src, (const T*)prev2, (const T*)x, nx, ny,
                        nz, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int m = 0; m < p.count && n_pad > n; ++m) {
    if (!a.out[m]) continue;
    err = cudaMemcpyAsync(a.out[m] + n, (const T*)x + n,
                          (n_pad - n) * sizeof(T), cudaMemcpyDeviceToDevice,
                          s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int stencil_poly_f32(const void* src, const void* prev2, const void* x,
                     const unsigned long long* outs, long long n,
                     long long n_pad, int nx, int ny, int nz, int z_lo,
                     int z_hi, int n_terms, const int* dx, const int* dy,
                     const int* dz, const long long* lin, const double* coeff,
                     const double* stage_coeffs, const int* plan,
                     void* stream) {
  return launch<float>(src, prev2, x, outs, n, n_pad, nx, ny, nz, z_lo, z_hi,
                       n_terms, dx, dy, dz, lin, coeff, stage_coeffs, plan,
                       stream);
}

int stencil_poly_f64(const void* src, const void* prev2, const void* x,
                     const unsigned long long* outs, long long n,
                     long long n_pad, int nx, int ny, int nz, int z_lo,
                     int z_hi, int n_terms, const int* dx, const int* dy,
                     const int* dz, const long long* lin, const double* coeff,
                     const double* stage_coeffs, const int* plan,
                     void* stream) {
  return launch<double>(src, prev2, x, outs, n, n_pad, nx, ny, nz, z_lo,
                        z_hi, n_terms, dx, dy, dz, lin, coeff, stage_coeffs,
                        plan, stream);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
