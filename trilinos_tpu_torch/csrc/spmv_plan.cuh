// The single-vector stencil SpMV's launch plan check, in plain C: the
// launcher of stencil_spmv.cu calls it, and a host C compiler builds it as
// it stands (tests/test_torch_spmv_tile.py holds it against
// ops/stencil_op.py spmv_plan).
#ifndef TT_SPMV_PLAN_CUH
#define TT_SPMV_PLAN_CUH

#include <stdint.h>

// The kernel's block and its z-chunk; ops/stencil_op.py spmv_plan plans
// with the same values (a CPU test reads them from here).
#define TT_SPMV_THREADS 256  // threads of a block, at most
#define TT_SPMV_ROW 64       // threads along x, at most
#define TT_SPMV_ZC 32        // planes a cross block marches, at most
#define TT_SPMV_GRID_YZ 65535  // CUDA's gridDim.y and gridDim.z limit

static inline long long tt_cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// plan: the int32 array [vw, cross, blockDim.x, .y, .z, gridDim.x, .y, .z,
// zc] of spmv_plan; cross = 1 for the z-marching instance (Galeri's 7-point
// cross only), 0 for the generic instance (any stencil, one point a
// thread, one plane a block, vw = zc = 1). True where the plan fits the
// stencil, the shape, the pointers and CUDA's per-axis limits, and its
// grid is exactly the one that covers the points: a larger grid would
// start blocks past the last point.
static inline int tt_spmv_plan_ok(const int* p, int itemsize, uintptr_t x,
                                  uintptr_t y, int nx, int ny, int nz,
                                  int is_cross) {
  const int vw = p[0], cross = p[1], bx = p[2], by = p[3], bz = p[4];
  const int zc = p[8];
  const long long bytes = (long long)vw * itemsize;
  if (cross != 0 && cross != 1) return 0;
  if (cross && !is_cross) return 0;
  if (!cross && (vw != 1 || zc != 1)) return 0;
  if (!(vw == 1 || vw == 2 || bytes == 16) || bytes > 16 || nx % vw) return 0;
  if (x % bytes || y % bytes) return 0;
  if (bx < 1 || by < 1 || bz != 1 || bx > TT_SPMV_ROW ||
      (long long)bx * by > TT_SPMV_THREADS)
    return 0;
  if (zc < 1 || zc > TT_SPMV_ZC) return 0;
  return p[5] == tt_cdiv(nx, (long long)bx * vw) && p[6] == tt_cdiv(ny, by) &&
         p[7] == tt_cdiv(nz, zc) && p[6] <= TT_SPMV_GRID_YZ &&
         p[7] <= TT_SPMV_GRID_YZ;
}

#endif  // TT_SPMV_PLAN_CUH
