// The ghost columns of one rank's boundary entries for the distributed
// fillComplete (parallel/distmatrix.py): the sorted unique global column
// ids the rank must receive, and for every entry its slot among them.
// With contiguous row maps, owner-major order is gid order, so one sort
// gives the reference's makeColMap ordering of the remote columns.
//
// Build: g++ -O3 -shared -fPIC (trilinos_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// ghost_gids receives the ng sorted unique values of bc_cols[0..nb) (room
// for nb), slots[e] the position of bc_cols[e] among them; returns ng.
int64_t tt_ghost_slots(int64_t nb, const int64_t* bc_cols,
                       int64_t* ghost_gids, int64_t* slots) {
  std::vector<int64_t> sorted(bc_cols, bc_cols + nb);
  std::sort(sorted.begin(), sorted.end());
  const int64_t ng =
      std::unique(sorted.begin(), sorted.end()) - sorted.begin();
  for (int64_t g = 0; g < ng; ++g) ghost_gids[g] = sorted[g];
  for (int64_t e = 0; e < nb; ++e)
    slots[e] = std::lower_bound(ghost_gids, ghost_gids + ng, bc_cols[e])
               - ghost_gids;
  return ng;
}

}  // extern "C"
