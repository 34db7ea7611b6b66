// Host SpGEMM C = A·B on CSR operands for the AMG set-up (Galerkin PᵀAP).
//
// Two passes, each one row of C at a time with a dense accumulator over the
// columns of C (KokkosSparse spgemm's kkmem variant): tt_spgemm_count
// counts the entries of every row of C, the caller scans the counts into
// c_ptr, and tt_spgemm_fill writes each row's columns sorted with their
// sums. Products are accumulated in double in the order of A's entries,
// then B's entries of each row.
//
// Build: g++ -O3 -shared -fPIC (trilinos_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Pass 1: count output nnz per row of C = A(m×k) · B(k×n).
void tt_spgemm_count(int64_t m, int64_t n, const int64_t* a_ptr,
                     const int32_t* a_cols, const int64_t* b_ptr,
                     const int32_t* b_cols, int64_t* c_counts) {
  std::vector<int64_t> mark(n, -1);
  for (int64_t i = 0; i < m; ++i) {
    int64_t cnt = 0;
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t k = a_cols[jj];
      for (int64_t bb = b_ptr[k]; bb < b_ptr[k + 1]; ++bb) {
        const int32_t c = b_cols[bb];
        if (mark[c] != i) { mark[c] = i; ++cnt; }
      }
    }
    c_counts[i] = cnt;
  }
}

// Pass 2: fill C (rows sorted by column). c_ptr = exclusive scan of counts.
void tt_spgemm_fill(int64_t m, int64_t n, const int64_t* a_ptr,
                    const int32_t* a_cols, const double* a_vals,
                    const int64_t* b_ptr, const int32_t* b_cols,
                    const double* b_vals, const int64_t* c_ptr,
                    int32_t* c_cols, double* c_vals) {
  std::vector<double> acc(n, 0.0);
  std::vector<int64_t> mark(n, -1);
  std::vector<int32_t> touched;
  touched.reserve(256);
  for (int64_t i = 0; i < m; ++i) {
    touched.clear();
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t k = a_cols[jj];
      const double av = a_vals[jj];
      for (int64_t bb = b_ptr[k]; bb < b_ptr[k + 1]; ++bb) {
        const int32_t c = b_cols[bb];
        if (mark[c] != i) {
          mark[c] = i;
          acc[c] = 0.0;
          touched.push_back(c);
        }
        acc[c] += av * b_vals[bb];
      }
    }
    std::sort(touched.begin(), touched.end());
    int64_t out = c_ptr[i];
    for (const int32_t c : touched) {
      c_cols[out] = c;
      c_vals[out] = acc[c];
      ++out;
    }
  }
}

}  // extern "C"
