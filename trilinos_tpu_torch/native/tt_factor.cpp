// Host set-up of the stored-matrix path: the Matrix Market reader and the
// incomplete factorizations, copied from the JAX package's native library
// (trilinos_tpu/native/src/tt_native.cpp) and nothing else of it.
//
//   * tt_read_mm_header / tt_read_mm: Matrix Market coordinate parser
//     (real, integer and pattern fields; one strtod scan of the entries);
//   * tt_ilu0: in-place ILU(0) numeric factorization on a sorted CSR;
//   * tt_ilut: Saad's dual-threshold ILUT(p, tau), row by row;
//   * tt_iluk: the ILU(k) level-of-fill pattern.
//
// Build: g++ -O3 -shared -fPIC, one library with tt_spgemm.cpp
// (trilinos_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Matrix Market coordinate parser
// ---------------------------------------------------------------------------

// Parses the header; returns 0 on success. symm: 0 general, 1 symmetric,
// 2 skew. field: 0 real/int, 1 pattern. Leaves *data_pos at the first
// entry line's file offset.
int tt_read_mm_header(const char* path, int64_t* m, int64_t* n,
                      int64_t* nnz, int* symm, int* pattern,
                      int64_t* data_pos) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
  if (std::strncmp(line, "%%MatrixMarket", 14) != 0) {
    std::fclose(f);
    return -3;
  }
  char obj[64], fmt[64], field[64], sym[64];
  if (std::sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s", obj, fmt,
                  field, sym) != 4) { std::fclose(f); return -4; }
  if (std::strcmp(fmt, "coordinate") != 0) { std::fclose(f); return -5; }
  // complex entries carry FOUR value columns — this parser reads three,
  // so defer complex (and hermitian symmetry) to the Python reader
  if (std::strcmp(field, "real") != 0 &&
      std::strcmp(field, "integer") != 0 &&
      std::strcmp(field, "pattern") != 0) { std::fclose(f); return -8; }
  *pattern = std::strcmp(field, "pattern") == 0 ? 1 : 0;
  if (std::strcmp(sym, "symmetric") == 0) *symm = 1;
  else if (std::strcmp(sym, "skew-symmetric") == 0) *symm = 2;
  else *symm = 0;
  // skip comments
  long pos;
  for (;;) {
    pos = std::ftell(f);
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -6; }
    if (line[0] != '%') break;
  }
  long long mm, nn, zz;
  if (std::sscanf(line, "%lld %lld %lld", &mm, &nn, &zz) != 3) {
    std::fclose(f);
    return -7;
  }
  *m = mm; *n = nn; *nnz = zz;
  *data_pos = std::ftell(f);
  std::fclose(f);
  return 0;
}

// Reads nnz (row, col, val) triples starting at data_pos. rows/cols are
// 0-based on output. Returns number parsed, or negative on error.
int64_t tt_read_mm(const char* path, int64_t data_pos, int64_t nnz,
                   int pattern, int64_t* rows, int64_t* cols, double* vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, static_cast<long>(data_pos), SEEK_SET);
  // slurp the remainder for a single fast scan
  long start = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long end = std::ftell(f);
  std::fseek(f, start, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(end - start) + 1);
  size_t got = std::fread(buf.data(), 1, buf.size() - 1, f);
  buf[got] = '\0';
  std::fclose(f);
  char* p = buf.data();
  int64_t k = 0;
  while (k < nnz) {
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (!*p) break;
    char* q;
    long long r = std::strtoll(p, &q, 10);
    if (q == p) return -2;
    p = q;
    long long c = std::strtoll(p, &q, 10);
    if (q == p) return -3;
    p = q;
    double v = 1.0;
    if (!pattern) {
      v = std::strtod(p, &q);
      if (q == p) return -4;
      p = q;
    }
    rows[k] = r - 1;
    cols[k] = c - 1;
    vals[k] = v;
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------------------
// ILU(0): in-place numeric factorization on a sorted CSR
// ---------------------------------------------------------------------------

// vals is modified in place; on exit, entries left of the diagonal hold L
// (unit diagonal implied), the diagonal and right of it hold U.
// Returns 0 on success, i+1 if a zero pivot was hit at row i (factorization
// continues with the pivot skipped, matching the reference's tolerant
// behavior).
int64_t tt_ilu0(int64_t n, const int64_t* row_ptr, const int32_t* cols,
                double* vals) {
  std::vector<int64_t> diag(n, -1);
  std::vector<int64_t> pos(n, -1);  // column -> index scratch for row i
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t jj = row_ptr[i]; jj < row_ptr[i + 1]; ++jj)
      if (cols[jj] == i) { diag[i] = jj; break; }
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t rs = row_ptr[i], re = row_ptr[i + 1];
    for (int64_t jj = rs; jj < re; ++jj) pos[cols[jj]] = jj;
    for (int64_t kk = rs; kk < re; ++kk) {
      const int64_t k = cols[kk];
      if (k >= i) break;  // sorted: done with the strict lower part
      const int64_t dk = diag[k];
      if (dk < 0) continue;
      const double ukk = vals[dk];
      if (ukk == 0.0) { if (!bad) bad = i + 1; continue; }
      const double lik = vals[kk] / ukk;
      vals[kk] = lik;
      for (int64_t jj = dk + 1; jj < row_ptr[k + 1]; ++jj) {
        const int64_t p = pos[cols[jj]];
        if (p >= 0) vals[p] -= lik * vals[jj];
      }
    }
    for (int64_t jj = rs; jj < re; ++jj) pos[cols[jj]] = -1;
  }
  return bad;
}

// ---------------------------------------------------------------------------
// ILUT(p, tau) — Saad dual-threshold incomplete LU, row-based.
// Analogue of Ifpack2::ILUT numeric factorization
// (packages/ifpack2/src/Ifpack2_ILUT_def.hpp compute()); semantics match
// the Python sweep of precond/ilut.py ilut_factor (drop
// below tau = droptol*||row||, keep the p = fill*row_len largest per
// factor, zero-pivot guard row_norm*1e-12).
//
// Outputs: L rows STRICT lower (unit diagonal added by the caller),
// U rows with the DIAGONAL FIRST then kept uppers ascending. Returns
// total nnz written (l+u), or a negative capacity hint when cap is
// exceeded (caller doubles and retries).
// ---------------------------------------------------------------------------

int64_t tt_ilut(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                const double* a_vals, double fill, double droptol,
                int64_t cap,
                int64_t* l_ptr, int32_t* l_cols, double* l_vals,
                int64_t* u_ptr, int32_t* u_cols, double* u_vals) {
  std::vector<double> w(n, 0.0);
  std::vector<double> udiag(n, 0.0);
  // state: 0 absent, 1 present, 2 present+queued for elimination
  std::vector<char> state(n, 0);
  std::priority_queue<int32_t, std::vector<int32_t>,
                      std::greater<int32_t>> heap;
  std::vector<int32_t> pat, cand;
  pat.reserve(256);
  int64_t lnnz = 0, unnz = 0;
  l_ptr[0] = 0;
  u_ptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    pat.clear();
    double norm2 = 0.0;
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t c = a_cols[jj];
      const double v = a_vals[jj];
      if (!state[c]) {
        state[c] = 1;
        pat.push_back(c);
        w[c] = v;
      } else {
        w[c] += v;
      }
      norm2 += v * v;
    }
    double row_norm = std::sqrt(norm2);
    if (row_norm == 0.0) row_norm = 1.0;
    const double tau = droptol * row_norm;
    const int64_t row_len = a_ptr[i + 1] - a_ptr[i];
    int64_t p_keep = (int64_t)(fill * (double)row_len);
    if (p_keep < 1) p_keep = 1;
    for (int32_t c : pat)
      if (c < i && state[c] == 1) {
        state[c] = 2;
        heap.push(c);
      }
    while (!heap.empty()) {
      const int32_t k = heap.top();
      heap.pop();
      if (!state[k]) continue;  // dropped by an earlier elimination
      state[k] = 1;
      const double ukk = udiag[k];
      if (ukk == 0.0) continue;
      const double lik = w[k] / ukk;
      if (std::abs(lik) < tau) {
        state[k] = 0;
        w[k] = 0.0;
        continue;
      }
      w[k] = lik;
      for (int64_t q = u_ptr[k]; q < u_ptr[k + 1]; ++q) {
        const int32_t j = u_cols[q];
        if (j <= k) continue;  // skip the leading diagonal slot
        const double uv = u_vals[q];
        if (!state[j]) {
          state[j] = 1;
          pat.push_back(j);
          w[j] = -lik * uv;
          if (j < i) {
            state[j] = 2;
            heap.push(j);
          }
        } else {
          w[j] -= lik * uv;
        }
      }
    }
    // select lower entries: |w| >= tau, keep the p largest
    cand.clear();
    for (int32_t c : pat)
      if (c < i && state[c] && std::abs(w[c]) >= tau) cand.push_back(c);
    auto bigger = [&](int32_t x, int32_t y) {
      return std::abs(w[x]) > std::abs(w[y]);
    };
    if ((int64_t)cand.size() > p_keep) {
      std::nth_element(cand.begin(), cand.begin() + p_keep, cand.end(),
                       bigger);
      cand.resize(p_keep);
    }
    std::sort(cand.begin(), cand.end());
    if (lnnz + (int64_t)cand.size() > cap ||
        unnz + p_keep + 1 > cap)
      return -(lnnz + unnz + 2 * (n - i) * (p_keep + 1));
    for (int32_t c : cand) {
      l_cols[lnnz] = c;
      l_vals[lnnz] = w[c];
      ++lnnz;
    }
    l_ptr[i + 1] = lnnz;
    // select upper entries (excluding diagonal): |w| >= tau, p largest
    cand.clear();
    for (int32_t c : pat)
      if (c > i && state[c] && std::abs(w[c]) >= tau) cand.push_back(c);
    if ((int64_t)cand.size() > p_keep) {
      std::nth_element(cand.begin(), cand.begin() + p_keep, cand.end(),
                       bigger);
      cand.resize(p_keep);
    }
    std::sort(cand.begin(), cand.end());
    double dpiv = (state[i] && w[i] != 0.0) ? w[i] : row_norm * 1e-12;
    u_cols[unnz] = (int32_t)i;  // diagonal first
    u_vals[unnz] = dpiv;
    ++unnz;
    for (int32_t c : cand) {
      u_cols[unnz] = c;
      u_vals[unnz] = w[c];
      ++unnz;
    }
    u_ptr[i + 1] = unnz;
    udiag[i] = dpiv;
    for (int32_t c : pat) {
      state[c] = 0;
      w[c] = 0.0;
    }
  }
  return lnnz + unnz;
}

// ---------------------------------------------------------------------------
// ILU(k) symbolic level-of-fill (Ifpack2::IlukGraph analogue,
// packages/ifpack2/src/Ifpack2_IlukGraph.hpp): the augmented sparsity
// pattern with fill level <= kfill. Row-merge formulation: row i starts
// at the levels of A's entries (0); each pivot k < i in the working row
// (ascending; std::set insertions of j > k keep iterators valid) merges
// row k's stored strict-upper pattern at level lev(i,k)+lev(k,j)+1,
// keeping entries with level <= kfill. ILU(0) on this pattern (zeros at
// fill positions) IS ILU(k) — the classical reduction the Python side
// uses. Capacity protocol like tt_splu: returns required nnz; out
// arrays are fully valid only when the result <= cap (out_ptr is always
// filled, so the caller can retry with the exact size).
// ---------------------------------------------------------------------------

int64_t tt_iluk(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                int64_t kfill, int64_t cap,
                int64_t* out_ptr, int32_t* out_cols) {
  const int32_t ABSENT = INT32_MAX;
  std::vector<int32_t> lev(n, ABSENT);
  std::vector<int64_t> uptr(n + 1, 0);  // strict-upper pattern storage
  std::vector<int32_t> ucols;
  std::vector<int32_t> ulevs;
  ucols.reserve(a_ptr[n]);
  ulevs.reserve(a_ptr[n]);
  int64_t total = 0;
  out_ptr[0] = 0;
  std::set<int32_t> act;
  for (int64_t i = 0; i < n; ++i) {
    act.clear();
    for (int64_t p = a_ptr[i]; p < a_ptr[i + 1]; ++p) {
      const int32_t c = a_cols[p];
      if (lev[c] == ABSENT) act.insert(c);
      lev[c] = 0;
    }
    for (auto it = act.begin(); it != act.end(); ++it) {
      const int32_t k = *it;
      if (k >= i) break;
      const int32_t lk = lev[k];
      for (int64_t p = uptr[k]; p < uptr[k + 1]; ++p) {
        const int32_t j = ucols[p];
        const int64_t nl = (int64_t)lk + ulevs[p] + 1;
        if (nl <= kfill) {
          if (lev[j] == ABSENT) {
            act.insert(j);  // j > k: not yet visited in this traversal
            lev[j] = (int32_t)nl;
          } else if ((int32_t)nl < lev[j]) {
            lev[j] = (int32_t)nl;
          }
        }
      }
    }
    const int64_t cnt = (int64_t)act.size();
    if (total + cnt <= cap) {
      int64_t q = total;
      for (int32_t c : act) out_cols[q++] = c;
    }
    total += cnt;
    out_ptr[i + 1] = total;
    for (int32_t c : act) {  // ascending: store strict upper + levels
      if (c > i) {
        ucols.push_back(c);
        ulevs.push_back(lev[c]);
      }
      lev[c] = ABSENT;
    }
    uptr[i + 1] = (int64_t)ucols.size();
  }
  return total;
}

}  // extern "C"
