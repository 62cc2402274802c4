// The LK window's runs of ones, as the wrappers of the LK kernels pass them
// (ops/cuda/lk_build.py:run_table): for each maximal run of the 0/1 window
// mask, its start `lo` on the 32-sample grid, its length, the base width `a`
// of the two-level sum and the factor list of the ladder sum
// (ops/window_sums.py: base_width, _smooth_factorization).
#pragma once

#include <cstring>

namespace ofri_lk {

constexpr int kGrid = 32;
constexpr int kExt = kGrid - 1;  // a window spans offsets [-hw, kGrid-1-hw]
constexpr int kMaxRuns = 4;
constexpr int kMaxFactors = 5;  // a run is at most 32 = 2^5 long

struct Run {
  int lo, len, a, nfac, fac[kMaxFactors];
};

struct Runs {
  int n;
  Run run[kMaxRuns];
};

static_assert(sizeof(Runs) == sizeof(int) * (1 + kMaxRuns * (4 + kMaxFactors)),
              "Runs must be a plain table of ints");

// The table the wrapper passes (host memory) as a struct the kernel takes by
// value; false when it is malformed.
inline bool runs_from_table(const int* table, Runs* out) {
  std::memcpy(out, table, sizeof(Runs));
  if (out->n < 1 || out->n > kMaxRuns) return false;
  for (int q = 0; q < out->n; ++q) {
    const Run& r = out->run[q];
    if (r.lo < 0 || r.len < 1 || r.lo + r.len > kGrid || r.a < 1 || r.a > r.len) return false;
    if (r.nfac < 0 || r.nfac > kMaxFactors) return false;
    int m = 1;
    for (int k = 0; k < r.nfac; ++k) {
      if (r.fac[k] < 2) return false;
      m *= r.fac[k];
    }
    if (m > r.len) return false;
  }
  return true;
}

}  // namespace ofri_lk
