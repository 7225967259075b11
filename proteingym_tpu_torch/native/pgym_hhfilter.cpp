// pgym_hhfilter: the greedy coverage / identity filter over MSA rows that
// stands in for hhfilter '-cov 75 -id 90' (ref esm/compute_fitness.py:85-89).
//
// A copy of pgym_hhfilter_mask from proteingym_tpu/native/pgym_native.cpp,
// line for line: the same counts, the same greedy order and the same
// double-precision comparisons, so the same matrix gives the same mask.
// Built at first use by proteingym_tpu_torch/native/__init__.py, with a
// plain C ABI for ctypes.
//
// Encoding contract: rows are int8, 0 = gap (never matches), 1..20 = amino
// acids.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// keep[i] = 1 if sequence i passes:
//   (a) coverage: non-gap fraction >= min_coverage
//   (b) max pairwise identity: among ALREADY-KEPT earlier sequences, no
//       kept j < i with identity(i, j) > max_identity (greedy, order-
//       preserving — the focus/first sequence always survives)
//   (c) min identity to the first (query) sequence >= min_query_identity
// Identity = matches / min(nongap_i, nongap_j).
void pgym_hhfilter_mask(const int8_t* matrix, int64_t n, int64_t L,
                        double min_coverage, double max_identity,
                        double min_query_identity, uint8_t* keep) {
    std::vector<int64_t> nongap(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = 0;
        const int8_t* row = matrix + i * L;
        for (int64_t k = 0; k < L; ++k) c += (row[k] != 0);
        nongap[i] = c;
    }
    auto identity = [&](int64_t a, int64_t b) -> double {
        const int8_t* ra = matrix + a * L;
        const int8_t* rb = matrix + b * L;
        int64_t m = 0;
        for (int64_t k = 0; k < L; ++k) m += (ra[k] != 0) & (ra[k] == rb[k]);
        int64_t d = std::min(nongap[a], nongap[b]);
        return d > 0 ? static_cast<double>(m) / static_cast<double>(d) : 0.0;
    };
    std::vector<int64_t> kept;
    for (int64_t i = 0; i < n; ++i) {
        keep[i] = 0;
        if (i == 0) { keep[i] = 1; kept.push_back(i); continue; }
        double cov = L > 0 ? static_cast<double>(nongap[i]) / L : 0.0;
        if (cov < min_coverage) continue;
        if (min_query_identity > 0.0 && identity(i, 0) < min_query_identity)
            continue;
        bool redundant = false;
        if (max_identity < 1.0) {
            for (int64_t j : kept) {
                if (identity(i, j) > max_identity) { redundant = true; break; }
            }
        }
        if (!redundant) { keep[i] = 1; kept.push_back(i); }
    }
}

}  // extern "C"
