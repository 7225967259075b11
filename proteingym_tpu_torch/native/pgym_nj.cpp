// pgym_nj: the neighbour-joining tree over MSA rows that GEMME's traces
// and patristic distances and SiteRM's cherries are built from (the role
// of FastTree / FastCherries in ref SiteRM/compute_fitness.py:19 and of
// JET2's trees in GEMME).
//
// A copy of pgym_nj_tree from proteingym_tpu/native/pgym_native.cpp: the
// distances, the argmin scan with its tie-breaking (the lowest (a, b) in
// scan order), the branch lengths and the updates are the same line for
// line, so the same matrix gives the same tree. The JAX package builds its
// library with -O3 -march=native, where g++ contracts two products into
// fused multiply-adds: Q = (m - 2) d(a, b) - r_a (then - r_b) and the left
// branch 0.5 d(a, b) + (r_a - r_b) / (2 (m - 2)). This copy writes those two
// as std::fma and is built with -ffp-contract=off, so it rounds as that
// library does on any host, and contracts nothing else. The scan is serial
// here (the JAX library splits it over OpenMP threads and merges the
// threads' minima by the same tie rule, so its tree does not depend on the
// thread count either). Built at first use by
// proteingym_tpu_torch/native/__init__.py, with a plain C ABI for ctypes.
//
// Encoding contract: rows are int8, 0 = gap (never matches), 1..20 = amino
// acids.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Classic Saitou-Nei neighbour joining with distance
// d(i,j) = 1 - matches/min(nongap_i, nongap_j). Output is the rooted merge
// sequence: internal node (n + k) has children left[k], right[k] (ids < n
// are leaves) with NJ branch lengths (clamped >= 0); the final merge joins
// the last two active nodes, so the arrays hold exactly n - 1 merges.
// Returns n - 1, or -1 on bad input. O(N^3). Two clones, picked at load
// time: one for hosts with FMA, where std::fma is one instruction, and one
// for the rest, where it is a call to libm's correctly rounded fma (the
// same result, ~2x slower here).
__attribute__((target_clones("fma", "default")))
int64_t pgym_nj_tree(const int8_t* matrix, int64_t n, int64_t L,
                     int32_t* left, int32_t* right,
                     double* left_len, double* right_len) {
    if (n < 2) return -1;
    const int64_t tot = 2 * n - 1;
    std::vector<double> d(tot * tot, 0.0);
    std::vector<int64_t> nongap(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = 0;
        const int8_t* row = matrix + i * L;
        for (int64_t k = 0; k < L; ++k) c += (row[k] != 0);
        nongap[i] = c;
    }
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* ri = matrix + i * L;
        for (int64_t j = i + 1; j < n; ++j) {
            const int8_t* rj = matrix + j * L;
            int64_t m = 0;
            for (int64_t k = 0; k < L; ++k)
                m += (ri[k] != 0) & (ri[k] == rj[k]);
            const int64_t den = std::min(nongap[i], nongap[j]);
            const double dist =
                den > 0 ? 1.0 - static_cast<double>(m) / den : 1.0;
            d[i * tot + j] = dist;
            d[j * tot + i] = dist;
        }
    }

    std::vector<int32_t> active(n);
    for (int64_t i = 0; i < n; ++i) active[i] = static_cast<int32_t>(i);
    std::vector<double> r(tot, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        double s = 0.0;
        for (int64_t j = 0; j < n; ++j) s += d[i * tot + j];
        r[i] = s;
    }

    int64_t next_id = n, merge = 0;
    while (static_cast<int64_t>(active.size()) > 2) {
        const int64_t m = static_cast<int64_t>(active.size());
        const double m2 = static_cast<double>(m - 2);
        // argmin of Q(a,b) = (m-2) d(a,b) - r_a - r_b over active pairs
        double best_q = 1e300;
        int64_t best_ai = -1, best_bi = -1;
        for (int64_t ai = 0; ai < m; ++ai) {
            const int64_t a = active[ai];
            const double ra = r[a];
            for (int64_t bi = ai + 1; bi < m; ++bi) {
                const int64_t b = active[bi];
                const double q = std::fma(m2, d[a * tot + b], -ra) - r[b];
                if (q < best_q) { best_q = q; best_ai = ai; best_bi = bi; }
            }
        }
        const int64_t a = active[best_ai], b = active[best_bi];
        const double dab = d[a * tot + b];
        double la = std::fma(0.5, dab, (r[a] - r[b]) / (2.0 * m2));
        double lb = dab - la;
        if (la < 0.0) la = 0.0;
        if (lb < 0.0) lb = 0.0;
        const int64_t u = next_id++;
        left[merge] = static_cast<int32_t>(a);
        right[merge] = static_cast<int32_t>(b);
        left_len[merge] = la;
        right_len[merge] = lb;
        ++merge;
        // distances to the new node + incremental row sums
        double ru = 0.0;
        for (int64_t ki = 0; ki < m; ++ki) {
            const int64_t k = active[ki];
            if (k == a || k == b) continue;
            const double duk =
                0.5 * (d[a * tot + k] + d[b * tot + k] - dab);
            d[u * tot + k] = duk;
            d[k * tot + u] = duk;
            r[k] += duk - d[a * tot + k] - d[b * tot + k];
            ru += duk;
        }
        r[u] = ru;
        // replace a with u, drop b (best_bi > best_ai)
        active[best_ai] = static_cast<int32_t>(u);
        active.erase(active.begin() + best_bi);
    }
    // root: join the final two
    const int64_t a = active[0], b = active[1];
    left[merge] = static_cast<int32_t>(a);
    right[merge] = static_cast<int32_t>(b);
    left_len[merge] = 0.5 * d[a * tot + b];
    right_len[merge] = 0.5 * d[a * tot + b];
    ++merge;
    return merge;
}

}  // extern "C"
