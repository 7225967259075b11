// pgym_align: the affine-gap global aligner (Gotoh) that realigns the
// retrieval priors of Tranception and TranceptEVE to every indel sequence
// (the role of Clustal Omega in ref tranception/utils/msa_utils.py:141-192).
//
// A copy of pgym_affine_align from proteingym_tpu/native/pgym_native.cpp:
// the recursion and the traceback's tie-breaking are the same line for
// line, so of two alignments of equal score the same one comes out.
// pgym_affine_align_batch, the one exported entry, runs it over all of an
// assay's sequences on native threads. Built at first use by
// proteingym_tpu_torch/native/__init__.py, with a plain C ABI for ctypes.
//
// Encoding contract: sequences are int8 arrays, 0 = gap or any non-amino
// acid (never matches), 1..20 = amino acids in "ACDEFGHIKLMNPQRSTVWY"
// order.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Aligns seq a (len la) to seq b (len lb) with match/mismatch scores and
// affine gaps; writes the aligned index of each position of a into
// out_a2b (length la): out_a2b[i] = column index in the alignment, and
// out_b_cols (length lb) likewise. Returns the alignment length.
// Scores are x100 ints to stay exact.
int64_t affine_align(const int8_t* a, int64_t la, const int8_t* b,
                     int64_t lb, int32_t match, int32_t mismatch,
                     int32_t gap_open, int32_t gap_extend,
                     int32_t* out_a2b, int32_t* out_b2a) {
    const int64_t W = lb + 1;
    const int32_t NEG = INT32_MIN / 4;
    std::vector<int32_t> M((la + 1) * W, NEG), X((la + 1) * W, NEG),
        Y((la + 1) * W, NEG);
    // traceback: 0=M,1=X(gap in b / a consumed),2=Y(gap in a / b consumed)
    std::vector<uint8_t> tbM((la + 1) * W), tbX((la + 1) * W), tbY((la + 1) * W);
    M[0] = 0;
    for (int64_t j = 1; j <= lb; ++j) {
        Y[j] = gap_open + static_cast<int32_t>(j - 1) * gap_extend;
        tbY[j] = 2;
    }
    for (int64_t i = 1; i <= la; ++i) {
        X[i * W] = gap_open + static_cast<int32_t>(i - 1) * gap_extend;
        tbX[i * W] = 1;
    }
    for (int64_t i = 1; i <= la; ++i) {
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t c = i * W + j, d = (i - 1) * W + (j - 1);
            const int32_t s = (a[i - 1] == b[j - 1] && a[i - 1] != 0)
                                  ? match : mismatch;
            int32_t best = M[d]; uint8_t t = 0;
            if (X[d] > best) { best = X[d]; t = 1; }
            if (Y[d] > best) { best = Y[d]; t = 2; }
            M[c] = best + s; tbM[c] = t;

            const int64_t u = (i - 1) * W + j;
            int32_t xo = M[u] + gap_open, xe = X[u] + gap_extend;
            if (xo >= xe) { X[c] = xo; tbX[c] = 0; }
            else { X[c] = xe; tbX[c] = 1; }

            const int64_t l = i * W + (j - 1);
            int32_t yo = M[l] + gap_open, ye = Y[l] + gap_extend;
            if (yo >= ye) { Y[c] = yo; tbY[c] = 0; }
            else { Y[c] = ye; tbY[c] = 2; }
        }
    }
    // traceback from the best terminal state
    int64_t i = la, j = lb;
    const int64_t end = la * W + lb;
    uint8_t state = 0;
    int32_t best = M[end];
    if (X[end] > best) { best = X[end]; state = 1; }
    if (Y[end] > best) { best = Y[end]; state = 2; }

    std::vector<int32_t> cols_a, cols_b;  // reversed alignment ops
    while (i > 0 || j > 0) {
        const int64_t c = i * W + j;
        if (state == 0) {
            uint8_t prev = tbM[c];
            cols_a.push_back(static_cast<int32_t>(i - 1));
            cols_b.push_back(static_cast<int32_t>(j - 1));
            --i; --j; state = prev;
        } else if (state == 1) {
            uint8_t prev = tbX[c];
            cols_a.push_back(static_cast<int32_t>(i - 1));
            cols_b.push_back(-1);
            --i; state = prev;
        } else {
            uint8_t prev = tbY[c];
            cols_a.push_back(-1);
            cols_b.push_back(static_cast<int32_t>(j - 1));
            --j; state = prev;
        }
    }
    const int64_t alen = static_cast<int64_t>(cols_a.size());
    for (int64_t kx = 0; kx < la; ++kx) out_a2b[kx] = -1;
    for (int64_t kx = 0; kx < lb; ++kx) out_b2a[kx] = -1;
    for (int64_t k2 = 0; k2 < alen; ++k2) {
        const int64_t col = alen - 1 - k2;  // forward column index
        int32_t ia = cols_a[k2], ib = cols_b[k2];
        if (ia >= 0) out_a2b[ia] = static_cast<int32_t>(col);
        if (ib >= 0) out_b2a[ib] = static_cast<int32_t>(col);
    }
    return alen;
}

}  // namespace

extern "C" {

// Aligns a against each of n queries with affine_align, on `threads`
// native threads in one call (no interpreter lock between pairs). The
// queries are concatenated in b_all, query i spanning b_off[i]..b_off[i+1];
// its columns go to out_a + i * la and out_b + b_off[i], its alignment
// length to out_len[i].
void pgym_affine_align_batch(const int8_t* a, int64_t la, const int8_t* b_all,
                             const int64_t* b_off, int64_t n, int32_t match,
                             int32_t mismatch, int32_t gap_open,
                             int32_t gap_extend, int32_t threads,
                             int32_t* out_a, int32_t* out_b, int64_t* out_len) {
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (int64_t i = next++; i < n; i = next++) {
            out_len[i] = affine_align(
                a, la, b_all + b_off[i], b_off[i + 1] - b_off[i], match,
                mismatch, gap_open, gap_extend, out_a + i * la, out_b + b_off[i]);
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < threads && t < n; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
}

}  // extern "C"
