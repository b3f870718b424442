// Host-side native kernels: the stitcher's overlap scan and the banded
// edit distance of read identity (the port's copy of
// nanodecoder_tpu/native/overlap.cpp, the same functions).
//
// Per-read post-processing runs on the host while the card decodes the
// next batch; the numpy versions in io/stitch.py and identity.py loop in
// Python over k or over the rows of the band, this tier in C++ (PERF.md
// has both times on the card's host).  Compiled at first use by
// nanodecoder_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) and
// bound with ctypes; the numpy versions stay as the plain fallback and
// the reference the tests hold these to.
//
// best_overlap_len: score every overlap length k in [1, max_k] between
// the k-suffix of `left` and the k-prefix of `right` by
// (matches - mismatches) and return the argmax (0 if no positive score),
// the smallest k on ties, as io/stitch._best_overlap_len_plain does.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int best_overlap_len(const char* left, int n_left,
                     const char* right, int n_right,
                     int max_k) {
    if (max_k > n_left) max_k = n_left;
    if (max_k > n_right) max_k = n_right;
    if (max_k <= 0) return 0;

    const char* suf = left + n_left - max_k;  // last max_k chars of left
    int best_k = 0;
    long best_score = 0;
    // Incremental trick: matches(k+1) extends the window by one char on
    // the left of the suffix and one on the right of the prefix — but
    // the aligned PAIRS change entirely between k and k+1 (suffix
    // re-anchors), so each k is scored independently; O(max_k^2) total,
    // branch-free inner loop.
    for (int k = 1; k <= max_k; ++k) {
        const char* a = suf + (max_k - k);
        long eq = 0;
        for (int i = 0; i < k; ++i) {
            eq += (a[i] == right[i]);
        }
        long score = 2 * eq - k;
        if (score > best_score) {
            best_score = score;
            best_k = k;
        }
    }
    return best_k;
}

// Batched variant: score many junctions in one call (amortizes ctypes
// overhead when stitching a long read's many chunks).
void best_overlap_len_batch(const char** lefts, const int* n_lefts,
                            const char** rights, const int* n_rights,
                            const int* max_ks, int n, int* out) {
    for (int i = 0; i < n; ++i) {
        out[i] = best_overlap_len(lefts[i], n_lefts[i], rights[i], n_rights[i],
                                  max_ks[i]);
    }
}

// Banded Levenshtein distance for read-identity evaluation.
// Band half-width `band` around the diagonal scaled to the length
// ratio; returns -1 if the band was exceeded (caller should widen).
// Memory: two rolling rows of 2*band+1 cells.

int banded_edit_distance(const char* a, int n, const char* b, int m, int band) {
    if (n == 0) return m;
    if (m == 0) return n;
    if (band <= 0) band = 1;
    const int INF = 1 << 28;
    const int width = 2 * band + 1;
    std::vector<int> prev(width, INF), cur(width, INF);
    // Row i covers columns j in [center-band, center+band], center = i*m/n.
    auto center_of = [&](int i) { return (int)((long)i * m / n); };
    // Row 0: D[0][j] = j for j within band of center 0.
    for (int k = 0; k < width; ++k) {
        int j = center_of(0) - band + k;
        if (j >= 0 && j <= m) prev[k] = j;
    }
    int prev_center = center_of(0);
    for (int i = 1; i <= n; ++i) {
        int center = center_of(i);
        std::fill(cur.begin(), cur.end(), INF);
        for (int k = 0; k < width; ++k) {
            int j = center - band + k;
            if (j < 0 || j > m) continue;
            int up_k = j - prev_center + band;        // D[i-1][j]
            int diag_k = j - 1 - prev_center + band;  // D[i-1][j-1]
            int best = INF;
            if (up_k >= 0 && up_k < width && prev[up_k] < INF)
                best = std::min(best, prev[up_k] + 1);
            if (j >= 1 && diag_k >= 0 && diag_k < width && prev[diag_k] < INF)
                best = std::min(best, prev[diag_k] + (a[i - 1] != b[j - 1] ? 1 : 0));
            if (k > 0 && cur[k - 1] < INF)            // D[i][j-1]
                best = std::min(best, cur[k - 1] + 1);
            cur[k] = best;
        }
        std::swap(prev, cur);
        prev_center = center;
    }
    int k = m - prev_center + band;
    if (k < 0 || k >= width || prev[k] >= INF) return -1;  // band exceeded
    return prev[k];
}

}  // extern "C"
