// Banded Levenshtein distance of read identity, a frozen copy of the
// program's host library (native/overlap.cpp) for the benchmark's
// read_identity metric.  Built with g++ at first use into the
// benchmark's build directory and bound with ctypes (portbench/identity.py).

#include <algorithm>
#include <vector>

extern "C" {

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
