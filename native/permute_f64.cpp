// Threaded symmetric permutation gather: out[i, j] = m[ord[i], ord[j]].
//
// Replaces numpy's single-threaded fancy-index gather for the
// leaf-order reorder of the full contact matrix
// (scaffoldToChromosomes.py:157-163 `matrix[:, order][order]`;
// part1_cluster.py applies the same permute after UPGMA).  At 16K the
// np.ix_ form moves 2.1 GB single-threaded and cache-hostile;
// this kernel threads over output-row blocks and keeps the inner gather
// within one 128 KB source row (L2-resident), so it runs at memory
// bandwidth.  Bit-identical trivially: pure data movement.
//
// C ABI (ctypes):
//   permute_symmetric_f64(m, ord, out, n_src, n_out)
//
// n_out may be < n_src (row/col subset gather, e.g. zero-row pruning).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

void permute_symmetric_f64(const double* m, const int64_t* ord, double* out,
                           int64_t n_src, int64_t n_out) {
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? hw : 1;
    if (n_out < 1024) n_threads = 1;
    if (n_threads > static_cast<size_t>(n_out))
        n_threads = static_cast<size_t>(n_out);

    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const double* src = m + ord[i] * n_src;
            double* dst = out + i * n_out;
            for (int64_t j = 0; j < n_out; ++j) dst[j] = src[ord[j]];
        }
    };
    if (n_threads == 1) {
        work(0, n_out);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n_out + static_cast<int64_t>(n_threads) - 1) /
                    static_cast<int64_t>(n_threads);
    for (size_t t = 0; t < n_threads; ++t) {
        int64_t lo = static_cast<int64_t>(t) * chunk;
        int64_t hi = lo + chunk < n_out ? lo + chunk : n_out;
        if (lo >= hi) break;
        pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
