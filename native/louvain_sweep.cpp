// One Louvain local-move sweep over a dense weighted graph.
//
// Replaces the python-louvain dependency's hot loop (the reference runs
// community.best_partition on a COMPLETE graph over the matrix tail,
// scaffoldToChromosomes.py:239-349); the framework's seeded Louvain
// (cluster/louvain.py) drives this sweep from a host loop that owns the
// pass/level structure and the RNG.
//
// Bit-exactness contract with the numpy oracle (_one_level_numpy):
// every float op reproduces the numpy form's per-element sequence —
//   link accumulated by scatter-add in index order (np.bincount),
//   gain[c] = link[c] - (sigma_tot[c] * k_node) / two_m
//     (multiply, then divide, then subtract — the divide feeding the
//      subtract also means no FMA contraction is possible),
//   argmax keeps the FIRST maximal index (numpy argmax tie rule),
//   sigma_tot updated -=/+= in the same visit order.
// The sweep is inherently sequential (every accepted move changes the
// state the next visit reads), so this is single-threaded C replacing
// per-visit numpy dispatch overhead with a fused
// scan+gain+argmax pass — and is also why the SURVEY §2b idea of
// evaluating gains on DEVICE does not pay: one dispatch round trip per
// visit would be latency-bound at any scale (see cluster/louvain.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Runs one full sweep of local moves in `perm` order.
// a_tilde: n*n row-major, symmetric, diagonal doubled (see louvain._prep)
// k:       per-node degrees (a_tilde row sums), length n
// comm:    in/out community id per node, length n
// sigma:   in/out per-community degree sums, length n
// perm:    visit order, length n
// scratch: caller-provided f64 buffer, length n (link accumulator)
// Returns 1 if any move was accepted, else 0.
int louvain_sweep_f64(const double* a_tilde, const double* k, double two_m,
                      int64_t* comm, double* sigma, const int64_t* perm,
                      double* scratch, int64_t n, double min_gain) {
    int improved = 0;
    double* link = scratch;
    for (int64_t v = 0; v < n; ++v) {
        const int64_t node = perm[v];
        const int64_t c_old = comm[node];
        const double* row = a_tilde + node * n;
        const double kn = k[node];

        // link[c] = sum of row weights into community c, index order
        std::memset(link, 0, sizeof(double) * n);
        for (int64_t j = 0; j < n; ++j) link[comm[j]] += row[j];
        // self-loop excluded from the node's own community weight
        link[c_old] -= row[node];

        sigma[c_old] -= kn;

        // fused gains + first-max argmax; gains[c_old] is `base`
        // (numpy: with two_m != 0 the vector entry already equals base;
        //  with two_m == 0 numpy overrides it to 0.0)
        const double base =
            two_m != 0.0 ? link[c_old] - (sigma[c_old] * kn) / two_m : 0.0;
        // argmax replicates numpy's NaN rule exactly: the running max is
        // updated on `!(g <= best)` (true for g > best AND for NaN), and
        // the scan stops once the max is NaN — so a NaN gain wins at its
        // FIRST index, like np.argmax (ADVICE r4 #3: plain `g > best`
        // silently diverged from the oracle on non-finite input).
        int64_t best = 0;
        double best_gain;
        if (two_m != 0.0) {
            best_gain = link[0] - (sigma[0] * kn) / two_m;
            if (best_gain == best_gain) {
                for (int64_t c = 1; c < n; ++c) {
                    const double g = link[c] - (sigma[c] * kn) / two_m;
                    if (!(g <= best_gain)) {
                        best_gain = g; best = c;
                        if (g != g) break;
                    }
                }
            }
        } else {
            best_gain = c_old == 0 ? base : link[0];
            if (best_gain == best_gain) {
                for (int64_t c = 1; c < n; ++c) {
                    const double g = c == c_old ? base : link[c];
                    if (!(g <= best_gain)) {
                        best_gain = g; best = c;
                        if (g != g) break;
                    }
                }
            }
        }

        if (best_gain - base > min_gain) {
            comm[node] = best;
            improved = 1;
        } else {
            comm[node] = c_old;
        }
        sigma[comm[node]] += kn;
    }
    return improved;
}

}  // extern "C"
