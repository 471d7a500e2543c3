// Native host runtime of iqtree2_tpu_torch: the CPU-side components that
// the reference implements in C/C++ — alignment pattern compression
// (reference: Alignment::buildPattern, alignment/alignment.cpp:1725),
// bit-parallel Fitch parsimony (tree/phylotreepars.cpp:32) and the edge
// costs of one randomized stepwise-addition step
// (pll/fastDNAparsimony.c).
//
// Copied from native/iqtree2_native.cpp, the two entry points the port
// calls; the stepwise-addition costs are the port's own, the arithmetic of
// ops/pars.random_stepwise_addition's numpy loop. Exposed through a plain C ABI consumed by iqtree2_tpu_torch/
// native.py via ctypes; every entry point is pure (caller-allocated
// buffers, no global state) so the numpy fallbacks remain drop-in
// equivalent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Pattern compression: site columns -> unique patterns + weights.
// codes: [L * nsites] int32 (taxon-major rows); outputs:
//   out_patterns [L * nsites] (only the first n_pat columns valid),
//   out_weights [nsites], out_site2pat [nsites].
// Returns the number of unique patterns.
int64_t it2_compress_patterns(const int32_t* codes, int64_t L,
                              int64_t nsites, int32_t* out_patterns,
                              double* out_weights,
                              int32_t* out_site2pat) {
    std::unordered_map<std::string, int64_t> seen;
    seen.reserve(static_cast<size_t>(nsites) * 2);
    std::string key(static_cast<size_t>(L) * sizeof(int32_t), '\0');
    std::vector<int32_t> col(L);
    int64_t n_pat = 0;
    for (int64_t s = 0; s < nsites; s++) {
        for (int64_t t = 0; t < L; t++) col[t] = codes[t * nsites + s];
        std::memcpy(&key[0], col.data(), key.size());
        auto it = seen.find(key);
        if (it == seen.end()) {
            int64_t p = n_pat++;
            seen.emplace(key, p);
            for (int64_t t = 0; t < L; t++)
                out_patterns[t * nsites + p] = col[t];
            out_weights[p] = 1.0;
            out_site2pat[s] = static_cast<int32_t>(p);
        } else {
            out_weights[it->second] += 1.0;
            out_site2pat[s] = static_cast<int32_t>(it->second);
        }
    }
    return n_pat;
}

// ---------------------------------------------------------------------
// Bit-parallel weighted Fitch score over a postorder schedule.
// masks: [L * P] uint64 state bitmasks; w: [P] weights;
// child_src: [n_int * 2] unified child rows (tips < L, internal L+i).
// Scratch: sets [(L + n_int) * P] uint64 is caller-allocated.
double it2_fitch_score(const uint64_t* masks, const double* w,
                       const int32_t* child_src, int64_t n_int,
                       int64_t L, int64_t P, uint64_t* sets) {
    std::memcpy(sets, masks,
                static_cast<size_t>(L) * P * sizeof(uint64_t));
    double cost = 0.0;
    for (int64_t i = 0; i < n_int; i++) {
        const uint64_t* a = sets + static_cast<int64_t>(
            child_src[2 * i]) * P;
        const uint64_t* b = sets + static_cast<int64_t>(
            child_src[2 * i + 1]) * P;
        uint64_t* o = sets + (L + i) * P;
        for (int64_t p = 0; p < P; p++) {
            uint64_t inter = a[p] & b[p];
            if (inter) {
                o[p] = inter;
            } else {
                o[p] = a[p] | b[p];
                cost += w[p];
            }
        }
    }
    return cost;
}

}  // extern "C"

namespace {

// Fitch combine of two state sets: a & b where it is not empty, else
// a | b; with masks rather than a branch, so that SSE2 vectorizes it.
template <typename T>
inline T fitch(T a, T b) {
    const T inter = a & b;
    return inter | ((a | b) & static_cast<T>(-static_cast<T>(inter == 0)));
}

// o = fitch(a, b) over n patterns (o may alias a).
template <typename T>
inline void fitch_into(T* o, const T* a, const T* b, int64_t n) {
    for (int64_t p = 0; p < n; p++) o[p] = fitch(a[p], b[p]);
}

// Costs of inserting a leaf of state masks x on every edge of a tree given
// in postorder from its root: post_v/post_p [n_post] (parent -1 at the
// root), the children of entry i in adjacency order kids[kid_off[i] ..
// kid_off[i + 1]) (none for a leaf). Down sets are the Fitch sets of the
// subtrees, up sets the sets seen from the parent side, each folded over
// the other children in order and then the node's own up set; edge (v, p)
// costs the weight of the patterns where x misses combine(down v, up v).
// The patterns go in tiles, so a tile's sets of every node stay in cache;
// the weights are pattern counts and the costs their integer sums, exact
// in any order. Scratch: down and up [n_nodes * tile], has_up [n_nodes];
// cost [edges] is written.
template <typename T>
void stepwise_costs(const T* masks, const T* x, const int32_t* w, int64_t P,
                    const int32_t* post_v, const int32_t* post_p,
                    const int32_t* kid_off, const int32_t* kids,
                    int64_t n_post, int64_t tile, T* down, T* up,
                    uint8_t* has_up, int64_t* cost) {
    int64_t n_edges = 0;
    for (int64_t i = 0; i < n_post; i++) n_edges += post_p[i] >= 0;
    std::fill(cost, cost + n_edges, int64_t{0});
    for (int64_t p0 = 0; p0 < P; p0 += tile) {
        const int64_t n = std::min(tile, P - p0);
        for (int64_t i = 0; i < n_post; i++) {  // down sets
            T* d = down + static_cast<int64_t>(post_v[i]) * tile;
            const int32_t k0 = kid_off[i], k1 = kid_off[i + 1];
            if (k0 == k1) {
                std::memcpy(d, masks + static_cast<int64_t>(post_v[i]) * P
                                + p0, n * sizeof(T));
                continue;
            }
            std::memcpy(d, down + static_cast<int64_t>(kids[k0]) * tile,
                        n * sizeof(T));
            for (int32_t k = k0 + 1; k < k1; k++)
                fitch_into(d, d, down + static_cast<int64_t>(kids[k]) * tile,
                           n);
        }
        has_up[post_v[n_post - 1]] = 0;
        for (int64_t i = n_post - 1; i >= 0; i--) {  // up sets, preorder
            const int32_t v = post_v[i], k0 = kid_off[i], k1 = kid_off[i + 1];
            const T* uv = up + static_cast<int64_t>(v) * tile;
            for (int32_t k = k0; k < k1; k++) {
                T* uu = up + static_cast<int64_t>(kids[k]) * tile;
                bool have = false;
                for (int32_t k2 = k0; k2 < k1; k2++) {
                    if (k2 == k) continue;
                    const T* d2 = down + static_cast<int64_t>(kids[k2]) * tile;
                    if (have)
                        fitch_into(uu, uu, d2, n);
                    else
                        std::memcpy(uu, d2, n * sizeof(T));
                    have = true;
                }
                if (has_up[v]) {
                    if (have)
                        fitch_into(uu, uu, uv, n);
                    else
                        std::memcpy(uu, uv, n * sizeof(T));
                    have = true;
                }
                has_up[kids[k]] = have;
            }
        }
        int64_t e = 0;
        for (int64_t i = 0; i < n_post; i++) {  // edge costs
            if (post_p[i] < 0) continue;
            const int32_t v = post_v[i];
            const T* d = down + static_cast<int64_t>(v) * tile;
            const T* u = up + static_cast<int64_t>(v) * tile;
            const T* xt = x + p0;
            const int32_t* wt = w + p0;
            int32_t c = 0;
            if (has_up[v]) {
                for (int64_t p = 0; p < n; p++)
                    c += wt[p] & -static_cast<int32_t>((fitch(d[p], u[p]) & xt[p]) == 0);
            } else {
                for (int64_t p = 0; p < n; p++)
                    c += wt[p] & -static_cast<int32_t>((d[p] & xt[p]) == 0);
            }
            cost[e++] += c;
        }
    }
}

}  // namespace

#define IT2_STEPWISE_COSTS(SUFFIX, T)                                        \
    extern "C" void it2_stepwise_costs_##SUFFIX(                             \
        const T* masks, const T* x, const int32_t* w, int64_t P,             \
        const int32_t* post_v, const int32_t* post_p, const int32_t* kid_off, \
        const int32_t* kids, int64_t n_post, int64_t tile, T* down, T* up,  \
        uint8_t* has_up, int64_t* cost) {                                    \
        stepwise_costs<T>(masks, x, w, P, post_v, post_p, kid_off, kids,     \
                          n_post, tile, down, up, has_up, cost);             \
    }

IT2_STEPWISE_COSTS(u8, uint8_t)
IT2_STEPWISE_COSTS(u32, uint32_t)
IT2_STEPWISE_COSTS(u64, uint64_t)
