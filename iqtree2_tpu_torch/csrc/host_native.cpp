// Native host runtime of iqtree2_tpu_torch: the CPU-side components that
// the reference implements in C/C++ — alignment pattern compression
// (reference: Alignment::buildPattern, alignment/alignment.cpp:1725) and
// bit-parallel Fitch parsimony (tree/phylotreepars.cpp:32).
//
// Copied from native/iqtree2_native.cpp, the two entry points the port
// calls. Exposed through a plain C ABI consumed by iqtree2_tpu_torch/
// native.py via ctypes; every entry point is pure (caller-allocated
// buffers, no global state) so the numpy fallbacks remain drop-in
// equivalent.

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
