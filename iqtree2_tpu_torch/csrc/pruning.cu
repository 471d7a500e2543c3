// Felsenstein pruning kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels carry every likelihood contract of the JAX package's Pallas
// kernels (iqtree2_tpu/ops/pallas_pruning.py, pallas_pruning2.py):
//
//   down_pass    the whole postorder pass in one launch: for every level
//                step, child messages, product, per-pattern rescale, partial
//                and scale count written into the unified buffer; given an
//                lp buffer, an epilogue in the same launch folds leaf 0 into
//                the root row and writes the site log-likelihoods (weighted
//                root sum, log, scale, invariant-site logaddexp)
//                (T1/T2/T4/T5/T6: down_sitelp_pallas, down_pass_pallas,
//                stream_pass in its three modes)
//   up_pass      the whole pre-order sweep in one launch: outside partial E
//                per child edge and UP per internal child, each rescaled
//                (T3/T7: up_pass_pallas, stream_up_pass)
//   theta_pass   the same sweep (up_pass_kernel's THETA instance) with
//                theta = (U^T E) * (V down_child) and its scale formed per
//                edge from the E the thread holds, so E is never written
//                (past 64 states E lives in a workspace, not in E's rows);
//                a prologue sets UP(root) and theta of edge 0
//                (T8: stream_theta_pass)
//
// Layout is the JAX package's, pattern-last everywhere:
//   all   [L + n_int, C, S, Pp]  unified partials (rows 0..L-1 are the tips'
//                                rows, which no kernel reads: tips come
//                                from `tip`)
//   sc    [L + n_int, Pp] int32  scale counts (tip rows 0)
//   tip   [L, S, Pp]             leaf partials (category independent)
//   P     [E, C, S, S]           transition tensors
//   theta [E, C, S, Pp]          theta rows by edge id
//   step_node [n_steps, G] int32 level steps of tree/schedule.py, padded
//                                with n_int
// Up to 64 states one thread owns one pattern of one node (or edge) and
// loops over the node's C*S values itself, so the per-pattern rescale max
// over all C*S values needs no cross-thread reduction. Above 64 states (PoMo
// from N = 13, wide --mdef datatypes) the wide instance splits a node's
// states across the block's threads instead (see "the wide instance" below).
//
// The passes walk the tree inside the launch, as every Pallas pass did.
// Patterns are independent, so the grid cuts them into tiles of kTile = 32
// and each block walks all level steps for its tile (in reverse for
// up_pass), with one __syncthreads() between steps: a step reads rows that
// other warps of the block wrote in earlier steps, and nothing crosses
// blocks, so no grid-wide synchronisation is needed. Within a step, warp w
// takes node slots w, w + kWarps, ... (up_pass: (slot, child) items), so
// the 32 lanes of a warp are 32 consecutive patterns of one node: loads and
// stores are coalesced and every lane reads the same transition matrices.
// A warp stages its slot's two matrix sets (2*C*S*S values) in shared
// memory when kWarps of them fit in kStageBytes (DNA always; LG+G4 in
// float32 would need 102 KB, and there the matrices are read through the
// cache). Partials and E are written once, already rescaled: at S <= 4 and
// C <= kRegCats the column stays in registers until its max is known;
// wider columns are computed twice, once for the max and once to store,
// which costs arithmetic the card has to spare instead of a second trip
// through device memory (for DNA the register column is 8-24% faster,
// PERF.md). The sweeps take UP(child) = P_k^T E from the E they hold in
// registers (DNA). A wider column computes E twice (max, then per
// category E and its UP values), and stores UP as it forms it, before
// UP's max is known; the few columns whose max then falls below the
// threshold are multiplied by 2^B in place, by the thread that stored
// them. The factor is a power of two, so the values are those a
// rescale-then-store would have written. E's store sweep and UP's loops
// over states are unrolled up to S = 20, E's max sweep is not (unrolled it
// was slower), and the codon width keeps its columns in local memory
// rather than unroll 64 x 64 products. Rows written earlier
// in the same launch (all and sc in down_pass, up and upsc in the sweeps)
// are read with plain loads or cp.async.ca, both through L1, never through
// the read-only __ldg path, which may return stale lines within one launch.
//
// Prefetch (float32, S <= 4: DNA): a slot's inputs, its two matrix sets,
// two columns (down: the children; up: UP(node) and the sibling) and two
// scale counts, are issued as cp.async copies into the warp's buffer in
// shared memory, each lane its own pattern, and waited for once; the next
// slot's copies are issued as soon as the warp is done with the buffer.
// Plain loads of a slot's columns came in several dependent round trips
// (one per category and child), which bound the narrow steps of a deep
// tree. One buffer (38 KB a block with the matrices) keeps 4 blocks per
// SM; two would not. On the H100 it took 1000 x 16384 from 1.47 to 1.39
// ms down and 4.06 to 2.96 ms up, the flagship's up pass from 0.042 to
// 0.035 ms, and cost the flagship's down pass 0.024 -> 0.026 ms
// (PERF.md). float64 and wider states keep plain loads: their buffers
// would not leave room for 4 blocks per SM.
//
// Site log-likelihoods (down_pass epilogue): after the last step's
// __syncthreads() the block's root row is complete, and warp 0 folds it
// for the tile's 32 patterns (root row and its scale by plain loads: they
// were written in this launch). A separate launch used to re-read that row
// and cost the host an operand check, an allocation and a launch per
// log-likelihood; the arithmetic is kept, operation for operation, so the
// float32 values are the same to the bit.
//
// theta_pass: an item (node, child slot k) forms E_k as up_pass does, then
// per category a = U^T E_k and b = V D_k, where D_k is child k's own down
// column (tip or internal row), and writes theta = a * b with scale
// e_count + dsc[child]; then UP(child) from E_k as up_pass does, into the
// UP rows the later steps read. U and V ([C, S, S] each) are staged once
// per block in shared memory when they fit. E (2 GB at 1000 x 16384) is
// never written or read back, in any column width: a wide column's E lives
// one category at a time in registers, where theta and UP are formed from
// it. With the float32 DNA prefetch the child's column and count are a
// third column in the warp's buffer: 55.5 KB a block with U and V, and 4
// blocks of that still fit an SM's 228 KB (pass_shape; the wrapper's
// occupancy query reports the figure).
//
// What bounds them on the card: memory bandwidth, and at the narrow steps
// of a deep tree the latency of each step's dependent loads. A DNA step
// reads two child partials and writes one (C*S*3 values per pattern) for
// 2*C*S*S multiply-adds: under 2 flops per byte in float32 at S = 4 and
// about 10 at S = 20, below the H100's float32 ridge of about 20 (67
// TFLOP/s at 3.35 TB/s). So there is no work for tensor cores (and TF32 is
// off by the precision policy, ops/prec.py); the design moves each value
// once per pass and keeps one block's steps back to back without a launch
// or a host round trip between them.
//
// The kernels allocate nothing, never synchronise the device, and launch on
// the stream they are given. Each extern "C" launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kTile = 32;      // patterns per block of the passes: one warp wide
constexpr int kWarps = 8;      // warps per block of the passes
// __launch_bounds__ minimum of resident blocks per SM of the S <= 4 passes:
// 4 caps a thread at 64 registers, so all 512 blocks of a 16384-pattern
// pass are resident at once (one wave); with 2-3 resident blocks the pass
// runs in two waves and took 1.5x (down) to 2.5x (up) as long on the H100
// (tools/torch_pass_variants.py)
constexpr int kMinBlocks = 4;
// ... and of the protein and codon instances (S > 4): their columns need
// far more than 64 registers, and held to 4 blocks they spill; with no
// minimum the LG+G4 passes at 64 x 4096 ran 1.2x to 1.7x (float32) and
// 1.7x to 2.8x (float64) faster
constexpr int kMinBlocksWide = 1;
constexpr int kRegCats = 4;    // categories whose S <= 4 column stays in registers
constexpr size_t kStageBytes = 48 * 1024;  // shared memory for staged matrices (and buffers)
constexpr bool kPrefetch = true;  // float S <= 4 passes: inputs by cp.async into buffers

// Rescale constants of ops/pruning.scaling_consts: B = 30 for float32,
// B = 256 for float64; partials are kept in [2^-B, 1].
template <typename T>
struct Scaling;

template <>
struct Scaling<float> {
  static constexpr float thresh = 0x1p-30f;
  static constexpr float factor = 0x1p30f;
  static constexpr float log_factor = (float)(30.0 * 0.69314718055994530942);
  static constexpr float tiny = FLT_MIN;
};

template <>
struct Scaling<double> {
  static constexpr double thresh = 0x1p-256;
  static constexpr double factor = 0x1p256;
  static constexpr double log_factor = 256.0 * 0.69314718055994530942;
  static constexpr double tiny = DBL_MIN;
};

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// Product and sum rounded each on its own (never contracted into an fma).
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
#else
template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) { return a * b; }
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) { return a + b; }
#endif

// logaddexp that keeps -inf + -inf at -inf (padded patterns carry
// log_ptn_invar = -inf; a - b would be NaN there).
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  const T m = a > b ? a : b;
  if (m == -(T)INFINITY) return m;
  return m + dlog1p(dexp(-dabs(a - b)));
}

// out[x] = sum_y M[x, y] * v[y] for row x of an S x S matrix in device
// memory (read-only for the whole launch).
template <typename T, int SMAX>
__device__ __forceinline__ T row_dot(const T* __restrict__ M, const T (&v)[SMAX], int x,
                                     int S) {
  T acc = 0;
#pragma unroll
  for (int y = 0; y < SMAX; ++y)
    if (y < S) acc += __ldg(M + x * S + y) * v[y];
  return acc;
}

// row_dot for a matrix that is staged in shared memory or read in place
// (a generic pointer; plain loads).
template <typename T, int SMAX>
__device__ __forceinline__ T row_dot_s(const T* M, const T* v, int x, int S) {
  T acc = 0;
#pragma unroll
  for (int y = 0; y < SMAX; ++y)
    if (y < S) acc += M[x * S + y] * v[y];
  return acc;
}

// out[y] = sum_x M[x, y] * v[x] (transposed product).
template <typename T, int SMAX>
__device__ __forceinline__ T col_dot_s(const T* M, const T* v, int y, int S) {
  T acc = 0;
#pragma unroll
  for (int x = 0; x < SMAX; ++x)
    if (x < S) acc += M[x * S + y] * v[x];
  return acc;
}

// One [C, S] column at one pattern: value (c, y) at base[c * cs + y * ys]
// (cs = 0 for a tip, whose partial does not depend on the category).
template <typename T>
struct Col {
  const T* base;
  size_t cs, ys;
};

// Column of unified row `src` at pattern p in device memory: tips from the
// compact tip rows, internal nodes from the unified buffer. Read with plain
// loads: down_pass writes those rows in the same launch.
template <typename T>
__device__ __forceinline__ Col<T> child_col(const T* tip, const T* all, int src, int L, int S,
                                            size_t CS, size_t Pp, int p) {
  if (src < L) return {tip + (size_t)src * S * Pp + p, 0, Pp};
  return {all + (size_t)src * CS * Pp + p, (size_t)S * Pp, Pp};
}

// The same column as copied into a warp's shared-memory buffer: row r of it
// (r = c * S + y; a tip has S rows) at buf[r * kTile + lane].
template <typename T>
__device__ __forceinline__ Col<T> buffer_col(const T* buf, bool is_tip, int S, int lane) {
  return {buf + lane, is_tip ? 0 : (size_t)S * kTile, (size_t)kTile};
}

template <typename T, int SMAX>
__device__ __forceinline__ void load_col(T (&v)[SMAX], const Col<T>& col, int c, int S) {
  const T* b = col.base + c * col.cs;
#pragma unroll
  for (int y = 0; y < SMAX; ++y) v[y] = y < S ? b[y * col.ys] : T(0);
}

// cp.async of one value from device to shared memory, through L1 like the
// plain loads it replaces (never the read-only path). Completion is waited
// for by cp_async_wait(); the mock build copies at once.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Copies a column of `rows` rows (g: its view in device memory) into a
// warp's buffer, each lane its own pattern.
template <typename T>
__device__ __forceinline__ void prefetch_col(T* buf, const Col<T>& g, int rows, int lane) {
  for (int r = 0; r < rows; ++r) cp_async(buf + r * kTile + lane, g.base + r * g.ys);
}

// The matrix sets of edges e0 and e1 for one warp's node slot: copied into
// the warp's shared-memory slice (then M0 = slice, M1 = slice + C*S*S), or
// pointed at in device memory when the slices do not fit. The whole warp
// calls it; the caller __syncwarp()s before the slice is refilled.
template <typename T>
__device__ __forceinline__ void warp_matrices(const T* __restrict__ P, int e0, int e1,
                                              size_t CSS, T* slice, bool staged,
                                              const T*& M0, const T*& M1, int lane) {
  const T* g0 = P + (size_t)e0 * CSS;
  const T* g1 = P + (size_t)e1 * CSS;
  if (!staged) {
    M0 = g0;
    M1 = g1;
    return;
  }
  for (size_t i = lane; i < CSS; i += 32) {
    slice[i] = __ldg(g0 + i);
    slice[CSS + i] = __ldg(g1 + i);
  }
  __syncwarp();
  M0 = slice;
  M1 = slice + CSS;
}

// The same, issued as cp.async copies (waited for with the columns).
template <typename T>
__device__ __forceinline__ void prefetch_matrices(const T* __restrict__ P, int e0, int e1,
                                                  size_t CSS, T* slice, int lane) {
  const T* g0 = P + (size_t)e0 * CSS;
  const T* g1 = P + (size_t)e1 * CSS;
  for (size_t i = lane; i < CSS; i += 32) {
    cp_async(slice + i, g0 + i);
    cp_async(slice + CSS + i, g1 + i);
  }
}

// The first item i, i + kWarps, ... (from i on) of a step row whose node
// (row[i >> SHIFT]) is not a pad slot; n if there is none.
template <int SHIFT>
__device__ __forceinline__ int next_item(const int* row, int i, int n, int n_int) {
  while (i < n && row[i >> SHIFT] >= n_int) i += kWarps;
  return i;
}

// ------------------------------------------------- down_pass column body
// A node's partial at one pattern: msg_k = P_k . child_k per category, the
// product, the max over all C*S values, stored once already rescaled at
// out[(c * S + x) * Pp], and its scale count (the children's counts + 1 if
// it was rescaled).
template <typename T, int SMAX, bool REG>
__device__ __forceinline__ void down_column(const T* M0, const T* M1, const Col<T>& a_col,
                                            const Col<T>& b_col, int count, T* out,
                                            int* sc_out, int C, int S, size_t Pp) {
  const size_t SS = (size_t)S * S;
  T mx = 0;
  bool low;
  if constexpr (REG) {  // S <= SMAX = 4 and C <= kRegCats: the column in registers
    T col[kRegCats * SMAX];
#pragma unroll
    for (int c = 0; c < kRegCats; ++c) {
      if (c < C) {
        T a[SMAX], b[SMAX];
        load_col(a, a_col, c, S);
        load_col(b, b_col, c, S);
#pragma unroll
        for (int x = 0; x < SMAX; ++x) {
          const T v = x < S ? row_dot_s<T, SMAX>(M0 + c * SS, a, x, S) *
                                  row_dot_s<T, SMAX>(M1 + c * SS, b, x, S)
                            : T(0);
          col[c * SMAX + x] = v;
          mx = v > mx ? v : mx;
        }
      }
    }
    low = mx < Scaling<T>::thresh;
    const T f = low ? Scaling<T>::factor : T(1);
#pragma unroll
    for (int c = 0; c < kRegCats; ++c)
#pragma unroll
      for (int x = 0; x < SMAX; ++x)
        if (c < C && x < S) out[(size_t)(c * S + x) * Pp] = col[c * SMAX + x] * f;
  } else {  // first sweep: the max; second sweep: the same products, stored
    for (int c = 0; c < C; ++c) {
      T a[SMAX], b[SMAX];
      load_col(a, a_col, c, S);
      load_col(b, b_col, c, S);
      for (int x = 0; x < S; ++x) {
        const T v = row_dot_s<T, SMAX>(M0 + c * SS, a, x, S) *
                    row_dot_s<T, SMAX>(M1 + c * SS, b, x, S);
        mx = v > mx ? v : mx;
      }
    }
    low = mx < Scaling<T>::thresh;
    const T f = low ? Scaling<T>::factor : T(1);
    for (int c = 0; c < C; ++c) {
      T a[SMAX], b[SMAX];
      load_col(a, a_col, c, S);
      load_col(b, b_col, c, S);
      for (int x = 0; x < S; ++x)
        out[(size_t)(c * S + x) * Pp] = row_dot_s<T, SMAX>(M0 + c * SS, a, x, S) *
                                        row_dot_s<T, SMAX>(M1 + c * SS, b, x, S) * f;
    }
  }
  *sc_out = count + (low ? 1 : 0);
}

// ------------------------------------------------ down_pass epilogue body
// Site log-likelihood at one pattern: leaf 0's message P_0 . tip_0 times
// the root row B, weighted by root_freqs and cat_weight, summed, logged,
// less the scale, logaddexp'd with the invariant-site term. B and count
// were written in this launch (plain loads).
template <typename T, int SMAX>
__device__ __forceinline__ T site_loglik(const T* __restrict__ P0, const T* __restrict__ tip0,
                                         const T* B, int count, const T* __restrict__ root_freqs,
                                         const T* __restrict__ cat_weight, T log_inv, int C,
                                         int S, size_t Pp) {
  T t0[SMAX];
#pragma unroll
  for (int y = 0; y < SMAX; ++y) t0[y] = y < S ? __ldg(tip0 + (size_t)y * Pp) : T(0);
  T site = 0;
  for (int c = 0; c < C; ++c) {
    const T* Pc = P0 + (size_t)c * S * S;
    T lh = 0;
    for (int x = 0; x < S; ++x)
      lh += __ldg(root_freqs + c * S + x) * (B[(size_t)(c * S + x) * Pp] * row_dot(Pc, t0, x, S));
    site += __ldg(cat_weight + c) * lh;
  }
  const T l = dlog(site > Scaling<T>::tiny ? site : Scaling<T>::tiny) -
              (T)count * Scaling<T>::log_factor;
  return logaddexp(l, log_inv);
}

// E values (one category) of a wide column, rescaled by fe: ev[x] =
// upn[x * ys] * (Mj . b)[x] * fe.
template <typename T, int SMAX>
__device__ __forceinline__ void e_column(T (&ev)[SMAX], const T* upn, size_t ys, const T* Mj,
                                         const T (&b)[SMAX], int S, T fe) {
#pragma unroll (SMAX <= 20 ? SMAX : 1)
  for (int x = 0; x < SMAX; ++x)
    ev[x] = x < S ? upn[x * ys] * row_dot_s<T, SMAX>(Mj, b, x, S) * fe : T(0);
}

// theta of one category of an edge at one pattern: out[(c * S + k) * Pp] =
// (sum_x U[c, x, k] E[c, x]) * (sum_y V[c, k, y] D[c, y]), from the
// category's E values ev and the edge's child column d. The loop over k is
// unrolled for DNA only: unrolled at S = 20 the protein instances spilled
// 1-3 KB and the LG+G4 theta pass at 64 x 4096 took 6.3 ms instead of 3.9
// (float32, PERF.md).
template <typename T, int SMAX>
__device__ __forceinline__ void theta_column(const T* ev, const T* Uc, const T* Vc,
                                             const Col<T>& d, int c, int S, T* out,
                                             size_t Pp) {
  T dv[SMAX];
  load_col(dv, d, c, S);
#pragma unroll (SMAX <= 4 ? SMAX : 1)
  for (int k = 0; k < SMAX; ++k)
    if (k < S)
      out[(size_t)(c * S + k) * Pp] =
          col_dot_s<T, SMAX>(Uc, ev, k, S) * row_dot_s<T, SMAX>(Vc, dv, k, S);
}

// What theta_pass needs of an item besides up_pass's inputs, and where its
// theta goes (unused by up_pass).
template <typename T>
struct ThetaArgs {
  const T* U;   // [C, S, S] eigenvectors per category (shared or device memory)
  const T* V;
  Col<T> d;     // the child's own down column
  int d_count;  // and its scale count
  T* theta;     // the edge's theta row at this pattern
  int* tsc;     // and its scale count
};

// --------------------------------------------------- up_pass column body
// Child slot k of a node at one pattern: E of edge ek = UP(node) x msg of
// the sibling (msg = P_j . down(sibling)), rescaled, with scale count
// e_base (+1); up_pass stores it at Ek with its count, theta_pass (THETA)
// turns it into the edge's theta instead (Ek unused). Then, for an
// internal child, UP(child) = P_k^T E, rescaled, stored at uc with scale
// count esc (+1). Mj/Mk: the matrix sets of the sibling's and the child's
// edges; upn: UP(node).
template <typename T, int SMAX, bool REG, bool THETA>
__device__ __forceinline__ void up_column(const T* Mj, const T* Mk, const Col<T>& upn,
                                          const Col<T>& b_col, int e_base, T* Ek, int* esc_out,
                                          T* uc, int* upsc_out, const ThetaArgs<T>& th, int C,
                                          int S, size_t Pp) {
  const size_t SS = (size_t)S * S;
  const bool internal = uc != nullptr;
  T mx = 0;
  if constexpr (REG) {  // S <= SMAX = 4 and C <= kRegCats: E and UP in registers
    T e[kRegCats * SMAX];
#pragma unroll
    for (int c = 0; c < kRegCats; ++c) {
      if (c < C) {
        T b[SMAX];
        load_col(b, b_col, c, S);
#pragma unroll
        for (int x = 0; x < SMAX; ++x) {
          const T v = x < S ? upn.base[c * upn.cs + x * upn.ys] *
                                  row_dot_s<T, SMAX>(Mj + c * SS, b, x, S)
                            : T(0);
          e[c * SMAX + x] = v;
          mx = v > mx ? v : mx;
        }
      }
    }
    const bool low_e = mx < Scaling<T>::thresh;
    const T fe = low_e ? Scaling<T>::factor : T(1);
#pragma unroll
    for (int c = 0; c < kRegCats; ++c)
#pragma unroll
      for (int x = 0; x < SMAX; ++x)
        if (c < C && x < S) {
          e[c * SMAX + x] *= fe;
          if constexpr (!THETA) Ek[(size_t)(c * S + x) * Pp] = e[c * SMAX + x];
        }
    const int e_count = e_base + (low_e ? 1 : 0);
    if constexpr (THETA) {
#pragma unroll
      for (int c = 0; c < kRegCats; ++c)
        if (c < C)
          theta_column<T, SMAX>(e + c * SMAX, th.U + c * SS, th.V + c * SS, th.d, c, S,
                                th.theta, Pp);
      *th.tsc = e_count + th.d_count;
    } else {
      *esc_out = e_count;
    }
    if (!internal) return;  // leaf child: no outside partial to propagate
    T u[kRegCats * SMAX];
    mx = 0;
#pragma unroll
    for (int c = 0; c < kRegCats; ++c)
#pragma unroll
      for (int y = 0; y < SMAX; ++y) {
        const T v = (c < C && y < S) ? col_dot_s<T, SMAX>(Mk + c * SS, e + c * SMAX, y, S)
                                     : T(0);
        u[c * SMAX + y] = v;
        mx = v > mx ? v : mx;
      }
    const bool low_u = mx < Scaling<T>::thresh;
    const T fu = low_u ? Scaling<T>::factor : T(1);
#pragma unroll
    for (int c = 0; c < kRegCats; ++c)
#pragma unroll
      for (int y = 0; y < SMAX; ++y)
        if (c < C && y < S) uc[(size_t)(c * S + y) * Pp] = u[c * SMAX + y] * fu;
    *upsc_out = e_count + (low_u ? 1 : 0);
  } else {  // E's max; then per category E (stored, or turned into theta) and
            // UP, stored as formed; UP rescaled in place if its max is low
    for (int c = 0; c < C; ++c) {
      T b[SMAX];
      load_col(b, b_col, c, S);
      for (int x = 0; x < S; ++x) {
        const T v = upn.base[c * upn.cs + x * upn.ys] * row_dot_s<T, SMAX>(Mj + c * SS, b, x, S);
        mx = v > mx ? v : mx;
      }
    }
    const bool low_e = mx < Scaling<T>::thresh;
    const T fe = low_e ? Scaling<T>::factor : T(1);
    const int e_count = e_base + (low_e ? 1 : 0);
    T mu = 0;
    for (int c = 0; c < C; ++c) {
      T b[SMAX], ev[SMAX];
      load_col(b, b_col, c, S);
      e_column(ev, upn.base + c * upn.cs, upn.ys, Mj + c * SS, b, S, fe);
      if constexpr (THETA)
        theta_column<T, SMAX>(ev, th.U + c * SS, th.V + c * SS, th.d, c, S, th.theta, Pp);
      else
        for (int x = 0; x < S; ++x) Ek[(size_t)(c * S + x) * Pp] = ev[x];
      if (internal) {
#pragma unroll (SMAX <= 20 ? SMAX : 1)
        for (int y = 0; y < SMAX; ++y)
          if (y < S) {
            const T v = col_dot_s<T, SMAX>(Mk + c * SS, ev, y, S);
            uc[(size_t)(c * S + y) * Pp] = v;
            mu = v > mu ? v : mu;
          }
      }
    }
    if constexpr (THETA)
      *th.tsc = e_count + th.d_count;
    else
      *esc_out = e_count;
    if (!internal) return;
    const bool low_u = mu < Scaling<T>::thresh;
    if (low_u)  // the UP this thread has just stored (plain loads), times 2^B
      for (size_t i = 0; i < (size_t)C * S; ++i) uc[i * Pp] *= Scaling<T>::factor;
    *upsc_out = e_count + (low_u ? 1 : 0);
  }
}

// theta_pass prologue at one pattern (T8's first grid step): UP(root) =
// pi x (P_0 . tip_0) with scale 0, and theta of edge 0 (root - leaf 0) from
// E_0 = pi x down(root) with scale dsc[root] and child column tip_0. The
// message P_0 . tip_0 is summed as the plain version
// (ops/kernels.root_init_plain) is by torch's reduction on the card, so the
// sweep starts from the up_pass path's bits: each product rounded, four
// running sums over y = 0, 4, ... / 1, 5, ... / 2, ... / 3, ... from 0,
// then added in order (for S = 4 simply the sum in order).
template <typename T, int SMAX>
__device__ __forceinline__ void theta_prologue(const T* __restrict__ P, const T* __restrict__ tip,
                                               const T* __restrict__ all,
                                               const int* __restrict__ dsc, T* up, int* upsc,
                                               T* theta, int* tsc, const T* U, const T* V,
                                               const T* __restrict__ rf, int L, int n_int, int C,
                                               int S, size_t Pp, int p) {
  const size_t SS = (size_t)S * S, CS = (size_t)C * S;
  const int root = L + n_int - 1;
  T t0[SMAX];
#pragma unroll
  for (int y = 0; y < SMAX; ++y) t0[y] = y < S ? __ldg(tip + (size_t)y * Pp + p) : T(0);
  const T* B = all + (size_t)root * CS * Pp + p;
  T* ur = up + (size_t)(n_int - 1) * CS * Pp + p;
  const Col<T> d0{tip + p, 0, Pp};
  for (int c = 0; c < C; ++c) {
    const T* Pc = P + c * SS;
    T ev[SMAX];
#pragma unroll (SMAX <= 20 ? SMAX : 1)
    for (int x = 0; x < SMAX; ++x) {
      if (x < S) {
        T acc[4] = {0, 0, 0, 0};
#pragma unroll (SMAX <= 20 ? SMAX : 1)
        for (int y = 0; y < SMAX; ++y)
          if (y < S) acc[y & 3] = add_rn(acc[y & 3], mul_rn(__ldg(Pc + x * S + y), t0[y]));
        ur[(size_t)(c * S + x) * Pp] =
            __ldg(rf + c * S + x) * add_rn(add_rn(add_rn(acc[0], acc[1]), acc[2]), acc[3]);
      }
      ev[x] = x < S ? __ldg(rf + c * S + x) * B[(size_t)(c * S + x) * Pp] : T(0);
    }
    theta_column<T, SMAX>(ev, U + c * SS, V + c * SS, d0, c, S, theta + p, Pp);
  }
  upsc[(size_t)(n_int - 1) * Pp + p] = 0;
  tsc[p] = dsc[(size_t)root * Pp + p];
}

// Columns (and scale counts) a warp of a pass prefetches per item.
__host__ __device__ constexpr int pf_cols(bool theta) { return theta ? 3 : 2; }

// Shared memory of one warp of a pass block, in values of T: its slot's two
// matrix sets, and with prefetch (float only) also pf_cols columns of kTile
// patterns and their scale counts.
__host__ __device__ constexpr size_t warp_values(size_t C, size_t S, bool pf, bool theta) {
  return 2 * C * S * S + (pf ? pf_cols(theta) * (C * S * kTile + kTile) : 0);
}

// ------------------------------------------------------------------ H1
// grid (ceil(Pp / kTile)), block kTile * kWarps: block b walks every level
// step for patterns [b * kTile, (b + 1) * kTile); warp w takes the node
// slots w, w + kWarps, ... of each step. PF: each slot's matrices, child
// columns and counts arrive by cp.async into the warp's buffer, the next
// slot's issued as soon as the current one is done with the buffer. With lp
// given, warp 0 writes the tile's site log-likelihoods after the last step.
template <typename T, int SMAX, bool REG, bool PF>
__global__ void __launch_bounds__(kTile* kWarps, SMAX <= 4 ? kMinBlocks : kMinBlocksWide)
    down_pass_kernel(const T* __restrict__ P, const T* __restrict__ tip, T* all, int* sc,
                     const int* __restrict__ child_src, const int* __restrict__ child_edge,
                     const int* __restrict__ step_node, const T* __restrict__ root_freqs,
                     const T* __restrict__ cat_weight, const T* __restrict__ log_inv, T* lp,
                     int n_steps, int G, int n_int, int L, int C, int S, int Pp, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kTile + lane;
  const bool live = p < Pp;
  const size_t CSS = (size_t)C * S * S, CS = (size_t)C * S, P64 = (size_t)Pp;
  T* slice = reinterpret_cast<T*>(smem) + (size_t)warp * warp_values(C, S, PF, false);
  T* cols = slice + 2 * CSS;
  int* cnt = reinterpret_cast<int*>(cols + 2 * CS * kTile);
  auto fetch = [&](int nid) {  // PF: issue the copies of node nid's inputs
    prefetch_matrices(P, child_edge[2 * nid], child_edge[2 * nid + 1], CSS, slice, lane);
    if (live)
      for (int k = 0; k < 2; ++k) {
        const int src = child_src[2 * nid + k];
        prefetch_col(cols + k * CS * kTile, child_col(tip, all, src, L, S, CS, P64, p),
                     src < L ? S : (int)CS, lane);
        if (src >= L)
          cp_async(cnt + k * kTile + lane, sc + (size_t)src * P64 + p);
        else
          cnt[k * kTile + lane] = 0;
      }
    cp_async_commit();
  };
  for (int s = 0; s < n_steps; ++s) {
    const int* row = step_node + (size_t)s * G;
    int g = next_item<0>(row, warp, G, n_int);
    if constexpr (PF)
      if (g < G) fetch(row[g]);
    while (g < G) {
      const int nid = row[g];
      const int gn = next_item<0>(row, g + kWarps, G, n_int);
      const int s0 = child_src[2 * nid], s1 = child_src[2 * nid + 1];
      const T *M0, *M1;
      Col<T> a, b;
      int count = 0;
      if constexpr (PF) {
        cp_async_wait();
        __syncwarp();  // the matrices other lanes copied are in place
        M0 = slice;
        M1 = slice + CSS;
        a = buffer_col<T>(cols, s0 < L, S, lane);
        b = buffer_col<T>(cols + CS * kTile, s1 < L, S, lane);
        if (live) count = cnt[lane] + cnt[kTile + lane];
      } else {
        warp_matrices(P, child_edge[2 * nid], child_edge[2 * nid + 1], CSS, slice,
                      staged != 0, M0, M1, lane);
        a = child_col(tip, all, s0, L, S, CS, P64, p);
        b = child_col(tip, all, s1, L, S, CS, P64, p);
        if (live)
          count = (s0 >= L ? sc[(size_t)s0 * P64 + p] : 0) +
                  (s1 >= L ? sc[(size_t)s1 * P64 + p] : 0);
      }
      if (live)
        down_column<T, SMAX, REG>(M0, M1, a, b, count, all + (size_t)(L + nid) * CS * P64 + p,
                                  sc + (size_t)(L + nid) * P64 + p, C, S, P64);
      if (PF || staged) __syncwarp();  // every lane is done with the buffer
      if constexpr (PF)
        if (gn < G) fetch(row[gn]);
      g = gn;
    }
    __syncthreads();  // this step's rows are visible to the next step
  }
  if (lp != nullptr && warp == 0 && live) {  // site log-likelihoods (T1/T4)
    const int root = L + n_int - 1;
    lp[p] = site_loglik<T, SMAX>(P, tip + p, all + (size_t)root * CS * P64 + p,
                                 sc[(size_t)root * P64 + p], root_freqs, cat_weight, log_inv[p],
                                 C, S, P64);
  }
}

// ---------------------------------------------------------------- H2, H3
// grid (ceil(Pp / kTile)), block kTile * kWarps: block b walks the level
// steps in reverse for its pattern tile; warp w takes the (slot, child)
// items w, w + kWarps, ... of each step. up_pass: UP of the root and E of
// edge 0 are set before the launch (ops/pruning.up_buffers). theta_pass
// (THETA): the block stages U and V, warp 0 runs the prologue, and items
// write theta and UP, never E (E is null). PF as in
// down_pass: an item's inputs are the two matrix sets, UP(node), the
// sibling's down column and their two scale counts (THETA: and the child's
// own column and count).
template <typename T, int SMAX, bool REG, bool PF, bool THETA>
__global__ void __launch_bounds__(kTile* kWarps, SMAX <= 4 ? kMinBlocks : kMinBlocksWide)
    up_pass_kernel(const T* __restrict__ P, const T* __restrict__ tip,
                   const T* __restrict__ all, const int* __restrict__ dsc, T* up, int* upsc,
                   T* E, int* esc, T* theta, int* tsc, const T* __restrict__ U,
                   const T* __restrict__ V, const T* __restrict__ root_freqs,
                   const int* __restrict__ child_src, const int* __restrict__ child_edge,
                   const int* __restrict__ step_node, int n_steps, int G, int n_int, int L,
                   int C, int S, int Pp, int staged, int uv_staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kTile + lane;
  const bool live = p < Pp;
  const size_t CSS = (size_t)C * S * S, CS = (size_t)C * S, P64 = (size_t)Pp;
  T* base = reinterpret_cast<T*>(smem);
  const T* Ub = U;
  const T* Vb = V;
  if constexpr (THETA) {
    if (uv_staged) {
      for (size_t i = threadIdx.x; i < CSS; i += blockDim.x) {
        base[i] = __ldg(U + i);
        base[CSS + i] = __ldg(V + i);
      }
      Ub = base;
      Vb = base + CSS;
      base += 2 * CSS;
      __syncthreads();
    }
    if (warp == 0 && live)
      theta_prologue<T, SMAX>(P, tip, all, dsc, up, upsc, theta, tsc, Ub, Vb, root_freqs, L,
                              n_int, C, S, P64, p);
    __syncthreads();  // UP(root) is visible to the first step
  }
  T* slice = base + (size_t)warp * warp_values(C, S, PF, THETA);
  T* cols = slice + 2 * CSS;
  int* cnt = reinterpret_cast<int*>(cols + pf_cols(THETA) * CS * kTile);
  const int n_items = 2 * G;
  auto fetch = [&](const int* row, int item) {  // PF: issue the copies of item's inputs
    const int nid = row[item >> 1], k = item & 1, j = 1 - k;
    prefetch_matrices(P, child_edge[2 * nid + j], child_edge[2 * nid + k], CSS, slice, lane);
    if (live) {
      const int sj = child_src[2 * nid + j];
      // UP(node): written by this block in an earlier step, or before the launch
      prefetch_col(cols, Col<T>{up + (size_t)nid * CS * P64 + p, (size_t)S * P64, P64},
                   (int)CS, lane);
      prefetch_col(cols + CS * kTile, child_col(tip, all, sj, L, S, CS, P64, p),
                   sj < L ? S : (int)CS, lane);
      cp_async(cnt + lane, upsc + (size_t)nid * P64 + p);
      if (sj >= L)
        cp_async(cnt + kTile + lane, dsc + (size_t)sj * P64 + p);
      else
        cnt[kTile + lane] = 0;
      if constexpr (THETA) {
        const int sk = child_src[2 * nid + k];
        prefetch_col(cols + 2 * CS * kTile, child_col(tip, all, sk, L, S, CS, P64, p),
                     sk < L ? S : (int)CS, lane);
        if (sk >= L)
          cp_async(cnt + 2 * kTile + lane, dsc + (size_t)sk * P64 + p);
        else
          cnt[2 * kTile + lane] = 0;
      }
    }
    cp_async_commit();
  };
  for (int s = n_steps - 1; s >= 0; --s) {
    const int* row = step_node + (size_t)s * G;
    int it = next_item<1>(row, warp, n_items, n_int);
    if constexpr (PF)
      if (it < n_items) fetch(row, it);
    while (it < n_items) {
      const int nid = row[it >> 1], k = it & 1, j = 1 - k;
      const int itn = next_item<1>(row, it + kWarps, n_items, n_int);
      const int sk = child_src[2 * nid + k], sj = child_src[2 * nid + j];
      const int ek = child_edge[2 * nid + k];
      const T *Mj, *Mk;
      Col<T> upn, b;
      ThetaArgs<T> th{};
      int e_base = 0;
      if constexpr (PF) {
        cp_async_wait();
        __syncwarp();  // the matrices other lanes copied are in place
        Mj = slice;
        Mk = slice + CSS;
        upn = buffer_col<T>(cols, false, S, lane);
        b = buffer_col<T>(cols + CS * kTile, sj < L, S, lane);
        if (live) e_base = cnt[lane] + cnt[kTile + lane];
        if constexpr (THETA) {
          th.d = buffer_col<T>(cols + 2 * CS * kTile, sk < L, S, lane);
          if (live) th.d_count = cnt[2 * kTile + lane];
        }
      } else {
        warp_matrices(P, child_edge[2 * nid + j], ek, CSS, slice, staged != 0, Mj, Mk, lane);
        upn = Col<T>{up + (size_t)nid * CS * P64 + p, (size_t)S * P64, P64};
        b = child_col(tip, all, sj, L, S, CS, P64, p);
        if (live)
          e_base = upsc[(size_t)nid * P64 + p] + (sj >= L ? dsc[(size_t)sj * P64 + p] : 0);
      }
      if constexpr (THETA && !PF) {
        th.d = child_col(tip, all, sk, L, S, CS, P64, p);
        if (live) th.d_count = sk >= L ? dsc[(size_t)sk * P64 + p] : 0;
      }
      if (live) {
        const bool internal = sk >= L;
        T* Ek = nullptr;
        int* esc_k = nullptr;
        if constexpr (THETA) {
          th.U = Ub;
          th.V = Vb;
          th.theta = theta + (size_t)ek * CS * P64 + p;
          th.tsc = tsc + (size_t)ek * P64 + p;
        } else {
          Ek = E + (size_t)ek * CS * P64 + p;
          esc_k = esc + (size_t)ek * P64 + p;
        }
        up_column<T, SMAX, REG, THETA>(
            Mj, Mk, upn, b, e_base, Ek, esc_k,
            internal ? up + (size_t)(sk - L) * CS * P64 + p : nullptr,
            internal ? upsc + (size_t)(sk - L) * P64 + p : nullptr, th, C, S, P64);
      }
      if (PF || staged) __syncwarp();  // every lane is done with the buffer
      if constexpr (PF)
        if (itn < n_items) fetch(row, itn);
      it = itn;
    }
    __syncthreads();  // this step's UP rows are visible to the next step
  }
}

// ------------------------------------------------ the wide instance, S > 64
// Past kMaxRegStates states a thread can no longer own a pattern's column:
// at S = 112 and C = 4 it holds 448 values, and the thread alone would do
// 2*C*S*S multiply-adds per node. So the wide instance splits a node's
// states across the block's warps: every product of a pass is a matrix
// product of one category, M = S output states, K = S and N = the block's
// tile of NP patterns, cut into warp items of 16 output states. The down
// pass (down_wide_kernel) and the sweeps (sweep_wide_kernel) share that
// machinery (down_stage, down_chunk, down_items and the block max).

constexpr int kMaxRegStates = 64;  // widest S of the register-column instances

// H1, S > 64: the wide down pass (down_wide_kernel). It serves T1/T2 and
// T4/T5/T6 past 64 states: pallas_pruning2.stream_pass
// (iqtree2_tpu/ops/pallas_pruning2.py:246 · :342) and the whole-tree forms
// down_pass_pallas (pallas_pruning.py:183 · :224) and down_sitelp_pallas
// (:405 · :452), with the site log-likelihoods as its epilogue.
//
// Per node, category c and child k the message is a matrix product: M = S
// output states, K = S, N = the block's pattern tile of NP patterns,
// P[e_k, c] (row-major S x S) times the child's [S, NP] column block. A
// node moves 3*C*S values per pattern for 2*C*S*S multiply-adds: about 37
// flops a byte at S = 112 in float32, above the H100's ridge of about 20,
// so the pass is bound by operations, not bytes. The design answers the
// four limits of the first wide kernel (one block of 8 warps per SM,
// every P value an __ldg broadcast inside the contraction, scalar DFMA,
// a runtime contraction stride):
//
// - Work: a node's C * ceil(S / 16) items, an item being 16 output states
//   of one category for both children, go to the block's 8 warps in turn;
//   a warp owns an item from the staged inputs to the stored partial, so
//   the contraction needs no block barrier. Rows past S are zero and never
//   stored (65 and 76 states pad to 80, 112 to 112, 136 to 144).
// - Staging: the warp brings each K-chunk of its item's two P row blocks
//   ([16, kK]) and two column blocks ([kK, NP]) into its own double buffer
//   in shared memory by cp.async, 16 bytes a copy where S (P's rows) and
//   Pp (the columns) allow it, else value by value; the next chunk's copies
//   (also across items) are in flight while it computes on the current
//   one. The contraction reads only shared memory at compile-time strides,
//   and what a block takes does not depend on S or C, so no S is refused:
//   float32 108, 74 and 57 KB at tiles of 32, 16 and 8 patterns, float64
//   136, 96 and 76 KB (tools/cuda_mock/rehearse.py's three builds give
//   the mock card 1, 8 and 16 SMs, so that they take its tiles 32, 16 and
//   8).
// - float64 runs on the tensor cores: DMMA, mma.sync m16n8k4 (dmma_16x8x4),
//   an item one 16 x 8 tile per 8 patterns, fragments from conflict-free
//   padded layouts.
// - float32 stays exact float32 (TF32 is off by the precision policy): a
//   register-tiled FFMA product, each lane 4 states x NP/8 patterns per
//   child, so one staged P value serves NP/8 patterns and one column value
//   4 states, read as 16-byte (4 x 4 blocks of P) and NP/8-wide loads.
// - Fill: the tile NP is 32, 16 or 8 patterns, the widest whose grid
//   reaches kDownFill blocks per SM (down_tile): 100 x 16384 (Pp 12672) and
//   MK65's 100 x 12288 (Pp 10496) take 32, 64 x 4096 (Pp 3072) 16 (192
//   blocks; 32 would leave 36 of the 132 SMs idle), and 64 x 1024 at 136
//   states (Pp 896) 8 (112 blocks where 32 gave 28). Two blocks stay
//   resident per SM (float64's tile of 32: one).
//
// What the H100 showed (variants timed back to back, as
// tools/torch_kernel_bits.py --wide times the pass): it is held by
// how many chunks its 16 resident warps keep in flight, not by the FMA or
// DMMA rate. Value-by-value copies took 1.1-1.7x as long as the 16-byte
// ones; staging each round's column chunks once for the whole block (a
// barrier per chunk) 1.2-1.6x; the copies through L1 (cp.async.ca) up to
// 1.13x;
// three stages a warp 1-3% less where two blocks stay resident and up to
// 1.8x more where the larger ring leaves one; three float32 blocks per SM
// (80 registers, spills) up to 1.2x more.
//
// The two children's tiles share one lane layout, so the product ua * ub,
// the per-pattern max over the node's C*S values and the store happen in
// registers; the max then goes across the warps in shared memory. Values
// are stored as formed; where a pattern's max is below Scaling<T>::thresh,
// the lanes that stored its values multiply them by 2^B in place (a power
// of two: the values a rescale-then-store writes). The epilogue forms leaf
// 0's message P_0 . tip_0 with the same product code, one child, and sums
// w_c pi_{c,x} B_root * msg per pattern across the block.

constexpr int kItemRows = 16;  // output states of a warp item: one m16 tile
// blocks per SM a wider pattern tile's grid must reach (down_tile)
constexpr int kDownFill = 1;
// stages of a warp's cp.async ring: kDownStages - 1 chunks in flight
constexpr int kDownStages = 2;

// Per precision: the K-chunk, the staged layout of one child's blocks (A
// row-major, or K-major where the product reads its matrix transposed),
// and the lanes that share a pattern column (the reduction's slots).
template <typename T>
struct DownTile;

template <>
struct DownTile<float> {
  static constexpr int kK = 16;            // contraction chunk
  static constexpr int kAStride = kK + 4;  // A [16][20]: P[x0 + r, y] at r * 20 + y
  static constexpr int kAValues = kItemRows * kAStride;
  static constexpr int kTStride = kItemRows + 4;  // A^T [16][20]: M[y, x0 + r] at (y - k0) * 20 + r
  static constexpr int kBPad = 0;          // B [kK][NP]
  static constexpr int kSlots = 4;         // row groups of 4 states
};

template <>
struct DownTile<double> {
  static constexpr int kK = 8;
  static constexpr int kAStride = kK + 4;  // A [16][12]: P[x0 + r, y] at r * 12 + y
  static constexpr int kAValues = kItemRows * kAStride;
  static constexpr int kTStride = kItemRows + 4;  // A^T [8][20]: M[y, x0 + r] at (y - k0) * 20 + r
  static constexpr int kBPad = 4;          // B [kK][NP + 4]
  static constexpr int kSlots = 8;         // fragment row groups
};
static_assert(DownTile<float>::kK * DownTile<float>::kTStride <= DownTile<float>::kAValues &&
                  DownTile<double>::kK * DownTile<double>::kTStride <= DownTile<double>::kAValues,
              "a K-major A block fits where a row-major one goes");

// Values of T one stage of a warp's ring holds: two children's A and B
// blocks.
template <typename T, int NP>
__host__ __device__ constexpr int down_stage_values() {
  using D = DownTile<T>;
  return 2 * (D::kAValues + D::kK * (NP + D::kBPad));
}

// Dynamic shared memory of a wide down block: the warps' rings of
// kDownStages buffers, the reduction rows [kWarps][kSlots][NP] and NP
// flags.
template <typename T, int NP>
__host__ __device__ constexpr size_t down_wide_shm() {
  return (size_t)kWarps * kDownStages * down_stage_values<T, NP>() * sizeof(T) +
         (size_t)kWarps * DownTile<T>::kSlots * NP * sizeof(T) + NP * sizeof(int);
}

// Aligned vector of N values (16-byte and 8-byte shared-memory loads).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// cp.async.wait_group N: every group but the N newest has landed.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// cp.async of 16 bytes (both addresses 16-byte aligned), through L2 only:
// rows written earlier in the launch are read there, never through L1's
// read-only path (through L1, as cp_async goes, the down pass took up to
// 13% longer on the H100: its L1 is small beside the staged buffers).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  for (int i = 0; i < 16; ++i)
    static_cast<unsigned char*>(dst)[i] = static_cast<const unsigned char*>(src)[i];
#endif
}

// A 16-byte aligned address.
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// d += A B for one warp (mma.sync m16n8k4, float64 on the tensor cores):
// lane l = 4 g + t holds A[g][t] (a0) and A[g + 8][t] (a1), B[t][g] (b),
// and D[g][2t + i] (d[i]) and D[g + 8][2t + i] (d[2 + i]), i = 0, 1.
__device__ __forceinline__ void dmma_16x8x4(double* d, double a0, double a1, double b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
#elif defined(IQ_CUDA_MOCK)
  iq_mock_mma_m16n8k4(d, a0, a1, b);
#endif
}

// A lane's share of an item: NV = NP / 2 values per child. float32: rows
// 4 rg + v / (NP/8) and pattern column v % (NP/8) of the lane's NP/8,
// rg = lane / 8, pg = lane % 8, columns pg * NP/8 + j. float64 (the mma's
// D fragments, one per 8 patterns): rows g + 8 (v % 4 / 2), column slot
// 2 (v / 4) + v % 2 at pattern 8 (j / 2) + 2 t + j % 2, g = lane / 4,
// t = lane % 4.
template <typename T, int NP>
struct DownLane {
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int kNV = NP / 2;
  static constexpr int kCols = kF64 ? NP / 4 : NP / 8;  // pattern columns a lane holds
  int lane;
  __device__ __forceinline__ int slot() const { return kF64 ? lane >> 2 : lane >> 3; }
  __device__ __forceinline__ int row(int v) const {
    return kF64 ? (lane >> 2) + 8 * ((v & 3) >> 1) : 4 * (lane >> 3) + v / (NP / 8);
  }
  __device__ __forceinline__ int col(int v) const {
    return kF64 ? 2 * (v >> 2) + (v & 1) : v % (NP / 8);
  }
  __device__ __forceinline__ int pattern(int j) const {
    return kF64 ? 8 * (j >> 1) + 2 * (lane & 3) + (j & 1) : (lane & 7) * (NP / 8) + j;
  }
};

// A wide product's operands: per child, its edge's [C, S, S] transition
// block and its column rows (category c at X + c * xcs: xcs = 0 for a tip,
// S * Pp for an internal node), pattern 0; vec_a: the child's P rows go
// in 16-byte copies (S a multiple of their values, P aligned), vec_b: its
// column rows do (Pp a multiple, X aligned).
template <typename T>
struct DownOps {
  const T* P[2];
  const T* X[2];
  size_t xcs[2];
  bool vec_a[2], vec_b[2];
};

// DownOps of one child (slot k): P at its edge, X its rows.
template <typename T>
__device__ __forceinline__ void down_operand(DownOps<T>& op, int k, const T* Pe, const T* X,
                                             size_t xcs, int S, int Pp) {
  constexpr int V = 16 / sizeof(T);
  op.P[k] = Pe;
  op.X[k] = X;
  op.xcs[k] = xcs;
  op.vec_a[k] = S % V == 0 && aligned16(Pe);
  op.vec_b[k] = Pp % V == 0 && aligned16(X);
}

// Issues (cp.async, zeros past S) K-chunk k0 of item (c, m0) into stage
// buffer buf: NCH children's A and B blocks, in 16-byte copies where
// DownOps allows (a copy then lies wholly inside or outside S and Pp),
// else value by value; patterns past Pp read pattern Pp - 1 (Pp - V).
// Bit ch of TR: child ch's product reads its matrix transposed (A[r][y] =
// M[y, m0 + r]), staged K-major, so that 16 rows of one column of M are
// one contiguous run, copied 16 bytes at a time as the rows of P are.
template <typename T, int NP, int NCH, unsigned TR = 0>
__device__ __forceinline__ void down_stage(T* buf, const DownOps<T>& op, int c, int m0, int k0,
                                           int S, int p0, int Pp, int lane) {
  using D = DownTile<T>;
  constexpr int V = 16 / sizeof(T);
  const size_t SS = (size_t)S * S;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    T* A = buf + ch * D::kAValues;
    const T* Pc = op.P[ch] + c * SS;
    if ((TR >> ch) & 1u) {  // K-major: lanes along x, coalesced rows of M
      if (op.vec_a[ch]) {
        for (int i = lane; i < D::kK * kItemRows / V; i += 32) {
          const int kk = i / (kItemRows / V), r = i % (kItemRows / V) * V;
          const int y = k0 + kk, x = m0 + r;
          T* dst = A + kk * D::kTStride + r;
          if (x < S && y < S)
            cp_async16(dst, Pc + (size_t)y * S + x);
          else
#pragma unroll
            for (int e = 0; e < V; ++e) dst[e] = T(0);
        }
      } else {
        for (int i = lane; i < D::kK * kItemRows; i += 32) {
          const int kk = i / kItemRows, r = i % kItemRows, y = k0 + kk, x = m0 + r;
          T* dst = A + kk * D::kTStride + r;
          if (x < S && y < S)
            cp_async(dst, Pc + (size_t)y * S + x);
          else
            *dst = T(0);
        }
      }
    } else if (op.vec_a[ch]) {  // lanes along y: coalesced rows of P
      for (int i = lane; i < kItemRows * D::kK / V; i += 32) {
        const int r = i / (D::kK / V), y = k0 + i % (D::kK / V) * V, x = m0 + r;
        T* dst = A + r * D::kAStride + (y - k0);
        if (x < S && y < S)
          cp_async16(dst, Pc + (size_t)x * S + y);
        else
#pragma unroll
          for (int e = 0; e < V; ++e) dst[e] = T(0);
      }
    } else {
      for (int i = lane; i < kItemRows * D::kK; i += 32) {
        const int r = i / D::kK, kk = i % D::kK, x = m0 + r, y = k0 + kk;
        T* dst = A + r * D::kAStride + kk;
        if (x < S && y < S)
          cp_async(dst, Pc + (size_t)x * S + y);
        else
          *dst = T(0);
      }
    }
    T* B = buf + 2 * D::kAValues + ch * D::kK * (NP + D::kBPad);
    const T* Xc = op.X[ch] + c * op.xcs[ch];
    if (op.vec_b[ch]) {  // lanes along patterns
      for (int i = lane; i < D::kK * NP / V; i += 32) {
        const int kk = i / (NP / V), j = i % (NP / V) * V, y = k0 + kk;
        const int p = p0 + j < Pp ? p0 + j : Pp - V;
        T* dst = B + kk * (NP + D::kBPad) + j;
        if (y < S)
          cp_async16(dst, Xc + (size_t)y * Pp + p);
        else
#pragma unroll
          for (int e = 0; e < V; ++e) dst[e] = T(0);
      }
    } else {
      for (int i = lane; i < D::kK * NP; i += 32) {
        const int kk = i / NP, j = i % NP, y = k0 + kk;
        const int p = p0 + j < Pp ? p0 + j : Pp - 1;
        T* dst = B + kk * (NP + D::kBPad) + j;
        if (y < S)
          cp_async(dst, Xc + (size_t)y * Pp + p);
        else
          *dst = T(0);
      }
    }
  }
}

// acc[ch] += the staged chunk's products for NCH children (TR: as
// down_stage staged them). A K-major block gives each lane the same values
// in the same order, from conflict-free layouts too: float64's fragment
// rows g and g + 8 of column t at 20 t + g (two 16-lane phases of distinct
// banks), float32's 4 x 4 block as four 16-byte rows of 4 states.
template <typename T, int NP, int NCH, unsigned TR = 0>
__device__ __forceinline__ void down_chunk(T (&acc)[2][NP / 2], const T* buf, int lane) {
  using D = DownTile<T>;
  if constexpr (sizeof(T) == 8) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D::kK; kk += 4)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const T* A = buf + ch * D::kAValues;
        const T* B = buf + 2 * D::kAValues + ch * D::kK * (NP + D::kBPad);
        const bool tr = (TR >> ch) & 1u;
        const double a0 = tr ? A[(kk + t) * D::kTStride + g] : A[g * D::kAStride + kk + t];
        const double a1 =
            tr ? A[(kk + t) * D::kTStride + g + 8] : A[(g + 8) * D::kAStride + kk + t];
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt)
          dmma_16x8x4(acc[ch] + 4 * nt, a0, a1, B[(kk + t) * (NP + D::kBPad) + 8 * nt + g]);
      }
  } else {  // per 4 steps of the contraction: a 4 x 4 block of A, 4 rows of B
    constexpr int TN = NP / 8;
    const int rg = lane >> 3, pg = lane & 7;
#pragma unroll
    for (int kq = 0; kq < D::kK; kq += 4)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const T* B = buf + 2 * D::kAValues + ch * D::kK * NP + kq * NP + TN * pg;
        Vec<T, 4> a[4];  // a[i].v[kk] = A[4 rg + i][kq + kk]
        if ((TR >> ch) & 1u) {
          const T* At = buf + ch * D::kAValues + kq * D::kTStride + 4 * rg;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const Vec<T, 4> col = *reinterpret_cast<const Vec<T, 4>*>(At + kk * D::kTStride);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i].v[kk] = col.v[i];
          }
        } else {
          const T* A = buf + ch * D::kAValues + 4 * rg * D::kAStride + kq;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const Vec<T, 4>*>(A + i * D::kAStride);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const Vec<T, TN> b = *reinterpret_cast<const Vec<T, TN>*>(B + kk * NP);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[ch][i * TN + j] += a[i].v[kk] * b.v[j];
        }
      }
  }
}

// The warp's items of a node, item = warp, warp + kWarps, ... of C *
// ceil(S / 16) (category item / MT, states 16 (item % MT) on): for each,
// the NCH children's products over all K-chunks, staged through the warp's
// ring of kDownStages buffers (the next chunks, of this item or the next,
// in flight while the current one is used), then done(c, m0, acc).
template <typename T, int NP, int NCH, unsigned TR = 0, typename F>
__device__ __forceinline__ void down_items(T* buf, const DownOps<T>& op, int C, int S, int p0,
                                           int Pp, int warp, int lane, F&& done) {
  using D = DownTile<T>;
  constexpr int kStage = down_stage_values<T, NP>();
  const int MT = (S + kItemRows - 1) / kItemRows, nk = (S + D::kK - 1) / D::kK;
  const int n_items = C * MT;
  if (warp >= n_items) return;
  const int total = (n_items - warp + kWarps - 1) / kWarps * nk;
  auto issue = [&](int f) {
    const int item = warp + kWarps * (f / nk);
    if (f < total)
      down_stage<T, NP, NCH, TR>(buf + f % kDownStages * kStage, op, item / MT,
                             item % MT * kItemRows, f % nk * D::kK, S, p0, Pp, lane);
    cp_async_commit();  // (empty past the last chunk: the groups keep their count)
  };
  T acc[2][NP / 2];
#pragma unroll
  for (int v = 0; v < NP / 2; ++v) acc[0][v] = acc[1][v] = T(0);
  for (int f = 0; f < kDownStages - 1; ++f) issue(f);
  for (int f = 0; f < total; ++f) {
    issue(f + kDownStages - 1);  // into the buffer chunk f - 1 used
    cp_async_wait_group<kDownStages - 1>();
    __syncwarp();  // the chunk the other lanes copied is in place
    down_chunk<T, NP, NCH, TR>(acc, buf + f % kDownStages * kStage, lane);
    __syncwarp();  // every lane is done with the buffer before it is refilled
    if (f % nk == nk - 1) {
      const int item = warp + kWarps * (f / nk);
      done(item / MT, item % MT * kItemRows, acc);
#pragma unroll
      for (int v = 0; v < NP / 2; ++v) acc[0][v] = acc[1][v] = T(0);
    }
  }
}

// Per pattern of the tile, the max (SUM: the sum) over the block of each
// lane's column values v[j]; thread i < NP gets pattern i's (the others 0).
template <typename T, int NP, bool SUM>
__device__ __forceinline__ T down_reduce(const T (&v)[DownLane<T, NP>::kCols], T* red,
                                         const DownLane<T, NP>& ln, int warp) {
  constexpr int R = kWarps * DownTile<T>::kSlots;
#pragma unroll
  for (int j = 0; j < DownLane<T, NP>::kCols; ++j)
    red[(warp * DownTile<T>::kSlots + ln.slot()) * NP + ln.pattern(j)] = v[j];
  __syncthreads();
  T r = 0;
  if (threadIdx.x < NP)
    for (int i = 0; i < R; ++i) {
      const T o = red[i * NP + threadIdx.x];
      r = SUM ? r + o : (o > r ? o : r);
    }
  return r;
}

// grid (ceil(Pp / NP)), block kWarps * 32: block b walks every level step
// for patterns [b * NP, (b + 1) * NP); per node the warps take its items.
// With lp given, the site log-likelihoods after the last step. The
// __launch_bounds__ minimum of 2 resident blocks per SM caps a thread at 128
// registers; float64's 32-pattern tile (64 doubles of accumulators, and
// shared memory for one block) takes 1.
template <typename T, int NP>
__global__ void __launch_bounds__(kTile* kWarps, sizeof(T) == 8 && NP == 32 ? 1 : 2)
    down_wide_kernel(const T* __restrict__ P, const T* __restrict__ tip, T* all, int* sc,
                     const int* __restrict__ child_src, const int* __restrict__ child_edge,
                     const int* __restrict__ step_node, const T* __restrict__ root_freqs,
                     const T* __restrict__ cat_weight, const T* __restrict__ log_inv, T* lp,
                     int n_steps, int G, int n_int, int L, int C, int S, int Pp) {
  extern __shared__ __align__(16) unsigned char smem[];
  using LN = DownLane<T, NP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LN ln{lane};
  const int p0 = blockIdx.x * NP;
  const size_t SS = (size_t)S * S, CSS = (size_t)C * SS, CS = (size_t)C * S, P64 = (size_t)Pp;
  T* buf = reinterpret_cast<T*>(smem) + (size_t)warp * kDownStages * down_stage_values<T, NP>();
  T* red = reinterpret_cast<T*>(smem) + (size_t)kWarps * kDownStages * down_stage_values<T, NP>();
  int* flag = reinterpret_cast<int*>(red + kWarps * DownTile<T>::kSlots * NP);
  const int MT = (S + kItemRows - 1) / kItemRows;
  // the lane's stored values of its items, each v[x, p] at out(c, x, p)
  auto each_value = [&](int c, int m0, auto&& fn) {
#pragma unroll
    for (int v = 0; v < LN::kNV; ++v) {
      const int x = m0 + ln.row(v), j = ln.col(v), p = p0 + ln.pattern(j);
      if (x < S && p < Pp) fn(v, j, ((size_t)c * S + x) * P64 + p);
    }
  };
  for (int s = 0; s < n_steps; ++s) {
    const int* row = step_node + (size_t)s * G;
    for (int g = 0; g < G; ++g) {
      const int nid = row[g];
      if (nid >= n_int) continue;  // a pad slot (the same for every thread)
      DownOps<T> op;
      for (int k = 0; k < 2; ++k) {
        const int src = child_src[2 * nid + k];
        down_operand(op, k, P + (size_t)child_edge[2 * nid + k] * CSS,
                     src < L ? tip + (size_t)src * S * P64 : all + (size_t)src * CS * P64,
                     src < L ? 0 : (size_t)S * P64, S, Pp);
      }
      T* out = all + (size_t)(L + nid) * CS * P64;
      T mx[LN::kCols];
#pragma unroll
      for (int j = 0; j < LN::kCols; ++j) mx[j] = 0;
      down_items<T, NP, 2>(buf, op, C, S, p0, Pp, warp, lane,
                           [&](int c, int m0, T(&acc)[2][NP / 2]) {
                             each_value(c, m0, [&](int v, int j, size_t o) {
                               const T u = acc[0][v] * acc[1][v];
                               mx[j] = u > mx[j] ? u : mx[j];
                               out[o] = u;
                             });
                           });
      const T m = down_reduce<T, NP, false>(mx, red, ln, warp);
      if (threadIdx.x < NP) {
        const int p = p0 + threadIdx.x;
        const bool low = m < Scaling<T>::thresh;
        flag[threadIdx.x] = low;
        if (p < Pp) {
          const int s0 = child_src[2 * nid], s1 = child_src[2 * nid + 1];
          sc[(size_t)(L + nid) * P64 + p] = (s0 >= L ? sc[(size_t)s0 * P64 + p] : 0) +
                                            (s1 >= L ? sc[(size_t)s1 * P64 + p] : 0) +
                                            (low ? 1 : 0);
        }
      }
      __syncthreads();  // the flags are in place, the reduction rows free
      bool any = false;
#pragma unroll
      for (int j = 0; j < LN::kCols; ++j) any |= flag[ln.pattern(j)] != 0;
      if (any)  // the values this lane stored for a low pattern, times 2^B
        for (int item = warp; item < C * MT; item += kWarps)
          each_value(item / MT, item % MT * kItemRows, [&](int, int j, size_t o) {
            if (flag[ln.pattern(j)]) out[o] *= Scaling<T>::factor;
          });
    }
    __syncthreads();  // this step's rows are visible to the next step
  }
  if (lp == nullptr) return;
  // site log-likelihoods (T1/T4): leaf 0's message P_0 . tip_0 (edge 0)
  // times the root row, weighted by root_freqs and cat_weight, summed over
  // the block per pattern
  const int root = L + n_int - 1;
  const T* B = all + (size_t)root * CS * P64;
  DownOps<T> op{};
  down_operand(op, 0, P, tip, 0, S, Pp);
  T part[LN::kCols];
#pragma unroll
  for (int j = 0; j < LN::kCols; ++j) part[j] = 0;
  down_items<T, NP, 1>(buf, op, C, S, p0, Pp, warp, lane,
                       [&](int c, int m0, T(&acc)[2][NP / 2]) {
#pragma unroll
                         for (int v = 0; v < LN::kNV; ++v) {
                           const int x = m0 + ln.row(v), j = ln.col(v), p = p0 + ln.pattern(j);
                           if (x < S && p < Pp)
                             part[j] += __ldg(cat_weight + c) *
                                        (__ldg(root_freqs + c * S + x) *
                                         (B[((size_t)c * S + x) * P64 + p] * acc[0][v]));
                         }
                       });
  const T site = down_reduce<T, NP, true>(part, red, ln, warp);
  const int p = p0 + threadIdx.x;
  if (threadIdx.x < NP && p < Pp) {
    const T l = dlog(site > Scaling<T>::tiny ? site : Scaling<T>::tiny) -
                (T)sc[(size_t)root * P64 + p] * Scaling<T>::log_factor;
    lp[p] = logaddexp(l, log_inv[p]);
  }
}

// Per pattern of the tile, the max over the block of N quantities' lane
// values v[q][j] (the lane's pattern columns j): first across the lanes of
// a warp that hold the same patterns (the slots, by shuffles), then across
// the warps in red [N][kWarps][NP]; thread i < N * NP gets quantity i /
// NP's at pattern i % NP (the others 0). The caller syncs the block before
// red is written again.
template <typename T, int NP, int N>
__device__ __forceinline__ T block_max(const T (&v)[N][DownLane<T, NP>::kCols], T* red,
                                       const DownLane<T, NP>& ln, int warp) {
  constexpr int kFirst = sizeof(T) == 8 ? 4 : 8;  // lane bits above the pattern's: the slot
#pragma unroll
  for (int q = 0; q < N; ++q)
#pragma unroll
    for (int j = 0; j < DownLane<T, NP>::kCols; ++j) {
      T m = v[q][j];
#pragma unroll
      for (int s = kFirst; s < 32; s *= 2) {
        const T o = __shfl_xor_sync(0xffffffffu, m, s);
        m = o > m ? o : m;
      }
      if (ln.slot() == 0) red[(q * kWarps + warp) * NP + ln.pattern(j)] = m;
    }
  __syncthreads();
  T r = 0;
  if (threadIdx.x < N * NP) {
    const T* row = red + (size_t)(threadIdx.x / NP) * kWarps * NP + threadIdx.x % NP;
    for (int w = 0; w < kWarps; ++w) r = row[w * NP] > r ? row[w * NP] : r;
  }
  return r;
}

// H2/H3, S > 64: the wide sweeps (sweep_wide_kernel). up_pass serves T3/T7
// past 64 states, pallas_pruning2.stream_up_pass
// (iqtree2_tpu/ops/pallas_pruning2.py:490 · :567) and the whole-tree
// up_pass_pallas (pallas_pruning.py:310 · :372); theta_pass (THETA) serves
// T8, stream_theta_pass (pallas_pruning2.py:726 · :804).
//
// Per node and child slot k (sibling j = 1 - k) a sweep forms three kinds
// of product per category, each M = S states, K = S, N = the block's NP
// patterns: E_k = UP(node) x (P_j . down(sibling)); UP(child) = P_k^T E_k
// for an internal child; and for theta_pass theta_k = (U^T E_k) x (V .
// down(child)). A node moves some 5*C*S values a pattern for 4*C*S*S
// multiply-adds (theta_pass 8*C*S*S), so the sweeps are bound by
// operations, as the down pass is. The first wide sweep lost to that bound
// in five ways (one block of 8 warps per SM; every P, U or V value an
// __ldg broadcast inside the contraction; scalar DFMA; a runtime
// contraction stride; the whole block on one (node, child) item, with
// barriers per category and E computed twice where its tile did not fit).
// This one is the down pass's machinery with three more epilogues:
//
// - Both slots at once: P_j . down(sibling) of slots 0 and 1 are the down
//   pass's two messages of the node, so the first phase is down_items over
//   the node's C * ceil(S / 16) warp items of both children, and its
//   epilogue multiplies UP(node) in (E_0 = UP x msg_1, E_1 = UP x msg_0),
//   keeps both per-pattern maxima in registers and stores both E blocks.
// - E between the phases: the maxima go across the warps (block_max); the
//   lanes that stored a low pattern's E multiply it by 2^B in place, as the
//   down pass fixes its partials; after a barrier the second phase reads E
//   back as its K operand by cp.async.cg, through L2. up_pass keeps E in
//   its edges' rows, where it belongs; theta_pass in a [2, C, S, Pp]
//   workspace that the launcher allocates stream-ordered (E of edge 0 in
//   its first slot for the prologue). So shared memory holds only the
//   warps' rings and the reduction rows, whatever S and C are: no S is
//   refused.
// - Transposed operands: P_k^T and U^T are read down columns of P and U;
//   down_stage stages them K-major (TR), so that their copies are 16-byte
//   copies where S divides, as P's rows are, and down_chunk reads every
//   block at compile-time strides.
// - Second phase: theta_pass's theta_k is a two-operand item, (U^T, E_k)
//   and (V, down(child k)), multiplied in registers as the down pass
//   multiplies its two children; UP of the internal children is one item of
//   one or two operands (P_0^T E_0, P_1^T E_1), stored as formed, its max
//   reduced and its low patterns fixed in place as E's are.
// - float64 on DMMA, float32 register-tiled exact FFMA, and the pattern
//   tile of down_tile, as the down pass; one launch per pass, the level
//   steps in reverse, and a node's six block barriers whatever C is (four
//   with no internal child).
// The prologue of theta_pass (UP(root), theta of edge 0) uses the same
// items; UP(root) keeps root_init_plain's order of summation, so that the
// sweep starts from the up_pass path's bits.
//
// What the H100 showed (tools/torch_kernel_bits.py --wide, against the
// first wide sweep): 2.2-6.4x faster at 65-136 states, 7-18% of the
// operations bound (up_pass 7.1-17.5%, theta_pass 7.1-15.0%), two blocks
// per SM at every timed shape where the first sweep kept one; float64 and
// the widest grids are furthest from the bound. The warps' per-item
// maxima reduce by shuffles first, so the reduction rows are one per
// warp and float32's tile of 32 keeps two blocks per SM (109 KB each).

// Dynamic shared memory of a wide sweep block: the down pass's rings, two
// quantities' reduction rows of block_max, and per child slot NP flags and
// NP scale counts.
template <typename T, int NP>
__host__ __device__ constexpr size_t sweep_wide_shm() {
  return (size_t)kWarps * kDownStages * down_stage_values<T, NP>() * sizeof(T) +
         2 * (size_t)kWarps * NP * sizeof(T) + 4 * NP * sizeof(int);
}

// grid (ceil(Pp / NP)), block kWarps * 32: block b walks the level steps in
// reverse for patterns [b * NP, (b + 1) * NP); per node the warps take its
// items. up_pass: UP of the root and E of edge 0 are set before the launch,
// E [n_edges, C, S, Pp] are the edges' rows. theta_pass (THETA): E is the
// [2, C, S, Pp] workspace, esc unused. Resident blocks as down_wide_kernel.
template <typename T, int NP, bool THETA>
__global__ void __launch_bounds__(kTile* kWarps, sizeof(T) == 8 && NP == 32 ? 1 : 2)
    sweep_wide_kernel(const T* __restrict__ P, const T* __restrict__ tip,
                      const T* __restrict__ all, const int* __restrict__ dsc, T* up, int* upsc,
                      T* E, int* esc, T* theta, int* tsc, const T* __restrict__ U,
                      const T* __restrict__ V, const T* __restrict__ root_freqs,
                      const int* __restrict__ child_src, const int* __restrict__ child_edge,
                      const int* __restrict__ step_node, int n_steps, int G, int n_int, int L,
                      int C, int S, int Pp) {
  extern __shared__ __align__(16) unsigned char smem[];
  using LN = DownLane<T, NP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LN ln{lane};
  const int p0 = blockIdx.x * NP;
  const size_t SS = (size_t)S * S, CSS = (size_t)C * SS, CS = (size_t)C * S, P64 = (size_t)Pp;
  T* buf = reinterpret_cast<T*>(smem) + (size_t)warp * kDownStages * down_stage_values<T, NP>();
  T* red = reinterpret_cast<T*>(smem) + (size_t)kWarps * kDownStages * down_stage_values<T, NP>();
  int* flag = reinterpret_cast<int*>(red + 2 * kWarps * NP);  // [2][NP]: slot k's pattern is low
  int* cnt = flag + 2 * NP;                                // [2][NP]: E_k's scale count
  const int MT = (S + kItemRows - 1) / kItemRows;
  // the lane's stored values of its items, each v[x, p] at out(c, x, p)
  auto each_value = [&](int c, int m0, auto&& fn) {
#pragma unroll
    for (int v = 0; v < LN::kNV; ++v) {
      const int x = m0 + ln.row(v), j = ln.col(v), p = p0 + ln.pattern(j);
      if (x < S && p < Pp) fn(v, j, ((size_t)c * S + x) * P64 + p);
    }
  };
  // the values this lane stored in out[q] (q < n) where slot[q]'s flag
  // marks the pattern low, times 2^B; then the block syncs
  auto rescale = [&](T* const (&out)[2], const int (&slot)[2], int n) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < LN::kCols; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) any |= q < n && flag[slot[q] * NP + ln.pattern(j)] != 0;
    if (any)
      for (int item = warp; item < C * MT; item += kWarps)
        each_value(item / MT, item % MT * kItemRows, [&](int, int j, size_t o) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (q < n && flag[slot[q] * NP + ln.pattern(j)]) out[q][o] *= Scaling<T>::factor;
        });
    __syncthreads();
  };
  // theta of an edge, (U^T e) x (V . d), into out [C, S, Pp]: e's and d's
  // rows at category c are e + c S Pp and d + c dcs
  auto thetas = [&](const T* e, const T* d, size_t dcs, T* out) {
    DownOps<T> op;
    down_operand(op, 0, U, e, (size_t)S * P64, S, Pp);
    down_operand(op, 1, V, d, dcs, S, Pp);
    down_items<T, NP, 2, 1u>(buf, op, C, S, p0, Pp, warp, lane, [&](int c, int m0, auto& acc) {
      each_value(c, m0, [&](int v, int, size_t o) { out[o] = acc[0][v] * acc[1][v]; });
    });
  };
  if constexpr (THETA) {
    // prologue (T8's first grid step): UP(root) = pi x (P_0 . tip_0), each
    // product rounded, four running sums over y = 0, 4, ... / 1, 5, ... /
    // ..., added in order (theta_prologue), scale 0; E_0 = pi x down(root)
    // into the workspace (scale dsc[root], no rescale) for theta of edge 0
    const int root = L + n_int - 1;
    T* ur = up + (size_t)(n_int - 1) * CS * P64;
    const T* B = all + (size_t)root * CS * P64;
    for (int i = threadIdx.x; i < C * S * NP; i += blockDim.x) {
      const int c = i / (S * NP), x = i / NP % S, p = p0 + i % NP;
      if (p >= Pp) continue;
      const T* Px = P + c * SS + (size_t)x * S;
      T acc[4] = {0, 0, 0, 0};
      for (int y = 0; y < S; ++y)
        acc[y & 3] = add_rn(acc[y & 3], mul_rn(__ldg(Px + y), __ldg(tip + (size_t)y * P64 + p)));
      const T f = __ldg(root_freqs + c * S + x);
      const size_t o = ((size_t)c * S + x) * P64 + p;
      ur[o] = f * add_rn(add_rn(add_rn(acc[0], acc[1]), acc[2]), acc[3]);
      E[o] = f * B[o];
    }
    const int p = p0 + threadIdx.x;
    if (threadIdx.x < NP && p < Pp) {
      upsc[(size_t)(n_int - 1) * P64 + p] = 0;
      tsc[p] = dsc[(size_t)root * P64 + p];
    }
    __syncthreads();  // E_0 is in place
    thetas(E, tip, 0, theta);
    __syncthreads();  // UP(root) is visible to the first step, the workspace free
  }
  for (int s = n_steps - 1; s >= 0; --s) {
    const int* row = step_node + (size_t)s * G;
    for (int g = 0; g < G; ++g) {
      const int nid = row[g];
      if (nid >= n_int) continue;  // a pad slot (the same for every thread)
      const int src[2] = {child_src[2 * nid], child_src[2 * nid + 1]};
      const int edge[2] = {child_edge[2 * nid], child_edge[2 * nid + 1]};
      DownOps<T> op;
      T* ek[2];  // E of slot k: the edge's rows (up_pass) or the workspace's
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        down_operand(op, k, P + (size_t)edge[k] * CSS,
                     src[k] < L ? tip + (size_t)src[k] * S * P64 : all + (size_t)src[k] * CS * P64,
                     src[k] < L ? 0 : (size_t)S * P64, S, Pp);
        ek[k] = E + (THETA ? (size_t)k : (size_t)edge[k]) * CS * P64;
      }
      // first phase: E_0 = UP x msg_1 and E_1 = UP x msg_0, stored as formed
      const T* un = up + (size_t)nid * CS * P64;
      T mx[2][LN::kCols] = {};
      down_items<T, NP, 2>(buf, op, C, S, p0, Pp, warp, lane, [&](int c, int m0, auto& acc) {
        each_value(c, m0, [&](int v, int j, size_t o) {
          const T u = un[o];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const T e = u * acc[1 - k][v];
            mx[k][j] = e > mx[k][j] ? e : mx[k][j];
            ek[k][o] = e;
          }
        });
      });
      const T m = block_max<T, NP, 2>(mx, red, ln, warp);
      if (threadIdx.x < 2 * NP) {
        const int k = threadIdx.x / NP, p = p0 + threadIdx.x % NP, sj = src[1 - k];
        const bool low = m < Scaling<T>::thresh;
        flag[threadIdx.x] = low;
        if (p < Pp) {
          const int e_count = upsc[(size_t)nid * P64 + p] +
                              (sj >= L ? dsc[(size_t)sj * P64 + p] : 0) + (low ? 1 : 0);
          cnt[threadIdx.x] = e_count;
          if constexpr (THETA)
            tsc[(size_t)edge[k] * P64 + p] =
                e_count + (src[k] >= L ? dsc[(size_t)src[k] * P64 + p] : 0);
          else
            esc[(size_t)edge[k] * P64 + p] = e_count;
        }
      }
      __syncthreads();  // the flags are in place, the reduction rows free
      const int slots[2] = {0, 1};
      rescale(ek, slots, 2);  // E is final and visible to the block's copies
      if constexpr (THETA)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          thetas(ek[k], op.X[k], op.xcs[k], theta + (size_t)edge[k] * CS * P64);
      // second phase: UP(child) = P_k^T E_k of the internal children
      const int n = (src[0] >= L) + (src[1] >= L);
      const int slot[2] = {src[0] >= L ? 0 : 1, 1};
      if (n == 0) {
        __syncthreads();  // the workspace is free again
        continue;
      }
      DownOps<T> uo;
      T* uc[2] = {nullptr, nullptr};
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (q < n) {
          down_operand(uo, q, P + (size_t)edge[slot[q]] * CSS, ek[slot[q]], (size_t)S * P64, S,
                       Pp);
          uc[q] = up + (size_t)(src[slot[q]] - L) * CS * P64;
        }
      T mu[2][LN::kCols] = {};
      auto store = [&](int c, int m0, auto& acc) {
        each_value(c, m0, [&](int v, int j, size_t o) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (q < n) {
              const T u = acc[q][v];
              mu[q][j] = u > mu[q][j] ? u : mu[q][j];
              uc[q][o] = u;
            }
        });
      };
      if (n == 2)
        down_items<T, NP, 2, 3u>(buf, uo, C, S, p0, Pp, warp, lane, store);
      else
        down_items<T, NP, 1, 1u>(buf, uo, C, S, p0, Pp, warp, lane, store);
      const T mu_max = block_max<T, NP, 2>(mu, red, ln, warp);
      if (threadIdx.x < n * NP) {
        const int q = threadIdx.x / NP, i = threadIdx.x % NP, p = p0 + i;
        const bool low = mu_max < Scaling<T>::thresh;
        flag[slot[q] * NP + i] = low;
        if (p < Pp)
          upsc[(size_t)(src[slot[q]] - L) * P64 + p] = cnt[slot[q] * NP + i] + (low ? 1 : 0);
      }
      __syncthreads();  // the flags are in place
      rescale(uc, slot, n);  // UP(child) is final; E and the workspace free
    }
    __syncthreads();  // this step's UP rows are visible to the next step
  }
}

// Block shape and dynamic shared memory of the passes (S <= kMaxRegStates;
// the wide instance takes down_tile). The matrices are
// staged when every warp's slice fits in the budget; the prefetch buffers
// are added (float only, S <= 4) when they fit there too; theta_pass also
// stages U and V when they fit beside the warps' part. theta_pass's budget
// is 56 KB, as its buffers hold a third column: an SM's 228 KB less 1 KB
// reserved per block leaves 56 KB for each of 4 blocks.
struct PassShape {
  dim3 grid, block;
  size_t shm;
  int staged, uv_staged;
  bool pf;
};

template <typename T>
PassShape pass_shape(int Pp, int C, int S, bool theta) {
  PassShape ps;
  ps.grid = dim3((unsigned)((Pp + kTile - 1) / kTile));
  ps.block = dim3(kTile * kWarps);
  const size_t budget = theta ? 56 * 1024 : kStageBytes;
  const size_t pf_bytes = kWarps * warp_values(C, S, true, theta) * sizeof(T);
  const size_t bytes = kWarps * warp_values(C, S, false, theta) * sizeof(T);
  const size_t uv = theta ? 2 * (size_t)C * S * S * sizeof(T) : 0;
  ps.pf = kPrefetch && sizeof(T) == 4 && S <= 4 && pf_bytes + uv <= budget;
  ps.staged = ps.pf || bytes <= budget;
  const size_t warps = ps.pf ? pf_bytes : ps.staged ? bytes : 0;
  ps.uv_staged = theta && warps + uv <= budget;
  ps.shm = warps + (ps.uv_staged ? uv : 0);
  return ps;
}

// The pass kernel instance for S <= kMaxRegStates states: the register
// column width is the smallest of 4 (DNA), 20 (protein), 64 (codon) that
// holds S. Prefetch instances exist
// for float at S <= 4 only. Trailing template arguments (up_pass_kernel's
// THETA) follow KERNEL after an empty argument.
#define IQ_PICK_PASS(KERNEL, ...)                                              \
  if constexpr (kRegCats > 0)                                                 \
    if (S <= 4 && C <= kRegCats) {                                            \
      if constexpr (sizeof(T) == 4)                                           \
        if (ps.pf) return KERNEL<T, 4, true, true __VA_ARGS__>;               \
      return KERNEL<T, 4, true, false __VA_ARGS__>;                           \
    }                                                                         \
  if (S <= 4) {                                                               \
    if constexpr (sizeof(T) == 4)                                             \
      if (ps.pf) return KERNEL<T, 4, false, true __VA_ARGS__>;                \
    return KERNEL<T, 4, false, false __VA_ARGS__>;                            \
  }                                                                           \
  if (S <= 20) return KERNEL<T, 20, false, false __VA_ARGS__>;                \
  return KERNEL<T, 64, false, false __VA_ARGS__>;

template <typename T>
auto pick_down_pass(int C, int S, const PassShape& ps) -> decltype(&down_pass_kernel<T, 4, true, false>) {
  IQ_PICK_PASS(down_pass_kernel, )
}

template <typename T, bool THETA>
auto pick_up_pass(int C, int S, const PassShape& ps)
    -> decltype(&up_pass_kernel<T, 4, true, false, THETA>) {
  IQ_PICK_PASS(up_pass_kernel, , THETA)
}

// Lets a kernel take more than the default 48 KB of dynamic shared memory
// (theta_pass with prefetch, the wide instance), from the SM's largest
// shared-memory carveout.
template <typename K>
cudaError_t allow_shm(K kernel, size_t shm) {
  if (shm <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Resident blocks per SM of a pass instance (negative: a CUDA error).
template <typename K>
int blocks_per_sm(K kernel, const PassShape& ps) {
  cudaError_t err = allow_shm(kernel, ps.shm);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, (int)ps.block.x, ps.shm);
  return err == cudaSuccess ? n : -(int)err;
}

// The wide down pass's pattern tile on the current card: the widest of 32,
// 16 and 8 patterns whose grid reaches kDownFill blocks per SM.
inline int down_tile(int Pp) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  for (int np = 32; np > 8; np /= 2)
    if ((Pp + np - 1) / np >= kDownFill * sms) return np;
  return 8;
}

template <typename T, int NP>
int launch_down_wide(const void* P, const void* tip, void* all, void* sc, const void* child_src,
                     const void* child_edge, const void* step_node, const void* root_freqs,
                     const void* cat_weight, const void* log_inv, void* lp, int n_steps, int G,
                     int n_int, int L, int C, int S, int Pp, cudaStream_t st) {
  const auto kernel = down_wide_kernel<T, NP>;
  const size_t shm = down_wide_shm<T, NP>();
  const cudaError_t err = allow_shm(kernel, shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)((Pp + NP - 1) / NP)), dim3(kTile * kWarps), shm, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(tip), static_cast<T*>(all),
      static_cast<int*>(sc), static_cast<const int*>(child_src),
      static_cast<const int*>(child_edge), static_cast<const int*>(step_node),
      static_cast<const T*>(root_freqs), static_cast<const T*>(cat_weight),
      static_cast<const T*>(log_inv), static_cast<T*>(lp), n_steps, G, n_int, L, C, S, Pp);
  return (int)cudaGetLastError();
}

// The wide sweep with pattern tile NP (theta_pass: E is its workspace).
template <typename T, int NP, bool THETA>
int launch_sweep_wide(const void* P, const void* tip, const void* all, const void* dsc, void* up,
                      void* upsc, void* E, void* esc, void* theta, void* tsc, const void* U,
                      const void* V, const void* root_freqs, const void* child_src,
                      const void* child_edge, const void* step_node, int n_steps, int G,
                      int n_int, int L, int C, int S, int Pp, cudaStream_t st) {
  const auto kernel = sweep_wide_kernel<T, NP, THETA>;
  const size_t shm = sweep_wide_shm<T, NP>();
  const cudaError_t err = allow_shm(kernel, shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)((Pp + NP - 1) / NP)), dim3(kTile * kWarps), shm, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(tip), static_cast<const T*>(all),
      static_cast<const int*>(dsc), static_cast<T*>(up), static_cast<int*>(upsc),
      static_cast<T*>(E), static_cast<int*>(esc), static_cast<T*>(theta), static_cast<int*>(tsc),
      static_cast<const T*>(U), static_cast<const T*>(V), static_cast<const T*>(root_freqs),
      static_cast<const int*>(child_src), static_cast<const int*>(child_edge),
      static_cast<const int*>(step_node), n_steps, G, n_int, L, C, S, Pp);
  return (int)cudaGetLastError();
}

// The wide sweep's launcher for the pattern tile of Pp (down_tile).
template <typename T, bool THETA>
auto pick_sweep_wide(int Pp) -> decltype(&launch_sweep_wide<T, 32, THETA>) {
  const int np = down_tile(Pp);
  return np == 32   ? launch_sweep_wide<T, 32, THETA>
         : np == 16 ? launch_sweep_wide<T, 16, THETA>
                    : launch_sweep_wide<T, 8, THETA>;
}

// Resident blocks per SM and dynamic shared memory of a wide instance:
// KIND 0 the down pass, 1 up_pass, 2 theta_pass, with pattern tile NP.
template <typename T, int NP, int KIND>
int wide_occupancy(int* blocks, int* shm) {
  PassShape ps;
  ps.block = dim3(kTile * kWarps);
  ps.shm = KIND == 0 ? down_wide_shm<T, NP>() : sweep_wide_shm<T, NP>();
  *shm = (int)ps.shm;
  if constexpr (KIND == 0)
    *blocks = blocks_per_sm(down_wide_kernel<T, NP>, ps);
  else
    *blocks = blocks_per_sm(sweep_wide_kernel<T, NP, KIND == 2>, ps);
  return *blocks < 0 ? -*blocks : (int)cudaSuccess;
}

template <typename T>
int launch_down_pass(const void* P, const void* tip, void* all, void* sc, const void* child_src,
                     const void* child_edge, const void* step_node, const void* root_freqs,
                     const void* cat_weight, const void* log_inv, void* lp, int n_steps, int G,
                     int n_int, int L, int C, int S, int Pp, cudaStream_t st) {
  if (S > kMaxRegStates) {
    const int np = down_tile(Pp);
    const auto launch = np == 32   ? launch_down_wide<T, 32>
                        : np == 16 ? launch_down_wide<T, 16>
                                   : launch_down_wide<T, 8>;
    return launch(P, tip, all, sc, child_src, child_edge, step_node, root_freqs, cat_weight,
                  log_inv, lp, n_steps, G, n_int, L, C, S, Pp, st);
  }
  const PassShape ps = pass_shape<T>(Pp, C, S, false);
  const auto kernel = pick_down_pass<T>(C, S, ps);
  const cudaError_t err = allow_shm(kernel, ps.shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ps.grid, ps.block, ps.shm, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(tip), static_cast<T*>(all),
      static_cast<int*>(sc), static_cast<const int*>(child_src),
      static_cast<const int*>(child_edge), static_cast<const int*>(step_node),
      static_cast<const T*>(root_freqs), static_cast<const T*>(cat_weight),
      static_cast<const T*>(log_inv), static_cast<T*>(lp), n_steps, G, n_int, L, C, S, Pp,
      ps.staged);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_up_pass(const void* P, const void* tip, const void* all, const void* dsc, void* up,
                   void* upsc, void* E, void* esc, const void* child_src, const void* child_edge,
                   const void* step_node, int n_steps, int G, int n_int, int L, int C, int S,
                   int Pp, cudaStream_t st) {
  if (S > kMaxRegStates)
    return pick_sweep_wide<T, false>(Pp)(P, tip, all, dsc, up, upsc, E, esc, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, child_src, child_edge,
                                         step_node, n_steps, G, n_int, L, C, S, Pp, st);
  const PassShape ps = pass_shape<T>(Pp, C, S, false);
  const auto kernel = pick_up_pass<T, false>(C, S, ps);
  const cudaError_t err = allow_shm(kernel, ps.shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ps.grid, ps.block, ps.shm, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(tip), static_cast<const T*>(all),
      static_cast<const int*>(dsc), static_cast<T*>(up), static_cast<int*>(upsc),
      static_cast<T*>(E), static_cast<int*>(esc), static_cast<T*>(nullptr),
      static_cast<int*>(nullptr), static_cast<const T*>(nullptr), static_cast<const T*>(nullptr),
      static_cast<const T*>(nullptr), static_cast<const int*>(child_src),
      static_cast<const int*>(child_edge), static_cast<const int*>(step_node), n_steps, G, n_int,
      L, C, S, Pp, ps.staged, 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_theta_pass(const void* P, const void* tip, const void* all, const void* dsc, void* up,
                      void* upsc, void* theta, void* tsc, const void* U, const void* V,
                      const void* root_freqs, const void* child_src, const void* child_edge,
                      const void* step_node, int n_steps, int G, int n_int, int L, int C, int S,
                      int Pp, cudaStream_t st) {
  if (S > kMaxRegStates) {
    // the wide sweep keeps E of a node's two child slots in a [2, C, S, Pp]
    // workspace, stream-ordered around the launch
    void* ws = nullptr;
    cudaError_t err = cudaMallocAsync(&ws, 2 * (size_t)C * S * Pp * sizeof(T), st);
    if (err != cudaSuccess) return (int)err;
    err = (cudaError_t)pick_sweep_wide<T, true>(Pp)(
        P, tip, all, dsc, up, upsc, ws, nullptr, theta, tsc, U, V, root_freqs, child_src,
        child_edge, step_node, n_steps, G, n_int, L, C, S, Pp, st);
    const cudaError_t freed = cudaFreeAsync(ws, st);
    return (int)(err != cudaSuccess ? err : freed);
  }
  const PassShape ps = pass_shape<T>(Pp, C, S, true);
  const auto kernel = pick_up_pass<T, true>(C, S, ps);
  const cudaError_t err = allow_shm(kernel, ps.shm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ps.grid, ps.block, ps.shm, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(tip), static_cast<const T*>(all),
      static_cast<const int*>(dsc), static_cast<T*>(up), static_cast<int*>(upsc),
      static_cast<T*>(nullptr), static_cast<int*>(nullptr), static_cast<T*>(theta),
      static_cast<int*>(tsc), static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const T*>(root_freqs), static_cast<const int*>(child_src),
      static_cast<const int*>(child_edge), static_cast<const int*>(step_node), n_steps, G, n_int,
      L, C, S, Pp, ps.staged, ps.uv_staged);
  return (int)cudaGetLastError();
}

// KIND 0 down_pass, 1 up_pass, 2 theta_pass: resident blocks per SM and
// dynamic shared memory per block of the instance for (C, S, Pp).
template <typename T, int KIND>
int pass_occupancy(int C, int S, int Pp, int* blocks, int* shm) {
  if (S > kMaxRegStates) {
    const int np = down_tile(Pp);
    return np == 32   ? wide_occupancy<T, 32, KIND>(blocks, shm)
           : np == 16 ? wide_occupancy<T, 16, KIND>(blocks, shm)
                      : wide_occupancy<T, 8, KIND>(blocks, shm);
  }
  const PassShape ps = pass_shape<T>(Pp, C, S, KIND == 2);
  *shm = (int)ps.shm;
  if constexpr (KIND == 0)
    *blocks = blocks_per_sm(pick_down_pass<T>(C, S, ps), ps);
  else
    *blocks = blocks_per_sm(pick_up_pass<T, KIND == 2>(C, S, ps), ps);
  return *blocks < 0 ? -*blocks : (int)cudaSuccess;
}

}  // namespace

// ------------------------------------------------------------ C interface
// Pointers and the stream arrive as void* (ctypes c_void_p), sizes as int.
// down_pass's root_freqs, cat_weight, log_inv and lp are null without the
// epilogue.

#define IQ_DOWN_PASS(SUFFIX, T)                                                              \
  extern "C" int iq_down_pass_##SUFFIX(const void* P, const void* tip, void* all, void* sc,  \
                                       const void* child_src, const void* child_edge,       \
                                       const void* step_node, const void* root_freqs,       \
                                       const void* cat_weight, const void* log_inv,         \
                                       void* lp, int n_steps, int G, int n_int, int L,      \
                                       int C, int S, int Pp, void* stream) {                \
    return launch_down_pass<T>(P, tip, all, sc, child_src, child_edge, step_node,           \
                               root_freqs, cat_weight, log_inv, lp, n_steps, G, n_int, L,   \
                               C, S, Pp, static_cast<cudaStream_t>(stream));                \
  }

#define IQ_UP_PASS(SUFFIX, T)                                                                \
  extern "C" int iq_up_pass_##SUFFIX(const void* P, const void* tip, const void* all,        \
                                     const void* dsc, void* up, void* upsc, void* E,        \
                                     void* esc, const void* child_src,                      \
                                     const void* child_edge, const void* step_node,         \
                                     int n_steps, int G, int n_int, int L, int C, int S,    \
                                     int Pp, void* stream) {                                \
    return launch_up_pass<T>(P, tip, all, dsc, up, upsc, E, esc, child_src, child_edge,     \
                             step_node, n_steps, G, n_int, L, C, S, Pp,                     \
                             static_cast<cudaStream_t>(stream));                            \
  }

#define IQ_THETA_PASS(SUFFIX, T)                                                             \
  extern "C" int iq_theta_pass_##SUFFIX(                                                     \
      const void* P, const void* tip, const void* all, const void* dsc, void* up,           \
      void* upsc, void* theta, void* tsc, const void* U, const void* V,                     \
      const void* root_freqs, const void* child_src, const void* child_edge,                \
      const void* step_node, int n_steps, int G, int n_int, int L, int C, int S, int Pp,    \
      void* stream) {                                                                       \
    return launch_theta_pass<T>(P, tip, all, dsc, up, upsc, theta, tsc, U, V,               \
                                root_freqs, child_src, child_edge, step_node, n_steps, G,   \
                                n_int, L, C, S, Pp, static_cast<cudaStream_t>(stream));     \
  }

#define IQ_PASS_OCCUPANCY(KIND_NAME, KIND, SUFFIX, T)                                        \
  extern "C" int iq_pass_occupancy_##KIND_NAME##_##SUFFIX(int C, int S, int Pp, int* blocks, \
                                                           int* shm) {                     \
    return pass_occupancy<T, KIND>(C, S, Pp, blocks, shm);                                  \
  }

// IQ_PART k (0-5) compiles one (pass, precision) pair's launcher and
// occupancy query, and with them only that pair's kernel instances, so
// that ops/kernels.build_library runs one nvcc for each part, all at once,
// and links the parts; without IQ_PART the whole library is one unit.
#if !defined(IQ_PART) || IQ_PART == 0
IQ_DOWN_PASS(f32, float)
IQ_PASS_OCCUPANCY(down_pass, 0, f32, float)
#endif
#if !defined(IQ_PART) || IQ_PART == 1
IQ_DOWN_PASS(f64, double)
IQ_PASS_OCCUPANCY(down_pass, 0, f64, double)
#endif
#if !defined(IQ_PART) || IQ_PART == 2
IQ_UP_PASS(f32, float)
IQ_PASS_OCCUPANCY(up_pass, 1, f32, float)
#endif
#if !defined(IQ_PART) || IQ_PART == 3
IQ_UP_PASS(f64, double)
IQ_PASS_OCCUPANCY(up_pass, 1, f64, double)
#endif
#if !defined(IQ_PART) || IQ_PART == 4
IQ_THETA_PASS(f32, float)
IQ_PASS_OCCUPANCY(theta_pass, 2, f32, float)
#endif
#if !defined(IQ_PART) || IQ_PART == 5
IQ_THETA_PASS(f64, double)
IQ_PASS_OCCUPANCY(theta_pass, 2, f64, double)
#endif
