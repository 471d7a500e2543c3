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
//                edge from the E the thread holds, so E is never written;
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
// One thread owns one pattern of one node (or edge) and loops over the
// node's C*S values itself, so the per-pattern rescale max over all C*S
// values needs no cross-thread reduction.
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

// Block shape and dynamic shared memory of the passes. The matrices are
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

// The pass kernel instance for S states: the register column width is the
// smallest of 4 (DNA), 20 (protein), 64 (codon) that holds S; larger S is
// refused (nullptr; the wrapper raises before launching). Prefetch
// instances exist for float at S <= 4 only. Trailing template arguments
// (up_pass_kernel's THETA) follow KERNEL after an empty argument.
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
  if (S <= 64) return KERNEL<T, 64, false, false __VA_ARGS__>;                \
  return nullptr;

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
// (theta_pass with prefetch), from the SM's largest shared-memory carveout.
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
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_shm(kernel, ps.shm);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, (int)ps.block.x, ps.shm);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int launch_down_pass(const void* P, const void* tip, void* all, void* sc, const void* child_src,
                     const void* child_edge, const void* step_node, const void* root_freqs,
                     const void* cat_weight, const void* log_inv, void* lp, int n_steps, int G,
                     int n_int, int L, int C, int S, int Pp, cudaStream_t st) {
  const PassShape ps = pass_shape<T>(Pp, C, S, false);
  const auto kernel = pick_down_pass<T>(C, S, ps);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
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
  const PassShape ps = pass_shape<T>(Pp, C, S, false);
  const auto kernel = pick_up_pass<T, false>(C, S, ps);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
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
  const PassShape ps = pass_shape<T>(Pp, C, S, true);
  const auto kernel = pick_up_pass<T, true>(C, S, ps);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
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

// kind 0 down_pass, 1 up_pass, 2 theta_pass: resident blocks per SM and
// dynamic shared memory per block of the instance for (C, S, Pp).
template <typename T>
int pass_occupancy(int kind, int C, int S, int Pp, int* blocks, int* shm) {
  const PassShape ps = pass_shape<T>(Pp, C, S, kind == 2);
  *shm = (int)ps.shm;
  *blocks = kind == 0   ? blocks_per_sm(pick_down_pass<T>(C, S, ps), ps)
            : kind == 1 ? blocks_per_sm(pick_up_pass<T, false>(C, S, ps), ps)
                        : blocks_per_sm(pick_up_pass<T, true>(C, S, ps), ps);
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

#define IQ_PASS_OCCUPANCY(SUFFIX, T)                                                         \
  extern "C" int iq_pass_occupancy_##SUFFIX(int kind, int C, int S, int Pp, int* blocks,     \
                                            int* shm) {                                     \
    return pass_occupancy<T>(kind, C, S, Pp, blocks, shm);                                  \
  }

IQ_DOWN_PASS(f32, float)
IQ_DOWN_PASS(f64, double)
IQ_UP_PASS(f32, float)
IQ_UP_PASS(f64, double)
IQ_THETA_PASS(f32, float)
IQ_THETA_PASS(f64, double)
IQ_PASS_OCCUPANCY(f32, float)
IQ_PASS_OCCUPANCY(f64, double)
