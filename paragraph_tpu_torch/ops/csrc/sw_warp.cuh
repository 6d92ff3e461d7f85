// The column step shared by the graph Smith-Waterman fills graph_sw.cu
// (K3) and paired_sw.cu (K1, K2): one warp owns one lane (one read
// orientation), and thread t of the warp holds the R consecutive read rows
// j = t R ... t R + R - 1 of that lane in registers.
//
// Per lane and thread, in registers: the previous column's H and this
// column's E (R each) and the read's codes as bit masks (bit r of eq[c]:
// row r holds base c; bit r of valid: row r holds A, C, G or T), built once
// at lane start. One column, all of a lane's rows at once, exact because
// gapO >= gapE >= 0:
//     hp_j = max(H_{j-1} of the previous column + prof_j, E_j, 0)
//     F_j  = max(0, max_{k<j} (hp_k - (j-1-k) gapE) - gapO)
//     H_j  = max(hp_j, F_j)
//     E_j  = max(E_j - gapE, H_j - gapO, 0)
// The diagonal of a thread's first row is its neighbour's last row
// (__shfl_up_sync). F is a prefix max with a linear decay: each thread
// runs A = max(A - gapE, hp) over its R rows, then a log-step
// __shfl_up_sync scan over the 32 threads, each step shifted by d R gapE,
// gives the value entering its first row, and a second pass over its rows
// gives F, H and E. The maxima are Hopper's DPX instructions
// (__viaddmax_s32, __viaddmax_s32_relu).
//
// End cell and node maxima. Each thread keeps its best H over its stripe
// rows (rows below the lane's striped length) with the first column and
// then the first row where it was attained, updated on a strict > in
// column order; reduce_end picks over the warp the highest score, then the
// lowest column, then the lowest row, which is gssw's order with no limit
// on the score's bits. Each thread keeps a running maximum over its real
// rows (rows below the read length); at a node's last column the warp
// reduces it and one thread stores it.
//
// Saved boundary states. Per lane, H and E of each node's last column,
// [N][R][32] words each: row r of thread t at r * 32 + t, so the store at
// a node's last column and the elementwise max over the predecessors at a
// node's first column are coalesced. Slot N, the zero state, is never
// stored or read: H and E are never negative, so seeding starts from 0 and
// skips it. Then node maxima [N].
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sw_warp {

constexpr unsigned kFull = 0xffffffffu;
// threads per lane
constexpr int kGroup = 32;
// below any score, and far enough from INT_MIN that subtracting a gap
// penalty cannot wrap
constexpr int kNeg = INT_MIN / 2;

// Rows per thread the launchers instantiate. A launch takes the smallest
// R with 32 R >= M; the largest, 26, covers M = 832.
#define SW_WARP_ROW_COUNTS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(10) X(12) X(14) X(16) X(20) \
  X(23) X(26)

__host__ __device__ inline int rows_for(int M) {
  const int need = (M + kGroup - 1) / kGroup;
#define SW_WARP_PICK(R) \
  if (need <= R) return R;
  SW_WARP_ROW_COUNTS(SW_WARP_PICK)
#undef SW_WARP_PICK
  return 0;
}

struct Scoring {
  int gap_open, gap_extend, match, mismatch;
};

// A lane's read codes as bit masks over its thread's R rows.
struct CodeBits {
  unsigned eq[4];
  unsigned valid;
};

// code_at(j): the code of read row j (0-3 ACGT, 4 N, 5 pad) for j < M.
template <int R, class CodeAt>
__device__ __forceinline__ CodeBits load_codes(int t, int M, CodeAt code_at) {
  CodeBits b = {{0u, 0u, 0u, 0u}, 0u};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = t * R + r;
    const int x = j < M ? code_at(j) : 5;
    const unsigned bit = 1u << r;
    b.eq[0] |= x == 0 ? bit : 0u;
    b.eq[1] |= x == 1 ? bit : 0u;
    b.eq[2] |= x == 2 ? bit : 0u;
    b.eq[3] |= x == 3 ? bit : 0u;
    b.valid |= x < 4 ? bit : 0u;
  }
  return b;
}

// The rows of a thread that score match / mismatch against reference
// code ref (4: N or pad, which scores 0 everywhere).
struct ColBits {
  unsigned eq, mis;
};

__device__ __forceinline__ ColBits column_bits(const CodeBits& b, int ref) {
  if (ref >= 4) return {0u, 0u};
  const unsigned eq = ref == 0   ? b.eq[0]
                      : ref == 1 ? b.eq[1]
                      : ref == 2 ? b.eq[2]
                                 : b.eq[3];
  return {eq, b.valid & ~eq};
}

// Rows of thread t below a lane's bound (striped length or read length).
template <int R>
__device__ __forceinline__ int rows_below(int bound, int t) {
  return min(max(bound - t * R, 0), R);
}

// One column of one lane: h holds the previous column's H on entry (or
// the seeded state at a node's first column) and this column's H on exit;
// e likewise. col_max takes the max over stripe rows, node_run over real
// rows.
template <int R>
__device__ __forceinline__ void column_step(int (&h)[R], int (&e)[R],
                                            ColBits cb, const Scoring& s,
                                            int t, int n_stripe, int n_real,
                                            int& col_max, int& node_run) {
  int up = __shfl_up_sync(kFull, h[R - 1], 1);
  if (t == 0) up = 0;
  // hp in place, last row first: row r reads row r - 1's previous H
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int diag = r > 0 ? h[r - 1] : up;
    const int prof = ((cb.eq >> r) & 1u)    ? s.match
                     : ((cb.mis >> r) & 1u) ? -s.mismatch
                                            : 0;
    h[r] = __viaddmax_s32_relu(diag, prof, e[r]);
  }
  // A at this thread's last row, from its own rows
  int run = h[0];
#pragma unroll
  for (int r = 1; r < R; ++r) run = __viaddmax_s32(run, -s.gap_extend, h[r]);
  // inclusive scan over the threads, thread s < t decayed by (t - s) R gapE;
  // threads t < d get their own value back, which the max leaves as it is
  const int step = R * s.gap_extend;
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) {
    const int o = __shfl_up_sync(kFull, run, d);
    run = __viaddmax_s32(o, -d * step, run);
  }
  // A entering this thread's first row
  int a = __shfl_up_sync(kFull, run, 1);
  if (t == 0) a = kNeg;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hp = h[r];
    const int hn = __viaddmax_s32_relu(a, -s.gap_open, hp);  // max(hp, F)
    a = __viaddmax_s32(a, -s.gap_extend, hp);
    h[r] = hn;
    e[r] = __viaddmax_s32_relu(e[r], -s.gap_extend, hn - s.gap_open);
    if (r < n_stripe) col_max = max(col_max, hn);
    if (r < n_real) node_run = max(node_run, hn);
  }
}

// The first of a thread's stripe rows whose H equals v.
template <int R>
__device__ __forceinline__ int first_row(const int (&h)[R], int v,
                                         int n_stripe) {
  int row = 0;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if (r < n_stripe && h[r] == v) row = r;
  }
  return row;
}

// Seed a node's first column: the elementwise max of its predecessors'
// saved states (slot n_nodes, the zero state, adds nothing).
template <int R>
__device__ __forceinline__ void seed(int (&h)[R], int (&e)[R],
                                     const int32_t* preds, int P, int n_nodes,
                                     const int32_t* saved_h,
                                     const int32_t* saved_e, int t) {
  constexpr int slot = R * kGroup;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h[r] = 0;
    e[r] = 0;
  }
  for (int q = 0; q < P; ++q) {
    const int pq = __ldg(preds + q);
    if (pq >= n_nodes) continue;
    const int32_t* sh = saved_h + static_cast<size_t>(pq) * slot + t;
    const int32_t* se = saved_e + static_cast<size_t>(pq) * slot + t;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = max(h[r], sh[r * kGroup]);
      e[r] = max(e[r], se[r * kGroup]);
    }
  }
}

// A node's last column: its H and E saved, its maximum over real rows
// stored by thread 0.
template <int R>
__device__ __forceinline__ void save(const int (&h)[R], const int (&e)[R],
                                     int nid, int node_run, int32_t* saved_h,
                                     int32_t* saved_e, int32_t* node_max,
                                     int t) {
  constexpr int slot = R * kGroup;
  int32_t* sh = saved_h + static_cast<size_t>(nid) * slot + t;
  int32_t* se = saved_e + static_cast<size_t>(nid) * slot + t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sh[r * kGroup] = h[r];
    se[r * kGroup] = e[r];
  }
  const int m = __reduce_max_sync(kFull, node_run);
  if (t == 0) node_max[nid] = m;
}

// The warp's end cell: highest score, then lowest column, then lowest
// row, into every thread.
__device__ __forceinline__ void reduce_end(int& best, int& col, int& row) {
#pragma unroll
  for (int d = kGroup / 2; d > 0; d >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, d);
    const int oc = __shfl_xor_sync(kFull, col, d);
    const int orow = __shfl_xor_sync(kFull, row, d);
    if (ob > best || (ob == best && (oc < col || (oc == col && orow < row)))) {
      best = ob;
      col = oc;
      row = orow;
    }
  }
}

// Node slots whose maximum equals score, over the warp (every slot counts,
// unvisited and pad ones included).
__device__ __forceinline__ int count_top(const int32_t* node_max, int N,
                                         int score, int t) {
  int n_top = 0;
  for (int n = t; n < N; n += kGroup) n_top += node_max[n] == score;
  return __reduce_add_sync(kFull, n_top);
}

// Zero a lane's node maxima before its first column.
__device__ __forceinline__ void zero_node_max(int32_t* node_max, int N,
                                              int t) {
  for (int n = t; n < N; n += kGroup) node_max[n] = 0;
  __syncwarp();
}

// Scratch words of one lane: saved H and E of N nodes, then N maxima.
__host__ __device__ inline size_t lane_words(int N, int R) {
  return 2 * static_cast<size_t>(N) * R * kGroup + N;
}

}  // namespace sw_warp
