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
//
// Reads longer than the largest R covers (M > 832 rows) take the row-band
// path (band_lane below): a lane's rows are cut into bands of kBandR * 32
// = 832 rows, and each band sweeps all of the lane's columns with the same
// column_step at R = kBandR. A row depends only on the rows above it, so
// band b + 1 needs from band b only, per column, the H entering the column
// at band b's last row (thread 0's diagonal, in place of 0) and the F
// carry A after that row (thread 0's incoming A, in place of kNeg, joined
// into its run before the scan); E is row-local and each band seeds its
// own saved states. Band b writes these two words per column into one half
// of a per-lane ping-pong buffer while it reads band b - 1's from the
// other. Node maxima take the max over bands; the end cell is merged over
// bands in reduce_end's order with global rows.
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
// rows. Thread 0's diagonal is up0 and the A entering its first row a0
// (a lane's first rows: 0 and kNeg); with kCarry, a0 also enters the F
// scan. Returns, in every thread, the A after its last row.
template <int R, bool kCarry = false>
__device__ __forceinline__ int column_step(int (&h)[R], int (&e)[R],
                                           ColBits cb, const Scoring& s,
                                           int t, int n_stripe, int n_real,
                                           int& col_max, int& node_run,
                                           int up0 = 0, int a0 = kNeg) {
  int up = __shfl_up_sync(kFull, h[R - 1], 1);
  if (t == 0) up = up0;
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
  const int step = R * s.gap_extend;
  // the carry from the rows above thread 0, decayed over its R rows
  if (kCarry && t == 0) run = __viaddmax_s32(a0, -step, run);
  // inclusive scan over the threads, thread s < t decayed by (t - s) R gapE;
  // threads t < d get their own value back, which the max leaves as it is
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) {
    const int o = __shfl_up_sync(kFull, run, d);
    run = __viaddmax_s32(o, -d * step, run);
  }
  // A entering this thread's first row
  int a = __shfl_up_sync(kFull, run, 1);
  if (t == 0) a = a0;
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
  return a;
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
// stored by thread 0 (with kMerge, the max of it and the stored one: the
// row bands' node maxima).
template <int R, bool kMerge = false>
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
  if (t == 0) node_max[nid] = kMerge ? max(node_max[nid], m) : m;
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

// ---------------------------------------------------------------- row bands

// Rows per thread of a band, and read rows per band.
constexpr int kBandR = 26;
constexpr int kBandRows = kBandR * kGroup;

// Scratch words of one lane on the band path over at most L columns: one
// band's saved states and the N node maxima, then the ping-pong boundary
// buffers, [2][L] diagonals and [2][L] carries.
__host__ __device__ inline size_t band_lane_words(int N, int L) {
  return lane_words(N, kBandR) + 4 * static_cast<size_t>(L);
}

// One column of the lane's column stream.
struct Col {
  int ref, nid;
  bool start, last;
};

// The fill of one lane whose reads are longer than kBandRows rows, band by
// band, over clen <= L columns. col_at(c) gives column c, preds_of(nid) the
// node's P predecessor ids, code_at(j) the code of read row j < M. On exit
// every thread holds the lane's end cell (best, best_col, best_row, global
// row) and the scratch's node maxima cover all bands.
template <class ColAt, class PredsOf, class CodeAt>
__device__ __forceinline__ void band_lane(
    int t, int M, int len, int vlen, int clen, int N, int P, int L,
    const Scoring& s, int32_t* scratch, ColAt col_at, PredsOf preds_of,
    CodeAt code_at, int& best, int& best_col, int& best_row) {
  constexpr int R = kBandR;
  int32_t* saved_h = scratch;
  int32_t* saved_e = saved_h + static_cast<size_t>(N) * kBandRows;
  int32_t* node_max = saved_e + static_cast<size_t>(N) * kBandRows;
  int32_t* diag_buf = node_max + N;
  int32_t* carry_buf = diag_buf + 2 * static_cast<size_t>(L);
  zero_node_max(node_max, N, t);
  best = 0;
  best_col = 0;
  best_row = 0;
  const int n_bands = (M + kBandRows - 1) / kBandRows;
  for (int b = 0; b < n_bands; ++b) {
    const int off = b * kBandRows;
    const bool carry_in = b > 0, carry_out = b + 1 < n_bands;
    const int32_t* diag_in = diag_buf + ((b + 1) & 1) * L;
    const int32_t* a_in = carry_buf + ((b + 1) & 1) * L;
    int32_t* diag_out = diag_buf + (b & 1) * L;
    int32_t* a_out = carry_buf + (b & 1) * L;
    const int n_stripe = rows_below<R>(min(vlen, M) - off, t);
    const int n_real = rows_below<R>(min(len, M) - off, t);
    const CodeBits codes =
        load_codes<R>(t, M - off, [&](int j) { return code_at(off + j); });
    int h[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = 0;
      e[r] = 0;
    }
    int bb = 0, bc = 0, br = 0;
    int node_run = 0;
    for (int c = 0; c < clen; ++c) {
      const Col col = col_at(c);
      if (col.start) {
        seed<R>(h, e, preds_of(col.nid), P, N, saved_h, saved_e, t);
        node_run = 0;
      }
      int up0 = 0, a0 = kNeg;
      if (carry_in && t == 0) {
        up0 = diag_in[c];
        a0 = a_in[c];
      }
      if (carry_out && t == kGroup - 1) diag_out[c] = h[R - 1];
      int col_max = 0;
      const int a_end =
          column_step<R, true>(h, e, column_bits(codes, col.ref), s, t,
                               n_stripe, n_real, col_max, node_run, up0, a0);
      if (carry_out && t == kGroup - 1) a_out[c] = a_end;
      if (col_max > bb) {
        bb = col_max;
        bc = c;
        br = off + t * R + first_row<R>(h, col_max, n_stripe);
      }
      if (col.last) {
        save<R, true>(h, e, col.nid, node_run, saved_h, saved_e, node_max, t);
      }
    }
    reduce_end(bb, bc, br);
    if (bb > best || (bb == best && (bc < best_col ||
                                     (bc == best_col && br < best_row)))) {
      best = bb;
      best_col = bc;
      best_row = br;
    }
    // band b's boundary words and node maxima before band b + 1 reads them
    __syncwarp();
  }
}

}  // namespace sw_warp
