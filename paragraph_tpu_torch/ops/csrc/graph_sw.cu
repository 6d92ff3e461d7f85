// Single-graph Smith-Waterman fill for Hopper (sm_90a).
//
// Replaces the TPU kernel paragraph_tpu/ops/pallas_sw.py::_make_kernel as
// launched by pallas_fill, and computes exactly what it computes:
// affine-gap local SW (match 1, mismatch 4, open 6, extend 1 by default;
// N and pad score 0) of every lane (one read orientation) over all L
// columns of one graph, with node-start seeding from the predecessors'
// saved boundary states, E clamped at 0, gssw's end-cell tie-break and
// the multi-node flag. The plain PyTorch version is graph_fill_reference
// in ops/pallas_sw.py.
//
// What bounds it on this card. Each DP cell costs ~15 integer ALU
// operations and five shared-memory accesses (load H, E and the read
// code; store H and E); rows are a sequential recurrence per lane, so a
// lane's time is L x rows dependent steps. On the per-event path the
// launch is small: an event's graph has a few hundred to about a thousand
// columns and its reads give a few hundred to a thousand lanes, that is
// 8-32 CTAs of 32 lanes on 132 SMs, so most of the card idles and the
// kernel's time is one lane's chain of dependent steps (latency), not
// throughput. Only the largest launches (paragraph -M 10000: 20,000
// lanes) fill the card, and are then bound by integer issue and
// shared-memory bandwidth as K1 is.
//
// What this simple design does about it. One thread owns one lane and
// walks the graph's columns; for each column it runs the rows j < vlen
// (rows at or past the striped length never influence rows above them,
// and count neither for the end cell nor for the multi flag) in the
// sequential form of the TPU kernel's closed-form prefix max:
//     hp  = max(diag + prof, 0, E_j)
//     F_j = max(0, F_{j-1} - gapE, hp_{j-1} - gapO)        (F_0 = 0)
//     H_j = max(hp, F_j)
//     E_j = max(E_j - gapE, H_j - gapO, 0)
// which is exact because gapO >= gapE. The H/E column and the read's
// codes live in shared memory laid out [M][lanes], so neighbouring
// threads touch neighbouring words. All lanes of a launch share the
// graph, so each column's reference code, node id and start/last flags
// are broadcast loads through the read-only cache. The TPU kernel's
// packed end-cell word is not needed: one thread sees its lane's cells in
// column order, and within a column in row order, so three scalars
// (best, column, row) updated on a strict > give gssw's order (highest
// score, then the first column, then the lowest row) with no limit on
// the score's bits. The node maximum over real rows is one running scalar,
// reset at a node's first column and stored at its last. Saved boundary
// states [N][M][lanes] and node maxima [N][lanes] are per-CTA scratch in
// device memory that the wrapper allocates; the zero-state slot N is
// never stored, since H and E are never negative and seeding starts from
// zero. Edges are topological (SequenceGraph refuses others), so every
// predecessor's last column precedes its successor's first column and
// each saved state is written before it is read. The grid is capped so
// the scratch stays within the wrapper's budget, and each CTA strides
// over lane groups; lanes past B idle.
//
// Left for later: a warp per read with the F recurrence as a shuffle
// prefix max, which spreads one lane's rows over 32 threads and fills
// the SMs that small per-event launches leave idle; DPX maxima; int16
// state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct GraphParams {
  const int32_t* __restrict__ ref_codes;   // [L] 0-3 ACGT, 4 N or pad
  const int32_t* __restrict__ col_node;    // [L] node id
  const int32_t* __restrict__ is_start;    // [L] first column of its node
  const int32_t* __restrict__ is_last;     // [L] last column of its node
  const int32_t* __restrict__ pred_table;  // [N][P], value N = zero state
  const int8_t* __restrict__ read_codes_t; // [M][B] 0-3 ACGT, 4 N, 5 pad
  const int32_t* __restrict__ lens;        // [B]
  const int32_t* __restrict__ vlens;       // [B]
  int32_t* scratch;                        // [grid][2 N M + N][lanes]
  int32_t* out;                            // [4][B]
  int L, N, P, M, B;
  int gap_open, gap_extend, match, mismatch;
};

__global__ void graph_sw_kernel(const GraphParams p) {
  extern __shared__ int32_t smem[];
  const int lpb = blockDim.x;
  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, P = p.P;
  int32_t* sh_h = smem;                     // [M][lpb]
  int32_t* sh_e = smem + M * lpb;           // [M][lpb]
  int8_t* sh_code = reinterpret_cast<int8_t*>(smem + 2 * M * lpb);

  const size_t state = static_cast<size_t>(M) * lpb;
  int32_t* saved_h = p.scratch + blockIdx.x * (2 * N * state +
                                               static_cast<size_t>(N) * lpb);
  int32_t* saved_e = saved_h + N * state;
  int32_t* node_max = saved_e + N * state;

  const int n_groups = (p.B + lpb - 1) / lpb;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int lane = grp * lpb + tid;
    const bool live = lane < p.B;
    const int len = live ? p.lens[lane] : 0;
    const int rows = live ? min(p.vlens[lane], M) : 0;

    for (int j = 0; j < rows; ++j) {
      sh_code[j * lpb + tid] =
          p.read_codes_t[static_cast<size_t>(j) * p.B + lane];
      sh_h[j * lpb + tid] = 0;
      sh_e[j * lpb + tid] = 0;
    }

    int best = 0, best_col = 0, best_row = 0;
    int nodecol = 0;
    for (int c = 0; c < p.L; ++c) {
      const int ref_c = p.ref_codes[c];
      const int nid = p.col_node[c];
      const bool start = p.is_start[c] != 0;
      const bool last = p.is_last[c] != 0;
      const int32_t* preds = p.pred_table + nid * P;
      int32_t* sv_h = saved_h + nid * state;
      int32_t* sv_e = saved_e + nid * state;
      if (start) nodecol = 0;
      int diag = 0;     // H of row j-1 in the previous column
      int hp_prev = 0;  // H' of row j-1 in this column
      int f = 0;
      for (int j = 0; j < rows; ++j) {
        const int idx = j * lpb + tid;
        int h_old, e;
        if (start) {
          // seed: elementwise max of the predecessors' saved states; the
          // zero-state slot N adds nothing to a max of non-negatives
          h_old = 0;
          e = 0;
          for (int q = 0; q < P; ++q) {
            const int pq = preds[q];
            if (pq < N) {
              h_old = max(h_old, saved_h[pq * state + idx]);
              e = max(e, saved_e[pq * state + idx]);
            }
          }
        } else {
          h_old = sh_h[idx];
          e = sh_e[idx];
        }
        const int code = sh_code[idx];
        const int prof = (ref_c < 4 && code < 4)
                             ? (code == ref_c ? p.match : -p.mismatch)
                             : 0;
        const int hp = max(max(diag + prof, 0), e);
        if (j > 0) f = max(max(f - p.gap_extend, hp_prev - p.gap_open), 0);
        const int h = max(hp, f);
        const int e_next = max(max(e - p.gap_extend, h - p.gap_open), 0);
        sh_h[idx] = h;
        sh_e[idx] = e_next;
        if (last) {
          sv_h[idx] = h;
          sv_e[idx] = e_next;
        }
        if (h > best) {
          best = h;
          best_col = c;
          best_row = j;
        }
        if (j < len) nodecol = max(nodecol, h);
        diag = h_old;
        hp_prev = hp;
      }
      if (last) node_max[nid * lpb + tid] = nodecol;
    }

    if (live) {
      // every node slot counts, filler nodes included: a zero-score lane
      // with N > 1 gets multi = 1, as in the TPU kernel
      int n_top = 0;
      for (int n = 0; n < N; ++n) n_top += node_max[n * lpb + tid] == best;
      const bool zero = best == 0;
      p.out[lane] = best;
      p.out[p.B + lane] = zero ? -1 : best_col;
      p.out[2 * p.B + lane] = zero ? 0 : min(best_row, len - 1);
      p.out[3 * p.B + lane] = n_top > 1;
    }
  }
}

}  // namespace

extern "C" int graph_sw_launch(
    const void* ref_codes, const void* col_node, const void* is_start,
    const void* is_last, const void* pred_table, const void* read_codes_t,
    const void* lens, const void* vlens, void* scratch, void* out, int L,
    int N, int P, int M, int B, int lanes_per_block, int grid, int gap_open,
    int gap_extend, int match, int mismatch, void* stream) {
  if (lanes_per_block <= 0 || grid <= 0 || B <= 0 || N <= 0 || P <= 0 ||
      M <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GraphParams p;
  p.ref_codes = static_cast<const int32_t*>(ref_codes);
  p.col_node = static_cast<const int32_t*>(col_node);
  p.is_start = static_cast<const int32_t*>(is_start);
  p.is_last = static_cast<const int32_t*>(is_last);
  p.pred_table = static_cast<const int32_t*>(pred_table);
  p.read_codes_t = static_cast<const int8_t*>(read_codes_t);
  p.lens = static_cast<const int32_t*>(lens);
  p.vlens = static_cast<const int32_t*>(vlens);
  p.scratch = static_cast<int32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.L = L;
  p.N = N;
  p.P = P;
  p.M = M;
  p.B = B;
  p.gap_open = gap_open;
  p.gap_extend = gap_extend;
  p.match = match;
  p.mismatch = mismatch;
  const size_t smem = static_cast<size_t>(M) * lanes_per_block *
                      (2 * sizeof(int32_t) + sizeof(int8_t));
  cudaError_t err = cudaFuncSetAttribute(
      graph_sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  graph_sw_kernel<<<grid, lanes_per_block, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
