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
// What bounds it on this card. A lane is a chain of L dependent columns.
// On the per-event path a launch holds one event's reads: a few hundred
// to a thousand lanes over a few hundred to a thousand columns, too few
// lanes to fill 132 SMs with one thread each. There the kernel is bound by
// the latency of one lane's column chain. Only the largest launches
// (paragraph -M 10000: 20,000 lanes) fill the card, and are then bound by
// INT32 issue: about 15 integer operations per cell, plus the scan's
// shuffles and the per-column work, which thread t spreads over its R rows.
//
// What this design does about it (sw_warp.cuh). One warp owns one lane and
// each of its threads R = ceil(M / 32) rows, in registers, so a column of
// a lane is 32 threads working at once: its latency is R dependent steps
// twice and a five-step shuffle scan for F, not M steps, and a per-event
// launch of 480 lanes puts 480 warps on the card instead of 15. There is
// no per-cell shared-memory traffic: the TPU kernel's rows along its
// vector's sublanes, with F as a log-step prefix max, become rows across
// a warp's threads with F as a shuffle prefix max. The end cell is three
// scalars per thread (no packed word, so no limit on the score's bits,
// and match=100000 runs here too), reduced over the warp at the lane's
// end. All lanes of a launch share the graph, so each column's reference
// code, node id and start/last flags are broadcast loads through the
// read-only cache. Edges are topological (SequenceGraph refuses others), so
// every predecessor's last column precedes its successor's first column
// and each saved state is written before it is read. A CTA holds
// lanes_per_block warps; the grid is capped so the scratch stays within
// the wrapper's budget, and each warp strides over lanes; warps past B
// idle.
//
// Reads longer than 832 rows (M > kBandRows) take graph_sw_band_kernel:
// the same column step over bands of 832 rows (sw_warp.cuh, band_lane),
// with two boundary words per column and band carried in per-lane scratch.
// There is no packed word, so any M is taken. Launches with M <= 832 keep
// graph_sw_kernel.

#include "sw_warp.cuh"

namespace {

using namespace sw_warp;

struct GraphParams {
  const int32_t* __restrict__ ref_codes;   // [L] 0-3 ACGT, 4 N or pad
  const int32_t* __restrict__ col_node;    // [L] node id
  const int32_t* __restrict__ is_start;    // [L] first column of its node
  const int32_t* __restrict__ is_last;     // [L] last column of its node
  const int32_t* __restrict__ pred_table;  // [N][P], value N = zero state
  const int8_t* __restrict__ read_codes_t; // [M][B] 0-3 ACGT, 4 N, 5 pad
  const int32_t* __restrict__ lens;        // [B]
  const int32_t* __restrict__ vlens;       // [B]
  int32_t* scratch;                        // [grid][warps][lane_words]
  int32_t* out;                            // [4][B]
  int L, N, P, M, B;
  Scoring s;
};

template <int R>
__global__ void graph_sw_kernel(const GraphParams p) {
  const int t = threadIdx.x % kGroup;
  const int warps = blockDim.x / kGroup;
  const int w = threadIdx.x / kGroup;
  const int N = p.N, M = p.M;
  constexpr int slot = R * kGroup;
  int32_t* saved_h =
      p.scratch + (static_cast<size_t>(blockIdx.x) * warps + w) *
                      lane_words(N, R);
  int32_t* saved_e = saved_h + static_cast<size_t>(N) * slot;
  int32_t* node_max = saved_e + static_cast<size_t>(N) * slot;

  for (int lane = blockIdx.x * warps + w; lane < p.B;
       lane += gridDim.x * warps) {
    const int len = p.lens[lane];
    const int n_stripe = rows_below<R>(min(p.vlens[lane], M), t);
    const int n_real = rows_below<R>(min(len, M), t);
    const CodeBits codes = load_codes<R>(t, M, [&](int j) {
      return static_cast<int>(p.read_codes_t[static_cast<size_t>(j) * p.B +
                                             lane]);
    });
    zero_node_max(node_max, N, t);

    int h[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = 0;
      e[r] = 0;
    }
    int best = 0, best_col = 0, best_row = 0;
    int node_run = 0;
    for (int c = 0; c < p.L; ++c) {
      const int ref_c = __ldg(p.ref_codes + c);
      const int nid = __ldg(p.col_node + c);
      if (__ldg(p.is_start + c)) {
        seed<R>(h, e, p.pred_table + nid * p.P, p.P, N, saved_h, saved_e, t);
        node_run = 0;
      }
      int col_max = 0;
      column_step<R>(h, e, column_bits(codes, ref_c), p.s, t, n_stripe,
                     n_real, col_max, node_run);
      if (col_max > best) {
        best = col_max;
        best_col = c;
        best_row = t * R + first_row<R>(h, col_max, n_stripe);
      }
      if (__ldg(p.is_last + c)) {
        save<R>(h, e, nid, node_run, saved_h, saved_e, node_max, t);
      }
    }

    reduce_end(best, best_col, best_row);
    __syncwarp();
    // every node slot counts, filler nodes included: a zero-score lane
    // with N > 1 gets multi = 1, as in the TPU kernel
    const int n_top = count_top(node_max, N, best, t);
    if (t == 0) {
      const bool zero = best == 0;
      p.out[lane] = best;
      p.out[p.B + lane] = zero ? -1 : best_col;
      p.out[2 * p.B + lane] = zero ? 0 : min(best_row, len - 1);
      p.out[3 * p.B + lane] = n_top > 1;
    }
    __syncwarp();
  }
}

// Reads longer than kBandRows: graph_sw_kernel's lane, with band_lane over
// the graph's L columns in place of the column loop.
__global__ void graph_sw_band_kernel(const GraphParams p) {
  const int t = threadIdx.x % kGroup;
  const int warps = blockDim.x / kGroup;
  const int w = threadIdx.x / kGroup;
  int32_t* scratch =
      p.scratch + (static_cast<size_t>(blockIdx.x) * warps + w) *
                      band_lane_words(p.N, p.L);
  const int32_t* node_max =
      scratch + 2 * static_cast<size_t>(p.N) * kBandRows;

  for (int lane = blockIdx.x * warps + w; lane < p.B;
       lane += gridDim.x * warps) {
    const int len = p.lens[lane];
    int best, best_col, best_row;
    band_lane(
        t, p.M, len, p.vlens[lane], p.L, p.N, p.P, p.L, p.s, scratch,
        [&](int c) {
          return Col{__ldg(p.ref_codes + c), __ldg(p.col_node + c),
                     __ldg(p.is_start + c) != 0, __ldg(p.is_last + c) != 0};
        },
        [&](int nid) { return p.pred_table + nid * p.P; },
        [&](int j) {
          return static_cast<int>(
              p.read_codes_t[static_cast<size_t>(j) * p.B + lane]);
        },
        best, best_col, best_row);
    const int n_top = count_top(node_max, p.N, best, t);
    if (t == 0) {
      const bool zero = best == 0;
      p.out[lane] = best;
      p.out[p.B + lane] = zero ? -1 : best_col;
      p.out[2 * p.B + lane] = zero ? 0 : min(best_row, len - 1);
      p.out[3 * p.B + lane] = n_top > 1;
    }
    __syncwarp();
  }
}

template <int R>
int launch(const GraphParams& p, int lanes_per_block, int grid,
           cudaStream_t stream) {
  graph_sw_kernel<R><<<grid, lanes_per_block * kGroup, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int blocks_per_sm(int lanes_per_block, int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, graph_sw_kernel<R>, lanes_per_block * kGroup, 0));
}

}  // namespace

// Rows per thread of a launch at M read rows; 0 past the largest, where
// the launchers take the band kernels.
extern "C" int sw_warp_rows(int M) { return M > 0 ? rows_for(M) : 0; }

// Scratch words of one lane of a K1, K2 or K3 launch at N node slots and M
// read rows; on the band path (M > kBandRows) over at most band_cols
// columns per lane.
extern "C" long long sw_warp_lane_words(int N, int M, int band_cols) {
  if (N <= 0 || M <= 0) return 0;
  if (M > kBandRows) {
    return band_cols > 0 ? static_cast<long long>(
                               band_lane_words(N, band_cols))
                         : 0;
  }
  return static_cast<long long>(lane_words(N, rows_for(M)));
}

extern "C" int graph_sw_launch(
    const void* ref_codes, const void* col_node, const void* is_start,
    const void* is_last, const void* pred_table, const void* read_codes_t,
    const void* lens, const void* vlens, void* scratch, void* out, int L,
    int N, int P, int M, int B, int lanes_per_block, int grid, int gap_open,
    int gap_extend, int match, int mismatch, void* stream) {
  if (lanes_per_block <= 0 || lanes_per_block > 32 || grid <= 0 || B <= 0 ||
      N <= 0 || P <= 0 || M <= 0 || L <= 0 || gap_extend < 0 ||
      gap_open < gap_extend) {
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
  p.s = {gap_open, gap_extend, match, mismatch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > kBandRows) {
    graph_sw_band_kernel<<<grid, lanes_per_block * kGroup, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  switch (rows_for(M)) {
#define GRAPH_SW_CASE(R) \
  case R:                \
    return launch<R>(p, lanes_per_block, grid, s);
    SW_WARP_ROW_COUNTS(GRAPH_SW_CASE)
#undef GRAPH_SW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of lanes_per_block warps resident on one SM at M read rows.
extern "C" int graph_sw_blocks_per_sm(int M, int lanes_per_block, int* out) {
  if (M > kBandRows) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, graph_sw_band_kernel, lanes_per_block * kGroup, 0));
  }
  switch (M > 0 ? rows_for(M) : 0) {
#define GRAPH_SW_CASE(R) \
  case R:                \
    return blocks_per_sm<R>(lanes_per_block, out);
    SW_WARP_ROW_COUNTS(GRAPH_SW_CASE)
#undef GRAPH_SW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
