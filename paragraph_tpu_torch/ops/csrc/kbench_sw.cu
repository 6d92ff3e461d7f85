// Entry points of K4, the ablation ladder of the multi-event graph
// Smith-Waterman fill (tools/kbench2.py): the kernel, its variants and what
// each replaces are in kbench_warp.cuh; each variant's instantiations are
// compiled in kbench_<variant>.cu.

#include "kbench_warp.cuh"

namespace kbench {
KBENCH_IDS(KBENCH_DECLARE)
}  // namespace kbench

using kbench::Params;

extern "C" int kbench_sw_launch(
    int variant, const void* packed_cols, const void* pred_tables,
    const void* tile_col_start, const void* tile_col_len,
    const void* tile_event, const void* codes_t, const void* lens,
    const void* vlens, void* scratch, void* out, int B, int TB, int N, int P,
    int M, int lanes_per_block, int grid, int gap_open, int gap_extend,
    int match, int mismatch, int col_bits, void* stream) {
  // the profile table holds scores as int8; the per-row word needs a
  // column field
  if (lanes_per_block <= 0 || lanes_per_block > 32 || TB <= 0 ||
      TB % lanes_per_block != 0 || B % TB != 0 || grid <= 0 || N <= 0 ||
      P <= 0 || M <= 0 || gap_extend < 0 || gap_open < gap_extend ||
      match < 0 || match > 127 || mismatch < 0 || mismatch > 127 ||
      col_bits <= 0 || col_bits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.packed_cols = static_cast<const int32_t*>(packed_cols);
  p.pred_tables = static_cast<const int32_t*>(pred_tables);
  p.tile_col_start = static_cast<const int32_t*>(tile_col_start);
  p.tile_col_len = static_cast<const int32_t*>(tile_col_len);
  p.tile_event = static_cast<const int32_t*>(tile_event);
  p.codes_t = static_cast<const int8_t*>(codes_t);
  p.lens = static_cast<const int32_t*>(lens);
  p.vlens = static_cast<const int32_t*>(vlens);
  p.scratch = static_cast<int32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.B = B;
  p.TB = TB;
  p.N = N;
  p.P = P;
  p.M = M;
  p.col_bits = col_bits;
  p.s = {gap_open, gap_extend, match, mismatch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define KBENCH_CASE(ID) \
  case ID:              \
    return kbench::launch<ID>(p, lanes_per_block, grid, s);
    KBENCH_IDS(KBENCH_CASE)
#undef KBENCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of lanes_per_block warps of a variant resident on one SM at M rows.
extern "C" int kbench_sw_blocks_per_sm(int variant, int M,
                                       int lanes_per_block, int* out) {
  switch (variant) {
#define KBENCH_CASE(ID) \
  case ID:              \
    return kbench::blocks_per_sm<ID>(M, lanes_per_block, out);
    KBENCH_IDS(KBENCH_CASE)
#undef KBENCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
