// K4 variant hoist_u2 (VARIANTS id 6): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(6)
