// K4 variant unroll2 (VARIANTS id 5): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(5)
