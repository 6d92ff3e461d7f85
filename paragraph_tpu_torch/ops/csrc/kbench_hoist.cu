// K4 variant hoist (VARIANTS id 4): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(4)
