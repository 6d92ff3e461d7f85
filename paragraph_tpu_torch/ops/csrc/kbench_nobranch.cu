// K4 variant nobranch (VARIANTS id 3): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(3)
