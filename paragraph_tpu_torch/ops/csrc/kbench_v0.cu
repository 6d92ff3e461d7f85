// K4 variant v0 (VARIANTS id 0): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(0)
