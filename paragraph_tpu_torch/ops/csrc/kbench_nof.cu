// K4 variant nof (VARIANTS id 1): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(1)
