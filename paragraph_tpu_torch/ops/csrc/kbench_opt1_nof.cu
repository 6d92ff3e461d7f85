// K4 variant opt1_nof (VARIANTS id 9): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(9)
