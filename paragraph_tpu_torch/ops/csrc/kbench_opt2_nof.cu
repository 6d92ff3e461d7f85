// K4 variant opt2_nof (VARIANTS id 11): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(11)
