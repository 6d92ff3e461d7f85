// K4 variant opt1_iprof (VARIANTS id 8): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(8)
