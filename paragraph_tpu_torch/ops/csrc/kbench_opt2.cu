// K4 variant opt2 (VARIANTS id 10): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(10)
