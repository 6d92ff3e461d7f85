// K4 variant opt1 (VARIANTS id 7): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(7)
