// K4 variant notrack (VARIANTS id 2): one instantiation per row count.
#include "kbench_warp.cuh"

KBENCH_INSTANTIATE(2)
