// The culled megakernels' plan-mode instantiations (mega_kernel_culled_modes
// and mega_kernel_culled_surfaces_modes: super-groups, batched votes, the
// bounce unroll) and their launch, rtw_culled_modes_launch: megakernel.cu
// compiled a second time with RTW_MODES_TU, which leaves out its other
// kernels and entry points. The build (ops/_build.py) compiles each source
// in its own nvcc process, so the two halves build in parallel; a
// measurement build (-DRTW_MEASURE, with -DRTW_SPLIT or any other define)
// compiles megakernel.cu alone, without the plan modes.
#define RTW_MODES_TU
#include "megakernel.cu"
