// The lane-batched scan (K15: ffd_lanes_kernel<false> and <true>), built as a
// library of its own so that nvcc compiles its two instances of the scan body
// beside the other scan instances (ffd_kernels.cu, ffd_sparse_kernels.cu),
// not after them. The kernel and its notes are in ffd_kernels.cu; this
// library exports only ffd_lanes_launch and ffd_lanes_zone_max_v.
#define FFD_LANES_ONLY
#include "ffd_kernels.cu"
