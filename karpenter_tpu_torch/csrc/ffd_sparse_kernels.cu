// The sparse instances of the FFD scan (K1s, K7s: ffd_cluster_kernel<*, *,
// true>; K6s: ffd_ladder_kernel<*, true>), built as a library of their own so that nvcc compiles
// them beside the dense instances (ffd_kernels.cu), not after them. The
// kernels and their notes are in ffd_kernels.cu; this library exports only
// ffd_scan_sparse_launch, ffd_ladder_sparse_launch and ffd_ckpt_sparse_launch.
#define FFD_SPARSE_ONLY
#include "ffd_kernels.cu"
