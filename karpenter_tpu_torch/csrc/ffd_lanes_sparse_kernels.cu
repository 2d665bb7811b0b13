// The sparse lanes of a mesh-sharded solve (K17s: ffd_lanes_sparse_kernel<false>
// and <true>), built as a library of its own so that nvcc compiles its two
// instances of the sparse scan body beside the other scan instances, and
// K15's library (ffd_lanes_kernels.cu) compiles exactly as it did. The
// kernel and its notes are in ffd_kernels.cu; this library exports only
// ffd_lanes_sparse_launch, ffd_lanes_sparse_rows_budget and
// ffd_lanes_sparse_cluster_info.
#define FFD_LANES_ONLY
#define FFD_LANES_SPARSE
#include "ffd_kernels.cu"
