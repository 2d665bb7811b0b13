// The batched consolidation scan (K4: ffd_batched_kernel<ZONE, MANY>), built
// as a library of its own so that nvcc compiles its instances of the scan
// body beside the other scan instances (ffd_kernels.cu,
// ffd_sparse_kernels.cu, the lanes libraries), not after them. The kernel
// and its notes are in ffd_kernels.cu; this library exports only
// ffd_batched_launch, ffd_batched_rows_budget and ffd_batched_info.
#define FFD_BATCHED_ONLY
#include "ffd_kernels.cu"
