// Hand-written Hopper (sm_90a) kernel of the argument arena's upload. Plain
// C interface, loaded with ctypes (solver/cuda/build.py), the launcher
// convention of ffd_kernels.cu: a host array of device pointers, a host
// array of ints, the caller's stream; it returns cudaGetLastError().
//
// K8 arena_unpack  replaces karpenter_tpu/solver/arena.py:230 _unpack_fn:
//                  one packed uint8 upload sliced into typed arrays by
//                  bitcast, bools read as byte != 0.
//
// What bounds it on the H100: bytes (each packed byte read once, each output
// byte written once; no arithmetic but a compare per bool byte) — and, at
// the few-hundred-kilobyte uploads of a solve, the launch itself. Design:
// one launch per adopt over a segment table that rides in the kernel's
// parameters (no table upload); blockIdx.y picks the segment, a grid-stride
// loop over blockIdx.x writes its output in 4-byte words. The destination
// is a fresh tensor, so 4-byte aligned; the source keeps the reference's
// back-to-back packing, so a segment behind an odd-sized bool table starts
// at any byte: an aligned source is read a word at a time, any other byte by
// byte. The last nbytes % 4 bytes are written one at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UT = 256;        // threads of the unpack
constexpr int MAX_SEGS = 64;   // solver/cuda/arena.py MAX_SEGS
constexpr int MAX_GRID_X = 1024;

struct Seg {
  unsigned char* dst;
  int src;       // byte offset in the packed buffer
  int nbytes;
  int is_bool;   // write src != 0
};

struct SegTable {
  Seg seg[MAX_SEGS];
};

__device__ __forceinline__ unsigned bool_bytes(unsigned v) {
  // each byte -> 1 if nonzero, else 0
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) r |= (((v >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << (8 * k);
  return r;
}

__global__ void __launch_bounds__(UT) arena_unpack_kernel(const unsigned char* __restrict__ buf,
                                                          SegTable t) {
  const Seg s = t.seg[blockIdx.y];
  const unsigned char* src = buf + s.src;
  const int words = s.nbytes >> 2;
  unsigned* dst = reinterpret_cast<unsigned*>(s.dst);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3u) == 0u;
  for (int w = blockIdx.x * UT + threadIdx.x; w < words; w += gridDim.x * UT) {
    unsigned v;
    if (aligned) {
      v = reinterpret_cast<const unsigned*>(src)[w];
    } else {
      const unsigned char* p = src + 4 * w;
      v = (unsigned)p[0] | ((unsigned)p[1] << 8) | ((unsigned)p[2] << 16) | ((unsigned)p[3] << 24);
    }
    dst[w] = s.is_bool ? bool_bytes(v) : v;
  }
  const int tail = s.nbytes & 3;
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const int i = (words << 2) + threadIdx.x;
    const unsigned char v = src[i];
    s.dst[i] = s.is_bool ? (unsigned char)(v != 0) : v;
  }
}

}  // namespace

extern "C" {

// ptrs: the packed buffer, then one destination per segment; ints: the
// segment count n, then (byte offset, byte count, is_bool) per segment.
int arena_unpack_launch(void** p, int n, const int* d, void* stream) {
  const int nseg = d[0];
  if (nseg < 1 || nseg > MAX_SEGS || n != nseg + 1) return (int)cudaErrorInvalidValue;
  SegTable t{};
  int max_words = 1;
  for (int i = 0; i < nseg; ++i) {
    Seg& s = t.seg[i];
    s.dst = (unsigned char*)p[1 + i];
    s.src = d[1 + 3 * i];
    s.nbytes = d[2 + 3 * i];
    s.is_bool = d[3 + 3 * i];
    if (s.src < 0 || s.nbytes < 0) return (int)cudaErrorInvalidValue;
    max_words = s.nbytes / 4 > max_words ? s.nbytes / 4 : max_words;
  }
  int gx = (max_words + UT - 1) / UT;
  gx = gx < 1 ? 1 : (gx > MAX_GRID_X ? MAX_GRID_X : gx);
  arena_unpack_kernel<<<dim3(gx, nseg), UT, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)p[0], t);
  return (int)cudaGetLastError();
}

}  // extern "C"
