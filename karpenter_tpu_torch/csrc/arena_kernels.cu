// Hand-written Hopper (sm_90a) kernel of the argument arena's upload. Plain
// C interface, loaded with ctypes (solver/cuda/build.py), the launcher
// convention of ffd_kernels.cu: a host array of device pointers, a host
// array of ints, the caller's stream; it returns cudaGetLastError().
//
// K8 arena_unpack  replaces karpenter_tpu/solver/arena.py:230 _unpack_fn:
//                  one packed uint8 upload sliced into typed arrays by
//                  bitcast, bools read as byte != 0.
// K14 apply_events replaces karpenter_tpu/solver/tpu/ffd.py:309
//                  ffd_apply_events (below).
// K16 pad_lanes    replaces karpenter_tpu/parallel/sharded.py:122 pad_batch
//                  (below).
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

// ---- K14: the streaming run-table edit scatter --------------------------------
//
// Replaces karpenter_tpu/solver/tpu/ffd.py:309 ffd_apply_events: a batch of
// (pos, gid, cnt) int32 edit rows scattered into the resident [Sp] run_group
// / run_count pair; rows whose pos lies outside [0, Sp) (EVENT_PAD_POS
// padding included) are dropped, as the reference documents (its scatter
// wraps a negative position as a NumPy index first: ROADMAP §C.9). As the
// reference's jit, which does not donate its inputs, the result is a NEW
// pair: the resident tensors are never written (an enqueued dispatch may
// still read them).
// What bounds it on the H100: bytes (the pair read and written once, 12 B an
// edit row) — and, at a few hundred runs and a handful of edits, the launch.
// Design: a grid-stride copy of the pair into the new buffers, then one
// thread per event row writing its two words; two launches on one stream, so
// the scatter lands after the copy. Positions are unique on the path
// (encode_cache.run_table_events diffs with np.nonzero); duplicates, as in
// the reference's scatter, have no defined winner.
constexpr int ET = 256;  // threads of the edit copy and scatter

__global__ void __launch_bounds__(ET) copy_runs_kernel(const int* __restrict__ rg,
                                                       const int* __restrict__ rc,
                                                       int* __restrict__ out_rg,
                                                       int* __restrict__ out_rc, int Sp) {
  for (int i = blockIdx.x * ET + threadIdx.x; i < Sp; i += gridDim.x * ET) {
    out_rg[i] = rg[i];
    out_rc[i] = rc[i];
  }
}

__global__ void __launch_bounds__(ET) apply_events_kernel(const int* __restrict__ ev,
                                                          int* __restrict__ out_rg,
                                                          int* __restrict__ out_rc, int Sp,
                                                          int K) {
  const int j = blockIdx.x * ET + threadIdx.x;
  if (j >= K) return;
  const int pos = ev[3 * j];
  if (pos < 0 || pos >= Sp) return;
  out_rg[pos] = ev[3 * j + 1];
  out_rc[pos] = ev[3 * j + 2];
}

// ---- K16: the device pad of a lane batch -------------------------------------------
//
// Replaces karpenter_tpu/parallel/sharded.py:122 pad_batch: every array of a
// stacked [n, ...] argument tuple padded to [B, ...] lanes, lanes b >= n
// copies of lane n - 1 (the cohort's pad members; decode discards them).
// What bounds it on the H100: bytes (each input lane read once, B lanes
// written) — at a cohort's few hundred kilobytes, the launch.
// Design: ONE launch for the whole tuple; the (source, destination, lane
// bytes) table rides in the kernel's parameters (no table upload, no host
// bytes); blockIdx.y picks the array, a grid-stride loop over blockIdx.x
// writes its B lanes, word by word where a lane is a whole number of 4-byte
// words (every int32 array, and bool tables of such sizes), else byte by byte.
constexpr int PT = 256;          // threads of the pad
constexpr int MAX_PAD = 64;      // solver/cuda/arena.py MAX_PAD
constexpr int MAX_PAD_GRID_X = 512;

struct PadArray {
  const unsigned char* src;  // [n, lane bytes]
  unsigned char* dst;        // [B, lane bytes]
  long long lane;            // bytes a lane
};

struct PadTable {
  PadArray arr[MAX_PAD];
};

template <typename W>
__device__ __forceinline__ void pad_copy(const W* src, W* dst, long long lane, long long total,
                                         int n) {
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x; i < total;
       i += (long long)gridDim.x * PT) {
    const long long b = i / lane;
    const long long from = (b < n ? b : n - 1) * lane + (i - b * lane);
    dst[i] = src[from];
  }
}

__global__ void __launch_bounds__(PT) pad_lanes_kernel(PadTable t, int n, int B) {
  const PadArray x = t.arr[blockIdx.y];
  if (x.lane <= 0) return;
  if ((x.lane & 3) == 0) {
    pad_copy(reinterpret_cast<const unsigned*>(x.src), reinterpret_cast<unsigned*>(x.dst),
             x.lane >> 2, (long long)B * (x.lane >> 2), n);
  } else {
    pad_copy(x.src, x.dst, x.lane, (long long)B * x.lane, n);
  }
}

}  // namespace

extern "C" {

// K14. ptrs: run_group [Sp], run_count [Sp], events [K, 3], the new
// run_group and run_count [Sp]; ints: Sp, K.
int apply_events_launch(void** p, int n, const int* d, void* stream) {
  if (n != 5) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], K = d[1];
  if (Sp < 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Sp > 0) {
    int g = (Sp + ET - 1) / ET;
    g = g > MAX_GRID_X ? MAX_GRID_X : g;
    copy_runs_kernel<<<g, ET, 0, st>>>((const int*)p[0], (const int*)p[1], (int*)p[3],
                                       (int*)p[4], Sp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (K > 0) {
    apply_events_kernel<<<(K + ET - 1) / ET, ET, 0, st>>>((const int*)p[2], (int*)p[3],
                                                         (int*)p[4], Sp, K);
  }
  return (int)cudaGetLastError();
}

// K16. ptrs: per array its input [n, ...] then its output [B, ...]; ints:
// the array count m, n, B, then each array's lane bytes as two ints (low,
// high 32 bits).
int pad_lanes_launch(void** p, int np, const int* d, void* stream) {
  const int m = d[0], n = d[1], B = d[2];
  if (m < 1 || m > MAX_PAD || np != 2 * m || n < 1 || B < n) return (int)cudaErrorInvalidValue;
  PadTable t{};
  long long max_words = 1;
  for (int i = 0; i < m; ++i) {
    PadArray& x = t.arr[i];
    x.src = (const unsigned char*)p[2 * i];
    x.dst = (unsigned char*)p[2 * i + 1];
    x.lane = (long long)(unsigned)d[3 + 2 * i] | ((long long)d[4 + 2 * i] << 32);
    if (x.lane < 0) return (int)cudaErrorInvalidValue;
    const long long w = (long long)B * ((x.lane & 3) == 0 ? x.lane >> 2 : x.lane);
    max_words = w > max_words ? w : max_words;
  }
  long long gx = (max_words + PT - 1) / PT;
  gx = gx < 1 ? 1 : (gx > MAX_PAD_GRID_X ? MAX_PAD_GRID_X : gx);
  pad_lanes_kernel<<<dim3((unsigned)gx, m), PT, 0, (cudaStream_t)stream>>>(t, n, B);
  return (int)cudaGetLastError();
}

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
