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
// the few-hundred-kilobyte uploads of a solve, the launch and the host work
// around it. Design: one launch per adopt over a segment table that rides in
// the kernel's parameters (no table upload); blockIdx.y picks the segment, a
// grid-stride loop over blockIdx.x writes its output in 4-byte words. Every
// output is a view into ONE block the wrapper allocates per call
// (solver/cuda/arena.py UnpackPlan), each segment at a multiple of 256 bytes
// of the block, so a later kernel's vector or TMA load on a resident
// argument stays aligned; the table holds each segment's offset in the
// block, and the wrapper builds it once per segment list. The source keeps
// the reference's back-to-back packing, so a segment behind an odd-sized
// bool table starts at any byte: an aligned source is read a word at a
// time, any other byte by byte. The last nbytes % 4 bytes are written one at
// a time. A segment may instead be read from a device address: a resident
// tensor of an earlier block moved into this one (the arena's bound on the
// bytes a bucket holds), copied as it is.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int UT = 256;        // threads of the unpack
constexpr int MAX_SEGS = 64;   // solver/cuda/arena.py MAX_SEGS
constexpr int MAX_GRID_X = 1024;

struct Seg {
  const unsigned char* src;  // the segment's first byte: in the packed buffer, or a moved tensor
  int dst;                   // byte offset in the block (a multiple of 256)
  int nbytes;
  int is_bool;               // write src != 0
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

__global__ void __launch_bounds__(UT) arena_unpack_kernel(unsigned char* __restrict__ block,
                                                          SegTable t) {
  const Seg s = t.seg[blockIdx.y];
  const unsigned char* src = s.src;
  unsigned char* out = block + s.dst;
  const int words = s.nbytes >> 2;
  unsigned* dst = reinterpret_cast<unsigned*>(out);
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
    out[i] = s.is_bool ? (unsigned char)(v != 0) : v;
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
// Design: ONE launch into ONE [2, Sp] allocation (the new run_group row,
// then the new run_count row): a block owns ET positions, marks in shared
// memory which edit row aims at each of them, then each thread writes its
// position's two words once, the edit's or the input's. Up to EV_PARAM_ROWS
// rows ride in the kernel's parameters (a __grid_constant__ table, 3 KB of
// the 4 KB parameter space: no event tensor, no copy); past that the same
// kernel reads them from a device tensor. Positions are unique on the path
// (encode_cache.run_table_events diffs with np.nonzero); duplicates, as in
// the reference's scatter, have no defined winner.
constexpr int ET = 256;             // threads of the edit (positions a block)
constexpr int EV_PARAM_ROWS = 256;  // ffd.py EVENT_PARAM_ROWS

struct EvRows {
  int w[3 * EV_PARAM_ROWS];  // (pos, gid, cnt) rows
};

__global__ void __launch_bounds__(ET) apply_events_kernel(const int* __restrict__ rg,
                                                          const int* __restrict__ rc,
                                                          int* __restrict__ out,
                                                          const int* __restrict__ ev, int Sp,
                                                          int K, const __grid_constant__ EvRows t) {
  __shared__ int slot[ET];  // the edit row aimed at each position of the block, or -1
  const int lo = blockIdx.x * ET;
  const int* rows = ev != nullptr ? ev : t.w;
  slot[threadIdx.x] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += ET) {
    const int pos = rows[3 * j];
    if (pos >= lo && pos < lo + ET && pos < Sp) slot[pos - lo] = j;
  }
  __syncthreads();
  const int i = lo + threadIdx.x;
  if (i < Sp) {
    const int j = slot[threadIdx.x];
    out[i] = j < 0 ? rg[i] : rows[3 * j + 1];
    out[Sp + i] = j < 0 ? rc[i] : rows[3 * j + 2];
  }
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

// K14. ptrs: run_group [Sp], run_count [Sp], the new pair [2, Sp], the
// edit rows [K, 3] on the card or null; ints: Sp, K, then (rows null) the
// K rows' 3 K words, K at most EV_PARAM_ROWS.
int apply_events_launch(void** p, int n, const int* d, void* stream) {
  if (n != 4) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], K = d[1];
  const int* ev = (const int*)p[3];
  if (Sp < 0 || K < 0 || (ev == nullptr && K > EV_PARAM_ROWS)) return (int)cudaErrorInvalidValue;
  EvRows t;
  if (ev == nullptr) memcpy(t.w, d + 2, sizeof(int) * 3 * (size_t)K);
  const int g = Sp > 0 ? (Sp + ET - 1) / ET : 1;
  apply_events_kernel<<<g, ET, 0, (cudaStream_t)stream>>>((const int*)p[0], (const int*)p[1],
                                                          (int*)p[2], ev, Sp, K, t);
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

// ptrs: the packed buffer (null where no segment reads it), the block;
// ints: the segment count n, then per segment (source lo, source hi, byte
// count, kind, block offset): kind bit 0 a bool segment (write byte != 0),
// bit 1 a moved segment whose source is the device address hi:lo; else the
// source is the byte offset lo in the packed buffer.
int arena_unpack_launch(void** p, int n, const int* d, void* stream) {
  const int nseg = d[0];
  if (nseg < 1 || nseg > MAX_SEGS || n != 2 || p[1] == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned char* buf = (const unsigned char*)p[0];
  SegTable t{};
  int max_words = 1;
  for (int i = 0; i < nseg; ++i) {
    const int* e = d + 1 + 5 * i;
    Seg& s = t.seg[i];
    const int kind = e[3];
    if (kind & 2) {
      s.src = (const unsigned char*)(uintptr_t)((unsigned long long)(unsigned)e[0] |
                                                ((unsigned long long)(unsigned)e[1] << 32));
    } else {
      if (buf == nullptr || e[0] < 0) return (int)cudaErrorInvalidValue;
      s.src = buf + e[0];
    }
    s.nbytes = e[2];
    s.is_bool = kind & 1;
    s.dst = e[4];
    if (s.src == nullptr || s.nbytes < 0 || s.dst < 0 || (s.dst & 3) != 0)
      return (int)cudaErrorInvalidValue;
    max_words = s.nbytes / 4 > max_words ? s.nbytes / 4 : max_words;
  }
  int gx = (max_words + UT - 1) / UT;
  gx = gx < 1 ? 1 : (gx > MAX_GRID_X ? MAX_GRID_X : gx);
  arena_unpack_kernel<<<dim3(gx, nseg), UT, 0, (cudaStream_t)stream>>>((unsigned char*)p[1], t);
  return (int)cudaGetLastError();
}

}  // extern "C"
