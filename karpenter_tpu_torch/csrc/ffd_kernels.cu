// Hand-written Hopper (sm_90a) kernels for the provisioning solve's main
// path. Plain C interface, loaded with ctypes (solver/cuda/build.py); each
// launcher takes a host array of device pointers, a host array of dims and
// the caller's stream, and returns cudaGetLastError() after its launches.
//
// Integer semantics follow the JAX reference exactly: int32 arithmetic
// wraps (done here in unsigned), `//` floors (C `/` truncates), ties in
// argmax go to the lowest index, uint32 words are carried as raw bits.
//
// K1 ffd_scan      replaces karpenter_tpu/solver/tpu/ffd.py:1884 ffd_solve
//                   (_ffd_scan :395): ffd_cluster_kernel<false, false,
//                   false> the fast branch (step_body.fast :605-855),
//                   ffd_cluster_kernel<true, false, false> adds the zoned
//                   branch (step_body.zoned :860-1663, count_contrib :587);
//                   one thread-block cluster a solve.
// K2 + K3 pack_delta  replaces karpenter_tpu/solver/backend.py:635
//                   _pack_outputs_delta: tpu/ffd.py:325 compact_takes (K2),
//                   :358 compact_claim_meta with the c_mask word pack of
//                   backend.py:652-660 (K3) and the concatenation, in one
//                   launch of a thread-block cluster that writes the fetch
//                   buffer (pack_delta_kernel<64>); mask_words_kernel, its
//                   word stage alone, serves backend.py:569
//                   _pack_outputs_wide.
// K4 ffd_batched    replaces karpenter_tpu/solver/tpu/consolidate.py:57
//                   _batched_ffd_core (jit :97): ffd_batched_kernel<ZONE,
//                   MANY>, K1's cluster scan on each candidate-subset row,
//                   the team chosen at launch from the rows: one cluster of
//                   CL CTAs a row, or one CTA a row with several rows an SM;
//                   built from ffd_batched_kernels.cu (this file with
//                   FFD_BATCHED_ONLY).
// K5 pack_verdicts  replaces karpenter_tpu/solver/tpu/consolidate.py:291
//                   _pack_verdicts.
// K6 ffd_ladder     replaces karpenter_tpu/solver/tpu/ffd.py:2167
//                   ffd_solve_ladder (step_ladder :1714-1800):
//                   ffd_ladder_kernel<ZONE, false>, the relax-ladder
//                   cascade of attempts per run; one thread-block cluster
//                   a solve.
// K7 ffd_ckpt       replaces karpenter_tpu/solver/tpu/ffd.py:1975
//                   ffd_solve_ckpt and :2071 ffd_resume (step_ck
//                   :1825-1850): ffd_cluster_kernel<ZONE, true, false>,
//                   K1's scan that also snapshots its whole carry into a
//                   device-resident ring every K steps.
// K9 pack_outputs   replaces karpenter_tpu/solver/backend.py:511 _pack_outputs.
// K15 ffd_lanes     replaces karpenter_tpu/parallel/sharded.py:80 batched_solve:
//                   ffd_lanes_kernel<ZONE>, K1's scan on each of B lanes,
//                   one thread-block cluster a lane, its size chosen at
//                   launch; built from ffd_lanes_kernels.cu (this file
//                   with FFD_LANES_ONLY).
// K17 ffd_sharded  replaces karpenter_tpu/solver/tpu/ffd.py:2264
//                   ffd_solve_sharded: K15's ffd_lanes_kernel<ZONE>, one
//                   lane per run block of a mesh-sharded solve, the shared
//                   tables at a per-lane count of 0 (no kernel of its own).
// K17s              replaces karpenter_tpu/solver/tpu/ffd.py:2800
//                   ffd_solve_sharded_sparse: ffd_lanes_sparse_kernel<ZONE>,
//                   K1s's scan per run block, one cluster a lane; built
//                   from ffd_lanes_sparse_kernels.cu (this file with
//                   FFD_LANES_ONLY and FFD_LANES_SPARSE).
// K1s/K6s/K7s       replace karpenter_tpu/solver/tpu/ffd.py:2403
//                   ffd_solve_sparse, :2701 ffd_solve_ladder_sparse, :2500
//                   ffd_solve_ckpt_sparse and :2602 ffd_resume_sparse: the
//                   template flag SPARSE of K1/K6/K7 (ffd_cluster_kernel's
//                   third, ffd_ladder_kernel's second), built from
//                   ffd_sparse_kernels.cu (this file with FFD_SPARSE_ONLY).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

// the main library (ffd_kernels.cu built alone): K2 + K3, K5, K9 and the
// checks beside the single-solve scans
#if !defined(FFD_SPARSE_ONLY) && !defined(FFD_LANES_ONLY) && !defined(FFD_BATCHED_ONLY)
#define FFD_MAIN_LIBRARY
#endif

// The scan instances' launch-sized shared rows (RunShared's Q rows, then
// the zoned instances' V rows: ZoneShared::mv/ov/vk/vcol), at file scope:
// an extern shared array does not belong in the unnamed namespace.
extern __shared__ __align__(16) unsigned char scan_rows[];

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 1024;          // threads of the single-block kernels
constexpr int NWARPS = NT / 32;
constexpr int BIG = 1 << 30;
constexpr int I32MAX = 2147483647;
constexpr int MAX_R = 16;         // solver/cuda/ffd.py MAX_R
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }

// floor division for b >= 1 (every divisor of the scan is max(x, 1))
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) q -= 1;
  return q;
}

// ---- a block-wide helper (all NT threads must call it) ----------------------

// out[i] = sum(in[0..i)) with int32 wrap; returns the total. Thread t owns
// the contiguous chunk [t*per, (t+1)*per). `in` may alias `out`.
__device__ unsigned block_exclusive_scan(const int* in, int* out, int n, unsigned* sh) {
  const int per = (n + NT - 1) / NT;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += (unsigned)in[i];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned x = s;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned w = sh[lane];
    for (int o = 1; o < 32; o <<= 1) {
      unsigned y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  unsigned run = (wid ? sh[wid - 1] : 0u) + x - s;
  const unsigned total = sh[NWARPS - 1];
  for (int i = lo; i < hi; ++i) {
    unsigned v = (unsigned)in[i];
    out[i] = (int)run;
    run += v;
  }
  __syncthreads();
  return total;
}


// ---- the team: the threads that walk one solve -----------------------------
//
// One thread-block cluster of n CTAs of NTC threads on neighbouring SMs
// (K1, K6, K7 and their sparse twins, one cluster a solve; K15, K17 and
// K17s, one cluster a lane, and K4, one cluster a subset row, several
// clusters a launch; a cluster may be one CTA). Work over
// node rows, claim rows and [n, T] grids is split over the team's threads
// (gtid of gnt) or warps (gwid of gnw); every CTA
// computes the control scalars, the run's Q / V rows, the pool passes and
// the zoned [Z] / [P] vectors itself from the same data, so nothing is
// broadcast. Partials cross CTAs through distributed shared memory: a CTA
// pushes its partial into a slot of every peer (team_reduce, team_scan), or
// folds its peers' min / max accumulators into its own in place
// (pull_acc: the ops are idempotent, so a peer reading ours meanwhile still
// finds the extreme), or sums its peers' partials into a slot of its own
// (pull_sum), each after a cluster barrier whose release / acquire also
// orders the CTAs' global writes. A slot pair is used by parity, so a slot
// is written again only after one more cluster barrier has passed.

constexpr int NTC = 512;          // threads of one CTA of a cluster scan
constexpr int MAX_CL = 16;        // the widest cluster

struct TeamShared {
  int red[NWARPS];                // a CTA's per-warp partials
  long long red64[NWARPS];
  int slot[2][MAX_CL];            // CL: each CTA's partial, pushed into every peer
  long long slot64[2][MAX_CL];
};

struct Team {
  static constexpr int NTB = NTC;  // threads of a CTA
  static constexpr int NWB = NTB / 32;
  int tid, lane, wid;             // in the CTA
  int rank, n;                    // the CTA's rank, the cluster's CTAs
  int gtid, gnt, gwid, gnw;       // over the team
  int par;                        // parity of the next push slot
  __device__ Team() {
    tid = threadIdx.x;
    lane = tid & 31;
    wid = tid >> 5;
    cg::cluster_group c = cg::this_cluster();
    rank = (int)c.block_rank();
    n = (int)c.num_blocks();
    gtid = rank * NTB + tid;
    gnt = n * NTB;
    gwid = rank * NWB + wid;
    gnw = n * NWB;
    par = 0;
  }
  // the one thread that writes the team's global scalars
  __device__ __forceinline__ bool lead() const { return rank == 0 && tid == 0; }
};

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// the address of `p` (this CTA's shared memory) in peer CTA r
template <typename T>
__device__ __forceinline__ T* peer(T* p, int r) {
  return cg::this_cluster().map_shared_rank(p, r);
}

enum { OP_MIN, OP_MAX, OP_SUM };

template <int OP>
__device__ __forceinline__ int op2(int a, int b) {
  if constexpr (OP == OP_MIN) return min(a, b);
  else if constexpr (OP == OP_MAX) return max(a, b);
  else return wadd(a, b);
}

// the CTA's reduction of one int a thread (every thread of the CTA calls it)
template <int OP, int NWB>
__device__ int cta_reduce(int v, int lane, int wid, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = op2<OP>(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int r = red[0];
  for (int i = 1; i < NWB; ++i) r = op2<OP>(r, red[i]);
  return r;
}

// the team's reduction of one int a thread (every thread of the team calls it)
template <int OP>
__device__ int team_reduce(Team& tm, int v, TeamShared& ts) {
  int r = cta_reduce<OP, Team::NWB>(v, tm.lane, tm.wid, ts.red);
  const int b = tm.par;
  tm.par ^= 1;
  if (tm.tid < tm.n) *peer(&ts.slot[b][tm.rank], tm.tid) = r;
  cluster_barrier();
  r = ts.slot[b][0];
  for (int i = 1; i < tm.n; ++i) r = op2<OP>(r, ts.slot[b][i]);
  return r;
}

// The CTA's exclusive prefix of one 64-bit sum a thread, in thread order:
// returns the thread's offset and the CTA's total in `total`.
template <int NWB>
__device__ long long cta_prefix(long long s, int lane, int wid, long long* red64, long long& total) {
  long long x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red64[wid] = x;
  __syncthreads();
  long long off = x - s;
  total = 0;
  for (int i = 0; i < NWB; ++i) {
    const long long w = red64[i];
    if (i < wid) off += w;
    total += w;
  }
  return off;
}

// out[i] = sum(in[j] for j < i) with int32 wrap over the team's chunks:
// thread gtid owns [lo, hi), the chunks contiguous and ascending in gtid; a
// thread writes only its own chunk (`in` may alias `out`). Returns the
// exact (64-bit) sum of every chunk.
__device__ long long team_scan(Team& tm, const int* in, int* out, int lo, int hi, TeamShared& ts) {
  long long s = 0;
  for (int i = lo; i < hi; ++i) s += in[i];
  long long total;
  long long off = cta_prefix<Team::NWB>(s, tm.lane, tm.wid, ts.red64, total);
  const int b = tm.par;
  tm.par ^= 1;
  if (tm.tid < tm.n) *peer(&ts.slot64[b][tm.rank], tm.tid) = total;
  cluster_barrier();
  total = 0;
  for (int i = 0; i < tm.n; ++i) {
    const long long c = ts.slot64[b][i];
    if (i < tm.rank) off += c;
    total += c;
  }
  unsigned run = (unsigned)(unsigned long long)off;
  for (int i = lo; i < hi; ++i) {
    const unsigned v = (unsigned)in[i];
    out[i] = (int)run;
    run += v;
  }
  __syncthreads();
  return total;
}

// thread gtid's contiguous chunk of [0, n)
__device__ __forceinline__ void thread_chunk(const Team& tm, int n, int& lo, int& hi) {
  const int per = (n + tm.gnt - 1) / tm.gnt;
  lo = min(tm.gtid * per, n);
  hi = min(lo + per, n);
}

// The claim rows a CTA's warps own, and warp gwid's contiguous chunk of
// [0, n): the claim rows a warp owns. Every CTA takes ceil(n / CTAs) rows
// first and splits them over its warps, so a solve with few claims open
// keeps every CTA busy (a cluster of one CTA: ceil(n / warps) rows a
// warp). The chunks are contiguous and ascending in gwid.
__device__ __forceinline__ void cta_chunk(const Team& tm, int n, int& lo, int& hi) {
  const int per = (n + tm.n - 1) / tm.n;
  lo = min(tm.rank * per, n);
  hi = min(lo + per, n);
}

__device__ __forceinline__ void warp_chunk(const Team& tm, int n, int& lo, int& hi) {
  int clo, chi;
  cta_chunk(tm, n, clo, chi);
  const int per = (chi - clo + Team::NWB - 1) / Team::NWB;
  lo = min(clo + tm.wid * per, chi);
  hi = min(lo + per, chi);
}

// The warps that share one claim row's [T] walk: NWB / rows where the CTA
// holds fewer rows than warps, so a row's walk issues a fraction of its
// serial loads (the other warps idle); else 1. Warp i * ws + j walks types
// j * 32 + lane, stepping 32 * ws, of the CTA's row i; their maxima meet
// in the CTA's shared memory.
template <int NWB>
__device__ __forceinline__ int row_warps(int rows) {
  return rows > 0 && rows < NWB ? NWB / rows : 1;
}

// the position of the r-th set bit of b (r < popc(b))
__device__ __forceinline__ int nth_bit(unsigned b, int r) {
  for (int q = 0; q < r; ++q) b &= b - 1u;
  return __ffs(b) - 1;
}

// a lane's contiguous piece of its warp's chunk [wlo, whi)
__device__ __forceinline__ void lane_chunk(int wlo, int whi, int lane, int& lo, int& hi) {
  const int per = (whi - wlo + 31) / 32;
  lo = min(wlo + lane * per, whi);
  hi = min(lo + per, whi);
}

// ---- exact division by the run's request -------------------------------------
//
// floor(n / d) for d >= 1 as a multiply-high: with l = ceil(log2 d) and
// m = ceil(2^(31+l) / d) < 2^32, floor(u * m / 2^(31+l)) = floor(u / d) for
// every 0 <= u < 2^31 (Granlund & Montgomery 1994, theorem 4.2 at N = 31,
// since m d - 2^(31+l) < d <= 2^l); a negative n floors through
// ~n = -n - 1 >= 0: floor(n / d) = ~floor(~n / d). Exact for every int32 n,
// as the plain _floordiv floors.
__device__ __forceinline__ void magic_of(int d, unsigned& m, int& sh) {
  const int l = d > 1 ? 32 - __clz(d - 1) : 0;
  m = (unsigned)(((1ull << (31 + l)) + (unsigned)d - 1u) / (unsigned)d);
  sh = 31 + l;
}

__device__ __forceinline__ int floordiv_magic(int n, unsigned m, int sh) {
  const unsigned u = n >= 0 ? (unsigned)n : ~(unsigned)n;
  const unsigned q = (unsigned)(((unsigned long long)u * m) >> sh);
  return n >= 0 ? (int)q : (int)~q;
}

// ---- K1: the FFD scan --------------------------------------------------------
//
// What bounds it on the H100: the scan is sequential over runs, and a run's
// work is small — the [used, T] claim fit (about M·T·R integer divisions)
// plus per-pool [T] passes — so the card is latency-bound, far from both
// its memory and its integer peak; on one SM the open-claim fit and the
// mask narrowing were 90% of a surge run (PERF.md §6, Step 0).
// Design: ONE launch per dispatch, one thread-block cluster of CL CTAs
// (16, or 8 where the card refuses 16; ffd_cluster_kernel, and
// ffd_ladder_kernel for K6) walks every run (K15 / K17 / K17s run one such
// cluster a lane, K4 one a subset row or one CTA a row). The carry
// (FFDState) lives in global buffers the wrapper allocated; per-run rows
// (req and its exact divisions, Q flags) sit in every CTA's shared memory.
// The claim pass runs one warp of the cluster per OPEN claim, each warp a
// contiguous range of rows (rows >= used have c_pool == -1 and capacity 0,
// so the pour over [0, used) is exact); the pour's prefix runs over the
// same warps' lanes in row order, so a row never leaves its warp, and only
// claims that received pods recompute their type mask. Pools are walked in
// order, each CTA over the whole [T] row (cheap, and it needs no cluster
// barrier). A run costs three cluster barriers (the claims' prefix, a
// claim-opening pool, the run's end), three more where the solve has
// nodes (the nodes' prefix between strided passes); the serial floor is
// runs x barriers x one barrier's cost (~0.75 us on an H100 at 16 CTAs).
//
// The kernel is a template on ZONE, the JAX scan's static zone_engine.
// ZONE=false (a solve without V-axis sigs) is the fast branch alone.
// ZONE=true adds, per run, the `constrained` test (ffd.py:1662): a run whose
// group owns a V-axis sig or is a member of an anti sig goes through the
// domain event engine (zoned_run below, ffd.py:860-1651); every other run
// takes the fast branch and records its V-axis counts (count_contrib
// :587-600) and claim-local matches (c_vm). The engine loops events on the
// same team; each event's [Z] domain vectors and [P] pool rows sit in every
// CTA's shared memory (Z <= 32), the per-claim [M,T] and [M,Z,T] tests run
// one warp of the team per open claim on the fly and keep only [M] and
// [M,Z] results in global scratch, every CTA runs the [P,T] pool pass and
// the water-fill over all its threads, and v_count / v_owner_z / c_vm /
// c_vo stay in global memory. An event costs three cluster barriers (after
// the candidate passes, after the apply, at its end).

constexpr int MAX_Z = 32;         // solver/cuda/ffd.py MAX_Z
constexpr int MAX_P = 64;         // solver/cuda/ffd.py MAX_P

struct ScanArgs {
  const int* run_group; const int* run_count;
  const int* group_req; const unsigned char* group_compat_t; const unsigned* group_zc_bits;
  const unsigned char* group_pool; const unsigned* group_pair_nok; const unsigned char* group_device;
  const int* type_alloc; const int* type_charge; const unsigned* offer_zc_bits;
  const unsigned char* pool_type; const unsigned* pool_zc_bits; const int* pool_daemon;
  const int* pool_limit; const int* node_free; const unsigned char* node_compat;
  const unsigned char* q_member; const unsigned char* q_owner; const int* q_kind; const int* q_cap;
  const unsigned char* v_member; const unsigned char* v_owner; const int* v_kind; const int* v_cap;
  const int* v_primary; const int* v_aff; const int* node_zone; const unsigned* zone_col_mask;
  const int* node_dom2; const int* col_axis; const int* group_daxis;
  int* e_cum; int* c_cum; unsigned char* c_mask; unsigned* c_zc_bits; unsigned* c_gbits;
  int* c_pool; int* used; int* p_usage; int* e_cm; int* e_co; int* c_cm; int* c_co;
  int* v_count; unsigned char* v_owner_z; int* c_vm; unsigned char* c_vo;
  int* take_e; int* take_c; int* leftover; int* events; int* scratch;
  int S, G, T, E, P, R, Q, W, M, V, Z;
  // the batched instances (BATCH=true, K4) only: the carry's shared seeds,
  // the subset rows and this row's [E] removed-node mask
  const int* pool_usage0; const int* node_q_member; const int* node_q_owner;
  const int* v_count0; const int* node_cand; const unsigned char* cand_member;
  int* removed;
  int NC, row_words, take_off;
  // the ladder instances (LADDER=true, K6) only: the rung table, and the
  // run's output rows (take_e / take_c / leftover then point at the
  // current attempt's rows in the scratch)
  const int* run_ladder; int* out_take_e; int* out_take_c; int* out_leftover;
  int* attempts;
  int Lw;
  // the checkpointed instances (CKPT=true, K7) only: the ring, one
  // [n_ckpt, ...] array per FFDState field (FFDState order), and its
  // prefix [n_ckpt]
  unsigned char* ring[16]; int* ring_prefix;
  int ck_every, n_ckpt;
  // the sparse instances (SPARSE=true) only: the run-major index tables
  // [S, Kq] / [S, Kv] of the run's active hostname / zone sigs (-1 pad)
  const int* run_q_idx; const int* run_v_idx;
  int Kq, Kv;
};

// Row offset of run s in the [S, n] take tables. The batched and the ladder
// scans keep only the current run's (attempt's) take rows, in the block's
// scratch: offset 0 (ROW0 = BATCH || LADDER).
template <bool ROW0>
__device__ __forceinline__ size_t take_row(int s, int n) {
  if constexpr (ROW0) return 0; else return (size_t)s * n;
}

// node_compat[g, e]; in the batched scan also "node e is not removed by
// this block's subset"
template <bool BATCH>
__device__ __forceinline__ bool node_compat_at(const ScanArgs& a, int g, int e) {
  if constexpr (BATCH) return a.node_compat[(size_t)g * a.E + e] && !a.removed[e];
  else return a.node_compat[(size_t)g * a.E + e];
}

// One Q-axis row of a run: the group's member / owner flags, the sig's
// kind and cap, the members' total, and under SPARSE the slot's Q column
// (-1 padding). 24 bytes.
struct QRow {
  int mg, og, kq, cq;
  unsigned tot;
  int qcol;
};
static_assert(sizeof(QRow) == 24, "solver/cuda/ffd.py scan_rows_bytes counts 24 bytes a Q row");

// Per-run shared state of the scan. The run's Q rows lie in dynamic shared
// memory sized at launch to the dispatch (q_rows_bytes): max(Q, Kq) of
// them, because a constrained run of a sparse instance reloads the dense
// flags into the first Q. So Q is bounded by the card's opt-in shared
// memory less the instance's static share (the *_rows_budget queries), not
// by a constant. q() addresses the rows from the shared symbol itself, at a
// fixed 24-byte stride, so every access stays a shared-memory load at a
// constant offset from the row.
struct RunShared {
  int req[MAX_R];
  int charge[MAX_R];
  __device__ __forceinline__ QRow* q() const { return reinterpret_cast<QRow*>(scan_rows); }
  unsigned dm[MAX_R];  // the run's exact division by req[r] > 0 (floordiv_magic)
  int ds[MAX_R];
  TeamShared ts;
  int any_owned2, boot2, fresh_allow, remaining, used, cap2, n_new, full_take;
  int has_e_boot, e_first, has_c_boot, c_first;
  int skip;
};

// Shared state of the zoned branch (ZONE=true only): the run's V-axis
// flags and every [Z] / [P] vector and scalar of one event. The V-axis rows
// (mv, ov, vk; vcol in the sparse instances) point into dynamic shared
// memory sized at launch to the dispatch (zone_rows_bytes), after the Q
// rows: max(V, Kv) rows of mv/ov/vk, because a constrained run of a sparse
// instance reloads the dense flags at full width, and Kv slots of vcol. So
// V trades against Q within the card's opt-in shared memory less the
// instance's static share (the *_rows_budget queries).
struct ZoneShared {
  unsigned char* mv;
  unsigned char* ov;
  int* vk;
  int* vcol;  // SPARSE: slot -> V column (-1 padding)
  unsigned zcm[MAX_Z];
  int col_axis[MAX_Z];
  int gax[MAX_Z], elig[MAX_Z], A[MAX_Z], A_base[MAX_Z], blk[MAX_Z], pbc[MAX_Z];
  int cnt_p[MAX_Z], cnt_a[MAX_Z], B[MAX_Z];
  int pos_node[MAX_Z], pos_claim[MAX_Z];
  int first_ez[MAX_Z], first_cz[MAX_Z], tgt_e[MAX_Z], tgt_c[MAX_Z];
  int kmax_z[MAX_Z], charge_zr[MAX_Z][MAX_R];
  int T_zv[MAX_Z], fr_z[MAX_Z], n_z[MAX_Z], base_z[MAX_Z];
  // contrib: this CTA's [Z] count deltas of an event's apply, then its
  // placed pods at [Z]; csum: their sums over the team
  int contrib[MAX_Z + 1], csum[MAX_Z + 1], owner_rec[MAX_Z];
  int kpz[NWARPS][MAX_Z];
  unsigned nbits_p[MAX_P];
  int kmax_p[MAX_P], elig_p[MAX_P], charge_p[MAX_P][MAX_R];
  // per-run constants
  int any_mv, g_ax, has_tsc, psig, cap_p, is_self, has_affs, asig, is_member_a;
  int self_anti, has_owned, has_anti, any_ma, pure_tsc, multi_ok;
  // per-run loop carry
  int remaining, progress, fuel, events;
  // per-event scalars
  int m1, amin, nmin, any_present;
  int e_first, c_first, multi_claim, tgts_bad;
  int found_e, e_star, found_c, m_star, found_p, p_star;
  int nz_fin, z_c, nz_fin_p, z_p, q_e, q_c, q_p, z_e;
  int aff_bulk, cyc_eff, per_tgt, use_e, use_c, use_p;
  int q_tot_p, full_p, n_open_p, mega_pre, mega_ok, n_mega, km0, trips0;
  int charge0[MAX_R];
  unsigned pz_star;
};

// global scratch of the scan (int words), laid out by scan_scratch_words()
struct Scratch {
  int* e_full; int* e_boot; int* c_full; int* c_boot; int* c_take; int* c_pref; int* k_t; int* fit_t;
  // zoned branch
  int* c_km; int* c_host; int* c_flag; int* c_apref;
  unsigned* c_bits; int* k_cap; int* scat_z; int* scat_take; int* caps_mz; int* take_mz;
};

// Q column of the run's view slot q: q itself, or under SPARSE the
// column the slot gathered (-1 padding, whose flags are all false)
template <bool SPARSE>
__device__ __forceinline__ int qcol_of(const RunShared& sh, int q) {
  if constexpr (SPARSE) return sh.q()[q].qcol; else return q;
}

// hostname allowance of one row (Q axis) over the nq slots of the run's
// view; the fast branch's owner is o & (kind != 2) (kind2_owner false), the
// zoned branch's the full o; cm/co == nullptr reads zeros (fresh claims)
template <bool KIND2_OWNER = false, bool SPARSE = false>
__device__ int row_allowance(const RunShared& sh, int nq, const int* cm, const int* co) {
  int best = BIG;
  for (int q = 0; q < nq; ++q) {
    const int kind = sh.q()[q].kq;
    const bool member = sh.q()[q].mg, owner = sh.q()[q].og && (KIND2_OWNER || kind != 2);
    const bool relevant = owner || (kind == 1 && member);
    if (!relevant) continue;
    const int col = qcol_of<SPARSE>(sh, q);
    const int c = cm ? cm[col] : 0, o = co ? co[col] : 0;
    int v;
    if (kind == 0) {
      v = member ? wsub(sh.q()[q].cq, c) : (wadd(c, 1) <= sh.q()[q].cq ? BIG : 0);
    } else if (kind == 2) {
      v = c > 0 ? BIG : 0;
    } else if (owner) {
      v = c == 0 ? (member ? 1 : BIG) : 0;
    } else {
      v = o == 0 ? BIG : 0;
    }
    best = min(best, v);
  }
  return max(best, 0);
}

// kind-2 cap of one row: BIG where matching pods are present (or no owned
// kind-2 sig), else 0
template <bool SPARSE = false>
__device__ int row_pos(const RunShared& sh, int nq, const int* cm) {
  int best = BIG;
  for (int q = 0; q < nq; ++q)
    if (sh.q()[q].og && sh.q()[q].kq == 2) best = min(best, cm[qcol_of<SPARSE>(sh, q)] > 0 ? BIG : 0);
  return best;
}

// pods of the run's request that fit in alloc - cum (R rows; rows the
// request leaves at 0 do not bind), by the run's exact divisions; alloc is
// a read-only input table (type_alloc, node_free), cum may be the carry
__device__ __forceinline__ int fit_rows(const int* alloc, const int* cum, const RunShared& sh, int R) {
  int k = BIG;
  for (int r = 0; r < R; ++r)
    if (sh.req[r] > 0) k = min(k, floordiv_magic(wsub(__ldg(&alloc[r]), cum[r]), sh.dm[r], sh.ds[r]));
  return max(k, 0);
}

__device__ __forceinline__ int ceildiv(int a, int b) { return wneg(floordiv(wneg(a), b)); }

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v = wadd(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// [Z] count deltas of `take` pods landing on a claim with joint bits `bits`:
// one per axis on which the claim's domain is single-valued (count_contrib)
__device__ void claim_contrib(const ZoneShared& zs, int* contrib, int Z, unsigned bits, int take) {
  for (int ax = 0; ax < 2; ++ax) {
    int n = 0, zz = -1;
    for (int z = 0; z < Z; ++z)
      if (zs.col_axis[z] == ax && (bits & zs.zcm[z]) != 0u) { ++n; zz = z; }
    if (n == 1) atomicAdd(&contrib[zz], take);
  }
}

// [Z] count deltas of `take` pods on existing node e: its column on every axis
__device__ void node_contrib(const ScanArgs& a, int* contrib, int e, int take) {
  const int nz = a.node_zone[e], n2 = a.node_dom2[e];
  if (nz >= 0 && nz < a.Z) atomicAdd(&contrib[nz], take);
  if (n2 >= 0 && n2 < a.Z && n2 != nz) atomicAdd(&contrib[n2], take);
}

// ---- the zoned branch of one run: the domain event engine --------------------

__device__ __forceinline__ int node_dom(const ScanArgs& a, const ZoneShared& zs, int e) {
  return zs.g_ax == 0 ? a.node_zone[e] : a.node_dom2[e];
}

// Max consecutive pods into domain zt before a blocked domain with an earlier
// first-fit target re-enters the allowed set (ffd.py:1038-1052).
__device__ int preempt_bound(const ZoneShared& zs, int Z, int zt, int pos_t) {
  if (!(zs.has_tsc && zs.nmin == 1 && zt == zs.amin)) return BIG;
  const int cz = zs.cnt_p[min(max(zt, 0), Z - 1)];
  int val = BIG;
  for (int z = 0; z < Z; ++z) {
    const int pos_z = min(zs.pos_node[z], zs.pos_claim[z]);
    if (zs.pbc[z] && pos_z < pos_t)
      val = min(val, wsub(wsub(wadd(zs.cnt_p[z], 1), zs.cap_p), cz));
  }
  return max(val, 0);
}

// argmin over z of the domain score of a claim / pool whose candidate set is
// `inter` (bit z); non-candidates score BIG; ties go to the lowest z
__device__ int domain_argmin(const ZoneShared& zs, int Z, unsigned inter, int mode) {
  int best = 0, arg = 0;
  for (int z = 0; z < Z; ++z) {
    int sc = BIG;
    if (inter >> z & 1u)
      sc = mode == 0 ? wadd(wmul(zs.cnt_p[z], 64), z)
                     : mode == 1 ? wadd(wmul(wneg(zs.cnt_a[z]), 64), z) : z;
    if (z == 0 || sc < best) { best = sc; arg = z; }
  }
  return arg;
}

// The team's accumulators of an event's candidate passes, folded over the
// CTAs after a cluster barrier: the [Z] first-node / first-claim / first-fit
// positions and the first eligible node and claim (min), the multi-domain
// and bad-target flags (max). Each CTA folds every peer's value into its
// own in place; the folds are idempotent, so a peer reading ours meanwhile
// still finds the extreme in the CTA that holds it.
__device__ void pull_acc(const Team& tm, ZoneShared& zs, int Z) {
  const int K = 4 * Z + 4;
  for (int i = tm.tid; i < tm.n * K; i += Team::NTB) {
    const int r = i / K, j = i - r * K;
    if (r == tm.rank) continue;
    int* v;
    if (j < Z) v = &zs.pos_node[j];
    else if (j < 2 * Z) v = &zs.pos_claim[j - Z];
    else if (j < 3 * Z) v = &zs.first_ez[j - 2 * Z];
    else if (j < 4 * Z) v = &zs.first_cz[j - 3 * Z];
    else if (j == 4 * Z) v = &zs.e_first;
    else if (j == 4 * Z + 1) v = &zs.c_first;
    else if (j == 4 * Z + 2) v = &zs.multi_claim;
    else v = &zs.tgts_bad;
    const int o = *peer(v, r);
    if (j < 4 * Z + 2) atomicMin(v, o); else atomicMax(v, o);
  }
}

// zs.csum[j] = the sum over the team's CTAs of zs.contrib[j], j <= Z
// (int32 wrap); after a barrier that orders every CTA's partials
__device__ void pull_sum(const Team& tm, ZoneShared& zs, int Z) {
  for (int j = tm.tid; j <= Z; j += Team::NTB) {
    unsigned s = 0u;
    for (int r = 0; r < tm.n; ++r) s += (unsigned)*peer(&zs.contrib[j], r);
    zs.csum[j] = (int)s;
  }
}

template <bool BATCH, bool LADDER>
__device__ void zoned_run(const ScanArgs& a, RunShared& sh, ZoneShared& zs, const Scratch& x,
                          Team& tm, int s, int g) {
  constexpr int NTB = Team::NTB, NWB = Team::NWB;
  const int tid = tm.tid, lane = tm.lane, wid = tm.wid;
  const int T = a.T, E = a.E, P = a.P, R = a.R, Q = a.Q, W = a.W, M = a.M, V = a.V, Z = a.Z;
  const unsigned g_zc = a.group_zc_bits[g];
  const unsigned char* compat = a.group_compat_t + (size_t)g * T;
  const unsigned* g_nok = a.group_pair_nok + (size_t)g * W;
  const unsigned gbit = 1u << (g & 31);
  const int gword = g >> 5;

  // ---- per-run setup (ffd.py:860-895) ---------------------------------------
  if (tid < Z) {
    zs.zcm[tid] = a.zone_col_mask[tid];
    zs.col_axis[tid] = a.col_axis[tid];
  }
  for (int e = tm.gtid; e < E; e += tm.gnt) a.take_e[take_row<BATCH || LADDER>(s, E) + e] = 0;
  for (int m = tm.gtid; m < M; m += tm.gnt) x.c_take[m] = 0;
  if (tid == 0) {
    zs.g_ax = a.group_daxis[g];
    const int psg = a.v_primary[g];
    zs.has_tsc = psg >= 0;
    zs.psig = min(max(psg, 0), V - 1);
    zs.cap_p = a.v_cap[zs.psig];
    zs.is_self = zs.mv[zs.psig];
    const int asg = a.v_aff[g];
    zs.has_affs = asg >= 0;
    zs.asig = min(max(asg, 0), V - 1);
    zs.is_member_a = zs.mv[zs.asig];
    int self_anti = 0, has_owned = 0, has_anti = 0, any_ma = 0;
    for (int v = 0; v < V; ++v) {
      const bool blk = zs.ov[v] && (zs.vk[v] == 1 || zs.vk[v] == 3);
      if (blk && zs.mv[v]) self_anti = 1;
      if (zs.ov[v]) has_owned = 1;
      if (blk) has_anti = 1;
      if (zs.mv[v] && zs.vk[v] == 1) any_ma = 1;
    }
    zs.self_anti = self_anti;
    zs.has_owned = has_owned;
    zs.has_anti = has_anti;
    zs.any_ma = any_ma;
    zs.pure_tsc = zs.has_tsc && !self_anti && !zs.has_affs && !any_ma && !has_anti;
    zs.multi_ok = !zs.has_tsc && !self_anti;
    zs.remaining = sh.remaining;
    zs.fuel = wadd(sh.remaining, 8);
    zs.progress = 1;
    zs.events = 0;
  }
  __syncthreads();
  if (tid < Z) {
    zs.gax[tid] = zs.col_axis[tid] == zs.g_ax;
    zs.elig[tid] = zs.gax[tid] && (g_zc & zs.zcm[tid]) != 0u;
  }
  __syncthreads();

  while (zs.remaining > 0 && zs.progress && zs.fuel > 0) {
    const int used0 = sh.used;
    const int remaining = zs.remaining;
    // ---- allowed domains A and per-domain budgets B (ffd.py:901-932) ------
    if (tid < Z) {
      const int z = tid;
      zs.cnt_p[z] = a.v_count[zs.psig * Z + z];
      zs.cnt_a[z] = a.v_count[zs.asig * Z + z];
      zs.blk[z] = 0;  // below, over every (sig, domain) pair
      zs.pos_node[z] = BIG;
      zs.pos_claim[z] = BIG;
      zs.first_ez[z] = I32MAX;
      zs.first_cz[z] = I32MAX;
      zs.contrib[z] = 0;
      zs.kmax_z[z] = 0;
    }
    for (int i = tid; i < Z * MAX_R; i += NTB) zs.charge_zr[i / MAX_R][i % MAX_R] = I32MAX;
    for (int i = tid; i < P * MAX_R; i += NTB) zs.charge_p[i / MAX_R][i % MAX_R] = I32MAX;
    if (tid == 0) {
      zs.multi_claim = 0;
      zs.tgts_bad = 0;
      zs.c_first = I32MAX;
      zs.e_first = I32MAX;
      zs.contrib[Z] = 0;
    }
    __syncthreads();
    // a domain is blocked by an owned anti sig with pods in it, or by a
    // matched anti sig's registered owner there
    for (int i = tid; i < V * Z; i += NTB) {
      const int v = i / Z;
      if ((zs.ov[v] && (zs.vk[v] == 1 || zs.vk[v] == 3) && a.v_count[i] > 0) ||
          (zs.mv[v] && zs.vk[v] == 1 && a.v_owner_z[i]))
        atomicOr(&zs.blk[i - v * Z], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int m1 = I32MAX, amin = 0, nmin = 0, second = BIG;
      for (int z = 0; z < Z; ++z) {
        const int c = zs.elig[z] ? zs.cnt_p[z] : BIG;
        if (z == 0 || c < m1) { m1 = c; amin = z; }
      }
      for (int z = 0; z < Z; ++z) {
        const int c = zs.elig[z] ? zs.cnt_p[z] : BIG;
        if (c == m1) ++nmin;
        if (z != amin) second = min(second, c);
      }
      int any_present = 0;
      for (int z = 0; z < Z; ++z) any_present |= zs.cnt_a[z] > 0;
      for (int z = 0; z < Z; ++z) {
        const int c = zs.cnt_p[z];
        const int m2 = (nmin == 1 && z == amin) ? second : m1;
        int A = zs.elig[z], B = BIG;
        if (zs.has_tsc) {
          A = zs.elig[z] && wsub(wadd(c, 1), m1) <= zs.cap_p;
          B = min(max(wsub(wadd(m2, zs.cap_p), c), 0), BIG);
        }
        A = A && !zs.blk[z];
        if (zs.self_anti) B = min(B, 1);
        zs.A_base[z] = A;
        if (zs.has_affs) A = any_present ? (A && zs.cnt_a[z] > 0) : (zs.is_member_a ? A : 0);
        if (zs.has_affs && !any_present) B = min(B, 1);
        zs.A[z] = A;
        zs.B[z] = B;
        zs.pbc[z] = zs.elig[z] && !A && !zs.blk[z] && wsub(wadd(c, 1), zs.cap_p) <= second;
      }
      zs.m1 = m1;
      zs.amin = amin;
      zs.nmin = nmin;
      zs.any_present = any_present;
    }
    __syncthreads();

    // ---- existing-node candidate (ffd.py:934-944), over the team's threads ----
    int my_first = I32MAX;
    for (int e = tm.gtid; e < E; e += tm.gnt) {
      const int fit = fit_rows(a.node_free + e * R, a.e_cum + e * R, sh, R);
      const int host = row_allowance<true>(sh, Q, a.e_cm + e * Q, a.e_co + e * Q);
      const int nd = node_dom(a, zs, e);
      const bool base = node_compat_at<BATCH>(a, g, e) && fit > 0 && host > 0;
      const bool nz_ok = nd >= 0 ? zs.A[min(nd, Z - 1)] != 0 : !zs.has_owned;
      const bool el = base && nz_ok;
      x.e_full[e] = fit;
      x.e_boot[e] = host;
      if (el) {
        my_first = min(my_first, e);
        if (nd >= 0 && nd < Z) atomicMin(&zs.first_ez[nd], e);
      }
      if (base) {
        const int nz = a.node_zone[e], n2 = a.node_dom2[e];
        if (nz >= 0 && nz < Z) atomicMin(&zs.pos_node[nz], e);
        if (n2 >= 0 && n2 < Z) atomicMin(&zs.pos_node[n2], e);
      }
    }
    my_first = warp_min(my_first);
    if (lane == 0 && my_first != I32MAX) atomicMin(&zs.e_first, my_first);

    // ---- open-claim candidates (ffd.py:946-1011), a warp per claim, the
    // rows spread over the CTAs, ws warps a row where a CTA holds fewer rows
    // than warps (as the fast branch's claim pass) -------------------------
    int wlo, whi, clo, chi;
    warp_chunk(tm, used0, wlo, whi);
    cta_chunk(tm, used0, clo, chi);
    const int ws = row_warps<NWB>(chi - clo);
    // a claim row's tests, the same in every warp that walks it
    struct ZRow {
      unsigned czb, bits_eff;
      int node_ok, host, zcount;
      bool claim_ok;
    };
    // the row's tests, then its walk of the lane's types t0, t0 + step, ...
    // (the warp's per-domain maxima in kpz[wid]); returns the warp's k_m
    auto zrow = [&](int m, int t0, int step, ZRow& r) {
      bool loc = false, ok = true;
      for (int v = lane; v < V; v += 32) {
        const int cvm = a.c_vm[m * V + v];
        if (v == zs.asig) loc = cvm > 0;
        if (zs.ov[v] && (zs.vk[v] == 1 || zs.vk[v] == 3) && cvm != 0) ok = false;
        if (zs.mv[v] && zs.vk[v] == 1 && a.c_vo[m * V + v]) ok = false;
      }
      const bool local_aff = zs.has_affs && __any_sync(FULL, loc);
      const bool anti_ok = __all_sync(FULL, ok);
      bool clash = false;
      for (int w = lane; w < W; w += 32) clash |= (a.c_gbits[(size_t)m * W + w] & g_nok[w]) != 0u;
      const bool pair_ok = !__any_sync(FULL, clash);
      const int pool = a.c_pool[m];
      const bool is_open = pool >= 0;
      const bool pool_ok = is_open && a.group_pool[g * P + min(max(pool, 0), P - 1)];
      const unsigned czb = a.c_zc_bits[m];
      unsigned bits_eff = 0u;
      int node_ok = 0, host = 0, zcount = 0;
      if (lane == 0) {
        unsigned inter = 0u, az = 0u;
        for (int z = 0; z < Z; ++z) {
          const bool cz = (czb & zs.zcm[z]) != 0u;
          if (cz && zs.gax[z]) ++zcount;
          if (cz && (local_aff ? zs.A_base[z] : zs.A[z])) { inter |= 1u << z; az |= zs.zcm[z]; }
        }
        const bool aff_mode = zs.has_affs && zs.any_present && !local_aff;
        const bool commit = zs.has_tsc || aff_mode || zs.has_anti;
        const int dz = domain_argmin(zs, Z, inter, zs.has_tsc ? 0 : aff_mode ? 1 : 2);
        bits_eff = (commit ? zs.zcm[dz] : az) & czb & g_zc;
        node_ok = is_open && pair_ok && pool_ok && inter != 0u && bits_eff != 0u && anti_ok;
        host = row_allowance<true>(sh, Q, a.c_cm + m * Q, a.c_co + m * Q);
      }
      bits_eff = __shfl_sync(FULL, bits_eff, 0);
      node_ok = __shfl_sync(FULL, node_ok, 0);
      host = __shfl_sync(FULL, host, 0);
      zcount = __shfl_sync(FULL, zcount, 0);
      __syncwarp();  // the previous claim's kpz reads are done
      if (lane < Z) zs.kpz[wid][lane] = 0;
      __syncwarp();
      const int* cum = a.c_cum + m * R;
      const unsigned char* mask = a.c_mask + (size_t)m * T;
      int kbest = 0;
      // every lane walks as many rows (the warp reductions below), each
      // row's loads issued before its tests
      for (int t1 = t0 - lane; t1 < T; t1 += step) {
        const int t = t1 + lane;
        const int tt = t < T ? t : 0;
        const bool ok = (t < T) & (mask[tt] != 0) & (__ldg(&compat[tt]) != 0);
        const unsigned off = __ldg(&a.offer_zc_bits[tt]);
        const int k = fit_rows(a.type_alloc + tt * R, cum, sh, R);
        if (ok && node_ok && (bits_eff & off) != 0u) kbest = max(kbest, k);
        const unsigned zt = (ok && k >= 1) ? (czb & g_zc & off) : 0u;
        if (__any_sync(FULL, zt != 0u))
          for (int z = 0; z < Z; ++z) {
            const int kz = __reduce_max_sync(FULL, (zt & zs.zcm[z]) != 0u ? k : 0);
            if (lane == 0 && kz > zs.kpz[wid][z]) zs.kpz[wid][z] = kz;
          }
      }
      r = ZRow{czb, bits_eff, node_ok, host, zcount, is_open && pair_ok && pool_ok && host > 0 && anti_ok};
      return warp_max(kbest);
    };
    // the row's results from its k_m and, in lane z < Z, its domain z's max
    auto zrow_finish = [&](int m, const ZRow& r, int k_m, int kp) {
      bool emz = false;
      if (lane < Z) {
        emz = r.claim_ok && kp > 0;
        x.caps_mz[(size_t)m * Z + lane] = (emz && zs.elig[lane]) ? min(kp, r.host) : 0;
        if (emz) atomicMin(&zs.pos_claim[lane], E + m);
      }
      const unsigned mz = __ballot_sync(FULL, emz);
      if (lane == 0) {
        const bool elig_m = k_m > 0 && r.host > 0;
        x.c_bits[m] = r.bits_eff;
        x.c_km[m] = k_m;
        x.c_host[m] = r.host;
        x.c_flag[m] = (elig_m ? 1 : 0) | (r.node_ok ? 2 : 0);
        unsigned eligmask = 0u;
        for (int z = 0; z < Z; ++z) eligmask |= zs.elig[z] ? 1u << z : 0u;
        if ((mz & eligmask) != 0u && r.zcount > 1) zs.tgts_bad = 1;
        if (elig_m) {
          atomicMin(&zs.c_first, m);
          if (r.zcount > 1) zs.multi_claim = 1;
          if (r.zcount == 1)
            for (int z = 0; z < Z; ++z)
              if ((r.czb & zs.zcm[z]) != 0u) atomicMin(&zs.first_cz[z], m);
        }
      }
    };
    if (ws == 1) {
      for (int m = wlo; m < whi; ++m) {
        ZRow r;
        const int k_m = zrow(m, lane, 32, r);
        __syncwarp();
        zrow_finish(m, r, k_m, lane < Z ? zs.kpz[wid][lane] : 0);
      }
    } else {
      // warp i * ws + j walks slice j of the CTA's row i; slice 0 finishes it
      // (k_m through the team's reduction slots, which the next reduction
      // writes only after a barrier)
      const int i = wid / ws;
      ZRow r;
      if (i < chi - clo) {
        const int k = zrow(clo + i, (wid % ws) * 32 + lane, 32 * ws, r);
        if (lane == 0) sh.ts.red[wid] = k;
      }
      __syncthreads();
      if (i < chi - clo && wid % ws == 0) {
        int k_m = 0, kp = 0;
        for (int j = 0; j < ws; ++j) {
          k_m = max(k_m, sh.ts.red[wid + j]);
          if (lane < Z) kp = max(kp, zs.kpz[wid + j][lane]);
        }
        zrow_finish(clo + i, r, k_m, kp);
      }
    }

    // ---- per-pool new-claim candidates (ffd.py:1076-1135): every CTA walks
    // every pool's [T] row with all its threads (P <= MAX_P) ------------------
    if (tid < P) {
      const int p = tid;
      const unsigned pzb = a.pool_zc_bits[p] & g_zc;
      unsigned inter = 0u, az = 0u;
      for (int z = 0; z < Z; ++z)
        if ((pzb & zs.zcm[z]) != 0u && zs.A[z]) { inter |= 1u << z; az |= zs.zcm[z]; }
      const bool aff = zs.has_affs && zs.any_present;
      const bool commit = zs.has_tsc || aff || zs.has_anti;
      const int dz = domain_argmin(zs, Z, inter, zs.has_tsc ? 0 : aff ? 1 : 2);
      zs.nbits_p[p] = (commit ? zs.zcm[dz] : az) & pzb;
      zs.elig_p[p] = inter != 0u;  // finished below
      zs.kmax_p[p] = 0;
    }
    __syncthreads();
    for (int p = 0; p < P; ++p) {
      // A pool that no allowed domain or the group's pool set admits is
      // skipped (a relax walk's base attempts meet only such pools): it
      // cannot be elig_p, and an ineligible pool's kmax_p and charge_p are
      // read only through p_star when found_p is false, where nothing reads
      // the values they feed (q_p, full_p, n_open_p, the water-fill's
      // preconditions need found_p).
      if (!(zs.elig_p[p] && a.group_pool[g * P + p])) continue;
      const unsigned nbits = zs.nbits_p[p];
      const int* daemon = a.pool_daemon + p * R;
      int kmax = 0;
      int cmin[MAX_R];
      for (int r = 0; r < R; ++r) cmin[r] = I32MAX;
      for (int t = tid; t < T; t += NTB) {
        const bool fit = __ldg(&compat[t]) && __ldg(&a.pool_type[(size_t)p * T + t]) &&
                         (nbits & __ldg(&a.offer_zc_bits[t])) != 0u;
        if (!fit) continue;
        const int k = fit_rows(a.type_alloc + t * R, daemon, sh, R);
        kmax = max(kmax, k);
        if (k >= 1)
          for (int r = 0; r < R; ++r) cmin[r] = min(cmin[r], __ldg(&a.type_charge[t * R + r]));
      }
      for (int r = 0; r < R; ++r) {
        const int c = __reduce_min_sync(FULL, cmin[r]);
        if (lane == 0 && c != I32MAX) atomicMin(&zs.charge_p[p][r], c);
      }
      kmax = warp_max(kmax);
      if (lane == 0 && kmax > 0) atomicMax(&zs.kmax_p[p], kmax);
    }
    __syncthreads();
    if (tid < P) {
      const int p = tid;
      bool over = false;
      for (int r = 0; r < R; ++r) {
        if (zs.charge_p[p][r] == I32MAX) zs.charge_p[p][r] = 0;
        if (a.p_usage[p * R + r] >= a.pool_limit[p * R + r]) over = true;
      }
      zs.elig_p[p] = a.group_pool[g * P + p] && zs.elig_p[p] && zs.kmax_p[p] > 0 && !over &&
                     used0 < M && sh.fresh_allow > 0;
    }
    // every CTA's candidate passes and scratch rows are written: fold the
    // team's accumulators
    cluster_barrier();
    pull_acc(tm, zs, Z);
    __syncthreads();

    // ---- candidates, budgets and the preemption bound (ffd.py:1012-1149) ------
    if (tid == 0) {
      zs.found_e = zs.e_first != I32MAX;
      zs.e_star = zs.found_e ? zs.e_first : 0;
      zs.z_e = node_dom(a, zs, zs.e_star);
      zs.found_c = zs.c_first != I32MAX;
      zs.m_star = zs.found_c ? zs.c_first : 0;
      int nz_fin = 0, z_c = 0;
      if (zs.found_c) {
        const unsigned b = x.c_bits[zs.m_star];
        for (int z = Z - 1; z >= 0; --z)
          if ((b & zs.zcm[z]) != 0u && zs.gax[z]) { ++nz_fin; z_c = z; }
      }
      zs.nz_fin = nz_fin;
      zs.z_c = z_c;
      const int z_e = zs.z_e;
      const int bz_e = z_e >= 0
          ? min(zs.B[min(z_e, Z - 1)], preempt_bound(zs, Z, z_e, zs.e_star)) : BIG;
      zs.q_e = min(min(remaining, x.e_full[zs.e_star]), min(x.e_boot[zs.e_star], bz_e));
      const int bz_c = nz_fin == 1 ? min(zs.B[z_c], preempt_bound(zs, Z, z_c, E + zs.m_star)) : BIG;
      int q_c = min(min(remaining, zs.found_c ? x.c_km[zs.m_star] : 0),
                    min(zs.found_c ? x.c_host[zs.m_star] : 0, bz_c));
      if (zs.self_anti) q_c = min(q_c, 1);
      zs.q_c = q_c;
      int p_star = -1;
      for (int p = 0; p < P && p_star < 0; ++p)
        if (zs.elig_p[p]) p_star = p;
      zs.found_p = p_star >= 0;
      p_star = max(p_star, 0);
      zs.p_star = p_star;
      int nz_fin_p = 0, z_p = 0;
      for (int z = Z - 1; z >= 0; --z)
        if ((zs.nbits_p[p_star] & zs.zcm[z]) != 0u && zs.gax[z]) { ++nz_fin_p; z_p = z; }
      zs.nz_fin_p = nz_fin_p;
      zs.z_p = z_p;
      const int bz_p = nz_fin_p == 1 ? min(zs.B[z_p], preempt_bound(zs, Z, z_p, E + used0)) : BIG;
      int q_p = min(min(remaining, min(zs.kmax_p[p_star], sh.fresh_allow)), bz_p);
      if (zs.self_anti) q_p = min(q_p, 1);
      zs.q_p = q_p;
      zs.full_p = min(zs.kmax_p[p_star], sh.fresh_allow);
      // (A) multi-claim opening: the whole budgeted pour opens its claims
      // in one event when the commit domain cannot rotate
      zs.q_tot_p = bz_p;  // finished below once the affinity drains are known
    }
    __syncthreads();

    // ---- (C) fixed-zone affinity bulk drain (ffd.py:1151-1188) ----------------
    {
      // the drain's other preconditions are known: walk the claims only
      // where it can fire (a uniform test)
      const bool aff_pre = zs.has_affs && !zs.has_tsc && !zs.self_anti && !zs.has_anti &&
                           !zs.any_ma && !zs.found_e && zs.found_c && zs.found_p;
      bool aff_bulk = false;
      int drained = 0;
      if (aff_pre) {
        const unsigned not_zp = ~zs.zcm[zs.z_p];
        int lo, hi;
        lane_chunk(wlo, whi, lane, lo, hi);
        int comm = 1, fre = 1;
        for (int m = lo; m < hi; ++m) {
          const bool elig_m = x.c_flag[m] & 1;
          const int caps = elig_m ? min(x.c_km[m], x.c_host[m]) : 0;
          x.c_full[m] = caps;
          if (elig_m) {
            const unsigned b = x.c_bits[m];
            if ((b & not_zp) != 0u) comm = 0;
            int ze = 0;
            for (int z = 0; z < Z; ++z) ze += ((b & zs.zcm[z]) != 0u && zs.gax[z]) ? 1 : 0;
            if (!(ze > 1)) fre = 0;
          }
        }
        const int all_comm = team_reduce<OP_MIN>(tm, comm, sh.ts);
        const int all_free = team_reduce<OP_MIN>(tm, fre, sh.ts);
        team_scan(tm, x.c_full, x.c_apref, lo, hi, sh.ts);
        aff_bulk = (zs.any_present && zs.nz_fin_p == 1 && all_comm) ||
                   (!zs.any_present && zs.is_member_a && all_free && zs.nz_fin_p > 1);
        if (aff_bulk) {
          int d = 0;
          for (int m = lo; m < hi; ++m)
            d = wadd(d, min(max(wsub(remaining, x.c_apref[m]), 0), x.c_full[m]));
          drained = team_reduce<OP_SUM>(tm, d, sh.ts);
        }
      }
      if (tid == 0) {
        zs.aff_bulk = aff_bulk;
        const int rem_p = wsub(remaining, drained);
        const int q_tot_p = zs.multi_ok ? min(rem_p, zs.q_tot_p) : zs.q_p;
        const int p = zs.p_star;
        int trips = BIG;
        for (int r = 0; r < R; ++r) {
          const int c = zs.charge_p[p][r];
          const int head = wsub(a.pool_limit[p * R + r], a.p_usage[p * R + r]);
          trips = min(trips, c > 0 ? max(ceildiv(head, max(c, 1)), 0) : BIG);
        }
        const int n_want = zs.full_p > 0 ? ceildiv(q_tot_p, max(zs.full_p, 1)) : 0;
        zs.q_tot_p = q_tot_p;
        zs.n_open_p = zs.multi_ok ? min(min(n_want, trips), M - used0) : 1;

        // ---- balanced-phase cycle batching (ffd.py:1189-1245) ------------------
        int mx = -BIG, n_zones = 0;
        for (int z = 0; z < Z; ++z)
          if (zs.elig[z]) { mx = max(mx, zs.cnt_p[z]); ++n_zones; }
        bool cyc = zs.pure_tsc && zs.is_self && mx == zs.m1 && !zs.multi_claim &&
                   (zs.found_e || zs.found_c);
        const int k_sk = max(zs.cap_p, 1);
        int cap_min = BIG;
        for (int z = 0; z < Z; ++z) {
          zs.tgt_e[z] = -1;
          zs.tgt_c[z] = -1;
          if (!zs.elig[z]) continue;
          const bool fe = zs.first_ez[z] != I32MAX, fc = zs.first_cz[z] != I32MAX;
          if (!fe && !fc) { cyc = false; continue; }
          const int cap = fe ? min(x.e_full[zs.first_ez[z]], x.e_boot[zs.first_ez[z]])
                             : min(x.c_km[zs.first_cz[z]], x.c_host[zs.first_cz[z]]);
          cap_min = min(cap_min, cap);
          if (fe) zs.tgt_e[z] = zs.first_ez[z]; else zs.tgt_c[z] = zs.first_cz[z];
        }
        const int rounds = min(floordiv(cap_min, k_sk), floordiv(remaining, max(wmul(k_sk, n_zones), 1)));
        zs.cyc_eff = cyc && rounds >= 1 && n_zones >= 1;  // masked by mega below
        zs.per_tgt = wmul(k_sk, rounds);

        // water-fill mega preconditions (ffd.py:1341-1379)
        bool no_node = true;
        for (int z = 0; z < Z; ++z) no_node = no_node && (!zs.elig[z] || zs.pos_node[z] >= BIG);
        zs.mega_pre = zs.pure_tsc && zs.is_self && no_node && !zs.tgts_bad && zs.found_p &&
                      zs.cap_p == 1;
        zs.mega_ok = 0;
        zs.n_mega = 0;
        zs.pz_star = a.pool_zc_bits[zs.p_star] & g_zc;
      }
      __syncthreads();
    }

    // ---- (B) closed-form water-fill batching (ffd.py:1275-1431) ----------------
    if (zs.mega_pre) {
      const int p = zs.p_star;
      const unsigned pz = zs.pz_star;
      // every CTA the whole [T] row (k_cap is the CTA's own)
      // (a warp's rows reduced first: one shared atomic a warp a domain)
      for (int t0 = 0; t0 < T; t0 += NTB) {
        const int t = t0 + tid;
        const int tt = t < T ? t : 0;
        const int kc = fit_rows(a.type_alloc + tt * R, a.pool_daemon + p * R, sh, R);
        if (t < T) x.k_cap[t] = kc;
        const bool row = (t < T) & (__ldg(&compat[tt]) != 0) & (__ldg(&a.pool_type[(size_t)p * T + tt]) != 0);
        const unsigned off = row ? pz & __ldg(&a.offer_zc_bits[tt]) : 0u;
        if (!__any_sync(FULL, off != 0u)) continue;
        for (int z = 0; z < Z; ++z) {
          const bool in = (off & zs.zcm[z]) != 0u;
          const int km = __reduce_max_sync(FULL, in ? kc : 0);
          if (lane == 0 && km > 0) atomicMax(&zs.kmax_z[z], km);
          if (__any_sync(FULL, in && kc >= 1))
            for (int r = 0; r < R; ++r) {
              const int c = __reduce_min_sync(FULL, (in && kc >= 1) ? __ldg(&a.type_charge[tt * R + r]) : I32MAX);
              if (lane == 0 && c != I32MAX) atomicMin(&zs.charge_zr[z][r], c);
            }
        }
      }
      __syncthreads();
      if (tid == 0) {
        int z_first = 0;
        for (int z = Z - 1; z >= 0; --z) if (zs.elig[z]) z_first = z;
        const int kmax0 = zs.kmax_z[z_first];
        bool kmax_eq = true, charge_eq = true, covers = true;
        for (int z = 0; z < Z; ++z)
          for (int r = 0; r < R; ++r)
            if (zs.charge_zr[z][r] == I32MAX) zs.charge_zr[z][r] = 0;
        for (int z = 0; z < Z; ++z) {
          if (!zs.elig[z]) continue;
          kmax_eq = kmax_eq && zs.kmax_z[z] == kmax0;
          for (int r = 0; r < R; ++r) charge_eq = charge_eq && zs.charge_zr[z][r] == zs.charge_zr[z_first][r];
          covers = covers && (zs.pz_star & zs.zcm[z]) != 0u;
        }
        int trips0 = BIG;
        for (int r = 0; r < R; ++r) {
          const int c = zs.charge_zr[z_first][r];
          zs.charge0[r] = c;
          const int head = wsub(a.pool_limit[p * R + r], a.p_usage[p * R + r]);
          trips0 = min(trips0, c > 0 ? max(ceildiv(head, max(c, 1)), 0) : BIG);
        }
        // water-fill: theta = max level with sum(max(0, theta - c)) <=
        // remaining over the sorted counts; the remainder goes one pod each
        // to the lex-first domains at the water line
        int cs[MAX_Z];
        int nz_e = 0;
        for (int z = 0; z < Z; ++z) {
          int c = zs.elig[z] ? zs.cnt_p[z] : BIG;
          nz_e += zs.elig[z] ? 1 : 0;
          int i = z;
          while (i > 0 && cs[i - 1] > c) { cs[i] = cs[i - 1]; --i; }
          cs[i] = c;
        }
        int theta = -BIG, pref = 0;
        for (int k = 1; k <= Z; ++k) {
          pref = wadd(pref, cs[k - 1] < BIG ? cs[k - 1] : 0);
          const int th = floordiv(wadd(remaining, pref), k);
          const int nxt = k < Z ? cs[k] : BIG;
          if (k <= nz_e && th >= cs[k - 1] && th <= nxt) theta = max(theta, th);
        }
        int sfill = 0;
        for (int z = 0; z < Z; ++z)
          if (zs.elig[z]) sfill = wadd(sfill, min(max(wsub(theta, zs.cnt_p[z]), 0), BIG));
        const int r_rem = wsub(remaining, sfill);
        int lexr = -1, tsum = 0;
        for (int z = 0; z < Z; ++z) {
          int tz = 0;
          if (zs.elig[z]) {
            tz = min(max(wsub(theta, zs.cnt_p[z]), 0), BIG);
            if (zs.cnt_p[z] <= theta) { ++lexr; if (lexr < r_rem) ++tz; }
          }
          zs.T_zv[z] = tz;
          tsum = wadd(tsum, tz);
        }
        zs.km0 = max(kmax0, 1);
        zs.mega_ok = kmax0 > 0 && kmax_eq && charge_eq && covers && sh.fresh_allow >= kmax0 &&
                     remaining > 0 && tsum == remaining;
        zs.trips0 = trips0;
      }
      __syncthreads();
      // per-domain prefix drains of every eligible single-domain claim in
      // slot order, then the fresh claims each domain still needs: every
      // CTA walks every claim (a scan over its threads, one domain at a
      // time) and keeps the drains of the claims its warps apply
      {
        const int per = (used0 + NTB - 1) / NTB;
        const int lo = min(tid * per, used0), hi = min(lo + per, used0);
        for (int z = 0; z < Z; ++z) {
          long long sz = 0;
          for (int m = lo; m < hi; ++m) sz += x.caps_mz[(size_t)m * Z + z];
          long long tot;
          unsigned pref = (unsigned)(unsigned long long)cta_prefix<NWB>(sz, lane, wid, sh.ts.red64, tot);
          int tm_z = 0;
          for (int m = lo; m < hi; ++m) {
            const int caps = x.caps_mz[(size_t)m * Z + z];
            const int take = min(max(wsub(zs.T_zv[z], (int)pref), 0), caps);
            if (m >= clo && m < chi) x.take_mz[(size_t)m * Z + z] = take;
            pref += (unsigned)caps;
            tm_z = wadd(tm_z, take);
          }
          tm_z = cta_reduce<OP_SUM, NWB>(tm_z, lane, wid, sh.ts.red);
          if (tid == 0) {
            const int fr = wsub(zs.T_zv[z], tm_z);
            zs.fr_z[z] = fr;
            zs.n_z[z] = ceildiv(fr, zs.km0);
            zs.base_z[z] = zs.elig[z] ? wadd(zs.cnt_p[z], tm_z) : BIG;
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        int n_mega = 0;
        for (int z = 0; z < Z; ++z) n_mega = wadd(n_mega, zs.n_z[z]);
        zs.mega_ok = zs.mega_ok && n_mega <= M - used0 && zs.trips0 >= n_mega;
        zs.n_mega = zs.mega_ok ? n_mega : 0;
      }
      __syncthreads();
      if (zs.mega_ok) {
        // fresh-claim slot order: rank (z, g) by (count at open, lex z); every
        // CTA the whole order (scat_z / scat_take are the CTA's own)
        const int km0 = zs.km0, n_mega = zs.n_mega;
        for (int j = tid; j < M; j += NTB) { x.scat_z[j] = 0; x.scat_take[j] = 0; }
        __syncthreads();
        for (int i = tid; i < n_mega; i += NTB) {
          int z = 0, off = i;
          while (off >= zs.n_z[z]) { off -= zs.n_z[z]; ++z; }
          const int gg = off;
          const int K = wadd(zs.base_z[z], wmul(gg, km0));
          int rank = 0;
          for (int z2 = 0; z2 < Z; ++z2) {
            const int diff = wsub(K, zs.base_z[z2]);
            rank += min(max(ceildiv(diff, km0), 0), zs.n_z[z2]);
            if (diff >= 0 && diff % km0 == 0 && floordiv(diff, km0) < zs.n_z[z2] && z2 < z) ++rank;
          }
          if (rank < M) {
            x.scat_z[rank] = z;
            x.scat_take[rank] = min(max(wsub(zs.fr_z[z], wmul(gg, km0)), 0), km0);
          }
        }
      }
    }
    __syncthreads();

    // ---- selection & unified masked apply (ffd.py:1432-1628) --------------------
    if (tid == 0) {
      const bool mega = zs.mega_ok;
      const bool cyc = zs.cyc_eff && !mega;
      zs.cyc_eff = cyc;
      zs.use_e = zs.found_e && !cyc && !mega;
      zs.use_c = !zs.found_e && zs.found_c && !cyc && !mega && !zs.aff_bulk;
      zs.use_p = !zs.found_e && (!zs.found_c || zs.aff_bulk) && zs.found_p && !cyc && !mega;
      for (int z = 0; z < Z; ++z) zs.owner_rec[z] = 0;
      if (zs.use_e && zs.z_e >= 0) zs.owner_rec[min(zs.z_e, Z - 1)] = 1;
      if (zs.use_c && zs.nz_fin == 1) zs.owner_rec[zs.z_c] = 1;
      if (zs.use_p && zs.nz_fin_p == 1) zs.owner_rec[zs.z_p] = 1;
    }
    __syncthreads();
    int placed = 0;
    // existing nodes
    for (int e = tm.gtid; e < E; e += tm.gnt) {
      int add = (zs.use_e && e == zs.e_star) ? zs.q_e : 0;
      if (zs.cyc_eff) {
        const int nd = node_dom(a, zs, e);
        if (nd >= 0 && nd < Z && zs.tgt_e[nd] == e) add = wadd(add, zs.per_tgt);
      }
      if (add == 0) continue;
      for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = wadd(a.e_cum[e * R + r], wmul(add, sh.req[r]));
      for (int q = 0; q < Q; ++q) {
        if (sh.q()[q].mg) a.e_cm[e * Q + q] = wadd(a.e_cm[e * Q + q], add);
        if (add > 0 && sh.q()[q].og && sh.q()[q].kq == 1) a.e_co[e * Q + q] = wadd(a.e_co[e * Q + q], 1);
      }
      a.take_e[take_row<BATCH || LADDER>(s, E) + e] =
          wadd(a.take_e[take_row<BATCH || LADDER>(s, E) + e], add);
      node_contrib(a, zs.contrib, e, add);
      placed = wadd(placed, add);
    }
    // open claims: pours, balanced-cycle targets, affinity-bulk and
    // water-fill drains, a warp per claim (the claims it tested)
    for (int m = wlo; m < whi; ++m) {
      int add = 0, drain = 0;
      if (lane == 0) {
        if (zs.use_c && m == zs.m_star) add = zs.q_c;
        if (zs.cyc_eff)
          for (int z = 0; z < Z; ++z)
            if (zs.tgt_c[z] == m) add = wadd(add, zs.per_tgt);
        if (zs.aff_bulk)
          add = wadd(add, min(max(wsub(remaining, x.c_apref[m]), 0), x.c_full[m]));
        if (zs.mega_ok)
          for (int z = 0; z < Z; ++z) drain = wadd(drain, x.take_mz[(size_t)m * Z + z]);
      }
      add = __shfl_sync(FULL, add, 0);
      drain = __shfl_sync(FULL, drain, 0);
      if (add == 0 && drain == 0) continue;
      const unsigned bits_eff = x.c_bits[m];
      const bool node_ok = x.c_flag[m] & 2;
      const unsigned czb = a.c_zc_bits[m];
      const unsigned cz_after = add > 0 ? bits_eff : czb;
      const int* cum = a.c_cum + m * R;
      unsigned char* mask = a.c_mask + (size_t)m * T;
#pragma unroll 4
      for (int t = lane; t < T; t += 32) {
        const bool mk0 = mask[t] != 0, cp = __ldg(&compat[t]) != 0;
        const unsigned off = __ldg(&a.offer_zc_bits[t]);
        const int k = fit_rows(a.type_alloc + t * R, cum, sh, R);
        bool mk = mk0;
        if (add > 0) mk = mk && cp && (bits_eff & off) != 0u && (node_ok ? k : 0) >= add;
        if (drain > 0) mk = mk && cp && (cz_after & off) != 0u && k >= drain;
        mask[t] = mk;
      }
      __syncwarp();
      // the row's counters, a lane a column (the Q and V rows are dense here)
      const int tot = wadd(add, drain);
      const int nco = (add > 0 ? 1 : 0) + (drain > 0 ? 1 : 0);
      for (int r = lane; r < R; r += 32) a.c_cum[m * R + r] = wadd(a.c_cum[m * R + r], wmul(tot, sh.req[r]));
      for (int q = lane; q < Q; q += 32) {
        if (sh.q()[q].mg) a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], tot);
        if (sh.q()[q].og && sh.q()[q].kq == 1) a.c_co[m * Q + q] = wadd(a.c_co[m * Q + q], nco);
      }
      for (int v = lane; v < V; v += 32) {
        if (zs.mv[v]) a.c_vm[m * V + v] = wadd(a.c_vm[m * V + v], tot);
        if (add > 0 && zs.ov[v] && zs.vk[v] == 1) a.c_vo[m * V + v] = 1;
      }
      if (lane == 0) {
        a.c_zc_bits[m] = cz_after;
        if (add > 0 || drain > 0) a.c_gbits[(size_t)m * W + gword] |= gbit;
        x.c_take[m] = wadd(x.c_take[m], tot);
        claim_contrib(zs, zs.contrib, Z, cz_after, tot);
        placed = wadd(placed, tot);
      }
    }
    // fresh claims: the (A) multi-claim open or the (B) mega generations,
    // a warp of the team per claim
    const int n_fresh = zs.use_p ? zs.n_open_p : zs.n_mega;
    for (int j = tm.gwid; j < n_fresh; j += tm.gnw) {
      const int m = used0 + j;
      const int p = zs.p_star;
      int take;
      unsigned bits;
      if (zs.use_p) {
        take = zs.multi_ok
            ? min(max(wsub(zs.q_tot_p, wmul(j, max(zs.full_p, 1))), 0), zs.full_p) : zs.q_p;
        bits = zs.nbits_p[p];
      } else {
        take = x.scat_take[j];
        bits = zs.zcm[x.scat_z[j]] & zs.pz_star;
      }
      unsigned char* mask = a.c_mask + (size_t)m * T;
      const int* daemon = a.pool_daemon + p * R;
#pragma unroll 4
      for (int t = lane; t < T; t += 32) {
        const bool fit = __ldg(&compat[t]) && __ldg(&a.pool_type[(size_t)p * T + t]) &&
                         (bits & __ldg(&a.offer_zc_bits[t])) != 0u;
        const int k = !fit ? 0 : zs.use_p ? fit_rows(a.type_alloc + t * R, daemon, sh, R)
                                          : x.k_cap[t];
        mask[t] = fit && k >= take;
      }
      // the row's fields, a lane a column
      for (int r = lane; r < R; r += 32) a.c_cum[m * R + r] = wadd(daemon[r], wmul(take, sh.req[r]));
      for (int w = lane; w < W; w += 32) a.c_gbits[(size_t)m * W + w] = (w == gword) ? gbit : 0u;
      for (int q = lane; q < Q; q += 32) {
        a.c_cm[m * Q + q] = sh.q()[q].mg ? take : 0;
        a.c_co[m * Q + q] = (take > 0 && sh.q()[q].og && sh.q()[q].kq == 1) ? 1 : 0;
      }
      for (int v = lane; v < V; v += 32) {
        a.c_vm[m * V + v] = zs.mv[v] ? take : 0;
        if (zs.use_p) a.c_vo[m * V + v] = take > 0 && zs.ov[v] && zs.vk[v] == 1;
      }
      if (lane == 0) {
        a.c_zc_bits[m] = bits;
        a.c_pool[m] = p;
        x.c_take[m] = wadd(x.c_take[m], take);
        claim_contrib(zs, zs.contrib, Z, bits, take);
        placed = wadd(placed, take);
      }
    }
    // the event's placed pods and domain counts over the team (the
    // barrier also orders the contrib atomics)
    placed = warp_sum(placed);
    if (lane == 0 && placed != 0) atomicAdd(&zs.contrib[Z], placed);
    cluster_barrier();
    pull_sum(tm, zs, Z);
    __syncthreads();
    // domain counts, anti-owner registration and the event's bookkeeping
    for (int i = tm.gtid; i < V * Z; i += tm.gnt) {
      const int v = i / Z, z = i % Z;
      if (zs.mv[v]) a.v_count[i] = wadd(a.v_count[i], zs.csum[z]);
      if (zs.ov[v] && zs.vk[v] == 1 && zs.owner_rec[z]) a.v_owner_z[i] = 1;
    }
    if (tid == 0) {
      const int p = zs.p_star;
      const int n_open = zs.use_p ? zs.n_open_p : 0;
      if (tm.rank == 0)  // every CTA read p_usage before the barrier above
        for (int r = 0; r < R; ++r) {
          a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(zs.charge_p[p][r], n_open));
          if (zs.mega_ok) a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(zs.charge0[r], zs.n_mega));
        }
      sh.used = used0 + n_open + zs.n_mega;
      zs.remaining = wsub(remaining, zs.csum[Z]);
      zs.progress = zs.csum[Z] != 0;
      zs.fuel = wsub(zs.fuel, 1);
      zs.events += 1;
    }
    cluster_barrier();
  }
  for (int m = tm.gtid; m < M; m += tm.gnt) a.take_c[take_row<BATCH || LADDER>(s, M) + m] = x.c_take[m];
  if (tm.lead()) {
    a.leftover[s] = zs.remaining;
    *a.events = wadd(*a.events, zs.events);
  }
  if constexpr (LADDER)  // the cascade reads the attempt's leftover here
    if (tid == 0) sh.remaining = zs.remaining;
  cluster_barrier();
}

// the scan's global scratch (int words; scan_scratch_words() in
// solver/cuda/ffd.py sizes it): the fast branch's rows first, then the
// zoned branch's
__device__ __forceinline__ Scratch zone_scratch(const ScanArgs& a) {
  const int T = a.T, E = a.E, M = a.M;
  Scratch x;
  x.e_full = a.scratch;             // [E] cap_full, then the pour cap / prefix; zoned: e_fit
  x.e_boot = x.e_full + E;          // [E]; zoned: e_host
  x.c_full = x.e_boot + E;          // [M]; zoned: affinity-bulk caps
  x.c_boot = x.c_full + M;          // [M]
  x.c_take = x.c_boot + M;          // [M] this run's claim takes
  x.c_pref = x.c_take + M;          // [M]
  x.k_t = x.c_pref + M;             // [T]
  x.fit_t = x.k_t + T;              // [T]
  x.c_km = x.fit_t + T;             // [M] k_m
  x.c_host = x.c_km + M;            // [M] c_host
  x.c_flag = x.c_host + M;          // [M] bit 0 elig_m, bit 1 node_ok
  x.c_apref = x.c_flag + M;         // [M] affinity-bulk pour prefix
  x.c_bits = (unsigned*)(x.c_apref + M);  // [M] bits_eff
  x.k_cap = (int*)(x.c_bits + M);   // [T] fresh-claim fit on p_star
  x.scat_z = x.k_cap + T;           // [M]
  x.scat_take = x.scat_z + M;       // [M]
  x.caps_mz = x.scat_take + M;      // [M, Z]
  x.take_mz = x.caps_mz + (size_t)M * a.Z;  // [M, Z]
  return x;
}

// ---- K4: the batched scan (BATCH=true) ---------------------------------------
//
// Replaces karpenter_tpu/solver/tpu/consolidate.py:57 _batched_ffd_core (jit
// :97 _batched_ffd): the FFD scan vmapped over B candidate subsets in verdict
// mode. Row b re-solves the universe with its subset's pods (b_run_count[b]),
// its subset's nodes removed from node_compat, their hostname-sig rows
// zeroed in the carry's e_cm / e_co, and its own v_count0.
//
// What bounds it on the H100: each row is K1's sequential scan (latency-
// bound), so a batch is bound by the rows' latency and how many rows run at
// once; the carry is per row ([E, Q] hostname counts are the largest part,
// written by the prologue and read back by every run's node pass).
// Design: the same kernel body as K1 under a second template flag, on K1's
// cluster team (ffd_batched_kernel below), the team chosen at launch from B
// and what the card holds (launch_batched): few rows take one cluster of CL
// CTAs a row, as the lanes scans do, so a row's node rows, claim rows and
// [n, T] grids spread over CL SMs; many rows take one CTA a row (a cluster
// of one) under launch bounds that let two rows share an SM, so the rows
// hide each other's latency. The prologue below moves every carry pointer to
// the row, seeds the carry in place over the whole team (no host-side copies
// of the seeds per row), and computes the row's [E] removed-node mask from
// node_cand and the row's cand_member into the row's scratch; node_compat
// reads AND it in (node_compat_at); one cluster barrier ends it. The current
// run's take rows live in the same scratch (take_row = 0): the body reads
// them back within a run, and verdict mode emits none. A row's scratch is
// the scan's shared rows, then its CL CTAs' own rows, then take_e [E],
// take_c [M] and the removed mask [E] (take_off, row_words).
#ifdef FFD_BATCHED_ONLY
__device__ void batch_row_prologue(ScanArgs& a, long long b) {
  cg::cluster_group c = cg::this_cluster();
  const int gtid = (int)c.block_rank() * NTC + (int)threadIdx.x;
  const int gnt = (int)c.num_blocks() * NTC;
  const int E = a.E, M = a.M, T = a.T, R = a.R, Q = a.Q, W = a.W, P = a.P, V = a.V, Z = a.Z;
  a.run_count += b * a.S;
  a.v_count0 += b * V * Z;
  a.cand_member += b * a.NC;
  a.e_cum += b * E * R;
  a.c_cum += b * M * R;
  a.c_mask += b * M * T;
  a.c_zc_bits += b * M;
  a.c_gbits += b * M * W;
  a.c_pool += b * M;
  a.used += b;
  a.p_usage += b * P * R;
  a.e_cm += b * E * Q;
  a.e_co += b * E * Q;
  a.c_cm += b * M * Q;
  a.c_co += b * M * Q;
  a.v_count += b * V * Z;
  a.v_owner_z += b * V * Z;
  a.c_vm += b * M * V;
  a.c_vo += b * M * V;
  a.leftover += b * a.S;
  a.events += b;
  a.scratch += b * a.row_words;
  a.take_e = a.scratch + a.take_off;
  a.take_c = a.take_e + E;
  a.removed = a.take_c + M;
  // the carry's initial values (FFDState at a cold solve), row b's seeds,
  // each array walked flat over the team's threads (coalesced). The [E, Q]
  // hostname rows are most of the bytes: where Q is a multiple of 4 and the
  // four arrays are 16-byte aligned (the arena's blocks align every entry
  // to 256 bytes), a thread seeds SEED_U 16-byte pieces at once, every
  // load issued before any store, so the pieces' dependent reads (the
  // node's candidate, then its membership) overlap; the removed mask is
  // written with a row's first piece.
  constexpr int SEED_U = 4;
  const bool vec = Q > 0 && (Q & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.e_cm) | reinterpret_cast<uintptr_t>(a.e_co) |
                     reinterpret_cast<uintptr_t>(a.node_q_member) |
                     reinterpret_cast<uintptr_t>(a.node_q_owner)) & 15u) == 0;
  if (vec) {
    const int Q4 = Q >> 2, n4 = E * Q4;
    const int4* qm = reinterpret_cast<const int4*>(a.node_q_member);
    const int4* qo = reinterpret_cast<const int4*>(a.node_q_owner);
    int4* cm = reinterpret_cast<int4*>(a.e_cm);
    int4* co = reinterpret_cast<int4*>(a.e_co);
    for (int i0 = gtid; i0 < n4; i0 += SEED_U * gnt) {
      int k[SEED_U];
      int4 m[SEED_U], o[SEED_U];
#pragma unroll
      for (int j = 0; j < SEED_U; ++j) {
        const int i = i0 + j * gnt;
        k[j] = i < n4 ? a.node_cand[i / Q4] : -1;
        if (i < n4) { m[j] = qm[i]; o[j] = qo[i]; }
      }
      bool rm[SEED_U];
#pragma unroll
      for (int j = 0; j < SEED_U; ++j) rm[j] = k[j] >= 0 && a.cand_member[min(k[j], a.NC - 1)];
#pragma unroll
      for (int j = 0; j < SEED_U; ++j) {
        const int i = i0 + j * gnt;
        if (i >= n4) continue;
        const int4 zero = make_int4(0, 0, 0, 0);
        cm[i] = rm[j] ? zero : m[j];
        co[i] = rm[j] ? zero : o[j];
        if (i % Q4 == 0) a.removed[i / Q4] = rm[j];
      }
    }
  } else {
    for (int e = gtid; e < E; e += gnt) {
      const int k = a.node_cand[e];
      a.removed[e] = k >= 0 && a.cand_member[min(k, a.NC - 1)];
    }
    for (int i = gtid; i < E * Q; i += gnt) {
      const int k = a.node_cand[i / Q];
      const bool rm = k >= 0 && a.cand_member[min(k, a.NC - 1)];
      a.e_cm[i] = rm ? 0 : a.node_q_member[i];
      a.e_co[i] = rm ? 0 : a.node_q_owner[i];
    }
  }
  for (int i = gtid; i < E * R; i += gnt) a.e_cum[i] = 0;
  for (int i = gtid; i < M * R; i += gnt) a.c_cum[i] = 0;
  for (int i = gtid; i < M * T; i += gnt) a.c_mask[i] = 0;
  for (int i = gtid; i < M; i += gnt) { a.c_zc_bits[i] = 0u; a.c_pool[i] = -1; }
  for (int i = gtid; i < M * W; i += gnt) a.c_gbits[i] = 0u;
  for (int i = gtid; i < M * Q; i += gnt) { a.c_cm[i] = 0; a.c_co[i] = 0; }
  for (int i = gtid; i < V * Z; i += gnt) { a.v_count[i] = a.v_count0[i]; a.v_owner_z[i] = 0; }
  for (int i = gtid; i < M * V; i += gnt) { a.c_vm[i] = 0; a.c_vo[i] = 0; }
  for (int i = gtid; i < P * R; i += gnt) a.p_usage[i] = a.pool_usage0[i];
  if (gtid == 0) { *a.used = 0; *a.events = 0; }
  cluster_barrier();  // the seeds and the mask, written strided, are read by every CTA
}
#endif  // FFD_BATCHED_ONLY

// ---- K6: the relax-ladder scan (LADDER=true) ---------------------------------
//
// Replaces karpenter_tpu/solver/tpu/ffd.py:2167 ffd_solve_ladder (step_ladder
// :1714-1800). Each run walks a cascade of ATTEMPTS, each one full scan step
// (the run body below, fast branch or event engine) for its own group and
// pod count: the base rung (level 0) pours every still-unplaced pod of the
// run's group; rung l >= 1 pours ONE pod of group run_ladder[s, l-1] (the
// run's pod spec with its l lowest-weight preferences dropped), and a -1
// there ends the walk. After a base attempt the walk goes to rung 1, after a
// rung that placed its pod back to the base, after one that placed nothing
// one rung up; it stops when the run is placed, past the last rung or out of
// fuel ((count + 1) * (Lw + 2) + 4 attempts).
//
// What bounds it on the H100: a serial chain of step bodies, one per
// attempt, and a pod that relaxes costs at least two (its base attempt and
// the rung that places it), so a run whose pods all relax costs >= 2 *
// count serial bodies; each body is K1's, latency-bound. On one block the
// open-claim passes, the mask narrowing and the pool passes were 70-90% of
// an attempt (PERF.md §6, the ladder's attribution).
// Design: one thread-block cluster a solve (ffd_ladder_kernel, K1's team
// and launch), so every attempt's body runs on the cluster as K1's runs do.
// The run loop's header picks the attempt (its group and count) and the
// loop's increment folds it into the run, so the body is K1's. A walk
// keeps few claims open (a relax walk: 53 at 10 000 pods), so the body
// spreads the claim rows over the CTAs (cta_chunk) and walks each row with
// several warps (row_warps), in the fast branch's fit and narrowing and the
// event engine's claim pass, and skips work that cannot change its outputs:
// the pools once no pod is left, pools that no allowed domain admits in the
// event engine, the node pass where no node row can take a pod (every
// instance does the same).
// The cascade state (level, remaining, fuel) is uniform over the team:
// every thread of every CTA keeps its own copy in registers, computed from
// the attempt's leftover in its CTA's own sh.remaining (every path out of
// an attempt's body leaves it there, the same in every CTA, behind the
// body's closing team barrier), so the cascade reads nothing across CTAs.
// Each attempt writes its take rows and leftover to scratch (take_row = 0);
// the increment adds the take rows into the run's output rows strided over
// the team's threads, the same stride at which every attempt's body zeroes
// or first writes a take row before its first team barrier (the zoned
// run's zeroing and final copy, the node pour or its skip), so the fold
// needs no barrier of its own. Every attempt commits its carry, as the JAX
// while_loop commits its state.

struct Cascade {
  int s = -1;     // the run the cascade is walking
  int lvl = 0;    // 0 the base rung, l >= 1 run_ladder[s, l - 1]
  int rem = 0;    // the run's pods still unplaced
  int fuel = 0;
  int cnt = 0;    // the current attempt's pod count
  int base = 0;   // the current attempt is the base rung
  int ran = 0;    // an attempt ran since the last increment
};

// The header of the run loop: starts run s's walk (zeroed output rows) the
// first time it sees s, then picks the next attempt: its group in g, its pod
// count in count. Returns false when the walk is over (the run's leftover
// written): the loop then moves to the next run.
__device__ bool ladder_attempt(const ScanArgs& a, const Team& tm, Cascade& c, int s, int& g,
                               int& count) {
  if (c.s != s) {
    c.s = s;
    c.lvl = 0;
    c.rem = count;
    c.fuel = wadd(wmul(wadd(count, 1), a.Lw + 2), 4);
    for (int e = tm.gtid; e < a.E; e += tm.gnt) a.out_take_e[(size_t)s * a.E + e] = 0;
    for (int m = tm.gtid; m < a.M; m += tm.gnt) a.out_take_c[(size_t)s * a.M + m] = 0;
  }
  c.ran = 0;
  if (count > 0 && c.rem > 0 && c.lvl <= a.Lw && c.fuel > 0) {
    const bool base = c.lvl == 0;
    const int gv = base ? 0 : a.run_ladder[(size_t)s * a.Lw + min(max(c.lvl - 1, 0), a.Lw - 1)];
    if (base || gv >= 0) {
      if (!base) g = min(max(gv, 0), a.G - 1);
      count = base ? c.rem : 1;
      c.cnt = count;
      c.base = base;
      c.ran = 1;
      return true;
    }
  }
  if (tm.lead()) a.out_leftover[s] = count > 0 ? c.rem : 0;
  return false;
}

// The increment of the run loop: K1 and K4 go to the next run; K6 folds the
// attempt that ran into run s (takes into its output rows, placed pods into
// the cascade: the attempt's leftover is the CTA's sh.remaining) and stays
// on s, or moves on when no attempt ran.
template <bool LADDER>
__device__ __forceinline__ int next_run(const ScanArgs& a, const RunShared& sh, const Team& tm,
                                        Cascade& c, int s) {
  if constexpr (!LADDER) {
    return s + 1;
  } else {
    if (!c.ran) return s + 1;
    for (int e = tm.gtid; e < a.E; e += tm.gnt)
      a.out_take_e[(size_t)s * a.E + e] = wadd(a.out_take_e[(size_t)s * a.E + e], a.take_e[e]);
    for (int m = tm.gtid; m < a.M; m += tm.gnt)
      a.out_take_c[(size_t)s * a.M + m] = wadd(a.out_take_c[(size_t)s * a.M + m], a.take_c[m]);
    const int placed = wsub(c.cnt, sh.remaining);
    c.lvl = c.base ? 1 : (placed > 0 ? 0 : c.lvl + 1);
    c.rem = wsub(c.rem, placed);
    c.fuel = wsub(c.fuel, 1);
    c.ran = 0;
    if (tm.lead()) *a.attempts += 1;
    return s;
  }
}

// K7: the loop increment of the checkpointed scan. Every path out of a
// run's body reaches it (the padded run's and the zoned run's `continue`
// too), so the step at position pos = s + 1 snapshots the whole carry into
// ring slot ((pos / K) - 1) % n when pos % K == 0, padded steps included,
// and records prefix[slot] = pos (ffd.py:1838-1846). Between a team barrier
// that makes the step's writes visible and one that keeps the next step
// from writing a field before it is copied, the team's threads copy each
// field (16 B per thread where both ends are 16-byte aligned); the claim
// count is the CTA's shared copy, which reaches *a.used only at the end,
// written by the team's lead thread. The zoned event counter is not part of
// the carry and stays out. Identity (no code) for CKPT=false.
__device__ void team_copy(unsigned char* dst, const unsigned char* src, size_t n, size_t i0,
                          size_t stride) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0u) {
    const size_t n16 = n >> 4;
    for (size_t i = i0; i < n16; i += stride)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    for (size_t i = (n16 << 4) + i0; i < n; i += stride) dst[i] = src[i];
  } else {
    for (size_t i = i0; i < n; i += stride) dst[i] = src[i];
  }
}

template <bool CKPT>
__device__ __forceinline__ int snapshot(const ScanArgs& a, const RunShared& sh, const Team& tm,
                                        int s) {
  if constexpr (CKPT) {
    const int pos = s + 1;
    if (pos % a.ck_every == 0) {
      cluster_barrier();
      const size_t slot = (size_t)((pos / a.ck_every - 1) % a.n_ckpt);
      const size_t E = a.E, M = a.M, T = a.T, R = a.R, Q = a.Q, W = a.W, P = a.P,
                   V = a.V, Z = a.Z;
      const unsigned char* src[16] = {
          (const unsigned char*)a.e_cum, (const unsigned char*)a.c_cum, a.c_mask,
          (const unsigned char*)a.c_zc_bits, (const unsigned char*)a.c_gbits,
          (const unsigned char*)a.c_pool, nullptr, (const unsigned char*)a.p_usage,
          (const unsigned char*)a.e_cm, (const unsigned char*)a.e_co,
          (const unsigned char*)a.c_cm, (const unsigned char*)a.c_co,
          (const unsigned char*)a.v_count, a.v_owner_z, (const unsigned char*)a.c_vm, a.c_vo};
      const size_t nb[16] = {E * R * 4, M * R * 4, M * T, M * 4, M * W * 4, M * 4, 4,
                             P * R * 4, E * Q * 4, E * Q * 4, M * Q * 4, M * Q * 4,
                             V * Z * 4, V * Z, M * V * 4, M * V};
#pragma unroll
      for (int f = 0; f < 16; ++f)
        if (f != 6) team_copy(a.ring[f] + slot * nb[f], src[f], nb[f], tm.gtid, tm.gnt);
      if (tm.lead()) {
        reinterpret_cast<int*>(a.ring[6])[slot] = sh.used;
        a.ring_prefix[slot] = pos;
      }
      cluster_barrier();
    }
  }
  return s;
}

// ---- K1s / K6s / K7s: the sparse instances (SPARSE=true) -------------------
//
// Replace the JAX sparse twins (ffd.py:2403 ffd_solve_sparse, :2500
// ffd_solve_ckpt_sparse, :2602 ffd_resume_sparse, :2701
// ffd_solve_ladder_sparse): the same scan, with the run's hostname (Q) and
// zone-sig (V) state read through its index rows run_q_idx[s] /
// run_v_idx[s] (-1 padding anywhere in a row). The run prologue loads the
// rows and gathers the group's flags into the shared slots (mg/og/kq/cq,
// mv/ov/vk), with a slot -> column map (qcol, vcol; -1 on padding, whose
// flags are false); the fast branch, the fresh-claim allowance, the boot
// test and the `constrained` test (ffd.py:1662) read the slots, and the fast
// branch's writes skip padding and land in the slot's column. A claim open
// adds onto its row (rows >= used are zero), as the JAX scatter-add does.
// The zoned event engine reads the dense flags by sig index, so a
// constrained run reloads them at full width before it (ffd.py:876-890).
// What bounds it on the H100: as K1 (latency-bound); the view
// narrows the fast branch's per-row Q and V loops to Kq / Kv slots.
// Design: K1's body under a fifth template flag, so the dense instances
// keep their code; the index tables ride beside the 32 scan inputs.

// Bytes of the launch-sized shared rows (scan_rows) of one launch: the Q
// rows (QRow, 24 bytes, over max(Q, Kq) rows), then in the zoned instances
// the V rows (vk and vcol as int, mv and ov as bytes). The dense instances
// pass Kq = Kv = 0. A sparse zoned launch at Kq = Q, Kv = V takes 24 bytes
// a Q row and 10 a V row.
__host__ __device__ __forceinline__ int q_rows_bytes(int Q, int Kq) {
  return (int)sizeof(QRow) * (Q > Kq ? Q : Kq);
}

__host__ __device__ __forceinline__ int zone_rows_bytes(int V, int Kv) {
  const int vd = V > Kv ? V : Kv;
  return 6 * vd + 4 * Kv;
}

__host__ __device__ __forceinline__ int scan_rows_bytes(int Q, int Kq, int V, int Kv, bool zone) {
  return q_rows_bytes(Q, Kq) + (zone ? zone_rows_bytes(V, Kv) : 0);
}

__device__ __forceinline__ void bind_zone_rows(ZoneShared& zs, int V, int Kv, int q_bytes) {
  const int vd = max(V, Kv);
  zs.vk = reinterpret_cast<int*>(scan_rows + q_bytes);
  zs.vcol = zs.vk + vd;
  zs.mv = reinterpret_cast<unsigned char*>(zs.vcol + Kv);
  zs.ov = zs.mv + vd;
}

// int32 words of the scan's shared global scratch (solver/cuda/ffd.py
// scan_scratch_words), and of one cluster CTA's own rows after it
// (cluster_scratch_words): k_t, fit_t, k_cap [T], scat_z, scat_take [M]
__host__ __device__ __forceinline__ size_t scan_words(const ScanArgs& a) {
  return 2 * (size_t)a.E + 11 * (size_t)a.M + 3 * (size_t)a.T + 2 * (size_t)a.M * a.Z + 64;
}

__host__ __device__ __forceinline__ size_t cta_words(const ScanArgs& a) {
  return 3 * (size_t)a.T + 2 * (size_t)a.M;
}

// The scan body of every instance below: ffd_cluster_kernel's,
// ffd_ladder_kernel's and, for K15, ffd_lanes_kernel's and, for K4,
// ffd_batched_kernel's. Inlined into each kernel, so an instance compiles as
// it did when this body was the kernel's own. The team is the launch's
// cluster (see Team).
template <bool ZONE, bool BATCH, bool LADDER, bool CKPT, bool SPARSE>
__device__ __forceinline__ void scan_body(ScanArgs& a) {
  constexpr int NTB = Team::NTB, NWB = Team::NWB;
  __shared__ RunShared sh;
  ZoneShared* zs = nullptr;
  Scratch x{};
  if constexpr (ZONE) {
    __shared__ ZoneShared zone_sh;
    zs = &zone_sh;
    x = zone_scratch(a);
  }
  Team tm;
  const int tid = tm.tid, lane = tm.lane;
  const int T = a.T, E = a.E, P = a.P, R = a.R, Q = a.Q, W = a.W, M = a.M;
  int* e_full = a.scratch;          // [E] cap_full, then the pour cap / prefix
  int* e_boot = e_full + E;         // [E]
  int* c_full = e_boot + E;         // [M]
  int* c_boot = c_full + M;         // [M]
  int* c_take = c_boot + M;         // [M] this run's claim takes (pour + opens)
  int* c_pref = c_take + M;         // [M]
  int* k_t = c_pref + M;            // [T]
  int* fit_t = k_t + T;             // [T]
  {
    // the rows every CTA computes whole for itself: its own copy
    int* own = a.scratch + scan_words(a) + (size_t)tm.rank * cta_words(a);
    k_t = own;
    fit_t = own + T;
    x.k_cap = own + 2 * T;
    x.scat_z = own + 3 * T;
    x.scat_take = own + 3 * T + M;
  }

  if (tid == 0) {
    sh.used = *a.used;
    if constexpr (ZONE) bind_zone_rows(*zs, a.V, SPARSE ? a.Kv : 0, q_rows_bytes(Q, SPARSE ? a.Kq : 0));
  }
  __syncthreads();

  Cascade cas;
  for (int s = 0; s < a.S; s = next_run<LADDER>(a, sh, tm, cas, snapshot<CKPT>(a, sh, tm, s))) {
    int g = a.run_group[s];
    int count = a.run_count[s];
    if constexpr (LADDER)
      if (!ladder_attempt(a, tm, cas, s, g, count)) continue;
    // padded run: zero rows, state untouched (never an attempt: the cascade
    // starts one only with count > 0)
    if (count <= 0) {
      for (int i = tm.gtid; i < E; i += tm.gnt) a.take_e[take_row<BATCH || LADDER>(s, E) + i] = 0;
      for (int i = tm.gtid; i < M; i += tm.gnt) a.take_c[take_row<BATCH || LADDER>(s, M) + i] = 0;
      if (tm.lead()) a.leftover[s] = 0;
      continue;
    }
    const unsigned g_zc = a.group_zc_bits[g];
    // the run's view of the Q and V axes: nq / nv slots
    const int nq = SPARSE ? a.Kq : Q;
    const int nv = SPARSE ? a.Kv : a.V;
    if (tid < R) {
      const int rq = a.group_req[g * R + tid];
      sh.req[tid] = rq;
      if (rq > 0) magic_of(rq, sh.dm[tid], sh.ds[tid]);
    }
    if constexpr (SPARSE) {
      for (int k = tid; k < nq; k += NTB) {
        const int c = a.run_q_idx[(size_t)s * nq + k];
        const bool ok = c >= 0 && c < Q;
        sh.q()[k].qcol = ok ? c : -1;
        sh.q()[k].mg = ok && a.q_member[g * Q + c] != 0;
        sh.q()[k].og = ok && a.q_owner[g * Q + c] != 0;
        sh.q()[k].kq = ok ? a.q_kind[c] : 0;
        sh.q()[k].cq = ok ? a.q_cap[c] : 0;
        sh.q()[k].tot = 0u;
      }
    } else {
      for (int q = tid; q < Q; q += NTB) {
        sh.q()[q].mg = a.q_member[g * Q + q] != 0;
        sh.q()[q].og = a.q_owner[g * Q + q] != 0;
        sh.q()[q].kq = a.q_kind[q];
        sh.q()[q].cq = a.q_cap[q];
        sh.q()[q].tot = 0u;
      }
    }
    for (int i = tm.gtid; i < M; i += tm.gnt) c_take[i] = 0;
    if constexpr (ZONE) {
      if constexpr (SPARSE) {
        for (int k = tid; k < nv; k += NTB) {
          const int c = a.run_v_idx[(size_t)s * nv + k];
          const bool ok = c >= 0 && c < a.V;
          zs->vcol[k] = ok ? c : -1;
          zs->mv[k] = ok && a.v_member[g * a.V + c] != 0;
          zs->ov[k] = ok && a.v_owner[g * a.V + c] != 0;
          zs->vk[k] = ok ? a.v_kind[c] : 0;
        }
      } else {
        for (int v = tid; v < a.V; v += NTB) {
          zs->mv[v] = a.v_member[g * a.V + v] != 0;
          zs->ov[v] = a.v_owner[g * a.V + v] != 0;
          zs->vk[v] = a.v_kind[v];
        }
      }
    }
    __syncthreads();
    // (nq may exceed the block: each thread folds its strided slots)
    int own2 = 0;
    for (int k = tid; k < nq; k += NTB) own2 |= sh.q()[k].og && sh.q()[k].kq == 2;
    const int any_owned2 = __syncthreads_or(own2);
    if (any_owned2) {
      // total members per sig over nodes and claims (wrapping sums); every
      // CTA sums every row into its own Q rows
      for (int e = tid; e < E; e += NTB)
        for (int q = 0; q < nq; ++q) {
          const int c = qcol_of<SPARSE>(sh, q);
          if constexpr (SPARSE) if (c < 0) continue;
          if (a.e_cm[e * Q + c]) atomicAdd(&sh.q()[q].tot, (unsigned)a.e_cm[e * Q + c]);
        }
      for (int m = tid; m < M; m += NTB)
        for (int q = 0; q < nq; ++q) {
          const int c = qcol_of<SPARSE>(sh, q);
          if constexpr (SPARSE) if (c < 0) continue;
          if (a.c_cm[m * Q + c]) atomicAdd(&sh.q()[q].tot, (unsigned)a.c_cm[m * Q + c]);
        }
    }
    __syncthreads();
    if (tid == 0) {
      sh.fresh_allow = row_allowance<false, SPARSE>(sh, nq, nullptr, nullptr);
      int boot_ok = 1;
      for (int q = 0; q < nq; ++q)
        if (sh.q()[q].og && sh.q()[q].kq == 2 && !(sh.q()[q].mg && sh.q()[q].tot == 0u)) boot_ok = 0;
      sh.boot2 = any_owned2 && boot_ok;
      sh.remaining = a.group_device[g] ? count : 0;
    }
    __syncthreads();
    const int boot2 = sh.boot2;
    if constexpr (ZONE) {
      // `constrained` (ffd.py:1662): the group owns a V-axis sig or is a
      // member of an anti sig -> the domain event engine
      // (nv may exceed the block: each thread folds its strided slots)
      int con = 0;
      for (int k = tid; k < nv; k += NTB) con |= zs->ov[k] || (zs->mv[k] && zs->vk[k] == 1);
      const int constrained = __syncthreads_or(con);
      if (constrained) {
        if constexpr (SPARSE) {
          // the event engine reads the dense flags by sig index
          for (int q = tid; q < Q; q += NTB) {
            sh.q()[q].mg = a.q_member[g * Q + q] != 0;
            sh.q()[q].og = a.q_owner[g * Q + q] != 0;
            sh.q()[q].kq = a.q_kind[q];
            sh.q()[q].cq = a.q_cap[q];
          }
          for (int v = tid; v < a.V; v += NTB) {
            zs->mv[v] = a.v_member[g * a.V + v] != 0;
            zs->ov[v] = a.v_owner[g * a.V + v] != 0;
            zs->vk[v] = a.v_kind[v];
          }
          __syncthreads();
        }
        zoned_run<BATCH, LADDER>(a, sh, *zs, x, tm, s, g);
        continue;
      }
      int mv_any = 0;
      for (int k = tid; k < nv; k += NTB) mv_any |= zs->mv[k];
      const int any_mv = __syncthreads_or(mv_any);
      if (tid == 0) zs->any_mv = any_mv;
    }

    // ---- 1. existing nodes, strided over the team's threads (coalesced);
    // the pour's prefix over contiguous chunks in between -------------------
    // The first-boot node matters only under boot2 (the boot rewrite and
    // cap2), so only then is it reduced. Every cap is in [0, BIG]: where the
    // caps' exact sum stays below 2^31 no prefix wraps and the first-fit
    // pour places min(remaining, sum) pods; only past that is the placed
    // count reduced.
    int has_e_boot = 0;
    bool nodes = E > 0;
    // The pass is skipped where no node row can take a pod of the run (a
    // dispatch without nodes holds padding rows only): every CTA tests the
    // rows itself (E <= its threads) before any thread of the team writes,
    // and the take row is zeroed at the stride the pour writes it
    if (nodes && E <= NTB) {
      int cap = 0;
      if (tid < E && node_compat_at<BATCH>(a, g, tid))
        cap = min(fit_rows(a.node_free + tid * R, a.e_cum + tid * R, sh, R),
                  row_allowance<false, SPARSE>(sh, nq, a.e_cm + tid * Q, a.e_co + tid * Q)) > 0;
      nodes = __syncthreads_or(cap);
      if (!nodes)
        for (int e = tm.gtid; e < E; e += tm.gnt) a.take_e[take_row<BATCH || LADDER>(s, E) + e] = 0;
    }
    if (nodes) {
      int my_first = I32MAX;
      for (int e = tm.gtid; e < E; e += tm.gnt) {
        int base = node_compat_at<BATCH>(a, g, e)
                       ? fit_rows(a.node_free + e * R, a.e_cum + e * R, sh, R) : 0;
        const int allow = row_allowance<false, SPARSE>(sh, nq, a.e_cm + e * Q, a.e_co + e * Q);
        const int pos = row_pos<SPARSE>(sh, nq, a.e_cm + e * Q);
        e_full[e] = min(base, min(allow, pos));
        e_boot[e] = min(base, allow);
        if (e_boot[e] > 0) my_first = min(my_first, e);
      }
      if (boot2) {
        int e_first = team_reduce<OP_MIN>(tm, my_first, sh.ts);
        has_e_boot = e_first != I32MAX;
        if (!has_e_boot) e_first = 0;
        for (int e = tm.gtid; e < E; e += tm.gnt) e_full[e] = (e == e_first) ? e_boot[e] : 0;
      }
      // first-fit pour: take = clip(remaining - prefix, 0, cap)
      for (int e = tm.gtid; e < E; e += tm.gnt) e_boot[e] = e_full[e];  // keep caps
      cluster_barrier();  // the caps, written strided, are read in chunks
      const int rem = sh.remaining;
      int lo, hi;
      thread_chunk(tm, E, lo, hi);
      const long long tot = team_scan(tm, e_full, e_full, lo, hi, sh.ts);
      cluster_barrier();  // the prefixes, written in chunks, are read strided
      int placed = 0;
      for (int e = tm.gtid; e < E; e += tm.gnt) {
        const int take = min(max(wsub(rem, e_full[e]), 0), e_boot[e]);
        a.take_e[take_row<BATCH || LADDER>(s, E) + e] = take;
        placed = wadd(placed, take);
        if (take > 0) {
          for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = wadd(a.e_cum[e * R + r], wmul(take, sh.req[r]));
          for (int k = 0; k < nq; ++k) {
            const int q = qcol_of<SPARSE>(sh, k);
            if constexpr (SPARSE) if (q < 0) continue;
            if (sh.q()[k].mg) a.e_cm[e * Q + q] = wadd(a.e_cm[e * Q + q], take);
            if (sh.q()[k].og && sh.q()[k].kq == 1) a.e_co[e * Q + q] = wadd(a.e_co[e * Q + q], 1);
          }
        }
      }
      if (tot >= 0 && tot <= I32MAX) placed = rem > 0 ? (int)min((long long)rem, tot) : 0;
      else placed = team_reduce<OP_SUM>(tm, placed, sh.ts);
      if (tid == 0) sh.remaining = wsub(rem, placed);
      __syncthreads();
    }

    // ---- 2. open claims: a warp of the team per claim row, the warp's
    // rows contiguous; the pour's prefix runs over the warps' lanes in
    // row order, so every row stays with its warp. The rows spread over
    // the CTAs, and a row's [T] is walked by ws warps where a CTA holds
    // fewer rows than warps (row_warps) ----------------------------------------
    const int used0 = sh.used;
    const unsigned char* compat = a.group_compat_t + (size_t)g * T;
    const unsigned* g_nok = a.group_pair_nok + (size_t)g * W;
    int wlo, whi, clo, chi;
    warp_chunk(tm, used0, wlo, whi);
    cta_chunk(tm, used0, clo, chi);
    const int ws = row_warps<NWB>(chi - clo);
    // the most pods of the run that claim row m takes over the lane's types
    // t0, t0 + step, ... (0 where the claim cannot take the group): the
    // warp's maximum, in every lane
    auto claim_fit = [&](int m, int t0, int step) {
      const int pool = a.c_pool[m];
      const bool is_open = pool >= 0;
      const bool pool_ok = is_open && a.group_pool[g * P + min(max(pool, 0), P - 1)];
      bool clash = false;
      for (int w = lane; w < W; w += 32) clash |= (a.c_gbits[(size_t)m * W + w] & g_nok[w]) != 0u;
      const bool node_ok = is_open && pool_ok && !__any_sync(FULL, clash);
      int kbest = 0;
      if (node_ok) {
        const unsigned czc = a.c_zc_bits[m] & g_zc;
        const int* cum = a.c_cum + m * R;
        const unsigned char* mask = a.c_mask + (size_t)m * T;
        // each row's loads issued before its test, four rows in flight
#pragma unroll 4
        for (int t = t0; t < T; t += step) {
          const bool ok = (mask[t] != 0) & (__ldg(&compat[t]) != 0) &
                          ((czc & __ldg(&a.offer_zc_bits[t])) != 0u);
          const int k = fit_rows(a.type_alloc + t * R, cum, sh, R);
          if (ok) kbest = max(kbest, k);
        }
      }
      return warp_max(kbest);
    };
    // claims that received pods: narrow the lane's types of the type mask
    // with the OLD carry ...
    auto narrow = [&](int m, int take, int t0, int step) {
      const unsigned czc = a.c_zc_bits[m];
      const int* cum = a.c_cum + m * R;
      unsigned char* mask = a.c_mask + (size_t)m * T;
#pragma unroll 4
      for (int t = t0; t < T; t += step) {
        const bool fit = (mask[t] != 0) & (__ldg(&compat[t]) != 0) &
                         ((czc & __ldg(&a.offer_zc_bits[t]) & g_zc) != 0u);
        const int k = fit_rows(a.type_alloc + t * R, cum, sh, R);
        mask[t] = fit && k >= take;
      }
    };
    // ... then fold the pods into the row's counters (the warp's lanes): a
    // lane a column where the columns are the dense ones (distinct); a
    // sparse view's slots are walked in order
    auto fold = [&](int m, int take) {
      const unsigned czc = a.c_zc_bits[m];
      for (int r = lane; r < R; r += 32) a.c_cum[m * R + r] = wadd(a.c_cum[m * R + r], wmul(take, sh.req[r]));
      // (a sparse view's padding slots, column -1, are skipped)
      for (int k = SPARSE ? (lane == 0 ? 0 : nq) : lane; k < nq; k += SPARSE ? 1 : 32) {
        const int q = qcol_of<SPARSE>(sh, k);
        if (!SPARSE || q >= 0) {
          if (sh.q()[k].mg) a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], take);
          if (sh.q()[k].og && sh.q()[k].kq == 1) a.c_co[m * Q + q] = wadd(a.c_co[m * Q + q], 1);
        }
      }
      if (ZONE)
        for (int k = SPARSE ? (lane == 0 ? 0 : nv) : lane; k < nv; k += SPARSE ? 1 : 32) {
          const int v = SPARSE ? zs->vcol[k] : k;
          if ((!SPARSE || v >= 0) && zs->mv[k]) a.c_vm[m * a.V + v] = wadd(a.c_vm[m * a.V + v], take);
        }
      if (lane == 0) {
        a.c_zc_bits[m] = czc & g_zc;
        a.c_gbits[(size_t)m * W + (g >> 5)] |= 1u << (g & 31);
      }
    };
    {
      int my_first = I32MAX;
      // the row's caps from its fit, by lane 0 of the warp that owns it
      auto caps = [&](int m, int kbest) {
        const int allow = row_allowance<false, SPARSE>(sh, nq, a.c_cm + m * Q, a.c_co + m * Q);
        const int pos = row_pos<SPARSE>(sh, nq, a.c_cm + m * Q);
        c_full[m] = min(kbest, min(allow, pos));
        c_boot[m] = min(kbest, allow);
        if (c_boot[m] > 0) my_first = min(my_first, m);
      };
      if (ws == 1) {
        for (int m = wlo; m < whi; ++m) {
          const int kbest = claim_fit(m, lane, 32);
          if (lane == 0) caps(m, kbest);
        }
      } else {
        // (the CTA's rows are fewer than its warps: warp i owns row clo + i;
        // the warps' maxima meet in the team's reduction slots, which the
        // next reduction writes only after a barrier)
        const int i = tm.wid / ws;
        if (i < chi - clo) {
          const int k = claim_fit(clo + i, (tm.wid % ws) * 32 + lane, 32 * ws);
          if (lane == 0) sh.ts.red[tm.wid] = k;
        }
        __syncthreads();
        if (tm.wid < chi - clo && lane == 0) {
          int k = 0;
          for (int j = 0; j < ws; ++j) k = max(k, sh.ts.red[tm.wid * ws + j]);
          caps(clo + tm.wid, k);
        }
      }
      __syncwarp();
      int has_c_boot = 0;
      if (boot2) {
        int c_first = team_reduce<OP_MIN>(tm, my_first, sh.ts);
        has_c_boot = c_first != I32MAX;
        if (!has_c_boot) c_first = 0;
        if (lane == 0)
          for (int m = wlo; m < whi; ++m) c_full[m] = (!has_e_boot && m == c_first) ? c_boot[m] : 0;
        __syncwarp();
      }
      int lo, hi;
      lane_chunk(wlo, whi, lane, lo, hi);
      const int rem = sh.remaining;
      const long long tot = team_scan(tm, c_full, c_pref, lo, hi, sh.ts);
      int placed = 0;
      for (int m = lo; m < hi; ++m) {
        const int take = min(max(wsub(rem, c_pref[m]), 0), c_full[m]);
        c_take[m] = take;
        a.take_c[take_row<BATCH || LADDER>(s, M) + m] = take;
        placed = wadd(placed, take);
      }
      if (tot >= 0 && tot <= I32MAX) placed = rem > 0 ? (int)min((long long)rem, tot) : 0;
      else placed = team_reduce<OP_SUM>(tm, placed, sh.ts);
      __syncwarp();
      if (ws == 1) {
        for (int m = wlo; m < whi; ++m) {
          const int take = c_take[m];
          if (take <= 0) continue;
          narrow(m, take, lane, 32);
          __syncwarp();
          fold(m, take);
        }
      } else {
        // the CTA's receiving rows share all its warps' walks
        __syncthreads();  // the CTA's pours are written
        const int rows = chi - clo;
        const unsigned got = __ballot_sync(FULL, lane < rows && c_take[clo + lane] > 0);
        const int nr = __popc(got);
        if (nr > 0) {
          const int wr = NWB / nr;
          const int r = tm.wid / wr;
          if (r < nr) {
            const int m = clo + nth_bit(got, r);
            narrow(m, c_take[m], (tm.wid % wr) * 32 + lane, 32 * wr);
          }
          __syncthreads();  // every walk read the old carry
          if (tm.wid < rows && ((got >> tm.wid) & 1u)) fold(clo + tm.wid, c_take[clo + tm.wid]);
        }
      }
      if (tid == 0) {
        sh.remaining = wsub(rem, placed);
        sh.cap2 = any_owned2 ? ((boot2 && !has_e_boot && !has_c_boot) ? 1 : 0) : BIG;
      }
      __syncthreads();
    }

    // ---- 3. new claims, pool by pool in priority order: every CTA walks
    // every pool's [T] row (the fits into its own k_t / fit_t), so the
    // pool's decision needs no barrier across the cluster. The walk stops
    // once no pod is left (a relax rung pours one pod, mostly into an open
    // claim): a pool then opens nothing, and the outputs are the same
    // (sh.remaining is the same in every thread of the team) -----------------
    for (int p = 0; p < P && sh.remaining != 0; ++p) {
      const unsigned new_bits = a.pool_zc_bits[p] & g_zc;
      const int* daemon = a.pool_daemon + p * R;
      if (tid < R) sh.charge[tid] = I32MAX;
      __syncthreads();
      int kmax = 0;
      int cmin[MAX_R];
      for (int r = 0; r < R; ++r) cmin[r] = I32MAX;
      for (int t = tid; t < T; t += NTB) {
        const bool fit = __ldg(&compat[t]) && __ldg(&a.pool_type[(size_t)p * T + t]) &&
                         (__ldg(&a.offer_zc_bits[t]) & new_bits) != 0u;
        const int k = fit ? fit_rows(a.type_alloc + t * R, daemon, sh, R) : 0;
        k_t[t] = k;
        fit_t[t] = fit;
        kmax = max(kmax, k);
        if (fit && k >= 1)
          for (int r = 0; r < R; ++r) cmin[r] = min(cmin[r], __ldg(&a.type_charge[t * R + r]));
      }
      for (int r = 0; r < R; ++r) {
        const int c = __reduce_min_sync(FULL, cmin[r]);
        if (lane == 0 && c != I32MAX) atomicMin(&sh.charge[r], c);
      }
      kmax = cta_reduce<OP_MAX, NWB>(kmax, lane, tm.wid, sh.ts.red);  // also orders the atomics above
      if (tid == 0) {
        const int full_take = min(kmax, sh.fresh_allow);
        int allow = BIG;
        bool over = false;
        for (int r = 0; r < R; ++r) {
          int c = sh.charge[r];
          if (c == I32MAX) c = 0;
          sh.charge[r] = c;
          const int lim = a.pool_limit[p * R + r], use = a.p_usage[p * R + r];
          if (use >= lim) over = true;
          const int head = wsub(lim, use);
          const int trips = c > 0 ? max(wneg(floordiv(wneg(head), max(c, 1))), 0) : BIG;
          allow = min(allow, trips);
        }
        if (over) allow = 0;
        const int rem = sh.remaining;
        const int n_want = full_take > 0 ? wneg(floordiv(wneg(rem), max(full_take, 1))) : 0;
        int n_new = min(min(n_want, allow), wsub(M, sh.used));
        n_new = min(n_new, sh.cap2);
        if (!(a.group_pool[g * P + p] && full_take > 0)) n_new = 0;
        sh.n_new = n_new;
        sh.full_take = full_take;
      }
      __syncthreads();
      const int n_new = sh.n_new;
      if (n_new > 0) {
        const int used = sh.used, rem = sh.remaining, full = sh.full_take;
        for (size_t i = tm.gtid; i < (size_t)n_new * T; i += tm.gnt) {
          const int j = (int)(i / T), t = (int)(i % T);
          const int take_j = min(max(wsub(rem, wmul(j, full)), 0), full);
          a.c_mask[(size_t)(used + j) * T + t] = fit_t[t] && k_t[t] >= take_j;
        }
        // every CTA sums every new row; CTA rank writes rows j = rank mod n
        int placed = 0;
        for (int j = tid; j < n_new; j += NTB) {
          const int m = used + j;
          const int take_j = min(max(wsub(rem, wmul(j, full)), 0), full);
          placed = wadd(placed, take_j);
          if (j % tm.n != tm.rank) continue;
          for (int r = 0; r < R; ++r) a.c_cum[m * R + r] = wadd(daemon[r], wmul(take_j, sh.req[r]));
          a.c_zc_bits[m] = new_bits;
          for (int w = 0; w < W; ++w) a.c_gbits[(size_t)m * W + w] = (w == (g >> 5)) ? (1u << (g & 31)) : 0u;
          a.c_pool[m] = p;
          if constexpr (SPARSE) {
            // the row is zero (m >= used): add the view's columns onto it
            for (int k = 0; k < nq; ++k) {
              const int q = sh.q()[k].qcol;
              if (q < 0) continue;
              a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], sh.q()[k].mg ? take_j : 0);
              a.c_co[m * Q + q] =
                  wadd(a.c_co[m * Q + q], (take_j > 0 && sh.q()[k].og && sh.q()[k].kq == 1) ? 1 : 0);
            }
            if constexpr (ZONE)
              for (int k = 0; k < nv; ++k) {
                const int v = zs->vcol[k];
                if (v >= 0) a.c_vm[m * a.V + v] = wadd(a.c_vm[m * a.V + v], zs->mv[k] ? take_j : 0);
              }
          } else {
            for (int q = 0; q < Q; ++q) {
              a.c_cm[m * Q + q] = sh.q()[q].mg ? take_j : 0;
              a.c_co[m * Q + q] = (take_j > 0 && sh.q()[q].og && sh.q()[q].kq == 1) ? 1 : 0;
            }
            if constexpr (ZONE)
              for (int v = 0; v < a.V; ++v) a.c_vm[m * a.V + v] = zs->mv[v] ? take_j : 0;
          }
          c_take[m] = take_j;
          a.take_c[take_row<BATCH || LADDER>(s, M) + m] = take_j;
        }
        placed = cta_reduce<OP_SUM, NWB>(placed, lane, tm.wid, sh.ts.red);
        // every CTA has read p_usage[p] above before the lead thread adds to it
        cluster_barrier();
        if (tid == 0) {
          if (tm.rank == 0)
            for (int r = 0; r < R; ++r)
              a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(sh.charge[r], n_new));
          sh.remaining = wsub(rem, placed);
          sh.used = used + n_new;
          sh.cap2 = wsub(sh.cap2, n_new);
        }
      }
      __syncthreads();
    }
    if constexpr (ZONE) {
      // zone-sig membership counts: the group may match other pods'
      // selectors without owning a constraint (count_contrib); every CTA
      // sums every take of the run
      if (zs->any_mv) {
        if (tid < a.Z) zs->contrib[tid] = 0;
        cluster_barrier();
        for (int e = tid; e < E; e += NTB) {
          const int take = a.take_e[take_row<BATCH || LADDER>(s, E) + e];
          if (take > 0) node_contrib(a, zs->contrib, e, take);
        }
        for (int m = tid; m < sh.used; m += NTB)
          if (c_take[m] > 0) claim_contrib(*zs, zs->contrib, a.Z, a.c_zc_bits[m], c_take[m]);
        __syncthreads();
        if constexpr (SPARSE) {
          for (int i = tm.gtid; i < nv * a.Z; i += tm.gnt) {
            const int k = i / a.Z, v = zs->vcol[k];
            if (v >= 0 && zs->mv[k])
              a.v_count[v * a.Z + i % a.Z] = wadd(a.v_count[v * a.Z + i % a.Z], zs->contrib[i % a.Z]);
          }
        } else {
          for (int i = tm.gtid; i < a.V * a.Z; i += tm.gnt)
            if (zs->mv[i / a.Z]) a.v_count[i] = wadd(a.v_count[i], zs->contrib[i % a.Z]);
        }
      }
    }
    // the take row's claims past the run's last (the rest were written
    // where their pods were placed)
    for (int m = sh.used + tm.gtid; m < M; m += tm.gnt) a.take_c[take_row<BATCH || LADDER>(s, M) + m] = 0;
    if (tm.lead()) a.leftover[s] = sh.remaining;
    cluster_barrier();
  }
  if (tm.lead()) *a.used = sh.used;
}

// K1 (CKPT=false) and K7 (CKPT=true: K1 with the snapshot ring), and their
// sparse instances (SPARSE=true): one solve on one cluster of CTAs
template <bool ZONE, bool CKPT, bool SPARSE>
__global__ void __launch_bounds__(NTC, 1) ffd_cluster_kernel(ScanArgs a) {
  scan_body<ZONE, false, false, CKPT, SPARSE>(a);
}

// K6 and K6s (LADDER=true: a cascade of attempts per run): one solve on one
// cluster of CTAs, as K1's
template <bool ZONE, bool SPARSE>
__global__ void __launch_bounds__(NTC, 1) ffd_ladder_kernel(ScanArgs a) {
  scan_body<ZONE, false, true, false, SPARSE>(a);
}

#ifdef FFD_LANES_ONLY
// ---- K15: the lane-batched scan ------------------------------------------------
//
// Replaces karpenter_tpu/parallel/sharded.py:80 batched_solve: jax.vmap of
// ffd_solve over a leading lane axis, one lane a cohort member's whole solve
// (the fused cross-tenant cohort dispatch, backend.solve_cohort_async).
//
// What bounds it on the H100: each lane is K1's scan, a serial chain of run
// steps (latency-bound, far from the card's memory and integer peaks);
// lanes share nothing, so a lane's time is K1's at the lane's cluster size
// while every lane's cluster is resident at once.
// Design: one launch, one thread-block cluster of CL CTAs a lane (a grid of
// B x CL CTAs, the cluster along x), each cluster running K1's scan
// (scan_body<ZONE, false, false, false, false, true>) on its own lane: the
// same team, split and barriers as K1. CL is chosen per launch from B and
// the clusters the card holds at once (launch_lanes below). Every CTA of a
// cluster moves every argument, carry and output pointer of the lane-0
// ScanArgs by its cluster's lane x that array's per-lane element count;
// both the ScanArgs and the per-array counts (LaneStrides) ride in the
// kernel's parameters by value, so the launch uploads nothing. A lane's
// scratch is a cluster scan's (the shared rows, then MAX_CL CTAs' own
// rows). The carry is seeded per lane by the wrapper, as K1's is, and each
// lane's outputs are full take tables.
constexpr int LANE_ARRAYS = 53;  // 32 scan inputs, 16 carry fields, 5 outputs

struct LaneStrides {
  long long n[LANE_ARRAYS];  // per-lane elements, in the launcher's pointer order
};

template <typename Ptr>
__device__ __forceinline__ void to_lane(Ptr& p, long long b, long long n) { p += b * n; }

// the lane of this CTA: its cluster's index along x (every CTA of a
// cluster computes the same lane)
__device__ __forceinline__ long long lane_index() {
  return blockIdx.x / cg::this_cluster().num_blocks();
}

__device__ __forceinline__ void lane_prologue(ScanArgs& a, const LaneStrides& ls, long long b) {
  const long long* n = ls.n;
  to_lane(a.run_group, b, n[0]); to_lane(a.run_count, b, n[1]);
  to_lane(a.group_req, b, n[2]); to_lane(a.group_compat_t, b, n[3]);
  to_lane(a.group_zc_bits, b, n[4]); to_lane(a.group_pool, b, n[5]);
  to_lane(a.group_pair_nok, b, n[6]); to_lane(a.group_device, b, n[7]);
  to_lane(a.type_alloc, b, n[8]); to_lane(a.type_charge, b, n[9]);
  to_lane(a.offer_zc_bits, b, n[10]); to_lane(a.pool_type, b, n[11]);
  to_lane(a.pool_zc_bits, b, n[12]); to_lane(a.pool_daemon, b, n[13]);
  to_lane(a.pool_limit, b, n[14]); to_lane(a.node_free, b, n[15]);
  to_lane(a.node_compat, b, n[16]); to_lane(a.q_member, b, n[17]);
  to_lane(a.q_owner, b, n[18]); to_lane(a.q_kind, b, n[19]); to_lane(a.q_cap, b, n[20]);
  to_lane(a.v_member, b, n[21]); to_lane(a.v_owner, b, n[22]);
  to_lane(a.v_kind, b, n[23]); to_lane(a.v_cap, b, n[24]); to_lane(a.v_primary, b, n[25]);
  to_lane(a.v_aff, b, n[26]); to_lane(a.node_zone, b, n[27]);
  to_lane(a.zone_col_mask, b, n[28]); to_lane(a.node_dom2, b, n[29]);
  to_lane(a.col_axis, b, n[30]); to_lane(a.group_daxis, b, n[31]);
  to_lane(a.e_cum, b, n[32]); to_lane(a.c_cum, b, n[33]); to_lane(a.c_mask, b, n[34]);
  to_lane(a.c_zc_bits, b, n[35]); to_lane(a.c_gbits, b, n[36]); to_lane(a.c_pool, b, n[37]);
  to_lane(a.used, b, n[38]); to_lane(a.p_usage, b, n[39]); to_lane(a.e_cm, b, n[40]);
  to_lane(a.e_co, b, n[41]); to_lane(a.c_cm, b, n[42]); to_lane(a.c_co, b, n[43]);
  to_lane(a.v_count, b, n[44]); to_lane(a.v_owner_z, b, n[45]); to_lane(a.c_vm, b, n[46]);
  to_lane(a.c_vo, b, n[47]);
  to_lane(a.take_e, b, n[48]); to_lane(a.take_c, b, n[49]); to_lane(a.leftover, b, n[50]);
  to_lane(a.events, b, n[51]); to_lane(a.scratch, b, n[52]);
}

template <bool ZONE>
__global__ void __launch_bounds__(NTC, 1) ffd_lanes_kernel(ScanArgs a, LaneStrides ls) {
  lane_prologue(a, ls, lane_index());
  scan_body<ZONE, false, false, false, false>(a);
}

// ---- K17s: the sparse lanes of a mesh-sharded solve ----------------------------
//
// Replaces karpenter_tpu/solver/tpu/ffd.py:2800 ffd_solve_sharded_sparse:
// jax.vmap of the sparse scan over the [Nd, Sblk] run blocks of one solve,
// the index tables [Nd, Sblk, Kq] / [Nd, Sblk, Kv] blocked like the runs.
// (K17, the dense twin, is ffd_lanes_kernel itself: the wrapper gives
// every shared table a per-lane count of 0.)
// What bounds it: as K15, each lane is a serial chain of run steps; Nd
// lanes run on Nd clusters at once, each over Sblk = Sp / Nd runs.
// Design: K15's prologue, then the two index tables step by their own
// per-lane counts, then K1s's scan (scan_body<ZONE, false, false, false,
// true, true>), one cluster a lane as K15's. A kernel of its own, so that
// K15's two instances compile as they did.
struct SparseLaneStrides {
  LaneStrides base;
  long long q, v;  // per-lane elements of run_q_idx and run_v_idx
};

template <bool ZONE>
__global__ void __launch_bounds__(NTC, 1) ffd_lanes_sparse_kernel(ScanArgs a, SparseLaneStrides ls) {
  const long long b = lane_index();
  lane_prologue(a, ls.base, b);
  to_lane(a.run_q_idx, b, ls.q);
  to_lane(a.run_v_idx, b, ls.v);
  scan_body<ZONE, false, false, false, true>(a);
}
#endif  // FFD_LANES_ONLY

#ifdef FFD_BATCHED_ONLY
// K4: one subset row a cluster (its size chosen at launch: launch_batched),
// the row the cluster's index along x; MANY: the instance of the many-rows
// team, one CTA a row under launch bounds that fit two CTAs an SM.
template <bool ZONE, bool MANY>
__global__ void __launch_bounds__(NTC, MANY ? 2 : 1) ffd_batched_kernel(ScanArgs a) {
  const long long b = blockIdx.x / cg::this_cluster().num_blocks();
  batch_row_prologue(a, b);
  scan_body<ZONE, true, false, false, false>(a);
}
#endif  // FFD_BATCHED_ONLY

#ifdef FFD_MAIN_LIBRARY
// ---- K5: verdict pack --------------------------------------------------------
//
// Replaces karpenter_tpu/solver/tpu/consolidate.py:291 _pack_verdicts: per
// subset row [leftover total (int32, wrapping), used, c_zc_bits[M], c_mask
// [M, Tp] as ceil(Tp/32) uint32 words with bit i = type 32w + i], rows
// concatenated into one int32 buffer so a dispatch is one fetch.
// Bound on the H100: bytes — each row's leftovers, used, zc words and type
// mask are read once and 2 + M + M·W words written; the work is a sum and a
// bit pack. Design: one block per row, as K3's word pack; a warp reduction
// of the leftover total in unsigned (wrapping) arithmetic; one thread per
// output word of the type-mask pack.

constexpr int VT = 256;  // threads of the verdict pack

__global__ void __launch_bounds__(VT) pack_verdicts_kernel(
    const int* leftover, const int* used, const unsigned* c_zc, const unsigned char* c_mask,
    unsigned* out, int S, int M, int T) {
  __shared__ unsigned red[VT / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = (T + 31) / 32;
  unsigned* o = out + (size_t)b * (2 + M + M * W);
  unsigned sum = 0u;
  for (int i = tid; i < S; i += VT) sum += (unsigned)leftover[(size_t)b * S + i];
  for (int k = 16; k > 0; k >>= 1) sum += __shfl_xor_sync(FULL, sum, k);
  if ((tid & 31) == 0) red[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    unsigned t = 0u;
    for (int i = 0; i < VT / 32; ++i) t += red[i];
    o[0] = t;
    o[1] = (unsigned)used[b];
  }
  for (int m = tid; m < M; m += VT) o[2 + m] = c_zc[(size_t)b * M + m];
  const unsigned char* mask = c_mask + (size_t)b * M * T;
  for (int i = tid; i < M * W; i += VT) {
    const int m = i / W, t0 = (i % W) * 32;
    unsigned v = 0u;
    for (int j = 0; j < 32 && t0 + j < T; ++j)
      if (mask[(size_t)m * T + t0 + j]) v |= 1u << j;
    o[2 + M + i] = v;
  }
}

// ---- K2 + K3: the delta pack -------------------------------------------------
//
// Replaces karpenter_tpu/solver/backend.py:635 _pack_outputs_delta with the
// two programs it calls, karpenter_tpu/solver/tpu/ffd.py:325 compact_takes
// (K2) and :358 compact_claim_meta (K3, with the type-mask word pack of
// backend.py:652), and the concatenation: one launch writes the whole int32
// fetch buffer [overflow_t | overflow_u, n, n_u, cnt16 [Sp/2], pairs [cap],
// leftover [Sp], uniq [cap_u, Wt], mid16 [M/2], used], its scratch behind it
// in the same allocation (solver/cuda/ffd.py pack_delta_words).
// What bounds it on the H100: bytes — the [Sp, Ep + M] take grid and the
// [M, T] type mask read once, O(entries + claims x Wt) words written. The
// first-equal search makes one row compare a claim (more only where two
// unequal rows share a hash), not the M^2 / 2 of the row-equality matrix.
// Design: one thread-block cluster of CL CTAs of NT threads, CL chosen at
// launch from the bytes (ffd.pack_delta_cluster; wider where a CTA's claim
// rows would not fit its shared memory); each CTA owns a contiguous,
// even-sized share of the run rows and of the claim rows. The main path's
// shapes are small, so the design counts dependent round trips to L2: each
// phase issues its loads together, and the CTAs' totals travel by DSMEM
// stores before a barrier, not loads after it.
//  1. Take counts, a warp a run row: each lane keeps PU loads in flight; a
//     row's ballot words stay in shared memory (where they fit), its count
//     beside them, and the "> 65535" flag. Claim rows, a warp a claim: its
//     zc, group words and pool loaded with its type mask (T16, T % 16 == 0
//     as the encoder pads T: 16 bytes a lane, a warp 512 types a load,
//     lanes 2w and 2w + 1 joined into word w; else a ballot a word over
//     its 32 bytes); the row goes to the scratch with a 64-bit hash (HB
//     bits of it), the hash also to shared memory. The CTA clears its slice
//     of the hash table, copies leftover and used, and pushes its entry
//     count and flag into every CTA's shared memory.
//  Cluster barrier 1 (its release / acquire also orders the global writes).
//  2. The entries' bases from the pushed counts: n and the flag. The pairs
//     are scattered in run-major order from the saved ballots, 32 words at a
//     time (only the set cells' values are read again): where no word holds
//     more than RB set cells, each lane loads its word's at once; else PU of
//     the nonzero words at once, a lane a column. The tail of pairs zeroed,
//     cnt16 written. Each warp's claims go into
//     the open-addressed table, one insert a distinct hash (__match_any:
//     the lowest claim inserts, a 64-bit CAS, its slot keeping the lowest
//     claim of that hash by atomicMin; the others take its slot).
//  Cluster barrier 2.
//  3. A claim's first equal row, a thread a claim: the slot's lowest claim
//     where its row is equal (equal rows share the hash, so that row is the
//     lowest equal one); else its warp walks the lower claims of the same
//     hash in index order, comparing whole rows up to the first equal one
//     (it ends at the claim itself at the latest: a collision costs time,
//     never a result; ties go to the lowest index, as argmax). The
//     representatives are ranked by a CTA scan and listed in order in
//     shared memory; the ranks go to the scratch, the CTA's total into
//     every CTA's shared memory.
//  Cluster barrier 3.
//  4. The ranks' bases from the pushed totals: uniq rows copied a thread a
//     word and the table's tail zeroed, mid16 = the rank of each claim's
//     first equal row (another CTA's from the scratch), and the header.
//     Reads of what other CTAs wrote go through L2 (__ldcg).
// HB = 2 keeps two bits of the hash, so hash groups hold unequal rows and
// the walk runs: an instance that only chip_smoke.py launches, to hold the
// walk against the plain version on the card; the main path's is HB = 64.

constexpr int PU = 8;                              // take-grid loads in flight a lane
constexpr int UW = 16;                             // type-mask words a lane loads at once (bytes)
constexpr int UC = 2;                              // 512-type chunks a lane loads at once (T16)
constexpr int RB = 4;                              // set cells of a sparse word a lane loads at once
constexpr unsigned long long EMPTY_KEY = ~0ull;    // a free slot of the hash table
constexpr int PACK_SMEM = 200 * 1024;              // the launch's dynamic shared memory, at most

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// word w of a claim row holding v: its term of the row's hash (a sum)
__device__ __forceinline__ unsigned long long word_hash(int w, unsigned v) {
  return mix64(((unsigned long long)(unsigned)w << 32) | v);
}

// the byte-nonzero bits of x: bit k set where byte k of x is not 0
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  const unsigned m = __vcmpne4(x, 0u) & 0x01010101u;
  return ((m * 0x00204081u) >> 21) & 0xFu;
}

// The type-mask words of one claim row `mk` (T mask bytes), by one warp;
// lane w % 32 calls put(w, word) for word w. T16 (T % 16 == 0, the rows
// 16-byte aligned): each lane loads 16 bytes, a warp 512 types a load, UC
// loads at once, and word w of a 512-type chunk joins lanes 2w and 2w + 1's
// 16 bits; else word w is one ballot over its 32 bytes, UW words' bytes
// loaded at once.
template <typename F>
__device__ __forceinline__ void type_words(const unsigned char* mk, int T, int Wm, bool t16,
                                           int lane, F put) {
  if (t16) {
    const uint4* mk4 = (const uint4*)mk;
    const int nq = T / 16;
    for (int c0 = 0; c0 < nq; c0 += 32 * UC) {
      uint4 x[UC];
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int q = c0 + 32 * u + lane;
        x[u] = q < nq ? __ldg(mk4 + q) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const unsigned bits = byte_bits(x[u].x) | (byte_bits(x[u].y) << 4) |
                              (byte_bits(x[u].z) << 8) | (byte_bits(x[u].w) << 12);
        const unsigned lo = __shfl_sync(FULL, bits, (2 * lane) & 31);
        const unsigned hi = __shfl_sync(FULL, bits, (2 * lane + 1) & 31);
        const int w = (c0 + 32 * u) / 2 + lane;
        if (lane < 16 && w < Wm) put(w, lo | (hi << 16));
      }
    }
    return;
  }
  for (int w0 = 0; w0 < Wm; w0 += UW) {
    unsigned char b[UW];
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const int t = (w0 + u) * 32 + lane;
      b[u] = (w0 + u < Wm && t < T) ? __ldg(mk + t) : (unsigned char)0;
    }
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const unsigned word = __ballot_sync(FULL, b[u] != 0);
      if (w0 + u < Wm && lane == ((w0 + u) & 31)) put(w0 + u, word);
    }
  }
}

// two claim rows of the scratch equal in every word (one warp)
__device__ __forceinline__ bool rows_equal(const unsigned* x, const unsigned* y, int Wt,
                                           int lane) {
  bool ne = false;
  for (int w = lane; w < Wt; w += 32) ne |= __ldcg(x + w) != __ldcg(y + w);
  return !__any_sync(FULL, ne);
}

// two claim rows of the scratch equal in every word (one thread)
__device__ __forceinline__ bool rows_equal1(const unsigned* x, const unsigned* y, int Wt) {
  bool eq = true;
  for (int w0 = 0; w0 < Wt; w0 += 4) {
    unsigned a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = w0 + u < Wt ? __ldcg(x + w0 + u) : 0u;
      b[u] = w0 + u < Wt ? __ldcg(y + w0 + u) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) eq &= a[u] == b[u];
  }
  return eq;
}

// inclusive sum over the warp's lanes
__device__ __forceinline__ int warp_incl(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// the take grid's cell (s, c), c over [0, Ep + M)
__device__ __forceinline__ int take_at(const int* te, const int* tc, int c, int Ep) {
  return c < Ep ? __ldg(te + c) : __ldg(tc + (c - Ep));
}

struct PackArgs {
  const int* take_e;            // [Sp, Ep]
  const int* take_c;            // [Sp, M]
  const int* leftover;          // [Sp]
  const unsigned char* c_mask;  // [M, T] bool
  const unsigned* c_zc;         // [M]
  const unsigned* c_gbits;      // [M, W]
  const int* c_pool;            // [M]
  const int* used;              // scalar
  int* out;                     // the fetch buffer
  // scratch, behind the buffer in the same allocation
  unsigned* meta;               // [M, Wt] claim rows
  unsigned long long* hash;     // [M]
  unsigned long long* tkey;     // [S] the hash table's keys
  int* thead;                   // [S] a slot's lowest claim
  int* rank;                    // [M] a representative's rank within its CTA
  int Sp, Ep, M, T, W, Wm, Wt, cap, cap_u, S, rows_c, claims_c, stash, t16;
};

// word w >= Wm of claim m's row: zc, then the group words, then the pool
__device__ __forceinline__ unsigned tail_word(const PackArgs& a, int m, int w) {
  if (w == a.Wm) return __ldg(a.c_zc + m);
  if (w == a.Wt - 1) return (unsigned)__ldg(a.c_pool + m);
  return __ldg(a.c_gbits + (size_t)m * a.W + (w - a.Wm - 1));
}

// a CTA's shared rows (dynamic): its claims' hashes, slots (then the list of
// its representatives), first equal rows and ranks, its run rows' counts
// (then offsets) and, where they fit, their ballot words
struct PackShared {
  unsigned long long* hash;  // [claims_c]
  int* slot;                 // [claims_c]
  int* first;                // [claims_c]
  int* lrank;                // [claims_c] representative flags, then ranks within the CTA
  int* rowcnt;               // [rows_c]
  unsigned* stash;           // [rows_c, NWd]
  __device__ PackShared(const PackArgs& a) {
    hash = (unsigned long long*)scan_rows;
    slot = (int*)(hash + a.claims_c);
    first = slot + a.claims_c;
    lrank = first + a.claims_c;
    rowcnt = lrank + a.claims_c;
    stash = (unsigned*)(rowcnt + a.rows_c);
  }
};

template <int HB>
__global__ void __launch_bounds__(NT, 1) pack_delta_kernel(PackArgs a) {
  __shared__ unsigned ured[NWARPS];
  __shared__ int over_any;       // this CTA's "> 65535" flag
  __shared__ int ttot[MAX_CL][2];  // each CTA's entries and flag, pushed here by that CTA
  __shared__ int rtot[MAX_CL];   // each CTA's representatives, pushed here by that CTA
  __shared__ int sc[4];          // entries before this CTA, n, the flag, n_u
  __shared__ int rbase[MAX_CL];  // representatives before each CTA
  cg::cluster_group clu = cg::this_cluster();
  const int rk = (int)clu.block_rank(), ncl = (int)clu.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int Ep = a.Ep, M = a.M, K = Ep + M, NWd = (K + 31) / 32, Wt = a.Wt;
  const int r0 = min(rk * a.rows_c, a.Sp), r1 = min(r0 + a.rows_c, a.Sp);
  const int m0 = min(rk * a.claims_c, M), m1 = min(m0 + a.claims_c, M), nm = m1 - m0;
  const PackShared sh(a);
  int* out = a.out;
  const long long o_cnt = 3, o_pairs = o_cnt + a.Sp / 2, o_left = o_pairs + a.cap;
  const long long o_uniq = o_left + a.Sp, o_mid = o_uniq + (long long)a.cap_u * Wt;
  const long long o_used = o_mid + M / 2;
  if (tid == 0) over_any = 0;
  __syncthreads();

  // 1. take counts, a warp a run row
  bool over = false;
  for (int s = r0 + wid; s < r1; s += NWARPS) {
    const int* te = a.take_e + (size_t)s * Ep;
    const int* tc = a.take_c + (size_t)s * M;
    unsigned* sw = sh.stash + (size_t)(s - r0) * NWd;
    int cnt = 0;
    for (int q0 = 0; q0 < NWd; q0 += PU) {
      int v[PU];
#pragma unroll
      for (int u = 0; u < PU; ++u) {
        const int c = (q0 + u) * 32 + lane;
        v[u] = c < K ? take_at(te, tc, c, Ep) : 0;
      }
#pragma unroll
      for (int u = 0; u < PU; ++u) {
        over |= v[u] > 65535;
        const unsigned b = __ballot_sync(FULL, v[u] > 0);
        cnt += __popc(b);
        if (a.stash && lane == 0 && q0 + u < NWd) sw[q0 + u] = b;
      }
    }
    if (lane == 0) sh.rowcnt[s - r0] = cnt;
  }
  if (over) over_any = 1;

  // claim rows and their hashes, a warp a claim
  for (int m = m0 + wid; m < m1; m += NWARPS) {
    unsigned* row = a.meta + (size_t)m * Wt;
    unsigned long long h = 0;
    // the tail words (zc, the group words, the pool), loaded before the mask's
    const int w0 = a.Wm + lane, w1 = w0 + 32;
    const unsigned t0 = w0 < Wt ? tail_word(a, m, w0) : 0u;
    const unsigned t1 = w1 < Wt ? tail_word(a, m, w1) : 0u;
    type_words(a.c_mask + (size_t)m * a.T, a.T, a.Wm, a.t16, lane, [&](int w, unsigned v) {
      row[w] = v;
      h += word_hash(w, v);
    });
    for (int w = w0; w < Wt; w += 32) {
      const unsigned v = w == w0 ? t0 : w == w1 ? t1 : tail_word(a, m, w);
      row[w] = v;
      h += word_hash(w, v);
    }
    for (int o = 16; o > 0; o >>= 1) h += __shfl_xor_sync(FULL, h, o);
    if constexpr (HB < 64) h &= (1ull << HB) - 1ull;
    if (h == EMPTY_KEY) h = 0ull;
    if (lane == 0) {
      a.hash[m] = h;
      sh.hash[m - m0] = h;
    }
  }

  // this CTA's slice of the hash table; leftover and used
  const int t_lo = (int)((long long)a.S * rk / ncl), t_hi = (int)((long long)a.S * (rk + 1) / ncl);
  for (int i = t_lo + tid; i < t_hi; i += NT) {
    a.tkey[i] = EMPTY_KEY;
    a.thead[i] = I32MAX;
  }
  for (int s = r0 + tid; s < r1; s += NT) out[o_left + s] = __ldg(a.leftover + s);
  if (rk == 0 && tid == 0) out[o_used] = __ldg(a.used);
  __syncthreads();
  for (int i = (r0 >> 1) + tid; i < (r1 >> 1); i += NT)
    out[o_cnt + i] = (int)(((unsigned)sh.rowcnt[2 * i - r0] & 0xffffu) |
                           (((unsigned)sh.rowcnt[2 * i + 1 - r0] & 0xffffu) << 16));
  __syncthreads();
  const unsigned rows_total = block_exclusive_scan(sh.rowcnt, sh.rowcnt, r1 - r0, ured);
  if (wid == 0 && lane < ncl) {  // into every CTA's slot rk, over DSMEM
    int* pt = peer(&ttot[rk][0], lane);
    pt[0] = (int)rows_total;
    pt[1] = over_any;
  }
  cluster_barrier();

  // 2. the entries' bases from the pushed totals, the pairs scattered
  if (wid == 0) {
    const int t = lane < ncl ? ttot[lane][0] : 0, f = lane < ncl ? ttot[lane][1] : 0;
    const int x = warp_incl(t, lane);
    const int before = __shfl_sync(FULL, x - t, rk);
    const int n_all = __shfl_sync(FULL, x, 31);
    const int flag = __any_sync(FULL, f != 0);
    if (lane == 0) {
      sc[0] = before;
      sc[1] = n_all;
      sc[2] = flag;
    }
  }
  __syncthreads();
  const int n = sc[1];
  const unsigned lt = (1u << lane) - 1u;
  for (int s = r0 + wid; s < r1; s += NWARPS) {
    const int* te = a.take_e + (size_t)s * Ep;
    const int* tc = a.take_c + (size_t)s * M;
    const unsigned* sw = sh.stash + (size_t)(s - r0) * NWd;
    int base = sc[0] + sh.rowcnt[s - r0];
    for (int q0 = 0; q0 < NWd; q0 += 32) {  // 32 ballot words, a lane a word
      unsigned b = 0u;
      if (a.stash) {
        if (q0 + lane < NWd) b = sw[q0 + lane];
      } else {
        for (int u = 0; u < 32 && q0 + u < NWd; ++u) {
          const int c = (q0 + u) * 32 + lane;
          const unsigned w = __ballot_sync(FULL, c < K && take_at(te, tc, c, Ep) > 0);
          if (lane == u) b = w;
        }
      }
      const int cnt = __popc(b);
      const int x = warp_incl(cnt, lane);
      const int pos0 = base + x - cnt;
      if (__reduce_max_sync(FULL, (unsigned)cnt) <= (unsigned)RB) {
        // sparse words: each lane loads its word's set cells at once
        int c[RB], v[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          c[u] = -1;
          if (b) {
            c[u] = (q0 + lane) * 32 + __ffs(b) - 1;
            b &= b - 1u;
            v[u] = take_at(te, tc, c[u], Ep);
          }
        }
#pragma unroll
        for (int u = 0; u < RB; ++u)
          if (c[u] >= 0 && pos0 + u < a.cap)
            out[o_pairs + pos0 + u] =
                (int)(((unsigned)c[u] & 0xffffu) | (((unsigned)v[u] & 0xffffu) << 16));
      } else {
        // dense words: PU of the nonzero words at once, a lane a column
        unsigned nz = __ballot_sync(FULL, b != 0u);
        while (nz) {
          int wq[PU], v[PU];
          unsigned bq[PU];
#pragma unroll
          for (int u = 0; u < PU; ++u) {
            wq[u] = nz ? __ffs(nz) - 1 : -1;
            if (nz) nz &= nz - 1u;
            bq[u] = __shfl_sync(FULL, b, wq[u] < 0 ? 0 : wq[u]);
            if (wq[u] < 0) bq[u] = 0u;
            v[u] = (bq[u] >> lane) & 1u ? take_at(te, tc, (q0 + wq[u]) * 32 + lane, Ep) : 0;
          }
#pragma unroll
          for (int u = 0; u < PU; ++u) {
            const int p0 = __shfl_sync(FULL, pos0, wq[u] < 0 ? 0 : wq[u]);
            const int pos = p0 + __popc(bq[u] & lt);
            if ((bq[u] >> lane) & 1u && pos < a.cap)
              out[o_pairs + pos] = (int)(((unsigned)((q0 + wq[u]) * 32 + lane) & 0xffffu) |
                                         (((unsigned)v[u] & 0xffffu) << 16));
          }
        }
      }
      base += __shfl_sync(FULL, x, 31);
    }
  }
  for (long long i = (long long)n + (long long)rk * NT + tid; i < a.cap; i += (long long)ncl * NT)
    out[o_pairs + i] = 0;

  // the claims' hashes into the table: the lowest claim of each hash a warp
  // holds inserts it (the lanes' claims ascend), the others take its slot
  for (int i0 = wid * 32; i0 < nm; i0 += NT) {
    const int i = i0 + lane;
    const unsigned long long h = i < nm ? sh.hash[i] : EMPTY_KEY;
    const unsigned grp = __match_any_sync(FULL, h);
    const int lead = __ffs(grp) - 1;
    unsigned sl = 0u;
    if (i < nm && lane == lead) {
      sl = (unsigned)mix64(h) & (unsigned)(a.S - 1);
      for (;;) {
        const unsigned long long prev = atomicCAS(a.tkey + sl, EMPTY_KEY, h);
        if (prev == EMPTY_KEY || prev == h) break;
        sl = (sl + 1u) & (unsigned)(a.S - 1);
      }
      atomicMin(a.thead + sl, m0 + i);
    }
    sl = __shfl_sync(FULL, sl, lead);
    if (i < nm) sh.slot[i] = (int)sl;
  }
  cluster_barrier();

  // 3. each claim's first equal row: a thread a claim against its slot's
  // lowest claim; a warp walks the hash group of a claim that differs
  for (int i0 = wid * 32; i0 < nm; i0 += NT) {
    const int i = i0 + lane, m = m0 + i;
    bool walk = false;
    if (i < nm) {
      const int hd = __ldcg(a.thead + sh.slot[i]);
      int f = m;
      if (hd < m) {
        if (rows_equal1(a.meta + (size_t)hd * Wt, a.meta + (size_t)m * Wt, Wt)) f = hd;
        else walk = true;
      }
      sh.first[i] = walk ? hd : f;  // a walk starts past the slot's lowest claim
    }
    __syncwarp();
    unsigned todo = __ballot_sync(FULL, walk);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int mi = m0 + i0 + j;
      const unsigned* row = a.meta + (size_t)mi * Wt;
      const unsigned long long h = sh.hash[i0 + j];
      int f = mi;
      for (int k0 = sh.first[i0 + j] + 1; k0 < mi && f == mi; k0 += 32) {
        const int k = k0 + lane;
        unsigned bk = __ballot_sync(FULL, k < mi && __ldcg(a.hash + k) == h);
        while (bk) {
          const int jj = __ffs(bk) - 1;
          bk &= bk - 1u;
          if (rows_equal(a.meta + (size_t)(k0 + jj) * Wt, row, Wt, lane)) {
            f = k0 + jj;
            break;
          }
        }
      }
      if (lane == 0) sh.first[i0 + j] = f;
    }
  }
  __syncthreads();
  for (int i = tid; i < nm; i += NT) sh.lrank[i] = sh.first[i] == m0 + i ? 1 : 0;
  __syncthreads();
  const unsigned reps = block_exclusive_scan(sh.lrank, sh.lrank, nm, ured);
  for (int i = tid; i < nm; i += NT) {
    a.rank[m0 + i] = sh.lrank[i];
    if (sh.first[i] == m0 + i) sh.slot[sh.lrank[i]] = m0 + i;  // the representatives in order
  }
  if (wid == 0 && lane < ncl) *peer(&rtot[rk], lane) = (int)reps;
  cluster_barrier();

  // 4. the ranks' bases; uniq, mid16 and the header
  if (wid == 0) {
    const int t = lane < ncl ? rtot[lane] : 0;
    const int x = warp_incl(t, lane);
    if (lane < ncl) rbase[lane] = x - t;
    const int n_u = __shfl_sync(FULL, x, 31);
    if (lane == 0) sc[3] = n_u;
  }
  __syncthreads();
  const int n_u = sc[3], ubase = rbase[rk];
  const int nrep = min((int)reps, max(0, a.cap_u - ubase));
  for (long long i = tid; i < (long long)nrep * Wt; i += NT) {
    const int r = (int)(i / Wt), w = (int)(i % Wt);
    out[o_uniq + (long long)(ubase + r) * Wt + w] = (int)__ldcg(a.meta + (size_t)sh.slot[r] * Wt + w);
  }
  for (long long i = (long long)n_u * Wt + (long long)rk * NT + tid; i < (long long)a.cap_u * Wt;
       i += (long long)ncl * NT)
    out[o_uniq + i] = 0;
  for (int i = tid; i < (nm >> 1); i += NT) {
    unsigned r2[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = sh.first[2 * i + u], cf = f / a.claims_c;
      r2[u] = (unsigned)(rbase[cf] + (cf == rk ? sh.lrank[f - m0] : __ldcg(a.rank + f))) & 0xffffu;
    }
    out[o_mid + (m0 >> 1) + i] = (int)(r2[0] | (r2[1] << 16));
  }
  if (rk == 0 && tid == 0) {
    out[0] = (sc[2] || n > a.cap || n_u > a.cap_u) ? 1 : 0;
    out[1] = n;
    out[2] = n_u;
  }
}

// The wide re-fetch's type-mask words (karpenter_tpu/solver/backend.py:569
// _pack_outputs_wide): the delta pack's word stage alone, a warp a claim
// row, out [M, Wm]. Bound: bytes (the [M, T] mask read once).
__global__ void __launch_bounds__(256) mask_words_kernel(const unsigned char* c_mask,
                                                         unsigned* out, int M, int T, int Wm,
                                                         int t16) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= M) return;
  unsigned* row = out + (size_t)m * Wm;
  type_words(c_mask + (size_t)m * T, T, Wm, t16, threadIdx.x & 31,
             [&](int w, unsigned v) { row[w] = v; });
}

// ---- K9: the dense output pack ------------------------------------------------
//
// Replaces karpenter_tpu/solver/backend.py:511 _pack_outputs: every output
// the host decodes, flattened into ONE int32 buffer — [overflow flag,
// take_e as uint16 pairs, take_c as uint16 pairs (each padded to an even
// count), leftover [S], c_mask [M, T] as ceil(T/32) uint32 words per row
// (bit i of word w = type 32w + i), c_zc_bits [M], c_gbits [M, Wg], c_pool
// [M], c_cum [M, R], used] — the wire of TorchSolver(device_decode=False)
// and of shapes past the uint16 delta coding. The flag is set when a take
// exceeds 65535 (the host then re-fetches wide).
// What bounds it on the H100: bytes — each input read once, about half as
// many words written for the take grids; no arithmetic to speak of.
// Design: one thread per output word over a grid-stride loop (the word's
// region found from the offsets), the flag zeroed by the launcher and OR-ed
// in once per block.

constexpr int PT = 256;  // threads of the output pack

__device__ __forceinline__ unsigned take_pair(const int* x, long long n, long long j, int& over) {
  const long long i = 2 * j;
  const int lo = x[i], hi = i + 1 < n ? x[i + 1] : 0;
  over |= (lo > 65535) | (hi > 65535);
  return ((unsigned)lo & 0xFFFFu) | (((unsigned)hi & 0xFFFFu) << 16);
}

__global__ void __launch_bounds__(PT) pack_outputs_kernel(
    const int* take_e, const int* take_c, const int* leftover, const unsigned char* c_mask,
    const unsigned* c_zc, const unsigned* c_gbits, const int* c_pool, const int* c_cum,
    const int* used, unsigned* out, int S, int E, int M, int T, int Wg, int R) {
  const long long ne = (long long)S * E, nc = (long long)S * M;
  const int W = (T + 31) / 32;
  const long long o_c = 1 + (ne + 1) / 2, o_lo = o_c + (nc + 1) / 2, o_cm = o_lo + S;
  const long long o_zc = o_cm + (long long)M * W, o_gb = o_zc + M, o_pool = o_gb + (long long)M * Wg;
  const long long o_cum = o_pool + M, o_used = o_cum + (long long)M * R, total = o_used + 1;
  int over = 0;
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x + 1; i < total;
       i += (long long)gridDim.x * PT) {
    unsigned v;
    if (i < o_c) {
      v = take_pair(take_e, ne, i - 1, over);
    } else if (i < o_lo) {
      v = take_pair(take_c, nc, i - o_c, over);
    } else if (i < o_cm) {
      v = (unsigned)leftover[i - o_lo];
    } else if (i < o_zc) {
      const long long m = (i - o_cm) / W;
      const int w = (int)((i - o_cm) % W);
      const unsigned char* row = c_mask + m * T;
      v = 0u;
      for (int b = 0; b < 32 && w * 32 + b < T; ++b) v |= (row[w * 32 + b] != 0 ? 1u : 0u) << b;
    } else if (i < o_gb) {
      v = c_zc[i - o_zc];
    } else if (i < o_pool) {
      v = c_gbits[i - o_gb];
    } else if (i < o_cum) {
      v = (unsigned)c_pool[i - o_pool];
    } else if (i < o_used) {
      v = (unsigned)c_cum[i - o_cum];
    } else {
      v = (unsigned)*used;
    }
    out[i] = v;
  }
  if (__syncthreads_or(over) && threadIdx.x == 0) atomicOr(out, 1u);
}

// ---- checks of the cluster scans' building blocks -----------------------------
//
// floordiv_magic (the scans' division by the run's request) against each
// divisor, one thread a (divisor, numerator) pair: out[j, i] =
// floor(num[i] / den[j]), den[j] >= 1; and a loop of cluster barriers on one
// cluster, whose time over the count is one barrier's cost. Neither replaces
// a TPU kernel: chip_smoke.py holds the first against the plain floor and
// times the second (the scan's serial floor, PERF.md).

__global__ void floordiv_check_kernel(const int* num, const int* den, int* out, int N, int D) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)N * D) return;
  const int j = (int)(k / N), i = (int)(k % N);
  unsigned m;
  int sh;
  magic_of(den[j], m, sh);
  out[k] = floordiv_magic(num[i], m, sh);
}

__global__ void __launch_bounds__(NTC) cluster_barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) cluster_barrier();
}

#endif  // FFD_MAIN_LIBRARY

}  // namespace

// The scan's 32 input arrays (ARG_SPEC order without pool_usage0,
// node_q_member, node_q_owner and v_count0, which seed the carry) from p[0..31]
// and the dims S, G, T, E, P, R, Q, W, M, V, Z from d[0..10].
static void fill_scan_inputs(ScanArgs& a, void** p, const int* d) {
  a.run_group = (const int*)p[0]; a.run_count = (const int*)p[1];
  a.group_req = (const int*)p[2]; a.group_compat_t = (const unsigned char*)p[3];
  a.group_zc_bits = (const unsigned*)p[4]; a.group_pool = (const unsigned char*)p[5];
  a.group_pair_nok = (const unsigned*)p[6]; a.group_device = (const unsigned char*)p[7];
  a.type_alloc = (const int*)p[8]; a.type_charge = (const int*)p[9];
  a.offer_zc_bits = (const unsigned*)p[10]; a.pool_type = (const unsigned char*)p[11];
  a.pool_zc_bits = (const unsigned*)p[12]; a.pool_daemon = (const int*)p[13];
  a.pool_limit = (const int*)p[14]; a.node_free = (const int*)p[15];
  a.node_compat = (const unsigned char*)p[16]; a.q_member = (const unsigned char*)p[17];
  a.q_owner = (const unsigned char*)p[18]; a.q_kind = (const int*)p[19]; a.q_cap = (const int*)p[20];
  a.v_member = (const unsigned char*)p[21]; a.v_owner = (const unsigned char*)p[22];
  a.v_kind = (const int*)p[23]; a.v_cap = (const int*)p[24]; a.v_primary = (const int*)p[25];
  a.v_aff = (const int*)p[26]; a.node_zone = (const int*)p[27];
  a.zone_col_mask = (const unsigned*)p[28]; a.node_dom2 = (const int*)p[29];
  a.col_axis = (const int*)p[30]; a.group_daxis = (const int*)p[31];
  a.S = d[0]; a.G = d[1]; a.T = d[2]; a.E = d[3]; a.P = d[4]; a.R = d[5]; a.Q = d[6];
  a.W = d[7]; a.M = d[8]; a.V = d[9]; a.Z = d[10];
}

// The carry (FFDState order) from p[0..15].
static void fill_scan_state(ScanArgs& a, void** p) {
  a.e_cum = (int*)p[0]; a.c_cum = (int*)p[1]; a.c_mask = (unsigned char*)p[2];
  a.c_zc_bits = (unsigned*)p[3]; a.c_gbits = (unsigned*)p[4]; a.c_pool = (int*)p[5];
  a.used = (int*)p[6]; a.p_usage = (int*)p[7]; a.e_cm = (int*)p[8]; a.e_co = (int*)p[9];
  a.c_cm = (int*)p[10]; a.c_co = (int*)p[11]; a.v_count = (int*)p[12];
  a.v_owner_z = (unsigned char*)p[13]; a.c_vm = (int*)p[14]; a.c_vo = (unsigned char*)p[15];
}

static bool scan_limits_ok(const ScanArgs& a, bool zone) {
  if (a.R > MAX_R) return false;
  return !(zone && (a.Z > MAX_Z || a.Z < 1 || a.V < 1 || a.P > MAX_P));
}

// The dynamic shared memory opt-in of `kern` on the current device, raised
// to `dyn` bytes when that is past the widest launch on this device so far
// (opted[device]). cudaFuncSetAttribute holds per device, so the cache is
// per device: a process-wide one would skip the call on a second card and
// its launch past 48 KB would be refused. Returns 0 or a CUDA error.
constexpr int MAX_DEVICES = 64;

template <typename K>
static int opt_in(K kern, int dyn, int* opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (dyn > opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = dyn;
  }
  return 0;
}

// The bytes of launch-sized rows (scan_rows_bytes) a launch of `kern`
// holds: the card's opt-in shared memory per block less the kernel's
// static share. Negative: a CUDA error.
template <typename K>
static int rows_budget(K kern) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes at{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, kern);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)at.sharedSizeBytes;
}

// The least of several budgets, or the first CUDA error (negative).
static int least_budget(std::initializer_list<int> budgets) {
  int best = 0x7fffffff;
  for (int b : budgets) {
    if (b < 0) return b;
    best = std::min(best, b);
  }
  return best;
}

// ---- the cluster launch (K1, K6, K7 and their sparse twins) ------------------
//
// One cluster of CL CTAs a solve: CL = 16 where the device allows the
// non-portable size and the occupancy query fits one such cluster at the
// instance's widest launch (its whole row budget of dynamic shared memory),
// else 8. Chosen once per device and instance, with the dynamic shared
// memory opt-in raised to that budget; a launch the device refuses returns
// its error, and no other launch is tried.
struct ClusterPick {
  int cl, fit16, fit8;  // the cluster size; clusters of 16 / of 8 the device holds at once
};

template <bool ZONE, bool LADDER, bool CKPT, bool SPARSE>
static ClusterPick* cluster_picks() {
  static ClusterPick picks[MAX_DEVICES] = {};
  return picks;
}

// the cluster kernel of an instance: ffd_ladder_kernel for K6 / K6s,
// ffd_cluster_kernel for K1 / K7 and their sparse twins
template <bool ZONE, bool LADDER, bool CKPT, bool SPARSE>
static auto cluster_kernel() {
  if constexpr (LADDER) return ffd_ladder_kernel<ZONE, SPARSE>;
  else return ffd_cluster_kernel<ZONE, CKPT, SPARSE>;
}

template <typename K>
static cudaError_t cluster_fit(K kern, int cl, int dyn, int* fit) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NTC, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
}

template <typename K>
static int pick_cluster(K kern, ClusterPick* picks, int& dev) {
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  ClusterPick& pk = picks[dev];
  if (pk.cl) return 0;
  const int dyn = rows_budget(kern);
  if (dyn < 0) return -dyn;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  int f16 = 0, f8 = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
      cluster_fit(kern, 16, dyn, &f16) != cudaSuccess)
    f16 = 0;
  (void)cudaGetLastError();  // a refused size-16 query is an answer, not a fault
  e = cluster_fit(kern, 8, dyn, &f8);
  if (e != cudaSuccess) return (int)e;
  if (f16 < 1 && f8 < 1) return (int)cudaErrorInvalidConfiguration;
  pk.fit16 = f16;
  pk.fit8 = f8;
  pk.cl = f16 >= 1 ? 16 : 8;
  return 0;
}

template <bool ZONE, bool LADDER, bool CKPT, bool SPARSE>
static int launch_cluster(const ScanArgs& a, void* stream) {
  auto kern = cluster_kernel<ZONE, LADDER, CKPT, SPARSE>();
  ClusterPick* picks = cluster_picks<ZONE, LADDER, CKPT, SPARSE>();
  int dev = 0;
  const int err = pick_cluster(kern, picks, dev);
  if (err != 0) return err;
  const int cl = picks[dev].cl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NTC, 1, 1);
  cfg.dynamicSmemBytes = scan_rows_bytes(a.Q, SPARSE ? a.Kq : 0, a.V, SPARSE ? a.Kv : 0, ZONE);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0..2]: the instance's cluster size and the clusters of 16 / of 8 the
// device holds at once (picking them on first use)
template <bool ZONE, bool LADDER, bool CKPT, bool SPARSE>
static int cluster_info(int* out) {
  ClusterPick* picks = cluster_picks<ZONE, LADDER, CKPT, SPARSE>();
  int dev = 0;
  const int err = pick_cluster(cluster_kernel<ZONE, LADDER, CKPT, SPARSE>(), picks, dev);
  if (err != 0) return err;
  out[0] = picks[dev].cl;
  out[1] = picks[dev].fit16;
  out[2] = picks[dev].fit8;
  return 0;
}

// The six cluster instances of a library (SPARSE: the sparse one): K1
// fast, K1 zoned, K7 fast, K7 zoned, K6 fast, K6 zoned, three ints each
// into out[0..17].
template <bool SPARSE>
static int clusters_info(int* out) {
  int e = cluster_info<false, false, false, SPARSE>(out);
  if (e == 0) e = cluster_info<true, false, false, SPARSE>(out + 3);
  if (e == 0) e = cluster_info<false, false, true, SPARSE>(out + 6);
  if (e == 0) e = cluster_info<true, false, true, SPARSE>(out + 9);
  if (e == 0) e = cluster_info<false, true, false, SPARSE>(out + 12);
  if (e == 0) e = cluster_info<true, true, false, SPARSE>(out + 15);
  return e;
}

#ifdef FFD_LANES_ONLY
// ---- the lanes launch (K15, K17, K17s) --------------------------------------------
//
// One launch a dispatch: B lanes, one cluster of CL CTAs a lane. The
// clusters of 16, 8, 4 and 2 CTAs the device holds at once at the
// instance's widest launch (its whole row budget of dynamic shared memory,
// the occupancy query of pick_cluster) are queried once per device and
// instance, with the dynamic shared memory opt-in raised to that budget.
// Each launch then takes the largest CL whose clusters the device holds
// all B at once; past every size, the smallest size it holds at all (CL 2
// on an H100), and the lanes run in waves. solver/cuda/ffd.py lanes_cluster
// mirrors the rule. A launch the device refuses returns its error, and no
// other launch is tried.
constexpr int LANE_SIZES = 4;
constexpr int LANE_CL[LANE_SIZES] = {16, 8, 4, 2};

struct LanesFit {
  int fit[LANE_SIZES];  // clusters of LANE_CL[i] CTAs the device holds at once
  bool done;
};

// this library's lanes kernel: the sparse one in ffd_lanes_sparse_kernels.cu
#ifdef FFD_LANES_SPARSE
constexpr bool LANES_SPARSE = true;
template <bool ZONE>
static auto lanes_kernel() { return ffd_lanes_sparse_kernel<ZONE>; }
#else
constexpr bool LANES_SPARSE = false;
template <bool ZONE>
static auto lanes_kernel() { return ffd_lanes_kernel<ZONE>; }
#endif

template <bool ZONE>
static LanesFit* lanes_fits() {
  static LanesFit fits[MAX_DEVICES] = {};
  return fits;
}

// the instance's fits on the current device (queried on first use)
template <bool ZONE>
static int lanes_fit(const LanesFit*& out) {
  auto kern = lanes_kernel<ZONE>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  LanesFit& lf = lanes_fits<ZONE>()[dev];
  out = &lf;
  if (lf.done) return 0;
  const int dyn = rows_budget(kern);
  if (dyn < 0) return -dyn;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  int held = 0;
  for (int i = 0; i < LANE_SIZES; ++i) {
    int f = 0;
    if (LANE_CL[i] > 8) {
      // the non-portable size: a refused attribute or query is an answer, not a fault
      if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
          cluster_fit(kern, LANE_CL[i], dyn, &f) != cudaSuccess)
        f = 0;
      (void)cudaGetLastError();
    } else {
      e = cluster_fit(kern, LANE_CL[i], dyn, &f);
      if (e != cudaSuccess) return (int)e;
    }
    lf.fit[i] = f;
    held += f > 0;
  }
  if (held == 0) return (int)cudaErrorInvalidConfiguration;
  lf.done = true;
  return 0;
}

// the cluster size a launch of B lanes takes (0: the device holds none)
static int lanes_cl(int B, const int* fit) {
  for (int i = 0; i < LANE_SIZES; ++i)
    if (fit[i] >= B) return LANE_CL[i];
  for (int i = LANE_SIZES - 1; i >= 0; --i)
    if (fit[i] >= 1) return LANE_CL[i];
  return 0;
}

template <bool ZONE, typename Strides>
static int launch_lanes(const ScanArgs& a, const Strides& ls, int B, void* stream) {
  const LanesFit* lf = nullptr;
  const int err = lanes_fit<ZONE>(lf);
  if (err != 0) return err;
  const int cl = lanes_cl(B, lf->fit);
  if (cl < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cl, 1, 1);
  cfg.blockDim = dim3(NTC, 1, 1);
  cfg.dynamicSmemBytes = scan_rows_bytes(a.Q, LANES_SPARSE ? a.Kq : 0, a.V, LANES_SPARSE ? a.Kv : 0,
                                         ZONE);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lanes_kernel<ZONE>(), a, ls);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0..9]: the fast instance's clusters of 16, 8, 4 and 2 the device
// holds at once and the CL a launch of B lanes takes, then the zoned
// instance's
static int lanes_info(int B, int* out) {
  const LanesFit* lf = nullptr;
  for (int z = 0; z < 2; ++z) {
    const int e = z ? lanes_fit<true>(lf) : lanes_fit<false>(lf);
    if (e != 0) return e;
    for (int i = 0; i < LANE_SIZES; ++i) out[5 * z + i] = lf->fit[i];
    out[5 * z + LANE_SIZES] = lanes_cl(B, lf->fit);
  }
  return 0;
}

// The lanes launchers' per-lane element counts: n arrays from dims d[at..],
// two ints each (low, high 32 bits). Returns false on a negative count.
static bool lane_counts(const int* d, int at, int n, long long* cnt) {
  for (int i = 0; i < n; ++i) {
    cnt[i] = (long long)(unsigned)d[at + 2 * i] | ((long long)d[at + 2 * i + 1] << 32);
    if (cnt[i] < 0) return false;
  }
  return true;
}
#endif  // FFD_LANES_ONLY

#ifdef FFD_BATCHED_ONLY
// ---- the batched launch (K4) ---------------------------------------------------
//
// One launch a dispatch: B subset rows on the team the caller chose (CL
// CTAs a row: a cluster of 16, 8, 4 or 2, or 1, one CTA a row of the
// many-rows instance). The rule is the wrapper's
// (solver/cuda/consolidate.py batched_team): the largest CL whose clusters
// the device holds all B rows at once, past every size one CTA a row, as
// many rows at once as the device holds, the rest in waves. It reads the
// teams from batched_info: the cluster instance's clusters of 16, 8, 4 and
// 2 CTAs the device holds at once at its widest launch (its whole row
// budget of dynamic shared memory; queried once per device, with the opt-in
// raised to that budget, as the lanes scans' are), and the many-rows
// instance's CTAs a SM at the launch's own rows. The launcher checks the
// team against the row's scratch; a launch the device refuses returns its
// error, and no other launch is tried.
constexpr int BATCH_SIZES = 4;
constexpr int BATCH_CL[BATCH_SIZES] = {16, 8, 4, 2};

struct BatchedFit {
  int fit[BATCH_SIZES];  // clusters of BATCH_CL[i] CTAs the device holds at once
  int budget;            // the cluster instance's row budget (rows_budget)
  bool done;
};

template <bool ZONE>
static BatchedFit* batched_fits() {
  static BatchedFit fits[MAX_DEVICES] = {};
  return fits;
}

// the cluster instance's fits on the current device (queried on first use)
template <bool ZONE>
static int batched_fit(const BatchedFit*& out) {
  auto kern = ffd_batched_kernel<ZONE, false>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  BatchedFit& bf = batched_fits<ZONE>()[dev];
  out = &bf;
  if (bf.done) return 0;
  const int dyn = rows_budget(kern);
  if (dyn < 0) return -dyn;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  bf.budget = dyn;
  for (int i = 0; i < BATCH_SIZES; ++i) {
    int f = 0;
    if (BATCH_CL[i] > 8) {
      // the non-portable size: a refused attribute or query is an answer, not a fault
      if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
          cluster_fit(kern, BATCH_CL[i], dyn, &f) != cudaSuccess)
        f = 0;
      (void)cudaGetLastError();
    } else {
      e = cluster_fit(kern, BATCH_CL[i], dyn, &f);
      if (e != cudaSuccess) return (int)e;
    }
    bf.fit[i] = f;
  }
  bf.done = true;
  return 0;
}

// the many-rows instance's opt-in raised to `dyn` bytes of rows
template <bool ZONE>
static int batched_many_opt_in(int dyn) {
  static int opted[MAX_DEVICES] = {};
  return opt_in(ffd_batched_kernel<ZONE, true>, dyn, opted);
}

template <bool ZONE>
static int launch_batched(const ScanArgs& a, int B, int cl, void* stream) {
  if (cl != 1 && cl != 2 && cl != 4 && cl != 8 && cl != 16) return (int)cudaErrorInvalidConfiguration;
  // the row's scratch must hold this team's CTA rows before the take rows
  if ((size_t)a.take_off < scan_words(a) + (size_t)cl * cta_words(a) ||
      (size_t)a.row_words < (size_t)a.take_off + 2 * (size_t)a.E + (size_t)a.M)
    return (int)cudaErrorInvalidValue;
  const int dyn = scan_rows_bytes(a.Q, 0, a.V, 0, ZONE);
  if (cl > 1) {
    const BatchedFit* bf = nullptr;
    const int err = batched_fit<ZONE>(bf);
    if (err != 0) return err;
    if (dyn > bf->budget) return (int)cudaErrorInvalidValue;
  } else {
    const int err = batched_many_opt_in<ZONE>(dyn);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cl, 1, 1);
  cfg.blockDim = dim3(NTC, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cl == 1 ? cudaLaunchKernelEx(&cfg, ffd_batched_kernel<ZONE, true>, a)
                                : cudaLaunchKernelEx(&cfg, ffd_batched_kernel<ZONE, false>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0..6]: the fast instance's clusters of 16, 8, 4 and 2 the device
// holds at once, the many-rows instance's CTAs a SM at `dyn` bytes of rows,
// the cluster instance's CTAs a SM at the same rows, and the device's SMs;
// then out[7..13], the zoned instance's (its rows at `dyn_zone`)
template <bool ZONE>
static int batched_info_of(int dyn, int* o) {
  const BatchedFit* bf = nullptr;
  int e = batched_fit<ZONE>(bf);
  if (e == 0) e = batched_many_opt_in<ZONE>(dyn);
  int dev = 0;
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&o[6], cudaDevAttrMultiProcessorCount, dev);
  if (e == 0)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[4], ffd_batched_kernel<ZONE, true>,
                                                           NTC, dyn);
  if (e == 0)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[5], ffd_batched_kernel<ZONE, false>,
                                                           NTC, dyn);
  if (e != 0) return e;
  for (int i = 0; i < BATCH_SIZES; ++i) o[i] = bf->fit[i];
  return 0;
}

static int batched_info(int dyn, int dyn_zone, int* out) {
  const int e = batched_info_of<false>(dyn, out);
  return e != 0 ? e : batched_info_of<true>(dyn_zone, out + 7);
}
#endif  // FFD_BATCHED_ONLY

// The sparse launchers take the dense launcher's pointers and dims, then
// run_q_idx [S, Kq] and run_v_idx [S, Kv] (two more pointers) and Kq, Kv
// (two more dims). Returns false when the view is wider than the shared
// slots.
template <bool SPARSE>
static bool fill_sparse(ScanArgs& a, void** p, int n, const int* d, int nd) {
  if constexpr (SPARSE) {
    a.run_q_idx = (const int*)p[n - 2];
    a.run_v_idx = (const int*)p[n - 1];
    a.Kq = d[nd - 2];
    a.Kv = d[nd - 1];
    return a.Kq >= 0 && a.Kv >= 0;
  } else {
    return true;
  }
}

// K1 (and K1s). ptrs: the 32 scan inputs, then the carry (e_cum, c_cum,
// c_mask, c_zc_bits, c_gbits, c_pool, used, p_usage, e_cm, e_co, c_cm, c_co,
// v_count, v_owner_z, c_vm, c_vo), take_e, take_c, leftover, events,
// scratch. dims: S, G, T, E, P, R, Q, W, M, V, Z, zone (0: the fast-branch
// instance, 1: the instance with the zoned branch).
template <bool SPARSE>
static int scan_launch(void** p, int n, const int* d, void* stream) {
  if (n != 53 + 2 * SPARSE) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  fill_scan_state(a, p + 32);
  a.take_e = (int*)p[48]; a.take_c = (int*)p[49]; a.leftover = (int*)p[50];
  a.events = (int*)p[51]; a.scratch = (int*)p[52];
  const bool zone = d[11] != 0;
  if (!scan_limits_ok(a, zone) || !fill_sparse<SPARSE>(a, p, n, d, 12 + 2 * SPARSE))
    return (int)cudaErrorInvalidValue;
  return zone ? launch_cluster<true, false, false, SPARSE>(a, stream)
              : launch_cluster<false, false, false, SPARSE>(a, stream);
}

// K6 (and K6s), one cluster a solve. ptrs: as scan_launch (the 32 scan
// inputs, the carry, take_e, take_c, leftover, events, scratch), then
// run_ladder [S, Lw] and
// the attempt count (a zeroed int32 scalar); dims: as scan_launch, then Lw
// and the offset of the attempt's rows in the scratch (take_e [E], take_c
// [M], leftover [S] after the cluster scan's own rows and its CTAs').
template <bool SPARSE>
static int ladder_launch(void** p, int n, const int* d, void* stream) {
  if (n != 55 + 2 * SPARSE) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  fill_scan_state(a, p + 32);
  a.out_take_e = (int*)p[48]; a.out_take_c = (int*)p[49]; a.out_leftover = (int*)p[50];
  a.events = (int*)p[51]; a.scratch = (int*)p[52]; a.run_ladder = (const int*)p[53];
  a.attempts = (int*)p[54];
  const bool zone = d[11] != 0;
  a.Lw = d[12];
  const int off = d[13];
  if (!scan_limits_ok(a, zone) || a.Lw < 1 || off < 0 ||
      !fill_sparse<SPARSE>(a, p, n, d, 14 + 2 * SPARSE))
    return (int)cudaErrorInvalidValue;
  a.take_e = a.scratch + off;
  a.take_c = a.take_e + a.E;
  a.leftover = a.take_c + a.M;
  return zone ? launch_cluster<true, true, false, SPARSE>(a, stream)
              : launch_cluster<false, true, false, SPARSE>(a, stream);
}

// K7 (and K7s). ptrs: as scan_launch (the 32 scan inputs, the carry — a
// fresh state for ffd_solve_ckpt, clones of the checkpoint for ffd_resume —
// take_e, take_c, leftover, events, scratch), then the ring's 16 fields
// (FFDState order, each [n_ckpt, ...], zeroed) and its prefix [n_ckpt]
// (-1); dims: as scan_launch, then ckpt_every and n_ckpt.
template <bool SPARSE>
static int ckpt_launch(void** p, int n, const int* d, void* stream) {
  if (n != 70 + 2 * SPARSE) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  fill_scan_state(a, p + 32);
  a.take_e = (int*)p[48]; a.take_c = (int*)p[49]; a.leftover = (int*)p[50];
  a.events = (int*)p[51]; a.scratch = (int*)p[52];
  for (int f = 0; f < 16; ++f) a.ring[f] = (unsigned char*)p[53 + f];
  a.ring_prefix = (int*)p[69];
  const bool zone = d[11] != 0;
  a.ck_every = d[12];
  a.n_ckpt = d[13];
  if (!scan_limits_ok(a, zone) || a.ck_every < 1 || a.n_ckpt < 1 ||
      !fill_sparse<SPARSE>(a, p, n, d, 14 + 2 * SPARSE))
    return (int)cudaErrorInvalidValue;
  return zone ? launch_cluster<true, false, true, SPARSE>(a, stream)
              : launch_cluster<false, false, true, SPARSE>(a, stream);
}

#ifdef FFD_MAIN_LIBRARY
// the clusters of cl NT-thread CTAs of the delta pack the card holds at once
static cudaError_t pack_cluster_fit(void (*kern)(PackArgs), int cl, int* fit) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = PACK_SMEM;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
}
#endif

extern "C" {

#ifdef FFD_SPARSE_ONLY
// the sparse library (ffd_sparse_kernels.cu): K1s, K6s, K7s
int ffd_scan_sparse_launch(void** p, int n, const int* d, void* stream) {
  return scan_launch<true>(p, n, d, stream);
}

int ffd_ladder_sparse_launch(void** p, int n, const int* d, void* stream) {
  return ladder_launch<true>(p, n, d, stream);
}

int ffd_ckpt_sparse_launch(void** p, int n, const int* d, void* stream) {
  return ckpt_launch<true>(p, n, d, stream);
}

// The row budget of this library's instances (bytes of launch-sized rows,
// the least over them); the arguments are unused. Returns the budget, or
// minus a CUDA error.
int ffd_sparse_rows_budget(void**, int, const int*, void*) {
  return least_budget({rows_budget(ffd_cluster_kernel<false, false, true>),
                       rows_budget(ffd_cluster_kernel<true, false, true>),
                       rows_budget(ffd_ladder_kernel<false, true>),
                       rows_budget(ffd_ladder_kernel<true, true>),
                       rows_budget(ffd_cluster_kernel<false, true, true>),
                       rows_budget(ffd_cluster_kernel<true, true, true>)});
}

// The cluster size of this library's six cluster instances (K1s fast and
// zoned, K7s fast and zoned, K6s fast and zoned) and the clusters of 16 and
// of 8 the device holds at once: 18 ints into the host buffer ptrs[0].
// Returns 0 or a CUDA error.
int ffd_sparse_cluster_info(void** p, int, const int*, void*) {
  return clusters_info<true>((int*)p[0]);
}
#elif defined(FFD_LANES_ONLY) && defined(FFD_LANES_SPARSE)
// the sparse lanes library (ffd_lanes_sparse_kernels.cu): K17s
// K17s. ptrs: as ffd_lanes_launch (the 32 scan inputs, the carry, take_e,
// take_c, leftover, events, scratch), then run_q_idx [B, S, Kq] and
// run_v_idx [B, S, Kv]; dims: as ffd_lanes_launch (S, G, T, E, P, R, Q, W,
// M, V, Z, zone, B, then each array's per-lane element count as two ints,
// the two index tables' included, in the pointer order), then Kq, Kv.
int ffd_lanes_sparse_launch(void** p, int n, const int* d, void* stream) {
  if (n != LANE_ARRAYS + 2) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  fill_scan_state(a, p + 32);
  a.take_e = (int*)p[48]; a.take_c = (int*)p[49]; a.leftover = (int*)p[50];
  a.events = (int*)p[51]; a.scratch = (int*)p[52];
  const bool zone = d[11] != 0;
  const int B = d[12];
  const int nd = 13 + 2 * (LANE_ARRAYS + 2) + 2;
  if (!scan_limits_ok(a, zone) || B < 1 || !fill_sparse<true>(a, p, n, d, nd))
    return (int)cudaErrorInvalidValue;
  long long cnt[LANE_ARRAYS + 2];
  if (!lane_counts(d, 13, LANE_ARRAYS + 2, cnt)) return (int)cudaErrorInvalidValue;
  SparseLaneStrides ls{};
  for (int i = 0; i < LANE_ARRAYS; ++i) ls.base.n[i] = cnt[i];
  ls.q = cnt[LANE_ARRAYS];
  ls.v = cnt[LANE_ARRAYS + 1];
  return zone ? launch_lanes<true>(a, ls, B, stream) : launch_lanes<false>(a, ls, B, stream);
}

// The row budget of the sparse lanes instances (the least of the two); the
// arguments are unused. Returns the budget, or minus a CUDA error.
int ffd_lanes_sparse_rows_budget(void**, int, const int*, void*) {
  return least_budget({rows_budget(ffd_lanes_sparse_kernel<false>),
                       rows_budget(ffd_lanes_sparse_kernel<true>)});
}

// The sparse lanes instances' clusters of 16, 8, 4 and 2 the device holds
// at once and the CL a launch of B = dims[0] lanes takes, fast then zoned:
// 10 ints into the host buffer ptrs[0]. Returns 0 or a CUDA error.
int ffd_lanes_sparse_cluster_info(void** p, int, const int* d, void*) {
  return d[0] < 1 ? (int)cudaErrorInvalidValue : lanes_info(d[0], (int*)p[0]);
}
#elif defined(FFD_BATCHED_ONLY)
// the batched library (ffd_batched_kernels.cu): K4
// K4. ptrs: the 32 scan inputs; the carry seeds pool_usage0, node_q_member,
// node_q_owner, b_v_count0 [B, V, Z], node_cand [E], cand_member [B, NC]
// (bool); the carry [B, ...] (FFDState order, as scan_launch);
// b_run_count [B, S], leftover [B, S], events [B], scratch [B, row_words].
// dims: S, G, T, E, P, R, Q, W, M, V, Z, zone, B, NC, row_words, take_off
// (the offset of the row's take rows in its scratch, after its team's CTA
// rows), team (1, 2, 4, 8 or 16 CTAs a row: the caller's choice).
int ffd_batched_launch(void** p, int n, const int* d, void* stream) {
  if (n != 58) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  a.pool_usage0 = (const int*)p[32]; a.node_q_member = (const int*)p[33];
  a.node_q_owner = (const int*)p[34]; a.v_count0 = (const int*)p[35];
  a.node_cand = (const int*)p[36]; a.cand_member = (const unsigned char*)p[37];
  fill_scan_state(a, p + 38);
  a.run_count = (const int*)p[54]; a.leftover = (int*)p[55]; a.events = (int*)p[56];
  a.scratch = (int*)p[57];
  const bool zone = d[11] != 0;
  const int B = d[12];
  a.NC = d[13]; a.row_words = d[14]; a.take_off = d[15];
  const int cl = d[16];
  if (!scan_limits_ok(a, zone) || a.NC < 1 || B < 1) return (int)cudaErrorInvalidValue;
  return zone ? launch_batched<true>(a, B, cl, stream) : launch_batched<false>(a, B, cl, stream);
}

// The row budget of the batched instances (the least over them); the
// arguments are unused. Returns the budget, or minus a CUDA error.
int ffd_batched_rows_budget(void**, int, const int*, void*) {
  return least_budget({rows_budget(ffd_batched_kernel<false, false>),
                       rows_budget(ffd_batched_kernel<true, false>),
                       rows_budget(ffd_batched_kernel<false, true>),
                       rows_budget(ffd_batched_kernel<true, true>)});
}

// The teams of the instances at dims[0] / dims[1] bytes of launch-sized
// rows (fast / zoned): 14 ints into the host buffer ptrs[0] (batched_info).
// Returns 0 or a CUDA error.
int ffd_batched_info(void** p, int, const int* d, void*) {
  return batched_info(d[0], d[1], (int*)p[0]);
}
#elif defined(FFD_LANES_ONLY)
// the lanes library (ffd_lanes_kernels.cu): K15, and K17 (the same
// instances, shared tables at a per-lane count of 0)
// K15. ptrs: as scan_launch (the 32 scan inputs, the carry, take_e, take_c,
// leftover, events, scratch), each [B, ...] lane-major; dims: as
// scan_launch (the per-lane S, G, T, E, P, R, Q, W, M, V, Z and zone), then
// B, then each array's per-lane element count as two ints (low, high 32
// bits), in the pointer order.
int ffd_lanes_launch(void** p, int n, const int* d, void* stream) {
  if (n != LANE_ARRAYS) return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  fill_scan_inputs(a, p, d);
  fill_scan_state(a, p + 32);
  a.take_e = (int*)p[48]; a.take_c = (int*)p[49]; a.leftover = (int*)p[50];
  a.events = (int*)p[51]; a.scratch = (int*)p[52];
  const bool zone = d[11] != 0;
  const int B = d[12];
  if (!scan_limits_ok(a, zone) || B < 1) return (int)cudaErrorInvalidValue;
  LaneStrides ls{};
  if (!lane_counts(d, 13, LANE_ARRAYS, ls.n)) return (int)cudaErrorInvalidValue;
  return zone ? launch_lanes<true>(a, ls, B, stream) : launch_lanes<false>(a, ls, B, stream);
}

// The row budget of the lanes instances (the least of the two); the
// arguments are unused. Returns the budget, or minus a CUDA error.
int ffd_lanes_rows_budget(void**, int, const int*, void*) {
  return least_budget({rows_budget(ffd_lanes_kernel<false>), rows_budget(ffd_lanes_kernel<true>)});
}

// As ffd_lanes_sparse_cluster_info, for K15 / K17 fast and zoned.
int ffd_lanes_cluster_info(void** p, int, const int* d, void*) {
  return d[0] < 1 ? (int)cudaErrorInvalidValue : lanes_info(d[0], (int*)p[0]);
}
#else
int ffd_scan_launch(void** p, int n, const int* d, void* stream) {
  return scan_launch<false>(p, n, d, stream);
}

int ffd_ladder_launch(void** p, int n, const int* d, void* stream) {
  return ladder_launch<false>(p, n, d, stream);
}

int ffd_ckpt_launch(void** p, int n, const int* d, void* stream) {
  return ckpt_launch<false>(p, n, d, stream);
}

// The row budget of this library's scan instances (K1, K6, K7, fast and
// zoned; the least over them); the arguments are unused. Returns the
// budget, or minus a CUDA error.
int ffd_rows_budget(void**, int, const int*, void*) {
  return least_budget({rows_budget(ffd_cluster_kernel<false, false, false>),
                       rows_budget(ffd_cluster_kernel<true, false, false>),
                       rows_budget(ffd_ladder_kernel<false, false>),
                       rows_budget(ffd_ladder_kernel<true, false>),
                       rows_budget(ffd_cluster_kernel<false, true, false>),
                       rows_budget(ffd_cluster_kernel<true, true, false>)});
}

// As ffd_sparse_cluster_info, for K1 / K7 / K6 fast and zoned.
int ffd_cluster_info(void** p, int, const int*, void*) {
  return clusters_info<false>((int*)p[0]);
}

// K5. ptrs: leftover [B, S], used [B], c_zc_bits [B, M], c_mask [B, M, T]
// (bool), out [B * (2 + M + M * ceil(T/32))]; dims: B, S, M, T
int pack_verdicts_launch(void** p, int n, const int* d, void* stream) {
  if (n != 5) return (int)cudaErrorInvalidValue;
  const int B = d[0];
  if (B < 1) return (int)cudaErrorInvalidValue;
  pack_verdicts_kernel<<<B, VT, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const int*)p[1], (const unsigned*)p[2], (const unsigned char*)p[3],
      (unsigned*)p[4], d[1], d[2], d[3]);
  return (int)cudaGetLastError();
}

// K2 + K3, the delta pack. ptrs: take_e [Sp, Ep], take_c [Sp, M], leftover
// [Sp], c_mask [M, T] (bool), c_zc_bits [M], c_gbits [M, W], c_pool [M],
// used, buf (the fetch buffer, then its scratch: solver/cuda/ffd.py
// pack_delta_words); dims: Sp, Ep, M, T, W, cap, cap_u, the cluster's CTAs
// (1, 2, 4, 8 or 16: fewer where the card holds no such cluster), the
// hash's bits (64; 2 only for chip_smoke.py's check of the walk), buf's words
int pack_delta_launch(void** p, int n, const int* d, void* stream) {
  if (n != 9) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], Ep = d[1], M = d[2], T = d[3], W = d[4], cap = d[5], cap_u = d[6];
  const int hb = d[8];
  int cl = d[7];
  if (Sp < 2 || Sp % 2 || M < 2 || M % 2 || Ep < 0 || T < 1 || W < 0 || cap < 1 || cap_u < 1 ||
      cl < 1 || cl > MAX_CL || (cl & (cl - 1)) || (hb != 64 && hb != 2))
    return (int)cudaErrorInvalidValue;
  const int Wm = (T + 31) / 32, Wt = Wm + 1 + W + 1, NWd = (Ep + M + 31) / 32;
  const long long out_words = 3 + Sp / 2 + (long long)cap + Sp + (long long)cap_u * Wt + M / 2 + 1;
  int S = 64;
  while (S < 2 * M) S <<= 1;
  const long long o_meta = (out_words + 3) & ~3ll, o_hash = (o_meta + (long long)M * Wt + 3) & ~3ll;
  const long long o_tkey = o_hash + 2ll * M, o_thead = o_tkey + 2ll * S, o_rank = o_thead + S;
  if (o_rank + M > (long long)d[9]) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  void (*kern)(PackArgs) = hb == 2 ? &pack_delta_kernel<2> : &pack_delta_kernel<64>;
  static int max_cl[MAX_DEVICES][2];  // the widest cluster the card holds, per instance
  int& mc = max_cl[dev][hb == 2];
  if (mc == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, PACK_SMEM);
    if (e != cudaSuccess) return (int)e;
    int f16 = 0, f8 = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess ||
        pack_cluster_fit(kern, 16, &f16) != cudaSuccess)
      f16 = 0;
    (void)cudaGetLastError();  // a refused size-16 query is an answer, not a fault
    e = pack_cluster_fit(kern, 8, &f8);
    if (e != cudaSuccess) return (int)e;
    if (f16 < 1 && f8 < 1) return (int)cudaErrorInvalidConfiguration;
    mc = f16 >= 1 ? 16 : 8;
  }
  cl = std::min(cl, mc);
  // a CTA's claim rows (20 B each) and run rows (4 B) must fit its shared memory
  auto rows_of = [](int n, int c) { return ((n + c - 1) / c + 1) & ~1; };
  while (cl < mc && 20ll * rows_of(M, cl) + 4ll * rows_of(Sp, cl) > PACK_SMEM) cl *= 2;
  int* buf = (int*)p[8];
  PackArgs a;
  a.take_e = (const int*)p[0];
  a.take_c = (const int*)p[1];
  a.leftover = (const int*)p[2];
  a.c_mask = (const unsigned char*)p[3];
  a.c_zc = (const unsigned*)p[4];
  a.c_gbits = (const unsigned*)p[5];
  a.c_pool = (const int*)p[6];
  a.used = (const int*)p[7];
  a.out = buf;
  a.meta = (unsigned*)(buf + o_meta);
  a.hash = (unsigned long long*)(buf + o_hash);
  a.tkey = (unsigned long long*)(buf + o_tkey);
  a.thead = buf + o_thead;
  a.rank = buf + o_rank;
  a.Sp = Sp;
  a.Ep = Ep;
  a.M = M;
  a.T = T;
  a.W = W;
  a.Wm = Wm;
  a.Wt = Wt;
  a.cap = cap;
  a.cap_u = cap_u;
  a.S = S;
  a.rows_c = rows_of(Sp, cl);
  a.claims_c = rows_of(M, cl);
  const long long rows_bytes = 20ll * a.claims_c + 4ll * a.rows_c;
  const long long stash_bytes = 4ll * a.rows_c * NWd;
  a.stash = rows_bytes + stash_bytes <= PACK_SMEM;
  a.t16 = T % 16 == 0 && (uintptr_t)p[3] % 16 == 0;
  const long long dyn = a.stash ? rows_bytes + stash_bytes : rows_bytes;
  if (dyn > PACK_SMEM) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the wide re-fetch's type-mask words. ptrs: c_mask [M, T] (bool), out
// [M, ceil(T/32)]; dims: M, T
int mask_words_launch(void** p, int n, const int* d, void* stream) {
  if (n != 2 || d[0] < 0 || d[1] < 1) return (int)cudaErrorInvalidValue;
  const int M = d[0], T = d[1];
  if (M == 0) return 0;
  const int t16 = T % 16 == 0 && (uintptr_t)p[0] % 16 == 0;
  mask_words_kernel<<<(M + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)p[0], (unsigned*)p[1], M, T, (T + 31) / 32, t16);
  return (int)cudaGetLastError();
}


// ptrs: num [N], den [D] (every divisor >= 1), out [D, N] (int32); dims: N, D
int floordiv_check_launch(void** p, int n, const int* d, void* stream) {
  if (n != 3 || d[0] < 1 || d[1] < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)d[0] * d[1];
  floordiv_check_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const int*)p[1], (int*)p[2], d[0], d[1]);
  return (int)cudaGetLastError();
}

// dims: the barriers, the cluster's CTAs (1..16); one cluster of NTC-thread CTAs
int cluster_barrier_launch(void**, int, const int* d, void* stream) {
  const int iters = d[0], cl = d[1];
  if (iters < 0 || cl < 1 || cl > MAX_CL) return (int)cudaErrorInvalidValue;
  if (cl > 8) {
    const cudaError_t e = cudaFuncSetAttribute(cluster_barrier_kernel,
                                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NTC, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, iters);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K9. ptrs: take_e [S, E], take_c [S, M], leftover [S], c_mask [M, T]
// (bool), c_zc_bits [M], c_gbits [M, Wg], c_pool [M], c_cum [M, R], used,
// out (solver/cuda/ffd.py pack_words sizes it); dims: S, E, M, T, Wg, R
int pack_outputs_launch(void** p, int n, const int* d, void* stream) {
  if (n != 10) return (int)cudaErrorInvalidValue;
  const int S = d[0], E = d[1], M = d[2], T = d[3], Wg = d[4], R = d[5];
  const long long total = 1 + ((long long)S * E + 1) / 2 + ((long long)S * M + 1) / 2 + S +
                          (long long)M * ((T + 31) / 32 + 1 + Wg + 1 + R) + 1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(p[9], 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)std::min<long long>((total + PT - 1) / PT, 132 * 8);
  pack_outputs_kernel<<<blocks, PT, 0, st>>>(
      (const int*)p[0], (const int*)p[1], (const int*)p[2], (const unsigned char*)p[3],
      (const unsigned*)p[4], (const unsigned*)p[5], (const int*)p[6], (const int*)p[7],
      (const int*)p[8], (unsigned*)p[9], S, E, M, T, Wg, R);
  return (int)cudaGetLastError();
}

#endif  // FFD_SPARSE_ONLY / FFD_BATCHED_ONLY / FFD_LANES_ONLY

}  // extern "C"
