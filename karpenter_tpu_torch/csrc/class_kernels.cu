// Hand-written Hopper (sm_90a) kernels of the scheduling-class passes (atomic
// gangs, priority preemption) and of decision provenance (explain). Plain C
// interface, loaded with ctypes (solver/cuda/build.py), the launcher
// convention of ffd_kernels.cu: a host array of device pointers, a host array
// of ints, the caller's stream; each launcher returns cudaGetLastError().
//
// Integer semantics follow the JAX reference: int32 sums wrap (added here as
// uint32, compared as int32), an argmax over an all-false row is 0, bools are
// one byte, 0 or 1.
//
// K10 gang_commit      replaces karpenter_tpu/solver/tpu/ffd.py:2953
//                      gang_commit: per-gang segment sum of the runs' placed
//                      counts, commit iff placed >= min_ranks > 0.
// K11 preemption_plan  replaces karpenter_tpu/solver/tpu/ffd.py:2969
//                      preemption_plan: the first node (ascending) whose free
//                      capacity plus the shortest prefix of its eligible
//                      victims covers `need`, and that prefix as a mask.
// preemption_walk      replaces K11's per-candidate calls from the class pass's
//                      host loop (karpenter_tpu/solver/scheduling_class.py:565-606,
//                      its plan karpenter_tpu/solver/tpu/ffd.py:2969
//                      preemption_plan): every candidate planned in order, the
//                      victim tables and their updates kept on the card.
// K12 explain_pack     replaces karpenter_tpu/solver/tpu/ffd.py:3096
//                      explain_pack: a reason code per (group, node), the
//                      first top_k rejected nodes per group, one int32 wire.
//
// What bounds them on the H100: at the shapes of a solve (a few thousand runs,
// nodes or groups) the launch itself; by bytes, K12's read of the take table.
// Design:
// - K10: one block; zero the per-gang sums, one atomicAdd per run whose gang
//   lies in [0, NG) (JAX parks negative gangs in slot NG and drops indices
//   past it), then the verdicts.
// - K11: one warp per node row walks its victims 32 at a time: the ineligible
//   reclaim is zeroed, each resource's inclusive prefix comes from
//   __shfl_up_sync with the running sum carried between chunks, and the
//   first fitting position from __ballot_sync / __ffs. A fitting row
//   atomicMin's its index into a device scalar set to 0x7f7f7f7f first; a
//   second one-warp launch reads it and writes the chosen row's mask (each
//   row of the mask was zeroed by its warp in the first launch).
// - the walk: one launch a call (a class solve's whole pass, or a chunk of it
//   where the candidates bring many node rows), the candidate loop inside the
//   kernel, so its bound is serial: candidates walked x one team barrier each
//   (the tables are a few hundred KB, read once). Node rows are split over the
//   warps of the team (row e: warp e % W, W the team's warps), and a row's
//   working copy of node_free / victim_ok is read and written by its warp
//   alone, so no barrier guards the state. A candidate's first fit is found
//   by an ascending search with early exit: each warp walks its rows
//   upwards, stops at its first fit (atomicMin into the team's slot, CTA
//   0's shared memory, reached through distributed shared memory on a
//   cluster) or at the first row above the lowest fit so far. One barrier
//   then makes the minimum final; the warp that owns that row (and found
//   it) appends the victims through the prefix end its search kept and
//   updates the row and the count while the other warps already search the
//   next candidate. The budget
//   test reads the count after that barrier: a candidate searched past the
//   budget only wrote its own minimum slot. The minimum rotates through
//   three slots and the count through two, so no write races a read. The
//   team is one block of WT threads or a cluster of WALK_CL such CTAs,
//   chosen from E at launch (walk_ctas: PERF.md's Step 0).
// - K12: one launch a call, no memset, no dense [Gp, Ep] placed matrix and
//   no global atomics; the bound is the take table's bytes (read once from
//   memory, a second time from L2). Two teams, chosen at launch
//   (explain_team; the plan, explain_plan, sizes both phases). The grid
//   (one cooperative launch over the card): phase A, the last CTA sorts the
//   runs by group (a counting sort into off / ids, a few Sp + Gp words) and
//   every CTA sums columns of the take table: a strip of sw columns a team
//   of warps, each take cell read once in row segments, the usage added
//   across lanes and warps in shared memory and written as the final free
//   table ff [R, Ep]; each warp loads its first group's constants; one grid
//   barrier. The local team (small tables): every CTA reads the take
//   table's counted columns once itself and adds the usage, and the placed
//   counts of its own tile's few groups, in shared memory, so no barrier
//   spans CTAs and no runs are sorted. Phase B: a CTA takes a tile of
//   groups, a warp a group (or a few warps a group over column segments
//   where the groups are few), with ff, node_zone and node_ct of a column
//   chunk in shared memory once for the tile; on the grid a warp sums its
//   group's placed count from its own runs' take cells (read again, from
//   L2; the next 128 columns' loads in flight while it forms this step's
//   codes); it forms the code and keeps the first top_k rejections by
//   ballot / popc, with no CTA barrier a column step.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GT = 1024;  // threads of the gang verdict (one block)
constexpr int PW = 8;     // warps per block of the preemption scan (a node row each)
constexpr int XT = 256;   // threads of an explain CTA
constexpr int XW = XT / 32;  // its warps: a group each in phase B
constexpr int XS_WORDS = 12288;  // its dynamic shared memory in words (48 KB)
constexpr int XS_BYTES = XS_WORDS * 4;
constexpr int XA_ROWS = 16;  // take rows a lane keeps in flight in the grid's phase A
constexpr int XL = 8;        // quads of take cells a thread keeps in flight in the local phase A
constexpr int XNF = 4;       // node_free words a thread prefetches there
constexpr int XB_CTAS = 4;   // CTAs of the grid an SM holds at once (launch bounds: 64 registers)
constexpr int XK = 32;       // entries a later column segment keeps in shared memory
// the explain teams (ffd.py EXPLAIN_LOCAL / EXPLAIN_GRID): every CTA its own
// column sums (no barrier across CTAs) while Sp * Ep is at most
// EXPLAIN_LOCAL_CELLS, Gp at most EXPLAIN_LOCAL_GROUPS and the layout fits
// a CTA's shared memory, else the cooperative grid
constexpr int EXPLAIN_LOCAL = 1;
constexpr int EXPLAIN_GRID = 2;
constexpr long long EXPLAIN_LOCAL_CELLS = 16384;
constexpr int EXPLAIN_LOCAL_GROUPS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_R = 16; // solver/cuda/ffd.py MAX_R
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_NODE = 0x7f7f7f7f;  // the memset value of the chosen-node scalar
constexpr int WT = 1024;      // threads of a walk CTA
constexpr int WW = WT / 32;   // its warps: node rows a round
constexpr int WALK_CL = 16;   // CTAs of the walk's cluster (ffd.py WALK_CLUSTER)
// the most node rows one block walks (ffd.py WALK_BLOCK_ROWS): 64 rounds of its
// 32 warps; a search of every row then costs a block at most ~2x a cluster's
// (PERF.md's Step 0: ~0.125 us a round of one block, ~0.33 of the cluster, which
// pays ~0.76 us more a candidate for its barrier where the fits lie in front)
constexpr int WALK_BLOCK_ROWS = 2048;
constexpr int NO_ROW = 0x7fffffff;  // no fitting row

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// ---------------------------------------------------------------------------
// K10 gang_commit
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GT) gang_commit_kernel(
    const int* __restrict__ run_placed, const int* __restrict__ run_gang,
    const int* __restrict__ min_ranks, unsigned char* __restrict__ commit,
    int* __restrict__ placed, int S, int NG) {
  for (int g = threadIdx.x; g < NG; g += GT) placed[g] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += GT) {
    const int g = run_gang[s];
    if (g >= 0 && g < NG) atomicAdd(&placed[g], run_placed[s]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < NG; g += GT) {
    const int p = __ldcg(&placed[g]);  // the atomics' result, past L1
    const int mr = min_ranks[g];
    commit[g] = (unsigned char)(p >= mr && mr > 0);
  }
}

// ---------------------------------------------------------------------------
// K11 preemption_plan
// ---------------------------------------------------------------------------

// The first victim position of node row `e` whose cumulative (free plus the
// eligible reclaim through it, int32 wrap) covers `need` in every resource,
// or -1. Warp-collective: every lane of the warp calls it with the same row.
// node_free and vok carry no __restrict__: the walk writes them in the same
// launch, so their loads must not take the read-only (non-coherent) path.
__device__ int row_first_fit(const int* node_free, const int* __restrict__ vprio,
                             const int* __restrict__ vreq, const unsigned char* vok,
                             const int* __restrict__ need, int e, int Vm, int R, int pod_prio,
                             int lane) {
  unsigned carry[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) carry[r] = r < R ? (unsigned)node_free[(size_t)e * R + r] : 0u;
  for (int base = 0; base < Vm; base += 32) {
    const int v = base + lane;
    const bool in = v < Vm;
    const size_t ev = (size_t)e * Vm + v;
    const bool elig = in && vok[ev] && vprio[ev] < pod_prio;
    bool fit = in;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) {
        unsigned x = elig ? (unsigned)vreq[ev * R + r] : 0u;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, x, d);
          if (lane >= d) x += y;
        }
        fit = fit && (int)(carry[r] + x) >= need[r];
        carry[r] += __shfl_sync(FULL, x, 31);
      }
    }
    const unsigned hit = __ballot_sync(FULL, fit);
    if (hit) return base + __ffs(hit) - 1;
  }
  return -1;
}

__device__ __forceinline__ bool free_fits(const int* node_free,
                                          const int* __restrict__ need, int e, int R) {
  bool ok = true;
  for (int r = 0; r < R; ++r) ok = ok && node_free[(size_t)e * R + r] >= need[r];
  return ok;
}

__global__ void __launch_bounds__(PW * 32) preempt_scan_kernel(
    const int* __restrict__ node_free, const int* __restrict__ vprio,
    const int* __restrict__ vreq, const unsigned char* __restrict__ vok,
    const unsigned char* __restrict__ node_ok, const int* __restrict__ need,
    unsigned char* __restrict__ take, int* __restrict__ best, int E, int Vm, int R,
    int pod_prio) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * PW + (threadIdx.x >> 5);
  if (e >= E) return;
  for (int v = lane; v < Vm; v += 32) take[(size_t)e * Vm + v] = 0;
  if (!node_ok[e]) return;
  const bool fit = free_fits(node_free, need, e, R) ||
                   row_first_fit(node_free, vprio, vreq, vok, need, e, Vm, R, pod_prio, lane) >= 0;
  if (fit && lane == 0) atomicMin(best, e);
}

__global__ void __launch_bounds__(32) preempt_take_kernel(
    const int* __restrict__ node_free, const int* __restrict__ vprio,
    const int* __restrict__ vreq, const unsigned char* __restrict__ vok,
    const int* __restrict__ need, const int* __restrict__ best, int* __restrict__ node_idx,
    unsigned char* __restrict__ take, int E, int Vm, int R, int pod_prio) {
  const int lane = threadIdx.x;
  const int b = *best;
  const int e = b < E ? b : -1;
  if (lane == 0) node_idx[0] = e;
  if (e < 0 || free_fits(node_free, need, e, R)) return;  // no plan, or free alone fits
  int k = row_first_fit(node_free, vprio, vreq, vok, need, e, Vm, R, pod_prio, lane);
  k = k < 0 ? 0 : k;  // argmax of an all-false row
  for (int v = lane; v <= k && v < Vm; v += 32) {
    const size_t ev = (size_t)e * Vm + v;
    take[ev] = (unsigned char)(vok[ev] && vprio[ev] < pod_prio);
  }
}

// ---------------------------------------------------------------------------
// preemption_walk: the class pass's preemption loop in one launch
// ---------------------------------------------------------------------------

struct WalkArgs {
  const int* node_free0;          // [E, R] the charged free table (not written)
  const int* vprio;               // [E, Vm]
  const int* vreq;                // [E, Vm, R]
  const unsigned char* vok0;      // [E, Vm] (not written)
  const unsigned char* masks;     // [U, E] the candidates' node rows
  const int* cand_row;            // [C] each candidate's row of masks
  const int* need;                // [C, R]
  const int* prio;                // [C]
  int* wire;                      // [2 + 3 cap]: count, budget flag, (c, e, v) rows
  int* node_free;                 // [E, R] the walk's copy: the final free table
  unsigned char* vok;             // [E, Vm] the same for victim_ok
  int E, Vm, R, C, budget, cap;
};

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

template <bool CL>
__device__ __forceinline__ void walk_sync() {
  if constexpr (CL) cluster_barrier(); else __syncthreads();
}

template <bool CL>
__global__ void __launch_bounds__(WT, 1) preempt_walk_kernel(const WalkArgs a) {
  __shared__ int s_best[3];   // candidate c's lowest fitting row, slot c % 3
  __shared__ int s_count[2];  // the evictions through candidate c, slot c % 2
  const int lane = threadIdx.x & 31;
  int rank = 0, ctas = 1;
  int* best = s_best;
  int* count = s_count;
  if constexpr (CL) {  // the team's slots are CTA 0's
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    ctas = (int)cl.num_blocks();
    best = cl.map_shared_rank(s_best, 0);
    count = cl.map_shared_rank(s_count, 0);
  }
  const bool lead = rank == 0 && threadIdx.x == 0;
  const int W = ctas * WW;
  const int gw = rank * WW + (threadIdx.x >> 5);
  const int E = a.E, Vm = a.Vm, R = a.R;
  if (lead) {
    s_best[0] = s_best[1] = s_best[2] = NO_ROW;
    s_count[0] = s_count[1] = 0;
  }
  // the working copies, each row by the warp that owns it from here on
  for (int e = gw; e < E; e += W) {
    if (lane < R) a.node_free[(size_t)e * R + lane] = a.node_free0[(size_t)e * R + lane];
    for (int v = lane; v < Vm; v += 32) a.vok[(size_t)e * Vm + v] = a.vok0[(size_t)e * Vm + v];
  }
  for (int i = rank * WT + threadIdx.x; i < 3 * a.cap; i += ctas * WT) a.wire[2 + i] = -1;
  __syncwarp();
  walk_sync<CL>();
  for (int c = 0;; ++c) {
    const int* need = a.need + (size_t)c * R;
    const int pprio = c < a.C ? a.prio[c] : 0;
    // this warp's first fit: its prefix end (-2 where free capacity alone fits)
    int fit_k = -1;
    if (c < a.C) {
      // this warp's rows upwards: stop at its first fit or above the lowest so far
      const unsigned char* mrow = a.masks + (size_t)a.cand_row[c] * E;
      volatile int* bc = best + c % 3;
      for (int e = gw; e < E; e += W) {
        int cur = 0;
        if (lane == 0) cur = *bc;
        if (__shfl_sync(FULL, cur, 0) < e) break;
        if (!mrow[e]) continue;
        fit_k = free_fits(a.node_free, need, e, R)
                    ? -2
                    : row_first_fit(a.node_free, a.vprio, a.vreq, a.vok, need, e, Vm, R, pprio, lane);
        if (fit_k != -1) {
          if (lane == 0) atomicMin((int*)bc, e);
          break;
        }
      }
    }
    walk_sync<CL>();  // c's minimum is final; c - 1's update and count are visible
    const int n = *(volatile int*)(count + ((c + 1) & 1));  // the evictions through c - 1
    if (c == a.C || n >= a.budget) {
      if (lead) {
        a.wire[0] = n;
        a.wire[1] = c < a.C;
      }
      break;
    }
    const int b = *(volatile int*)(best + c % 3);
    if (lead) {
      best[(c + 2) % 3] = NO_ROW;  // c + 2's slot: its last readers were c - 1's
      if (b == NO_ROW) count[c & 1] = n;
    }
    if (b == NO_ROW || b % W != gw) continue;
    // this warp owns the chosen row, the fit its search stopped at (the row is
    // unchanged since): nothing to evict where its free capacity alone fits,
    // else the eligible victims through the first fitting position
    int taken = 0;
    if (fit_k >= 0) {
      const int k = fit_k;
      unsigned add = 0;  // lane r < R: resource r of the taken victims (int32 wrap)
      for (int base = 0; base <= k; base += 32) {
        const int v = base + lane;
        const size_t ev = (size_t)b * Vm + v;
        const bool take = v <= k && a.vok[ev] && a.vprio[ev] < pprio;
        const unsigned m = __ballot_sync(FULL, take);
        if (take) {
          const int pos = n + taken + __popc(m & ((1u << lane) - 1u));
          if (pos < a.cap) {
            int* row = a.wire + 2 + 3 * (size_t)pos;
            row[0] = c;
            row[1] = b;
            row[2] = v;
          }
          a.vok[ev] = 0;
        }
        for (unsigned mm = m; mm; mm &= mm - 1u) {
          const size_t t = (size_t)b * Vm + base + __ffs(mm) - 1;
          if (lane < R) add += (unsigned)a.vreq[t * R + lane];
        }
        taken += __popc(m);
      }
      if (taken && lane < R) {  // freed, then spoken for: max(free - need, 0)
        const size_t at = (size_t)b * R + lane;
        const long long f = (long long)(int)((unsigned)a.node_free[at] + add) - need[lane];
        a.node_free[at] = f > 0 ? (int)f : 0;
      }
    }
    __syncwarp();  // the row's new state before this warp's next search reads it
    if (lane == 0) count[c & 1] = n + taken;
  }
  if constexpr (CL) cluster_barrier();  // CTA 0's slots outlive every read of them
}

// The walk's team: one block up to WALK_BLOCK_ROWS node rows, else a cluster
static int walk_ctas(int E) { return E <= WALK_BLOCK_ROWS ? 1 : WALK_CL; }

// n barriers of one walk block (timing only: the walk's serial floor on one
// block; a cluster's barrier is timed by ffd_kernels.cu cluster_barrier_kernel)
__global__ void __launch_bounds__(WT, 1) block_barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) __syncthreads();
}

// ---------------------------------------------------------------------------
// K12 explain_pack
// ---------------------------------------------------------------------------

struct ExplainArgs {
  const int* take_e;                // [Sp, Ep]
  const int* run_group;             // [Sp]
  const int* group_req;             // [Gp, R]
  const int* node_free;             // [Ep, R]
  const unsigned char* node_compat; // [Gp, Ep]
  const int* node_zone;             // [Ep]
  const int* node_ct;               // [Ep]
  const unsigned char* group_zone;  // [Gp, Z]
  const unsigned char* group_ct;    // [Gp, C]
  const unsigned char* group_topo;  // [Gp]
  const unsigned char* group_aff;   // [Gp]
  int* out;                         // [3 + Gp (1 + K)] the wire
  // the grid's scratch (explain_scratch_words), written in phase A, read in
  // phase B; the local team keeps its own in shared memory
  int* ff;                          // [R, Ep] the final free table, resource-major
  int* off;                         // [Gp + 1] each group's first entry of ids
  int* cnt;                         // [Gp + 1] the sort's counters past shared memory
  int* ids;                         // [Sp] the run ids, grouped by run_group
  int Sp, Ep, Gp, R, Z, C, K, e_count, g_count;
  int sw;     // the grid's phase A: columns of a strip (32, 16 or 8)
  int tw;     // the grid's phase A: warps of a strip's team (1, 2, 4 or 8)
  int nseg;   // phase B: warps of a group, each a contiguous column segment
  int chunk;  // phase B: columns a CTA stages at once (a multiple of 32)
  int tiles;  // phase B: tiles of XW / nseg groups
  bool vec;   // 16-byte loads of take rows, 4-byte loads of compat rows
};

// A CTA's static shared memory: the sort's warp sums, and for each warp of
// phase B its group's requests, zone and capacity-type masks and flags, its
// segment's count and a later segment's first XK entries.
struct XShared {
  int wsum[XW];
  int cnt[XW];
  int req[XW][MAX_R];
  unsigned gm[XW][3];  // zone mask, capacity-type mask, flags (1 topology, 2 affinity)
  int ent[XW][XK];
};

// 16 bytes of shared memory, and a word of them
__device__ __forceinline__ int4 ld4(const int* p) { return *reinterpret_cast<const int4*>(p); }

__device__ __forceinline__ int at4(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One 4-byte asynchronous copy from global to shared memory (cp.async,
// through L1: no line of the scratch it reads was cached on this SM before
// the barrier that made it final), and the wait for this thread's copies.
__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The grid's counting sort of run_group (its last CTA): off[g] = the runs
// of groups below g, ids = the runs grouped by group (any order inside a
// group: the placed sum wraps and is order-free); cnt holds Gp + 1
// counters (shared memory where they fit, else the scratch).
__device__ __forceinline__ void explain_sort(const ExplainArgs& a, XShared& xs, int* cnt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int Gp = a.Gp;
  for (int g = threadIdx.x; g <= Gp; g += XT) cnt[g] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < a.Sp; s += XT) {
    const int g = __ldg(&a.run_group[s]);
    if (g >= 0 && g < Gp) atomicAdd(&cnt[g], 1);
  }
  __syncthreads();
  // exclusive scan: each thread a contiguous span of groups
  const int per = (Gp + XT - 1) / XT;
  const int lo = min(Gp, threadIdx.x * per), hi = min(Gp, lo + per);
  int sum = 0;
  for (int g = lo; g < hi; ++g) sum += cnt[g];
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) xs.wsum[w] = x;
  __syncthreads();
  int run = x - sum;
  for (int i = 0; i < w; ++i) run += xs.wsum[i];
  for (int g = lo; g < hi; ++g) {
    const int c = cnt[g];
    a.off[g] = run;
    cnt[g] = run;  // the scatter's cursor
    run += c;
  }
  if (threadIdx.x == XT - 1) a.off[Gp] = run;
  __syncthreads();
  for (int s = threadIdx.x; s < a.Sp; s += XT) {
    const int g = __ldg(&a.run_group[s]);
    if (g >= 0 && g < Gp) a.ids[atomicAdd(&cnt[g], 1)] = s;
  }
  __syncthreads();  // the counters' words are phase A's next
}

// The grid's phase A column sums: ff[r, e] = node_free[e, r] - sum_s
// take_e[s, e] * group_req[run_group[s], r] (int32 wrap). A strip of sw
// columns is one team of tw warps (XW / tw strips a CTA at once); lane l
// reads column l % sw of row l / sw of the warp's step, so a warp reads 32 /
// sw whole row segments of the strip at a time, XA_ROWS steps in flight.
// Each take cell is read once; a nonzero one adds its products into the
// strip's sums in shared memory (atomics there; nothing atomic in global
// memory).
__device__ __forceinline__ void explain_usage(const ExplainArgs& a, int* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sw = a.sw, tw = a.tw, R = a.R, Ep = a.Ep;
  const int rs = 32 / sw;             // rows a warp step covers
  const int spc = XW / tw;            // strips a CTA round
  const int ws = w / tw, wr = w % tw;
  const int col = lane % sw, ro = lane / sw;
  const int rstep = tw * rs;          // rows a team step covers
  const int strips = (Ep + sw - 1) / sw;
  int* use = sh;                      // [spc][R][sw] the round's sums
  for (int base = blockIdx.x * spc; base < strips; base += gridDim.x * spc) {
    for (int i = threadIdx.x; i < spc * R * sw; i += XT) use[i] = 0;
    __syncthreads();
    const int e = (base + ws) * sw + col;
    const bool in = base + ws < strips && e < Ep;
    int* mine = use + ws * R * sw + col;
    for (int s0 = wr * rs + ro; s0 < a.Sp; s0 += rstep * XA_ROWS) {
      int t[XA_ROWS];
#pragma unroll
      for (int u = 0; u < XA_ROWS; ++u) {
        const int s = s0 + u * rstep;
        t[u] = in && s < a.Sp ? __ldg(&a.take_e[(size_t)s * Ep + e]) : 0;
      }
#pragma unroll
      for (int u = 0; u < XA_ROWS; ++u) {
        if (t[u] == 0) continue;
        const int g = __ldg(&a.run_group[s0 + u * rstep]);
        if (g < 0 || g >= a.Gp) continue;  // run_group lies in [0, Gp) by contract
        const int* req = a.group_req + (size_t)g * R;
        for (int r = 0; r < R; ++r) atomicAdd(&mine[r * sw], wmul(t[u], __ldg(&req[r])));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < spc * R * sw; i += XT) {
      const int slot = i / (R * sw), r = (i / sw) % R, c = i % sw;
      const int ee = (base + slot) * sw + c;
      if (base + slot < strips && ee < Ep)
        a.ff[(size_t)r * Ep + ee] = wsub(__ldg(&a.node_free[(size_t)ee * R + r]), use[i]);
    }
    __syncthreads();  // the sums are read before the next round zeroes them
  }
}

// A warp's group constants in phase B, inputs only (so they are loaded
// before phase A's results are final): its requests, its zone and
// capacity-type rows as bit masks (lane bit l: column l, where Z / C <= 32;
// past 32 the walk reads the rows from memory) and its flags. Nothing for a
// group at or past g_count.
__device__ __forceinline__ void explain_consts(const ExplainArgs& a, XShared& xs, int tile) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = tile * (XW / a.nseg) + w / a.nseg;
  if (g >= a.Gp || g >= a.g_count) return;
  // every load first (one round trip), then the masks
  const bool zin = a.Z <= 32 && lane < a.Z, cin = a.C <= 32 && lane < a.C;
  const unsigned char zb = zin ? a.group_zone[(size_t)g * a.Z + lane] : 0;
  const unsigned char cb = cin ? a.group_ct[(size_t)g * a.C + lane] : 0;
  const int rq = lane < a.R ? __ldg(&a.group_req[(size_t)g * a.R + lane]) : 0;
  const unsigned char tp = lane == 0 ? a.group_topo[g] : 0;
  const unsigned char af = lane == 0 ? a.group_aff[g] : 0;
  __syncwarp();  // the last tile's reads of the warp's rows are done
  if (lane < a.R) xs.req[w][lane] = rq;
  const unsigned zm = __ballot_sync(FULL, zb != 0), cm = __ballot_sync(FULL, cb != 0);
  if (lane == 0) {
    xs.gm[w][0] = zm;
    xs.gm[w][1] = cm;
    xs.gm[w][2] = (tp != 0 ? 1u : 0u) | (af != 0 ? 2u : 0u);
  }
  __syncwarp();
}

// The local team's phase A, in every CTA: node_zone, node_ct (the counted
// columns, e < e_count), run_group and group_req staged by asynchronous
// copies; one pass over the take table's counted columns, each thread XL
// quads (4 cells of a row, one 16-byte load where Ep is a multiple of 4) in
// flight, a nonzero cell adding its products into the staged free table and,
// where its run's group is one of the CTA's tile, its count into the tile's
// placed rows [XW / nseg][chunk] (int32 wrap, by shared atomics: the
// placed counts of a few groups, not a [Gp, Ep] matrix, and no sort of the
// runs); then node_free (prefetched, XNF words a thread) minus the sums
// replaces them. The first quads are in flight while the copies land and
// the group constants of the CTA's tile load.
__device__ __forceinline__ void explain_local(const ExplainArgs& a, XShared& xs, int* sh) {
  const int R = a.R, Ep = a.Ep, Gp = a.Gp, chunk = a.chunk;
  const int ecnt = min(Ep, max(a.e_count, 0));
  const int gpt = XW / a.nseg, g0 = blockIdx.x * gpt;
  int* s_ff = sh;                     // [R][chunk]
  int* s_zone = sh + R * chunk;       // [chunk]
  int* s_ct = s_zone + chunk;         // [chunk]
  int* s_pl = s_ct + chunk;           // [gpt][chunk]
  int* s_rg = s_pl + gpt * chunk;     // [Sp]
  int* s_req = s_rg + a.Sp;           // [Gp][R]
  for (int i = threadIdx.x; i < R * chunk; i += XT) s_ff[i] = 0;
  for (int i = threadIdx.x; i < gpt * chunk; i += XT) s_pl[i] = 0;
  for (int i = threadIdx.x; i < ecnt; i += XT) {
    cp_async4(s_zone + i, a.node_zone + i);
    cp_async4(s_ct + i, a.node_ct + i);
  }
  for (int i = threadIdx.x; i < a.Sp; i += XT) cp_async4(s_rg + i, a.run_group + i);
  for (int i = threadIdx.x; i < Gp * R; i += XT) cp_async4(s_req + i, a.group_req + i);
  // node_free's counted words i = r * ecnt + e, a thread's XNF first ones
  // in flight; a thread's words (and quads below) advance by XT without a
  // division: (dr, de) rows and columns a step
  const int dr = ecnt > 0 ? XT / ecnt : 0, de = ecnt > 0 ? XT % ecnt : 0;
  const int fr0 = ecnt > 0 ? (int)threadIdx.x / ecnt : R;
  const int fe0 = ecnt > 0 ? (int)threadIdx.x % ecnt : 0;
  int fr = fr0, fe = fe0;
  auto next_word = [&]() {
    fr += dr, fe += de;
    if (fe >= ecnt) fe -= ecnt, ++fr;
  };
  int nf[XNF];
#pragma unroll
  for (int k = 0; k < XNF; ++k) {
    nf[k] = fr < R ? __ldg(&a.node_free[(size_t)fe * R + fr]) : 0;
    next_word();
  }
  // take quads: row qs, cells 4 qc..4 qc+3; the batch's rows and first
  // columns kept for its sums
  const int q4 = (ecnt + 3) >> 2;
  const int ds = q4 > 0 ? XT / q4 : 0, dc = q4 > 0 ? XT % q4 : 0;
  int qs = q4 > 0 ? (int)threadIdx.x / q4 : a.Sp, qc = q4 > 0 ? (int)threadIdx.x % q4 : 0;
  int4 t[XL];
  int ts[XL], te[XL];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      const int e = 4 * qc;
      ts[u] = qs, te[u] = e;
      t[u] = make_int4(0, 0, 0, 0);
      if (qs < a.Sp) {
        const int* p = a.take_e + (size_t)qs * Ep + e;
        if (a.vec) {
          t[u] = __ldg(reinterpret_cast<const int4*>(p));
        } else {
          t[u].x = __ldg(p);
          if (e + 1 < ecnt) t[u].y = __ldg(p + 1);
          if (e + 2 < ecnt) t[u].z = __ldg(p + 2);
          if (e + 3 < ecnt) t[u].w = __ldg(p + 3);
        }
      }
      qs += ds, qc += dc;
      if (qc >= q4) qc -= q4, ++qs;
    }
  };
  load();
  explain_consts(a, xs, blockIdx.x);
  cp_async_wait_all();
  __syncthreads();  // the copies and the zeroed sums
  while (true) {
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      if ((t[u].x | t[u].y | t[u].z | t[u].w) == 0) continue;
      const int e = te[u];
      const int g = s_rg[ts[u]];
      if (g < 0 || g >= Gp) continue;  // run_group lies in [0, Gp) by contract
      for (int r = 0; r < R; ++r) {
        const int rq = s_req[g * R + r];
        int* f = s_ff + r * chunk + e;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int v = at4(t[u], c);
          if (v != 0 && e + c < ecnt) atomicAdd(f + c, wmul(v, rq));
        }
      }
      if ((unsigned)(g - g0) < (unsigned)gpt) {
        int* pl = s_pl + (g - g0) * chunk + e;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int v = at4(t[u], c);
          if (v != 0 && e + c < ecnt) atomicAdd(pl + c, v);
        }
      }
    }
    if (qs >= a.Sp) break;
    load();
  }
  __syncthreads();
  fr = fr0, fe = fe0;
#pragma unroll
  for (int k = 0; k < XNF; ++k) {
    if (fr < R) s_ff[fr * chunk + fe] = wsub(nf[k], s_ff[fr * chunk + fe]);
    next_word();
  }
  for (; fr < R; next_word())
    s_ff[fr * chunk + fe] = wsub(__ldg(&a.node_free[(size_t)fe * R + fr]), s_ff[fr * chunk + fe]);
  __syncthreads();
}

// The staged columns [base, base + n) of a phase B chunk: ff [R][stride],
// node_zone and node_ct, in shared memory.
struct Stage {
  const int* ff;
  const int* zone;
  const int* ct;
  int base;
  int stride;
};

// A group's per-warp state in phase B: its constants (explain_consts, in
// the warp's rows of XShared) and its runs (lane l holds run l of the
// first 32; past 32 they are read from runs), or, for the local team, its
// placed row in shared memory.
struct Group {
  int g;
  const int* req;
  unsigned zmask, cmask;
  bool topo, aff;
  const int* runs;
  int nruns;
  int run0;
  const int* pl;  // the local team: the group's placed row
};

// The grid's lookup of group g's runs in the sort's output (written by
// another CTA of this launch: read past L1).
__device__ __forceinline__ void explain_runs(const ExplainArgs& a, int g, Group& gr) {
  const int lane = threadIdx.x & 31;
  const int o = __ldcg(&a.off[g]);
  gr.runs = a.ids + o;
  gr.nruns = __ldcg(&a.off[g + 1]) - o;
  gr.run0 = lane < gr.nruns ? __ldcg(&gr.runs[lane]) : 0;
}

// One step's loads of a group's walk, for the lane's 4 columns e..e+3 of a
// 128-column slice: their compat bytes and their placed sums over the
// group's runs (the grid: the take table's second read, from L2, int32
// wrap; the local team: its placed row), 16 bytes a load where the tables
// allow (`vec`). The first run's cells are loaded straight into the sums, so
// the loads of a one-run group's next step stay in flight while the warp
// forms this step's codes.
struct XStep {
  unsigned cm;
  int p[4];
};

template <bool GRID>
__device__ __forceinline__ XStep explain_step(const ExplainArgs& a, const Group& gr, int e,
                                              int c1) {
  XStep x;
  const unsigned char* compat = a.node_compat + (size_t)gr.g * a.Ep;
  const bool v4 = a.vec && e + 3 < c1;
  if (v4) {
    x.cm = *reinterpret_cast<const unsigned*>(compat + e);
  } else {
    x.cm = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < c1) x.cm |= (unsigned)compat[e + c] << (8 * c);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) x.p[c] = 0;
  if constexpr (!GRID) {  // the local team's placed row (its columns are within the chunk)
    if (e < c1) {
      const int4 v = ld4(gr.pl + e);
      x.p[0] = v.x, x.p[1] = v.y, x.p[2] = v.z, x.p[3] = v.w;
    }
    return x;
  }
  if (gr.nruns == 0) return x;
  const int* row0 = a.take_e + (size_t)__shfl_sync(FULL, gr.run0, 0) * a.Ep;
  if (v4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(row0 + e));
    x.p[0] = t.x, x.p[1] = t.y, x.p[2] = t.z, x.p[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < c1) x.p[c] = __ldg(&row0[e + c]);
  }
  for (int i = 1; i < gr.nruns; ++i) {
    const size_t s = (size_t)(i < 32 ? __shfl_sync(FULL, gr.run0, i) : __ldcg(&gr.runs[i]));
    const int* row_s = a.take_e + s * a.Ep;
    if (v4) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(row_s + e));
      x.p[0] = wadd(x.p[0], t.x);
      x.p[1] = wadd(x.p[1], t.y);
      x.p[2] = wadd(x.p[2], t.z);
      x.p[3] = wadd(x.p[3], t.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e + c < c1) x.p[c] = wadd(x.p[c], __ldg(&row_s[e + c]));
    }
  }
  return x;
}

// One step of a walk: the codes of the lane's 4 columns from the step's
// loads and the staged columns (read 16 bytes at a time). A lane's
// rejections are a 4-bit mask; their ranks come from a warp scan of the
// lanes' counts, so entries keep ascending column order. They are counted
// into `count`; the one of rank p (base_pos + its rank in the walk) is
// written to dst[p] while p < limit.
__device__ __forceinline__ void explain_emit(const ExplainArgs& a, const Stage& st,
                                             const Group& gr, const XStep& s, int e0, int c1,
                                             int* dst, int base_pos, int limit, int& count) {
  const int lane = threadIdx.x & 31;
  const int e = e0 + 4 * lane;
  const int k = e - st.base;  // a multiple of 4: the staged rows are read 16 bytes a lane
  int code[4] = {0, 0, 0, 0};
  unsigned bits = 0u;
  if (e < c1) {
    const int4 nz = ld4(st.zone + k), nc = ld4(st.ct + k);
    bool fits[4] = {true, true, true, true};
    for (int r = 0; r < a.R; ++r) {
      const int4 f = ld4(st.ff + r * st.stride + k);
      const int q = gr.req[r];
      fits[0] &= f.x >= q;
      fits[1] &= f.y >= q;
      fits[2] &= f.z >= q;
      fits[3] &= f.w >= q;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int z = at4(nz, c), t = at4(nc, c);
      const int zi = min(max(z, 0), a.Z - 1), ci = min(max(t, 0), a.C - 1);
      const bool zone_ok = z < 0 || (a.Z <= 32 ? (gr.zmask >> zi) & 1u
                                               : a.group_zone[(size_t)gr.g * a.Z + zi] != 0);
      const bool ct_ok = t < 0 || (a.C <= 32 ? (gr.cmask >> ci) & 1u
                                             : a.group_ct[(size_t)gr.g * a.C + ci] != 0);
      const bool ok = (s.cm >> (8 * c)) & 0xffu;
      code[c] = !zone_ok ? 1 : !ct_ok ? 2 : !ok ? 3 : !fits[c] ? 4 : gr.topo ? 5 : gr.aff ? 6 : 0;
      if (e + c < c1 && code[c] > 0 && s.p[c] <= 0) bits |= 1u << c;
    }
  }
  // the lanes' counts, scanned: this lane's first rank in the slice
  const int n = __popc(bits);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  const int first = base_pos + count + incl - n;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if ((bits >> c) & 1u) {
      const int pos = first + __popc(bits & ((1u << c) - 1u));
      if (pos < limit) dst[pos] = (e + c) | (code[c] << 16);
    }
  }
  count += __shfl_sync(FULL, incl, 31);
}

// One warp walks group gr's columns [c0, c1) in 128-column steps (lane l
// the 4 consecutive columns 4l..4l+3 of a step), the next step's loads
// issued before this step's codes. Stops after the step that reaches
// `stop_at`.
template <bool GRID>
__device__ __forceinline__ void explain_walk(const ExplainArgs& a, const Stage& st,
                                             const Group& gr, int c0, int c1, int* dst,
                                             int base_pos, int limit, int stop_at, int& count) {
  const int lane = threadIdx.x & 31;
  XStep cur = explain_step<GRID>(a, gr, c0 + 4 * lane, c1);
  for (int e0 = c0; e0 < c1; e0 += 128) {
    XStep nxt = cur;
    if (e0 + 128 < c1) nxt = explain_step<GRID>(a, gr, e0 + 128 + 4 * lane, c1);
    explain_emit(a, st, gr, cur, e0, c1, dst, base_pos, limit, count);
    if (count >= stop_at) return;
    cur = nxt;
  }
}

// Phase B: a CTA takes a tile of XW / nseg groups, a warp a group, or nseg
// warps a group over contiguous column segments. The final free table,
// node_zone and node_ct of the columns that can count (e < e_count) lie in
// shared memory for the whole tile: the local team computed them there; the
// grid stages them once for every tile of the CTA where they fit in one
// chunk, its copies in flight while the warps look up their first tile's
// runs. A group's walk needs no CTA barrier; with nseg > 1 the segments'
// counts meet in shared memory once: the first segment wrote its entries
// during its walk, a later one kept its first XK in shared memory and
// copies those the earlier segments left room for; only past XK does it
// walk again (from the staged columns).
template <bool GRID>
__device__ __forceinline__ void explain_rows(const ExplainArgs& a, XShared& xs, int* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int R = a.R, K = a.K, nseg = a.nseg, chunk = a.chunk, tiles = a.tiles;
  const int ecnt = min(a.Ep, max(a.e_count, 0));
  const int nchunks = (ecnt + chunk - 1) / chunk;
  const int gpt = XW / nseg;
  const int j = w % nseg;
  const int seg = ((ecnt + nseg - 1) / nseg + 127) & ~127;
  int* s_ff = sh;
  int* s_zone = sh + R * chunk;
  int* s_ct = s_zone + chunk;
  const Stage st{s_ff, s_zone, s_ct, 0, chunk};
  // every word of the chunk in flight at once (asynchronous copies to shared
  // memory; the caller waits, then its barrier publishes them); each CTA
  // starts at its own 32-word offset, so the CTAs that stage the same
  // columns at once spread over the L2's slices
  auto stage = [&](int c0) {
    const int n = min(chunk, ecnt - c0);
    const int rot = n > 0 ? (int)(((long long)blockIdx.x * 97 * 32) % n) & ~31 : 0;
    for (int r = 0; r < R + 2; ++r) {
      const int* src = r < R ? a.ff + (size_t)r * a.Ep + c0 : (r == R ? a.node_zone : a.node_ct) + c0;
      for (int i0 = threadIdx.x; i0 < n; i0 += XT) {
        const int i = i0 + rot < n ? i0 + rot : i0 + rot - n;
        cp_async4(s_ff + r * chunk + i, src + i);
      }
    }
  };
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.out[0] = a.Ep > 0xFFFF ? 1 : 0;
    a.out[1] = a.g_count;
    a.out[2] = K;
  }
  Group gr{};
  if ((int)blockIdx.x < tiles) {
    if (GRID && nchunks == 1) stage(0);
    const int g = blockIdx.x * gpt + w / nseg;
    if (GRID && g < a.Gp && g < a.g_count) explain_runs(a, g, gr);
    if (!GRID) gr.pl = s_ct + chunk + (w / nseg) * chunk;  // explain_local's placed rows
    if (GRID && nchunks == 1) {
      cp_async_wait_all();
      __syncthreads();
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = tile * gpt + w / nseg;
    const bool live = g < a.Gp;
    const bool real = live && g < a.g_count;
    int* row = a.out + 3 + (size_t)g * (1 + K);
    if (tile != (int)blockIdx.x) {  // the grid alone: the local team's grid is its tiles
      explain_consts(a, xs, tile);
      if (real) explain_runs(a, g, gr);
    }
    if (real) {
      gr.g = g;
      gr.req = xs.req[w];
      gr.zmask = xs.gm[w][0];
      gr.cmask = xs.gm[w][1];
      gr.topo = xs.gm[w][2] & 1u;
      gr.aff = xs.gm[w][2] & 2u;
    }
    int count = 0;
    const int c0 = j * seg, c1 = min(ecnt, c0 + seg);
    if (nchunks == 1) {
      // the first segment writes the row's slots; a later one keeps its
      // first XK entries in shared memory until the counts meet
      if (real && c0 < c1)
        explain_walk<GRID>(a, st, gr, c0, c1, j == 0 ? row + 1 : xs.ent[w], 0, j == 0 ? K : XK,
                           INT_MAX, count);
    } else {  // the grid, nseg 1
      for (int ch = 0; ch < nchunks; ++ch) {
        __syncthreads();  // the last chunk's readers are done
        stage(ch * chunk);
        cp_async_wait_all();
        __syncthreads();
        const Stage sc{s_ff, s_zone, s_ct, ch * chunk, chunk};
        if (real)
          explain_walk<GRID>(a, sc, gr, ch * chunk, min(ecnt, ch * chunk + chunk), row + 1, 0, K,
                             INT_MAX, count);
      }
    }
    int total = count;
    if (nseg > 1) {
      if (lane == 0) xs.cnt[w] = count;
      __syncthreads();
      int before = 0;
      total = 0;
      for (int i = 0; i < nseg; ++i) {
        const int c = xs.cnt[w - j + i];
        total += c;
        before += i < j ? c : 0;
      }
      if (real && j > 0 && count > 0 && before < K) {
        const int n = min(min(count, XK), K - before);
        for (int i = lane; i < n; i += 32) row[1 + before + i] = xs.ent[w][i];
        if (n < min(count, K - before)) {  // past XK kept: walk the segment again
          int again = 0;
          explain_walk<GRID>(a, st, gr, c0, c1, row + 1, before, K, K - before, again);
        }
      }
      __syncthreads();  // xs.cnt is read before the next tile writes it
    }
    if (live && j == 0) {
      if (lane == 0) row[0] = total;
      for (int i = min(total, K) + lane; i < K; i += 32) row[1 + i] = -1;
    }
  }
}

// K12 in one launch. The grid: the last CTA first sorts the runs by group,
// every CTA takes its strips' column sums and its first tile's group
// constants, one grid barrier, phase B. The local team (no barrier across
// CTAs, at most a CTA an SM where the groups allow, so its launch bounds
// leave it every register it needs): every CTA its own phase A in shared
// memory, then phase B.
template <bool GRID>
__global__ void __launch_bounds__(XT, GRID ? XB_CTAS : 1) explain_kernel(const ExplainArgs a) {
  extern __shared__ int sh[];
  __shared__ XShared xs;
  if constexpr (GRID) {
    if (blockIdx.x == gridDim.x - 1)
      explain_sort(a, xs, a.Gp + 1 <= XS_WORDS ? sh : a.cnt);
    explain_usage(a, sh);
    if ((int)blockIdx.x < a.tiles) explain_consts(a, xs, blockIdx.x);
    cg::this_grid().sync();
    explain_rows<true>(a, xs, sh);
  } else {
    explain_local(a, xs, sh);
    explain_rows<false>(a, xs, sh);
  }
}

// Shared words of the local team (explain_local's layout, its tile at XW
// groups): the staged free table, node_zone, node_ct and the tile's placed
// rows over at least 32 columns, the staged run_group and group_req.
static long long explain_local_words(int Sp, int Ep, int Gp, int R) {
  const long long cols = Ep <= 32 ? 32 : (Ep + 31LL) / 32 * 32;
  return (R + 2 + XW) * cols + Sp + (long long)Gp * R;
}

// The team (explain_team): the local team where every CTA can afford the
// whole take table (Sp * Ep at most EXPLAIN_LOCAL_CELLS, Gp at most
// EXPLAIN_LOCAL_GROUPS, its layout within the CTA's shared memory), else
// the cooperative grid.
static int explain_team(int Sp, int Ep, int Gp, int R) {
  return (long long)Sp * Ep <= EXPLAIN_LOCAL_CELLS && Gp <= EXPLAIN_LOCAL_GROUPS &&
                 explain_local_words(Sp, Ep, Gp, R) <= XS_WORDS
             ? EXPLAIN_LOCAL
             : EXPLAIN_GRID;
}

// CTAs of the grid instance a multiprocessor holds (the occupancy query at
// XS_BYTES, once per device), and the multiprocessors
struct ExplainFit {
  int per_sm;
  int sms;
  bool done;
};
ExplainFit g_xfit[MAX_DEVICES];

cudaError_t explain_fit(ExplainFit& out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  ExplainFit& f = g_xfit[dev];
  if (!f.done) {
    e = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(explain_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               XS_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(explain_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               XS_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, explain_kernel<true>, XT,
                                                        XS_BYTES);
    if (e != cudaSuccess) return e;
    f.done = true;
  }
  out = f;
  return cudaSuccess;
}

// A launch's shape for `team`: the grid's strip width and team, the
// segments a group, the staged chunk, the group tiles and the grid.
struct ExplainPlan {
  int sw, tw, nseg, chunk, grid, strips, tiles;
};

ExplainPlan explain_plan(int Sp, int Ep, int Gp, int R, int e_count, int team, int per_sm,
                         int sms) {
  ExplainPlan p{};
  const int ecnt = Ep < e_count ? Ep : (e_count > 0 ? e_count : 0);
  // the segments a group where one chunk holds every column: the most that
  // keeps the tiles within `cap` CTAs, none narrower than a 128-column step
  auto segments = [&](long long cap) {
    p.nseg = 1;
    if (ecnt <= p.chunk)
      while (p.nseg * 2 <= XW && p.nseg * 2 <= (ecnt + 127) / 128 &&
             ((long long)Gp * p.nseg * 2 + XW - 1) / XW <= cap)
        p.nseg *= 2;
    p.tiles = (Gp + XW / p.nseg - 1) / (XW / p.nseg);
  };
  if (team == EXPLAIN_LOCAL) {
    // every CTA its own phase A over the counted columns: a tile a CTA, at
    // most one CTA a multiprocessor where the groups allow
    p.chunk = ecnt <= 32 ? 32 : (ecnt + 31) / 32 * 32;
    segments(sms);
    p.grid = p.tiles;
    return p;
  }
  const long long gmax = (long long)per_sm * sms;
  // phase A: the strip width and team with the fewest dependent steps, a
  // step one batch of XA_ROWS row loads in flight a lane, and a round (the
  // strips the CTAs take at once) two more for its sums; ties keep the one
  // that needs fewer CTAs
  long long best = -1, best_need = 0;
  for (int sw = 8; sw <= 32; sw *= 2) {
    for (int tw = 1; tw <= XW; tw *= 2) {
      const long long strips = (Ep + sw - 1) / sw;
      const long long need = (strips + XW / tw - 1) / (XW / tw);
      const long long rounds = (need + gmax - 1) / gmax;
      const long long rows = (long long)tw * (32 / sw) * XA_ROWS;
      const long long cost = rounds * ((Sp + rows - 1) / rows + 2);
      if (best < 0 || cost < best || (cost == best && need < best_need)) {
        best = cost, best_need = need;
        p.sw = sw, p.tw = tw;
      }
    }
  }
  p.strips = (Ep + p.sw - 1) / p.sw;
  // phase B: the staged chunk, and the segments within the CTAs the card
  // holds at once
  p.chunk = (XS_WORDS / (R + 2)) & ~31;
  segments(gmax);
  long long need = best_need > p.tiles ? best_need : p.tiles;
  need = need < 1 ? 1 : need;
  p.grid = (int)(need < gmax ? need : gmax);
  return p;
}

}  // namespace

extern "C" {

// ptrs: run_placed, run_gang, gang_min_ranks, commit (out), placed (out);
// ints: S, NG.
int gang_commit_launch(void** p, int n, const int* d, void* stream) {
  if (n != 5) return (int)cudaErrorInvalidValue;
  const int S = d[0], NG = d[1];
  if (S < 0 || NG < 0) return (int)cudaErrorInvalidValue;
  gang_commit_kernel<<<1, GT, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const int*)p[1], (const int*)p[2], (unsigned char*)p[3], (int*)p[4],
      S, NG);
  return (int)cudaGetLastError();
}

// ptrs: node_free, victim_prio, victim_req, victim_ok, node_ok, need,
// node_idx (out, 1 int), take (out, [E, Vm] bool), best (scratch, 1 int);
// ints: E, Vm, R, pod_prio.
int preemption_plan_launch(void** p, int n, const int* d, void* stream) {
  if (n != 9) return (int)cudaErrorInvalidValue;
  const int E = d[0], Vm = d[1], R = d[2], pod_prio = d[3];
  if (E < 1 || Vm < 1 || R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* best = (int*)p[8];
  cudaError_t err = cudaMemsetAsync(best, 0x7f, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  static_assert(NO_NODE == 0x7f7f7f7f, "memset byte 0x7f");
  preempt_scan_kernel<<<(E + PW - 1) / PW, PW * 32, 0, st>>>(
      (const int*)p[0], (const int*)p[1], (const int*)p[2], (const unsigned char*)p[3],
      (const unsigned char*)p[4], (const int*)p[5], (unsigned char*)p[7], best, E, Vm, R,
      pod_prio);
  preempt_take_kernel<<<1, 32, 0, st>>>(
      (const int*)p[0], (const int*)p[1], (const int*)p[2], (const unsigned char*)p[3],
      (const int*)p[5], best, (int*)p[6], (unsigned char*)p[7], E, Vm, R, pod_prio);
  return (int)cudaGetLastError();
}

// ptrs: node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need,
// prio, wire (out, [2 + 3 cap] int32), node_free_out ([E, R]), victim_ok_out
// ([E, Vm]); ints: E, Vm, R, C, budget, cap, ctas (0: walk_ctas; 1: one
// block; WALK_CL: a cluster, both forced for the checks and the timing).
int preemption_walk_launch(void** p, int n, const int* d, void* stream) {
  if (n != 11) return (int)cudaErrorInvalidValue;
  WalkArgs a;
  a.node_free0 = (const int*)p[0];
  a.vprio = (const int*)p[1];
  a.vreq = (const int*)p[2];
  a.vok0 = (const unsigned char*)p[3];
  a.masks = (const unsigned char*)p[4];
  a.cand_row = (const int*)p[5];
  a.need = (const int*)p[6];
  a.prio = (const int*)p[7];
  a.wire = (int*)p[8];
  a.node_free = (int*)p[9];
  a.vok = (unsigned char*)p[10];
  a.E = d[0], a.Vm = d[1], a.R = d[2], a.C = d[3], a.budget = d[4], a.cap = d[5];
  int ctas = d[6];
  if (a.E < 1 || a.Vm < 1 || a.R < 1 || a.R > MAX_R || a.C < 0 || a.cap < 1 ||
      (ctas != 0 && ctas != 1 && ctas != WALK_CL))
    return (int)cudaErrorInvalidValue;
  if (ctas == 0) ctas = walk_ctas(a.E);
  cudaStream_t st = (cudaStream_t)stream;
  if (ctas == 1) {
    preempt_walk_kernel<false><<<1, WT, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // a cluster of 16 is past the portable 8
  cudaError_t e = cudaFuncSetAttribute(preempt_walk_kernel<true>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(WALK_CL, 1, 1);
  cfg.blockDim = dim3(WT, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = WALK_CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, preempt_walk_kernel<true>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dims: the barriers one walk block passes
int block_barrier_launch(void**, int, const int* d, void* stream) {
  if (d[0] < 0) return (int)cudaErrorInvalidValue;
  block_barrier_kernel<<<1, WT, 0, (cudaStream_t)stream>>>(d[0]);
  return (int)cudaGetLastError();
}

// Scratch words after the wire (ffd.py explain_scratch_words): ff [R, Ep],
// off [Gp + 1], cnt [Gp + 1], ids [Sp] (the grid's; the local team's lie in
// its shared memory).
static long long explain_scratch_words(int Sp, int Ep, int Gp, int R) {
  return (long long)R * Ep + 2LL * (Gp + 1) + Sp;
}

// ptrs: take_e, run_group, group_req, node_free, node_compat, node_zone,
// node_ct, group_zone, group_ct, group_topo, group_aff, then one buffer: the
// wire ([3 + Gp*(1+K)] int32, the output) followed by the scratch
// (explain_scratch_words); ints: Sp, Ep, Gp, R, Z, C, K, e_count, g_count,
// team (0: explain_team; EXPLAIN_LOCAL or EXPLAIN_GRID force one, for the
// checks and the timing; a forced local team needs its layout to fit).
int explain_pack_launch(void** p, int n, const int* d, void* stream) {
  if (n != 12) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], Ep = d[1], Gp = d[2], R = d[3], Z = d[4], C = d[5], K = d[6];
  int team = d[9];
  if (Sp < 0 || Ep < 0 || Gp < 1 || R < 0 || R > MAX_R || Z < 1 || C < 1 || K < 1 ||
      (team != 0 && team != EXPLAIN_LOCAL && team != EXPLAIN_GRID) ||
      (team == EXPLAIN_LOCAL && explain_local_words(Sp, Ep, Gp, R) > XS_WORDS))
    return (int)cudaErrorInvalidValue;
  if (team == 0) team = explain_team(Sp, Ep, Gp, R);
  ExplainFit f;
  cudaError_t e = explain_fit(f);
  if (e != cudaSuccess) return (int)e;
  if (f.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const ExplainPlan pl = explain_plan(Sp, Ep, Gp, R, d[7], team, f.per_sm, f.sms);
  ExplainArgs a;
  a.take_e = (const int*)p[0];
  a.run_group = (const int*)p[1];
  a.group_req = (const int*)p[2];
  a.node_free = (const int*)p[3];
  a.node_compat = (const unsigned char*)p[4];
  a.node_zone = (const int*)p[5];
  a.node_ct = (const int*)p[6];
  a.group_zone = (const unsigned char*)p[7];
  a.group_ct = (const unsigned char*)p[8];
  a.group_topo = (const unsigned char*)p[9];
  a.group_aff = (const unsigned char*)p[10];
  a.out = (int*)p[11];
  a.ff = a.out + 3 + (size_t)Gp * (1 + K);
  a.off = a.ff + (size_t)R * Ep;
  a.cnt = a.off + Gp + 1;
  a.ids = a.cnt + Gp + 1;
  a.Sp = Sp, a.Ep = Ep, a.Gp = Gp, a.R = R, a.Z = Z, a.C = C, a.K = K;
  a.e_count = d[7], a.g_count = d[8];
  a.sw = pl.sw, a.tw = pl.tw, a.nseg = pl.nseg, a.chunk = pl.chunk, a.tiles = pl.tiles;
  a.vec = (Ep & 3) == 0 && ((uintptr_t)a.take_e & 15) == 0 && ((uintptr_t)a.node_compat & 3) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (team == EXPLAIN_LOCAL) {
    explain_kernel<false><<<pl.grid, XT, XS_BYTES, st>>>(a);
    return (int)cudaGetLastError();
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)explain_kernel<true>, pl.grid, XT, args, XS_BYTES,
                                  st);
  cudaGetLastError();  // clear the launch's error state; e carries it
  return (int)e;
}

// Host query for ints Sp, Ep, Gp, R, e_count, team (0: explain_team): writes
// into the int64 host buffer ptrs[0] the team, the grid (CTAs), threads a
// CTA, CTAs a multiprocessor (the grid instance's occupancy), the
// multiprocessors, the strip width and the strip team's warps (the grid's
// phase A; 0 for the local team), the segments a group, the staged chunk's
// columns, the strips, the group tiles, the dynamic shared bytes a CTA, the
// scratch words and the local team's shared words.
int explain_info(void** p, int n, const int* d, void* stream) {
  (void)stream;
  if (n != 1) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], Ep = d[1], Gp = d[2], R = d[3];
  int team = d[5];
  if (Sp < 0 || Ep < 0 || Gp < 1 || R < 0 || R > MAX_R ||
      (team != 0 && team != EXPLAIN_LOCAL && team != EXPLAIN_GRID))
    return (int)cudaErrorInvalidValue;
  if (team == 0) team = explain_team(Sp, Ep, Gp, R);
  ExplainFit f;
  const cudaError_t e = explain_fit(f);
  if (e != cudaSuccess) return (int)e;
  const ExplainPlan pl = explain_plan(Sp, Ep, Gp, R, d[4], team, f.per_sm, f.sms);
  long long* out = (long long*)p[0];
  out[0] = team;
  out[1] = pl.grid;
  out[2] = XT;
  out[3] = f.per_sm;
  out[4] = f.sms;
  out[5] = pl.sw;
  out[6] = pl.tw;
  out[7] = pl.nseg;
  out[8] = pl.chunk;
  out[9] = pl.strips;
  out[10] = pl.tiles;
  out[11] = XS_BYTES;
  out[12] = explain_scratch_words(Sp, Ep, Gp, R);
  out[13] = explain_local_words(Sp, Ep, Gp, R);
  return (int)cudaSuccess;
}
}  // extern "C"
