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
// - K12: the take table is never multiplied by a group one-hot (Gp*Sp*Ep
//   multiply-adds): every run belongs to one group, so one pass over
//   take_e [Sp, Ep] adds each nonzero take into the node's usage [Ep, R] and
//   the (group, node) placed sum [Gp, Ep] (wrapped int32, order-free). Then
//   one block per group walks the nodes in ascending order, forms the code,
//   counts the rejected nodes and keeps the first top_k by a ballot/popc
//   prefix.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GT = 1024;  // threads of the gang verdict (one block)
constexpr int PW = 8;     // warps per block of the preemption scan (a node row each)
constexpr int XT = 256;   // threads of the explain kernels
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

// usage[e, r] += take * group_req[g, r] and placed[g, e] += take for every
// nonzero take_e[s, e] (g = run_group[s]); both zeroed by the launcher.
__global__ void __launch_bounds__(XT) explain_sums_kernel(
    const int* __restrict__ take_e, const int* __restrict__ run_group,
    const int* __restrict__ group_req, int* __restrict__ usage, int* __restrict__ placed,
    int Sp, int Ep, int Gp, int R) {
  const size_t n = (size_t)Sp * Ep;
  for (size_t i = (size_t)blockIdx.x * XT + threadIdx.x; i < n; i += (size_t)gridDim.x * XT) {
    const int t = take_e[i];
    if (t == 0) continue;
    const int s = (int)(i / Ep);
    const int e = (int)(i - (size_t)s * Ep);
    const int g = run_group[s];
    if (g < 0 || g >= Gp) continue;  // run_group lies in [0, Gp) by contract
    atomicAdd(&placed[(size_t)g * Ep + e], t);
    for (int r = 0; r < R; ++r) {
      const int u = wmul(t, group_req[(size_t)g * R + r]);
      if (u != 0) atomicAdd(&usage[(size_t)e * R + r], u);
    }
  }
}

// One block per group: out[3 + g*(1+K)] = the rejected count, then the first
// K rejected nodes ascending as e | (code << 16), -1 for an empty slot.
__global__ void __launch_bounds__(XT) explain_rows_kernel(
    const int* __restrict__ group_req, const int* __restrict__ node_free,
    const unsigned char* __restrict__ node_compat, const int* __restrict__ node_zone,
    const int* __restrict__ node_ct, const unsigned char* __restrict__ group_zone,
    const unsigned char* __restrict__ group_ct, const unsigned char* __restrict__ group_topo,
    const unsigned char* __restrict__ group_aff, const int* __restrict__ usage,
    const int* __restrict__ placed, int* __restrict__ out, int Ep, int Gp, int R, int Z,
    int C, int K, int e_count, int g_count) {
  __shared__ int warp_cnt[XT / 32];
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int* row = out + 3 + (size_t)g * (1 + K);
  for (int j = threadIdx.x; j < K; j += XT) row[1 + j] = -1;
  if (g == 0 && threadIdx.x == 0) {
    out[0] = Ep > 0xFFFF ? 1 : 0;
    out[1] = g_count;
    out[2] = K;
  }
  const bool real_g = g < g_count;
  const bool topo = group_topo[g] != 0;
  const bool aff = group_aff[g] != 0;
  __syncthreads();  // the -1 fill lands before any entry
  int total = 0;
  for (int e0 = 0; e0 < Ep; e0 += XT) {
    const int e = e0 + threadIdx.x;
    int code = 0;
    if (real_g && e < Ep && e < e_count && __ldcg(&placed[(size_t)g * Ep + e]) <= 0) {
      const int nz = node_zone[e];
      const int nc = node_ct[e];
      const bool zone_ok = nz < 0 || group_zone[(size_t)g * Z + (nz < Z - 1 ? nz : Z - 1)];
      const bool ct_ok = nc < 0 || group_ct[(size_t)g * C + (nc < C - 1 ? nc : C - 1)];
      bool fits = true;
      for (int r = 0; r < R; ++r)
        fits = fits && wsub(node_free[(size_t)e * R + r], __ldcg(&usage[(size_t)e * R + r])) >=
                           group_req[(size_t)g * R + r];
      code = !zone_ok ? 1
             : !ct_ok ? 2
             : !node_compat[(size_t)g * Ep + e] ? 3
             : !fits ? 4
             : topo ? 5
             : aff ? 6
             : 0;
    }
    const bool rej = code > 0;
    const unsigned bal = __ballot_sync(FULL, rej);
    if (lane == 0) warp_cnt[w] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int i = 0; i < XT / 32; ++i) {
      const int c = warp_cnt[i];
      before += i < w ? c : 0;
      chunk += c;
    }
    const int pos = total + before + __popc(bal & ((1u << lane) - 1u));
    if (rej && pos < K) row[1 + pos] = e | (code << 16);
    total += chunk;
    __syncthreads();  // every warp read warp_cnt before the next chunk writes it
  }
  if (threadIdx.x == 0) row[0] = total;
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

// ptrs: take_e, run_group, group_req, node_free, node_compat, node_zone,
// node_ct, group_zone, group_ct, group_topo, group_aff, out ([3 + Gp*(1+K)]
// int32), scratch ([Gp*Ep + Ep*R] int32, zeroed here);
// ints: Sp, Ep, Gp, R, Z, C, K, e_count, g_count.
int explain_pack_launch(void** p, int n, const int* d, void* stream) {
  if (n != 13) return (int)cudaErrorInvalidValue;
  const int Sp = d[0], Ep = d[1], Gp = d[2], R = d[3], Z = d[4], C = d[5], K = d[6];
  const int e_count = d[7], g_count = d[8];
  if (Sp < 0 || Ep < 0 || Gp < 1 || R < 0 || Z < 1 || C < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* placed = (int*)p[12];
  int* usage = placed + (size_t)Gp * Ep;
  const size_t scratch = ((size_t)Gp * Ep + (size_t)Ep * R) * sizeof(int);
  if (scratch) {
    cudaError_t err = cudaMemsetAsync(placed, 0, scratch, st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t cells = (size_t)Sp * Ep;
  if (cells) {
    size_t blocks = (cells + XT - 1) / XT;
    blocks = blocks > 4096 ? 4096 : blocks;
    explain_sums_kernel<<<(unsigned)blocks, XT, 0, st>>>(
        (const int*)p[0], (const int*)p[1], (const int*)p[2], usage, placed, Sp, Ep, Gp, R);
  }
  explain_rows_kernel<<<Gp, XT, 0, st>>>(
      (const int*)p[2], (const int*)p[3], (const unsigned char*)p[4], (const int*)p[5],
      (const int*)p[6], (const unsigned char*)p[7], (const unsigned char*)p[8],
      (const unsigned char*)p[9], (const unsigned char*)p[10], usage, placed, (int*)p[11], Ep,
      Gp, R, Z, C, K, e_count, g_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
