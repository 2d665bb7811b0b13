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
//                   (_ffd_scan :395): ffd_scan_kernel<false, false, false,
//                   false> the fast branch (step_body.fast :605-855),
//                   ffd_scan_kernel<true, false, false, false> adds the
//                   zoned branch (step_body.zoned :860-1663, count_contrib
//                   :587).
// K2 compact_takes  replaces karpenter_tpu/solver/tpu/ffd.py:325 compact_takes.
// K3 claim_meta     replaces karpenter_tpu/solver/tpu/ffd.py:358
//                   compact_claim_meta plus the c_mask word pack of
//                   karpenter_tpu/solver/backend.py:652-660.
// K4 ffd_batched    replaces karpenter_tpu/solver/tpu/consolidate.py:57
//                   _batched_ffd_core (jit :97): ffd_scan_kernel<ZONE, true,
//                   false, false>, one block per candidate-subset row.
// K5 pack_verdicts  replaces karpenter_tpu/solver/tpu/consolidate.py:291
//                   _pack_verdicts.
// K6 ffd_ladder     replaces karpenter_tpu/solver/tpu/ffd.py:2167
//                   ffd_solve_ladder (step_ladder :1714-1800):
//                   ffd_scan_kernel<ZONE, false, true, false>, the
//                   relax-ladder cascade of attempts per run.
// K7 ffd_ckpt       replaces karpenter_tpu/solver/tpu/ffd.py:1975
//                   ffd_solve_ckpt and :2071 ffd_resume (step_ck
//                   :1825-1850): ffd_scan_kernel<ZONE, false, false, true>,
//                   K1's scan that also snapshots its whole carry into a
//                   device-resident ring every K steps.
// K9 pack_outputs   replaces karpenter_tpu/solver/backend.py:511 _pack_outputs.
// K15 ffd_lanes     replaces karpenter_tpu/parallel/sharded.py:80 batched_solve:
//                   ffd_lanes_kernel<ZONE>, K1's scan body on each of B
//                   lanes, one block per lane; built from
//                   ffd_lanes_kernels.cu (this file with FFD_LANES_ONLY).
// K1s/K6s/K7s       replace karpenter_tpu/solver/tpu/ffd.py:2403
//                   ffd_solve_sparse, :2701 ffd_solve_ladder_sparse, :2500
//                   ffd_solve_ckpt_sparse and :2602 ffd_resume_sparse: the
//                   fifth template flag SPARSE of K1/K6/K7, built from
//                   ffd_sparse_kernels.cu (this file with FFD_SPARSE_ONLY).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 1024;          // threads of the single-block kernels
constexpr int NWARPS = NT / 32;
constexpr int BIG = 1 << 30;
constexpr int I32MAX = 2147483647;
constexpr int MAX_Q = 256;        // solver/cuda/ffd.py MAX_Q
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

// ---- block-wide helpers (all NT threads must call them) --------------------

__device__ int block_max(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sh[0];
  for (int i = 1; i < NWARPS; ++i) r = max(r, sh[i]);
  __syncthreads();
  return r;
}

__device__ int block_min(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sh[0];
  for (int i = 1; i < NWARPS; ++i) r = min(r, sh[i]);
  __syncthreads();
  return r;
}

__device__ unsigned block_sum(unsigned v, unsigned* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned r = 0;
  for (int i = 0; i < NWARPS; ++i) r += sh[i];
  __syncthreads();
  return r;
}

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

// ---- K1: the FFD scan --------------------------------------------------------
//
// What bounds it on the H100: the scan is sequential over runs, and a run's
// work is small — the [used, T] claim fit (about M·T·R integer divisions)
// plus per-pool [T] passes — so one block can hold the whole carry and the
// card is latency-bound, far from both its memory and its integer peak.
// Design: ONE launch per dispatch, one block of 1024 threads walks every
// run; phases inside a run are separated by __syncthreads(). The carry
// (FFDState) lives in global buffers the wrapper allocated; per-run rows
// (req, Q flags) sit in shared memory. The claim pass runs one warp per
// OPEN claim (rows >= used have c_pool == -1 and capacity 0, so the pour
// over [0, used) is exact), and only claims that received pods recompute
// their type mask. Pools are walked in order inside the kernel.
//
// The kernel is a template on ZONE, the JAX scan's static zone_engine.
// ZONE=false (a solve without V-axis sigs) is the fast branch alone.
// ZONE=true adds, per run, the `constrained` test (ffd.py:1662): a run whose
// group owns a V-axis sig or is a member of an anti sig goes through the
// domain event engine (zoned_run below, ffd.py:860-1651); every other run
// takes the fast branch and records its V-axis counts (count_contrib
// :587-600) and claim-local matches (c_vm). The engine loops events in the
// same block; each event's [Z] domain vectors and [P] pool rows sit in
// shared memory (Z <= 32, one warp or one thread walks them), the per-claim
// [M,T] and [M,Z,T] tests run one warp per open claim on the fly and keep
// only [M] and [M,Z] results in global scratch, the [P,T] pool pass runs
// one warp per pool, and v_count / v_owner_z / c_vm / c_vo stay in global
// memory.

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
  // the subset rows, and this block's [E] removed-node mask
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

struct RunShared {
  int req[MAX_R];
  int charge[MAX_R];
  int mg[MAX_Q], og[MAX_Q], kq[MAX_Q], cq[MAX_Q];
  unsigned tot[MAX_Q];
  int qcol[MAX_Q];  // SPARSE: slot -> Q column (-1 padding)
  int red[NWARPS];
  unsigned ured[NWARPS];
  int any_owned2, boot2, fresh_allow, remaining, used, cap2, n_new, full_take;
  int has_e_boot, e_first, has_c_boot, c_first;
  int skip;
};

// Shared state of the zoned branch (ZONE=true only): the run's V-axis
// flags and every [Z] / [P] vector and scalar of one event. The V-axis rows
// (mv, ov, vk; vcol in the sparse instances) point into dynamic shared
// memory sized at launch to the dispatch (zone_rows_bytes): max(V, Kv) rows
// of mv/ov/vk, because a constrained run of a sparse instance reloads the
// dense flags at full width, and Kv slots of vcol. So V is bounded by the
// card's opt-in shared memory less the instance's static share
// (ffd_zone_max_v), not by a constant.
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
  int contrib[MAX_Z], owner_rec[MAX_Z];
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
  if constexpr (SPARSE) return sh.qcol[q]; else return q;
}

// hostname allowance of one row (Q axis) over the nq slots of the run's
// view; the fast branch's owner is o & (kind != 2) (kind2_owner false), the
// zoned branch's the full o; cm/co == nullptr reads zeros (fresh claims)
template <bool KIND2_OWNER = false, bool SPARSE = false>
__device__ int row_allowance(const RunShared& sh, int nq, const int* cm, const int* co) {
  int best = BIG;
  for (int q = 0; q < nq; ++q) {
    const int kind = sh.kq[q];
    const bool member = sh.mg[q], owner = sh.og[q] && (KIND2_OWNER || kind != 2);
    const bool relevant = owner || (kind == 1 && member);
    if (!relevant) continue;
    const int col = qcol_of<SPARSE>(sh, q);
    const int c = cm ? cm[col] : 0, o = co ? co[col] : 0;
    int v;
    if (kind == 0) {
      v = member ? wsub(sh.cq[q], c) : (wadd(c, 1) <= sh.cq[q] ? BIG : 0);
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
    if (sh.og[q] && sh.kq[q] == 2) best = min(best, cm[qcol_of<SPARSE>(sh, q)] > 0 ? BIG : 0);
  return best;
}

__device__ __forceinline__ int fit_rows(const int* alloc, const int* cum, const int* req, int R) {
  int k = BIG;
  for (int r = 0; r < R; ++r)
    if (req[r] > 0) k = min(k, floordiv(wsub(alloc[r], cum[r]), req[r]));
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

template <bool BATCH, bool LADDER>
__device__ void zoned_run(const ScanArgs& a, RunShared& sh, ZoneShared& zs, const Scratch& x,
                          int s, int g) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
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
  for (int e = tid; e < E; e += NT) a.take_e[take_row<BATCH || LADDER>(s, E) + e] = 0;
  for (int m = tid; m < M; m += NT) x.c_take[m] = 0;
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
      bool blk = false;
      for (int v = 0; v < V; ++v) {
        if (zs.ov[v] && (zs.vk[v] == 1 || zs.vk[v] == 3) && a.v_count[v * Z + z] > 0) blk = true;
        if (zs.mv[v] && zs.vk[v] == 1 && a.v_owner_z[v * Z + z]) blk = true;
      }
      zs.blk[z] = blk;
      zs.pos_node[z] = BIG;
      zs.pos_claim[z] = BIG;
      zs.first_ez[z] = I32MAX;
      zs.first_cz[z] = I32MAX;
      zs.contrib[z] = 0;
      zs.kmax_z[z] = 0;
    }
    for (int i = tid; i < Z * MAX_R; i += NT) zs.charge_zr[i / MAX_R][i % MAX_R] = I32MAX;
    for (int i = tid; i < P * MAX_R; i += NT) zs.charge_p[i / MAX_R][i % MAX_R] = I32MAX;
    if (tid == 0) {
      zs.multi_claim = 0;
      zs.tgts_bad = 0;
      zs.c_first = I32MAX;
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

    // ---- existing-node candidate (ffd.py:934-944) -------------------------------
    {
      int my_first = I32MAX;
      for (int e = tid; e < E; e += NT) {
        const int fit = fit_rows(a.node_free + e * R, a.e_cum + e * R, sh.req, R);
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
      const int e_first = block_min(my_first, sh.red);
      if (tid == 0) zs.e_first = e_first;
    }

    // ---- open-claim candidates (ffd.py:946-1011), one warp per claim -----------
    for (int m = wid; m < used0; m += NWARPS) {
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
      for (int t = lane; t < T; t += 32) {
        if (!mask[t] || !compat[t]) continue;
        const int k = fit_rows(a.type_alloc + t * R, cum, sh.req, R);
        if (node_ok && (bits_eff & a.offer_zc_bits[t]) != 0u) kbest = max(kbest, k);
        const unsigned zt = czb & g_zc & a.offer_zc_bits[t];
        if (k >= 1 && zt != 0u)
          for (int z = 0; z < Z; ++z)
            if (zt & zs.zcm[z]) atomicMax(&zs.kpz[wid][z], k);
      }
      const int k_m = warp_max(kbest);
      __syncwarp();
      const bool claim_ok = is_open && pair_ok && pool_ok && host > 0 && anti_ok;
      bool emz = false;
      if (lane < Z) {
        const int kp = zs.kpz[wid][lane];
        emz = claim_ok && kp > 0;
        x.caps_mz[(size_t)m * Z + lane] = (emz && zs.elig[lane]) ? min(kp, host) : 0;
        if (emz) atomicMin(&zs.pos_claim[lane], E + m);
      }
      const unsigned mz = __ballot_sync(FULL, emz);
      if (lane == 0) {
        const bool elig_m = k_m > 0 && host > 0;
        x.c_bits[m] = bits_eff;
        x.c_km[m] = k_m;
        x.c_host[m] = host;
        x.c_flag[m] = (elig_m ? 1 : 0) | (node_ok ? 2 : 0);
        unsigned eligmask = 0u;
        for (int z = 0; z < Z; ++z) eligmask |= zs.elig[z] ? 1u << z : 0u;
        if ((mz & eligmask) != 0u && zcount > 1) zs.tgts_bad = 1;
        if (elig_m) {
          atomicMin(&zs.c_first, m);
          if (zcount > 1) zs.multi_claim = 1;
          if (zcount == 1)
            for (int z = 0; z < Z; ++z)
              if ((czb & zs.zcm[z]) != 0u) atomicMin(&zs.first_cz[z], m);
        }
      }
    }

    // ---- per-pool new-claim candidates (ffd.py:1076-1135), one warp per pool --
    for (int p = wid; p < P; p += NWARPS) {
      const unsigned pzb = a.pool_zc_bits[p] & g_zc;
      unsigned nbits = 0u;
      int has_inter = 0;
      if (lane == 0) {
        unsigned inter = 0u, az = 0u;
        for (int z = 0; z < Z; ++z)
          if ((pzb & zs.zcm[z]) != 0u && zs.A[z]) { inter |= 1u << z; az |= zs.zcm[z]; }
        const bool aff = zs.has_affs && zs.any_present;
        const bool commit = zs.has_tsc || aff || zs.has_anti;
        const int dz = domain_argmin(zs, Z, inter, zs.has_tsc ? 0 : aff ? 1 : 2);
        nbits = (commit ? zs.zcm[dz] : az) & pzb;
        has_inter = inter != 0u;
      }
      nbits = __shfl_sync(FULL, nbits, 0);
      has_inter = __shfl_sync(FULL, has_inter, 0);
      const int* daemon = a.pool_daemon + p * R;
      int kmax = 0;
      for (int t = lane; t < T; t += 32) {
        const bool fit = compat[t] && a.pool_type[(size_t)p * T + t] &&
                         (nbits & a.offer_zc_bits[t]) != 0u;
        if (!fit) continue;
        const int k = fit_rows(a.type_alloc + t * R, daemon, sh.req, R);
        kmax = max(kmax, k);
        if (k >= 1)
          for (int r = 0; r < R; ++r) atomicMin(&zs.charge_p[p][r], a.type_charge[t * R + r]);
      }
      kmax = warp_max(kmax);
      __syncwarp();
      if (lane == 0) {
        bool over = false;
        for (int r = 0; r < R; ++r) {
          if (zs.charge_p[p][r] == I32MAX) zs.charge_p[p][r] = 0;
          if (a.p_usage[p * R + r] >= a.pool_limit[p * R + r]) over = true;
        }
        zs.nbits_p[p] = nbits;
        zs.kmax_p[p] = kmax;
        zs.elig_p[p] = a.group_pool[g * P + p] && has_inter && kmax > 0 && !over &&
                       used0 < M && sh.fresh_allow > 0;
      }
    }
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
      const unsigned not_zp = ~zs.zcm[zs.z_p];
      bool comm = true, fre = true;
      for (int m = tid; m < used0; m += NT) {
        const bool elig_m = x.c_flag[m] & 1;
        const int caps = elig_m ? min(x.c_km[m], x.c_host[m]) : 0;
        x.c_full[m] = caps;
        if (elig_m) {
          const unsigned b = x.c_bits[m];
          if ((b & not_zp) != 0u) comm = false;
          int ze = 0;
          for (int z = 0; z < Z; ++z) ze += ((b & zs.zcm[z]) != 0u && zs.gax[z]) ? 1 : 0;
          if (!(ze > 1)) fre = false;
        }
      }
      const int all_comm = __syncthreads_and(comm);
      const int all_free = __syncthreads_and(fre);
      block_exclusive_scan(x.c_full, x.c_apref, used0, sh.ured);
      const bool aff_bulk =
          zs.has_affs && !zs.has_tsc && !zs.self_anti && !zs.has_anti && !zs.any_ma &&
          !zs.found_e && zs.found_c && zs.found_p &&
          ((zs.any_present && zs.nz_fin_p == 1 && all_comm) ||
           (!zs.any_present && zs.is_member_a && all_free && zs.nz_fin_p > 1));
      unsigned drained = 0;
      if (aff_bulk)
        for (int m = tid; m < used0; m += NT)
          drained += (unsigned)min(max(wsub(remaining, x.c_apref[m]), 0), x.c_full[m]);
      drained = block_sum(drained, sh.ured);
      if (tid == 0) {
        zs.aff_bulk = aff_bulk;
        const int rem_p = wsub(remaining, (int)drained);
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
      for (int t = tid; t < T; t += NT) {
        const int kc = fit_rows(a.type_alloc + t * R, a.pool_daemon + p * R, sh.req, R);
        x.k_cap[t] = kc;
        if (!compat[t] || !a.pool_type[(size_t)p * T + t]) continue;
        const unsigned off = pz & a.offer_zc_bits[t];
        if (off == 0u) continue;
        for (int z = 0; z < Z; ++z) {
          if ((off & zs.zcm[z]) == 0u) continue;
          atomicMax(&zs.kmax_z[z], kc);
          if (kc >= 1)
            for (int r = 0; r < R; ++r) atomicMin(&zs.charge_zr[z][r], a.type_charge[t * R + r]);
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
      // slot order, then the fresh claims each domain still needs
      if (tid < Z) {
        const int z = tid;
        unsigned pref = 0u;
        int tm = 0;
        for (int m = 0; m < used0; ++m) {
          const int caps = x.caps_mz[(size_t)m * Z + z];
          const int take = min(max(wsub(zs.T_zv[z], (int)pref), 0), caps);
          x.take_mz[(size_t)m * Z + z] = take;
          pref += (unsigned)caps;
          tm = wadd(tm, take);
        }
        const int fr = wsub(zs.T_zv[z], tm);
        zs.fr_z[z] = fr;
        zs.n_z[z] = ceildiv(fr, zs.km0);
        zs.base_z[z] = zs.elig[z] ? wadd(zs.cnt_p[z], tm) : BIG;
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
        // fresh-claim slot order: rank (z, g) by (count at open, lex z)
        const int km0 = zs.km0, n_mega = zs.n_mega;
        for (int j = tid; j < M; j += NT) { x.scat_z[j] = 0; x.scat_take[j] = 0; }
        __syncthreads();
        for (int i = tid; i < n_mega; i += NT) {
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
    unsigned placed = 0;
    // existing nodes
    for (int e = tid; e < E; e += NT) {
      int add = (zs.use_e && e == zs.e_star) ? zs.q_e : 0;
      if (zs.cyc_eff) {
        const int nd = node_dom(a, zs, e);
        if (nd >= 0 && nd < Z && zs.tgt_e[nd] == e) add = wadd(add, zs.per_tgt);
      }
      if (add == 0) continue;
      for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = wadd(a.e_cum[e * R + r], wmul(add, sh.req[r]));
      for (int q = 0; q < Q; ++q) {
        if (sh.mg[q]) a.e_cm[e * Q + q] = wadd(a.e_cm[e * Q + q], add);
        if (add > 0 && sh.og[q] && sh.kq[q] == 1) a.e_co[e * Q + q] = wadd(a.e_co[e * Q + q], 1);
      }
      a.take_e[take_row<BATCH || LADDER>(s, E) + e] =
          wadd(a.take_e[take_row<BATCH || LADDER>(s, E) + e], add);
      node_contrib(a, zs.contrib, e, add);
      placed += (unsigned)add;
    }
    // open claims: pours, balanced-cycle targets, affinity-bulk and
    // water-fill drains, one warp per claim
    for (int m = wid; m < used0; m += NWARPS) {
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
      for (int t = lane; t < T; t += 32) {
        bool mk = mask[t];
        const int k = fit_rows(a.type_alloc + t * R, cum, sh.req, R);
        if (add > 0) {
          const bool fit = mk && compat[t] && (bits_eff & a.offer_zc_bits[t]) != 0u;
          mk = fit && (node_ok ? k : 0) >= add;
        }
        if (drain > 0) mk = mk && compat[t] && (cz_after & a.offer_zc_bits[t]) != 0u && k >= drain;
        mask[t] = mk;
      }
      __syncwarp();
      if (lane == 0) {
        const int tot = wadd(add, drain);
        const int nco = (add > 0 ? 1 : 0) + (drain > 0 ? 1 : 0);
        for (int r = 0; r < R; ++r) a.c_cum[m * R + r] = wadd(a.c_cum[m * R + r], wmul(tot, sh.req[r]));
        a.c_zc_bits[m] = cz_after;
        if (add > 0 || drain > 0) a.c_gbits[(size_t)m * W + gword] |= gbit;
        for (int q = 0; q < Q; ++q) {
          if (sh.mg[q]) a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], tot);
          if (sh.og[q] && sh.kq[q] == 1) a.c_co[m * Q + q] = wadd(a.c_co[m * Q + q], nco);
        }
        for (int v = 0; v < V; ++v) {
          if (zs.mv[v]) a.c_vm[m * V + v] = wadd(a.c_vm[m * V + v], tot);
          if (add > 0 && zs.ov[v] && zs.vk[v] == 1) a.c_vo[m * V + v] = 1;
        }
        x.c_take[m] = wadd(x.c_take[m], tot);
        claim_contrib(zs, zs.contrib, Z, cz_after, tot);
        placed += (unsigned)tot;
      }
    }
    // fresh claims: the (A) multi-claim open or the (B) mega generations
    const int n_fresh = zs.use_p ? zs.n_open_p : zs.n_mega;
    for (int j = wid; j < n_fresh; j += NWARPS) {
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
      for (int t = lane; t < T; t += 32) {
        const bool fit = compat[t] && a.pool_type[(size_t)p * T + t] &&
                         (bits & a.offer_zc_bits[t]) != 0u;
        const int k = !fit ? 0 : zs.use_p ? fit_rows(a.type_alloc + t * R, daemon, sh.req, R)
                                          : x.k_cap[t];
        mask[t] = fit && k >= take;
      }
      if (lane == 0) {
        for (int r = 0; r < R; ++r) a.c_cum[m * R + r] = wadd(daemon[r], wmul(take, sh.req[r]));
        a.c_zc_bits[m] = bits;
        for (int w = 0; w < W; ++w) a.c_gbits[(size_t)m * W + w] = (w == gword) ? gbit : 0u;
        a.c_pool[m] = p;
        for (int q = 0; q < Q; ++q) {
          a.c_cm[m * Q + q] = sh.mg[q] ? take : 0;
          a.c_co[m * Q + q] = (take > 0 && sh.og[q] && sh.kq[q] == 1) ? 1 : 0;
        }
        for (int v = 0; v < V; ++v) {
          a.c_vm[m * V + v] = zs.mv[v] ? take : 0;
          if (zs.use_p) a.c_vo[m * V + v] = take > 0 && zs.ov[v] && zs.vk[v] == 1;
        }
        x.c_take[m] = wadd(x.c_take[m], take);
        claim_contrib(zs, zs.contrib, Z, bits, take);
        placed += (unsigned)take;
      }
    }
    placed = block_sum(placed, sh.ured);  // also orders the contrib atomics
    // domain counts, anti-owner registration and the event's bookkeeping
    for (int i = tid; i < V * Z; i += NT) {
      const int v = i / Z, z = i % Z;
      if (zs.mv[v]) a.v_count[i] = wadd(a.v_count[i], zs.contrib[z]);
      if (zs.ov[v] && zs.vk[v] == 1 && zs.owner_rec[z]) a.v_owner_z[i] = 1;
    }
    if (tid == 0) {
      const int p = zs.p_star;
      const int n_open = zs.use_p ? zs.n_open_p : 0;
      for (int r = 0; r < R; ++r) {
        a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(zs.charge_p[p][r], n_open));
        if (zs.mega_ok) a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(zs.charge0[r], zs.n_mega));
      }
      sh.used = used0 + n_open + zs.n_mega;
      zs.remaining = wsub(remaining, (int)placed);
      zs.progress = placed > 0;
      zs.fuel = wsub(zs.fuel, 1);
      zs.events += 1;
    }
    __syncthreads();
  }
  for (int m = tid; m < M; m += NT) a.take_c[take_row<BATCH || LADDER>(s, M) + m] = x.c_take[m];
  if (tid == 0) {
    a.leftover[s] = zs.remaining;
    *a.events = wadd(*a.events, zs.events);
  }
  __syncthreads();
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
// bound, one block), so a batch is bound by rows / SMs waves of K1-sized
// work; the carry is per row ([E, Q] hostname counts are the largest part).
// Design: one block per row (grid = B), the same kernel body as K1 under a
// second template flag, so the single-solve instances keep their code. The
// prologue below moves every carry pointer to the block's row, seeds the
// carry in place (no host-side copies of the seeds per row), and computes
// the row's [E] removed-node mask from node_cand and the row's cand_member
// into the block's scratch; node_compat reads AND it in (node_compat_at).
// The current run's take rows live in the same scratch (take_row = 0): the
// body reads them back within a run, and verdict mode emits none.
__device__ void batch_row_prologue(ScanArgs& a) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
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
  // the carry's initial values (FFDState at a cold solve), row b's seeds
  for (int e = tid; e < E; e += NT) {
    const int k = a.node_cand[e];
    const bool rm = k >= 0 && a.cand_member[min(k, a.NC - 1)];
    a.removed[e] = rm;
    for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = 0;
    for (int q = 0; q < Q; ++q) {
      a.e_cm[e * Q + q] = rm ? 0 : a.node_q_member[e * Q + q];
      a.e_co[e * Q + q] = rm ? 0 : a.node_q_owner[e * Q + q];
    }
  }
  for (int i = tid; i < M * R; i += NT) a.c_cum[i] = 0;
  for (int i = tid; i < M * T; i += NT) a.c_mask[i] = 0;
  for (int i = tid; i < M; i += NT) { a.c_zc_bits[i] = 0u; a.c_pool[i] = -1; }
  for (int i = tid; i < M * W; i += NT) a.c_gbits[i] = 0u;
  for (int i = tid; i < M * Q; i += NT) { a.c_cm[i] = 0; a.c_co[i] = 0; }
  for (int i = tid; i < V * Z; i += NT) { a.v_count[i] = a.v_count0[i]; a.v_owner_z[i] = 0; }
  for (int i = tid; i < M * V; i += NT) { a.c_vm[i] = 0; a.c_vo[i] = 0; }
  for (int i = tid; i < P * R; i += NT) a.p_usage[i] = a.pool_usage0[i];
  if (tid == 0) { *a.used = 0; *a.events = 0; }
  __syncthreads();
}

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
// What bounds it on the H100: as K1, one block walking a serial chain; the
// chain is now one step body per attempt, and a pod that relaxes costs at
// least two (its base attempt and the rung that places it), so a run whose
// pods all relax costs >= 2 * count serial bodies.
// Design: the run loop's header picks the attempt (its group and count) and
// the loop's increment folds it into the run, so the body is K1's, with no
// change for the other instances. The cascade state (level, remaining,
// fuel) is uniform over the block and every thread keeps its own copy in
// registers, computed from the same global values after a block barrier.
// Each attempt writes its take rows and leftover to scratch (take_row = 0),
// the increment adds them into the run's output rows, and every attempt
// commits its carry, as the JAX while_loop commits its state.

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
__device__ bool ladder_attempt(const ScanArgs& a, Cascade& c, int s, int& g, int& count) {
  if (c.s != s) {
    c.s = s;
    c.lvl = 0;
    c.rem = count;
    c.fuel = wadd(wmul(wadd(count, 1), a.Lw + 2), 4);
    for (int e = threadIdx.x; e < a.E; e += NT) a.out_take_e[(size_t)s * a.E + e] = 0;
    for (int m = threadIdx.x; m < a.M; m += NT) a.out_take_c[(size_t)s * a.M + m] = 0;
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
  if (threadIdx.x == 0) a.out_leftover[s] = count > 0 ? c.rem : 0;
  return false;
}

// The increment of the run loop: K1 and K4 go to the next run; K6 folds the
// attempt that ran into run s (takes into its output rows, placed pods into
// the cascade) and stays on s, or moves on when no attempt ran.
template <bool LADDER>
__device__ __forceinline__ int next_run(const ScanArgs& a, Cascade& c, int s) {
  if constexpr (!LADDER) {
    return s + 1;
  } else {
    if (!c.ran) return s + 1;
    for (int e = threadIdx.x; e < a.E; e += NT)
      a.out_take_e[(size_t)s * a.E + e] = wadd(a.out_take_e[(size_t)s * a.E + e], a.take_e[e]);
    for (int m = threadIdx.x; m < a.M; m += NT)
      a.out_take_c[(size_t)s * a.M + m] = wadd(a.out_take_c[(size_t)s * a.M + m], a.take_c[m]);
    const int placed = wsub(c.cnt, a.leftover[s]);
    c.lvl = c.base ? 1 : (placed > 0 ? 0 : c.lvl + 1);
    c.rem = wsub(c.rem, placed);
    c.fuel = wsub(c.fuel, 1);
    c.ran = 0;
    if (threadIdx.x == 0) *a.attempts += 1;
    return s;
  }
}

// K7: the loop increment of the checkpointed scan. Every path out of a
// run's body reaches it (the padded run's and the zoned run's `continue`
// too), so the step at position pos = s + 1 snapshots the whole carry into
// ring slot ((pos / K) - 1) % n when pos % K == 0, padded steps included,
// and records prefix[slot] = pos (ffd.py:1838-1846). Between a barrier that
// makes the step's writes visible and one that keeps the next step from
// writing a field before it is copied, the block copies each field (16 B
// per thread where both ends are 16-byte aligned); the claim count is the
// block's shared copy, which reaches *a.used only at the end. The zoned
// event counter is not part of the carry and stays out. Identity (no code)
// for CKPT=false.
__device__ void block_copy(unsigned char* dst, const unsigned char* src, size_t n) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0u) {
    const size_t n16 = n >> 4;
    for (size_t i = threadIdx.x; i < n16; i += NT)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    for (size_t i = (n16 << 4) + threadIdx.x; i < n; i += NT) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
  }
}

template <bool CKPT>
__device__ __forceinline__ int snapshot(const ScanArgs& a, const RunShared& sh, int s) {
  if constexpr (CKPT) {
    const int pos = s + 1;
    if (pos % a.ck_every == 0) {
      __syncthreads();
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
        if (f != 6) block_copy(a.ring[f] + slot * nb[f], src[f], nb[f]);
      if (threadIdx.x == 0) {
        reinterpret_cast<int*>(a.ring[6])[slot] = sh.used;
        a.ring_prefix[slot] = pos;
      }
      __syncthreads();
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
// What bounds it on the H100: as K1 (one block, latency-bound); the view
// narrows the fast branch's per-row Q and V loops to Kq / Kv slots.
// Design: K1's body under a fifth template flag, so the dense instances
// keep their code; the index tables ride beside the 32 scan inputs.

}  // namespace

// The zoned instances' V-axis rows (ZoneShared::mv/ov/vk/vcol), at file
// scope: an extern shared array does not belong in the unnamed namespace.
extern __shared__ __align__(16) unsigned char zone_rows[];

namespace {

// Bytes of those rows for one launch: vk and vcol as int, mv and ov as bytes.
__host__ __device__ __forceinline__ int zone_rows_bytes(int V, int Kv) {
  const int vd = V > Kv ? V : Kv;
  return 6 * vd + 4 * Kv;
}

__device__ __forceinline__ void bind_zone_rows(ZoneShared& zs, int V, int Kv) {
  const int vd = max(V, Kv);
  zs.vk = reinterpret_cast<int*>(zone_rows);
  zs.vcol = zs.vk + vd;
  zs.mv = reinterpret_cast<unsigned char*>(zs.vcol + Kv);
  zs.ov = zs.mv + vd;
}

// The scan body of every instance below: ffd_scan_kernel's and, for K15,
// ffd_lanes_kernel's. Inlined into each kernel, so an instance compiles as
// it did when this body was the kernel's own.
template <bool ZONE, bool BATCH, bool LADDER, bool CKPT, bool SPARSE>
__device__ __forceinline__ void scan_body(ScanArgs& a) {
  __shared__ RunShared sh;
  ZoneShared* zs = nullptr;
  Scratch x{};
  if constexpr (ZONE) {
    __shared__ ZoneShared zone_sh;
    zs = &zone_sh;
    x = zone_scratch(a);
  }
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = a.T, E = a.E, P = a.P, R = a.R, Q = a.Q, W = a.W, M = a.M;
  int* e_full = a.scratch;          // [E] cap_full, then the pour cap / prefix
  int* e_boot = e_full + E;         // [E]
  int* c_full = e_boot + E;         // [M]
  int* c_boot = c_full + M;         // [M]
  int* c_take = c_boot + M;         // [M] this run's claim takes (pour + opens)
  int* c_pref = c_take + M;         // [M]
  int* k_t = c_pref + M;            // [T]
  int* fit_t = k_t + T;             // [T]

  if (tid == 0) {
    sh.used = *a.used;
    if constexpr (ZONE) bind_zone_rows(*zs, a.V, SPARSE ? a.Kv : 0);
  }
  __syncthreads();

  Cascade cas;
  for (int s = 0; s < a.S; s = next_run<LADDER>(a, cas, snapshot<CKPT>(a, sh, s))) {
    int g = a.run_group[s];
    int count = a.run_count[s];
    if constexpr (LADDER)
      if (!ladder_attempt(a, cas, s, g, count)) continue;
    if (count <= 0) {  // padded run: zero rows, state untouched
      for (int i = tid; i < E; i += NT) a.take_e[take_row<BATCH || LADDER>(s, E) + i] = 0;
      for (int i = tid; i < M; i += NT) a.take_c[take_row<BATCH || LADDER>(s, M) + i] = 0;
      if (tid == 0) a.leftover[s] = 0;
      continue;
    }
    const unsigned g_zc = a.group_zc_bits[g];
    // the run's view of the Q and V axes: nq / nv slots
    const int nq = SPARSE ? a.Kq : Q;
    const int nv = SPARSE ? a.Kv : a.V;
    if (tid < R) sh.req[tid] = a.group_req[g * R + tid];
    if constexpr (SPARSE) {
      for (int k = tid; k < nq; k += NT) {
        const int c = a.run_q_idx[(size_t)s * nq + k];
        const bool ok = c >= 0 && c < Q;
        sh.qcol[k] = ok ? c : -1;
        sh.mg[k] = ok && a.q_member[g * Q + c] != 0;
        sh.og[k] = ok && a.q_owner[g * Q + c] != 0;
        sh.kq[k] = ok ? a.q_kind[c] : 0;
        sh.cq[k] = ok ? a.q_cap[c] : 0;
        sh.tot[k] = 0u;
      }
    } else {
      for (int q = tid; q < Q; q += NT) {
        sh.mg[q] = a.q_member[g * Q + q] != 0;
        sh.og[q] = a.q_owner[g * Q + q] != 0;
        sh.kq[q] = a.q_kind[q];
        sh.cq[q] = a.q_cap[q];
        sh.tot[q] = 0u;
      }
    }
    for (int i = tid; i < M; i += NT) c_take[i] = 0;
    if constexpr (ZONE) {
      if constexpr (SPARSE) {
        for (int k = tid; k < nv; k += NT) {
          const int c = a.run_v_idx[(size_t)s * nv + k];
          const bool ok = c >= 0 && c < a.V;
          zs->vcol[k] = ok ? c : -1;
          zs->mv[k] = ok && a.v_member[g * a.V + c] != 0;
          zs->ov[k] = ok && a.v_owner[g * a.V + c] != 0;
          zs->vk[k] = ok ? a.v_kind[c] : 0;
        }
      } else {
        for (int v = tid; v < a.V; v += NT) {
          zs->mv[v] = a.v_member[g * a.V + v] != 0;
          zs->ov[v] = a.v_owner[g * a.V + v] != 0;
          zs->vk[v] = a.v_kind[v];
        }
      }
    }
    __syncthreads();
    const int any_owned2 = __syncthreads_or(tid < nq && sh.og[tid] && sh.kq[tid] == 2);
    if (any_owned2) {
      // total members per sig over nodes and claims (wrapping sums)
      for (int e = tid; e < E; e += NT)
        for (int q = 0; q < nq; ++q) {
          const int c = qcol_of<SPARSE>(sh, q);
          if constexpr (SPARSE) if (c < 0) continue;
          if (a.e_cm[e * Q + c]) atomicAdd(&sh.tot[q], (unsigned)a.e_cm[e * Q + c]);
        }
      for (int m = tid; m < M; m += NT)
        for (int q = 0; q < nq; ++q) {
          const int c = qcol_of<SPARSE>(sh, q);
          if constexpr (SPARSE) if (c < 0) continue;
          if (a.c_cm[m * Q + c]) atomicAdd(&sh.tot[q], (unsigned)a.c_cm[m * Q + c]);
        }
    }
    __syncthreads();
    if (tid == 0) {
      sh.fresh_allow = row_allowance<false, SPARSE>(sh, nq, nullptr, nullptr);
      int boot_ok = 1;
      for (int q = 0; q < nq; ++q)
        if (sh.og[q] && sh.kq[q] == 2 && !(sh.mg[q] && sh.tot[q] == 0u)) boot_ok = 0;
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
      for (int k = tid; k < nv; k += NT) con |= zs->ov[k] || (zs->mv[k] && zs->vk[k] == 1);
      const int constrained = __syncthreads_or(con);
      if (constrained) {
        if constexpr (SPARSE) {
          // the event engine reads the dense flags by sig index
          for (int q = tid; q < Q; q += NT) {
            sh.mg[q] = a.q_member[g * Q + q] != 0;
            sh.og[q] = a.q_owner[g * Q + q] != 0;
            sh.kq[q] = a.q_kind[q];
            sh.cq[q] = a.q_cap[q];
          }
          for (int v = tid; v < a.V; v += NT) {
            zs->mv[v] = a.v_member[g * a.V + v] != 0;
            zs->ov[v] = a.v_owner[g * a.V + v] != 0;
            zs->vk[v] = a.v_kind[v];
          }
          __syncthreads();
        }
        zoned_run<BATCH, LADDER>(a, sh, *zs, x, s, g);
        continue;
      }
      int mv_any = 0;
      for (int k = tid; k < nv; k += NT) mv_any |= zs->mv[k];
      const int any_mv = __syncthreads_or(mv_any);
      if (tid == 0) zs->any_mv = any_mv;
    }

    // ---- 1. existing nodes ----------------------------------------------
    int my_first = I32MAX, any_boot = 0;
    for (int e = tid; e < E; e += NT) {
      int base = node_compat_at<BATCH>(a, g, e)
                     ? fit_rows(a.node_free + e * R, a.e_cum + e * R, sh.req, R) : 0;
      const int allow = row_allowance<false, SPARSE>(sh, nq, a.e_cm + e * Q, a.e_co + e * Q);
      const int pos = row_pos<SPARSE>(sh, nq, a.e_cm + e * Q);
      e_full[e] = min(base, min(allow, pos));
      e_boot[e] = min(base, allow);
      if (e_boot[e] > 0) { any_boot = 1; my_first = min(my_first, e); }
    }
    const int has_e_boot = __syncthreads_or(any_boot);
    int e_first = block_min(my_first, sh.red);
    if (!has_e_boot) e_first = 0;
    if (boot2)
      for (int e = tid; e < E; e += NT) e_full[e] = (e == e_first) ? e_boot[e] : 0;
    __syncthreads();
    // first-fit pour: take = clip(remaining - prefix, 0, cap)
    for (int e = tid; e < E; e += NT) e_boot[e] = e_full[e];  // keep caps
    __syncthreads();
    block_exclusive_scan(e_full, e_full, E, sh.ured);
    {
      const int rem = sh.remaining;
      unsigned placed = 0;
      for (int e = tid; e < E; e += NT) {
        const int take = min(max(wsub(rem, e_full[e]), 0), e_boot[e]);
        a.take_e[take_row<BATCH || LADDER>(s, E) + e] = take;
        placed += (unsigned)take;
        if (take > 0) {
          for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = wadd(a.e_cum[e * R + r], wmul(take, sh.req[r]));
          for (int k = 0; k < nq; ++k) {
            const int q = qcol_of<SPARSE>(sh, k);
            if constexpr (SPARSE) if (q < 0) continue;
            if (sh.mg[k]) a.e_cm[e * Q + q] = wadd(a.e_cm[e * Q + q], take);
            if (sh.og[k] && sh.kq[k] == 1) a.e_co[e * Q + q] = wadd(a.e_co[e * Q + q], 1);
          }
        }
      }
      placed = block_sum(placed, sh.ured);
      if (tid == 0) sh.remaining = wsub(rem, (int)placed);
      __syncthreads();
    }

    // ---- 2. open claims (one warp per claim row) --------------------------
    const int used0 = sh.used;
    const unsigned char* compat = a.group_compat_t + (size_t)g * T;
    const unsigned* g_nok = a.group_pair_nok + (size_t)g * W;
    for (int m = wid; m < used0; m += NWARPS) {
      const int pool = a.c_pool[m];
      const bool is_open = pool >= 0;
      const bool pool_ok = is_open && a.group_pool[g * P + min(max(pool, 0), P - 1)];
      bool clash = false;
      for (int w = lane; w < W; w += 32) clash |= (a.c_gbits[(size_t)m * W + w] & g_nok[w]) != 0u;
      const bool node_ok = is_open && pool_ok && !__any_sync(FULL, clash);
      int kbest = 0;
      if (node_ok) {
        const unsigned czc = a.c_zc_bits[m];
        const int* cum = a.c_cum + m * R;
        const unsigned char* mask = a.c_mask + (size_t)m * T;
        for (int t = lane; t < T; t += 32) {
          if (mask[t] && compat[t] && (czc & a.offer_zc_bits[t] & g_zc) != 0u)
            kbest = max(kbest, fit_rows(a.type_alloc + t * R, cum, sh.req, R));
        }
      }
      for (int o = 16; o > 0; o >>= 1) kbest = max(kbest, __shfl_xor_sync(FULL, kbest, o));
      if (lane == 0) {
        const int allow = row_allowance<false, SPARSE>(sh, nq, a.c_cm + m * Q, a.c_co + m * Q);
        const int pos = row_pos<SPARSE>(sh, nq, a.c_cm + m * Q);
        c_full[m] = min(kbest, min(allow, pos));
        c_boot[m] = min(kbest, allow);
      }
    }
    __syncthreads();
    my_first = I32MAX;
    any_boot = 0;
    for (int m = tid; m < used0; m += NT)
      if (c_boot[m] > 0) { any_boot = 1; my_first = min(my_first, m); }
    const int has_c_boot = __syncthreads_or(any_boot);
    int c_first = block_min(my_first, sh.red);
    if (!has_c_boot) c_first = 0;
    if (boot2)
      for (int m = tid; m < used0; m += NT)
        c_full[m] = (!has_e_boot && m == c_first) ? c_boot[m] : 0;
    __syncthreads();
    block_exclusive_scan(c_full, c_pref, used0, sh.ured);
    {
      const int rem = sh.remaining;
      unsigned placed = 0;
      for (int m = tid; m < used0; m += NT) {
        const int take = min(max(wsub(rem, c_pref[m]), 0), c_full[m]);
        c_take[m] = take;
        placed += (unsigned)take;
      }
      placed = block_sum(placed, sh.ured);
      if (tid == 0) sh.remaining = wsub(rem, (int)placed);
      __syncthreads();
    }
    // claims that received pods: narrow the type mask with the OLD carry,
    // then fold the pods in
    for (int m = wid; m < used0; m += NWARPS) {
      const int take = c_take[m];
      if (take <= 0) continue;
      const unsigned czc = a.c_zc_bits[m];
      const int* cum = a.c_cum + m * R;
      unsigned char* mask = a.c_mask + (size_t)m * T;
      for (int t = lane; t < T; t += 32) {
        const bool fit = mask[t] && compat[t] && (czc & a.offer_zc_bits[t] & g_zc) != 0u;
        mask[t] = fit && fit_rows(a.type_alloc + t * R, cum, sh.req, R) >= take;
      }
      __syncwarp();
      if (lane == 0) {
        for (int r = 0; r < R; ++r) a.c_cum[m * R + r] = wadd(a.c_cum[m * R + r], wmul(take, sh.req[r]));
        a.c_zc_bits[m] = czc & g_zc;
        a.c_gbits[(size_t)m * W + (g >> 5)] |= 1u << (g & 31);
        for (int k = 0; k < nq; ++k) {
          const int q = qcol_of<SPARSE>(sh, k);
          if constexpr (SPARSE) if (q < 0) continue;
          if (sh.mg[k]) a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], take);
          if (sh.og[k] && sh.kq[k] == 1) a.c_co[m * Q + q] = wadd(a.c_co[m * Q + q], 1);
        }
        if constexpr (ZONE)
          for (int k = 0; k < nv; ++k) {
            const int v = SPARSE ? zs->vcol[k] : k;
            if constexpr (SPARSE) if (v < 0) continue;
            if (zs->mv[k]) a.c_vm[m * a.V + v] = wadd(a.c_vm[m * a.V + v], take);
          }
      }
    }
    if (tid == 0) sh.cap2 = any_owned2 ? ((boot2 && !has_e_boot && !has_c_boot) ? 1 : 0) : BIG;
    __syncthreads();

    // ---- 3. new claims, pool by pool in priority order --------------------
    for (int p = 0; p < P; ++p) {
      const unsigned new_bits = a.pool_zc_bits[p] & g_zc;
      const int* daemon = a.pool_daemon + p * R;
      if (tid < R) sh.charge[tid] = I32MAX;
      __syncthreads();
      int kmax = 0;
      int cmin[MAX_R];
      for (int r = 0; r < R; ++r) cmin[r] = I32MAX;
      for (int t = tid; t < T; t += NT) {
        const bool fit = compat[t] && a.pool_type[(size_t)p * T + t] &&
                         (a.offer_zc_bits[t] & new_bits) != 0u;
        const int k = fit ? fit_rows(a.type_alloc + t * R, daemon, sh.req, R) : 0;
        k_t[t] = k;
        fit_t[t] = fit;
        kmax = max(kmax, k);
        if (fit && k >= 1)
          for (int r = 0; r < R; ++r) cmin[r] = min(cmin[r], a.type_charge[t * R + r]);
      }
      for (int r = 0; r < R; ++r)
        if (cmin[r] != I32MAX) atomicMin(&sh.charge[r], cmin[r]);
      kmax = block_max(kmax, sh.red);  // also orders the atomics above
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
        for (size_t i = tid; i < (size_t)n_new * T; i += NT) {
          const int j = (int)(i / T), t = (int)(i % T);
          const int take_j = min(max(wsub(rem, wmul(j, full)), 0), full);
          a.c_mask[(size_t)(used + j) * T + t] = fit_t[t] && k_t[t] >= take_j;
        }
        unsigned placed = 0;
        for (int j = tid; j < n_new; j += NT) {
          const int m = used + j;
          const int take_j = min(max(wsub(rem, wmul(j, full)), 0), full);
          for (int r = 0; r < R; ++r) a.c_cum[m * R + r] = wadd(daemon[r], wmul(take_j, sh.req[r]));
          a.c_zc_bits[m] = new_bits;
          for (int w = 0; w < W; ++w) a.c_gbits[(size_t)m * W + w] = (w == (g >> 5)) ? (1u << (g & 31)) : 0u;
          a.c_pool[m] = p;
          if constexpr (SPARSE) {
            // the row is zero (m >= used): add the view's columns onto it
            for (int k = 0; k < nq; ++k) {
              const int q = sh.qcol[k];
              if (q < 0) continue;
              a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], sh.mg[k] ? take_j : 0);
              a.c_co[m * Q + q] =
                  wadd(a.c_co[m * Q + q], (take_j > 0 && sh.og[k] && sh.kq[k] == 1) ? 1 : 0);
            }
            if constexpr (ZONE)
              for (int k = 0; k < nv; ++k) {
                const int v = zs->vcol[k];
                if (v >= 0) a.c_vm[m * a.V + v] = wadd(a.c_vm[m * a.V + v], zs->mv[k] ? take_j : 0);
              }
          } else {
            for (int q = 0; q < Q; ++q) {
              a.c_cm[m * Q + q] = sh.mg[q] ? take_j : 0;
              a.c_co[m * Q + q] = (take_j > 0 && sh.og[q] && sh.kq[q] == 1) ? 1 : 0;
            }
            if constexpr (ZONE)
              for (int v = 0; v < a.V; ++v) a.c_vm[m * a.V + v] = zs->mv[v] ? take_j : 0;
          }
          c_take[m] = take_j;
          placed += (unsigned)take_j;
        }
        placed = block_sum(placed, sh.ured);
        if (tid == 0) {
          for (int r = 0; r < R; ++r)
            a.p_usage[p * R + r] = wadd(a.p_usage[p * R + r], wmul(sh.charge[r], n_new));
          sh.remaining = wsub(rem, (int)placed);
          sh.used = used + n_new;
          sh.cap2 = wsub(sh.cap2, n_new);
        }
      }
      __syncthreads();
    }
    if constexpr (ZONE) {
      // zone-sig membership counts: the group may match other pods'
      // selectors without owning a constraint (count_contrib)
      if (zs->any_mv) {
        if (tid < a.Z) zs->contrib[tid] = 0;
        __syncthreads();
        for (int e = tid; e < E; e += NT) {
          const int take = a.take_e[take_row<BATCH || LADDER>(s, E) + e];
          if (take > 0) node_contrib(a, zs->contrib, e, take);
        }
        for (int m = tid; m < sh.used; m += NT)
          if (c_take[m] > 0) claim_contrib(*zs, zs->contrib, a.Z, a.c_zc_bits[m], c_take[m]);
        __syncthreads();
        if constexpr (SPARSE) {
          for (int i = tid; i < nv * a.Z; i += NT) {
            const int k = i / a.Z, v = zs->vcol[k];
            if (v >= 0 && zs->mv[k])
              a.v_count[v * a.Z + i % a.Z] = wadd(a.v_count[v * a.Z + i % a.Z], zs->contrib[i % a.Z]);
          }
        } else {
          for (int i = tid; i < a.V * a.Z; i += NT)
            if (zs->mv[i / a.Z]) a.v_count[i] = wadd(a.v_count[i], zs->contrib[i % a.Z]);
        }
      }
    }
    for (int m = tid; m < M; m += NT) a.take_c[take_row<BATCH || LADDER>(s, M) + m] = c_take[m];
    if (tid == 0) a.leftover[s] = sh.remaining;
    __syncthreads();
  }
  if (tid == 0) *a.used = sh.used;
}

// K1 (BATCH=false: one solve, one block), K4 (BATCH=true: one block per
// subset row, from the prologue above), K6 (LADDER=true: one solve, a
// cascade of attempts per run), K7 (CKPT=true: K1 with the snapshot ring),
// and the sparse instances of K1, K6 and K7 (SPARSE=true)
template <bool ZONE, bool BATCH, bool LADDER, bool CKPT, bool SPARSE>
__global__ void __launch_bounds__(NT) ffd_scan_kernel(ScanArgs a) {
  if constexpr (BATCH) batch_row_prologue(a);
  scan_body<ZONE, BATCH, LADDER, CKPT, SPARSE>(a);
}

#ifdef FFD_LANES_ONLY
// ---- K15: the lane-batched scan ------------------------------------------------
//
// Replaces karpenter_tpu/parallel/sharded.py:80 batched_solve: jax.vmap of
// ffd_solve over a leading lane axis, one lane a cohort member's whole solve
// (the fused cross-tenant cohort dispatch, backend.solve_cohort_async).
//
// What bounds it on the H100: each lane is K1's scan, a serial chain of run
// steps that one block walks (latency-bound, far from the card's memory and
// integer peaks); lanes share nothing, so B lanes run on B SMs at once and a
// batch of up to 132 lanes costs about one lane's time.
// Design: one launch, grid = B, one block per lane running K1's body
// (scan_body<ZONE, false, false, false, false>) on its own lane. The block
// moves every argument, carry and output pointer of the lane-0 ScanArgs by
// lane x that array's per-lane element count; both the ScanArgs and the
// per-array counts (LaneStrides) ride in the kernel's parameters by value,
// so the launch uploads nothing. The carry is seeded per lane by the
// wrapper, as K1's is, and each lane's outputs are full take tables.
constexpr int LANE_ARRAYS = 53;  // 32 scan inputs, 16 carry fields, 5 outputs

struct LaneStrides {
  long long n[LANE_ARRAYS];  // per-lane elements, in the launcher's pointer order
};

template <typename Ptr>
__device__ __forceinline__ void to_lane(Ptr& p, long long b, long long n) { p += b * n; }

__device__ __forceinline__ void lane_prologue(ScanArgs& a, const LaneStrides& ls) {
  const long long b = blockIdx.x;
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
__global__ void __launch_bounds__(NT) ffd_lanes_kernel(ScanArgs a, LaneStrides ls) {
  lane_prologue(a, ls);
  scan_body<ZONE, false, false, false, false>(a);
}
#endif  // FFD_LANES_ONLY

#if !defined(FFD_SPARSE_ONLY) && !defined(FFD_LANES_ONLY)
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

// ---- K2: take-table compaction ---------------------------------------------
//
// Bound on the H100: bytes — it reads the [Sp, Ep+M] take grid once and
// writes O(entries); the work per element is a compare. Design: one block,
// one warp per run row; a ballot + popcount gives each nonzero entry its
// rank inside the row, a block scan of the per-row counts gives the row's
// offset, so entries land in row-major order with no atomics.

__device__ __forceinline__ int grid_at(const int* te, const int* tc, int s, int c, int Ep, int M) {
  return c < Ep ? te[(size_t)s * Ep + c] : tc[(size_t)s * M + (c - Ep)];
}

__global__ void __launch_bounds__(NT) compact_takes_kernel(
    const int* take_e, const int* take_c, int* hdr, int* cnt16, unsigned* pairs,
    int* rowcnt, int* rowoff, int Sp, int Ep, int M, int cap) {
  __shared__ unsigned ured[NWARPS];
  __shared__ int big;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int K = Ep + M;
  if (tid == 0) big = 0;
  for (int i = tid; i < cap; i += NT) pairs[i] = 0u;
  __syncthreads();
  bool over = false;
  for (int s = wid; s < Sp; s += NWARPS) {
    int cnt = 0;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < K ? grid_at(take_e, take_c, s, c, Ep, M) : 0;
      over |= v > 65535;
      cnt += __popc(__ballot_sync(FULL, v > 0));
    }
    if (lane == 0) rowcnt[s] = cnt;
  }
  if (over) big = 1;
  __syncthreads();
  const unsigned n = block_exclusive_scan(rowcnt, rowoff, Sp, ured);
  if (tid == 0) {
    hdr[0] = ((int)n > cap || big) ? 1 : 0;
    hdr[1] = (int)n;
  }
  for (int i = tid; i < Sp / 2; i += NT)
    cnt16[i] = (int)(((unsigned)rowcnt[2 * i] & 0xffffu) | (((unsigned)rowcnt[2 * i + 1] & 0xffffu) << 16));
  for (int s = wid; s < Sp; s += NWARPS) {
    int base = rowoff[s];
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < K ? grid_at(take_e, take_c, s, c, Ep, M) : 0;
      const unsigned bal = __ballot_sync(FULL, v > 0);
      if (v > 0) {
        const int pos = base + __popc(bal & ((1u << lane) - 1u));
        if (pos < cap) pairs[pos] = ((unsigned)c & 0xffffu) | (((unsigned)v & 0xffffu) << 16);
      }
      base += __popc(bal);
    }
  }
}

// ---- K3: claim identity rows -----------------------------------------------
//
// Bound on the H100: the [M, M] row-equality search, M·M/2·Wt word
// compares at worst (most pairs differ in the first word, so far fewer).
// Design: three launches — pack each claim's row (type-mask words ++ zc ++
// group bits ++ pool) with one block per claim; find each row's first equal
// row with one block per claim (a block min reduction, so ties go to the
// lowest index as argmax does); one block ranks the representatives with a
// scan and scatters the unique table and the uint16 ids.

constexpr int MT = 256;  // threads of the per-claim kernels

__global__ void __launch_bounds__(MT) meta_pack_kernel(
    const unsigned char* c_mask, const unsigned* c_zc, const unsigned* c_gbits, const int* c_pool,
    unsigned* meta, int T, int W, int Wm, int Wt) {
  const int m = blockIdx.x;
  for (int w = threadIdx.x; w < Wt; w += MT) {
    unsigned v;
    if (w < Wm) {
      v = 0u;
      const int t0 = w * 32;
      for (int j = 0; j < 32 && t0 + j < T; ++j)
        if (c_mask[(size_t)m * T + t0 + j]) v |= 1u << j;
    } else if (w == Wm) {
      v = c_zc[m];
    } else if (w < Wm + 1 + W) {
      v = c_gbits[(size_t)m * W + (w - Wm - 1)];
    } else {
      v = (unsigned)c_pool[m];
    }
    meta[(size_t)m * Wt + w] = v;
  }
}

__global__ void __launch_bounds__(MT) meta_first_kernel(const unsigned* meta, int* first, int Wt) {
  __shared__ int red[MT / 32];
  const int m = blockIdx.x;
  const unsigned* row = meta + (size_t)m * Wt;
  int best = m;  // the diagonal always matches
  for (int k = threadIdx.x; k < m; k += MT) {
    const unsigned* other = meta + (size_t)k * Wt;
    bool eq = true;
    for (int w = 0; w < Wt && eq; ++w) eq = other[w] == row[w];
    if (eq) best = min(best, k);
  }
  for (int o = 16; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(FULL, best, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = red[0];
    for (int i = 1; i < MT / 32; ++i) r = min(r, red[i]);
    first[m] = r;
  }
}

__global__ void __launch_bounds__(NT) meta_finish_kernel(
    const unsigned* meta, const int* first, int* rank, int* hdr, unsigned* uniq, int* mid16,
    int M, int Wt, int cap_u) {
  __shared__ unsigned ured[NWARPS];
  const int tid = threadIdx.x;
  for (int m = tid; m < M; m += NT) rank[m] = first[m] == m ? 1 : 0;
  for (size_t i = tid; i < (size_t)cap_u * Wt; i += NT) uniq[i] = 0u;
  __syncthreads();
  const unsigned n_u = block_exclusive_scan(rank, rank, M, ured);
  for (int m = tid; m < M; m += NT) {
    if (first[m] == m && rank[m] < cap_u)
      for (int w = 0; w < Wt; ++w) uniq[(size_t)rank[m] * Wt + w] = meta[(size_t)m * Wt + w];
  }
  for (int i = tid; i < M / 2; i += NT) {
    const unsigned lo = (unsigned)rank[first[2 * i]] & 0xffffu;
    const unsigned hi = (unsigned)rank[first[2 * i + 1]] & 0xffffu;
    mid16[i] = (int)(lo | (hi << 16));
  }
  if (tid == 0) {
    hdr[0] = (int)n_u > cap_u ? 1 : 0;
    hdr[1] = (int)n_u;
  }
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

#endif  // !FFD_SPARSE_ONLY && !FFD_LANES_ONLY

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
  if (a.Q > MAX_Q || a.R > MAX_R) return false;
  return !(zone && (a.Z > MAX_Z || a.Z < 1 || a.V < 1 || a.P > MAX_P));
}

// Launch one scan instance. A zoned instance takes its V-axis rows as
// dynamic shared memory; past the 48 KB default it needs the opt-in, raised
// once per instance to the widest launch so far. A launch past the card's
// opt-in (ffd_zone_max_v) is refused here with the attribute call's error.
template <bool ZONE, bool BATCH, bool LADDER, bool CKPT, bool SPARSE>
static int launch_scan(int blocks, const ScanArgs& a, void* stream) {
  auto kern = ffd_scan_kernel<ZONE, BATCH, LADDER, CKPT, SPARSE>;
  int dyn = 0;
  if constexpr (ZONE) {
    dyn = zone_rows_bytes(a.V, SPARSE ? a.Kv : 0);
    static int opted = 0;
    if (dyn > opted) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
      if (e != cudaSuccess) return (int)e;
      opted = dyn;
    }
  }
  kern<<<blocks, NT, dyn, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The most V-axis rows (max(V, Kv)) a launch of `kern` holds: the card's
// opt-in shared memory per block less the kernel's static share, over the
// 10 bytes a row takes (zone_rows_bytes). Negative: a CUDA error.
template <typename K>
static int zone_max_v(K kern) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes at{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, kern);
  if (e != cudaSuccess) return -(int)e;
  return (optin - (int)at.sharedSizeBytes) / 10;
}

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
    return a.Kq >= 0 && a.Kq <= MAX_Q && a.Kv >= 0;
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
  return zone ? launch_scan<true, false, false, false, SPARSE>(1, a, stream)
              : launch_scan<false, false, false, false, SPARSE>(1, a, stream);
}

// K6 (and K6s). ptrs: as scan_launch (the 32 scan inputs, the carry,
// take_e, take_c, leftover, events, scratch), then run_ladder [S, Lw] and
// the attempt count (a zeroed int32 scalar); dims: as scan_launch, then Lw
// and the offset of the attempt's rows in the scratch (take_e [E], take_c
// [M], leftover [S] after the scan's own).
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
  return zone ? launch_scan<true, false, true, false, SPARSE>(1, a, stream)
              : launch_scan<false, false, true, false, SPARSE>(1, a, stream);
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
  return zone ? launch_scan<true, false, false, true, SPARSE>(1, a, stream)
              : launch_scan<false, false, false, true, SPARSE>(1, a, stream);
}

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

// The V-row cap of this library's zoned instances (the least over them);
// the arguments are unused. Returns the cap, or minus a CUDA error.
int ffd_sparse_zone_max_v(void**, int, const int*, void*) {
  const int caps[3] = {zone_max_v(ffd_scan_kernel<true, false, false, false, true>),
                       zone_max_v(ffd_scan_kernel<true, false, true, false, true>),
                       zone_max_v(ffd_scan_kernel<true, false, false, true, true>)};
  return std::min(caps[0], std::min(caps[1], caps[2]));
}
#elif defined(FFD_LANES_ONLY)
// the lanes library (ffd_lanes_kernels.cu): K15
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
  for (int i = 0; i < LANE_ARRAYS; ++i) {
    ls.n[i] = (long long)(unsigned)d[13 + 2 * i] | ((long long)d[14 + 2 * i] << 32);
    if (ls.n[i] < 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (zone) {
    auto kern = ffd_lanes_kernel<true>;
    const int dyn = zone_rows_bytes(a.V, 0);
    static int opted = 0;
    if (dyn > opted) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
      if (e != cudaSuccess) return (int)e;
      opted = dyn;
    }
    kern<<<B, NT, dyn, st>>>(a, ls);
  } else {
    ffd_lanes_kernel<false><<<B, NT, 0, st>>>(a, ls);
  }
  return (int)cudaGetLastError();
}

// The V-row cap of the zoned lanes instance; the arguments are unused.
// Returns the cap, or minus a CUDA error.
int ffd_lanes_zone_max_v(void**, int, const int*, void*) {
  return zone_max_v(ffd_lanes_kernel<true>);
}
#else
int ffd_scan_launch(void** p, int n, const int* d, void* stream) {
  return scan_launch<false>(p, n, d, stream);
}

// K4. ptrs: the 32 scan inputs; the carry seeds pool_usage0, node_q_member,
// node_q_owner, b_v_count0 [B, V, Z], node_cand [E], cand_member [B, NC]
// (bool); the carry [B, ...] (FFDState order, as scan_launch);
// b_run_count [B, S], leftover [B, S], events [B], scratch [B, row_words].
// dims: S, G, T, E, P, R, Q, W, M, V, Z, zone, B, NC, row_words, take_off
// (the offset of the row's take rows in its scratch).
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
  if (!scan_limits_ok(a, zone) || a.NC < 1 || B < 1) return (int)cudaErrorInvalidValue;
  return zone ? launch_scan<true, true, false, false, false>(B, a, stream)
              : launch_scan<false, true, false, false, false>(B, a, stream);
}

int ffd_ladder_launch(void** p, int n, const int* d, void* stream) {
  return ladder_launch<false>(p, n, d, stream);
}

int ffd_ckpt_launch(void** p, int n, const int* d, void* stream) {
  return ckpt_launch<false>(p, n, d, stream);
}

// The V-row cap of this library's zoned instances (K1, K4, K6, K7 zoned; the
// least over them); the arguments are unused. Returns the cap, or minus a
// CUDA error.
int ffd_zone_max_v(void**, int, const int*, void*) {
  const int caps[4] = {zone_max_v(ffd_scan_kernel<true, false, false, false, false>),
                       zone_max_v(ffd_scan_kernel<true, true, false, false, false>),
                       zone_max_v(ffd_scan_kernel<true, false, true, false, false>),
                       zone_max_v(ffd_scan_kernel<true, false, false, true, false>)};
  return std::min(std::min(caps[0], caps[1]), std::min(caps[2], caps[3]));
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

// ptrs: take_e, take_c, hdr[2], cnt16, pairs, rows[2*Sp]; dims: Sp, Ep, M, cap
int compact_takes_launch(void** p, int n, const int* d, void* stream) {
  if (n != 6) return (int)cudaErrorInvalidValue;
  const int Sp = d[0];
  int* rows = (int*)p[5];
  compact_takes_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const int*)p[1], (int*)p[2], (int*)p[3], (unsigned*)p[4],
      rows, rows + Sp, Sp, d[1], d[2], d[3]);
  return (int)cudaGetLastError();
}

// ptrs: c_mask, c_zc_bits, c_gbits, c_pool, hdr[2], uniq, mid16, meta,
// first[2*M]; dims: M, T, W, cap_u
int claim_meta_launch(void** p, int n, const int* d, void* stream) {
  if (n != 9) return (int)cudaErrorInvalidValue;
  const int M = d[0], T = d[1], W = d[2], cap_u = d[3];
  const int Wm = (T + 31) / 32, Wt = Wm + 1 + W + 1;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* meta = (unsigned*)p[7];
  int* first = (int*)p[8];
  meta_pack_kernel<<<M, MT, 0, st>>>((const unsigned char*)p[0], (const unsigned*)p[1],
                                     (const unsigned*)p[2], (const int*)p[3], meta, T, W, Wm, Wt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  meta_first_kernel<<<M, MT, 0, st>>>(meta, first, Wt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  meta_finish_kernel<<<1, NT, 0, st>>>(meta, first, first + M, (int*)p[4], (unsigned*)p[5],
                                       (int*)p[6], M, Wt, cap_u);
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

#endif  // FFD_SPARSE_ONLY / FFD_LANES_ONLY

}  // extern "C"
