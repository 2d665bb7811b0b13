// Hand-written Hopper (sm_90a) kernels for the provisioning solve's main
// path. Plain C interface, loaded with ctypes (solver/cuda/build.py); each
// launcher takes a host array of device pointers, a host array of dims and
// the caller's stream, and returns cudaGetLastError() after its launches.
//
// Integer semantics follow the JAX reference exactly: int32 arithmetic
// wraps (done here in unsigned), `//` floors (C `/` truncates), ties in
// argmax go to the lowest index, uint32 words are carried as raw bits.
//
// K1 ffd_fast_scan  replaces karpenter_tpu/solver/tpu/ffd.py:1884 ffd_solve
//                   (_ffd_scan :395, fast branch step_body.fast :605-855).
// K2 compact_takes  replaces karpenter_tpu/solver/tpu/ffd.py:325 compact_takes.
// K3 claim_meta     replaces karpenter_tpu/solver/tpu/ffd.py:358
//                   compact_claim_meta plus the c_mask word pack of
//                   karpenter_tpu/solver/backend.py:652-660.

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- K1: the fast-branch FFD scan ------------------------------------------
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

struct ScanArgs {
  const int* run_group; const int* run_count;
  const int* group_req; const unsigned char* group_compat_t; const unsigned* group_zc_bits;
  const unsigned char* group_pool; const unsigned* group_pair_nok; const unsigned char* group_device;
  const int* type_alloc; const int* type_charge; const unsigned* offer_zc_bits;
  const unsigned char* pool_type; const unsigned* pool_zc_bits; const int* pool_daemon;
  const int* pool_limit; const int* node_free; const unsigned char* node_compat;
  const unsigned char* q_member; const unsigned char* q_owner; const int* q_kind; const int* q_cap;
  int* e_cum; int* c_cum; unsigned char* c_mask; unsigned* c_zc_bits; unsigned* c_gbits;
  int* c_pool; int* used; int* p_usage; int* e_cm; int* e_co; int* c_cm; int* c_co;
  int* take_e; int* take_c; int* leftover; int* scratch;
  int S, G, T, E, P, R, Q, W, M;
};

struct RunShared {
  int req[MAX_R];
  int charge[MAX_R];
  int mg[MAX_Q], og[MAX_Q], kq[MAX_Q], cq[MAX_Q];
  unsigned tot[MAX_Q];
  int red[NWARPS];
  unsigned ured[NWARPS];
  int any_owned2, boot2, fresh_allow, remaining, used, cap2, n_new, full_take;
  int has_e_boot, e_first, has_c_boot, c_first;
  int skip;
};

// hostname allowance of one row (Q axis) with owner = o & (kind != 2);
// cm/co == nullptr reads zeros (fresh claims)
__device__ int row_allowance(const RunShared& sh, int Q, const int* cm, const int* co) {
  int best = BIG;
  for (int q = 0; q < Q; ++q) {
    const int kind = sh.kq[q];
    const bool member = sh.mg[q], owner = sh.og[q] && kind != 2;
    const bool relevant = owner || (kind == 1 && member);
    if (!relevant) continue;
    const int c = cm ? cm[q] : 0, o = co ? co[q] : 0;
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
__device__ int row_pos(const RunShared& sh, int Q, const int* cm) {
  int best = BIG;
  for (int q = 0; q < Q; ++q)
    if (sh.og[q] && sh.kq[q] == 2) best = min(best, cm[q] > 0 ? BIG : 0);
  return best;
}

__device__ __forceinline__ int fit_rows(const int* alloc, const int* cum, const int* req, int R) {
  int k = BIG;
  for (int r = 0; r < R; ++r)
    if (req[r] > 0) k = min(k, floordiv(wsub(alloc[r], cum[r]), req[r]));
  return max(k, 0);
}

__global__ void __launch_bounds__(NT) ffd_fast_scan_kernel(ScanArgs a) {
  __shared__ RunShared sh;
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

  if (tid == 0) sh.used = *a.used;
  __syncthreads();

  for (int s = 0; s < a.S; ++s) {
    const int g = a.run_group[s];
    const int count = a.run_count[s];
    if (count <= 0) {  // padded run: zero rows, state untouched
      for (int i = tid; i < E; i += NT) a.take_e[(size_t)s * E + i] = 0;
      for (int i = tid; i < M; i += NT) a.take_c[(size_t)s * M + i] = 0;
      if (tid == 0) a.leftover[s] = 0;
      continue;
    }
    const unsigned g_zc = a.group_zc_bits[g];
    if (tid < R) sh.req[tid] = a.group_req[g * R + tid];
    for (int q = tid; q < Q; q += NT) {
      sh.mg[q] = a.q_member[g * Q + q] != 0;
      sh.og[q] = a.q_owner[g * Q + q] != 0;
      sh.kq[q] = a.q_kind[q];
      sh.cq[q] = a.q_cap[q];
      sh.tot[q] = 0u;
    }
    for (int i = tid; i < M; i += NT) c_take[i] = 0;
    __syncthreads();
    const int any_owned2 = __syncthreads_or(tid < Q && sh.og[tid] && sh.kq[tid] == 2);
    if (any_owned2) {
      // total members per sig over nodes and claims (wrapping sums)
      for (int e = tid; e < E; e += NT)
        for (int q = 0; q < Q; ++q) if (a.e_cm[e * Q + q]) atomicAdd(&sh.tot[q], (unsigned)a.e_cm[e * Q + q]);
      for (int m = tid; m < M; m += NT)
        for (int q = 0; q < Q; ++q) if (a.c_cm[m * Q + q]) atomicAdd(&sh.tot[q], (unsigned)a.c_cm[m * Q + q]);
    }
    __syncthreads();
    if (tid == 0) {
      sh.fresh_allow = row_allowance(sh, Q, nullptr, nullptr);
      int boot_ok = 1;
      for (int q = 0; q < Q; ++q)
        if (sh.og[q] && sh.kq[q] == 2 && !(sh.mg[q] && sh.tot[q] == 0u)) boot_ok = 0;
      sh.boot2 = any_owned2 && boot_ok;
      sh.remaining = a.group_device[g] ? count : 0;
    }
    __syncthreads();
    const int boot2 = sh.boot2;

    // ---- 1. existing nodes ----------------------------------------------
    int my_first = I32MAX, any_boot = 0;
    for (int e = tid; e < E; e += NT) {
      int base = a.node_compat[(size_t)g * E + e]
                     ? fit_rows(a.node_free + e * R, a.e_cum + e * R, sh.req, R) : 0;
      const int allow = row_allowance(sh, Q, a.e_cm + e * Q, a.e_co + e * Q);
      const int pos = row_pos(sh, Q, a.e_cm + e * Q);
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
        a.take_e[(size_t)s * E + e] = take;
        placed += (unsigned)take;
        if (take > 0) {
          for (int r = 0; r < R; ++r) a.e_cum[e * R + r] = wadd(a.e_cum[e * R + r], wmul(take, sh.req[r]));
          for (int q = 0; q < Q; ++q) {
            if (sh.mg[q]) a.e_cm[e * Q + q] = wadd(a.e_cm[e * Q + q], take);
            if (sh.og[q] && sh.kq[q] == 1) a.e_co[e * Q + q] = wadd(a.e_co[e * Q + q], 1);
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
        const int allow = row_allowance(sh, Q, a.c_cm + m * Q, a.c_co + m * Q);
        const int pos = row_pos(sh, Q, a.c_cm + m * Q);
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
        for (int q = 0; q < Q; ++q) {
          if (sh.mg[q]) a.c_cm[m * Q + q] = wadd(a.c_cm[m * Q + q], take);
          if (sh.og[q] && sh.kq[q] == 1) a.c_co[m * Q + q] = wadd(a.c_co[m * Q + q], 1);
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
          for (int q = 0; q < Q; ++q) {
            a.c_cm[m * Q + q] = sh.mg[q] ? take_j : 0;
            a.c_co[m * Q + q] = (take_j > 0 && sh.og[q] && sh.kq[q] == 1) ? 1 : 0;
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
    for (int m = tid; m < M; m += NT) a.take_c[(size_t)s * M + m] = c_take[m];
    if (tid == 0) a.leftover[s] = sh.remaining;
    __syncthreads();
  }
  if (tid == 0) *a.used = sh.used;
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

}  // namespace

extern "C" {

// ptrs: the 21 input arrays of the scan (ARG_SPEC order, V-axis and
// per-solve-init entries left out), then e_cum, c_cum, c_mask, c_zc_bits,
// c_gbits, c_pool, used, p_usage, e_cm, e_co, c_cm, c_co, take_e, take_c,
// leftover, scratch. dims: S, G, T, E, P, R, Q, W, M.
int ffd_fast_scan_launch(void** p, int n, const int* d, void* stream) {
  if (n != 37) return (int)cudaErrorInvalidValue;
  ScanArgs a;
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
  a.e_cum = (int*)p[21]; a.c_cum = (int*)p[22]; a.c_mask = (unsigned char*)p[23];
  a.c_zc_bits = (unsigned*)p[24]; a.c_gbits = (unsigned*)p[25]; a.c_pool = (int*)p[26];
  a.used = (int*)p[27]; a.p_usage = (int*)p[28]; a.e_cm = (int*)p[29]; a.e_co = (int*)p[30];
  a.c_cm = (int*)p[31]; a.c_co = (int*)p[32]; a.take_e = (int*)p[33]; a.take_c = (int*)p[34];
  a.leftover = (int*)p[35]; a.scratch = (int*)p[36];
  a.S = d[0]; a.G = d[1]; a.T = d[2]; a.E = d[3]; a.P = d[4]; a.R = d[5]; a.Q = d[6];
  a.W = d[7]; a.M = d[8];
  if (a.Q > MAX_Q || a.R > MAX_R) return (int)cudaErrorInvalidValue;
  ffd_fast_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a);
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

}  // extern "C"
