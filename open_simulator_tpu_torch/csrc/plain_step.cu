// plain_step: the scheduling step of open_simulator_tpu_torch as one CUDA
// kernel for Hopper (sm_90a), run over a range of pods [p0, p1) for S lanes.
//
// Replaces: the XLA fusion of open_simulator_tpu/engine/scheduler.py:_step
// (the body of the lax.scan in schedule_pods, scheduler.py:745-1449) for the
// plain-fit ops, required pod affinity and anti-affinity, hard and soft
// PodTopologySpread and the interpod preference score. The JAX package has
// no Pallas kernel: on the TPU, XLA's fusion of _step is the kernel. Per
// pod: the batched carry-column read (the pod's affinity, anti-affinity,
// spread and preferred-term columns of group_count summed per domain), the
// filter masks in filter_op_table order, the first-fail reason histogram,
// the raw scores, the normalizer min-reductions, the final score in the
// reference's add order, selectHost (max, then the lowest index among exact
// maxima) and the bind into the lane's carry, including the anti-affinity
// term paint and the preferred-term paint over the bound node's domain.
//
// What bounds it: latency, not bytes or operations. Each pod's pick depends
// on the previous pod's bind, so the P pods form one dependent chain. Per pod
// the block reads O(N*R) bytes of carry and node rows that stay in L1/L2, and
// its time goes to the block-wide barriers and reductions between phases.
//
// Design, right and simple first: one thread block per lane (1,024 threads,
// nodes strided over threads), the pod loop inside the kernel, and
// __syncthreads() between phases. A lane's carry belongs to one block, so
// the scan needs no grid-wide sync. At S=1 this occupies 1 of the card's 132
// SMs; a lane spread over a thread-block cluster (distributed shared memory
// for the cross-node reductions) is later work.
//
// The reverse anti-affinity verdict reads only the pod's hit-term columns
// (a host-built list, the nonzeros of hit_terms): "any hit column > 0" over
// nonnegative counts is the verdict of both the reference's dense
// term_block @ hit_terms and its slot-form gather, without sweeping all T
// columns per node.
//
// Exactness: built with --fmad=false, and every float operation is an
// explicit round-to-nearest intrinsic, so each one is the same IEEE
// operation, in the same order, as in the plain torch step
// (open_simulator_tpu_torch/engine/scheduler.py:_step). The reductions are
// min (exact in any order), the (max, lowest index) pick and integer counts
// (domain sums of the carry's integer counts are integer adds). The
// interpod raw sums and pref_paint hold integer-valued f32 (weights x
// counts), exact below 2^24.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;
constexpr float kNegInf = -3.4e38f;
constexpr int kRows = 8;  // normalizer min-reduction rows

// StepArgs.flags bits; mirrored in kernels/step.py
constexpr int F_UNSCHED = 1 << 0;      // unschedulable filter row live
constexpr int F_CLASS_AFF = 1 << 1;    // class node-affinity filter row live
constexpr int F_CLASS_TAINT = 1 << 2;  // class taint filter row live
constexpr int F_PORTS = 1 << 3;        // host-port filter + carry live
constexpr int F_FAIL = 1 << 4;         // per-op fail counts and feasible counts
constexpr int F_NA = 1 << 5;           // node-affinity score
constexpr int F_TT = 1 << 6;           // taint-toleration score
constexpr int F_SP = 1 << 7;           // soft spread score
constexpr int F_SI = 1 << 8;           // Simon score
constexpr int F_BAL = 1 << 9;          // balanced-allocation term
constexpr int F_LEAST = 1 << 10;       // least-allocated term
constexpr int F_MOST = 1 << 11;        // most-allocated term
constexpr int F_GC = 1 << 12;          // group_count carry (the column reads use it)
constexpr int F_DOM = 1 << 13;         // dom_count carry (spread reads it)
constexpr int F_GC_BF16 = 1 << 14;     // group_count stored bfloat16
constexpr int F_AFF = 1 << 15;         // required pod-affinity filter row
constexpr int F_ANTI = 1 << 16;        // anti-affinity filter row + term paint
constexpr int F_SPH = 1 << 17;         // hard spread (DoNotSchedule) filter row
constexpr int F_IP = 1 << 18;          // interpod preference score
constexpr int F_PREF = 1 << 19;        // preferred-term paint (pref_paint carry)
constexpr int F_TB_BF16 = 1 << 20;     // term_block stored bfloat16
// the gates of the inter-pod slice: a launch that sets none of them runs
// the kernel's instantiation without their code (and its registers)
constexpr int kInterpodFlags = F_AFF | F_ANTI | F_SPH | F_IP | F_PREF;

// what a pod's carry column q needs from the column read (s_qneed bits)
constexpr int kNeedDom = 1;   // per-domain sums (non-hostname key)
constexpr int kNeedTot = 2;   // the column's total (affinity bootstrap)
constexpr int kNeedMin = 4;   // min over hostname-eligible nodes (hard spread)

}  // namespace

extern "C" {

struct StepArgs {
  // node arrays
  const float* inv_alloc;             // [N, R] 1/alloc, 0 where alloc <= 0
  const uint8_t* unschedulable;       // [N]
  const uint8_t* class_affinity;      // [C, N]
  const uint8_t* class_taint;         // [C, N]
  const float* class_node_aff_score;  // [C, N]
  const float* class_taint_prefer;    // [C, N]
  const int32_t* spec_id;             // [N]
  const float* spec_alloc;            // [U, R]
  const int32_t* node_dom;            // [K1, N] domain under each non-hostname key, -1 none
  const uint8_t* has_key;             // [K, N]
  const int32_t* term_key;            // [T] topology key of each anti-affinity term
  // pod arrays
  const float* req;                   // [P, R]
  const int32_t* class_id;            // [P]
  const int32_t* forced_node;         // [P]
  const uint8_t* ports;               // [P, Pt]
  const uint8_t* match_groups;        // [P, Sg]
  const int32_t* spread_group;        // [P, Cs]
  const int32_t* spread_key;          // [P, Cs]
  const float* spread_skew;           // [P, Cs]
  const uint8_t* spread_soft;         // [P, Cs] valid and ScheduleAnyway
  const uint8_t* spread_hard;         // [P, Cs] valid and DoNotSchedule
  const int32_t* aff_group;           // [P, A] required pod-affinity terms
  const int32_t* aff_key;             // [P, A]
  const uint8_t* aff_valid;           // [P, A]
  const uint8_t* aff_self;            // [P, A] the pod matches its own term
  const int32_t* anti_group;          // [P, B] required anti-affinity terms
  const int32_t* anti_key;            // [P, B]
  const uint8_t* anti_valid;          // [P, B]
  const int32_t* hit_ptr;             // [P+1] offsets into hit_idx
  const int32_t* hit_idx;             // terms whose selector matches the pod
  const int32_t* own_ptr;             // [P+1] offsets into own_idx
  const int32_t* own_idx;             // the pod's own anti-affinity terms
  const int32_t* pref_group;          // [P, Ap] preferred terms
  const int32_t* pref_key;            // [P, Ap]
  const float* pref_weight;           // [P, Ap] (negative = anti-affinity preference)
  const uint8_t* pref_valid;          // [P, Ap]
  const int32_t* pref_tid;            // [P, Ap] pref_paint column of each term
  const uint8_t* hit_pref;            // [P, T2] the pod matches preferred term t2
  // per lane
  const uint8_t* active;              // [S, N]
  const float* log_dom;               // [S, K]
  const uint8_t* elig_host;           // [S, C, N] active & class affinity & hostname
  const uint8_t* domain_has;          // [S, C, K1, D] domain holds an eligible node
  const uint8_t* any_elig;            // [S, C, K] an eligible node has the key
  float* headroom;                    // [S, N, R] carry, updated in place
  uint8_t* ports_used;                // [S, N, Pt] carry (torch.bool storage)
  float* dom_count;                   // [S, K1, D, Sg] carry
  void* group_count;                  // [S, N, Sg] carry, bf16 or f32
  void* term_block;                   // [S, N, T] carry, bf16 or f32
  float* pref_paint;                  // [S, N, T2] carry
  // outputs, pod axis p - p0
  int32_t* out_node;                  // [S, P']
  int32_t* out_fail;                  // [S, P', OPS]
  int32_t* out_feasible;              // [S, P']
  // scratch
  float* scratch;                     // [S, 4, N] base score, spread raw, Simon raw, interpod raw
  uint8_t* scratch_flags;             // [S, N] bit 0 feasible, bit 1 spread keys present
  int n, r, c, u, k, k1, d, sg, pt, cs, a, b, ap, t, t2, ops, s, p0, p1, ci, mi, flags;
  float w_bal, w_least, w_most, w_na, w_tt, w_ip, w_sp, w_si;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// max score, ties to the lowest node index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float cnt_load(const void* p, size_t idx, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx])
              : static_cast<const float*>(p)[idx];
}

// carry count += 1 (exact: counts stay below 256 in bf16, 2^24 in f32)
__device__ __forceinline__ void cnt_inc(void* p, size_t idx, bool bf16) {
  if (bf16) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p);
    q[idx] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(q[idx]), 1.0f));
  } else {
    float* q = static_cast<float*>(p);
    q[idx] = __fadd_rn(q[idx], 1.0f);
  }
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// selector group and topology key of the pod's carry column q, over the
// concatenated [aff | anti | spread | pref] slot axis
__device__ __forceinline__ void column_of(const StepArgs& a, int p, int q, int& g, int& key) {
  if (q < a.a) {
    g = a.aff_group[(size_t)p * a.a + q];
    key = a.aff_key[(size_t)p * a.a + q];
    return;
  }
  q -= a.a;
  if (q < a.b) {
    g = a.anti_group[(size_t)p * a.b + q];
    key = a.anti_key[(size_t)p * a.b + q];
    return;
  }
  q -= a.b;
  if (q < a.cs) {
    g = a.spread_group[(size_t)p * a.cs + q];
    key = a.spread_key[(size_t)p * a.cs + q];
    return;
  }
  q -= a.cs;
  g = a.pref_group[(size_t)p * a.ap + q];
  key = a.pref_key[(size_t)p * a.ap + q];
}

// what column q of pod p needs from the column read (0 = not read),
// under the launch's flags `fl`
__device__ int column_need(const StepArgs& a, int fl, int p, int q, int key) {
  const int dom = key > 0 ? kNeedDom : 0;
  if (q < a.a) return ((fl & F_AFF) && a.aff_valid[(size_t)p * a.a + q]) ? (dom | kNeedTot) : 0;
  q -= a.a;
  if (q < a.b) return ((fl & F_ANTI) && a.anti_valid[(size_t)p * a.b + q]) ? dom : 0;
  q -= a.b;
  if (q < a.cs) {
    const bool soft = (fl & F_SP) && a.spread_soft[(size_t)p * a.cs + q];
    const bool hard = (fl & F_SPH) && a.spread_hard[(size_t)p * a.cs + q];
    if (!soft && !hard) return 0;
    return dom | ((hard && key == 0) ? kNeedMin : 0);
  }
  q -= a.cs;
  return ((fl & F_IP) && a.pref_valid[(size_t)p * a.ap + q]) ? dom : 0;
}

// the domain count of carry column q at node n: hostname-keyed columns
// read the node's own count, others the per-domain sum (0 without the key)
__device__ __forceinline__ float column_count(const StepArgs& a, const int* s_dacc, int q,
                                              int g, int key, int n, size_t gc_base,
                                              bool bf16) {
  if (key == 0) return cnt_load(a.group_count, gc_base + (size_t)n * a.sg + g, bf16);
  const int dm = a.node_dom[(size_t)(key - 1) * a.n + n];
  return dm >= 0 ? (float)s_dacc[q * a.d + dm] : 0.0f;
}

// does node m share `fin`'s domain under non-hostname key `key`? (the
// reference's sd_all row; a node without the key shares none)
__device__ __forceinline__ bool same_domain(const StepArgs& a, int key, int fin, int m) {
  const int32_t* dom_of = a.node_dom + (size_t)(key - 1) * a.n;
  const int df = dom_of[fin];
  return df >= 0 && dom_of[m] == df;
}

template <bool kInterpod>
__global__ void __launch_bounds__(kThreads, 1) plain_step_kernel(const StepArgs a) {
  // the normalizer rows: node affinity, taint, spread lo/hi, Simon lo/hi
  // (+ interpod lo/hi)
  constexpr int kLive = kInterpod ? kRows : kRows - 2;
  const int N = a.n, R = a.r, D = a.d, SG = a.sg, PT = a.pt, CS = a.cs;
  const int Q = a.a + a.b + a.cs + a.ap;
  extern __shared__ int s_dyn[];
  int* s_fail = s_dyn;             // [OPS] first-fail histogram
  int* s_dacc = s_fail + a.ops;    // [Q, D] per-domain column sums
  int* s_qtot = s_dacc + Q * D;    // [Q] column totals
  int* s_qmin = s_qtot + Q;        // [Q] column min over hostname-eligible nodes
  int* s_qneed = s_qmin + Q;       // [Q] kNeed* bits
  float* s_minval = reinterpret_cast<float*>(s_qneed + Q);  // [Cs] hard-spread minimum
  __shared__ float s_redf[kRows][kWarps];
  __shared__ int s_redc[kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_bidx[kWarps];
  __shared__ float s_fin[kRows];
  __shared__ int s_fin_cnt;
  __shared__ float s_top;
  __shared__ int s_sel;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const int fl = kInterpod ? a.flags : (a.flags & ~kInterpodFlags);
  const bool fail = fl & F_FAIL, use_sp = fl & F_SP, gc_path = fl & F_GC;
  const bool bf16 = fl & F_GC_BF16, tb_bf16 = fl & F_TB_BF16;
  const int n_out = a.p1 - a.p0;
  const int iters = (N + kThreads - 1) / kThreads;
  const int s_base = a.a + a.b;      // first spread column
  const int p_base = s_base + CS;    // first preferred-term column

  const uint8_t* active = a.active + (size_t)lane * N;
  const float* log_dom = a.log_dom + (size_t)lane * a.k;
  const uint8_t* elig_host_l = a.elig_host + (size_t)lane * a.c * N;
  const uint8_t* domain_has_l = a.domain_has + (size_t)lane * a.c * a.k1 * D;
  const uint8_t* any_elig_l = a.any_elig + (size_t)lane * a.c * a.k;
  float* headroom = a.headroom + (size_t)lane * N * R;
  uint8_t* ports_used = a.ports_used + (size_t)lane * N * PT;
  float* dom_count = a.dom_count + (size_t)lane * a.k1 * D * SG;
  const size_t gc_base = (size_t)lane * N * SG;
  const size_t tb_base = (size_t)lane * N * a.t;
  float* pref_paint = a.pref_paint + (size_t)lane * N * a.t2;
  float* sc_base = a.scratch + (size_t)lane * 4 * N;
  float* sc_spread = sc_base + N;
  float* sc_simon = sc_base + 2 * (size_t)N;
  float* sc_ip = sc_base + 3 * (size_t)N;
  uint8_t* sc_flag = a.scratch_flags + (size_t)lane * N;

  for (int p = a.p0; p < a.p1; ++p) {
    const int j = p - a.p0;
    const float* req = a.req + (size_t)p * R;
    const int cid = a.class_id[p];
    const int forced = a.forced_node[p];
    const uint8_t* pports = a.ports + (size_t)p * PT;
    const uint8_t* match = a.match_groups + (size_t)p * SG;
    const int32_t* sgrp = a.spread_group + (size_t)p * CS;
    const int32_t* skey = a.spread_key + (size_t)p * CS;
    const float* sskew = a.spread_skew + (size_t)p * CS;
    const uint8_t* ssoft = a.spread_soft + (size_t)p * CS;
    const uint8_t* shard = a.spread_hard + (size_t)p * CS;
    const uint8_t* elig_host = elig_host_l + (size_t)cid * N;
    bool any_soft = false;
    if (use_sp)
      for (int c = 0; c < CS; ++c) any_soft |= ssoft[c] != 0;

    // ---- phase 0: zero the histograms, and what each carry column of
    // the pod needs from the batched column read
    for (int i = tid; i < a.ops; i += kThreads) s_fail[i] = 0;
    if (gc_path) {
      for (int i = tid; i < Q * D; i += kThreads) s_dacc[i] = 0;
      for (int q = tid; q < Q; q += kThreads) {
        int g, key;
        column_of(a, p, q, g, key);
        s_qneed[q] = column_need(a, fl, p, q, key);
        s_qtot[q] = 0;
        s_qmin[q] = INT_MAX;
      }
    }
    __syncthreads();

    // ---- phase 0b: the batched carry-column read (group_count path):
    // per-domain sums, totals and eligible minima of the pod's columns,
    // warp-aggregated integer adds and mins (exact in any order)
    if (gc_path && Q) {
      for (int q = 0; q < Q; ++q) {
        const int need = s_qneed[q];
        if (!need) continue;
        int g, key;
        column_of(a, p, q, g, key);
        const int32_t* dom_of = key > 0 ? a.node_dom + (size_t)(key - 1) * N : nullptr;
        int tot = 0, mn = INT_MAX;
        for (int it = 0; it < iters; ++it) {
          const int n = it * kThreads + tid;
          int v = 0, dm = -1;
          if (n < N) {
            v = (int)cnt_load(a.group_count, gc_base + (size_t)n * SG + g, bf16);
            if (need & kNeedDom) dm = dom_of[n];
            if ((need & kNeedMin) && elig_host[n]) mn = min(mn, v);
            tot += v;
          }
          if (need & kNeedDom) {
            const unsigned peers = __match_any_sync(kFull, dm);
            const int sum = __reduce_add_sync(peers, v);
            if (dm >= 0 && sum && lid == __ffs(peers) - 1) atomicAdd(&s_dacc[q * D + dm], sum);
          }
        }
        if (need & kNeedTot) {
          tot = __reduce_add_sync(kFull, tot);
          if (lid == 0 && tot) atomicAdd(&s_qtot[q], tot);
        }
        if (need & kNeedMin) {
          mn = __reduce_min_sync(kFull, mn);
          if (lid == 0) atomicMin(&s_qmin[q], mn);
        }
      }
      __syncthreads();
    }

    // ---- phase 0c: the hard spread's minimum per constraint: over the
    // domains holding an eligible node (hostname: over eligible nodes),
    // 0 when no eligible node has the key
    if (fl & F_SPH) {
      for (int c = tid; c < CS; c += kThreads) {
        if (!shard[c]) continue;
        const int key = skey[c];
        float mv = kBig;
        if (gc_path) {
          const int q = s_base + c;
          if (key == 0) {
            if (s_qmin[q] != INT_MAX) mv = (float)s_qmin[q];
          } else {
            const uint8_t* dhas = domain_has_l + ((size_t)cid * a.k1 + (key - 1)) * D;
            for (int dd = 0; dd < D; ++dd)
              if (dhas[dd]) mv = fminf(mv, (float)s_dacc[q * D + dd]);
          }
        } else {
          const int kk = a.k1 == 1 ? 0 : max(key - 1, 0);
          const uint8_t* dhas = domain_has_l + ((size_t)cid * a.k1 + kk) * D;
          for (int dd = 0; dd < D; ++dd)
            if (dhas[dd]) mv = fminf(mv, dom_count[((size_t)kk * D + dd) * SG + sgrp[c]]);
        }
        s_minval[c] = any_elig_l[(size_t)cid * a.k + key] ? mv : 0.0f;
      }
      __syncthreads();
    }

    // ---- phase 1: filters, first-fail histogram, raw scores, local minima
    float m_na = kBig, m_tt = kBig, m_slo = kBig, m_shi = kBig, m_ilo = kBig, m_ihi = kBig;
    float m_plo = kBig, m_phi = kBig;
    int cnt = 0;
    for (int it = 0; it < iters; ++it) {
      const int n = it * kThreads + tid;
      int charged_op = -1;
      if (n < N) {
        const bool act = active[n] != 0;
        const float* hr = headroom + (size_t)n * R;
        int ff = -1;
        if ((fl & F_UNSCHED) && a.unschedulable[n]) {
          ff = 0;
        } else if ((fl & F_CLASS_AFF) && !a.class_affinity[(size_t)cid * N + n]) {
          ff = 1;
        } else if ((fl & F_CLASS_TAINT) && !a.class_taint[(size_t)cid * N + n]) {
          ff = 2;
        } else {
          if (fl & F_PORTS) {
            for (int t = 0; t < PT; ++t)
              if (pports[t] && ports_used[(size_t)n * PT + t]) {
                ff = 3;
                break;
              }
          }
          if (ff < 0)
            for (int r = 0; r < R; ++r)
              if (!(req[r] <= hr[r])) {
                ff = 4 + r;
                break;
              }
        }
        // required pod affinity: every valid term has a matching pod in
        // the node's domain, or (no match anywhere, the pod matches its
        // own term) the node has the key
        if (ff < 0 && (fl & F_AFF)) {
          for (int q = 0; q < a.a; ++q) {
            const size_t o = (size_t)p * a.a + q;
            if (!a.aff_valid[o]) continue;
            const int g = a.aff_group[o], key = a.aff_key[o];
            const float dc = column_count(a, s_dacc, q, g, key, n, gc_base, bf16);
            const bool ok = a.has_key[(size_t)key * N + n] &&
                            (dc > 0.0f || (s_qtot[q] == 0 && a.aff_self[o]));
            if (!ok) {
              ff = 4 + R;
              break;
            }
          }
        }
        // anti-affinity: forward (no pod matching the pod's terms in the
        // domain) and reverse (no existing pod's term covers this pod)
        if (ff < 0 && (fl & F_ANTI)) {
          bool bad = false;
          for (int q = 0; q < a.b && !bad; ++q) {
            const size_t o = (size_t)p * a.b + q;
            if (!a.anti_valid[o]) continue;
            bad = column_count(a, s_dacc, a.a + q, a.anti_group[o], a.anti_key[o], n,
                               gc_base, bf16) != 0.0f;
          }
          for (int i = a.hit_ptr[p]; i < a.hit_ptr[p + 1] && !bad; ++i)
            bad = cnt_load(a.term_block, tb_base + (size_t)n * a.t + a.hit_idx[i], tb_bf16) > 0.0f;
          if (bad) ff = 5 + R;
        }
        // hard spread: skew = count + self-match - minimum <= maxSkew on
        // nodes holding every constraint's key
        if (ff < 0 && (fl & F_SPH)) {
          for (int c = 0; c < CS; ++c) {
            if (!shard[c]) continue;
            const int key = skey[c], g = sgrp[c];
            float dc;
            if (gc_path) {
              dc = column_count(a, s_dacc, s_base + c, g, key, n, gc_base, bf16);
            } else {
              const int kk = a.k1 == 1 ? 0 : max(key - 1, 0);
              const int dm = a.node_dom[(size_t)kk * N + n];
              dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + g] : 0.0f;
            }
            const float skew = __fsub_rn(__fadd_rn(dc, match[g] ? 1.0f : 0.0f), s_minval[c]);
            if (!(a.has_key[(size_t)key * N + n] && skew <= sskew[c])) {
              ff = 6 + R;
              break;
            }
          }
        }
        const bool mask = act && ff < 0;
        if (act && ff >= 0) charged_op = ff;
        uint8_t flag = mask ? 1 : 0;
        if (fl & F_NA) m_na = fminf(m_na, mask ? -a.class_node_aff_score[(size_t)cid * N + n] : 0.0f);
        if (fl & F_TT) m_tt = fminf(m_tt, mask ? -a.class_taint_prefer[(size_t)cid * N + n] : 0.0f);
        if (mask) {
          ++cnt;
          // NodeResources: balanced + least (+ most) over free fractions
          const float* ia = a.inv_alloc + (size_t)n * R;
          const float h_c = __fmul_rn(__fsub_rn(hr[a.ci], req[a.ci]), ia[a.ci]);
          const float h_m = __fmul_rn(__fsub_rn(hr[a.mi], req[a.mi]), ia[a.mi]);
          float base = 0.0f;
          if (fl & F_BAL)
            base = __fadd_rn(base, __fmul_rn(a.w_bal, __fmul_rn(
                __fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(h_c, h_m)), 0.5f)), 100.0f)));
          if (fl & F_LEAST)
            base = __fadd_rn(base, __fmul_rn(a.w_least, __fmul_rn(
                __fadd_rn(fmaxf(h_c, 0.0f), fmaxf(h_m, 0.0f)), 50.0f)));
          if (fl & F_MOST)
            base = __fadd_rn(base, __fmul_rn(a.w_most, __fmul_rn(__fadd_rn(
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_c)), ia[a.ci] > 0.0f ? 1.0f : 0.0f),
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_m)), ia[a.mi] > 0.0f ? 1.0f : 0.0f)),
                50.0f)));
          sc_base[n] = base;
          // InterPodAffinity preference: the existing pods' weighted paint
          // at this pod's hit terms, then weight x domain count per term
          if (fl & F_IP) {
            float raw = 0.0f;
            for (int t = 0; t < a.t2; ++t)
              if (a.hit_pref[(size_t)p * a.t2 + t])
                raw = __fadd_rn(raw, pref_paint[(size_t)n * a.t2 + t]);
            for (int q = 0; q < a.ap; ++q) {
              const size_t o = (size_t)p * a.ap + q;
              if (!a.pref_valid[o]) continue;
              const int key = a.pref_key[o];
              const float dc = column_count(a, s_dacc, p_base + q, a.pref_group[o], key, n,
                                            gc_base, bf16);
              const float hk = a.has_key[(size_t)key * N + n] ? 1.0f : 0.0f;
              raw = __fadd_rn(raw, __fmul_rn(__fmul_rn(a.pref_weight[o], dc), hk));
            }
            sc_ip[n] = raw;
            m_plo = fminf(m_plo, raw);
            m_phi = fminf(m_phi, -raw);
          }
          // PodTopologySpread, soft: sum of count * log_dom + maxSkew - 1
          if (use_sp) {
            float sraw = 0.0f;
            bool sok = true;
            for (int c = 0; c < CS; ++c) {
              if (!ssoft[c]) continue;
              const int kid = skey[c];
              const int g = sgrp[c];
              float dc;
              if (gc_path) {
                dc = column_count(a, s_dacc, s_base + c, g, kid, n, gc_base, bf16);
              } else {
                const int kk = a.k1 == 1 ? 0 : max(kid - 1, 0);
                const int dm = a.node_dom[(size_t)kk * N + n];
                dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + g] : 0.0f;
              }
              sraw = __fadd_rn(sraw, __fadd_rn(__fmul_rn(dc, log_dom[kid]),
                                               __fsub_rn(sskew[c], 1.0f)));
              sok = sok && a.has_key[(size_t)kid * N + n];
            }
            sc_spread[n] = sraw;
            if (sok) {
              flag |= 2;
              m_slo = fminf(m_slo, sraw);
              m_shi = fminf(m_shi, -sraw);
            }
          }
          // Simon: max over resources of share(req, alloc - req), static alloc
          if (fl & F_SI) {
            const float* sa = a.spec_alloc + (size_t)a.spec_id[n] * R;
            float mx = 0.0f;
            for (int r = 0; r < R; ++r) {
              const float avail = __fsub_rn(sa[r], req[r]);
              const float rq = req[r];
              float sh = avail != 0.0f ? __fdiv_rn(rq, avail) : (rq != 0.0f ? 1.0f : 0.0f);
              sh = rq > 0.0f ? clamp01(sh) : 0.0f;
              mx = r == 0 ? sh : fmaxf(mx, sh);
            }
            const float raw_si = __fmul_rn(mx, 100.0f);
            sc_simon[n] = raw_si;
            m_ilo = fminf(m_ilo, raw_si);
            m_ihi = fminf(m_ihi, -raw_si);
          }
        }
        sc_flag[n] = flag;
      }
      if (fail) {
        // warp-aggregated histogram add: one shared atomic per distinct op
        const unsigned peers = __match_any_sync(kFull, charged_op);
        if (charged_op >= 0 && lid == __ffs(peers) - 1)
          atomicAdd(&s_fail[charged_op], __popc(peers));
      }
    }
    {
      const float mins[kRows] = {m_na, m_tt, m_slo, m_shi, m_ilo, m_ihi, m_plo, m_phi};
#pragma unroll
      for (int q = 0; q < kLive; ++q) {
        const float v = warp_min(mins[q]);
        if (lid == 0) s_redf[q][wid] = v;
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lid == 0) s_redc[wid] = cnt;
    __syncthreads();
    if (wid == 0) {
      for (int q = 0; q < kLive; ++q) {
        const float v = warp_min(s_redf[q][lid]);
        if (lid == 0) s_fin[q] = v;
      }
      const int c = __reduce_add_sync(kFull, s_redc[lid]);
      if (lid == 0) s_fin_cnt = c;
    }
    __syncthreads();

    // ---- phase 2: normalizers, final score in the reference's add order
    // (resources, node affinity, taint, interpod, spread, Simon), selectHost
    const float hi_na = -s_fin[0];
    const float inv_na = hi_na > 0.0f ? __fdiv_rn(100.0f, hi_na) : 0.0f;
    const float hi_tt = -s_fin[1];
    const float inv_tt = hi_tt > 0.0f ? __fdiv_rn(100.0f, hi_tt) : 0.0f;
    const float sp_min = s_fin[2];
    const float sp_max = -s_fin[3];
    const float soft_f = any_soft ? 1.0f : 0.0f;
    const bool sp_pos = sp_max > 0.0f;
    const float inv_sp = __fmul_rn(sp_pos ? __fdiv_rn(100.0f, fmaxf(sp_max, 1e-9f)) : 0.0f, soft_f);
    const float base_sp = __fmul_rn(sp_pos ? 0.0f : 100.0f, soft_f);
    const float c1 = __fadd_rn(sp_max, sp_min);
    const float si_lo = s_fin[4];
    const float si_rng = __fsub_rn(-s_fin[5], si_lo);
    const float inv_si = si_rng > 0.0f ? __fdiv_rn(100.0f, si_rng) : 0.0f;
    const float ip_lo = kInterpod ? s_fin[6] : 0.0f;
    const float ip_rng = kInterpod ? __fsub_rn(-s_fin[7], ip_lo) : 0.0f;
    const float inv_ip = ip_rng > 0.0f ? __fdiv_rn(100.0f, ip_rng) : 0.0f;

    float best = -INFINITY;
    int bidx = 0x7fffffff;
    for (int it = 0; it < iters; ++it) {
      const int n = it * kThreads + tid;
      if (n >= N) break;
      const uint8_t flag = sc_flag[n];
      float ms = kNegInf;
      if (flag & 1) {
        float score = sc_base[n];
        if (fl & F_NA)
          score = __fadd_rn(score, __fmul_rn(a.w_na, __fmul_rn(
              a.class_node_aff_score[(size_t)cid * N + n], inv_na)));
        if (fl & F_TT)
          score = __fadd_rn(score, __fmul_rn(a.w_tt, __fsub_rn(100.0f, __fmul_rn(
              a.class_taint_prefer[(size_t)cid * N + n], inv_tt))));
        if (fl & F_IP)
          score = __fadd_rn(score, __fmul_rn(a.w_ip, __fmul_rn(
              __fsub_rn(sc_ip[n], ip_lo), inv_ip)));
        if (use_sp) {
          const float v = (flag & 2)
              ? __fadd_rn(base_sp, __fmul_rn(__fsub_rn(c1, sc_spread[n]), inv_sp))
              : 0.0f;
          score = __fadd_rn(score, __fmul_rn(a.w_sp, v));
        }
        if (fl & F_SI)
          score = __fadd_rn(score, __fmul_rn(a.w_si, __fmul_rn(
              __fsub_rn(sc_simon[n], si_lo), inv_si)));
        ms = score;
      }
      if (ms > best) {  // nodes ascend per thread: ties keep the lower index
        best = ms;
        bidx = n;
      }
    }
    warp_argmax(best, bidx);
    if (lid == 0) {
      s_best[wid] = best;
      s_bidx[wid] = bidx;
    }
    __syncthreads();
    if (wid == 0) {
      float v = s_best[lid];
      int i = s_bidx[lid];
      warp_argmax(v, i);
      if (lid == 0) {
        s_top = v;
        s_sel = i;
      }
    }
    __syncthreads();

    // ---- phase 3: forced-node fast path, outputs, bind
    const bool any_feasible = s_top > kNegInf;
    const int fin = forced >= 0 ? forced : ((forced == -1 && any_feasible) ? s_sel : -1);
    const size_t o = (size_t)lane * n_out + j;
    if (tid == 0) {
      a.out_node[o] = fin;
      a.out_feasible[o] = fail ? s_fin_cnt : 0;
    }
    if (fail)
      for (int i = tid; i < a.ops; i += kThreads) a.out_fail[o * a.ops + i] = s_fail[i];
    if (fin >= 0) {
      for (int i = tid; i < R; i += kThreads)
        headroom[(size_t)fin * R + i] = __fsub_rn(headroom[(size_t)fin * R + i], req[i]);
      if (fl & F_PORTS)
        for (int i = tid; i < PT; i += kThreads)
          if (pports[i]) ports_used[(size_t)fin * PT + i] = 1;
      if (gc_path)
        for (int i = tid; i < SG; i += kThreads)
          if (match[i]) cnt_inc(a.group_count, gc_base + (size_t)fin * SG + i, bf16);
      if (fl & F_DOM) {
        for (int i = tid; i < a.k1 * SG; i += kThreads) {
          const int kk = i / SG, g = i % SG;
          if (!match[g]) continue;
          const int dm = a.node_dom[(size_t)kk * N + fin];
          if (dm >= 0) {
            float* cell = dom_count + ((size_t)kk * D + dm) * SG + g;
            *cell = __fadd_rn(*cell, 1.0f);
          }
        }
      }
      // the paints over the bound node's domain: each node's cells are
      // written by the one thread that owns the node (m % kThreads), so a
      // cell's adds run in the reference's slot order
      if (fl & F_ANTI) {
        for (int i = a.own_ptr[p]; i < a.own_ptr[p + 1]; ++i) {
          const int t = a.own_idx[i];
          const int key = a.term_key[t];
          if (key == 0) {
            if (fin % kThreads == tid) cnt_inc(a.term_block, tb_base + (size_t)fin * a.t + t, tb_bf16);
            continue;
          }
          for (int m = tid; m < N; m += kThreads)
            if (same_domain(a, key, fin, m)) cnt_inc(a.term_block, tb_base + (size_t)m * a.t + t, tb_bf16);
        }
      }
      if (fl & F_PREF) {
        for (int q = 0; q < a.ap; ++q) {
          const size_t po = (size_t)p * a.ap + q;
          if (!a.pref_valid[po]) continue;
          const int key = a.pref_key[po];
          const int t = a.pref_tid[po];
          const float w = a.pref_weight[po];
          if (key == 0) {
            if (fin % kThreads == tid) {
              float* cell = pref_paint + (size_t)fin * a.t2 + t;
              *cell = __fadd_rn(*cell, w);
            }
            continue;
          }
          for (int m = tid; m < N; m += kThreads) {
            if (!same_domain(a, key, fin, m)) continue;
            float* cell = pref_paint + (size_t)m * a.t2 + t;
            *cell = __fadd_rn(*cell, w);
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError():
// a refused launch never runs, so the caller must check it.
extern "C" int plain_step_launch(const StepArgs* args, void* stream) {
  const int q = args->a + args->b + args->cs + args->ap;
  const size_t smem =
      (size_t)(args->ops + q * args->d + 3 * q) * sizeof(int) + (size_t)args->cs * sizeof(float);
  void (*kernel)(StepArgs) = (args->flags & kInterpodFlags) ? plain_step_kernel<true>
                                                           : plain_step_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<args->s, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
