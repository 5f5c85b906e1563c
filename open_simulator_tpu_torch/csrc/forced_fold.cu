// forced_fold: a chunk of forced binds folded into a carry, as two CUDA
// kernels for Hopper (sm_90a).
//
// Replaces: the XLA fusion of open_simulator_tpu/engine/scheduler.py:
// apply_forced_mask (:347) and apply_forced_prefix (:323) over
// _apply_prefix_chunk (:370): the pinned pods of a replay step
// (schedule_pods(..., hoist_forced=True), :1527-1551) and the leading
// run of spec.nodeName pods, folded into the start carry as one-hot f32
// matmuls at Precision.HIGHEST, 4,096 pods a chunk. The JAX package has no
// Pallas kernel: on the TPU, XLA's fusion of those matmuls is the kernel.
// Each pod of the chunk bound to `nodes[i]` (negative: not folded; with
// `mask`, pod i folds at max(nodes[i], 0) where mask[i] is set) adds, each
// channel behind the reference's gate:
//   headroom    -= its requests at the node
//   group_count += its matched groups at the node
//   dom_count   += per topology key, its matched groups in the node's domain
//   ports_used  |= its host ports at the node
//   vol_cnt     += its attachments (vol_limit_req) at the node
//   term_block  += its anti-affinity terms over each term key's domain of
//                  the node (the hostname: the node itself)
//   pref_paint  += per preferred slot, its weight over the slot key's
//                  domain of the node, slot by slot
//
// Design: a chunk holds thousands of pods and a node a few of them, so no
// cell walks the chunk. (1) fold_bucket: block 0 buckets the chunk's pods
// by node into the CSR the node cells walk: a histogram and a block scan
// in shared memory, then every thread places its few pods, each at its
// bucket's cursor taken with a shared atomic, so a bucket's pods land in
// no fixed order. Blocks 1.. take the domain cells, `dom_blocks` blocks a
// topology key: each buckets the chunk by its key's domain the same way
// into its own shared memory (cheap beside the walks: a few pods a
// thread) and sums its share of the key's cells, a warp a cell:
// dom_count, and the term and preference sums of each (key, domain) into
// scratch. (2) fold_node: a thread a node cell walks its node's pods
// (headroom, group_count, ports, vol_cnt, the hostname-keyed paints) and
// reads its domains' sums. Work is O(c + cells) a chunk, not O(c x
// cells). The fold writes a new carry (`in_*` read, the rest written;
// the same tensors for a fold in place), so the node launch also copies,
// 16 bytes a thread, each channel the chunk leaves and the carry fields
// the fold never changes: the caller needs no clone.
//
// Why this design (the earlier form timed phase by phase on the H100,
// PERF.md §6): that form was three dependent launches (bucket, domain,
// node) behind a wrapper whose clone and input conversions cost more than
// its kernels, and its bucketing ended in a stable scatter by one warp,
// ceil(c / 32) dependent steps: 51 us of a 4,096-pod chunk. The sums need no pod
// order (below), so the scatter is unstable and spread over every thread,
// the domain sums ride the bucket launch, the clone rides the node launch,
// and the shared-memory attribute is set once per device, not per call.
//
// Exactness: the weights are 0/1 and the requests, counts and preference
// weights integer-valued, so every sum is exact below 2^24 in any order,
// and no float cell is written with an atomic (the atomics count integers
// and take places). A bf16 carry adds the chunk's f32 sum rounded to bf16
// once, as the reference's astype does. No FMA contraction (--fmad=false)
// and no fast math.
//
// What bounds it on this card: latency, then bytes. The carry cells are
// read and written once and the chunk's pod rows read once; the bucketing
// is a few dependent block-wide steps (histogram, scan, placement).

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// FoldArgs.flags bits; the merge's bits (kernels/wave.py), without the
// slot rows and the GPU debit
constexpr int F_GC = 1 << 0;       // group_count (needs_group_count)
constexpr int F_DOM = 1 << 1;      // dom_count (maintain_dom_count)
constexpr int F_PORTS = 1 << 3;    // ports_used
constexpr int F_VOL = 1 << 4;      // vol_cnt (attach limits)
constexpr int F_ANTI = 1 << 5;     // term_block paint
constexpr int F_PREF = 1 << 6;     // pref_paint paint
constexpr int F_GC_BF16 = 1 << 8;  // group_count stored bfloat16
constexpr int F_TB_BF16 = 1 << 9;  // term_block stored bfloat16
constexpr int kBucketThreads = 1024;
constexpr int kThreads = 256;
// the bucket launch's dynamic shared memory cap (kernels/wave.py:
// _FOLD_SMEM_LIMIT), set as the kernel's attribute once per device
constexpr int kSmemMax = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

extern "C" {

struct FoldArgs {
  const int32_t* node_dom;       // [K1, N] domain under each non-hostname key, -1 none
  const int32_t* term_key;       // [T] topology key of each anti-affinity term
  // pod arrays, the chunk's pods at rows p0 .. p0 + c - 1
  const float* req;              // [P, R]
  const uint8_t* match_groups;   // [P, Sg]
  const uint8_t* ports;          // [P, Pt]
  const float* vol_limit_req;    // [P, Lk]
  const uint8_t* own_terms;      // [P, T]
  const int32_t* pref_key;       // [P, Ap]
  const int32_t* pref_tid;       // [P, Ap]
  const float* pref_weight;      // [P, Ap]
  const uint8_t* pref_valid;     // [P, Ap]
  const int32_t* nodes;          // [c] the chunk's binds, negative: none
  const uint8_t* mask;           // [c] or null: pod i folds at max(nodes[i], 0) where set
  // scratch, written before it is read within the launch pair
  int32_t* off;                  // [N + 1] CSR offsets by node
  int32_t* list;                 // [c] pod rows, node by node
  float* dom_terms;              // [K1, D, T] per (key, domain) term sums
  float* dom_pref;               // [K1, D, Ap, T2] per (key, domain, slot) weight sums
  // the carry read, and the carry written (the same tensors in place)
  const float* in_headroom;      // [N, R]
  const void* in_group_count;    // [N, Sg] bf16 or f32
  const float* in_dom_count;     // [K1, D, Sg]
  const uint8_t* in_ports_used;  // [N, Pt] (torch.bool storage)
  const float* in_vol_cnt;       // [N, Lk]
  const void* in_term_block;     // [N, T] bf16 or f32
  const float* in_pref_paint;    // [N, T2]
  float* headroom;
  void* group_count;
  float* dom_count;
  uint8_t* ports_used;
  float* vol_cnt;
  void* term_block;
  float* pref_paint;
  // the carry fields the fold leaves as they are (copied when the carry
  // written is another)
  const float* in_gpu_used;      // [N, G]
  const float* in_vg_used;       // [N, V]
  const uint8_t* in_sdev_taken;  // [N, E]
  const uint8_t* in_pv_taken;    // [Npv]
  const uint8_t* in_svol_on_node;  // [N, Nsv]
  float* gpu_used;
  float* vg_used;
  uint8_t* sdev_taken;
  uint8_t* pv_taken;
  uint8_t* svol_on_node;
  int n, r, sg, pt, lk, t, ap, t2, k1, d, p0, c, flags, g, v, e, npv, nsv;
};

}  // extern "C"

namespace {

// the node pod i of the chunk folds at, -1 for none
__device__ __forceinline__ int bind_of(const FoldArgs& a, int i) {
  const int nd = a.nodes[i];
  if (a.mask) return a.mask[i] ? max(nd, 0) : -1;
  return nd;
}

// the bucket of a pod bound at `nd` under `key` (0: the node; k >= 1: the
// node's domain under topology key k - 1), -1 for none
__device__ __forceinline__ int bucket_of(const FoldArgs& a, int key, int nd) {
  if (nd < 0 || nd >= a.n) return -1;
  return key == 0 ? nd : a.node_dom[(size_t)(key - 1) * a.n + nd];
}

__device__ __forceinline__ void add_count(const void* in, void* out, size_t idx, float sum,
                                          bool bf16) {
  if (bf16) {
    const float add = __bfloat162float(__float2bfloat16_rn(sum));
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(static_cast<const __nv_bfloat16*>(in)[idx]), add));
  } else {
    static_cast<float*>(out)[idx] = __fadd_rn(static_cast<const float*>(in)[idx], sum);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The chunk's pods bucketed by `key` into `nb` buckets, by the whole block:
// s_cnt[nb + 1] ends as each bucket's end offset (bucket b's pods sit at
// [b ? s_cnt[b - 1] : 0, s_cnt[b]) of `list`, in no fixed order); with
// `off`, the offsets [nb + 1] are also written there before the
// placement. s_warp: [32] scratch.
__device__ void bucket_pods(const FoldArgs& a, int key, int nb, int* s_cnt, int* s_warp,
                            int32_t* off, int32_t* list) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < a.c; i += blockDim.x) {
    const int bk = bucket_of(a, key, bind_of(a, i));
    if (bk >= 0) atomicAdd(&s_cnt[bk], 1);
  }
  __syncthreads();

  // exclusive scan: each thread a contiguous run of buckets
  const int per = (nb + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = min(nb, (int)threadIdx.x * per), hi = min(nb, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += s_cnt[i];
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = (int)blockDim.x >> 5;
    const int w = lane < nw ? s_warp[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < nw) s_warp[lane] = wi - w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - local;
  for (int i = lo; i < hi; ++i) {
    const int v = s_cnt[i];
    s_cnt[i] = run;
    if (off) off[i] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) {
    s_cnt[nb] = run;  // the total
    if (off) off[nb] = run;
  }
  __syncthreads();

  // placement: each pod at its bucket's cursor (a bucket's order is the
  // atomics' order: the sums do not depend on it)
  for (int i = threadIdx.x; i < a.c; i += blockDim.x) {
    const int bk = bucket_of(a, key, bind_of(a, i));
    if (bk >= 0) list[atomicAdd(&s_cnt[bk], 1)] = a.p0 + i;
  }
  __syncthreads();
}

// the domain cells of one topology key, in order: dom_count [D, Sg]
// (F_DOM), the term sums [D, T] (F_ANTI), the preference sums [D, Ap, T2]
// (F_PREF)
__host__ __device__ inline long long key_cells(const FoldArgs& a) {
  long long m = 0;
  if (a.flags & F_DOM) m += (long long)a.d * a.sg;
  if (a.flags & F_ANTI) m += (long long)a.d * a.t;
  if (a.flags & F_PREF) m += (long long)a.d * a.ap * a.t2;
  return m;
}

// (1) block 0: the CSR by node; blocks 1 ..: `dom_blocks` blocks a key,
// each its share of the key's domain cells, a warp a cell
__global__ void __launch_bounds__(kBucketThreads) fold_bucket_kernel(const FoldArgs a,
                                                                     int dom_blocks) {
  extern __shared__ int s_mem[];
  int* const s_warp = s_mem;  // [32]
  int* const s_cnt = s_mem + 32;
  if (blockIdx.x == 0) {
    bucket_pods(a, 0, a.n, s_cnt, s_warp, a.off, a.list);
    return;
  }
  const int kk = (int)(blockIdx.x - 1) / dom_blocks, part = (int)(blockIdx.x - 1) % dom_blocks;
  int* const s_list = s_cnt + a.d + 1;  // [c]
  bucket_pods(a, kk + 1, a.d, s_cnt, s_warp, nullptr, s_list);

  const int lane = threadIdx.x & 31, nw = (int)blockDim.x >> 5;
  const long long span = key_cells(a);
  const int fl = a.flags;
  for (long long cell = (long long)part * nw + (threadIdx.x >> 5); cell < span;
       cell += (long long)dom_blocks * nw) {
    long long q = cell;
    if (fl & F_DOM) {
      if (q < (long long)a.d * a.sg) {
        const int dd = (int)(q / a.sg), g = (int)(q % a.sg);
        float sum = 0.0f;
        for (int i = (dd ? s_cnt[dd - 1] : 0) + lane; i < s_cnt[dd]; i += 32)
          sum = __fadd_rn(sum, a.match_groups[(size_t)s_list[i] * a.sg + g] ? 1.0f : 0.0f);
        sum = warp_sum(sum);
        if (lane == 0) {
          const size_t o = ((size_t)kk * a.d + dd) * a.sg + g;
          a.dom_count[o] = __fadd_rn(a.in_dom_count[o], sum);
        }
        continue;
      }
      q -= (long long)a.d * a.sg;
    }
    if (fl & F_ANTI) {
      if (q < (long long)a.d * a.t) {
        const int dd = (int)(q / a.t), t = (int)(q % a.t);
        if (a.term_key[t] != kk + 1) continue;  // another key's term: never read
        float sum = 0.0f;
        for (int i = (dd ? s_cnt[dd - 1] : 0) + lane; i < s_cnt[dd]; i += 32)
          sum = __fadd_rn(sum, a.own_terms[(size_t)s_list[i] * a.t + t] ? 1.0f : 0.0f);
        sum = warp_sum(sum);
        if (lane == 0) a.dom_terms[((size_t)kk * a.d + dd) * a.t + t] = sum;
        continue;
      }
      q -= (long long)a.d * a.t;
    }
    // F_PREF
    const long long per_dom = (long long)a.ap * a.t2;
    const int dd = (int)(q / per_dom);
    const int s = (int)((q % per_dom) / a.t2), t2 = (int)(q % a.t2);
    float sum = 0.0f;
    for (int i = (dd ? s_cnt[dd - 1] : 0) + lane; i < s_cnt[dd]; i += 32) {
      const size_t o = (size_t)s_list[i] * a.ap + s;
      if (a.pref_valid[o] && a.pref_tid[o] == t2 && a.pref_key[o] == kk + 1)
        sum = __fadd_rn(sum, a.pref_weight[o]);
    }
    sum = warp_sum(sum);
    if (lane == 0) a.dom_pref[(((size_t)kk * a.d + dd) * a.ap + s) * a.t2 + t2] = sum;
  }
}

// the node launch's cell ranges, in order: the node channels (headroom,
// group_count, ports_used, vol_cnt, term_block, pref_paint), each folded
// under its flag (headroom always), a thread a cell; then what is only
// copied, 16 bytes a thread: a node channel off its flag, dom_count where
// no domain cell folds it, and the fields the fold never changes. A copy
// in place has no cells.
enum Range { kHead, kGc, kPorts, kVol, kTerm, kPref, kDom, kGpu, kVg, kSdev, kPv, kSvol, kRanges };

__host__ __device__ inline bool folds(const FoldArgs& a, int range) {
  switch (range) {
    case kHead: return true;
    case kGc: return a.flags & F_GC;
    case kPorts: return a.flags & F_PORTS;
    case kVol: return a.flags & F_VOL;
    case kTerm: return a.flags & F_ANTI;
    case kPref: return a.flags & F_PREF;
    default: return false;
  }
}

__host__ __device__ inline bool domains_fold(const FoldArgs& a) {
  return a.k1 > 0 && (a.flags & (F_DOM | F_ANTI | F_PREF));
}

// the range's elements, and each one's bytes
__host__ __device__ inline long long range_len(const FoldArgs& a, int range) {
  const long long n = a.n;
  switch (range) {
    case kHead: return n * a.r;
    case kGc: return n * a.sg;
    case kPorts: return n * a.pt;
    case kVol: return n * a.lk;
    case kTerm: return n * a.t;
    case kPref: return n * a.t2;
    case kDom: return (domains_fold(a) && (a.flags & F_DOM)) ? 0 : (long long)a.k1 * a.d * a.sg;
    case kGpu: return n * a.g;
    case kVg: return n * a.v;
    case kSdev: return n * a.e;
    case kPv: return a.npv;
    default: return n * a.nsv;
  }
}

__host__ __device__ inline int elem_bytes(const FoldArgs& a, int range) {
  switch (range) {
    case kGc: return (a.flags & F_GC_BF16) ? 2 : 4;
    case kTerm: return (a.flags & F_TB_BF16) ? 2 : 4;
    case kPorts: case kSdev: case kPv: case kSvol: return 1;
    default: return 4;
  }
}

__host__ __device__ inline long long range_cells(const FoldArgs& a, int range) {
  if (folds(a, range)) return range_len(a, range);
  if (a.in_headroom == a.headroom) return 0;
  return (range_len(a, range) * elem_bytes(a, range) + 15) / 16;
}

// a copied range's source and destination
__device__ __forceinline__ void range_ptrs(const FoldArgs& a, int range, const void*& src,
                                           void*& dst) {
  switch (range) {
    case kGc: src = a.in_group_count; dst = a.group_count; return;
    case kPorts: src = a.in_ports_used; dst = a.ports_used; return;
    case kVol: src = a.in_vol_cnt; dst = a.vol_cnt; return;
    case kTerm: src = a.in_term_block; dst = a.term_block; return;
    case kPref: src = a.in_pref_paint; dst = a.pref_paint; return;
    case kDom: src = a.in_dom_count; dst = a.dom_count; return;
    case kGpu: src = a.in_gpu_used; dst = a.gpu_used; return;
    case kVg: src = a.in_vg_used; dst = a.vg_used; return;
    case kSdev: src = a.in_sdev_taken; dst = a.sdev_taken; return;
    case kPv: src = a.in_pv_taken; dst = a.pv_taken; return;
    default: src = a.in_svol_on_node; dst = a.svol_on_node; return;
  }
}

// piece i (16 bytes, or the tail) of a `bytes`-byte copy
__device__ __forceinline__ void copy_piece(const void* src, void* dst, long long bytes,
                                           long long i) {
  const long long lo = i * 16;
  const int m = (int)min(16LL, bytes - lo);
  const uint8_t* s = static_cast<const uint8_t*>(src) + lo;
  uint8_t* d = static_cast<uint8_t*>(dst) + lo;
  if (m == 16 && !((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15)) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  } else {
    for (int k = 0; k < m; ++k) d[k] = s[k];
  }
}

// cell `cell` of range `range` (a compile-time constant where it is
// called): a node cell walks its node's pods; a copied range copies a piece
__device__ __forceinline__ void node_cell(const FoldArgs& a, int range, long long cell) {
  const int N = a.n, fl = a.flags;
  const size_t i_cell = (size_t)cell;
  if (!folds(a, range)) {
    const void* src;
    void* dst;
    range_ptrs(a, range, src, dst);
    copy_piece(src, dst, range_len(a, range) * elem_bytes(a, range), cell);
    return;
  }
  const int32_t* off = a.off;
  const int32_t* list = a.list;
  switch (range) {
    case kHead: {
      const int n = (int)(cell / a.r), col = (int)(cell % a.r);
      float sum = 0.0f;
      for (int i = off[n]; i < off[n + 1]; ++i)
        sum = __fadd_rn(sum, a.req[(size_t)list[i] * a.r + col]);
      a.headroom[i_cell] = __fsub_rn(a.in_headroom[i_cell], sum);
      return;
    }
    case kGc: {
      const int n = (int)(cell / a.sg), g = (int)(cell % a.sg);
      float sum = 0.0f;
      for (int i = off[n]; i < off[n + 1]; ++i)
        sum = __fadd_rn(sum, a.match_groups[(size_t)list[i] * a.sg + g] ? 1.0f : 0.0f);
      add_count(a.in_group_count, a.group_count, i_cell, sum, fl & F_GC_BF16);
      return;
    }
    case kPorts: {
      const int n = (int)(cell / a.pt), t = (int)(cell % a.pt);
      bool any = a.in_ports_used[i_cell] != 0;
      for (int i = off[n]; i < off[n + 1]; ++i) any |= a.ports[(size_t)list[i] * a.pt + t] != 0;
      a.ports_used[i_cell] = any ? 1 : 0;
      return;
    }
    case kVol: {
      const int n = (int)(cell / a.lk), k = (int)(cell % a.lk);
      float sum = 0.0f;
      for (int i = off[n]; i < off[n + 1]; ++i)
        sum = __fadd_rn(sum, a.vol_limit_req[(size_t)list[i] * a.lk + k]);
      a.vol_cnt[i_cell] = __fadd_rn(a.in_vol_cnt[i_cell], sum);
      return;
    }
    case kTerm: {
      const int n = (int)(cell / a.t), t = (int)(cell % a.t);
      const int key = a.term_key[t];
      float sum = 0.0f;
      if (key == 0) {
        for (int i = off[n]; i < off[n + 1]; ++i)
          sum = __fadd_rn(sum, a.own_terms[(size_t)list[i] * a.t + t] ? 1.0f : 0.0f);
      } else if (key >= 1 && key <= a.k1) {
        const int dd = a.node_dom[(size_t)(key - 1) * N + n];
        if (dd >= 0) sum = a.dom_terms[((size_t)(key - 1) * a.d + dd) * a.t + t];
      }
      add_count(a.in_term_block, a.term_block, i_cell, sum, fl & F_TB_BF16);
      return;
    }
    default: {  // kPref
      const int n = (int)(cell / a.t2), t2 = (int)(cell % a.t2);
      float v = a.in_pref_paint[i_cell];
      for (int s = 0; s < a.ap; ++s) {  // one add per slot, as the reference
        float sum = 0.0f;
        for (int i = off[n]; i < off[n + 1]; ++i) {
          const size_t o = (size_t)list[i] * a.ap + s;
          if (a.pref_valid[o] && a.pref_tid[o] == t2 && a.pref_key[o] == 0)
            sum = __fadd_rn(sum, a.pref_weight[o]);
        }
        for (int kk = 0; kk < a.k1; ++kk) {
          const int dd = a.node_dom[(size_t)kk * N + n];
          if (dd >= 0)
            sum = __fadd_rn(sum, a.dom_pref[(((size_t)kk * a.d + dd) * a.ap + s) * a.t2 + t2]);
        }
        v = __fadd_rn(v, sum);
      }
      a.pref_paint[i_cell] = v;
    }
  }
}

// (2) one thread a node cell, walking its node's pods, or a piece of a copy
__global__ void __launch_bounds__(kThreads) fold_node_kernel(const FoldArgs a) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int range = 0; range < kRanges; ++range) {
    const long long m = range_cells(a, range);
    if (cell < m) {
      node_cell(a, range, cell);
      return;
    }
    cell -= m;
  }
}

// blocks a key of the domain cells: enough warps for every cell of the key
int dom_blocks_of(const FoldArgs* a) {
  if (!domains_fold(*a)) return 0;
  const long long warps = kBucketThreads / 32;
  const long long b = (key_cells(*a) + warps - 1) / warps;
  return (int)(b < 1 ? 1 : (b > 256 ? 256 : b));
}

// the bucket launch's dynamic shared memory: the warp totals, then the
// node counts (block 0) or a key's domain counts and the chunk's list
size_t bucket_smem(const FoldArgs* a) {
  const long long node = a->n + 1;
  const long long dom = dom_blocks_of(a) ? (long long)a->d + 1 + a->c : 0;
  return (size_t)(32 + (node > dom ? node : dom)) * sizeof(int);
}

// the bucket kernel may take more than 48 KB of dynamic shared memory:
// asked for once per device
cudaError_t allow_smem(size_t smem) {
  static std::atomic<unsigned long long> done{0};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fold_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

}  // namespace

// Launch the pair on `stream` (PyTorch's current stream): the bucket
// kernel (block 0 the node CSR, then the domain cells' blocks) and the
// node kernel (a thread a cell). Returns the first launch error: a
// refused launch never runs, so the caller must check it.
extern "C" int forced_fold_launch(const FoldArgs* args, void* stream) {
  if (args->c <= 0 || args->n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bucket_smem(args);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const int dom_blocks = dom_blocks_of(args);
  fold_bucket_kernel<<<1 + args->k1 * dom_blocks, kBucketThreads, smem, st>>>(*args, dom_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long cells = 0;
  for (int range = 0; range < kRanges; ++range) cells += range_cells(*args, range);
  fold_node_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
