// forced_fold: a chunk of forced binds folded into one carry, as a launch
// sequence of three CUDA kernels for Hopper (sm_90a).
//
// Replaces: the XLA fusion of open_simulator_tpu/engine/scheduler.py:
// apply_forced_mask (:347) and apply_forced_prefix (:323) over
// _apply_prefix_chunk (:370): the pinned pods of a replay step
// (schedule_pods(..., hoist_forced=True), :1527-1551) and the leading
// run of spec.nodeName pods, folded into the start carry as one-hot f32
// matmuls at Precision.HIGHEST, 4,096 pods a chunk. The JAX package has no
// Pallas kernel: on the TPU, XLA's fusion of those matmuls is the kernel.
// Each pod of the chunk bound to `nodes[i]` (negative: not folded) adds,
// each channel behind the reference's gate:
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
// cell walks the chunk. (1) fold_bucket, one block per key (the hostname,
// then each topology key), buckets the chunk's pods by node (or by the
// node's domain): a histogram in shared memory, an exclusive block scan
// (the CSR offsets) and a stable scatter by one warp in pod order (peers
// found with __match_any_sync, cursors in shared memory), so each
// bucket's list keeps pod order. (2) fold_domain, one warp per domain
// cell, sums the pods of the cell's domain: dom_count directly, and the
// term and preference paints of each (key, domain) into scratch. (3)
// fold_node, one thread per node cell, walks its node's list (headroom,
// group_count, ports, vol_cnt, the hostname-keyed paints) and reads its
// domains' sums. Work is O(c + cells) a chunk, not O(c x cells).
//
// Exactness: the weights are 0/1 and the requests, counts and preference
// weights integer-valued, so every sum is exact below 2^24 in any order;
// the node lists keep pod order anyway, and no float cell is written with
// an atomic (the histogram's atomics count integers). A bf16 carry adds
// the chunk's f32 sum rounded to bf16 once, as the reference's astype
// does. No FMA contraction (--fmad=false) and no fast math.
//
// What bounds it on this card: bytes and latency. The carry cells are read
// and written once and the chunk's pod rows read once; the bucketing is a
// few dependent steps in one block per key (the scatter 32 pods a step).

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
  // scratch, written before it is read within the sequence
  int32_t* off;                  // [K1 + 1, B + 1] CSR offsets per key
  int32_t* list;                 // [K1 + 1, c] pod rows per key, bucket by bucket
  float* dom_terms;              // [K1, D, T] per (key, domain) term sums
  float* dom_pref;               // [K1, D, Ap, T2] per (key, domain, slot) weight sums
  // the carry, updated in place
  float* headroom;               // [N, R]
  void* group_count;             // [N, Sg] bf16 or f32
  float* dom_count;              // [K1, D, Sg]
  uint8_t* ports_used;           // [N, Pt] (torch.bool storage)
  float* vol_cnt;                // [N, Lk]
  void* term_block;              // [N, T] bf16 or f32
  float* pref_paint;             // [N, T2]
  int n, r, sg, pt, lk, t, ap, t2, k1, d, b, p0, c, flags;
};

}  // extern "C"

namespace {

// the bucket of a pod bound at `nd` under `key` (0: the node; k >= 1: the
// node's domain under topology key k - 1), -1 for none
__device__ __forceinline__ int bucket_of(const FoldArgs& a, int key, int nd) {
  if (nd < 0 || nd >= a.n) return -1;
  return key == 0 ? nd : a.node_dom[(size_t)(key - 1) * a.n + nd];
}

__device__ __forceinline__ void add_count(void* base, size_t idx, float sum, bool bf16) {
  if (bf16) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(base) + idx;
    const float add = __bfloat162float(__float2bfloat16_rn(sum));
    *q = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*q), add));
  } else {
    float* q = static_cast<float*>(base) + idx;
    *q = __fadd_rn(*q, sum);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (1) one block per key: the CSR of the chunk's pods by bucket
__global__ void __launch_bounds__(kBucketThreads) fold_bucket_kernel(const FoldArgs a) {
  extern __shared__ int s_mem[];
  int* s_cnt = s_mem;              // [nb] counts, then offsets, then cursors
  int* s_warp = s_mem + a.b + 1;   // [32] warp totals
  const int key = blockIdx.x;
  const int nb = key == 0 ? a.n : a.d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < a.c; i += blockDim.x) {
    const int bk = bucket_of(a, key, a.nodes[i]);
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
  int32_t* off = a.off + (size_t)key * (a.b + 1);
  int run = s_warp[warp] + incl - local;
  for (int i = lo; i < hi; ++i) {
    const int v = s_cnt[i];
    s_cnt[i] = run;
    off[i] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) off[nb] = run;  // the total
  __syncthreads();

  // stable scatter: one warp, 32 pods a step in pod order; the lanes of a
  // bucket take consecutive places from its cursor by their lane rank
  if (warp != 0) return;
  int32_t* list = a.list + (size_t)key * a.c;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < a.c; base += 32) {
    const int i = base + lane;
    const int bk = i < a.c ? bucket_of(a, key, a.nodes[i]) : -1;
    const unsigned peers = __match_any_sync(kFull, bk);
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (lane == leader && bk >= 0) start = s_cnt[bk];
    start = __shfl_sync(kFull, start, leader);
    if (bk >= 0) list[start + __popc(peers & below)] = a.p0 + i;
    __syncwarp();
    if (lane == leader && bk >= 0) s_cnt[bk] = start + __popc(peers);
    __syncwarp();
  }
}

// (2) one warp per domain cell: dom_count, and the per-(key, domain)
// term and preference sums the node cells read
__global__ void __launch_bounds__(kThreads) fold_domain_kernel(const FoldArgs a) {
  long long cell = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long kd = (long long)a.k1 * a.d;
  const int fl = a.flags;
  if (fl & F_DOM) {
    const long long span = kd * a.sg;
    if (cell < span) {
      const int kk = (int)(cell / ((long long)a.d * a.sg));
      const int rem = (int)(cell % ((long long)a.d * a.sg));
      const int dd = rem / a.sg, g = rem % a.sg;
      const int32_t* off = a.off + (size_t)(kk + 1) * (a.b + 1);
      const int32_t* list = a.list + (size_t)(kk + 1) * a.c;
      float sum = 0.0f;
      for (int i = off[dd] + lane; i < off[dd + 1]; i += 32)
        sum = __fadd_rn(sum, a.match_groups[(size_t)list[i] * a.sg + g] ? 1.0f : 0.0f);
      sum = warp_sum(sum);
      if (lane == 0) {
        float* q = a.dom_count + cell;
        *q = __fadd_rn(*q, sum);
      }
      return;
    }
    cell -= span;
  }
  if (fl & F_ANTI) {
    const long long span = kd * a.t;
    if (cell < span) {
      const int kk = (int)(cell / ((long long)a.d * a.t));
      const int rem = (int)(cell % ((long long)a.d * a.t));
      const int dd = rem / a.t, t = rem % a.t;
      float sum = 0.0f;
      if (a.term_key[t] == kk + 1) {
        const int32_t* off = a.off + (size_t)(kk + 1) * (a.b + 1);
        const int32_t* list = a.list + (size_t)(kk + 1) * a.c;
        for (int i = off[dd] + lane; i < off[dd + 1]; i += 32)
          sum = __fadd_rn(sum, a.own_terms[(size_t)list[i] * a.t + t] ? 1.0f : 0.0f);
        sum = warp_sum(sum);
      }
      if (lane == 0) a.dom_terms[cell] = sum;
      return;
    }
    cell -= span;
  }
  if (fl & F_PREF) {
    const long long span = kd * a.ap * a.t2;
    if (cell < span) {
      const long long per_dom = (long long)a.ap * a.t2;
      const int kk = (int)(cell / ((long long)a.d * per_dom));
      const long long rem = cell % ((long long)a.d * per_dom);
      const int dd = (int)(rem / per_dom);
      const int s = (int)((rem % per_dom) / a.t2), t2 = (int)(rem % a.t2);
      const int32_t* off = a.off + (size_t)(kk + 1) * (a.b + 1);
      const int32_t* list = a.list + (size_t)(kk + 1) * a.c;
      float sum = 0.0f;
      for (int i = off[dd] + lane; i < off[dd + 1]; i += 32) {
        const size_t o = (size_t)list[i] * a.ap + s;
        if (a.pref_valid[o] && a.pref_tid[o] == t2 && a.pref_key[o] == kk + 1)
          sum = __fadd_rn(sum, a.pref_weight[o]);
      }
      sum = warp_sum(sum);
      if (lane == 0) a.dom_pref[cell] = sum;
    }
  }
}

// (3) one thread per node cell, walking its node's pods
__global__ void __launch_bounds__(kThreads) fold_node_kernel(const FoldArgs a) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int N = a.n, fl = a.flags;
  const int32_t* off = a.off;    // key 0: by node
  const int32_t* list = a.list;

  long long span = (long long)N * a.r;
  if (cell < span) {
    const int n = (int)(cell / a.r), col = (int)(cell % a.r);
    float sum = 0.0f;
    for (int i = off[n]; i < off[n + 1]; ++i)
      sum = __fadd_rn(sum, a.req[(size_t)list[i] * a.r + col]);
    float* h = a.headroom + cell;
    *h = __fsub_rn(*h, sum);
    return;
  }
  cell -= span;
  if (fl & F_GC) {
    span = (long long)N * a.sg;
    if (cell < span) {
      const int n = (int)(cell / a.sg), g = (int)(cell % a.sg);
      float sum = 0.0f;
      for (int i = off[n]; i < off[n + 1]; ++i)
        sum = __fadd_rn(sum, a.match_groups[(size_t)list[i] * a.sg + g] ? 1.0f : 0.0f);
      add_count(a.group_count, (size_t)cell, sum, fl & F_GC_BF16);
      return;
    }
    cell -= span;
  }
  if (fl & F_PORTS) {
    span = (long long)N * a.pt;
    if (cell < span) {
      const int n = (int)(cell / a.pt), t = (int)(cell % a.pt);
      bool any = false;
      for (int i = off[n]; i < off[n + 1]; ++i)
        any |= a.ports[(size_t)list[i] * a.pt + t] != 0;
      if (any) a.ports_used[cell] = 1;
      return;
    }
    cell -= span;
  }
  if (fl & F_VOL) {
    span = (long long)N * a.lk;
    if (cell < span) {
      const int n = (int)(cell / a.lk), k = (int)(cell % a.lk);
      float sum = 0.0f;
      for (int i = off[n]; i < off[n + 1]; ++i)
        sum = __fadd_rn(sum, a.vol_limit_req[(size_t)list[i] * a.lk + k]);
      float* q = a.vol_cnt + cell;
      *q = __fadd_rn(*q, sum);
      return;
    }
    cell -= span;
  }
  if (fl & F_ANTI) {
    span = (long long)N * a.t;
    if (cell < span) {
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
      add_count(a.term_block, (size_t)cell, sum, fl & F_TB_BF16);
      return;
    }
    cell -= span;
  }
  if (fl & F_PREF) {
    span = (long long)N * a.t2;
    if (cell < span) {
      const int n = (int)(cell / a.t2), t2 = (int)(cell % a.t2);
      float* q = a.pref_paint + cell;
      float v = *q;
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
      *q = v;
    }
  }
}

long long node_cells(const FoldArgs* a) {
  const long long n = a->n;
  long long m = n * a->r;
  if (a->flags & F_GC) m += n * a->sg;
  if (a->flags & F_PORTS) m += n * a->pt;
  if (a->flags & F_VOL) m += n * a->lk;
  if (a->flags & F_ANTI) m += n * a->t;
  if (a->flags & F_PREF) m += n * a->t2;
  return m;
}

long long domain_cells(const FoldArgs* a) {
  const long long kd = (long long)a->k1 * a->d;
  long long m = 0;
  if (a->flags & F_DOM) m += kd * a->sg;
  if (a->flags & F_ANTI) m += kd * a->t;
  if (a->flags & F_PREF) m += kd * a->ap * a->t2;
  return m;
}

}  // namespace

// Launch the sequence on `stream` (PyTorch's current stream): the bucket
// kernel (one block a key), the domain kernel (a warp a domain cell) and
// the node kernel (a thread a node cell). Returns the first launch error:
// a refused launch never runs, so the caller must check it.
extern "C" int forced_fold_launch(const FoldArgs* args, void* stream) {
  if (args->c <= 0 || args->n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = ((size_t)args->b + 1 + 32) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(fold_bucket_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool domains = args->k1 > 0 && (args->flags & (F_DOM | F_ANTI | F_PREF));
  const int keys = domains ? args->k1 + 1 : 1;
  fold_bucket_kernel<<<keys, kBucketThreads, smem, st>>>(*args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long dcells = domains ? domain_cells(args) : 0;
  if (dcells > 0) {
    const long long threads = dcells * 32;
    fold_domain_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        *args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long ncells = node_cells(args);
  fold_node_kernel<<<(unsigned)((ncells + kThreads - 1) / kThreads), kThreads, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
