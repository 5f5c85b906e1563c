// wave_merge: one wave's binds folded into S lanes' carry at once, as one
// CUDA kernel for Hopper (sm_90a).
//
// Replaces: the XLA fusion of open_simulator_tpu/engine/scheduler.py:
// _wave_merge (:473, with _dense_slot_rows :460), the carry merge of every
// GRID wave, BATCH chunk and FORCED chunk of _run_wave_plan (:593). The JAX
// package has no Pallas kernel: on the TPU, XLA's fusion of those one-hot
// f32 matmuls (Precision.HIGHEST) is the kernel. The merge folds the wave's
// pods, each bound to `nodes[lane][i]` (negative: binds nothing), into the
// lane's carry channels, each behind the reference's gate:
//   headroom    -= the requests of the pods bound at the node
//   group_count += their matched groups (slot rows under slot_paint)
//   dom_count   += per topology key, the matched groups of the pods bound
//                  in the domain
//   ports_used  |= their host ports
//   vol_cnt     += their attachments (vol_limit_req)
//   term_block  += the anti-affinity terms of the pods bound in the term
//                  key's domain of the node
//   pref_paint  += per preferred slot, the weights of the pods bound in the
//                  slot key's domain of the node, slot by slot
//   gpu_used    += the pods' GPU picks x their per-device memory
//
// Design: one thread per (lane, carry cell the merge writes), over a flat
// index of the enabled channels; the thread walks the wave's pods in pod
// order, sums their contributions in f32 (round to nearest, no FMA) and
// writes the cell once: no atomics, so the result is deterministic. The
// reference's matmul sums integer-valued products (0/1 one-hots, counts,
// encoded requests and weights, exact below 2^24), so summing in pod order
// gives its bits; a bf16 carry adds the f32 sum rounded to bf16 once, as the
// reference's astype does.
//
// The engine's wave loop (engine/scheduler._run_wave_plan) launches it with
// MergeArgs.cursor set: the wave's first pod is read on the card, so one
// launch captured into a CUDA graph merges whichever wave the cursor names,
// its binds read from the loop's full-length output buffers; the
// arithmetic is the same.
//
// What bounds it on this card: bytes. Each thread reads its cell and the
// wave's node row (the same addresses across a warp, so one load serves
// it) and, for each pod bound at its node, that pod's value; the work per
// cell is one compare per pod. The carry read and write dominate for a
// narrow wave; the pod walk (c compares a cell) for a wide one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// MergeArgs.flags bits; mirrored in kernels/wave.py
constexpr int M_GC = 1 << 0;       // group_count (needs_group_count)
constexpr int M_DOM = 1 << 1;      // dom_count (maintain_dom_count)
constexpr int M_SLOT = 1 << 2;     // matched groups and own terms as slot rows
constexpr int M_PORTS = 1 << 3;    // ports_used
constexpr int M_VOL = 1 << 4;      // vol_cnt (attach limits)
constexpr int M_ANTI = 1 << 5;     // term_block paint
constexpr int M_PREF = 1 << 6;     // pref_paint paint
constexpr int M_GPU = 1 << 7;      // gpu_used (a GPU pick is given)
constexpr int M_GC_BF16 = 1 << 8;  // group_count stored bfloat16
constexpr int M_TB_BF16 = 1 << 9;  // term_block stored bfloat16
constexpr int kThreads = 256;

}  // namespace

extern "C" {

struct MergeArgs {
  const int32_t* node_dom;       // [K1, N] domain under each non-hostname key, -1 none
  const int32_t* term_key;       // [T] topology key of each anti-affinity term
  // pod arrays, the wave's pods at rows p0 .. p0 + c - 1
  const float* req;              // [P, R]
  const uint8_t* match_groups;   // [P, Sg]
  const int32_t* match_gid;      // [P, Mg] slot form, -1 pad
  const uint8_t* ports;          // [P, Pt]
  const float* vol_limit_req;    // [P, Lk]
  const uint8_t* own_terms;      // [P, T]
  const int32_t* own_tid;        // [P, Ot] slot form, -1 pad
  const int32_t* pref_key;       // [P, Ap]
  const int32_t* pref_tid;       // [P, Ap]
  const float* pref_weight;      // [P, Ap]
  const uint8_t* pref_valid;     // [P, Ap]
  const float* gpu_mem;          // [P]
  // the wave's binds: lane s's nodes at nodes + s * node_stride, [c]
  const int32_t* nodes;
  const int32_t* gpu_pick;       // [S, c, G] under M_GPU
  // the lanes' carry, updated in place
  float* headroom;               // [S, N, R]
  void* group_count;             // [S, N, Sg] bf16 or f32
  float* dom_count;              // [S, K1, D, Sg]
  uint8_t* ports_used;           // [S, N, Pt] (torch.bool storage)
  float* vol_cnt;                // [S, N, Lk]
  void* term_block;              // [S, N, T] bf16 or f32
  float* pref_paint;             // [S, N, T2]
  float* gpu_used;               // [S, N, G]
  int n, r, sg, mg, pt, lk, t, ot, ap, t2, g, k1, d, s, p0, c, node_stride, flags;
  // the wave loop's merge, captured into a CUDA graph (null otherwise): the
  // wave's first pod is *cursor, not p0, and its nodes and GPU picks are
  // rows *cursor - row_base of the loop's full-length [S, ls] buffers
  // (nodes node_stride = ls apart, gpu_pick ls x G apart); without it they
  // are the wave's own (gpu_pick c x G apart)
  const int32_t* cursor;
  int row_base, ls;
};

}  // extern "C"

namespace {

// pod p's count of group g: its slot rows (each slot once) or its dense row
__device__ __forceinline__ float group_of(const MergeArgs& a, int p, int g) {
  if (a.flags & M_SLOT) {
    float m = 0.0f;
    for (int j = 0; j < a.mg; ++j) m = __fadd_rn(m, a.match_gid[(size_t)p * a.mg + j] == g ? 1.0f : 0.0f);
    return m;
  }
  return a.match_groups[(size_t)p * a.sg + g] ? 1.0f : 0.0f;
}

// pod p's count of own anti-affinity term t
__device__ __forceinline__ float term_of(const MergeArgs& a, int p, int t) {
  if (a.flags & M_SLOT) {
    float m = 0.0f;
    for (int j = 0; j < a.ot; ++j) m = __fadd_rn(m, a.own_tid[(size_t)p * a.ot + j] == t ? 1.0f : 0.0f);
    return m;
  }
  return a.own_terms[(size_t)p * a.t + t] ? 1.0f : 0.0f;
}

// does node `at` share bound node `nd`'s domain under key `key` (0: the
// hostname, itself; past K1: no domain)?
__device__ __forceinline__ bool same_domain(const MergeArgs& a, int key, int nd, int at) {
  if (key == 0) return nd == at;
  if (key < 0 || key > a.k1) return false;
  const int32_t* dom = a.node_dom + (size_t)(key - 1) * a.n;
  const int df = dom[nd];
  return df >= 0 && dom[at] == df;
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

__global__ void __launch_bounds__(kThreads) wave_merge_kernel(const MergeArgs a) {
  const int lane = blockIdx.y;
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the wave's first pod and its row in the binds' buffers
  const int p0 = a.cursor ? *a.cursor : a.p0;
  const int row = a.cursor ? p0 - a.row_base : 0;
  const int32_t* nodes = a.nodes + (size_t)lane * a.node_stride + row;
  const int N = a.n, fl = a.flags;
  const size_t ln = (size_t)lane * N;

  long long span = (long long)N * a.r;
  if (cell < span) {
    const int n = (int)(cell / a.r), col = (int)(cell % a.r);
    float sum = 0.0f;
    for (int i = 0; i < a.c; ++i)
      if (nodes[i] == n) sum = __fadd_rn(sum, a.req[(size_t)(p0 + i) * a.r + col]);
    float* h = a.headroom + (ln + n) * a.r + col;
    *h = __fsub_rn(*h, sum);
    return;
  }
  cell -= span;
  if (fl & M_GC) {
    span = (long long)N * a.sg;
    if (cell < span) {
      const int n = (int)(cell / a.sg), g = (int)(cell % a.sg);
      float sum = 0.0f;
      for (int i = 0; i < a.c; ++i)
        if (nodes[i] == n) sum = __fadd_rn(sum, group_of(a, p0 + i, g));
      add_count(a.group_count, (ln + n) * a.sg + g, sum, fl & M_GC_BF16);
      return;
    }
    cell -= span;
  }
  if (fl & M_DOM) {
    span = (long long)a.k1 * a.d * a.sg;
    if (cell < span) {
      const int kk = (int)(cell / ((long long)a.d * a.sg));
      const int rem = (int)(cell % ((long long)a.d * a.sg));
      const int dd = rem / a.sg, g = rem % a.sg;
      const int32_t* dom = a.node_dom + (size_t)kk * N;
      float sum = 0.0f;
      for (int i = 0; i < a.c; ++i) {
        const int nd = nodes[i];
        if (nd >= 0 && dom[nd] == dd) sum = __fadd_rn(sum, group_of(a, p0 + i, g));
      }
      float* q = a.dom_count + (size_t)lane * a.k1 * a.d * a.sg + cell;
      *q = __fadd_rn(*q, sum);
      return;
    }
    cell -= span;
  }
  if (fl & M_PORTS) {
    span = (long long)N * a.pt;
    if (cell < span) {
      const int n = (int)(cell / a.pt), t = (int)(cell % a.pt);
      bool any = false;
      for (int i = 0; i < a.c; ++i)
        any |= nodes[i] == n && a.ports[(size_t)(p0 + i) * a.pt + t] != 0;
      if (any) a.ports_used[(ln + n) * a.pt + t] = 1;
      return;
    }
    cell -= span;
  }
  if (fl & M_VOL) {
    span = (long long)N * a.lk;
    if (cell < span) {
      const int n = (int)(cell / a.lk), k = (int)(cell % a.lk);
      float sum = 0.0f;
      for (int i = 0; i < a.c; ++i)
        if (nodes[i] == n) sum = __fadd_rn(sum, a.vol_limit_req[(size_t)(p0 + i) * a.lk + k]);
      float* q = a.vol_cnt + (ln + n) * a.lk + k;
      *q = __fadd_rn(*q, sum);
      return;
    }
    cell -= span;
  }
  if (fl & M_ANTI) {
    span = (long long)N * a.t;
    if (cell < span) {
      const int n = (int)(cell / a.t), t = (int)(cell % a.t);
      const int key = a.term_key[t];
      float sum = 0.0f;
      for (int i = 0; i < a.c; ++i) {
        const int nd = nodes[i];
        if (nd >= 0 && same_domain(a, key, nd, n)) sum = __fadd_rn(sum, term_of(a, p0 + i, t));
      }
      add_count(a.term_block, (ln + n) * a.t + t, sum, fl & M_TB_BF16);
      return;
    }
    cell -= span;
  }
  if (fl & M_PREF) {
    span = (long long)N * a.t2;
    if (cell < span) {
      const int n = (int)(cell / a.t2), t2 = (int)(cell % a.t2);
      float* q = a.pref_paint + (ln + n) * a.t2 + t2;
      float v = *q;
      for (int s = 0; s < a.ap; ++s) {  // one add per slot, as the reference
        float sum = 0.0f;
        for (int i = 0; i < a.c; ++i) {
          const int nd = nodes[i];
          const size_t o = (size_t)(p0 + i) * a.ap + s;
          if (nd < 0 || !a.pref_valid[o] || a.pref_tid[o] != t2) continue;
          if (same_domain(a, a.pref_key[o], nd, n)) sum = __fadd_rn(sum, a.pref_weight[o]);
        }
        v = __fadd_rn(v, sum);
      }
      *q = v;
      return;
    }
    cell -= span;
  }
  if (fl & M_GPU) {
    span = (long long)N * a.g;
    if (cell < span) {
      const int n = (int)(cell / a.g), g = (int)(cell % a.g);
      const int32_t* pick = a.gpu_pick + ((size_t)lane * a.ls + row) * a.g;
      float sum = 0.0f;
      for (int i = 0; i < a.c; ++i)
        if (nodes[i] == n)
          sum = __fadd_rn(sum, __fmul_rn((float)pick[(size_t)i * a.g + g], a.gpu_mem[p0 + i]));
      float* q = a.gpu_used + (ln + n) * a.g + g;
      *q = __fadd_rn(*q, sum);
    }
  }
}

// the cells a lane's merge writes under these flags
long long cells_of(const MergeArgs* a) {
  const long long n = a->n;
  long long m = n * a->r;
  if (a->flags & M_GC) m += n * a->sg;
  if (a->flags & M_DOM) m += (long long)a->k1 * a->d * a->sg;
  if (a->flags & M_PORTS) m += n * a->pt;
  if (a->flags & M_VOL) m += n * a->lk;
  if (a->flags & M_ANTI) m += n * a->t;
  if (a->flags & M_PREF) m += n * a->t2;
  if (a->flags & M_GPU) m += n * a->g;
  return m;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): a grid of (cells / 256,
// S) blocks. Returns cudaGetLastError(): a refused launch never runs, so
// the caller must check it.
extern "C" int wave_merge_launch(const MergeArgs* args, void* stream) {
  const long long cells = cells_of(args);
  if (args->c <= 0 || cells <= 0 || args->s <= 0) return (int)cudaSuccess;
  if (args->s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cells + kThreads - 1) / kThreads), (unsigned)args->s, 1);
  wave_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
