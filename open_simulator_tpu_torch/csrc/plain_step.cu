// plain_step: the scheduling step of open_simulator_tpu_torch as one CUDA
// kernel for Hopper (sm_90a), run over a range of pods [p0, p1) for S lanes.
//
// Replaces: the XLA fusion of open_simulator_tpu/engine/scheduler.py:_step
// (the body of the lax.scan in schedule_pods, scheduler.py:745-1449) for the
// plain-fit ops, required pod affinity and anti-affinity, hard and soft
// PodTopologySpread, the interpod preference score and the device-resource
// ops (GPU share, open-local storage, the static volume masks,
// WaitForFirstConsumer PV matching, attach limits and shared-volume dedup;
// ops/gpu_share.py, ops/storage.py, ops/volumes.py and
// scheduler.py:982-1044, :1392-1443 of the reference). The JAX package has
// no Pallas kernel: on the TPU, XLA's fusion of _step is the kernel. Per
// pod: the batched carry-column read (the pod's affinity, anti-affinity,
// spread and preferred-term columns of group_count summed per domain), the
// filter masks in filter_op_table order, the first-fail reason histogram,
// the raw scores, the normalizer min-reductions, the final score in the
// reference's add order, selectHost (max, then the lowest index among exact
// maxima) and the bind into the lane's carry, including the anti-affinity
// term paint and the preferred-term paint over the bound node's domain.
//
// What bounds it on this card: latency, not bytes or operations (the
// kernel runs thousands of times over its operations bound at one lane and
// 65-190x at 64 lanes, PERF.md). Each pod's pick depends on the previous
// pod's bind, so the P pods of a lane form one dependent chain, and per
// pod each thread walks its nodes, each through a chain of dependent loads
// and arithmetic, between the cross-node reductions: a pod takes about the
// nodes a thread walks times that chain, plus the reductions. At 64 lanes
// (C = 2: 2,592 nodes a block, 6-7 a thread, 12-16 warps an SM) the node
// walk of phase 1 was 59-81% of a pod, 4.1k-13.8k cycles a node a thread,
// and the column read of phase 0b another 28% on the rich cluster; with
// the staged regions below, 3.4k (north star), 9.9k (rich) and 12.8k
// (device resources): 12-13% less a 64-lane launch, 6% with the
// device-resource ops (PERF.md).
//
// Design: one thread-block cluster of C blocks per lane (grid S x C,
// launched with cudaLaunchKernelEx and a cluster dimension). The launcher
// (kernels/step.py:plan_launch) takes the largest power of two C <= 16
// whose S clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// so one lane spreads over up to 16 SMs and a thread holds one to a few
// nodes. Block `rank` owns the contiguous node slice [rank*SL, (rank+1)*SL)
// of its lane, so block rank order is node order. Each block reduces its
// slice in shared memory (warp shuffles, then one shared atomic per warp),
// and the cluster combines the blocks' partials through distributed shared
// memory (cooperative_groups::this_cluster(), map_shared_rank), one
// cluster.sync() per round: the per-domain column sums of phase 0b (on the
// group_count path), then the normalizer minima, the feasible count and
// the first-fail histogram, then the (score, lowest index) argmax. The
// partials are double-buffered by pod parity: a block rewrites a buffer
// only after every block has passed the next round's barrier, so each
// round needs one cluster barrier. Minima, integer counts and the
// lexicographic argmax give the same answer in any order. The raw scores
// and feasibility flags of phase 1 stay in the block's shared memory for
// phase 2 (no global scratch), and the block's slice of headroom lives in
// shared memory for the whole launch when it fits (the launcher decides).
// What stays: at one lane the two or three cluster rounds are about a
// third of a pod. At 64 lanes a node's chain holds what the staging cannot
// take off it: the carry reads (group_count at hostname-keyed columns,
// term_block at the hit terms, pref_paint, ports_used, the device-resource
// carries) and the arithmetic (the Simon and GPU rows' IEEE divides, the
// rounded score sums), with 3-4 warps a scheduler to hide them: a
// spill-free build needs 112-168 registers a thread (a block of at most
// 512 threads, 384 with the device-resource walks), so no build fits two
// blocks an SM (at __launch_bounds__(threads, 2) ptxas spills and the
// launch is 10-14% slower).
//
// The staged regions (kernels/step.py:plan_launch chooses; PERF.md):
// the loads of a node's chain that do not depend on the carry are taken
// off it. The pod's scalars are one row of a host-built pod_pack (a 16-byte
// record a carry column: group, key, the valid / self / soft / hard bits,
// maxSkew or the preferred term's id and weight; the request; the hit list
// hit_w wide; the ports, match groups and preferred hits as bytes), and
// each pod's class rows (node-affinity score, taint prefer, class affinity
// and taint) one row of a pack cut into the plan's block slices, each
// padded to 16 nodes (RES_STAGE_CLASS): one thread issues 1-D bulk copies
// (cp.async.bulk, completing on the buffer's mbarrier) of the next pod's
// rows right after this pod's phase-0 barrier, when every thread is past
// the pod that last read that buffer, into two buffers by the pod's place
// in the loop; the first pod's copies fly during the lane prologue, and
// every thread waits on its pod's barrier after phase 0's barrier. The
// slice's node-static rows (active, unschedulable, inv_alloc's two
// columns, spec_id, node_dom, has_key) are copied once a launch in the
// lane prologue (RES_STAGE_NODE). A plan whose slice cannot hold them
// drops the class rows first, then the node rows, and reads them where
// they lie; the extension loop's one-pod launches stage neither (their one
// pod would not repay the copy), the device-resource builds no class rows,
// `<1,1>` no node rows (registers: that code is compiled out of those
// builds); the frozen form stages as the scan does, a group's pods at once.
//
// Ownership. A node's carry rows (headroom, ports, group_count, term_block,
// pref_paint and the device-resource rows) are read and written only by the
// block that owns the node: the bind, the term paint and the preferred-term
// paint over the bound node's domain are done by each painted node's owner
// thread, in slot order, and the device-resource bind by the block that owns
// the bound node. The lane-wide state (dom_count [K1, D, Sg] and pv_taken
// [Npv]) is held as one shared-memory replica per block: every block applies
// the same adds in the same order, and rank 0 writes it back at the end, so
// no barrier orders a bind before the next pod's reads across blocks.
//
// The lane prologue (F_TEMPLATE; replaces the reference's vmapped lanes,
// open_simulator_tpu/engine/exec_cache.py:batched_lane_fn, and its fresh
// lane state, :_fresh_lane_state): every lane starts from one [N, ...]
// template carry, the fresh carry with the forced prefix folded in. Each
// block first writes its slice of the lane's carry (and its replicas) from
// the template, then runs the pod loop, so the launcher needs no S-fold
// copy on the host and a sweep round can reuse the previous round's carry.
//
// The reverse anti-affinity verdict reads only the pod's hit-term columns
// (a host-built list, the nonzeros of hit_terms): "any hit column > 0" over
// nonnegative counts is the verdict of both the reference's dense
// term_block @ hit_terms and its slot-form gather, without sweeping all T
// columns per node.
//
// The device-resource ops run in their own instantiation (kDevRes), so
// launches without them keep the code and registers they had. Each node's
// thread walks its GPU devices, volume groups, devices and admitted PVs
// serially, in ascending index: every "lowest index on ties" of the
// reference (the single-GPU argmin, lvm_pack's argmax, device_match's
// argmin, the first free PV) falls out of the walk. A node's admitted PVs
// are a host-built list (the CSR of pv_node_ok's columns, ascending PV id:
// the reference's capacity-ascending axis, keeping only PVs that are some
// claim class's candidate), and the PVs a node's claims
// have chosen so far sit in a per-thread array, so no [Npv, N] table is
// swept. The bind recomputes the bound node's storage plan and PV picks
// (the same values the filter pass found for that node) in one thread.
//
// The preemption columns (StepArgs.disabled / nominated, the reference's
// _disabled and _nominated, scheduler.py:1223-1235, :1290-1297) are the
// third template flag, kCols, set when either pointer is non-null: a
// launch without them (the sweep, simulate()'s first pass) runs the code
// it ran before the columns existed. They only mask values, so a pod with
// either still runs every phase and every cluster barrier (the partials
// are double-buffered by pod parity, and a block that skipped a round
// would let a faster block overwrite a buffer a slower one still reads).
// The two values are loaded with the pod's other scalars, so their
// latency hides behind phases 0 and 1. Whether the nominated node is still feasible is
// known only to the block that owns it: its phase-1 thread sets a bit in
// the block's round-A partials, which every block gathers with the minima,
// and phase 2 then keys only that node, so the pick is the nomination. A
// victim's outputs are node -3 and zero reason and feasible counts, and it
// binds nothing.
//
// The frozen wave form (StepArgs.frozen, the fourth template flag kFrozen;
// replaces the reference's _grid_step and the BATCH segment's
// jax.vmap(step(frozen, .)), scheduler.py:581-590, :627-635): the wave
// planner (engine/waves.py) has proved a run of pods carry-independent, so
// each pod is evaluated against the lane's wave-start carry, which the
// launch only reads; the wave merge (csrc/wave_merge.cu) folds the binds
// in afterwards. It is a body of its own (frozen_body, below the scan's):
// a cluster serves one lane and a group of StepArgs.grp of its pods, so
// the prologue, the staged rows, each node's carry reads and the cluster
// rounds are paid once a group (its comment has the design; PERF.md the
// measurement that led to it: at 64 lanes one pod a cluster ran 2,048
// clusters in 16 rounds). It is built only without the columns (a plan is
// dropped under them), so the eight scan builds keep their code. With
// StepArgs.cursor it reads its wave's first pod from the card (the engine's
// wave loop, replayed as a CUDA graph).
//
// Explain and the seeded tie-break (the fifth template flag, kExplain;
// replaces the reference's explain top-k and tie-break jitter,
// scheduler.py:1238-1266 with the part rows of :1083-1091). kExplain is
// not a per-launch branch but a build: this file is compiled twice, and the
// build with PLAIN_STEP_EXPLAIN=1 holds the twelve kExplain instantiations
// in a library of its own, so the twelve builds without it keep their code,
// and the two compile side by side. The jitter (StepArgs.jitter, the PRNG
// key words key0/key1 of PRNGKey(seed)): thread 0 folds the pod's global
// index into the key in phase 0 (fold_in: one threefry2x32 of (0, p)), and
// in phase 2 each node's owner thread hashes (0, n) under the folded key,
// builds the uniform in [0, 0.5) as jax.random.uniform does (the top 23
// bits as the mantissa of [1, 2), minus 1, times 0.5) and adds it to the
// score rounded half to even (rintf), before the pick. The top-k
// (StepArgs.topk = K > 0): phase 2 keeps each node's masked final score in
// shared memory (one more row beside the raw scores), and the nodes are
// ranked by a 64-bit key of the score's total order (+0 above -0, as
// lax.top_k orders) and the lower index, in passes of up to kTopkPass
// candidates. In a pass each warp builds its list of the largest keys by
// repeated warp maxima (a 64-bit maximum is two redux.sync reductions;
// only the winning thread rescans its few nodes for its next key, so no
// thread holds a list in registers), warp 0 merges the block's warp lists
// into the block's list in shared memory, and after the pass's cluster
// barrier warp 0 of every block reads the C blocks' lists through
// distributed shared memory and merges them into the pass's candidates.
// Candidate c's row (its node, masked score and weighted score rows, zero
// for a filler slot, a node past the feasible ones) is then written by
// lane c of the last warp of the block that owns the node, all in parallel
// and beside warp 0's share of the bind, computed by the same function
// that sums the final score, so the parts and the sum share their
// arithmetic. The first pass rides round B's barrier and pass i takes the
// largest keys below pass i - 1's last: a K up to kTopkPass adds no cluster
// barrier a pod (one block barrier and 2K warp-merge steps), a larger K
// ceil(K / kTopkPass) - 1 barriers. No K is capped: K = N runs
// ceil(N / kTopkPass) passes. kTopkPass = 8: the lists live in shared
// memory (21 rows of 8 keys, 1,344 bytes a block), so the width costs no
// registers (a thread holds one key) and the explain builds stay
// spill-free; 8 holds the CLI's K = 3 and any K up to 8 in one pass, and a
// wider pass would only lengthen every merge's serial steps. What it costs
// besides: the 20 threefry rounds per node of the jitter, latency, as
// every other round of the pod.
//
// The traced weights (StepArgs.w_lane; replaces the reference's per-lane
// weight vector, exec_cache.py:521-545 and scheduler.py:1097-1116): an
// [S, kWeights] row of score weights per lane, read once per block in the
// lane prologue into shared memory; the score code multiplies by the
// lane's row, and with w_lane null by the launch's scalars (w_bal ..
// w_gpu), so the launches without weights run the code they ran before.
// It is a runtime pointer, not a template flag: the traced mode sets every
// weight-gated row's flag (F_BAL .. F_SI), and a zero weight adds its
// 0 x value in its place in the sum, as in the reference.
//
// Per-phase cycle counts (StepArgs.cycles, null unless asked): thread 0 of
// rank 0 reads clock64() at each phase boundary and sums over the pods (the
// frozen form: of each lane's first cluster, over its group).
//
// The extension rows (StepArgs.ext_ok / ext_raw; replaces the reference's
// out-of-tree extension ops in _step, scheduler.py:1051-1054, :1171-1184,
// :1214-1221): the callables of engine/extensions.ExtensionOp read the
// carry, so the host evaluates them against the lane's live carry and
// launches the step one pod at a time with their [S, P', Ef, N] masks and
// [S, P', Es, N] raw scores (engine/scheduler._extension_scan). Phase 1
// ANDs each mask after the built-in filters (its first failing row is
// charged as op OPS - Ef + e) and adds each score's normalizer minima,
// "minmax" where(mask, raw, big) and where(mask, -raw, big), "max"
// where(mask, -raw, 0), as integer keys (a NaN keys lowest, so it wins the
// minimum as it does in jnp.minimum) in dynamic shared memory by pod
// parity; round A reduces them over the cluster; phase 2 adds
// w_e x (raw - lo) x inv after the GPU row, in registration order, in the
// function that sums the score (so explain's parts carry the rows). A NaN
// final score keys above every node, so the pod stays unbound, as the
// reference's max leaves it. The rows are the sixth template flag, kExt,
// and a build of their own: compiled with PLAIN_STEP_EXT=1 this file is the
// library plain_step_ext (plain_step_ext_explain with PLAIN_STEP_EXPLAIN=1)
// of the eight scan builds with the rows (a wave plan is dropped under
// extensions, and a fleet runs them serially), so the scan builds of the
// other libraries carry none of their code or shared memory; the wide
// library keeps them in its scan builds, gated at run time on ef / es.
// The engine's loop launches them one pod at a time, replayed as a CUDA
// graph (engine/scheduler._extension_scan): a launch with StepArgs.cursor
// set runs the one pod the device cursor names (every block reads it in
// the prologue), writes output row *cursor - p0 and reads row 0 of
// [S, 1, Ef, N] / [S, 1, Es, N] rows, so one captured launch serves every
// pod; the engine advances the cursor in a step of its own after the
// launch, never inside it (at 64 lanes other clusters may still read it).
//
// The fleet form (plain_step_fleet_kernel, four builds a library; replaces
// the reference's run_fleet_batched, exec_cache.py:837): each lane is a
// cluster of its own, every array its own. The launcher builds each lane's
// StepArgs as a lone launch of that cluster would; each block copies its
// lane's into shared memory and runs the same body with lane index 0.
//
// The wide library (built again with PLAIN_STEP_WIDE=1; it replaces no
// TPU kernel: the reference has no width caps, and this keeps the kernel
// computing every width the encoder can produce): a launch whose
// device-resource widths pass kMaxV, kMaxE or kMaxLw walks them in a
// per-thread window of global memory (StepArgs.walk), and a launch whose
// dom_count replica or column-read partials do not fit a block's shared
// memory keeps them in global memory, one region per block
// (RES_DOM_GLOBAL, RES_COLS_GLOBAL). The launcher picks it only for such
// launches (kernels/step.needs_wide); in the other libraries that code is
// compiled out, so their builds keep their code and registers.
//
// Exactness: built with --fmad=false, and every float operation is an
// explicit round-to-nearest intrinsic, so each one is the same IEEE
// operation, in the same order, as in the plain torch step
// (open_simulator_tpu_torch/engine/scheduler.py:_step). The reductions are
// min (exact in any order), the (max, lowest index) pick and integer counts
// (domain sums of the carry's integer counts are integer adds). The
// interpod raw sums and pref_paint hold integer-valued f32 (weights x
// counts), exact below 2^24.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// which library this compilation is: PLAIN_STEP_EXPLAIN 0 the builds
// without explain, 1 the kExplain builds; PLAIN_STEP_WIDE 1 the builds with
// the walk window and the regions in global memory; PLAIN_STEP_EXT 1 the
// scan builds with the extension rows (kernels/build.py passes
// -DPLAIN_STEP_EXPLAIN=1, -DPLAIN_STEP_WIDE=1 and -DPLAIN_STEP_EXT=1)
#ifndef PLAIN_STEP_EXPLAIN
#define PLAIN_STEP_EXPLAIN 0
#endif
#ifndef PLAIN_STEP_WIDE
#define PLAIN_STEP_WIDE 0
#endif
#ifndef PLAIN_STEP_EXT
#define PLAIN_STEP_EXT 0
#endif

namespace {

constexpr bool kWideLib = PLAIN_STEP_WIDE != 0;
constexpr bool kExtLib = PLAIN_STEP_EXT != 0;
static_assert(!(kWideLib && kExtLib), "the wide library keeps its own extension rows");

// block size caps, so that ptxas keeps each instantiation in registers (no
// spill): 128 registers a thread, 168 with the device-resource walks; the
// fleet builds (their StepArgs in shared memory, not in the constant bank)
// and the wide library's builds take 168 and 255, and so do the explain
// library's builds (the top-k's lists and part rows beside the staged
// regions; its grouped frozen builds spill 4 bytes at 128); the launcher
// picks the block size under the cap (kernels/step.py:max_threads)
constexpr int kMaxThreads = 512;
constexpr int kMaxThreadsDevRes = 384;
constexpr int kMaxThreadsWide = 384;
constexpr int kMaxThreadsWideDevRes = 256;
constexpr int kMaxThreadsExplain = 384;
constexpr int kMaxThreadsExplainDevRes = 256;
// the extension library's scan builds (<1,0>+columns spills 8 bytes at
// 128 registers with the rows and the cursor)
constexpr int kMaxThreadsExt = 384;

__host__ __device__ constexpr int max_threads_of(bool devres, bool wide, bool explain = false,
                                                 bool ext = false) {
  return wide ? (devres ? kMaxThreadsWideDevRes : kMaxThreadsWide)
       : (explain && devres) ? kMaxThreadsExplainDevRes
       : explain ? kMaxThreadsExplain
       : ext ? kMaxThreadsExt
       : (devres ? kMaxThreadsDevRes : kMaxThreads);
}
constexpr int kMaxCluster = 16;     // blocks per lane (16 is non-portable)
// the explain top-k: a pass ranks up to kTopkPass candidates a pod in one
// cluster round (kernels/step.py:TOPK_PASS); each warp's list of a pass,
// and after the pass's barrier each block's, sit in kTopkLists rows (the
// warps of the largest block, the blocks of the largest cluster)
constexpr int kTopkPass = 8;
constexpr int kTopkLists = 16;
static_assert(kTopkLists >= kMaxThreads / 32 && kTopkLists >= kMaxCluster, "top-k list rows");
// the top-k's key rows in 4-byte words: the lists, the block's merged list
// by pod parity and pass parity, the pass's candidates (8-byte keys)
constexpr int kTopkWords = 2 * (kTopkLists + 4 + 1) * kTopkPass;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;
constexpr float kNegInf = -3.4e38f;
constexpr int kRows = 10;  // normalizer min-reduction rows
// the score weights, in WEIGHT_FIELDS order: balanced, least, most, node
// affinity, taint, interpod, spread, Simon, GPU
constexpr int kWeights = 9;
// widths the device-resource walks keep in per-thread arrays; a launch
// past any of them walks a window of global memory instead (StepArgs.walk)
constexpr int kMaxV = 8;    // volume groups per node
constexpr int kMaxE = 32;   // exclusive devices per node (a bit mask)
constexpr int kMaxLw = 8;   // WaitForFirstConsumer claims per pod
// per-phase cycle counts (StepArgs.cycles): prologue, phase 0/0b/0c,
// phase 1, the min/count reduction, phase 2, the argmax reduction, bind
constexpr int kPhases = 7;

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
constexpr int F_TEMPLATE = 1 << 21;    // lane prologue: carry slices from the template
constexpr int F_GPU = 1 << 22;         // GPU-share filter, score, pick and debit
constexpr int F_STORAGE = 1 << 23;     // open-local LVM and exclusive-device filter + plan
constexpr int F_VOL_STATIC = 1 << 24;  // static volume class masks + missing-PV row
constexpr int F_PV_MATCH = 1 << 25;    // WaitForFirstConsumer PV matching + pv_taken
constexpr int F_VOL_LIMITS = 1 << 26;  // attach limits (vol_cnt carry)
constexpr int F_VOL_DEDUP = 1 << 27;   // shared-volume dedup (svol_on_node carry)
// the gates of the inter-pod and device-resource slices: a launch that
// sets none of a slice's gates runs an instantiation without its code
// (and its registers); the preemption columns are the third such gate
constexpr int kInterpodFlags = F_AFF | F_ANTI | F_SPH | F_IP | F_PREF;
constexpr int kDevResFlags =
    F_GPU | F_STORAGE | F_VOL_STATIC | F_PV_MATCH | F_VOL_LIMITS | F_VOL_DEDUP;

// what a pod's carry column q needs from the column read (s_qneed bits)
constexpr int kNeedDom = 1;   // per-domain sums (non-hostname key)
constexpr int kNeedTot = 2;   // the column's total (affinity bootstrap)
constexpr int kNeedMin = 4;   // min over hostname-eligible nodes (hard spread)

// StepArgs.res bits; mirrored in kernels/step.py
constexpr int RES_HEADROOM = 1;     // the block's headroom slice lives in shared memory
constexpr int RES_DOM_GLOBAL = 2;   // the dom_count replicas live in global memory
constexpr int RES_COLS_GLOBAL = 4;  // the column-read partials live in global memory
constexpr int RES_STAGE_NODE = 8;   // the slice's node-static rows staged once a launch
constexpr int RES_STAGE_CLASS = 16; // each pod's class rows staged by bulk copies, one pod ahead

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
  // the preemption columns, null when absent
  const uint8_t* disabled;            // [P] a victim: deleted, node -3
  const int32_t* nominated;           // [P] the preemption retry's node, -1 none
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
  // the template carry every lane starts from (F_TEMPLATE; else unused)
  const float* tmpl_headroom;         // [N, R]
  const uint8_t* tmpl_ports_used;     // [N, Pt]
  const float* tmpl_dom_count;        // [K1, D, Sg]
  const void* tmpl_group_count;       // [N, Sg], the carry's dtype
  const void* tmpl_term_block;        // [N, T], the carry's dtype
  const float* tmpl_pref_paint;       // [N, T2]
  // outputs, pod axis p - p0
  int32_t* out_node;                  // [S, P']
  int32_t* out_fail;                  // [S, P', OPS], only under F_FAIL
  int32_t* out_feasible;              // [S, P']
  int n, r, c, u, k, k1, d, sg, pt, cs, a, b, ap, t, t2, ops, s, p0, p1, ci, mi, flags;
  float w_bal, w_least, w_most, w_na, w_tt, w_ip, w_sp, w_si;
  // the device-resource ops (kDevRes), after the fields of the other
  // instantiations so that their layout is unchanged
  const float* gpu_cap_mem;           // [N] per-device GPU memory
  const float* gpu_slot;              // [N, G] 1 for a real device
  const float* vg_cap;                // [N, V] volume-group capacity (MiB)
  const float* sdev_cap;              // [N, E] exclusive-device capacity, 0 = none
  const uint8_t* sdev_ssd;            // [N, E] device media is ssd
  const int32_t* pv_ptr;              // [N+1] offsets into pv_idx
  const int32_t* pv_idx;              // each node's admitted PVs, ascending id
  const uint8_t* pv_cand;             // [Cc, Npv] candidate PVs of a claim class
  const uint8_t* class_vol_node;      // [Cv, N] bound-PV node affinity
  const uint8_t* class_vol_zone;      // [Cv, N] bound-PV zone labels
  const uint8_t* class_vol_bind;      // [Cv, N] provisioning allowedTopologies
  const float* vol_limit_cap;         // [N, Lk] attach limit per key
  const int32_t* svol_key;            // [Nsv] limit key of each shared volume
  // device-resource pod arrays
  const float* gpu_mem;               // [P] per-device GPU memory request
  const float* gpu_cnt;               // [P] devices wanted
  const int32_t* gpu_forced;          // [P, G] pinned multiplicities (gpu-index)
  const uint8_t* gpu_has_forced;      // [P]
  const float* lvm_req;               // [P, Lv] LVM volume sizes, descending
  const float* sdev_req;              // [P, Ev] exclusive-device claim sizes
  const uint8_t* sdev_req_ssd;        // [P, Ev] the claim wants ssd
  const int32_t* vol_cid;             // [P] volume class
  const uint8_t* vol_pv_missing;      // [P] a bound claim names a missing PV
  const int32_t* wfc_ccid;            // [P, Lw] claim class per WFC slot
  const uint8_t* wfc_valid;           // [P, Lw]
  const float* vol_limit_req;         // [P, Lk] attachments of unshared claims
  const int32_t* svol_id;             // [P, Lsv] shared volumes mounted, -1 pad
  // device-resource carries, their template, outputs
  float* gpu_used;                    // [S, N, G] carry
  float* vg_used;                     // [S, N, V] carry
  uint8_t* sdev_taken;                // [S, N, E] carry (torch.bool storage)
  uint8_t* pv_taken;                  // [S, Npv] carry (torch.bool storage)
  float* vol_cnt;                     // [S, N, Lk] carry
  uint8_t* svol_on_node;              // [S, N, Nsv] carry (torch.bool storage)
  const float* tmpl_gpu_used;         // [N, G]
  const float* tmpl_vg_used;          // [N, V]
  const uint8_t* tmpl_sdev_taken;     // [N, E]
  const uint8_t* tmpl_pv_taken;       // [Npv]
  const float* tmpl_vol_cnt;          // [N, Lk]
  const uint8_t* tmpl_svol_on_node;   // [N, Nsv]
  int32_t* out_gpu_pick;              // [S, P', G], only under F_GPU
  int32_t* out_vol_pick;              // [S, P', Lw], only under F_PV_MATCH
  int g, v, e, lv, ev, npv, lw, lk, lsv, nsv;
  float w_gpu;
  // [S, kPhases] cycles (clock64 on thread 0 of rank 0, summed over the
  // pods), or null
  long long* cycles;
  // the launch geometry (kernels/step.py:plan_launch): cluster size,
  // threads per block, nodes per block slice, residency bits (RES_*)
  int cl, bt, sl, res;
  // the frozen wave form (kFrozen): a cluster per lane and group of pods,
  // no bind
  int frozen;
  // explain and the tie-break (kExplain): K candidates (0 off) of C score
  // rows each; the jitter on (1) under PRNGKey(seed) = (key0, key1)
  int topk, n_parts, jitter;
  unsigned key0, key1;
  int32_t* out_topk_node;             // [S, P', K]
  float* out_topk_score;              // [S, P', K]
  float* out_topk_parts;              // [S, P', C, K]
  // the traced weights: each lane's kWeights score weights (the scalars
  // w_bal .. w_gpu above when null)
  const float* w_lane;                // [S, kWeights]
  // the fleet form (plain_step_fleet_kernel): the launch's lanes, one
  // StepArgs each on the card, every one built as a one-lane launch over
  // its own cluster would be (null outside a fleet launch); `fleet` is 1
  // in the launch's StepArgs and in each lane's
  const struct StepArgs* lanes;       // [S]
  int fleet;
  // the device-resource walks past kMaxV / kMaxE / kMaxLw: each thread's
  // window of walk_w words in global memory, interleaved over a lane's
  // C x B threads (null: every width fits the per-thread arrays)
  int* walk;                          // [S, walk_w, C * B]
  int walk_w;
  // what plan_launch places in global memory when a block's shared memory
  // cannot hold it: each block's dom_count replica (RES_DOM_GLOBAL) and
  // its column-read partials, by pod parity (RES_COLS_GLOBAL)
  float* dom_spill;                   // [S, C, K1 * D * Sg]
  int* col_spill;                     // [S, C, 2, Q * D + 2Q]
  // the extension rows (null without extensions; the scan builds only):
  // each filter extension's mask and each score extension's raw score per
  // lane and pod, the score rows' f32 weights and normalize kinds (0 none,
  // 1 minmax, 2 max), the counts, and `ered`, the normalizer rows they add
  const uint8_t* ext_ok;              // [S, P', Ef, N]
  const float* ext_raw;               // [S, P', Es, N]
  const float* ext_w;                 // [Es]
  const int32_t* ext_norm;            // [Es]
  int ef, es, ered;
  // the lane stride of the output rows (P' for outputs of the launch's own
  // pods; larger where a launch writes into rows of a longer output)
  int ls;
  // the staged regions' sources (kernels/step.py): each pod's region as
  // the kernel stages it (PodLay; its hit list hit_w wide, -1 past its
  // last; hit_w 0: the pod reads hit_ptr / hit_idx), and under
  // RES_STAGE_CLASS each class's rows packed per block slice of slp = sl
  // rounded up to 16 nodes; both the sources of the bulk copies
  const int32_t* pod_pack;            // [P, PodLay.words]
  const uint8_t* cls_pack;            // [C, cl, 10 * slp]: node-affinity score and taint
                                      // prefer (f32), class affinity and taint (u8)
  int hit_w;
  // the one-pod launches of the extension loop (kExt builds) and the
  // frozen form's waves (null otherwise): the pod's index on the card, read
  // by every block, so a captured launch runs whichever pod the cursor
  // names; a pod p writes output row p - p0 (p1 - p0 = ls rows), and the
  // extension loop's reads extension row 0
  const int32_t* cursor;              // [1]
  // the frozen form's groups (kFrozen; kernels/step.py:frozen_group): each
  // cluster evaluates up to grp of the launch's npod pods, which start at
  // pod p0 + poff, or with the cursor at pod *cursor + poff (a launch
  // captured into the wave loop's CUDA graph); pod p writes output row
  // p - p0
  int grp, npod, poff;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// an int whose order is the float's (no NaN): a < b iff fkey(a) < fkey(b),
// so float minima combine through integer atomicMin
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// fkey with a NaN below every float, so that a minimum over it is the NaN
// (fkey_inv(INT_MIN) is a NaN), as in jnp.minimum (the extension rows)
__device__ __forceinline__ int ekey(float f) { return f != f ? INT_MIN : fkey(f); }

__device__ __forceinline__ float fkey_inv(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// selectHost's order as one integer: the larger score first, then the lower
// node index; 0 is below every node's key. A -0 score keys as +0, so equal
// scores key equal. A NaN score (an extension's) keys above every node, and
// its pick_score is a NaN, so the pod stays unbound, as the reference's max
// over a NaN leaves it.
__device__ __forceinline__ unsigned long long pick_key(float v, int n) {
  if (v != v) return ~0ull;
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(0x7fffffff - n);
}

__device__ __forceinline__ float pick_score(unsigned long long k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int pick_node(unsigned long long k) {
  return 0x7fffffff - (int)(unsigned)(k & 0xffffffffu);
}

// the top-k's order as one integer: the score's total order (-0 below +0,
// as lax.top_k ranks), then the lower node index; 0 is below every key
__device__ __forceinline__ unsigned long long topk_key(float v, int n) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(0x7fffffff - n);
}

// threefry2x32 (20 rounds) of the counter words (x0, x1) under the key
// (k0, k1), as jax.random's threefry2x32 (ops/threefry.py is the twin)
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned& x0,
                                             unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// the tie-break jitter of node n under the pod's folded key: element n of
// jax.random.uniform(key, (N,), 0.0, 0.5) (partitionable threefry: the
// counter pair is (0, n), the bits the XOR of the two words; the top 23
// bits as the mantissa of [1, 2), minus 1, times 0.5, which is exact)
__device__ __forceinline__ float jitter_of(unsigned k0, unsigned k1, int n) {
  unsigned x0 = 0, x1 = (unsigned)n;
  threefry2x32(k0, k1, x0, x1);
  const float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3f800000u);
  return __fmul_rn(__fsub_rn(f, 1.0f), 0.5f);
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// the warp's largest 64-bit key in two warp reductions (redux.sync): the
// largest high word, then the largest low word among the lanes that hold it
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long v) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned low = __reduce_max_sync(kFull, hi == top ? (unsigned)v : 0u);
  return ((unsigned long long)top << 32) | low;
}

// one warp merges `nl` descending lists of keys (rows kTopkPass apart, `m`
// keys each, 0 past their last) into their `m` largest, descending, at
// `dst`: lane l holds list l's head, and each step's warp maximum advances
// the one lane that holds it (keys are distinct)
__device__ __forceinline__ void merge_lists(const unsigned long long* src, int nl, int m,
                                            unsigned long long* dst, int lid) {
  int h = 0;
  for (int r = 0; r < m; ++r) {
    const unsigned long long k = (lid < nl && h < m) ? src[lid * kTopkPass + h] : 0;
    const unsigned long long t = warp_max_key(k);
    if (lid == 0) dst[r] = t;
    if (t && k == t) ++h;
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

// the block copies n bytes, 16 or 4 at a time where both ends and n allow it
__device__ void block_copy(void* dst, const void* src, size_t n) {
  const size_t tid = threadIdx.x, stride = blockDim.x;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | n;
  if ((align & 15) == 0) {
    uint4* d = static_cast<uint4*>(dst);
    const uint4* s = static_cast<const uint4*>(src);
    for (size_t i = tid; i < n / 16; i += stride) d[i] = s[i];
  } else if ((align & 3) == 0) {
    uint32_t* d = static_cast<uint32_t*>(dst);
    const uint32_t* s = static_cast<const uint32_t*>(src);
    for (size_t i = tid; i < n / 4; i += stride) d[i] = s[i];
  } else {
    uint8_t* d = static_cast<uint8_t*>(dst);
    const uint8_t* s = static_cast<const uint8_t*>(src);
    for (size_t i = tid; i < n; i += stride) d[i] = s[i];
  }
}

// The pod region: the pod's scalars, one pod's row of the host-built
// pod_pack, copied in by a bulk copy one pod ahead (into a buffer by the
// pod's place in the loop, so a copy never rewrites rows a thread still
// reads in the previous pod's phase 3). First one 16-byte record a carry column,
// over the [aff | anti | spread | pref] slot axis (one shared load a term):
//   affinity   {group, key, valid | self << 1, 0}
//   anti       {group, key, valid, 0}
//   spread     {group, key, soft | hard << 1, maxSkew (f32 bits)}
//   preferred  {group, key, valid ? pref_tid : -1, weight (f32 bits)}
// then word rows, then byte rows (offsets from the region's base; a
// parity's size is a multiple of 4 words, so both stay 16-byte aligned).
// Mirrored in kernels/step.py:pod_words.
struct PodLay {
  // words after the records: resources, the padded hit list
  int req, hits;
  // bytes after the words
  int ports, match, hpref;
  int words;   // a parity's size in 4-byte words
};

__host__ __device__ inline PodLay pod_lay(const StepArgs& a) {
  PodLay l;
  int w = 0;
  w += 4 * (a.a + a.b + a.cs + a.ap);  // the term records
  l.req = w; w += a.r;
  l.hits = w; w += a.hit_w;
  int b = 0;
  l.ports = b; b += a.pt;
  l.match = b; b += a.sg;
  l.hpref = b; b += a.t2;
  l.words = (w + (b + 3) / 4 + 3) & ~3;
  const int at = 4 * w;  // byte rows follow the words
  l.ports += at; l.match += at; l.hpref += at;
  return l;
}

// the class rows' buffer of one pod (RES_STAGE_CLASS), in bytes: the
// node-affinity score and the taint prefer as f32, the class affinity and
// taint as u8, each slp long
__host__ __device__ inline int slp_of(const StepArgs& a) { return (a.sl + 15) & ~15; }
__host__ __device__ inline int cls_bytes(const StepArgs& a) { return 10 * slp_of(a); }

// A block's dynamic shared memory: offsets of 4-byte words, then of bytes
// after them. Mirrored in kernels/step.py:smem_bytes.
struct Layout {
  int keys;    // the top-k's key rows (StepArgs.topk > 0, explain library):
               // [kTopkLists][kTopkPass] lists, [2][2][kTopkPass] the block's
               // merged list by pod and pass parity, [kTopkPass] candidates
  int cls;     // [2][cls_bytes] the class rows by pod parity (RES_STAGE_CLASS;
               // 16-byte aligned, the bulk copies' destination)
  int pod;     // [2][PodLay.words] the pod region by pod parity
  int fail;    // [2][OPS] first-fail histogram, by pod parity
  int dpart;   // [2][Q*D + 2Q] column-read partials: sums, totals, minima
  int merged;  // [Q*D + 2Q] the cluster's column sums, totals, minima
  int qneed;   // [Q] kNeed* bits
  int minval;  // [Cs] f32 hard-spread minimum
  int dom;     // [K1*D*Sg] f32 dom_count replica (F_DOM)
  int sc;      // [rows][SL] f32 raw scores of the block's nodes
  int ms;      // [SL] f32 masked final scores (the top-k; StepArgs.topk > 0)
  int ext;     // [2][ered] extension minima by pod parity, [ered] the cluster's,
               // [Es][3] each score row's lo, inverse range and weight, [Es][SL]
               // the block's raw extension scores, then (Ef > 0) [SL] each
               // node's first failing filter extension, -1 none
  int hr;      // [SL*R] f32 headroom slice (RES_HEADROOM)
  int node;    // (RES_STAGE_NODE) [2][SL] f32 inv_alloc's two columns, [SL]
               // spec_id, [K1][SL] node_dom
  int flag;    // byte offset: [SL] feasibility flags
  int pv;      // byte offset: [Npv] pv_taken replica (device-resource, F_PV_MATCH)
  int nbyte;   // byte offset: (RES_STAGE_NODE) [SL] active, [SL] unschedulable,
               // [K][SL] has_key
  int bytes;   // total
};

__host__ __device__ inline int score_rows(int flags) {
  return 3 + ((flags & kInterpodFlags) ? 1 : 0) + ((flags & kDevResFlags) ? 1 : 0);
}

__host__ __device__ inline Layout layout_of(const StepArgs& a) {
  const int q = a.a + a.b + a.cs + a.ap;
  const int qd = q * a.d + 2 * q;
  const bool node = a.res & RES_STAGE_NODE;
  Layout l;
  int w = 0;
  l.keys = w;  // first: 8-byte keys at the region's 16-byte alignment
  w += (PLAIN_STEP_EXPLAIN && a.topk > 0) ? kTopkWords : 0;
  l.cls = w;   // (a multiple of 4 words: kTopkWords is)
  w += (a.res & RES_STAGE_CLASS) ? 2 * cls_bytes(a) / 4 : 0;
  l.pod = w;
  w += 2 * pod_lay(a).words;
  l.fail = w;
  w += 2 * a.ops;
  // (the column-read partials and the dom_count replica take no shared
  // memory where plan_launch placed them in global memory)
  l.dpart = w;
  w += (kWideLib && (a.res & RES_COLS_GLOBAL)) ? 0 : 2 * qd;
  l.merged = w;
  w += qd;
  l.qneed = w;
  w += q;
  l.minval = w;
  w += a.cs;
  l.dom = w;
  w += ((a.flags & F_DOM) && !(kWideLib && (a.res & RES_DOM_GLOBAL))) ? a.k1 * a.d * a.sg : 0;
  l.sc = w;
  w += score_rows(a.flags) * a.sl;
  l.ms = w;
  w += (PLAIN_STEP_EXPLAIN && a.topk > 0) ? a.sl : 0;
  l.ext = w;
  w += 3 * a.ered + 3 * a.es + (a.es + (a.ef ? 1 : 0)) * a.sl;
  l.hr = w;
  w += (a.res & RES_HEADROOM) ? a.sl * a.r : 0;
  l.node = w;
  w += node ? (3 + a.k1) * a.sl : 0;
  l.flag = 4 * w;
  l.pv = l.flag + a.sl;
  l.nbyte = l.pv + (((a.flags & kDevResFlags) && (a.flags & F_PV_MATCH)) ? a.npv : 0);
  l.bytes = l.nbyte + (node ? (2 + a.k) * a.sl : 0);
  return l;
}

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
// read the node's own count, others the per-domain sum at `dm`, the node's
// domain under the key (0 without the key, dm -1)
__device__ __forceinline__ float column_count(const StepArgs& a, const int* s_dacc, int q,
                                              int g, int key, int n, int dm, size_t gc_base,
                                              bool bf16) {
  if (key == 0) return cnt_load(a.group_count, gc_base + (size_t)n * a.sg + g, bf16);
  return dm >= 0 ? (float)s_dacc[q * a.d + dm] : 0.0f;
}

// ---- the device-resource ops (kDevRes) ------------------------------------

// one lane's device-resource carries
struct DevLane {
  float* gpu_used;      // [N, G]
  float* vg_used;       // [N, V]
  uint8_t* sdev_taken;  // [N, E]
  uint8_t* pv_taken;    // [Npv]
  float* vol_cnt;       // [N, Lk]
  uint8_t* svol_on;     // [N, Nsv]
};

// GPU-share filter at node n (reference gpu_fit): a device present, the
// node's total memory covers the per-GPU request, and the two-pointer
// allocation succeeds (sum over devices of floor(idle/mem) >= cnt) unless
// the pod is pinned. Pods without a GPU request pass.
__device__ bool gpu_fits(const StepArgs& a, const DevLane& L, int p, int n) {
  const float cnt = a.gpu_cnt[p];
  if (!(cnt > 0.0f)) return true;
  const float mem = a.gpu_mem[p];
  const float mem_safe = mem > 0.0f ? mem : 1.0f;
  const float cap = a.gpu_cap_mem[n];
  const float* slot = a.gpu_slot + (size_t)n * a.g;
  const float* used = L.gpu_used + (size_t)n * a.g;
  float n_slots = 0.0f, fit = 0.0f;
  for (int g = 0; g < a.g; ++g) {
    n_slots = __fadd_rn(n_slots, slot[g]);
    if (slot[g] > 0.0f)
      fit = __fadd_rn(fit, floorf(__fdiv_rn(fmaxf(__fsub_rn(cap, used[g]), 0.0f), mem_safe)));
  }
  return n_slots > 0.0f && __fmul_rn(cap, n_slots) >= mem &&
         (fit >= cnt || a.gpu_has_forced[p] != 0);
}

// the raw GPU-share score at node n (reference gpu_share_raw): the request
// over the free memory left after it, clipped to [0, 1], x 100
__device__ float gpu_raw(const StepArgs& a, const DevLane& L, int p, int n) {
  const float cap = a.gpu_cap_mem[n];
  const float* slot = a.gpu_slot + (size_t)n * a.g;
  const float* used = L.gpu_used + (size_t)n * a.g;
  float free_total = 0.0f;
  for (int g = 0; g < a.g; ++g)
    if (slot[g] > 0.0f) free_total = __fadd_rn(free_total, __fsub_rn(cap, used[g]));
  const float want = __fmul_rn(a.gpu_mem[p], a.gpu_cnt[p]);
  const float avail = __fsub_rn(free_total, want);
  const float share = avail > 0.0f ? __fdiv_rn(want, avail) : (want > 0.0f ? 1.0f : 0.0f);
  return __fmul_rn(clamp01(share), 100.0f);
}

// the pod's per-device multiplicities on node fin (reference
// gpu_pick_devices): a pinned gpu-index verbatim, the tightest single
// device (lowest id on ties) for one GPU, else the ascending two-pointer
__device__ void gpu_pick(const StepArgs& a, const DevLane& L, int p, int fin, int32_t* out) {
  const int G = a.g;
  const float cnt = a.gpu_cnt[p], mem = a.gpu_mem[p];
  const float on = cnt > 0.0f ? 1.0f : 0.0f;
  const float cap = a.gpu_cap_mem[fin];
  const float* slot = a.gpu_slot + (size_t)fin * G;
  const float* used = L.gpu_used + (size_t)fin * G;
  if (a.gpu_has_forced[p]) {
    for (int g = 0; g < G; ++g)
      out[g] = (int)__fmul_rn((float)a.gpu_forced[(size_t)p * G + g], on);
    return;
  }
  if (cnt == 1.0f) {
    int sel = -1;
    float best = kBig;
    for (int g = 0; g < G; ++g) {
      const float free = __fsub_rn(cap, used[g]);
      if (slot[g] > 0.0f && free >= mem && (sel < 0 || free < best)) {
        sel = g;
        best = free;
      }
    }
    for (int g = 0; g < G; ++g) out[g] = (int)__fmul_rn(g == sel ? 1.0f : 0.0f, on);
    return;
  }
  const float mem_safe = mem > 0.0f ? mem : 1.0f;
  float total = 0.0f;
  for (int g = 0; g < G; ++g)
    if (slot[g] > 0.0f)
      total = __fadd_rn(total, floorf(__fdiv_rn(fmaxf(__fsub_rn(cap, used[g]), 0.0f), mem_safe)));
  const bool complete = total >= cnt;
  float cum = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float sl = slot[g] > 0.0f
        ? floorf(__fdiv_rn(fmaxf(__fsub_rn(cap, used[g]), 0.0f), mem_safe)) : 0.0f;
    cum = __fadd_rn(cum, sl);
    const float take = fminf(fmaxf(__fsub_rn(cnt, __fsub_rn(cum, sl)), 0.0f), sl);
    out[g] = (int)__fmul_rn(complete ? take : 0.0f, on);
  }
}

// open-local LVM packing at node n (reference lvm_pack): each volume,
// largest first, into the most-free VG (the first on ties). With `add`,
// the per-VG debit the bind applies.
__device__ bool lvm_pack(const StepArgs& a, const DevLane& L, int p, int n, float* add) {
  const int V = a.v;
  float free[kMaxV];
  for (int v = 0; v < V; ++v) {
    free[v] = __fsub_rn(a.vg_cap[(size_t)n * V + v], L.vg_used[(size_t)n * V + v]);
    if (add) add[v] = 0.0f;
  }
  bool ok = true;
  for (int i = 0; i < a.lv; ++i) {
    const float size = a.lvm_req[(size_t)p * a.lv + i];
    if (!(size > 0.0f)) continue;  // a padded slot moves nothing
    int slot = 0;
    for (int v = 1; v < V; ++v)
      if (free[v] > free[slot]) slot = v;
    if (!(free[slot] >= size)) ok = false;
    free[slot] = __fsub_rn(free[slot], size);
    if (add) add[slot] = __fadd_rn(add[slot], size);
  }
  return ok;
}

// open-local exclusive devices at node n (reference device_match): each
// claim takes the tightest free device of its media that holds it (the
// lowest index on ties). With `take`, the devices taken, as a bit mask.
__device__ bool device_match(const StepArgs& a, const DevLane& L, int p, int n, unsigned* take) {
  const int E = a.e;
  const float* cap = a.sdev_cap + (size_t)n * E;
  const uint8_t* ssd = a.sdev_ssd + (size_t)n * E;
  unsigned avail = 0, took = 0;
  for (int e = 0; e < E; ++e)
    if (!L.sdev_taken[(size_t)n * E + e] && cap[e] > 0.0f) avail |= 1u << e;
  bool ok = true;
  for (int j = 0; j < a.ev; ++j) {
    const float size = a.sdev_req[(size_t)p * a.ev + j];
    if (!(size > 0.0f)) continue;
    const bool wants = a.sdev_req_ssd[(size_t)p * a.ev + j] != 0;
    int pick = -1;
    for (int e = 0; e < E; ++e)
      if (((avail >> e) & 1u) && cap[e] >= size && (ssd[e] != 0) == wants &&
          (pick < 0 || cap[e] < cap[pick]))
        pick = e;
    if (pick < 0) {
      ok = false;
      continue;
    }
    took |= 1u << pick;
    avail &= ~(1u << pick);
  }
  if (take) *take = took;
  return ok;
}

// WaitForFirstConsumer matching at node n (reference wfc_claims_ok): each
// claim in turn takes the first free candidate among the node's admitted
// PVs (ascending id = smallest fit) that no earlier claim of the pod chose.
// A pod's valid slots come first (the launcher checks), and a padded slot
// can only take a PV from the padded slots after it, so the walk stops at
// the first padded slot: the verdict is the reference's.
__device__ bool wfc_fits(const StepArgs& a, const uint8_t* pv_taken, int p, int n) {
  int chosen[kMaxLw];
  bool ok = true;
  const int lo = a.pv_ptr[n], hi = a.pv_ptr[n + 1];
  for (int j = 0; j < a.lw && a.wfc_valid[(size_t)p * a.lw + j]; ++j) {
    const uint8_t* cand = a.pv_cand + (size_t)a.wfc_ccid[(size_t)p * a.lw + j] * a.npv;
    int found = -1;
    for (int i = lo; i < hi && found < 0; ++i) {
      const int pv = a.pv_idx[i];
      if (!cand[pv] || pv_taken[pv]) continue;
      bool dup = false;
      for (int c = 0; c < j; ++c) dup |= chosen[c] == pv;
      if (!dup) found = pv;
    }
    chosen[j] = found;
    if (found < 0) ok = false;
  }
  return ok;
}

// a thread's window of the device-resource walks in global memory (p
// null: every width fits the per-thread arrays above), word i at
// p[i * stride]: [0, V) the volume groups' free space, [V, 2V) the bind's
// VG debit, [2V, 2V + E) the devices still free for the pod, [2V + E,
// 2V + 2E) the devices it took, [2V + 2E, 2V + 2E + Lw) the PV each
// claim chose
struct Walk {
  int* p;
  size_t stride;
};

// The walks over any width: lvm_pack, device_match and wfc_fits with
// their per-thread arrays in the window, the same walks, picks and ties.
__device__ bool storage_fits_walk(const StepArgs& a, const DevLane& L, int p,
                                               int n, bool record, const Walk& w) {
  const size_t st = w.stride;
  const int V = a.v, E = a.e;
  float* const free = reinterpret_cast<float*>(w.p);
  float* const add = free + (size_t)V * st;
  for (int v = 0; v < V; ++v) {
    free[v * st] = __fsub_rn(a.vg_cap[(size_t)n * V + v], L.vg_used[(size_t)n * V + v]);
    add[v * st] = 0.0f;
  }
  bool ok = true;
  for (int i = 0; i < a.lv; ++i) {
    const float size = a.lvm_req[(size_t)p * a.lv + i];
    if (!(size > 0.0f)) continue;  // a padded slot moves nothing
    int slot = 0;
    for (int v = 1; v < V; ++v)
      if (free[v * st] > free[slot * st]) slot = v;
    if (!(free[slot * st] >= size)) ok = false;
    free[slot * st] = __fsub_rn(free[slot * st], size);
    add[slot * st] = __fadd_rn(add[slot * st], size);
  }
  // the phase-1 verdict is lvm_pack's && device_match's: the device walk
  // runs only when the volumes fit, unless the bind needs its picks
  if (!ok && !record) return false;
  const float* cap = a.sdev_cap + (size_t)n * E;
  const uint8_t* ssd = a.sdev_ssd + (size_t)n * E;
  int* const avail = w.p + (size_t)(2 * V) * st;
  int* const took = avail + (size_t)E * st;
  for (int e = 0; e < E; ++e) {
    avail[e * st] = !L.sdev_taken[(size_t)n * E + e] && cap[e] > 0.0f;
    took[e * st] = 0;
  }
  for (int j = 0; j < a.ev; ++j) {
    const float size = a.sdev_req[(size_t)p * a.ev + j];
    if (!(size > 0.0f)) continue;
    const bool wants = a.sdev_req_ssd[(size_t)p * a.ev + j] != 0;
    int pick = -1;
    for (int e = 0; e < E; ++e)
      if (avail[e * st] && cap[e] >= size && (ssd[e] != 0) == wants &&
          (pick < 0 || cap[e] < cap[pick]))
        pick = e;
    if (pick < 0) {
      ok = false;
      continue;
    }
    avail[pick * st] = 0;
    took[pick * st] = 1;
  }
  return ok;
}

__device__ bool wfc_fits_walk(const StepArgs& a, const uint8_t* pv_taken, int p,
                                           int n, const Walk& w) {
  const size_t st = w.stride;
  int* const chosen = w.p + (size_t)(2 * (a.v + a.e)) * st;
  bool ok = true;
  const int lo = a.pv_ptr[n], hi = a.pv_ptr[n + 1];
  for (int j = 0; j < a.lw && a.wfc_valid[(size_t)p * a.lw + j]; ++j) {
    const uint8_t* cand = a.pv_cand + (size_t)a.wfc_ccid[(size_t)p * a.lw + j] * a.npv;
    int found = -1;
    for (int i = lo; i < hi && found < 0; ++i) {
      const int pv = a.pv_idx[i];
      if (!cand[pv] || pv_taken[pv]) continue;
      bool dup = false;
      for (int c = 0; c < j; ++c) dup |= chosen[c * st] == pv;
      if (!dup) found = pv;
    }
    chosen[j * st] = found;
    if (found < 0) ok = false;
  }
  return ok;
}

// the window of this thread (a launch with StepArgs.walk set)
__device__ __forceinline__ Walk walk_of(const StepArgs& a) {
  return Walk{a.walk + (size_t)blockIdx.x * blockDim.x + threadIdx.x,
              (size_t)gridDim.x * blockDim.x};
}

// The walks' verdicts for pod p at the block's nodes, each by its owner
// thread into its s_flag byte (4: storage refuses, 8: the claims find no
// PVs), before phase 1 reads them: the walks run where few values are
// live, and phase 1 keeps the code it has within the widths.
__device__ void walk_verdicts(const StepArgs& a, const DevLane& L, int fl, int p, int lo,
                              int hi, uint8_t* s_flag) {
  const Walk w = walk_of(a);
  for (int n = lo + (int)threadIdx.x; n < hi; n += blockDim.x) {
    uint8_t bits = 0;
    if ((fl & F_STORAGE) && !storage_fits_walk(a, L, p, n, false, w)) bits |= 4;
    if ((fl & F_PV_MATCH) && !wfc_fits_walk(a, L.pv_taken, p, n, w)) bits |= 8;
    s_flag[n - lo] = bits;
  }
}

// the storage bind of pod p on node fin over the window: the VG debit and
// the devices taken, as dev_bind applies them within the widths
__device__ void storage_bind_walk(const StepArgs& a, const DevLane& L, int p,
                                               int fin, const Walk& w) {
  storage_fits_walk(a, L, p, fin, true, w);
  const size_t st = w.stride;
  const float* add = reinterpret_cast<const float*>(w.p) + (size_t)a.v * st;
  const int* took = w.p + (size_t)(2 * a.v + a.e) * st;
  float* vg = L.vg_used + (size_t)fin * a.v;
  for (int v = 0; v < a.v; ++v) vg[v] = __fadd_rn(vg[v], add[v * st]);
  for (int e = 0; e < a.e; ++e)
    if (took[e * st]) L.sdev_taken[(size_t)fin * a.e + e] = 1;
}

// the pod's attach demand on node n under limit key k: its unshared
// claims, then each shared volume not yet on the node (every mount when
// dedup is off), in slot order
__device__ float vol_demand(const StepArgs& a, const DevLane& L, int fl, int p, int n, int k) {
  float dmd = a.vol_limit_req[(size_t)p * a.lk + k];
  if (a.lsv) {
    float sv = 0.0f;
    for (int sl = 0; sl < a.lsv; ++sl) {
      const int vid = a.svol_id[(size_t)p * a.lsv + sl];
      const int vc = max(vid, 0);
      const bool add = (fl & F_VOL_DEDUP) ? (vid >= 0 && !L.svol_on[(size_t)n * a.nsv + vc])
                                         : vid >= 0;
      sv = __fadd_rn(sv, (add && a.svol_key[vc] == k) ? 1.0f : 0.0f);
    }
    dmd = __fadd_rn(dmd, sv);
  }
  return dmd;
}

__device__ bool limits_ok(const StepArgs& a, const DevLane& L, int fl, int p, int n) {
  for (int k = 0; k < a.lk; ++k)
    if (!(__fadd_rn(L.vol_cnt[(size_t)n * a.lk + k], vol_demand(a, L, fl, p, n, k)) <=
          a.vol_limit_cap[(size_t)n * a.lk + k]))
      return false;
  return true;
}

// the device-resource bind of pod p on node fin (-1: unbound), by one
// thread of each block: the GPU pick and debit, the storage plan's row, the
// attach counts and the shared-volume presence in the block that owns fin
// (`own`); the PV picks in every block, each on its own replica of
// pv_taken (the same walk, so the same picks); the pod's gpu_pick /
// vol_pick output rows by the owner, or by rank 0 (`lead`) when unbound
__device__ void dev_bind(const StepArgs& a, const DevLane& L, int fl, int p, int fin, size_t o,
                         bool own, bool lead) {
  if (fl & F_GPU) {
    int32_t* gp = a.out_gpu_pick + o * a.g;
    if (fin >= 0 && own) {
      gpu_pick(a, L, p, fin, gp);
      float* used = L.gpu_used + (size_t)fin * a.g;
      const float mem = a.gpu_mem[p];
      for (int g = 0; g < a.g; ++g) used[g] = __fadd_rn(used[g], __fmul_rn((float)gp[g], mem));
    } else if (fin < 0 && lead) {
      for (int g = 0; g < a.g; ++g) gp[g] = 0;
    }
  }
  int32_t* vp = (fl & F_PV_MATCH) ? a.out_vol_pick + o * a.lw : nullptr;
  if (fin < 0) {
    if (vp && lead)
      for (int j = 0; j < a.lw; ++j) vp[j] = -1;
    return;
  }
  if (kWideLib && (fl & F_STORAGE) && own && a.walk) {
    storage_bind_walk(a, L, p, fin, walk_of(a));
  } else if ((fl & F_STORAGE) && own) {
    float add[kMaxV];
    unsigned take = 0;
    lvm_pack(a, L, p, fin, add);
    device_match(a, L, p, fin, &take);
    float* vg = L.vg_used + (size_t)fin * a.v;
    for (int v = 0; v < a.v; ++v) vg[v] = __fadd_rn(vg[v], add[v]);
    for (int e = 0; e < a.e; ++e)
      if ((take >> e) & 1u) L.sdev_taken[(size_t)fin * a.e + e] = 1;
  }
  if (vp) {
    const int lo = a.pv_ptr[fin], hi = a.pv_ptr[fin + 1];
    for (int j = 0; j < a.lw; ++j) {
      int pick = -1;
      if (a.wfc_valid[(size_t)p * a.lw + j]) {  // an invalid slot takes nothing
        const uint8_t* cand = a.pv_cand + (size_t)a.wfc_ccid[(size_t)p * a.lw + j] * a.npv;
        for (int i = lo; i < hi; ++i) {
          const int pv = a.pv_idx[i];
          if (cand[pv] && !L.pv_taken[pv]) {
            L.pv_taken[pv] = 1;
            pick = pv;
            break;
          }
        }
      }
      if (own) vp[j] = pick;
    }
  }
  if ((fl & F_VOL_LIMITS) && own) {
    // the demand reads the presence carry before this pod's volumes join it
    for (int k = 0; k < a.lk; ++k) {
      float* cell = L.vol_cnt + (size_t)fin * a.lk + k;
      *cell = __fadd_rn(*cell, vol_demand(a, L, fl, p, fin, k));
    }
    if (fl & F_VOL_DEDUP)
      for (int sl = 0; sl < a.lsv; ++sl) {
        const int vid = a.svol_id[(size_t)p * a.lsv + sl];
        if (vid >= 0) L.svol_on[(size_t)fin * a.nsv + vid] = 1;
      }
  }
}

// the frozen wave form's device-resource outputs of pod p on node fin (-1:
// unbound): the GPU pick against the wave-start gpu_used, by the thread of
// the block that owns fin, no debit (the merge adds it); no PV pick, since
// WaitForFirstConsumer pods never join a wave (engine/waves.py)
__device__ void dev_pick(const StepArgs& a, const DevLane& L, int fl, int p, int fin, size_t o,
                         bool own, bool lead) {
  if (fl & F_GPU) {
    int32_t* gp = a.out_gpu_pick + o * a.g;
    if (fin >= 0 && own) {
      gpu_pick(a, L, p, fin, gp);
    } else if (fin < 0 && lead) {
      for (int g = 0; g < a.g; ++g) gp[g] = 0;
    }
  }
  if ((fl & F_PV_MATCH) && lead)
    for (int j = 0; j < a.lw; ++j) a.out_vol_pick[o * a.lw + j] = -1;
}

// the launch's constant score weight `i` (WEIGHT_FIELDS order)
__device__ __forceinline__ float scalar_weight(const StepArgs& a, int i) {
  switch (i) {
    case 0: return a.w_bal;
    case 1: return a.w_least;
    case 2: return a.w_most;
    case 3: return a.w_na;
    case 4: return a.w_tt;
    case 5: return a.w_ip;
    case 6: return a.w_sp;
    case 7: return a.w_si;
    default: return a.w_gpu;
  }
}

// The scan over the launch's pods for the lane this block's cluster
// serves: the body of plain_step_kernel's scan builds, and with kFleet of
// plain_step_fleet_kernel, where `a` is the lane's own StepArgs, built as
// for a one-lane launch over its own cluster (lane index 0).
template <bool kInterpod, bool kDevRes, bool kCols, bool kExplain, bool kFleet, bool kExt>
__device__ __forceinline__ void step_body(const StepArgs& a) {
  // the extension rows: the scan builds only (a wave plan is dropped under
  // extensions, and a fleet runs them serially)
  static_assert(!(kExt && kFleet), "extension rows in a scan build only");
  // the normalizer rows: node affinity, taint, spread lo/hi, Simon lo/hi
  // (+ interpod lo/hi) (+ GPU lo/hi)
  constexpr int kRowsT = kDevRes ? kRows : kRows - 2;
  constexpr int kLive = kDevRes ? kRows : (kInterpod ? kRows - 2 : kRows - 4);
  // the raw-score rows in shared memory: base, spread, Simon (+ interpod) (+ GPU)
  constexpr int kRowGpu = kInterpod ? 4 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int N = a.n, R = a.r, D = a.d, SG = a.sg, PT = a.pt, CS = a.cs;
  const int Q = a.a + a.b + a.cs + a.ap;
  const int QD = Q * D + 2 * Q;
  const int C = a.cl, B = blockDim.x, SL = a.sl;
  const int rank = (int)cluster.block_rank();
  // (a fleet lane's StepArgs points at its own cluster's arrays)
  const int lane = kFleet ? 0 : blockIdx.x / C;
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  // this block's nodes [lo, hi): ascending slices, so rank order is node order
  const int lo = min(rank * SL, N), hi = min(lo + SL, N);
  const int iters = (hi - lo + B - 1) / B;
  const Layout lay = layout_of(a);
  extern __shared__ __align__(16) int s_dyn[];
  int* const s_fail = s_dyn + lay.fail;
  // the column-read partials, by pod parity: in shared memory, or
  // (RES_COLS_GLOBAL, the wide library only) in this block's region of
  // col_spill, which the other blocks read through L2 after the cluster
  // barrier (a buffer is rewritten only after every block has passed the
  // next round's barrier, as in shared memory)
  const bool cols_glob = kWideLib && (a.res & RES_COLS_GLOBAL);
  int* const s_dpart = cols_glob ? a.col_spill + (size_t)blockIdx.x * 2 * QD : s_dyn + lay.dpart;
  int* const s_dacc = s_dyn + lay.merged;  // [Q, D], then the totals, then the minima
  int* const s_qtot = s_dacc + Q * D;
  int* const s_qmin = s_qtot + Q;
  int* const s_qneed = s_dyn + lay.qneed;
  float* const s_minval = reinterpret_cast<float*>(s_dyn + lay.minval);
  float* const s_sc = reinterpret_cast<float*>(s_dyn + lay.sc);
  uint8_t* const s_flag = reinterpret_cast<uint8_t*>(s_dyn) + lay.flag;
  // the block's minima (fkey), feasible count (and with the columns: the
  // nominated node is feasible here)
  __shared__ int s_part[2][kRows + 1 + kCols];
  __shared__ unsigned long long s_key[2];  // the block's argmax key
  __shared__ float s_fin[kRowsT];
  __shared__ int s_fin_cnt;
  __shared__ int s_nom;  // the pod's nominated node while still feasible, else -1
  __shared__ unsigned long long s_pick;
  __shared__ long long s_cyc[kPhases + 1];  // the phases, then the last mark
  // kExplain: the pod's folded PRNG key
  __shared__ unsigned s_pkey[2];
  // the traced weights: the lane's row of w_lane, read once in the lane
  // prologue (with w_lane null the score code reads the scalars instead)
  __shared__ float s_w[kWeights];
  // the two buffers' barriers: the bulk copies of a pod's region (and
  // class rows) complete its buffer's current phase
  __shared__ __align__(8) unsigned long long s_cbar[2];

  // (an instantiation without kDevRes is launched only when no
  // device-resource flag is set, and reads none of them)
  const int fl = kInterpod ? a.flags : (a.flags & ~kInterpodFlags);
  const bool fail = fl & F_FAIL, use_sp = fl & F_SP, gc_path = fl & F_GC;
  const bool bf16 = fl & F_GC_BF16, tb_bf16 = fl & F_TB_BF16;
  const bool dom_rep = fl & F_DOM, hr_res = a.res & RES_HEADROOM;
  const bool pv_rep = kDevRes && (fl & F_PV_MATCH);
  const int n_out = a.p1 - a.p0;
  const int s_base = a.a + a.b;      // first spread column
  const int p_base = s_base + CS;    // first preferred-term column
  const size_t nl = hi - lo;

  const uint8_t* active = a.active + (size_t)lane * N;
  // the staged regions: the pod's scalars (always) and each pod's class
  // rows (RES_STAGE_CLASS), bulk copies one pod ahead into a buffer by the
  // pod's place in the loop; the slice's node-static rows (RES_STAGE_NODE)
  // once a launch, in the lane prologue; unstaged, the rows are read from
  // global memory where they lie. The device-resource builds stage no
  // class rows and the build with both slices' gates no node rows either:
  // that code is compiled out of those builds (registers)
  constexpr bool kStageNode = !(kInterpod && kDevRes);
  constexpr bool kStageClass = !kDevRes;
  const PodLay pl = pod_lay(a);
  int* const s_podb = s_dyn + lay.pod;
  const bool nst = kStageNode && (a.res & RES_STAGE_NODE);
  const bool cst = kStageClass && (a.res & RES_STAGE_CLASS);
  float* const s_ia = reinterpret_cast<float*>(s_dyn + lay.node);  // [2][SL]
  int* const s_spec = s_dyn + lay.node + 2 * SL;
  int* const s_ndom = s_spec + SL;                                   // [K1][SL]
  uint8_t* const s_act = reinterpret_cast<uint8_t*>(s_dyn) + lay.nbyte;
  uint8_t* const s_uns = s_act + SL;
  uint8_t* const s_hk = s_uns + SL;                                  // [K][SL]
  uint8_t* const s_cls = reinterpret_cast<uint8_t*>(s_dyn + lay.cls);
  const int slp = slp_of(a), cbytes = cls_bytes(a);
  // node n's domain under the non-hostname key kk + 1, and whether it has key
  auto ndom = [&](int kk, int n) -> int {
    return nst ? s_ndom[kk * SL + (n - lo)] : a.node_dom[(size_t)kk * N + n];
  };
  auto nhas = [&](int key, int n) -> bool {
    return nst ? s_hk[key * SL + (n - lo)] != 0 : a.has_key[(size_t)key * N + n] != 0;
  };
  // the bulk copies of the cluster's i-th pod (pod pp, class cid) into
  // buffer i & 1: its pod region and (RES_STAGE_CLASS) its class rows,
  // completing that buffer's barrier phase i >> 1 (one thread)
  auto fetch = [&](int i, int pp, int cid) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_cbar[i & 1]);
    const int pbytes = 4 * pl.words;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(pbytes + (cst ? cbytes : 0)) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"((unsigned)__cvta_generic_to_shared(s_podb + (i & 1) * pl.words)),
        "l"(a.pod_pack + (size_t)pp * pl.words), "r"(pbytes), "r"(bar) : "memory");
    if (cst)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"((unsigned)__cvta_generic_to_shared(s_cls + (i & 1) * cbytes)),
          "l"(a.cls_pack + ((size_t)cid * C + rank) * cbytes), "r"(cbytes), "r"(bar)
          : "memory");
  };
  auto wait_pod = [&](int i) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_cbar[i & 1]);
    const unsigned par = (unsigned)(i >> 1) & 1u;
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2; "
          "selp.u32 %0, 1, 0, P1; }"
          : "=r"(done) : "r"(bar), "r"(par) : "memory");
  };
  const float* log_dom = a.log_dom + (size_t)lane * a.k;
  const uint8_t* elig_host_l = a.elig_host + (size_t)lane * a.c * N;
  const uint8_t* domain_has_l = a.domain_has + (size_t)lane * a.c * a.k1 * D;
  const uint8_t* any_elig_l = a.any_elig + (size_t)lane * a.c * a.k;
  float* const headroom_g = a.headroom + (size_t)lane * N * R;
  // headroom row of node n: hr_l + (n - lo) * R, in shared memory or not
  float* const hr_l = hr_res ? reinterpret_cast<float*>(s_dyn + lay.hr) : headroom_g + (size_t)lo * R;
  uint8_t* ports_used = a.ports_used + (size_t)lane * N * PT;
  float* const dom_g = a.dom_count + (size_t)lane * a.k1 * D * SG;
  // the dom_count replica: in shared memory, or (RES_DOM_GLOBAL, the wide
  // library only) in this block's region of dom_spill
  const bool dom_glob = kWideLib && (a.res & RES_DOM_GLOBAL);
  float* const dom_count = dom_rep
      ? (dom_glob ? a.dom_spill + (size_t)blockIdx.x * a.k1 * D * SG
                  : reinterpret_cast<float*>(s_dyn + lay.dom))
      : dom_g;
  const size_t gc_base = (size_t)lane * N * SG;
  const size_t tb_base = (size_t)lane * N * a.t;
  float* pref_paint = a.pref_paint + (size_t)lane * N * a.t2;
  float* const sc_base = s_sc;
  float* const sc_spread = s_sc + SL;
  float* const sc_simon = s_sc + 2 * SL;
  float* const sc_ip = s_sc + 3 * SL;
  float* const sc_gpu = s_sc + kRowGpu * SL;
  float* const s_ms = reinterpret_cast<float*>(s_dyn + lay.ms);
  // the extension minima (by pod parity, then the cluster's), each score
  // row's (lo, inverse range, weight) and the block's raw scores (phase 2
  // reads them from shared memory), and each node's first failing filter
  int* const s_epart = s_dyn + lay.ext;
  int* const s_efin = s_epart + 2 * a.ered;
  float* const s_epar = reinterpret_cast<float*>(s_efin + a.ered);
  int* const s_eff = reinterpret_cast<int*>(s_epar + 3 * a.es + (size_t)a.es * SL);
  const int topk = kExplain ? a.topk : 0;
  const bool jitter = kExplain && a.jitter;
  uint8_t* const pv_g = kDevRes ? a.pv_taken + (size_t)lane * a.npv : nullptr;
  const DevLane L = kDevRes
      ? DevLane{a.gpu_used + (size_t)lane * N * a.g, a.vg_used + (size_t)lane * N * a.v,
                a.sdev_taken + (size_t)lane * N * a.e,
                pv_rep ? reinterpret_cast<uint8_t*>(s_dyn) + lay.pv : pv_g,
                a.vol_cnt + (size_t)lane * N * a.lk, a.svol_on_node + (size_t)lane * N * a.nsv}
      : DevLane{};

  // the cycle counts: thread 0 of rank 0 charges the cycles since the last
  // mark to phase k; with them on, each phase ends at a block barrier
  const bool counted = a.cycles != nullptr;
  const bool timed = counted && rank == 0 && tid == 0;
  if (timed) {
    for (int i = 0; i < kPhases; ++i) s_cyc[i] = 0;
    s_cyc[kPhases] = clock64();
  }
  auto mark = [&](int k) {
    if (timed) {
      const long long t = clock64();
      s_cyc[k] += t - s_cyc[kPhases];
      s_cyc[kPhases] = t;
    }
  };

  // ---- the lane prologue: the first pod's copies (the barriers set up
  // first; the prologue's barrier shows every thread them), then this
  // block's slice of the lane's carry (and its replicas of the lane-wide
  // state) from the template, or the replicas and shared-memory rows from
  // the lane's carry, while the copies fly
  // (an extension build's one-pod launch: the pod the device cursor names)
  const bool at_cursor = kExt && a.cursor != nullptr;
  const int p_first = at_cursor ? *a.cursor : a.p0;
  const int p_end = at_cursor ? p_first + 1 : a.p1;
  // the extension rows' pods a lane: the launch's, or the cursor's one
  const size_t ext_n = at_cursor ? 1 : n_out;
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       (unsigned)__cvta_generic_to_shared(&s_cbar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fetch(0, p_first, cst ? a.class_id[p_first] : 0);
  }
  if (a.flags & F_TEMPLATE) {
    const size_t gc_el = bf16 ? 2 : 4, tb_el = tb_bf16 ? 2 : 4;
    block_copy(hr_l, a.tmpl_headroom + (size_t)lo * R, nl * R * sizeof(float));
    block_copy(ports_used + (size_t)lo * PT, a.tmpl_ports_used + (size_t)lo * PT, nl * PT);
    block_copy(static_cast<uint8_t*>(a.group_count) + (gc_base + (size_t)lo * SG) * gc_el,
               static_cast<const uint8_t*>(a.tmpl_group_count) + (size_t)lo * SG * gc_el,
               nl * SG * gc_el);
    block_copy(static_cast<uint8_t*>(a.term_block) + (tb_base + (size_t)lo * a.t) * tb_el,
               static_cast<const uint8_t*>(a.tmpl_term_block) + (size_t)lo * a.t * tb_el,
               nl * a.t * tb_el);
    block_copy(pref_paint + (size_t)lo * a.t2, a.tmpl_pref_paint + (size_t)lo * a.t2,
               nl * a.t2 * sizeof(float));
    if (dom_rep || rank == 0)
      block_copy(dom_count, a.tmpl_dom_count, (size_t)a.k1 * D * SG * sizeof(float));
    if constexpr (kDevRes) {
      block_copy(L.gpu_used + (size_t)lo * a.g, a.tmpl_gpu_used + (size_t)lo * a.g,
                 nl * a.g * sizeof(float));
      block_copy(L.vg_used + (size_t)lo * a.v, a.tmpl_vg_used + (size_t)lo * a.v,
                 nl * a.v * sizeof(float));
      block_copy(L.sdev_taken + (size_t)lo * a.e, a.tmpl_sdev_taken + (size_t)lo * a.e, nl * a.e);
      block_copy(L.vol_cnt + (size_t)lo * a.lk, a.tmpl_vol_cnt + (size_t)lo * a.lk,
                 nl * a.lk * sizeof(float));
      block_copy(L.svol_on + (size_t)lo * a.nsv, a.tmpl_svol_on_node + (size_t)lo * a.nsv,
                 nl * a.nsv);
      if (pv_rep || rank == 0) block_copy(L.pv_taken, a.tmpl_pv_taken, (size_t)a.npv);
    }
  } else {
    if (hr_res) block_copy(hr_l, headroom_g + (size_t)lo * R, nl * R * sizeof(float));
    if (dom_rep) block_copy(dom_count, dom_g, (size_t)a.k1 * D * SG * sizeof(float));
    if (pv_rep) block_copy(L.pv_taken, pv_g, (size_t)a.npv);
  }
  // (filled from the scalars too when w_lane is null: with the fill made
  // conditional, ptxas spills <0,0>+columns at its 128-register cap)
  if (tid < kWeights) s_w[tid] = a.w_lane ? a.w_lane[(size_t)lane * kWeights + tid]
                                          : scalar_weight(a, tid);
  // the slice's node-static rows, once a launch (RES_STAGE_NODE)
  if (nst) {
    const int nn = (int)nl;
    for (int ln = tid; ln < nn; ln += B) {
      const int n = lo + ln;
      s_ia[ln] = a.inv_alloc[(size_t)n * R + a.ci];
      s_ia[SL + ln] = a.inv_alloc[(size_t)n * R + a.mi];
      s_spec[ln] = a.spec_id[n];
      s_act[ln] = active[n];
      s_uns[ln] = a.unschedulable[n];
    }
    for (int i = tid; i < a.k1 * nn; i += B)
      s_ndom[(i / nn) * SL + i % nn] = a.node_dom[(size_t)(i / nn) * N + lo + i % nn];
    for (int i = tid; i < a.k * nn; i += B)
      s_hk[(i / nn) * SL + i % nn] = a.has_key[(size_t)(i / nn) * N + lo + i % nn];
  }
  __syncthreads();
  mark(0);

  for (int p = p_first; p < p_end; ++p) {
    const int j = p - a.p0;
    const int par = j & 1;  // the pod's parity: which partial buffers it uses
    const int lp = p - p_first;  // the pod's place in this cluster's loop (its buffer lp & 1)
    // the pod's staged scalars and class rows
    int* const sp = s_podb + (lp & 1) * pl.words;
    const uint8_t* const sb = reinterpret_cast<const uint8_t*>(sp);
    const float* req = reinterpret_cast<const float*>(sp + pl.req);
    const uint8_t* pports = sb + pl.ports;
    const uint8_t* match = sb + pl.match;
    const int4* const terms = reinterpret_cast<const int4*>(sp);  // [Q] term records
    const uint8_t* const cb = s_cls + (lp & 1) * cbytes;
    const float* const cbf = reinterpret_cast<const float*>(cb);
    const int cid = a.class_id[p];
    const int forced = a.forced_node[p];
    // the next pod's class, for its copies after phase 0
    const bool prefetch = tid == 0 && p + 1 < p_end;
    const int cid_next = (cst && prefetch) ? a.class_id[p + 1] : 0;
    const uint8_t* elig_host = elig_host_l + (size_t)cid * N;
    const int vcid = kDevRes ? a.vol_cid[p] : 0;
    const bool pv_missing = kDevRes && a.vol_pv_missing[p];
    const size_t orow = (size_t)lane * a.ls + j;  // the pod's output row
    const int nom = kCols && a.nominated ? a.nominated[p] : -1;
    const bool victim = kCols && a.disabled && a.disabled[p];
    int* const fail_b = s_fail + par * a.ops;
    int* const dpart = s_dpart + par * QD;
    int* const part = s_part[par];
    int* const epart = s_epart + par * a.ered;
    bool any_soft = false;
    if (use_sp)
      for (int c = 0; c < CS; ++c) any_soft |= a.spread_soft[(size_t)p * CS + c] != 0;

    // ---- phase 0: zero this parity's partials (the other parity's may
    // still be read by the other blocks), and what each carry column of
    // the pod needs from the batched column read
    for (int i = tid; i < a.ops; i += B) fail_b[i] = 0;
    if (tid <= kRows + kCols) part[tid] = tid < kRows ? INT_MAX : 0;
    if constexpr (kExt)
      for (int i = tid; i < a.ered; i += B) epart[i] = INT_MAX;
    if (tid == 0) s_key[par] = 0;
    if constexpr (kExplain) {
      if (tid == 0 && jitter) {  // fold_in(PRNGKey(seed), p): the hash of (0, p)
        unsigned x0 = 0, x1 = (unsigned)p;
        threefry2x32(a.key0, a.key1, x0, x1);
        s_pkey[0] = x0;
        s_pkey[1] = x1;
      }
    }
    if (gc_path) {
      for (int i = tid; i < QD; i += B) dpart[i] = i < Q * D + Q ? 0 : INT_MAX;
      for (int q = tid; q < Q; q += B) {
        int g, key;
        column_of(a, p, q, g, key);
        s_qneed[q] = column_need(a, fl, p, q, key);
      }
    }
    __syncthreads();
    // the pod's region and class rows have landed; every thread is past the
    // previous pod, so its buffer is free for the next pod's copies
    wait_pod(lp);
    if (prefetch) fetch(lp + 1, p + 1, cid_next);

    // ---- phase 0b: the batched carry-column read (group_count path):
    // each block's per-domain sums, totals and eligible minima of the
    // pod's columns over its nodes (warp-aggregated integer adds and mins,
    // exact in any order), then the cluster's, summed over the blocks'
    // partials through distributed shared memory (round C)
    if (gc_path && Q) {
      for (int q = 0; q < Q; ++q) {
        const int need = s_qneed[q];
        if (!need) continue;
        const int g = terms[q].x, key = terms[q].y;
        int tot = 0, mn = INT_MAX;
        for (int it = 0; it < iters; ++it) {
          const int n = lo + it * B + tid;
          int v = 0, dm = -1;
          if (n < hi) {
            v = (int)cnt_load(a.group_count, gc_base + (size_t)n * SG + g, bf16);
            if (need & kNeedDom) dm = ndom(key - 1, n);
            if ((need & kNeedMin) && elig_host[n]) mn = min(mn, v);
            tot += v;
          }
          if (need & kNeedDom) {
            const unsigned peers = __match_any_sync(kFull, dm);
            const int sum = __reduce_add_sync(peers, v);
            if (dm >= 0 && sum && lid == __ffs(peers) - 1) atomicAdd(&dpart[q * D + dm], sum);
          }
        }
        if (need & kNeedTot) {
          tot = __reduce_add_sync(kFull, tot);
          if (lid == 0 && tot) atomicAdd(&dpart[Q * D + q], tot);
        }
        if (need & kNeedMin) {
          mn = __reduce_min_sync(kFull, mn);
          if (lid == 0) atomicMin(&dpart[Q * D + Q + q], mn);
        }
      }
      cluster.sync();
      for (int i = tid; i < QD; i += B) {
        const bool is_sum = i < Q * D, is_tot = !is_sum && i < Q * D + Q;
        const int q = is_sum ? i / D : (is_tot ? i - Q * D : i - Q * D - Q);
        if (!(s_qneed[q] & (is_sum ? kNeedDom : (is_tot ? kNeedTot : kNeedMin)))) continue;
        int v = (is_sum || is_tot) ? 0 : INT_MAX;
        for (int r = 0; r < C; ++r) {
          const int x = cols_glob ? __ldcg(dpart + (ptrdiff_t)(r - rank) * 2 * QD + i)
                                  : cluster.map_shared_rank(dpart, r)[i];
          v = (is_sum || is_tot) ? v + x : min(v, x);
        }
        s_dacc[i] = v;
      }
      __syncthreads();
    }

    // ---- phase 0c: the hard spread's minimum per constraint: over the
    // domains holding an eligible node (hostname: over eligible nodes),
    // 0 when no eligible node has the key
    if (fl & F_SPH) {
      for (int c = tid; c < CS; c += B) {
        const int4 sc = terms[s_base + c];
        if (!(sc.z & 2)) continue;  // not DoNotSchedule
        const int key = sc.y;
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
            if (dhas[dd]) mv = fminf(mv, dom_count[((size_t)kk * D + dd) * SG + sc.x]);
        }
        s_minval[c] = any_elig_l[(size_t)cid * a.k + key] ? mv : 0.0f;
      }
      __syncthreads();
    }
    mark(1);

    // ---- phase 1: filters, first-fail histogram, raw scores into shared
    // memory, the block's minima (past the walks' widths, their verdicts
    // first)
    if constexpr (kDevRes && kWideLib) {
      if (a.walk) walk_verdicts(a, L, fl, p, lo, hi, s_flag);
    }
    // each node's first failing filter extension, ahead of the filter
    // chain (each thread reads back its own nodes' entries)
    if constexpr (kExt) {
      if (a.ef) {
        const uint8_t* eo = a.ext_ok + ((size_t)lane * ext_n + lp) * a.ef * N;
        for (int it = 0; it < iters; ++it) {
          const int n = lo + it * B + tid;
          if (n >= hi) break;
          int first = -1;
          for (int e = 0; e < a.ef && first < 0; ++e)
            if (!eo[(size_t)e * N + n]) first = e;
          s_eff[n - lo] = first;
        }
      }
    }
    float m_na = kBig, m_tt = kBig, m_slo = kBig, m_shi = kBig, m_ilo = kBig, m_ihi = kBig;
    float m_plo = kBig, m_phi = kBig, m_glo = kBig, m_ghi = kBig;
    int cnt = 0;
    for (int it = 0; it < iters; ++it) {
      const int n = lo + it * B + tid;
      const int ln = n - lo;
      int charged_op = -1;
      if (n < hi) {
        // the node's inputs that depend on nothing else, loaded together
        // ahead of the filter chain's branches (one latency, not several;
        // none where they are staged)
        const size_t cn = (size_t)cid * N + n;
        const bool act = (nst ? s_act[ln] : active[n]) != 0;
        const bool unsched = (fl & F_UNSCHED) && (nst ? s_uns[ln] : a.unschedulable[n]);
        const bool aff_ok = !(fl & F_CLASS_AFF) || (cst ? cb[8 * slp + ln] : a.class_affinity[cn]);
        const bool taint_ok = !(fl & F_CLASS_TAINT) || (cst ? cb[9 * slp + ln] : a.class_taint[cn]);
        const float na_score = (fl & F_NA) ? (cst ? cbf[ln] : a.class_node_aff_score[cn]) : 0.0f;
        const float tt_prefer =
            (fl & F_TT) ? (cst ? cbf[slp + ln] : a.class_taint_prefer[cn]) : 0.0f;
        const float ia_c = nst ? s_ia[ln] : a.inv_alloc[(size_t)n * R + a.ci];
        const float ia_m = nst ? s_ia[SL + ln] : a.inv_alloc[(size_t)n * R + a.mi];
        const int spec = (fl & F_SI) ? (nst ? s_spec[ln] : a.spec_id[n]) : 0;
        const float* hr = hr_l + (size_t)ln * R;
        int ff = -1;
        if (unsched) {
          ff = 0;
        } else if (!aff_ok) {
          ff = 1;
        } else if (!taint_ok) {
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
            const int4 tm = terms[q];
            if (!(tm.z & 1)) continue;
            const int key = tm.y;
            const float dc = column_count(a, s_dacc, q, tm.x, key, n,
                                          key ? ndom(key - 1, n) : -1, gc_base, bf16);
            const bool ok = nhas(key, n) && (dc > 0.0f || (s_qtot[q] == 0 && (tm.z & 2)));
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
            const int4 tm = terms[a.a + q];
            if (!tm.z) continue;
            const int key = tm.y;
            bad = column_count(a, s_dacc, a.a + q, tm.x, key, n,
                               key ? ndom(key - 1, n) : -1, gc_base, bf16) != 0.0f;
          }
          // the hit terms: staged (-1 past the pod's last), or the host's lists
          if (a.hit_w) {
            for (int i = 0; i < a.hit_w && !bad; ++i) {
              const int t = sp[pl.hits + i];
              if (t < 0) break;
              bad = cnt_load(a.term_block, tb_base + (size_t)n * a.t + t, tb_bf16) > 0.0f;
            }
          } else {
            for (int i = a.hit_ptr[p]; i < a.hit_ptr[p + 1] && !bad; ++i)
              bad = cnt_load(a.term_block, tb_base + (size_t)n * a.t + a.hit_idx[i], tb_bf16) > 0.0f;
          }
          if (bad) ff = 5 + R;
        }
        // hard spread: skew = count + self-match - minimum <= maxSkew on
        // nodes holding every constraint's key
        if (ff < 0 && (fl & F_SPH)) {
          for (int c = 0; c < CS; ++c) {
            const int4 tm = terms[s_base + c];
            if (!(tm.z & 2)) continue;
            const int key = tm.y, g = tm.x;
            float dc;
            if (gc_path) {
              dc = column_count(a, s_dacc, s_base + c, g, key, n, key ? ndom(key - 1, n) : -1,
                                gc_base, bf16);
            } else {
              const int kk = a.k1 == 1 ? 0 : max(key - 1, 0);
              const int dm = ndom(kk, n);
              dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + g] : 0.0f;
            }
            const float skew = __fsub_rn(__fadd_rn(dc, match[g] ? 1.0f : 0.0f), s_minval[c]);
            if (!(nhas(key, n) && skew <= __int_as_float(tm.w))) {
              ff = 6 + R;
              break;
            }
          }
        }
        // the device-resource rows, in the reference's order: GPU,
        // storage, volume node affinity, volume zone, volume binding (the
        // static class row, then the PV match), missing PV, attach limits
        if constexpr (kDevRes) {
          if (ff < 0 && (fl & F_GPU) && !gpu_fits(a, L, p, n)) ff = 7 + R;
          if (ff < 0 && (fl & F_STORAGE) &&
              ((kWideLib && a.walk) ? (s_flag[ln] & 4) != 0
                      : !(lvm_pack(a, L, p, n, nullptr) && device_match(a, L, p, n, nullptr))))
            ff = 8 + R;
          if (ff < 0 && (fl & F_VOL_STATIC)) {
            const size_t cv = (size_t)vcid * N + n;
            if (!a.class_vol_node[cv]) ff = 9 + R;
            else if (!a.class_vol_zone[cv]) ff = 10 + R;
            else if (!a.class_vol_bind[cv]) ff = 11 + R;
          }
          if (ff < 0 && (fl & F_PV_MATCH) &&
              ((kWideLib && a.walk) ? (s_flag[ln] & 8) != 0 : !wfc_fits(a, L.pv_taken, p, n)))
            ff = 11 + R;
          if (ff < 0 && (fl & F_VOL_STATIC) && pv_missing) ff = 12 + R;
          if (ff < 0 && (fl & F_VOL_LIMITS) && !limits_ok(a, L, fl, p, n)) ff = 13 + R;
        }
        // the filter extensions, past the built-in ops, in registration order
        if constexpr (kExt) {
          if (ff < 0 && a.ef && s_eff[ln] >= 0) ff = a.ops - a.ef + s_eff[ln];
        }
        const bool mask = act && ff < 0;
        if (act && ff >= 0) charged_op = ff;
        if (kCols && mask && n == nom) part[kRows + kCols] = 1;
        uint8_t flag = mask ? 1 : 0;
        if (fl & F_NA) m_na = fminf(m_na, mask ? -na_score : 0.0f);
        if (fl & F_TT) m_tt = fminf(m_tt, mask ? -tt_prefer : 0.0f);
        if (mask) {
          ++cnt;
          // NodeResources: balanced + least (+ most) over free fractions
          const float h_c = __fmul_rn(__fsub_rn(hr[a.ci], req[a.ci]), ia_c);
          const float h_m = __fmul_rn(__fsub_rn(hr[a.mi], req[a.mi]), ia_m);
          float base = 0.0f;
          if (fl & F_BAL)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[0] : a.w_bal), __fmul_rn(
                __fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(h_c, h_m)), 0.5f)), 100.0f)));
          if (fl & F_LEAST)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[1] : a.w_least), __fmul_rn(
                __fadd_rn(fmaxf(h_c, 0.0f), fmaxf(h_m, 0.0f)), 50.0f)));
          if (fl & F_MOST)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[2] : a.w_most),
                                             __fmul_rn(__fadd_rn(
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_c)), ia_c > 0.0f ? 1.0f : 0.0f),
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_m)), ia_m > 0.0f ? 1.0f : 0.0f)),
                50.0f)));
          sc_base[ln] = base;
          // InterPodAffinity preference: the existing pods' weighted paint
          // at this pod's hit terms, then weight x domain count per term
          if (fl & F_IP) {
            float raw = 0.0f;
            for (int t = 0; t < a.t2; ++t)
              if (sb[pl.hpref + t]) raw = __fadd_rn(raw, pref_paint[(size_t)n * a.t2 + t]);
            for (int q = 0; q < a.ap; ++q) {
              const int4 tm = terms[p_base + q];
              if (tm.z < 0) continue;
              const int key = tm.y;
              const float dc = column_count(a, s_dacc, p_base + q, tm.x, key, n,
                                            key ? ndom(key - 1, n) : -1, gc_base, bf16);
              const float hk = nhas(key, n) ? 1.0f : 0.0f;
              raw = __fadd_rn(raw, __fmul_rn(__fmul_rn(__int_as_float(tm.w), dc), hk));
            }
            sc_ip[ln] = raw;
            m_plo = fminf(m_plo, raw);
            m_phi = fminf(m_phi, -raw);
          }
          // PodTopologySpread, soft: sum of count * log_dom + maxSkew - 1
          if (use_sp) {
            float sraw = 0.0f;
            bool sok = true;
            for (int c = 0; c < CS; ++c) {
              const int4 tm = terms[s_base + c];
              if (!(tm.z & 1)) continue;  // not ScheduleAnyway
              const int kid = tm.y;
              const int g = tm.x;
              float dc;
              if (gc_path) {
                dc = column_count(a, s_dacc, s_base + c, g, kid, n, kid ? ndom(kid - 1, n) : -1,
                                  gc_base, bf16);
              } else {
                const int kk = a.k1 == 1 ? 0 : max(kid - 1, 0);
                const int dm = ndom(kk, n);
                dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + g] : 0.0f;
              }
              sraw = __fadd_rn(sraw, __fadd_rn(__fmul_rn(dc, log_dom[kid]),
                                               __fsub_rn(__int_as_float(tm.w), 1.0f)));
              sok = sok && nhas(kid, n);
            }
            sc_spread[ln] = sraw;
            if (sok) {
              flag |= 2;
              m_slo = fminf(m_slo, sraw);
              m_shi = fminf(m_shi, -sraw);
            }
          }
          // Simon: max over resources of share(req, alloc - req), static alloc
          if (fl & F_SI) {
            const float* sa = a.spec_alloc + (size_t)spec * R;
            float mx = 0.0f;
            for (int r = 0; r < R; ++r) {
              const float avail = __fsub_rn(sa[r], req[r]);
              const float rq = req[r];
              float sh = avail != 0.0f ? __fdiv_rn(rq, avail) : (rq != 0.0f ? 1.0f : 0.0f);
              sh = rq > 0.0f ? clamp01(sh) : 0.0f;
              mx = r == 0 ? sh : fmaxf(mx, sh);
            }
            const float raw_si = __fmul_rn(mx, 100.0f);
            sc_simon[ln] = raw_si;
            m_ilo = fminf(m_ilo, raw_si);
            m_ihi = fminf(m_ihi, -raw_si);
          }
          // GPU share: the request's share of the node's free GPU memory
          if constexpr (kDevRes) {
            if (fl & F_GPU) {
              const float raw_gp = gpu_raw(a, L, p, n);
              sc_gpu[ln] = raw_gp;
              m_glo = fminf(m_glo, raw_gp);
              m_ghi = fminf(m_ghi, -raw_gp);
            }
          }
        }
        s_flag[ln] = flag;
      }
      if (fail) {
        // warp-aggregated histogram add: one shared atomic per distinct op
        const unsigned peers = __match_any_sync(kFull, charged_op);
        if (charged_op >= 0 && lid == __ffs(peers) - 1)
          atomicAdd(&fail_b[charged_op], __popc(peers));
      }
    }
    {
      const float mins[kRows] = {m_na, m_tt, m_slo, m_shi, m_ilo, m_ihi, m_plo, m_phi, m_glo,
                                 m_ghi};
#pragma unroll
      for (int q = 0; q < kLive; ++q) {
        const float v = warp_min(mins[q]);
        if (lid == 0) atomicMin(&part[q], fkey(v));
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lid == 0 && cnt) atomicAdd(&part[kRows], cnt);
    // the score extensions' raw scores of the block's nodes into shared
    // memory and their normalizer minima (each thread reads back its own
    // nodes' feasibility flags, and phase 2 its own nodes' scores)
    if constexpr (kExt) {
      if (a.es) {
        const float* er = a.ext_raw + ((size_t)lane * ext_n + lp) * a.es * N;
        for (int e = 0, row = 0; e < a.es; ++e) {
          const int kind = a.ext_norm[e];
          const float* raw = er + (size_t)e * N;
          float* const keep = s_epar + 3 * a.es + (size_t)e * SL;
          int klo = fkey(kBig), khi = fkey(kBig);
          for (int it = 0; it < iters; ++it) {
            const int n = lo + it * B + tid;
            if (n >= hi) break;
            const bool m = s_flag[n - lo] & 1;
            const float v = raw[n];
            keep[n - lo] = v;
            if (kind == 1) {
              if (m) {
                klo = min(klo, ekey(v));
                khi = min(khi, ekey(-v));
              }
            } else if (kind == 2) {
              khi = min(khi, ekey(m ? -v : 0.0f));
            }
          }
          if (kind == 1) {
            klo = __reduce_min_sync(kFull, klo);
            if (lid == 0) atomicMin(&epart[row], klo);
            ++row;
          }
          if (kind != 0) {
            khi = __reduce_min_sync(kFull, khi);
            if (lid == 0) atomicMin(&epart[row], khi);
            ++row;
          }
        }
      }
    }
    if (counted) {
      __syncthreads();
      mark(2);
    }

    // ---- round A: the cluster's minima and feasible count (warp 0, one
    // lane per block), and the first-fail histogram into the output (each
    // op summed over the blocks by one thread of one block)
    cluster.sync();
    if (wid == 0) {
      const int* rp = lid < C ? cluster.map_shared_rank(part, lid) : nullptr;
      int v[kLive];
#pragma unroll
      for (int q = 0; q < kLive; ++q) v[q] = rp ? rp[q] : INT_MAX;
      const int c = __reduce_add_sync(kFull, rp ? rp[kRows] : 0);
      const unsigned nom_ok =
          kCols ? __reduce_or_sync(kFull, rp ? (unsigned)rp[kRows + kCols] : 0u) : 0u;
#pragma unroll
      for (int q = 0; q < kLive; ++q) {
        const int mq = __reduce_min_sync(kFull, v[q]);
        if (lid == 0) s_fin[q] = fkey_inv(mq);
      }
      if (lid == 0) {
        // the nomination holds while its node is feasible (an out-of-range
        // one matches no node, so nom_ok is 0)
        if (kCols) s_nom = nom_ok ? nom : -1;
        s_fin_cnt = nom_ok ? 1 : c;
      }
    }
    if (fail) {
      const int t0 = B > 32 ? 32 : 0;  // past warp 0 where the block has more warps
      for (int i = rank + (tid - t0) * C; tid >= t0 && i < a.ops; i += (B - t0) * C) {
        int sum = 0;
        for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(fail_b, r)[i];
        a.out_fail[orow * a.ops + i] = victim ? 0 : sum;
      }
    }
    if constexpr (kExt) {
      for (int i = tid; i < a.ered; i += B) {
        int v = INT_MAX;
        for (int r = 0; r < C; ++r) v = min(v, cluster.map_shared_rank(epart, r)[i]);
        s_efin[i] = v;
      }
    }
    __syncthreads();
    // each score extension's (lo, inverse range): minmax as
    // scores.minmax_apply, max as max_apply (lo 0), none as (0, 1)
    if constexpr (kExt) {
      if (a.es) {
        for (int e = tid; e < a.es; e += B) {
          int row = 0;
          for (int f = 0; f < e; ++f) row += a.ext_norm[f] == 1 ? 2 : (a.ext_norm[f] == 2 ? 1 : 0);
          const int kind = a.ext_norm[e];
          float lo_e = 0.0f, inv_e = 1.0f;
          if (kind == 1) {
            lo_e = fkey_inv(s_efin[row]);
            const float rng = __fsub_rn(-fkey_inv(s_efin[row + 1]), lo_e);
            inv_e = rng > 0.0f ? __fdiv_rn(100.0f, rng) : 0.0f;
          } else if (kind == 2) {
            const float hi_e = -fkey_inv(s_efin[row]);
            inv_e = hi_e > 0.0f ? __fdiv_rn(100.0f, hi_e) : 0.0f;
          }
          s_epar[3 * e] = lo_e;
          s_epar[3 * e + 1] = inv_e;
          s_epar[3 * e + 2] = a.ext_w[e];
        }
        __syncthreads();
      }
    }
    mark(3);

    // ---- phase 2: normalizers, final score in the reference's add order
    // (resources, node affinity, taint, interpod, spread, Simon, GPU),
    // selectHost
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
    const float gp_lo = kDevRes ? s_fin[kRowsT - 2] : 0.0f;
    const float gp_rng = kDevRes ? __fsub_rn(-s_fin[kRowsT - 1], gp_lo) : 0.0f;
    const float inv_gp = gp_rng > 0.0f ? __fdiv_rn(100.0f, gp_rng) : 0.0f;
    // a pod without a GPU request scores 0 on the GPU row
    const float gp_w = kDevRes ? __fmul_rn((a.w_lane ? s_w[8] : a.w_gpu),
                                           a.gpu_cnt[p] > 0.0f ? 1.0f : 0.0f) : 0.0f;
    const int nom_pick = kCols ? s_nom : -1;

    // the final score of node n (slice index ln): its weighted score rows
    // in the reference's add order (resources, node affinity, taint,
    // interpod, spread, Simon, GPU), summed left to right; given `parts`,
    // each live row is also written there, `stride` apart (the explain
    // candidates' breakdown, the reference's part rows)
    auto score_of = [&](int n, int ln, uint8_t flag, float* parts, int stride) -> float {
      float score = sc_base[ln];
      int c = 0;
      auto add = [&](float v) {
        if (parts) parts[(size_t)(++c) * stride] = v;
        score = __fadd_rn(score, v);
      };
      if (parts) parts[0] = score;
      if (fl & F_NA)
        add(__fmul_rn((a.w_lane ? s_w[3] : a.w_na),
                      __fmul_rn(cst ? cbf[ln] : a.class_node_aff_score[(size_t)cid * N + n],
                                inv_na)));
      if (fl & F_TT)
        add(__fmul_rn((a.w_lane ? s_w[4] : a.w_tt), __fsub_rn(100.0f, __fmul_rn(
            cst ? cbf[slp + ln] : a.class_taint_prefer[(size_t)cid * N + n], inv_tt))));
      if (fl & F_IP)
        add(__fmul_rn((a.w_lane ? s_w[5] : a.w_ip),
                      __fmul_rn(__fsub_rn(sc_ip[ln], ip_lo), inv_ip)));
      if (use_sp) {
        const float v = (flag & 2)
            ? __fadd_rn(base_sp, __fmul_rn(__fsub_rn(c1, sc_spread[ln]), inv_sp))
            : 0.0f;
        add(__fmul_rn((a.w_lane ? s_w[6] : a.w_sp), v));
      }
      if (fl & F_SI)
        add(__fmul_rn((a.w_lane ? s_w[7] : a.w_si),
                      __fmul_rn(__fsub_rn(sc_simon[ln], si_lo), inv_si)));
      if constexpr (kDevRes) {
        if (fl & F_GPU) add(__fmul_rn(gp_w, __fmul_rn(__fsub_rn(sc_gpu[ln], gp_lo), inv_gp)));
      }
      if constexpr (kExt) {
        for (int e = 0; e < a.es; ++e) {
          const float* q = s_epar + 3 * e;
          add(__fmul_rn(q[2], __fmul_rn(__fsub_rn(q[3 * (a.es - e) + e * SL + ln], q[0]),
                                        q[1])));
        }
      }
      return score;
    };

    unsigned long long best = 0, tbest = 0;
    for (int it = 0; it < iters; ++it) {
      const int n = lo + it * B + tid;
      if (n >= hi) break;
      const int ln = n - lo;
      const uint8_t flag = s_flag[ln];
      float ms = kNegInf;
      if ((flag & 1) && (!kCols || nom_pick < 0 || n == nom_pick)) {
        ms = score_of(n, ln, flag, nullptr, 0);
        // the tie-break: the integer score scale, then the jitter
        if (jitter) ms = __fadd_rn(rintf(ms), jitter_of(s_pkey[0], s_pkey[1], n));
      }
      // nodes ascend per thread: a tie keys lower for the later node
      const unsigned long long k = pick_key(ms, n);
      if (k > best) best = k;
      if constexpr (kExplain) {
        if (topk) {
          s_ms[ln] = ms;
          const unsigned long long tk = topk_key(ms, n);
          if (tk > tbest) tbest = tk;
        }
      }
    }
    best = warp_max_u64(best);
    if (lid == 0 && best) atomicMax(&s_key[par], best);
    // the top-k's passes (kExplain, topk > 0): pass i ranks candidates
    // i * kTopkPass .. of the pod; the first rides round B's barrier
    unsigned long long* const s_wl = reinterpret_cast<unsigned long long*>(s_dyn + lay.keys);
    unsigned long long* const s_tk = s_wl + kTopkLists * kTopkPass;
    unsigned long long* const s_cand = s_tk + 4 * kTopkPass;
    // the largest key of this thread's nodes below `below` (0: none)
    auto key_below = [&](unsigned long long below) {
      unsigned long long b = 0;
      for (int it = 0; it < iters; ++it) {
        const int n = lo + it * B + tid;
        if (n >= hi) break;
        const unsigned long long tk = topk_key(s_ms[n - lo], n);
        if (tk < below && tk > b) b = tk;
      }
      return b;
    };
    // a pass before its barrier: each warp's `m` largest keys by repeated
    // warp maxima (this thread's largest is `mine`; only the winning thread
    // rescans its nodes), then warp 0 merges the block's warp lists into
    // the pass's buffer `dst`
    auto pass_lists = [&](unsigned long long mine, int m, unsigned long long* dst) {
      unsigned long long* const wl = s_wl + wid * kTopkPass;
      for (int r = 0; r < m; ++r) {
        const unsigned long long t = warp_max_key(mine);
        if (lid == 0) wl[r] = t;
        if (t && mine == t) mine = key_below(t);
      }
      __syncthreads();
      if (wid == 0) merge_lists(s_wl, B >> 5, m, dst, lid);
    };
    // a pass after its barrier (warp 0): the C blocks' m keys each read
    // through distributed shared memory into this block's list rows, two
    // reads in flight a lane, then merged into the pass's candidates
    auto pass_pick = [&](const unsigned long long* src, int m) {
      const int n_keys = C * m;
      for (int i = lid; i < n_keys; i += 64) {
        const int j = i + 32;
        const unsigned long long k0 = *cluster.map_shared_rank(src + i % m, i / m);
        const unsigned long long k1 =
            j < n_keys ? *cluster.map_shared_rank(src + j % m, j / m) : 0;
        s_wl[(i / m) * kTopkPass + i % m] = k0;
        if (j < n_keys) s_wl[(j / m) * kTopkPass + j % m] = k1;
      }
      __syncwarp();
      merge_lists(s_wl, C, m, s_cand, lid);
    };
    if constexpr (kExplain) {
      if (topk) pass_lists(tbest, min(topk, kTopkPass), s_tk + 2 * par * kTopkPass);
    }
    if (counted) {
      __syncthreads();
      mark(4);
    }

    // ---- round B: the cluster's (max score, lowest index) pick (with the
    // top-k: its first pass too)
    cluster.sync();
    if (wid == 0) {
      const unsigned long long k = lid < C ? *cluster.map_shared_rank(&s_key[par], lid) : 0;
      const unsigned long long top = warp_max_u64(k);
      if (lid == 0) s_pick = top;
      if constexpr (kExplain) {
        if (topk) pass_pick(s_tk + 2 * par * kTopkPass, min(topk, kTopkPass));
      }
    }
    __syncthreads();

    // ---- the top-k's candidates: after each pass, candidate r0 + c's row
    // (node, masked score, weighted rows; zero rows for a filler slot) is
    // written by lane c of the last warp of the block that owns the node,
    // all in parallel; pass i >= 1 takes the largest keys below pass i - 1's last,
    // its buffers alternating by pass parity (a block rewrites one only
    // after every block has passed the next pass's barrier)
    if constexpr (kExplain) {
      for (int pass = 0, r0 = 0; r0 < topk; ++pass, r0 += kTopkPass) {
        const int m = min(topk - r0, kTopkPass);
        if (pass > 0) {
          unsigned long long* const dst = s_tk + (2 * par + (pass & 1)) * kTopkPass;
          pass_lists(key_below(s_cand[kTopkPass - 1]), m, dst);
          cluster.sync();
          if (wid == 0) pass_pick(dst, m);
          __syncthreads();
        }
        const int cand = tid - (B - 32);  // the last warp's lanes, beside phase 3's warp 0
        const int w = cand >= 0 && cand < m ? pick_node(s_cand[cand]) : -1;
        if (w >= lo && w < hi) {
          const size_t o = orow * topk + r0 + cand;
          const float v = s_ms[w - lo];
          a.out_topk_node[o] = w;
          a.out_topk_score[o] = v;
          float* parts = a.out_topk_parts + orow * a.n_parts * topk + r0 + cand;
          if (v > kNegInf) {
            score_of(w, w - lo, s_flag[w - lo], parts, topk);
          } else {
            for (int c = 0; c < a.n_parts; ++c) parts[(size_t)c * topk] = 0.0f;
          }
        }
      }
    }
    mark(5);

    // ---- phase 3: forced-node fast path, outputs, bind. A node's rows are
    // written by its owner block; the replicas by every block alike. A
    // victim's node is -3, so it binds nothing
    const unsigned long long pick = s_pick;
    const bool any_feasible = pick_score(pick) > kNegInf;
    const int fin = victim ? -3
        : (forced >= 0 ? forced : ((forced == -1 && any_feasible) ? pick_node(pick) : -1));
    const bool own = fin >= lo && fin < hi;
    if (rank == 0 && tid == 0) {
      a.out_node[orow] = fin;
      a.out_feasible[orow] = (fail && !victim) ? s_fin_cnt : 0;
    }
    if (fin >= 0) {
      if (own) {
        float* hf = hr_l + (size_t)(fin - lo) * R;
        for (int i = tid; i < R; i += B) hf[i] = __fsub_rn(hf[i], req[i]);
        if (fl & F_PORTS)
          for (int i = tid; i < PT; i += B)
            if (pports[i]) ports_used[(size_t)fin * PT + i] = 1;
        if (gc_path)
          for (int i = tid; i < SG; i += B)
            if (match[i]) cnt_inc(a.group_count, gc_base + (size_t)fin * SG + i, bf16);
      }
      if (fl & F_DOM) {
        for (int i = tid; i < a.k1 * SG; i += B) {
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
      // written by the one thread that owns the node ((m - lo) % B of the
      // owner block), so a cell's adds run in the reference's slot order
      const bool fin_thread = own && (fin - lo) % B == tid;
      // (a node m of the slice shares fin's domain df under the key when
      // its own domain is df; a node without the key shares none: the
      // reference's sd_all row)
      if (fl & F_ANTI) {
        for (int i = a.own_ptr[p]; i < a.own_ptr[p + 1]; ++i) {
          const int t = a.own_idx[i];
          const int key = a.term_key[t];
          if (key == 0) {
            if (fin_thread) cnt_inc(a.term_block, tb_base + (size_t)fin * a.t + t, tb_bf16);
            continue;
          }
          const int df = a.node_dom[(size_t)(key - 1) * N + fin];
          for (int m = lo + tid; m < hi && df >= 0; m += B)
            if (ndom(key - 1, m) == df) cnt_inc(a.term_block, tb_base + (size_t)m * a.t + t, tb_bf16);
        }
      }
      if (fl & F_PREF) {
        for (int q = 0; q < a.ap; ++q) {
          const int4 tm = terms[p_base + q];
          if (tm.z < 0) continue;
          const int key = tm.y;
          const int t = tm.z;
          const float w = __int_as_float(tm.w);
          if (key == 0) {
            if (fin_thread) {
              float* cell = pref_paint + (size_t)fin * a.t2 + t;
              *cell = __fadd_rn(*cell, w);
            }
            continue;
          }
          const int df = a.node_dom[(size_t)(key - 1) * N + fin];
          for (int m = lo + tid; m < hi && df >= 0; m += B) {
            if (ndom(key - 1, m) != df) continue;
            float* cell = pref_paint + (size_t)m * a.t2 + t;
            *cell = __fadd_rn(*cell, w);
          }
        }
      }
    }
    if constexpr (kDevRes) {
      if (tid == 0) dev_bind(a, L, fl, p, fin, orow, own, rank == 0);
    }
    if (counted) __syncthreads();
    mark(6);
    // (the next pod's phase-0 barrier orders this bind before its reads)
  }

  // write back what lived in shared memory: the headroom slice, and (rank
  // 0; the replicas are equal) the lane-wide state
  __syncthreads();
  if (hr_res) block_copy(headroom_g + (size_t)lo * R, hr_l, nl * R * sizeof(float));
  if (rank == 0 && dom_rep) block_copy(dom_g, dom_count, (size_t)a.k1 * D * SG * sizeof(float));
  if (rank == 0 && pv_rep) block_copy(pv_g, L.pv_taken, (size_t)a.npv);
  if (timed)
    for (int i = 0; i < kPhases; ++i) a.cycles[(size_t)lane * kPhases + i] = s_cyc[i];
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---- the frozen wave form (kFrozen) ---------------------------------------

// each pod's normalizers, from round A's minima (phase 2 and the top-k's
// parts read them): inv_na, inv_tt, inv_sp, base_sp, c1, si_lo, inv_si,
// ip_lo, inv_ip, gp_lo, inv_gp, gp_w
constexpr int kNorm = 12;

// The frozen form's dynamic shared memory, for a group of G = StepArgs.grp
// pods: offsets of 4-byte words, then of bytes after them. Mirrored in
// kernels/step.py:frozen_smem_bytes.
struct FrozenLayout {
  int keys;    // the top-k's key rows (StepArgs.topk > 0, explain library):
               // [kTopkLists][kTopkPass] lists, [2][kTopkPass] a later pass's
               // merged list by pass parity, [kTopkPass] candidates, then
               // [G][kTopkPass] each pod's first-pass list
  int pick;    // [G] the block's argmax keys, [G] the cluster's picks (8 bytes each)
  int cls;     // [G][cls_bytes] each pod's class rows (RES_STAGE_CLASS; 16-byte aligned)
  int pod;     // [G][PodLay.words] each pod's region (one bulk copy)
  int fail;    // [G][OPS] first-fail histograms
  int part;    // [G][kRows + 1] the block's minima (fkey) and feasible count
  int fin;     // [G][kRows + 1] the cluster's minima and feasible count
  int nrm;     // [G][kNorm] each pod's normalizers
  int pkey;    // [G][2] each pod's folded PRNG key (the jitter)
  int sca;     // [G][4] each pod's class, forced node, soft spread and GPU request
  int dpart;   // [G][Q*D + 2Q] column-read partials (not RES_COLS_GLOBAL)
  int merged;  // [G][Q*D + 2Q] the cluster's column sums, totals, minima
  int qneed;   // [G][Q] kNeed* bits
  int minval;  // [G][Cs] f32 hard-spread minima
  int dom;     // [K1*D*Sg] f32 dom_count replica (F_DOM, not RES_DOM_GLOBAL)
  int sc;      // [G][rows][SL] f32 raw scores (+ the top-k's masked final scores)
  int hr;      // [SL*R] f32 headroom slice (RES_HEADROOM)
  int node;    // (RES_STAGE_NODE) [2][SL] f32 inv_alloc's two columns, [SL]
               // spec_id, [K1][SL] node_dom
  int flag;    // byte offset: [G][SL] feasibility flags
  int pv;      // byte offset: [Npv] pv_taken replica (device-resource, F_PV_MATCH)
  int nbyte;   // byte offset: (RES_STAGE_NODE) [SL] active, [SL] unschedulable,
               // [K][SL] has_key
  int bytes;   // total
};

__host__ __device__ inline FrozenLayout frozen_layout_of(const StepArgs& a) {
  const int g = a.grp;
  const int q = a.a + a.b + a.cs + a.ap;
  const int qd = q * a.d + 2 * q;
  const bool node = a.res & RES_STAGE_NODE;
  const bool topk = PLAIN_STEP_EXPLAIN && a.topk > 0;
  FrozenLayout l;
  int w = 0;
  l.keys = w;  // first: 8-byte keys at the region's 16-byte alignment
  w += topk ? 2 * (kTopkLists + 3 + g) * kTopkPass : 0;
  l.pick = w;
  w += 4 * g;
  l.cls = w;   // (a multiple of 4 words: so are the regions before it)
  w += (a.res & RES_STAGE_CLASS) ? g * cls_bytes(a) / 4 : 0;
  l.pod = w;
  w += g * pod_lay(a).words;
  l.fail = w;
  w += g * a.ops;
  l.part = w;
  w += g * (kRows + 1);
  l.fin = w;
  w += g * (kRows + 1);
  l.nrm = w;
  w += g * kNorm;
  l.pkey = w;
  w += 2 * g;
  l.sca = w;
  w += 4 * g;
  l.dpart = w;
  w += (kWideLib && (a.res & RES_COLS_GLOBAL)) ? 0 : g * qd;
  l.merged = w;
  w += g * qd;
  l.qneed = w;
  w += g * q;
  l.minval = w;
  w += g * a.cs;
  l.dom = w;
  w += ((a.flags & F_DOM) && !(kWideLib && (a.res & RES_DOM_GLOBAL))) ? a.k1 * a.d * a.sg : 0;
  l.sc = w;
  w += g * (score_rows(a.flags) + (topk ? 1 : 0)) * a.sl;
  l.hr = w;
  w += (a.res & RES_HEADROOM) ? a.sl * a.r : 0;
  l.node = w;
  w += node ? (3 + a.k1) * a.sl : 0;
  l.flag = 4 * w;
  l.pv = l.flag + g * a.sl;
  l.nbyte = l.pv + (((a.flags & kDevResFlags) && (a.flags & F_PV_MATCH)) ? a.npv : 0);
  l.bytes = l.nbyte + (node ? (2 + a.k) * a.sl : 0);
  return l;
}

// The frozen wave form (replaces the reference's _grid_step and the BATCH
// segment's jax.vmap(step(frozen, .)), scheduler.py:581-590, :627-635):
// every pod of the wave is evaluated against the lane's wave-start carry,
// which nothing changes during the launch, and nothing is bound (the wave
// merge, csrc/wave_merge.cu, folds the binds in afterwards). A cluster
// serves one lane and a group of up to G = StepArgs.grp consecutive pods of
// the launch (kernels/step.py:frozen_group picks G), so what the group's
// pods share is done once a cluster, not once a pod:
//  - the prologue: one bulk copy brings the G pods' regions (consecutive
//    rows of pod_pack) and one each their class rows (RES_STAGE_CLASS,
//    from class_packs), all completing on one mbarrier (phase 0), while
//    the block copies the lane's read-only wave-start carry (the headroom
//    slice, the dom_count and pv_taken replicas) and stages the slice's
//    node-static rows (RES_STAGE_NODE) once;
//  - phase 1 walks the block's nodes once: each node's rows that no pod
//    changes are read once, then the G pods are evaluated against them,
//    each pod into its own raw-score rows, flags, first-fail histogram and
//    minima partials (a warp's minima are folded into the pod's partials
//    after each node stride, so no G-wide array lives in registers);
//  - one cluster barrier a group for the column read (round C), one for
//    the minima, counts and histograms (round A) and one for the picks
//    (round B), over partial arrays G wide; each pod's normalizers are
//    computed once, by lane 0 of the warp that reduced its minima;
//  - phase 2 scores each pod over the block's nodes from shared memory and
//    folds its (score, lowest index) key into the pod's key.
// Each pod's arithmetic is the scan's, in the reference's order, so the
// outputs are those of one pod a cluster bit for bit. The outputs: node,
// fail row, feasible count, the GPU pick against the wave-start gpu_used
// (dev_pick), PV picks -1; under kExplain the top-k candidates (the first
// pass of each pod rides round B, later passes take a barrier each) and
// the jitter. Cycles (StepArgs.cycles): thread 0 of rank 0 of each lane's
// first cluster, for its group.
template <bool kInterpod, bool kDevRes, bool kExplain>
__device__ __forceinline__ void frozen_body(const StepArgs& a) {
  constexpr int kRowsT = kDevRes ? kRows : kRows - 2;
  constexpr int kLive = kDevRes ? kRows : (kInterpod ? kRows - 2 : kRows - 4);
  constexpr int kRowGpu = kInterpod ? 4 : 3;
  // the stagings the scan's builds of these gates have (registers)
  constexpr bool kStageNode = !(kInterpod && kDevRes);
  constexpr bool kStageClass = !kDevRes;
  cg::cluster_group cluster = cg::this_cluster();
  const int N = a.n, R = a.r, D = a.d, SG = a.sg, PT = a.pt, CS = a.cs;
  const int Q = a.a + a.b + a.cs + a.ap;
  const int QD = Q * D + 2 * Q;
  const int C = a.cl, B = blockDim.x, SL = a.sl, G = a.grp;
  const int rank = (int)cluster.block_rank();
  // cluster j serves lane j / n_grp and its group j % n_grp: pods
  // [pg, pg + ng), output rows p - p0
  const int n_grp = (a.npod + G - 1) / G;
  const int lane = (int)(blockIdx.x / C) / n_grp, gi = (int)(blockIdx.x / C) % n_grp;
  const int pg = (a.cursor ? *a.cursor : a.p0) + a.poff + gi * G;
  const int ng = min(G, a.npod - gi * G);
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int lid = tid & 31;
  const int lo = min(rank * SL, N), hi = min(lo + SL, N);
  const int iters = (hi - lo + B - 1) / B;
  const FrozenLayout lay = frozen_layout_of(a);
  extern __shared__ __align__(16) int s_dyn[];
  const int rows = score_rows(a.flags) + ((kExplain && a.topk > 0) ? 1 : 0);
  unsigned long long* const s_key = reinterpret_cast<unsigned long long*>(s_dyn + lay.pick);
  unsigned long long* const s_pick = s_key + G;
  uint8_t* const s_cls = reinterpret_cast<uint8_t*>(s_dyn + lay.cls);
  int* const s_podb = s_dyn + lay.pod;
  int* const s_fail = s_dyn + lay.fail;
  int* const s_part = s_dyn + lay.part;
  int* const s_fin = s_dyn + lay.fin;
  float* const s_nrm = reinterpret_cast<float*>(s_dyn + lay.nrm);
  unsigned* const s_pkey = reinterpret_cast<unsigned*>(s_dyn + lay.pkey);
  // each pod's scalars read after the prologue: its class, forced node,
  // whether a soft spread constraint is valid, whether it asks for GPUs
  int* const s_sca = s_dyn + lay.sca;
  // the column-read partials: in shared memory, or (RES_COLS_GLOBAL, the
  // wide library only) in this block's region of col_spill, G wide
  const bool cols_glob = kWideLib && (a.res & RES_COLS_GLOBAL);
  int* const s_dpart = cols_glob ? a.col_spill + (size_t)blockIdx.x * G * QD : s_dyn + lay.dpart;
  int* const s_dacc = s_dyn + lay.merged;
  int* const s_qneed = s_dyn + lay.qneed;
  float* const s_minval = reinterpret_cast<float*>(s_dyn + lay.minval);
  float* const s_sc = reinterpret_cast<float*>(s_dyn + lay.sc);
  uint8_t* const s_flag = reinterpret_cast<uint8_t*>(s_dyn) + lay.flag;
  __shared__ long long s_cyc[kPhases + 1];  // the phases, then the last mark
  __shared__ float s_w[kWeights];
  // the barrier the group's bulk copies complete
  __shared__ __align__(8) unsigned long long s_cbar;

  const int fl = kInterpod ? a.flags : (a.flags & ~kInterpodFlags);
  const bool fail = fl & F_FAIL, use_sp = fl & F_SP, gc_path = fl & F_GC;
  const bool bf16 = fl & F_GC_BF16, tb_bf16 = fl & F_TB_BF16;
  const bool dom_rep = fl & F_DOM, hr_res = a.res & RES_HEADROOM;
  const bool pv_rep = kDevRes && (fl & F_PV_MATCH);
  const int s_base = a.a + a.b;      // first spread column
  const int p_base = s_base + CS;    // first preferred-term column
  const size_t nl = hi - lo;
  const uint8_t* active = a.active + (size_t)lane * N;
  const PodLay pl = pod_lay(a);
  const bool nst = kStageNode && (a.res & RES_STAGE_NODE);
  const bool cst = kStageClass && (a.res & RES_STAGE_CLASS);
  float* const s_ia = reinterpret_cast<float*>(s_dyn + lay.node);  // [2][SL]
  int* const s_spec = s_dyn + lay.node + 2 * SL;
  int* const s_ndom = s_spec + SL;                                   // [K1][SL]
  uint8_t* const s_act = reinterpret_cast<uint8_t*>(s_dyn) + lay.nbyte;
  uint8_t* const s_uns = s_act + SL;
  uint8_t* const s_hk = s_uns + SL;                                  // [K][SL]
  const int slp = slp_of(a), cbytes = cls_bytes(a);
  auto ndom = [&](int kk, int n) -> int {
    return nst ? s_ndom[kk * SL + (n - lo)] : a.node_dom[(size_t)kk * N + n];
  };
  auto nhas = [&](int key, int n) -> bool {
    return nst ? s_hk[key * SL + (n - lo)] != 0 : a.has_key[(size_t)key * N + n] != 0;
  };
  const float* log_dom = a.log_dom + (size_t)lane * a.k;
  const uint8_t* elig_host_l = a.elig_host + (size_t)lane * a.c * N;
  const uint8_t* domain_has_l = a.domain_has + (size_t)lane * a.c * a.k1 * D;
  const uint8_t* any_elig_l = a.any_elig + (size_t)lane * a.c * a.k;
  const float* const headroom_g = a.headroom + (size_t)lane * N * R;
  // headroom row of node n: hr_l + (n - lo) * R, in shared memory or not
  float* const hr_l = hr_res ? reinterpret_cast<float*>(s_dyn + lay.hr)
                             : const_cast<float*>(headroom_g) + (size_t)lo * R;
  const uint8_t* ports_used = a.ports_used + (size_t)lane * N * PT;
  const float* const dom_g = a.dom_count + (size_t)lane * a.k1 * D * SG;
  // the dom_count replica in shared memory, or (RES_DOM_GLOBAL, the wide
  // library only) the lane's own, which the launch only reads
  const bool dom_glob = kWideLib && (a.res & RES_DOM_GLOBAL);
  const float* const dom_count =
      (dom_rep && !dom_glob) ? reinterpret_cast<const float*>(s_dyn + lay.dom) : dom_g;
  const size_t gc_base = (size_t)lane * N * SG;
  const size_t tb_base = (size_t)lane * N * a.t;
  const float* pref_paint = a.pref_paint + (size_t)lane * N * a.t2;
  const int topk = kExplain ? a.topk : 0;
  const bool jitter = kExplain && a.jitter;
  uint8_t* const pv_g = kDevRes ? a.pv_taken + (size_t)lane * a.npv : nullptr;
  const DevLane L = kDevRes
      ? DevLane{a.gpu_used + (size_t)lane * N * a.g, a.vg_used + (size_t)lane * N * a.v,
                a.sdev_taken + (size_t)lane * N * a.e,
                pv_rep ? reinterpret_cast<uint8_t*>(s_dyn) + lay.pv : pv_g,
                a.vol_cnt + (size_t)lane * N * a.lk, a.svol_on_node + (size_t)lane * N * a.nsv}
      : DevLane{};

  // the cycle counts: thread 0 of rank 0 of the lane's first cluster
  // charges the cycles since the last mark to phase k; with them on, each
  // phase ends at a block barrier
  const bool counted = a.cycles != nullptr;
  const bool timed = counted && rank == 0 && tid == 0 && gi == 0;
  if (timed) {
    for (int i = 0; i < kPhases; ++i) s_cyc[i] = 0;
    s_cyc[kPhases] = clock64();
  }
  auto mark = [&](int k) {
    if (timed) {
      const long long t = clock64();
      s_cyc[k] += t - s_cyc[kPhases];
      s_cyc[kPhases] = t;
    }
  };

  // ---- the prologue: the group's copies (the barrier set up first; the
  // prologue's barrier shows every thread it), then the lane's read-only
  // carry rows and the node-static rows, while the copies fly
  if (tid == 0) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_cbar);
    const int pbytes = 4 * pl.words * ng;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(pbytes + (cst ? ng * cbytes : 0)) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"((unsigned)__cvta_generic_to_shared(s_podb)),
        "l"(a.pod_pack + (size_t)pg * pl.words), "r"(pbytes), "r"(bar) : "memory");
    if (cst)
      for (int g = 0; g < ng; ++g)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"((unsigned)__cvta_generic_to_shared(s_cls + (size_t)g * cbytes)),
            "l"(a.cls_pack + ((size_t)a.class_id[pg + g] * C + rank) * cbytes), "r"(cbytes),
            "r"(bar) : "memory");
  }
  // (by the block's last threads: thread 0 is issuing the bulk copies)
  for (int g = B - 1 - tid; g < ng; g += B) {
    const int p = pg + g;
    bool any_soft = false;
    if (use_sp)
      for (int c = 0; c < CS; ++c) any_soft |= a.spread_soft[(size_t)p * CS + c] != 0;
    s_sca[4 * g] = a.class_id[p];
    s_sca[4 * g + 1] = a.forced_node[p];
    s_sca[4 * g + 2] = any_soft;
    s_sca[4 * g + 3] = kDevRes && a.gpu_cnt[p] > 0.0f;
  }
  if (hr_res) block_copy(hr_l, headroom_g + (size_t)lo * R, nl * R * sizeof(float));
  if (dom_rep && !dom_glob)
    block_copy(const_cast<float*>(dom_count), dom_g, (size_t)a.k1 * D * SG * sizeof(float));
  if (pv_rep) block_copy(L.pv_taken, pv_g, (size_t)a.npv);
  if (tid < kWeights) s_w[tid] = a.w_lane ? a.w_lane[(size_t)lane * kWeights + tid]
                                          : scalar_weight(a, tid);
  if (nst) {
    const int nn = (int)nl;
    for (int ln = tid; ln < nn; ln += B) {
      const int n = lo + ln;
      s_ia[ln] = a.inv_alloc[(size_t)n * R + a.ci];
      s_ia[SL + ln] = a.inv_alloc[(size_t)n * R + a.mi];
      s_spec[ln] = a.spec_id[n];
      s_act[ln] = active[n];
      s_uns[ln] = a.unschedulable[n];
    }
    for (int i = tid; i < a.k1 * nn; i += B)
      s_ndom[(i / nn) * SL + i % nn] = a.node_dom[(size_t)(i / nn) * N + lo + i % nn];
    for (int i = tid; i < a.k * nn; i += B)
      s_hk[(i / nn) * SL + i % nn] = a.has_key[(size_t)(i / nn) * N + lo + i % nn];
  }
  // ---- phase 0: zero the group's partials, fold each pod's PRNG key, and
  // what each carry column of each pod needs from the column read
  for (int i = tid; i < ng * a.ops; i += B) s_fail[i] = 0;
  for (int i = tid; i < ng * (kRows + 1); i += B) s_part[i] = i % (kRows + 1) < kRows ? INT_MAX : 0;
  for (int g = tid; g < ng; g += B) s_key[g] = 0;
  if constexpr (kExplain) {
    if (jitter)  // fold_in(PRNGKey(seed), p): the hash of (0, p)
      for (int g = tid; g < ng; g += B) {
        unsigned x0 = 0, x1 = (unsigned)(pg + g);
        threefry2x32(a.key0, a.key1, x0, x1);
        s_pkey[2 * g] = x0;
        s_pkey[2 * g + 1] = x1;
      }
  }
  if (gc_path) {
    for (int i = tid; i < ng * QD; i += B) s_dpart[i] = i % QD < Q * D + Q ? 0 : INT_MAX;
    for (int i = tid; i < ng * Q; i += B) {
      int g, key;
      column_of(a, pg + i / Q, i % Q, g, key);
      s_qneed[i] = column_need(a, fl, pg + i / Q, i % Q, key);
    }
  }
  __syncthreads();
  mark(0);
  {  // the group's regions and class rows have landed
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_cbar);
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred P1; mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], 0; "
          "selp.u32 %0, 1, 0, P1; }"
          : "=r"(done) : "r"(bar) : "memory");
  }

  // ---- phase 0b: the batched carry-column read (group_count path) of
  // every pod of the group, then round C over the cluster, once a group
  if (gc_path && Q) {
    for (int g = 0; g < ng; ++g) {
      const int4* const terms = reinterpret_cast<const int4*>(s_podb + g * pl.words);
      const uint8_t* elig_host = elig_host_l + (size_t)s_sca[4 * g] * N;
      int* const dpart = s_dpart + g * QD;
      for (int q = 0; q < Q; ++q) {
        const int need = s_qneed[g * Q + q];
        if (!need) continue;
        const int gr = terms[q].x, key = terms[q].y;
        int tot = 0, mn = INT_MAX;
        for (int it = 0; it < iters; ++it) {
          const int n = lo + it * B + tid;
          int v = 0, dm = -1;
          if (n < hi) {
            v = (int)cnt_load(a.group_count, gc_base + (size_t)n * SG + gr, bf16);
            if (need & kNeedDom) dm = ndom(key - 1, n);
            if ((need & kNeedMin) && elig_host[n]) mn = min(mn, v);
            tot += v;
          }
          if (need & kNeedDom) {
            const unsigned peers = __match_any_sync(kFull, dm);
            const int sum = __reduce_add_sync(peers, v);
            if (dm >= 0 && sum && lid == __ffs(peers) - 1) atomicAdd(&dpart[q * D + dm], sum);
          }
        }
        if (need & kNeedTot) {
          tot = __reduce_add_sync(kFull, tot);
          if (lid == 0 && tot) atomicAdd(&dpart[Q * D + q], tot);
        }
        if (need & kNeedMin) {
          mn = __reduce_min_sync(kFull, mn);
          if (lid == 0) atomicMin(&dpart[Q * D + Q + q], mn);
        }
      }
    }
    cluster.sync();
    for (int i = tid; i < ng * QD; i += B) {
      const int g = i / QD, ii = i % QD;
      const bool is_sum = ii < Q * D, is_tot = !is_sum && ii < Q * D + Q;
      const int q = is_sum ? ii / D : (is_tot ? ii - Q * D : ii - Q * D - Q);
      if (!(s_qneed[g * Q + q] & (is_sum ? kNeedDom : (is_tot ? kNeedTot : kNeedMin)))) continue;
      int v = (is_sum || is_tot) ? 0 : INT_MAX;
      for (int r = 0; r < C; ++r) {
        const int x = cols_glob ? __ldcg(s_dpart + (ptrdiff_t)(r - rank) * G * QD + i)
                                : cluster.map_shared_rank(s_dpart, r)[i];
        v = (is_sum || is_tot) ? v + x : min(v, x);
      }
      s_dacc[i] = v;
    }
    __syncthreads();
  }

  // ---- phase 0c: each pod's hard-spread minimum per constraint
  if (fl & F_SPH) {
    for (int i = tid; i < ng * CS; i += B) {
      const int g = i / CS, c = i % CS;
      const int4 sc = reinterpret_cast<const int4*>(s_podb + g * pl.words)[s_base + c];
      if (!(sc.z & 2)) continue;  // not DoNotSchedule
      const int key = sc.y, cid = s_sca[4 * g];
      float mv = kBig;
      if (gc_path) {
        const int q = s_base + c;
        const int* const dacc = s_dacc + g * QD;
        if (key == 0) {
          if (dacc[Q * D + Q + q] != INT_MAX) mv = (float)dacc[Q * D + Q + q];
        } else {
          const uint8_t* dhas = domain_has_l + ((size_t)cid * a.k1 + (key - 1)) * D;
          for (int dd = 0; dd < D; ++dd)
            if (dhas[dd]) mv = fminf(mv, (float)dacc[q * D + dd]);
        }
      } else {
        const int kk = a.k1 == 1 ? 0 : max(key - 1, 0);
        const uint8_t* dhas = domain_has_l + ((size_t)cid * a.k1 + kk) * D;
        for (int dd = 0; dd < D; ++dd)
          if (dhas[dd]) mv = fminf(mv, dom_count[((size_t)kk * D + dd) * SG + sc.x]);
      }
      s_minval[i] = any_elig_l[(size_t)cid * a.k + key] ? mv : 0.0f;
    }
    __syncthreads();
  }
  mark(1);

  // ---- phase 1: each node's rows read once, then each pod of the group
  // against them: filters, first-fail histogram, raw scores into the pod's
  // rows, the pod's minima (past the walks' widths, their verdicts first)
  if constexpr (kDevRes && kWideLib) {
    if (a.walk)
      for (int g = 0; g < ng; ++g) walk_verdicts(a, L, fl, pg + g, lo, hi, s_flag + (size_t)g * SL);
  }
  for (int it = 0; it < iters; ++it) {
    const int n = lo + it * B + tid;
    const int ln = n - lo;
    const bool in = n < hi;
    // the node's rows that no pod of the wave changes
    bool act = false, unsched = false;
    float ia_c = 0.0f, ia_m = 0.0f;
    int spec = 0;
    if (in) {
      act = (nst ? s_act[ln] : active[n]) != 0;
      unsched = (fl & F_UNSCHED) && (nst ? s_uns[ln] : a.unschedulable[n]);
      ia_c = nst ? s_ia[ln] : a.inv_alloc[(size_t)n * R + a.ci];
      ia_m = nst ? s_ia[SL + ln] : a.inv_alloc[(size_t)n * R + a.mi];
      spec = (fl & F_SI) ? (nst ? s_spec[ln] : a.spec_id[n]) : 0;
    }
    const float* hr = hr_l + (size_t)ln * R;
    for (int g = 0; g < ng; ++g) {
      const int p = pg + g;
      const int* const sp = s_podb + g * pl.words;
      const uint8_t* const sb = reinterpret_cast<const uint8_t*>(sp);
      const float* req = reinterpret_cast<const float*>(sp + pl.req);
      const uint8_t* pports = sb + pl.ports;
      const uint8_t* match = sb + pl.match;
      const int4* const terms = reinterpret_cast<const int4*>(sp);
      const uint8_t* const cb = s_cls + (size_t)g * cbytes;
      const float* const cbf = reinterpret_cast<const float*>(cb);
      const int cid = s_sca[4 * g];
      const int* const dacc = s_dacc + g * QD;
      const int* const qtot = dacc + Q * D;
      float* const sc_g = s_sc + (size_t)g * rows * SL;
      uint8_t* const flag_g = s_flag + (size_t)g * SL;
      float m_na = kBig, m_tt = kBig, m_slo = kBig, m_shi = kBig, m_ilo = kBig, m_ihi = kBig;
      float m_plo = kBig, m_phi = kBig, m_glo = kBig, m_ghi = kBig;
      int cnt = 0, charged_op = -1;
      if (in) {
        const size_t cn = (size_t)cid * N + n;
        const bool aff_ok = !(fl & F_CLASS_AFF) || (cst ? cb[8 * slp + ln] : a.class_affinity[cn]);
        const bool taint_ok = !(fl & F_CLASS_TAINT) || (cst ? cb[9 * slp + ln] : a.class_taint[cn]);
        const float na_score = (fl & F_NA) ? (cst ? cbf[ln] : a.class_node_aff_score[cn]) : 0.0f;
        const float tt_prefer =
            (fl & F_TT) ? (cst ? cbf[slp + ln] : a.class_taint_prefer[cn]) : 0.0f;
        int ff = -1;
        if (unsched) {
          ff = 0;
        } else if (!aff_ok) {
          ff = 1;
        } else if (!taint_ok) {
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
        if (ff < 0 && (fl & F_AFF)) {
          for (int q = 0; q < a.a; ++q) {
            const int4 tm = terms[q];
            if (!(tm.z & 1)) continue;
            const int key = tm.y;
            const float dc = column_count(a, dacc, q, tm.x, key, n,
                                          key ? ndom(key - 1, n) : -1, gc_base, bf16);
            const bool ok = nhas(key, n) && (dc > 0.0f || (qtot[q] == 0 && (tm.z & 2)));
            if (!ok) {
              ff = 4 + R;
              break;
            }
          }
        }
        if (ff < 0 && (fl & F_ANTI)) {
          bool bad = false;
          for (int q = 0; q < a.b && !bad; ++q) {
            const int4 tm = terms[a.a + q];
            if (!tm.z) continue;
            const int key = tm.y;
            bad = column_count(a, dacc, a.a + q, tm.x, key, n,
                               key ? ndom(key - 1, n) : -1, gc_base, bf16) != 0.0f;
          }
          if (a.hit_w) {
            for (int i = 0; i < a.hit_w && !bad; ++i) {
              const int t = sp[pl.hits + i];
              if (t < 0) break;
              bad = cnt_load(a.term_block, tb_base + (size_t)n * a.t + t, tb_bf16) > 0.0f;
            }
          } else {
            for (int i = a.hit_ptr[p]; i < a.hit_ptr[p + 1] && !bad; ++i)
              bad = cnt_load(a.term_block, tb_base + (size_t)n * a.t + a.hit_idx[i], tb_bf16) > 0.0f;
          }
          if (bad) ff = 5 + R;
        }
        if (ff < 0 && (fl & F_SPH)) {
          for (int c = 0; c < CS; ++c) {
            const int4 tm = terms[s_base + c];
            if (!(tm.z & 2)) continue;
            const int key = tm.y, gr = tm.x;
            float dc;
            if (gc_path) {
              dc = column_count(a, dacc, s_base + c, gr, key, n, key ? ndom(key - 1, n) : -1,
                                gc_base, bf16);
            } else {
              const int kk = a.k1 == 1 ? 0 : max(key - 1, 0);
              const int dm = ndom(kk, n);
              dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + gr] : 0.0f;
            }
            const float skew =
                __fsub_rn(__fadd_rn(dc, match[gr] ? 1.0f : 0.0f), s_minval[g * CS + c]);
            if (!(nhas(key, n) && skew <= __int_as_float(tm.w))) {
              ff = 6 + R;
              break;
            }
          }
        }
        if constexpr (kDevRes) {
          const int vcid = a.vol_cid[p];
          if (ff < 0 && (fl & F_GPU) && !gpu_fits(a, L, p, n)) ff = 7 + R;
          if (ff < 0 && (fl & F_STORAGE) &&
              ((kWideLib && a.walk) ? (flag_g[ln] & 4) != 0
                      : !(lvm_pack(a, L, p, n, nullptr) && device_match(a, L, p, n, nullptr))))
            ff = 8 + R;
          if (ff < 0 && (fl & F_VOL_STATIC)) {
            const size_t cv = (size_t)vcid * N + n;
            if (!a.class_vol_node[cv]) ff = 9 + R;
            else if (!a.class_vol_zone[cv]) ff = 10 + R;
            else if (!a.class_vol_bind[cv]) ff = 11 + R;
          }
          if (ff < 0 && (fl & F_PV_MATCH) &&
              ((kWideLib && a.walk) ? (flag_g[ln] & 8) != 0 : !wfc_fits(a, L.pv_taken, p, n)))
            ff = 11 + R;
          if (ff < 0 && (fl & F_VOL_STATIC) && a.vol_pv_missing[p]) ff = 12 + R;
          if (ff < 0 && (fl & F_VOL_LIMITS) && !limits_ok(a, L, fl, p, n)) ff = 13 + R;
        }
        const bool mask = act && ff < 0;
        if (act && ff >= 0) charged_op = ff;
        uint8_t flag = mask ? 1 : 0;
        if (fl & F_NA) m_na = fminf(m_na, mask ? -na_score : 0.0f);
        if (fl & F_TT) m_tt = fminf(m_tt, mask ? -tt_prefer : 0.0f);
        if (mask) {
          ++cnt;
          const float h_c = __fmul_rn(__fsub_rn(hr[a.ci], req[a.ci]), ia_c);
          const float h_m = __fmul_rn(__fsub_rn(hr[a.mi], req[a.mi]), ia_m);
          float base = 0.0f;
          if (fl & F_BAL)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[0] : a.w_bal), __fmul_rn(
                __fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(h_c, h_m)), 0.5f)), 100.0f)));
          if (fl & F_LEAST)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[1] : a.w_least), __fmul_rn(
                __fadd_rn(fmaxf(h_c, 0.0f), fmaxf(h_m, 0.0f)), 50.0f)));
          if (fl & F_MOST)
            base = __fadd_rn(base, __fmul_rn((a.w_lane ? s_w[2] : a.w_most),
                                             __fmul_rn(__fadd_rn(
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_c)), ia_c > 0.0f ? 1.0f : 0.0f),
                __fmul_rn(clamp01(__fsub_rn(1.0f, h_m)), ia_m > 0.0f ? 1.0f : 0.0f)),
                50.0f)));
          sc_g[ln] = base;
          if (fl & F_IP) {
            float raw = 0.0f;
            for (int t = 0; t < a.t2; ++t)
              if (sb[pl.hpref + t]) raw = __fadd_rn(raw, pref_paint[(size_t)n * a.t2 + t]);
            for (int q = 0; q < a.ap; ++q) {
              const int4 tm = terms[p_base + q];
              if (tm.z < 0) continue;
              const int key = tm.y;
              const float dc = column_count(a, dacc, p_base + q, tm.x, key, n,
                                            key ? ndom(key - 1, n) : -1, gc_base, bf16);
              const float hk = nhas(key, n) ? 1.0f : 0.0f;
              raw = __fadd_rn(raw, __fmul_rn(__fmul_rn(__int_as_float(tm.w), dc), hk));
            }
            sc_g[3 * SL + ln] = raw;
            m_plo = fminf(m_plo, raw);
            m_phi = fminf(m_phi, -raw);
          }
          if (use_sp) {
            float sraw = 0.0f;
            bool sok = true;
            for (int c = 0; c < CS; ++c) {
              const int4 tm = terms[s_base + c];
              if (!(tm.z & 1)) continue;  // not ScheduleAnyway
              const int kid = tm.y;
              const int gr = tm.x;
              float dc;
              if (gc_path) {
                dc = column_count(a, dacc, s_base + c, gr, kid, n, kid ? ndom(kid - 1, n) : -1,
                                  gc_base, bf16);
              } else {
                const int kk = a.k1 == 1 ? 0 : max(kid - 1, 0);
                const int dm = ndom(kk, n);
                dc = dm >= 0 ? dom_count[((size_t)kk * D + dm) * SG + gr] : 0.0f;
              }
              sraw = __fadd_rn(sraw, __fadd_rn(__fmul_rn(dc, log_dom[kid]),
                                               __fsub_rn(__int_as_float(tm.w), 1.0f)));
              sok = sok && nhas(kid, n);
            }
            sc_g[SL + ln] = sraw;
            if (sok) {
              flag |= 2;
              m_slo = fminf(m_slo, sraw);
              m_shi = fminf(m_shi, -sraw);
            }
          }
          if (fl & F_SI) {
            const float* sa = a.spec_alloc + (size_t)spec * R;
            float mx = 0.0f;
            for (int r = 0; r < R; ++r) {
              const float avail = __fsub_rn(sa[r], req[r]);
              const float rq = req[r];
              float sh = avail != 0.0f ? __fdiv_rn(rq, avail) : (rq != 0.0f ? 1.0f : 0.0f);
              sh = rq > 0.0f ? clamp01(sh) : 0.0f;
              mx = r == 0 ? sh : fmaxf(mx, sh);
            }
            const float raw_si = __fmul_rn(mx, 100.0f);
            sc_g[2 * SL + ln] = raw_si;
            m_ilo = fminf(m_ilo, raw_si);
            m_ihi = fminf(m_ihi, -raw_si);
          }
          if constexpr (kDevRes) {
            if (fl & F_GPU) {
              const float raw_gp = gpu_raw(a, L, p, n);
              sc_g[kRowGpu * SL + ln] = raw_gp;
              m_glo = fminf(m_glo, raw_gp);
              m_ghi = fminf(m_ghi, -raw_gp);
            }
          }
        }
        flag_g[ln] = flag;
      }
      if (fail) {
        // warp-aggregated histogram add: one shared atomic per distinct op
        const unsigned peers = __match_any_sync(kFull, charged_op);
        if (charged_op >= 0 && lid == __ffs(peers) - 1)
          atomicAdd(&s_fail[g * a.ops + charged_op], __popc(peers));
      }
      // this node stride's minima and count into the pod's partials
      int* const part = s_part + g * (kRows + 1);
      const float mins[kRows] = {m_na, m_tt, m_slo, m_shi, m_ilo, m_ihi, m_plo, m_phi, m_glo,
                                 m_ghi};
#pragma unroll
      for (int q = 0; q < kLive; ++q) {
        const float v = warp_min(mins[q]);
        if (lid == 0) atomicMin(&part[q], fkey(v));
      }
      cnt = __reduce_add_sync(kFull, cnt);
      if (lid == 0 && cnt) atomicAdd(&part[kRows], cnt);
    }
  }
  if (counted) {
    __syncthreads();
    mark(2);
  }

  // ---- round A, once a group: each pod's minima and feasible count over
  // the cluster (a warp a pod, one lane per block), and from them the
  // pod's normalizers (that warp's lane 0); the first-fail histograms into
  // the output (each (pod, op) summed over the blocks by one thread of one
  // block)
  auto normalize = [&](int g) {
    const float* const fin = reinterpret_cast<const float*>(s_fin + g * (kRows + 1));
    const bool any_soft = s_sca[4 * g + 2];
    const float hi_na = -fin[0];
    const float hi_tt = -fin[1];
    const float sp_min = fin[2];
    const float sp_max = -fin[3];
    const float soft_f = any_soft ? 1.0f : 0.0f;
    const bool sp_pos = sp_max > 0.0f;
    const float si_lo = fin[4];
    const float si_rng = __fsub_rn(-fin[5], si_lo);
    const float ip_lo = kInterpod ? fin[6] : 0.0f;
    const float ip_rng = kInterpod ? __fsub_rn(-fin[7], ip_lo) : 0.0f;
    const float gp_lo = kDevRes ? fin[kRowsT - 2] : 0.0f;
    const float gp_rng = kDevRes ? __fsub_rn(-fin[kRowsT - 1], gp_lo) : 0.0f;
    float* const nv = s_nrm + g * kNorm;
    nv[0] = hi_na > 0.0f ? __fdiv_rn(100.0f, hi_na) : 0.0f;
    nv[1] = hi_tt > 0.0f ? __fdiv_rn(100.0f, hi_tt) : 0.0f;
    nv[2] = __fmul_rn(sp_pos ? __fdiv_rn(100.0f, fmaxf(sp_max, 1e-9f)) : 0.0f, soft_f);
    nv[3] = __fmul_rn(sp_pos ? 0.0f : 100.0f, soft_f);
    nv[4] = __fadd_rn(sp_max, sp_min);
    nv[5] = si_lo;
    nv[6] = si_rng > 0.0f ? __fdiv_rn(100.0f, si_rng) : 0.0f;
    nv[7] = ip_lo;
    nv[8] = ip_rng > 0.0f ? __fdiv_rn(100.0f, ip_rng) : 0.0f;
    nv[9] = gp_lo;
    nv[10] = gp_rng > 0.0f ? __fdiv_rn(100.0f, gp_rng) : 0.0f;
    // a pod without a GPU request scores 0 on the GPU row
    nv[11] = kDevRes ? __fmul_rn((a.w_lane ? s_w[8] : a.w_gpu),
                                 s_sca[4 * g + 3] ? 1.0f : 0.0f) : 0.0f;
  };
  cluster.sync();
  for (int g = wid; g < ng; g += B >> 5) {
    const int* rp = lid < C ? cluster.map_shared_rank(s_part + g * (kRows + 1), lid) : nullptr;
    int v[kLive];
#pragma unroll
    for (int q = 0; q < kLive; ++q) v[q] = rp ? rp[q] : INT_MAX;
    const int c = __reduce_add_sync(kFull, rp ? rp[kRows] : 0);
#pragma unroll
    for (int q = 0; q < kLive; ++q) {
      const int mq = __reduce_min_sync(kFull, v[q]);
      if (lid == 0) s_fin[g * (kRows + 1) + q] = __float_as_int(fkey_inv(mq));
    }
    if (lid == 0) {
      s_fin[g * (kRows + 1) + kRows] = c;
      normalize(g);
    }
  }
  if (fail) {
    for (int i = rank + tid * C; i < ng * a.ops; i += B * C) {
      int sum = 0;
      for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(s_fail, r)[i];
      a.out_fail[((size_t)lane * a.ls + (pg + i / a.ops - a.p0)) * a.ops + i % a.ops] = sum;
    }
  }
  __syncthreads();
  mark(3);

  // ---- phase 2, a pod at a time over the block's nodes: the final score
  // in the reference's add order, the pod's (score, lowest index) key
  // the final score of pod g at node n (slice index ln) from its
  // normalizers `nv`: its weighted score rows in the reference's add order
  // (resources, node affinity, taint, interpod, spread, Simon, GPU), summed
  // left to right; given `parts`, each live row is also written there,
  // `stride` apart (the explain candidates' breakdown)
  auto score_of = [&](const float (&nv)[kNorm], int g, int n, int ln, uint8_t flag, float* parts,
                      int stride) -> float {
    const float* const sc_g = s_sc + (size_t)g * rows * SL;
    const uint8_t* const cb = s_cls + (size_t)g * cbytes;
    const float* const cbf = reinterpret_cast<const float*>(cb);
    const size_t cn = (size_t)s_sca[4 * g] * N + n;
    float score = sc_g[ln];
    int c = 0;
    auto add = [&](float v) {
      if (parts) parts[(size_t)(++c) * stride] = v;
      score = __fadd_rn(score, v);
    };
    if (parts) parts[0] = score;
    if (fl & F_NA)
      add(__fmul_rn((a.w_lane ? s_w[3] : a.w_na),
                    __fmul_rn(cst ? cbf[ln] : a.class_node_aff_score[cn], nv[0])));
    if (fl & F_TT)
      add(__fmul_rn((a.w_lane ? s_w[4] : a.w_tt), __fsub_rn(100.0f, __fmul_rn(
          cst ? cbf[slp + ln] : a.class_taint_prefer[cn], nv[1]))));
    if (fl & F_IP)
      add(__fmul_rn((a.w_lane ? s_w[5] : a.w_ip),
                    __fmul_rn(__fsub_rn(sc_g[3 * SL + ln], nv[7]), nv[8])));
    if (use_sp) {
      const float v = (flag & 2)
          ? __fadd_rn(nv[3], __fmul_rn(__fsub_rn(nv[4], sc_g[SL + ln]), nv[2]))
          : 0.0f;
      add(__fmul_rn((a.w_lane ? s_w[6] : a.w_sp), v));
    }
    if (fl & F_SI)
      add(__fmul_rn((a.w_lane ? s_w[7] : a.w_si),
                    __fmul_rn(__fsub_rn(sc_g[2 * SL + ln], nv[5]), nv[6])));
    if constexpr (kDevRes) {
      if (fl & F_GPU)
        add(__fmul_rn(nv[11], __fmul_rn(__fsub_rn(sc_g[kRowGpu * SL + ln], nv[9]), nv[10])));
    }
    return score;
  };
  auto load_norm = [&](int g, float (&nv)[kNorm]) {
#pragma unroll
    for (int i = 0; i < kNorm; ++i) nv[i] = s_nrm[g * kNorm + i];
  };
  // the top-k (kExplain, topk > 0): each pod's masked final scores in its
  // last row; the lists, passes and candidates as in the scan
  unsigned long long* const s_wl = reinterpret_cast<unsigned long long*>(s_dyn + lay.keys);
  unsigned long long* const s_tk = s_wl + kTopkLists * kTopkPass;  // [2][kTopkPass]
  unsigned long long* const s_cand = s_tk + 2 * kTopkPass;
  unsigned long long* const s_first = s_cand + kTopkPass;           // [G][kTopkPass]
  auto ms_of = [&](int g) { return s_sc + ((size_t)g * rows + rows - 1) * SL; };
  // the largest key of this thread's nodes below `below` (0: none)
  auto key_below = [&](const float* ms, unsigned long long below) {
    unsigned long long b = 0;
    for (int it = 0; it < iters; ++it) {
      const int n = lo + it * B + tid;
      if (n >= hi) break;
      const unsigned long long tk = topk_key(ms[n - lo], n);
      if (tk < below && tk > b) b = tk;
    }
    return b;
  };
  // a pass before its barrier: each warp's `m` largest keys by repeated
  // warp maxima, then warp 0 merges the block's warp lists into `dst`
  auto pass_lists = [&](const float* ms, unsigned long long mine, int m,
                        unsigned long long* dst) {
    unsigned long long* const wl = s_wl + wid * kTopkPass;
    for (int r = 0; r < m; ++r) {
      const unsigned long long t = warp_max_key(mine);
      if (lid == 0) wl[r] = t;
      if (t && mine == t) mine = key_below(ms, t);
    }
    __syncthreads();
    if (wid == 0) merge_lists(s_wl, B >> 5, m, dst, lid);
  };
  // a pass after its barrier (warp 0): the C blocks' m keys each, read
  // through distributed shared memory, merged into the pass's candidates
  auto pass_pick = [&](const unsigned long long* src, int m) {
    const int n_keys = C * m;
    for (int i = lid; i < n_keys; i += 64) {
      const int j = i + 32;
      const unsigned long long k0 = *cluster.map_shared_rank(src + i % m, i / m);
      const unsigned long long k1 =
          j < n_keys ? *cluster.map_shared_rank(src + j % m, j / m) : 0;
      s_wl[(i / m) * kTopkPass + i % m] = k0;
      if (j < n_keys) s_wl[(j / m) * kTopkPass + j % m] = k1;
    }
    __syncwarp();
    merge_lists(s_wl, C, m, s_cand, lid);
  };
  for (int g = 0; g < ng; ++g) {
    float nv[kNorm];
    load_norm(g, nv);
    const uint8_t* const flag_g = s_flag + (size_t)g * SL;
    float* const ms_g = ms_of(g);
    unsigned long long best = 0, tbest = 0;
    for (int it = 0; it < iters; ++it) {
      const int n = lo + it * B + tid;
      if (n >= hi) break;
      const int ln = n - lo;
      const uint8_t flag = flag_g[ln];
      float ms = kNegInf;
      if (flag & 1) {
        ms = score_of(nv, g, n, ln, flag, nullptr, 0);
        // the tie-break: the integer score scale, then the jitter
        if (jitter) ms = __fadd_rn(rintf(ms), jitter_of(s_pkey[2 * g], s_pkey[2 * g + 1], n));
      }
      // nodes ascend per thread: a tie keys lower for the later node
      const unsigned long long k = pick_key(ms, n);
      if (k > best) best = k;
      if constexpr (kExplain) {
        if (topk) {
          ms_g[ln] = ms;
          const unsigned long long tk = topk_key(ms, n);
          if (tk > tbest) tbest = tk;
        }
      }
    }
    best = warp_max_u64(best);
    if (lid == 0 && best) atomicMax(&s_key[g], best);
    if constexpr (kExplain) {
      if (topk) {
        __syncthreads();  // the warp lists are free (warp 0 merged the last pod's)
        pass_lists(ms_g, tbest, min(topk, kTopkPass), s_first + g * kTopkPass);
      }
    }
  }
  if (counted) {
    __syncthreads();
    mark(4);
  }

  // ---- round B, once a group: each pod's pick over the cluster (a warp a
  // pod); with the top-k, each pod's first pass rides it
  cluster.sync();
  for (int g = wid; g < ng; g += B >> 5) {
    const unsigned long long k = lid < C ? *cluster.map_shared_rank(&s_key[g], lid) : 0;
    const unsigned long long top = warp_max_u64(k);
    if (lid == 0) s_pick[g] = top;
  }
  __syncthreads();
  // the top-k's candidates, a pod at a time: after each pass, candidate
  // r0 + c's row is written by lane c of the last warp of the block that
  // owns the node; pass i >= 1 takes the largest keys below pass i - 1's
  // last, its buffers alternating by the launch's pass count (a block
  // rewrites one only after every block has passed the next pass's barrier)
  if constexpr (kExplain) {
    for (int g = 0, later = 0; g < ng && topk; ++g) {
      float nv[kNorm];
      load_norm(g, nv);
      const float* const ms_g = ms_of(g);
      const size_t orow = (size_t)lane * a.ls + (pg + g - a.p0);
      for (int pass = 0, r0 = 0; r0 < topk; ++pass, r0 += kTopkPass) {
        const int m = min(topk - r0, kTopkPass);
        if (pass == 0) {
          if (wid == 0) pass_pick(s_first + g * kTopkPass, m);
        } else {
          unsigned long long* const dst = s_tk + (later++ & 1) * kTopkPass;
          pass_lists(ms_g, key_below(ms_g, s_cand[kTopkPass - 1]), m, dst);
          cluster.sync();
          if (wid == 0) pass_pick(dst, m);
        }
        __syncthreads();
        const int cand = tid - (B - 32);
        const int w = cand >= 0 && cand < m ? pick_node(s_cand[cand]) : -1;
        if (w >= lo && w < hi) {
          const size_t o = orow * topk + r0 + cand;
          const float v = ms_g[w - lo];
          a.out_topk_node[o] = w;
          a.out_topk_score[o] = v;
          float* parts = a.out_topk_parts + orow * a.n_parts * topk + r0 + cand;
          if (v > kNegInf) {
            score_of(nv, g, w, w - lo, s_flag[(size_t)g * SL + w - lo], parts, topk);
          } else {
            for (int c = 0; c < a.n_parts; ++c) parts[(size_t)c * topk] = 0.0f;
          }
        }
        __syncthreads();  // the lists and the candidates are free again
      }
    }
  }
  mark(5);

  // ---- phase 3: each pod's outputs (a thread a pod): the forced node or
  // the pick, the feasible count, the device-resource picks; nothing binds
  for (int g = tid; g < ng; g += B) {
    const int p = pg + g;
    const unsigned long long pick = s_pick[g];
    const bool any_feasible = pick_score(pick) > kNegInf;
    const int forced = s_sca[4 * g + 1];
    const int fin = forced >= 0 ? forced : ((forced == -1 && any_feasible) ? pick_node(pick) : -1);
    const size_t orow = (size_t)lane * a.ls + (p - a.p0);
    if (rank == 0) {
      a.out_node[orow] = fin;
      a.out_feasible[orow] = fail ? s_fin[g * (kRows + 1) + kRows] : 0;
    }
    if constexpr (kDevRes) dev_pick(a, L, fl, p, fin, orow, fin >= lo && fin < hi, rank == 0);
  }
  if (counted) __syncthreads();
  mark(6);
  if (timed)
    for (int i = 0; i < kPhases; ++i) a.cycles[(size_t)lane * kPhases + i] = s_cyc[i];
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <bool kInterpod, bool kDevRes, bool kCols, bool kFrozen, bool kExplain, bool kExt>
__global__ void __launch_bounds__(max_threads_of(kDevRes, kWideLib, kExplain, kExt), 1)
    plain_step_kernel(const StepArgs a) {
  static_assert(!(kFrozen && (kCols || kExt)), "the frozen form has no columns and no rows");
  if constexpr (kFrozen)
    frozen_body<kInterpod, kDevRes, kExplain>(a);
  else
    step_body<kInterpod, kDevRes, kCols, kExplain, false, kExt>(a);
}

// The fleet form (replaces the reference's run_fleet_batched,
// open_simulator_tpu/engine/exec_cache.py:837: schedule_pods vmapped over
// per-lane SnapshotArrays): lane s is its own cluster, every array its
// own. Each block copies its lane's StepArgs (a.lanes[s], built as a
// one-lane launch over that cluster would build it) into shared memory
// and runs the step's body on it, so each lane computes what a lone
// launch of its cluster computes. Built for the scan without the
// preemption columns, the only form a fleet runs.
template <bool kInterpod, bool kDevRes, bool kExplain>
__global__ void __launch_bounds__(max_threads_of(kDevRes, true), 1)
    plain_step_fleet_kernel(const StepArgs a) {
  __shared__ __align__(16) StepArgs s_lane;
  block_copy(&s_lane, a.lanes + blockIdx.x / a.cl, sizeof(StepArgs));
  __syncthreads();
  step_body<kInterpod, kDevRes, false, kExplain, true, false>(s_lane);
}

// the instantiation a launch runs: the frozen wave form (never with the
// preemption columns: the planner's plan is dropped under them), the
// column builds, or the plain scan; kExplain is this library's, and so is
// kExt in the scan builds (the extension library holds only those; the
// wide library keeps the rows in its scan builds)
constexpr bool kExplainLib = PLAIN_STEP_EXPLAIN != 0;
constexpr bool kExtScan = kExtLib || kWideLib;

void (*kernel_of(const StepArgs* args))(StepArgs) {
  constexpr bool X = kExplainLib, E = kExtScan;
  const bool interpod = args->flags & kInterpodFlags, devres = args->flags & kDevResFlags;
#if PLAIN_STEP_EXT
  // (the extension library builds neither the fleet nor the frozen form)
  if (args->fleet || args->frozen) return nullptr;
#else
  if (args->fleet)
    return devres ? (interpod ? plain_step_fleet_kernel<true, true, X>
                              : plain_step_fleet_kernel<false, true, X>)
                  : (interpod ? plain_step_fleet_kernel<true, false, X>
                              : plain_step_fleet_kernel<false, false, X>);
  if (args->frozen)
    return devres ? (interpod ? plain_step_kernel<true, true, false, true, X, false>
                              : plain_step_kernel<false, true, false, true, X, false>)
                  : (interpod ? plain_step_kernel<true, false, false, true, X, false>
                              : plain_step_kernel<false, false, false, true, X, false>);
#endif
  if (args->disabled || args->nominated)
    return devres ? (interpod ? plain_step_kernel<true, true, true, false, X, E>
                              : plain_step_kernel<false, true, true, false, X, E>)
                  : (interpod ? plain_step_kernel<true, false, true, false, X, E>
                              : plain_step_kernel<false, false, true, false, X, E>);
  return devres ? (interpod ? plain_step_kernel<true, true, false, false, X, E>
                            : plain_step_kernel<false, true, false, false, X, E>)
                : (interpod ? plain_step_kernel<true, false, false, false, X, E>
                            : plain_step_kernel<false, false, false, false, X, E>);
}

// a launch asks for explain or the jitter exactly when it is this
// library's (kernels/step.py loads the library that matches)
bool explain_ok(const StepArgs* args) {
  const bool wants = args->topk > 0 || args->jitter;
  return wants == kExplainLib && args->topk >= 0 &&
         (args->topk == 0 || (args->topk <= args->n && args->n_parts >= 1 &&
                              args->out_topk_node && args->out_topk_score &&
                              args->out_topk_parts));
}

// the clusters a launch runs: one per lane (a fleet: per lane's StepArgs),
// or frozen one per lane and group of its pods
int clusters_of(const StepArgs* args) {
  return args->frozen ? args->s * ((args->npod + args->grp - 1) / args->grp) : args->s;
}

// a block's dynamic shared memory: the frozen form's layout, or the scan's
int smem_of(const StepArgs* args) {
  return args->frozen ? frozen_layout_of(*args).bytes : layout_of(*args).bytes;
}

// the kernel's attributes for a launch of this geometry: a cluster over 8
// blocks is non-portable, and over 48 KB of dynamic shared memory must be
// asked for
cudaError_t prepare(void (*kernel)(StepArgs), const StepArgs* args, size_t smem) {
  cudaError_t e = cudaSuccess;
  if (args->cl > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return e;
}

bool geometry_ok(const StepArgs* args) {
  if (!explain_ok(args) || args->hit_w < 0) return false;
  // the walk window and the regions in global memory are the wide library's
  if (!kWideLib && (args->walk || (args->res & (RES_DOM_GLOBAL | RES_COLS_GLOBAL))))
    return false;
  const int c = args->cl;
  const int max_bt = max_threads_of(args->flags & kDevResFlags, args->fleet || kWideLib,
                                    kExplainLib, kExtLib);
  return c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0 && args->bt >= 32 &&
         args->bt <= max_bt && args->bt % 32 == 0 && args->sl >= 1 &&
         (long long)args->sl * c >= args->n;
}

cudaLaunchConfig_t config_of(const StepArgs* args, size_t smem, cudaLaunchAttribute* attr,
                             int n_clusters, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = args->cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * args->cl, 1, 1);
  cfg.blockDim = dim3(args->bt, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The dynamic shared memory a block of this launch needs (bytes).
extern "C" int plain_step_smem(const StepArgs* args) { return smem_of(args); }

// How many clusters of args->cl blocks of args->bt threads the card holds
// at once (cudaOccupancyMaxActiveClusters) into *n; 0 when it cannot place
// one. Returns a CUDA error code.
extern "C" int plain_step_clusters(const StepArgs* args, int* n) {
  *n = 0;
  if (!geometry_ok(args)) return (int)cudaErrorInvalidValue;
  void (*kernel)(StepArgs) = kernel_of(args);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of(args);
  cudaError_t e = prepare(kernel, args, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config_of(args, smem, &attr, 1, nullptr);
  e = cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) {
    *n = 0;
    cudaGetLastError();  // a size the card refuses is an answer (0), not a fault
  }
  return (int)cudaSuccess;
}

// Launch on `stream` (PyTorch's current stream): S clusters of args->cl
// blocks. Returns cudaGetLastError(): a refused launch never runs, so the
// caller must check it.
extern "C" int plain_step_launch(const StepArgs* args, void* stream) {
  if (!geometry_ok(args)) return (int)cudaErrorInvalidValue;
  // the staged regions' sources, and only the stagings a build has
  // (none with both slices' gates, no class rows with the device-resource
  // ops)
  const bool devres = args->flags & kDevResFlags, both = devres && (args->flags & kInterpodFlags);
  if (!args->pod_pack || ((args->res & RES_STAGE_CLASS) && !args->cls_pack) ||
      ((args->res & RES_STAGE_CLASS) && devres) ||
      ((args->res & (RES_STAGE_NODE | RES_STAGE_CLASS)) && both))
    return (int)cudaErrorInvalidValue;
  // the frozen form: no template or column, groups of at least one pod, and
  // (without the cursor, whose pods the host cannot see) its pods inside
  // [p0, p1)
  if (args->frozen && (args->disabled || args->nominated || (args->flags & F_TEMPLATE) ||
                       args->grp < 1 || args->npod < 1 || args->poff < 0 ||
                       (!args->cursor && args->p0 + args->poff + args->npod > args->p1)))
    return (int)cudaErrorInvalidValue;
  if (args->fleet && (!args->lanes || args->frozen || args->disabled || args->nominated ||
                      args->cycles))
    return (int)cudaErrorInvalidValue;
  // the extension rows: the scan builds of the extension library (which
  // takes no launch without rows) and of the wide one only, every pointer
  // of a row kind its count needs, and an output stride that holds the
  // launch's pods; the device cursor: those scan builds, or the frozen form
  const int n_out = args->p1 - args->p0;
  const bool ext = args->ef || args->es;
  if (ext && (!kExtScan || args->frozen || args->fleet)) return (int)cudaErrorInvalidValue;
  if (args->cursor && (args->fleet || !(args->frozen || kExtScan)))
    return (int)cudaErrorInvalidValue;
  if (kExtLib && !ext) return (int)cudaErrorInvalidValue;
  if (args->ef < 0 || args->es < 0 || (args->ef && !args->ext_ok) ||
      (args->es && !(args->ext_raw && args->ext_w && args->ext_norm)) ||
      args->ered < 0 || args->ered > 2 * args->es || args->ls < n_out ||
      (args->ef + args->es && args->ops < args->ef))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(StepArgs) = kernel_of(args);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of(args);
  // (setting a function attribute is no stream work: relaxed, it may run
  // while the stream is captured into a CUDA graph, as PyTorch's allocator
  // does its cudaMalloc)
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaThreadExchangeStreamCaptureMode(&mode);
  cudaError_t e = prepare(kernel, args, smem);
  cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config_of(args, smem, &attr, clusters_of(args), static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
