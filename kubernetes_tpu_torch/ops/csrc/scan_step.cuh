// The greedy pod scan, shared by K2 assign_scan (one block over the wave,
// or past one block's slots a cluster of blocks), K5 gang_assign (one
// block, or one cluster, per placement mask) and K6 sharded_assign (one
// cluster of blocks over the wave, each block a node range): the
// reference's _assign_step (kubernetes_tpu/ops/kernels.py:925-1250) in a
// loop over the pods, both tiers, with hard spread and inter-pod affinity.
//
// Per pod: the NodeResourcesFit filter on the carried `used` plane, the
// hard PodTopologySpread filter on the carried per-domain selector counts
// and InterPodAffinity's three checks on the carried term planes, ANDed
// with K1's static_ok; the fit score (Least/Most/RequestedToCapacityRatio)
// and BalancedAllocation; soft PodTopologySpread and the InterPodAffinity
// score over the live feasible set; the taint / node-affinity normalizers
// and _finish_total; the CPython randrange-exact tie draw over the
// max-score nodes in node order; and the winner's adds into used /
// nonzero_used / sel_counts, its domains' carried counts and the IPA planes.
//
// With signature dedup (G > 0) the step is two-tier, as the reference's
// fast branch: K1's outputs are per signature row, and a resident table
// (t_ew, t_ffit, t_feas [G, Nb], t_segs/t_pcs [G, CT, D]) holds the last
// full pass of each signature. A signature whose row is resident replays
// it (gated, with hard spread or IPA, on its feasibility equalling the live
// one over every row) and pays only the spread/IPA re-rank and the draw; a
// fresh or refused one takes the full tier, which installs its row and its
// sig_scores row. After each placement every resident row is patched at
// the winner column: fit score, fit filter and feasibility from the updated
// used row and the signature's own request, and each traced soft slot's
// per-domain tables by the winner's delta. A chained wave seeds the table
// from the previous wave's rows (p.xwave, the cross-wave reuse) in the
// prologue, so its repeat signatures replay from their first step.
//
// What bounds it on an H100: latency. The pods are a serial chain; a step
// is a few dependent block-wide reductions with per-node work between them,
// all on one SM. Layout, built to shorten that chain:
// - The walk covers live nodes only. K2 and K6 walk [0, extent) of their
//   range, where the extent (computed once per launch in the prologue, see
//   live_extent in ops/kernels.py) ends at the last row that any input
//   marks live: valid, nonzero alloc / used / nonzero_used, or a seeded
//   table row feasible there. Past it every node is invalid with zero
//   planes, so the plain version's answer there is fixed: a capture writes
//   the padding constants (ew 0, ffit 1, feas 0; sig_scores stays -1). K5
//   walks the ascending list of its mask's nodes in its range, built once
//   per block (ballot + prefix) in shared memory as uint16 positions
//   relative to the range's start (a block's range is at most 65536
//   slots), at most p.walk of them; node order, and so the tie ballots and
//   the draw, is unchanged.
// - Past the card's largest cluster (scan_plan in ops/kernels.py: 16
//   blocks of 16384 slots on an H100) a block walks its range in p.passes
//   passes of at most SCAN_MAX_SLOTS positions: the pass instance (the PASS
//   flag, NPT 16, in the cluster libraries only). Position i of a block is
//   pass i / (NPT * 1024), then t + 1024 j as in one pass, so walking the
//   passes in order walks the nodes in order, and the tie ballots (one
//   column per pass and owned position, pass-major) and the draw see them
//   in node order: the CPython-exact draw and the words it consumes are
//   those of one pass. The per-position words (the partial-then-whole
//   total, the spread and IPA raw scores and, under MASKED, the node list
//   as int32 by list position) leave shared memory for a device-memory
//   scratch the wrapper allocates on the launch's stream (scan_pass_words,
//   per mask row in K5), read and written only by the owning thread, so no
//   barrier is added; so do each thread's feasibility and reject bits (one
//   word a pass: NPT feasibility bits, then NPT reject bits) and the tie
//   ballots of both parities (each warp also publishes its tie count in
//   shared memory beside its maximum). Each reduction folds a thread's
//   passes into its registers before the block fold (max, min and wrapping
//   int32 sums do not depend on the order), so a step takes the barriers
//   of one pass. A K5 range past SCAN_MAX_RANGE takes the pass instance
//   too (its node list is int32 there). The pass count is a runtime field;
//   one pass of the pass instance is a plan whose positions pass shared
//   memory beside the tables (K5's widest configuration at 16384 slots).
//   Its libraries build one table placement for both: where the plan puts
//   the tables in device memory (p.gtab) the pass instance reaches them
//   through the GTAB scratch at run time, as the GTAB instance does.
// - Thread t of the block's 1024 owns positions t, t + 1024, ..., NPT of
//   them (NPT a template parameter: 8 for up to 8192 node slots, 16 past
//   that; a wider bucket takes a cluster of blocks, the launch plan of
//   scan_plan in ops/kernels.py). A second template flag, GATED, compiles
//   the filter phases (hard
//   spread, inter-pod affinity) only into the instance that runs them.
//   Each pass is an unrolled loop over the owned positions whose loads
//   issue together (the replay pass branches on no loaded value).
//   Feasibility and the reject mask stay in registers as bit masks; the
//   partial total (ew plus the image score, then the whole total) and the
//   spread and IPA raw scores stay in shared memory at the node's position,
//   written and read only by the thread that owns it, so they need no
//   barrier. (An NPT-word register array spilled at the 64 registers a
//   thread of 1024 has, and 512 threads with 128 registers hid the full
//   tier's latency worse.) Nothing goes through device memory between
//   passes.
// - A reduction is one barrier: each warp reduces with __reduce_*_sync,
//   writes its partials to a double-buffered shared array, and after the
//   barrier every warp folds the 32 partials itself (no broadcast barrier,
//   no warp-0 tail). Only the slots a step needs are reduced. The totals
//   pass publishes each warp's maximum and, per owned column, the ballot of
//   its nodes at that maximum; after its one barrier every warp finds the
//   best score, counts the ties and makes the draw (every thread keeps the
//   cursor), and the winner's warp (warp 4) finds the node and makes the
//   winner's row adds while warps 0-3 load the next pod's slots.
// - With few signature rows, a narrow winner row and few selectors the
//   winner's warp also patches the resident rows after a warp barrier,
//   reading the winner's rows from shared memory; else every thread takes
//   patch rows after a block barrier.
// - A replay step whose signature's soft-spread tables are still in shared
//   memory (the previous step's, patched as the table row is patched)
//   keeps them; the filter and score tables are cleared at the end of the
//   step that used them, so no barrier waits on a clear.
// A replay step of SchedulingBasic's wave (whose pods carry the two default
// soft spread constraints) takes four barriers: the pod's slots (after the
// previous step's patch), the normalizers' maxima, the spread scores'
// range, and the totals and draw.
//
// Per-domain sums are int32 atomics (exact; the reference used one-hot
// float matmuls up to 2048 domains and segment_sum past them); the
// hard-spread domain counts [K, D, S] are carried in device memory, built
// once per scan over the valid nodes and bumped at each placement. Carry
// planes are updated in place (the callers' copies).
//
// The domain tables: a slot's tables (soft spread, the pod's IPA terms)
// are D words each, D the widest key's domain count, since the slot's key
// varies by pod; the tables kept per key slot (the existing pods'
// anti-affinity and preferred terms, the hard-spread presence bits) hold
// key k's topo_dk[k] words at topo_off[k] (host-computed offsets), so
// zone, hostname and a rack key of 8192 domains take 8 + 8192 words, not
// 4 x 8192. They live in shared memory (the block's own, or rank 0's under
// ClusterComm) wherever the launch plan (scan_plan in ops/kernels.py) finds
// a block count whose shared memory holds them beside the positions; past
// that (a key of thousands of domains with several slots or IPA terms) the
// GTAB instance keeps them in a device-memory scratch that the wrapper
// allocates on the launch's stream (one set per launch, or per mask row in
// K5), reached through the same pointers: the int32 atomics take a generic
// address, and at these sizes (well under 1 MB) the scratch stays resident
// in L2. GTAB runs under ClusterComm only (a cluster of one block
// included), so its tables follow the cluster's rules: rank 0 clears them,
// every block adds into them, and the cluster barriers that order today's
// DSMEM adds (barrier.cluster.arrive has release and barrier.cluster.wait
// acquire semantics at cluster scope, which the PTX memory model applies to
// every state space, global memory included) order these too.
//
// Node validity is read in one place, node_valid(): with MASKED (K5) the
// walk holds only the mask's nodes, so valid there is valid & mask, the
// placement-narrowed snapshot of the reference's _gang_assign_jit, and
// every participation set follows the mask. K1's static_ok already
// includes valid (and so is read as is on the mask's nodes).
//
// The reduction scope is a template policy, the reference's comm
// (kernels.py:81-131), in comm.cuh (shared with K4 and K7). BlockComm: one
// block owns every node; its domain
// tables live in the block's own shared memory (K2, K5 up to one block's
// slots). ClusterComm (K6; K2 and each K5 row past one block's slots):
// block r of a cluster of n owns the node range [r*Nb/n, (r+1)*Nb/n) of
// every plane and of the signature table's columns, and walks that range's
// live extent only. Each reduction is the block fold, then an exchange of
// the n block results through distributed shared memory after a cluster
// barrier, folded by every warp (max, min or a wrapping int32 sum: the
// result does not depend on the order, and no float32 sum crosses a
// shard). The per-domain tables are one set in rank 0's shared memory that
// every block adds into (DSMEM atomics) and reads; they are reloaded on
// every replay (no kept tables across the cluster). The tie pick exchanges
// each block's best and tie count; every block makes the same draw and the
// block whose prefix range holds it finds its node (under MASKED each block
// walks its own range's mask nodes, and the placement score's walk folds
// over the cluster as an int32 sum). Replicated state has
// one copy: the hard-spread domain counts in device memory and the domain
// presence bits in rank 0's shared memory, the signature table's
// segs/pcs/valid (written by rank 0), the winner's row adds and
// signature-row patch (made by the winner's owner, then a cluster barrier).
// Every branch that contains a barrier is decided from replicated or
// cluster-reduced values, so every block takes it.
#pragma once

#include <type_traits>

#include "comm.cuh"
#include "scoring.cuh"

// the blocks of one scanning cluster at most: 16 is a non-portable cluster
// size (cudaFuncAttributeNonPortableClusterSizeAllowed past 8); whether the
// card holds one is asked once (scan_limits, sharded_assign.cu)
#define SCAN_MAX_BLOCKS 16
// owned positions per thread: 8 (a block's range of up to 8192 node slots)
// or 16 (up to 16384)
#define SCAN_MIN_NPT 8
#define SCAN_MAX_NPT 16
// the positions one pass of a block walks at most
#define SCAN_MAX_SLOTS (SCAN_NT * SCAN_MAX_NPT)
// a block's range of node slots at most under MASKED in one-pass
// instances: their node list holds uint16 positions relative to the
// range's start (the pass instance's holds int32)
#define SCAN_MAX_RANGE 65536

// the smallest power-of-two NPT (from SCAN_MIN_NPT) whose SCAN_NT * NPT
// positions cover `span` node slots, or 0 past SCAN_MAX_NPT
__host__ __device__ inline int scan_npt(int span) {
    int npt = SCAN_MIN_NPT;
    while (npt * SCAN_NT < span) npt *= 2;
    return npt <= SCAN_MAX_NPT ? npt : 0;
}

// the positions a block walks at most, which size its shared memory: its
// range of `span` node slots, or under MASKED the launch's bound on any
// block's mask nodes (p.walk, when set)
__host__ __device__ inline int scan_slots(const ScanParams& p, int span, bool masked) {
    return masked && p.walk > 0 && p.walk < span ? p.walk : span;
}

// whether a scan runs the filter phases (hard spread or inter-pod
// affinity): the GATED instance; the other compiles without them
__host__ __device__ inline bool scan_gated(const ScanParams& p) {
    return p.n_hard > 0 || p.ipa_active;
}

// fn(std::integral_constant<int, NPT>, std::bool_constant<GATED>,
// std::bool_constant<GTAB>, std::bool_constant<PASS>) for the instance
// covering `span` positions with its tables where `gtab` puts them: in a
// pass library (SCAN_PASS_LIB) the pass instance of p.passes > 0 passes
// (NPT 16), which must cover span, its table placement read at run time;
// else the one-pass instance of the smallest NPT; cudaErrorInvalidValue
// past SCAN_MAX_NPT in one pass, or for the other libraries' table
// placement or pass kind (the wrappers' plan never asks for any of them)
template <typename F>
inline int scan_dispatch(int span, bool gated, bool gtab, int passes, F&& fn) {
    constexpr std::bool_constant<SCAN_GTAB_LIB> g{};
    constexpr std::bool_constant<SCAN_PASS_LIB> q{};
    constexpr std::integral_constant<int, SCAN_MAX_NPT> wide{};
    if ((passes > 0) != SCAN_PASS_LIB || (!SCAN_PASS_LIB && gtab != SCAN_GTAB_LIB))
        return (int)cudaErrorInvalidValue;
    if constexpr (SCAN_PASS_LIB) {
        if ((long long)passes * SCAN_MAX_SLOTS < span) return (int)cudaErrorInvalidValue;
        if (gated) return fn(wide, std::true_type{}, g, q);
        return fn(wide, std::false_type{}, g, q);
    } else {
        const int npt = scan_npt(span);
        if (npt == 8 && gated) return fn(std::integral_constant<int, 8>{}, std::true_type{}, g, q);
        if (npt == 8) return fn(std::integral_constant<int, 8>{}, std::false_type{}, g, q);
        if (npt == 16 && gated) return fn(wide, std::true_type{}, g, q);
        if (npt == 16) return fn(wide, std::false_type{}, g, q);
        return (int)cudaErrorInvalidValue;
    }
}

// The domain tables of one scan, in int32 words: the soft spread tables
// (segments then participants, ns tables of D words each), the union of
// the filter phase's tables (the required IPA terms, D words each, then the
// existing pods' anti-affinity per key slot, topo_words in all) and the
// score phase's IPA tables (the preferred terms, then the existing pods'
// preferred terms per key slot), and the domain presence bits of the
// hard-spread carry (topo_words bits). Then a scanning block's dynamic
// shared memory: the staged launch tables (launch_table_words, 0 within
// the parameter block's caps), the tables (but in the GTAB instance, whose
// tables are its scratch's `tables` words), by owned position (`span` of them:
// scan_slots) the partial-then-whole total and the spread and IPA raw
// scores, (MASKED) the mask's node list as uint16 (the pass instance,
// p.passes > 0, keeps these position words in its scratch instead:
// scan_pass_words), the winner's rows after its adds (used, alloc,
// nonzero_used, sel_counts) for the patch, and past 32 key slots the
// matched key masks of the step's two slot buffers (key_words(K) words
// each; one word stays in the static s_flags). ops/kernels.py
// scan_smem_words and scan_table_words mirror it for the launch plan.
struct ScanSmem {
    int lt, soft, uni, present, tables, ew, raw, iraw, list, wrow, keys, words;
};

__host__ __device__ inline ScanSmem scan_smem(const ScanParams& p, int span, bool masked) {
    const int filt = (p.n_ipa_anti + p.n_ipa_aff) * p.D + (p.ex_anti ? p.topo_words : 0);
    const int score = p.n_ipa_pref * p.D + (p.ex_pref_add ? p.topo_words : 0);
    const bool ipa_raw = p.n_ipa_pref > 0 || (p.ipa_active && p.ex_pref);
    const int pos = p.passes > 0 ? 0 : span;  // the position words held here
    ScanSmem s;
    s.lt = launch_table_words(p);
    s.soft = 0;  // the tables' offsets are from their base (dynamic shared
                 // memory past the launch tables, or the GTAB scratch)
    s.uni = s.soft + 2 * p.n_soft * p.D;
    s.present = s.uni + (filt > score ? filt : score);
    s.tables = s.present + (p.dom_carry ? (p.topo_words + 31) / 32 : 0);
    s.ew = s.lt + (p.gtab ? 0 : s.tables);
    s.raw = s.ew + pos;
    s.iraw = s.raw + (p.n_soft > 0 ? pos : 0);
    s.list = s.iraw + (ipa_raw ? pos : 0);
    s.wrow = s.list + (masked ? (pos + 1) / 2 : 0);
    s.keys = s.wrow + 2 * p.R + 2 + p.S;
    s.words = s.keys + (key_words(p.K) > 1 ? 2 * key_words(p.K) : 0);
    return s;
}

__host__ __device__ inline size_t scan_smem_bytes(const ScanParams& p, int span, bool masked) {
    const int w = scan_smem(p, span, masked).words;
    return (size_t)(w > 0 ? w : 1) * sizeof(int);
}

// The pass instance's position scratch (p.passes > 0), in int32 words, for
// a launch of `blocks` blocks over p.Nb node slots (per mask row in K5):
// by node slot the partial-then-whole total, the spread raw score and the
// IPA raw score (3 Nb: a block's position i is at slot lo + i), (MASKED)
// the node list as int32 by list position (Nb, the same indexing), then
// per block each thread's bits per pass (passes x SCAN_NT) and the tie
// ballots of both parities (2 x passes x SCAN_MAX_NPT columns x
// SCAN_NWARPS warps). 0 in one-pass instances. ops/kernels.py
// scan_pass_words mirrors it.
__host__ __device__ inline size_t scan_pass_block_words(const ScanParams& p) {
    return (size_t)p.passes * SCAN_NT + (size_t)2 * p.passes * SCAN_MAX_NPT * SCAN_NWARPS;
}

__host__ __device__ inline size_t scan_pass_words(const ScanParams& p, int blocks, bool masked) {
    if (p.passes <= 0) return 0;
    return (size_t)(masked ? 4 : 3) * p.Nb + (size_t)blocks * scan_pass_block_words(p);
}

// Thread 0's clock, split by step phase (its view of the critical path:
// every thread meets it at the barriers): the slots barrier, the filter
// phases and table setup, A's node pass, A's fold, B, C's node pass with
// the tie publication and its barrier, the pick and draw, and the step's
// end (adds, clears, the patch barrier and the patch). Read through the
// sync counts' output.
#define SCAN_PHASES 8
#define SCAN_SYNC_WORDS (5 + SCAN_PHASES)

struct ScanArgs {
    const int* alloc;
    const int* domain;
    const uint8_t* valid;
    const uint8_t* mask;  // [Nb] placement mask (MASKED only)
    const uint8_t* static_ok;
    const int* taint_cnt;
    const int* aff_raw;
    const int* img;
    const uint8_t* aff_has_pref;
    const int* feats;
    const unsigned* tie_words;
    const float* logtab;
    int* used;  // the carry, updated in place
    int* nonzero_used;
    int* sel_counts;
    int* ipa_counts;
    int* ipa_anti;
    int* ipa_pref;
    const int* ipa_term_key;
    int* dom_counts;  // [K, D, S] with dom_carry
    int* tables;      // the GTAB instance's domain tables (scan_smem's words)
    int* winners;     // [P]
    // signature dedup (G > 0) only
    const int* sig_ids;
    const int* uniq_idx;
    uint8_t* t_valid;
    int* t_ew;
    uint8_t* t_ffit;
    uint8_t* t_feas;
    int* t_segs;
    int* t_pcs;
    int* sig_scores;
    // the tie cursor's start in device memory (K2 of a chained wave: the
    // predecessor's final cursor, its packed[P_prev]); nullptr: p.cursor0
    const int* cursor_init;
    // cross-wave reuse (p.xwave): slot map [G] into the previous wave's
    // table of p.G_prev rows, which seeds t_* in the prologue
    const int* carry_map;
    const int* prev_ew;
    const uint8_t* prev_ffit;
    const uint8_t* prev_feas;
    const int* prev_segs;
    const int* prev_pcs;
    int* syncs;  // [5] the counted synchronisations (nullptr: not wanted)
    const int* lt;  // the launch tables past the parameter block (common.cuh)
    int* pos;  // the pass instance's position scratch (scan_pass_words)
};

// ScanArgs from K2's and K6's pointer list: alloc, domain, valid,
// static_ok, taint_cnt, aff_raw, img, aff_has_pref, feats, tie_words,
// logtab, used, nonzero_used, sel_counts, ipa_counts, ipa_anti, ipa_pref,
// ipa_term_key, dom_counts, out, then with dedup sig_ids, uniq_idx,
// t_valid, t_ew, t_ffit, t_feas, t_segs, t_pcs, sig_scores, tiers (0
// without), then the device cursor (0: the host's p->cursor0), then with
// p->xwave carry_map and the previous table's ew, ffit, feas, segs, pcs (0
// without), then the sync counts [5] (0: not wanted), the GTAB scratch
// (K6's launcher reads it: sharded_assign.cu), then the launch tables (0
// within the parameter block's), then the pass instance's position scratch
// (0 in one pass)
inline ScanArgs scan_args(void* const* ptrs) {
    ScanArgs a = {};
    a.alloc = (const int*)ptrs[0];
    a.domain = (const int*)ptrs[1];
    a.valid = (const uint8_t*)ptrs[2];
    a.mask = nullptr;
    a.static_ok = (const uint8_t*)ptrs[3];
    a.taint_cnt = (const int*)ptrs[4];
    a.aff_raw = (const int*)ptrs[5];
    a.img = (const int*)ptrs[6];
    a.aff_has_pref = (const uint8_t*)ptrs[7];
    a.feats = (const int*)ptrs[8];
    a.tie_words = (const unsigned*)ptrs[9];
    a.logtab = (const float*)ptrs[10];
    a.used = (int*)ptrs[11];
    a.nonzero_used = (int*)ptrs[12];
    a.sel_counts = (int*)ptrs[13];
    a.ipa_counts = (int*)ptrs[14];
    a.ipa_anti = (int*)ptrs[15];
    a.ipa_pref = (int*)ptrs[16];
    a.ipa_term_key = (const int*)ptrs[17];
    a.dom_counts = (int*)ptrs[18];
    a.winners = (int*)ptrs[19];
    a.sig_ids = (const int*)ptrs[20];
    a.uniq_idx = (const int*)ptrs[21];
    a.t_valid = (uint8_t*)ptrs[22];
    a.t_ew = (int*)ptrs[23];
    a.t_ffit = (uint8_t*)ptrs[24];
    a.t_feas = (uint8_t*)ptrs[25];
    a.t_segs = (int*)ptrs[26];
    a.t_pcs = (int*)ptrs[27];
    a.sig_scores = (int*)ptrs[28];
    a.cursor_init = (const int*)ptrs[30];
    a.carry_map = (const int*)ptrs[31];
    a.prev_ew = (const int*)ptrs[32];
    a.prev_ffit = (const uint8_t*)ptrs[33];
    a.prev_feas = (const uint8_t*)ptrs[34];
    a.prev_segs = (const int*)ptrs[35];
    a.prev_pcs = (const int*)ptrs[36];
    a.syncs = (int*)ptrs[37];
    a.lt = (const int*)ptrs[39];
    a.pos = (int*)ptrs[40];
    return a;
}

// meaningful in thread 0: the tie words consumed up to the cursor, whether a
// draw ran out of words, with dedup the steps by tier, and the counted
// synchronisations
struct ScanEnd {
    int cursor, overflow, n_full, n_replay;
    int walked;  // positions walked: the live extent, or the mask list's length
    int truncated;  // MASKED: the range held more mask nodes than the list's slots
    ScanSyncs syncs;
    const long long* phase_cycles;  // [SCAN_PHASES], shared (thread 0's)
};

// the counts [5] of a scan, for the latency floor, then its phases'
// thousands of SM clock cycles [SCAN_PHASES] (dst may be null)
__device__ __forceinline__ void write_syncs(int* dst, const ScanSyncs& s,
                                            const long long* phase_cycles) {
    if (dst == nullptr) return;
    dst[0] = s.bar;
    dst[1] = s.fold;
    dst[2] = s.csync;
    dst[3] = s.xch;
    dst[4] = s.pick;
    for (int k = 0; k < SCAN_PHASES; ++k) dst[5 + k] = (int)(phase_cycles[k] / 1000);
}

template <bool MASKED, int NPT, bool GATED, bool GTAB, bool PASS, typename Comm>
__device__ __forceinline__ ScanEnd scan_block(const ScanParams& p, const ScanArgs& a,
                                              Comm& comm) {
    static_assert(NPT >= 1 && NPT <= SCAN_MAX_NPT, "owned positions per thread");
    static_assert(!GTAB || Comm::kCluster, "device-memory tables run under ClusterComm");
    static_assert(!PASS || NPT == SCAN_MAX_NPT, "the pass instance owns 16 positions a pass");
    static_assert(!PASS || (Comm::kCluster && !GTAB), "the pass instance reads p.gtab");
    static_assert(2 * SCAN_MAX_NPT <= 32, "a pass's feasibility and reject bits share a word");
    // K2 and K5 keep a replay's soft tables across steps; K6 reloads them
    constexpr bool kKeep = !Comm::kCluster;
    extern __shared__ int dyn[];
    __shared__ Slot s_hard[2][SCAN_MAX_SOFT], s_soft[2][SCAN_MAX_SOFT];
    __shared__ Slot s_anti[2][MAX_REQ_TERMS], s_aff[2][MAX_REQ_TERMS], s_pref[2][MAX_PREF_TERMS];
    __shared__ int s_flags[2][3];  // any soft slot on, any hard slot on, IPA key mask
    __shared__ int ndom_keep[SCAN_MAX_SOFT];  // kept tables' domains with pcs > 0
    __shared__ unsigned pick_s[2][SCAN_NWARPS][NPT + 1];  // per warp: max, ballots
    __shared__ long long clock_s[SCAN_PHASES + 1];  // phase cycles, then the last mark
    __shared__ int win_s;  // the winner, from its warp to every thread (block patch)

    const int* __restrict__ alloc = a.alloc;
    const int* __restrict__ domain = a.domain;
    const uint8_t* __restrict__ static_ok = a.static_ok;
    const int* __restrict__ taint_cnt = a.taint_cnt;
    const int* __restrict__ aff_raw = a.aff_raw;
    const int* __restrict__ img = a.img;
    const int* __restrict__ feats = a.feats;
    const unsigned* __restrict__ tie_words = a.tie_words;
    const float* __restrict__ logtab = a.logtab;
    const int* __restrict__ ipa_term_key = a.ipa_term_key;
    int* used = a.used;
    int* nonzero_used = a.nonzero_used;
    int* sel_counts = a.sel_counts;
    int* ipa_counts = a.ipa_counts;
    int* ipa_anti = a.ipa_anti;
    int* ipa_pref = a.ipa_pref;
    int* dom_counts = a.dom_counts;
    int* out = a.winners;
    const int* __restrict__ sig_ids = a.sig_ids;
    const int* __restrict__ uniq_idx = a.uniq_idx;
    uint8_t* t_valid = a.t_valid;
    int* t_ew = a.t_ew;
    uint8_t* t_ffit = a.t_ffit;
    uint8_t* t_feas = a.t_feas;
    int* t_segs = a.t_segs;
    int* t_pcs = a.t_pcs;
    int* sig_scores = a.sig_scores;

    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int Nb = p.Nb, D = p.D, S = p.S, K = p.K;
    // this block's node range (the whole axis but under ClusterComm), the
    // positions it walks at most, and whether it writes the replicated state
    const int lo = comm.lo, span = comm.hi - comm.lo;
    const int slots = scan_slots(p, span, MASKED);
    // (at the card level: rank 0 of card 0, whose device memory holds it)
    const bool lead = comm.lead();
    const int nh = p.n_hard, ns = p.n_soft;
    const int na = p.n_ipa_anti, nfa = p.n_ipa_aff, np = p.n_ipa_pref;
    const bool dedup = p.G > 0;
    // GATED equals scan_gated(p) (the launchers dispatch on it)
    const bool gated = GATED;
    const bool ipa_act = GATED && p.ipa_active;
    const bool ipa_on = GATED && (np > 0 || (p.ipa_active && p.ex_pref));  // the IPA score
    const bool ipa_acc = GATED && (np > 0 || (p.ipa_active && p.ex_pref_add));  // its tables
    const bool dom_carry = GATED && p.dom_carry;
    const ScanSmem lay = scan_smem(p, slots, MASKED);
    // the launch tables past the parameter block, staged before the
    // prologue's first barrier (every read of them comes after it)
    if (lay.lt) stage_launch_tables(a.lt, lay.lt);
    // the union of the filter and score IPA tables (scan_smem)
    const int union_words = lay.present - lay.uni;
    // the domain tables every block adds into: the scratch (GTAB, or the
    // pass instance where the plan puts them in device memory), else
    // shared memory (rank 0's under ClusterComm)
    const bool gtab = GTAB || (PASS && p.gtab != 0);
    int* tabs = gtab ? a.tables : comm.tables(dyn + lay.lt);
    int* soft_t = tabs + lay.soft;
    int* uni_t = tabs + lay.uni;
    unsigned* present = reinterpret_cast<unsigned*>(gtab ? a.tables + lay.present
                                                         : comm.tables(dyn + lay.lt + lay.present));
    // passes of PS positions (one outside the pass instance): position i
    // of the block is pass i / PS, then j * SCAN_NT + t within it
    constexpr int PS = NPT * SCAN_NT;
    const int npass = PASS ? p.passes : 1;
    // ew plus the image score, then the total, by owned position, and the
    // spread and IPA raw scores: in shared memory, or (the pass instance)
    // at the position's node slot in the scratch. Each thread reads and
    // writes only its own positions, so neither needs a barrier
    int* ew_s = PASS ? a.pos + lo : dyn + lay.ew;
    int* raw_s = PASS ? a.pos + (size_t)Nb + lo : dyn + lay.raw;
    int* iraw_s = PASS ? a.pos + (size_t)2 * Nb + lo : dyn + lay.iraw;
    unsigned short* list = reinterpret_cast<unsigned short*>(dyn + lay.list);
    // the pass instance's node list (int32, relative to lo), this block's
    // bits by pass and thread, and its tie ballots [parity][column][warp]
    int* list32 = PASS && MASKED ? a.pos + (size_t)3 * Nb + lo : nullptr;
    unsigned* bits_g =
        PASS ? reinterpret_cast<unsigned*>(a.pos + (size_t)(MASKED ? 4 : 3) * Nb
                                           + (size_t)comm.rank() * scan_pass_block_words(p))
             : nullptr;
    unsigned* pk_g = PASS ? bits_g + (size_t)npass * SCAN_NT : nullptr;
    const int ncol = npass * NPT;  // tie ballot columns a warp publishes
    // a pass's bits (NPT feasibility bits, then NPT reject bits): the
    // register `reg` in one pass, the scratch word of (pass, thread) in the
    // pass instance
    auto load_bits = [&](int ps, unsigned reg) -> unsigned {
        if constexpr (PASS) return bits_g[(size_t)ps * SCAN_NT + tid];
        else return reg;
    };
    auto store_bits = [&](int ps, unsigned& reg, unsigned v) {
        if constexpr (PASS) bits_g[(size_t)ps * SCAN_NT + tid] = v;
        else reg = v;
    };
    // the winner's rows after its adds, read by the patch after a barrier
    int* w_used = dyn + lay.wrow;
    int* w_alloc = w_used + p.R;
    int* w_nz = w_alloc + p.R;
    int* w_sel = w_nz + 2;

    auto seg = [&](int c) { return soft_t + (size_t)c * D; };
    auto pcs = [&](int c) { return soft_t + (size_t)(ns + c) * D; };
    auto node_at = [&](int i) -> int {
        if constexpr (MASKED && PASS) return lo + list32[i];
        else if constexpr (MASKED) return lo + (int)list[i];
        else return lo + i;
    };
    // the one place the scan reads node validity (see the header comment)
    auto node_valid = [&](int n) -> bool { return a.valid[n] != 0; };
    auto present_at = [&](int w) -> bool { return (present[w >> 5] >> (w & 31)) & 1u; };

    // the words [a, b) of an n-word table pass (clear, reload, install)
    // this block makes: rank 0's all of them where the tables are its
    // shared memory; in the scratch each block its share of it
    auto share = [&](size_t n, size_t& a, size_t& b) {
        if constexpr (Comm::kCluster) {  // the scratch is cluster-only
            if (gtab) {
                // at the card level the scratch is the home card's, and
                // only that card's blocks clear and install it
                if (!comm.home()) {
                    a = b = 0;
                    return;
                }
                const size_t per = (n + comm.nb - 1) / comm.nb;
                a = min(n, (size_t)comm.r * per);
                b = min(n, a + per);
                return;
            }
        }
        a = 0;
        b = lead ? n : 0;
    };
    auto clear_words = [&](int* t, size_t n) {
        size_t a, b;
        share(n, a, b);
        for (size_t i = a + tid; i < b; i += SCAN_NT) t[i] = 0;
    };
    ScanEnd end = {0, 0, 0, 0, 0, 0, {0, 0, 0, 0, 0}, clock_s};  // tiers counted in thread 0
    // thread 0 books the cycles since its last mark to phase k
    auto mark = [&](int k) {
        if (tid == 0) {
            const long long now = clock64();
            clock_s[k] += now - clock_s[SCAN_PHASES];
            clock_s[SCAN_PHASES] = now;
        }
    };
    if (tid == 0) {
        for (int k = 0; k < SCAN_PHASES; ++k) clock_s[k] = 0;
    }
    // every thread keeps the cursor: every warp makes the same draws
    int cursor = (a.cursor_init ? a.cursor_init[0] : p.cursor0) - p.frame_shift;
    int overflow = 0, truncated = 0;

    // prologue: the nodes this block walks. MASKED: the ascending list of
    // the mask's nodes in the range, relative to lo (each warp a contiguous
    // run of 32-node words, counted, prefix-summed and written in order; the
    // plan bounds a block's mask nodes by slots from the caller's
    // population, and a list never writes past them: a range holding more
    // is reported as truncated, never walked in part unseen). Else the live
    // extent of the range
    // (see the header comment), with the cross-wave seed of the signature
    // table first, since a seeded feasible column counts as live.
    int last = -1;
    if (dedup && p.xwave) {
        // slot g copies row carry_map[g] of the previous wave's table where
        // it is >= 0, else starts zeroed and invalid; every entry is written
        const size_t row_words = (size_t)p.CT * D;
        for (size_t i = tid; i < (size_t)p.G * span; i += SCAN_NT) {
            const int g = (int)(i / span), c = (int)(i % span), n = lo + c;
            const int m = a.carry_map[g];
            const size_t o = (size_t)clampi(m, 0, p.G_prev - 1) * Nb + n;
            const size_t t = (size_t)g * Nb + n;
            const bool ok = m >= 0;
            const uint8_t fe = ok ? a.prev_feas[o] : 0;
            t_ew[t] = ok ? a.prev_ew[o] : 0;
            t_ffit[t] = ok ? a.prev_ffit[o] : 0;
            t_feas[t] = fe;
            if (fe) last = max(last, c);
        }
        if (lead) {
            for (size_t i = tid; i < (size_t)p.G * row_words; i += SCAN_NT) {
                const int g = (int)(i / row_words);
                const int m = a.carry_map[g];
                const size_t o = (size_t)clampi(m, 0, p.G_prev - 1) * row_words + i % row_words;
                const bool ok = m >= 0;
                t_segs[i] = ok ? a.prev_segs[o] : 0;
                t_pcs[i] = ok ? a.prev_pcs[o] : 0;
            }
            for (int g = tid; g < p.G; g += SCAN_NT) t_valid[g] = a.carry_map[g] >= 0;
        }
    }
    int cnt;
    if constexpr (MASKED) {
        const int words = (span + 31) / 32;
        const int per = (words + SCAN_NWARPS - 1) / SCAN_NWARPS;
        const int w0 = min(wid * per, words), w1 = min(w0 + per, words);
        int c = 0;
        for (int w = w0; w < w1; ++w) {
            const int n = w * 32 + lane;
            c += __popc(__ballot_sync(FULL_MASK, n < span && a.mask[lo + n] != 0));
        }
        int v[1] = {c};
        // the warps' counts: each warp's base is the sum over warps before it
        int (*red)[SCAN_RED] = comm.red[comm.par];
        if (lane == 0) red[wid][0] = c;
        __syncthreads();
        comm.par ^= 1;
        const int mine = lane < SCAN_NWARPS ? red[lane][0] : 0;
        int base = (int)__reduce_add_sync(FULL_MASK, (unsigned)(lane < wid ? mine : 0));
        v[0] = (int)__reduce_add_sync(FULL_MASK, (unsigned)mine);
        for (int w = w0; w < w1; ++w) {
            const int n = w * 32 + lane;
            const bool in = n < span && a.mask[lo + n] != 0;
            const unsigned b = __ballot_sync(FULL_MASK, in);
            const int at = base + __popc(b & ((1u << lane) - 1u));
            if (in && at < slots) {
                if constexpr (PASS) list32[at] = n;
                else list[at] = (unsigned short)n;
            }
            base += __popc(b);
        }
        cnt = min(v[0], slots);
        truncated = v[0] > slots;
        tick(comm.n->fold);
    } else {
        for (int ps = 0; ps < npass; ++ps) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
                const int i = ps * PS + j * SCAN_NT + tid;
                if (i >= span) continue;
                const int n = lo + i;
                bool live = a.valid[n] != 0;
                const int* a_row = alloc + (size_t)n * p.R;
                const int* u_row = used + (size_t)n * p.R;
                for (int r = 0; r < p.R; ++r) live |= (a_row[r] | u_row[r]) != 0;
                live |= (nonzero_used[(size_t)n * 2] | nonzero_used[(size_t)n * 2 + 1]) != 0;
                if (live) last = max(last, i);
            }
        }
        int v[1] = {last};
        comm.template reduce_local<1>(v, 1u, 0u);
        cnt = v[0] + 1;
    }

    // prologue: the tables start cleared; with the hard-spread carry, per
    // key slot and domain the sum of sel_counts over the domain's valid
    // nodes, and the domains' presence bits
    clear_words(tabs, lay.tables);
    if (dom_carry) clear_words(dom_counts, (size_t)K * D * S);
    if (tid < SCAN_MAX_SOFT) ndom_keep[tid] = 0;
    comm.sync();
    if (dom_carry) {
        for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
#pragma unroll 4
            for (int j = 0; j < NPT; ++j) {
                const int i = ps * PS + j * SCAN_NT + tid;
                if (i >= cnt) continue;
                const int n = node_at(i);
                if (!node_valid(n)) continue;
                for (int k = 0; k < K; ++k) {
                    const int dk = topo_dk_at(p, k), d = domain[(size_t)n * K + k];
                    if (dk == 0 || d < 0) continue;
                    const int dc = clampi(d, 0, dk - 1);
                    const int bit = topo_off_at(p, k) + dc;
                    atomicOr(&present[bit >> 5], 1u << (bit & 31));
                    for (int s = 0; s < S; ++s)
                        atomicAdd(&dom_counts[((size_t)k * D + dc) * S + s],
                                  sel_counts[(size_t)n * S + s]);
                }
            }
        }
        comm.sync();
    }

    // which soft tables shared memory holds: row tab_sid of the signature
    // table, patched with it (-1: none); whether the soft and the union
    // tables are known to be clear
    int tab_sid = -1;
    bool soft_clear = true, union_clear = true;
    int pick_par = 0;
    // the matched key mask of slot buffer b: s_flags[b][2] up to 32 key
    // slots, past them key_words(K) words of dynamic shared memory
    const int kw = key_words(K);
    auto key_mask = [&](int b) -> unsigned* {
        return kw > 1 ? reinterpret_cast<unsigned*>(dyn + lay.keys) + b * kw
                      : reinterpret_cast<unsigned*>(&s_flags[b][2]);
    };
    // pod q's slots into buffer q & 1, by warps 0-3 side by side (the next
    // barrier publishes them)
    auto load_slots = [&](int q) {
        const int* fq = feats + (size_t)q * p.F;
        const int b = q & 1;
        if (wid == 0) {
            pod_slots(p, fq, ipa_term_key, ipa_act, s_hard[b], s_soft[b], s_anti[b],
                      s_aff[b], s_pref[b]);
        } else if (wid == 1) {
            const bool anys = any_column(fq, p.f_soft_active, p.MC);
            if (lane == 0) s_flags[b][0] = anys;
        } else if (wid == 2) {
            // a hard slot is on iff traced (n_hard <= 4) and active
            const bool anyh = any_column(fq, p.f_hard_active, min(nh, p.MC));
            if (lane == 0) s_flags[b][1] = anyh;
        } else if (wid == 3) {
            unsigned* km = key_mask(b);
            if (ipa_act) {
                matched_key_mask(p, fq, ipa_term_key, km);
            } else if (lane == 0) {
                for (int w = 0; w < kw; ++w) km[w] = 0;
            }
        }
    };
    // what the previous step loaded ahead for pod `ahead`: its slots, its
    // signature row and whether that row is resident
    int ahead = -1, ahead_sid = 0;
    bool ahead_res = false;
    // The winner's warp: warp 4 finds the winner and makes its adds, while
    // warps 0-3 load the next pod's slots. With few rows, a narrow winner
    // row and few selectors it also patches, after a warp barrier; else
    // every thread takes patch rows after a block barrier. my_g is this
    // thread's first patch row (its features read once, up front).
    constexpr int kWinWarp = 4;
    const bool warp_patch = dedup && p.G <= 32 && p.R <= 32 && S <= 32;
    const int my_g = warp_patch ? (wid == kWinWarp && lane < p.G ? lane : -1)
                                : (tid < p.G ? tid : -1);
    const int* my_fg = my_g >= 0 ? feats + (size_t)clampi(uniq_idx[my_g], 0, p.P - 1) * p.F
                                 : feats;

    // The winner-column patch of every resident signature row, winner pw
    // (placed by the pod whose features are pf), rows g0, g0 + gstep, ...:
    // fit score, fit filter and feasibility from the winner's rows after
    // its adds (shared memory) and the signature's own request, and each
    // traced soft slot's per-domain tables by the winner's delta
    auto patch_rows = [&](int pw, const int* pf, int g0, int gstep) {
        const int* a_row = w_alloc;
        const int* u_row = w_used;
        const int* nz_row = w_nz;
        const int win = pw;
        const int* f = pf;
        const bool v0 = my_g >= 0 && t_valid[my_g] != 0;
        const size_t o0 = (size_t)(my_g >= 0 ? my_g : 0) * Nb + win;
        const bool st0 = v0 && static_ok[o0] != 0;
        const bool fo0 = v0 && t_feas[o0] != 0;
        for (int g = g0; g < p.G; g += gstep) {
            const bool first = g == my_g;
            if (!(first ? v0 : t_valid[g] != 0)) continue;
            const int* fg =
                first ? my_fg : feats + (size_t)clampi(uniq_idx[g], 0, p.P - 1) * p.F;
            const int ew_w = wadd(wmul(fit_score(p, a_row, u_row, nz_row, fg), p.w_fit),
                                  wmul(balanced_score(p, a_row, u_row, nz_row, fg), p.w_bal));
            bool ffit_w = too_many_pods(a_row, u_row);
            for (int r = 0; r < p.R; ++r)
                ffit_w |= fit_insufficient(r, fg[p.f_req + r], a_row[r], u_row[r]);
            const size_t o = (size_t)g * Nb + win;
            const bool feas_w = (first ? st0 : static_ok[o] != 0) && !ffit_w;
            const bool feas_old = first ? fo0 : t_feas[o] != 0;
            t_ew[o] = ew_w;
            t_ffit[o] = ffit_w;
            t_feas[o] = feas_w;
            // every traced soft slot, active or not (as the reference);
            // the kept copy in shared memory takes the same delta. The
            // slots' keys and domains are read first, all at once.
            int keyv[SCAN_MAX_SOFT], dv[SCAN_MAX_SOFT];
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c)
                keyv[c] = c < ns ? fg[p.f_soft_key + c] : -1;
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                const int key = keyv[c];
                const bool ok = key >= 0 && key < K && topo_dk_at(p, key) != 0;
                dv[c] = ok ? domain[(size_t)win * K + key] : -1;
            }
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                const int d = dv[c];
                if (d < 0) continue;
                const int sel = clampi(fg[p.f_soft_sel + c], 0, S - 1);
                const int cnt_new = w_sel[sel];
                const int cnt_old = cnt_new - f[p.f_sig_match + sel];
                const int dd = min(d, D - 1);
                const size_t to = ((size_t)g * p.CT + c) * D + dd;
                const int dseg = (feas_w ? cnt_new : 0) - (feas_old ? cnt_old : 0);
                const int dpcs = (int)feas_w - (int)feas_old;
                t_segs[to] += dseg;
                t_pcs[to] += dpcs;
                if (kKeep && g == tab_sid) {
                    const int before = pcs(c)[dd];
                    seg(c)[dd] += dseg;
                    pcs(c)[dd] = before + dpcs;
                    ndom_keep[c] += (int)(before + dpcs > 0) - (int)(before > 0);
                }
            }
        }
    };

    for (int pod = 0; pod < p.P; ++pod) {
        const int* f = feats + (size_t)pod * p.F;
        const bool active = f[p.f_active] != 0;
        // without dedup an inactive pad slot is skipped: it places nothing
        // and draws nothing; with dedup it is its own signature and still
        // takes its tier (table row and sig_scores row)
        if (!dedup && !active) {
            if (lead && tid == 0) comm.store_out(out, pod, -1);
            continue;
        }
        const int buf = pod & 1;
        if (tid == 0) clock_s[SCAN_PHASES] = clock64();
        const Slot* hard = s_hard[buf];
        const Slot* soft = s_soft[buf];
        const bool was_ahead = ahead == pod;
        // the static row and residency (the table's valid flags change only
        // at a capture, before an earlier step's last barrier)
        const int sid = !dedup ? pod : (was_ahead ? ahead_sid : clampi(sig_ids[pod], 0, p.G - 1));
        const size_t srow = (size_t)sid * Nb;
        const bool resident = dedup && (was_ahead ? ahead_res : t_valid[sid] != 0);
        // the pod's slots, the key slots its matching terms use
        if (!was_ahead) load_slots(pod);
        // the next pod's signature and whether its row is resident now (a
        // capture in this step can only add this step's row), read early
        const int nxt = pod + 1;
        const int nxt_sid = dedup && nxt < p.P ? clampi(sig_ids[nxt], 0, p.G - 1) : nxt;
        const bool nxt_valid = dedup && nxt < p.P && t_valid[nxt_sid] != 0;
        // this step's first tie word per lane, loaded ahead of the draw
        const unsigned tw = tie_words[clampi(cursor + lane, 0, p.L - 1)];
        // the slots; the previous step's adds, patch and table clears
        comm.sync();
        mark(0);
        const bool any_soft = s_flags[buf][0] != 0, any_hard = s_flags[buf][1] != 0;
        const bool has_fail = GATED && (any_hard || p.ipa_active);
        const Ipa ipa = {s_anti[buf], s_aff[buf], s_pref[buf], na, nfa, np, key_mask(buf)[0],
                         lay.keys + buf * kw, D, uni_t, uni_t, ipa_counts, ipa_anti, ipa_pref,
                         ipa_term_key};

        // F. statistics over the valid nodes (PreFilter participation): the
        // hard slots' min counts, the required IPA terms' domain sums and
        // "anywhere" flags, the existing pods' anti-affinity per key slot,
        // into the union tables (clear: the previous step cleared them)
        int hmin[SCAN_MAX_SOFT] = {0, 0, 0, 0};
        int aff_any[MAX_REQ_TERMS] = {0, 0, 0, 0};
        if (has_fail) {
            if (!union_clear) {
                clear_words(uni_t, union_words);
                comm.sync();
            }
            union_clear = false;
            int v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = i < 4 ? SCAN_BIG : 0;
            if (dom_carry) {  // a non-singleton key: over the present domains
#pragma unroll
                for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                    if (c >= nh) continue;
                    const Slot s = hard[c];
                    if (!s.on || s.dk == 0) continue;
                    for (int d = tid; d < s.dk; d += SCAN_NT) {
                        if (present_at(topo_off_at(p, s.key) + d))
                            v[c] = min(v[c], dom_counts[((size_t)s.key * D + d) * S + s.col]);
                    }
                }
            }
            for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    if (i >= cnt) continue;
                    const int n = node_at(i);
                    if (!node_valid(n)) continue;
                    const int* dom_row = domain + (size_t)n * K;
#pragma unroll
                    for (int c = 0; c < SCAN_MAX_SOFT; ++c) {  // a singleton key: over the nodes
                        if (c >= nh) continue;
                        const Slot s = hard[c];
                        if (s.on && s.dk == 0 && dom_at(dom_row, s) >= 0)
                            v[c] = min(v[c], sel_counts[(size_t)n * S + s.col]);
                    }
                    if (ipa_act) ipa_filter_stats(p, ipa, f, n, dom_row, v + 4);
                }
            }
            comm.template reduce<8>(v, 0xF0u, 0x0Fu);
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) hmin[c] = v[c] == SCAN_BIG ? 0 : v[c];
#pragma unroll
            for (int s = 0; s < MAX_REQ_TERMS; ++s) aff_any[s] = v[4 + s];
        }

        // G. the live reject mask (hard spread, IPA) and, for a resident
        // signature under hard spread or IPA, the replay gate: the row's
        // feasibility must equal the live one on every node row
        const bool check = gated && resident;
        unsigned fail_bits = 0;  // the one pass's reject bits (at bit NPT + j)
        int refused = 0;
        if (has_fail || check) {
            int mismatch = 0;
            for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
                unsigned fb = 0;
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    if (i >= cnt) continue;
                    const int n = node_at(i);
                    bool fail = false;
                    if (has_fail) {
                        const int* dom_row = domain + (size_t)n * K;
                        for (int c = 0; c < nh && !fail; ++c) {
                            const Slot s = hard[c];
                            if (!s.on) continue;
                            const int d = dom_at(dom_row, s);
                            if (d < 0) {
                                fail = true;  // the node lacks the key
                                break;
                            }
                            const size_t dc = ((size_t)s.key * D + clampi(d, 0, D - 1)) * S;
                            const int count = s.dk == 0 ? sel_counts[(size_t)n * S + s.col]
                                                        : dom_counts[dc + s.col];
                            fail = count + s.b - hmin[c] > s.a;
                        }
                        if (!fail && ipa_act) {
                            bool i1, i2, i3;
                            ipa_filters_at(p, ipa, f, n, node_valid(n), dom_row, aff_any, i1, i2,
                                           i3);
                            fail = i1 || i2 || i3;
                        }
                        fb |= (unsigned)fail << (NPT + j);
                    }
                    if (check) {
                        const size_t o = srow + n;
                        const bool live = static_ok[o] && !t_ffit[o] && !fail;
                        mismatch |= live != (t_feas[o] != 0);
                    }
                }
                if (has_fail) store_bits(ps, fail_bits, fb);
            }
            // one barrier: the gate, and the filter tables' last read
            refused = comm.sync_or(mismatch);
        }
        const bool replay = resident && !refused;
        const bool capture = dedup && !replay;

        // the soft tables: kept (a replay of the row shared memory holds),
        // reloaded from the row (a replay, read after A's barrier), or
        // accumulated by the full tier (every traced slot when capturing);
        // the IPA score tables accumulate into the cleared union
        const bool kept = kKeep && replay && tab_sid == sid;
        const bool reload = replay && !kept && ns > 0;
        const bool acc_soft = !replay && ns > 0 && (capture || any_soft);
        const bool clear_soft = acc_soft && !soft_clear;
        const bool clear_union = ipa_acc && !union_clear;
        int nd_load[SCAN_MAX_SOFT] = {0, 0, 0, 0};
        if (clear_soft) clear_words(soft_t, (size_t)2 * ns * D);
        if (clear_union) clear_words(uni_t, union_words);
        if (reload) {
            size_t a, b;
            share((size_t)2 * ns * D, a, b);
            for (int i = (int)a + tid; i < (int)b; i += SCAN_NT) {
                const int c = (i / D) % ns;
                const int val = (i < ns * D ? t_segs : t_pcs)[((size_t)sid * p.CT + c) * D + i % D];
                soft_t[i] = val;
                // a replay's domain count: the table's entries with pcs > 0
                // (each block counts its words; the cluster's fold sums them)
                if (i >= ns * D && val > 0) {
#pragma unroll
                    for (int q = 0; q < SCAN_MAX_SOFT; ++q) nd_load[q] += q == c;
                }
            }
        }
        if (clear_soft || clear_union) comm.sync();
        soft_clear = soft_clear && !acc_soft && !reload;
        union_clear = union_clear && !ipa_acc;
        if (dedup) tab_sid = (capture || replay) ? sid : -1;
        if (!dedup) tab_sid = -1;

        mark(1);
        // A. feasibility, fit + balanced, the static normalizers' maxima and
        // the feasible-set statistics (soft spread per domain, accumulated
        // by the full tier; the preferred IPA terms)
        const bool has_pref = a.aff_has_pref[sid] != 0;
        const bool pts_on = ns > 0 && any_soft;
        unsigned fe_bits = 0;  // the one pass's feasibility bits (at bit j)
        // max taint count, max aff raw, the singleton slots' domain counts,
        // the other slots' first participants (or a reload's counts)
        int w[SCAN_RED] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < SCAN_MAX_SOFT; ++q) w[6 + q] = nd_load[q];
        // the signature's rows, for 32-bit indexing by node
        const int* tc_row = taint_cnt + srow;
        const int* af_row = aff_raw + srow;
        const int* img_row = img + srow;
        if (replay) {  // the table row: the tight pass of a replay step
            // no branch waits on a loaded value, so every owned position's
            // loads are in flight together (the maxima start at 0, so an
            // infeasible node's 0 leaves them as they are)
            for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
                unsigned fbits = 0;
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    if (i >= cnt) continue;
                    const int n = node_at(i);
                    const int tc = __ldg(tc_row + n), im = __ldg(img_row + n);
                    const bool fe = t_feas[srow + n] != 0;
                    // the total's parts that no normalizer scales (int32 sums
                    // wrap, so their order does not change the total)
                    ew_s[i] = wadd(t_ew[srow + n], wmul(im, p.w_img));
                    fbits |= (unsigned)fe << j;
                    w[0] = max(w[0], fe ? tc : 0);
                    if (has_pref) w[1] = max(w[1], fe ? __ldg(af_row + n) : 0);
                    if (pts_on) {
                        const int* dom_row = domain + (size_t)n * K;
#pragma unroll
                        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                            if (c >= ns) continue;
                            const Slot s = soft[c];
                            w[2 + c] += fe && s.on && s.dk == 0 && dom_at(dom_row, s) >= 0;
                        }
                    }
                    if (ipa_acc && fe) ipa_score_stats(p, ipa, f, n, domain + (size_t)n * K);
                }
                store_bits(ps, fe_bits, fbits);
            }
        } else {
            for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
                // this pass's reject bits (from G; none without a filter phase)
                const unsigned fb = has_fail ? load_bits(ps, fail_bits) >> NPT : 0u;
                unsigned fbits = 0;
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    if (i >= cnt) continue;
                    const int n = node_at(i);
                    const size_t o = srow + n;
                    const int tc = __ldg(tc_row + n), af = __ldg(af_row + n);
                    const int im = __ldg(img_row + n);
                    const int* a_row = alloc + (size_t)n * p.R;
                    const int* u_row = used + (size_t)n * p.R;
                    bool ffit = too_many_pods(a_row, u_row);
                    for (int r = 0; r < p.R; ++r)
                        ffit |= fit_insufficient(r, f[p.f_req + r], a_row[r], u_row[r]);
                    const bool fe = static_ok[o] && !ffit && !((fb >> j) & 1u);
                    int ew = 0;
                    if (fe || capture) {  // the table row holds ew on every row
                        const int* nz_row = nonzero_used + (size_t)n * 2;
                        ew = wadd(wmul(fit_score(p, a_row, u_row, nz_row, f), p.w_fit),
                                  wmul(balanced_score(p, a_row, u_row, nz_row, f), p.w_bal));
                    }
                    if (capture) {
                        t_ew[o] = ew;
                        t_ffit[o] = ffit;
                        t_feas[o] = fe;
                    }
                    ew_s[i] = wadd(ew, wmul(im, p.w_img));
                    fbits |= (unsigned)fe << j;
                    if (!fe) continue;
                    w[0] = max(w[0], tc);
                    w[1] = max(w[1], af);
                    if (pts_on || acc_soft) {
                        const int* dom_row = domain + (size_t)n * K;
#pragma unroll
                        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                            if (c >= ns) continue;
                            const Slot s = soft[c];
                            const int d = dom_at(dom_row, s);
                            if (d < 0) continue;
                            if (s.dk == 0) {
                                if (s.on) w[2 + c] += 1;
                            } else if (acc_soft && (s.on || capture)) {
                                // the full tier captures every traced slot's tables
                                const int dc = clampi(d, 0, s.dk - 1);
                                atomicAdd(&seg(c)[dc], sel_counts[(size_t)n * S + s.col]);
                                if (atomicAdd(&pcs(c)[dc], 1) == 0) w[6 + c] += 1;
                            }
                        }
                    }
                    if (ipa_acc) ipa_score_stats(p, ipa, f, n, domain + (size_t)n * K);
                }
                store_bits(ps, fe_bits, fbits);
            }
        }
        // the padding constants of a captured row past the walk
        if (capture && !MASKED) {
            for (int i = cnt + tid; i < span; i += SCAN_NT) {
                const size_t o = srow + lo + i;
                t_ew[o] = 0;
                t_ffit[o] = 1;
                t_feas[o] = 0;
            }
        }
        mark(2);
        const bool need_nd = pts_on || capture || reload;
        if (need_nd) comm.template reduce<SCAN_RED>(w, 0x3u, 0u);
        else {
            int w2[2] = {w[0], w[1]};
            comm.template reduce<2>(w2, 0x3u, 0u);
            w[0] = w2[0];
            w[1] = w2[1];
        }
        const int maxtc = w[0], maxaff = w[1];
        // each soft slot's domains with a participant: kept, or counted now
        int nd[SCAN_MAX_SOFT];
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) nd[c] = kept ? ndom_keep[c] : w[6 + c];
        if (kKeep && (capture || reload) && tid == 0) {
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) ndom_keep[c] = w[6 + c];
        }
        if (capture) {  // install the signature's spread tables, then the row
            size_t a, b;
            share((size_t)p.CT * D, a, b);
            for (int i = (int)a + tid; i < (int)b; i += SCAN_NT) {
                const int c = i / D, d = i % D;
                const bool on = c < ns && soft[c].dk > 0;
                t_segs[(size_t)sid * p.CT * D + i] = on ? seg(c)[d] : 0;
                t_pcs[(size_t)sid * p.CT * D + i] = on ? pcs(c)[d] : 0;
            }
            if (lead && tid == 0) t_valid[sid] = 1;
        }
        // the soft slots' log weights: a singleton key's domains counted in
        // A, another key's domains with a participant
        float wlog[SCAN_MAX_SOFT];
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            const bool on = c < ns && soft[c].on;
            wlog[c] = on ? logtab[soft[c].dk == 0 ? w[2 + c] : nd[c]] : 0.0f;
        }

        mark(3);
        // B. the spread and IPA raw scores, their max/min over the feasible set
        int mm[4] = {-SCAN_BIG, SCAN_BIG, -SCAN_BIG, SCAN_BIG};  // spread max, min, IPA max, min
        if (pts_on || ipa_on) {
            for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
                const unsigned fbits = load_bits(ps, fe_bits);
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    if (i >= cnt || !((fbits >> j) & 1u)) continue;
                    const int n = node_at(i);
                    const int* dom_row = domain + (size_t)n * K;
                    if (pts_on) {
                        float cost = 0.0f;
#pragma unroll
                        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                            if (c >= ns) continue;
                            const Slot s = soft[c];
                            const int d = dom_at(dom_row, s);
                            if (!s.on || d < 0) continue;  // the reference adds +0.0
                            // a replay gathers as _pts_score_carried: clip to D
                            const int count = s.dk == 0
                                                  ? sel_counts[(size_t)n * S + s.col]
                                                  : seg(c)[clampi(d, 0, (replay ? D : s.dk) - 1)];
                            cost = __fadd_rn(cost, __fmul_rn(__int2float_rn(count), wlog[c]));
                        }
                        const int raw = __float2int_rz(cost);
                        raw_s[i] = raw;
                        mm[0] = max(mm[0], raw);
                        mm[1] = min(mm[1], raw);
                    }
                    if (ipa_on) {
                        const int raw = ipa_raw_at(p, ipa, f, n, true, dom_row);
                        iraw_s[i] = raw;
                        mm[2] = max(mm[2], raw);
                        mm[3] = min(mm[3], raw);
                    }
                }
            }
            if (pts_on && ipa_on) {
                comm.template reduce<4>(mm, 0x5u, 0xAu);
            } else {
                int m2[2] = {mm[pts_on ? 0 : 2], mm[pts_on ? 1 : 3]};
                comm.template reduce<2>(m2, 0x1u, 0x2u);
                mm[pts_on ? 0 : 2] = m2[0];
                mm[pts_on ? 1 : 3] = m2[1];
            }
        }

        mark(4);
        // C. weighted total; the full tier exports the signature's
        // feasibility-gated score row. Each warp publishes its best total
        // and, per owned column, the ballot of its nodes at that best.
        int lmax = -SCAN_BIG - 1;
        for (int ps = 0; ps < npass && ps * PS < cnt; ++ps) {
            const unsigned fbits = load_bits(ps, fe_bits);
#pragma unroll 4
            for (int j = 0; j < NPT; ++j) {
                const int i = ps * PS + j * SCAN_NT + tid;
                if (i >= cnt) continue;
                const int n = node_at(i);
                const size_t o = srow + n;
                if (!((fbits >> j) & 1u)) {
                    if (capture) sig_scores[o] = -1;
                    continue;
                }
                const int pts = pts_on ? pts_normalized(raw_s[i], mm[0], mm[1]) : 0;
                const int taint = maxtc > 0 ? taint_normalized(__ldg(tc_row + n), maxtc)
                                            : MAX_NODE_SCORE;
                const int aff_s = has_pref ? affinity_normalized(__ldg(af_row + n), maxaff) : 0;
                int total = wadd(wadd(ew_s[i], wmul(pts, p.w_pts)),
                                 wadd(wmul(taint, p.w_taint), wmul(aff_s, p.w_aff)));
                if (ipa_on)
                    total = wadd(total, wmul(ipa_normalized(iraw_s[i], mm[2], mm[3]), p.w_ipa));
                ew_s[i] = total;
                if (capture) sig_scores[o] = total;
                lmax = max(lmax, total);
            }
        }
        const int wmax = __reduce_max_sync(FULL_MASK, lmax);
        unsigned (*pk)[NPT + 1] = pick_s[pick_par];
        // the pass instance's ballots of this parity, [column][warp]
        unsigned* pkg = PASS ? pk_g + (size_t)pick_par * ncol * SCAN_NWARPS : nullptr;
        if constexpr (PASS) {
            // every column, pass-major, and the warp's tie count beside its
            // maximum (every warp's loop runs every pass: the ballots are
            // warp-wide)
            int tcount = 0;
            for (int ps = 0; ps < npass; ++ps) {
                const unsigned fbits = ps * PS < cnt ? load_bits(ps, 0u) : 0u;
#pragma unroll 4
                for (int j = 0; j < NPT; ++j) {
                    const int i = ps * PS + j * SCAN_NT + tid;
                    const bool tie = i < cnt && ((fbits >> j) & 1u) && ew_s[i] == wmax;
                    const unsigned b = __ballot_sync(FULL_MASK, tie);
                    tcount += __popc(b);
                    if (lane == 0) pkg[(size_t)(ps * NPT + j) * SCAN_NWARPS + wid] = b;
                }
            }
            if (lane == 0) pk[wid][1] = (unsigned)tcount;
        } else {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
                const int i = j * SCAN_NT + tid;
                const bool tie = i < cnt && ((fe_bits >> j) & 1u) && ew_s[i] == wmax;
                const unsigned b = __ballot_sync(FULL_MASK, tie);
                if (lane == 0) pk[wid][1 + j] = b;
            }
        }
        if (lane == 0) pk[wid][0] = (unsigned)wmax;
        tick(comm.n->pick);
        __syncthreads();
        pick_par ^= 1;
        mark(5);
        // every warp: this block's best and its ties (lane l reads warp l's)
        const bool has_w = lane < SCAN_NWARPS;
        const int wm_l = has_w ? (int)pk[lane][0] : -SCAN_BIG - 1;
        const int bb = __reduce_max_sync(FULL_MASK, wm_l);
        int mine = 0;
        if constexpr (PASS) {
            mine = has_w ? (int)pk[lane][1] : 0;
        } else {
#pragma unroll
            for (int j = 0; j < NPT; ++j) mine += has_w ? __popc(pk[lane][1 + j]) : 0;
        }
        const int bc = (int)__reduce_add_sync(FULL_MASK, (unsigned)(wm_l == bb ? mine : 0));
        int best, nw, prefix;
        comm.pick(bb, bc, best, nw, prefix);
        best = max(best, -1);
        if (tid == 0 && dedup) (replay ? end.n_replay : end.n_full) += 1;
        int win = -1;
        const bool placed = best >= 0 && active;
        if (placed) {
            // CPython randrange(nw): k = nw.bit_length(), the top k bits of
            // successive 32-bit words, reject r >= nw (at most 16 words)
            int r_final = 0;
            if (nw > 1) {
                const int k = 32 - __clz(nw);
                const unsigned r = tw >> (32 - k);
                const unsigned acc =
                    __ballot_sync(FULL_MASK, lane < MAX_TIE_DRAWS && r < (unsigned)nw);
                if (acc) {
                    const int first = __ffs(acc) - 1;
                    r_final = (int)__shfl_sync(FULL_MASK, r, first);
                    cursor += first + 1;
                } else {
                    cursor += MAX_TIE_DRAWS;
                    overflow = 1;
                }
            }
            // the owned column, then the warp, then the bit of tie r_final
            // (of this block: minus the ties of the blocks before it)
            const int r_loc = r_final - prefix;
            if (wid == kWinWarp && bb == best && r_loc >= 0 && r_loc < bc) {
                int accn = 0, jstar = -1, rem = 0, c_sel = 0;
                unsigned b_sel = 0;
                if constexpr (PASS) {
                    // the columns in node order until the one holding the
                    // tie (a warp-uniform exit: t and accn are reduced)
                    for (int col = 0; col < ncol; ++col) {
                        const unsigned b = has_w && wm_l == bb
                                               ? pkg[(size_t)col * SCAN_NWARPS + lane] : 0u;
                        const int c = __popc(b);
                        const int t = (int)__reduce_add_sync(FULL_MASK, (unsigned)c);
                        if (r_loc < accn + t) {
                            jstar = col;
                            rem = r_loc - accn;
                            c_sel = c;
                            b_sel = b;
                            break;
                        }
                        accn += t;
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < NPT; ++j) {
                        const unsigned b = has_w && wm_l == bb ? pk[lane][1 + j] : 0u;
                        const int c = __popc(b);
                        const int t = (int)__reduce_add_sync(FULL_MASK, (unsigned)c);
                        if (jstar < 0 && r_loc < accn + t) {
                            jstar = j;
                            rem = r_loc - accn;
                            c_sel = c;
                            b_sel = b;
                        }
                        accn += t;
                    }
                }
                int incl = c_sel;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const int o2 = __shfl_up_sync(FULL_MASK, incl, off);
                    if (lane >= off) incl += o2;
                }
                const int excl = incl - c_sel;
                const unsigned own = __ballot_sync(FULL_MASK, rem >= excl && rem < incl);
                const int lstar = __ffs(own) - 1;
                int node = -1;
                if (lane == lstar) {
                    unsigned bits = b_sel;
                    for (int q = 0; q < rem - excl; ++q) bits &= bits - 1;
                    node = node_at(jstar * SCAN_NT + lstar * 32 + __ffs(bits) - 1);
                }
                win = __shfl_sync(FULL_MASK, node, lstar);
                if (lane == 0) comm.store_out(out, pod, win);
            }
        } else if (lead && tid == 0) {  // nothing feasible, or a pad slot
            comm.store_out(out, pod, -1);
        }

        mark(6);
        // the end of the step: the winner's row adds (by the winner's warp of
        // the block that owns it), with copies of the winner's rows for the
        // patch; the next pod's slots (warps 0-3, published by the next
        // step's first barrier)
        if (wid == kWinWarp && win >= 0) {
            for (int r = lane; r < p.R; r += 32) {
                const size_t o = (size_t)win * p.R + r;
                const int v = used[o] + f[p.f_req + r];
                used[o] = v;
                w_used[r] = v;
                w_alloc[r] = alloc[o];
            }
            if (lane < 2) {
                const int v = nonzero_used[(size_t)win * 2 + lane] + f[p.f_nz_req + lane];
                nonzero_used[(size_t)win * 2 + lane] = v;
                w_nz[lane] = v;
            }
            for (int s = lane; s < S; s += 32) {
                const int v = sel_counts[(size_t)win * S + s] + f[p.f_sig_match + s];
                sel_counts[(size_t)win * S + s] = v;
                w_sel[s] = v;
            }
            if (dom_carry) {
                for (int i = lane; i < K * S; i += 32) {
                    const int k = i / S, s = i % S, d = domain[(size_t)win * K + k];
                    if (topo_dk_at(p, k) > 0 && d >= 0 && d < D)
                        dom_counts[((size_t)k * D + d) * S + s] += f[p.f_sig_match + s];
                }
            }
            if (ipa_act) {
                for (int t = lane; t < p.Ta; t += 32) {
                    const size_t o = (size_t)win * p.Ta + t;
                    ipa_counts[o] += f[p.f_ipa_match + t];
                    ipa_anti[o] += f[p.f_ipa_anti_add + t];
                    ipa_pref[o] += f[p.f_ipa_pref_add + t];
                }
            }
        }
        if (nxt < p.P) load_slots(nxt);
        // the next pod, loaded ahead: its slots, row and residency
        if (nxt < p.P) {
            ahead = nxt;
            ahead_sid = nxt_sid;
            ahead_res = nxt_valid || (capture && nxt_sid == sid);
        }
        // nobody reads the tables past C's barrier: clear the union for the
        // next step's filter phase, and the soft tables when the next step
        // is surely a full tier (no dedup, or its signature not resident)
        if (GATED) {
            clear_words(uni_t, union_words);
            union_clear = true;
        }
        if (ns > 0 && nxt < p.P && !ahead_res && !soft_clear) {
            clear_words(soft_t, (size_t)2 * ns * D);
            soft_clear = true;
            tab_sid = -1;
        }
        if (dedup) {
            if (warp_patch) {  // the winner's warp made the rows: a warp barrier
                if (wid == kWinWarp && win >= 0) {
                    __syncwarp();
                    patch_rows(win, f, lane, SCAN_NT);
                }
            } else {  // the winner from its warp, and the rows, to every thread
                if (wid == kWinWarp && lane == 0) win_s = win;
                tick(comm.n->bar);
                __syncthreads();
                win = win_s;
                if (win >= 0) patch_rows(win, f, tid, SCAN_NT);
            }
        }
        mark(7);
    }
    end.cursor = cursor;
    end.overflow = overflow;
    end.walked = cnt;
    end.truncated = truncated;
    end.syncs = *comm.n;
    return end;
}
