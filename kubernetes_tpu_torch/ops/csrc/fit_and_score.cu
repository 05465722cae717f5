// K4 fit_and_score — replaces _fit_and_score_jit of the reference package
// (kubernetes_tpu/ops/kernels.py:754 -> filter_masks :442 and scores :731,
// with the helpers _pts_domain_stats :198, _domain_sum_at_node :303,
// _ipa_term_stats :328, _ipa_filters :347, _ipa_score :396 and the
// normalizers :590-627).
//
// What it computes, for each pod of a [P, F] packed feature buffer against
// every node row: the filter rows (NodeUnschedulable, NodeName, taints,
// node affinity + pin, ports, NodeResourcesFit, then per constraint slot
// the hard PodTopologySpread missing-key and skew rows, then the three
// InterPodAffinity checks), feasible, the per-resource insufficient rows and
// too_many_pods; the seven plugin scores on every row (infeasible and pad
// rows included, unmasked, as the reference returns them) and the weighted
// total, -1 where infeasible. The outputs go into one packed buffer per pod
// (bytes, then int32) so the caller makes one device-to-host copy.
//
// What bounds it on an H100: latency and instruction issue, not bytes. One
// pod moves about 1 MB at 8192 node rows (a fraction of a microsecond at
// 3.35 TB/s). The work is a dependent chain over the node axis: domain
// statistics over the valid nodes (A), the filters and feasible (B), domain
// statistics over the feasible nodes (C), the spread and IPA raw scores
// and their range (D), the normalized scores and the total (E), with a
// cross-node reduction between each step. The design before this one ran
// the chain in one block of one SM, ~8 node rows per thread in each of
// five passes: the per-node filter and score formulas (integer floor
// divisions, IEEE float32 division and square root, chains of dependent
// loads) on one SM's issue slots held it (thread 0's clock on an H100 at
// 700 W: B 27 us and E 22 us of 83).
//
// Design: one pod is a thread-block cluster of C blocks of FIT_NT = 512
// threads (C = 1, 2, 4, 8 or 16; the wrapper's constant, 16, measured).
// - The node axis is cut by the live extent (one past the last valid row,
//   which every block finds in the prologue from `valid`): block r owns
//   [r * extent / C, (r + 1) * extent / C) and a contiguous share of the
//   padding rows past the extent, ceil(Nb / C) rows in all, so every block
//   walks live rows once the extent reaches C (fit_partition in
//   ops/kernels.py states the same split). Padding rows get every output; they join no
//   reduction, being invalid.
// - Thread t owns positions t, t + NT, ... of its block's rows, NPT of them
//   in registers (a template parameter: 1, 2 or 4, chosen for ceil(Nb / C)
//   rows). Its per-node state (feasible as a bit, the partial weighted
//   total, the taint count and node-affinity raw, then the spread and IPA
//   raws) stays in registers from B to E; nothing the kernel wrote is read
//   back. Positions past NPT * NT (a bucket past the instance) keep the
//   same state in the output rows instead: every bucket runs. A warp whose
//   positions all lie past the block's rows skips the pass.
// - The pod's feature row and the node-plane rows of the register
//   positions are copied into shared memory (cp.async) while the prologue
//   and A run, so the formulas' chains of dependent reads (a row, the
//   feature column it selects, a table) cost shared-memory latency, not L2
//   round trips.
// - A, B + C (fused: the score tables beside the filter tables in shared
//   memory, when both fit), D and E are one pass each; fit, balanced and
//   image scores, which need no reduction, are made in B.
// - Each block keeps its per-domain tables in its own shared memory, built
//   with warp-aggregated adds (WarpAdd, scoring.cuh: one atomic per
//   distinct domain per warp). After the exchange's cluster barrier each
//   block sums every block's words into a second copy over distributed
//   shared memory (ClusterComm::fold_words, comm.cuh; large tables fold
//   in place by slices), so each block reads whole tables locally. Maxima,
//   minima and counts fold as K6 folds them: a one-barrier block fold,
//   then one exchange, which warp 0 gathers for the block (a read of the
//   peers by every warp took up to 16 us at 16 blocks on an H100).
// - Passes and reductions the pod does not use are skipped (no hard or IPA
//   filter term: no A; no soft spread or IPA score term: no D fold); the
//   hard minima and soft domain counts fold per warp, with no barrier. The
//   branches read only the pod's features, which every block of the
//   cluster reads alike, so no block skips a cluster barrier another block
//   waits at.
// Every cross-node reduction is an int32 max, min or sum, so the outputs
// are the same bit for bit for every C; the float32 spread cost never
// crosses nodes. The slots and the InterPodAffinity passes are
// scoring.cuh's, shared with K2; numerics as there.
//
// K7 wave_fit_and_score — replaces _wave_fit_and_score_jit of the
// reference package (kubernetes_tpu/parallel/mesh.py:262), the vmap over
// pods of filter_masks + scores: the pods x nodes feasibility and total
// matrix against one snapshot, no assumes between the pods. It is this
// kernel's device code with FULL = false, on P pods x C blocks of 1024
// threads (C = 1, the wrapper's constant: one block per pod under
// BlockComm; 2 or 4 measured slower), one register position per thread,
// writing only feasible [P, Nb] and total [P, Nb] (-1 where infeasible);
// rows past the registers keep their state in feasible, total and a
// [P, 2, Nb] scratch (a register array past one position spilled at 64
// registers a thread). Bound as K4 per pod, with many pods in flight at
// once: the card is full at one block per pod.
//
// fit_floor_kernel, beside them, is the latency floor of one such launch:
// the counts of block barriers, folds, cluster barriers, exchanges and
// table folds (with their words) that the kernel reports, with no node
// work.
#include "comm.cuh"

#define N_PLUGINS 7
#define FIT_COUNTS 6
#define FIT_PHASES 12
#define FIT_MAX_CLUSTER 16
// K4's block: half the scan's, so that at 16 blocks a pod of 8192 rows has
// one position per thread and every thread's share of the redundant work
// (slots, layout, partition) issues from half as many warps; K7 keeps the
// scan's 1024 threads
#define FIT_NT 512
// the score tables sit beside the filter tables (B and C in one pass) when
// both fit in this much shared memory; else they share its start
#define FIT_FUSED_SMEM (160 * 1024)
// the node rows of the register positions are staged in shared memory when
// everything fits in this much
#define FIT_STAGE_SMEM (200 * 1024)

// returned by the launcher when one pod's cluster cannot be resident
#define FIT_CLUSTER_DOES_NOT_FIT (-2)

struct FitArgs {
    const int* alloc;
    const int* used;
    const int* nonzero_used;
    const uint8_t* valid;
    const uint8_t* unsched;
    const int* group_id;
    const int* taints;
    const int* prefer_taints;
    const int* domain;
    const int* sel_counts;
    const int* port_words;
    const int* image_kib;
    const int* ipa_counts;
    const int* ipa_anti;
    const int* ipa_pref;
    const int* ipa_term_key;
    const uint8_t* aff_match;
    const int* aff_pref;
    const uint8_t* aff_allow;
    const uint8_t* aff_has_pref;
    const int* feats;
    const float* logtab;
    uint8_t* out;       // K4: [P, per_pod] packed outputs
    uint8_t* feas_out;  // K7: [P, Nb]
    int* total_out;     // K7: [P, Nb]
    int* raw_out;       // K7: [P, 2, Nb] state of positions past the registers
    int* syncs;         // [FIT_COUNTS + FIT_PHASES] or nullptr
    int* tables;        // GTAB: [P, fit_smem().tables] the pods' domain tables
    const int* lt;      // the launch tables past the parameter block (common.cuh)
    CardLink link;      // the card level (CardComm instances only)
};

// the in-card part of a kernel's reduction scope (a card-level policy's
// card fields are set by the kernel)
__device__ __forceinline__ void init_comm(BlockComm& c, int, int, int (*red)[SCAN_NWARPS][SCAN_RED],
                                          int*, ScanSyncs* s) {
    c = {0, 0, red, 0, s};
}
__device__ __forceinline__ void init_comm(ClusterComm& c, int r, int C,
                                          int (*red)[SCAN_NWARPS][SCAN_RED], int* xch,
                                          ScanSyncs* s) {
    c = {0, 0, r, C, red, 0, xch, 0, s};
}

// The dynamic shared memory of one block, in int32 words: the staged
// launch tables (launch_table_words, 0 within the parameter block's caps;
// the offsets below but feat's onwards are from the tables' base past
// them), the filter
// tables (the hard slots' selector sums and participants and the required
// IPA terms, D words each, then the existing pods' anti-affinity per key
// slot, key k's topo_dk[k] words at topo_off[k]) and the score tables (the
// soft slots' sums and participants, the preferred terms, the existing
// pods' preferred terms per key slot), side by side when fused; the folded
// copies a cluster reads when its fold gathers (small tables; else the
// tables fold in place); the pod's feature row; past 32 key slots the
// matched key mask (key_words(K) words; one word stays in the static
// exmask_s); then, when it fits, the
// rows of the node planes at the thread's register positions (alloc, used,
// nonzero_used, group_id, taints, prefer_taints, port_words, image_kib,
// domain, sel_counts: `row` words each), copied in while A runs. In the
// GTAB instance (tables past shared memory: fit_gtab in ops/kernels.py)
// the tables are one set per pod in a device-memory scratch, `tables`
// words, fused and read where every block of the cluster added into them
// (no copies, no fold), and shared memory starts at the feature row.
struct FitSmem {
    int lt, filt_words, score_words, score, rfilt, rscore, tables, feat, keys, row, stage,
        words;
    bool fused, staged;
};

__host__ __device__ inline FitSmem fit_smem(const FitParams& p, int npt, int nt) {
    FitSmem s;
    s.lt = launch_table_words(p);
    s.filt_words = (2 * p.n_hard + p.n_ipa_anti + p.n_ipa_aff) * p.D +
                   (p.ex_anti ? p.topo_words : 0);
    s.score_words = (2 * p.n_soft + p.n_ipa_pref) * p.D + (p.ex_pref_add ? p.topo_words : 0);
    s.fused = p.gtab || (size_t)(s.filt_words + s.score_words) * sizeof(int) <= FIT_FUSED_SMEM;
    s.score = s.fused ? s.filt_words : 0;
    s.tables = s.fused ? s.filt_words + s.score_words
                       : (s.filt_words > s.score_words ? s.filt_words : s.score_words);
    int end = p.gtab ? 0 : s.tables;
    s.rfilt = 0;
    if (!p.gtab && s.fused && ClusterComm::gathers(s.filt_words, p.cluster)) {
        s.rfilt = end;
        end += s.filt_words;
    }
    s.rscore = s.score;
    if (!p.gtab && s.fused && ClusterComm::gathers(s.score_words, p.cluster)) {
        s.rscore = end;
        end += s.score_words;
    }
    s.feat = s.lt + end;
    s.keys = s.feat + p.F;
    s.stage = s.keys + (key_words(p.K) > 1 ? key_words(p.K) : 0);
    s.row = 2 * p.R + 3 + p.T + p.Tp + p.W + p.I + p.K + p.S;
    const long long staged = (long long)s.stage + (long long)s.row * npt * nt;
    s.staged = staged * (long long)sizeof(int) <= FIT_STAGE_SMEM;
    s.words = s.staged ? (int)staged : s.stage;
    if (s.words < 1) s.words = 1;
    return s;
}

// n words from global to shared memory, asynchronously (cp.async; the
// thread waits for its own copies with cp.async.wait_all)
__device__ __forceinline__ void copy_async(int* dst, const int* src, int n) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    for (int i = 0; i < n; ++i)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i), "l"(src + i)
                     : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one node's plane rows: in shared memory at a staged register position,
// else in device memory
struct FitRows {
    const int *alloc, *used, *nz, *taints, *prefer, *ports, *image, *dom, *sel;
    int gid;
};

// one past the last valid row of [0, Nb): this thread's part (rows it
// reads 8 at a time where `valid` is 8-byte aligned)
__device__ __forceinline__ int extent_part(const uint8_t* valid, int Nb) {
    int e = 0, n0 = 0;
    if ((reinterpret_cast<uintptr_t>(valid) & 7) == 0) {
        const unsigned long long* v8 = reinterpret_cast<const unsigned long long*>(valid);
        for (int i = threadIdx.x; i < Nb / 8; i += blockDim.x) {
            const unsigned long long x = v8[i];
            if (x) e = 8 * i + (63 - __clzll((long long)x)) / 8 + 1;
        }
        n0 = Nb / 8 * 8;
    }
    for (int n = n0 + threadIdx.x; n < Nb; n += blockDim.x) {
        if (valid[n]) e = n + 1;
    }
    return e;
}

// thread 0's clock: cycles since the last mark into phase k (pod 0, rank 0)
struct FitClock {
    long long* c;  // shared [FIT_PHASES + 1]: the phases, then the last mark
    bool on;
    __device__ void mark(int k) {
        if (on) {
            const long long now = clock64();
            c[k] += now - c[FIT_PHASES];
            c[FIT_PHASES] = now;
        }
    }
};

// one node position's state between passes: the partial weighted total,
// then x/y = the taint count and node-affinity raw (B to D), then the
// spread and IPA raws (D to E)
struct FitNode {
    int pt, x, y;
};

template <bool FULL, int NT, int NPT, bool GTAB, class Comm>
__global__ void __launch_bounds__(NT, 1) fit_and_score_kernel(FitParams p, FitArgs a) {
    extern __shared__ int pool[];
    __shared__ Slot hard[SCAN_MAX_SOFT], soft[SCAN_MAX_SOFT];
    __shared__ Slot anti[MAX_REQ_TERMS], aff[MAX_REQ_TERMS], pref[MAX_PREF_TERMS];
    __shared__ unsigned exmask_s;  // the matched key mask up to 32 key slots
    __shared__ int any_soft_s;
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int xch[3 * SCAN_RED];
    __shared__ ScanSyncs syncs;
    __shared__ long long clk[FIT_PHASES + 1];
    // the card level's result slots, link and dead flag (CardComm only)
    __shared__ int cres[2][SCAN_RED];
    __shared__ CardLink lk;
    __shared__ int dead;

    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int Nb = p.Nb, D = p.D;
    int r = 0, C = 1, pod = blockIdx.x;
    if constexpr (Comm::kCluster) {
        cg::cluster_group cl = cg::this_cluster();
        r = (int)cl.block_rank();
        C = (int)cl.num_blocks();
        pod = blockIdx.x / C;
    }
    Comm comm{};
    init_comm(comm, r, C, red, xch, &syncs);
    if constexpr (Comm::kCards) {
        if (tid == 0) {
            lk = a.link;
            dead = 0;
        }
        comm.link = &lk;
        comm.group = pod;
        comm.k = 0;
        comm.cres = cres;
        comm.cpar = 0;
        comm.dead = &dead;
    }
    FitClock timer = {clk, tid == 0 && pod == 0 && r == 0};
    if (tid == 0) {
        syncs = {0, 0, 0, 0, 0, 0, 0};
        for (int k = 0; k < FIT_PHASES; ++k) clk[k] = 0;
        clk[FIT_PHASES] = clock64();
    }
    if constexpr (Comm::kCards) __syncthreads();  // the link before any card exchange

    const int* fg = a.feats + (size_t)pod * p.F;  // the pod's feature row
    // FULL (K4): one packed buffer per pod. Else (K7): feasible and total
    // rows of the matrix, two scratch rows
    const long long per_pod =
        (long long)(p.NF + p.R + 2) * Nb + (long long)(1 + N_PLUGINS) * Nb * 4;
    uint8_t* fails = FULL ? a.out + (size_t)pod * per_pod : nullptr;
    uint8_t* feas = FULL ? fails + (size_t)p.NF * Nb : a.feas_out + (size_t)pod * Nb;
    uint8_t* insuf = FULL ? feas + Nb : nullptr;
    uint8_t* toomany = FULL ? insuf + (size_t)p.R * Nb : nullptr;
    int* total = FULL ? reinterpret_cast<int*>(toomany + Nb) : a.total_out + (size_t)pod * Nb;
    int* per = FULL ? total + Nb : nullptr;  // row j = PLUGIN_NAMES[j]
    // where a position past the registers keeps x and y
    int* sx = FULL ? per + (size_t)4 * Nb : a.raw_out + (size_t)pod * 2 * Nb;
    int* sy = FULL ? per + (size_t)5 * Nb : a.raw_out + (size_t)pod * 2 * Nb + Nb;

    const int nh = p.n_hard, ns = p.n_soft;
    const int na = p.n_ipa_anti, nfa = p.n_ipa_aff, np = p.n_ipa_pref;
    const FitSmem lay = fit_smem(p, NPT, NT);
    // the launch tables past the parameter block, staged before warp 0
    // resolves the pod's slots
    if (lay.lt) {
        stage_launch_tables(a.lt, lay.lt);
        __syncthreads();
    }
    // the tables this block adds into, and the folded ones it reads: the
    // pod's set in the scratch (GTAB: every block adds into it and reads
    // it), else this block's own in shared memory
    int* tabs = GTAB ? a.tables + (size_t)pod * lay.tables : pool + lay.lt;
    int* filt = tabs;
    int* score = tabs + lay.score;
    int* rfilt = tabs + lay.rfilt;
    int* rscore = tabs + lay.rscore;
    auto hcnt = [&](int c) { return rfilt + (size_t)c * D; };
    auto hpcs = [&](int c) { return rfilt + (size_t)(nh + c) * D; };
    auto scnt = [&](int c) { return rscore + (size_t)c * D; };
    auto spcs = [&](int c) { return rscore + (size_t)(ns + c) * D; };

    // the prologue: the pod's slots (warp 0) and key mask (warp 1) from
    // device memory while its feature row is copied in, the tables
    // cleared, the live extent; one fold publishes them all
    int* fsm = pool + lay.feat;
    unsigned* km = key_words(p.K) > 1 ? reinterpret_cast<unsigned*>(pool + lay.keys) : &exmask_s;
    for (int i = tid; i < p.F; i += NT) copy_async(fsm + i, fg + i, 1);
    if (wid == 0) {
        pod_slots(p, fg, a.ipa_term_key, true, hard, soft, anti, aff, pref);
    } else if (wid == 1) {
        const bool anys = any_column(fg, p.f_soft_active, p.MC);
        matched_key_mask(p, fg, a.ipa_term_key, km);
        if (lane == 0) any_soft_s = anys;
    }
    const int table_words = lay.fused ? lay.filt_words + lay.score_words : lay.filt_words;
    if (GTAB && comm.home()) {  // the pod's set (card 0's at the card level), each block a slice
        const int per = (table_words + C - 1) / C;
        for (int i = r * per + tid; i < min(table_words, (r + 1) * per); i += NT) tabs[i] = 0;
    } else {
        for (int i = tid; i < table_words; i += NT) tabs[i] = 0;
    }
    int ev[1] = {extent_part(a.valid, Nb)};
    copy_async_wait();
    comm.template reduce_local<1>(ev, 1u, 0u);
    // GTAB: every block's clears before any block's adds
    if (GTAB) comm.sync();
    const int E = ev[0];
    const int* f = fsm;  // from here on, the feature row in shared memory
    const Ipa ipa = {anti, aff, pref, na, nfa, np, km[0], lay.keys, D, rfilt + (size_t)2 * nh * D,
                     rscore + (size_t)2 * ns * D, a.ipa_counts, a.ipa_anti, a.ipa_pref,
                     a.ipa_term_key};
    Ipa ipa_add = ipa;  // where the IPA passes add
    ipa_add.filt = filt + (size_t)2 * nh * D;
    ipa_add.score = score + (size_t)2 * ns * D;
    // this block's rows: [lo, hi) of the live extent, then [plo, phi) of
    // the padding (fit_partition in ops/kernels.py)
    const int q = (Nb + C - 1) / C;
    const int lo = (int)((long long)r * E / C), hi = (int)((long long)(r + 1) * E / C);
    const int plo = E + min(r * q - lo, Nb - E), phi = E + min((r + 1) * q - hi, Nb - E);
    const int nlive = hi - lo, span = nlive + (phi - plo);
    auto node_at = [&](int j) { return j < nlive ? lo + j : plo + (j - nlive); };
    const int ovf = NPT * NT;  // the first position past the registers

    // the plane rows of this thread's register positions into shared
    // memory (each thread reads only its own: no barrier)
    int* stg = pool + lay.stage;
    const int o_used = p.R, o_nz = 2 * p.R, o_gid = o_nz + 2, o_taint = o_gid + 1;
    const int o_pref = o_taint + p.T, o_port = o_pref + p.Tp, o_img = o_port + p.W;
    const int o_dom = o_img + p.I, o_sel = o_dom + p.K;
    if (lay.staged) {
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            const int j = k * NT + tid;
            if (j >= span) break;
            const size_t n = node_at(j);
            int* b = stg + (size_t)j * lay.row;
            copy_async(b, a.alloc + n * p.R, p.R);
            copy_async(b + o_used, a.used + n * p.R, p.R);
            copy_async(b + o_nz, a.nonzero_used + n * 2, 2);
            copy_async(b + o_gid, a.group_id + n, 1);
            copy_async(b + o_taint, a.taints + n * p.T, p.T);
            copy_async(b + o_pref, a.prefer_taints + n * p.Tp, p.Tp);
            copy_async(b + o_port, a.port_words + n * p.W, p.W);
            copy_async(b + o_img, a.image_kib + n * p.I, p.I);
            copy_async(b + o_dom, a.domain + n * p.K, p.K);
            copy_async(b + o_sel, a.sel_counts + n * p.S, p.S);
        }
    }
    auto rows_at = [&](int j, int n) -> FitRows {
        if (lay.staged && j < ovf && j < span) {
            const int* b = stg + (size_t)j * lay.row;
            return {b, b + o_used, b + o_nz, b + o_taint, b + o_pref, b + o_port, b + o_img,
                    b + o_dom, b + o_sel, b[o_gid]};
        }
        return {a.alloc + (size_t)n * p.R, a.used + (size_t)n * p.R,
                a.nonzero_used + (size_t)n * 2, a.taints + (size_t)n * p.T,
                a.prefer_taints + (size_t)n * p.Tp, a.port_words + (size_t)n * p.W,
                a.image_kib + (size_t)n * p.I, a.domain + (size_t)n * p.K,
                a.sel_counts + (size_t)n * p.S, a.group_id[n]};
    };

    // what the pod uses (uniform over the cluster: slots and features)
    bool hard_on = false, hard_tab = false, req_on = false, req_tab = false;
    bool soft_tab = false, pref_on = false, pref_tab = false;
    for (int c = 0; c < nh; ++c) {
        hard_on |= hard[c].on != 0;
        hard_tab |= hard[c].on && hard[c].dk > 0;
    }
    for (int s = 0; s < na + nfa; ++s) {
        const Slot t = s < na ? anti[s] : aff[s - na];
        req_on |= t.on != 0;
        req_tab |= t.on && t.dk > 0;
    }
    for (int c = 0; c < ns; ++c) soft_tab |= soft[c].on && soft[c].dk > 0;
    for (int s = 0; s < np; ++s) {
        pref_on |= pref[s].on != 0;
        pref_tab |= pref[s].on && pref[s].dk > 0;
    }
    bool ex_any = false, ex_anti_tab = false, ex_pref_on = false, ex_pref_tab = false;
    for (int k = 0; k < p.K; ++k) {
        if (!ex_key(ipa, k)) continue;
        ex_any = true;
        ex_anti_tab |= p.ex_anti && topo_dk_at(p, k) > 0;
        ex_pref_on |= p.ex_pref_add != 0;
        ex_pref_tab |= p.ex_pref_add && topo_dk_at(p, k) > 0;
    }
    const bool need_a = hard_on || req_on || (p.ex_anti && ex_any);
    const bool tab_a = hard_tab || req_tab || ex_anti_tab;
    const bool pts_on = ns > 0 && any_soft_s;
    const bool ipa_on = pref_on || ex_pref_on;
    const bool tab_c = (pts_on && soft_tab) || pref_tab || ex_pref_tab;
    const bool d_on = pts_on || ipa_on;
    timer.mark(0);

    const int sig = clampi(f[p.f_aff_sig], 0, p.A - 1);
    const int name_idx = f[p.f_name_idx], pin = f[p.f_aff_pin];
    const bool has_pref = a.aff_has_pref[sig] != 0;
    copy_async_wait();

    // A. domain statistics over the valid nodes (PreFilter participation):
    // the hard slots' singleton minima and per-domain sums, the required
    // terms' per-domain sums and "anywhere", the existing pods'
    // anti-affinity per key slot
    int v[8] = {SCAN_BIG, SCAN_BIG, SCAN_BIG, SCAN_BIG, 0, 0, 0, 0};
    int any_aff[MAX_REQ_TERMS] = {0, 0, 0, 0};  // indexed by slot at run time
    int hmin[SCAN_MAX_SOFT] = {0, 0, 0, 0};
    if (need_a) {
        auto pass_a = [&](int j) {
            const bool in = j < nlive;
            const int n = in ? lo + j : 0;
            const bool vn = in && a.valid[n];
            const FitRows rw = rows_at(j, n);
            const int* dom_row = rw.dom;
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                if (c >= nh) break;
                const Slot s = hard[c];
                if (!s.on) continue;
                const int d = vn ? dom_at(dom_row, s) : -1;
                const bool on = d >= 0;
                const int cnt = on ? rw.sel[s.col] : 0;
                if (s.dk == 0) {
                    if (on) v[c] = min(v[c], cnt);
                } else {
                    const int dc = clampi(d, 0, s.dk - 1);
                    WarpAdd{}(filt + (size_t)c * D, dc, cnt, on);
                    WarpAdd{}(filt + (size_t)(nh + c) * D, dc, 1, on);
                }
            }
            ipa_filter_stats(p, ipa_add, f, n, dom_row, any_aff, WarpAdd{}, vn);
        };
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            if (k * NT + wid * 32 < nlive) pass_a(k * NT + tid);
        }
        for (int b = ovf + wid * 32; b < nlive; b += NT) pass_a(b + lane);
        timer.mark(1);
#pragma unroll
        for (int s = 0; s < MAX_REQ_TERMS; ++s) v[4 + s] = any_aff[s];
        // (GTAB: the reduction's barrier publishes every block's adds)
        if (tab_a && !GTAB)
            comm.template reduce_tables<8>(v, 0xF0u, 0x0Fu, filt, rfilt, lay.filt_words);
        else comm.template reduce<8>(v, 0xF0u, 0x0Fu);
#pragma unroll
        for (int s = 0; s < MAX_REQ_TERMS; ++s) any_aff[s] = v[4 + s];
        timer.mark(2);
        // the hard slots' min_count: over participating nodes for singleton
        // keys, over present domains otherwise; 0 when there is none. Every
        // warp reads the whole tables and folds them itself: no barrier
        int m[SCAN_MAX_SOFT] = {SCAN_BIG, SCAN_BIG, SCAN_BIG, SCAN_BIG};
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            if (c >= nh) break;
            const Slot s = hard[c];
            if (!s.on || s.dk == 0) continue;
            for (int d = lane; d < s.dk; d += 32) {
                if (hpcs(c)[d] > 0) m[c] = min(m[c], hcnt(c)[d]);
            }
            m[c] = __reduce_min_sync(FULL_MASK, m[c]);
        }
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            const int x = (c < nh && hard[c].dk > 0) ? m[c] : v[c];
            hmin[c] = x == SCAN_BIG ? 0 : x;
        }
        timer.mark(3);
    }

    // B. the filter rows and feasible; the fit, balanced and image scores,
    // the taint count and node-affinity raw; the feasible set's maxima and
    // soft singleton counts; fused, C's adds
    int w[6] = {0, 0, 0, 0, 0, 0};  // max taint count, max aff raw, soft nd
    auto pass_b = [&](int j, FitNode& st) -> bool {
        const bool in = j < span;
        const int n = in ? node_at(j) : 0;
        const FitRows rw = rows_at(j, n);
        const int* a_row = rw.alloc;
        const int* u_row = rw.used;
        const int* nz_row = rw.nz;
        const int* dom_row = rw.dom;
        const bool vn = in && a.valid[n];
        const int g = clampi(rw.gid, 0, p.G - 1);
        bool row[6];
        row[0] = a.unsched[n] && !f[p.f_tol_unsched];
        row[1] = name_idx != -1 && n != name_idx;
        row[2] = untolerated_taint(p, rw.taints, f);
        row[3] = !(a.aff_match[(size_t)sig * p.G + g] && a.aff_allow[(size_t)sig * Nb + n]) ||
                 (pin != -1 && n != pin);
        row[4] = ports_conflict(p, rw.ports, f);
        bool ins_any = false;
        for (int rr = 0; rr < p.R; ++rr) {
            const bool ins = fit_insufficient(rr, f[p.f_req + rr], a_row[rr], u_row[rr]);
            if (FULL && in) insuf[(size_t)rr * Nb + n] = ins;
            ins_any |= ins;
        }
        const bool tm = too_many_pods(a_row, u_row);
        if (FULL && in) toomany[n] = tm;
        row[5] = ins_any || tm;
        bool any = false;
        for (int rr = 0; rr < 6; ++rr) {
            if (FULL && in) fails[(size_t)rr * Nb + n] = row[rr];
            any |= row[rr];
        }
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            if (c >= p.MC) break;
            bool miss = false, skew = false;
            if (c < nh && hard[c].on) {
                const Slot s = hard[c];
                const int d = dom_at(dom_row, s);
                if (d < 0) {
                    miss = true;
                } else {
                    const int count = s.dk == 0 ? rw.sel[s.col] : hcnt(c)[clampi(d, 0, s.dk - 1)];
                    skew = count + s.b - hmin[c] > s.a;
                }
            }
            if (FULL && in) {
                fails[(size_t)(6 + c) * Nb + n] = miss;
                fails[(size_t)(6 + p.MC + c) * Nb + n] = skew;
            }
            any |= miss || skew;
        }
        // InterPodAffinity (filtering.go:352-412)
        bool ipa1, ipa2, ipa3;
        ipa_filters_at(p, ipa, f, n, vn, dom_row, any_aff, ipa1, ipa2, ipa3);
        if (FULL && in) {
            fails[(size_t)(p.NF - 3) * Nb + n] = ipa1;
            fails[(size_t)(p.NF - 2) * Nb + n] = ipa2;
            fails[(size_t)(p.NF - 1) * Nb + n] = ipa3;
        }
        const bool fe = vn && !(any || ipa1 || ipa2 || ipa3);
        if (in) feas[n] = fe;
        const int fit = fit_score(p, a_row, u_row, nz_row, f);
        const int bal = balanced_score(p, a_row, u_row, nz_row, f);
        const int img = image_score(p, rw.image, f);
        if (FULL && in) {
            per[n] = fit;
            per[(size_t)Nb + n] = bal;
            per[(size_t)6 * Nb + n] = img;
        }
        st.pt = wadd(wadd(wmul(fit, p.w_fit), wmul(bal, p.w_bal)), wmul(img, p.w_img));
        st.x = prefer_taint_count(p, rw.prefer, f);
        st.y = a.aff_pref[(size_t)sig * p.G + g];
        if (fe) {
            w[0] = max(w[0], st.x);
            w[1] = max(w[1], st.y);
        }
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            if (c >= ns) break;
            const Slot s = soft[c];
            if (!s.on) continue;
            const int d = fe ? dom_at(dom_row, s) : -1;
            if (s.dk == 0) {
                w[2 + c] += d >= 0;
            } else if (lay.fused && pts_on) {
                const int dc = clampi(d, 0, s.dk - 1);
                const bool on = d >= 0;
                WarpAdd{}(score + (size_t)c * D, dc, on ? rw.sel[s.col] : 0, on);
                WarpAdd{}(score + (size_t)(ns + c) * D, dc, 1, on);
            }
        }
        if (lay.fused && ipa_on) ipa_score_stats(p, ipa_add, f, n, dom_row, WarpAdd{}, fe);
        return fe;
    };
    FitNode st[NPT];
    unsigned fe_bits = 0;
    // a warp whose positions all lie past the block's rows skips them
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        if (k * NT + wid * 32 < span && pass_b(k * NT + tid, st[k]))
            fe_bits |= 1u << k;
    }
    for (int b = ovf + wid * 32; b < span; b += NT) {
        FitNode s;
        pass_b(b + lane, s);  // feasible is in its output row
        if (b + lane < span) {
            const int n = node_at(b + lane);
            total[n] = s.pt;
            sx[n] = s.x;
            sy[n] = s.y;
        }
    }
    timer.mark(4);
    if (tab_c && lay.fused && !GTAB)
        comm.template reduce_tables<6>(w, 0x3u, 0u, score, rscore, lay.score_words);
    else comm.template reduce<6>(w, 0x3u, 0u);
    const int maxtc = w[0], maxaff = w[1];
    timer.mark(5);

    // C, when the score tables share the filter tables' memory: a pass of
    // its own over the feasible nodes after the filter tables' last read
    if (tab_c && !lay.fused) {
        for (int i = tid; i < lay.score_words; i += NT) tabs[i] = 0;
        tick(syncs.bar);
        __syncthreads();
        auto pass_c = [&](int j, bool fe) {
            const bool in = j < span;
            const int n = in ? node_at(j) : 0;
            fe = fe && in;
            const FitRows rw = rows_at(j, n);
            const int* dom_row = rw.dom;
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                if (c >= ns) break;
                const Slot s = soft[c];
                if (!pts_on || !s.on || s.dk == 0) continue;
                const int d = fe ? dom_at(dom_row, s) : -1;
                const bool on = d >= 0;
                const int dc = clampi(d, 0, s.dk - 1);
                WarpAdd{}(score + (size_t)c * D, dc, on ? rw.sel[s.col] : 0, on);
                WarpAdd{}(score + (size_t)(ns + c) * D, dc, 1, on);
            }
            if (ipa_on) ipa_score_stats(p, ipa_add, f, n, dom_row, WarpAdd{}, fe);
        };
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            if (k * NT + wid * 32 < span) pass_c(k * NT + tid, (fe_bits >> k) & 1u);
        }
        for (int b = ovf + wid * 32; b < span; b += NT) {
            pass_c(b + lane, b + lane < span && feas[node_at(b + lane)]);
        }
        int dummy[1] = {0};
        comm.template reduce_tables<1>(dummy, 0u, 0u, score, rscore, lay.score_words);
    }
    timer.mark(6);

    // the soft slots' present-domain counts (every warp folds the whole
    // tables itself), then their log weights
    int nd[SCAN_MAX_SOFT] = {0, 0, 0, 0};
    if (pts_on) {
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            if (c >= ns) break;
            const Slot s = soft[c];
            if (!s.on || s.dk == 0) continue;
            for (int d = lane; d < s.dk; d += 32) nd[c] += spcs(c)[d] > 0;
            nd[c] = (int)__reduce_add_sync(FULL_MASK, (unsigned)nd[c]);
        }
    }
    float wlog[SCAN_MAX_SOFT];
#pragma unroll
    for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
        const bool on = c < ns && soft[c].on;
        wlog[c] = on ? a.logtab[soft[c].dk == 0 ? w[2 + c] : nd[c]] : 0.0f;
    }
    timer.mark(7);

    // D. the taint and node-affinity scores into the partial total (their
    // maxima are known); the spread and IPA raw scores on every row and
    // their feasible min/max. Without D's fold the total is final here.
    int mm[4] = {-SCAN_BIG, SCAN_BIG, -SCAN_BIG, SCAN_BIG};  // max, min, max, min
    if (!d_on) comm.arrive();
    auto pass_d = [&](int j, FitNode& s, bool fe) {
        const bool in = j < span;
        const int n = in ? node_at(j) : 0;
        const int sc2 = taint_normalized(s.x, maxtc);
        const int sc3 = has_pref ? affinity_normalized(s.y, maxaff) : 0;
        if (FULL && in) {
            per[(size_t)2 * Nb + n] = sc2;
            per[(size_t)3 * Nb + n] = sc3;
        }
        s.pt = wadd(s.pt, wadd(wmul(sc2, p.w_taint), wmul(sc3, p.w_aff)));
        const FitRows rw = rows_at(j, n);
        const int* dom_row = rw.dom;
        int rp = 0, ri = 0;
        if (pts_on) {
            float cost = 0.0f;
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                if (c >= ns) break;
                const Slot t = soft[c];
                const int d = dom_at(dom_row, t);
                if (!t.on || d < 0) continue;  // the reference adds +0.0
                const int count = t.dk == 0 ? rw.sel[t.col] : scnt(c)[clampi(d, 0, t.dk - 1)];
                cost = __fadd_rn(cost, __fmul_rn(__int2float_rn(count), wlog[c]));
            }
            rp = __float2int_rz(cost);
            if (fe) {
                mm[0] = max(mm[0], rp);
                mm[1] = min(mm[1], rp);
            }
        }
        if (ipa_on) {
            ri = ipa_raw_at(p, ipa, f, n, fe, dom_row);
            if (fe) {
                mm[2] = max(mm[2], ri);
                mm[3] = min(mm[3], ri);
            }
        }
        s.x = rp;
        s.y = ri;
        if (!d_on && in) {  // the spread and IPA scores are 0
            if (FULL) {
                per[(size_t)4 * Nb + n] = 0;
                per[(size_t)5 * Nb + n] = 0;
            }
            total[n] = fe ? s.pt : -1;
        }
    };
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        if (k * NT + wid * 32 < span) pass_d(k * NT + tid, st[k], (fe_bits >> k) & 1u);
    }
    for (int b = ovf + wid * 32; b < span; b += NT) {
        const bool in = b + lane < span;
        const int n = in ? node_at(b + lane) : 0;
        FitNode s = {total[n], sx[n], sy[n]};
        const bool fe = in && feas[n];
        pass_d(b + lane, s, fe);
        if (d_on && in) {
            total[n] = s.pt;
            sx[n] = s.x;
            sy[n] = s.y;
        }
    }
    timer.mark(8);

    // E. the normalized spread and IPA scores and the weighted total
    if (d_on) {
        comm.template reduce<4>(mm, 0x5u, 0xAu);
        comm.arrive();
        timer.mark(9);
        auto pass_e = [&](int j, const FitNode& s, bool fe) {
            if (j >= span) return;
            const int n = node_at(j);
            const int sc4 = pts_on ? pts_normalized(s.x, mm[0], mm[1]) : 0;
            const int sc5 = ipa_on ? ipa_normalized(s.y, mm[2], mm[3]) : 0;
            if (FULL) {
                per[(size_t)4 * Nb + n] = sc4;
                per[(size_t)5 * Nb + n] = sc5;
            }
            const int tot = wadd(s.pt, wadd(wmul(sc4, p.w_pts), wmul(sc5, p.w_ipa)));
            total[n] = fe ? tot : -1;
        };
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            if (k * NT + wid * 32 < span) pass_e(k * NT + tid, st[k], (fe_bits >> k) & 1u);
        }
        for (int j = ovf + tid; j < span; j += NT) {
            const int n = node_at(j);
            const FitNode s = {total[n], sx[n], sy[n]};
            pass_e(j, s, feas[n] != 0);
        }
        timer.mark(10);
    }
    comm.wait();
    timer.mark(11);
    if (a.syncs && tid == 0 && pod == 0 && r == 0) {
        const int counts[FIT_COUNTS] = {syncs.bar,  syncs.fold,  syncs.csync,
                                        syncs.xch,  syncs.tfold, syncs.twords};
        for (int k = 0; k < FIT_COUNTS; ++k) a.syncs[k] = counts[k];
        for (int k = 0; k < FIT_PHASES; ++k) a.syncs[FIT_COUNTS + k] = (int)clk[k];
    }
    if constexpr (Comm::kCards) {
        if (tid == 0 && pod == 0 && r == 0) a.link.ctl[1] = syncs.card;
    }
}

// The latency floor of a K4 or K7 launch: per pod, the counted folds, block
// barriers, exchanges, table folds (over twords / tfold words each) and
// cluster barriers that the kernel reported, in the kernel's comm policy,
// with no node work.
template <class Comm>
__global__ void __launch_bounds__(SCAN_NT, 1) fit_floor_kernel(ScanSyncs n, int* out) {
    extern __shared__ int pool[];
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int xch[3 * SCAN_RED];
    __shared__ ScanSyncs syncs;
    if (threadIdx.x == 0) syncs = {0, 0, 0, 0, 0, 0, 0};
    Comm comm;
    if constexpr (Comm::kCluster) {
        cg::cluster_group cl = cg::this_cluster();
        comm = {0, 0, (int)cl.block_rank(), (int)cl.num_blocks(), red, 0, xch, 0, &syncs};
    } else {
        comm = {0, 0, red, 0, &syncs};
    }
    int acc = threadIdx.x;
    for (int i = 0; i < n.fold; ++i) {
        int v[4] = {acc, acc, acc, acc};
        comm.template reduce_local<4>(v, 0x1u, 0x2u);
        acc += v[0] & 1;
    }
    for (int i = 0; i < n.bar; ++i) __syncthreads();
    if constexpr (Comm::kCluster) {
        const int words = n.tfold ? n.twords / n.tfold : 0;
        const bool gathered = ClusterComm::gathers(words, comm.nb);
        for (int i = 0; i < n.xch; ++i) {
            int v[4] = {acc, acc, acc, acc};
            comm.template exchange<4>(v, 0x1u, 0x2u);
            acc += v[0] & 1;
        }
        for (int i = 0; i < n.tfold; ++i) comm.fold_words(pool, gathered ? pool + words : pool, words);
        for (int i = 1; i < n.csync; ++i) comm.sync();
        comm.arrive();
        comm.wait();
    }
    if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = acc;
}

// what a launcher learned about one kernel: the dynamic shared memory it
// may use, and for each cluster size the largest dynamic shared memory at
// which a cluster was found resident
// (per card: a function attribute is set on the calling thread's current
// device only, so a memo shared by the cards would leave a second card's
// kernel without its dynamic shared memory)
struct LaunchMemo {
    const void* kernel;
    int device;
    size_t dyn_set;
    size_t fits_dyn[FIT_MAX_CLUSTER + 1];
};

inline LaunchMemo* launch_memo(const void* kernel) {
    static LaunchMemo memo[64];
    static int used = 0;
    int dev = -1;
    if (cudaGetDevice(&dev) != cudaSuccess) return nullptr;
    for (int i = 0; i < used; ++i) {
        if (memo[i].kernel == kernel && memo[i].device == dev) return &memo[i];
    }
    if (used == 64) return nullptr;
    memo[used] = LaunchMemo{kernel, dev, 0, {}};
    return &memo[used++];
}

// launch one instance on P pods x C blocks, as clusters of C under the
// cluster policy (refused when one cannot be resident:
// cudaOccupancyMaxActiveClusters is 0), else one block per pod; the
// attributes and the occupancy answer are asked once per kernel
template <class Comm, class K, class... Args>
int launch_clusters(K kernel, int P, int C, int threads, size_t dyn, void* stream,
                    Args... args) {
    LaunchMemo scratch = {(const void*)kernel, -1, 0, {}};
    LaunchMemo* memo = launch_memo((const void*)kernel);
    if (!memo) memo = &scratch;
    cudaError_t err;
    if (dyn > memo->dyn_set || memo->dyn_set == 0) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (err != cudaSuccess) return (int)err;
        if (Comm::kCluster) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return (int)err;
        }
        memo->dyn_set = dyn > 0 ? dyn : 1;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P * C, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = Comm::kCluster ? 1 : 0;
    if (Comm::kCluster && !(memo->fits_dyn[C] && dyn <= memo->fits_dyn[C])) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters < 1) return FIT_CLUSTER_DOES_NOT_FIT;
        memo->fits_dyn[C] = dyn > 0 ? dyn : 1;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The instance for a launch: NPT the smallest of the compiled ones whose
// NT * NPT positions cover ceil(Nb / C) rows, else the largest (the rows
// past it keep their state in the outputs). K4 runs FIT_NT threads and
// every C under ClusterComm (a cluster of 1 included); K7 runs 1024 threads
// and one position, C = 1 under BlockComm.
template <bool FULL, int NT, int NPT, class Comm>
int launch_npt(const FitParams* p, const FitArgs& a, void* stream) {
    const size_t dyn = (size_t)fit_smem(*p, NPT, NT).words * sizeof(int);
    return launch_clusters<Comm>(fit_and_score_kernel<FULL, NT, NPT, SCAN_GTAB_LIB, Comm>,
                                 p->P, p->cluster, NT, dyn, stream, *p, a);
}

inline int fit_npt(const FitParams* p, int nt, int max_npt) {
    const int rows = (p->Nb + p->cluster - 1) / p->cluster;
    int npt = 1;
    while (npt < max_npt && npt * nt < rows) npt *= 2;
    return npt;
}

inline FitArgs fit_args(void* const* ptrs) {
    FitArgs a = {};
    a.alloc = (const int*)ptrs[0];
    a.used = (const int*)ptrs[1];
    a.nonzero_used = (const int*)ptrs[2];
    a.valid = (const uint8_t*)ptrs[3];
    a.unsched = (const uint8_t*)ptrs[4];
    a.group_id = (const int*)ptrs[5];
    a.taints = (const int*)ptrs[6];
    a.prefer_taints = (const int*)ptrs[7];
    a.domain = (const int*)ptrs[8];
    a.sel_counts = (const int*)ptrs[9];
    a.port_words = (const int*)ptrs[10];
    a.image_kib = (const int*)ptrs[11];
    a.ipa_counts = (const int*)ptrs[12];
    a.ipa_anti = (const int*)ptrs[13];
    a.ipa_pref = (const int*)ptrs[14];
    a.ipa_term_key = (const int*)ptrs[15];
    a.aff_match = (const uint8_t*)ptrs[16];
    a.aff_pref = (const int*)ptrs[17];
    a.aff_allow = (const uint8_t*)ptrs[18];
    a.aff_has_pref = (const uint8_t*)ptrs[19];
    a.feats = (const int*)ptrs[20];
    a.logtab = (const float*)ptrs[21];
    return a;
}

#ifndef SCAN_CARDS
// ptrs: alloc, used, nonzero_used, valid, unsched, group_id, taints,
// prefer_taints, domain, sel_counts, port_words, image_kib, ipa_counts,
// ipa_anti, ipa_pref, ipa_term_key, aff_match, aff_pref, aff_allow,
// aff_has_pref, feats, logtab, then K4: out, syncs (0: none), tables; K7:
// feasible, total, raw, syncs, tables (the GTAB scratch, 0 without); then
// both the launch tables (common.cuh; 0 within the parameter block's).
//
// The file builds twice (ops/cuda.py DEFINES): with -DSCAN_GMEM its
// instances keep the domain tables in the device-memory scratch (GTAB),
// else in shared memory; each library refuses the other's launches.
extern "C" int launch_fit_and_score(const FitParams* p, void* const* ptrs, void* stream) {
    const int C = p->cluster;
    if (C < 1 || C > FIT_MAX_CLUSTER || (C & (C - 1)) || (p->gtab != 0) != SCAN_GTAB_LIB ||
        (p->gtab && !ptrs[24]))
        return (int)cudaErrorInvalidValue;
    FitArgs a = fit_args(ptrs);
    a.out = (uint8_t*)ptrs[22];
    a.syncs = (int*)ptrs[23];
    a.tables = (int*)ptrs[24];
    a.lt = (const int*)ptrs[25];
    switch (fit_npt(p, FIT_NT, 4)) {
        case 1: return launch_npt<true, FIT_NT, 1, ClusterComm>(p, a, stream);
        case 2: return launch_npt<true, FIT_NT, 2, ClusterComm>(p, a, stream);
        default: return launch_npt<true, FIT_NT, 4, ClusterComm>(p, a, stream);
    }
}

extern "C" int launch_wave_fit_and_score(const FitParams* p, void* const* ptrs, void* stream) {
    const int C = p->cluster;
    if ((C != 1 && C != 2 && C != 4) || (p->gtab != 0) != SCAN_GTAB_LIB ||
        (p->gtab && !ptrs[26]))
        return (int)cudaErrorInvalidValue;
    FitArgs a = fit_args(ptrs);
    a.feas_out = (uint8_t*)ptrs[22];
    a.total_out = (int*)ptrs[23];
    a.raw_out = (int*)ptrs[24];
    a.syncs = (int*)ptrs[25];
    a.tables = (int*)ptrs[26];
    a.lt = (const int*)ptrs[27];
    // one position per thread in registers, the rest through the outputs:
    // many pods in flight keep the card busy, and a register array past
    // one position spills at 64 registers a thread
    if (C == 1) return launch_npt<false, SCAN_NT, 1, BlockComm>(p, a, stream);
    return launch_npt<false, SCAN_NT, 1, ClusterComm>(p, a, stream);
}

// the floor of a launch's counted synchronisations (counts [FIT_COUNTS] as
// the kernel wrote them) on P pods of C blocks of `threads`: a cluster
// policy for K4 (any C) and K7 past one block, one block per pod for K7 at
// C = 1
extern "C" int launch_fit_floor(const int* counts, int P, int C, int threads,
                                int cluster_policy, int* out, void* stream) {
    const ScanSyncs n = {counts[0], counts[1], counts[2], counts[3], 0, counts[4], counts[5]};
    if (P < 1 || C < 1 || C > FIT_MAX_CLUSTER || (C > 1 && !cluster_policy) || threads < 32 ||
        threads > SCAN_NT || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int words = n.tfold ? n.twords / n.tfold : 0;
    const size_t dyn = (size_t)(words > 0 ? 2 * words : 1) * sizeof(int);
    if (cluster_policy)
        return launch_clusters<ClusterComm>(fit_floor_kernel<ClusterComm>, P, C, threads, dyn,
                                            stream, n, out);
    return launch_clusters<BlockComm>(fit_floor_kernel<BlockComm>, P, 1, threads, dyn, stream,
                                      n, out);
}

#endif

#ifdef SCAN_CARDS
// The card level of K4 and K7 (comm.cuh CardComm): on each card the pods
// against the card's range of the node axis (its planes; the pods' feature
// rows with NodeName and the affinity pin shifted into the card's range by
// the wrapper), the folds crossing cards, the domain tables one set per pod
// on card 0 (GTAB: this library builds with -DSCAN_GMEM). Every pod of a
// launch must be resident on every card at once (a pod's blocks wait at
// each card exchange for the same pod on the other cards), so the launcher
// cuts the pods into launches of what the card holds at once, divided by
// the card ranks this card carries (two ranks on one card run side by side
// on two streams). ptrs as launch_fit_and_score's / launch_wave_fit_and_score's.
template <bool FULL, int NT, int NPT, class Comm>
int launch_cards_npt(const FitParams* p, FitArgs a, int ranks, void* stream, long long per_pod) {
    auto kernel = fit_and_score_kernel<FULL, NT, NPT, true, Comm>;
    const int C = p->cluster;
    const FitSmem lay = fit_smem(*p, NPT, NT);
    const size_t dyn = (size_t)lay.words * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dyn);
    if (err != cudaSuccess) return (int)err;
    int resident = 0;
    if (Comm::kCluster) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(C, 1, 1);
        cfg.blockDim = dim3(NT, 1, 1);
        cfg.dynamicSmemBytes = dyn;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
    } else {
        int per_sm = 0, dev = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, dyn);
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        resident = per_sm * sms;
    }
    const int chunk = resident / ranks;
    if (chunk < 1) return FIT_CLUSTER_DOES_NOT_FIT;
    int* syncs = a.syncs;
    for (int pod0 = 0; pod0 < p->P; pod0 += chunk) {
        FitParams q = *p;
        q.P = min(chunk, p->P - pod0);
        FitArgs b = a;
        b.feats = a.feats + (size_t)pod0 * p->F;
        if (FULL) {
            b.out = a.out + (size_t)pod0 * per_pod;
        } else {
            b.feas_out = a.feas_out + (size_t)pod0 * p->Nb;
            b.total_out = a.total_out + (size_t)pod0 * p->Nb;
            b.raw_out = a.raw_out + (size_t)pod0 * 2 * p->Nb;
        }
        b.tables = a.tables + (size_t)pod0 * lay.tables;
        b.link.group0 = a.link.group0 + pod0;
        b.syncs = pod0 == 0 ? syncs : nullptr;
        const int code = launch_clusters<Comm>(kernel, q.P, C, NT, dyn, stream, q, b);
        if (code != 0) return code;
    }
    return 0;
}

extern "C" int launch_fit_and_score_cards(const FitParams* p, void* const* ptrs,
                                          const CardLink* link, int ranks, void* stream) {
    const int C = p->cluster;
    if (C < 1 || C > FIT_MAX_CLUSTER || (C & (C - 1)) || !p->gtab || !ptrs[24] || ranks < 1 ||
        link->cards < 1 || link->cards > CARD_MAX)
        return (int)cudaErrorInvalidValue;
    FitArgs a = fit_args(ptrs);
    a.out = (uint8_t*)ptrs[22];
    a.syncs = (int*)ptrs[23];
    a.tables = (int*)ptrs[24];
    a.lt = (const int*)ptrs[25];
    a.link = *link;
    const long long per_pod =
        (long long)(p->NF + p->R + 2) * p->Nb + (long long)(1 + N_PLUGINS) * p->Nb * 4;
    using CC = CardComm<ClusterComm>;
    switch (fit_npt(p, FIT_NT, 4)) {
        case 1: return launch_cards_npt<true, FIT_NT, 1, CC>(p, a, ranks, stream, per_pod);
        case 2: return launch_cards_npt<true, FIT_NT, 2, CC>(p, a, ranks, stream, per_pod);
        default: return launch_cards_npt<true, FIT_NT, 4, CC>(p, a, ranks, stream, per_pod);
    }
}

// K7 at the card level: one block per pod (BlockComm within the card)
extern "C" int launch_wave_fit_and_score_cards(const FitParams* p, void* const* ptrs,
                                               const CardLink* link, int ranks, void* stream) {
    if (p->cluster != 1 || !p->gtab || !ptrs[26] || ranks < 1 || link->cards < 1 ||
        link->cards > CARD_MAX)
        return (int)cudaErrorInvalidValue;
    FitArgs a = fit_args(ptrs);
    a.feas_out = (uint8_t*)ptrs[22];
    a.total_out = (int*)ptrs[23];
    a.raw_out = (int*)ptrs[24];
    a.syncs = (int*)ptrs[25];
    a.tables = (int*)ptrs[26];
    a.lt = (const int*)ptrs[27];
    a.link = *link;
    return launch_cards_npt<false, SCAN_NT, 1, CardComm<BlockComm>>(p, a, ranks, stream, 0);
}
#endif
