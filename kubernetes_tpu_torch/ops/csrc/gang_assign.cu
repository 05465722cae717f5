// K5 gang_assign — replaces _gang_assign_jit with _gang_placement_score of
// the reference package (kubernetes_tpu/ops/kernels.py:1472-1543,
// :1448-1469): whole-PodGroup placement over a stack of placement masks.
//
// What it computes: for each mask row d, the gang's member scan of K2's
// non-dedup tier over the placement-narrowed snapshot (valid & mask[d]),
// from cursor 0 of the same tie-word stream with its own carry, giving
// winners [P], tie words consumed and overflow; the number of members
// placed; and the placement score, the mean free-capacity score (0-100,
// LeastAllocated shape, int32 floor math) of the mask's nodes with cpu or
// memory capacity, on the PRE-scan planes (valid is not read). Then the
// pick: the first row < n_constrained with the highest score among rows
// where every active member placed and no draw overflowed, else the
// fallback row n_constrained when has_fallback. One packed int32 output,
// in the reference's order: winners [rows * P], consumed [rows], overflow
// [rows], placed [rows], score [rows], then [win_d, ok, n_active].
//
// What bounds it on an H100: latency, as K2 — each row is a serial chain of
// member steps, each a few dependent block-wide reductions. Design: one
// 1024-thread block per mask row, or past one block's slots one
// thread-block cluster of m blocks per row (grid = rows x m; m from the
// launch plan on the largest row's mask population, scan_plan in
// ops/kernels.py: eight zone rows of 6250 nodes keep one block each, a
// fallback row over a 50000-node cluster takes four), the rows' chains in
// parallel on separate SMs (domain tables past shared memory: a cluster of
// m >= 1 blocks per row with the row's tables in its work slice, the GTAB
// instance of scan_step.cuh). Each block copies its range of the pre-scan
// carry planes into the row's slice of a [rows, ...] device work buffer
// (the cluster shares the slice: a block reads only its own range's rows,
// and the hard-spread domain counts are the row's, as K6's) and runs
// scan_block<MASKED>() of scan_step.cuh (K2's step, shared), which first
// builds the ascending list of its range's mask nodes in shared memory and
// then walks only that list (a zone row of a 5000-node cluster holds ~1/8
// of the 8192 slots), each thread owning NPT list positions, one barrier
// per reduction (and one cluster exchange in a cluster). The placement
// score on the pre-scan planes walks the same list and folds over the
// cluster as an int32 sum. K1 runs once over the members, not per row: its
// static_ok is the only K1 output that reads valid, and the walk holds only
// the mask's nodes. A one-block tail launch makes the pick. Past the card's
// largest cluster (a row's mask population past 16 blocks of 16384 list
// positions, or a range past SCAN_MAX_RANGE slots) each block of the row's
// cluster walks its list in passes (the pass instance of scan_step.cuh,
// built into the cluster libraries): its node list, held as int32 by list
// position, and its position words live in the row's slice of a position
// scratch (scan_pass_words per row).
#include "scan_step.cuh"

#define GANG_CPU_COL 0
#define GANG_MEM_COL 1

struct GangParams {
    ScanParams scan;
    int rows;           // mask rows (pow2-padded placements)
    int n_constrained;  // rows [0, n_constrained) are topology domains
    int has_fallback;   // row n_constrained is the unconstrained parent
    int blocks;         // blocks per row: 1, or a cluster of 2-16 dividing Nb
};

// int32 words of one row's work slice: the carry planes, the hard-spread
// domain counts and, in the GTAB instance, the row's domain tables
__host__ __device__ inline size_t gang_work_words(const ScanParams& p) {
    const size_t nb = (size_t)p.Nb;
    return nb * p.R + nb * 2 + nb * p.S + (p.ipa_active ? 3 * nb * p.Ta : 0)
           + (p.dom_carry ? (size_t)p.K * p.D * p.S : 0)
           + (p.gtab ? (size_t)scan_smem(p, 1, true).tables : 0);
}

__device__ __forceinline__ void copy_words(int* dst, const int* src, size_t n) {
    for (size_t i = threadIdx.x; i < n; i += SCAN_NT) dst[i] = src[i];
}

// returned by the launcher when a row's cluster cannot be co-resident
#define GANG_CLUSTER_DOES_NOT_FIT (-2)
// a row's overflow word when one of its blocks held more mask nodes than
// its list's slots (the launch's population below the row's count): the
// row never wins, and the caller raises (kernels.GANG_LIST_TRUNCATED)
#define GANG_LIST_TRUNCATED 2

template <typename Comm>
__device__ __forceinline__ Comm gang_comm(int lo, int hi, int r, int m,
                                          int (*red)[SCAN_NWARPS][SCAN_RED], int* xch,
                                          ScanSyncs* syncs) {
    if constexpr (Comm::kCluster) return Comm{lo, hi, r, m, red, 0, xch, 0, syncs};
    else return Comm{lo, hi, red, 0, syncs};
}

template <int NPT, bool GATED, bool GTAB, bool PASS, typename Comm>
__global__ void __launch_bounds__(SCAN_NT, 1) gang_assign_kernel(
    GangParams g, ScanArgs base, const uint8_t* __restrict__ masks, int* work, int* out) {
    // the fold and exchange slots, at the same address in every block
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int xch[3 * SCAN_RED];
    __shared__ ScanSyncs syncs;
    extern __shared__ int dyn[];
    const ScanParams& p = g.scan;
    // mask row d; this block's rank r of the row's m and its node range
    const int m = g.blocks;
    const int d = blockIdx.x / m;
    int r = 0;
    if constexpr (Comm::kCluster) r = (int)cg::this_cluster().block_rank();
    const int nbl = p.Nb / m, lo = r * nbl, hi = lo + nbl;
    const size_t nb = (size_t)p.Nb;
    const uint8_t* mask = masks + (size_t)d * nb;

    // this row's carry, from the pre-scan planes: this block's range of
    // rows (the scan's prologue passes a barrier before it reads them, and
    // a block reads only its own range's rows)
    ScanArgs a = base;
    a.mask = mask;
    int* w = work + (size_t)d * gang_work_words(p);
    a.used = w;
    w += nb * p.R;
    a.nonzero_used = w;
    w += nb * 2;
    a.sel_counts = w;
    w += nb * p.S;
    const size_t l0 = (size_t)lo, rows = (size_t)nbl;
    copy_words(a.used + l0 * p.R, base.used + l0 * p.R, rows * p.R);
    copy_words(a.nonzero_used + l0 * 2, base.nonzero_used + l0 * 2, rows * 2);
    copy_words(a.sel_counts + l0 * p.S, base.sel_counts + l0 * p.S, rows * p.S);
    if (p.ipa_active) {
        a.ipa_counts = w;
        a.ipa_anti = w + nb * p.Ta;
        a.ipa_pref = w + 2 * nb * p.Ta;
        w += 3 * nb * p.Ta;
        const size_t o = l0 * p.Ta, n = rows * p.Ta;
        copy_words(a.ipa_counts + o, base.ipa_counts + o, n);
        copy_words(a.ipa_anti + o, base.ipa_anti + o, n);
        copy_words(a.ipa_pref + o, base.ipa_pref + o, n);
    }
    if (p.dom_carry) {
        a.dom_counts = w;
        w += (size_t)p.K * p.D * p.S;
    }
    if (GTAB || (PASS && p.gtab)) a.tables = w;
    if (PASS) a.pos = base.pos + (size_t)d * scan_pass_words(p, m, true);
    a.winners = out + (size_t)d * p.P;

    if (threadIdx.x == 0) syncs = {0, 0, 0, 0, 0};
    Comm comm = gang_comm<Comm>(lo, hi, r, m, red, xch, &syncs);
    const ScanEnd end = scan_block<true, NPT, GATED, GTAB, PASS>(p, a, comm);

    // the placement score on the pre-scan planes, over the mask's list: per
    // node the mean of the cpu and memory free shares over the columns with
    // capacity, then the mean over the mask's nodes that have such a column
    // (the counts and sums fold over the cluster: int32 sums; whether any
    // block's list was truncated, a max)
    const unsigned short* list = reinterpret_cast<const unsigned short*>(
        dyn + scan_smem(p, scan_slots(p, nbl, true), true).list);
    const int* list32 = PASS ? a.pos + (size_t)3 * nb + lo : nullptr;  // the pass instance's
    int v[3] = {0, 0, end.truncated};  // counted nodes, their score sum, truncated
    for (int i = threadIdx.x; i < end.walked; i += SCAN_NT) {
        const int n = lo + (PASS ? list32[i] : (int)list[i]);
        int score = 0, parts = 0;
        for (int col = GANG_CPU_COL; col <= GANG_MEM_COL; ++col) {
            const int cap = base.alloc[(size_t)n * p.R + col];
            if (cap <= 0) continue;
            const int req = min(base.used[(size_t)n * p.R + col], cap);
            score = wadd(score, floordiv(wmul(cap - req, MAX_NODE_SCORE), cap));
            parts += 1;
        }
        if (parts > 0) {
            v[0] += 1;
            v[1] = wadd(v[1], floordiv(score, parts));
        }
    }
    // (a cluster's exchange barrier also publishes every block's winners)
    comm.template reduce<3>(v, 0x4u, 0u);
    const int pscore = v[0] > 0 ? floordiv(v[1], v[0]) : 0;
    if (r == 0 && threadIdx.x == 0) {
        int placed = 0;
        for (int i = 0; i < p.P; ++i)
            placed += a.winners[i] >= 0 && base.feats[(size_t)i * p.F + p.f_active] != 0;
        int* rows_out = out + (size_t)g.rows * p.P;
        rows_out[d] = end.cursor;
        rows_out[g.rows + d] = v[2] ? GANG_LIST_TRUNCATED : end.overflow;
        rows_out[2 * g.rows + d] = placed;
        rows_out[3 * g.rows + d] = pscore;
        if (d == 0) write_syncs(base.syncs, end.syncs, end.phase_cycles);
    }
    // no block leaves while a peer may still read its shared memory
    if constexpr (Comm::kCluster) cg::this_cluster().sync();
}

// the all-or-nothing pick (kernels.py:1515-1533): a row's key is its score
// when every active member placed without a draw overflow, else -1; the
// first max over the constrained rows wins, else the fallback row
__global__ void gang_pick_kernel(GangParams g, const int* __restrict__ feats, int* out) {
    if (threadIdx.x != 0) return;
    const ScanParams& p = g.scan;
    const int rows = g.rows, nc = g.n_constrained;
    int n_active = 0;
    for (int i = 0; i < p.P; ++i) n_active += feats[(size_t)i * p.F + p.f_active] != 0;
    const int* r = out + (size_t)rows * p.P;
    const int* overflow = r + rows;
    const int* placed = r + 2 * rows;
    const int* score = r + 3 * rows;
    int cbest = -1, cwin = 0;
    if (nc > 0) {
        for (int d = 0; d < rows; ++d) {
            const bool fits = placed[d] == n_active && !overflow[d];
            const int ckey = d < nc && fits ? score[d] : -1;
            if (d == 0 || ckey > cbest) {
                cbest = ckey;
                cwin = d;
            }
        }
    }
    int win_d = cwin, ok = cbest >= 0;
    if (g.has_fallback) {
        const bool fb_ok = placed[nc] == n_active && !overflow[nc];
        win_d = cbest >= 0 ? cwin : nc;
        ok = cbest >= 0 || fb_ok;
    }
    int* tail = out + (size_t)rows * p.P + 4 * (size_t)rows;
    tail[0] = win_d;
    tail[1] = ok;
    tail[2] = n_active;
}

// one launch of the rows: m = 1 one block per row (BlockComm), else one
// cluster of m blocks per row (ClusterComm), refused when such a cluster
// cannot be resident rather than launched smaller
template <int NPT, bool GATED, bool GTAB, bool PASS, typename Comm>
int launch_rows(const GangParams* g, const ScanArgs& a, void* const* ptrs, size_t dyn,
                cudaStream_t s) {
    auto kernel = gang_assign_kernel<NPT, GATED, GTAB, PASS, Comm>;
    const int m = g->blocks;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
    if (e != cudaSuccess) return (int)e;
    if (Comm::kCluster && m > 8) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g->rows * m, 1, 1);
    cfg.blockDim = dim3(SCAN_NT, 1, 1);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = m;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = Comm::kCluster ? 1 : 0;
    if (Comm::kCluster) {
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (clusters < 1) return GANG_CLUSTER_DOES_NOT_FIT;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, *g, a, (const uint8_t*)ptrs[18], (int*)ptrs[19],
                           (int*)ptrs[20]);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// ptrs: alloc, domain, valid, static_ok, taint_cnt, aff_raw, img,
// aff_has_pref, feats, tie_words, logtab, used, nonzero_used, sel_counts,
// ipa_counts, ipa_anti, ipa_pref, ipa_term_key (the pre-scan planes, read
// only; IPA pointers 0 without IPA), masks, work, out, then the sync counts
// and phase cycles of row 0's scan (0: not wanted), then the launch tables
// (common.cuh; 0 within the parameter block's), then the pass instance's
// position scratch (rows x scan_pass_words; 0 in one pass)
//
// The file builds three times (ops/cuda.py DEFINES): without GANG_CLUSTER
// the library launches one block per row (m = 1), with it one cluster of m
// blocks per row (m > 1), and with GANG_CLUSTER and SCAN_GMEM a cluster of
// m blocks per row (m >= 1) whose domain tables live in the row's work
// slice (the GTAB instances, for tables past shared memory); each library
// refuses the others' launches. With GANG_CLUSTER and SCAN_PASS the
// library holds the pass instances (p.passes > 0), on either table
// placement. Libraries compile side by side in the time of one.
extern "C" int launch_gang_assign(const GangParams* g, void* const* ptrs, void* stream) {
    const int m = g->blocks, nb = g->scan.Nb;
#ifdef GANG_CLUSTER
    constexpr bool cluster = true;
#else
    constexpr bool cluster = false;
#endif
    const int passes = g->scan.passes;
    // a one-pass block's uint16 list spans at most SCAN_MAX_RANGE slots
    if (m < 1 || m > SCAN_MAX_BLOCKS || (m & (m - 1)) || nb % m
        || (passes == 0 && nb / m > SCAN_MAX_RANGE)
        || (!SCAN_GTAB_LIB && passes == 0 && (m > 1) != cluster))
        return (int)cudaErrorInvalidValue;
    const int slots = scan_slots(g->scan, nb / m, true);
    const size_t dyn = scan_smem_bytes(g->scan, slots, true);
    ScanArgs a = {};
    a.alloc = (const int*)ptrs[0];
    a.domain = (const int*)ptrs[1];
    a.valid = (const uint8_t*)ptrs[2];
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
    a.syncs = (int*)ptrs[21];
    a.lt = (const int*)ptrs[22];
    a.pos = (int*)ptrs[23];
    if (passes > 0 && a.pos == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int err = scan_dispatch(slots, scan_gated(g->scan), g->scan.gtab != 0, passes,
                                  [&](auto npt, auto gated, auto gtab, auto pass) {
        constexpr int N = decltype(npt)::value;
        constexpr bool G = decltype(gated)::value;
        constexpr bool T = decltype(gtab)::value;
        constexpr bool Q = decltype(pass)::value;
#ifdef GANG_CLUSTER
        return launch_rows<N, G, T, Q, ClusterComm>(g, a, ptrs, dyn, s);
#else
        return launch_rows<N, G, T, Q, BlockComm>(g, a, ptrs, dyn, s);
#endif
    });
    if (err != 0) return err;
    gang_pick_kernel<<<1, 32, 0, s>>>(*g, (const int*)ptrs[8], (int*)ptrs[20]);
    return (int)cudaGetLastError();
}
