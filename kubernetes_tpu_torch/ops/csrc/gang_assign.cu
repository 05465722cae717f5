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
// member steps, each a handful of dependent block-wide reductions. Design:
// one 1024-thread block per mask row (grid = rows), the rows' chains in
// parallel on separate SMs. Each block copies the pre-scan carry planes
// into its own slice of a [rows, ...] device work buffer, reduces its
// placement score, runs scan_block<MASKED>() of scan_step.cuh (K2's step,
// shared, with validity narrowed by the row's mask), and writes its row's
// outputs. K1 runs once over the members, not per row: its static_ok is
// the only K1 output that reads valid, and scan_block narrows it by the
// mask. A one-block tail launch makes the pick.
#include "scan_step.cuh"

#define GANG_CPU_COL 0
#define GANG_MEM_COL 1

struct GangParams {
    ScanParams scan;
    int rows;           // mask rows (pow2-padded placements)
    int n_constrained;  // rows [0, n_constrained) are topology domains
    int has_fallback;   // row n_constrained is the unconstrained parent
};

// int32 words of one row's work slice: the carry planes, the hard-spread
// domain counts and the scan scratch
__host__ __device__ inline size_t gang_work_words(const ScanParams& p) {
    const size_t nb = (size_t)p.Nb;
    return nb * p.R + nb * 2 + nb * p.S + (p.ipa_active ? 3 * nb * p.Ta : 0)
           + (p.dom_carry ? (size_t)p.K * p.D * p.S : 0) + scan_scratch_words(p);
}

__device__ __forceinline__ void copy_words(int* dst, const int* src, size_t n) {
    for (size_t i = threadIdx.x; i < n; i += SCAN_NT) dst[i] = src[i];
}

__global__ void __launch_bounds__(SCAN_NT, 1) gang_assign_kernel(
    GangParams g, ScanArgs base, const uint8_t* __restrict__ masks, int* work, int* out) {
    __shared__ int sred[SCAN_NWARPS][2];
    __shared__ int sres[2];
    const ScanParams& p = g.scan;
    const int d = blockIdx.x;
    const size_t nb = (size_t)p.Nb;
    const uint8_t* mask = masks + (size_t)d * nb;

    // this row's carry, from the pre-scan planes
    ScanArgs a = base;
    a.mask = mask;
    int* w = work + (size_t)d * gang_work_words(p);
    a.used = w;
    w += nb * p.R;
    a.nonzero_used = w;
    w += nb * 2;
    a.sel_counts = w;
    w += nb * p.S;
    copy_words(a.used, base.used, nb * p.R);
    copy_words(a.nonzero_used, base.nonzero_used, nb * 2);
    copy_words(a.sel_counts, base.sel_counts, nb * p.S);
    if (p.ipa_active) {
        a.ipa_counts = w;
        a.ipa_anti = w + nb * p.Ta;
        a.ipa_pref = w + 2 * nb * p.Ta;
        w += 3 * nb * p.Ta;
        copy_words(a.ipa_counts, base.ipa_counts, nb * p.Ta);
        copy_words(a.ipa_anti, base.ipa_anti, nb * p.Ta);
        copy_words(a.ipa_pref, base.ipa_pref, nb * p.Ta);
    }
    if (p.dom_carry) {
        a.dom_counts = w;
        w += (size_t)p.K * p.D * p.S;
    }
    a.scratch = w;
    a.winners = out + (size_t)d * p.P;

    // the placement score on the pre-scan planes: per node the mean of the
    // cpu and memory free shares over the columns with capacity, then the
    // mean over the mask's nodes that have such a column
    int v[2] = {0, 0};  // counted nodes, their score sum
    for (int n = threadIdx.x; n < p.Nb; n += SCAN_NT) {
        int score = 0, parts = 0;
        for (int col = GANG_CPU_COL; col <= GANG_MEM_COL; ++col) {
            const int cap = base.alloc[(size_t)n * p.R + col];
            if (cap <= 0) continue;
            const int req = min(base.used[(size_t)n * p.R + col], cap);
            score = wadd(score, floordiv(wmul(cap - req, MAX_NODE_SCORE), cap));
            parts += 1;
        }
        if (mask[n] && parts > 0) {
            v[0] += 1;
            v[1] = wadd(v[1], floordiv(score, parts));
        }
    }
    block_reduce<2>(v, 0u, 0u, sred, sres);  // ends in a barrier: the copies are in
    const int pscore = v[0] > 0 ? floordiv(v[1], v[0]) : 0;

    const ScanEnd end = scan_block<true>(p, a);
    __syncthreads();
    if (threadIdx.x == 0) {
        int placed = 0;
        for (int i = 0; i < p.P; ++i)
            placed += a.winners[i] >= 0 && base.feats[(size_t)i * p.F + p.f_active] != 0;
        int* rows_out = out + (size_t)g.rows * p.P;
        rows_out[d] = end.cursor;
        rows_out[g.rows + d] = end.overflow;
        rows_out[2 * g.rows + d] = placed;
        rows_out[3 * g.rows + d] = pscore;
    }
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

// ptrs: alloc, domain, valid, static_ok, taint_cnt, aff_raw, img,
// aff_has_pref, feats, tie_words, logtab, used, nonzero_used, sel_counts,
// ipa_counts, ipa_anti, ipa_pref, ipa_term_key (the pre-scan planes, read
// only; IPA pointers 0 without IPA), masks, work, out
extern "C" int launch_gang_assign(const GangParams* g, void* const* ptrs, void* stream) {
    const size_t dyn = scan_smem_bytes(g->scan);
    cudaError_t err = cudaFuncSetAttribute(
        gang_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
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
    cudaStream_t s = (cudaStream_t)stream;
    gang_assign_kernel<<<g->rows, SCAN_NT, dyn, s>>>(
        *g, a, (const uint8_t*)ptrs[18], (int*)ptrs[19], (int*)ptrs[20]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gang_pick_kernel<<<1, 32, 0, s>>>(*g, (const int*)ptrs[8], (int*)ptrs[20]);
    return (int)cudaGetLastError();
}
