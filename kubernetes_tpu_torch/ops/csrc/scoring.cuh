// Filter and score formulas shared by the kernels: K1 static_parts, K2
// assign_scan and K4 fit_and_score include this header, so each formula
// has one definition. The helpers are templates over the kernel's params
// struct; they read the same field names (f_* packed-feature offsets, the
// scoring config) from each. Besides the per-node formulas: the pod's
// spread and inter-pod affinity slots, and the InterPodAffinity passes
// (per-domain term sums over a participation mask, the three filters, the
// raw score) that K2 and K4 both run.
//
// Numerics as in common.cuh: floordiv() for every integer division, the
// rounded float32 intrinsics with -fmad=false, and the int32 lines that can
// overflow (the normalizers with no feasible node) in wrapping arithmetic,
// as XLA's int32 wraps: signed overflow is undefined in C++.
#pragma once

#include "common.cuh"

#define PODS_COL 3
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}

// --- filters ---------------------------------------------------------------

// NodeResourcesFit (fit.go:673-760): resource r is short on the node; the
// PODS column is never "insufficient", it has its own too-many-pods check
__device__ __forceinline__ bool fit_insufficient(int r, int req, int alloc,
                                                 int used) {
    return r != PODS_COL && req > 0 && req > alloc - used;
}
__device__ __forceinline__ bool too_many_pods(const int* alloc_row,
                                              const int* used_row) {
    return used_row[PODS_COL] + 1 > alloc_row[PODS_COL];
}

// TaintToleration filter: a NoSchedule/NoExecute taint the pod does not
// tolerate (taint ids are vocab ids < T, -1 pads)
template <typename P>
__device__ __forceinline__ bool untolerated_taint(const P& p, const int* taint_row,
                                                  const int* f) {
    for (int j = 0; j < p.T; ++j) {
        const int tid = taint_row[j];
        if (tid >= 0 && !f[p.f_tol + clampi(tid, 0, p.T - 1)]) return true;
    }
    return false;
}

// NodePorts: any used host-port bit the pod also wants
template <typename P>
__device__ __forceinline__ bool ports_conflict(const P& p, const int* port_row,
                                               const int* f) {
    if (!f[p.f_has_ports]) return false;
    for (int j = 0; j < p.W; ++j) {
        if (port_row[j] & f[p.f_ports + j]) return true;
    }
    return false;
}

// --- scores ----------------------------------------------------------------

// TaintToleration score input: intolerable PreferNoSchedule taints
template <typename P>
__device__ __forceinline__ int prefer_taint_count(const P& p, const int* row,
                                                  const int* f) {
    int cnt = 0;
    for (int j = 0; j < p.Tp; ++j) {
        const int tid = row[j];
        if (tid >= 0 && !f[p.f_tol_prefer + clampi(tid, 0, p.Tp - 1)]) ++cnt;
    }
    return cnt;
}

// ImageLocality (image_locality.go:93-105), totals in KiB
template <typename P>
__device__ __forceinline__ int image_score(const P& p, const int* kib_row,
                                           const int* f) {
    int total = 0;
    for (int j = 0; j < 8; ++j) {
        const int idx = f[p.f_img_idx + j];
        if (idx >= 0) total += kib_row[clampi(idx, 0, p.I - 1)];
    }
    const int min_kib = 23 * 1024;
    const int max_thr = 1024 * 1024 * f[p.f_num_containers];
    if (total < min_kib) return 0;
    if (total > max_thr) return MAX_NODE_SCORE;
    return floordiv(MAX_NODE_SCORE * (total - min_kib), max(max_thr - min_kib, 1));
}

// requested-including-pod per node; cpu/mem use NonZero accounting
// (resource_allocation.go:138)
template <typename P>
__device__ __forceinline__ int requested_for(const P& p, int col,
                                             const int* used_row,
                                             const int* nz_row, const int* f) {
    if (col == 0) return nz_row[0] + f[p.f_nz_req + 0];
    if (col == 1) return nz_row[1] + f[p.f_nz_req + 1];
    return used_row[col] + f[p.f_req + col];
}

// least_allocated.go:30-52, most_allocated.go, and the RequestedToCapacity
// Ratio piecewise line (requested_to_capacity_ratio.go)
template <typename P>
__device__ __forceinline__ int strategy_score(const P& p, int requested,
                                              int capacity) {
    const int cap = max(capacity, 1);
    if (p.strategy == 0) return floordiv((cap - requested) * MAX_NODE_SCORE, cap);
    if (p.strategy == 1) return floordiv(requested * MAX_NODE_SCORE, cap);
    // the first segment whose right end covers util, else the last score;
    // util at or below the first x takes y0
    const int util = floordiv(requested * 100, cap);
    int out = p.rtc_y[p.n_rtc - 1];
    for (int i = 0; i + 1 < p.n_rtc; ++i) {
        const int x0 = p.rtc_x[i], y0 = p.rtc_y[i];
        const int x1 = p.rtc_x[i + 1], y1 = p.rtc_y[i + 1];
        if (util <= x1) {
            out = (x1 == x0) ? y1 : y0 + floordiv((y1 - y0) * (util - x0), x1 - x0);
            break;
        }
    }
    return util <= p.rtc_x[0] ? p.rtc_y[0] : out;
}

// NodeResourcesFit score (resource_allocation.go:52): weighted mean of the
// strategy scores over the resources the node has
template <typename P>
__device__ __forceinline__ int fit_score(const P& p, const int* alloc_row,
                                         const int* used_row, const int* nz_row,
                                         const int* f) {
    int total = 0, tw = 0;
    for (int i = 0; i < p.n_fit; ++i) {
        const int col = p.fit_col[i], w = p.fit_w[i];
        const int a = alloc_row[col];
        if (a > 0) {
            const int req = min(requested_for(p, col, used_row, nz_row, f), a);
            total += strategy_score(p, req, a) * w;
            tw += w;
        }
    }
    return tw > 0 ? floordiv(total, max(tw, 1)) : 0;
}

// BalancedAllocation (balanced_allocation.go:204-230) in float32, every op
// rounded as numpy rounds it
template <typename P>
__device__ __forceinline__ int balanced_score(const P& p, const int* alloc_row,
                                              const int* used_row,
                                              const int* nz_row, const int* f) {
    const int aa = alloc_row[p.bal_a], ab = alloc_row[p.bal_b];
    const float fa = fminf(
        __fdiv_rn(__int2float_rn(requested_for(p, p.bal_a, used_row, nz_row, f)),
                  __int2float_rn(max(aa, 1))),
        1.0f);
    const float fb = fminf(
        __fdiv_rn(__int2float_rn(requested_for(p, p.bal_b, used_row, nz_row, f)),
                  __int2float_rn(max(ab, 1))),
        1.0f);
    const float mean = __fdiv_rn(__fadd_rn(fa, fb), 2.0f);
    const float da = __fsub_rn(fa, mean), db = __fsub_rn(fb, mean);
    const float var = __fdiv_rn(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)), 2.0f);
    const float sd = __fsqrt_rn(var);
    return (aa > 0 && ab > 0) ? __float2int_rz(__fmul_rn(__fsub_rn(1.0f, sd), 100.0f))
                              : 0;
}

// the normalizers over the feasible set (kernels.py:590-627)
__device__ __forceinline__ int taint_normalized(int cnt, int max_cnt) {
    return max_cnt > 0 ? MAX_NODE_SCORE - floordiv(cnt * MAX_NODE_SCORE, max(max_cnt, 1))
                       : MAX_NODE_SCORE;
}
__device__ __forceinline__ int affinity_normalized(int raw, int mx) {
    return mx > 0 ? floordiv(raw * MAX_NODE_SCORE, max(mx, 1)) : raw;
}
// PodTopologySpread: inverted, an all-equal spread scores 100
__device__ __forceinline__ int pts_normalized(int raw, int mx, int mn) {
    const int spread = wsub(mx, mn);
    return spread == 0 ? MAX_NODE_SCORE
                       : floordiv(wmul(wsub(mx, raw), MAX_NODE_SCORE), max(spread, 1));
}
// InterPodAffinity: an all-equal spread scores 100 only when positive
__device__ __forceinline__ int ipa_normalized(int raw, int mx, int mn) {
    const int spread = wsub(mx, mn);
    if (spread == 0) return mx > 0 ? MAX_NODE_SCORE : 0;
    return floordiv(wmul(MAX_NODE_SCORE, wsub(raw, mn)), max(spread, 1));
}

// --- the pod's spread and inter-pod affinity slots ----------------------------

#define MAX_REQ_TERMS 4
#define MAX_PREF_TERMS 8

// one spread-constraint or IPA-term slot of the pod, resolved by thread 0
struct Slot {
    int on;   // traced and active
    int key;  // topology key slot; -1 when outside the planes (no node has it)
    int dk;   // 0 = singleton key (the domain is the node), else table size
    int col;  // selector column (spread) or term column (IPA)
    int a;    // spread: max skew; IPA affinity: matches itself; preferred: weight
    int b;    // spread: the pod matches its own selector
};

__device__ __forceinline__ int dom_at(const int* dom_row, const Slot& s) {
    return s.key >= 0 ? dom_row[s.key] : -1;
}

// spread constraint slot c of the pod (hard or soft); traced slots are the
// first n_hard / n_soft of the MC feature columns
template <typename P>
__device__ __forceinline__ Slot spread_slot(const P& p, const int* f, bool hard, int c) {
    Slot s = {0, -1, 0, 0, 0, 0};
    if (c >= p.MC) return s;
    const int act = hard ? p.f_hard_active : p.f_soft_active;
    const int fkey = hard ? p.f_hard_key : p.f_soft_key;
    const int fsel = hard ? p.f_hard_sel : p.f_soft_sel;
    s.on = c < (hard ? p.n_hard : p.n_soft) && f[act + c] != 0;
    const int key = f[fkey + c];
    s.key = (key >= 0 && key < p.K) ? key : -1;
    s.dk = s.key >= 0 ? p.topo_dk[s.key] : 0;
    s.col = clampi(f[fsel + c], 0, p.S - 1);
    if (hard) {
        s.a = f[p.f_hard_skew + c];
        s.b = f[p.f_hard_self + c];
    }
    return s;
}

// inter-pod affinity term slot s of the pod: kind 0 required
// anti-affinity, 1 required affinity, 2 preferred
template <typename P>
__device__ __forceinline__ Slot ipa_slot(const P& p, const int* f, const int* ipa_term_key,
                                         int kind, int s) {
    const int traced = kind == 0 ? p.n_ipa_anti : (kind == 1 ? p.n_ipa_aff : p.n_ipa_pref);
    const int t = f[(kind == 0 ? p.f_ipa_anti_t : (kind == 1 ? p.f_ipa_aff_t : p.f_ipa_pref_t)) + s];
    Slot q = {0, -1, 0, 0, 0, 0};
    q.on = s < traced && t >= 0;
    // jnp.take of clip(t, 0): an inactive slot reads term 0
    q.col = clampi(t, 0, p.Ta - 1);
    const int key = ipa_term_key[q.col];
    q.key = (key >= 0 && key < p.K) ? key : -1;
    q.dk = q.key >= 0 ? p.topo_dk[q.key] : 0;
    if (kind == 1) q.a = f[p.f_ipa_aff_self + s];
    if (kind == 2) q.a = f[p.f_ipa_pref_w + s];
    return q;
}

// every slot of the pod into the shared arrays, one slot per lane of warp 0
// (lanes 0-3 hard, 4-7 soft, with IPA 8-11 anti, 12-15 affinity, 16-23
// preferred): the slots' feature loads run in parallel, not as one chain.
// Call from all of warp 0; the caller syncs before reading the arrays.
template <typename P>
__device__ __forceinline__ void pod_slots(const P& p, const int* f, const int* ipa_term_key,
                                          bool ipa, Slot* hard, Slot* soft, Slot* anti,
                                          Slot* aff, Slot* pref) {
    const int l = threadIdx.x & 31;
    if (l < 4) hard[l] = spread_slot(p, f, true, l);
    else if (l < 8) soft[l - 4] = spread_slot(p, f, false, l - 4);
    else if (ipa && l < 12) anti[l - 8] = ipa_slot(p, f, ipa_term_key, 0, l - 8);
    else if (ipa && l < 16) aff[l - 12] = ipa_slot(p, f, ipa_term_key, 1, l - 12);
    else if (ipa && l < 24) pref[l - 16] = ipa_slot(p, f, ipa_term_key, 2, l - 16);
}

// whether any of the pod's first n feature columns from `col` is set; call
// from all 32 lanes of one warp, every lane gets the answer
__device__ __forceinline__ bool any_column(const int* f, int col, int n) {
    bool a = false;
    for (int c = threadIdx.x & 31; c < n; c += 32) a |= f[col + c] != 0;
    return __any_sync(FULL_MASK, a);
}

// key slots that some term matching the pod uses, as a bit mask; called by
// all 32 lanes of one warp, every lane gets the mask
template <typename P>
__device__ __forceinline__ int matched_key_mask(const P& p, const int* f,
                                                const int* ipa_term_key) {
    unsigned bits = 0;
    for (int t = threadIdx.x & 31; t < p.Ta; t += 32) {
        const int k = ipa_term_key[t];
        if (f[p.f_ipa_match + t] && k >= 0 && k < p.K) bits |= 1u << k;
    }
    return (int)__reduce_or_sync(FULL_MASK, bits);
}

// --- InterPodAffinity passes ---------------------------------------------------

// sum of `row[t]` over the terms on key slot k that match the pod: the
// existing pods' side of the reference's [Nb, Ta] x [Ta] float32 matvec
template <typename P>
__device__ __forceinline__ int term_col(const P& p, const int* row, const int* f,
                                        const int* tkey, int k) {
    int s = 0;
    for (int t = 0; t < p.Ta; ++t) {
        if (f[p.f_ipa_match + t] && tkey[t] == k) s = wadd(s, row[t]);
    }
    return s;
}

// One pod's inter-pod affinity state in a kernel: its slots (shared
// arrays), the matched key mask, the carried planes and two D-word table
// regions of shared memory. Filter tables: the na + nfa required terms,
// then the existing pods' anti-affinity per key slot; score tables: the np
// preferred terms, then the existing pods' preferred terms per key slot.
struct Ipa {
    const Slot* anti;
    const Slot* aff;
    const Slot* pref;
    int na, nfa, np, exmask, D;
    int* filt;
    int* score;
    const int* counts;  // ipa_counts [Nb, Ta]
    const int* anti_p;  // ipa_anti [Nb, Ta]
    const int* pref_p;  // ipa_pref [Nb, Ta]
    const int* tkey;    // ipa_term_key [Ta]
};

// How a pass adds into a per-domain table: add(table, word, value, on).
// AtomicAdd: one shared-memory atomic per adding lane (K2). WarpAdd (K4):
// the lanes of a warp that add into one word fold their values first
// (__match_any_sync, then __reduce_add_sync over the peers) and one lane
// adds the sum, so a warp makes one atomic per distinct word; every lane
// of the warp must call it, on or not.
struct AtomicAdd {
    __device__ __forceinline__ void operator()(int* t, int i, int v, bool on) const {
        if (on) atomicAdd(t + i, v);
    }
};
struct WarpAdd {
    __device__ __forceinline__ void operator()(int* t, int i, int v, bool on) const {
        const unsigned act = __ballot_sync(FULL_MASK, on);
        if (!on) return;
        const unsigned peers = __match_any_sync(act, i);
        const int s = (int)__reduce_add_sync(peers, (unsigned)v);
        if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(t + i, s);
    }
};

// filter phase at a valid node (live: the caller's node is one; a lane
// with live false adds nothing): the required terms' per-domain sums and
// "anywhere" flags (aff_any[s] is max-reduced by the caller), and the
// existing pods' anti-affinity per key slot (filtering.go:352-412)
template <typename P, typename Add = AtomicAdd>
__device__ __forceinline__ void ipa_filter_stats(const P& p, const Ipa& q, const int* f, int n,
                                                 const int* dom_row, int* aff_any,
                                                 Add add = {}, bool live = true) {
    for (int s = 0; s < q.na + q.nfa; ++s) {
        const Slot t = s < q.na ? q.anti[s] : q.aff[s - q.na];
        const int d = dom_at(dom_row, t);
        const bool on = live && t.on && d >= 0;
        const int cnt = on ? q.counts[(size_t)n * p.Ta + t.col] : 0;
        if (on && s >= q.na) aff_any[s - q.na] = max(aff_any[s - q.na], cnt > 0 ? 1 : 0);
        if (t.dk > 0) add(q.filt + (size_t)s * q.D, clampi(d, 0, t.dk - 1), cnt, on);
    }
    if (p.ex_anti) {
        for (int k = 0; k < p.K; ++k) {
            const int dk = p.topo_dk[k], d = dom_row[k];
            if (!((q.exmask >> k) & 1) || dk == 0) continue;
            const bool on = live && d >= 0;
            const int col = on ? term_col(p, q.anti_p + (size_t)n * p.Ta, f, q.tkey, k) : 0;
            add(q.filt + (size_t)(q.na + q.nfa + k) * q.D, clampi(d, 0, dk - 1), col,
                on && col != 0);
        }
    }
}

// the three checks at node n (vn: n is valid): existing pods' anti-affinity,
// the pod's anti-affinity, the pod's affinity with the self-match bootstrap
template <typename P>
__device__ __forceinline__ void ipa_filters_at(const P& p, const Ipa& q, const int* f, int n,
                                               bool vn, const int* dom_row, const int* aff_any,
                                               bool& ipa1, bool& ipa2, bool& ipa3) {
    ipa1 = ipa2 = ipa3 = false;
    if (p.ex_anti) {
        for (int k = 0; k < p.K && !ipa1; ++k) {
            const int dk = p.topo_dk[k], d = dom_row[k];
            if (!((q.exmask >> k) & 1) || d < 0) continue;
            const int at = dk == 0 ? (vn ? term_col(p, q.anti_p + (size_t)n * p.Ta, f, q.tkey, k) : 0)
                                   : q.filt[(size_t)(q.na + q.nfa + k) * q.D + clampi(d, 0, dk - 1)];
            ipa1 = at > 0;
        }
    }
    for (int s = 0; s < q.na + q.nfa; ++s) {
        const bool is_aff = s >= q.na;
        const Slot t = is_aff ? q.aff[s - q.na] : q.anti[s];
        if (!t.on) continue;
        // a term matching nowhere passes when the pod matches its own term
        if (is_aff && !aff_any[s - q.na] && t.a) continue;
        const int d = dom_at(dom_row, t);
        int at = 0;
        if (d >= 0) {
            at = t.dk == 0 ? (vn ? q.counts[(size_t)n * p.Ta + t.col] : 0)
                           : q.filt[(size_t)s * q.D + clampi(d, 0, t.dk - 1)];
        }
        const bool ok = d >= 0 && at > 0;
        if (is_aff) ipa3 |= !ok;
        else ipa2 |= ok;
    }
}

// score phase at a feasible node (live: the caller's node is one): the
// preferred terms' per-domain sums and the existing pods' preferred terms
// per key slot (scoring.go:81-257)
template <typename P, typename Add = AtomicAdd>
__device__ __forceinline__ void ipa_score_stats(const P& p, const Ipa& q, const int* f, int n,
                                                const int* dom_row, Add add = {},
                                                bool live = true) {
    for (int s = 0; s < q.np; ++s) {
        const Slot t = q.pref[s];
        if (!t.on || t.dk == 0) continue;
        const int d = dom_at(dom_row, t);
        const bool on = live && d >= 0;
        add(q.score + (size_t)s * q.D, clampi(d, 0, t.dk - 1),
            on ? q.counts[(size_t)n * p.Ta + t.col] : 0, on);
    }
    if (p.ex_pref_add) {
        for (int k = 0; k < p.K; ++k) {
            const int dk = p.topo_dk[k], d = dom_row[k];
            if (!((q.exmask >> k) & 1) || dk == 0) continue;
            const bool on = live && d >= 0;
            add(q.score + (size_t)(q.np + k) * q.D, clampi(d, 0, dk - 1),
                on ? term_col(p, q.pref_p + (size_t)n * p.Ta, f, q.tkey, k) : 0, on);
        }
    }
}

// the raw InterPodAffinity score at node n (fe: n is feasible)
template <typename P>
__device__ __forceinline__ int ipa_raw_at(const P& p, const Ipa& q, const int* f, int n, bool fe,
                                          const int* dom_row) {
    int raw = 0;
    for (int s = 0; s < q.np; ++s) {
        const Slot t = q.pref[s];
        const int d = dom_at(dom_row, t);
        if (!t.on || d < 0) continue;
        const int at = t.dk == 0 ? (fe ? q.counts[(size_t)n * p.Ta + t.col] : 0)
                                 : q.score[(size_t)s * q.D + clampi(d, 0, t.dk - 1)];
        raw = wadd(raw, wmul(t.a, at));
    }
    if (p.ex_pref_add) {
        for (int k = 0; k < p.K; ++k) {
            const int dk = p.topo_dk[k], d = dom_row[k];
            if (!((q.exmask >> k) & 1) || d < 0) continue;
            const int at = dk == 0 ? (fe ? term_col(p, q.pref_p + (size_t)n * p.Ta, f, q.tkey, k) : 0)
                                   : q.score[(size_t)(q.np + k) * q.D + clampi(d, 0, dk - 1)];
            raw = wadd(raw, at);
        }
    }
    return raw;
}
