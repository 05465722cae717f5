// The greedy pod scan of one thread block, shared by K2 assign_scan (one
// block over the wave) and K5 gang_assign (one block per placement mask):
// the reference's _assign_step (kubernetes_tpu/ops/kernels.py:925-1250) in
// a loop over the pods, both tiers, with hard spread and inter-pod affinity.
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
// per-domain tables by the winner's delta.
//
// Node validity is read in one place, node_valid(): with MASKED (K5) it is
// valid & mask, the placement-narrowed snapshot of the reference's
// _gang_assign_jit, so every participation set (the hard-spread domain
// counts and singleton minima, the IPA valid-set sums) follows the mask.
// K1's static_ok already includes valid, so static_at() narrows it by the
// same mask; everything else gates on the feasible set built from it.
//
// Layout: the block's 1024 threads make strided passes over the node axis
// (warps read contiguous nodes) with block reductions between them: F
// (only with hard spread or IPA) the valid-set statistics, G the live
// reject mask and the replay gate, A feasibility and the feasible-set
// statistics, B the spread and IPA raw scores, C the totals, D the tie
// ballots. Per-domain sums are int32 shared-memory atomics in one pool of
// D-word tables reused between the filter and score phases (exact; the
// reference used one-hot float matmuls at HIGHEST precision); the
// hard-spread domain counts [K, D, S] are carried in device memory, built
// once per scan over the valid nodes and bumped at each placement. Warp 0
// does the prefix count and the 16-word draw (one word per lane); the whole
// block applies the winner's row adds and patches the signature rows (one
// thread per row). Carry planes are updated in place (the callers' copies).
#pragma once

#include "scoring.cuh"

#define SCAN_NT 1024
#define SCAN_NWARPS (SCAN_NT / 32)
#define SCAN_RED 8
#define SCAN_BIG 2147483647

// shared-memory pool words: the larger of the filter phase's tables (the
// required IPA terms, the existing pods' anti-affinity per key slot) and the
// score phase's (soft spread segment and participant tables, the preferred
// IPA terms, the existing pods' preferred terms per key slot)
__host__ __device__ inline int scan_pool_words(const ScanParams& p) {
    const int filt = p.n_ipa_anti + p.n_ipa_aff + (p.ex_anti ? p.K : 0);
    const int score = 2 * p.n_soft + p.n_ipa_pref + (p.ex_pref_add ? p.K : 0);
    const int tables = filt > score ? filt : score;
    return (tables > 1 ? tables : 1) * p.D;
}

// dynamic shared memory of one scanning block: the pool, then the ballots
__host__ __device__ inline size_t scan_smem_bytes(const ScanParams& p) {
    return ((size_t)scan_pool_words(p) + (size_t)((p.Nb + 31) / 32)) * sizeof(int);
}

// int32 words of per-scan scratch: ew, spread raw, IPA raw, total, feasible
// and reject rows, then the domain presence [K, D] with the hard-spread carry
__host__ __device__ inline size_t scan_scratch_words(const ScanParams& p) {
    return 6 * (size_t)p.Nb + (p.dom_carry ? (size_t)p.K * p.D : 0);
}

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
    int* scratch;     // scan_scratch_words(p)
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
};

// meaningful in thread 0: the tie words consumed up to the cursor, whether a
// draw ran out of words, and with dedup the steps by tier
struct ScanEnd {
    int cursor, overflow, n_full, n_replay;
};

template <bool MASKED>
__device__ __forceinline__ ScanEnd scan_block(const ScanParams& p, const ScanArgs& a) {
    extern __shared__ int pool[];  // domain tables, then the tie ballots
    __shared__ Slot hard[SCAN_MAX_SOFT], soft[SCAN_MAX_SOFT];
    __shared__ Slot anti[MAX_REQ_TERMS], aff[MAX_REQ_TERMS], pref[MAX_PREF_TERMS];
    __shared__ int exmask, any_soft, any_hard, win_sh;
    __shared__ int ndom[SCAN_MAX_SOFT];  // soft slots' domains with a participant
    __shared__ int red[SCAN_NWARPS][SCAN_RED];
    __shared__ int res[SCAN_RED];

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
    // the one place the scan reads node validity (see the header comment)
    auto node_valid = [&](int n) -> bool {
        return a.valid[n] != 0 && (!MASKED || a.mask[n] != 0);
    };
    auto static_at = [&](size_t o, int n) -> bool {
        return static_ok[o] != 0 && (!MASKED || a.mask[n] != 0);
    };

    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int Nb = p.Nb, D = p.D, S = p.S;
    const int nh = p.n_hard, ns = p.n_soft;
    const int na = p.n_ipa_anti, nfa = p.n_ipa_aff, np = p.n_ipa_pref;
    const bool dedup = p.G > 0;
    const bool gated = nh > 0 || p.ipa_active;
    const int filter_tables = na + nfa + (p.ex_anti ? p.K : 0);
    const int score_tables = 2 * ns + np + (p.ex_pref_add ? p.K : 0);
    unsigned* ballots = reinterpret_cast<unsigned*>(pool + scan_pool_words(p));
    const int nwords = (Nb + 31) / 32;
    int* ew_s = a.scratch;
    int* raw_s = a.scratch + (size_t)Nb;
    int* iraw_s = a.scratch + 2 * (size_t)Nb;
    int* total_s = a.scratch + 3 * (size_t)Nb;
    int* feas_s = a.scratch + 4 * (size_t)Nb;
    int* fail_s = a.scratch + 5 * (size_t)Nb;
    int* present = a.scratch + 6 * (size_t)Nb;  // [K, D] with dom_carry
    auto table = [&](int i) { return pool + (size_t)i * D; };
    ScanEnd end = {p.cursor0, 0, 0, 0};  // cursor meaningful in warp 0
    int& cursor = end.cursor;

    // prologue: the hard-spread carry, per key slot and domain the sum of
    // sel_counts over the domain's valid nodes, and the static presence
    if (p.dom_carry) {
        for (size_t i = tid; i < (size_t)p.K * D * S; i += SCAN_NT) dom_counts[i] = 0;
        for (int i = tid; i < p.K * D; i += SCAN_NT) present[i] = 0;
        __syncthreads();
        for (int n = tid; n < Nb; n += SCAN_NT) {
            if (!node_valid(n)) continue;
            for (int k = 0; k < p.K; ++k) {
                const int dk = p.topo_dk[k], d = domain[(size_t)n * p.K + k];
                if (dk == 0 || d < 0) continue;
                const int dc = clampi(d, 0, dk - 1);
                present[k * D + dc] = 1;
                for (int s = 0; s < S; ++s)
                    atomicAdd(&dom_counts[((size_t)k * D + dc) * S + s],
                              sel_counts[(size_t)n * S + s]);
            }
        }
        __syncthreads();
    }

    for (int pod = 0; pod < p.P; ++pod) {
        const int* f = feats + (size_t)pod * p.F;
        const bool active = f[p.f_active] != 0;
        // without dedup an inactive pad slot is skipped: it places nothing
        // and draws nothing; with dedup it is its own signature and still
        // takes its tier (table row and sig_scores row)
        if (!dedup && !active) {
            if (tid == 0) out[pod] = -1;
            continue;
        }
        const int sid = dedup ? clampi(sig_ids[pod], 0, p.G - 1) : pod;  // static row
        const size_t srow = (size_t)sid * Nb;
        if (wid == 0) {  // the pod's slots, the key slots its matching terms use
            pod_slots(p, f, ipa_term_key, p.ipa_active, hard, soft, anti, aff, pref);
            const bool anys = any_column(f, p.f_soft_active, p.MC);
            // a hard slot is on iff traced (n_hard <= 4) and active
            const bool anyh = any_column(f, p.f_hard_active, min(nh, p.MC));
            const int bits = p.ipa_active ? matched_key_mask(p, f, ipa_term_key) : 0;
            if (lane < SCAN_MAX_SOFT) ndom[lane] = 0;
            if (lane == 0) {
                any_soft = anys;
                any_hard = anyh;
                exmask = bits;
            }
        }
        __syncthreads();
        const bool has_fail = any_hard || p.ipa_active;
        const Ipa ipa = {anti, aff, pref, na, nfa, np, exmask, D,
                         table(0), table(2 * ns), ipa_counts, ipa_anti, ipa_pref,
                         ipa_term_key};

        // F. statistics over the valid nodes (PreFilter participation): the
        // hard slots' min counts, the required IPA terms' domain sums and
        // "anywhere" flags, the existing pods' anti-affinity per key slot
        int hmin[SCAN_MAX_SOFT] = {0, 0, 0, 0};
        int aff_any[MAX_REQ_TERMS] = {0, 0, 0, 0};
        if (has_fail) {
            for (int i = tid; i < filter_tables * D; i += SCAN_NT) pool[i] = 0;
            __syncthreads();
            int v[SCAN_RED];
            for (int i = 0; i < SCAN_RED; ++i) v[i] = i < 4 ? SCAN_BIG : 0;
            if (p.dom_carry) {  // a non-singleton key: over the present domains
                for (int c = 0; c < nh; ++c) {
                    const Slot s = hard[c];
                    if (!s.on || s.dk == 0) continue;
                    for (int d = tid; d < D; d += SCAN_NT) {
                        if (present[s.key * D + d])
                            v[c] = min(v[c], dom_counts[((size_t)s.key * D + d) * S + s.col]);
                    }
                }
            }
            for (int n = tid; n < Nb; n += SCAN_NT) {
                if (!node_valid(n)) continue;
                const int* dom_row = domain + (size_t)n * p.K;
                for (int c = 0; c < nh; ++c) {  // a singleton key: over the nodes
                    const Slot s = hard[c];
                    if (s.on && s.dk == 0 && dom_at(dom_row, s) >= 0)
                        v[c] = min(v[c], sel_counts[(size_t)n * S + s.col]);
                }
                if (p.ipa_active) ipa_filter_stats(p, ipa, f, n, dom_row, v + 4);
            }
            block_reduce<SCAN_RED>(v, 0xF0u, 0x0Fu, red, res);
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) hmin[c] = v[c] == SCAN_BIG ? 0 : v[c];
            for (int s = 0; s < MAX_REQ_TERMS; ++s) aff_any[s] = v[4 + s];
        }

        // G. the live reject mask (hard spread, IPA) and, for a resident
        // signature under hard spread or IPA, the replay gate: the row's
        // feasibility must equal the live one on every node row
        const bool check = dedup && gated && t_valid[sid];
        int mismatch = 0;
        if (has_fail || check) {
            for (int n = tid; n < Nb; n += SCAN_NT) {
                bool fail = false;
                if (has_fail) {
                    const int* dom_row = domain + (size_t)n * p.K;
                    for (int c = 0; c < nh && !fail; ++c) {
                        const Slot s = hard[c];
                        if (!s.on) continue;
                        const int d = dom_at(dom_row, s);
                        if (d < 0) {
                            fail = true;  // the node lacks the key
                            break;
                        }
                        const int count =
                            s.dk == 0 ? sel_counts[(size_t)n * S + s.col]
                                      : dom_counts[((size_t)s.key * D + clampi(d, 0, D - 1)) * S + s.col];
                        fail = count + s.b - hmin[c] > s.a;
                    }
                    if (!fail && p.ipa_active) {
                        bool i1, i2, i3;
                        ipa_filters_at(p, ipa, f, n, node_valid(n), dom_row, aff_any, i1, i2, i3);
                        fail = i1 || i2 || i3;
                    }
                    fail_s[n] = fail;
                }
                if (check) {
                    const size_t o = srow + n;
                    const bool live = static_at(o, n) && !t_ffit[o] && !fail;
                    mismatch |= live != (t_feas[o] != 0);
                }
            }
        }
        const int refused = __syncthreads_or(mismatch);
        const bool replay = dedup && t_valid[sid] && !refused;
        const bool capture = dedup && !replay;

        // A. feasibility, fit + balanced, the static normalizers' maxima and
        // the feasible-set statistics (soft spread per domain: accumulated
        // by the full tier, loaded from the resident row by a replay; the
        // preferred IPA terms)
        for (int i = tid; i < score_tables * D; i += SCAN_NT) {
            int val = 0;
            if (replay && i < 2 * ns * D) {
                const int c = (i / D) % ns;
                val = (i < ns * D ? t_segs : t_pcs)[((size_t)sid * p.CT + c) * D + i % D];
                // a replay's domain count: the table's entries with pcs > 0
                if (i >= ns * D && val > 0 && soft[c].on && soft[c].dk > 0)
                    atomicAdd(&ndom[c], 1);
            }
            pool[i] = val;
        }
        __syncthreads();
        int w[SCAN_RED];  // max taint count, max aff raw, feasible count, singleton nd[4]
        for (int i = 0; i < SCAN_RED; ++i) w[i] = 0;
        for (int n = tid; n < Nb; n += SCAN_NT) {
            const int* dom_row = domain + (size_t)n * p.K;
            bool fe;
            int ew = 0;
            if (replay) {
                fe = t_feas[srow + n] != 0;
                ew = t_ew[srow + n];
            } else {
                const int* a_row = alloc + (size_t)n * p.R;
                const int* u_row = used + (size_t)n * p.R;
                bool ffit = too_many_pods(a_row, u_row);
                for (int r = 0; r < p.R; ++r)
                    ffit |= fit_insufficient(r, f[p.f_req + r], a_row[r], u_row[r]);
                fe = static_at(srow + n, n) && !ffit && !(has_fail && fail_s[n]);
                if (fe || capture) {  // the table row holds ew on every row
                    const int* nz_row = nonzero_used + (size_t)n * 2;
                    ew = wadd(wmul(fit_score(p, a_row, u_row, nz_row, f), p.w_fit),
                              wmul(balanced_score(p, a_row, u_row, nz_row, f), p.w_bal));
                }
                if (capture) {
                    t_ew[srow + n] = ew;
                    t_ffit[srow + n] = ffit;
                    t_feas[srow + n] = fe;
                }
            }
            feas_s[n] = fe;
            if (!fe) continue;
            ew_s[n] = ew;
            w[0] = max(w[0], taint_cnt[srow + n]);
            w[1] = max(w[1], aff_raw[srow + n]);
            w[2] += 1;
            for (int c = 0; c < ns; ++c) {
                const Slot s = soft[c];
                const int d = dom_at(dom_row, s);
                if (d < 0) continue;
                if (s.dk == 0) {
                    if (s.on) w[3 + c] += 1;
                } else if (!replay && (s.on || capture)) {
                    // the full tier captures every traced slot's tables
                    const int dc = clampi(d, 0, s.dk - 1);
                    atomicAdd(&table(c)[dc], sel_counts[(size_t)n * S + s.col]);
                    if (atomicAdd(&table(ns + c)[dc], 1) == 0 && s.on) atomicAdd(&ndom[c], 1);
                }
            }
            if (p.ipa_active) ipa_score_stats(p, ipa, f, n, dom_row);
        }
        block_reduce<SCAN_RED>(w, 0x3u, 0u, red, res);
        const int maxtc = w[0], maxaff = w[1];
        if (capture) {  // install the signature's spread tables, then the row
            for (int i = tid; i < p.CT * D; i += SCAN_NT) {
                const int c = i / D, d = i % D;
                const bool on = c < ns && soft[c].dk > 0;
                t_segs[(size_t)sid * p.CT * D + i] = on ? table(c)[d] : 0;
                t_pcs[(size_t)sid * p.CT * D + i] = on ? table(ns + c)[d] : 0;
            }
            if (tid == 0) t_valid[sid] = 1;
        }
        // the soft slots' log weights: a singleton key's domains counted in
        // A, another key's domains with a participant (ndom, complete after
        // the reduction's barriers)
        float wlog[SCAN_MAX_SOFT];
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            const bool on = c < ns && soft[c].on;
            wlog[c] = on ? logtab[soft[c].dk == 0 ? w[3 + c] : ndom[c]] : 0.0f;
        }

        // B. the spread and IPA raw scores, their max/min over the feasible set
        const bool pts_on = ns > 0 && any_soft;
        const bool ipa_on = np > 0 || (p.ipa_active && p.ex_pref);
        int mm[SCAN_RED];  // spread max, min, IPA max, min
        for (int i = 0; i < SCAN_RED; ++i) mm[i] = (i & 1) ? SCAN_BIG : -SCAN_BIG;
        if (pts_on || ipa_on) {
            for (int n = tid; n < Nb; n += SCAN_NT) {
                if (!feas_s[n]) continue;
                const int* dom_row = domain + (size_t)n * p.K;
                if (pts_on) {
                    float cost = 0.0f;
                    for (int c = 0; c < ns; ++c) {
                        const Slot s = soft[c];
                        const int d = dom_at(dom_row, s);
                        if (!s.on || d < 0) continue;  // the reference adds +0.0
                        // a replay gathers as _pts_score_carried: clip to D
                        const int count = s.dk == 0
                                              ? sel_counts[(size_t)n * S + s.col]
                                              : table(c)[clampi(d, 0, (replay ? D : s.dk) - 1)];
                        cost = __fadd_rn(cost, __fmul_rn(__int2float_rn(count), wlog[c]));
                    }
                    const int raw = __float2int_rz(cost);
                    raw_s[n] = raw;
                    mm[0] = max(mm[0], raw);
                    mm[1] = min(mm[1], raw);
                }
                if (ipa_on) {
                    const int raw = ipa_raw_at(p, ipa, f, n, true, dom_row);
                    iraw_s[n] = raw;
                    mm[2] = max(mm[2], raw);
                    mm[3] = min(mm[3], raw);
                }
            }
            block_reduce<SCAN_RED>(mm, 0x55u, 0xAAu, red, res);
        }

        // C. weighted total, best feasible score; the full tier exports the
        // signature's feasibility-gated score row
        int b[SCAN_RED] = {-1, 0, 0, 0, 0, 0, 0, 0};
        const bool has_pref = a.aff_has_pref[sid] != 0;
        for (int n = tid; n < Nb; n += SCAN_NT) {
            if (!feas_s[n]) {
                if (capture) sig_scores[srow + n] = -1;
                continue;
            }
            const int pts = pts_on ? pts_normalized(raw_s[n], mm[0], mm[1]) : 0;
            const int taint = taint_normalized(taint_cnt[srow + n], maxtc);
            const int aff_s = has_pref ? affinity_normalized(aff_raw[srow + n], maxaff) : 0;
            int total = wadd(wadd(ew_s[n], wmul(pts, p.w_pts)),
                             wadd(wmul(img[srow + n], p.w_img),
                                  wadd(wmul(taint, p.w_taint), wmul(aff_s, p.w_aff))));
            if (ipa_on) total = wadd(total, wmul(ipa_normalized(iraw_s[n], mm[2], mm[3]), p.w_ipa));
            total_s[n] = total;
            if (capture) sig_scores[srow + n] = total;
            b[0] = max(b[0], total);
        }
        block_reduce<SCAN_RED>(b, 0x1u, 0u, red, res);
        if (tid == 0 && dedup) (replay ? end.n_replay : end.n_full) += 1;
        const int best = b[0];
        if (best < 0 || !active) {  // nothing feasible, or a pad slot
            if (tid == 0) out[pod] = -1;
            continue;
        }

        // D. the tie set as ballots, one word per 32 consecutive nodes
        for (int base = 0; base < Nb; base += SCAN_NT) {
            const int n = base + tid;
            const bool tie = n < Nb && feas_s[n] && total_s[n] == best;
            const unsigned bits = __ballot_sync(FULL_MASK, tie);
            const int word = (base >> 5) + wid;
            if (lane == 0 && word < nwords) ballots[word] = bits;
        }
        __syncthreads();

        if (wid == 0) {
            // per-lane contiguous word ranges, prefix-counted in node order
            const int chunk = (nwords + 31) / 32;
            const int lo = min(lane * chunk, nwords), hi = min(lo + chunk, nwords);
            int cnt = 0;
            for (int i = lo; i < hi; ++i) cnt += __popc(ballots[i]);
            int incl = cnt;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int o = __shfl_up_sync(FULL_MASK, incl, off);
                if (lane >= off) incl += o;
            }
            const int nw = __shfl_sync(FULL_MASK, incl, 31);
            // CPython randrange(nw): k = nw.bit_length(), the top k bits of
            // successive 32-bit words, reject r >= nw (at most 16 words)
            int r_final = 0;
            if (nw > 1) {
                const int k = 32 - __clz(nw);
                const int idx = clampi(cursor + lane, 0, p.L - 1);
                const unsigned r = tie_words[idx] >> (32 - k);
                const unsigned acc =
                    __ballot_sync(FULL_MASK, lane < MAX_TIE_DRAWS && r < (unsigned)nw);
                if (acc) {
                    const int first = __ffs(acc) - 1;
                    r_final = (int)__shfl_sync(FULL_MASK, r, first);
                    cursor += first + 1;
                } else {
                    cursor += MAX_TIE_DRAWS;
                    end.overflow = 1;
                }
            }
            // the lane whose range holds tie number r_final finds its node
            const int excl = incl - cnt;
            if (r_final >= excl && r_final < incl) {
                int rem = r_final - excl;
                int win = -1;
                for (int i = lo; i < hi && win < 0; ++i) {
                    unsigned bits = ballots[i];
                    const int c = __popc(bits);
                    if (rem < c) {
                        for (int j = 0; j < rem; ++j) bits &= bits - 1;
                        win = i * 32 + __ffs(bits) - 1;
                    } else {
                        rem -= c;
                    }
                }
                win_sh = win;
                out[pod] = win;
            }
        }
        __syncthreads();

        // the winner's row: used, nonzero_used, sel_counts, its domains'
        // carried counts and its IPA plane rows
        const int win = win_sh;
        for (int r = tid; r < p.R; r += SCAN_NT) used[(size_t)win * p.R + r] += f[p.f_req + r];
        if (tid < 2) nonzero_used[(size_t)win * 2 + tid] += f[p.f_nz_req + tid];
        for (int s = tid; s < S; s += SCAN_NT) sel_counts[(size_t)win * S + s] += f[p.f_sig_match + s];
        if (p.dom_carry) {
            for (int i = tid; i < p.K * S; i += SCAN_NT) {
                const int k = i / S, s = i % S, d = domain[(size_t)win * p.K + k];
                if (p.topo_dk[k] > 0 && d >= 0 && d < D)
                    dom_counts[((size_t)k * D + d) * S + s] += f[p.f_sig_match + s];
            }
        }
        if (p.ipa_active) {
            for (int t = tid; t < p.Ta; t += SCAN_NT) {
                const size_t o = (size_t)win * p.Ta + t;
                ipa_counts[o] += f[p.f_ipa_match + t];
                ipa_anti[o] += f[p.f_ipa_anti_add + t];
                ipa_pref[o] += f[p.f_ipa_pref_add + t];
            }
        }
        __syncthreads();

        // the winner-column patch of every resident signature row (this
        // step's row included): one thread per row
        if (dedup) {
            const int* a_row = alloc + (size_t)win * p.R;
            const int* u_row = used + (size_t)win * p.R;
            const int* nz_row = nonzero_used + (size_t)win * 2;
            for (int g = tid; g < p.G; g += SCAN_NT) {
                if (!t_valid[g]) continue;
                const int* fg = feats + (size_t)clampi(uniq_idx[g], 0, p.P - 1) * p.F;
                const int ew_w = wadd(wmul(fit_score(p, a_row, u_row, nz_row, fg), p.w_fit),
                                      wmul(balanced_score(p, a_row, u_row, nz_row, fg), p.w_bal));
                bool ffit_w = too_many_pods(a_row, u_row);
                for (int r = 0; r < p.R; ++r)
                    ffit_w |= fit_insufficient(r, fg[p.f_req + r], a_row[r], u_row[r]);
                const size_t o = (size_t)g * Nb + win;
                const bool feas_w = static_at(o, win) && !ffit_w;
                const bool feas_old = t_feas[o] != 0;
                t_ew[o] = ew_w;
                t_ffit[o] = ffit_w;
                t_feas[o] = feas_w;
                // every traced soft slot, active or not (as the reference)
                for (int c = 0; c < ns; ++c) {
                    const int key = fg[p.f_soft_key + c];
                    if (key < 0 || key >= p.K || p.topo_dk[key] == 0) continue;
                    const int d = domain[(size_t)win * p.K + key];
                    if (d < 0) continue;
                    const int sel = clampi(fg[p.f_soft_sel + c], 0, S - 1);
                    const int cnt_new = sel_counts[(size_t)win * S + sel];
                    const int cnt_old = cnt_new - f[p.f_sig_match + sel];
                    const size_t to = ((size_t)g * p.CT + c) * D + min(d, D - 1);
                    t_segs[to] += (feas_w ? cnt_new : 0) - (feas_old ? cnt_old : 0);
                    t_pcs[to] += (int)feas_w - (int)feas_old;
                }
            }
            __syncthreads();
        }
    }
    return end;
}
