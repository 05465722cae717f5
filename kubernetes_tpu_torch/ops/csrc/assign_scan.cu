// K2 assign_scan — replaces _batched_assign_jit of the reference package
// (kubernetes_tpu/ops/kernels.py:_batched_assign_jit -> _batched_assign_core
// -> _assign_step, both tiers, with _dom_counts_init :820,
// _pts_hard_carried :855, _finish_total :887, _pts_score_carried :673 and
// the InterPodAffinity filters and score); the cross-wave seeding of the
// signature table (:1314-1328) is not ported.
//
// What it computes: the greedy wave scan. Pod i+1 sees pod i's placement.
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
// What bounds it on an H100: latency, not bytes or operations. The pods are
// a serial chain and each step is a handful of dependent block-wide
// reductions. Design: ONE thread block of 1024 threads loops over the pods;
// each step makes strided passes over the node axis (warps read contiguous
// nodes) with block reductions between them: F (only with hard spread or
// IPA) the valid-set statistics, G the live reject mask and the replay
// gate, A feasibility and the feasible-set statistics, B the spread and
// IPA raw scores, C the totals, D the tie ballots. Per-domain sums are int32
// shared-memory atomics in one pool of D-word tables reused between the
// filter and score phases (exact; the reference used one-hot float matmuls
// at HIGHEST precision); the hard-spread domain counts [K, D, S] are
// carried in device memory, built once per launch over the valid nodes and
// bumped at each placement. Warp 0 does the prefix count and the 16-word
// draw (one word per lane); the whole block applies the winner's row adds
// and patches the signature rows (one thread per row). Carry planes are
// updated in place in device memory (copies the wrapper makes).
#include "scoring.cuh"

#define NT 1024
#define NWARPS (NT / 32)
#define FULL FULL_MASK
#define RED 8
#define BIG 2147483647

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

__global__ void __launch_bounds__(NT, 1) assign_scan_kernel(
    ScanParams p, const int* __restrict__ alloc, const int* __restrict__ domain,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ static_ok,
    const int* __restrict__ taint_cnt, const int* __restrict__ aff_raw,
    const int* __restrict__ img, const uint8_t* __restrict__ aff_has_pref,
    const int* __restrict__ feats, const unsigned* __restrict__ tie_words,
    const float* __restrict__ logtab, int* used, int* nonzero_used,
    int* sel_counts, int* ipa_counts, int* ipa_anti, int* ipa_pref,
    const int* __restrict__ ipa_term_key, int* dom_counts, int* scratch,
    int* out, const int* __restrict__ sig_ids, const int* __restrict__ uniq_idx,
    uint8_t* t_valid, int* t_ew, uint8_t* t_ffit, uint8_t* t_feas, int* t_segs,
    int* t_pcs, int* sig_scores, int* tiers) {
    extern __shared__ int pool[];  // domain tables, then the tie ballots
    __shared__ Slot hard[SCAN_MAX_SOFT], soft[SCAN_MAX_SOFT];
    __shared__ Slot anti[MAX_REQ_TERMS], aff[MAX_REQ_TERMS], pref[MAX_PREF_TERMS];
    __shared__ int exmask, any_soft, any_hard, win_sh;
    __shared__ int ndom[SCAN_MAX_SOFT];  // soft slots' domains with a participant
    __shared__ int red[NWARPS][RED];
    __shared__ int res[RED];

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
    int* ew_s = scratch;
    int* raw_s = scratch + (size_t)Nb;
    int* iraw_s = scratch + 2 * (size_t)Nb;
    int* total_s = scratch + 3 * (size_t)Nb;
    int* feas_s = scratch + 4 * (size_t)Nb;
    int* fail_s = scratch + 5 * (size_t)Nb;
    int* present = scratch + 6 * (size_t)Nb;  // [K, D] with dom_carry
    auto table = [&](int i) { return pool + (size_t)i * D; };
    int cursor = p.cursor0;  // meaningful in warp 0
    int overflow = 0;
    int n_full = 0, n_replay = 0;  // meaningful in thread 0

    // prologue: the hard-spread carry, per key slot and domain the sum of
    // sel_counts over the domain's valid nodes, and the static presence
    if (p.dom_carry) {
        for (size_t i = tid; i < (size_t)p.K * D * S; i += NT) dom_counts[i] = 0;
        for (int i = tid; i < p.K * D; i += NT) present[i] = 0;
        __syncthreads();
        for (int n = tid; n < Nb; n += NT) {
            if (!valid[n]) continue;
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
            for (int i = tid; i < filter_tables * D; i += NT) pool[i] = 0;
            __syncthreads();
            int v[RED];
            for (int i = 0; i < RED; ++i) v[i] = i < 4 ? BIG : 0;
            if (p.dom_carry) {  // a non-singleton key: over the present domains
                for (int c = 0; c < nh; ++c) {
                    const Slot s = hard[c];
                    if (!s.on || s.dk == 0) continue;
                    for (int d = tid; d < D; d += NT) {
                        if (present[s.key * D + d])
                            v[c] = min(v[c], dom_counts[((size_t)s.key * D + d) * S + s.col]);
                    }
                }
            }
            for (int n = tid; n < Nb; n += NT) {
                if (!valid[n]) continue;
                const int* dom_row = domain + (size_t)n * p.K;
                for (int c = 0; c < nh; ++c) {  // a singleton key: over the nodes
                    const Slot s = hard[c];
                    if (s.on && s.dk == 0 && dom_at(dom_row, s) >= 0)
                        v[c] = min(v[c], sel_counts[(size_t)n * S + s.col]);
                }
                if (p.ipa_active) ipa_filter_stats(p, ipa, f, n, dom_row, v + 4);
            }
            block_reduce<RED>(v, 0xF0u, 0x0Fu, red, res);
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) hmin[c] = v[c] == BIG ? 0 : v[c];
            for (int s = 0; s < MAX_REQ_TERMS; ++s) aff_any[s] = v[4 + s];
        }

        // G. the live reject mask (hard spread, IPA) and, for a resident
        // signature under hard spread or IPA, the replay gate: the row's
        // feasibility must equal the live one on every node row
        const bool check = dedup && gated && t_valid[sid];
        int mismatch = 0;
        if (has_fail || check) {
            for (int n = tid; n < Nb; n += NT) {
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
                        ipa_filters_at(p, ipa, f, n, valid[n] != 0, dom_row, aff_any, i1, i2, i3);
                        fail = i1 || i2 || i3;
                    }
                    fail_s[n] = fail;
                }
                if (check) {
                    const size_t o = srow + n;
                    const bool live = static_ok[o] && !t_ffit[o] && !fail;
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
        for (int i = tid; i < score_tables * D; i += NT) {
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
        int w[RED];  // max taint count, max aff raw, feasible count, singleton nd[4]
        for (int i = 0; i < RED; ++i) w[i] = 0;
        for (int n = tid; n < Nb; n += NT) {
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
                fe = static_ok[srow + n] && !ffit && !(has_fail && fail_s[n]);
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
        block_reduce<RED>(w, 0x3u, 0u, red, res);
        const int maxtc = w[0], maxaff = w[1];
        if (capture) {  // install the signature's spread tables, then the row
            for (int i = tid; i < p.CT * D; i += NT) {
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
        int mm[RED];  // spread max, min, IPA max, min
        for (int i = 0; i < RED; ++i) mm[i] = (i & 1) ? BIG : -BIG;
        if (pts_on || ipa_on) {
            for (int n = tid; n < Nb; n += NT) {
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
            block_reduce<RED>(mm, 0x55u, 0xAAu, red, res);
        }

        // C. weighted total, best feasible score; the full tier exports the
        // signature's feasibility-gated score row
        int b[RED] = {-1, 0, 0, 0, 0, 0, 0, 0};
        const bool has_pref = aff_has_pref[sid] != 0;
        for (int n = tid; n < Nb; n += NT) {
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
        block_reduce<RED>(b, 0x1u, 0u, red, res);
        if (tid == 0 && dedup) (replay ? n_replay : n_full) += 1;
        const int best = b[0];
        if (best < 0 || !active) {  // nothing feasible, or a pad slot
            if (tid == 0) out[pod] = -1;
            continue;
        }

        // D. the tie set as ballots, one word per 32 consecutive nodes
        for (int base = 0; base < Nb; base += NT) {
            const int n = base + tid;
            const bool tie = n < Nb && feas_s[n] && total_s[n] == best;
            const unsigned bits = __ballot_sync(FULL, tie);
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
                const int o = __shfl_up_sync(FULL, incl, off);
                if (lane >= off) incl += o;
            }
            const int nw = __shfl_sync(FULL, incl, 31);
            // CPython randrange(nw): k = nw.bit_length(), the top k bits of
            // successive 32-bit words, reject r >= nw (at most 16 words)
            int r_final = 0;
            if (nw > 1) {
                const int k = 32 - __clz(nw);
                const int idx = clampi(cursor + lane, 0, p.L - 1);
                const unsigned r = tie_words[idx] >> (32 - k);
                const unsigned acc = __ballot_sync(FULL, lane < MAX_TIE_DRAWS && r < (unsigned)nw);
                if (acc) {
                    const int first = __ffs(acc) - 1;
                    r_final = (int)__shfl_sync(FULL, r, first);
                    cursor += first + 1;
                } else {
                    cursor += MAX_TIE_DRAWS;
                    overflow = 1;
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
        for (int r = tid; r < p.R; r += NT) used[(size_t)win * p.R + r] += f[p.f_req + r];
        if (tid < 2) nonzero_used[(size_t)win * 2 + tid] += f[p.f_nz_req + tid];
        for (int s = tid; s < S; s += NT) sel_counts[(size_t)win * S + s] += f[p.f_sig_match + s];
        if (p.dom_carry) {
            for (int i = tid; i < p.K * S; i += NT) {
                const int k = i / S, s = i % S, d = domain[(size_t)win * p.K + k];
                if (p.topo_dk[k] > 0 && d >= 0 && d < D)
                    dom_counts[((size_t)k * D + d) * S + s] += f[p.f_sig_match + s];
            }
        }
        if (p.ipa_active) {
            for (int t = tid; t < p.Ta; t += NT) {
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
            for (int g = tid; g < p.G; g += NT) {
                if (!t_valid[g]) continue;
                const int* fg = feats + (size_t)clampi(uniq_idx[g], 0, p.P - 1) * p.F;
                const int ew_w = wadd(wmul(fit_score(p, a_row, u_row, nz_row, fg), p.w_fit),
                                      wmul(balanced_score(p, a_row, u_row, nz_row, fg), p.w_bal));
                bool ffit_w = too_many_pods(a_row, u_row);
                for (int r = 0; r < p.R; ++r)
                    ffit_w |= fit_insufficient(r, fg[p.f_req + r], a_row[r], u_row[r]);
                const size_t o = (size_t)g * Nb + win;
                const bool feas_w = static_ok[o] && !ffit_w;
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
    if (tid == 0) {
        out[p.P] = cursor;
        out[p.P + 1] = overflow;
        if (dedup) {
            tiers[0] = n_full;
            tiers[1] = n_replay;
        }
    }
}

// ptrs: alloc, domain, valid, static_ok, taint_cnt, aff_raw, img,
// aff_has_pref, feats, tie_words, logtab, used, nonzero_used, sel_counts,
// ipa_counts, ipa_anti, ipa_pref, ipa_term_key, dom_counts, scratch, out,
// then with dedup sig_ids, uniq_idx, t_valid, t_ew, t_ffit, t_feas, t_segs,
// t_pcs, sig_scores, tiers (0 without)
extern "C" int launch_assign_scan(const ScanParams* p, void* const* ptrs,
                                  void* stream) {
    const size_t dyn =
        ((size_t)scan_pool_words(*p) + (size_t)((p->Nb + 31) / 32)) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
    assign_scan_kernel<<<1, NT, dyn, (cudaStream_t)stream>>>(
        *p, (const int*)ptrs[0], (const int*)ptrs[1], (const uint8_t*)ptrs[2],
        (const uint8_t*)ptrs[3], (const int*)ptrs[4], (const int*)ptrs[5],
        (const int*)ptrs[6], (const uint8_t*)ptrs[7], (const int*)ptrs[8],
        (const unsigned*)ptrs[9], (const float*)ptrs[10], (int*)ptrs[11],
        (int*)ptrs[12], (int*)ptrs[13], (int*)ptrs[14], (int*)ptrs[15],
        (int*)ptrs[16], (const int*)ptrs[17], (int*)ptrs[18], (int*)ptrs[19],
        (int*)ptrs[20], (const int*)ptrs[21], (const int*)ptrs[22],
        (uint8_t*)ptrs[23], (int*)ptrs[24], (uint8_t*)ptrs[25], (uint8_t*)ptrs[26],
        (int*)ptrs[27], (int*)ptrs[28], (int*)ptrs[29], (int*)ptrs[30]);
    return (int)cudaGetLastError();
}
