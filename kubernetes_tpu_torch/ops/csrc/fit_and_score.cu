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
// What bounds it on an H100: latency. One pod moves the planes once (about
// 0.6 MB at 8192 node rows for the single-pod path) and writes ~0.3 MB, a
// fraction of a microsecond of memory time at 3.35 TB/s; what costs is the
// chain of passes over the node axis with block-wide reductions between
// them. Design: one thread block of 1024 threads per pod (grid.x = P; the
// single-pod path launches one block, K7 below one per pod of the wave),
// five strided passes over the nodes:
//   A. domain statistics over the valid nodes: hard-spread per-domain
//      counts and participants, required IPA term counts per domain and
//      "anywhere", the existing pods' anti-affinity per key slot;
//   B. the filter rows and feasible, with the feasible-set maxima of the
//      taint and node-affinity raws;
//   C. domain statistics over the feasible nodes: soft spread and the
//      preferred IPA terms, both directions;
//   D. the spread and IPA raw scores on every row and their feasible
//      min/max;
//   E. the normalized plugin scores and the weighted total.
// Per-domain sums are int32 shared-memory atomics (exact; the reference
// multiplies by a one-hot float32 matrix at HIGHEST precision), in one
// dynamic shared-memory pool of D-word tables reused between the filter
// and score phases. The existing pods' [Nb, Ta] x [Ta] products are per-node
// int32 loops over the term table. The slots and the InterPodAffinity
// passes are scoring.cuh's, shared with K2; numerics as there.
//
// K7 wave_fit_and_score — replaces _wave_fit_and_score_jit of the
// reference package (kubernetes_tpu/parallel/mesh.py:262), the vmap over
// pods of filter_masks + scores: the pods x nodes feasibility and total
// matrix against one snapshot, no assumes between the pods. It is this
// kernel's device code with FULL = false: the same grid of one block per
// pod (the reference's wave axis splits the pods; on one card the blocks
// spread over the SMs, and the node axis is not split), writing only
// feasible [P, Nb] and total [P, Nb] (-1 where infeasible); the spread and
// IPA raw rows go to a scratch buffer instead of per_plugin. Bound as K4:
// latency per block, with P blocks in flight at once.
#include "scoring.cuh"

#define NT 1024
#define NWARPS (NT / 32)
#define RED 16
#define N_PLUGINS 7
#define BIG 2147483647

template <bool FULL>
__global__ void __launch_bounds__(NT, 1) fit_and_score_kernel(
    FitParams p, const int* __restrict__ alloc, const int* __restrict__ used,
    const int* __restrict__ nonzero_used, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ unsched, const int* __restrict__ group_id,
    const int* __restrict__ taints, const int* __restrict__ prefer_taints,
    const int* __restrict__ domain, const int* __restrict__ sel_counts,
    const int* __restrict__ port_words, const int* __restrict__ image_kib,
    const int* __restrict__ ipa_counts, const int* __restrict__ ipa_anti,
    const int* __restrict__ ipa_pref, const int* __restrict__ ipa_term_key,
    const uint8_t* __restrict__ aff_match, const int* __restrict__ aff_pref,
    const uint8_t* __restrict__ aff_allow,
    const uint8_t* __restrict__ aff_has_pref, const int* __restrict__ feats,
    const float* __restrict__ logtab, uint8_t* __restrict__ out,
    long long per_pod, uint8_t* __restrict__ feas_out, int* __restrict__ total_out,
    int* __restrict__ raw_out) {
    extern __shared__ int pool[];
    __shared__ Slot hard[SCAN_MAX_SOFT], soft[SCAN_MAX_SOFT];
    __shared__ Slot anti[MAX_REQ_TERMS], aff[MAX_REQ_TERMS], pref[MAX_PREF_TERMS];
    __shared__ int exmask, any_soft;
    __shared__ int red[NWARPS][RED];
    __shared__ int res[RED];

    const int tid = threadIdx.x;
    const int pod = blockIdx.x;
    const int Nb = p.Nb, D = p.D;
    const int* f = feats + (size_t)pod * p.F;
    // FULL (K4): one packed buffer per pod. Else (K7): feasible and total
    // rows of the matrix, the spread and IPA raw rows in scratch
    uint8_t* o = FULL ? out + (size_t)pod * per_pod : nullptr;
    uint8_t* fails = o;
    uint8_t* feas = FULL ? fails + (size_t)p.NF * Nb : feas_out + (size_t)pod * Nb;
    uint8_t* insuf = FULL ? feas + Nb : nullptr;
    uint8_t* toomany = FULL ? insuf + (size_t)p.R * Nb : nullptr;
    int* total = FULL ? reinterpret_cast<int*>(toomany + Nb) : total_out + (size_t)pod * Nb;
    int* per = FULL ? total + Nb : nullptr;  // row j = PLUGIN_NAMES[j]
    int* raw_pts = FULL ? per + (size_t)4 * Nb : raw_out + (size_t)pod * 2 * Nb;
    int* raw_ipa = FULL ? per + (size_t)5 * Nb : raw_out + (size_t)pod * 2 * Nb + Nb;

    const int nh = p.n_hard, ns = p.n_soft;
    const int na = p.n_ipa_anti, nfa = p.n_ipa_aff, np = p.n_ipa_pref;
    // shared-memory tables: filter phase, then (reused) score phase
    const int base_anti = 2 * nh, base_aff = base_anti + na, base_xa = base_aff + nfa;
    const int base_pref = 2 * ns, base_xp = base_pref + np;
    const int n_filter_tables = base_xa + (p.ex_anti ? p.K : 0);
    const int n_score_tables = base_xp + (p.ex_pref_add ? p.K : 0);
    auto table = [&](int i) { return pool + (size_t)i * D; };

    if (tid < 32) {  // warp 0: the pod's slots, the key slots its matching terms use
        pod_slots(p, f, ipa_term_key, true, hard, soft, anti, aff, pref);
        const bool anys = any_column(f, p.f_soft_active, p.MC);
        const int bits = matched_key_mask(p, f, ipa_term_key);
        if (tid == 0) {
            any_soft = anys;
            exmask = bits;
        }
    }
    for (int i = tid; i < n_filter_tables * D; i += NT) pool[i] = 0;
    __syncthreads();
    const Ipa ipa = {anti, aff, pref, na, nfa, np, exmask, D, table(base_anti), table(base_pref),
                     ipa_counts, ipa_anti, ipa_pref, ipa_term_key};

    const int sig = clampi(f[p.f_aff_sig], 0, p.A - 1);
    const int name_idx = f[p.f_name_idx], pin = f[p.f_aff_pin];

    // A. domain statistics over the valid nodes (PreFilter participation)
    int v[RED];
    for (int i = 0; i < RED; ++i) v[i] = i < 4 ? BIG : 0;  // hard min, aff anywhere
    for (int n = tid; n < Nb; n += NT) {
        if (!valid[n]) continue;
        const int* dom_row = domain + (size_t)n * p.K;
        for (int c = 0; c < nh; ++c) {
            const Slot s = hard[c];
            const int d = dom_at(dom_row, s);
            if (!s.on || d < 0) continue;
            const int cnt = sel_counts[(size_t)n * p.S + s.col];
            if (s.dk == 0) {
                v[c] = min(v[c], cnt);
            } else {
                const int dc = clampi(d, 0, s.dk - 1);
                atomicAdd(&table(c)[dc], cnt);
                atomicAdd(&table(nh + c)[dc], 1);
            }
        }
        ipa_filter_stats(p, ipa, f, n, dom_row, v + 4);
    }
    block_reduce<RED>(v, 0xF0u, 0x0Fu, red, res);
    // the hard slots' min_count: over participating nodes for singleton
    // keys, over present domains otherwise; 0 when there is none
    int m[RED];
    for (int i = 0; i < RED; ++i) m[i] = BIG;
    for (int c = 0; c < nh; ++c) {
        const Slot s = hard[c];
        if (!s.on || s.dk == 0) continue;
        for (int d = tid; d < s.dk; d += NT) {
            if (table(nh + c)[d] > 0) m[c] = min(m[c], table(c)[d]);
        }
    }
    block_reduce<RED>(m, 0u, 0xFFFFu, red, res);
    int hmin[SCAN_MAX_SOFT];
    for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
        const int x = (c < nh && hard[c].dk > 0) ? m[c] : v[c];
        hmin[c] = x == BIG ? 0 : x;
    }

    // B. the filter rows and feasible
    int w[RED];
    for (int i = 0; i < RED; ++i) w[i] = 0;  // max taint count, max aff raw, soft nd
    for (int n = tid; n < Nb; n += NT) {
        const int* a_row = alloc + (size_t)n * p.R;
        const int* u_row = used + (size_t)n * p.R;
        const int* dom_row = domain + (size_t)n * p.K;
        const bool vn = valid[n] != 0;
        const int g = clampi(group_id[n], 0, p.G - 1);
        bool row[6];
        row[0] = unsched[n] && !f[p.f_tol_unsched];
        row[1] = name_idx != -1 && n != name_idx;
        row[2] = untolerated_taint(p, taints + (size_t)n * p.T, f);
        row[3] = !(aff_match[(size_t)sig * p.G + g] && aff_allow[(size_t)sig * Nb + n]) ||
                 (pin != -1 && n != pin);
        row[4] = ports_conflict(p, port_words + (size_t)n * p.W, f);
        bool ins_any = false;
        for (int r = 0; r < p.R; ++r) {
            const bool ins = fit_insufficient(r, f[p.f_req + r], a_row[r], u_row[r]);
            if (FULL) insuf[(size_t)r * Nb + n] = ins;
            ins_any |= ins;
        }
        const bool tm = too_many_pods(a_row, u_row);
        if (FULL) toomany[n] = tm;
        row[5] = ins_any || tm;
        bool any = false;
        for (int r = 0; r < 6; ++r) {
            if (FULL) fails[(size_t)r * Nb + n] = row[r];
            any |= row[r];
        }
        for (int c = 0; c < p.MC; ++c) {
            bool miss = false, skew = false;
            if (c < nh && hard[c].on) {
                const Slot s = hard[c];
                const int d = dom_at(dom_row, s);
                if (d < 0) {
                    miss = true;
                } else {
                    const int count = s.dk == 0 ? sel_counts[(size_t)n * p.S + s.col]
                                                : table(c)[clampi(d, 0, s.dk - 1)];
                    skew = count + s.b - hmin[c] > s.a;
                }
            }
            if (FULL) {
                fails[(size_t)(6 + c) * Nb + n] = miss;
                fails[(size_t)(6 + p.MC + c) * Nb + n] = skew;
            }
            any |= miss || skew;
        }
        // InterPodAffinity (filtering.go:352-412)
        bool ipa1, ipa2, ipa3;
        ipa_filters_at(p, ipa, f, n, vn, dom_row, v + 4, ipa1, ipa2, ipa3);
        if (FULL) {
            fails[(size_t)(p.NF - 3) * Nb + n] = ipa1;
            fails[(size_t)(p.NF - 2) * Nb + n] = ipa2;
            fails[(size_t)(p.NF - 1) * Nb + n] = ipa3;
        }
        const bool fe = vn && !(any || ipa1 || ipa2 || ipa3);
        feas[n] = fe;
        if (!fe) continue;
        w[0] = max(w[0], prefer_taint_count(p, prefer_taints + (size_t)n * p.Tp, f));
        w[1] = max(w[1], aff_pref[(size_t)sig * p.G + g]);
        for (int c = 0; c < ns; ++c) {
            const Slot s = soft[c];
            if (s.on && s.dk == 0 && dom_at(dom_row, s) >= 0) w[2 + c] += 1;
        }
    }
    block_reduce<RED>(w, 0x3u, 0u, red, res);
    const int maxtc = w[0], maxaff = w[1];

    // C. domain statistics over the feasible nodes (PreScore participation)
    for (int i = tid; i < n_score_tables * D; i += NT) pool[i] = 0;
    __syncthreads();
    for (int n = tid; n < Nb; n += NT) {
        if (!feas[n]) continue;
        const int* dom_row = domain + (size_t)n * p.K;
        for (int c = 0; c < ns; ++c) {
            const Slot s = soft[c];
            const int d = dom_at(dom_row, s);
            if (!s.on || s.dk == 0 || d < 0) continue;
            const int dc = clampi(d, 0, s.dk - 1);
            atomicAdd(&table(c)[dc], sel_counts[(size_t)n * p.S + s.col]);
            atomicAdd(&table(ns + c)[dc], 1);
        }
        ipa_score_stats(p, ipa, f, n, dom_row);
    }
    __syncthreads();
    // the soft slots' present-domain counts, then their log weights
    int nd[RED];
    for (int i = 0; i < RED; ++i) nd[i] = 0;
    for (int c = 0; c < ns; ++c) {
        const Slot s = soft[c];
        if (!s.on || s.dk == 0) continue;
        for (int d = tid; d < s.dk; d += NT) nd[c] += table(ns + c)[d] > 0;
    }
    block_reduce<RED>(nd, 0u, 0u, red, res);
    float wlog[SCAN_MAX_SOFT];
    for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
        const bool on = c < ns && soft[c].on;
        wlog[c] = on ? logtab[soft[c].dk == 0 ? w[2 + c] : nd[c]] : 0.0f;
    }

    // D. the spread and IPA raw scores on every row, min/max over feasible
    const bool pts_on = ns > 0 && any_soft;
    const bool ipa_on = np > 0 || p.ex_pref;
    int mm[RED];
    for (int i = 0; i < RED; ++i) mm[i] = (i & 1) ? BIG : -BIG;  // max, min, max, min
    for (int n = tid; n < Nb; n += NT) {
        const bool fe = feas[n] != 0;
        const int* dom_row = domain + (size_t)n * p.K;
        if (pts_on) {
            float cost = 0.0f;
            for (int c = 0; c < ns; ++c) {
                const Slot s = soft[c];
                const int d = dom_at(dom_row, s);
                if (!s.on || d < 0) continue;  // the reference adds +0.0
                const int count = s.dk == 0 ? sel_counts[(size_t)n * p.S + s.col]
                                            : table(c)[clampi(d, 0, s.dk - 1)];
                cost = __fadd_rn(cost, __fmul_rn(__int2float_rn(count), wlog[c]));
            }
            const int raw = __float2int_rz(cost);
            raw_pts[n] = raw;
            if (fe) {
                mm[0] = max(mm[0], raw);
                mm[1] = min(mm[1], raw);
            }
        }
        if (ipa_on) {
            const int raw = ipa_raw_at(p, ipa, f, n, fe, dom_row);
            raw_ipa[n] = raw;
            if (fe) {
                mm[2] = max(mm[2], raw);
                mm[3] = min(mm[3], raw);
            }
        }
    }
    block_reduce<RED>(mm, 0x5555u, 0xAAAAu, red, res);

    // E. the normalized plugin scores and the weighted total
    const bool has_pref = aff_has_pref[sig] != 0;
    for (int n = tid; n < Nb; n += NT) {
        const int* a_row = alloc + (size_t)n * p.R;
        const int* u_row = used + (size_t)n * p.R;
        const int* nz_row = nonzero_used + (size_t)n * 2;
        const int g = clampi(group_id[n], 0, p.G - 1);
        int sc[N_PLUGINS];
        sc[0] = fit_score(p, a_row, u_row, nz_row, f);
        sc[1] = balanced_score(p, a_row, u_row, nz_row, f);
        sc[2] = taint_normalized(prefer_taint_count(p, prefer_taints + (size_t)n * p.Tp, f),
                                 maxtc);
        sc[3] = has_pref ? affinity_normalized(aff_pref[(size_t)sig * p.G + g], maxaff) : 0;
        sc[4] = pts_on ? pts_normalized(raw_pts[n], mm[0], mm[1]) : 0;
        sc[5] = ipa_on ? ipa_normalized(raw_ipa[n], mm[2], mm[3]) : 0;
        sc[6] = image_score(p, image_kib + (size_t)n * p.I, f);
        const int wt[N_PLUGINS] = {p.w_fit, p.w_bal, p.w_taint, p.w_aff,
                                   p.w_pts, p.w_ipa, p.w_img};
        int tot = 0;
        for (int j = 0; j < N_PLUGINS; ++j) {
            if (FULL) per[(size_t)j * Nb + n] = sc[j];
            tot = wadd(tot, wmul(sc[j], wt[j]));
        }
        total[n] = feas[n] ? tot : -1;
    }
}

// the dynamic shared memory of one block: the filter or the score tables
inline size_t fit_smem_bytes(const FitParams* p) {
    const int filter_tables = 2 * p->n_hard + p->n_ipa_anti + p->n_ipa_aff +
                              (p->ex_anti ? p->K : 0);
    const int score_tables = 2 * p->n_soft + p->n_ipa_pref + (p->ex_pref_add ? p->K : 0);
    const int tables = max(max(filter_tables, score_tables), 1);
    return (size_t)tables * p->D * sizeof(int);
}

template <bool FULL>
int launch_fit(const FitParams* p, void* const* ptrs, void* stream, uint8_t* out,
               uint8_t* feas_out, int* total_out, int* raw_out) {
    const size_t dyn = fit_smem_bytes(p);
    cudaError_t err = cudaFuncSetAttribute(
        fit_and_score_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
    const long long per_pod =
        (long long)(p->NF + p->R + 2) * p->Nb + (long long)(1 + N_PLUGINS) * p->Nb * 4;
    fit_and_score_kernel<FULL><<<p->P, NT, dyn, (cudaStream_t)stream>>>(
        *p, (const int*)ptrs[0], (const int*)ptrs[1], (const int*)ptrs[2],
        (const uint8_t*)ptrs[3], (const uint8_t*)ptrs[4], (const int*)ptrs[5],
        (const int*)ptrs[6], (const int*)ptrs[7], (const int*)ptrs[8],
        (const int*)ptrs[9], (const int*)ptrs[10], (const int*)ptrs[11],
        (const int*)ptrs[12], (const int*)ptrs[13], (const int*)ptrs[14],
        (const int*)ptrs[15], (const uint8_t*)ptrs[16], (const int*)ptrs[17],
        (const uint8_t*)ptrs[18], (const uint8_t*)ptrs[19], (const int*)ptrs[20],
        (const float*)ptrs[21], out, per_pod, feas_out, total_out, raw_out);
    return (int)cudaGetLastError();
}

// ptrs: alloc, used, nonzero_used, valid, unsched, group_id, taints,
// prefer_taints, domain, sel_counts, port_words, image_kib, ipa_counts,
// ipa_anti, ipa_pref, ipa_term_key, aff_match, aff_pref, aff_allow,
// aff_has_pref, feats, logtab, then K4: out; K7: feasible, total, raw
extern "C" int launch_fit_and_score(const FitParams* p, void* const* ptrs,
                                    void* stream) {
    return launch_fit<true>(p, ptrs, stream, (uint8_t*)ptrs[22], nullptr, nullptr, nullptr);
}

extern "C" int launch_wave_fit_and_score(const FitParams* p, void* const* ptrs,
                                         void* stream) {
    return launch_fit<false>(p, ptrs, stream, nullptr, (uint8_t*)ptrs[22], (int*)ptrs[23],
                             (int*)ptrs[24]);
}
