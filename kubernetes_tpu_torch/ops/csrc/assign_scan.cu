// K2 assign_scan — replaces _batched_assign_jit of the reference package
// (kubernetes_tpu/ops/kernels.py:_batched_assign_jit -> _batched_assign_core
// -> _assign_step, the non-dedup tier) for configurations without hard
// spread constraints and without inter-pod affinity.
//
// What it computes: the greedy wave scan. Pod i+1 sees pod i's placement.
// Per pod: the NodeResourcesFit filter on the carried `used` plane ANDed
// with K1's static_ok; the fit score (Least/Most/RequestedToCapacityRatio)
// and BalancedAllocation; soft PodTopologySpread over the live feasible set
// (singleton keys elementwise, other keys as exact int32 per-domain sums);
// the taint / node-affinity normalizers and _finish_total; the CPython
// randrange-exact tie draw over the max-score nodes in node order; and the
// single-row adds of the winner into used / nonzero_used / sel_counts.
//
// What bounds it on an H100: latency, not bytes or operations. The pods are
// a serial chain and each step is a handful of dependent block-wide
// reductions; the bytes it must move (K1's [P, Nb] outputs read once, the
// planes) take ~17 us at full memory rate for a 512 x 8192 wave. Design: ONE
// thread block of 1024 threads loops over the pods; each step makes four
// passes over the node axis (strided, so warps read contiguous nodes) with
// shared-memory reductions between them, keeps the per-domain segment
// counts as shared-memory int32 atomics (exact; the reference used a
// one-hot float matmul at HIGHEST precision), records the tie set as warp
// ballots in shared memory, and lets warp 0 do the prefix count, the
// 16-word draw (one word per lane) and the winner's row update. The carry
// planes are updated in place in device memory (copies the wrapper makes).
#include "scoring.cuh"

#define NT 1024
#define NWARPS (NT / 32)
#define FULL FULL_MASK

// slots of the per-step block reduction
#define RED_SLOTS 8

__global__ void __launch_bounds__(NT, 1) assign_scan_kernel(
    ScanParams p, const int* __restrict__ alloc, const int* __restrict__ domain,
    const uint8_t* __restrict__ static_ok, const int* __restrict__ taint_cnt,
    const int* __restrict__ aff_raw, const int* __restrict__ img,
    const uint8_t* __restrict__ aff_has_pref, const int* __restrict__ feats,
    const unsigned* __restrict__ tie_words, const float* __restrict__ logtab,
    int* used, int* nonzero_used, int* sel_counts, uint8_t* feas_s,
    int* ew_s, int* raw_s, int* total_s, int* out) {
    __shared__ int seg[SCAN_MAX_SOFT][SCAN_MAX_DOM];
    __shared__ int pcnt[SCAN_MAX_SOFT][SCAN_MAX_DOM];
    __shared__ int ndom[SCAN_MAX_SOFT];
    __shared__ int red[NWARPS][RED_SLOTS];
    __shared__ int res[RED_SLOTS];
    extern __shared__ unsigned ballots[];  // one word per 32 nodes

    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int nsoft = min(p.n_soft, SCAN_MAX_SOFT);
    const int nwords = (p.Nb + 31) / 32;
    int cursor = p.cursor0;  // meaningful in warp 0
    int overflow = 0;

    for (int pod = 0; pod < p.P; ++pod) {
        const int* f = feats + (size_t)pod * p.F;
        // inactive pad slots place nothing and draw no words
        if (!f[p.f_active]) {
            if (tid == 0) out[pod] = -1;
            continue;
        }
        const size_t row0 = (size_t)pod * p.Nb;
        // soft-constraint slots of this pod
        bool act[SCAN_MAX_SOFT];
        int key[SCAN_MAX_SOFT], sel[SCAN_MAX_SOFT], dk[SCAN_MAX_SOFT];
        bool any_active = false;
        for (int c = 0; c < p.MC; ++c) any_active |= f[p.f_soft_active + c] != 0;
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            act[c] = c < nsoft && f[p.f_soft_active + c] != 0;
            key[c] = act[c] ? clampi(f[p.f_soft_key + c], 0, p.K - 1) : 0;
            sel[c] = act[c] ? clampi(f[p.f_soft_sel + c], 0, p.S - 1) : 0;
            dk[c] = act[c] ? p.topo_dk[key[c]] : 0;
            if (act[c] && dk[c] > 0) {
                for (int d = tid; d < dk[c]; d += NT) {
                    seg[c][d] = 0;
                    pcnt[c][d] = 0;
                }
            }
        }
        if (tid < SCAN_MAX_SOFT) ndom[tid] = 0;
        __syncthreads();

        // pass A: fit filter, feasibility, fit + balanced, the static
        // normalizers and the spread participant counts
        int v[RED_SLOTS] = {0, 0, 0, 0, 0, 0, 0, 0};  // maxtc, maxaff, nfeas, nd[4]
        for (int n = tid; n < p.Nb; n += NT) {
            const int* a_row = alloc + (size_t)n * p.R;
            const int* u_row = used + (size_t)n * p.R;
            const int* nz_row = nonzero_used + (size_t)n * 2;
            bool fe = static_ok[row0 + n] != 0;
            if (fe) {
                for (int r = 0; r < p.R; ++r) {
                    if (fit_insufficient(r, f[p.f_req + r], a_row[r], u_row[r])) fe = false;
                }
                if (too_many_pods(a_row, u_row)) fe = false;
            }
            feas_s[n] = fe;
            if (!fe) continue;
            ew_s[n] = fit_score(p, a_row, u_row, nz_row, f) * p.w_fit +
                      balanced_score(p, a_row, u_row, nz_row, f) * p.w_bal;
            v[0] = max(v[0], taint_cnt[row0 + n]);
            v[1] = max(v[1], aff_raw[row0 + n]);
            v[2] += 1;
#pragma unroll
            for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                if (!act[c]) continue;
                const int d = domain[(size_t)n * p.K + key[c]];
                if (d < 0) continue;
                if (dk[c] == 0) {
                    v[3 + c] += 1;
                } else {
                    const int dc = clampi(d, 0, dk[c] - 1);
                    atomicAdd(&seg[c][dc], sel_counts[(size_t)n * p.S + sel[c]]);
                    if (atomicAdd(&pcnt[c][dc], 1) == 0) atomicAdd(&ndom[c], 1);
                }
            }
        }
        block_reduce<RED_SLOTS>(v, 0x3u, 0u, red, res);
        const int maxtc = v[0], maxaff = v[1];
        if (v[2] == 0) {  // nothing feasible: best = -1, not found
            if (tid == 0) out[pod] = -1;
            continue;
        }
        float w[SCAN_MAX_SOFT];
#pragma unroll
        for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
            const int nd = dk[c] == 0 ? v[3 + c] : ndom[c];
            w[c] = act[c] ? logtab[nd] : 0.0f;
        }

        // pass B: spread raw cost, its max/min over the feasible set
        const bool pts_on = p.n_soft > 0 && any_active;
        int mx = 0, mn = 0;
        if (pts_on) {
            int u[RED_SLOTS] = {INT_MIN, INT_MIN, 0, 0, 0, 0, 0, 0};  // max raw, max -raw
            for (int n = tid; n < p.Nb; n += NT) {
                if (!feas_s[n]) continue;
                float cost = 0.0f;
#pragma unroll
                for (int c = 0; c < SCAN_MAX_SOFT; ++c) {
                    if (!act[c]) continue;
                    const int d = domain[(size_t)n * p.K + key[c]];
                    if (d < 0) continue;
                    const int count = dk[c] == 0
                                          ? sel_counts[(size_t)n * p.S + sel[c]]
                                          : seg[c][clampi(d, 0, dk[c] - 1)];
                    cost = __fadd_rn(cost, __fmul_rn(__int2float_rn(count), w[c]));
                }
                const int raw = __float2int_rz(cost);
                raw_s[n] = raw;
                u[0] = max(u[0], raw);
                u[1] = max(u[1], -raw);
            }
            block_reduce<RED_SLOTS>(u, 0x3u, 0u, red, res);
            mx = u[0];
            mn = -u[1];
        }

        // pass C: weighted total, best feasible score
        int b[RED_SLOTS] = {-1, 0, 0, 0, 0, 0, 0, 0};
        const bool has_pref = aff_has_pref[pod] != 0;
        for (int n = tid; n < p.Nb; n += NT) {
            if (!feas_s[n]) continue;
            const int pts = pts_on ? pts_normalized(raw_s[n], mx, mn) : 0;
            const int taint = taint_normalized(taint_cnt[row0 + n], maxtc);
            const int aff = has_pref ? affinity_normalized(aff_raw[row0 + n], maxaff) : 0;
            const int total = ew_s[n] + pts * p.w_pts + img[row0 + n] * p.w_img +
                              taint * p.w_taint + aff * p.w_aff;
            total_s[n] = total;
            b[0] = max(b[0], total);
        }
        block_reduce<RED_SLOTS>(b, 0x1u, 0u, red, res);
        const int best = b[0];
        if (best < 0) {
            if (tid == 0) out[pod] = -1;
            continue;
        }

        // pass D: the tie set as ballots, one word per 32 consecutive nodes
        for (int base = 0; base < p.Nb; base += NT) {
            const int n = base + tid;
            const bool tie = n < p.Nb && feas_s[n] && total_s[n] == best;
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
                for (int r = 0; r < p.R; ++r) used[(size_t)win * p.R + r] += f[p.f_req + r];
                nonzero_used[(size_t)win * 2 + 0] += f[p.f_nz_req + 0];
                nonzero_used[(size_t)win * 2 + 1] += f[p.f_nz_req + 1];
                for (int s = 0; s < p.S; ++s)
                    sel_counts[(size_t)win * p.S + s] += f[p.f_sig_match + s];
                out[pod] = win;
            }
        }
        __syncthreads();
    }
    if (tid == 0) {
        out[p.P] = cursor;
        out[p.P + 1] = overflow;
    }
}

// ptrs: alloc, domain, static_ok, taint_cnt, aff_raw, img, aff_has_pref,
// feats, tie_words, logtab, used, nonzero_used, sel_counts, feas_s, ew_s,
// raw_s, total_s, out
extern "C" int launch_assign_scan(const ScanParams* p, void* const* ptrs,
                                  void* stream) {
    const size_t dyn = (size_t)((p->Nb + 31) / 32) * sizeof(unsigned);
    cudaError_t err = cudaFuncSetAttribute(
        assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
    assign_scan_kernel<<<1, NT, dyn, (cudaStream_t)stream>>>(
        *p, (const int*)ptrs[0], (const int*)ptrs[1], (const uint8_t*)ptrs[2],
        (const int*)ptrs[3], (const int*)ptrs[4], (const int*)ptrs[5],
        (const uint8_t*)ptrs[6], (const int*)ptrs[7], (const unsigned*)ptrs[8],
        (const float*)ptrs[9], (int*)ptrs[10], (int*)ptrs[11], (int*)ptrs[12],
        (uint8_t*)ptrs[13], (int*)ptrs[14], (int*)ptrs[15], (int*)ptrs[16],
        (int*)ptrs[17]);
    return (int)cudaGetLastError();
}
