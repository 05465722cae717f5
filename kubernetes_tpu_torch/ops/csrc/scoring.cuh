// Filter and score formulas shared by the kernels: K1 static_parts, K2
// assign_scan and K4 fit_and_score include this header, so each formula
// has one definition. The helpers are templates over the kernel's params
// struct; they read the same field names (f_* packed-feature offsets, the
// scoring config) from each.
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

// Reduce N ints over a block of exactly 1024 threads (32 warps): slot i
// takes the max when bit i of maxmask is set, the min when bit i of minmask
// is set, else the wrapping sum. red is a [32][N] and res an [N] shared
// array; every thread gets the results in v. Contains two __syncthreads().
template <int N>
__device__ __forceinline__ void block_reduce(int (&v)[N], unsigned maxmask,
                                             unsigned minmask, int (*red)[N],
                                             int* res) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bool mx = (maxmask >> i) & 1u, mn = (minmask >> i) & 1u;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int o = __shfl_xor_sync(FULL_MASK, v[i], off);
            v[i] = mx ? max(v[i], o) : (mn ? min(v[i], o) : wadd(v[i], o));
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[wid][i] = v[i];
    }
    __syncthreads();
    if (wid == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const bool mx = (maxmask >> i) & 1u, mn = (minmask >> i) & 1u;
            int x = red[lane][i];  // 32 warps: every lane holds a warp's value
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const int o = __shfl_xor_sync(FULL_MASK, x, off);
                x = mx ? max(x, o) : (mn ? min(x, o) : wadd(x, o));
            }
            if (lane == 0) res[i] = x;
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = res[i];
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
