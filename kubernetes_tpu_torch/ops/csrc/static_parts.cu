// K1 static_parts — replaces the vmapped _static_pod_parts of the reference
// package (kubernetes_tpu/ops/kernels.py:_static_pod_parts, vmapped over the
// wave's pods inside _batched_assign_core, or with signature dedup over the
// first-occurrence rows uniq_idx only). Output row i reads feature row
// rows[i] when a row index is given, else feature row i.
//
// What it computes, per (pod, node): every filter and score input that does
// not depend on the scan carry — NodeUnschedulable, NodeName, the
// single-name affinity pin, TaintToleration (NoSchedule/NoExecute), required
// NodeAffinity/nodeSelector via the per-signature tables, NodePorts — folded
// into static_ok; plus the PreferNoSchedule intolerable-taint count, the
// preferred-affinity raw score and the ImageLocality score. Per pod it also
// writes aff_has_pref.
//
// What bounds it on an H100: the stores at 128 and more rows (13 bytes per
// (pod, node): 13.6 MB for 128 gang members on 8192 rows, 54.5 MB for a
// 512-pod wave, against a few hundred KB of reads); at 8 signature rows
// and small gangs, latency: the launch, the dependent round trips to
// memory and the instructions on the way (PERF.md §5h). Design:
// node-stationary tiles with the pods spread over warps. A block owns
// K1_TILE (128) consecutive nodes, lane l of every warp the K1_NPT (4)
// nodes 4l..4l+3, and a chunk of output rows that its warps take in turn
// (warp w rows w, w + warps, ...), so a block's pods run side by side.
// Everything a lane reads before its first pod is issued before any of
// it is used, one round trip (two through the rows map): its nodes'
// valid, unsched, group_id and (one signature row) aff_allow as 4-node
// vectors; their taints, prefer_taints, port_words and image_kib rows
// into registers; the small affinity tables (aff_match, aff_pref) into
// shared memory, or with one signature row and too many node groups for
// that, the lane's four entries into registers; each warp's pod records
// (the K1 feature fields, the rows map resolved), one lane per field,
// into shared memory. Vocabularies of one entry (the kernel instances
// MW = 1; each path measured so far runs them) ride in registers, so the
// scoring.cuh helpers, shared with K4, run on K1Params<1>, whose widths
// and record offsets are compile-time constants: their loops unroll over
// registers and their record reads are fixed shared-memory offsets. A
// wider vocabulary takes the MW = 0
// instance: the tile's rows staged in shared memory at an odd pitch (a
// warp's reads hit 32 banks), runtime widths and offsets; one too wide
// for shared memory reads its rows or records from device memory (pitch
// or rec 0), never refused. A pod then costs a lane shared-memory reads,
// register arithmetic, one 4-byte store of static_ok and one 16-byte
// store of each int32 output (a warp writes 128 and 3 x 512 contiguous
// bytes); only large tables with several signatures (and, at MW = 0, the
// image sizes) are read from device memory per pod. The chunk, the warps,
// MW, the table staging and the shared-memory plan are static_plan's
// (kubernetes_tpu_torch/ops/kernels.py), written into StaticParams; the
// launch below uses its formulas for the grid and the shared memory.
#include "scoring.cuh"

#define K1_NPT 4
#define K1_TILE (32 * K1_NPT)
#define K1_RPW 4  // a warp's pod records staged per pass
#define K1_TAB_PER_THREAD 8  // affinity-table entries a thread stages

// The MW > 0 instances' params: taint, prefer-taint, port and image rows
// padded to MW entries, and the pod record's fixed layout tol [MW] | tol_prefer
// [MW] | ports [MW] | img_idx [8] | tol_unsched, name_idx, aff_pin,
// aff_sig, has_ports, num_containers (3 * MW + 14 ints). The helpers read
// these compile-time members in place of StaticParams' runtime ones.
template <int MW>
struct K1Params : StaticParams {
    static constexpr int T = MW, Tp = MW, W = MW, I = MW;
    static constexpr int f_tol = 0, f_tol_prefer = MW, f_ports = 2 * MW, f_img_idx = 3 * MW,
                         f_tol_unsched = 3 * MW + 8, f_name_idx = 3 * MW + 9,
                         f_aff_pin = 3 * MW + 10, f_aff_sig = 3 * MW + 11,
                         f_has_ports = 3 * MW + 12, f_num_containers = 3 * MW + 13;
    static constexpr int rec = 3 * MW + 14;
};

// the feature column of field column c of the MW > 0 record, or -1 for a
// pad past the vocabulary (staged as 0: never tolerated, no port); selects
// rather than branches, as every lane takes its own column
template <int MW>
__device__ __forceinline__ int k1_record_source(const StaticParams& p, int c) {
    const int fld = c < 3 * MW ? c / MW : 3;
    const int j = c - fld * MW;
    const int base = fld == 0 ? p.f_tol : fld == 1 ? p.f_tol_prefer : p.f_ports;
    const int width = fld == 0 ? p.T : fld == 1 ? p.Tp : p.W;
    const int s = c - 3 * MW - 8;
    const int scalar = s == 0   ? p.f_tol_unsched
                       : s == 1 ? p.f_name_idx
                       : s == 2 ? p.f_aff_pin
                       : s == 3 ? p.f_aff_sig
                       : s == 4 ? p.f_has_ports
                                : p.f_num_containers;
    return c < 3 * MW ? (j < width ? base + j : -1)
                      : (c < 3 * MW + 8 ? p.f_img_idx + c - 3 * MW : scalar);
}

// the feature column of field column c of the MW = 0 record: tol [T] |
// tol_prefer [Tp] | ports [W] | img_idx [8] | the six scalars
__device__ __forceinline__ int record_source(const StaticParams& p, int c) {
    if (c < p.T) return p.f_tol + c;
    c -= p.T;
    if (c < p.Tp) return p.f_tol_prefer + c;
    c -= p.Tp;
    if (c < p.W) return p.f_ports + c;
    c -= p.W;
    if (c < 8) return p.f_img_idx + c;
    switch (c - 8) {
        case 0: return p.f_tol_unsched;
        case 1: return p.f_name_idx;
        case 2: return p.f_aff_pin;
        case 3: return p.f_aff_sig;
        case 4: return p.f_has_ports;
        default: return p.f_num_containers;
    }
}

// p with its f_* offsets moved into the MW = 0 record
__device__ __forceinline__ StaticParams record_params(const StaticParams& p) {
    StaticParams q = p;
    q.f_tol = 0;
    q.f_tol_prefer = p.T;
    q.f_ports = p.T + p.Tp;
    q.f_img_idx = p.T + p.Tp + p.W;
    q.f_tol_unsched = q.f_img_idx + 8;
    q.f_name_idx = q.f_img_idx + 9;
    q.f_aff_pin = q.f_img_idx + 10;
    q.f_aff_sig = q.f_img_idx + 11;
    q.f_has_ports = q.f_img_idx + 12;
    q.f_num_containers = q.f_img_idx + 13;
    return q;
}

// the output row's feature row (the clamp only keeps a bad row index from
// reading out of bounds)
__device__ __forceinline__ int feature_row(const StaticParams& p, const int* __restrict__ rows,
                                           int pod) {
    return rows ? clampi(rows[pod], 0, p.P_feats - 1) : pod;
}

// one plane's rows over the tile into shared memory (MW = 0): node slot s
// = q * 32 + l (node K1_NPT * l + q of the tile) at s * pitch; past Nb the
// rows read -1 (no taint, no port)
__device__ __forceinline__ void stage_rows(int* dst, const int* __restrict__ src, int width,
                                           int pitch, int tile0, int Nb) {
    for (int e = threadIdx.x; e < K1_TILE * width; e += blockDim.x) {
        const int ln = e / width, j = e - ln * width;
        const int n = tile0 + ln;
        dst[((ln % K1_NPT) * 32 + ln / K1_NPT) * pitch + j] =
            n < Nb ? src[(size_t)n * width + j] : -1;
    }
}

// a staged record entry: 0 for a pad, an image index clamped with the
// image plane's own width (a pad -1 stays), else the feature as it is
__device__ __forceinline__ int record_entry(int v, int src, bool img_lane, int I) {
    return src < 0 ? 0 : (img_lane && v >= 0 ? min(v, I - 1) : v);
}

// a taint id as the helpers clamp it with the plane's own width (the clamp
// only keeps a bad id from reading out of bounds); -1 stays a pad
__device__ __forceinline__ int clamp_id(int id, int width) {
    return id < 0 ? id : min(id, width - 1);
}

// how an instance reads the affinity tables: K1_ANY decides at run time
// (4-node vectors or not, tables in shared memory or per pod from device
// memory); K1_SHARED and K1_ONE_SIG assume 4-node vectors and hold the
// tables in shared memory, or (one signature row, too many node groups
// for shared memory) each lane's four entries in registers, gathered once
#define K1_ANY 0
#define K1_SHARED 1
#define K1_ONE_SIG 2

template <int MW, int MODE>
__global__ void static_parts_kernel(
    StaticParams p, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ unsched, const int* __restrict__ group_id,
    const int* __restrict__ taints, const int* __restrict__ prefer_taints,
    const int* __restrict__ port_words, const int* __restrict__ image_kib,
    const uint8_t* __restrict__ aff_match, const int* __restrict__ aff_pref,
    const uint8_t* __restrict__ aff_allow,
    const uint8_t* __restrict__ aff_has_pref_table,
    const int* __restrict__ feats, const int* __restrict__ rows,
    uint8_t* __restrict__ static_ok,
    int* __restrict__ taint_cnt, int* __restrict__ aff_raw,
    int* __restrict__ img, uint8_t* __restrict__ aff_has_pref) {
    constexpr int RW = MW > 0 ? MW : 1;  // register row entries (MW > 0)
    extern __shared__ int smem[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = tid >> 5, warps = blockDim.x >> 5;
    const int tile0 = blockIdx.x * K1_TILE;
    const int pod0 = blockIdx.y * p.chunk;
    const int n_pods = min(p.chunk, p.P - pod0);
    const bool vec = MODE != K1_ANY || p.vec;  // Nb % 4 == 0 and aligned planes
    const bool tab = MODE == K1_SHARED || (MODE == K1_ANY && p.tab);
    constexpr bool one_sig = MODE == K1_ONE_SIG;
    const int n_tab = tab ? p.A * p.G : 0;
    int* s_match = smem;
    int* s_pref = s_match + n_tab;
    int* s_taints = s_pref + n_tab;
    int* s_prefer = s_taints + K1_TILE * p.pitch_t;
    int* s_ports = s_prefer + K1_TILE * p.pitch_tp;
    int* s_rec = s_ports + K1_TILE * p.pitch_w;

    // 1. Every load a lane needs before its first pod goes out before any
    // of them is used: the rows map first; its nodes' valid, unsched,
    // group_id and (for a one-row signature table) aff_allow as 4-node
    // vectors; (MW > 0) their taints, prefer_taints and port_words rows;
    // the small affinity tables (K1_TAB_PER_THREAD entries a thread); (MW > 0) the warp's
    // first K1_RPW pod records. So the block waits one round trip (two
    // through the rows map), not one per kind. Addresses are clamped into
    // the planes rather than branched around; a lane past Nb (a bucket
    // under one tile) computes nothing with what it read.
    constexpr int REC = K1Params<RW>::rec;
    const int n0 = tile0 + K1_NPT * lane;
    int frow[K1_RPW];  // the rows map's entries, clamped once the node loads are out
    if constexpr (MW > 0) {
#pragma unroll
        for (int r = 0; r < K1_RPW; ++r) {
            const int pod = pod0 + min(warp + r * warps, n_pods - 1);
            frow[r] = rows ? rows[pod] : pod;
        }
    }
    int ok_in[K1_NPT], uns[K1_NPT], g[K1_NPT], allow0[K1_NPT];
    if (vec) {
        const int nv = min(n0, p.Nb - K1_NPT);
        const uchar4 v = *reinterpret_cast<const uchar4*>(valid + nv);
        const uchar4 u = *reinterpret_cast<const uchar4*>(unsched + nv);
        const int4 gg = *reinterpret_cast<const int4*>(group_id + nv);
        const uchar4 a = *reinterpret_cast<const uchar4*>(aff_allow + nv);
        ok_in[0] = v.x; ok_in[1] = v.y; ok_in[2] = v.z; ok_in[3] = v.w;
        uns[0] = u.x; uns[1] = u.y; uns[2] = u.z; uns[3] = u.w;
        g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
        allow0[0] = a.x; allow0[1] = a.y; allow0[2] = a.z; allow0[3] = a.w;
    } else {
#pragma unroll
        for (int q = 0; q < K1_NPT; ++q) {
            const int n = min(n0 + q, p.Nb - 1);
            ok_in[q] = n0 + q < p.Nb ? valid[n] : 0;
            uns[q] = unsched[n];
            g[q] = group_id[n];
            allow0[q] = aff_allow[n];
        }
    }
    int treg[K1_NPT][RW], preg[K1_NPT][RW], wreg[K1_NPT][RW], ireg[K1_NPT][RW];
    if constexpr (MW == 1 && MODE != K1_ANY) {
        // one entry a row (T = Tp = W = I = 1): the four nodes' rows are one
        // 16-byte vector of each plane (the wrapper's vec checks they align)
        const int nv = min(n0, p.Nb - K1_NPT);
        const int4 t4 = *reinterpret_cast<const int4*>(taints + nv);
        const int4 p4 = *reinterpret_cast<const int4*>(prefer_taints + nv);
        const int4 w4 = *reinterpret_cast<const int4*>(port_words + nv);
        const int4 i4 = *reinterpret_cast<const int4*>(image_kib + nv);
        treg[0][0] = t4.x; treg[1][0] = t4.y; treg[2][0] = t4.z; treg[3][0] = t4.w;
        preg[0][0] = p4.x; preg[1][0] = p4.y; preg[2][0] = p4.z; preg[3][0] = p4.w;
        wreg[0][0] = w4.x; wreg[1][0] = w4.y; wreg[2][0] = w4.z; wreg[3][0] = w4.w;
        ireg[0][0] = i4.x; ireg[1][0] = i4.y; ireg[2][0] = i4.z; ireg[3][0] = i4.w;
    } else if constexpr (MW > 0) {
#pragma unroll
        for (int q = 0; q < K1_NPT; ++q) {
            const size_t n = (size_t)min(n0 + q, p.Nb - 1);
#pragma unroll
            for (int j = 0; j < MW; ++j) {
                treg[q][j] = taints[n * p.T + min(j, p.T - 1)];
                preg[q][j] = prefer_taints[n * p.Tp + min(j, p.Tp - 1)];
                wreg[q][j] = port_words[n * p.W + min(j, p.W - 1)];
                ireg[q][j] = image_kib[n * p.I + min(j, p.I - 1)];
            }
        }
    }
    const int hp0 = aff_has_pref_table[0];
    int tmv[K1_TAB_PER_THREAD], tpv[K1_TAB_PER_THREAD];
#pragma unroll
    for (int r = 0; r < K1_TAB_PER_THREAD; ++r) {
        const int e = min(tid + r * (int)blockDim.x, max(n_tab - 1, 0));
        tmv[r] = aff_match[e];
        tpv[r] = aff_pref[e];
    }
    int src = -1, rv[K1_RPW];
    bool img_lane = false;
    if constexpr (MW > 0) {
        src = lane < REC ? k1_record_source<MW>(p, lane) : -1;
        // an image index is clamped here with the plane's own width, as the
        // helper clamps it with MW
        img_lane = lane >= 3 * MW && lane < 3 * MW + 8;
#pragma unroll
        for (int r = 0; r < K1_RPW; ++r) {
            // the clamp only keeps a bad row index from reading out of bounds
            const int row = clampi(frow[r], 0, p.P_feats - 1);
            rv[r] = feats[(size_t)row * p.F + max(src, 0)];
        }
    }

    // 2. Their uses: (one signature) the lane's table entries, gathered
    // by its nodes' groups; the tables' and records' shared copies (the
    // records past K1_RPW a warp, a pass each), the rows padded to MW
    // (taint ids -1, port words 0, image sizes 0) and clamped as the
    // helpers clamp with the plane's width;
    // (MW = 0) the block's records and the tile's rows at runtime widths
#pragma unroll
    for (int q = 0; q < K1_NPT; ++q) g[q] = clampi(g[q], 0, p.G - 1);
    int m1[K1_NPT], r1[K1_NPT];
    if constexpr (one_sig) {
#pragma unroll
        for (int q = 0; q < K1_NPT; ++q) {
            m1[q] = aff_match[g[q]];
            r1[q] = aff_pref[g[q]];
        }
    }
#pragma unroll
    for (int r = 0; r < K1_TAB_PER_THREAD; ++r) {
        const int e = tid + r * blockDim.x;
        if (e < n_tab) {
            s_match[e] = tmv[r];
            s_pref[e] = tpv[r];
        }
    }
    if constexpr (MW > 0) {
#pragma unroll
        for (int r = 0; r < K1_RPW; ++r) {
            const int c = warp + r * warps;
            if (c < n_pods && lane < REC) s_rec[c * REC + lane] = record_entry(rv[r], src, img_lane, p.I);
        }
        for (int c = warp + K1_RPW * warps; c < n_pods; c += warps) {
            const int v = feats[(size_t)feature_row(p, rows, pod0 + c) * p.F + max(src, 0)];
            if (lane < REC) s_rec[c * REC + lane] = record_entry(v, src, img_lane, p.I);
        }
#pragma unroll
        for (int q = 0; q < K1_NPT; ++q) {
#pragma unroll
            for (int j = 0; j < MW; ++j) {
                treg[q][j] = j < p.T ? clamp_id(treg[q][j], p.T) : -1;
                preg[q][j] = j < p.Tp ? clamp_id(preg[q][j], p.Tp) : -1;
                wreg[q][j] = j < p.W ? wreg[q][j] : 0;
                ireg[q][j] = j < p.I ? ireg[q][j] : 0;
            }
        }
    } else {
        if (p.rec) {
            for (int e = tid; e < n_pods * p.rec; e += blockDim.x) {
                const int c = e / p.rec, col = e - c * p.rec;
                s_rec[e] = feats[(size_t)feature_row(p, rows, pod0 + c) * p.F +
                                 record_source(p, col)];
            }
        }
        if (p.pitch_t) stage_rows(s_taints, taints, p.T, p.pitch_t, tile0, p.Nb);
        if (p.pitch_tp) stage_rows(s_prefer, prefer_taints, p.Tp, p.pitch_tp, tile0, p.Nb);
        if (p.pitch_w) stage_rows(s_ports, port_words, p.W, p.pitch_w, tile0, p.Nb);
    }
    // the helpers' params: K1Params<MW> (compile-time widths and record
    // offsets), or for MW = 0 the record's runtime offsets, or the feature
    // row's
    using FP = typename std::conditional<(MW > 0), K1Params<RW>, StaticParams>::type;
    FP fp;
    static_cast<StaticParams&>(fp) = MW > 0 || !p.rec ? p : record_params(p);
    const int* trow[K1_NPT];
    const int* prow[K1_NPT];
    const int* wrow[K1_NPT];
#pragma unroll
    for (int q = 0; q < K1_NPT; ++q) {
        if constexpr (MW > 0) {
            trow[q] = treg[q];
            prow[q] = preg[q];
            wrow[q] = wreg[q];
        } else {
            const int slot = q * 32 + lane;
            const size_t n = (size_t)min(n0 + q, p.Nb - 1);
            trow[q] = p.pitch_t ? s_taints + slot * p.pitch_t : taints + n * p.T;
            prow[q] = p.pitch_tp ? s_prefer + slot * p.pitch_tp : prefer_taints + n * p.Tp;
            wrow[q] = p.pitch_w ? s_ports + slot * p.pitch_w : port_words + n * p.W;
        }
    }
    __syncthreads();

    // 3. this warp's pods
    const int rec = MW > 0 ? REC : p.rec;
    for (int c = warp; c < n_pods; c += warps) {
        const int pod = pod0 + c;
        const int* f = MW > 0 || rec ? s_rec + c * rec
                                     : feats + (size_t)feature_row(p, rows, pod) * p.F;
        // aff_sig is an interned signature id < A; the clamp only keeps a
        // bad input from reading out of bounds
        const int sig = one_sig || p.A == 1 ? 0 : clampi(f[fp.f_aff_sig], 0, p.A - 1);
        if (blockIdx.x == 0 && lane == 0)
            aff_has_pref[pod] = one_sig || p.A == 1 ? hp0 : aff_has_pref_table[sig];
        if (n0 >= p.Nb) continue;
        const int tol_unsched = f[fp.f_tol_unsched];
        const int name_idx = f[fp.f_name_idx];
        const int pin = f[fp.f_aff_pin];
        // a pod that names no image scores 0 on every node (image_score's
        // total stays under its minimum): the warp skips the helper
        bool any_img = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) any_img |= f[fp.f_img_idx + j] >= 0;
        int al[K1_NPT];
        if (one_sig || p.A == 1) {
#pragma unroll
            for (int q = 0; q < K1_NPT; ++q) al[q] = allow0[q];
        } else if (vec) {
            const uchar4 a = *reinterpret_cast<const uchar4*>(aff_allow + (size_t)sig * p.Nb + n0);
            al[0] = a.x; al[1] = a.y; al[2] = a.z; al[3] = a.w;
        } else {
#pragma unroll
            for (int q = 0; q < K1_NPT; ++q)
                al[q] = n0 + q < p.Nb ? aff_allow[(size_t)sig * p.Nb + n0 + q] : 0;
        }
        int ok[K1_NPT], tc[K1_NPT], ar[K1_NPT], im[K1_NPT];
#pragma unroll
        for (int q = 0; q < K1_NPT; ++q) {
            const int n = n0 + q;
            const int t = sig * p.G + g[q];
            // NodeUnschedulable (node_unschedulable.go:142)
            bool fail = uns[q] && !tol_unsched;
            // NodeName (node_name.go:79) and the single-name affinity pin
            fail |= name_idx != -1 && n != name_idx;
            fail |= pin != -1 && n != pin;
            // TaintToleration filter (NoSchedule/NoExecute)
            fail |= untolerated_taint(fp, trow[q], f);
            // NodeAffinity required + nodeSelector: signature row over node
            // groups, AND the signature's node allowlist
            const int match = one_sig ? m1[q] : tab ? s_match[t] : aff_match[t];
            fail |= !(match && al[q]);
            // NodePorts
            fail |= ports_conflict(fp, wrow[q], f);
            ok[q] = ok_in[q] && !fail;
            tc[q] = prefer_taint_count(fp, prow[q], f);
            // NodeAffinity preferred raw score (node_affinity.go:272)
            ar[q] = one_sig ? r1[q] : tab ? s_pref[t] : aff_pref[t];
            const int* irow;
            if constexpr (MW > 0) irow = ireg[q];
            else irow = image_kib + (size_t)min(n, p.Nb - 1) * p.I;
            im[q] = any_img ? image_score(fp, irow, f) : 0;
        }
        const size_t o = (size_t)pod * p.Nb + n0;
        if (vec) {
            *reinterpret_cast<uint32_t*>(static_ok + o) =
                (uint32_t)ok[0] | ((uint32_t)ok[1] << 8) | ((uint32_t)ok[2] << 16) |
                ((uint32_t)ok[3] << 24);
            *reinterpret_cast<int4*>(taint_cnt + o) = make_int4(tc[0], tc[1], tc[2], tc[3]);
            *reinterpret_cast<int4*>(aff_raw + o) = make_int4(ar[0], ar[1], ar[2], ar[3]);
            *reinterpret_cast<int4*>(img + o) = make_int4(im[0], im[1], im[2], im[3]);
        } else {
#pragma unroll
            for (int q = 0; q < K1_NPT; ++q) {
                if (n0 + q >= p.Nb) break;
                static_ok[o + q] = (uint8_t)ok[q];
                taint_cnt[o + q] = tc[q];
                aff_raw[o + q] = ar[q];
                img[o + q] = im[q];
            }
        }
    }
}

// ptrs: valid, unsched, group_id, taints, prefer_taints, port_words,
// image_kib, aff_match, aff_pref, aff_allow, aff_has_pref_table, feats,
// rows (0 = none), static_ok, taint_cnt, aff_raw, img, aff_has_pref.
// static_plan's grid and shared memory: ceil(Nb / K1_TILE) node tiles x
// ceil(P / chunk) row chunks; (2 * A * G if tab) + K1_TILE * (pitch_t +
// pitch_tp + pitch_w) + chunk * rec ints.
extern "C" int launch_static_parts(const StaticParams* p, void* const* ptrs,
                                   void* stream) {
    if (p->P == 0 || p->Nb == 0) return 0;
    // staged tables are one pass of K1_TAB_PER_THREAD entries a thread
    if (p->tab && p->A * p->G > K1_TAB_PER_THREAD * p->threads)
        return (int)cudaErrorInvalidValue;
    dim3 grid((p->Nb + K1_TILE - 1) / K1_TILE, (p->P + p->chunk - 1) / p->chunk);
    const size_t smem =
        ((p->tab ? 2 * (size_t)p->A * p->G : 0) +
         (size_t)K1_TILE * (p->pitch_t + p->pitch_tp + p->pitch_w) +
         (size_t)p->chunk * p->rec) * sizeof(int);
    const int mode = !p->vec ? K1_ANY : p->tab ? K1_SHARED : p->A == 1 ? K1_ONE_SIG : K1_ANY;
    void (*kernel)(StaticParams, const uint8_t*, const uint8_t*, const int*, const int*,
                   const int*, const int*, const int*, const uint8_t*, const int*,
                   const uint8_t*, const uint8_t*, const int*, const int*, uint8_t*, int*, int*,
                   int*, uint8_t*) = static_parts_kernel<0, K1_ANY>;
    if (p->mw == 1)
        kernel = mode == K1_SHARED    ? static_parts_kernel<1, K1_SHARED>
                 : mode == K1_ONE_SIG ? static_parts_kernel<1, K1_ONE_SIG>
                                      : static_parts_kernel<1, K1_ANY>;

    kernel<<<grid, p->threads, smem, (cudaStream_t)stream>>>(
        *p, (const uint8_t*)ptrs[0], (const uint8_t*)ptrs[1],
        (const int*)ptrs[2], (const int*)ptrs[3], (const int*)ptrs[4],
        (const int*)ptrs[5], (const int*)ptrs[6], (const uint8_t*)ptrs[7],
        (const int*)ptrs[8], (const uint8_t*)ptrs[9], (const uint8_t*)ptrs[10],
        (const int*)ptrs[11], (const int*)ptrs[12], (uint8_t*)ptrs[13],
        (int*)ptrs[14], (int*)ptrs[15], (int*)ptrs[16], (uint8_t*)ptrs[17]);
    return (int)cudaGetLastError();
}

// The store floor beside K1 (a measurement yardstick that no path runs):
// K1's 13 bytes per (row, node) written in K1's layout, static_ok 4 nodes
// to a 32-bit word and each int32 output 4 nodes to a 16-byte store, with
// nothing read. One thread per 4 nodes of one row; Nb % 4 == 0 (every
// bucket is a power of two >= 8).
__global__ void static_store_floor_kernel(int P, int Nb, uint32_t* __restrict__ ok,
                                          int4* __restrict__ taint_cnt,
                                          int4* __restrict__ aff_raw,
                                          int4* __restrict__ img) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)P * (Nb / 4)) return;
    const int v = (int)t;
    ok[t] = 0x01010101u;
    taint_cnt[t] = make_int4(v, v, v, v);
    aff_raw[t] = make_int4(v, v, v, v);
    img[t] = make_int4(v, v, v, v);
}

// ptrs: static_ok, taint_cnt, aff_raw, img
extern "C" int launch_static_store_floor(int P, int Nb, void* const* ptrs, void* stream) {
    const long long quads = (long long)P * (Nb / 4);
    if (quads == 0) return 0;
    const int threads = 256;
    static_store_floor_kernel<<<(unsigned)((quads + threads - 1) / threads), threads, 0,
                                (cudaStream_t)stream>>>(
        P, Nb, (uint32_t*)ptrs[0], (int4*)ptrs[1], (int4*)ptrs[2], (int4*)ptrs[3]);
    return (int)cudaGetLastError();
}
