// K1 static_parts — replaces the vmapped _static_pod_parts of the reference
// package (kubernetes_tpu/ops/kernels.py:_static_pod_parts, vmapped over the
// wave's pods inside _batched_assign_core).
//
// What it computes, per (pod, node): every filter and score input that does
// not depend on the scan carry — NodeUnschedulable, NodeName, the
// single-name affinity pin, TaintToleration (NoSchedule/NoExecute), required
// NodeAffinity/nodeSelector via the per-signature tables, NodePorts — folded
// into static_ok; plus the PreferNoSchedule intolerable-taint count, the
// preferred-affinity raw score and the ImageLocality score. Per pod it also
// writes aff_has_pref.
//
// What bounds it on an H100: bytes. It writes 13 bytes per (pod, node)
// (static_ok 1 + three int32), 54.5 MB for a 512 x 8192 wave, against a few
// hundred KB of plane and table reads that stay in L2 across pods. Design:
// one thread per (pod, node) on a 2-D grid (x = nodes, y = pods), so each
// warp's stores are contiguous along the node axis; the plane rows a thread
// reads are shared by every pod of the wave and hit L2 after the first.
#include "common.cuh"

__global__ void static_parts_kernel(
    StaticParams p, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ unsched, const int* __restrict__ group_id,
    const int* __restrict__ taints, const int* __restrict__ prefer_taints,
    const int* __restrict__ port_words, const int* __restrict__ image_kib,
    const uint8_t* __restrict__ aff_match, const int* __restrict__ aff_pref,
    const uint8_t* __restrict__ aff_allow,
    const uint8_t* __restrict__ aff_has_pref_table,
    const int* __restrict__ feats, uint8_t* __restrict__ static_ok,
    int* __restrict__ taint_cnt, int* __restrict__ aff_raw,
    int* __restrict__ img, uint8_t* __restrict__ aff_has_pref) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int pod = blockIdx.y;
    const int* f = feats + (size_t)pod * p.F;
    // aff_sig is an interned signature id < A; the clamp only keeps a bad
    // input from reading out of bounds
    const int sig = clampi(f[p.f_aff_sig], 0, p.A - 1);
    if (n == 0) aff_has_pref[pod] = aff_has_pref_table[sig];
    if (n >= p.Nb) return;

    // NodeUnschedulable (node_unschedulable.go:142)
    bool fail = unsched[n] && !f[p.f_tol_unsched];
    // NodeName (node_name.go:79) and the single-name affinity pin
    const int name_idx = f[p.f_name_idx];
    fail |= name_idx != -1 && n != name_idx;
    const int pin = f[p.f_aff_pin];
    fail |= pin != -1 && n != pin;
    // TaintToleration filter: a NoSchedule/NoExecute taint the pod does not
    // tolerate; ids are vocab ids < T, -1 pads
    for (int j = 0; j < p.T; ++j) {
        const int tid = taints[(size_t)n * p.T + j];
        if (tid >= 0 && !f[p.f_tol + clampi(tid, 0, p.T - 1)]) fail = true;
    }
    // NodeAffinity required + nodeSelector: signature row over node groups,
    // AND the signature's node allowlist
    const int g = clampi(group_id[n], 0, p.G - 1);
    fail |= !(aff_match[(size_t)sig * p.G + g] &&
              aff_allow[(size_t)sig * p.Nb + n]);
    // NodePorts: any used host-port bit the pod also wants
    if (f[p.f_has_ports]) {
        for (int j = 0; j < p.W; ++j) {
            if (port_words[(size_t)n * p.W + j] & f[p.f_ports + j]) fail = true;
        }
    }
    const size_t o = (size_t)pod * p.Nb + n;
    static_ok[o] = valid[n] && !fail;

    // TaintToleration score input: intolerable PreferNoSchedule taints
    int cnt = 0;
    for (int j = 0; j < p.Tp; ++j) {
        const int tid = prefer_taints[(size_t)n * p.Tp + j];
        if (tid >= 0 && !f[p.f_tol_prefer + clampi(tid, 0, p.Tp - 1)]) ++cnt;
    }
    taint_cnt[o] = cnt;
    // NodeAffinity preferred raw score (node_affinity.go:272)
    aff_raw[o] = aff_pref[(size_t)sig * p.G + g];

    // ImageLocality (image_locality.go:93-105), totals in KiB
    int total = 0;
    for (int j = 0; j < 8; ++j) {
        const int idx = f[p.f_img_idx + j];
        if (idx >= 0) total += image_kib[(size_t)n * p.I + clampi(idx, 0, p.I - 1)];
    }
    const int min_kib = 23 * 1024;
    const int max_thr = 1024 * 1024 * f[p.f_num_containers];
    int score;
    if (total < min_kib) {
        score = 0;
    } else if (total > max_thr) {
        score = MAX_NODE_SCORE;
    } else {
        const int span = max(max_thr - min_kib, 1);
        score = floordiv(MAX_NODE_SCORE * (total - min_kib), span);
    }
    img[o] = score;
}

// ptrs: valid, unsched, group_id, taints, prefer_taints, port_words,
// image_kib, aff_match, aff_pref, aff_allow, aff_has_pref_table, feats,
// static_ok, taint_cnt, aff_raw, img, aff_has_pref
extern "C" int launch_static_parts(const StaticParams* p, void* const* ptrs,
                                   void* stream) {
    const int threads = 256;
    dim3 grid((p->Nb + threads - 1) / threads, p->P);
    static_parts_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        *p, (const uint8_t*)ptrs[0], (const uint8_t*)ptrs[1],
        (const int*)ptrs[2], (const int*)ptrs[3], (const int*)ptrs[4],
        (const int*)ptrs[5], (const int*)ptrs[6], (const uint8_t*)ptrs[7],
        (const int*)ptrs[8], (const uint8_t*)ptrs[9], (const uint8_t*)ptrs[10],
        (const int*)ptrs[11], (uint8_t*)ptrs[12], (int*)ptrs[13],
        (int*)ptrs[14], (int*)ptrs[15], (uint8_t*)ptrs[16]);
    return (int)cudaGetLastError();
}
