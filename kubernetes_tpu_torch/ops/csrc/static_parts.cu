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
// What bounds it on an H100: bytes. It writes 13 bytes per (pod, node)
// (static_ok 1 + three int32), 54.5 MB for a 512 x 8192 wave, against a few
// hundred KB of plane and table reads that stay in L2 across pods. Design:
// one thread per (pod, node) on a 2-D grid (x = nodes, y = pods), so each
// warp's stores are contiguous along the node axis; the plane rows a thread
// reads are shared by every pod of the wave and hit L2 after the first.
#include "scoring.cuh"

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
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int pod = blockIdx.y;  // output row
    // the clamp only keeps a bad row index from reading out of bounds
    const int row = rows ? clampi(rows[pod], 0, p.P_feats - 1) : pod;
    const int* f = feats + (size_t)row * p.F;
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
    // TaintToleration filter (NoSchedule/NoExecute)
    fail |= untolerated_taint(p, taints + (size_t)n * p.T, f);
    // NodeAffinity required + nodeSelector: signature row over node groups,
    // AND the signature's node allowlist
    const int g = clampi(group_id[n], 0, p.G - 1);
    fail |= !(aff_match[(size_t)sig * p.G + g] &&
              aff_allow[(size_t)sig * p.Nb + n]);
    // NodePorts
    fail |= ports_conflict(p, port_words + (size_t)n * p.W, f);
    const size_t o = (size_t)pod * p.Nb + n;
    static_ok[o] = valid[n] && !fail;

    taint_cnt[o] = prefer_taint_count(p, prefer_taints + (size_t)n * p.Tp, f);
    // NodeAffinity preferred raw score (node_affinity.go:272)
    aff_raw[o] = aff_pref[(size_t)sig * p.G + g];
    img[o] = image_score(p, image_kib + (size_t)n * p.I, f);
}

// ptrs: valid, unsched, group_id, taints, prefer_taints, port_words,
// image_kib, aff_match, aff_pref, aff_allow, aff_has_pref_table, feats,
// rows (0 = none), static_ok, taint_cnt, aff_raw, img, aff_has_pref
extern "C" int launch_static_parts(const StaticParams* p, void* const* ptrs,
                                   void* stream) {
    const int threads = 256;
    dim3 grid((p->Nb + threads - 1) / threads, p->P);
    static_parts_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        *p, (const uint8_t*)ptrs[0], (const uint8_t*)ptrs[1],
        (const int*)ptrs[2], (const int*)ptrs[3], (const int*)ptrs[4],
        (const int*)ptrs[5], (const int*)ptrs[6], (const uint8_t*)ptrs[7],
        (const int*)ptrs[8], (const uint8_t*)ptrs[9], (const uint8_t*)ptrs[10],
        (const int*)ptrs[11], (const int*)ptrs[12], (uint8_t*)ptrs[13],
        (int*)ptrs[14], (int*)ptrs[15], (int*)ptrs[16], (uint8_t*)ptrs[17]);
    return (int)cudaGetLastError();
}
