// K2 assign_scan — replaces _batched_assign_jit of the reference package
// (kubernetes_tpu/ops/kernels.py:_batched_assign_jit -> _batched_assign_core
// -> _assign_step, both tiers, with _dom_counts_init :820,
// _pts_hard_carried :855, _finish_total :887, _pts_score_carried :673 and
// the InterPodAffinity filters and score); the cross-wave seeding of the
// signature table (:1314-1328) is not ported.
//
// What it computes: the greedy wave scan. Pod i+1 sees pod i's placement.
// The step itself (both tiers, hard spread, inter-pod affinity, the tie
// draw, the winner's adds and the signature-row patch) is scan_block() in
// scan_step.cuh, which K5 gang_assign runs too, once per placement mask.
//
// What bounds it on an H100: latency, not bytes or operations. The pods are
// a serial chain and each step is a handful of dependent block-wide
// reductions. Design: ONE thread block of 1024 threads loops over the pods
// (scan_step.cuh describes the passes); the carry planes are updated in
// place in device memory (copies the wrapper makes).
#include "scan_step.cuh"

__global__ void __launch_bounds__(SCAN_NT, 1) assign_scan_kernel(
    ScanParams p, ScanArgs a, int* out, int* tiers) {
    const ScanEnd end = scan_block<false>(p, a);
    if (threadIdx.x == 0) {
        out[p.P] = end.cursor;
        out[p.P + 1] = end.overflow;
        if (p.G > 0) {
            tiers[0] = end.n_full;
            tiers[1] = end.n_replay;
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
    const size_t dyn = scan_smem_bytes(*p);
    cudaError_t err = cudaFuncSetAttribute(
        assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
    ScanArgs a;
    a.alloc = (const int*)ptrs[0];
    a.domain = (const int*)ptrs[1];
    a.valid = (const uint8_t*)ptrs[2];
    a.mask = nullptr;
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
    a.dom_counts = (int*)ptrs[18];
    a.scratch = (int*)ptrs[19];
    a.winners = (int*)ptrs[20];
    a.sig_ids = (const int*)ptrs[21];
    a.uniq_idx = (const int*)ptrs[22];
    a.t_valid = (uint8_t*)ptrs[23];
    a.t_ew = (int*)ptrs[24];
    a.t_ffit = (uint8_t*)ptrs[25];
    a.t_feas = (uint8_t*)ptrs[26];
    a.t_segs = (int*)ptrs[27];
    a.t_pcs = (int*)ptrs[28];
    a.sig_scores = (int*)ptrs[29];
    assign_scan_kernel<<<1, SCAN_NT, dyn, (cudaStream_t)stream>>>(
        *p, a, (int*)ptrs[20], (int*)ptrs[30]);
    return (int)cudaGetLastError();
}
