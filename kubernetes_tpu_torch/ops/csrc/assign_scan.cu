// K2 assign_scan — replaces _batched_assign_jit of the reference package
// (kubernetes_tpu/ops/kernels.py:_batched_assign_jit -> _batched_assign_core
// -> _assign_step, both tiers, with _dom_counts_init :820,
// _pts_hard_carried :855, _finish_total :887, _pts_score_carried :673,
// the InterPodAffinity filters and score, and the chained launch's
// cross-wave seed of the signature table and device cursor :1308-1328).
//
// What it computes: the greedy wave scan. Pod i+1 sees pod i's placement.
// The step itself (both tiers, hard spread, inter-pod affinity, the tie
// draw, the winner's adds and the signature-row patch) is scan_block() in
// scan_step.cuh, which K5 gang_assign runs too, once per placement mask.
// A chained wave (pipelined launch) passes the previous wave's signature
// table with a slot map, gathered into this wave's table in the block's
// prologue, and its predecessor's final tie cursor as a device pointer,
// read in the kernel minus the host's frame shift: no host round trip
// between chained launches. K5 passes neither.
//
// What bounds it on an H100: latency, not bytes or operations. The pods are
// a serial chain and each step is a handful of dependent block-wide
// reductions. Design: ONE thread block of 1024 threads loops over the pods
// (scan_step.cuh describes the passes); the carry planes are updated in
// place in device memory (copies the wrapper makes).
#include "scan_step.cuh"

__global__ void __launch_bounds__(SCAN_NT, 1) assign_scan_kernel(
    ScanParams p, ScanArgs a, int* out, int* tiers) {
    BlockComm comm(p.Nb);
    const ScanEnd end = scan_block<false>(p, a, comm);
    if (threadIdx.x == 0) {
        out[p.P] = end.cursor;
        out[p.P + 1] = end.overflow;
        if (p.G > 0) {
            tiers[0] = end.n_full;
            tiers[1] = end.n_replay;
        }
    }
}

// ptrs: as scan_args() in scan_step.cuh reads them
extern "C" int launch_assign_scan(const ScanParams* p, void* const* ptrs,
                                  void* stream) {
    const size_t dyn = scan_smem_bytes(*p);
    cudaError_t err = cudaFuncSetAttribute(
        assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
    const ScanArgs a = scan_args(ptrs);
    assign_scan_kernel<<<1, SCAN_NT, dyn, (cudaStream_t)stream>>>(
        *p, a, (int*)ptrs[20], (int*)ptrs[30]);
    return (int)cudaGetLastError();
}
