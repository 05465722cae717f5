// K6 sharded_assign — replaces _sharded_assign_jit of the reference package
// (kubernetes_tpu/parallel/mesh.py:159): _batched_assign_core in a
// shard_map over the nodes axis, each reduction an AxisComm collective
// (kubernetes_tpu/ops/kernels.py:107-131).
//
// What it computes: exactly K2's outputs (the greedy wave scan, both tiers,
// hard spread, inter-pod affinity, the cross-wave seed and the device
// cursor) with the node axis cut into n shards. On one card a node shard is
// one block of a thread-block cluster of n blocks (n = 1, 2, 4 or 8, the
// portable cluster sizes): block r owns nodes [r*Nb/n, (r+1)*Nb/n) of every
// plane and of the signature table's columns, and the reference's psum,
// pmax, pmin, all_gather and axis_index become exchanges through
// distributed shared memory after cluster barriers (ClusterComm in
// scan_step.cuh, which runs K2's step code). Every cross-shard reduction is
// a max, a min or an int32 sum, so the result equals K2's bit for bit.
//
// What bounds it on an H100: latency, as K2: each pod step is a chain of
// dependent reductions, each a block fold followed by a cluster barrier
// and a read of the n partials by every warp; each block walks the live
// extent of its range with K2's owned-position layout (NPT chosen for
// Nb/n slots), so its passes are n times shorter. The cluster must be
// co-resident (n SMs of one GPC, 1024 threads and the scan's dynamic
// shared memory each): the launcher asks cudaOccupancyMaxActiveClusters
// first and refuses a cluster that does not fit rather than launch a
// smaller one.
#include "scan_step.cuh"

// returned by the launcher when the cluster cannot be co-resident
#define SHARD_CLUSTER_DOES_NOT_FIT (-2)

struct ShardParams {
    ScanParams scan;
    int n_shards;  // cluster size: 1, 2, 4 or 8, dividing Nb
};

template <int NPT, bool GATED>
__global__ void __launch_bounds__(SCAN_NT, 1) sharded_assign_kernel(
    ShardParams sp, ScanArgs a, int* out, int* tiers) {
    // the fold and exchange slots, at the same address in every block
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int xch[3 * SCAN_RED];
    __shared__ ScanSyncs syncs;
    if (threadIdx.x == 0) syncs = {0, 0, 0, 0, 0};
    cg::cluster_group cl = cg::this_cluster();
    const ScanParams& p = sp.scan;
    const int r = (int)cl.block_rank(), n = (int)cl.num_blocks();
    const int nbl = p.Nb / n;
    ClusterComm comm = {r * nbl, (r + 1) * nbl, r, n, red, 0, xch, 0, &syncs};
    const ScanEnd end = scan_block<false, NPT, GATED>(p, a, comm);
    if (r == 0 && threadIdx.x == 0) {
        out[p.P] = end.cursor;
        out[p.P + 1] = end.overflow;
        if (p.G > 0) {
            tiers[0] = end.n_full;
            tiers[1] = end.n_replay;
        }
        write_syncs(a.syncs, end.syncs, end.phase_cycles);
    }
    // no block leaves while a peer may still read its shared memory
    cl.sync();
}

// ptrs: as scan_args() in scan_step.cuh reads them (K2's list)
extern "C" int launch_sharded_assign(const ShardParams* sp, void* const* ptrs,
                                     void* stream) {
    const int n = sp->n_shards;
    if (n < 1 || n > SCAN_MAX_SHARDS || sp->scan.Nb % n) return (int)cudaErrorInvalidValue;
    const int span = sp->scan.Nb / n;
    const size_t dyn = scan_smem_bytes(sp->scan, span, false);
    const ScanArgs a = scan_args(ptrs);
    return scan_dispatch(span, scan_gated(sp->scan), [&](auto npt, auto gated) {
        auto kernel = sharded_assign_kernel<decltype(npt)::value, decltype(gated)::value>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (err != cudaSuccess) return (int)err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(n, 1, 1);
        cfg.blockDim = dim3(SCAN_NT, 1, 1);
        cfg.dynamicSmemBytes = dyn;
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = n;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters < 1) return SHARD_CLUSTER_DOES_NOT_FIT;
        err = cudaLaunchKernelEx(&cfg, kernel, *sp, a, (int*)ptrs[19], (int*)ptrs[29]);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
    });
}
