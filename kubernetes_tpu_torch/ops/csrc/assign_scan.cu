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
// a serial chain and each step is a few dependent block-wide reductions.
// Design: ONE thread block of 1024 threads loops over the pods; it walks
// only the bucket's live extent [0, extent), found in the prologue, each
// thread owning NPT positions (feasibility in register bit masks, partial
// totals in shared memory at the position), with one barrier per
// reduction and the tie draw folded into the totals' barrier
// (scan_step.cuh describes the layout). The launcher picks the
// instance that covers the bucket (NPT 8 up to 8192 node slots) and runs
// the filter phases only where hard spread or IPA is on (GATED). The
// carry planes are updated in place in device memory (copies the wrapper
// makes).
//
// scan_floor_kernel, beside it, is the latency floor of such a scan: the
// same counts of barriers, folds, cluster barriers, exchanges and tie picks
// as a scan reported, with no node work.
#include "scan_step.cuh"

template <int NPT, bool GATED>
__global__ void __launch_bounds__(SCAN_NT, 1) assign_scan_kernel(
    ScanParams p, ScanArgs a, int* out, int* tiers) {
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ ScanSyncs syncs;
    if (threadIdx.x == 0) syncs = {0, 0, 0, 0, 0};
    BlockComm comm = {0, p.Nb, red, 0, &syncs};
    const ScanEnd end = scan_block<false, NPT, GATED>(p, a, comm);
    if (threadIdx.x == 0) {
        out[p.P] = end.cursor;
        out[p.P + 1] = end.overflow;
        if (p.G > 0) {
            tiers[0] = end.n_full;
            tiers[1] = end.n_replay;
        }
        write_syncs(a.syncs, end.syncs, end.phase_cycles);
    }
}

// ptrs: as scan_args() in scan_step.cuh reads them
extern "C" int launch_assign_scan(const ScanParams* p, void* const* ptrs,
                                  void* stream) {
    const ScanArgs a = scan_args(ptrs);
    int* out = (int*)ptrs[19];
    int* tiers = (int*)ptrs[29];
    const size_t dyn = scan_smem_bytes(*p, p->Nb, false);
    return scan_dispatch(p->Nb, scan_gated(*p), [&](auto npt, auto gated) {
        auto kernel = assign_scan_kernel<decltype(npt)::value, decltype(gated)::value>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (err != cudaSuccess) return (int)err;
        kernel<<<1, SCAN_NT, dyn, (cudaStream_t)stream>>>(*p, a, out, tiers);
        return (int)cudaGetLastError();
    });
}

// The latency floor: n.fold single-barrier folds of two slots, n.bar bare
// block barriers, n.pick tie picks over NPT ballots (publish, barrier, the
// best, the tie count and the column/warp/bit search), and, in a cluster,
// n.csync cluster barriers and n.xch exchanges (ClusterComm::exchange:
// publish, cluster barrier, warp 0 reading the peers' slots, a block
// barrier). One block, or one cluster of
// n_blocks; out[0] keeps the values alive.
template <bool CLUSTER>
__global__ void __launch_bounds__(SCAN_NT, 1) scan_floor_kernel(ScanSyncs n, int npt, int* out) {
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ unsigned pk[2][SCAN_NWARPS][SCAN_MAX_NPT + 1];
    __shared__ int xch[3 * SCAN_RED];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int acc = threadIdx.x, par = 0;
    for (int i = 0; i < n.fold; ++i) {
        int v[2] = {acc, acc};
        fold_block<2>(v, 0x1u, 0x2u, red[par]);
        par ^= 1;
        acc += (v[0] - v[1]) & 1;
    }
    for (int i = 0; i < n.bar; ++i) {
        __syncthreads();
        acc += 1;
    }
    for (int i = 0; i < n.pick; ++i) {
        for (int j = 0; j < npt; ++j) {
            const unsigned b = __ballot_sync(FULL_MASK, ((acc + j + lane) & 7) == 0);
            if (lane == 0) pk[par][wid][1 + j] = b;
        }
        if (lane == 0) pk[par][wid][0] = (unsigned)(acc & 3);
        __syncthreads();
        const bool has_w = lane < SCAN_NWARPS;
        const int wm = has_w ? (int)pk[par][lane][0] : 0;
        const int bb = __reduce_max_sync(FULL_MASK, wm);
        int mine = 0;
        for (int j = 0; j < npt; ++j) mine += has_w ? __popc(pk[par][lane][1 + j]) : 0;
        const int bc = (int)__reduce_add_sync(FULL_MASK, (unsigned)(wm == bb ? mine : 0));
        int accn = 0, c_sel = 0;
        for (int j = 0; j < npt; ++j) {
            const int c = has_w ? __popc(pk[par][lane][1 + j]) : 0;
            const int t = (int)__reduce_add_sync(FULL_MASK, (unsigned)c);
            if (accn <= (bc >> 1)) c_sel = c;
            accn += t;
        }
        int incl = c_sel;
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(FULL_MASK, incl, off);
            if (lane >= off) incl += o;
        }
        acc += __shfl_sync(FULL_MASK, incl, 31) & 1;
        par ^= 1;
    }
    if constexpr (CLUSTER) {
        cg::cluster_group cl = cg::this_cluster();
        const int nb = (int)cl.num_blocks();
        for (int i = 0; i < n.csync; ++i) {
            cl.sync();
            acc += 1;
        }
        ScanSyncs counts = {};
        ClusterComm comm = {0, 0, (int)cl.block_rank(), nb, red, 0, xch, 0, &counts};
        for (int i = 0; i < n.xch; ++i) {
            int v[1] = {acc};
            comm.template exchange<1>(v, 1u, 0u);
            acc += v[0] & 1;
        }
        cl.sync();  // no block leaves while a peer may still read its slots
    }
    if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = acc;
}

// the floor of a scan's counted synchronisations (syncs [5] as
// write_syncs leaves them) over one block, or a cluster of n_blocks (2-8)
extern "C" int launch_scan_floor(const int* syncs, int npt, int n_blocks, int* out,
                                 void* stream) {
    const ScanSyncs n = {syncs[0], syncs[1], syncs[2], syncs[3], syncs[4]};
    if (npt < 1 || npt > SCAN_MAX_NPT) return (int)cudaErrorInvalidValue;
    if (n_blocks <= 1) {
        scan_floor_kernel<false><<<1, SCAN_NT, 0, (cudaStream_t)stream>>>(n, npt, out);
        return (int)cudaGetLastError();
    }
    if (n_blocks > SCAN_MAX_SHARDS) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_blocks, 1, 1);
    cfg.blockDim = dim3(SCAN_NT, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, scan_floor_kernel<true>, n, npt, out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
