// K6 sharded_assign — replaces _sharded_assign_jit of the reference package
// (kubernetes_tpu/parallel/mesh.py:159): _batched_assign_core in a
// shard_map over the nodes axis, each reduction an AxisComm collective
// (kubernetes_tpu/ops/kernels.py:107-131).
//
// What it computes: exactly K2's outputs (the greedy wave scan, both tiers,
// hard spread, inter-pod affinity, the cross-wave seed and the device
// cursor) with the node axis cut into n ranges. On one card a node shard is
// one block of a thread-block cluster of n blocks, or, where a shard passes
// one block's 16384 slots, m blocks (the launch plan, scan_plan in
// ops/kernels.py, picks n = shards x m: 1, 2, 4, 8 or 16, the last a
// non-portable size): block r owns nodes [r*Nb/n, (r+1)*Nb/n) of every
// plane and of the signature table's columns, and the reference's psum,
// pmax, pmin, all_gather and axis_index become exchanges through
// distributed shared memory after cluster barriers (ClusterComm in
// scan_step.cuh, which runs K2's step code). Every cross-shard reduction is
// a max, a min or an int32 sum, so the result equals K2's bit for bit
// whatever the block count. K2's wrapper launches this kernel too (its
// cluster route) for a bucket past one block's slots, and for domain tables
// past shared memory. The file builds twice (ops/cuda.py DEFINES): with
// -DSCAN_GMEM its instances keep the domain tables in a device-memory
// scratch (the GTAB instances of scan_step.cuh, on any cluster size, one
// block included), else in rank 0's shared memory. Past the card's largest
// cluster each block walks its range in passes (p.passes, the pass
// instance of scan_step.cuh, built with -DSCAN_PASS for either table
// placement), and any bucket the card's memory holds runs on the largest
// cluster.
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
    int blocks;  // cluster size: 1, 2, 4, 8 or 16, dividing Nb
};

template <int NPT, bool GATED, bool GTAB, bool PASS>
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
    const ScanEnd end = scan_block<false, NPT, GATED, GTAB, PASS>(p, a, comm);
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

// the cluster launch of one instance over n blocks with `dyn` bytes each
template <typename K>
cudaLaunchConfig_t cluster_config(K kernel, int n, size_t dyn, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaError_t& err) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err == cudaSuccess && n > 8)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n, 1, 1);
    cfg.blockDim = dim3(SCAN_NT, 1, 1);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

#ifdef SCAN_CARDS
// The card level of K6 (comm.cuh CardComm): one instance per card, each a
// cluster of `blocks` blocks over the card's contiguous range of the node
// axis (the planes, K1's outputs, the carry and the signature table's
// columns are the card's own tensors; node indices are card-local but in
// the results, which take the card's offset), the reference's collectives
// crossing cards through peer memory. Always the GTAB instance: the domain
// tables, the hard-spread counts and the signature table's segs/pcs/valid
// are one copy on card 0 that every card's blocks add into and read. The
// exit barrier keeps every card in the kernel until no peer can still
// write its memory (the last step's winner adds and patches).
template <int NPT, bool GATED>
__global__ void __launch_bounds__(SCAN_NT, 1) sharded_assign_cards_kernel(
    ShardParams sp, ScanArgs a, CardLink link, int* tiers) {
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int xch[3 * SCAN_RED];
    __shared__ int cres[2][SCAN_RED];
    __shared__ CardLink lk;
    __shared__ int dead;
    __shared__ ScanSyncs syncs;
    if (threadIdx.x == 0) {
        syncs = {};
        lk = link;
        dead = 0;
    }
    __syncthreads();
    cg::cluster_group cl = cg::this_cluster();
    const ScanParams& p = sp.scan;
    const int r = (int)cl.block_rank(), n = (int)cl.num_blocks();
    const int nbl = p.Nb / n;
    CardComm<ClusterComm> comm = {{r * nbl, (r + 1) * nbl, r, n, red, 0, xch, 0, &syncs},
                                  &lk, 0, 0, cres, 0, &dead};
    const ScanEnd end = scan_block<false, NPT, GATED, true, false>(p, a, comm);
    comm.sync();
    if (r == 0 && threadIdx.x == 0) {
        a.winners[p.P] = end.cursor;
        a.winners[p.P + 1] = end.overflow;
        if (p.G > 0) {
            tiers[0] = end.n_full;
            tiers[1] = end.n_replay;
        }
        if (link.card == 0) write_syncs(a.syncs, end.syncs, end.phase_cycles);
        link.ctl[1] = end.syncs.card;
    }
    cl.sync();
}

// The card level's latency floor: n card exchanges of four words (each a
// block fold and a card fold, fenced as the kernels' are) on one block per
// card, with no node work
__global__ void __launch_bounds__(SCAN_NT, 1) card_floor_kernel(CardLink link, int n, int* out) {
    __shared__ int red[2][SCAN_NWARPS][SCAN_RED];
    __shared__ int cres[2][SCAN_RED];
    __shared__ CardLink lk;
    __shared__ int dead;
    __shared__ ScanSyncs syncs;
    if (threadIdx.x == 0) {
        syncs = {};
        lk = link;
        dead = 0;
    }
    __syncthreads();
    CardComm<BlockComm> comm = {{0, 0, red, 0, &syncs}, &lk, 0, 0, cres, 0, &dead};
    int acc = threadIdx.x;
    for (int i = 0; i < n; ++i) {
        int v[4] = {acc, acc, acc, acc};
        comm.template reduce<4>(v, 0x1u, 0x2u);
        acc += v[0] & 1;
    }
    if (threadIdx.x == 0) out[0] = acc;
}
#endif

// ptrs: as scan_args() in scan_step.cuh reads them (K2's list: the GTAB
// instance's device-memory scratch, scan_smem's `tables` words, at 38, 0
// where the tables live in shared memory; the pass instance's position
// scratch, scan_pass_words, at 40, 0 in one pass)
#ifndef SCAN_CARDS
extern "C" int launch_sharded_assign(const ShardParams* sp, void* const* ptrs,
                                     void* stream) {
    const int n = sp->blocks;
    if (n < 1 || n > SCAN_MAX_BLOCKS || (n & (n - 1)) || sp->scan.Nb % n)
        return (int)cudaErrorInvalidValue;
    const int span = sp->scan.Nb / n;
    const size_t dyn = scan_smem_bytes(sp->scan, span, false);
    ScanArgs a = scan_args(ptrs);
    a.tables = (int*)ptrs[38];
    if (sp->scan.gtab && a.tables == nullptr) return (int)cudaErrorInvalidValue;
    if (sp->scan.passes > 0 && a.pos == nullptr) return (int)cudaErrorInvalidValue;
    return scan_dispatch(span, scan_gated(sp->scan), sp->scan.gtab != 0, sp->scan.passes,
                         [&](auto npt, auto gated, auto gtab, auto pass) {
        auto kernel = sharded_assign_kernel<decltype(npt)::value, decltype(gated)::value,
                                            decltype(gtab)::value, decltype(pass)::value>;
        cudaLaunchAttribute attr[1];
        cudaError_t err;
        cudaLaunchConfig_t cfg = cluster_config(kernel, n, dyn, (cudaStream_t)stream, attr, err);
        if (err != cudaSuccess) return (int)err;
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters < 1) return SHARD_CLUSTER_DOES_NOT_FIT;
        err = cudaLaunchKernelEx(&cfg, kernel, *sp, a, (int*)ptrs[19], (int*)ptrs[29]);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
    });
}

#endif

#ifdef SCAN_CARDS
// K6 on one card of a card-level launch: ptrs as launch_sharded_assign's
// (the GTAB tables at 38, on card 0; the signature table's segs/pcs/valid,
// the hard-spread counts likewise card 0's), `link` the launch's card
// level; `ranks` the card ranks this launch's card holds (two ranks on one
// card run side by side on two streams): the launch is refused where fewer
// clusters than that can be resident at once
extern "C" int launch_sharded_assign_cards(const ShardParams* sp, void* const* ptrs,
                                           const CardLink* link, int ranks, void* stream) {
    const int n = sp->blocks;
    if (n < 1 || n > SCAN_MAX_BLOCKS || (n & (n - 1)) || sp->scan.Nb % n || !sp->scan.gtab ||
        sp->scan.passes > 0 || link->cards < 1 || link->cards > CARD_MAX || ranks < 1 ||
        ptrs[38] == nullptr)
        return (int)cudaErrorInvalidValue;
    const int span = sp->scan.Nb / n;
    const size_t dyn = scan_smem_bytes(sp->scan, span, false);
    ScanArgs a = scan_args(ptrs);
    a.tables = (int*)ptrs[38];
    return scan_dispatch(span, scan_gated(sp->scan), true, 0,
                         [&](auto npt, auto gated, auto, auto) {
        auto kernel = sharded_assign_cards_kernel<decltype(npt)::value, decltype(gated)::value>;
        cudaLaunchAttribute attr[1];
        cudaError_t err;
        cudaLaunchConfig_t cfg = cluster_config(kernel, n, dyn, (cudaStream_t)stream, attr, err);
        if (err != cudaSuccess) return (int)err;
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters < ranks) return SHARD_CLUSTER_DOES_NOT_FIT;
        err = cudaLaunchKernelEx(&cfg, kernel, *sp, a, *link, (int*)ptrs[29]);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
    });
}

extern "C" int launch_card_floor(const CardLink* link, int n, int* out, void* stream) {
    if (link->cards < 1 || link->cards > CARD_MAX || n < 0) return (int)cudaErrorInvalidValue;
    card_floor_kernel<<<1, SCAN_NT, 0, (cudaStream_t)stream>>>(*link, n, out);
    return (int)cudaGetLastError();
}

// A stream of the calling thread's card that never waits for the legacy
// default stream (cudaStreamNonBlocking): a second card rank on one card
// runs there, side by side with the first on the card's current stream
extern "C" int create_nonblocking_stream(void** out) {
    cudaStream_t s = nullptr;
    const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *out = (void*)s;
    return (int)err;
}

// Peer access from the calling thread's card to card `peer` (both directions
// are asked by the wrapper, once per pair): cudaErrorPeerAccessUnsupported
// where the pair has none; an access already enabled is no error
extern "C" int enable_peer_access(int dev, int peer) {
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return (int)err;
    int can = 0;
    err = cudaDeviceCanAccessPeer(&can, dev, peer);
    if (err != cudaSuccess) return (int)err;
    if (!can) return (int)cudaErrorPeerAccessUnsupported;
    err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        err = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(cur);
    return (int)(err != cudaSuccess ? err : back);
}
#endif

#if !defined(SCAN_PASS) && !defined(SCAN_CARDS)
// What the scan's launch plan needs from this card, asked once: out[0] the
// largest cluster of scanning blocks (16, else 8, 4, 2, 1; 0 none) that
// one GPC holds with `dyn` bytes of dynamic shared memory each
// (cudaOccupancyMaxActiveClusters on the widest instance); out[1] the
// largest static shared memory of this library's scan instances (each
// library's table placement: ops/cuda.py asks both); out[2] the shared
// memory a block may opt into on this card
extern "C" int scan_limits(int dyn, int* out) {
    constexpr bool G = SCAN_GTAB_LIB;
    auto widest = sharded_assign_kernel<SCAN_MAX_NPT, true, G, false>;
    out[0] = 0;
    for (int n = SCAN_MAX_BLOCKS; n >= 1 && out[0] == 0; n /= 2) {
        cudaLaunchAttribute attr[1];
        cudaError_t err;
        cudaLaunchConfig_t cfg = cluster_config(widest, n, (size_t)dyn, nullptr, attr, err);
        if (err != cudaSuccess) return (int)err;
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, widest, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters >= 1) out[0] = n;
    }
    const void* kernels[4] = {(const void*)sharded_assign_kernel<8, false, G, false>,
                              (const void*)sharded_assign_kernel<8, true, G, false>,
                              (const void*)sharded_assign_kernel<16, false, G, false>,
                              (const void*)sharded_assign_kernel<16, true, G, false>};
    out[1] = 0;
    for (const void* k : kernels) {
        cudaFuncAttributes fa;
        cudaError_t err = cudaFuncGetAttributes(&fa, k);
        if (err != cudaSuccess) return (int)err;
        if ((int)fa.sharedSizeBytes > out[1]) out[1] = (int)fa.sharedSizeBytes;
    }
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(&out[2], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
#endif
