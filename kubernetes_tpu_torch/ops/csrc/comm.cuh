// The reduction scope of the kernels that fold over node ranges, a template
// policy as the reference's comm (kubernetes_tpu/ops/kernels.py:81-131):
// BlockComm, one block of threads owning every node (K2, K5; K7 at
// one block per pod), and ClusterComm, a thread-block cluster of n blocks,
// block r owning a node range, its reductions exchanged through
// distributed shared memory (K6, K4; K7 past one block per pod). The scan
// (scan_step.cuh) and K4 (fit_and_score.cu) share these, so there is one
// copy of the fold and of the DSMEM exchange.
//
// Every reduction is a max, a min or a wrapping int32 sum: the result does
// not depend on the order or on the number of blocks, and no float32 sum
// crosses a block. A fold is one barrier: each warp reduces with
// __reduce_*_sync, writes its partials to a double-buffered shared array,
// and after the barrier every warp folds the 32 partials itself. A cluster
// reduction adds one exchange: thread 0 publishes the block's result in a
// parity slot, a cluster barrier, warp 0 reads the n slots and folds them,
// and a block barrier hands the result to every warp. K4's per-domain
// tables live in each block's own shared memory; after the exchange's
// barrier each block sums every block's words into a second copy of its
// own (small tables) or the blocks sum them by slices in place (large
// ones; fold_words). K6's are one set in rank 0's that every block adds
// into (tables()). CardComm, at the end of this file, wraps either policy
// with a card level: several cards of one host, exchanging through
// peer-mapped device memory.
#pragma once

#include <cooperative_groups.h>

#include "scoring.cuh"

namespace cg = cooperative_groups;

// the scan's block (K2, K5, K6, K7); K4's has FIT_NT threads. The fold
// arrays hold SCAN_NWARPS warps, the most a block has
#define SCAN_NT 1024
#define SCAN_NWARPS (SCAN_NT / 32)
#define SCAN_RED 10
#define SCAN_BIG 2147483647
// a table fold of at most this many words times blocks reads every block's
// words in each block (one cluster barrier); a larger one sums by slices
#define COMM_GATHER_WORDS 16384

// The counted synchronisations of a kernel (thread 0): block barriers,
// single-barrier folds, cluster barriers, cluster exchanges, tie picks
// (the scan) and table folds with their words (K4). The latency-floor
// kernels replay these counts with no node work.
struct ScanSyncs {
    int bar, fold, csync, xch, pick, tfold, twords, card;
};

// one warp's reduction of x: max, min or a wrapping int32 sum
template <int OP>
__device__ __forceinline__ int warp_op(int x) {
    if constexpr (OP == 1) return __reduce_max_sync(FULL_MASK, x);
    else if constexpr (OP == 2) return __reduce_min_sync(FULL_MASK, x);
    else return (int)__reduce_add_sync(FULL_MASK, (unsigned)x);
}

__device__ __forceinline__ int fold_op(int x, unsigned maxmask, unsigned minmask, int i) {
    if ((maxmask >> i) & 1u) return warp_op<1>(x);
    if ((minmask >> i) & 1u) return warp_op<2>(x);
    return warp_op<0>(x);
}

// the identity of slot i's fold
__device__ __forceinline__ int fold_id(unsigned maxmask, unsigned minmask, int i) {
    return ((maxmask >> i) & 1u) ? -SCAN_BIG - 1 : (((minmask >> i) & 1u) ? SCAN_BIG : 0);
}

// The block fold of N ints in ONE barrier: every warp reduces its values
// (slot i takes the max when bit i of maxmask is set, the min when bit i of
// minmask is, else the wrapping sum), lane 0 writes them to red[wid], and
// after the barrier every warp folds the block's warps' partials itself
// (lane l reads warp l's). red is one parity of a double-buffered
// [2][SCAN_NWARPS][SCAN_RED] array: a fold's buffer is rewritten two folds
// later, after a barrier every reader has passed.
template <int N>
__device__ __forceinline__ void fold_block(int (&v)[N], unsigned maxmask, unsigned minmask,
                                           int (*red)[SCAN_RED]) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = fold_op(v[i], maxmask, minmask, i);
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[wid][i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i)
        v[i] = fold_op(lane < (int)(blockDim.x >> 5) ? red[lane][i] : fold_id(maxmask, minmask, i),
                       maxmask, minmask, i);
}

// counts one synchronisation (thread 0, into the block's shared counts)
__device__ __forceinline__ void tick(int& c) {
    if (threadIdx.x == 0) ++c;
}

// One block owns the whole node axis (K2, K5; K7 at one block per pod).
struct BlockComm {
    static constexpr bool kCluster = false;
    static constexpr bool kCards = false;
    int lo, hi;  // the node range this block walks
    int (*red)[SCAN_NWARPS][SCAN_RED];
    int par;
    ScanSyncs* n;  // the synchronisations so far (shared; thread 0 counts)
    __device__ int rank() const { return 0; }
    // whether this block writes the replicated state (the scan's lead),
    // whether its card holds the replicated state in device memory, and
    // the global index of its card's first node (0 but at the card level)
    __device__ bool lead() const { return true; }
    __device__ bool home() const { return true; }
    __device__ int offset() const { return 0; }
    // a pod's winner (or -1) into the results
    __device__ void store_out(int* out, int pod, int win) const { out[pod] = win; }
    // the shared-memory domain tables the block adds into and reads
    __device__ int* tables(int* local) const { return local; }
    __device__ void sync() {
        tick(n->bar);
        __syncthreads();
    }
    template <int N>
    __device__ void reduce(int (&v)[N], unsigned maxmask, unsigned minmask) {
        tick(n->fold);
        fold_block<N>(v, maxmask, minmask, red[par]);
        par ^= 1;
    }
    // this block's fold only (the same under both policies)
    template <int N>
    __device__ void reduce_local(int (&v)[N], unsigned maxmask, unsigned minmask) {
        reduce<N>(v, maxmask, minmask);
    }
    __device__ int sync_or(int x) {
        tick(n->bar);
        return __syncthreads_or(x);
    }
    // the blocks' best score and tie count: the block's own
    __device__ void pick(int bb, int bc, int& best, int& ties, int& prefix) {
        best = bb;
        ties = bc;
        prefix = 0;
    }
    // reduce v, and make the block's own per-domain tables whole (K4; they
    // are read where they were added, out == t): the fold's barrier
    // publishes every add
    template <int N>
    __device__ void reduce_tables(int (&v)[N], unsigned maxmask, unsigned minmask, int*, int*,
                                  int) {
        reduce<N>(v, maxmask, minmask);
    }
    // the exit fence of a cluster: nothing to wait for in one block
    __device__ void arrive() {}
    __device__ void wait() {}
};

// A cluster of n blocks, block r owning nodes [lo, hi) (K6; K4, and K7
// past one block per pod, own two ranges, fit_and_score.cu). xch is a
// shared [3][SCAN_RED] array: two exchange slots (double-buffered by
// parity: a slot is rewritten only after a later cluster barrier has
// passed every peer's read of it) and the gathered result, declared in the
// kernel so that every block has it at the same address.
struct ClusterComm {
    static constexpr bool kCluster = true;
    static constexpr bool kCards = false;
    int lo, hi, r, nb;
    int (*red)[SCAN_NWARPS][SCAN_RED];
    int par;
    int* xch;
    int xpar;
    ScanSyncs* n;
    __device__ int rank() const { return r; }
    __device__ bool lead() const { return r == 0; }
    __device__ bool home() const { return true; }
    __device__ int offset() const { return 0; }
    __device__ void store_out(int* out, int pod, int win) const { out[pod] = win; }
    __device__ int* tables(int* local) const {
        return cg::this_cluster().map_shared_rank(local, 0);
    }
    __device__ void sync() {
        tick(n->csync);
        cg::this_cluster().sync();
    }
    // every thread holds this block's v: every warp folds the n blocks'
    __device__ int* publish(const int* v, int cnt) {
        int* slot = xch + xpar * SCAN_RED;
        if (threadIdx.x == 0) {
            for (int i = 0; i < cnt; ++i) slot[i] = v[i];
        }
        tick(n->xch);
        cg::this_cluster().sync();
        xpar ^= 1;
        return slot;
    }
    // warp 0 folds the n blocks' published values of a slot (lane q reads
    // block q's) and hands the result to the block through shared memory:
    // one remote read per block and value, where a read by every warp
    // queued 32 times as many on the cluster's network (xch's third part
    // holds the result; the next write to it comes after the next
    // publish's cluster barrier, which every reader has passed)
    template <int N>
    __device__ void gather(int (&v)[N], const int* slot, unsigned maxmask, unsigned minmask) {
        int* res = xch + 2 * SCAN_RED;
        if (threadIdx.x < 32) {
            cg::cluster_group cl = cg::this_cluster();
            const int lane = threadIdx.x;
            int x[N];
#pragma unroll
            for (int i = 0; i < N; ++i)
                x[i] = lane < nb ? *cl.map_shared_rank(slot + i, lane) : fold_id(maxmask, minmask, i);
#pragma unroll
            for (int i = 0; i < N; ++i) {
                x[i] = fold_op(x[i], maxmask, minmask, i);
                if (lane == 0) res[i] = x[i];
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = res[i];
    }
    template <int N>
    __device__ void exchange(int (&v)[N], unsigned maxmask, unsigned minmask) {
        gather<N>(v, publish(v, N), maxmask, minmask);
    }
    // whether a fold of `words` table words reads every block's words
    // (fold_words with out != t) or sums them by slices in place
    __host__ __device__ static bool gathers(int words, int n_blocks) {
        return n_blocks > 1 && words * n_blocks <= COMM_GATHER_WORDS;
    }
    // The sum of every block's words [0, words) of `t` (a per-block
    // shared-memory table set, at the same address in every block) into
    // every block's `out`. Call after a cluster barrier that closed every
    // block's adds. Gathered (out != t): each block reads all n blocks'
    // words itself; the caller's next block barrier publishes out, and t
    // stays untouched until the next cluster barrier. In place (out == t):
    // block r sums its slice of the words over the n blocks and writes the
    // sum back into each; a cluster barrier must follow before any read.
    __device__ void fold_words(const int* t, int* out, int words) {
        cg::cluster_group cl = cg::this_cluster();
        if (out != t) {
            for (int w = threadIdx.x; w < words; w += blockDim.x) {
                int s = 0;
                for (int q = 0; q < nb; ++q) s = wadd(s, *cl.map_shared_rank(t + w, q));
                out[w] = s;
            }
        } else {
            const int per = (words + nb - 1) / nb;
            const int a = r * per, b = min(words, a + per);
            for (int w = a + (int)threadIdx.x; w < b; w += blockDim.x) {
                int s = 0;
                for (int q = 0; q < nb; ++q) s = wadd(s, *cl.map_shared_rank(out + w, q));
                for (int q = 0; q < nb; ++q) *cl.map_shared_rank(out + w, q) = s;
            }
        }
        tick(n->tfold);
        if (threadIdx.x == 0) n->twords += words;
    }
    // reduce v over the cluster, and fold the per-block tables t [0, words)
    // into `out` of every block (K4; out == t folds in place): the
    // exchange's barrier also closes the adds; in place, one more barrier
    // publishes the folded tables
    template <int N>
    __device__ void reduce_tables(int (&v)[N], unsigned maxmask, unsigned minmask, int* t,
                                  int* out, int words) {
        reduce_local<N>(v, maxmask, minmask);
        const int* slot = publish(v, N);
        if (out != t) {
            fold_words(t, out, words);
            gather<N>(v, slot, maxmask, minmask);
        } else {
            gather<N>(v, slot, maxmask, minmask);
            fold_words(t, out, words);
            sync();
        }
    }
    // The exit fence: no block may leave while a peer can still read its
    // shared memory. arrive() after the block's last cluster access, wait()
    // before it exits; no cluster barrier may come between them.
    __device__ void arrive() {
        tick(n->csync);
        asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    }
    __device__ void wait() {
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    template <int N>
    __device__ void reduce_local(int (&v)[N], unsigned maxmask, unsigned minmask) {
        tick(n->fold);
        fold_block<N>(v, maxmask, minmask, red[par]);
        par ^= 1;
    }
    template <int N>
    __device__ void reduce(int (&v)[N], unsigned maxmask, unsigned minmask) {
        reduce_local<N>(v, maxmask, minmask);
        exchange<N>(v, maxmask, minmask);
    }
    __device__ int sync_or(int x) {
        tick(n->bar);
        int v[1] = {__syncthreads_or(x)};
        exchange<1>(v, 1u, 0u);
        return v[0];
    }
    // every block's (best, tie count) in rank order: the cluster's best, its
    // tie count and the ties of the blocks before this one, in every thread
    __device__ void pick(int bb, int bc, int& best, int& ties, int& prefix) {
        cg::cluster_group cl = cg::this_cluster();
        const int mine[2] = {bb, bc};
        int* slot = publish(mine, 2);
        const int lane = threadIdx.x & 31;
        const int qb = lane < nb ? *cl.map_shared_rank(slot, lane) : -SCAN_BIG - 1;
        const int qc = lane < nb ? *cl.map_shared_rank(slot + 1, lane) : 0;
        best = __reduce_max_sync(FULL_MASK, qb);
        const int c = qb == best ? qc : 0;
        ties = (int)__reduce_add_sync(FULL_MASK, (unsigned)c);
        prefix = (int)__reduce_add_sync(FULL_MASK, (unsigned)(lane < r ? c : 0));
    }
};



// ---------------------------------------------------------------------------
// The card level: several cards of one host, each holding a contiguous range
// of the node axis, card c's blocks a cluster (or, K7, one block per pod)
// over its range. The reference's collectives cross chips inside its
// shard_map scan (AxisComm, kubernetes_tpu/ops/kernels.py:107-131); here
// they cross cards inside the kernels, through peer-mapped device memory
// over NVLink: a launch of one instance per card, all resident at once.
//
// CardComm<Inner> wraps an in-card policy (ClusterComm for K6 and K4,
// BlockComm for K7 at one block per pod). Each reduction first runs the
// in-card one, which leaves the card's partial in every thread; then warp
// 0's lane q of the card's rank-0 block writes that partial into card q's
// inbox (plain stores, then the exchange's 64-bit sequence number with a
// system-scope release), and warp 0's lane q of EVERY block spins with a
// system-scope acquire on its own card's inbox slot of card q until that
// sequence number arrives, reads card q's words and folds them across the
// lanes; a block barrier hands the result to every warp. Reads are local
// (each card's inbox is its own memory); only the writes cross NVLink.
//
// Slots: [group][parity][source card][CARD_SLOT words], a group per pod
// (K4, K7) or one for the scan (K6). Exchange k of a launch writes parity
// k & 1 with sequence number (epoch << 32) + k + 1, epoch the wrapper's
// launch counter, so no stale word ever matches. A writer reaches exchange
// k + 2 only after reading every card's k + 1 partial, which each card's
// rank 0 wrote after its in-card barrier of k + 1, which every block of
// that card passes only after its read of k: a slot is rewritten only
// after every reader is done with it. A spin waits for a sequence number
// at least the one it expects, so a peer already in its next launch
// (whose numbers are larger) releases it as well.
//
// The replicated state (the scan's domain tables, the hard-spread counts,
// the signature table's segs/pcs/valid; K4's and K7's domain tables) has
// one copy, on card 0 (the home card, device memory: the GTAB instances),
// which every card's blocks add into and read through peer pointers;
// every thread fences at system scope before and after each card
// exchange, so the adds made before an exchange are seen by every card
// after it. The scan's winners are written into every card's results.
//
// A rank that never arrives: each spin is bounded (CARD_SPIN_CYCLES); one
// that runs out sets the card's error word (ctl[0]) and the block's dead
// flag, after which the block waits no more, and the wrapper raises.
#define CARD_MAX 8
#define CARD_SLOT 16
#define CARD_SPIN_CYCLES (1LL << 34)

// the launch's card level (ops/cuda.py CardParams, same field order)
struct CardLink {
    int card, cards, node_off, group0;
    long long seq;         // epoch << 32
    int* inbox[CARD_MAX];  // card q's inbox, peer-mapped
    int* outs[CARD_MAX];   // card q's packed results (K6's winners go to every card)
    int* ctl;              // this card's control words: [0] error, [1] card exchanges
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(const void* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void st_release_sys(void* p, unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void fence_sys() {
    asm volatile("fence.acq_rel.sys;\n" ::: "memory");
}

template <class Inner>
struct CardComm : Inner {
    static constexpr bool kCards = true;
    const CardLink* link;  // the launch's link (a shared copy)
    int group;             // this pod's slot group (K6: 0)
    int k;                 // card exchanges so far (every thread counts alike)
    int (*cres)[SCAN_RED];  // shared [2][SCAN_RED]: the folded result, by parity
    int cpar;
    int* dead;  // shared: a spin of this block ran out

    __device__ bool lead() const { return Inner::lead() && link->card == 0; }
    __device__ bool home() const { return link->card == 0; }
    __device__ int offset() const { return link->node_off; }
    // the winner's global index into every card's results
    __device__ void store_out(int*, int pod, int win) const {
        const int v = win >= 0 ? win + link->node_off : win;
        for (int q = 0; q < link->cards; ++q) link->outs[q][pod] = v;
    }
    __device__ int* slot(int q, int par, int src) const {
        return link->inbox[q] +
               ((size_t)((link->group0 + group) * 2 + par) * CARD_MAX + src) * CARD_SLOT;
    }
    // one card exchange of this card's N words `mine` (the same in every
    // block): in warp 0, lane q < cards gets card q's words in x (its own
    // card's from mine). Every thread calls it
    template <int N>
    __device__ void card_round(const int (&mine)[N], int (&x)[N]) {
        const int me = link->card, C = link->cards, par = k & 1;
        const unsigned long long seq = (unsigned long long)link->seq + (unsigned)k + 1u;
        ++k;
        tick(Inner::n->card);
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
#pragma unroll
            for (int i = 0; i < N; ++i) x[i] = mine[i];
            if (Inner::rank() == 0 && lane < C && lane != me) {
                int* s = slot(lane, par, me);
#pragma unroll
                for (int i = 0; i < N; ++i) s[2 + i] = mine[i];
                st_release_sys(s, seq);
            }
            if (lane < C && lane != me && !*(volatile int*)dead) {
                const int* s = slot(me, par, lane);
                const long long t0 = clock64();
                bool ok = true;
                while (ld_acquire_sys(s) < seq) {
                    if (clock64() - t0 > CARD_SPIN_CYCLES) {
                        ok = false;
                        atomicExch(link->ctl, 1);
                        *(volatile int*)dead = 1;
                        break;
                    }
                }
                if (ok) {
#pragma unroll
                    for (int i = 0; i < N; ++i) x[i] = ((volatile const int*)s)[2 + i];
                }
            }
        }
    }
    // fold N words over the cards (every thread holds its card's v)
    template <int N>
    __device__ void card_fold(int (&v)[N], unsigned maxmask, unsigned minmask) {
        int x[N];
        card_round<N>(v, x);
        int* res = cres[cpar];
        cpar ^= 1;
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int y = fold_op(lane < link->cards ? x[i] : fold_id(maxmask, minmask, i),
                                      maxmask, minmask, i);
                if (lane == 0) res[i] = y;
            }
        }
        __syncthreads();
        fence_sys();
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = res[i];
    }
    template <int N>
    __device__ void reduce(int (&v)[N], unsigned maxmask, unsigned minmask) {
        fence_sys();
        Inner::template reduce<N>(v, maxmask, minmask);
        card_fold<N>(v, maxmask, minmask);
    }
    template <int N>
    __device__ void exchange(int (&v)[N], unsigned maxmask, unsigned minmask) {
        fence_sys();
        Inner::template exchange<N>(v, maxmask, minmask);
        card_fold<N>(v, maxmask, minmask);
    }
    // a barrier over every block of every card
    __device__ void sync() {
        fence_sys();
        Inner::sync();
        int v[1] = {0};
        card_fold<1>(v, 1u, 0u);
    }
    __device__ int sync_or(int x) {
        fence_sys();
        int v[1] = {Inner::sync_or(x)};
        card_fold<1>(v, 1u, 0u);
        return v[0];
    }
    // the cards' best and tie count, and the ties before this block: those
    // of the earlier cards at the best score, then the in-card prefix (node
    // order is card-major, then block, then pass)
    __device__ void pick(int bb, int bc, int& best, int& ties, int& prefix) {
        int cb, ct, cp;
        Inner::pick(bb, bc, cb, ct, cp);
        const int mine[2] = {cb, ct};
        int x[2];
        card_round<2>(mine, x);
        int* res = cres[cpar];
        cpar ^= 1;
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
            const int qb = lane < link->cards ? x[0] : -SCAN_BIG - 1;
            const int qc = lane < link->cards ? x[1] : 0;
            const int b = __reduce_max_sync(FULL_MASK, qb);
            const int c = qb == b ? qc : 0;
            const int t = (int)__reduce_add_sync(FULL_MASK, (unsigned)c);
            const int pre = (int)__reduce_add_sync(FULL_MASK,
                                                   (unsigned)(lane < link->card ? c : 0));
            if (lane == 0) {
                res[0] = b;
                res[1] = t;
                res[2] = pre;
            }
        }
        __syncthreads();
        best = res[0];
        ties = res[1];
        prefix = res[2] + (cb == best ? cp : 0);
    }
};
