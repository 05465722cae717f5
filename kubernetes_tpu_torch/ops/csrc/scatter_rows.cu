// K3 scatter_rows — replaces _scatter_rows_jit of the reference package
// (kubernetes_tpu/scheduler/tpu/backend.py:_scatter_rows_jit), the O(churn)
// delta upload: dev[k][idx] = rows[k] for every node plane in one launch.
//
// What it computes: for each plane k and each dirty row i, copy row_bytes[k]
// bytes from the packed upload buffer into row idx[i] of the resident
// device plane. An index at or past dst_rows[k] is dropped, as the
// reference's scatter drops it; a negative one (never passed) is dropped
// too. Duplicate indices carry identical rows and are benign.
//
// What bounds it on an H100: latency. The single-pod cycle dirties one
// row per assume (5008 launches in a TopologySpreading run), a wave at most
// 512 rows of ~100 bytes across the planes: tens of KB, far under a
// microsecond of memory time. On this card an empty launch takes ~0.83 us
// and a kernel whose one store waits on one index load ~1.3 us, so the
// design keeps every thread's chain to that one round trip. Each plane
// owns an equal power-of-two part of a flat thread space (2^part_log
// threads, at least a warp, so a warp never spans two planes) and each
// dirty row the same 2^lane_log lanes of it, so a thread's row index comes
// from uniform parameters alone: its index load goes out at once, beside
// the plane's fields (one uniform read per warp), and its row load, one
// copy unit of 16, 8, 4 or 1 bytes (the widest that divides the row and
// both pointers), goes out as soon as they arrive; the store waits for
// both. Consecutive lanes read consecutive units of the packed buffer. A
// byte plane (valid, unsched) or a one-unit row takes one lane per row
// when every row is one unit, so a warp covers 32 rows. No thread copies a
// row in a loop, and no block waits on one live thread: one dirty row is
// one block of a warp per plane, 512 rows a few dozen blocks. The widths,
// units and the two part sizes come from scatter_plan (kubernetes_tpu_torch
// /ops/kernels.py), which the wrapper writes into ScatterParams; the
// launch below uses its formula for the grid.
#include "common.cuh"

template <typename T>
__device__ __forceinline__ void copy_units(const ScatterParams& p, int k, int i, int lane,
                                           int row, bool keep) {
    const size_t nb = (size_t)p.row_bytes[k];
    const T* src = reinterpret_cast<const T*>(
        reinterpret_cast<const uint8_t*>(p.src[k]) + (size_t)i * nb);
    T* dst = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(p.dst[k]) +
                                  (size_t)(keep ? row : 0) * nb);
    for (int u = lane; u < p.units[k]; u += 1 << p.lane_log) {
        const T v = __ldg(src + u);
        if (keep) dst[u] = v;
    }
}

__global__ void scatter_rows_kernel(ScatterParams p, const int* __restrict__ idx) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.n_threads) return;
    const int k = t >> p.part_log;  // the plane: uniform in a warp
    const int r = t & ((1 << p.part_log) - 1);
    const int i = r >> p.lane_log;  // the dirty row
    if (i >= p.n_rows) return;      // the part's padding
    const int lane = r & ((1 << p.lane_log) - 1);
    const int row = __ldg(idx + i);
    const bool keep = row >= 0 && row < p.dst_rows[k];
    switch (p.width[k]) {
        case 16: copy_units<int4>(p, k, i, lane, row, keep); break;
        case 8: copy_units<int2>(p, k, i, lane, row, keep); break;
        case 4: copy_units<int>(p, k, i, lane, row, keep); break;
        default: copy_units<unsigned char>(p, k, i, lane, row, keep); break;
    }
}

// ptrs: idx. The grid is scatter_plan's: ceil(n_threads / block) blocks,
// n_threads = n_planes << part_log.
extern "C" int launch_scatter_rows(const ScatterParams* p, void* const* ptrs,
                                   void* stream) {
    if (p->n_rows == 0 || p->n_threads == 0) return 0;
    const int blocks = (p->n_threads + p->block - 1) / p->block;
    scatter_rows_kernel<<<blocks, p->block, 0, (cudaStream_t)stream>>>(
        *p, (const int*)ptrs[0]);
    return (int)cudaGetLastError();
}
