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
// What bounds it on an H100: launch latency. A wave dirties at most 512
// rows of ~100 bytes across the planes, some 50 KB read and written, well
// under a microsecond of memory time. Design: one launch for all planes (a
// pointer table passed by value), grid.y = plane, one thread per row,
// word-wide copies when the row and both pointers are 4-byte aligned.
#include "common.cuh"

__global__ void scatter_rows_kernel(ScatterParams p, const int* __restrict__ idx) {
    const int k = blockIdx.y;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= p.n_planes || i >= p.n_rows) return;
    const int row = idx[i];
    if (row < 0 || row >= p.dst_rows[k]) return;
    const int nb = p.row_bytes[k];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(p.src[k]) + (size_t)i * nb;
    uint8_t* dst = reinterpret_cast<uint8_t*>(p.dst[k]) + (size_t)row * nb;
    if ((nb & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
        const int* s4 = reinterpret_cast<const int*>(src);
        int* d4 = reinterpret_cast<int*>(dst);
        for (int b = 0; b < nb / 4; ++b) d4[b] = s4[b];
    } else {
        for (int b = 0; b < nb; ++b) dst[b] = src[b];
    }
}

// ptrs: idx
extern "C" int launch_scatter_rows(const ScatterParams* p, void* const* ptrs,
                                   void* stream) {
    if (p->n_rows == 0 || p->n_planes == 0) return 0;
    const int threads = 128;
    dim3 grid((p->n_rows + threads - 1) / threads, p->n_planes);
    scatter_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        *p, (const int*)ptrs[0]);
    return (int)cudaGetLastError();
}
