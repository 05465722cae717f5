// Shared helpers and parameter blocks for the port's kernels.
//
// Every struct here has a ctypes twin in kubernetes_tpu_torch/ops/cuda.py
// with the same field order; all scalars are int32 and all arrays fixed
// size, so the two layouts agree without padding rules. The fixed arrays
// do not bound what a launch computes: a configuration past them passes
// its tables beside the block (the launch tables, below).
//
// Numerics (the bit-exact contract with the reference package):
// - integer division is FLOOR division (jnp `//`); C/CUDA `/` truncates, so
//   every division goes through floordiv() below;
// - float32 lines use the explicitly rounded intrinsics (__fadd_rn,
//   __fmul_rn, __fdiv_rn, __fsqrt_rn) and the build passes -fmad=false, so
//   no a*b+c is contracted into an FMA and every op rounds as numpy/XLA do.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define MAX_NODE_SCORE 100
#define MAX_TIE_DRAWS 16

__host__ __device__ inline int floordiv(int a, int b) {
    int q = a / b;
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__host__ __device__ inline int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// K1 static_parts: dims + packed-feature column offsets, and the launch
// plan of kubernetes_tpu_torch/ops/kernels.py static_plan
struct StaticParams {
    int P;        // output rows (pods, or signature rows with dedup)
    int P_feats;  // rows of the packed feature buffer
    int Nb, T, Tp, W, I, A, G, F;
    int f_tol_unsched, f_name_idx, f_aff_pin, f_tol, f_aff_sig, f_ports,
        f_has_ports, f_tol_prefer, f_img_idx, f_num_containers;
    int threads;  // per block: 32 x its warps, each warp its own rows
    int chunk;    // output rows per block, taken by its warps in turn
    int mw;       // kernel instance: rows of at most mw (1, 2) entries in
                  // registers; 0: runtime widths
    int rec;      // ints per staged pod record (0: read the feature rows)
    int tab;      // aff_match and aff_pref staged in shared memory
    int pitch_t, pitch_tp, pitch_w;  // mw 0: shared-memory row pitch of the
                                     // tile's taints, prefer_taints,
                                     // port_words (0: read them from
                                     // device memory)
    int vec;      // 4-node vector loads and stores (Nb % 4 == 0, aligned)
};

// A scan or fit library compiles the instances of one table placement:
// with -DSCAN_GMEM (ops/cuda.py DEFINES) the GTAB instances, their domain
// tables in a device-memory scratch, else those with the tables in shared
// memory. Two libraries compile side by side in half the time of one with
// both.
#ifdef SCAN_GMEM
#define SCAN_GTAB_LIB true
#else
#define SCAN_GTAB_LIB false
#endif
// The same for a scan's passes: with -DSCAN_PASS a cluster library builds
// the pass instances (p.passes > 0, past the card's largest cluster), else
// those of one pass, so no nvcc process compiles more than four instances.
#ifdef SCAN_PASS
#define SCAN_PASS_LIB true
#else
#define SCAN_PASS_LIB false
#endif

#define SCAN_MAX_FIT 8
#define SCAN_MAX_RTC 16
#define SCAN_MAX_KEYS 16
#define SCAN_MAX_SOFT 4

// K2 assign_scan (and K5, K6): dims, feature offsets and the static
// KernelConfig
struct ScanParams {
    int P, Nb, R, K, S, F, MC, L;
    int Ta;  // IPA term columns (0 when inter-pod affinity is off)
    int D;   // words per slot table (a slot's key varies): max(1, max topo_dk)
    int G;   // signature rows (0: the non-dedup tier)
    int CT;  // spread slots per signature table row: max(1, n_soft)
    int cursor0;      // the tie cursor's start when no device cursor is given
    int frame_shift;  // subtracted from the start cursor (host or device)
    int xwave;        // seed the signature table from the previous wave's
    int G_prev;       // ... table of G_prev rows (cross-wave reuse)
    int f_req, f_nz_req, f_soft_active, f_soft_key, f_soft_sel, f_hard_active,
        f_hard_key, f_hard_sel, f_hard_skew, f_hard_self, f_sig_match, f_active,
        f_ipa_match, f_ipa_anti_add, f_ipa_pref_add, f_ipa_aff_t, f_ipa_aff_self,
        f_ipa_anti_t, f_ipa_pref_t, f_ipa_pref_w;
    int strategy;  // 0 LeastAllocated, 1 MostAllocated, 2 RequestedToCapacityRatio
    int n_fit;
    int fit_col[SCAN_MAX_FIT];
    int fit_w[SCAN_MAX_FIT];
    int n_rtc;
    int rtc_x[SCAN_MAX_RTC];
    int rtc_y[SCAN_MAX_RTC];
    int bal_a, bal_b;
    int w_fit, w_bal, w_pts, w_ipa, w_img, w_taint, w_aff;
    // traced slot counts (min(max_constraints, cfg.n_*), term slot caps)
    int n_hard, n_soft, n_ipa_aff, n_ipa_anti, n_ipa_pref;
    int ipa_active;   // the IPA planes ride the carry, filters and score on
    int ex_anti;      // existing (or this wave's) pods carry anti-affinity terms
    int ex_pref;      // the InterPodAffinity score is computed at all
    int ex_pref_add;  // ... and adds the existing pods' preferred terms
    int dom_carry;    // hard slots and a non-singleton key: carry dom_counts
    int topo_dk[SCAN_MAX_KEYS];
    // the tables kept per key slot (the existing pods' anti-affinity and
    // preferred terms, the hard-spread presence bits) hold key k's dk words
    // at topo_off[k]: topo_words = sum of topo_dk in all
    int topo_off[SCAN_MAX_KEYS];
    int topo_words;
    int walk;  // K5: the most mask nodes one block walks (0: its whole range)
    int gtab;  // the domain tables live in a device-memory scratch (the
               // instance for tables past shared memory: scan_plan)
    int passes;  // 0: one pass, the position words in shared memory; n >= 1:
                 // the pass instance, n passes of SCAN_MAX_SLOTS positions a
                 // block with the position words in a device-memory scratch
};

// K4 fit_and_score: dims, feature offsets, the static KernelConfig and the
// traced slot counts (already capped by the feature widths)
struct FitParams {
    int P, Nb, R, K, S, T, Tp, W, I, Ta, A, G, F;
    int MC;  // spread constraint slots per pod (feature width)
    int NF;  // fails rows: 6 + 2 * MC + 3
    int D;   // words per slot table: max(1, max topo_dk)
    int f_req, f_nz_req, f_name_idx, f_tol_unsched, f_aff_pin, f_tol,
        f_tol_prefer, f_aff_sig, f_ports, f_has_ports, f_hard_active,
        f_hard_key, f_hard_sel, f_hard_skew, f_hard_self, f_soft_active,
        f_soft_key, f_soft_sel, f_img_idx, f_num_containers, f_ipa_match,
        f_ipa_aff_t, f_ipa_aff_self, f_ipa_anti_t, f_ipa_pref_t, f_ipa_pref_w;
    int strategy;  // 0 LeastAllocated, 1 MostAllocated, 2 RequestedToCapacityRatio
    int n_fit;
    int fit_col[SCAN_MAX_FIT];
    int fit_w[SCAN_MAX_FIT];
    int n_rtc;
    int rtc_x[SCAN_MAX_RTC];
    int rtc_y[SCAN_MAX_RTC];
    int bal_a, bal_b;
    int w_fit, w_bal, w_taint, w_aff, w_pts, w_ipa, w_img;
    int n_hard, n_soft, n_ipa_aff, n_ipa_anti, n_ipa_pref;
    int ex_anti;      // existing pods carry required anti-affinity terms
    int ex_pref;      // the InterPodAffinity score is computed at all
    int ex_pref_add;  // ... and adds the existing pods' preferred terms
    int topo_dk[SCAN_MAX_KEYS];
    int topo_off[SCAN_MAX_KEYS];  // as ScanParams: key k's per-key tables
    int topo_words;
    int cluster;  // blocks per pod: one thread-block cluster of 1, 2, 4, 8 or 16
    int gtab;     // the domain tables live in a device-memory scratch, one set
                  // per pod (fit_gtab in ops/kernels.py)
};

// The launch tables past the parameter block. ScanParams and FitParams
// hold the first SCAN_MAX_FIT scored resources, SCAN_MAX_RTC shape points
// and SCAN_MAX_KEYS key slots by value, so a configuration within them
// launches with the same parameter bytes as ever. A configuration past any
// of them also passes the whole of its tables in one small int32 device
// tensor (the wrapper's, uploaded once per KernelConfig: launch_tables in
// ops/kernels.py): fit_col [n_fit], fit_w [n_fit], rtc_x [n_rtc], rtc_y
// [n_rtc], topo_dk [K], topo_off [K], launch_table_words(p) words; nullptr
// within them. Each block stages them at the start of its dynamic shared
// memory (stage_launch_tables: the kernels' layouts start after them,
// scan_smem and fit_smem count them), so no device pointer stays live in
// the kernels. Every entry is read through these accessors: below the cap
// from the parameter block, past it from the staged copy (a branch on the
// index alone, uniform over the grid).
template <typename P>
__host__ __device__ inline int launch_table_words(const P& p) {
    return p.n_fit > SCAN_MAX_FIT || p.n_rtc > SCAN_MAX_RTC || p.K > SCAN_MAX_KEYS
               ? 2 * (p.n_fit + p.n_rtc + p.K)
               : 0;
}

// the kernels' dynamic shared memory (every extern __shared__ array starts
// at the same address): the staged launch tables at its start
extern __shared__ int dyn_smem[];

// copy the launch tables (n words) to the start of dynamic shared memory;
// the caller's next block barrier publishes them
__device__ __forceinline__ void stage_launch_tables(const int* lt, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dyn_smem[i] = lt[i];
}

template <typename P>
__device__ __forceinline__ int fit_col_at(const P& p, int i) {
    return i < SCAN_MAX_FIT ? p.fit_col[i] : dyn_smem[i];
}
template <typename P>
__device__ __forceinline__ int fit_w_at(const P& p, int i) {
    return i < SCAN_MAX_FIT ? p.fit_w[i] : dyn_smem[p.n_fit + i];
}
template <typename P>
__device__ __forceinline__ int rtc_x_at(const P& p, int i) {
    return i < SCAN_MAX_RTC ? p.rtc_x[i] : dyn_smem[2 * p.n_fit + i];
}
template <typename P>
__device__ __forceinline__ int rtc_y_at(const P& p, int i) {
    return i < SCAN_MAX_RTC ? p.rtc_y[i] : dyn_smem[2 * p.n_fit + p.n_rtc + i];
}
template <typename P>
__device__ __forceinline__ int topo_dk_at(const P& p, int k) {
    return k < SCAN_MAX_KEYS ? p.topo_dk[k] : dyn_smem[2 * (p.n_fit + p.n_rtc) + k];
}
template <typename P>
__device__ __forceinline__ int topo_off_at(const P& p, int k) {
    return k < SCAN_MAX_KEYS ? p.topo_off[k]
                             : dyn_smem[2 * (p.n_fit + p.n_rtc) + p.K + k];
}

// words of a matched-key mask over K key slots: one bit a slot. Up to 32
// slots the mask is one word, kept where it always was (a register, one
// shared int); past them the kernels keep key_words(K) words in dynamic
// shared memory (scan_smem's and fit_smem's `keys`).
__host__ __device__ inline int key_words(int K) { return (K + 31) / 32; }

#define SCATTER_MAX_PLANES 16

// K3 scatter_rows: one entry per plane, and the copy plan of
// kubernetes_tpu_torch/ops/kernels.py scatter_plan (an even number of ints
// before the pointers, so the pointers are 8-byte aligned on both sides)
struct ScatterParams {
    int n_planes, n_rows;
    int n_threads;  // the flat thread space: n_planes << part_log
    int block;      // threads per block
    int part_log;   // log2 of each plane's part (a warp or more)
    int lane_log;   // log2 of the lanes per dirty row
    int row_bytes[SCATTER_MAX_PLANES];
    int dst_rows[SCATTER_MAX_PLANES];
    int width[SCATTER_MAX_PLANES];  // bytes per copy: 16, 8, 4 or 1
    int units[SCATTER_MAX_PLANES];  // copies per row: row_bytes / width
    long long dst[SCATTER_MAX_PLANES];
    long long src[SCATTER_MAX_PLANES];
};

// A kernel that does nothing, launched with a kernel's grid and block
// shape: the launch floor that kernel's time stands on (every library has
// it, as it has kernel_error_string)
__global__ void empty_kernel() {}

extern "C" int launch_empty(int gx, int gy, int threads, void* stream) {
    empty_kernel<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
