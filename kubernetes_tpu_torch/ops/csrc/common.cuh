// Shared helpers and parameter blocks for the port's kernels.
//
// Every struct here has a ctypes twin in kubernetes_tpu_torch/ops/cuda.py
// with the same field order; all scalars are int32 and all arrays fixed
// size, so the two layouts agree without padding rules.
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

#define SCAN_MAX_FIT 8
#define SCAN_MAX_RTC 16
#define SCAN_MAX_KEYS 16
#define SCAN_MAX_SOFT 4

// K2 assign_scan: dims, feature offsets and the static KernelConfig
struct ScanParams {
    int P, Nb, R, K, S, F, MC, L;
    int Ta;  // IPA term columns (0 when inter-pod affinity is off)
    int D;   // words per domain table: max(1, max topo_dk)
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
};

// K4 fit_and_score: dims, feature offsets, the static KernelConfig and the
// traced slot counts (already capped by the feature widths)
struct FitParams {
    int P, Nb, R, K, S, T, Tp, W, I, Ta, A, G, F;
    int MC;  // spread constraint slots per pod (feature width)
    int NF;  // fails rows: 6 + 2 * MC + 3
    int D;   // shared-memory words per domain table: max(1, max topo_dk)
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
    int cluster;  // blocks per pod: one thread-block cluster of 1, 2, 4, 8 or 16
};

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
