"""Build, load and launch the port's CUDA kernels.

Each kernel in csrc/ is compiled by nvcc into its own shared library with a
plain C interface (no PyTorch headers: seconds, not minutes) and loaded with
ctypes. The build happens at first use, from the sources in this checkout
only, into `_build/` beside this file (listed in .gitignore); a library is
named by a hash of its source, every shared header in csrc/ and the flags,
so an edited source or header rebuilds. build_all() starts one nvcc per
source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# library name -> source file; the sources include the shared headers
# (csrc/*.cuh). A library exports launch_<kernel> for its kernels: each
# its own, and fit_and_score also K7's launch_wave_fit_and_score
SOURCES = {
    "static_parts": "static_parts.cu",
    "assign_scan": "assign_scan.cu",
    "scatter_rows": "scatter_rows.cu",
    "fit_and_score": "fit_and_score.cu",
    "gang_assign": "gang_assign.cu",
    "sharded_assign": "sharded_assign.cu",
}

# a launcher's own code (beside CUDA's error codes): K6's cluster of n
# blocks, or K4's and K7's cluster of one pod, cannot be resident at once on
# this card
CLUSTER_DOES_NOT_FIT = -2

# -fmad=false: no a*b+c contraction (the float32 lines must round per op as
# numpy and XLA do); -prec-div/-prec-sqrt spell out the IEEE defaults, and
# --use_fast_math is never passed
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    """The library's path, named by a hash of its source, every header in
    csrc/ (any source may include any of them) and the flags."""
    h = hashlib.sha256()
    for part in [csrc / SOURCES[name]] + sorted(csrc.glob("*.cuh")):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every kernel library that is missing, all nvcc processes at
    once; returns {name: ptxas report} for the ones built now. Raises with
    the compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def launch(name: str, params: ctypes.Structure, ptrs: list[int], stream: int,
           lib: str | None = None) -> None:
    """Call launch_<name>(&params, ptrs, stream) of library `lib` (default:
    the library of the same name); raise on a refused launch."""
    dll = load(lib or name)
    fn = getattr(dll, f"launch_{name}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    arr = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    code = fn(ctypes.addressof(params), ctypes.addressof(arr), stream)
    if code == CLUSTER_DOES_NOT_FIT:
        n = getattr(params, "n_shards", None) or getattr(params, "cluster", "?")
        raise RuntimeError(f"{name}: a cluster of {n} blocks cannot be resident on this "
                           "card (cudaOccupancyMaxActiveClusters is 0)")
    if code != 0:
        msg = dll.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def launch_floor(counts: list[int], npt: int, n_blocks: int, out_ptr: int,
                 stream: int) -> None:
    """launch_scan_floor of the assign_scan library (csrc/assign_scan.cu):
    the latency floor of a scan's counted synchronisations."""
    dll = load("assign_scan")
    fn = dll.launch_scan_floor
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    arr = (ctypes.c_int * 5)(*counts)
    code = fn(ctypes.addressof(arr), npt, n_blocks, out_ptr, stream)
    if code != 0:
        msg = dll.kernel_error_string(code).decode()
        raise RuntimeError(f"scan_floor launch failed: CUDA error {code} ({msg})")


def launch_empty(lib: str, grid: tuple[int, int], threads: int, stream: int) -> None:
    """launch_empty of library `lib` (csrc/common.cuh): a kernel that does
    nothing, on a kernel's grid and block shape — the launch floor beside
    that kernel's time (a measurement yardstick that no path runs)."""
    dll = load(lib)
    fn = dll.launch_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(grid[0], grid[1], threads, stream)
    if code != 0:
        msg = dll.kernel_error_string(code).decode()
        raise RuntimeError(f"empty kernel launch failed: CUDA error {code} ({msg})")


def launch_store_floor(n_rows: int, nb: int, ptrs: list[int], stream: int) -> None:
    """launch_static_store_floor of the static_parts library
    (csrc/static_parts.cu): K1's output bytes written in K1's layout with
    nothing read — the practical byte bound beside K1."""
    dll = load("static_parts")
    fn = dll.launch_static_store_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    code = fn(n_rows, nb, ctypes.addressof(arr), stream)
    if code != 0:
        msg = dll.kernel_error_string(code).decode()
        raise RuntimeError(f"static_store_floor launch failed: CUDA error {code} ({msg})")


def launch_fit_floor(counts: list[int], n_pods: int, cluster: int, threads: int,
                     cluster_policy: bool, out_ptr: int, stream: int) -> None:
    """launch_fit_floor of the fit_and_score library (csrc/fit_and_score.cu):
    the latency floor of a K4 or K7 launch's counted synchronisations."""
    dll = load("fit_and_score")
    fn = dll.launch_fit_floor
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    arr = (ctypes.c_int * len(counts))(*counts)
    code = fn(ctypes.addressof(arr), n_pods, cluster, threads, int(cluster_policy), out_ptr,
              stream)
    if code == CLUSTER_DOES_NOT_FIT:
        raise RuntimeError(f"fit_floor: a cluster of {cluster} blocks cannot be resident "
                           "on this card (cudaOccupancyMaxActiveClusters is 0)")
    if code != 0:
        msg = dll.kernel_error_string(code).decode()
        raise RuntimeError(f"fit_floor launch failed: CUDA error {code} ({msg})")


# ctypes twins of the structs in csrc/common.cuh (same field order)

MAX_FIT, MAX_RTC, MAX_KEYS = 8, 16, 16
MAX_PLANES = 16


def _ints(*names):
    return [(n, ctypes.c_int) for n in names]


class StaticParams(ctypes.Structure):
    _fields_ = _ints("P", "P_feats", "Nb", "T", "Tp", "W", "I", "A", "G", "F",
                     "f_tol_unsched", "f_name_idx", "f_aff_pin", "f_tol",
                     "f_aff_sig", "f_ports", "f_has_ports", "f_tol_prefer",
                     "f_img_idx", "f_num_containers", "threads", "chunk", "mw", "rec",
                     "tab", "pitch_t", "pitch_tp", "pitch_w", "vec")


class ScanParams(ctypes.Structure):
    _fields_ = _ints("P", "Nb", "R", "K", "S", "F", "MC", "L", "Ta", "D", "G",
                     "CT", "cursor0", "frame_shift", "xwave", "G_prev",
                     "f_req", "f_nz_req", "f_soft_active", "f_soft_key",
                     "f_soft_sel", "f_hard_active", "f_hard_key", "f_hard_sel",
                     "f_hard_skew", "f_hard_self", "f_sig_match", "f_active",
                     "f_ipa_match", "f_ipa_anti_add", "f_ipa_pref_add",
                     "f_ipa_aff_t", "f_ipa_aff_self", "f_ipa_anti_t",
                     "f_ipa_pref_t", "f_ipa_pref_w", "strategy", "n_fit") + [
        ("fit_col", ctypes.c_int * MAX_FIT),
        ("fit_w", ctypes.c_int * MAX_FIT),
        ("n_rtc", ctypes.c_int),
        ("rtc_x", ctypes.c_int * MAX_RTC),
        ("rtc_y", ctypes.c_int * MAX_RTC),
    ] + _ints("bal_a", "bal_b", "w_fit", "w_bal", "w_pts", "w_ipa", "w_img",
              "w_taint", "w_aff", "n_hard", "n_soft", "n_ipa_aff", "n_ipa_anti",
              "n_ipa_pref", "ipa_active", "ex_anti", "ex_pref", "ex_pref_add",
              "dom_carry") + [
        ("topo_dk", ctypes.c_int * MAX_KEYS),
    ]


class GangParams(ctypes.Structure):
    _fields_ = [("scan", ScanParams)] + _ints("rows", "n_constrained", "has_fallback")


class ShardParams(ctypes.Structure):
    _fields_ = [("scan", ScanParams)] + _ints("n_shards")


class FitParams(ctypes.Structure):
    _fields_ = _ints(
        "P", "Nb", "R", "K", "S", "T", "Tp", "W", "I", "Ta", "A", "G", "F",
        "MC", "NF", "D",
        "f_req", "f_nz_req", "f_name_idx", "f_tol_unsched", "f_aff_pin",
        "f_tol", "f_tol_prefer", "f_aff_sig", "f_ports", "f_has_ports",
        "f_hard_active", "f_hard_key", "f_hard_sel", "f_hard_skew",
        "f_hard_self", "f_soft_active", "f_soft_key", "f_soft_sel",
        "f_img_idx", "f_num_containers", "f_ipa_match", "f_ipa_aff_t",
        "f_ipa_aff_self", "f_ipa_anti_t", "f_ipa_pref_t", "f_ipa_pref_w",
        "strategy", "n_fit") + [
        ("fit_col", ctypes.c_int * MAX_FIT),
        ("fit_w", ctypes.c_int * MAX_FIT),
        ("n_rtc", ctypes.c_int),
        ("rtc_x", ctypes.c_int * MAX_RTC),
        ("rtc_y", ctypes.c_int * MAX_RTC),
    ] + _ints("bal_a", "bal_b", "w_fit", "w_bal", "w_taint", "w_aff", "w_pts",
              "w_ipa", "w_img", "n_hard", "n_soft", "n_ipa_aff", "n_ipa_anti",
              "n_ipa_pref", "ex_anti", "ex_pref", "ex_pref_add") + [
        ("topo_dk", ctypes.c_int * MAX_KEYS),
        ("cluster", ctypes.c_int),
    ]


class ScatterParams(ctypes.Structure):
    _fields_ = _ints("n_planes", "n_rows", "n_threads", "block", "part_log", "lane_log") + [
        ("row_bytes", ctypes.c_int * MAX_PLANES),
        ("dst_rows", ctypes.c_int * MAX_PLANES),
        ("width", ctypes.c_int * MAX_PLANES),
        ("units", ctypes.c_int * MAX_PLANES),
        ("dst", ctypes.c_longlong * MAX_PLANES),
        ("src", ctypes.c_longlong * MAX_PLANES),
    ]
