"""ctypes bindings for the native host-side runtime (native/slam_native.cpp):
kd-tree NN queries and greedy chessboard growth — the framework components
that genuinely belong in C++ (pointer-chasing, branchy, host-side; the
reference uses PCL kd-tree, st10 detector.cpp:458-467, and sequential C++
growth, detector.cpp:602-824).

The library auto-builds on first use (`make -C native`); a pure-Python
fallback keeps everything working when no toolchain is available.
"""

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libslam_native.so")
_SOURCES = ("slam_native.cpp", "schur_baseline.cpp", "Makefile")
_lib = None
_build_failed = False


def _stale():
    """True when the library is missing or older than a source it is built
    from (Makefile included), so a copied checkout never loads a binary
    built from other sources or flags."""
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > built
               for f in _SOURCES)


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if _stale():
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _build_failed = True
        return None
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                 ctypes.c_int]
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_knn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_float)]
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.schur_ba_solve.restype = ctypes.c_int
    lib.schur_ba_solve.argtypes = [
        c_dp, c_dp, c_dp,                               # R0, t0, pts0
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        c_dp, c_dp,                                     # uv, w
        ctypes.POINTER(ctypes.c_uint8),                 # fixed
        ctypes.c_int, ctypes.c_int, ctypes.c_int,       # C, L, N
        ctypes.c_int, ctypes.c_double,                  # max_iters, lambda
        c_dp, c_dp, c_dp, c_dp, c_dp]                   # outputs
    lib.grow_chessboards.restype = ctypes.c_int
    lib.grow_chessboards.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available():
    return _load() is not None


class KDTree:
    """Native kd-tree (2D/3D). Falls back to scipy.spatial.cKDTree."""

    def __init__(self, pts):
        pts = np.ascontiguousarray(np.asarray(pts, np.float32))
        self._n, self._dim = pts.shape
        lib = _load()
        if lib is None:
            from scipy.spatial import cKDTree
            self._fallback = cKDTree(pts)
            self._h = None
        else:
            self._fallback = None
            self._pts = pts  # keep alive
            self._lib = lib
            self._h = lib.kdtree_build(
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._n, self._dim)

    def query(self, q, k=1):
        """q (m,dim) -> (indices (m,k), sq_distances (m,k))."""
        q = np.ascontiguousarray(np.asarray(q, np.float32))
        m = q.shape[0]
        if self._h is None:
            d, i = self._fallback.query(q, k=k)
            d = np.atleast_2d(d.astype(np.float32) ** 2).reshape(m, k)
            i = np.atleast_2d(i.astype(np.int32)).reshape(m, k)
            return i, d
        idx = np.empty((m, k), np.int32)
        d2 = np.empty((m, k), np.float32)
        self._lib.kdtree_knn(self._h,
                             q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             m, k,
                             idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                             d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return idx, d2

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            try:
                self._lib.kdtree_free(self._h)
            except Exception:
                pass


def schur_ba_solve_native(R0, t0, pts0, cam_idx, lm_idx, uv, w, fixed,
                          max_iters=20, lambda_init=1e-4):
    """Single-core C++ sparse-Schur LM bundle adjustment — the honest
    Ceres-SPARSE_SCHUR-class CPU baseline (native/schur_baseline.cpp; the
    algorithm of st20-g2o/src/include/test_ceres.h:143-145 with the analytic
    Jacobians of st17-ceres/src/include/solver.hpp:341-385).

    Returns dict with R, t, pts, cost, iters, wall_ms (pure solve time,
    excluding array marshalling). Raises RuntimeError when the native
    library is unavailable (this baseline has no Python fallback — a slow
    fallback would defeat its purpose as a timing denominator)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable; cannot time the "
                           "C++ Schur baseline")
    R0 = np.ascontiguousarray(np.asarray(R0, np.float64)).reshape(-1, 9)
    t0 = np.ascontiguousarray(np.asarray(t0, np.float64))
    pts0 = np.ascontiguousarray(np.asarray(pts0, np.float64))
    cam_idx = np.ascontiguousarray(np.asarray(cam_idx, np.int32))
    lm_idx = np.ascontiguousarray(np.asarray(lm_idx, np.int32))
    uv = np.ascontiguousarray(np.asarray(uv, np.float64))
    w = np.ascontiguousarray(np.asarray(w, np.float64))
    fixed = np.ascontiguousarray(np.asarray(fixed, np.uint8))
    C, L, N = R0.shape[0], pts0.shape[0], cam_idx.shape[0]
    out_R = np.empty((C, 9), np.float64)
    out_t = np.empty((C, 3), np.float64)
    out_pts = np.empty((L, 3), np.float64)
    out_cost = np.empty(1, np.float64)
    out_ms = np.empty(1, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    iters = lib.schur_ba_solve(
        R0.ctypes.data_as(dp), t0.ctypes.data_as(dp), pts0.ctypes.data_as(dp),
        cam_idx.ctypes.data_as(ip), lm_idx.ctypes.data_as(ip),
        uv.ctypes.data_as(dp), w.ctypes.data_as(dp),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        C, L, N, max_iters, lambda_init,
        out_R.ctypes.data_as(dp), out_t.ctypes.data_as(dp),
        out_pts.ctypes.data_as(dp), out_cost.ctypes.data_as(dp),
        out_ms.ctypes.data_as(dp))
    return {"R": out_R.reshape(C, 3, 3), "t": out_t, "pts": out_pts,
            "cost": float(out_cost[0]), "iters": int(iters),
            "wall_ms": float(out_ms[0])}


def grow_chessboards_native(xy, scores, dist_factor=1.6, cos_thresh=0.85,
                            max_boards=4, max_cells=32):
    """Native greedy chessboard growth; returns list of (rows, cols) index
    grids. Falls back to the Python implementation in frontend.chessboard."""
    lib = _load()
    xy = np.ascontiguousarray(np.asarray(xy, np.float32))
    scores = np.ascontiguousarray(np.asarray(scores, np.float32))
    if lib is None:
        from slam_tricks_tpu.frontend.chessboard import grow_chessboards
        return grow_chessboards(xy, None, scores, max_boards=max_boards,
                                dist_factor=dist_factor)
    n = xy.shape[0]
    out_grid = np.empty(max_boards * max_cells * max_cells, np.int32)
    out_shape = np.empty(2 * max_boards, np.int32)
    nb = lib.grow_chessboards(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dist_factor, cos_thresh, max_boards, max_cells,
        out_grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    boards = []
    off = 0
    for b in range(nb):
        r, c = int(out_shape[2 * b]), int(out_shape[2 * b + 1])
        boards.append(out_grid[off:off + r * c].reshape(r, c).copy())
        off += r * c
    return boards
