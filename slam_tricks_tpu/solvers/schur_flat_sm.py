"""Slot-major flat Schur BA — the headline path.

Mathematically identical to solvers/schur_flat.solve_ba_flat (same damping,
gauge, Nielsen control — parity-tested), laid out so that no per-observation
quantity is stored with a small trailing dimension ((N,18), (N,28),
(L,K,18) stacks pad that dimension in device tiles). Design rules here:

  1. SLOT-MAJOR grid: observation row n = k*L + l (slot k of landmark l).
     Every per-observation quantity lives as (rows, K, L) with the minor
     dimension = L, never as (N, small).
  2. Landmark-side reductions are sums over axis -2 (the K slots) — plain
     elementwise work, no gathers. Landmark->observation broadcasts are free.
  3. Every camera-indexed operation is ONE matmul against a bf16 one-hot
     ((rows,N') x (N',C) or (rows,C) x (C,N')): camera-value fetch,
     camera-side reduction, rhs reduction, and back-substitution gather.
     bf16 one-hots are exact (entries 0/1) and halve the one-hot bytes; the
     value side keeps f32 precision via per-operand HIGHEST (_MIXED).
  4. The Schur core keeps schur_flat's pieces: per-landmark whitening in
     flat columns, batched one-hot B build, one (3L,6C)^T(3L,6C) matmul for
     S, XLA Cholesky of the reduced camera system (cuSOLVER on a GPU).

Replaces the role of Ceres SPARSE_SCHUR / g2o BlockSolver<6,3> with
marginalized landmarks (st20-g2o/src/include/test_ceres.h:143-145,
test_g2o.h:94-135); Jacobian columns are the hand derivation of
st17-ceres/src/include/solver.hpp:176-199 unrolled to flat arrays.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tricks_tpu.manifolds import se3, so3
from slam_tricks_tpu.solvers.common import HIGHEST
from slam_tricks_tpu.solvers.schur import BAState, build_track_table, lm_accept

_IJ6 = [(i, j) for i in range(6) for j in range(i, 6)]     # 21 entries
_IJ3 = [(i, j) for i in range(3) for j in range(i, 3)]     # 6 entries

# mixed-precision pair: exact bf16 one-hot x f32 values at HIGHEST. The
# contraction's precision is the higher of the pair, so the f32 side never
# falls to TF32/bf16 (checked against f64 in tests/test_schur_flat_sm.py and
# on the GPU by chip_smoke.py's linearize+assemble check).
_MIXED = (jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT)
_MIXED_R = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST)


class SlotWork(NamedTuple):
    """Static per-problem structure, slot-major. All (K, L) or derived."""
    uv0: jnp.ndarray        # (K, L) measured u
    uv1: jnp.ndarray        # (K, L) measured v
    w: jnp.ndarray          # (K, L) weights (0 = padding slot)
    mask: jnp.ndarray       # (K, L) 1/0
    oh: jnp.ndarray         # (K*L, C) bf16 one-hot, or None (large C: the
                            # standing one-hot would be O(N*C) bytes)
    cam_of_slot: jnp.ndarray  # (K, L) int32
    cam_table: jnp.ndarray  # (C, Kc) int32 flat slot-major obs per camera,
                            # or None (small C)
    cam_mask: jnp.ndarray   # (C, Kc) or None

    # C/L are NOT stored as int fields: ints in a NamedTuple pytree become
    # traced leaves under jit and poison static shape computations
    @property
    def n_cams(self):
        return (self.oh.shape[1] if self.oh is not None
                else self.cam_table.shape[0])

    @property
    def n_points(self):
        return self.mask.shape[1]


def build_slot_work(obs, n_cams, n_points, dtype=np.float32,
                    use_onehot=None):
    """Host-side: slot-major grid from arbitrary observations. Slots of
    landmark l are its observations in input order; padding slots carry
    weight 0 and camera 0.

    use_onehot: True -> materialize the (N', C) bf16 one-hot (every camera
    op is one matmul; best for C up to a few hundred). False -> carry a
    (C, Kc) camera gather table instead (large C: the one-hot would be
    O(N*C) bytes — 6.7 GB at the C=1024 cube-room scale). None -> auto
    (C <= 128)."""
    cam_np = np.asarray(obs.cam_idx)
    w_np = np.asarray(obs.weight).astype(np.float64)
    uv_np = np.asarray(obs.uv)
    L = n_points
    table = build_track_table(obs.cam_idx, obs.lm_idx, obs.weight,
                              n_points=L, dtype=dtype)
    idx = np.asarray(table.obs_idx)          # (L, K)
    msk = np.asarray(table.mask) > 0
    K = idx.shape[1]

    def slotm(a, fill=0):
        out = np.full((L, K) + a.shape[1:], fill, a.dtype)
        out[msk] = a[idx[msk]]
        return np.ascontiguousarray(np.moveaxis(out, 1, 0))   # (K, L, ...)

    cam_sm = slotm(cam_np.astype(np.int32))
    uv_sm = slotm(uv_np.astype(dtype))
    w_sm = slotm(w_np.astype(dtype))
    if use_onehot is None:
        use_onehot = n_cams <= 128
    oh = cam_table = cam_mask = None
    if use_onehot:
        oh = jnp.asarray(
            (cam_sm.reshape(K * L, 1)
             == np.arange(n_cams, dtype=np.int32)[None, :])
            .astype(jnp.bfloat16))
    else:
        # flat slot-major index n = k*L + l of each camera's observations
        mask_sm = np.moveaxis(msk, 0, 1)                  # (K, L)
        kk, ll = np.nonzero(mask_sm)
        flat = (kk * L + ll).astype(np.int64)
        cams = cam_sm[kk, ll]
        order = np.argsort(cams, kind="stable")
        cams_s, flat_s = cams[order], flat[order]
        counts = np.bincount(cams_s, minlength=n_cams)
        Kc = int(counts.max()) if counts.size else 1
        Kc = Kc + (-Kc) % 8
        cam_table = np.zeros((n_cams, Kc), np.int32)
        cam_mask = np.zeros((n_cams, Kc), dtype)
        starts = np.zeros(n_cams + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(flat_s.shape[0]) - starts[cams_s]
        cam_table[cams_s, slot] = flat_s
        cam_mask[cams_s, slot] = 1
        cam_table = jnp.asarray(cam_table)
        cam_mask = jnp.asarray(cam_mask)
    return SlotWork(
        uv0=jnp.asarray(uv_sm[..., 0]), uv1=jnp.asarray(uv_sm[..., 1]),
        w=jnp.asarray(w_sm), mask=jnp.asarray(msk.T.astype(dtype)),
        oh=oh, cam_of_slot=jnp.asarray(cam_sm),
        cam_table=cam_table, cam_mask=cam_mask)


def _fetch_cam_vals(vals_c, work: SlotWork, K, L):
    """vals_c (C, m) camera columns -> m arrays (K, L) per slot. Small C:
    ONE bf16 one-hot matmul. Large C: an (m, K, L) take (the one-hot would
    be O(N*C) bytes)."""
    m = vals_c.shape[1]
    if work.oh is not None:
        out = jax.lax.dot_general(vals_c.T, work.oh.T,
                                  (((1,), (0,)), ((), ())),
                                  precision=_MIXED,
                                  preferred_element_type=vals_c.dtype)
        out = out.reshape(m, K, L)
    else:
        out = jnp.take(vals_c.T, work.cam_of_slot, axis=1)     # (m, K, L)
    return [out[i] for i in range(m)]


def _ohr_device(work: SlotWork):
    """(K, L, C) bf16 one-hot of the slot cameras, built ON DEVICE from the
    static index structure. Used by both the large-C camera reduction and
    the B build with the IDENTICAL expression, so XLA CSEs them into one
    buffer and hoists it out of the LM while-loop (built once per solve)."""
    C = work.n_cams
    return (jax.nn.one_hot(work.cam_of_slot, C, dtype=jnp.bfloat16)
            * work.mask[..., None].astype(jnp.bfloat16))


def _cam_reduce(cols, work: SlotWork, dtype):
    """cols: list of (K, L) arrays -> (n_cols, C) per-camera sums. Small C:
    ONE (n,N') x (N',C) matmul with the standing bf16 one-hot. Large C: ONE
    dot_general against the device-built (K,L,C) one-hot, contracting both
    slot axes (reads the big stack sequentially instead of gathering random
    rows through a (C,Kc) table)."""
    n = len(cols)
    KL = cols[0].size
    if work.oh is not None:
        stack = jnp.stack([c.reshape(KL) for c in cols], axis=0)  # (n, N')
        return jax.lax.dot_general(stack, work.oh,
                                   (((1,), (0,)), ((), ())),
                                   precision=_MIXED,
                                   preferred_element_type=dtype)   # (n, C)
    stack = jnp.stack(cols, axis=0)                           # (n, K, L)
    return jax.lax.dot_general(stack, _ohr_device(work),
                               (((1, 2), (0, 1)), ((), ())),
                               precision=_MIXED,
                               preferred_element_type=dtype)       # (n, C)


def _linearize_sm(R_flat, t, points, work: SlotWork, loss=None):
    """Slot-major linearization: residual rows, pose/point Jacobian columns,
    cost column — all (K, L)."""
    K, L = work.mask.shape
    rc = _fetch_cam_vals(jnp.concatenate([R_flat, t], axis=1), work, K, L)
    r_, tn = rc[:9], rc[9:]
    px, py, pz = points[:, 0][None], points[:, 1][None], points[:, 2][None]
    x = r_[0] * px + r_[1] * py + r_[2] * pz + tn[0]
    y = r_[3] * px + r_[4] * py + r_[5] * pz + tn[1]
    z = r_[6] * px + r_[7] * py + r_[8] * pz + tn[2]
    z = jnp.where(work.w > 0, z, 1.0)
    iz = 1.0 / z
    u = x * iz
    v = y * iz
    d0 = u - work.uv0
    d1 = v - work.uv1
    if loss is None:
        sw = jnp.sqrt(work.w)
        cost_col = 0.5 * work.w * (d0 * d0 + d1 * d1)
    else:
        sqn = d0 * d0 + d1 * d1
        sw = jnp.sqrt(work.w * loss.weight(sqn))
        cost_col = 0.5 * work.w * loss.rho(sqn)
    r0 = d0 * sw
    r1 = d1 * sw
    sziz = sw * iz
    jl0 = [(r_[j] - u * r_[6 + j]) * sziz for j in range(3)]
    jl1 = [(r_[3 + j] - v * r_[6 + j]) * sziz for j in range(3)]
    jo0 = [jl0[2] * py - jl0[1] * pz,
           jl0[0] * pz - jl0[2] * px,
           jl0[1] * px - jl0[0] * py]
    jo1 = [jl1[2] * py - jl1[1] * pz,
           jl1[0] * pz - jl1[2] * px,
           jl1[1] * px - jl1[0] * py]
    zero = jnp.zeros_like(x)
    jp0 = jo0 + [sziz, zero, -u * sziz]
    jp1 = jo1 + [zero, sziz, -v * sziz]
    return (r0, r1), (jp0, jp1), (jl0, jl1), cost_col


def _dot2(a0, a1, b0, b1):
    return a0 * b0 + a1 * b1


def _quantities_sm(poses, points, work: SlotWork, loss=None, psum_axis=None):
    """Linearize + assemble: Hpp (C,21 cols), gp (C,6), Hll (6 x (L,)),
    gl (3 x (L,)), W (18, K, L), cost."""
    C, L = work.n_cams, work.n_points
    dtype = points.dtype
    R_flat = poses.R.reshape(C, 9)
    (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_sm(
        R_flat, poses.t, points, work, loss=loss)

    cols = [_dot2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
    cols += [_dot2(jp0[i], jp1[i], r0, r1) for i in range(6)]
    cols += [cost_col]
    cam_red = _cam_reduce(cols, work, dtype)               # (28, C)
    if psum_axis is not None:
        cam_red = jax.lax.psum(cam_red, psum_axis)
    Hpp_flat = cam_red[:21].T                                 # (C, 21)
    gp = cam_red[21:27].T                                     # (C, 6)
    cost = jnp.sum(cam_red[27])

    # landmark-side: plain sums over the K axis (no gathers, no padding)
    Hll_flat = [jnp.sum(_dot2(jl0[i], jl1[i], jl0[j], jl1[j]), axis=0)
                for (i, j) in _IJ3]                           # 6 x (L,)
    gl = [jnp.sum(_dot2(jl0[i], jl1[i], r0, r1), axis=0) for i in range(3)]

    W = jnp.stack([_dot2(jp0[i], jp1[i], jl0[j], jl1[j])
                   for i in range(6) for j in range(3)], axis=0)  # (18,K,L)
    return Hpp_flat, gp, tuple(Hll_flat), tuple(gl), W, cost


def _sym6_expand(flat):
    idx = np.zeros((6, 6), np.int32)
    for k, (i, j) in enumerate(_IJ6):
        idx[i, j] = k
        idx[j, i] = k
    return flat[..., idx.reshape(-1)].reshape(flat.shape[:-1] + (6, 6))


def _inv3x3_flat(h):
    a, b, c, d, e, f = h
    A = d * f - e * e
    B = c * e - b * f
    Cc = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * Cc
    idet = 1.0 / det
    return [A * idet, B * idet, Cc * idet, D * idet, E * idet, F * idet]


def _chol3_flat(h):
    a, b, c, d, e, f = h
    l00 = jnp.sqrt(a)
    inv00 = 1.0 / l00
    l10 = b * inv00
    l20 = c * inv00
    l11 = jnp.sqrt(d - l10 * l10)
    inv11 = 1.0 / l11
    l21 = (e - l20 * l10) * inv11
    l22 = jnp.sqrt(f - l20 * l20 - l21 * l21)
    return [l00, l10, l11, l20, l21, l22]


def _solve_sm(Hpp_flat, gp, Hll_flat, gl, W, lam, fixed_mask,
              work: SlotWork):
    """Damped Schur solve from slot-major blocks. Returns (dp (C,6),
    dl (L,3), diag_pp (C,6), diag_ll (L,3))."""
    dtype = gp.dtype
    C, L = work.n_cams, work.n_points
    K = work.mask.shape[0]

    dpp = [jnp.maximum(Hpp_flat[:, k], 1e-12)
           for k, (i, j) in enumerate(_IJ6) if i == j]
    dll = [jnp.maximum(Hll_flat[k], 1e-12)
           for k, (i, j) in enumerate(_IJ3) if i == j]
    Hpp_d = _sym6_expand(Hpp_flat)
    diag_idx = jnp.arange(6)
    Hpp_d = Hpp_d.at[:, diag_idx, diag_idx].add(lam * jnp.stack(dpp, axis=1))
    empty = (Hll_flat[0] + Hll_flat[3] + Hll_flat[5]) <= 0.0
    Hll_d = [jnp.where(empty, 1.0 if k in (0, 3, 5) else 0.0,
                       Hll_flat[k] + (lam * dll[{0: 0, 3: 1, 5: 2}[k]]
                                      if k in (0, 3, 5) else 0.0))
             for k in range(6)]
    Hll_inv = _inv3x3_flat(Hll_d)

    # whiten per slot: X rows of Ld^{-1} W^T, slot-major (18 x (K,L) in one
    # (18,K,L) array; row index = r*6+i for X[r,i])
    lc = _chol3_flat(Hll_d)                        # 6 x (L,) broadcasts
    l00, l10, l11, l20, l21, l22 = [c[None] for c in lc]
    i00, i11, i22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    m = work.mask
    w_of = lambda i, j: W[i * 3 + j] * m
    x0 = [w_of(j, 0) * i00 for j in range(6)]
    x1 = [(w_of(j, 1) - l10 * x0[j]) * i11 for j in range(6)]
    x2 = [(w_of(j, 2) - l20 * x0[j] - l21 * x1[j]) * i22 for j in range(6)]
    X = jnp.stack(x0 + x1 + x2, axis=0)            # (18, K, L), row r*6+i

    # B build: B[(l,r),(c,i)] = sum_k oh[kl,c] X[r*6+i,k,l] — one mixed
    # dot_general contracting the flat slot axis, batched over nothing:
    # (18, N') x (N', C) would sum over l too; we need per-landmark rows,
    # so contract k only: einsum('jkl,klc->ljc') via dot_general with l as
    # a batch dim on both sides.
    if work.oh is not None:
        ohr = work.oh.reshape(K, L, C).transpose(1, 0, 2)      # (L, K, C)
        Bl = jax.lax.dot_general(
            X.transpose(2, 0, 1), ohr,
            (((2,), (1,)), ((0,), (0,))),
            precision=_MIXED, preferred_element_type=dtype)   # (L, 18, C)
    else:
        # large C: the SAME device-built (K,L,C) one-hot as _cam_reduce
        # (CSE -> one buffer, hoisted out of the LM while-loop); batch over
        # l, contract over k
        Bl = jax.lax.dot_general(
            X, _ohr_device(work),
            (((1,), (0,)), ((2,), (1,))),
            precision=_MIXED, preferred_element_type=dtype)   # (L, 18, C)
    B = (Bl.reshape(L, 3, 6, C).transpose(0, 1, 3, 2)
         .reshape(L * 3, C * 6))
    S_off = -jax.lax.dot_general(B, B, (((0,), (0,)), ((), ())),
                                 precision=HIGHEST)        # (6C, 6C)
    S = S_off.reshape(C, 6, C, 6)
    eye_c = jnp.eye(C, dtype=dtype)[:, None, :, None]
    S = S + eye_c * Hpp_d[:, :, None, :]

    # rhs: b = -(gp - W Hll^-1 gl); u broadcast along slots, reduce per cam
    gl_cols = [gl[0], gl[1], gl[2]]
    a_, b_, c_, d_, e_, f_ = Hll_inv
    u0 = a_ * gl_cols[0] + b_ * gl_cols[1] + c_ * gl_cols[2]
    u1 = b_ * gl_cols[0] + d_ * gl_cols[1] + e_ * gl_cols[2]
    u2 = c_ * gl_cols[0] + e_ * gl_cols[1] + f_ * gl_cols[2]
    un = [u0[None] * m, u1[None] * m, u2[None] * m]        # (K, L) x3
    y_cols = [W[i * 3 + 0] * un[0] + W[i * 3 + 1] * un[1]
              + W[i * 3 + 2] * un[2] for i in range(6)]
    y_c = _cam_reduce(y_cols, work, dtype).T            # (C, 6)
    b = -(gp - y_c)

    free = (~fixed_mask).astype(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + eye_c * (fixed_mask.astype(dtype)[:, None, None, None]
                     * jnp.eye(6, dtype=dtype)[None, :, None, :])
    b = b * free[:, None]
    cf = jax.scipy.linalg.cho_factor(S.reshape(C * 6, C * 6), lower=True)
    dp = jax.scipy.linalg.cho_solve(cf, b.reshape(C * 6)).reshape(C, 6)

    # back-substitution: dl = Hll^-1 (-gl - W^T dp); dp fetched per slot by
    # the one-hot matmul (no gather)
    K_, L_ = work.mask.shape
    dpn = _fetch_cam_vals(dp, work, K_, L_)             # 6 x (K, L)
    t_ = [jnp.sum(sum(W[i * 3 + j] * dpn[i] * m for i in range(6)), axis=0)
          for j in range(3)]
    rhs = [-gl_cols[j] - t_[j] for j in range(3)]
    dl0 = a_ * rhs[0] + b_ * rhs[1] + c_ * rhs[2]
    dl1 = b_ * rhs[0] + d_ * rhs[1] + e_ * rhs[2]
    dl2 = c_ * rhs[0] + e_ * rhs[1] + f_ * rhs[2]
    dl = jnp.stack([dl0, dl1, dl2], axis=1)                # (L, 3)

    diag_pp = jnp.stack(dpp, axis=1)
    diag_ll = jnp.stack(dll, axis=1)
    return dp, dl, diag_pp, diag_ll


def solve_ba_flat_sm(poses0, points0, work: SlotWork, *, fixed_mask=None,
                     max_iters=30, lambda_init=1e-4, xtol=1e-12,
                     loss=None):
    """LM bundle adjustment, slot-major flat layout. Same semantics and
    iteration trajectory as schur_flat.solve_ba_flat (parity-tested)."""
    C, L = work.n_cams, work.n_points
    dtype = points0.dtype
    if fixed_mask is None:
        fixed_mask = jnp.zeros(C, bool).at[0].set(True)

    def quantities(poses, points):
        Hpp_flat, gp, Hll_flat, gl, W, cost = _quantities_sm(
            poses, points, work, loss=loss)
        return (Hpp_flat, gp, Hll_flat, gl, W), cost

    blocks0, cost0 = quantities(poses0, points0)
    state = (BAState(poses=poses0, points=points0, cost=cost0,
                     lam=jnp.asarray(lambda_init, dtype),
                     nu=jnp.asarray(2.0, dtype),
                     it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool)),
             blocks0)

    def cond(sb):
        s, _ = sb
        return (~s.done) & (s.it < max_iters)

    def body(sb):
        s, blocks = sb
        Hpp_flat, gp, Hll_flat, gl, W = blocks
        dp, dl, diag_pp, diag_ll = _solve_sm(
            Hpp_flat, gp, list(Hll_flat), list(gl), W, s.lam, fixed_mask,
            work)

        bad = jnp.any(~jnp.isfinite(dp)) | jnp.any(~jnp.isfinite(dl))
        dp_s = jnp.where(bad, jnp.zeros_like(dp), dp)
        dl_s = jnp.where(bad, jnp.zeros_like(dl), dl)
        poses_try = jax.vmap(lambda T, d: se3.SE3(
            so3.retract(T.R, d[:3]), T.t + d[3:]))(s.poses, dp_s)
        points_try = s.points + dl_s
        blocks_try, cost_try = quantities(poses_try, points_try)

        gl_mat = jnp.stack(gl, axis=1)                      # (L, 3)
        pred_l = jnp.sum(dl_s * (s.lam * diag_ll * dl_s - gl_mat))
        pred = 0.5 * (jnp.sum(dp_s * (s.lam * diag_pp * dp_s - gp)) + pred_l)
        accept, lam_new, nu_new = lm_accept(s.cost, cost_try, s.lam, s.nu,
                                            pred, bad)
        sel = lambda a, b: jnp.where(accept, a, b)
        step_sq = jnp.sum(dp_s * dp_s) + jnp.sum(dl_s * dl_s)
        new_state = BAState(
            poses=jax.tree_util.tree_map(sel, poses_try, s.poses),
            points=sel(points_try, s.points),
            cost=sel(cost_try, s.cost), lam=lam_new, nu=nu_new, it=s.it + 1,
            done=accept & (step_sq < xtol * xtol))
        new_blocks = jax.tree_util.tree_map(sel, blocks_try, blocks)
        return (new_state, new_blocks)

    final, _ = jax.lax.while_loop(cond, body, state)
    return final


solve_ba_flat_sm_jit = jax.jit(partial(solve_ba_flat_sm),
                               static_argnames=("max_iters",))
