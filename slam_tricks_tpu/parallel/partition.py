"""Host-side observation partitioning for distributed BA (SURVEY §2.2 items
1-2). The distribution unit is the LANDMARK TRACK: all observations
of a landmark are placed on one device, so landmark elimination and the
within-track pair products that form the off-diagonal Schur mass are
shard-local, and the only O(>C) cross-device reduction is the psum of the
(C,6,C,6) reduced-camera-system contribution — O(C^2*36) bytes/iteration,
independent of landmark/observation counts.

(The reference has no distribution at all — num_threads=1 everywhere,
st17-ceres/src/include/solver.hpp:281; this design is the solver-domain analog
of data parallelism described in SURVEY §2.2.)
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class LocalPairs(NamedTuple):
    """Per-device within-track observation pairs with DEVICE-LOCAL indices
    (0..chunk_len) into the device's observation shard. Shapes are
    (n_devices, n_chunks, chunk); shard on the leading axis. pair_w is 1.0
    for off-diagonal pairs (a<b), 0.5 on the diagonal (a==b), 0 for padding."""
    pair_a: jnp.ndarray
    pair_b: jnp.ndarray
    pair_w: jnp.ndarray


def partition_obs_by_landmark(obs, n_devices):
    """Sort by lm_idx, split into n_devices chunks at landmark boundaries,
    pad each chunk to a common length. Returns a BAObservations-like tuple
    whose arrays have shape (n_devices * chunk_len, ...), chunk-contiguous
    (device d owns rows [d*chunk_len, (d+1)*chunk_len)). Padding rows carry
    weight 0 and point at indices 0."""
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.weight)
    order = np.argsort(lm_idx, kind="stable")
    cam_idx, lm_idx, uv, w = cam_idx[order], lm_idx[order], uv[order], w[order]
    n = len(order)

    # cut points at landmark boundaries nearest to equal splits
    cuts = [0]
    for d in range(1, n_devices):
        target = d * n // n_devices
        while target < n and target > 0 and lm_idx[target] == lm_idx[target - 1]:
            target += 1
        cuts.append(min(target, n))
    cuts.append(n)
    chunks = [slice(cuts[i], cuts[i + 1]) for i in range(n_devices)]
    chunk_len = max(c.stop - c.start for c in chunks)
    chunk_len = chunk_len + (-chunk_len) % 8

    def pad(a, fill=0):
        out = np.full((n_devices * chunk_len,) + a.shape[1:], fill, a.dtype)
        for i, c in enumerate(chunks):
            out[i * chunk_len:i * chunk_len + (c.stop - c.start)] = a[c]
        return out

    return type(obs)(
        cam_idx=jnp.asarray(pad(cam_idx)),
        lm_idx=jnp.asarray(pad(lm_idx)),
        uv=jnp.asarray(pad(uv)),
        weight=jnp.asarray(pad(w)),   # padding rows keep weight 0
    )


def build_local_pairs(obs_part, n_devices, *, chunk=65536, dtype=np.float32):
    """Enumerate within-track observation pairs per device, with indices LOCAL
    to each device's chunk of `obs_part` (which must come from
    `partition_obs_by_landmark` — track locality guarantees every pair is
    device-local). Pads every device to the same (n_chunks, chunk) shape so the
    pair arrays shard uniformly; padding pairs have weight 0 and index 0.

    This is the distributed form of solvers/schur.build_track_pairs — the
    index structure of the off-diagonal blocks W Hll^-1 W^T that g2o walks
    edge-pair by edge-pair (st20-g2o/src/include/test_g2o.h:121)."""
    cam_idx = np.asarray(obs_part.cam_idx)
    lm_idx = np.asarray(obs_part.lm_idx)
    w = np.asarray(obs_part.weight)
    n_total = cam_idx.shape[0]
    assert n_total % n_devices == 0
    chunk_len = n_total // n_devices

    per_dev = []
    max_pairs = 0
    for d in range(n_devices):
        sl = slice(d * chunk_len, (d + 1) * chunk_len)
        lm_d = lm_idx[sl]
        w_d = w[sl]
        valid = np.flatnonzero(w_d > 0)
        order = valid[np.argsort(lm_d[valid], kind="stable")].astype(np.int32)
        lm_sorted = lm_d[order]
        if order.size:
            starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
            ends = np.r_[starts[1:], lm_sorted.shape[0]]
        else:
            starts = ends = np.zeros(0, np.int64)
        lengths = ends - starts
        # vectorized pair enumeration, bucketed by track length
        a_list, b_list = [], []
        for k in np.unique(lengths):
            if k == 0:
                continue
            tr = np.flatnonzero(lengths == k)
            M = order[starts[tr][:, None] + np.arange(k)[None, :]]
            ii, jj = np.triu_indices(int(k))
            a_list.append(M[:, ii].ravel())
            b_list.append(M[:, jj].ravel())
        pa = np.concatenate(a_list) if a_list else np.zeros(0, np.int32)
        pb = np.concatenate(b_list) if b_list else np.zeros(0, np.int32)
        pw = np.where(pa == pb, 0.5, 1.0).astype(dtype)
        per_dev.append((pa, pb, pw))
        max_pairs = max(max_pairs, pa.shape[0])

    chunk = min(chunk, max(max_pairs, 1))
    p_pad = max_pairs + (-max_pairs) % chunk
    if p_pad == 0:
        p_pad = chunk
    n_chunks = p_pad // chunk

    pa_all = np.zeros((n_devices, n_chunks, chunk), np.int32)
    pb_all = np.zeros((n_devices, n_chunks, chunk), np.int32)
    pw_all = np.zeros((n_devices, n_chunks, chunk), dtype)
    for d, (pa, pb, pw) in enumerate(per_dev):
        k = pa.shape[0]
        pa_all[d].reshape(-1)[:k] = pa
        pb_all[d].reshape(-1)[:k] = pb
        pw_all[d].reshape(-1)[:k] = pw
    return LocalPairs(pair_a=jnp.asarray(pa_all), pair_b=jnp.asarray(pb_all),
                      pair_w=jnp.asarray(pw_all))
