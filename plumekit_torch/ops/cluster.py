"""Fire clustering (``plumekit/ops/cluster.py``).

basic and rg: the reference runs DBSCAN over fire lat/lon with the
haversine metric, ``min_samples=1`` and eps = cluster_dist_km / 6371
radians (``plume_identifier_rg.py:61-66``). With ``min_samples=1`` DBSCAN is
the connected components of the eps-neighbourhood graph: a cKDTree in
unit-sphere chord space plus union-find gives it exactly, on the host.

gaussian: rasterise the fires onto the grid, label 8-connected, drop
clusters under 3 px and take integer centroids
(``plume_identifier_gaussian_profile.py:126-139, 480-483``), on the device
with a fixed fire capacity (:func:`raster_cluster_centroids`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: sphere radius (km) that converts eps_km to radians
#: (``plume_identifier_rg.py:63``)
DBSCAN_EARTH_RADIUS_KM = 6371.0


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]
            i = p[i]
        return i

    def union(self, i: int, j: int) -> None:
        ri, rj = self.find(i), self.find(j)
        if ri != rj:
            self.parent[max(ri, rj)] = min(ri, rj)


def dbscan_haversine(lats, lons, eps_km: float, min_samples: int = 1
                     ) -> np.ndarray:
    """Cluster labels 0..K-1, numbered by first occurrence, for points
    within ``eps_km`` great-circle distance: DBSCAN(min_samples=1)."""
    if min_samples != 1:
        raise NotImplementedError("the reference uses min_samples=1 "
                                  "(plume_identifier_rg.py:63)")
    from scipy.spatial import cKDTree

    lats = np.radians(np.asarray(lats, dtype=np.float64))
    lons = np.radians(np.asarray(lons, dtype=np.float64))
    n = lats.size
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    xyz = np.column_stack([np.cos(lats) * np.cos(lons),
                           np.cos(lats) * np.sin(lons), np.sin(lats)])
    chord = 2.0 * np.sin(eps_km / DBSCAN_EARTH_RADIUS_KM / 2.0)
    uf = _UnionFind(n)
    for i, j in cKDTree(xyz).query_pairs(chord):
        uf.union(i, j)
    roots = np.array([uf.find(i) for i in range(n)])
    # the union parents the larger root under the smaller, so each root is
    # its cluster's first member and np.unique numbers by first appearance
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)


def _group_mean(values: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Per-label mean with the compensated (Kahan) running sum of pandas'
    ``groupby(...).mean()``, in row order, so that cluster positions equal
    the JAX package's to the last bit."""
    sums = np.zeros(k)
    comp = np.zeros(k)
    count = np.zeros(k)
    for v, g in zip(values.tolist(), labels.tolist()):
        count[g] += 1
        y = v - comp[g]
        t = sums[g] + y
        comp[g] = t - sums[g] - y
        sums[g] = t
    return sums / count


def mean_cluster_positions(fires, eps_km: float) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Cluster a fire table and return the per-cluster mean (latitude,
    longitude), clusters in label order — the reference's
    ``mean_fire_position`` (``plume_identifier_rg.py:61-66``)."""
    labels = dbscan_haversine(fires["latitude"], fires["longitude"], eps_km)
    k = int(labels.max()) + 1 if labels.size else 0
    return (_group_mean(np.asarray(fires["latitude"], np.float64), labels, k),
            _group_mean(np.asarray(fires["longitude"], np.float64), labels, k))


#: (F, H, W) elements per chunk of the per-fire reductions
CHUNK_ELEMENTS = 1 << 26


def raster_cluster_centroids(shape: Tuple[int, int], rows: torch.Tensor,
                             cols: torch.Tensor, valid: torch.Tensor,
                             min_size: int):
    """Fire clustering of the gaussian detector on the device of ``rows``.

    Rasterise the valid fires onto ``shape``, label 8-connected (the K2
    entry), drop clusters smaller than ``min_size`` px, and return one
    integer centroid per cluster (float32 mean, truncated, as the
    reference's ``.astype(int)``) packed into (F,) int32 arrays with a
    validity mask: the cluster's first fire carries it. Padding slots are
    never written to the raster. The per-fire (F, H, W) compares run in
    chunks; the sums are integers, so the result does not depend on the
    chunking.
    """
    from plumekit_torch.ops.kernels.ccl_sweep import multi_threshold_ccl

    h, w = shape
    device = rows.device
    grid = torch.zeros((h, w), dtype=torch.bool, device=device)
    grid[rows[valid].long(), cols[valid].long()] = True
    labels = multi_threshold_ccl(grid[None], connectivity=2,
                                 nested=False)[0]

    safe_r = torch.where(valid, rows, 0).long()
    safe_c = torch.where(valid, cols, 0).long()
    fire_labels = torch.where(valid, labels[safe_r, safe_c], 0)
    lab_eff = torch.where(fire_labels != 0, fire_labels, -1)

    f_count = rows.shape[0]
    rr = torch.arange(h, device=device)
    cc = torch.arange(w, device=device)
    cnt = torch.zeros(f_count, dtype=torch.int64, device=device)
    sum_r = torch.zeros_like(cnt)
    sum_c = torch.zeros_like(cnt)
    step = max(1, CHUNK_ELEMENTS // (h * w))
    for i in range(0, f_count, step):
        on = labels[None] == lab_eff[i:i + step, None, None]
        per_row, per_col = on.sum(2), on.sum(1)
        cnt[i:i + step] = per_row.sum(1)
        sum_r[i:i + step] = (per_row * rr).sum(1)
        sum_c[i:i + step] = (per_col * cc).sum(1)

    alive = (fire_labels != 0) & (cnt >= min_size)
    eq = fire_labels[:, None] == fire_labels[None, :]
    earlier = torch.tril(eq, diagonal=-1).any(1)
    is_rep = alive & ~earlier

    n = torch.clamp(cnt, min=1).to(torch.float32)
    cr = (sum_r.to(torch.float32) / n).to(torch.int32)
    ccol = (sum_c.to(torch.float32) / n).to(torch.int32)
    zero = torch.zeros_like(cr)
    return torch.where(is_rep, cr, zero), torch.where(is_rep, ccol, zero), \
        is_rep
