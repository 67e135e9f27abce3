"""Fire clustering of the rg detector (numpy/scipy copy of the host half of
``plumekit/ops/cluster.py``).

The reference runs DBSCAN over fire lat/lon with the haversine metric,
``min_samples=1`` and eps = cluster_dist_km / 6371 radians
(``plume_identifier_rg.py:61-66``). With ``min_samples=1`` DBSCAN is the
connected components of the eps-neighbourhood graph: a cKDTree in
unit-sphere chord space plus union-find gives it exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
