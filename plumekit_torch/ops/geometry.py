"""Plume geometry (``plumekit/ops/geometry.py``): the closed-form 2×2
symmetric eigendecomposition behind the principal-axis gate, point in
convex polygon, and the host convex hull."""

from __future__ import annotations

import numpy as np
import torch


def eig2x2_sym(a, b, c):
    """Eigen-decomposition of [[a, b], [b, c]] (symmetric PSD), elementwise.

    Returns ``(l_max, l_min, v_max, v_min)`` with unit eigenvectors stacked
    on the last axis.
    """
    tr = a + c
    disc = torch.sqrt(torch.clamp((a - c) ** 2 + 4.0 * b**2, min=0.0))
    l_max = 0.5 * (tr + disc)
    l_min = 0.5 * (tr - disc)

    def unit(vx, vy):
        n = torch.sqrt(vx**2 + vy**2)
        safe = n > 1e-20
        n = torch.where(safe, n, 1.0)
        return torch.where(safe, vx / n, 1.0), torch.where(safe, vy / n, 0.0)

    # eigenvector of l_max: (b, l_max - a) unless b ~ 0
    use_b = torch.abs(b) > 1e-20
    a_ge_c = a >= c
    vx1 = torch.where(use_b, b, torch.where(a_ge_c, 1.0, 0.0))
    vy1 = torch.where(use_b, l_max - a, torch.where(a_ge_c, 0.0, 1.0))
    vx1, vy1 = unit(vx1, vy1)
    v_max = torch.stack([vx1, vy1], dim=-1)
    v_min = torch.stack([-vy1, vx1], dim=-1)
    return l_max, l_min, v_max, v_min


def principal_axes(cov_rr, cov_rc, cov_cc):
    """Axis "distances" and directions as the reference builds them:
    endpoints ``center ± eigval * eigvec``, so the axis length is
    ``2 * eigval`` (variance-scaled, ``plume_identifier_rg.py:288-294``).
    Returns ``(d_major, d_minor, v_major, v_minor)``, vectors as (y, x)."""
    l_max, l_min, v_max, v_min = eig2x2_sym(cov_rr, cov_rc, cov_cc)
    return 2.0 * l_max, 2.0 * l_min, v_max, v_min


def points_in_convex_hull(points: torch.Tensor, hull_vertices: torch.Tensor,
                          n_valid) -> torch.Tensor:
    """Containment of ``points`` (N, 2) in the convex polygon whose
    vertices, in hull order (scipy's ``ConvexHull.vertices`` are
    counter-clockwise), are the first ``n_valid`` rows of
    ``hull_vertices`` (K, 2); the rest pad. Boundary points are inside
    (Delaunay ``find_simplex >= 0``); either winding is accepted. A hull
    of fewer than 3 vertices contains nothing."""
    k = hull_vertices.shape[0]
    idx = torch.arange(k, device=hull_vertices.device)
    nxt = torch.where(idx + 1 < n_valid, idx + 1, 0)
    edge = hull_vertices[nxt] - hull_vertices               # (K, 2)
    rel = points[:, None, :] - hull_vertices[None, :, :]   # (N, K, 2)
    cross = edge[None, :, 0] * rel[:, :, 1] - edge[None, :, 1] * rel[:, :, 0]
    cross = torch.where((idx < n_valid)[None, :], cross, 0.0)
    inside = (cross >= 0.0).all(1) | (cross <= 0.0).all(1)
    return inside & (n_valid >= 3)


def convex_hull_vertices_host(points: np.ndarray) -> np.ndarray:
    """Hull vertex indices via scipy (``plume_identifier_rg.py:414``)."""
    from scipy.spatial import ConvexHull

    return ConvexHull(points).vertices
