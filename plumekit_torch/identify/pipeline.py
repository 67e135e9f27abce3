"""The threshold-sweep program behind the rg detector
(``plumekit/identify/pipeline.py``), in PyTorch on one device.

Per scene: label the cross-opened masks of all T thresholds (the K1/K4
kernel), find each fire's nearest label in its window at every level, count
those labels' pixels (the K3 kernel), pick each fire's threshold index from
the extent ratios, and vet the plume at that index and the one before it
with the reference's gates (area, AOD max, principal-axis ratio, transect
peaks). Fires ride fixed-capacity arrays with a validity mask.

The JAX program vmaps the per-fire phase over fires and the (a, b)
threshold pair and lets XLA fuse its (H, W) temporaries away. Eager
PyTorch would build every one of them, (2F, H, W) at a time, so the
candidates go through in chunks sized from H·W; the results do not depend
on the chunking.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from plumekit_torch.ops.geometry import principal_axes
from plumekit_torch.ops.kernels.ccl_sweep import multi_threshold_ccl_fused
from plumekit_torch.ops.kernels.label_counts import fire_label_counts
from plumekit_torch.ops.morphology import binary_dilation_square
from plumekit_torch.ops.segment import (gather_windows, masked_bbox,
                                        masked_centroid, masked_moments_cov,
                                        window_label_from, window_starts)
from plumekit_torch.ops.transect import (count_peaks_masked, line_transect,
                                         line_transect_in_mask, savgol_smooth)

#: candidate-plane elements per chunk of the per-fire phase: about ten
#: float32 temporaries of this size are alive at once (~2.7 GB)
ASSESS_CHUNK_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class SweepStatics:
    """Static parameters of the sweep (the JAX package's, field for
    field)."""

    win_half: int
    min_plume_pixels: int
    max_plume_pixels: int
    max_lim: float               # min acceptable in-plume AOD max
    axis_ratio: float            # rg SIDE_RATIO=5 / gaussian MIN_AXIS_RATIO=8
    max_peaks: int               # rg 1 / gaussian 3
    n_transect: int
    savgol_window: int = 0       # 0 = no smoothing (gaussian variant)
    savgol_polyorder: int = 3
    check_null: bool = False     # gaussian CHECK 4
    max_invalid_frac: float = 0.2
    use_mask_b: bool = True      # rg also evaluates threshold_index - 1
    pick_larger_mask: bool = True
    reject_last_threshold: bool = True
    dilate_plume_px: int = 0     # gaussian buffers the final mask


def validate_descending_thresholds(thresholds) -> np.ndarray:
    """Float32 thresholds, at least two and strictly descending, as the
    JAX sweep requires of every detector; raises otherwise."""
    t = np.asarray(thresholds, dtype=np.float32)
    if t.ndim != 1 or t.size < 2 or not np.all(np.diff(t) < 0):
        raise ValueError(
            "threshold sweep requires >=2 strictly descending thresholds "
            f"(nested-mask invariant of the warm-started CCL); got {t!r}"
        )
    return t


def _threshold_index(extents: torch.Tensor, reject_last: bool):
    """Per-fire best threshold index — the reference's
    ``find_threshold_index`` (``plume_identifier_rg.py:198-234``) — for
    (T, F) extents over descending thresholds. Returns (index int32 (F,),
    has_index bool (F,)). ``argmax`` takes the first of equal maxima, as
    ``np.nanargmax``."""
    t = extents.shape[0]
    prev = extents[:-1].to(torch.float32)
    nxt = extents[1:].to(torch.float32)
    is_nan = prev == 0
    ratios = torch.where(is_nan, -torch.inf, nxt / torch.clamp(prev, min=1.0))
    all_nan = is_nan.all(0)
    argmax = torch.argmax(ratios, dim=0)
    any_nan = is_nan.any(0)
    # index of the last zero-extent entry (meaningful where any_nan)
    rev_first = torch.argmax(is_nan.flip(0).to(torch.int32), dim=0)
    last_nan = (t - 2) - rev_first
    first_non_nan_reject = any_nan & (argmax == last_nan + 1)
    if reject_last:
        last_reject = argmax == (t - 2)
    else:
        last_reject = torch.zeros_like(all_nan)
    has = ~all_nan & ~first_non_nan_reject & ~last_reject
    return argmax.to(torch.int32), has


def _flat_tol(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """A few-ULP flatness tolerance for fp32 peak counting: 32 eps of each
    row's valid dynamic range."""
    vmax = torch.where(valid, values, -torch.inf).amax(-1)
    vmin = torch.where(valid, values, torch.inf).amin(-1)
    spread = vmax - vmin
    spread = torch.where(torch.isfinite(spread), spread, 0.0)
    return (32.0 * np.float32(1.1920929e-7)) * spread


def _assess(s: SweepStatics, labels_all, aod_det, aod_stat, null_mask,
            t_idx, label, found, area):
    """Vet one chunk of N candidate plumes: candidate k is the component
    ``label[k]`` of ``labels_all[t_idx[k]]`` (empty where not ``found``).
    Mirrors ``assess_at`` (``plumekit/identify/pipeline.py:141-224``,
    i.e. ``find_plume_mask`` + ``assess_plume`` + ``check_plume_profile``
    of ``plume_identifier_rg.py:237-354``)."""
    mask = (labels_all[t_idx.long()] == label[:, None, None]) \
        & found[:, None, None]

    ok = found & (area >= s.min_plume_pixels) & (area <= s.max_plume_pixels)
    aod_max = torch.where(mask, aod_stat, -torch.inf).amax((-2, -1))
    ok &= aod_max >= s.max_lim
    if s.check_null:
        n_null = (null_mask & mask).sum((-2, -1))
        ok &= (n_null / torch.clamp(area, min=1)) <= s.max_invalid_frac

    c_rr, c_rc, c_cc, _n = masked_moments_cov(mask)
    d_major, d_minor, _v_major, v_minor = principal_axes(c_rr, c_rc, c_cc)
    ratio = d_major / torch.clamp(d_minor, min=1e-12)
    ok &= ratio >= s.axis_ratio

    min_r, min_c, max_r, max_c = masked_bbox(mask)
    mr, mc = masked_centroid(mask)
    # the minor axis as a line y = slope·x + intercept; a vertical axis
    # gives ±inf or NaN slopes whose comparisons fail, as in the reference
    slope = v_minor[:, 0] / v_minor[:, 1]
    y1 = mr + 0.5 * d_minor * v_minor[:, 0]
    x1 = mc + 0.5 * d_minor * v_minor[:, 1]
    intercept = y1 - x1 * slope
    line = (slope, intercept, min_r.to(torch.float32),
            min_c.to(torch.float32), max_r.to(torch.float32),
            max_c.to(torch.float32))
    if s.savgol_window:
        samples, valid = line_transect(aod_det, *line,
                                       n_samples=s.n_transect)
        smoothed, sg_ok = savgol_smooth(samples, valid, s.savgol_window,
                                        s.savgol_polyorder)
        n_peaks = count_peaks_masked(smoothed, valid,
                                     _flat_tol(smoothed, valid))
        ok &= sg_ok
    else:
        samples, valid = line_transect_in_mask(aod_det, mask, *line,
                                               n_samples=s.n_transect)
        n_peaks = count_peaks_masked(samples, valid,
                                     _flat_tol(samples, valid))
    ok &= n_peaks <= s.max_peaks

    stats_n = torch.clamp(area, min=1)
    mean = torch.where(mask, aod_stat, 0.0).sum((-2, -1)) / stats_n
    sq = torch.where(mask, (aod_stat - mean[:, None, None]) ** 2,
                     0.0).sum((-2, -1)) / stats_n
    gates = torch.stack([found, area >= s.min_plume_pixels,
                         area <= s.max_plume_pixels, aod_max >= s.max_lim,
                         ratio >= s.axis_ratio, n_peaks <= s.max_peaks], -1)
    return dict(
        ok=ok, mask_sum=mask.sum((-2, -1)), aod_mean=mean,
        aod_sd=torch.sqrt(sq),
        bbox=torch.stack([min_r, min_c, max_r, max_c], -1),
        gates=gates, n_peaks=n_peaks,
        dbg=torch.stack([slope, intercept, d_minor, d_major], -1),
    )


def _assess_all(s, labels_all, aod_det, aod_stat, null_mask, t_idx, label,
                found, area):
    """:func:`_assess` over every candidate, in chunks of at most
    :data:`ASSESS_CHUNK_ELEMENTS` plane elements."""
    h, w = aod_det.shape
    step = max(1, ASSESS_CHUNK_ELEMENTS // (h * w))
    parts = [_assess(s, labels_all, aod_det, aod_stat, null_mask,
                     t_idx[i:i + step], label[i:i + step],
                     found[i:i + step], area[i:i + step])
             for i in range(0, t_idx.shape[0], step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def make_sweep_identifier(statics: SweepStatics):
    """The sweep program for a static configuration.

    Returns ``fn(aod, raw_aod, null_mask, thresholds, fire_rows,
    fire_cols, fire_valid) -> dict`` over tensors on one device: ``aod``
    (H, W) float32 is the detection field, ``raw_aod`` the field for
    in-plume statistics, ``thresholds`` (T,) float32 descending, the fire
    arrays (F,) int32 with a validity mask. The output dict holds the JAX
    program's keys, shapes and dtypes: ``accepted`` (F,), ``mask``
    (F, H, W), ``t_index``, ``t_used``, ``label``, ``area``, ``aod_mean``,
    ``aod_sd``, ``bbox`` (F, 4), ``extents`` (T, F), and the gate debug
    arrays. The label stack goes through the K1 entry and the size table
    through K3 on every device.
    """
    s = statics

    def fn(aod_det, aod_stat, null_mask, thresholds, fire_rows, fire_cols,
           fire_valid):
        t_count = thresholds.shape[0]
        f_count = fire_rows.shape[0]
        h, w = aod_det.shape

        labels_all = multi_threshold_ccl_fused(aod_det, thresholds,
                                               connectivity=2)

        # (T, F) nearest labels and found flags: one (T, size, size) slab
        # per fire (the window does not depend on the threshold)
        size = 2 * s.win_half + 1
        sr, sc = window_starts(fire_rows, fire_cols, h, w, s.win_half)
        slab = gather_windows(labels_all, sr, sc, size)
        lab_tf, found_tf = window_label_from(slab, fire_rows, fire_cols,
                                             sr, sc)
        sizes_tf = fire_label_counts(labels_all, lab_tf.contiguous())
        extents = torch.where(found_tf & fire_valid[None, :], sizes_tf, 0)

        t_idx, has_idx = _threshold_index(extents, s.reject_last_threshold)
        has_idx &= fire_valid
        fires = torch.arange(f_count, device=aod_det.device)

        def candidates(ti):
            lab = lab_tf[ti.long(), fires]
            fnd = found_tf[ti.long(), fires]
            area = torch.where(fnd, sizes_tf[ti.long(), fires], 0)
            return lab, fnd, area

        if not s.use_mask_b:
            lab_a, found_a, area_a = candidates(t_idx)
            res = _assess_all(s, labels_all, aod_det, aod_stat, null_mask,
                              t_idx, lab_a, found_a, area_a)
            res.update(label=lab_a, area=area_a, found=found_a, t_used=t_idx)
        else:
            # Python's negative-index wrap: THRESHOLD_SET[idx - 1] with
            # idx = 0 reads the LAST threshold (plume_identifier_rg.py:386)
            t_b = torch.where(t_idx - 1 < 0, t_count - 1, t_idx - 1) \
                .to(torch.int32)
            (lab_a, found_a, area_a), (lab_b, found_b, area_b) = \
                candidates(t_idx), candidates(t_b)
            both = _assess_all(
                s, labels_all, aod_det, aod_stat, null_mask,
                torch.cat([t_idx, t_b]), torch.cat([lab_a, lab_b]),
                torch.cat([found_a, found_b]), torch.cat([area_a, area_b]))
            ra = {k: v[:f_count] for k, v in both.items()}
            rb = {k: v[f_count:] for k, v in both.items()}
            ra.update(label=lab_a, area=area_a, found=found_a)
            rb.update(label=lab_b, area=area_b, found=found_b)
            if s.pick_larger_mask:
                prefer_a = ra["mask_sum"] > rb["mask_sum"]
            else:
                prefer_a = ra["mask_sum"] <= rb["mask_sum"]
            use_a = torch.where(ra["ok"] & rb["ok"], prefer_a, ra["ok"])
            res = {}
            for k in ("label", "area", "found", "aod_mean", "aod_sd",
                      "bbox"):
                sel = use_a if ra[k].dim() == 1 else use_a[:, None]
                res[k] = torch.where(sel, ra[k], rb[k])
            res["ok"] = ra["ok"] | rb["ok"]
            res["t_used"] = torch.where(use_a, t_idx, t_b)
            for k in ("gates", "n_peaks", "dbg"):
                res[k + "_a"], res[k + "_b"] = ra[k], rb[k]

        accepted = res["ok"] & has_idx
        # the chosen component of each accepted fire (all-False rows for
        # the rest), built for the accepted fires only
        mask = torch.zeros((f_count, h, w), dtype=torch.bool,
                           device=aod_det.device)
        keep = torch.nonzero(accepted)[:, 0]
        step = max(1, ASSESS_CHUNK_ELEMENTS // (h * w))
        for part in torch.split(keep, step):
            chosen = (labels_all[res["t_used"][part].long()]
                      == res["label"][part][:, None, None]) \
                & res["found"][part][:, None, None]
            if s.dilate_plume_px:
                chosen = binary_dilation_square(chosen, s.dilate_plume_px)
            mask[part] = chosen

        ret = dict(accepted=accepted, mask=mask, t_index=t_idx,
                   t_used=res["t_used"], label=res["label"],
                   area=res["area"], aod_mean=res["aod_mean"],
                   aod_sd=res["aod_sd"], bbox=res["bbox"], extents=extents)
        for k in ("gates_a", "gates_b", "n_peaks_a", "n_peaks_b", "gates",
                  "n_peaks", "dbg_a", "dbg_b", "dbg"):
            if k in res:
                ret[k] = res[k]
        return ret

    return fn
