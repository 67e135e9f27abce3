"""Real-granule verification (``plumekit/io/verify.py``): one decoded
granule through the real-data contract register (docs/parity.md), check by
check, so that "works on real data" is a measured statement the moment a
real file lands.

The checks are independent, one failure never hides the rest, and
``verify_real_granule`` exits 0 only when every check that ran passed.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from plumekit_torch.io.granule import NULL_VALUE, Granule, load_granule

#: plausible ceiling of MAIAC's 0.001-scaled AOD: the product's valid range
#: tops out at 5.0, with headroom
AOD_MAX_PLAUSIBLE = 8.0


@dataclass
class Check:
    name: str
    status: str          # "pass" | "fail" | "skip"
    detail: str = ""


@dataclass
class VerifyResult:
    path: str
    checks: List[Check] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.status != "fail" for c in self.checks)

    def add(self, name: str, ok: bool, detail: str = "") -> None:
        self.checks.append(Check(name, "pass" if ok else "fail", detail))

    def skip(self, name: str, detail: str) -> None:
        self.checks.append(Check(name, "skip", detail))

    def summary(self) -> dict:
        return {
            "path": self.path,
            "ok": self.ok,
            "passed": sum(c.status == "pass" for c in self.checks),
            "failed": [c.name for c in self.checks if c.status == "fail"],
            "skipped": [c.name for c in self.checks if c.status == "skip"],
        }


def _check_decode(res: VerifyResult, path: str) -> Optional[Granule]:
    """Decode through the reader; its named errors become failed checks
    with their message, anything else is reported as UNNAMED."""
    try:
        granule = load_granule(path)
    except ImportError as e:
        res.add("decode", False, f"missing optional dependency: {e}")
        return None
    except ValueError as e:
        # the readers' named refusals of a malformed file
        res.add("decode", False, str(e))
        return None
    except Exception as e:
        res.add("decode", False,
                f"UNNAMED {type(e).__name__}: {e} — a contract-register "
                "gap (the reader should fail with a named error)")
        return None
    res.add("decode", True,
            f"{len(granule.layers)} layer(s), shape {granule.shape}")
    return granule


def _check_layers(res: VerifyResult, granule: Granule, is_hdf: bool):
    if not granule.layers:
        res.add("layers", False, "no layers decoded")
        return
    shapes = {ts: a.shape for ts, a in granule.layers.items()}
    uniform = len(set(shapes.values())) == 1
    res.add("layers", uniform, f"{shapes}")
    if is_hdf:
        stamp = re.compile(r"^[0-9]{11}[AT]$")
        bad = [ts for ts in granule.layers if not stamp.match(ts)]
        res.add("orbit_stamps", not bad,
                f"non-conforming keys: {bad}" if bad else
                f"{sorted(granule.layers)}")


def _check_grid(res: VerifyResult, granule: Granule):
    lat, lon = granule.lat, granule.lon
    ok_shape = lat.shape == lon.shape == granule.shape
    res.add("grid_shape", ok_shape,
            f"lat {lat.shape} lon {lon.shape} data {granule.shape}")
    finite = bool(np.isfinite(lat).all() and np.isfinite(lon).all())
    res.add("grid_finite", finite)
    if finite:
        res.add("lat_range",
                bool((lat >= -90).all() and (lat <= 90).all()),
                f"[{lat.min():.3f}, {lat.max():.3f}]")
        res.add("lon_range",
                bool((lon >= -180).all() and (lon <= 180).all()),
                f"[{lon.min():.3f}, {lon.max():.3f}]")
        # a sane granule spans far under 100 degrees of latitude; an
        # unwrapped antimeridian gives planetary extents
        res.add("extent_sane", float(lat.max() - lat.min()) < 60.0,
                f"lat span {lat.max() - lat.min():.2f} deg")


def _check_values(res: VerifyResult, granule: Granule):
    for ts, a in granule.layers.items():
        nulls = a == NULL_VALUE
        valid = a[~nulls]
        frac_null = float(nulls.mean())
        if valid.size == 0:
            res.add(f"values[{ts}]", True, "all-null layer (ocean/cloud)")
            continue
        in_range = bool((valid >= 0).all()
                        and (valid <= AOD_MAX_PLAUSIBLE).all())
        res.add(
            f"values[{ts}]", in_range and bool(np.isfinite(valid).all()),
            f"null {100 * frac_null:.1f}%, valid [{valid.min():.3f}, "
            f"{valid.max():.3f}] (scaled AOD; negatives must be "
            f"{NULL_VALUE:g})")


def _check_resample(res: VerifyResult, granule: Granule,
                    pixel_size: float = 1000.0, probe: int = 64):
    """The UTM plan built on the granule's geometry and spot-checked
    against brute-force nearest neighbours at ``probe`` random cells."""
    from plumekit_torch.geo.utm import UTMResampler

    try:
        sub = max(1, min(granule.shape) // 256)  # caps the plan's size
        lats = granule.lat[::sub, ::sub]
        lons = granule.lon[::sub, ::sub]
        rs = UTMResampler(lats, lons, pixel_size * sub)
        plan = rs.index_map
        rng = np.random.default_rng(0)
        sx, sy = rs.proj.forward(lons.ravel(), lats.ravel())
        txv, tyv = rs._cell_centers()
        worst = 0.0
        for _ in range(probe):
            i = int(rng.integers(plan.shape[0]))
            j = int(rng.integers(plan.shape[1]))
            d2 = (sx - txv[i, j]) ** 2 + (sy - tyv[i, j]) ** 2
            best = float(d2.min())
            got = float(d2[plan[i, j]])
            if rs.valid[i, j]:
                worst = max(worst, math.sqrt(got) - math.sqrt(best))
        res.add("utm_resample", worst < 1e-3,
                f"plan {plan.shape} zone {rs.zone}{'S' if rs.south else 'N'}"
                f", worst NN excess {worst:.2e} m over {probe} probes")
    except Exception as e:
        res.add("utm_resample", False, f"{type(e).__name__}: {e}")


def _check_identify(res: VerifyResult, granule: Granule,
                    fires_csv: Optional[str], detector: str, device):
    if not fires_csv:
        res.skip("identify", "no --fires table given")
        return
    try:
        from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                                    GaussianIdentifyConfig,
                                                    RGIdentifyConfig)
        from plumekit_torch.identify.api import identify
        from plumekit_torch.io.dates import granule_date
        from plumekit_torch.io.fires import load_fire_csv

        cfg = {"rg": RGIdentifyConfig(),
               "gaussian": GaussianIdentifyConfig(),
               "basic": BasicIdentifyConfig()}[detector]
        fires = load_fire_csv(fires_csv)
        date = granule_date(granule.name)
        if date is None:
            date = fires["date_time"][0]
        out = identify(granule, fires, date, cfg, device=device)
        # len(out) counts the ids of whichever table the detector fills
        res.add("identify", True, f"{detector}: {len(out)} plume(s) "
                f"at {date}")
    except Exception as e:
        res.add("identify", False, f"{type(e).__name__}: {e}")


def verify_granule(path: str, fires_csv: Optional[str] = None,
                   detector: str = "rg", run_identify: bool = True,
                   device="cuda") -> VerifyResult:
    """The whole register against one granule file; the detector's smoke
    run on ``device``."""
    res = VerifyResult(path=path)
    if not os.path.exists(path):
        res.add("exists", False, "file not found")
        return res
    granule = _check_decode(res, path)
    if granule is None:
        return res
    is_hdf = path.endswith(".hdf")
    _check_layers(res, granule, is_hdf)
    _check_grid(res, granule)
    _check_values(res, granule)
    _check_resample(res, granule)
    if run_identify:
        _check_identify(res, granule, fires_csv, detector, device)
    else:
        res.skip("identify", "disabled")
    return res


__all__ = ["verify_granule", "VerifyResult", "Check"]
