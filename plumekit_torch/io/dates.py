"""Granule acquisition dates (``plumekit/io/dates.py``) as
``datetime64[D]``: the MAIAC name's ``A2017255`` field is year + day of
year (``plume_identifier_rg.py:574``)."""

from __future__ import annotations

import re
from datetime import datetime

import numpy as np

_ACQ_RE = re.compile(r"\.A(\d{7})\.")


def granule_date(name: str, default=None):
    """Acquisition date of a MAIAC-style granule name
    (``MCD19A2.A2017255.h12v09...`` → 2017-09-12), else ``default``."""
    m = _ACQ_RE.search(name)
    if m:
        return np.datetime64(datetime.strptime(m.group(1), "%Y%j").date(),
                             "D")
    return default
