"""One ``identify(granule, fires, date, cfg)`` for the three fire-driven
detectors, chosen by the type of ``cfg`` (``plumekit/identify/api.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np

from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                            GaussianIdentifyConfig,
                                            RGIdentifyConfig)
from plumekit_torch.identify import basic as _basic
from plumekit_torch.identify import gaussian as _gaussian
from plumekit_torch.identify import rg as _rg
from plumekit_torch.io.tables import Table
from plumekit_torch.io.granule import Granule

IdentifyConfig = Union[BasicIdentifyConfig, RGIdentifyConfig,
                       GaussianIdentifyConfig]

BBOX_COLUMNS = ("id", "plume_min_row", "plume_max_row", "plume_min_col",
                "plume_max_col")


@dataclass
class PlumeSet:
    """One scene's result. ``aod_stats`` and ``hulls`` carry the
    reference's CSV columns (``plume_identifier_rg.py:425-457``); ``masks``
    maps plume id to its (H, W) bool mask and ``labelled_image`` is the
    basic detector's label image. A table a detector does not produce is
    empty and has no columns."""

    aod_stats: Table
    hulls: Table
    masks: Dict[int, np.ndarray] = field(default_factory=dict)
    labelled_image: Optional[np.ndarray] = None

    def __len__(self) -> int:
        """Distinct plume ids, of ``aod_stats`` if it has rows, else of
        ``hulls``."""
        for table in (self.aod_stats, self.hulls):
            if len(table):
                return len(set(table.column("id")))
        return 0


def identify(granule: Granule, fires, date_to_find,
             cfg: IdentifyConfig = RGIdentifyConfig(),
             device="cuda") -> PlumeSet:
    """Run the detector that ``cfg`` selects on a granule, on ``device``.

    * :class:`RGIdentifyConfig`: the threshold sweep on the first layer;
    * :class:`GaussianIdentifyConfig`: the multi-scale detector over every
      orbit layer;
    * :class:`BasicIdentifyConfig`: the fixed-threshold detector on the
      first layer with negative AOD zeroed
      (``plume_identifier_basic.py:44``).
    """
    if isinstance(cfg, RGIdentifyConfig):
        aod_table, hull_table, out = _rg.identify(
            granule.first_layer(), granule.lat, granule.lon, date_to_find,
            fires, cfg, device=device)
        return PlumeSet(aod_stats=aod_table, hulls=hull_table,
                        masks=_rg.plume_masks(out))
    if isinstance(cfg, GaussianIdentifyConfig):
        return PlumeSet(aod_stats=Table(()),
                        hulls=_gaussian.identify_granule(
                            granule, fires, date_to_find, cfg,
                            device=device))
    if isinstance(cfg, BasicIdentifyConfig):
        aod = granule.first_layer().copy()
        aod[aod < 0] = 0.0
        plume_dict, plume_image = _basic.identify(
            aod, granule.lat, granule.lon, date_to_find, fires, cfg,
            device=device)
        rows = [(pid, bb["min_r"], bb["max_r"], bb["min_c"], bb["max_c"])
                for pid, bb in plume_dict.items()]
        return PlumeSet(aod_stats=Table(BBOX_COLUMNS, rows),
                        hulls=Table(()), labelled_image=plume_image)
    raise TypeError(f"unknown identify config type: {type(cfg)!r}")
