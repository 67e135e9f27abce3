"""Workspace layout: the directory names of ``plumekit/config/paths.py``, so
one data root serves both packages."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class PathsConfig:
    """Workspace layout rooted at ``root``."""

    #: read at construction time (a class-body default would freeze the
    #: environment variable as of first import)
    root: str = field(default_factory=lambda: os.environ.get(
        "PLUMEKIT_ROOT", "data"))

    maiac_dir: str = "raw/plume_identification/maiac"
    log_dir: str = "raw/plume_identification/logs"
    aod_df_dir: str = "raw/plume_identification/dataframes/full/aod"
    hull_df_dir: str = "raw/plume_identification/dataframes/full/hull"
    plot_dir: str = "raw/plume_identification/plots"

    reduced_plume_hull_dir: str = "raw/plume_identification/dataframes/reduced/plume/hull"
    reduced_not_plume_hull_dir: str = "raw/plume_identification/dataframes/reduced/not_plume/hull"

    viirs_sdr_dir: str = "raw/viirs/sdr"
    viirs_sdr_reproj_tcc_dir: str = "raw/reprojected_viirs/tcc"
    viirs_sdr_reproj_blue_dir: str = "raw/reprojected_viirs/blue"
    viirs_sdr_reproj_h5_dir: str = "raw/reprojected_viirs/h5"
    viirs_aod_dir: str = "raw/viirs/aod"
    viirs_geo_dir: str = "raw/viirs/geo"
    viirs_masks_dir: str = "raw/viirs/masks"

    ml_viirs_sdr_dir: str = "raw/ml_data_viirs/sdr"
    ml_viirs_tcc_dir: str = "raw/ml_data_viirs/tcc"
    ml_viirs_h5_dir: str = "raw/ml_data_viirs/h5"
    ml_viirs_plume_masks_dir: str = "raw/ml_data_viirs/mask_full_plume"

    fires_dir: str = "raw/fires"

    model_data_dir: str = "processed/model_data"
    model_dir: str = "models"

    predictions_dir: str = "processed/predictions"
    evaluation_csv: str = "processed/evaluation.csv"

    plume_mask_dir: str = "interim/plume_masks"

    def resolve(self, name: str, create: bool = False) -> str:
        """Path of the named sub-directory; ``create=True`` makes it."""
        p = os.path.join(self.root, getattr(self, name))
        if create:
            os.makedirs(p, exist_ok=True)
        return p

    def ensure(self, name: str) -> str:
        """Path of the named sub-directory, created if missing."""
        return self.resolve(name, create=True)
