"""The MAIAC MCD19A2-shaped HDF4 fixtures of ``tests/data/maiac/``: their
contents, regenerated from seed 0 with ``plumekit_torch.io.synthetic.
make_scene`` (:func:`fixtures`, :func:`expected_granule`; numpy only, no
library), and the writer that stores them through the HDF4 C library
(``libdfalt`` / ``libmfhdfalt``) with ctypes (:func:`write`).

    python tools/make_maiac_fixtures.py [--out tests/data/maiac]

Writing needs the HDF4 C library and refuses to run without it; reading the
committed files needs only the port (``plumekit_torch/io/hdf4.py``). The
full-size granule is the bench scene (``bench.py:267-271``: 1200², 9
plumes, F = 16) on the MODIS sinusoidal tile h11v09, as four orbits of
``Optical_Depth_055`` (int16, ``round(aod × 1000)``, −28672 where there is
no retrieval) stored with deflate; the small ones (64 × 48) hold one
storage form or one rule each.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from plumekit_torch.geo.sinusoidal import (SINU_RADIUS_M,  # noqa: E402
                                           grid_from_extent)
from plumekit_torch.io.granule import (AOD_SCALE, NULL_VALUE,  # noqa: E402
                                       Granule)
from plumekit_torch.io.synthetic import (SyntheticSceneConfig,  # noqa: E402
                                         make_scene)

OUT_DIR = os.path.join(REPO, "tests", "data", "maiac")
SEED = 0

#: MAIAC's fill for "no retrieval"
MAIAC_FILL = -28672

#: corners of the sinusoidal tile h11v09 in meters (UL, LR), as in
#: tests/test_io_hdf4.py
X0, Y0 = -7783653.637667, -1111950.519667
X1, Y1 = -6671703.118000, -2223901.039333

#: the bench scene (bench.py:267-271)
BENCH_SCENE = dict(size=1200, n_plumes=9, background_level=0.2,
                   background_noise=0.05, plume_amplitude=(0.6, 0.8),
                   plume_sigma_major=(9.0, 14.0),
                   plume_sigma_minor=(1.8, 2.6), fires_per_plume=(7, 9),
                   extra_fires=4)
FULL_NAME = "MCD19A2.A2017213.h11v09.061.2017215000000"
FULL_STAMPS = "20172131355T 20172131535T 20172131710A 20172131850A"
SMALL = (64, 48)
TRUNCATED_BYTES = 65536
STRUCT_METADATA_BYTES = 32000       # HDF-EOS's fixed StructMetadata.0


def struct_metadata(ny: int, nx: int, pad: bool = False) -> str:
    """An HDF-EOS ``StructMetadata.0`` of one 1 km sinusoidal grid;
    ``pad`` fills it with NULs to HDF-EOS's fixed length."""
    text = (
        "GROUP=SwathStructure\nEND_GROUP=SwathStructure\n"
        "GROUP=GridStructure\n\tGROUP=GRID_1\n"
        '\t\tGridName="grid1km"\n'
        f"\t\tXDim={nx}\n\t\tYDim={ny}\n"
        f"\t\tUpperLeftPointMtrs=({X0:.6f},{Y0:.6f})\n"
        f"\t\tLowerRightMtrs=({X1:.6f},{Y1:.6f})\n"
        "\t\tProjection=GCTP_SNSOID\n"
        f"\t\tProjParams=({SINU_RADIUS_M:.6f},0,0,0,0,0,0,0,0,0,0,0,0)\n"
        "\t\tSphereCode=-1\n\t\tGridOrigin=HDFE_GD_UL\n"
        "\t\tGROUP=DataField\n\t\t\tOBJECT=DataField_1\n"
        '\t\t\t\tDataFieldName="Optical_Depth_055"\n'
        "\t\t\t\tDataType=DFNT_INT16\n"
        '\t\t\t\tDimList=("Orbits:grid1km","YDim:grid1km","XDim:grid1km")\n'
        "\t\t\tEND_OBJECT=DataField_1\n\t\tEND_GROUP=DataField\n"
        "\tEND_GROUP=GRID_1\nEND_GROUP=GridStructure\n"
        "GROUP=PointStructure\nEND_GROUP=PointStructure\nEND\n")
    return text + "\0" * (STRUCT_METADATA_BYTES - len(text)) if pad else text


@dataclass
class Fixture:
    """One file: its global attributes, its SDSs (name → raw array, or a
    shape for one never written), the storage of ``Optical_Depth_055``,
    and what the reader gives: the layers as (stamp, raw orbit) pairs, or
    the message of the named error."""
    file: str
    stamps: str
    raw: Optional[np.ndarray]
    storage: str = "contiguous"
    shape: Optional[Tuple[int, ...]] = None
    chunks: Optional[Tuple[int, ...]] = None
    extra: Dict[str, np.ndarray] = field(default_factory=dict)
    layers: List[Tuple[str, int]] = field(default_factory=list)
    error: Optional[str] = None
    pad_metadata: bool = False
    truncate_of: Optional[str] = None

    @property
    def name(self) -> str:
        return self.file[:-len(".hdf")]

    @property
    def sds_shape(self) -> Tuple[int, ...]:
        return self.raw.shape if self.raw is not None else self.shape


def tile_scene_config(size: int = 1200, **kw) -> SyntheticSceneConfig:
    """A scene on the h11v09 tile's grid: centred on the tile, at its pixel
    size, so that its fires fall on the pixels the file's grid gives."""
    yc, xc = (Y0 + Y1) / 2.0, (X0 + X1) / 2.0
    lat = np.degrees(yc / SINU_RADIUS_M)
    lon = np.degrees(xc / (SINU_RADIUS_M * np.cos(np.radians(lat))))
    return SyntheticSceneConfig(size=size, seed=SEED, center_lat=float(lat),
                                center_lon=float(lon),
                                pixel_size_m=(X1 - X0) / size, **kw)


@functools.lru_cache(maxsize=1)
def full_scene():
    """The bench scene on the tile's grid (its fire table for the full-size
    granule)."""
    return make_scene(tile_scene_config(**BENCH_SCENE))


def to_raw(aod: np.ndarray) -> np.ndarray:
    """MAIAC's int16 code of an AOD plane: ``round(aod × 1000)``, the fill
    where the scene holds no value."""
    raw = np.rint(aod.astype(np.float64) * 1000.0)
    return np.where(aod == NULL_VALUE, MAIAC_FILL, raw).astype(np.int16)


def later_orbits(raw0: np.ndarray, n: int, width: int) -> np.ndarray:
    """``n`` orbits: orbit 0 is ``raw0``; orbit k covers a diagonal band of
    ``width`` columns (its values ``raw0 + k``), fill elsewhere, as later
    MAIAC orbits cover part of a tile."""
    h, w = raw0.shape
    rows, cols = np.mgrid[0:h, 0:w]
    out = [raw0]
    for k in range(1, n):
        band = (cols - rows * 0.35 - (k * w // n - width // 2)) % w < width
        valid = band & (raw0 != MAIAC_FILL)
        out.append(np.where(valid, raw0 + k, MAIAC_FILL).astype(np.int16))
    return np.stack(out)


def small_raw(n: int) -> np.ndarray:
    """``n`` orbits of a 64 × 48 scene with holes (no retrieval) and a
    lattice of small negative codes (the product's valid range starts at
    −100; the reader nulls negatives)."""
    scene = make_scene(tile_scene_config(size=SMALL[0], null_blobs=2,
                                         null_blob_sigma=4.0))
    raw0 = to_raw(scene.granule.first_layer()[:, :SMALL[1]])
    raw0[::7, ::11] = np.where(raw0[::7, ::11] == MAIAC_FILL, MAIAC_FILL,
                               -50)
    return later_orbits(raw0, n, 20)


def fixtures() -> Dict[str, Fixture]:
    """Every fixture, by file name."""
    full_raw = later_orbits(to_raw(full_scene().granule.first_layer()), 4,
                            160)
    full_layers = [(t, i) for i, t in enumerate(FULL_STAMPS.split())]
    two = small_raw(2)
    two_stamps = "20172131535T  20172131710A "   # split noise, as real
    two_layers = [("20172131535T", 0), ("20172131710A", 1)]
    five = small_raw(5)
    rng = np.random.default_rng(SEED)
    extras = {
        "Optical_Depth_047": (two.astype(np.int32) * 11 // 10).clip(
            -28672, 5000).astype(np.int16),
        "AOD_Uncertainty": rng.integers(0, 4000, two.shape).astype(np.int16),
        "AOD_QA": rng.integers(0, 65535, two.shape).astype(np.uint16),
        "AOD_MODEL": rng.integers(0, 255, two.shape).astype(np.uint8),
        "Injection_Height": rng.normal(1500.0, 300.0,
                                       two.shape).astype(np.float32),
    }
    out = [
        Fixture(FULL_NAME + ".hdf", FULL_STAMPS, full_raw, "deflate",
                layers=full_layers, pad_metadata=True),
        Fixture("maiac_contiguous.hdf", two_stamps, two, "contiguous",
                layers=two_layers),
        Fixture("maiac_deflate.hdf", two_stamps, two, "deflate",
                layers=two_layers),
        Fixture("maiac_chunked.hdf", two_stamps, two, "chunked",
                chunks=(1, 20, 20), layers=two_layers),
        Fixture("maiac_chunked_deflate.hdf", two_stamps, two,
                "chunked_deflate", chunks=(1, 24, 28), layers=two_layers),
        Fixture("maiac_linked.hdf", two_stamps, two, "linked",
                layers=two_layers),
        Fixture("maiac_unwritten.hdf", "20172131710A", None, "unwritten",
                shape=(1,) + SMALL, layers=[("20172131710A", 0)]),
        Fixture("maiac_many_sds.hdf", two_stamps, two, "deflate",
                extra=extras, layers=two_layers),
        Fixture("maiac_five_orbits_aqua_third.hdf",
                "20172131215T 20172131355T 20172131530A 20172131710A "
                "20172131850T", five, "deflate",
                layers=[("20172131530A", 0)]),
        Fixture("maiac_five_orbits_terra.hdf",
                "20172131215T 20172131355T 20172131535T 20172131715T "
                "20172131855T", five, "deflate", error="Aqua"),
        Fixture("maiac_malformed_stamp.hdf", "20172131535T NOT_A_STAMP",
                two, "deflate", error="malformed orbit timestamp"),
        Fixture("maiac_skphuff.hdf", two_stamps, two, "skphuff",
                error="skipping Huffman coder"),
        Fixture("maiac_rle.hdf", two_stamps, two, "rle",
                error="RLE coder"),
        Fixture("maiac_external.hdf", two_stamps, two, "external",
                error="external file"),
        Fixture("maiac_truncated.hdf", FULL_STAMPS, None, "truncated",
                error="truncated", truncate_of=FULL_NAME + ".hdf"),
    ]
    return {f.file: f for f in out}


def expected_granule(fx: Fixture) -> Granule:
    """What a reader of the file returns: each listed orbit's raw codes ×
    0.001 in float32, negatives set to −999, on the grid of the tile's
    corners, named after the file."""
    layers = {}
    for stamp, i in fx.layers:
        raw = (fx.raw[i] if fx.raw is not None
               else np.full(fx.sds_shape[1:], MAIAC_FILL, np.int16))
        aod = raw.astype(np.float32) * AOD_SCALE
        aod[aod < 0] = NULL_VALUE
        layers[stamp] = aod
    ny, nx = fx.sds_shape[1:]
    lat, lon = grid_from_extent(float(f"{X0:.6f}"), float(f"{Y0:.6f}"),
                                float(f"{X1:.6f}"), float(f"{Y1:.6f}"),
                                ny, nx)
    return Granule(layers=layers, lat=lat, lon=lon, name=fx.name)


def write(fx: Fixture, out_dir: str, lib) -> str:
    """Store one fixture through the C library (``lib``: the
    ``tests/torch_hdf4_lib.py`` binding); returns its path. The library
    records the path it is given (the SD vgroup's name, an external
    element's file), so it is given bare names from inside ``out_dir``."""
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        _write(fx, lib)
    finally:
        os.chdir(cwd)
    return os.path.join(out_dir, fx.file)


def _write(fx: Fixture, lib) -> None:
    if fx.truncate_of:
        with open(fx.truncate_of, "rb") as f:
            head = f.read(TRUNCATED_BYTES)
        with open(fx.file, "wb") as f:
            f.write(head)
        return
    ext = fx.name + ".dat"
    with lib.Writer(fx.file) as w:
        w.attr("Orbit_time_stamp", fx.stamps)
        w.attr("StructMetadata.0", struct_metadata(*fx.sds_shape[1:],
                                                   pad=fx.pad_metadata))
        # one extra SDS ahead of Optical_Depth_055, the rest after it, so
        # that selection by name is exercised
        for name, arr in list(fx.extra.items())[:1]:
            w.sds(name, arr, storage="deflate")
        w.sds("Optical_Depth_055", fx.raw, shape=fx.sds_shape,
              nt=lib.DFNT_INT16, storage=fx.storage, chunks=fx.chunks,
              fill=MAIAC_FILL, block_size=1024, external=ext,
              attrs={"scale_factor": 0.001, "add_offset": 0.0,
                     "long_name": "AOD at 0.55 micron"})
        for name, arr in list(fx.extra.items())[1:]:
            w.sds(name, arr, storage="deflate")
    if os.path.exists(ext):
        os.remove(ext)         # the reader must refuse, not follow it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_hdf4_lib as lib

    if not lib.available():
        print("the HDF4 C library (libdfalt.so.0, libmfhdfalt.so.0) is not "
              "installed; the fixtures cannot be written here",
              file=sys.stderr)
        return 1
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    total = 0
    for fx in fixtures().values():
        path = write(fx, args.out, lib)
        size = os.path.getsize(path)
        total += size
        print(f"{fx.file}: {size} bytes, Optical_Depth_055 "
              f"{fx.sds_shape} {fx.storage}")
    print(f"{total} bytes in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
