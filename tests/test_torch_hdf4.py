"""The port's HDF4 reader (``plumekit_torch/io/hdf4.py``) against the HDF4
C library, the format's reference implementation: files the library writes
(every storage form it has for an SDS, every number type, both byte
orders, random shapes) read by the port equal what ``SDreaddata`` and
``SDreadattr`` read from them, and every structure the port does not take
fails with a named ``ValueError``.

Tests that write or read through the library skip where it is absent
(``tests/torch_hdf4_lib.py``); the committed fixtures are read everywhere
in tests/test_torch_maiac_reader.py."""

import ctypes
import os
import sys
import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from plumekit_torch.io.hdf4 import DFTAG_VH, SDFile

sys.path.insert(0, os.path.dirname(__file__))
import torch_hdf4_lib as lib  # noqa: E402

needs_lib = pytest.mark.skipif(not lib.available(),
                               reason="needs the HDF4 C library "
                                      "(libdfalt.so.0, libmfhdfalt.so.0)")

DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "float32",
          "float64"]
STORAGES = ["contiguous", "deflate", "chunked", "chunked_deflate", "linked",
            "unwritten"]


def _data(rng, shape, dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return (rng.standard_normal(shape) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


def _write_one(path, data, storage, litend=False, chunks=None, fill=None,
               shape=None, dtype=None):
    nt = lib.nt_of(data.dtype if data is not None else dtype, litend)
    shape = data.shape if data is not None else shape
    chunks = chunks or tuple(max(1, (d + 2) // 3) for d in shape)
    with lib.Writer(path) as w:
        w.attr("title", "one SDS")
        w.sds("values", data, shape=shape, nt=nt, storage=storage,
              chunks=chunks, fill=fill, block_size=64)


def _library(path, name="values"):
    sd = lib.SD(path)
    try:
        return sd.select(name).get()
    finally:
        sd.end()


def _assert_same(got, want):
    """Same dtype, shape and bytes (NaNs and signed zeros included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@needs_lib
@pytest.mark.parametrize("litend", [False, True], ids=["big", "little"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("storage", STORAGES)
def test_every_storage_form_and_number_type(tmp_path, storage, dtype,
                                            litend):
    """Bit for bit what the library reads back, the storage form named as
    written; a never-written SDS reads as the type's default fill."""
    rng = np.random.default_rng(len(storage) * 31 + DTYPES.index(dtype))
    path = str(tmp_path / "f.hdf")
    data = None if storage == "unwritten" else _data(rng, (5, 7, 6), dtype)
    _write_one(path, data, storage, litend, chunks=(2, 3, 4),
               shape=(5, 7, 6), dtype=dtype)
    with SDFile(path) as f:
        sds = f.select("values")
        assert sds.storage == {"contiguous": "contiguous",
                               "deflate": "compressed (deflate)",
                               "chunked": "chunked",
                               "chunked_deflate": "chunked",
                               "linked": "linked blocks",
                               "unwritten": "unwritten"}[storage]
        got = sds.get()
    _assert_same(got, _library(path))


@needs_lib
@pytest.mark.parametrize("storage", ["chunked", "chunked_deflate",
                                     "unwritten", "contiguous"])
def test_fill_value_where_nothing_was_written(tmp_path, storage):
    """A _FillValue set, then a partial write: unwritten chunks (and the
    rest of a contiguous element) read as the fill, as the library's."""
    path = str(tmp_path / "f.hdf")
    with lib.Writer(path) as w:
        sds_id = w.mf.SDcreate(w.sd, b"values", lib.DFNT_INT16, 3,
                               lib._ints(3, 10, 9))
        fill = np.asarray([-28672], np.int16)
        w.mf.SDsetfillvalue(sds_id, fill.ctypes.data_as(ctypes.c_void_p))
        if storage.startswith("chunked"):
            cdef = lib._ChunkDef()
            cdef.v[0], cdef.v[1], cdef.v[2] = 1, 4, 4
            flags = lib.HDF_CHUNK
            if storage == "chunked_deflate":
                cdef.v[lib.MAX_VAR_DIMS] = lib.COMP_CODE_DEFLATE
                cdef.v[lib.MAX_VAR_DIMS + 2] = 4
                flags = lib.HDF_COMP
            assert w.mf.SDsetchunk(sds_id, cdef, flags) == 0
        if storage != "unwritten":
            part = np.arange(2 * 5 * 5, dtype=np.int16).reshape(2, 5, 5)
            assert w.mf.SDwritedata(
                sds_id, lib._ints(1, 2, 3), None, lib._ints(*part.shape),
                part.ctypes.data_as(ctypes.c_void_p)) == 0
        w.mf.SDendaccess(sds_id)
    with SDFile(path) as f:
        got = f.select("values").get()
    want = _library(path)
    _assert_same(got, want)
    assert (got == -28672).sum() > 0


@needs_lib
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_random_shapes_and_rows(tmp_path_factory, data):
    """Rank 1 to 3, any number type, any storage, ragged chunks: the whole
    SDS and row slices equal the library's and numpy's indexing."""
    rank = data.draw(st.integers(1, 3))
    shape = tuple(data.draw(st.lists(st.integers(1, 9), min_size=rank,
                                     max_size=rank)))
    dtype = data.draw(st.sampled_from(DTYPES))
    storage = data.draw(st.sampled_from(STORAGES[:-1]))
    litend = data.draw(st.booleans())
    chunks = tuple(data.draw(st.integers(1, d)) for d in shape)
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
    path = str(tmp_path_factory.mktemp("h") / "f.hdf")
    arr = _data(rng, shape, dtype)
    _write_one(path, arr, storage, litend, chunks=chunks)
    want = _library(path)
    np.testing.assert_array_equal(want, arr)
    lo = data.draw(st.integers(0, shape[0] - 1))
    hi = data.draw(st.integers(lo + 1, shape[0]))
    with SDFile(path) as f:
        sds = f.select("values")
        _assert_same(sds.get(), want)
        _assert_same(sds[lo], want[lo])
        _assert_same(sds[lo:hi], want[lo:hi])
        _assert_same(sds[-1], want[-1])
        _assert_same(sds[lo:hi:2], want[lo:hi:2])


@needs_lib
def test_row_reads_and_indexing(tmp_path):
    """``sds[i, :, :]`` as the MAIAC reader asks, and numpy's other keys."""
    rng = np.random.default_rng(3)
    arr = _data(rng, (4, 9, 8), "int16")
    for storage in ("contiguous", "deflate", "chunked_deflate", "linked"):
        path = str(tmp_path / f"{storage}.hdf")
        _write_one(path, arr, storage, chunks=(1, 4, 3))
        with SDFile(path) as f:
            sds = f.select("values")
            for i in (3, 0, 2, 1, -1):    # out of order: resumed inflation
                _assert_same(sds[i, :, :], arr[i])
            _assert_same(sds[..., 3], arr[..., 3])
            _assert_same(sds[1:3, 2:5, ::2], arr[1:3, 2:5, ::2])
            _assert_same(sds[[0, 2]], arr[[0, 2]])
            with pytest.raises(IndexError):
                sds[4]


@needs_lib
def test_attributes_of_every_type(tmp_path):
    """Global and SDS attributes, one value and several, every number type
    and byte order, and char8 text with NULs and latin-1 bytes: equal to
    what ``SDreadattr`` gives (text trimmed of trailing NULs)."""
    path = str(tmp_path / "a.hdf")
    values = {f"{d}_{n}_{o}": (np.arange(1, n + 1) * 3 - 2).astype(d)
              for d in DTYPES for n in (1, 4) for o in ("b", "l")}
    with lib.Writer(path) as w:
        for k, v in values.items():
            w.attr(k, v, nt=lib.nt_of(v.dtype, k.endswith("_l")))
        w.attr("text", "Orbit 20172131535T\tcaf\xe9 \0\0\0")
        w.attr("inner_nul", "a\0b")
        w.attr("StructMetadata.0", "GROUP=GridStructure\n" * 1500)
        w.sds("values", np.ones((2, 3), np.float32),
              attrs={"scale_factor": 0.001, "long_name": "AOD",
                     "valid_range": np.asarray([-100, 5000], np.int16)})
    ref = lib.SD(path)
    want = ref.attributes()
    want_sds = ref.select("values").attributes()
    ref.end()
    with SDFile(path) as f:
        got = f.attributes()
        got_sds = f.select("values").attributes()
    assert got == want
    assert got_sds == want_sds
    assert got["text"] == "Orbit 20172131535T\tcaf\xe9 "
    assert got["int16_4_l"] == [1, 4, 7, 10]


@needs_lib
def test_datasets_and_selection_by_name(tmp_path):
    path = str(tmp_path / "m.hdf")
    names = ["Optical_Depth_047", "Optical_Depth_055", "AOD_Uncertainty",
             "AOD_QA", "Column_WV"]
    rng = np.random.default_rng(5)
    arrays = {n: _data(rng, (2, 6, 5), "uint16" if n == "AOD_QA"
                       else "int16") for n in names}
    with lib.Writer(path) as w:
        for n in names:
            w.sds(n, arrays[n], storage="deflate")
    ref = lib.SD(path)
    want = ref.datasets()
    ref.end()
    with SDFile(path) as f:
        assert f.datasets() == want == names
        for n in names:
            _assert_same(f.select(n)[1, :, :], arrays[n][1])
        with pytest.raises(ValueError, match="no SDS named 'Optical_Depth'"):
            f.select("Optical_Depth")


def _set_version4(path):
    """Attach an attribute to the first Attr0.0 vdata and to the SD
    vgroup through the library's V interface: both headers become
    version 4 (flags and attribute references after the extension
    pair)."""
    df, _ = lib._libs()
    fid = df.Hopen(path.encode(), 3, 0)
    assert fid >= 0 and df.Vinitialize(fid) >= 0     # Vstart
    vs_ref = df.VSfind(fid, b"title")
    vs = df.VSattach(fid, vs_ref, b"w")
    assert df.VSsetattr(vs, -1, b"note", lib.DFNT_CHAR8, 3, b"abc") == 0
    df.VSdetach(vs)
    vg_ref = df.Vfind(fid, b"values")
    vg = df.Vattach(fid, vg_ref, b"w")
    assert df.Vsetattr(vg, b"note", lib.DFNT_CHAR8, 3, b"xyz") == 0
    df.Vdetach(vg)
    df.Vfinish(fid)                                  # Vend
    df.Hclose(fid)


@needs_lib
def test_version_4_vdata_and_vgroup_headers(tmp_path):
    path = str(tmp_path / "v4.hdf")
    arr = np.arange(30, dtype=np.int16).reshape(5, 6)
    _write_one(path, arr, "deflate")
    _set_version4(path)
    with SDFile(path) as f:
        versions = {v.name: v.version for v in f._vgroups.values()}
        assert versions["values"] == 4
        assert f._vdata(next(r for t, r in f._dds if t == DFTAG_VH
                             and f._vdata(r).name == "title")).version == 4
        assert f.attributes() == {"title": "one SDS"}
        _assert_same(f.select("values").get(), arr)
    _assert_same(_library(path), arr)


@needs_lib
@pytest.mark.parametrize("storage,message", [
    ("skphuff", "skipping Huffman coder"), ("rle", "RLE coder"),
    ("external", "external file 'data.bin'")])
def test_unsupported_storage_is_a_named_error(tmp_path, storage, message):
    """Coders other than deflate, and data in another file: the library
    reads them, the port names what it does not take."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with lib.Writer("f.hdf") as w:
            w.sds("values", np.arange(60, dtype=np.int16).reshape(3, 4, 5),
                  storage=storage, external="data.bin")
        with SDFile("f.hdf") as f:
            with pytest.raises(ValueError, match=message) as e:
                f.select("values").get()
    finally:
        os.chdir(cwd)
    assert "f.hdf" in str(e.value)


@needs_lib
@pytest.mark.parametrize("share", [0.002, 0.05, 0.3, 0.6, 0.85, 0.97])
def test_a_file_cut_short_is_a_named_error(tmp_path, share):
    """Any prefix of a file fails with a ValueError naming the file and an
    offset, at open or at the read, never with another exception."""
    path = str(tmp_path / "whole.hdf")
    rng = np.random.default_rng(1)
    _write_one(path, _data(rng, (3, 40, 30), "int16"), "deflate")
    with open(path, "rb") as f:
        whole = f.read()
    cut = str(tmp_path / "cut.hdf")
    with open(cut, "wb") as f:
        f.write(whole[:int(len(whole) * share)])
    with pytest.raises(ValueError, match=r"cut\.hdf: .*(offset|HDF4)"):
        with SDFile(cut) as f:
            f.select("values").get()


def test_not_an_hdf4_file(tmp_path):
    for name, content in (("empty.hdf", b""),
                          ("npz.hdf", b"PK\x03\x04" + bytes(64)),
                          ("short.hdf", b"\x0e\x03")):
        p = tmp_path / name
        p.write_bytes(content)
        with pytest.raises(ValueError, match=f"{name}: not an HDF4 file"):
            SDFile(str(p))


def test_a_file_without_the_sd_model(tmp_path):
    """The magic and one empty DD block: no CDF0.0 vgroup."""
    p = tmp_path / "bare.hdf"
    p.write_bytes(b"\x0e\x03\x13\x01" + np.asarray([0], ">i2").tobytes()
                  + np.asarray([0], ">i4").tobytes())
    with pytest.raises(ValueError, match="no SD model"):
        SDFile(str(p))


def test_a_looping_dd_chain(tmp_path):
    p = tmp_path / "loop.hdf"
    p.write_bytes(b"\x0e\x03\x13\x01" + np.asarray([0], ">i2").tobytes()
                  + np.asarray([4], ">i4").tobytes())
    with pytest.raises(ValueError, match="loops at offset 4"):
        SDFile(str(p))


@needs_lib
def test_threads_each_with_their_own_file(tmp_path):
    """No global state: four threads reading the same file at once, each
    through its own SDFile, read what one reads alone."""
    path = str(tmp_path / "t.hdf")
    rng = np.random.default_rng(2)
    arr = _data(rng, (4, 64, 48), "int16")
    _write_one(path, arr, "deflate")
    results, errors = {}, []

    def read(k):
        try:
            with SDFile(path) as f:
                results[k] = [f.select("values")[i, :, :] for i in range(4)]
        except Exception as e:       # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=read, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == 4
    for layers in results.values():
        for i, layer in enumerate(layers):
            _assert_same(layer, arr[i])
