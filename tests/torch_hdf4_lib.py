"""The HDF4 C library (``libdfalt`` / ``libmfhdfalt``, the "alt" build of
HDF 4.2) through ctypes, for the tests of ``plumekit_torch/io/hdf4.py`` and
for ``tools/make_maiac_fixtures.py``: the reference implementation of the
format writes the files the port's reader is held against, and reads them
back.

* :class:`Writer` writes an SD file: global attributes, and SDSs stored
  contiguous, compressed (deflate, skipping Huffman, RLE), chunked (plain or
  deflated chunks), as linked blocks (an unlimited first dimension written
  in two appends), external, or never written;
* :class:`SD` is a ``pyhdf.SD.SD``-shaped shim (``SD(path, mode)``,
  ``attributes(full=1)`` giving ``(value, index, type, count)``,
  ``select(name)[i, :, :]``, ``datasets()``) on ``SDfileinfo``,
  ``SDattrinfo``, ``SDreadattr``, ``SDselect``, ``SDgetinfo`` and
  ``SDreaddata``. :func:`pyhdf_modules` wraps it as the ``pyhdf`` and
  ``pyhdf.SD`` modules, so that the JAX package's ``read_maiac_hdf4`` runs
  unchanged on real files.

A char8 attribute reads as its bytes in latin-1 with trailing NULs trimmed,
as the port's reader gives it. No test file itself.
"""

from __future__ import annotations

import ctypes
import types
from typing import Optional

import numpy as np

DFACC_READ, DFACC_CREATE = 1, 4
DFNT_CHAR8, DFNT_FLOAT32, DFNT_FLOAT64 = 4, 5, 6
DFNT_INT8, DFNT_UINT8, DFNT_INT16, DFNT_UINT16 = 20, 21, 22, 23
DFNT_INT32, DFNT_UINT32 = 24, 25
DFNT_LITEND = 0x4000
COMP_CODE_RLE, COMP_CODE_SKPHUFF, COMP_CODE_DEFLATE = 1, 3, 4
HDF_CHUNK, HDF_COMP = 1, 3
SD_UNLIMITED = 0
MAX_VAR_DIMS = 32

#: numpy kind of each number type (the low byte of the code)
KINDS = {DFNT_CHAR8: "S1", DFNT_FLOAT32: "f4", DFNT_FLOAT64: "f8",
         DFNT_INT8: "i1", DFNT_UINT8: "u1", DFNT_INT16: "i2",
         DFNT_UINT16: "u2", DFNT_INT32: "i4", DFNT_UINT32: "u4"}

_LIBS = []


def _libs():
    """(libdfalt, libmfhdfalt), loaded once: libdfalt first and global, or
    libmfhdfalt fails on ``error_top``."""
    if not _LIBS:
        df = ctypes.CDLL("libdfalt.so.0", mode=ctypes.RTLD_GLOBAL)
        mf = ctypes.CDLL("libmfhdfalt.so.0", mode=ctypes.RTLD_GLOBAL)
        df.HEstring.restype = ctypes.c_char_p
        _LIBS.extend([df, mf])
    return _LIBS


def available() -> bool:
    try:
        _libs()
    except OSError:
        return False
    return True


def nt_of(dtype, litend: bool = False) -> int:
    dtype = np.dtype(dtype)
    code = next(c for c, k in KINDS.items()
                if np.dtype(k) == dtype.newbyteorder("="))
    return code | (DFNT_LITEND if litend else 0)


def dtype_of(nt: int) -> np.dtype:
    return np.dtype(KINDS[nt & 0xFF])


def _ints(*values):
    return (ctypes.c_int32 * max(1, len(values)))(*values)


class _ChunkDef(ctypes.Structure):
    """``HDF_CHUNK_DEF``, passed by value: 32 chunk lengths, then the
    compression type, model and coder info."""
    _fields_ = [("v", ctypes.c_int32 * 64)]


def _check(rc, what):
    if rc < 0:
        df, _ = _libs()
        raise RuntimeError(f"{what} failed: "
                           f"{df.HEstring(df.HEvalue(1)).decode()}")
    return rc


def _set_attr(mf, obj_id, name: str, value, nt: Optional[int] = None):
    if isinstance(value, (str, bytes)):
        raw = value.encode("latin-1") if isinstance(value, str) else value
        _check(mf.SDsetattr(obj_id, name.encode(), DFNT_CHAR8, len(raw),
                            raw), f"SDsetattr {name}")
        return
    arr = np.atleast_1d(np.asarray(value))
    if nt is None:
        nt = nt_of(arr.dtype)
    arr = np.ascontiguousarray(arr.astype(dtype_of(nt)))
    _check(mf.SDsetattr(obj_id, name.encode(), nt, arr.size,
                        arr.ctypes.data_as(ctypes.c_void_p)),
           f"SDsetattr {name}")


class Writer:
    """One SD file, created at ``path`` (``with Writer(path) as w: ...``)."""

    def __init__(self, path: str):
        self.df, self.mf = _libs()
        self.path = str(path)
        self.sd = _check(self.mf.SDstart(self.path.encode(), DFACC_CREATE),
                         f"SDstart {path}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.sd is not None:
            _check(self.mf.SDend(self.sd), "SDend")
            self.sd = None

    def attr(self, name: str, value, nt: Optional[int] = None):
        _set_attr(self.mf, self.sd, name, value, nt)

    def sds(self, name: str, data: Optional[np.ndarray] = None,
            shape=None, nt: Optional[int] = None, storage: str = "contiguous",
            level: int = 6, chunks=None, fill=None, attrs=None,
            block_size: int = 0, external: Optional[str] = None):
        """Write one SDS. ``storage``: ``contiguous``, ``deflate``,
        ``skphuff``, ``rle``, ``chunked``, ``chunked_deflate`` (``chunks``
        lengths), ``linked`` (an unlimited first dimension written in two
        appends; ``block_size`` sets the blocks), ``external`` (the data in
        the file ``external``) or ``unwritten`` (``shape``, no data)."""
        mf = self.mf
        if data is not None:
            data = np.asarray(data)
            shape = data.shape
        if nt is None:
            nt = nt_of(data.dtype)
        dims = list(shape)
        if storage == "linked":
            dims[0] = SD_UNLIMITED
        sds = _check(mf.SDcreate(self.sd, name.encode(), nt, len(dims),
                                 _ints(*dims)), f"SDcreate {name}")
        try:
            if fill is not None:
                f = np.asarray([fill], dtype_of(nt))
                _check(mf.SDsetfillvalue(sds, f.ctypes.data_as(
                    ctypes.c_void_p)), "SDsetfillvalue")
            if storage in ("deflate", "skphuff", "rle"):
                code = {"deflate": COMP_CODE_DEFLATE, "rle": COMP_CODE_RLE,
                        "skphuff": COMP_CODE_SKPHUFF}[storage]
                info = _ints(*([level] if storage == "deflate" else
                               [np.dtype(dtype_of(nt)).itemsize]
                               if storage == "skphuff" else [0]), 0, 0, 0)
                _check(mf.SDsetcompress(sds, code, info), "SDsetcompress")
            elif storage in ("chunked", "chunked_deflate"):
                cdef = _ChunkDef()
                for k, c in enumerate(chunks):
                    cdef.v[k] = c
                flags = HDF_CHUNK
                if storage == "chunked_deflate":
                    cdef.v[MAX_VAR_DIMS] = COMP_CODE_DEFLATE
                    cdef.v[MAX_VAR_DIMS + 2] = level
                    flags = HDF_COMP
                _check(mf.SDsetchunk(sds, cdef, flags), "SDsetchunk")
            elif storage == "linked" and block_size:
                _check(mf.SDsetblocksize(sds, block_size), "SDsetblocksize")
            elif storage == "external":
                _check(mf.SDsetexternalfile(sds, external.encode(), 0),
                       "SDsetexternalfile")
            for k, v in (attrs or {}).items():
                _set_attr(mf, sds, k, v)
            if storage == "linked":
                half = max(1, shape[0] // 2)
                self._write(sds, data[:half], 0)
                _check(mf.SDendaccess(sds), "SDendaccess")
                sds = _check(mf.SDselect(self.sd, mf.SDnametoindex(
                    self.sd, name.encode())), "SDselect")
                self._write(sds, data[half:], half)
            elif storage != "unwritten" and data is not None:
                self._write(sds, data, 0)
        finally:
            _check(mf.SDendaccess(sds), "SDendaccess")

    def _write(self, sds, data, first):
        data = np.ascontiguousarray(data)
        if data.shape[0] == 0:
            return
        start = [first] + [0] * (data.ndim - 1)
        _check(self.mf.SDwritedata(sds, _ints(*start), None,
                                   _ints(*data.shape),
                                   data.ctypes.data_as(ctypes.c_void_p)),
               "SDwritedata")


def _read_attr(mf, obj_id, index):
    name = ctypes.create_string_buffer(256)
    nt, count = ctypes.c_int32(), ctypes.c_int32()
    _check(mf.SDattrinfo(obj_id, index, name, ctypes.byref(nt),
                         ctypes.byref(count)), "SDattrinfo")
    dtype = dtype_of(nt.value)
    buf = ctypes.create_string_buffer(dtype.itemsize * count.value + 1)
    _check(mf.SDreadattr(obj_id, index, buf), "SDreadattr")
    raw = buf.raw[:dtype.itemsize * count.value]
    if nt.value & 0xFF == DFNT_CHAR8:
        value = raw.rstrip(b"\0").decode("latin-1")
    else:
        values = np.frombuffer(raw, dtype)
        value = values[0].item() if values.size == 1 else values.tolist()
    return name.value.decode(), value, nt.value, count.value


class _SDS:
    def __init__(self, mf, sds):
        self.mf, self.id = mf, sds
        name = ctypes.create_string_buffer(256)
        rank, nt, nattrs = (ctypes.c_int32() for _ in range(3))
        dims = (ctypes.c_int32 * MAX_VAR_DIMS)()
        _check(mf.SDgetinfo(sds, name, ctypes.byref(rank), dims,
                            ctypes.byref(nt), ctypes.byref(nattrs)),
               "SDgetinfo")
        self.name = name.value.decode()
        self.shape = tuple(dims[:rank.value])
        self.nt = nt.value
        self.nattrs = nattrs.value

    def get(self) -> np.ndarray:
        out = np.empty(self.shape, dtype_of(self.nt))
        _check(self.mf.SDreaddata(self.id, _ints(*[0] * len(self.shape)),
                                  None, _ints(*self.shape),
                                  out.ctypes.data_as(ctypes.c_void_p)),
               f"SDreaddata {self.name}")
        return out

    def attributes(self):
        return {n: v for n, v, _, _ in (
            _read_attr(self.mf, self.id, i) for i in range(self.nattrs))}

    def __getitem__(self, key):
        return self.get()[key]

    def endaccess(self):
        self.mf.SDendaccess(self.id)


class SD:
    """``pyhdf.SD.SD`` on the C library, read-only."""

    def __init__(self, path, mode=DFACC_READ):
        _, self.mf = _libs()
        self.path = str(path)
        self.sd = _check(self.mf.SDstart(self.path.encode(), DFACC_READ),
                         f"SDstart {path}")
        n, natt = ctypes.c_int32(), ctypes.c_int32()
        _check(self.mf.SDfileinfo(self.sd, ctypes.byref(n),
                                  ctypes.byref(natt)), "SDfileinfo")
        self.ndatasets, self.nattrs = n.value, natt.value
        self._open = []

    def attributes(self, full=0):
        out = {}
        for i in range(self.nattrs):
            name, value, nt, count = _read_attr(self.mf, self.sd, i)
            out[name] = (value, i, nt, count) if full else value
        return out

    def datasets(self):
        names = []
        for i in range(self.ndatasets):
            s = _SDS(self.mf, _check(self.mf.SDselect(self.sd, i),
                                     "SDselect"))
            names.append(s.name)
            s.endaccess()
        return names

    def select(self, name):
        index = self.mf.SDnametoindex(self.sd, name.encode())
        if index < 0:
            raise KeyError(f"{self.path}: no SDS {name!r}")
        s = _SDS(self.mf, _check(self.mf.SDselect(self.sd, index),
                                 "SDselect"))
        self._open.append(s)
        return s

    def end(self):
        if self.sd is not None:
            for s in self._open:
                s.endaccess()
            self.mf.SDend(self.sd)
            self.sd = None

    def __del__(self):
        try:
            self.end()
        except Exception:
            pass


def pyhdf_modules():
    """(``pyhdf``, ``pyhdf.SD``) modules whose ``SD`` is this shim, to be
    put in ``sys.modules``."""
    sd_mod = types.ModuleType("pyhdf.SD")
    sd_mod.SD = SD
    sd_mod.SDC = types.SimpleNamespace(READ=DFACC_READ)
    pkg = types.ModuleType("pyhdf")
    pkg.SD = sd_mod
    return pkg, sd_mod
