"""A read-only HDF4 reader for the files the HDF4 SD interface writes, in
numpy, ``struct``, ``mmap`` and ``zlib`` alone: the port's stand-in for
``pyhdf.SD``, as :mod:`plumekit_torch.io.tables` is its stand-in for pandas.

It follows the public "HDF Specification and Developer's Guide" (HDF 4.2):

* the magic ``0e 03 13 01`` and the chain of DD blocks (big-endian
  ``ndds:int16, next:int32``, then 12-byte ``tag, ref, offset, length``
  entries; DFTAG_NULL and entries with offset or length -1 are skipped);
* Vgroups (1965) and Vdata headers and records (1962, 1963);
* the SD model: the file's ``CDF0.0`` vgroup, one ``Var0.0`` vgroup per SDS
  named after it, its NDG (720) to SDD (701: rank, dims, number type) and
  NT (106), and ``Attr0.0`` vdatas for the attributes;
* the number types int8/16/32, uint8/16/32, float32/64 and char8, big-endian
  unless the type carries DFNT_LITEND (``0x4000``) or the NT record names
  the little-endian class.

An SDS's data element (702) is contiguous or special (``tag | 0x4000``):
compressed (``SPECIAL_COMP``, deflate only: other coders raise), chunked
(``SPECIAL_CHUNKED``: a chunk table vdata, each chunk plain or compressed,
chunks never written read as the fill value), linked blocks
(``SPECIAL_LINKED``) or external (``SPECIAL_EXT``, which raises: the data
lives in another file). An SDS whose data was never written reads as its
fill value, as the C library returns it. Every malformed, truncated or
unsupported structure raises :class:`ValueError` naming the file and the
offset.

No global state: each :class:`SDFile` owns its mapping of the file, so
threads that each open their own file (``io/prefetch.decode_pool``) never
share one. An instance is not meant to be shared between threads.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"\x0e\x03\x13\x01"

# tags (HDF Specification, chapter 9)
DFTAG_NULL = 1
DFTAG_LINKED = 20
DFTAG_COMPRESSED = 40
DFTAG_SDD = 701
DFTAG_SD = 702
DFTAG_NDG = 720
DFTAG_VH = 1962
DFTAG_VS = 1963
DFTAG_VG = 1965
SPECIAL_BIT = 0x4000

# special element codes: the first int16 of a special element's header
SPECIAL_LINKED = 1
SPECIAL_EXT = 2
SPECIAL_COMP = 3
SPECIAL_CHUNKED = 5
SPECIAL_NAMES = {1: "linked blocks", 2: "external", 3: "compressed",
                 4: "variable-length linked blocks", 5: "chunked",
                 6: "buffered", 7: "compressed raster"}

COMP_MODEL_STDIO = 0
COMP_CODE_DEFLATE = 4
CODER_NAMES = {0: "none", 1: "RLE", 2: "n-bit", 3: "skipping Huffman",
               4: "deflate", 5: "szip", 7: "JPEG"}

# number types: the low byte of the code, and the numpy kind of each
DFNT_LITEND = 0x4000
DFNT_NATIVE = 0x1000
NUMBER_TYPES = {3: "u1", 4: "S1", 5: "f4", 6: "f8", 20: "i1", 21: "u1",
                22: "i2", 23: "u2", 24: "i4", 25: "u4"}
# the NT record's class byte: 1 is big-endian (IEEE floats, MBO integers),
# 4 is little-endian (PC floats, IBO integers)
NT_CLASS_ORDER = {1: ">", 4: "<"}

# the fill value the SD interface reads for a never-written SDS without a
# _FillValue attribute: netCDF's defaults by the type's netCDF class, the
# unsigned types taking the bits of their signed class's value
DEFAULT_FILL = {3: 129, 4: 0, 5: 9.9692099683868690e+36,
                6: 9.9692099683868690e+36, 20: -127, 21: 129, 22: -32767,
                23: 32769, 24: -2147483647, 25: 2147483649}


class _Cursor:
    """Big-endian fields of one structure, each read checked against the
    structure's end: a short structure raises with the file and offset."""

    def __init__(self, data: bytes, path: str, offset: int, what: str):
        self.data, self.path, self.base, self.what = data, path, offset, what
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(
                f"{self.path}: truncated or corrupt {self.what} at offset "
                f"{self.base + self.pos}: needs {n} byte(s), "
                f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))

    def u16(self) -> int:
        return self.unpack("H")[0]

    def i16(self) -> int:
        return self.unpack("h")[0]

    def i32(self) -> int:
        return self.unpack("i")[0]

    def text(self) -> str:
        return self.take(self.u16()).decode("latin-1")


def _dtype(code: int, path: str, where: str) -> np.dtype:
    """The numpy dtype, in the file's byte order, of an HDF number type
    code as vdata fields and attributes carry it."""
    if code & DFNT_NATIVE:
        raise ValueError(f"{path}: {where} has the native number type "
                         f"{code:#x}, which this reader does not take")
    kind = NUMBER_TYPES.get(code & 0xFF)
    if kind is None or code & ~(0xFF | DFNT_LITEND):
        raise ValueError(f"{path}: {where} has the unsupported number type "
                         f"{code:#x}")
    return np.dtype(("<" if code & DFNT_LITEND else ">") + kind)


@dataclass
class VGroup:
    ref: int
    name: str
    cls: str
    children: List[Tuple[int, int]]
    version: int


@dataclass
class VDataField:
    name: str
    dtype: np.dtype
    isize: int
    offset: int
    order: int


@dataclass
class VData:
    ref: int
    name: str
    cls: str
    interlace: int
    nvert: int
    ivsize: int
    fields: List[VDataField]
    version: int


def _trailer_version(cur: _Cursor) -> int:
    """The ``version`` of a vgroup or vdata header: the C library ends both
    with ``version:uint16, more:uint16`` and one NUL byte. Between the
    extension pair and that trailer, a vdata header repeats version and
    more, and version 4 adds flags and attribute references (vgroup and
    vdata attributes, which the SD model does not use). Only the fields
    before the extension pair are read; they are laid out alike in
    versions 2 to 4."""
    rest = cur.data[cur.pos:]
    if len(rest) >= 5 and rest[-1] == 0:
        return struct.unpack(">H", rest[-5:-3])[0]
    if len(rest) >= 4:
        return struct.unpack(">H", rest[-4:-2])[0]
    raise ValueError(f"{cur.path}: truncated {cur.what} at offset "
                     f"{cur.base + cur.pos}: no version field")


class SDS:
    """One scientific dataset: ``sds[i, :, :]`` reads the rows asked for
    (contiguous, linked and chunked storage read those rows' bytes only,
    a deflate stream is inflated no further than their end)."""

    def __init__(self, sd: "SDFile", name: str, shape: Tuple[int, ...],
                 code: int, dtype: np.dtype,
                 data: Optional[Tuple[int, int]], attrs: Dict[str, object]):
        self._sd = sd
        self.name = name
        self.shape = shape
        self._file_dtype = dtype
        self.dtype = dtype.newbyteorder("=")
        self._data = data
        self._attrs = attrs
        self._chunks = None
        fill = attrs.get("_FillValue", DEFAULT_FILL[code])
        if dtype.kind == "S":
            fill = fill.encode("latin-1")[:1] if isinstance(fill, str) \
                else bytes([fill & 0xFF])
        self.fill_value = np.asarray(fill).astype(self.dtype)[()]

    def attributes(self) -> Dict[str, object]:
        return dict(self._attrs)

    @property
    def storage(self) -> str:
        """``contiguous``, ``unwritten``, or the special element's kind
        (``compressed (deflate)``, ``chunked``, ``linked blocks``, ...)."""
        if self._data is None:
            return "unwritten"
        code, header = self._sd._special(*self._data)
        if code is None:
            return "contiguous"
        if code == SPECIAL_COMP:
            return f"compressed ({CODER_NAMES.get(header[4], header[4])})"
        return SPECIAL_NAMES.get(code, f"special {code}")

    def get(self) -> np.ndarray:
        return self[...]

    def __getitem__(self, key) -> np.ndarray:
        if not isinstance(key, tuple):
            key = (key,)
        n = self.shape[0] if self.shape else 0
        first = key[0] if key and key[0] is not Ellipsis else None
        if isinstance(first, (int, np.integer)):
            i = int(first) + (n if first < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {first} out of range for "
                                 f"{self.name} of shape {self.shape}")
            return self._rows(i, i + 1)[(0,) + key[1:]]
        if isinstance(first, slice):
            lo, hi, step = first.indices(n)
            if step > 0 and hi > lo:
                return self._rows(lo, hi)[
                    (slice(0, hi - lo, step),) + key[1:]]
        return self._rows(0, n)[key]

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows ``lo:hi`` of the first axis, native byte order."""
        out_shape = (hi - lo,) + tuple(self.shape[1:])
        if self._data is None:
            return np.full(out_shape, self.fill_value, self.dtype)
        code, header = self._sd._special(*self._data)
        if code == SPECIAL_CHUNKED:
            arr = self._chunked_rows(header, lo, hi)
        else:
            row = int(np.prod(self.shape[1:], dtype=np.int64)) \
                * self._file_dtype.itemsize
            raw = self._sd._element_range(*self._data, lo * row, hi * row,
                                          f"SDS {self.name!r}")
            arr = np.frombuffer(raw, self._file_dtype).reshape(out_shape)
        return arr.astype(self.dtype)

    def _chunked_rows(self, header, lo: int, hi: int) -> np.ndarray:
        sd = self._sd
        chunk_len, fill, table_ref, nt_size = header
        if len(chunk_len) != len(self.shape) \
                or nt_size != self._file_dtype.itemsize:
            raise ValueError(
                f"{sd.path}: SDS {self.name!r}: chunk header of rank "
                f"{len(chunk_len)}, element size {nt_size} against shape "
                f"{self.shape}, {self._file_dtype}")
        if self._chunks is None:
            self._chunks = sd._chunk_table(table_ref, len(self.shape))
        fill_value = (np.frombuffer(fill, self._file_dtype)[0]
                      if len(fill) == nt_size else self.fill_value)
        out = np.full((hi - lo,) + tuple(self.shape[1:]), fill_value,
                      self._file_dtype)
        grid = [range(lo // chunk_len[0], (hi - 1) // chunk_len[0] + 1)] + [
            range(-(-d // c)) for d, c in zip(self.shape[1:], chunk_len[1:])]
        chunk_bytes = int(np.prod(chunk_len, dtype=np.int64)) * nt_size
        for origin in np.ndindex(*[len(g) for g in grid]):
            idx = tuple(g[o] for g, o in zip(grid, origin))
            element = self._chunks.get(idx)
            if element is None:
                continue          # never written: the fill value stands
            raw = sd._element_range(*element, 0, chunk_bytes,
                                    f"chunk {idx} of SDS {self.name!r}",
                                    cache=False)
            chunk = np.frombuffer(raw, self._file_dtype).reshape(chunk_len)
            src, dst = [], []
            for axis, (c, cl) in enumerate(zip(idx, chunk_len)):
                start = c * cl
                stop = min(start + cl, self.shape[axis])
                if axis == 0:
                    a, b = max(start, lo), min(stop, hi)
                    src.append(slice(a - start, b - start))
                    dst.append(slice(a - lo, b - lo))
                else:
                    src.append(slice(0, stop - start))
                    dst.append(slice(start, stop))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


class _Inflate:
    """A deflate stream inflated on demand into its element's preallocated
    buffer: later reads of the same element continue where earlier ones
    stopped."""

    def __init__(self, payload: bytes, length: int):
        self.obj = zlib.decompressobj()
        self.out = bytearray(length)
        self.filled = 0
        self.pending = payload

    def upto(self, stop: int, what: str) -> memoryview:
        while self.filled < stop:
            piece = self.obj.decompress(self.pending, stop - self.filled)
            self.pending = self.obj.unconsumed_tail
            if not piece:
                raise ValueError(f"{what}: the deflate stream ends after "
                                 f"{self.filled} of {stop} byte(s)")
            self.out[self.filled:self.filled + len(piece)] = piece
            self.filled += len(piece)
        return memoryview(self.out)


class SDFile:
    """An HDF4 file as the SD interface sees it, read-only:
    :meth:`attributes` (the global attributes by name), :meth:`datasets`
    (the SDS names) and :meth:`select` (one :class:`SDS`).

    A char8 attribute is returned as text: its bytes as latin-1, with the
    trailing NULs of a fixed-length C string trimmed (HDF-EOS pads
    ``StructMetadata.0`` with them). A numeric attribute of one value is a
    Python number, of several a list."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            size = f.seek(0, 2)
            if size < len(MAGIC):
                raise ValueError(f"{self.path}: not an HDF4 file ({size} "
                                 "byte(s))")
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.size = size
        self._inflate: Dict[Tuple[int, int], _Inflate] = {}
        try:
            self._open()
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        self._inflate = {}
        if self._map is not None:
            self._map.close()
            self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ layout

    def _bytes(self, offset: int, length: int, what: str) -> bytes:
        if offset < 0 or length < 0 or offset + length > self.size:
            raise ValueError(
                f"{self.path}: truncated or corrupt file: {what} at offset "
                f"{offset} needs {length} byte(s), the file has {self.size}")
        return self._map[offset:offset + length]

    def _open(self) -> None:
        magic = self._bytes(0, 4, "magic")
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not an HDF4 file (magic "
                             f"{magic.hex()} at offset 0)")
        self._dds: Dict[Tuple[int, int], Tuple[int, int]] = {}
        offset, seen = 4, set()
        while offset:
            if offset in seen:
                raise ValueError(f"{self.path}: DD block chain loops at "
                                 f"offset {offset}")
            seen.add(offset)
            ndds, nxt = struct.unpack(">hi", self._bytes(offset, 6,
                                                         "DD block header"))
            if ndds < 0:
                raise ValueError(f"{self.path}: DD block at offset {offset} "
                                 f"holds {ndds} entries")
            block = self._bytes(offset + 6, 12 * ndds, "DD block")
            for k in range(ndds):
                tag, ref, off, length = struct.unpack_from(">HHii", block,
                                                           12 * k)
                if tag == DFTAG_NULL or off == -1 or length == -1:
                    continue
                self._dds.setdefault((tag, ref), (off, length))
            offset = nxt
        self._vgroups = {ref: self._vgroup(ref) for tag, ref in self._dds
                         if tag == DFTAG_VG}
        cdf = [v for v in self._vgroups.values() if v.cls == "CDF0.0"]
        if not cdf:
            raise ValueError(f"{self.path}: no SD model in the file (no "
                             "'CDF0.0' vgroup)")
        self._attrs: Dict[str, object] = {}
        self._vars: Dict[str, VGroup] = {}
        for tag, ref in cdf[0].children:
            if tag == DFTAG_VG and ref in self._vgroups:
                vg = self._vgroups[ref]
                if vg.cls == "Var0.0":
                    self._vars.setdefault(vg.name, vg)
            elif tag == DFTAG_VH:
                vd = self._vdata(ref)
                if vd.cls == "Attr0.0":
                    self._attrs[vd.name] = self._attr_value(vd)

    def _find(self, tag: int, ref: int) -> Optional[Tuple[int, int, int]]:
        """(tag as stored, offset, length) of an element, looked up by its
        base tag as the C library does: plain first, then special."""
        for t in (tag, tag | SPECIAL_BIT):
            if (t, ref) in self._dds:
                return (t,) + self._dds[(t, ref)]
        return None

    def _element(self, tag: int, ref: int, what: str) -> bytes:
        found = self._find(tag, ref)
        if found is None:
            raise ValueError(f"{self.path}: {what} names the element "
                             f"tag {tag} ref {ref}, which the file lacks")
        return self._bytes(found[1], found[2], what)

    def _vgroup(self, ref: int) -> VGroup:
        off = self._dds[(DFTAG_VG, ref)][0]
        cur = _Cursor(self._element(DFTAG_VG, ref, f"vgroup {ref}"),
                      self.path, off, f"vgroup {ref}")
        n = cur.u16()
        tags = cur.unpack(f"{n}H")
        refs = cur.unpack(f"{n}H")
        name, cls = cur.text(), cur.text()
        cur.unpack("HH")                         # extension tag and ref
        version = _trailer_version(cur)
        if version not in (2, 3, 4):
            raise ValueError(f"{self.path}: vgroup {ref} at offset {off} "
                             f"has the unknown version {version}")
        return VGroup(ref, name, cls, list(zip(tags, refs)), version)

    def _vdata(self, ref: int) -> VData:
        found = self._find(DFTAG_VH, ref)
        if found is None:
            raise ValueError(f"{self.path}: no vdata header {ref}")
        cur = _Cursor(self._bytes(found[1], found[2], f"vdata header {ref}"),
                      self.path, found[1], f"vdata header {ref}")
        interlace = cur.u16()
        nvert = cur.i32()
        ivsize = cur.u16()
        n = cur.u16()
        types = cur.unpack(f"{n}H")
        isizes = cur.unpack(f"{n}H")
        offsets = cur.unpack(f"{n}H")
        orders = cur.unpack(f"{n}H")
        names = [cur.text() for _ in range(n)]
        name, cls = cur.text(), cur.text()
        cur.unpack("HH")                         # extension tag and ref
        version = _trailer_version(cur)
        if version not in (2, 3, 4):
            raise ValueError(f"{self.path}: vdata {ref} at offset "
                             f"{found[1]} has the unknown version {version}")
        fields = [VDataField(nm, _dtype(t, self.path, f"vdata {name!r}"),
                             s, o, k)
                  for nm, t, s, o, k in zip(names, types, isizes, offsets,
                                            orders)]
        return VData(ref, name, cls, interlace, nvert, ivsize, fields,
                     version)

    def _records(self, vd: VData) -> Dict[str, np.ndarray]:
        """Each field's values, shape (nvert, order), in file order."""
        total = vd.nvert * vd.ivsize
        raw = (self._element_range(DFTAG_VS, vd.ref, 0, total,
                                   f"vdata {vd.name!r}", cache=False)
               if total else b"")
        out = {}
        rows = (np.frombuffer(raw, np.uint8).reshape(vd.nvert, vd.ivsize)
                if vd.interlace == 0 else None)     # records packed
        for k, f in enumerate(vd.fields):
            if f.isize != f.dtype.itemsize * f.order:
                raise ValueError(f"{self.path}: vdata {vd.name!r} field "
                                 f"{f.name!r}: size {f.isize} against "
                                 f"{f.order} x {f.dtype}")
            if rows is not None:
                col = rows[:, f.offset:f.offset + f.isize].copy()
            else:                                  # fields one after another
                start = sum(g.isize for g in vd.fields[:k]) * vd.nvert
                col = np.frombuffer(raw[start:start + f.isize * vd.nvert],
                                    np.uint8).reshape(vd.nvert, f.isize)
            out[f.name] = col.view(f.dtype).reshape(vd.nvert, f.order)
        return out

    def _attr_value(self, vd: VData):
        if len(vd.fields) != 1:
            raise ValueError(f"{self.path}: attribute {vd.name!r} has "
                             f"{len(vd.fields)} fields")
        values = self._records(vd)[vd.fields[0].name].reshape(-1)
        if values.dtype.kind == "S":
            return values.tobytes().rstrip(b"\0").decode("latin-1")
        values = values.astype(values.dtype.newbyteorder("="))
        return values[0].item() if values.size == 1 else values.tolist()

    # ----------------------------------------------------------- elements

    def _special(self, tag: int, ref: int):
        """(special code, parsed header) of a data element, or (None, None)
        for a plain one. Headers: compressed (version, length, payload ref,
        model, coder, coder info); linked (length, block length, blocks
        per table, first table ref); chunked (chunk lengths, fill bytes,
        chunk table ref, element size)."""
        found = self._find(tag, ref)
        if found is None:
            raise ValueError(f"{self.path}: no data element tag {tag} "
                             f"ref {ref}")
        stored, off, length = found
        if not stored & SPECIAL_BIT:
            return None, None
        what = f"special element tag {tag} ref {ref}"
        cur = _Cursor(self._bytes(off, length, what), self.path, off, what)
        code = cur.i16()
        if code == SPECIAL_COMP:
            version, total, payload, model, coder = cur.unpack("HiHHH")
            return code, (version, total, payload, model, coder)
        if code == SPECIAL_LINKED:
            return code, cur.unpack("iiiH")
        if code == SPECIAL_EXT:
            total, ext_off = cur.unpack("ii")
            name = cur.take(cur.i32()).decode("latin-1")
            raise ValueError(
                f"{self.path}: element tag {tag} ref {ref} keeps its data "
                f"in the external file {name!r} (offset {ext_off}, {total} "
                "bytes; SPECIAL_EXT), which this reader does not follow")
        if code == SPECIAL_CHUNKED:
            cur.i32()                          # header length
            cur.take(1)                        # version
            _, _, _, nt_size = cur.unpack("iiii")  # flag, length, chunk
            _, table_ref, _, _ = cur.unpack("HHHH")
            ndims = cur.i32()
            chunk_len = []
            for _ in range(ndims):
                _, _, cl = cur.unpack("iii")   # flag, dim length, chunk
                if cl <= 0:
                    raise ValueError(f"{self.path}: {what} at offset {off}"
                                     f" has the chunk length {cl}")
                chunk_len.append(cl)
            fill = cur.take(cur.i32())
            return code, (tuple(chunk_len), fill, table_ref, nt_size)
        raise ValueError(
            f"{self.path}: {what} at offset {off} is of special kind "
            f"{code} ({SPECIAL_NAMES.get(code, 'unknown')}), which this "
            "reader does not take")

    def _chunk_table(self, ref: int, rank: int) -> Dict[tuple, tuple]:
        vd = self._vdata(ref)
        rec = self._records(vd)
        if not {"origin", "chk_tag", "chk_ref"} <= set(rec) \
                or rec["origin"].shape[1] != rank:
            raise ValueError(f"{self.path}: chunk table {ref} has fields "
                             f"{sorted(rec)}, not origin[{rank}], chk_tag, "
                             "chk_ref")
        return {tuple(int(v) for v in o): (int(t), int(r))
                for o, t, r in zip(rec["origin"], rec["chk_tag"][:, 0],
                                   rec["chk_ref"][:, 0])}

    def _element_range(self, tag: int, ref: int, start: int, stop: int,
                       what: str, cache: bool = True) -> bytes:
        """Bytes ``start:stop`` of an element's data, whatever its storage
        (plain, compressed, linked blocks)."""
        code, header = self._special(tag, ref)
        if code is None:
            _, off, length = self._find(tag, ref)
            if stop > length:
                raise ValueError(f"{self.path}: {what}: element at offset "
                                 f"{off} holds {length} byte(s), {stop} "
                                 "needed")
            return self._bytes(off + start, stop - start, what)
        if code == SPECIAL_COMP:
            version, total, payload_ref, model, coder = header
            if stop > total:
                raise ValueError(f"{self.path}: {what}: compressed element "
                                 f"of {total} byte(s), {stop} needed")
            if model != COMP_MODEL_STDIO:
                raise ValueError(f"{self.path}: {what}: compression model "
                                 f"{model} is not taken")
            if coder != COMP_CODE_DEFLATE:
                raise ValueError(
                    f"{self.path}: {what} is compressed with the "
                    f"{CODER_NAMES.get(coder, f'unknown ({coder})')} coder "
                    f"(code {coder}); this reader takes deflate only")
            key = (tag, ref)
            inflate = self._inflate.get(key) if cache else None
            if inflate is None:
                inflate = _Inflate(self._element(
                    DFTAG_COMPRESSED, payload_ref, f"{what}, deflate stream"),
                    total)
                if cache:
                    self._inflate[key] = inflate
            try:
                view = inflate.upto(stop, f"{self.path}: {what}")
            except zlib.error as e:
                off = self._find(DFTAG_COMPRESSED, payload_ref)[1]
                raise ValueError(f"{self.path}: {what}: corrupt deflate "
                                 f"stream at offset {off}: {e}") from None
            return bytes(view[start:stop])
        if code == SPECIAL_LINKED:
            return self._linked_range(header, start, stop, what)
        raise ValueError(f"{self.path}: {what} is a "
                         f"{SPECIAL_NAMES.get(code, code)} element where "
                         "plain data was expected")

    def _linked_range(self, header, start: int, stop: int,
                      what: str) -> bytes:
        """Linked blocks: block tables (DFTAG_LINKED) chained by their first
        ref, each listing ``per_table`` block refs; the first block is as
        long as its own element, every later one ``block_len``; a block
        ref of 0 was never written and reads as zeros."""
        total, block_len, per_table, table_ref = header
        if stop > total:
            raise ValueError(f"{self.path}: {what}: linked element of "
                             f"{total} byte(s), {stop} needed")
        refs, seen = [], set()
        while table_ref and table_ref not in seen:
            seen.add(table_ref)
            cur = _Cursor(self._element(DFTAG_LINKED, table_ref,
                                        f"block table {table_ref}"),
                          self.path, 0, f"block table {table_ref}")
            table_ref = cur.u16()
            refs.extend(cur.unpack(f"{per_table}H"))
        out = bytearray(stop - start)
        pos = 0
        for k, ref in enumerate(refs):
            if pos >= stop:
                break
            found = self._find(DFTAG_LINKED, ref) if ref else None
            if ref and found is None:
                raise ValueError(f"{self.path}: {what}: block {ref} of its "
                                 "block table is not in the file")
            size = found[2] if k == 0 and found else block_len
            a, b = max(start, pos), min(stop, pos + size)
            if found and b > a:
                _, off, length = found
                have = max(0, min(b - pos, length) - (a - pos))
                out[a - start:a - start + have] = self._bytes(
                    off + a - pos, have, f"{what}, block {ref}")
            pos += size
        if pos < stop:
            raise ValueError(f"{self.path}: {what}: the block tables cover "
                             f"{pos} of {stop} byte(s)")
        return bytes(out)

    # --------------------------------------------------------- SD surface

    def attributes(self) -> Dict[str, object]:
        return dict(self._attrs)

    def datasets(self) -> List[str]:
        return list(self._vars)

    def select(self, name: str) -> SDS:
        vg = self._vars.get(name)
        if vg is None:
            raise ValueError(f"{self.path}: no SDS named {name!r} (the file "
                             f"has {self.datasets()})")
        where = f"SDS {name!r}"
        ndg = [r for t, r in vg.children if t == DFTAG_NDG]
        if not ndg:
            raise ValueError(f"{self.path}: {where} has no NDG")
        pairs = self._element(DFTAG_NDG, ndg[0], f"NDG of {where}")
        pairs = list(zip(*[iter(struct.unpack(f">{len(pairs) // 2}H",
                                              pairs))] * 2))
        sdd = [r for t, r in pairs if t == DFTAG_SDD]
        if not sdd:
            raise ValueError(f"{self.path}: the NDG of {where} names no SDD")
        off = self._find(DFTAG_SDD, sdd[0])
        cur = _Cursor(self._element(DFTAG_SDD, sdd[0], f"SDD of {where}"),
                      self.path, off[1] if off else 0, f"SDD of {where}")
        rank = cur.i16()
        dims = cur.unpack(f"{rank}i")
        nt_tag, nt_ref = cur.unpack("HH")
        nt = _Cursor(self._element(nt_tag, nt_ref, f"number type of {where}"),
                     self.path, 0, f"number type of {where}")
        _, code, bits, cls = nt.unpack("BBBB")
        kind = NUMBER_TYPES.get(code)
        order = NT_CLASS_ORDER.get(cls, ">" if bits == 8 else None)
        if kind is None or order is None:
            raise ValueError(f"{self.path}: {where} has the number type "
                             f"{code} of class {cls}, which this reader does "
                             "not take")
        dtype = np.dtype(order + kind)
        if dtype.itemsize * 8 != bits:
            raise ValueError(f"{self.path}: {where}: number type {code} of "
                             f"{bits} bits")
        data = [r for t, r in vg.children if t == DFTAG_SD] \
            or [r for t, r in pairs if t == DFTAG_SD]
        attrs = {}
        for t, r in vg.children:
            if t == DFTAG_VH:
                vd = self._vdata(r)
                if vd.cls == "Attr0.0":
                    attrs[vd.name] = self._attr_value(vd)
        return SDS(self, name, tuple(int(d) for d in dims), code, dtype,
                   (DFTAG_SD, data[0]) if data else None, attrs)


__all__ = ["SDFile", "SDS"]
