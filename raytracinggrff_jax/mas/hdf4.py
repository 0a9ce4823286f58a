"""Minimal HDF4 scientific-dataset (SD/DFSD) reader and writer.

The MAS coronal model ships as HDF4 files ({var}{ddd}.hdf with an SDS holding
the field on its (phi, theta, r) mesh plus per-dimension scale arrays). The
reference reads them through psipy -> pyhdf -> libdf (C); neither psipy nor
pyhdf exists in this environment, so this is a from-scratch parser of the
HDF4 container format covering what MAS files use:

  * big-endian DD (data-descriptor) block chains
  * DFTAG_NT number types (float32/float64/int32/...)
  * DFSD-style datasets: DFTAG_SDD (dimension record) + DFTAG_SD (raw data)
    + DFTAG_SDS (dimension scales), grouped by DFTAG_NDG
  * SD-API files where dimension scales are separate 1-D datasets
  * linked-block special elements (DFTAG_LINKED)

Reference behavior being replaced: psipy.io.mas._read_mas
(used at raytracingGRFF/build_rays.py:48-66).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

HDF4_MAGIC = b"\x0e\x03\x13\x01"

DFTAG_NULL = 1
DFTAG_VERSION = 30
DFTAG_NT = 106
DFTAG_SDG = 700
DFTAG_SDD = 701
DFTAG_SD = 702
DFTAG_SDS = 703
DFTAG_SDL = 704
DFTAG_NDG = 720
DFTAG_LINKED = 20
SPECIAL_BIT = 0x4000

DFNT_TO_DTYPE = {
    5: ">f4", 6: ">f8", 20: ">i1", 21: ">u1",
    22: ">i2", 23: ">u2", 24: ">i4", 25: ">u4",
}
DTYPE_TO_DFNT = {"f4": 5, "f8": 6, "i1": 20, "u1": 21,
                 "i2": 22, "u2": 23, "i4": 24, "u4": 25}


@dataclass
class _DD:
    tag: int
    ref: int
    offset: int
    length: int


@dataclass
class SDSData:
    """One scientific dataset: array + optional per-dimension scales."""
    data: np.ndarray
    scales: list = field(default_factory=list)  # list[np.ndarray | None]
    label: str | None = None


def _read_dds(buf: bytes) -> list[_DD]:
    if buf[:4] != HDF4_MAGIC:
        raise ValueError("not an HDF4 file (bad magic)")
    dds = []
    pos = 4
    while pos:
        ndd, nxt = struct.unpack(">hI", buf[pos:pos + 6])
        pos += 6
        for _ in range(ndd):
            tag, ref, off, length = struct.unpack(">HHII", buf[pos:pos + 12])
            pos += 12
            if tag != DFTAG_NULL:
                dds.append(_DD(tag, ref, off, length))
        pos = nxt
    return dds


def _element_bytes(buf: bytes, dd: _DD, dd_map) -> bytes:
    """Raw bytes of an element, following linked-block special storage."""
    if not (dd.tag & SPECIAL_BIT):
        return buf[dd.offset:dd.offset + dd.length]
    # special element header: int16 special-type
    sp_type, = struct.unpack(">h", buf[dd.offset:dd.offset + 2])
    if sp_type != 1:  # SPECIAL_LINKED
        raise NotImplementedError(
            f"HDF4 special storage type {sp_type} not supported "
            "(compressed/chunked MAS files)")
    total_len, first_len, blk_len, num_blk, link_ref = struct.unpack(
        ">IIIIH", buf[dd.offset + 2:dd.offset + 20])
    out = bytearray()
    ref = link_ref
    first = True
    while ref and len(out) < total_len:
        tbl = dd_map.get((DFTAG_LINKED, ref))
        if tbl is None:
            break
        raw = buf[tbl.offset:tbl.offset + tbl.length]
        nxt, = struct.unpack(">H", raw[:2])
        refs = struct.unpack(f">{(len(raw) - 2) // 2}H", raw[2:])
        for i, bref in enumerate(refs):
            if bref == 0:
                continue
            bdd = dd_map.get((DFTAG_LINKED, bref))
            if bdd is None:
                continue
            cap = first_len if (first and i == 0) else blk_len
            out += buf[bdd.offset:bdd.offset + min(bdd.length, cap)]
        first = False
        ref = nxt
    return bytes(out[:total_len])


def _parse_nt(buf: bytes, dd: _DD) -> np.dtype:
    _, typ, _, _ = struct.unpack(">BBBB", buf[dd.offset:dd.offset + 4])
    if typ not in DFNT_TO_DTYPE:
        raise ValueError(f"unsupported HDF4 number type {typ}")
    return np.dtype(DFNT_TO_DTYPE[typ])


def read_hdf4_sds(path) -> list[SDSData]:
    """Read all scientific datasets (with scales) from an HDF4 file."""
    with open(path, "rb") as f:
        buf = f.read()
    dds = _read_dds(buf)
    dd_map = {(d.tag & ~SPECIAL_BIT, d.ref): d for d in dds}
    # keep the special bit visible for element reads
    raw_map = {}
    for d in dds:
        raw_map[(d.tag & ~SPECIAL_BIT, d.ref)] = d

    ndgs = [d for d in dds if (d.tag & ~SPECIAL_BIT) == DFTAG_NDG]
    groups = []
    if ndgs:
        for g in ndgs:
            raw = _element_bytes(buf, g, raw_map)
            n = len(raw) // 4
            members = struct.unpack(f">{2 * n}H", raw[:4 * n])
            groups.append([(members[2 * i], members[2 * i + 1])
                           for i in range(n)])
    else:
        # no NDG: pair each SDD with the SD of the same ref
        for d in dds:
            if (d.tag & ~SPECIAL_BIT) == DFTAG_SDD:
                groups.append([(DFTAG_SDD, d.ref), (DFTAG_SD, d.ref)])

    out = []
    for members in groups:
        sdd = sd = sds = sdl = None
        for tag, ref in members:
            d = raw_map.get((tag & ~SPECIAL_BIT, ref))
            if d is None:
                continue
            t = tag & ~SPECIAL_BIT
            if t == DFTAG_SDD:
                sdd = d
            elif t == DFTAG_SD:
                sd = d
            elif t == DFTAG_SDS:
                sds = d
            elif t == DFTAG_SDL:
                sdl = d
        if sdd is None or sd is None:
            continue

        rec = _element_bytes(buf, sdd, raw_map)
        rank, = struct.unpack(">h", rec[:2])
        dims = struct.unpack(f">{rank}i", rec[2:2 + 4 * rank])
        pos = 2 + 4 * rank
        nt_refs = struct.unpack(f">{2 * (rank + 1)}H",
                                rec[pos:pos + 4 * (rank + 1)])
        data_nt_ref = nt_refs[1]
        scale_nt_refs = [nt_refs[2 * (i + 1) + 1] for i in range(rank)]

        data_dt = _parse_nt(buf, raw_map[(DFTAG_NT, data_nt_ref)])
        raw = _element_bytes(buf, sd, raw_map)
        n_items = int(np.prod(dims))
        data = np.frombuffer(raw, dtype=data_dt, count=n_items)
        data = data.reshape(dims).astype(data_dt.newbyteorder("="))

        scales: list = [None] * rank
        if sds is not None:
            raw = _element_bytes(buf, sds, raw_map)
            flags = raw[:rank]
            pos = rank
            for i in range(rank):
                if flags[i]:
                    dt = _parse_nt(buf, raw_map[(DFTAG_NT, scale_nt_refs[i])])
                    nbytes = dims[i] * dt.itemsize
                    scales[i] = np.frombuffer(
                        raw[pos:pos + nbytes], dtype=dt
                    ).astype(dt.newbyteorder("="))
                    pos += nbytes

        label = None
        if sdl is not None:
            label = _element_bytes(buf, sdl, raw_map).split(b"\x00")[0]
            label = label.decode("ascii", "replace") or None

        out.append(SDSData(data=data, scales=scales, label=label))

    if not out:
        raise ValueError(f"no scientific datasets found in {path}")
    return out


def write_hdf4_sds(path, data: np.ndarray, scales=None, label=None):
    """Write one SDS (DFSD style: NDG + SDD + SD + SDS [+ SDL]).

    Produces files this module (and pyhdf) can read back; used to generate
    synthetic MAS models for tests and demos.
    """
    data = np.asarray(data)
    rank = data.ndim
    dims = data.shape
    if scales is None:
        scales = [None] * rank
    be = data.dtype.str.lstrip("<>=|")
    if be not in DTYPE_TO_DFNT:
        data = data.astype(np.float32)
        be = "f4"

    elements = []  # (tag, ref, payload bytes)
    ref_counter = [1]

    def add(tag, payload):
        ref = ref_counter[0]
        ref_counter[0] += 1
        elements.append((tag, ref, payload))
        return ref

    def nt_payload(dtype_code):
        typ = DTYPE_TO_DFNT[dtype_code]
        width = int(dtype_code[1]) * 8
        return struct.pack(">BBBB", 1, typ, width, 0)

    add(DFTAG_VERSION, struct.pack(">III", 4, 2, 15) + b"rgrff-jax\x00")
    data_nt_ref = add(DFTAG_NT, nt_payload(be))

    scale_nt_refs = []
    scale_payload = bytearray()
    flags = bytearray()
    for i in range(rank):
        s = scales[i]
        if s is None:
            flags.append(0)
            scale_nt_refs.append(data_nt_ref)
        else:
            s = np.asarray(s, np.float64)
            if len(s) != dims[i]:
                raise ValueError("scale length mismatch")
            flags.append(1)
            scale_nt_refs.append(add(DFTAG_NT, nt_payload("f8")))
            scale_payload += s.astype(">f8").tobytes()

    sdd = struct.pack(">h", rank) + struct.pack(f">{rank}i", *dims)
    sdd += struct.pack(">HH", DFTAG_NT, data_nt_ref)
    for r in scale_nt_refs:
        sdd += struct.pack(">HH", DFTAG_NT, r)
    sdd_ref = add(DFTAG_SDD, bytes(sdd))

    sd_ref = add(DFTAG_SD, data.astype(f">{be}").tobytes())
    sds_ref = add(DFTAG_SDS, bytes(flags) + bytes(scale_payload))

    ndg_members = [(DFTAG_SDD, sdd_ref), (DFTAG_SD, sd_ref),
                   (DFTAG_SDS, sds_ref)]
    if label:
        sdl_ref = add(DFTAG_SDL, label.encode("ascii") + b"\x00")
        ndg_members.append((DFTAG_SDL, sdl_ref))
    ndg = b"".join(struct.pack(">HH", t, r) for t, r in ndg_members)
    add(DFTAG_NDG, ndg)

    # layout: magic + one DD block + payloads
    header_len = 4 + 6 + 12 * len(elements)
    offset = header_len
    dd_entries = []
    for tag, ref, payload in elements:
        dd_entries.append((tag, ref, offset, len(payload)))
        offset += len(payload)

    with open(path, "wb") as f:
        f.write(HDF4_MAGIC)
        f.write(struct.pack(">hI", len(elements), 0))
        for tag, ref, off, length in dd_entries:
            f.write(struct.pack(">HHII", tag, ref, off, length))
        for _, _, payload in elements:
            f.write(payload)
