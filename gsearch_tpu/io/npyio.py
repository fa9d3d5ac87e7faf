"""Zero-copy access to .npy payloads, standalone or inside .npz archives.

np.savez stores members ZIP_STORED (uncompressed), so an .npz member's raw
array bytes can be memory-mapped or read straight into a caller-owned
buffer once its payload offset is known.  Three call sites need this (the
index loader's capacity-buffer read and the 524k/1M bench scripts' sig
caches); this module is the single place that parses the npy/zip headers.
"""

from __future__ import annotations

import struct
import zipfile

import numpy as np

# numpy's public header readers (its private _read_array_header is not
# present in every numpy release)
_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def npy_payload(path: str, member: str | None = None):
    """Locate the raw array payload of `path` (.npy), or of one
    ZIP_STORED `member` of an .npz, without reading the data.

    Returns (offset, shape, dtype); raises on fortran-order arrays and
    compressed members."""
    with open(path, "rb") as f:
        if member is not None:
            with zipfile.ZipFile(path) as z:
                info = z.getinfo(member)
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{path}:{member} is compressed")
            f.seek(info.header_offset)
            lh = f.read(30)
            if lh[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}:{member}: bad local file header")
            nlen, elen = struct.unpack("<HH", lh[26:30])
            f.seek(info.header_offset + 30 + nlen + elen)
        version = np.lib.format.read_magic(f)
        read_header = _HEADER_READERS.get(version)
        if read_header is None:
            raise ValueError(f"{path}: unsupported .npy format {version}")
        shape, fortran, dtype = read_header(f)
        if fortran:
            raise ValueError(f"{path}: fortran-order array unsupported")
        return f.tell(), shape, dtype


def npy_memmap(path: str, member: str | None = None) -> np.memmap:
    """Memory-map the payload in place: ~zero anon RSS for matrices far
    larger than host RAM page-cache pressure allows (e.g. the 50 GB
    1M x 12000 sig cache)."""
    off, shape, dtype = npy_payload(path, member)
    return np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)


def npy_read_with_headroom(path: str, member: str | None = None):
    """Read a 2-D payload STRAIGHT into a capacity buffer with ~12.5%
    row headroom: one disk read, zero extra copies.  Returns (buf, n)
    where buf[:n] is the live matrix — the first append into the buffer
    then avoids a whole-matrix migration copy (90 s at 524k x 12000)."""
    off, shape, dtype = npy_payload(path, member)
    if len(shape) != 2:
        raise ValueError(f"{path}: expected 2-D, got {shape}")
    n, s = shape
    buf = np.empty((n + max(n >> 3, 4096), s), dtype)
    live = buf[:n]
    with open(path, "rb") as f:
        f.seek(off)
        got = f.readinto(live)
    if got != live.nbytes:
        raise IOError(f"{path}: expected {live.nbytes} payload bytes, got {got}")
    return buf, n
