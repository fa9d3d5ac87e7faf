"""ctypes bindings for the native FASTA parse+encode library.

The library is built from the committed native/ sources at first use into
native/build/libfastaparse-<key>.so, where the key hashes the source, the
compiler flags and the host CPU: a library compiled with -march=native on
one machine is never loaded on another (it could die there with SIGILL,
which no exception handler sees).  All callers fall back to the
pure-Python path transparently when no library can be built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ID_CAP = 512

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
CXXFLAGS = "-O3 -march=native"


def _host_cpu() -> str:
    """What -march=native compiles for: the CPU model and its ISA flags."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    keep.append(line.strip())
                    if len(keep) == 2:
                        break
    except OSError:
        pass
    return "\n".join(keep) or f"{platform.machine()} {platform.processor()}"


def build_key(source: bytes, cxxflags: str = CXXFLAGS,
              host_cpu: str | None = None) -> str:
    """Hash of everything that decides the built library's machine code."""
    h = hashlib.sha256(source)
    h.update(b"\0" + cxxflags.encode() + b"\0")
    h.update((_host_cpu() if host_cpu is None else host_cpu).encode())
    return h.hexdigest()[:16]


def lib_path() -> Optional[str]:
    """Where the library for this source, flags and host lives (None
    without the committed source)."""
    src = os.path.join(NATIVE_DIR, "fastaparse.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        key = build_key(f.read())
    return os.path.join(NATIVE_DIR, "build", f"libfastaparse-{key}.so")


def _find_lib() -> Optional[str]:
    cand = lib_path()
    if cand is None:
        return None
    if (not os.path.exists(cand)
            and os.environ.get("GSEARCH_TPU_NO_NATIVE_BUILD") != "1"):
        _try_build(cand)
    return cand if os.path.exists(cand) else None


def _try_build(out: str) -> None:
    """Best-effort one-shot build of the native library (reference role:
    the Rust crates are compiled ahead of time; here we lazily compile on
    first import so the fast ingest path is active without a manual step)."""
    import subprocess

    try:
        subprocess.run(
            ["sh", os.path.join(NATIVE_DIR, "build.sh"), out],
            cwd=NATIVE_DIR,
            env={**os.environ, "CXXFLAGS": CXXFLAGS},
            capture_output=True,
            timeout=120,
            check=True,
        )
    except Exception:
        pass  # toolchain absent or build failed; Python path covers everything


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fasta_concat_codes.restype = ctypes.c_long
    lib.fasta_concat_codes.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.fasta_records_codes.restype = ctypes.c_long
    lib.fasta_records_codes.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t), ctypes.c_long,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    try:  # older .so builds may predate the packer
        lib.pack2bit_exc.restype = ctypes.c_long
        lib.pack2bit_exc.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ]
    except AttributeError:
        pass
    try:  # fused parse+pack (may be absent in older .so builds)
        lib.fasta_concat_pack2.restype = ctypes.c_long
        lib.fasta_concat_pack2.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_long),
        ]
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def native_concat_codes(
    data: bytes, is_aa: bool, min_seq_size: int
) -> Optional[Tuple[np.ndarray, str, int]]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(data) + 1, dtype=np.uint8)
    out_len = ctypes.c_size_t(0)
    total = ctypes.c_size_t(0)
    first_id = ctypes.create_string_buffer(_ID_CAP)
    kept = lib.fasta_concat_codes(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        1 if is_aa else 0, min_seq_size,
        ctypes.byref(out_len), first_id, _ID_CAP,
        ctypes.byref(total),
    )
    if kept < 0:
        return None
    return out[: out_len.value], first_id.value.decode("utf-8", "replace"), int(total.value)


def native_records_codes(
    data: bytes, is_aa: bool, min_seq_size: int, max_records: int = 1 << 20
) -> Optional[List[Tuple[np.ndarray, str]]]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(data) + 1, dtype=np.uint8)
    offsets = np.zeros(max_records, dtype=np.uintp)
    lengths = np.zeros(max_records, dtype=np.uintp)
    ids = ctypes.create_string_buffer(max_records * 64)
    out_len = ctypes.c_size_t(0)
    kept = lib.fasta_records_codes(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        1 if is_aa else 0, min_seq_size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        max_records, ids, 64,
        ctypes.byref(out_len),
    )
    if kept < 0:
        return None
    result = []
    raw = ids.raw
    for i in range(kept):
        o, l = int(offsets[i]), int(lengths[i])
        ident = raw[i * 64 : (i + 1) * 64].split(b"\0", 1)[0].decode("utf-8", "replace")
        result.append((out[o : o + l], ident))
    return result


def native_concat_pack2(data: bytes, min_seq_size: int):
    """Fused one-block parse + 2-bit pack (DNA only): FASTA bytes ->
    (PackedCodes, first_fasta_id, total_bases), or None when the lib /
    symbol is absent or the file overflows its invalid-position budget
    (N-run-heavy; caller falls back to the unfused path)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fasta_concat_pack2"):
        return None
    cap = len(data) // 4 + 2
    p2 = np.empty(cap, dtype=np.uint8)
    max_exc = max(4096, len(data) // 16)
    inv = np.empty(max_exc, dtype=np.int32)
    out_codes = ctypes.c_size_t(0)
    total = ctypes.c_size_t(0)
    ninv = ctypes.c_long(0)
    first_id = ctypes.create_string_buffer(_ID_CAP)
    kept = lib.fasta_concat_pack2(
        data, len(data),
        p2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_exc,
        min_seq_size,
        ctypes.byref(out_codes), first_id, _ID_CAP,
        ctypes.byref(total), ctypes.byref(ninv),
    )
    if kept < 0:
        return None
    from .codec import PackedCodes

    if kept == 0:
        return PackedCodes(np.empty(0, np.uint8), 0, np.empty(0, np.int32)), "", 0
    return (
        PackedCodes(p2, int(out_codes.value), inv[: ninv.value].copy()),
        first_id.value.decode("utf-8", "replace"),
        int(total.value),
    )


def native_pack2bit_exc(arr: np.ndarray, lens: np.ndarray, max_exc: int):
    """C++ exception-form 2-bit pack (see models/base.py UPLOAD_MODE).
    Returns (p2, inv) or None when the lib is absent / a row overflows
    max_exc / shapes are unsuitable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pack2bit_exc"):
        return None
    b, nb = arr.shape
    if nb % 4 or not arr.flags.c_contiguous:
        return None
    p2 = np.empty((b, nb // 4), np.uint8)
    inv = np.full((b, max_exc), nb, np.int32)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    rc = lib.pack2bit_exc(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), b, nb,
        p2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_exc,
    )
    if rc < 0:
        return None
    return p2, inv
