"""Canonical-Huffman bit codec: native C fast path + numpy fallback.

A copy of ``aip_tpu/runtime/bitcodec.py`` for the port, which imports
nothing of the JAX package. ``_bitcodec.c`` is built with the system
compiler (``$CC``, default ``cc``) on first use into
``build/aip_tpu_torch/`` under the checkout (``AIP_TPU_TORCH_BUILD``
overrides it), and bound with ctypes. The canonical-code construction
lives in Python; only the per-bit pack/unpack loops are native. The numpy
decoder is the same host function, used where no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _build_dir() -> Path:
    default = Path(__file__).resolve().parent.parent.parent / "build" / "aip_tpu_torch"
    d = Path(os.environ.get("AIP_TPU_TORCH_BUILD", default))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _load_native():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = Path(__file__).with_name("_bitcodec.c")
    try:
        code = src.read_bytes()
        tag = hashlib.sha1(code).hexdigest()[:12]
        so = _build_dir() / f"_bitcodec_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cc = os.environ.get("CC", "cc")
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.pack_bits.restype = ctypes.c_longlong
        lib.pack_bits.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.unpack_canonical.restype = ctypes.c_longlong
        lib.unpack_canonical.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def canonical_codes(lengths_by_symbol: dict) -> tuple:
    """{symbol: code_length} -> (canonical {symbol: (code, length)},
    decode tables (first_code, first_rank, symbols_by_rank, max_len)).

    Standard canonical construction: symbols sorted by (length, symbol);
    ``first_code[l] = (first_code[l-1] + count[l-1]) << 1``.
    """
    items = sorted(lengths_by_symbol.items(), key=lambda kv: (kv[1], kv[0]))
    max_len = max(l for _, l in items)
    count = np.zeros(max_len + 2, np.int64)
    for _, l in items:
        count[l] += 1

    first_code = np.zeros(max_len + 2, np.uint32)
    first_rank = np.zeros(max_len + 2, np.int64)
    code = 0
    rank = 0
    for l in range(1, max_len + 2):
        first_code[l] = code
        first_rank[l] = rank
        if l <= max_len:
            code = (code + int(count[l])) << 1
            rank += int(count[l])

    codes = {}
    symbols_by_rank = np.empty(len(items), np.int64)
    next_in_len = {l: int(first_code[l]) for l in range(1, max_len + 1)}
    for r, (sym, length) in enumerate(items):
        codes[sym] = (next_in_len[length], length)
        next_in_len[length] += 1
        symbols_by_rank[r] = sym
    return codes, (first_code, first_rank, symbols_by_rank, max_len)


def pack(symbols: np.ndarray, codes: dict):
    """Pack a symbol stream with a (code, length) table. Returns
    (bytes_array, total_bits)."""
    syms = np.asarray(symbols)
    keys = np.fromiter(codes.keys(), np.int64, len(codes))
    if keys.min() >= 0 and keys.max() < (1 << 24):
        code_lut = np.zeros(int(keys.max()) + 1, np.uint32)
        len_lut = np.zeros(int(keys.max()) + 1, np.uint8)
        for s, (c, l) in codes.items():
            code_lut[s] = c
            len_lut[s] = l
        code_arr = code_lut[syms]
        len_arr = len_lut[syms]
    else:
        code_arr = np.array([codes[s][0] for s in syms.tolist()], np.uint32)
        len_arr = np.array([codes[s][1] for s in syms.tolist()], np.uint8)
    total_bits = int(len_arr.sum())
    out = np.zeros((total_bits + 7) // 8, np.uint8)

    lib = _load_native()
    if lib is not None:
        lib.pack_bits(
            code_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(code_arr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, total_bits

    ends = np.cumsum(len_arr.astype(np.int64))
    starts = ends - len_arr
    bits = np.zeros(total_bits, np.uint8)
    for i in range(len(code_arr)):
        c, l = int(code_arr[i]), int(len_arr[i])
        for k in range(l):
            bits[starts[i] + k] = (c >> (l - 1 - k)) & 1
    return np.packbits(bits), total_bits


def unpack(packed: np.ndarray, n_symbols: int, decode_tables):
    """Decode a canonical-coded stream. Returns int64 symbols."""
    first_code, first_rank, symbols_by_rank, max_len = decode_tables
    out = np.empty(n_symbols, np.int64)
    packed = np.ascontiguousarray(packed, np.uint8)

    lib = _load_native()
    if lib is not None:
        got = lib.unpack_canonical(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(packed.size) * 8, n_symbols, int(max_len),
            first_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            first_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            symbols_by_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if got == n_symbols:
            return out
        raise ValueError("malformed bitstream")

    bits = np.unpackbits(packed)
    pos = 0
    for i in range(n_symbols):
        code = 0
        length = 0
        while True:
            if length >= max_len or pos >= bits.size:
                raise ValueError("malformed bitstream")
            code = (code << 1) | int(bits[pos])
            pos += 1
            length += 1
            span = first_rank[length + 1] - first_rank[length]
            fc = int(first_code[length])
            if span > 0 and code >= fc and code - fc < span:
                out[i] = symbols_by_rank[first_rank[length] + (code - fc)]
                break
    return out
