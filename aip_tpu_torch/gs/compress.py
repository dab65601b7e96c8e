"""Model compression and storage: post-quant, Huffman, npz and PLY save/load.

Port of ``aip_tpu/gs/compress.py`` (reference ``scene/gaussian_model.py``):

* the canonical Huffman codec (``huffman_build`` :35, ``huffman_encode``
  :63, ``huffman_decode`` :79, ``_encode_stream`` / ``_decode_stream``,
  ``huffman_size_bytes`` :107) through the port's copy of the C bit codec;
* ``post_quant`` :120 (8-bit hash-grid quantisation), ``sort_active_by_
  morton`` :137, ``save_npz`` :147 with the storage report, ``load_npz``
  :309 (the per-level flat hash stream and the legacy full-table error);
* ``save_ply`` :231 / ``load_ply`` :264, the standard 3DGS PLY.

Everything is host numpy with the JAX package's arithmetic, so a
``model.npz`` written by either package loads in the other; tensors are
placed on ``device`` at the boundary.
"""

from __future__ import annotations

import heapq
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams, level_table_sizes_for_cap
from aip_tpu_torch.ops.morton import morton_encode_np
from aip_tpu_torch.runtime import bitcodec


def huffman_build(symbols: np.ndarray) -> dict:
    """Symbol frequencies -> {symbol: (code_int, code_len)}."""
    freq = Counter(symbols.tolist())
    if len(freq) == 1:
        (s,) = freq
        return {s: (0, 1)}
    heap = [(f, i, s, None, None) for i, (s, f) in enumerate(freq.items())]
    heapq.heapify(heap)
    counter = len(heap)
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        heapq.heappush(heap, (a[0] + b[0], counter, None, a, b))
        counter += 1
    codes = {}

    def walk(node, code, length):
        _f, _i, sym, left, right = node
        if sym is not None:
            codes[sym] = (code, max(length, 1))
            return
        walk(left, code << 1, length + 1)
        walk(right, (code << 1) | 1, length + 1)

    walk(heap[0], 0, 0)
    return codes


def huffman_encode(symbols: np.ndarray):
    """Returns (packed_bytes, codes, n_symbols, total_bits): code lengths
    from the Huffman tree, canonical codes, packed by the bit codec."""
    lengths = {s: l for s, (_c, l) in huffman_build(symbols).items()}
    codes, _tables = bitcodec.canonical_codes(lengths)
    packed, total_bits = bitcodec.pack(np.asarray(symbols), codes)
    return packed, codes, len(symbols), total_bits


def _encode_stream(symbols: np.ndarray) -> dict:
    """A flat int stream as npz-storable arrays: the packed bitstream and
    the (symbol, code-length) table."""
    packed, codes, n, total_bits = huffman_encode(symbols)
    syms = np.fromiter(codes.keys(), np.int64, len(codes))
    lens = np.fromiter((codes[int(s)][1] for s in syms), np.uint8, len(syms))
    return {"packed": packed, "syms": syms, "lens": lens,
            "n": np.int64(n), "bits": np.int64(total_bits)}


def huffman_size_bytes(symbols: np.ndarray) -> float:
    """Entropy-coded size in bytes (codebook overhead excluded)."""
    codes = huffman_build(symbols)
    freq = Counter(symbols.tolist())
    return sum(freq[s] * codes[s][1] for s in freq) / 8.0


def post_quant(param: np.ndarray, prune: bool = False):
    """8-bit uniform quantisation (:580-588 parity); returns (dequantized,
    int_codes, scale). ``prune`` zeroes entries with |value| < scale."""
    max_val = np.abs(param).max()
    scale = max_val / 127.0 if max_val > 0 else 1.0
    q = np.round(param / scale).astype(np.int8)
    if prune:
        q = np.where(np.abs(param) < scale, 0, q)
    return q.astype(np.float32) * scale, q, scale


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def sort_active_by_morton(state: G.GaussianState) -> np.ndarray:
    """Active indices in Morton order (:687-699)."""
    active = _np(state.active)
    xyz = _np(state.xyz)[active]
    lo, hi = xyz.min(0), xyz.max(0)
    grid = ((2 ** 21 - 1) * (xyz - lo) / np.maximum(hi - lo, 1e-12)).astype(np.uint64)
    order = np.argsort(morton_encode_np(grid), kind="stable")
    return np.nonzero(active)[0][order]


def save_npz(path, state: G.GaussianState, field, rvq_scale: rvq_mod.RVQState,
             rvq_rot: rvq_mod.RVQState, style_dim: int = 256) -> str:
    """Compressed save (save_npz parity); returns the storage report."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    order = sort_active_by_morton(state)

    xyz = _np(state.xyz)[order].astype(np.float16)
    opacity = _np(state.opacity)[order].astype(np.float16)
    scales = _np(G.get_scaling(state))[order]
    rots = _np(G.get_rotation(state))[order]
    books_s = rvq_mod.RVQState(rvq_scale.codebooks.detach().cpu())
    books_r = rvq_mod.RVQState(rvq_rot.codebooks.detach().cpu())
    with torch.no_grad():
        sc_idx = rvq_mod.quantize(books_s, torch.from_numpy(scales))[1].numpy().astype(np.int32)
        ro_idx = rvq_mod.quantize(books_r, torch.from_numpy(rots))[1].numpy().astype(np.int32)

    # Only each level's effective rows are serialized.
    tables_np = _np(field.hash_tables)
    lvl_sizes = level_table_sizes_for_cap(tables_np.shape[1], tables_np.shape[0])
    hash_flat = np.concatenate([tables_np[i, :s] for i, s in enumerate(lvl_sizes)], axis=0)
    _hash_q, hash_codes, hash_scale = post_quant(hash_flat, prune=True)

    mlp = {f"mlp_{k}": _np(getattr(field, k)).astype(np.float16)
           for k in ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2", "mlp_w3", "mlp_b3")}
    if field.style_w is not None:
        mlp["style_w"] = _np(field.style_w).astype(np.float16)
        mlp["style_b"] = _np(field.style_b).astype(np.float16)

    sc_stream = _encode_stream(sc_idx.ravel())
    ro_stream = _encode_stream(ro_idx.ravel())
    hash_stream = _encode_stream(hash_codes.ravel().astype(np.int64))
    sc_books = _np(books_s.codebooks).astype(np.float16)
    ro_books = _np(books_r.codebooks).astype(np.float16)
    np.savez_compressed(
        str(path), xyz=xyz, opacity=opacity,
        sc_shape=np.asarray(sc_idx.shape), ro_shape=np.asarray(ro_idx.shape),
        sc_books=sc_books, ro_books=ro_books,
        hash_shape=np.asarray(tables_np.shape), hash_scale=np.asarray(hash_scale),
        **{f"sc_{k}": v for k, v in sc_stream.items()},
        **{f"ro_{k}": v for k, v in ro_stream.items()},
        **{f"hash_{k}": v for k, v in hash_stream.items()},
        **mlp)

    pos_mb = xyz.nbytes / 1e6
    sc_mb = (sc_stream["packed"].nbytes + sc_books.nbytes) / 1e6
    ro_mb = (ro_stream["packed"].nbytes + ro_books.nbytes) / 1e6
    op_mb = opacity.nbytes / 1e6
    hash_mb = hash_stream["packed"].nbytes / 1e6
    mlp_mb = sum(v.nbytes for v in mlp.values()) / 1e6
    total = pos_mb + sc_mb + ro_mb + op_mb + hash_mb + mlp_mb
    return ("Storage\n"
            f"position: {round(pos_mb, 6)}\n"
            f"scale: {round(sc_mb, 6)}\n"
            f"rotation: {round(ro_mb, 6)}\n"
            f"opacity: {round(op_mb, 6)}\n"
            f"hash: {round(hash_mb, 6)}\n"
            f"mlp: {round(mlp_mb, 6)}\n"
            f"total: {round(total, 6)} MB")


def save_ply(path, state: G.GaussianState, field=None, style_f=None) -> str:
    """Standard 3DGS PLY export (save_ply parity, :254-293), the
    style-conditioned neural SH baked into f_dc / f_rest."""
    from aip_tpu_torch.gs.colorfield import predict_sh
    from aip_tpu_torch.gs.dataset import write_ply

    active = _np(state.active)
    xyz = _np(state.xyz)[active]
    extra = {}
    if field is not None:
        with torch.no_grad():
            sh = _np(predict_sh(field, state.xyz[state.active], style_f))   # [n, 16, 3]
        f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(len(xyz), -1)
        for i in range(3):
            extra[f"f_dc_{i}"] = sh[:, 0, i]
        for i in range(f_rest.shape[1]):
            extra[f"f_rest_{i}"] = f_rest[:, i]
    extra["opacity"] = _np(state.opacity)[active][:, 0]
    for i in range(3):
        extra[f"scale_{i}"] = _np(state.scaling)[active][:, i]
    for i in range(4):
        extra[f"rot_{i}"] = _np(state.rotation)[active][:, i]
    write_ply(path, xyz, rgb=None, extra=extra)
    return str(path)


def load_ply(path, capacity: int | None = None, device=None):
    """Load a standard 3DGS PLY (load_ply parity, :398-432). Returns
    (GaussianState, baked_sh [C, 16, 3] or None) on ``device``."""
    from aip_tpu_torch.gs.dataset import read_ply

    dev = resolve_device(device)
    d = read_ply(path)
    n = len(d["x"])
    cap = capacity or n
    xyz = np.stack([d["x"], d["y"], d["z"]], 1).astype(np.float32)
    opacity = d.get("opacity", np.zeros(n)).astype(np.float32)[:, None]
    scaling = np.stack([d[f"scale_{i}"] for i in range(3)], 1).astype(np.float32)
    rotation = np.stack([d[f"rot_{i}"] for i in range(4)], 1).astype(np.float32)

    def pad(x, fill=0.0):
        return np.pad(x, [(0, cap - n)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dtype=torch.float32, device=dev)

    sh = None
    if "f_dc_0" in d:
        f_dc = np.stack([d[f"f_dc_{i}"] for i in range(3)], 1)
        n_rest = len([k for k in d if k.startswith("f_rest_")])
        if n_rest:
            f_rest = np.stack([d[f"f_rest_{i}"] for i in range(n_rest)], 1)
            f_rest = f_rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
        else:
            f_rest = np.zeros((n, 15, 3))
        sh = t(pad(np.concatenate([f_dc[:, None, :], f_rest], axis=1).astype(np.float32)))
    rot = pad(rotation)
    rot[n:, 0] = 1.0
    state = G.GaussianState(
        xyz=t(pad(xyz)), scaling=t(pad(scaling)), rotation=t(rot),
        opacity=t(pad(opacity, -10.0)), mask=t(pad(np.ones((n, 1), np.float32))),
        active=torch.arange(cap, device=dev) < n, max_radii2d=torch.zeros(cap, device=dev),
        xyz_grad_accum=torch.zeros((cap, 1), device=dev), denom=torch.zeros((cap, 1), device=dev))
    return state, sh


def huffman_decode(packed: np.ndarray, codes: dict, n_symbols: int) -> np.ndarray:
    lengths = {s: l for s, (_c, l) in codes.items()}
    _codes, tables = bitcodec.canonical_codes(lengths)
    return bitcodec.unpack(np.asarray(packed), n_symbols, tables)


def _decode_stream(d, prefix: str) -> np.ndarray:
    lengths = {int(s): int(l) for s, l in zip(d[f"{prefix}_syms"], d[f"{prefix}_lens"])}
    _codes, tables = bitcodec.canonical_codes(lengths)
    return bitcodec.unpack(np.asarray(d[f"{prefix}_packed"]), int(d[f"{prefix}_n"]), tables)


def _rvq_decode_host(books: np.ndarray, indices: np.ndarray) -> np.ndarray:
    return rvq_mod.decode(rvq_mod.RVQState(torch.from_numpy(books)),
                          torch.from_numpy(np.asarray(indices, np.int64))).numpy()


def load_npz(path, capacity: int | None = None, device=None):
    """Load a compressed checkpoint. Returns (GaussianState,
    ColorFieldParams, RVQState scale, RVQState rotation) on ``device``
    (``None`` means CUDA). Scales/rotations are decoded from RVQ indices."""
    dev = resolve_device(device)
    d = np.load(str(path))
    n = d["xyz"].shape[0]
    cap = capacity or n

    sc_books = d["sc_books"].astype(np.float32)
    ro_books = d["ro_books"].astype(np.float32)
    if "sc_packed" in d:
        sc_idx = _decode_stream(d, "sc").reshape(tuple(d["sc_shape"]))
        ro_idx = _decode_stream(d, "ro").reshape(tuple(d["ro_shape"]))
    else:  # pre-entropy-coded format
        sc_idx, ro_idx = d["sc_idx"], d["ro_idx"]
    scales = _rvq_decode_host(sc_books, sc_idx)
    rots = _rvq_decode_host(ro_books, ro_idx)

    def pad(x, fill=0.0):
        return np.pad(x, [(0, cap - n)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    rotation = pad(rots).astype(np.float32)
    rotation[n:, 0] = 1.0

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dtype=dtype, device=dev)

    state = G.GaussianState(
        xyz=t(pad(d["xyz"].astype(np.float32))),
        scaling=t(pad(np.log(np.maximum(scales, 1e-8)))),
        rotation=t(rotation),
        opacity=t(pad(d["opacity"].astype(np.float32), -10.0)),
        mask=t(pad(np.ones((n, 1), np.float32))),
        active=torch.arange(cap, device=dev) < n,
        max_radii2d=torch.zeros(cap, device=dev),
        xyz_grad_accum=torch.zeros((cap, 1), device=dev),
        denom=torch.zeros((cap, 1), device=dev),
    )

    hash_shape = tuple(int(s) for s in d["hash_shape"])
    if "hash_packed" in d:
        hash_q = _decode_stream(d, "hash")
    else:  # pre-entropy-coded format
        hash_q = d["hash_q"].reshape(-1, hash_shape[-1])
    l_lv, t_cap, f_f = hash_shape
    lvl_sizes = level_table_sizes_for_cap(t_cap, l_lv)
    if hash_q.size == int(np.prod(hash_shape)):
        if sum(lvl_sizes) != l_lv * t_cap:
            # A full [L, T, F] stream at a cap where coarse levels are
            # dense comes from a save made before dense-level indexing:
            # its coarse rows cannot be remapped onto the dense layout.
            raise ValueError(
                f"{path}: legacy full-table hash stream (pre dense-level "
                "indexing). Re-train or re-save the model; coarse-level "
                "rows cannot be remapped onto the dense layout.")
        hash_q = hash_q.reshape(hash_shape)
    else:
        # Flat per-level-sized stream: re-pad each level to the uniform cap.
        flat = hash_q.reshape(-1, f_f)
        full = np.zeros(hash_shape, flat.dtype)
        off = 0
        for i, s in enumerate(lvl_sizes):
            full[i, :s] = flat[off:off + s]
            off += s
        hash_q = full
    hash_tables = hash_q.astype(np.float32) * d["hash_scale"]
    field = ColorFieldParams(
        hash_tables=t(hash_tables),
        mlp_w1=t(d["mlp_mlp_w1"].astype(np.float32)),
        mlp_b1=t(d["mlp_mlp_b1"].astype(np.float32)),
        mlp_w2=t(d["mlp_mlp_w2"].astype(np.float32)),
        mlp_b2=t(d["mlp_mlp_b2"].astype(np.float32)),
        mlp_w3=t(d["mlp_mlp_w3"].astype(np.float32)),
        mlp_b3=t(d["mlp_mlp_b3"].astype(np.float32)),
        style_w=t(d["style_w"].astype(np.float32)) if "style_w" in d else None,
        style_b=t(d["style_b"].astype(np.float32)) if "style_b" in d else None,
    )
    return (state, field, rvq_mod.RVQState(t(sc_books)), rvq_mod.RVQState(t(ro_books)))
