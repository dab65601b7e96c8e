"""Compressed model loading: Huffman decode, RVQ decode, hash-grid dequantize.

Port of ``aip_tpu/gs/compress.py``'s load path (reference
``scene/gaussian_model.py:340-396``): ``huffman_decode`` :79,
``_decode_stream`` :98 and ``load_npz`` :309, with the per-level flat hash
stream and the legacy full-table error. Decoding is host numpy through the
port's copy of the C bit codec, with the same numpy arithmetic as the JAX
package, so both packages load bitwise-equal arrays; the tensors are then
placed on ``device``. The save path and ``load_ply`` belong to the
training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams, level_table_sizes_for_cap
from aip_tpu_torch.runtime import bitcodec


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
