"""A compressed Compact-3DGS checkpoint (``model.npz``) read as plain data:
positions and opacities in float16; scales and rotations as residual
vector quantisation (6 codebooks of 64 entries, summed); the hash tables
quantised (``hash_q * hash_scale``), a level that is stored densely holding
only its own rows; the index and table streams entropy-coded with canonical
Huffman codes (symbols sorted by (length, symbol), bits most significant
first). The decoder runs on the tensors' device: every bit position's code
is read at once, and the chain of code starts is followed by pointer
doubling.
"""

from __future__ import annotations

import numpy as np
import torch


def _canonical(syms, lens):
    """first_code, count and the symbols in rank order, by length."""
    order = sorted(zip(lens.tolist(), syms.tolist()))
    max_len = max(l for l, _ in order)
    count = np.zeros(max_len + 1, np.int64)
    for l, _ in order:
        count[l] += 1
    first = np.zeros(max_len + 1, np.int64)
    first_rank = np.zeros(max_len + 1, np.int64)
    code = rank = 0
    for l in range(1, max_len + 1):
        first[l], first_rank[l] = code, rank
        code = (code + int(count[l])) << 1
        rank += int(count[l])
    return first, first_rank, count, np.array([s for _, s in order], np.int64), max_len


def decode_stream(packed, syms, lens, n: int, device) -> torch.Tensor:
    """The first ``n`` symbols of a canonical-coded bit stream (int64)."""
    first, first_rank, count, by_rank, max_len = _canonical(np.asarray(syms), np.asarray(lens))
    bits = torch.from_numpy(np.unpackbits(np.asarray(packed, np.uint8))).to(device)
    n_bits = bits.numel()
    pad = torch.cat([bits.long(), torch.zeros(max_len, dtype=torch.long, device=device)])
    length = torch.zeros(n_bits, dtype=torch.long, device=device)
    symbol = torch.zeros(n_bits, dtype=torch.long, device=device)
    code = torch.zeros(n_bits, dtype=torch.long, device=device)
    by_rank_t = torch.from_numpy(by_rank).to(device)
    for l in range(1, max_len + 1):
        code = (code << 1) | pad[l - 1:l - 1 + n_bits]
        if count[l] == 0:
            continue
        off = code - int(first[l])
        hit = (length == 0) & (off >= 0) & (off < int(count[l]))
        length = torch.where(hit, torch.full_like(length, l), length)
        rank = (int(first_rank[l]) + off).clamp(0, len(by_rank) - 1)
        symbol = torch.where(hit, by_rank_t[rank], symbol)
    # Code starts: 0, then p + length(p), followed by pointer doubling.
    nxt = torch.arange(n_bits, device=device) + length.clamp(min=1)
    nxt = torch.cat([nxt.clamp(max=n_bits), torch.tensor([n_bits], device=device)])
    idx = torch.arange(n, device=device)
    pos = torch.zeros(n, dtype=torch.long, device=device)
    k = 0
    while (1 << k) < n:
        step = ((idx >> k) & 1).bool()
        pos = torch.where(step, nxt[pos], pos)
        nxt = nxt[nxt]
        k += 1
    if int(pos.max()) >= n_bits or bool((length[pos] == 0).any()):
        raise ValueError("malformed bit stream")
    return symbol[pos]


def load(path, device) -> tuple[dict, dict]:
    """(Gaussian leaves: xyz, scaling (log), rotation, opacity (logit);
    colour-field leaves) as float32 tensors on ``device``."""
    with np.load(str(path)) as d:
        d = {k: d[k] for k in d.files}

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def rvq(prefix):
        idx = decode_stream(d[f"{prefix}_packed"], d[f"{prefix}_syms"], d[f"{prefix}_lens"],
                            int(d[f"{prefix}_n"]), device).reshape(tuple(d[f"{prefix}_shape"]))
        books = t(d[f"{prefix}_books"])
        return sum(books[q][idx[:, q]] for q in range(books.shape[0]))

    g = {"xyz": t(d["xyz"]), "opacity": t(d["opacity"]),
         "scaling": torch.log(torch.clamp(rvq("sc"), min=1e-8)), "rotation": rvq("ro")}
    levels, cap, feats = (int(s) for s in d["hash_shape"])
    flat = decode_stream(d["hash_packed"], d["hash_syms"], d["hash_lens"], int(d["hash_n"]),
                         device).reshape(-1, feats)
    tables = torch.zeros((levels, cap, feats), device=device)
    off = 0
    for lvl in range(levels):
        res = int(16 * 1.447 ** lvl)
        rows = min(-(-((res + 1) ** 3) // 8) * 8, cap)
        if flat.shape[0] == levels * cap:
            rows = cap
        tables[lvl, :rows] = flat[off:off + rows].float()
        off += rows
    f = {"hash_tables": tables * float(d["hash_scale"])}
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        f[f"mlp_{k}"] = t(d[f"mlp_mlp_{k}"])
    f["style_w"], f["style_b"] = t(d["style_w"]), t(d["style_b"])
    return g, f
