"""Weight management: torch checkpoints, the npz cache, fallback init.
Port of ``aip_tpu.models.weights``.

Parameters travel as the reference's flat list of ``{"w": HWIO, "b": [C]}``
numpy arrays ("HWIO params"): that is the npz cache format, and the cache
(``$AIP_TPU_WEIGHTS`` or ``~/.cache/aip_tpu``, files ``vgg_normalised.npz``
and ``adain_decoder.npz``) is shared with ``aip_tpu``. ``from_jax_params``
turns HWIO params, numpy or ``aip_tpu``'s own, into the port's modules.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.models import decoder as dec_mod
from aip_tpu_torch.models import vgg as vgg_mod

DEFAULT_WEIGHTS_DIR = Path(os.environ.get("AIP_TPU_WEIGHTS", Path.home() / ".cache" / "aip_tpu"))


def _is_real_checkpoint(path: Path) -> bool:
    """Reject git-LFS pointer stubs (~130-byte text files)."""
    try:
        return path.is_file() and path.stat().st_size > 4096
    except OSError:
        return False


def convert_torch_sequential(state_dict, torch_indices) -> list[dict]:
    """Map a torch Sequential state_dict (OIHW convs keyed ``'0.weight'`` or
    ``'features.0.weight'``) to HWIO params, in ``torch_indices`` order."""
    params = []
    for idx in torch_indices:
        w = np.asarray(state_dict[f"{idx}.weight"], dtype=np.float32)
        b = np.asarray(state_dict[f"{idx}.bias"], dtype=np.float32)
        params.append({"w": np.transpose(w, (2, 3, 1, 0)), "b": b})
    return params


def _load_torch_state_dict(path: Path):
    # weights_only: a checkpoint is outside input, and unpickling it in
    # full could run arbitrary code; the reference ships state_dicts.
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in state.items()}


def save_params_npz(params: list[dict], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for i, p in enumerate(params):
        flat[f"w{i}"] = np.asarray(p["w"])
        flat[f"b{i}"] = np.asarray(p["b"])
    np.savez(str(path), **flat)


def load_params_npz(path: Path) -> list[dict]:
    with np.load(str(path)) as data:
        n = len([k for k in data.files if k.startswith("w")])
        return [{"w": data[f"w{i}"], "b": data[f"b{i}"]} for i in range(n)]


def from_jax_params(params, device=None):
    """HWIO params (``aip_tpu``'s list of ``{"w", "b"}``, numpy or JAX
    arrays) -> ``VGGEncoder`` or ``AdaINDecoder`` on ``device``, chosen by
    the conv shapes."""
    shapes = [tuple(np.shape(p["w"])) for p in params]
    want_vgg = [(k, k, cin, cout) for _, cin, cout, k, _ in vgg_mod.conv_specs()]
    want_dec = [(3, 3, cin, cout) for _, cin, cout, _ in dec_mod.conv_specs()]
    if shapes == want_vgg:
        module = vgg_mod.VGGEncoder(device)
    elif shapes == want_dec:
        module = dec_mod.AdaINDecoder(device)
    else:
        raise ValueError(f"conv shapes {shapes} match neither the VGG encoder "
                         "nor the AdaIN decoder")
    with torch.no_grad():
        for conv, p in zip(module.convs, params):
            w = np.transpose(np.asarray(p["w"], dtype=np.float32), (3, 2, 0, 1))
            conv.weight.copy_(torch.tensor(w))
            conv.bias.copy_(torch.tensor(np.asarray(p["b"], dtype=np.float32)))
    return module


def _get_params(name: str, torch_path, torch_indices, init_fn, device):
    device = resolve_device(device)
    cache = DEFAULT_WEIGHTS_DIR / f"{name}.npz"
    if cache.is_file():
        return from_jax_params(load_params_npz(cache), device)
    if torch_path is not None and _is_real_checkpoint(Path(torch_path)):
        params = convert_torch_sequential(_load_torch_state_dict(Path(torch_path)),
                                          torch_indices)
        save_params_npz(params, cache)
        return from_jax_params(params, device)
    # Deterministic fallback so every pipeline still runs without the
    # pretrained checkpoint. The seed gives other weights than aip_tpu's
    # PRNGKey fallback; point both packages at one cache to share weights.
    return init_fn(device=device)


def get_vgg_params(torch_path=None, device=None) -> vgg_mod.VGGEncoder:
    idxs = [spec[4] for spec in vgg_mod.conv_specs()]
    return _get_params("vgg_normalised", torch_path, idxs, vgg_mod.init_vgg_params, device)


def get_decoder_params(torch_path=None, device=None) -> dec_mod.AdaINDecoder:
    idxs = [spec[3] for spec in dec_mod.conv_specs()]
    return _get_params("adain_decoder", torch_path, idxs, dec_mod.init_decoder_params,
                       device)
