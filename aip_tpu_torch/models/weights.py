"""Weight management: torch checkpoints, the npz cache, fallback init.
Port of ``aip_tpu.models.weights``.

Parameters travel as the reference's flat list of ``{"w": HWIO, "b": [C]}``
numpy arrays ("HWIO params"): that is the npz cache format, and the cache
(``$AIP_TPU_WEIGHTS`` or ``~/.cache/aip_tpu``, files ``vgg_normalised.npz``
and ``adain_decoder.npz``) is shared with ``aip_tpu``. ``from_jax_params``
turns HWIO params, numpy or ``aip_tpu``'s own, into the port's modules;
``hwio_params`` turns them back.

The models whose parameters the JAX package keeps as nested trees (ResNet,
DeepLab, the LPIPS backbones, the ImageNet VGG-19) hold them as a
``ParamTree``: the same keys and nesting, conv weights OIHW, every leaf a
frozen ``nn.Parameter``; ``tree_from_jax`` builds one from the JAX tree.
"""

from __future__ import annotations

import contextlib
import io
import os
import struct
import threading
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.models import decoder as dec_mod
from aip_tpu_torch.models import vgg as vgg_mod
from aip_tpu_torch.utils.profiling import count

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


def _nbytes(params: list[dict]) -> int:
    return sum(p["w"].nbytes + p["b"].nbytes for p in params)


def load_params_npz(path: Path, n_convs: int | None = None) -> list[dict]:
    """HWIO params of the npz cache's first ``n_convs`` convs (all by
    default); the other members are never read. Counts the bytes read as
    ``weights.bytes_read`` (under a profiler)."""
    with np.load(str(path)) as data:
        if n_convs is None:
            n_convs = len([k for k in data.files if k.startswith("w")])
        params = [{"w": data[f"w{i}"], "b": data[f"b{i}"]} for i in range(n_convs)]
    count("weights.bytes_read", _nbytes(params))
    return params


class _PinnedNpz:
    """The npz cache read for a network on a card: the byte span of the
    members asked for, in one ``readinto`` a call, into a page-locked
    buffer that the process keeps (grown as needed, anew in a child after a
    fork). Each member is checked against its CRC-32, as ``np.load`` checks
    it, and given as a numpy view of the buffer, which the card copies
    without a pageable staging copy. The views live until the next read:
    the caller holds the lock until its ``build`` has copied them. A file
    that is not a plain stored npz of C-ordered little-endian float32
    members gives None, and ``np.load`` reads it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf = None     # (pid, pinned uint8 tensor)

    def _buffer(self, n: int) -> np.ndarray:
        if self.buf is None or self.buf[0] != os.getpid() or self.buf[1].numel() < n:
            self.buf = (os.getpid(), torch.empty(max(n, 16 << 20), dtype=torch.uint8,
                                                 pin_memory=True))
        return self.buf[1].numpy()

    def read(self, path: Path, n_convs: int | None) -> list[dict] | None:
        """HWIO params of the first ``n_convs`` convs (all by default) as
        views of the buffer, or None (see the class docstring)."""
        with zipfile.ZipFile(path) as z:
            infos = sorted(z.infolist(), key=lambda i: i.header_offset)
            if not infos:
                return None
            end_of = {i.filename: j.header_offset for i, j in zip(infos, infos[1:])}
            end_of[infos[-1].filename] = z.start_dir
            if n_convs is None:
                n_convs = sum(1 for i in infos if i.filename.startswith("w"))
            names = [f"{k}{i}.npy" for i in range(n_convs) for k in "wb"]
            if not set(names) <= end_of.keys():
                return None
            want = [z.getinfo(n) for n in names]
        if any(i.compress_type != zipfile.ZIP_STORED for i in want):
            return None
        start = min(i.header_offset for i in want)
        size = max(end_of[i.filename] for i in want) - start
        buf = self._buffer(size)
        with open(path, "rb") as f:
            f.seek(start)
            if f.readinto(memoryview(buf)[:size]) != size:
                return None
        arrays = {}
        for info in want:
            at = info.header_offset - start
            head = buf[at:at + 30].tobytes()
            if head[:4] != b"PK\x03\x04":
                return None
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            data = at + 30 + name_len + extra_len
            member = memoryview(buf)[data:data + info.file_size]
            if zlib.crc32(member) != info.CRC:
                raise zipfile.BadZipFile(f"bad CRC-32 for {info.filename} in {path}")
            npy = io.BytesIO(member[:min(info.file_size, 1 << 16)])
            version = np.lib.format.read_magic(npy)
            if version not in ((1, 0), (2, 0)):
                return None
            header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                      else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = header(npy)
            count_ = int(np.prod(shape))
            if fortran or dtype != np.dtype("<f4") or npy.tell() + 4 * count_ != info.file_size:
                return None
            arrays[info.filename] = np.frombuffer(buf, np.float32, count_,
                                                  data + npy.tell()).reshape(shape)
        return [{"w": arrays[f"w{i}.npy"], "b": arrays[f"b{i}.npy"]} for i in range(n_convs)]


_PINNED_NPZ = _PinnedNpz()


# The AdaIN encoder's convs up to relu4_1, the deepest tap any caller asks
# for: the checkpoint's later convs are never run.
_ENCODER_CONVS_USED = len(vgg_mod.conv_specs(
    vgg_mod.VGG_LAYERS[:vgg_mod.VGG_LAYERS.index(("relu", "relu4_1")) + 1]))


def _host_tensor(a) -> torch.Tensor:
    """``a`` as a float32 CPU tensor, sharing the memory of a writable,
    C-contiguous float32 numpy array (others are copied once)."""
    return torch.from_numpy(np.require(a, np.float32, "CW"))


def from_jax_params(params, device=None):
    """HWIO params (``aip_tpu``'s list of ``{"w", "b"}``, numpy or JAX
    arrays) -> ``VGGEncoder`` (all 17 convs, or those up to relu4_1) or
    ``AdaINDecoder`` on ``device``, chosen by the conv shapes. Each array
    goes to the device as it is, in one copy; the HWIO -> OIHW permute
    runs there, into the module's weight."""
    shapes = [tuple(np.shape(p["w"])) for p in params]
    want_vgg = [(k, k, cin, cout) for _, cin, cout, k, _ in vgg_mod.conv_specs()]
    want_dec = [(3, 3, cin, cout) for _, cin, cout, _ in dec_mod.conv_specs()]
    if shapes in (want_vgg, want_vgg[:_ENCODER_CONVS_USED]):
        module = vgg_mod.VGGEncoder(device, len(shapes))
    elif shapes == want_dec:
        module = dec_mod.AdaINDecoder(device)
    else:
        raise ValueError(f"conv shapes {shapes} match neither the VGG encoder "
                         "nor the AdaIN decoder")
    with torch.no_grad():
        for conv, p in zip(module.convs, params):
            w = _host_tensor(p["w"]).to(conv.weight.device)
            conv.weight.copy_(w.permute(3, 2, 0, 1))
            conv.bias.copy_(_host_tensor(p["b"]))
    return module


def hwio_params(module) -> list[dict]:
    """A ``VGGEncoder``'s or ``AdaINDecoder``'s convs as HWIO params (numpy,
    on the host): the inverse of ``from_jax_params``, the form
    ``save_params_npz`` writes."""
    return [{"w": c.weight.detach().permute(2, 3, 1, 0).cpu().numpy(),
             "b": c.bias.detach().cpu().numpy()} for c in module.convs]


class ParamTree(nn.Module):
    """A nested dict of tensors (lists allowed) as one module, read as the
    JAX package reads its parameter trees: ``p["stages"][2][0]["conv1_w"]``.
    Dicts become ``ParamTree``s, lists of trees ``nn.ModuleList``s, lists of
    tensors ``nn.ParameterList``s, tensors frozen float32 parameters (the
    models are inference networks; gradients still flow to the inputs)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            node = tree_module(value)
            if isinstance(node, nn.Parameter):
                self.register_parameter(key, node)
            else:
                self.add_module(key, node)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def tree_module(value):
    """A dict, list or tensor of a parameter tree as ``ParamTree``'s node."""
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (dict, list, tuple)) for v in value):
            return nn.ModuleList(tree_module(v) for v in value)
        return nn.ParameterList(tree_module(v) for v in value)
    return nn.Parameter(torch.from_numpy(np.array(value, np.float32)), requires_grad=False)


def _oihw_leaves(tree):
    """The JAX tree with every 4-D (HWIO conv) leaf transposed to OIHW and
    every leaf a float32 numpy array."""
    if isinstance(tree, dict):
        return {k: _oihw_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_oihw_leaves(v) for v in tree]
    a = np.asarray(tree, np.float32)
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1))) if a.ndim == 4 else a


def tree_from_jax(tree, device=None):
    """A JAX parameter tree (dict or list of dicts; HWIO convs, numpy or JAX
    arrays) -> a ``ParamTree`` (or ``nn.ModuleList`` of them) on ``device``."""
    dev = resolve_device(device)
    return tree_module(_oihw_leaves(tree)).to(dev)


def he_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """He-normal OIHW conv weight ``shape`` drawn on the CPU from ``generator``."""
    fan_in = int(np.prod(shape[1:]))
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


def _convs_used(module, n_convs: int) -> int:
    """How many of a built network's convs its forward passes run: the AdaIN
    encoder's up to relu4_1, every conv of any other network."""
    return _ENCODER_CONVS_USED if isinstance(module, vgg_mod.VGGEncoder) else n_convs


def _get_params(name: str, torch_path, torch_indices, init_fn, device,
                build=from_jax_params, n_convs=None):
    """Cache, then checkpoint, then ``init_fn(device=...)``; ``build`` turns
    HWIO params into the module (the AdaIN networks by default), copying
    what it keeps (on a card it gets ``_PinnedNpz``'s views), from the
    first ``n_convs`` convs (all by default; the cache's others are not
    read). A load from the cache counts the bytes of the convs the network
    runs as ``weights.bytes_used``, beside ``load_params_npz``'s
    ``weights.bytes_read`` (under a profiler)."""
    device = resolve_device(device)
    cache = DEFAULT_WEIGHTS_DIR / f"{name}.npz"
    if cache.is_file():
        with contextlib.ExitStack() as held:
            params = None
            if device.type == "cuda":
                held.enter_context(_PINNED_NPZ.lock)
                params = _PINNED_NPZ.read(cache, n_convs)
                if params is not None:
                    count("weights.bytes_read", _nbytes(params))
            if params is None:
                params = load_params_npz(cache, n_convs)
            module = build(params, device)
        count("weights.bytes_used", _nbytes(params[:_convs_used(module, len(params))]))
        return module
    if torch_path is not None and _is_real_checkpoint(Path(torch_path)):
        params = convert_torch_sequential(_load_torch_state_dict(Path(torch_path)),
                                          torch_indices)
        save_params_npz(params, cache)
        return build(params[:n_convs], device)
    # Deterministic fallback so every pipeline still runs without the
    # pretrained checkpoint. The seed gives other weights than aip_tpu's
    # PRNGKey fallback; point both packages at one cache to share weights.
    return init_fn(device=device)


def get_vgg_params(torch_path=None, device=None) -> vgg_mod.VGGEncoder:
    """The AdaIN encoder; from the cache or a checkpoint it holds the convs
    up to relu4_1 alone, the only ones read."""
    idxs = [spec[4] for spec in vgg_mod.conv_specs()]
    return _get_params("vgg_normalised", torch_path, idxs, vgg_mod.init_vgg_params, device,
                       n_convs=_ENCODER_CONVS_USED)


def get_decoder_params(torch_path=None, device=None) -> dec_mod.AdaINDecoder:
    idxs = [spec[3] for spec in dec_mod.conv_specs()]
    return _get_params("adain_decoder", torch_path, idxs, dec_mod.init_decoder_params,
                       device)
