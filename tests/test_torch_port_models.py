"""aip_tpu_torch.models vs aip_tpu.models on the CPU, fp32, with the same
parameters carried over by ``from_jax_params``. Tolerance: max abs error
over the largest reference value below 1e-4, as test_torch_fidelity.py
holds aip_tpu against a torch mirror."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from aip_tpu.models import decoder as jdec
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import weights as jweights
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.models import weights as tweights

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    """HWIO params (aip_tpu's form) of both nets, drawn with numpy."""
    rng = np.random.default_rng(3)

    def draw(specs):
        return [{"w": jnp.asarray(rng.standard_normal((k, k, cin, cout), np.float32)
                                  * np.float32((2.0 / (k * k * cin)) ** 0.5)),
                 "b": jnp.asarray(rng.standard_normal(cout, np.float32) * np.float32(0.05))}
                for k, cin, cout in specs]

    return (draw([(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()]),
            draw([(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()]))


@pytest.fixture(scope="module")
def port_modules(jax_params):
    return (tweights.from_jax_params(jax_params[0], "cpu"),
            tweights.from_jax_params(jax_params[1], "cpu"))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-3)


@pytest.mark.parametrize("hw", [(37, 45), (32, 32)])
def test_vgg_encode_matches_jax(rng, jax_params, port_modules, hw):
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    ref = jvgg.vgg_encode(jax_params[0], jnp.asarray(x), "relu4_1", jnp.float32)
    out = tvgg.vgg_encode(port_modules[0], torch.from_numpy(x), "relu4_1", torch.float32)
    assert _rel(out, ref) < 1e-4


@pytest.mark.parametrize("taps", [tvgg.STYLE_TAPS, ("relu2_1", "relu3_1")])
def test_vgg_encode_with_intermediate_matches_jax(rng, jax_params, port_modules, taps):
    """STYLE_TAPS walks the layer path; taps from relu2_1 on take the head."""
    x = rng.random((1, 33, 40, 3)).astype(np.float32)
    ref = jvgg.vgg_encode_with_intermediate(jax_params[0], jnp.asarray(x), taps, jnp.float32)
    out = tvgg.vgg_encode_with_intermediate(port_modules[0], torch.from_numpy(x), taps,
                                            torch.float32)
    assert set(out) == set(ref) == set(taps)
    for k in taps:
        assert _rel(out[k], ref[k]) < 1e-4, k


def test_unknown_tap_raises(port_modules):
    with pytest.raises(ValueError):
        tvgg.vgg_encode_with_intermediate(port_modules[0], torch.zeros(1, 32, 32, 3), ("relu9",))


@pytest.mark.parametrize("hw", [(5, 7), (4, 4)])
def test_decoder_apply_matches_jax(rng, jax_params, port_modules, hw):
    f = (rng.standard_normal((2,) + hw + (512,)) * 0.1).astype(np.float32)
    ref = jdec.decoder_apply(jax_params[1], jnp.asarray(f), jnp.float32)
    out = tdec.decoder_apply(port_modules[1], torch.from_numpy(f), torch.float32)
    assert _rel(out, ref) < 1e-4


def test_from_jax_params_rejects_other_shapes(jax_params):
    with pytest.raises(ValueError):
        tweights.from_jax_params(jax_params[0][:5], "cpu")


def test_npz_cache_is_shared_with_aip_tpu(tmp_path, rng, monkeypatch, jax_params, port_modules):
    """An npz written by aip_tpu's save_params_npz loads into the port
    (directly and through get_*_params) with identical outputs."""
    jweights.save_params_npz(jax_params[0], tmp_path / "vgg_normalised.npz")
    jweights.save_params_npz(jax_params[1], tmp_path / "adain_decoder.npz")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    vgg = tweights.get_vgg_params(device="cpu")
    dec = tweights.get_decoder_params(device="cpu")
    direct = tweights.from_jax_params(tweights.load_params_npz(tmp_path / "vgg_normalised.npz"),
                                      "cpu")
    x = torch.from_numpy(rng.random((1, 16, 16, 3)).astype(np.float32))
    for m in (vgg, direct):
        torch.testing.assert_close(tvgg.vgg_encode(m, x), tvgg.vgg_encode(port_modules[0], x),
                                   rtol=0, atol=0)
    f = torch.from_numpy(rng.random((1, 2, 2, 512)).astype(np.float32))
    torch.testing.assert_close(tdec.decoder_apply(dec, f),
                               tdec.decoder_apply(port_modules[1], f), rtol=0, atol=0)
    # and the port's own writer round-trips
    tweights.save_params_npz(tweights.load_params_npz(tmp_path / "adain_decoder.npz"),
                             tmp_path / "again" / "adain_decoder.npz")
    again = jweights.load_params_npz(tmp_path / "again" / "adain_decoder.npz")
    np.testing.assert_array_equal(np.asarray(again[3]["w"]), np.asarray(jax_params[1][3]["w"]))


@pytest.mark.parametrize("past_relu4_1", ["absent", "other shapes"])
def test_get_vgg_params_reads_the_convs_to_relu4_1(tmp_path, rng, monkeypatch, jax_params,
                                                   port_modules, past_relu4_1):
    """The encoder from the cache holds the convs up to relu4_1 alone: the
    npz's later members are never read, so they may be absent or of any
    shape, and relu4_1 is bit-equal to the encoder of the whole file."""
    n = tweights._ENCODER_CONVS_USED
    params = list(jax_params[0][:n])
    if past_relu4_1 == "other shapes":
        params += [{"w": np.zeros((1, 1, 1, 1), np.float32), "b": np.zeros(1, np.float32)}
                   for _ in jax_params[0][n:]]
    tweights.save_params_npz(params, tmp_path / "vgg_normalised.npz")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    vgg = tweights.get_vgg_params(device="cpu")
    assert n == 10 and len(vgg.convs) == n
    x = torch.from_numpy(rng.random((1, 24, 20, 3)).astype(np.float32))
    torch.testing.assert_close(tvgg.vgg_encode(vgg, x, "relu4_1"),
                               tvgg.vgg_encode(port_modules[0], x, "relu4_1"), rtol=0, atol=0)


def _host_pinned_reader(monkeypatch):
    """The npz reader of the card's path with a host array for its buffer
    (page-locking needs a card)."""
    reader = tweights._PinnedNpz()
    monkeypatch.setattr(reader, "_buffer", lambda n: np.zeros(max(n, 1 << 20), np.uint8))
    return reader


@pytest.mark.parametrize("n_convs", [tweights._ENCODER_CONVS_USED, None])
def test_pinned_npz_read_equals_np_load(tmp_path, monkeypatch, jax_params, n_convs):
    """The card's read of the npz cache (the members' span at once, each
    checked against its CRC-32) gives np.load's arrays bit for bit, as
    views of its buffer, and only the first ``n_convs`` convs."""
    tweights.save_params_npz(jax_params[0], tmp_path / "vgg_normalised.npz")
    reader = _host_pinned_reader(monkeypatch)
    got = reader.read(tmp_path / "vgg_normalised.npz", n_convs)
    want = tweights.load_params_npz(tmp_path / "vgg_normalised.npz", n_convs)
    assert len(got) == len(want) == (n_convs or len(jax_params[0]))
    for g, w in zip(got, want):
        for k in "wb":
            assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
            assert np.require(g[k], np.float32, "CW") is g[k]     # uploaded with no copy


@pytest.mark.parametrize("fault", ["compressed", "float64", "missing member", "bad byte"])
def test_pinned_npz_read_leaves_other_files_to_np_load(tmp_path, monkeypatch, jax_params,
                                                       fault):
    """A compressed npz, another dtype or a missing member gives None (then
    np.load reads the file); a member whose bytes fail its CRC-32 raises,
    as np.load does."""
    import zipfile

    path = tmp_path / "adain_decoder.npz"
    params = [{"w": np.asarray(p["w"]), "b": np.asarray(p["b"])} for p in jax_params[1]]
    flat = {f"{k}{i}": p[k] for i, p in enumerate(params) for k in "wb"}
    if fault == "compressed":
        np.savez_compressed(path, **flat)
    elif fault == "float64":
        np.savez(path, **{k: v.astype(np.float64) for k, v in flat.items()})
    elif fault == "missing member":
        np.savez(path, **{k: v for k, v in flat.items() if k != "b3"})
    else:
        np.savez(path, **flat)
        with zipfile.ZipFile(path) as z:
            info = z.getinfo("w2.npy")
        data = bytearray(path.read_bytes())
        data[info.header_offset + 30 + len("w2.npy") + 200] ^= 1
        path.write_bytes(bytes(data))
    reader = _host_pinned_reader(monkeypatch)
    if fault == "bad byte":
        with pytest.raises(zipfile.BadZipFile):
            reader.read(path, None)
        with pytest.raises(zipfile.BadZipFile):
            tweights.load_params_npz(path)
    else:
        assert reader.read(path, len(params)) is None


@pytest.mark.parametrize("taps", [("relu4_2",), ("relu1_1", "relu5_1"), ("relu9",)])
def test_tap_past_the_encoders_convs_raises(jax_params, taps):
    vgg = tweights.from_jax_params(jax_params[0][:tweights._ENCODER_CONVS_USED], "cpu")
    with pytest.raises(ValueError, match="lie past the encoder's 10 convs"):
        tvgg.vgg_encode_with_intermediate(vgg, torch.zeros(1, 32, 32, 3), taps)


def test_fallback_init_is_deterministic_and_device_independent():
    a = tvgg.init_vgg_params(0, "cpu")
    b = tvgg.init_vgg_params(0, "cpu")
    for ca, cb in zip(a.convs, b.convs):
        torch.testing.assert_close(ca.weight, cb.weight, rtol=0, atol=0)
    w = a.convs[5].weight.detach()
    assert abs(float(w.std()) - (2.0 / (128 * 9)) ** 0.5) < 0.01
    assert float(a.convs[5].bias.abs().max()) == 0.0
    d = tdec.init_decoder_params(1, "cpu")
    assert tuple(d.convs[-1].weight.shape) == (3, 64, 3, 3)


def _torch_sequential(params):
    """The reference's torch Sequential (up to relu4_1) holding ``params``."""
    layers, ci = [], 0
    for layer in tvgg.VGG_LAYERS:
        if layer[0] == "conv":
            w = np.transpose(np.asarray(params[ci]["w"]), (3, 2, 0, 1))
            conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2])
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[ci]["b"])))
            layers.append(conv)
            ci += 1
        elif layer[0] == "pad":
            layers.append(nn.ReflectionPad2d(1))
        elif layer[0] == "pool":
            layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        else:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def test_convert_torch_sequential(rng, jax_params, port_modules):
    seq = _torch_sequential(jax_params[0])
    idxs = [spec[4] for spec in tvgg.conv_specs()]
    params = tweights.convert_torch_sequential(seq.state_dict(), idxs)
    jconv = jweights.convert_torch_sequential(
        {k: v.numpy() for k, v in seq.state_dict().items()}, idxs)
    for p, q in zip(params, jconv):
        np.testing.assert_array_equal(p["w"], np.asarray(q["w"]))
    module = tweights.from_jax_params(params, "cpu")
    x = rng.random((1, 20, 24, 3)).astype(np.float32)
    out = tvgg.vgg_encode(module, torch.from_numpy(x))
    # the Sequential itself, cut after relu4_1 (its index 30)
    with torch.no_grad():
        ref = seq[:31](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(out, ref) < 1e-4
    torch.testing.assert_close(out, tvgg.vgg_encode(port_modules[0], torch.from_numpy(x)),
                               rtol=0, atol=0)


def test_torch_checkpoint_is_converted_and_cached(tmp_path, rng, monkeypatch, jax_params,
                                                  port_modules):
    """A .pth state_dict given to get_vgg_params is converted, written to
    the npz cache in aip_tpu's format, and gives the same encoder."""
    ckpt = tmp_path / "vgg_normalised.pth"
    torch.save(_torch_sequential(jax_params[0]).state_dict(), ckpt)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "cache")
    vgg = tweights.get_vgg_params(ckpt, device="cpu")
    cached = jweights.load_params_npz(tmp_path / "cache" / "vgg_normalised.npz")
    np.testing.assert_array_equal(np.asarray(cached[4]["w"]), np.asarray(jax_params[0][4]["w"]))
    x = torch.from_numpy(rng.random((1, 16, 20, 3)).astype(np.float32))
    torch.testing.assert_close(tvgg.vgg_encode(vgg, x), tvgg.vgg_encode(port_modules[0], x),
                               rtol=0, atol=0)
