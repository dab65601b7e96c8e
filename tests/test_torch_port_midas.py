"""MiDaS-small (slice 7): aip_tpu_torch.models.midas against
aip_tpu.models.midas on the CPU, on inputs drawn with numpy from a seed.

Tolerances: the forward 1e-4 of the largest |value| (as
``tests/test_midas_fidelity.py`` holds the JAX converter; the port reads
2e-5 from JAX at 64^2 with random BN statistics, 1.6e-5 from its own
float64 run); a hub-layout module 1e-5 of the largest |value| (the same
ops in the same order, 3e-7); the depth estimator at 40x52 1e-4 of the
largest |value| (2.5e-5 from JAX with the seeded init).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aip_tpu.models import depthnet as jdepth
from aip_tpu.models import midas as jmidas
from aip_tpu_torch.models import depthnet as tdepth
from aip_tpu_torch.models import midas as tmidas

torch.set_num_threads(4)

TOL = 1e-4
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def hub_sd():
    """A hub-layout state dict drawn with numpy: He-normal convs, random BN
    statistics and affine terms, so that every mapping shows."""
    g = np.random.default_rng(0)
    sd = {}
    for k, v in tmidas.MidasNet().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif v.ndim == 4:
            sd[k] = (g.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[1:]))
                     ).astype(np.float32)
        elif k.endswith(("running_var", ".weight")):
            sd[k] = (g.random(v.shape) + 0.5).astype(np.float32)
        else:
            sd[k] = (g.standard_normal(v.shape) * 0.1).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(1).random((1, 64, 64, 3)).astype(np.float32)


def _jax_forward(params, x):
    return np.asarray(jax.jit(lambda a: jmidas.midas_inverse_depth(params, a))(jnp.asarray(x)))


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_inverse_depth_matches_jax_with_its_params_carried_across(hub_sd, x64):
    params = jmidas._convert_torch_midas(hub_sd)
    net = tmidas.from_jax_params(params, "cpu")
    ref = _jax_forward(params, x64)
    out = tmidas.midas_inverse_depth(net, torch.from_numpy(x64)).numpy()
    assert out.shape == ref.shape == (1, 64, 64)
    assert _rel(out, ref) <= TOL
    # from_jax_params puts every array where the hub keeps it.
    got = net.state_dict()
    assert set(got) == set(hub_sd)
    for k, v in hub_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_state_dict_through_the_jax_converter_gives_the_same_forward(x64):
    """The port's seeded module -> ``state_dict()`` -> the JAX package's
    ``_convert_torch_midas``: the same forward, and every key read but the
    BN step counters."""
    net = tmidas.init_midas_params(torch.Generator().manual_seed(3), device="cpu")
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    read = set()

    class Spy(dict):
        def __getitem__(self, k):
            read.add(k)
            return sd[k]

        def __contains__(self, k):
            return k in sd

    params = jmidas._convert_torch_midas(Spy())
    assert set(sd) - read == {k for k in sd if k.endswith("num_batches_tracked")}
    out = tmidas.midas_inverse_depth(net, torch.from_numpy(x64)).numpy()
    assert _rel(out, _jax_forward(params, x64)) <= TOL


def test_hub_layout_state_dict_loads_strictly(x64):
    """The JAX package's mirror of the hub's ``MidasNet_small`` (its own
    module names and forward): its state dict loads with ``strict=True`` and
    the port computes what it computes."""
    path = Path(__file__).resolve().parent / "test_midas_fidelity.py"
    spec = importlib.util.spec_from_file_location("midas_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mirror = mod.MidasMirror().eval()
    net = tmidas.MidasNet()
    net.load_state_dict(mirror.state_dict(), strict=True)
    with torch.no_grad():
        ref = mirror(torch.from_numpy(((x64 - MEAN) / STD).transpose(0, 3, 1, 2)))[:, 0]
    out = net(torch.from_numpy(x64))
    assert _rel(out.detach().numpy(), ref.numpy()) <= 1e-5


def test_get_midas_params_reads_a_real_checkpoint_and_falls_back(tmp_path, hub_sd):
    ckpt = tmp_path / "midas_v21_small_256.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in hub_sd.items()}, ckpt)
    net = tmidas.get_midas_params(ckpt, device="cpu")
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), hub_sd[k], err_msg=k)
    stub = tmp_path / "stub.pt"
    stub.write_text("version https://git-lfs.github.com/spec/v1\n")
    seeded = tmidas.get_midas_params(stub, device="cpu")
    again = tmidas.init_midas_params(device="cpu")
    for (k, a), b in zip(seeded.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert not any(p.requires_grad for p in seeded.parameters())


def test_use_midas_estimator_matches_jax(monkeypatch):
    net = tmidas.init_midas_params(device="cpu")
    params = jmidas._convert_torch_midas({k: v.numpy() for k, v in net.state_dict().items()})
    monkeypatch.setattr(jdepth, "_REGISTERED", None)
    monkeypatch.setattr(tdepth, "_REGISTERED", None)
    img = np.random.default_rng(2).random((40, 52, 3)).astype(np.float32)
    classical = tdepth.estimate_proximity(img, device="cpu")
    monkeypatch.setattr(jmidas, "get_midas_params", lambda p=None: params)
    monkeypatch.setattr(tmidas, "get_midas_params", lambda p=None, device=None: net)
    jmidas.use_midas("unused.pt")
    tmidas.use_midas("unused.pt", device="cpu")
    ref = np.asarray(jdepth.estimate_proximity(img))
    out = tdepth.estimate_proximity(img)
    assert out.shape == ref.shape == (40, 52) and out.device.type == "cpu"
    assert _rel(out.numpy(), ref) <= TOL
    # uint8 and tensor inputs read as the classical path reads them.
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_allclose(tdepth.estimate_proximity(u8).numpy(),
                               tdepth.estimate_proximity(u8.astype(np.float32) / 255).numpy(),
                               rtol=0, atol=1e-6 * np.abs(ref).max())
    assert torch.equal(tdepth.estimate_proximity(torch.from_numpy(img)), out)
    tdepth.register_depth_model(None)
    assert torch.equal(tdepth.estimate_proximity(img, device="cpu"), classical)


def test_estimator_refuses_a_tensor_on_another_device():
    net = tmidas.init_midas_params(device="cpu")
    est = tmidas.make_depth_estimator(net)
    img = torch.zeros(8, 8, 3, device="meta")
    with pytest.raises(ValueError, match="weights are on cpu"):
        est(img)


def test_midas_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdepth, "_REGISTERED", None)
    for call in (lambda: tmidas.init_midas_params(), lambda: tmidas.get_midas_params(),
                 lambda: tmidas.use_midas(None),
                 lambda: tmidas.from_jax_params(
                     jmidas._convert_torch_midas(
                         {k: v.numpy() for k, v in tmidas.MidasNet().state_dict().items()}))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tdepth._REGISTERED is None
