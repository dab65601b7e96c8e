"""The launch path every kernel wrapper shares (``aip_tpu_torch/kernels/_build.py``),
on the CPU: the generic tensor check, the launch's error, and each wrapper
module's launch counters.

A CPU tensor that reports a CUDA device stands in for a card's tensor, so
the check's other refusals are reached here; the launch runs a Python
entry point under a stubbed device guard and stream.
"""

import contextlib
import importlib
from types import SimpleNamespace

import pytest
import torch

from aip_tpu_torch.kernels import _build

CARD = torch.device("cuda", 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device."""

    @property
    def device(self):
        return CARD


def _on_card(t):
    return t.as_subclass(_OnCard)


@pytest.mark.parametrize("make,err", [
    (lambda: torch.zeros(4, 16), ValueError),                                  # a CPU tensor
    (lambda: _on_card(torch.zeros(4, 16, dtype=torch.float64)), TypeError),    # wrong dtype
    (lambda: _on_card(torch.zeros(16, 4).t()), ValueError),                    # not contiguous
    (lambda: _on_card(torch.zeros(65)[1:].view(4, 16)), ValueError),           # misaligned
    (lambda: _on_card(torch.zeros(4, 8)), ValueError),                         # wrong shape
    (lambda: _on_card(torch.zeros(4, 16, 1)), ValueError),                     # wrong rank
], ids=["cpu", "dtype", "non_contiguous", "misaligned", "shape", "rank"])
def test_check_refuses_what_a_kernel_cannot_read(make, err):
    good = _on_card(torch.zeros(4, 16))
    _build.check(good, "t", torch.float32, (4, 16), CARD, align=16)
    _build.check(good, "t", (torch.float32, torch.bfloat16), (None, 16), align=16)
    _build.check(good, "t", torch.float32, 2)
    with pytest.raises(err):
        _build.check(make(), "t", torch.float32, (4, 16), CARD, align=16)


def test_check_refuses_a_tensor_on_another_card():
    with pytest.raises(ValueError, match="other inputs on cuda:1"):
        _build.check(_on_card(torch.zeros(3)), "bg", torch.float32, (3,), torch.device("cuda", 1))


def test_launch_passes_pointers_and_the_stream_and_raises_on_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=77))
    calls = []

    def aip_fake(*args):
        calls.append(args)
        return len(calls) - 1          # 0 the first time, then a CUDA error

    t = torch.zeros(3)
    _build.launch(aip_fake, CARD, t, None, 5)
    assert calls == [(t.data_ptr(), None, 5, 77)]
    with pytest.raises(RuntimeError, match="aip_fake failed to launch: CUDA error 1"):
        _build.launch(aip_fake, CARD, t)


COUNTERS = {
    "adain_head": {"encode_head", "decode_tail"},
    "composite": {"composite_macro_mxu_seg", "composite_macro_mxu", "composite_tiles",
                  "composite_from_macro", "composite_macro_blocks"},
    "composite_ad": {"composite_ad_fwd", "composite_ad_bwd"},
    "hashgrad": {"hash_grad"},
    "tvl1": {"tvl1"},
    "conv_epilogue": {"conv_epilogue"},
    "conv3x3_f32": {"conv3x3_f32"},
}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_every_wrapper_counts_its_launches_under_its_keys(name):
    """Each wrapper module's launch_counts() has its kernels' keys and reads
    0 after reset_launch_counts(); adain_head's route_launch_counts() and
    tvl1's iteration_counts() too."""
    mod = importlib.import_module(f"aip_tpu_torch.kernels.{name}")
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(COUNTERS[name], 0)
    if name == "adain_head":
        zero = dict.fromkeys(COUNTERS[name], 0)
        assert mod.route_launch_counts() == {"bf16": zero, "fp32": zero}
    if name == "tvl1":
        assert mod.iteration_counts() == {"tvl1": 0}
