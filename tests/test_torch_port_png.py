"""The PNG writer on the CPU: ``kernels/png_filter.py``'s plain versions
(quantise, filter; the filter is the card kernel's reference) and
``utils/png.py``'s deflate in strips; ``save_image`` and
``save_depth_png`` of host arrays and CPU tensors, which keep PIL's encoder.

* Every file decodes under PIL to exactly the quantised array: 8-bit grey,
  RGB and RGBA and 16-bit grey, at 1x1, 1xN, Nx1, odd widths and heights
  that cross several strips.
* The bytes are the same on 1 thread and on 8; zlib's header keeps the
  level (6 for ``save_image``, 1 for the depth PNG); on smooth noisy
  content the file is within 2 % of PIL's at the same level.
* The filter choice equals a per-row reference written here, ties included.
* ``save_image`` rounds as its numpy rule, a float32 ulp either side of
  every rounding point, and a host array gives PIL's file of those pixels
  byte for byte; ``save_depth_png`` as its float64 rule, a constant map
  included.

The kernel itself runs on the card (test_torch_port_cuda.py).
"""

import io
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from aip_tpu_torch.kernels import png_filter as PF
from aip_tpu_torch.pipelines import adain_infer as tinfer
from aip_tpu_torch.utils import png
from aip_tpu_torch.utils import profiling as P

# (bit depth, channels) the writer takes, and the shapes (H, W) each is held at:
# one pixel, one row, one column, odd widths, and heights crossing strips.
KINDS = [(8, 1), (8, 3), (8, 4), (16, 1)]
SHAPES = [(1, 1), (1, 37), (41, 1), (7, 333), (300, 1001)]


def _decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _image(g, h, w, bits, channels) -> np.ndarray:
    top = 65536 if bits == 16 else 256
    shape = (h, w) if channels == 1 else (h, w, channels)
    # Few distinct values along some rows, so that filters tie.
    a = g.integers(0, top, shape)
    a[::3] = a[::3] // (top // 4) * (top // 4)
    return a.astype(np.uint16 if bits == 16 else np.uint8)


def _rows(a: np.ndarray, bits: int) -> np.ndarray:
    h = a.shape[0]
    if bits == 16:
        return PF.filter_rows(np.ascontiguousarray(a, ">u2").view(np.uint8).reshape(h, -1), 2)
    return PF.filter_rows(a.reshape(h, -1), 1 if a.ndim == 2 else a.shape[2])


def _smooth(seed, h, w, std=0.2):
    """Content like the request cells': coarse noise upsampled bicubically
    plus fine noise, fitted to mean 0.5 and ``std``."""
    gen = torch.Generator().manual_seed(seed)
    img = F.interpolate(torch.rand((1, 3, 24, 24), generator=gen), size=(h, w), mode="bicubic")
    img = img + 0.05 * torch.randn((1, 3, h, w), generator=gen)
    img = (img - img.mean()) / img.std() * std + 0.5
    return img[0].permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bits,channels", KINDS, ids=lambda k: str(k))
def test_the_file_decodes_to_the_array(bits, channels, shape):
    a = _image(np.random.default_rng(sum(shape) + channels), *shape, bits, channels)
    rows = _rows(a, bits)
    data = png.encode(rows, bits, channels, 6)
    got = _decode(data)
    assert got.shape == a.shape and np.array_equal(got.astype(a.dtype), a)
    # The IDAT's stream is the filtered rows, whole.
    idat = data[8 + 25 + 8:-12 - 4]
    assert zlib.decompress(idat) == rows.tobytes()


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("shape", [(300, 1001), (512, 683), (1, 1)], ids=str)
def test_the_bytes_do_not_depend_on_the_thread_count(shape, level):
    a = _image(np.random.default_rng(3), *shape, 8, 3)
    rows = _rows(a, 8)
    with ThreadPoolExecutor(1) as one, ThreadPoolExecutor(8) as eight:
        files = [png.encode(rows, 8, 3, level, ex) for ex in (one, eight, None)]
    assert files[0] == files[1] == files[2]
    assert (len(png.strips(*rows.shape)) > 1) == (shape != (1, 1))


def _filter_reference(raw: np.ndarray, bpp: int) -> np.ndarray:
    """PNG's filters written out row by row, byte by byte where a byte
    looks back, and libpng's choice: the least sum of |signed byte|, the
    first type on a tie."""
    h, n = raw.shape
    out = np.empty((h, n + 1), np.uint8)
    prior = np.zeros(n, np.int64)
    for r in range(h):
        x = raw[r].astype(np.int64)
        cands = [x.copy(), x.copy(), x - prior, x.copy(), x.copy()]
        for i in range(n):
            a = x[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cands[1][i] = x[i] - a
            cands[3][i] = x[i] - (a + b) // 2
            cands[4][i] = x[i] - pred
        best, least = 0, None
        for t, cand in enumerate(cands):
            signed = ((cand % 256) + 128) % 256 - 128
            s = int(np.abs(signed).sum())
            if least is None or s < least:
                best, least = t, s
        out[r, 0] = best
        out[r, 1:] = cands[best] % 256
        prior = x
    return out


@pytest.mark.parametrize("bpp,width", [(1, 1), (1, 17), (2, 9), (3, 11), (4, 8)])
@pytest.mark.parametrize("levels", [2, 3, 256], ids=lambda v: f"{v}levels")
def test_the_filter_choice_matches_a_per_row_reference(bpp, width, levels):
    """Random rows of 2, 3 or 256 distinct byte values: with few values the
    five costs tie often, and the lowest type has to win."""
    g = np.random.default_rng(bpp * 100 + width + levels)
    vals = np.unique(np.linspace(0, 255, levels).astype(np.uint8))
    raw = vals[g.integers(0, len(vals), (24, width * bpp))]
    raw[3] = 0
    raw[7] = raw[6]
    want = _filter_reference(raw, bpp)
    assert np.array_equal(PF.filter_rows(raw, bpp), want)
    if levels == 2:
        assert len(set(want[:, 0])) > 1 and want[3, 0] == 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["image", "depth"])
def test_the_size_is_within_two_percent_of_pils(seed, kind):
    """What the writer is given: ``save_image``'s 8-bit RGB at level 6, and
    ``save_depth_png``'s smooth 16-bit map at level 1."""
    if kind == "image":
        a, level = PF.quantise8(_smooth(seed, 512, 683).numpy()), 6
        ours = png.encode(_rows(a, 8), 8, 3, level)
    else:
        d = _smooth(seed, 768, 1024)[..., 0].double().numpy()
        a, level = PF.quantise16(d), 1
        ours = png.encode(_rows(a, 16), 16, 1, level)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", compress_level=level)
    assert abs(len(ours) / len(buf.getvalue()) - 1) <= 0.02


def _old_save_image_rule(a: np.ndarray) -> np.ndarray:
    a = np.clip(a, 0.0, 1.0)
    return np.clip(np.floor(a * 255.0 + 0.5), 0, 255).astype(np.uint8)


def _rounding_points() -> np.ndarray:
    """A float32 ulp either side of each k/255 + 0.5/255, and the points."""
    mid = ((np.arange(-1, 257) + 0.5) / 255.0).astype(np.float32)
    pts = np.concatenate([np.nextafter(mid, np.float32(-2)), mid, np.nextafter(mid, np.float32(2)),
                          np.float32([0, 1, -0.0, 2, -1, np.inf, -np.inf])])
    return pts.astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "cpu_tensor"])
@pytest.mark.parametrize("suffix", [".png", ".jpg"])
def test_save_image_rounds_as_the_numpy_rule_it_replaced(tmp_path, as_tensor, suffix):
    pts = _rounding_points()
    n = -(-pts.size // 3) * 3
    img = np.resize(pts, n).reshape(1, -1, 3)
    want = _old_save_image_rule(img)
    arr = torch.from_numpy(img) if as_tensor else img
    tinfer.save_image(arr[None], tmp_path / f"x{suffix}")
    if suffix == ".png":
        with Image.open(tmp_path / "x.png") as im:
            assert np.array_equal(np.asarray(im), want)
    else:   # PIL's JPEG of the same pixels, byte for byte
        buf = io.BytesIO()
        Image.fromarray(want).save(buf, format="JPEG")
        assert (tmp_path / "x.jpg").read_bytes() == buf.getvalue()
    raw = PF.png_rows8(torch.from_numpy(img[0]), filtered=False).numpy()
    assert np.array_equal(raw.reshape(want.shape), want)


@pytest.mark.parametrize("shape", [(5, 7, 3), (5, 7, 4), (5, 7), (5, 7, 2), (5, 7, 1)],
                         ids=str)
def test_save_image_of_a_host_array_writes_pils_file(tmp_path, shape):
    """A host array of any shape: PIL's PNG of the numpy rule's pixels,
    byte for byte, or PIL's refusal."""
    img = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    want = _old_save_image_rule(img)
    try:
        buf = io.BytesIO()
        Image.fromarray(want).save(buf, format="PNG")
    except (TypeError, ValueError) as exc:
        with pytest.raises(type(exc)):
            tinfer.save_image(img, tmp_path / "x.png")
        return
    tinfer.save_image(img, tmp_path / "x.png")
    assert (tmp_path / "x.png").read_bytes() == buf.getvalue()


@pytest.mark.parametrize("case", ["ramp", "random", "constant", "transposed"])
def test_save_depth_png_decodes_to_the_float64_rule(tmp_path, case):
    g = np.random.default_rng(5)
    d = {"ramp": np.linspace(-2.0, 3.0, 61 * 47).reshape(61, 47),
         "random": g.standard_normal((300, 257)) * 1e3,
         "constant": np.full((9, 4), 3.0),
         "transposed": g.random((33, 20)).T}[case].astype(np.float32)
    dd = d.astype(np.float64)
    extent = dd.max() - dd.min()
    norm = (dd - dd.min()) / extent if extent > 0 else np.zeros_like(dd)
    want = np.floor(norm * 65535.0 + 0.5).astype(np.uint16)
    t = torch.from_numpy(np.ascontiguousarray(d.T)).T if case == "transposed" \
        else torch.from_numpy(d)
    tinfer.save_depth_png(t, tmp_path / "d.png")
    data = (tmp_path / "d.png").read_bytes()
    got = _decode(data)
    assert got.shape == want.shape and np.array_equal(got.astype(np.uint16), want)
    assert data[42] >> 6 == 0        # zlib's FLEVEL of level 1


def test_save_image_keeps_level_6_and_counts_its_pngs(tmp_path):
    img = _smooth(0, 64, 90)
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tinfer.save_image(img[None], tmp_path / "a.png")
        tinfer.save_image(img, tmp_path / "b.jpg")
        tinfer.save_depth_png(img[..., 0], tmp_path / "c.png")
        stats = P.span_stats()
    assert stats["io.png_writes"] == 2 and stats["io.png_card_filtered"] == 0
    data = (tmp_path / "a.png").read_bytes()
    assert data[42] >> 6 == 2        # zlib's FLEVEL of level 6
    P.reset_spans()


@pytest.mark.parametrize("level", range(10))
def test_the_zlib_header_is_zlibs_own(level):
    assert png.zlib_header(level) == zlib.compress(b"x", level)[:2]


def test_the_writer_refuses_what_png_does_not_hold():
    rows = np.zeros((2, 7), np.uint8)
    with pytest.raises(ValueError):
        png.encode(rows, 16, 3, 6)
    with pytest.raises(ValueError):
        png.encode(rows, 8, 4, 6)        # 6 bytes are no whole 4-byte pixels
    with pytest.raises(ValueError):
        png.deflate(rows, 10)
    with pytest.raises(ValueError):
        PF.png_rows8(torch.zeros(2, 3, 2))
