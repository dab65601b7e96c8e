"""The port's GUI shell (``aip_tpu_torch/gui``) against aip_tpu's, headless
on the CPU (``SDL_VIDEODRIVER=dummy``).

* Screens, pixel for pixel: each JAX page and its port page on offscreen
  800x600 surfaces receive the same events (file picks through
  ``AIP_TPU_GUI_FILE``, radio clicks, slider drags, palette-list typing,
  wheel and clicks) and draw equal arrays; the menu and each page opened
  from it, through both Apps.
* Calls, argument for argument: with every pipeline function the pages
  reach replaced by a recorder in both packages, the same events and Run
  on each page and mode record equal calls; the port's also carry
  ``device``, the App's.
* Real flows: the AdaIN page end to end on shared weights (the saved
  images within BASELINE.md's 1e-3 mean abs) and the pixel-art page with
  "slso8" (every pixel a palette colour, equal to aip_tpu's, as the RGB
  method is in tests/test_torch_port_pixel_art.py).
* aip_tpu's GUI tests' cases on the port, the device rule, and the kernel
  build under threads (the pages run their jobs on worker threads).
"""

import inspect
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

os.environ["SDL_VIDEODRIVER"] = "dummy"
os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")

import pygame  # noqa: E402

from aip_tpu.gui import app as JA  # noqa: E402
from aip_tpu.gui import pages as JP  # noqa: E402
from aip_tpu_torch.gui import app as TA  # noqa: E402
from aip_tpu_torch.gui import jobs  # noqa: E402
from aip_tpu_torch.gui import pages as TP  # noqa: E402
from aip_tpu_torch.gui import widgets as TW  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _pygame():
    pygame.init()
    pygame.font.init()
    yield
    pygame.quit()


def _click(x, y):
    return pygame.event.Event(pygame.MOUSEBUTTONDOWN, {"pos": (x, y), "button": 1})


def _release(x, y):
    return pygame.event.Event(pygame.MOUSEBUTTONUP, {"pos": (x, y), "button": 1})


def _motion(x, y):
    return pygame.event.Event(pygame.MOUSEMOTION, {"pos": (x, y), "rel": (0, 0),
                                                   "buttons": (1, 0, 0)})


def _key(ch, key=pygame.K_a):
    return ("event", pygame.event.Event(pygame.KEYDOWN, {"key": key, "unicode": ch}))


def _wheel(y):
    return ("event", pygame.event.Event(pygame.MOUSEWHEEL, {"x": 0, "y": y}))


def _png(path, rng, h=24, w=32):
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(path)
    return str(path)


@pytest.fixture
def files(tmp_path, rng):
    """Content, three styles and a mask as PNGs from a seed."""
    return {k: _png(tmp_path / f"{k}.png", rng) for k in ("c", "s", "s2", "s3", "m")}


def _pick(path):
    return ("file", path)


def _radio(group, option):
    return ("radio", group, option)


def _slider(index, t):
    return ("slider", index, t)


def _expand(page, step):
    """One script step as the events it stands for on ``page``'s geometry
    (radio rects exist once the page has drawn)."""
    if step[0] == "radio":
        r = page.radios[step[1]].rects[step[2]]
        return [_click(r.x + 4, r.centery)]
    if step[0] == "slider":
        s = page.sliders[step[1]]
        x = s.rect.x + int(step[2] * s.rect.w)
        return [_click(s.rect.x + 1, s.rect.centery), _motion(x, s.rect.centery),
                _release(x, s.rect.centery)]
    if step[0] == "button":
        b = next(b for b in page.buttons if b.text == step[1])
        return [_click(*b.rect.center)]
    assert step[0] == "event", step
    return [step[1]]


def _drive(page, script, monkeypatch, after=None):
    """Apply ``script`` to ``page``, drawing after every step; ``after``
    (if given) is called with the page after each draw."""
    page.draw()
    for step in script:
        if step[0] == "file":
            monkeypatch.setenv("AIP_TPU_GUI_FILE", step[1])
            continue
        for event in _expand(page, step):
            page.handle(event)
        page.tick()
        page.draw()
        if after is not None:
            after(page)


def _screen_script(page_cls, files):
    """Every input of a page: its file pickers, each radio option (last
    first), each slider, the pixel-art list."""
    script = [_pick(files["c"]), ("button", page_cls.content_label)]
    if page_cls.needs_style:
        script += [_pick(files["s"]), ("button", "Select style")]
    return script


# The extra inputs of each page (by PAGES index), after the file pickers.
PAGE_INPUTS = {
    0: [_radio(0, 2), _radio(0, 1), _slider(0, 0.3), _slider(1, 0.8), _slider(2, 0.1)],
    1: [_radio(1, 3), _radio(1, 2), _radio(2, 1), _slider(0, 0.6), _slider(1, 0.25),
        _slider(2, 0.9), _key("s"), _key("l"), _key("", pygame.K_BACKSPACE), _key("o"),
        _wheel(-1), ("list_row", 1), _radio(0, 1), _radio(0, 0)],
    2: [_radio(0, 1), _radio(0, 2), _radio(1, 1), _slider(0, 0.2), _slider(1, 0.7),
        ("button", "Stop")],
    3: [],
    4: [_slider(0, 0.5), _slider(1, 0.4)],
    5: [("file", "s2"), ("button", "Select style 2"), _slider(0, 0.75)],
    6: [_radio(0, 2), _radio(1, 1), _radio(1, 3), _slider(0, 0.6)],
    7: [("file", "s2"), ("button", "Select style 2"), ("file", "s3"),
        ("button", "Select style 3"), ("file", "m"), ("button", "Select RGB mask")],
}


def _page_script(index, files):
    page_cls = JP.PAGES[index][1]
    script = _screen_script(page_cls, files)
    for step in PAGE_INPUTS[index]:
        if step[0] == "file":
            step = _pick(files[step[1]])
        script.append(step)
    return script


def _expand_list_rows(page, script):
    """("list_row", r) as a click on the palette list's row r."""
    lb = getattr(page, "palette_list", None)
    return [("event", _click(lb.rect.x + 5, lb.rect.y + step[1] * lb.row_h + 5))
            if step[0] == "list_row" else step for step in script]


def _state(page):
    return (page.content_path and Path(page.content_path).name,
            page.style_path and Path(page.style_path).name,
            [round(s.value, 9) for s in page.sliders], [r.selected for r in page.radios],
            page.status)


@pytest.mark.parametrize("index", range(8), ids=[label for label, _ in JP.PAGES])
def test_each_page_draws_the_jax_page_pixel_for_pixel(index, files, monkeypatch):
    (jlabel, jcls), (tlabel, tcls) = JP.PAGES[index], TP.PAGES[index]
    assert jlabel == tlabel and jcls.__name__ == tcls.__name__
    js, ts = pygame.Surface((800, 600)), pygame.Surface((800, 600))
    jpage = jcls(js, lambda: None)
    tpage = tcls(ts, lambda: None, CPU)
    assert tpage.device == CPU
    script = _expand_list_rows(jpage, _page_script(index, files))
    frames = {"j": [], "t": []}
    _drive(jpage, script, monkeypatch,
           after=lambda p: frames["j"].append((pygame.surfarray.array3d(js), _state(p))))
    _drive(tpage, script, monkeypatch,
           after=lambda p: frames["t"].append((pygame.surfarray.array3d(ts), _state(p))))
    assert len(frames["j"]) == len(frames["t"]) == len([s for s in script if s[0] != "file"])
    for i, ((ja, jst), (ta, tst)) in enumerate(zip(frames["j"], frames["t"])):
        assert tst == jst, (i, script[i])
        assert np.array_equal(ta, ja), (i, jst)
    assert jpage.content_path == files["c"]
    assert len({a.tobytes() for a, _ in frames["j"]}) > 1   # the script changes the screen
    if hasattr(jpage, "palette_list"):
        assert tpage.palette_list.value == jpage.palette_list.value
        assert tpage.palette_list.filter == jpage.palette_list.filter == "so"


def _app_screen(mod, clicks, **kw):
    app = mod.App(headless=True, **kw)
    try:
        app.step([])
        for c in clicks:
            app.step([_click(*c)])
            app.step([])
        return pygame.surfarray.array3d(app.screen), app
    finally:
        pygame.quit()
        pygame.init()


@pytest.mark.parametrize("index", range(8), ids=[label for label, _ in JP.PAGES])
def test_the_menu_opens_each_page_as_the_jax_menu_does(index):
    jmenu, japp = _app_screen(JA, [])
    tmenu, tapp = _app_screen(TA, [], device="cpu")
    assert np.array_equal(tmenu, jmenu)
    assert [b.text for b in tapp.buttons] == [b.text for b in japp.buttons]
    assert [tuple(b.rect) for b in tapp.buttons] == [tuple(b.rect) for b in japp.buttons]
    center = japp.buttons[index].rect.center
    jpage, japp = _app_screen(JA, [center])
    tpage, tapp = _app_screen(TA, [center], device="cpu")
    assert type(tapp.page).__name__ == type(japp.page).__name__ == JP.PAGES[index][1].__name__
    assert tapp.page.device == tapp.device == CPU
    assert np.array_equal(tpage, jpage)


# ---------------------------------------------------------------------------
# Calls, argument for argument
# ---------------------------------------------------------------------------

# Each pipeline function a page reaches: (module under aip_tpu / aip_tpu_torch, name).
PIPELINE_FUNCTIONS = (
    ("pipelines.adain_infer", "adain_inference"),
    ("gs.pipeline", "run_3dgs_training"),
    ("gs.pipeline", "run_3dgs_rendering"),
    ("pipelines.pixel_art", "pixelize"),
    ("pipelines.pixel_art", "depixelize"),
    ("pipelines.video", "video_to_frames"),
    ("pipelines.video", "apply_style_transfer_ada"),
    ("pipelines.video", "apply_style_transfer"),
    ("pipelines.video", "frames_to_video"),
    ("pipelines.localized", "run_localized_style_transfer"),
    ("pipelines.nst", "mix_styles"),
    ("pipelines.nst", "spatially_varying_style_transfer"),
    ("pipelines.style_mixer", "stylize_with_palette"),
)
ARRAY_RESULTS = ("mix_styles", "spatially_varying_style_transfer", "stylize_with_palette")

CALL_CASES = {
    "adain-simple": (0, [_slider(0, 0.3), _slider(2, 0.7)]),
    "adain-depth-aware": (0, [_radio(0, 1), _slider(1, 0.2)]),
    "adain-3dgs": (0, [_radio(0, 2)]),
    "pixelize": (1, [_radio(1, 2), _radio(2, 1), _slider(0, 0.5), _slider(1, 0.7),
                     _slider(2, 0.3), _key("s"), _key("w"), ("list_row", 2)]),
    "depixelize": (1, [_radio(0, 1)]),
    **{f"video-{flow}-{stylizer}": (2, [_radio(0, f), _radio(1, s), _slider(0, 0.4),
                                        _slider(1, 0.6)])
       for f, flow in enumerate(("farneback", "tvl1", "lk"))
       for s, stylizer in enumerate(("adain", "fast"))},
    "regional": (3, []),
    "depth": (4, [_slider(0, 0.6), _slider(1, 0.25)]),
    "mix": (5, [("file", "s2"), ("button", "Select style 2"), _slider(0, 0.8)]),
    "mix-one-style": (5, [_slider(0, 0.1)]),
    "style-mixer": (6, [_radio(0, 1), _radio(1, 2), _slider(0, 0.45)]),
    "spatial": (7, [("file", "s2"), ("button", "Select style 2"), ("file", "m"),
                    ("button", "Select RGB mask")]),
}


def _norm(x, cancel_flag):
    if x is cancel_flag:
        return "<the page runner's cancel_flag>"
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, cancel_flag) for v in x)
    return x


def _record_pipelines(pkg, monkeypatch, files, calls):
    import importlib

    takes_device = set()
    for mod_name, name in PIPELINE_FUNCTIONS:
        mod = importlib.import_module(f"{pkg}.{mod_name}")
        params = inspect.signature(getattr(mod, name)).parameters
        if "device" in params or any(p.kind is p.VAR_KEYWORD for p in params.values()):
            takes_device.add(name)     # as a parameter, or through **kw

        def recorder(*args, _name=name, **kw):
            calls.append((_name, args, kw))
            if _name in ARRAY_RESULTS:
                return torch.full((4, 4, 3), 0.5) if pkg == "aip_tpu_torch" else \
                    np.full((4, 4, 3), 0.5, np.float32)
            if _name in ("pixelize", "depixelize"):
                return np.zeros((4, 4, 3), np.uint8)
            return files["c"] if _name in ("adain_inference", "run_3dgs_rendering",
                                           "run_localized_style_transfer") else None

        monkeypatch.setattr(mod, name, recorder)
    return takes_device


def _run_page(mod, index, script, monkeypatch, **kw):
    """Open page ``index`` from ``mod``'s App menu, apply ``script``, press
    Run and wait for the job. Returns the page and the App."""
    app = mod.App(headless=True, **kw)
    app.step([])
    app.step([_click(*app.buttons[index].rect.center)])
    page = app.page
    _drive(page, _expand_list_rows(page, script), monkeypatch)
    page.handle(_click(*next(b for b in page.buttons if b.text == "Run").rect.center))
    page.runner.thread.join(timeout=30)
    assert not page.runner.thread.is_alive()
    app.step([])
    return page, app


@pytest.mark.parametrize("case", list(CALL_CASES))
def test_each_page_calls_its_pipeline_as_the_jax_page_does(case, files, tmp_path,
                                                           monkeypatch):
    index, extra = CALL_CASES[case]
    script = _screen_script(JP.PAGES[index][1], files) + [
        _pick(files[s[1]]) if s[0] == "file" else s for s in extra]
    # The video page's scratch directory, the same for both packages.
    scratch = tmp_path / "video"
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: str(scratch))
    recorded = {}
    for pkg, mod, kw in (("aip_tpu", JA, {}), ("aip_tpu_torch", TA, {"device": "cpu"})):
        calls = recorded[pkg] = []
        takes_device = _record_pipelines(pkg, monkeypatch, files, calls)
        page, app = _run_page(mod, index, script, monkeypatch, **kw)
        assert page.runner.error is None, page.runner.error
        flag = page.runner.cancel_flag
        out = []
        for name, args, fkw in calls:
            if pkg == "aip_tpu_torch" and name in takes_device:
                assert fkw.pop("device") == app.device == CPU, name
            out.append((name, _norm(args, flag), {k: _norm(v, flag) for k, v in fkw.items()}))
        recorded[pkg] = (out, page.status)
        pygame.quit()
        pygame.init()
    (jcalls, jstatus), (tcalls, tstatus) = recorded["aip_tpu"], recorded["aip_tpu_torch"]
    assert jcalls, "the page called no pipeline"
    assert tcalls == jcalls
    assert tstatus == jstatus


# ---------------------------------------------------------------------------
# Real flows on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def shared_adain(tmp_path_factory, monkeypatch):
    """One AdaIN weight cache for both packages."""
    from aip_tpu.models import decoder as jdec
    from aip_tpu.models import vgg as jvgg
    from aip_tpu.models import weights as jweights
    from aip_tpu_torch.models import weights as tweights

    rng = np.random.default_rng(14)
    d = tmp_path_factory.mktemp("weights")

    def hwio(specs):
        return [{"w": (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5)
                 .astype(np.float32), "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
                for k, cin, cout in specs]

    jweights.save_params_npz(hwio([(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()]),
                             d / "vgg_normalised.npz")
    jweights.save_params_npz(hwio([(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()]),
                             d / "adain_decoder.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", d)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", d)


def _wait(page, seconds=120):
    page.runner.thread.join(timeout=seconds)
    assert not page.runner.thread.is_alive()
    page.tick()


def test_adain_page_end_to_end_matches_jax(tmp_path, rng, files, shared_adain, monkeypatch):
    """Both AdaIN pages, driven the same way, save images within 1e-3 mean
    abs (decoded) and show a result."""
    script = _screen_script(JP.AdainPage, files) + [_slider(0, 0.7)]
    saved = {}
    for key, page_cls, args in (("j", JP.AdainPage, ()), ("t", TP.AdainPage, (CPU,))):
        (tmp_path / key).mkdir()
        monkeypatch.chdir(tmp_path / key)
        page = page_cls(pygame.Surface((800, 600)), lambda: None, *args)
        _drive(page, script, monkeypatch)
        page._run()
        _wait(page)
        assert page.status == "Done" and page.result_surface is not None, page.status
        saved[key] = np.asarray(Image.open(tmp_path / key / "output" / "gui_adain.jpg"),
                                np.float32) / 255.0
    assert saved["t"].shape == saved["j"].shape
    assert np.abs(saved["t"] - saved["j"]).mean() <= 1e-3


def test_pixel_art_page_with_slso8_matches_jax(tmp_path, rng):
    from aip_tpu_torch.pipelines.pixel_art import hex_palette_to_rgb

    c = _png(tmp_path / "c.png", rng, 24, 24)
    out = {}
    for key, page_cls, args in (("j", JP.PixelArtPage, ()), ("t", TP.PixelArtPage, (CPU,))):
        page = page_cls(pygame.Surface((800, 600)), lambda: None, *args)
        assert len(page.palette_list.options) >= 1024
        page.palette_list.selected = page.palette_list.options.index("slso8")
        page.content_path = c
        page.sliders[1].value = 0.2
        page.sliders[2].value = 0.1
        out[key] = page.run_pipeline()
        page.draw()
    assert out["t"].dtype == np.uint8 and out["t"].shape == out["j"].shape
    pal = hex_palette_to_rgb(TP.PixelArtPage(pygame.Surface((8, 8)), None)._palettes["slso8"])
    assert (out["t"].reshape(-1, 1, 3) == pal[None]).all(-1).any(-1).all()
    assert np.array_equal(out["t"], out["j"])


# ---------------------------------------------------------------------------
# aip_tpu's GUI tests' cases on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def app():
    return TA.App(headless=True, device="cpu")


def test_menu_renders_eight_pages(app):
    app.step([])
    assert len(app.buttons) == 8 and app.page is None
    for label, page_cls in TP.PAGES:
        app.page = page_cls(app.screen, app._back_to_menu, app.device)
        app.step([])
        app.page._back()
        assert app.page is None


def test_run_without_inputs_sets_status(app):
    page = TP.AdainPage(app.screen, app._back_to_menu, app.device)
    page._run()
    assert "Pick input" in page.status


def test_double_run_guard():
    r = TW.PipelineRunner()
    assert r.start(lambda: time.sleep(0.3))
    assert not r.start(lambda: None)
    r.thread.join(timeout=5)
    assert not r.thread.is_alive()


def test_a_failing_job_shows_its_error(app, files, monkeypatch):
    page = TP.DepthPage(app.screen, app._back_to_menu, app.device)
    page.content_path, page.style_path = files["c"], files["s"]

    def boom(*a, **k):
        raise ValueError("no such model")

    monkeypatch.setattr(jobs, "depth_image", boom)
    page._run()
    _wait(page)
    assert page.status == "Error: no such model"


def test_video_page_has_flow_and_stylizer_toggles(app):
    page = TP.VideoPage(app.screen, app._back_to_menu, app.device)
    assert page.radios[0].options == ["farneback", "tvl1", "lk"]
    assert page.radios[1].options == ["AdaIN", "fast stylizer"]


def test_palette_chooser_filters_the_full_lospec_set(app):
    page = TP.PixelArtPage(app.screen, app._back_to_menu, app.device)
    assert len(page.palette_list.options) >= 1024
    assert {"pico-8", "sweetie-16", "slso8"} <= set(page.palette_list.options)
    assert [s.label for s in page.sliders[1:]] == ["brightness", "contrast"]
    for ch in "slso":
        page.palette_list.handle(_key(ch)[1])
    visible = [page.palette_list.options[i] for i in page.palette_list._visible_idx]
    assert "slso8" in visible and len(visible) < 50


def test_gif_result_animates_in_pane(app, tmp_path):
    frames = [Image.fromarray(np.full((20, 24, 3), c, np.uint8)) for c in (10, 120, 240)]
    gif = tmp_path / "orbit.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:], duration=30, loop=0)
    page = TP.AdainPage(app.screen, app._back_to_menu, app.device)
    app.page = page
    page.runner.result = str(gif)
    page._poll_result()
    assert isinstance(page.result_surface, TW.AnimatedSurface)
    assert len(page.result_surface.frames) == 3
    seen = set()
    t0 = time.time()
    while len(seen) < 3 and time.time() - t0 < 3.0:
        seen.add(id(page.result_surface.current()))
        app.step([])
        time.sleep(0.01)
    assert len(seen) == 3, "GIF frames did not cycle"


def test_video_result_plays_in_pane(app, tmp_path):
    import cv2

    path = tmp_path / "out.avi"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 12, (32, 24))
    for c in (0, 128, 255):
        vw.write(np.full((24, 32, 3), c, np.uint8))
    vw.release()
    page = TP.VideoPage(app.screen, app._back_to_menu, app.device)
    app.page = page
    page.runner.result = str(path)
    page._poll_result()
    assert isinstance(page.result_surface, TW.AnimatedSurface)
    assert len(page.result_surface.frames) == 3
    app.step([])


def test_array_results_show_and_single_frame_gifs_degrade(app, tmp_path, rng):
    page = TP.MixPage(app.screen, app._back_to_menu, app.device)
    page.runner.result = rng.random((900, 300, 3)).astype(np.float32)
    page._poll_result()
    assert page.status == "Done" and page.result_surface.get_size() == (140, 420)
    gif = tmp_path / "one.gif"
    Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(gif)
    assert isinstance(TW.animated_surface_from_file(gif), pygame.Surface)


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------

def test_the_app_resolves_its_device_once_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.App(headless=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.main(["--headless"])
    app = TA.main(["--device", "cpu", "--headless"])
    assert isinstance(app, TA.App) and app.device == CPU
    assert "PyTorch" in pygame.display.get_caption()[0]
    app.step([_click(*app.buttons[4].rect.center)])
    assert isinstance(app.page, TP.DepthPage) and app.page.device == CPU


def test_jobs_return_host_arrays_from_tensors(monkeypatch, files):
    """Jobs hand the pages host arrays: the port's tensors are copied back."""
    from aip_tpu_torch.pipelines import nst, style_mixer

    devices = []

    def fake(*a, device=None, **k):
        devices.append(device)
        return torch.full((3, 5, 3), 0.25, requires_grad=True)

    monkeypatch.setattr(nst, "mix_styles", fake)
    monkeypatch.setattr(nst, "spatially_varying_style_transfer", fake)
    monkeypatch.setattr(style_mixer, "stylize_with_palette", fake)
    for out in (jobs.mix(files["c"], files["s"], None, weight=0.5, device=CPU),
                jobs.spatial(files["c"], files["s"], None, None, files["m"], device=CPU),
                jobs.style_mixer(files["c"], files["s"], model="ResNet", palette_name="Vintage",
                                 palette_intensity=0.25, device=CPU)):
        assert isinstance(out, np.ndarray) and out.shape == (3, 5, 3)
    assert devices == [CPU] * 3


# ---------------------------------------------------------------------------
# The kernel build under threads
# ---------------------------------------------------------------------------

def test_kernel_build_and_load_run_once_across_threads(tmp_path, monkeypatch):
    """Eight threads asking for one library at once (pages' workers on a
    cold build directory): one compile, one load, one shared object."""
    import re
    import subprocess

    from aip_tpu_torch.kernels import _build

    compiles, loads = [], []
    target = tmp_path / "x-0123456789ab.so"

    def fake_run(cmd, **kw):
        compiles.append(cmd)
        time.sleep(0.05)        # a compile takes a while: the others must wait
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info", stderr=None)

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_target", lambda name: target)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_loaded", {})
    barrier = threading.Barrier(8)
    got = [None] * 8

    def worker(i):
        barrier.wait()
        got[i] = _build.library("x")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 1 and len(loads) == 1
    assert all(g is got[0] for g in got) and got[0] is not None
    tmp_name = Path(compiles[0][compiles[0].index("-o") + 1]).name
    assert re.fullmatch(rf"x-0123456789ab\.{os.getpid()}\.\d+\.tmp", tmp_name), tmp_name
    assert target.read_bytes() == b"lib"
    assert _build.build("x") == ""      # built already


def test_chip_smoke_drives_each_page_at_its_defaults():
    """``chip_smoke.py`` phase 45 runs each page's job with the page's own
    widget defaults (the card's machine has no pygame to read them from)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from aip_tpu_torch.pipelines.style_mixer import MODEL_LIST, PALETTE_MENU

    screen = pygame.Surface((800, 600))
    pages = {cls.__name__: cls(screen, None, CPU) for _, cls in TP.PAGES}
    d = cs.PAGE_DEFAULTS
    vals = lambda name: [s.value for s in pages[name].sliders]
    assert vals("AdainPage") == [d["AdainPage"][k] for k in
                                 ("alpha", "depth_offset", "depth_prominence")]
    assert pages["AdainPage"].radios[0].selected == 0
    px = pages["PixelArtPage"]
    assert vals("PixelArtPage") == [d["PixelArtPage"][k] for k in
                                    ("downsample", "brightness", "contrast")]
    assert px.palette_list.value == d["PixelArtPage"]["palette"]
    assert (px.radios[2].selected == 1) == d["PixelArtPage"]["grayscale"]
    assert set(cs.PIXEL_METHODS) == set(px.radios[1].options)
    assert vals("VideoPage") == [d["VideoPage"]["alpha"], d["VideoPage"]["offset"]]
    assert vals("DepthPage") == [d["DepthPage"]["depth_offset"],
                                 d["DepthPage"]["depth_prominence"]]
    assert vals("MixPage") == [d["MixPage"]["weight"]]
    sm = pages["StyleMixerPage"]
    assert sm.radios[0].value == MODEL_LIST[d["StyleMixerPage"]["model_index"]]
    assert sm.radios[1].value == PALETTE_MENU[d["StyleMixerPage"]["palette_index"]]
    assert vals("StyleMixerPage") == [d["StyleMixerPage"]["palette_intensity"]]
