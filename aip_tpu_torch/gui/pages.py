"""The eight pipeline pages: a port of ``aip_tpu/gui/pages.py`` (reference
``gui/*.py`` parity, condensed onto a shared PipelinePage chassis: file
pickers, sliders/radios, threaded run, result display), with the same
widgets, positions, labels, defaults and ``PAGES`` order.

Each page takes the App's ``device``; its ``run_pipeline`` is one call into
``gui.jobs`` with ``device=self.device``, run on the page's
``PipelineRunner`` thread."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pygame

from aip_tpu_torch.gui import jobs
from aip_tpu_torch.gui.widgets import (
    Button, Slider, RadioGroup, ListBox, LoadingSpinner, PipelineRunner,
    animated_surface_from_file, draw_text, open_file_dialog,
    surface_from_file, surface_from_array,
    WHITE, BLACK, DARK,
)


class PipelinePage:
    """Common chassis: pick inputs, tweak params, run threaded, show result."""

    title = "Pipeline"
    needs_style = True
    content_label = "Select content"
    radio_y = 260            # top of the radio column (pages with extra
    result_pos = (240, 90)   # buttons/widgets override these to avoid
    result_max = (420, 420)  # overlap)

    def __init__(self, screen, go_back, device=None):
        self.screen = screen
        self.device = device
        self.go_back = go_back
        self.content_path = None
        self.style_path = None
        self.runner = PipelineRunner()
        self.spinner = LoadingSpinner()
        self.result_surface = None
        self.status = ""
        self.font = pygame.font.Font(None, 36)
        w, h = screen.get_size()
        self.buttons = [
            Button((20, h - 60, 100, 40), "Back", self._back),
            Button((20, 80, 180, 40), self.content_label, self._pick_content),
        ]
        if self.needs_style:
            self.buttons.append(Button((20, 130, 180, 40), "Select style", self._pick_style))
        self.buttons.append(Button((20, 190, 180, 40), "Run", self._run))
        self.sliders: list[Slider] = []
        self.radios: list[RadioGroup] = []
        self.active = True
        self.setup()

    # Overridables (each page also defines run_pipeline, its job) ------
    def setup(self):
        pass

    # Internals --------------------------------------------------------
    def _back(self):
        self.active = False
        self.go_back()

    def _pick_content(self):
        p = open_file_dialog("Select content")
        if p:
            self.content_path = p

    def _pick_style(self):
        p = open_file_dialog("Select style")
        if p:
            self.style_path = p

    def _run(self):
        if self.runner.running:
            return
        if self.content_path is None or (self.needs_style and self.style_path is None):
            self.status = "Pick input files first"
            return
        self.status = ""
        self.spinner = LoadingSpinner()
        self.runner.start(self.run_pipeline)

    def _poll_result(self):
        if self.runner.running:
            return
        if self.runner.error is not None:
            self.status = f"Error: {self.runner.error}"
            self.runner.error = None
        elif self.runner.result is not None:
            res = self.runner.result
            self.runner.result = None
            try:
                if isinstance(res, (str, Path)) and Path(str(res)).suffix.lower() in (
                        ".png", ".jpg", ".jpeg", ".gif", ".mp4", ".avi",
                        ".mov", ".mkv", ".webm"):
                    # GIFs animate and videos play in-pane
                    # (first_page.py:150-163, draw_helpers.py:263-308).
                    self.result_surface = animated_surface_from_file(
                        res, max_size=self.result_max)
                elif isinstance(res, np.ndarray):
                    surf = surface_from_array(res)
                    w, h = surf.get_size()
                    scale = min(self.result_max[0] / w, self.result_max[1] / h, 1.0)
                    if scale < 1.0:
                        surf = pygame.transform.smoothscale(
                            surf, (int(w * scale), int(h * scale)))
                    self.result_surface = surf
                self.status = "Done"
            except Exception as e:
                self.status = f"Result display failed: {e}"

    def draw(self):
        self.screen.fill(DARK)
        draw_text(self.title, self.font, WHITE, self.screen,
                  self.screen.get_width() // 2, 30)
        for b in self.buttons:
            b.draw(self.screen)
        for s in self.sliders:
            s.draw(self.screen)
        y = self.radio_y
        for r in self.radios:
            r.draw(self.screen, 30, y)
            y += 30 * len(r.options) + 10
        small = pygame.font.Font(None, 20)
        if self.content_path:
            draw_text(Path(self.content_path).name, small, WHITE, self.screen, 110, 72)
        if self.style_path:
            draw_text(Path(self.style_path).name, small, WHITE, self.screen, 110, 122)
        if self.runner.running:
            self.spinner.draw(self.screen, self.screen.get_width() // 2, 60)
        if self.status:
            draw_text(self.status, small, WHITE, self.screen,
                      self.screen.get_width() // 2, self.screen.get_height() - 20)
        if self.result_surface is not None:
            surf = (self.result_surface.current()
                    if hasattr(self.result_surface, "current")
                    else self.result_surface)
            rect = surf.get_rect()
            rect.topleft = self.result_pos
            self.screen.blit(surf, rect)

    def handle(self, event):
        for b in self.buttons:
            b.handle(event)
        for s in self.sliders:
            s.handle(event)
        for r in self.radios:
            r.handle(event)

    def tick(self):
        self._poll_result()


class AdainPage(PipelinePage):
    """Page 1 (first_page/GUI.py): AdaIN with depth controls + 3DGS
    train/render (the reference page launches 3DGS and plays the GIF,
    gui/first_page.py:103-121)."""

    title = "2D Stylization (AdaIN)"

    def setup(self):
        self.sliders = [
            Slider((220, 540, 160, 8), "alpha", 0.0, 1.0, 0.5),
            Slider((420, 540, 160, 8), "depth offset", 0.0, 1.0, 0.5),
            Slider((620, 540, 160, 8), "prominence", 1.0, 100.0, 20.0),
        ]
        self.radios = [RadioGroup(["simple", "depth-aware", "3DGS scene"], 0)]

    def run_pipeline(self):
        if self.radios[0].selected == 2:
            # content_path is a scene directory for the 3DGS mode.
            return jobs.adain_3dgs(self.content_path, self.style_path, device=self.device)
        return jobs.adain_image(
            self.content_path, self.style_path,
            alpha=self.sliders[0].value,
            depth_offset=self.sliders[1].value,
            depth_prominence=self.sliders[2].value,
            use_depth=self.radios[0].selected == 1,
            device=self.device,
        )


class PixelArtPage(PipelinePage):
    """Page 2 (second_page): pixelize with the FULL Lospec palette chooser
    (1024 palettes, scrollable + type-to-filter), brightness/contrast and
    grayscale controls (second_page.py:176-298) / depixelize."""

    title = "Pixel Art"
    needs_style = False
    result_pos = (440, 90)   # the palette list occupies x 220-420
    result_max = (350, 440)

    def setup(self):
        from aip_tpu_torch.pipelines.pixel_art import load_lospec_palettes

        self._palettes = load_lospec_palettes()
        names = sorted(self._palettes)
        self.radios = [
            RadioGroup(["Pixelize", "Depixelize"], 0),
            RadioGroup(["RGB", "LAB", "Floyd-Steinberg", "kd-tree"], 0),
            RadioGroup(["color", "grayscale"], 0),
        ]
        self.sliders = [
            Slider((220, 540, 160, 8), "downsample", 1, 16, 4),
            Slider((420, 540, 160, 8), "brightness", -1.0, 1.0, 0.0),
            Slider((620, 540, 160, 8), "contrast", -1.0, 1.0, 0.0),
        ]
        self.palette_list = ListBox((220, 100, 200, 330), names,
                                    selected=names.index("pico-8"))

    def draw(self):
        super().draw()
        if self.radios[0].selected == 0:
            self.palette_list.draw(self.screen)
            # Swatch of the selected palette under the list.
            pal = self._palettes[self.palette_list.value]
            for i, hexc in enumerate(pal[:16]):
                c = tuple(int(hexc.lstrip("#")[j:j + 2], 16) for j in (0, 2, 4))
                pygame.draw.rect(self.screen, c,
                                 (220 + i * 12, 436, 12, 12))

    def handle(self, event):
        super().handle(event)
        if self.radios[0].selected == 0:
            self.palette_list.handle(event)

    def run_pipeline(self):
        if self.radios[0].selected == 0:
            return jobs.pixelize_image(
                self.content_path, self._palettes[self.palette_list.value],
                downsample=self.sliders[0].value,
                grayscale=self.radios[2].selected == 1,
                brightness=self.sliders[1].value,
                contrast=self.sliders[2].value,
                method=self.radios[1].value, device=self.device,
            )
        return jobs.depixelize_image(self.content_path)


class VideoPage(PipelinePage):
    """Page 3 (third_page): video stylization with cancel support, flow
    method (farneback/tvl1/lk, the reference's Farneback-vs-DualTVL1
    switch) and stylizer (AdaIN vs fast magenta-style) toggles."""

    title = "Video Style Transfer"
    radio_y = 300  # keep the radio column clear of the Stop button (y 240-280)

    def setup(self):
        self.sliders = [
            Slider((220, 540, 160, 8), "blend alpha", 0.0, 1.0, 0.7),
            Slider((420, 540, 160, 8), "depth offset", 0.0, 1.0, 0.3),
        ]
        self.radios = [
            RadioGroup(["farneback", "tvl1", "lk"], 0),
            RadioGroup(["AdaIN", "fast stylizer"], 0),
        ]
        self.buttons.append(Button((20, 240, 180, 40), "Stop",
                                   lambda: self.runner.cancel_flag.set()))

    def run_pipeline(self):
        return jobs.stylize_video(
            self.content_path, self.style_path,
            flow_method=self.radios[0].value,
            fast=self.radios[1].selected == 1,
            alpha=self.sliders[0].value, offset=self.sliders[1].value,
            cancel_flag=self.runner.cancel_flag, device=self.device,
        )


class SemanticPage(PipelinePage):
    """Page 4 (fourth_page): regional style transfer."""

    title = "Regional Style Transfer"

    def run_pipeline(self):
        return jobs.regional(self.content_path, self.style_path, device=self.device)


class DepthPage(PipelinePage):
    """Page 5 (fifth_page): depth-aware-only controls."""

    title = "Depth-Aware Stylization"

    def setup(self):
        self.sliders = [
            Slider((220, 540, 160, 8), "depth offset", 0.0, 1.0, 0.15),
            Slider((420, 540, 160, 8), "prominence", 1.0, 100.0, 20.0),
        ]

    def run_pipeline(self):
        return jobs.depth_image(
            self.content_path, self.style_path,
            depth_offset=self.sliders[0].value,
            depth_prominence=self.sliders[1].value, device=self.device,
        )


class MixPage(PipelinePage):
    """Page 6 (six_page): two-style Gram mixing."""

    title = "Style Mixing (two styles)"

    def setup(self):
        self.style2_path = None
        self.buttons.append(Button((20, 240, 180, 40), "Select style 2",
                                   self._pick_style2))
        self.sliders = [Slider((220, 540, 160, 8), "style 1 weight", 0.0, 1.0, 0.5)]

    def _pick_style2(self):
        p = open_file_dialog("Select second style")
        if p:
            self.style2_path = p

    def run_pipeline(self):
        return jobs.mix(self.content_path, self.style_path, self.style2_path,
                        weight=self.sliders[0].value, device=self.device)


class StyleMixerPage(PipelinePage):
    """Page 7 (seven_page): multi-backbone NST with palette post."""

    title = "Style Mixer (multi-backbone)"

    def setup(self):
        from aip_tpu_torch.pipelines.style_mixer import PALETTE_MENU, MODEL_LIST

        self.radios = [RadioGroup(MODEL_LIST, 0), RadioGroup(PALETTE_MENU, 4)]
        self.sliders = [Slider((220, 540, 160, 8), "palette intensity", 0.0, 1.0, 0.25)]

    def run_pipeline(self):
        return jobs.style_mixer(
            self.content_path, self.style_path,
            model=self.radios[0].value,
            palette_name=self.radios[1].value,
            palette_intensity=self.sliders[0].value, device=self.device,
        )


class SpatialPage(PipelinePage):
    """Page 8 (eight_page): 3 styles + color-coded mask."""

    title = "Spatially-Varying Style Transfer"

    def setup(self):
        self.style2_path = None
        self.style3_path = None
        self.mask_path = None
        self.buttons += [
            Button((20, 240, 180, 40), "Select style 2",
                   lambda: setattr(self, "style2_path", open_file_dialog())),
            Button((20, 290, 180, 40), "Select style 3",
                   lambda: setattr(self, "style3_path", open_file_dialog())),
            Button((20, 340, 180, 40), "Select RGB mask",
                   lambda: setattr(self, "mask_path", open_file_dialog())),
        ]

    def run_pipeline(self):
        return jobs.spatial(self.content_path, self.style_path, self.style2_path,
                            self.style3_path, self.mask_path, device=self.device)


PAGES = [
    ("3DGS / AdaIN Pipeline", AdainPage),
    ("Pixel Art Pipeline", PixelArtPage),
    ("Video Pipeline", VideoPage),
    ("Semantic Segmentation", SemanticPage),
    ("Depth Stylization", DepthPage),
    ("Style Mixing", MixPage),
    ("Style Mixer", StyleMixerPage),
    ("Spatial Variation", SpatialPage),
]
