"""The GUI's widgets: a copy of ``aip_tpu/gui/widgets.py`` for the port
(reference ``utils/draw_helpers.py`` parity), with the same names, geometry
and colours, so that the port's screens equal the JAX package's pixel for
pixel.

Buttons, sliders, radio groups, a scrollable list, the file picker (the
``AIP_TPU_GUI_FILE`` override, then a tkinter dialog, then None), a
loading spinner, image, GIF and video display helpers, and
``PipelineRunner``, which runs a page's job on a worker thread.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

import numpy as np
import pygame

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
GRAY = (180, 180, 180)
DARK = (40, 40, 48)
ACCENT = (90, 140, 255)


def draw_text(text, font, color, surface, x, y, center=True):
    obj = font.render(text, True, color)
    rect = obj.get_rect()
    if center:
        rect.center = (x, y)
    else:
        rect.topleft = (x, y)
    surface.blit(obj, rect)
    return rect


class Button:
    def __init__(self, rect, text, action=None, font_size=24):
        self.rect = pygame.Rect(rect)
        self.text = text
        self.action = action
        self.font = pygame.font.Font(None, font_size)

    def draw(self, surface):
        pygame.draw.rect(surface, GRAY, self.rect, border_radius=6)
        pygame.draw.rect(surface, BLACK, self.rect, 2, border_radius=6)
        draw_text(self.text, self.font, BLACK, surface,
                  self.rect.centerx, self.rect.centery)

    def handle(self, event) -> bool:
        if (event.type == pygame.MOUSEBUTTONDOWN
                and self.rect.collidepoint(event.pos)):
            if self.action:
                self.action()
            return True
        return False


class Slider:
    """Horizontal slider (draw_helpers.draw_sliders/handle_slider_event parity)."""

    def __init__(self, rect, label, lo, hi, value):
        self.rect = pygame.Rect(rect)
        self.label = label
        self.lo, self.hi = lo, hi
        self.value = value
        self.dragging = False
        self.font = pygame.font.Font(None, 20)

    def draw(self, surface):
        pygame.draw.rect(surface, GRAY, self.rect, border_radius=4)
        t = (self.value - self.lo) / (self.hi - self.lo)
        knob_x = self.rect.x + int(t * self.rect.w)
        pygame.draw.circle(surface, ACCENT, (knob_x, self.rect.centery),
                           self.rect.h)
        draw_text(f"{self.label}: {self.value:.2f}", self.font, BLACK, surface,
                  self.rect.centerx, self.rect.y - 12)

    def handle(self, event):
        if event.type == pygame.MOUSEBUTTONDOWN and self.rect.inflate(10, 14).collidepoint(event.pos):
            self.dragging = True
        elif event.type == pygame.MOUSEBUTTONUP:
            self.dragging = False
        elif event.type == pygame.MOUSEMOTION and self.dragging:
            t = (event.pos[0] - self.rect.x) / max(1, self.rect.w)
            self.value = self.lo + min(max(t, 0.0), 1.0) * (self.hi - self.lo)


class RadioGroup:
    def __init__(self, options, selected=0):
        self.options = list(options)
        self.selected = selected
        self.rects = []
        self.font = pygame.font.Font(None, 22)

    def draw(self, surface, x, y, spacing=28):
        self.rects = []
        for i, opt in enumerate(self.options):
            cy = y + i * spacing
            r = pygame.Rect(x, cy - 8, 16, 16)
            pygame.draw.circle(surface, BLACK, r.center, 8, 2)
            if i == self.selected:
                pygame.draw.circle(surface, ACCENT, r.center, 4)
            draw_text(opt, self.font, BLACK, surface, x + 26, cy, center=False)
            self.rects.append(pygame.Rect(x, cy - 10, 150, 22))

    def handle(self, event):
        if event.type == pygame.MOUSEBUTTONDOWN:
            for i, r in enumerate(self.rects):
                if r.collidepoint(event.pos):
                    self.selected = i
                    return True
        return False

    @property
    def value(self):
        return self.options[self.selected]


class ListBox:
    """Scrollable single-select list (the reference second_page's
    1024-palette chooser, `gui/second_page.py:176-298`): mouse-wheel /
    drag scroll, click select, optional incremental type-to-filter."""

    def __init__(self, rect, options, selected=0, row_h=22):
        self.rect = pygame.Rect(rect)
        self.options = list(options)
        self.selected = selected
        self.row_h = row_h
        self.scroll = 0  # first visible row index
        self.filter = ""
        self.font = pygame.font.Font(None, 20)
        self._visible_idx = list(range(len(self.options)))

    def _apply_filter(self):
        f = self.filter.lower()
        self._visible_idx = [i for i, o in enumerate(self.options)
                             if f in o.lower()] if f else list(range(len(self.options)))
        self.scroll = 0

    @property
    def value(self):
        return self.options[self.selected]

    def draw(self, surface):
        pygame.draw.rect(surface, WHITE, self.rect)
        pygame.draw.rect(surface, BLACK, self.rect, 2)
        n_rows = self.rect.h // self.row_h
        vis = self._visible_idx[self.scroll:self.scroll + n_rows]
        for r, i in enumerate(vis):
            y = self.rect.y + r * self.row_h
            if i == self.selected:
                pygame.draw.rect(surface, ACCENT,
                                 (self.rect.x, y, self.rect.w, self.row_h))
            draw_text(self.options[i], self.font,
                      WHITE if i == self.selected else BLACK, surface,
                      self.rect.x + 6, y + self.row_h // 2 - 6, center=False)
        label = f"filter: {self.filter}" if self.filter else \
            f"{len(self._visible_idx)} items"
        draw_text(label, self.font, GRAY, surface,
                  self.rect.x, self.rect.y - 14, center=False)

    def handle(self, event):
        n_rows = self.rect.h // self.row_h
        if event.type == pygame.MOUSEWHEEL:
            self.scroll = max(0, min(len(self._visible_idx) - n_rows,
                                     self.scroll - event.y * 3))
            return True
        if (event.type == pygame.MOUSEBUTTONDOWN
                and self.rect.collidepoint(event.pos)):
            row = (event.pos[1] - self.rect.y) // self.row_h
            vi = self.scroll + row
            if 0 <= vi < len(self._visible_idx):
                self.selected = self._visible_idx[vi]
            return True
        if event.type == pygame.KEYDOWN:
            if event.key == pygame.K_BACKSPACE:
                self.filter = self.filter[:-1]
                self._apply_filter()
                return True
            ch = getattr(event, "unicode", "")
            if ch and (ch.isalnum() or ch in "-_ "):
                self.filter += ch
                self._apply_filter()
                return True
        return False


def open_file_dialog(title="Select file", filetypes=(("Images", "*.png *.jpg *.jpeg"),)):
    """tkinter picker; env-var / console fallback for headless sessions
    (draw_helpers.open_file_dialog parity)."""
    override = os.environ.get("AIP_TPU_GUI_FILE")
    if override:
        return override
    try:
        import tkinter as tk
        from tkinter import filedialog

        root = tk.Tk()
        root.withdraw()
        path = filedialog.askopenfilename(title=title, filetypes=list(filetypes))
        root.destroy()
        return path or None
    except Exception:
        return None


def get_random_file(directory, valid_extensions=(".png", ".jpg", ".jpeg")):
    import random

    files = [p for p in Path(directory).glob("*") if p.suffix.lower() in valid_extensions]
    return str(random.choice(files)) if files else None


def surface_from_array(arr: np.ndarray) -> pygame.Surface:
    """HWC uint8 (or [0,1] float) -> pygame surface."""
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return pygame.surfarray.make_surface(np.transpose(arr, (1, 0, 2)))


def surface_from_file(path, max_size=None) -> pygame.Surface:
    surf = pygame.image.load(str(path))
    if max_size:
        w, h = surf.get_size()
        scale = min(max_size[0] / w, max_size[1] / h, 1.0)
        surf = pygame.transform.smoothscale(surf, (int(w * scale), int(h * scale)))
    return surf


def _fit(surf: pygame.Surface, max_size) -> pygame.Surface:
    if not max_size:
        return surf
    w, h = surf.get_size()
    scale = min(max_size[0] / w, max_size[1] / h, 1.0)
    if scale >= 1.0:
        return surf
    return pygame.transform.smoothscale(surf, (int(w * scale), int(h * scale)))


class AnimatedSurface:
    """Frame-cycling playback for GIF / video results in the result pane.

    The reference plays its 3DGS orbit GIF in-page (first_page.py:76-88
    load_gif_frames + :150-163 frame cycling) and its stylized videos
    through draw_helpers.play_video (:263-308, cv2.VideoCapture loop).
    Here all frames are decoded up front into pygame surfaces and
    `current()` picks by wall-clock against the cumulative per-frame
    durations, so playback speed is independent of the draw loop's
    frame rate.
    """

    def __init__(self, frames, durations):
        assert frames, "no frames"
        self.frames = frames
        self.durations = [max(float(d), 1e-3) for d in durations]
        self.total = sum(self.durations)
        self._cum = []
        acc = 0.0
        for d in self.durations:
            acc += d
            self._cum.append(acc)
        self.t0 = time.time()

    @classmethod
    def from_gif(cls, path, max_size=None) -> "AnimatedSurface":
        from PIL import Image

        im = Image.open(str(path))
        frames, durations = [], []
        try:
            while True:
                frame = im.convert("RGB")
                surf = pygame.image.frombytes(
                    frame.tobytes(), frame.size, "RGB")
                frames.append(_fit(surf, max_size))
                durations.append(im.info.get("duration", 100) / 1000.0)
                im.seek(im.tell() + 1)
        except EOFError:
            pass
        return cls(frames, durations)

    @classmethod
    def from_video(cls, path, max_size=None) -> "AnimatedSurface":
        import cv2

        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise ValueError(f"could not open video {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
        frames = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(_fit(surface_from_array(rgb), max_size))
        cap.release()
        if not frames:
            raise ValueError(f"no frames in {path}")
        return cls(frames, [1.0 / max(fps, 1.0)] * len(frames))

    def current(self) -> pygame.Surface:
        t = (time.time() - self.t0) % self.total
        for i, c in enumerate(self._cum):
            if t < c:
                return self.frames[i]
        return self.frames[-1]

    def get_size(self):
        return self.frames[0].get_size()

    def get_rect(self, **kw):
        return self.frames[0].get_rect(**kw)


def animated_surface_from_file(path, max_size=None):
    """GIF/video -> AnimatedSurface; still image -> plain Surface."""
    sfx = Path(str(path)).suffix.lower()
    if sfx == ".gif":
        anim = AnimatedSurface.from_gif(path, max_size=max_size)
        # single-frame GIFs degrade to a plain surface
        return anim if len(anim.frames) > 1 else anim.frames[0]
    if sfx in (".mp4", ".avi", ".mov", ".mkv", ".webm"):
        return AnimatedSurface.from_video(path, max_size=max_size)
    return surface_from_file(path, max_size=max_size)


class LoadingSpinner:
    """Animated 'Processing...' indicator (draw_helpers.loading_animation)."""

    def __init__(self, message="Processing..."):
        self.message = message
        self.t0 = time.time()
        self.font = pygame.font.Font(None, 28)

    def draw(self, surface, x, y):
        dots = "." * (int((time.time() - self.t0) * 2) % 4)
        draw_text(f"{self.message}{dots}", self.font, ACCENT, surface, x, y)


class PipelineRunner:
    """Run a pipeline callable in a worker thread with a result slot and a
    cancel flag (the reference's threading pattern + pipeline_running guard)."""

    def __init__(self):
        self.thread = None
        self.result = None
        self.error = None
        self.cancel_flag = threading.Event()

    @property
    def running(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def start(self, fn, *args, **kwargs):
        if self.running:
            return False
        self.result = None
        self.error = None
        self.cancel_flag.clear()

        def work():
            try:
                self.result = fn(*args, **kwargs)
            except Exception as e:  # surfaced in the UI, as the reference does
                self.error = e

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()
        return True
