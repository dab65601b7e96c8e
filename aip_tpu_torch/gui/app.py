"""The GUI's main menu: a port of ``aip_tpu/gui/app.py`` (reference
``main_gui.py`` parity: an 8-button menu in a resizable 800x600 window).

    python -m aip_tpu_torch.gui.app [--device cpu] [--headless]

The device is resolved once, when the App starts (``None``: the card, and
no card is an error there, not at the first Run); every page runs its
pipeline on it.
"""

from __future__ import annotations

import argparse
import os

import pygame

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gui.widgets import Button, draw_text, WHITE, DARK


class App:
    def __init__(self, width: int = 800, height: int = 600, headless: bool = False,
                 device=None):
        self.device = resolve_device(device)
        if headless:
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        pygame.init()
        pygame.font.init()
        self.screen = pygame.display.set_mode((width, height), pygame.RESIZABLE)
        pygame.display.set_caption(f"Style Transfer (PyTorch, {self.device.type})")
        self.font = pygame.font.Font(None, 50)
        self.page = None
        self.running = True

        from aip_tpu_torch.gui.pages import PAGES

        self.buttons = []
        for i, (label, page_cls) in enumerate(PAGES):
            col, row = divmod(i, 4)
            self.buttons.append(Button(
                (160 + col * 260, 200 + row * 70, 240, 50), label,
                action=self._make_opener(page_cls),
            ))

    def _make_opener(self, page_cls):
        def open_page():
            self.page = page_cls(self.screen, self._back_to_menu, self.device)

        return open_page

    def _back_to_menu(self):
        self.page = None

    def draw_menu(self):
        self.screen.fill(DARK)
        draw_text("Style Transfer", self.font, WHITE, self.screen,
                  self.screen.get_width() // 2, 100)
        for b in self.buttons:
            b.draw(self.screen)

    def step(self, events) -> None:
        """One frame: dispatch events, draw. Separated for headless tests."""
        for event in events:
            if event.type == pygame.QUIT:
                self.running = False
            elif self.page is not None:
                self.page.handle(event)
            else:
                for b in self.buttons:
                    b.handle(event)
        if self.page is not None:
            self.page.tick()
            self.page.draw()
        else:
            self.draw_menu()
        pygame.display.flip()

    def run(self):
        clock = pygame.time.Clock()
        while self.running:
            self.step(pygame.event.get())
            clock.tick(30)
        pygame.quit()


def run_app(headless: bool = False, device=None):
    App(headless=headless, device=device).run()


def main(argv=None) -> App:
    """Parse ``--device`` and ``--headless`` and build the App; run it
    unless headless. Returns the App."""
    ap = argparse.ArgumentParser(description="The style-transfer GUI on the PyTorch port")
    ap.add_argument("--device", default=None,
                    help="torch device for every page's pipeline (default: the card)")
    ap.add_argument("--headless", action="store_true",
                    help="SDL's dummy video driver; build the App and return without "
                         "entering the event loop")
    args = ap.parse_args(argv)
    app = App(headless=args.headless, device=args.device)
    if not args.headless:
        app.run()
    return app


if __name__ == "__main__":
    main()
