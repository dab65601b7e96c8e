"""The pygame GUI shell on the PyTorch port (a port of ``aip_tpu/gui``).

Eight pipeline pages behind a menu, as in the JAX package:
1. 2D AdaIN / depth-aware / 3DGS stylization
2. Pixel art: pixelize + depixelize
3. Video style transfer
4. Regional (semantic) style transfer
5. Depth-only stylization controls
6. Two-style Gram mixing
7. Multi-backbone style mixer with palettes
8. Spatially-varying style transfer

Each page's pipeline call is a function of ``gui.jobs`` (no pygame), run on
a worker thread so the UI stays responsive. ``run_app`` imports pygame
only when it is called, so ``import aip_tpu_torch.gui.jobs`` works on a
machine without it. Headless-safe: ``SDL_VIDEODRIVER=dummy`` renders
offscreen.
"""


def run_app(headless: bool = False, device=None):
    """Start the GUI (``gui.app.run_app``) on ``device`` (None: the card)."""
    from aip_tpu_torch.gui.app import run_app as _run_app

    _run_app(headless=headless, device=device)
