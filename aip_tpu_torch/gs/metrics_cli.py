"""Scene evaluation: PSNR / SSIM / LPIPS over rendered vs GT test views.
Port of ``aip_tpu.gs.metrics_cli``.

Parity with reference `Style_3DGS/metrics.py:36-93` ``evaluate``: walks
``<model>/test/ours_<iter>/{renders,gt}``, computes per-view metrics, writes
``results.json`` and ``per_view.json`` (with the LPIPS weights' provenance,
``lpips_weights``). ``python -m aip_tpu_torch.gs.metrics_cli -m MODEL_DIR
[--no_lpips] [--device cuda|cpu]``; ``device=None`` means CUDA.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.ops.metrics import psnr, ssim


def _read_dir(d: Path):
    from PIL import Image

    names = sorted(p.name for p in d.iterdir() if p.suffix.lower() in (".png", ".jpg"))
    imgs = [np.asarray(Image.open(d / n).convert("RGB"), np.float32) / 255.0 for n in names]
    return names, imgs


@torch.no_grad()
def evaluate(model_paths, use_lpips: bool = True, device=None) -> dict:
    """Returns {model_path: {method: {SSIM, PSNR, LPIPS}}} and writes the
    reference's two json files per model."""
    dev = resolve_device(device)
    results_all = {}
    vgg16 = None
    lin_weights = None
    lpips_provenance = None
    if use_lpips:
        from aip_tpu_torch.models.lpips import get_lin_weights, get_vgg16_params

        vgg16 = get_vgg16_params(device=dev)
        lin_weights = get_lin_weights("vgg", device=dev)
        lpips_provenance = "learned" if lin_weights is not None else "uniform-fallback"
        if lin_weights is None:
            print(
                "WARNING: LPIPS lin weights unavailable — using the UNIFORM "
                "per-channel fallback. Scores are self-consistent but NOT "
                "comparable to published LPIPS values (results.json records "
                "lpips_weights='uniform-fallback').",
                file=sys.stderr,
            )

    for model_path in model_paths:
        model_path = Path(model_path)
        test_dir = model_path / "test"
        full_dict, per_view = {}, {}
        for method_dir in sorted(test_dir.iterdir()) if test_dir.exists() else []:
            if not method_dir.is_dir():
                continue
            names, renders = _read_dir(method_dir / "renders")
            _, gts = _read_dir(method_dir / "gt")
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(r)[None].to(dev)
                gt = torch.from_numpy(g)[None].to(dev)
                ssims.append(float(ssim(rt, gt)))
                psnrs.append(float(psnr(rt, gt)[0, 0]))
                if vgg16 is not None:
                    from aip_tpu_torch.models.lpips import lpips

                    lpipss.append(float(lpips(rt, gt, vgg16, lin_weights=lin_weights)[0]))
            method = method_dir.name
            full_dict[method] = {
                "SSIM": float(np.mean(ssims)) if ssims else None,
                "PSNR": float(np.mean(psnrs)) if psnrs else None,
                "LPIPS": float(np.mean(lpipss)) if lpipss else None,
            }
            if lpips_provenance is not None:
                full_dict[method]["lpips_weights"] = lpips_provenance
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)) if lpipss else {},
            }
        (model_path / "results.json").write_text(json.dumps(full_dict, indent=True))
        (model_path / "per_view.json").write_text(json.dumps(per_view, indent=True))
        results_all[str(model_path)] = full_dict
    return results_all


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Evaluate rendered scenes.")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)
    out = evaluate(args.model_paths, use_lpips=not args.no_lpips, device=args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
