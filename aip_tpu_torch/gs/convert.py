"""COLMAP preprocessing (reference `Style_3DGS/convert.py` parity). Port
of ``aip_tpu.gs.convert``: host code, no torch.

Shells out to the ``colmap`` binary (feature extraction -> exhaustive
matching -> mapping -> undistortion) and optionally builds a resize pyramid
(PIL replaces ImageMagick). Gated: raises a clear error when colmap is not
installed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path


def _run(cmd: list) -> None:
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{result.stderr[-2000:]}")


def convert_scene(
    source_path,
    camera: str = "OPENCV",
    colmap_executable: str = "",
    resize: bool = False,
    magick_executable: str = "",  # accepted for arg parity; PIL is used
    no_gpu: bool = True,
    skip_matching: bool = False,
) -> str:
    """Run the COLMAP pipeline over ``source_path/input`` images."""
    colmap = colmap_executable or shutil.which("colmap")
    if not colmap:
        # Undistortion needs the binary even when matching is skipped.
        raise RuntimeError(
            "colmap binary not found; install COLMAP or pass colmap_executable"
        )
    source = Path(source_path)
    use_gpu = 0 if no_gpu else 1

    if not skip_matching:
        (source / "distorted" / "sparse").mkdir(parents=True, exist_ok=True)
        _run([colmap, "feature_extractor",
              "--database_path", source / "distorted" / "database.db",
              "--image_path", source / "input",
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", camera,
              "--SiftExtraction.use_gpu", str(use_gpu)])
        _run([colmap, "exhaustive_matcher",
              "--database_path", source / "distorted" / "database.db",
              "--SiftMatching.use_gpu", str(use_gpu)])
        _run([colmap, "mapper",
              "--database_path", source / "distorted" / "database.db",
              "--image_path", source / "input",
              "--output_path", source / "distorted" / "sparse",
              "--Mapper.ba_global_function_tolerance=0.000001"])

    _run([colmap, "image_undistorter",
          "--image_path", source / "input",
          "--input_path", source / "distorted" / "sparse" / "0",
          "--output_path", source,
          "--output_type", "COLMAP"])

    # Move sparse model into sparse/0 (convert.py:70-78).
    sparse = source / "sparse"
    (sparse / "0").mkdir(exist_ok=True)
    for f in sparse.iterdir():
        if f.name != "0" and f.is_file():
            shutil.move(str(f), str(sparse / "0" / f.name))

    if resize:
        _build_resize_pyramid(source)
    return str(source)


def _build_resize_pyramid(source: Path) -> None:
    """images_2 / images_4 / images_8 downscale pyramid (convert.py:90-122,
    PIL instead of ImageMagick)."""
    from PIL import Image

    images = source / "images"
    for factor in (2, 4, 8):
        out = source / f"images_{factor}"
        out.mkdir(exist_ok=True)
        for img_path in images.iterdir():
            if img_path.suffix.lower() not in (".jpg", ".jpeg", ".png"):
                continue
            img = Image.open(img_path)
            img = img.resize((img.width // factor, img.height // factor),
                             Image.LANCZOS)
            img.save(out / img_path.name)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="COLMAP converter")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)
    convert_scene(args.source_path, args.camera, args.colmap_executable,
                  args.resize, args.magick_executable, args.no_gpu,
                  args.skip_matching)


if __name__ == "__main__":
    main()
