"""The port stands alone: no module of ``aip_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and the whole package
imports on a machine with no triton, no nvcc and no card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "aip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "aip_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "aip_tpu_torch").rglob("*.py"))


def test_forbidden_names_are_exact():
    """``aip_tpu_torch`` starts with ``aip_tpu``; the check compares names."""
    assert _forbidden("aip_tpu.ops") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("aip_tpu_torch.ops") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_leaves_jax_out():
    mods = _port_modules()
    for name in ("aip_tpu_torch.kernels.adain_head", "aip_tpu_torch.cli.run_depth",
                 "aip_tpu_torch.kernels.composite", "aip_tpu_torch.gs.pipeline",
                 "aip_tpu_torch.gs.render", "aip_tpu_torch.runtime.bitcodec",
                 "aip_tpu_torch.kernels.composite_ad", "aip_tpu_torch.kernels.hashgrad",
                 "aip_tpu_torch.gs.train", "aip_tpu_torch.gs.checkpoint",
                 "aip_tpu_torch.cli.run_3dgs", "aip_tpu_torch.config",
                 "aip_tpu_torch.kernels.tvl1", "aip_tpu_torch.ops.flow",
                 "aip_tpu_torch.ops.farneback", "aip_tpu_torch.pipelines.video",
                 "aip_tpu_torch.models.magenta", "aip_tpu_torch.models.mobilenet",
                 "aip_tpu_torch.cli.run_video", "aip_tpu_torch.cli.adain_video",
                 "aip_tpu_torch.gs.pose_paths", "aip_tpu_torch.gs.render_video",
                 "aip_tpu_torch.cli.render_video", "aip_tpu_torch.ops.color",
                 "aip_tpu_torch.models.vgg19_std", "aip_tpu_torch.models.resnet",
                 "aip_tpu_torch.models.deeplab", "aip_tpu_torch.models.segmenter",
                 "aip_tpu_torch.models.lpips", "aip_tpu_torch.pipelines.localized",
                 "aip_tpu_torch.cli.run_semantic_segm", "aip_tpu_torch.cli.sweep_depth",
                 "aip_tpu_torch.gs.metrics_cli", "aip_tpu_torch.gs.full_eval",
                 "aip_tpu_torch.ops.palette", "aip_tpu_torch.pipelines.pixel_art",
                 "aip_tpu_torch.cli.run_pixelize", "aip_tpu_torch.cli.run_vectorize",
                 "aip_tpu_torch.ops.gram", "aip_tpu_torch.pipelines.nst",
                 "aip_tpu_torch.cli.run_nst", "aip_tpu_torch.models.densenet",
                 "aip_tpu_torch.models.swin", "aip_tpu_torch.pipelines.style_mixer",
                 "aip_tpu_torch.data", "aip_tpu_torch.data.images", "aip_tpu_torch.parallel",
                 "aip_tpu_torch.parallel.train", "aip_tpu_torch.cli.train_adain",
                 "aip_tpu_torch.cli.train_magenta", "aip_tpu_torch.models.magenta_train",
                 "aip_tpu_torch.models.midas", "aip_tpu_torch.utils",
                 "aip_tpu_torch.utils.logging", "aip_tpu_torch.utils.profiling",
                 "aip_tpu_torch.utils.system", "aip_tpu_torch.gs.convert"):
        assert name in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aip_tpu'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card (as here, or with CUDA hidden) the script exits
    non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
