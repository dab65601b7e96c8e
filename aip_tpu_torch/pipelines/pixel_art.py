"""Pixel-art depixelization (Kopf-Lischinski) and palette pixelization.
Port of ``aip_tpu.pipelines.pixel_art``.

Depixelizer parity with `pixel_art/utils.py`:
* similarity graph with YUV thresholds y<=48, u<=7, v<=6 (:103-113),
* 2x2 diagonal conflict resolution with curve / sparsity / island heuristics
  (:32-57, :149-174),
* half-integer Voronoi cell templates (:176-228),
* valency-2 vertex pruning (:230-252) — implemented correctly; the reference
  mutates a list while iterating over it, skipping every other candidate,
* 4 iterations of Voronoi-graph junction marking + Chaikin smoothing
  (:254-329; factors 0.75/0.25, 1/8 beyond the 0.8 diagonal threshold,
  junction = more than 3 differing adjacent color pairs),
* 10x polygon rasterization (:59-93) — PIL supersampled polygon fill instead
  of svgwrite/cairosvg.

The depixelizer is host Python and numpy, as in the JAX package: irregular
graph passes over sprites of at most ~10^4 px. Its output equals the JAX
package's byte for byte. The card runs the palette ops
(``aip_tpu_torch.ops.palette``) and the style-transfer post-pass.

Palette pixelization parity with `gui/second_page.py` Pixelize._convert_image
(:176-192): downsample -> grayscale -> brightness/contrast -> palette
recolor, against the bundled Lospec palettes (1,029 palettes of at most 16
colours). Every entry point that runs on tensors takes ``device=None``
(CUDA; raises without it).
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device

# YUV similarity thresholds (pixel_art/utils.py:104-106).
Y_THRESHOLD = 48
U_THRESHOLD = 7
V_THRESHOLD = 6


def colors_differ(c1, c2) -> bool:
    """check_diff parity (:103-113): True when colors are DISSIMILAR."""
    return (
        abs(int(c1[0]) - int(c2[0])) > Y_THRESHOLD
        or abs(int(c1[1]) - int(c2[1])) > U_THRESHOLD
        or abs(int(c1[2]) - int(c2[2])) > V_THRESHOLD
    )


def similarity_edges(yuv: np.ndarray):
    """Vectorized 8-connected similarity edges.

    yuv: [H, W, 3] uint8 (YCbCr). Returns dict of bool arrays:
    'r' [H, W-1] right, 'd' [H-1, W] down, 'dr' [H-1, W-1] down-right,
    'dl' [H-1, W-1] down-left (edge from (i+1,j) to (i,j+1) in (x=i, y=j)
    indexing; here arrays are indexed [y, x]).
    """
    v = yuv.astype(np.int16)

    def similar(a, b):
        d = np.abs(a - b)
        return (d[..., 0] <= Y_THRESHOLD) & (d[..., 1] <= U_THRESHOLD) & (d[..., 2] <= V_THRESHOLD)

    return {
        "r": similar(v[:, :-1], v[:, 1:]),
        "d": similar(v[:-1, :], v[1:, :]),
        "dr": similar(v[:-1, :-1], v[1:, 1:]),
        "dl": similar(v[:-1, 1:], v[1:, :-1]),
    }


class _Graph:
    """Light adjacency over the edge arrays for the heuristic passes."""

    def __init__(self, edges, h, w):
        self.h, self.w = h, w
        self.adj = defaultdict(set)
        ys, xs = np.nonzero(edges["r"])
        for y, x in zip(ys, xs):
            self._add((x, y), (x + 1, y))
        ys, xs = np.nonzero(edges["d"])
        for y, x in zip(ys, xs):
            self._add((x, y), (x, y + 1))
        ys, xs = np.nonzero(edges["dr"])
        for y, x in zip(ys, xs):
            self._add((x, y), (x + 1, y + 1))
        ys, xs = np.nonzero(edges["dl"])
        for y, x in zip(ys, xs):
            self._add((x + 1, y), (x, y + 1))

    def _add(self, a, b):
        self.adj[a].add(b)
        self.adj[b].add(a)

    def remove(self, a, b):
        self.adj[a].discard(b)
        self.adj[b].discard(a)

    def has_edge(self, a, b):
        return b in self.adj[a]

    def degree(self, n):
        return len(self.adj[n])

    def curve_length(self, source):
        """BFS along degree-2 chains (utils.py:18-30)."""
        queue = [source]
        explored = set()
        while queue:
            node = queue.pop(0)
            if self.degree(node) == 2:
                for nb in self.adj[node]:
                    if nb not in explored and nb not in queue:
                        queue.append(nb)
            explored.add(node)
        return max(len(explored) - 1, 2)

    def component_size(self, source):
        seen = {source}
        stack = [source]
        while stack:
            n = stack.pop()
            for nb in self.adj[n]:
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return len(seen)


def resolve_diagonals(graph: _Graph, w: int, h: int) -> None:
    """process_diagonal_edges parity (:149-174), raster order, in place."""
    for i in range(w - 1):
        for j in range(h - 1):
            a, b, c, d = (i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1)
            if not (graph.has_edge(a, d) and graph.has_edge(b, c)):
                continue
            block = [a, b, c, d]
            n_edges = sum(
                1
                for p in block
                for q in graph.adj[p]
                if q in block and (p < q)
            )
            if n_edges == 6:
                graph.remove(a, d)
                graph.remove(b, c)
            elif n_edges == 2:
                rank_dr = graph.curve_length(a)
                rank_dl = graph.curve_length(b)
                # Sparsity (:42-49): smaller component's diagonal gains.
                cc_a = graph.component_size(a)
                cc_b = graph.component_size(b)
                score = min(abs(cc_a - cc_b), 64)
                if cc_a < cc_b:
                    rank_dr += score
                elif cc_a > cc_b:
                    rank_dl += score
                # Island (:51-57).
                if graph.degree(a) == 1 or graph.degree(d) == 1:
                    rank_dr += 5
                if graph.degree(b) == 1 or graph.degree(c) == 1:
                    rank_dl += 5
                if rank_dr > rank_dl:
                    graph.remove(b, c)
                else:
                    graph.remove(a, d)


def voronoi_cells(graph: _Graph, w: int, h: int):
    """Half-integer Voronoi templates (:176-228). Returns {(x, y): [verts]}."""
    cells = {}
    for x in range(w):
        for y in range(h):
            cx, cy = x + 0.5, y + 0.5
            v = []
            # top-left corner
            if graph.has_edge((x, y), (x - 1, y - 1)):
                v += [(cx - 0.25, cy - 0.75), (cx - 0.75, cy - 0.25)]
            elif graph.has_edge((x, y - 1), (x - 1, y)):
                v.append((cx - 0.25, cy - 0.25))
            else:
                v.append((cx - 0.5, cy - 0.5))
            v.append((cx - 0.5, cy))  # left
            # bottom-left
            if graph.has_edge((x, y), (x - 1, y + 1)):
                v += [(cx - 0.75, cy + 0.25), (cx - 0.25, cy + 0.75)]
            elif graph.has_edge((x, y + 1), (x - 1, y)):
                v.append((cx - 0.25, cy + 0.25))
            else:
                v.append((cx - 0.5, cy + 0.5))
            v.append((cx, cy + 0.5))  # bottom
            # bottom-right
            if graph.has_edge((x, y), (x + 1, y + 1)):
                v += [(cx + 0.25, cy + 0.75), (cx + 0.75, cy + 0.25)]
            elif graph.has_edge((x, y + 1), (x + 1, y)):
                v.append((cx + 0.25, cy + 0.25))
            else:
                v.append((cx + 0.5, cy + 0.5))
            v.append((cx + 0.5, cy))  # right
            # top-right
            if graph.has_edge((x, y), (x + 1, y - 1)):
                v += [(cx + 0.75, cy - 0.25), (cx + 0.25, cy - 0.75)]
            elif graph.has_edge((x, y - 1), (x + 1, y)):
                v.append((cx + 0.25, cy - 0.25))
            else:
                v.append((cx + 0.5, cy - 0.5))
            v.append((cx, cy - 0.5))  # top
            cells[(x, y)] = v
    return cells


def prune_valency2(cells, w: int, h: int):
    """Remove interior vertices used by exactly two cells (:230-252)."""
    valency = defaultdict(int)
    for verts in cells.values():
        for v in verts:
            valency[v] += 1
    for key, verts in cells.items():
        cells[key] = [
            v
            for v in verts
            if not (
                v[0] != 0 and v[0] != w and v[1] != 0 and v[1] != h and valency[v] == 2
            )
        ]
    return cells


def smooth_cells(cells, yuv, num_iterations=4, color_pairs_threshold=3,
                 diagonal_threshold=0.8):
    """Voronoi-graph junction marking + Chaikin (:254-329)."""
    h, w, _ = yuv.shape
    for _ in range(num_iterations):
        edge_cells = defaultdict(list)
        for (x, y), verts in cells.items():
            for i in range(len(verts)):
                v1, v2 = verts[i], verts[(i + 1) % len(verts)]
                key = (v1, v2) if v1 <= v2 else (v2, v1)
                edge_cells[key].append((x, y))

        vertex_edges = defaultdict(list)
        for key in edge_cells:
            vertex_edges[key[0]].append(key)
            vertex_edges[key[1]].append(key)

        is_junction = {}
        for vertex, keys in vertex_edges.items():
            colors = set()
            for key in keys:
                for (cx, cy) in edge_cells[key]:
                    colors.add(tuple(int(c) for c in yuv[cy, cx]))
            colors = list(colors)
            n_diff = sum(
                1
                for i in range(len(colors))
                for j in range(i + 1, len(colors))
                if colors_differ(colors[i], colors[j])
            )
            is_junction[vertex] = n_diff > color_pairs_threshold

        new_cells = {}
        for (x, y), verts in cells.items():
            out = []
            for i in range(len(verts)):
                p_l, p_r = verts[i], verts[(i + 1) % len(verts)]
                key = (p_l, p_r) if p_l <= p_r else (p_r, p_l)
                owners = edge_cells[key]
                smooth = False
                if (
                    len(owners) == 2
                    and not is_junction.get(p_l, False)
                    and not is_junction.get(p_r, False)
                ):
                    c1 = yuv[owners[0][1], owners[0][0]]
                    c2 = yuv[owners[1][1], owners[1][0]]
                    smooth = colors_differ(c1, c2)
                if smooth:
                    f1 = 0.75
                    if np.hypot(p_r[0] - p_l[0], p_r[1] - p_l[1]) > diagonal_threshold:
                        f1 = 1.0 / 8.0
                    f2 = 1.0 - f1
                    out.append((f1 * p_l[0] + f2 * p_r[0], f1 * p_l[1] + f2 * p_r[1]))
                    out.append((f2 * p_l[0] + f1 * p_r[0], f2 * p_l[1] + f1 * p_r[1]))
                else:
                    if p_l not in out:
                        out.append(p_l)
                    if p_r not in out:
                        out.append(p_r)
            new_cells[(x, y)] = out
        cells = new_cells
    return cells


def render_cells(cells, rgb, scale: int = 10, supersample: int = 2):
    """Rasterize the colored cell polygons (render_as_png parity, :59-93).

    Returns an [H*scale, W*scale, 3] uint8 array (PIL polygon fill with
    supersampling standing in for the SVG -> cairo path).
    """
    from PIL import Image, ImageDraw

    h, w, _ = rgb.shape
    ss = supersample
    img = Image.new("RGB", (w * scale * ss, h * scale * ss))
    draw = ImageDraw.Draw(img)
    for (x, y), verts in cells.items():
        if len(verts) < 3:
            continue
        color = tuple(int(c) for c in rgb[y, x])
        pts = [(vx * scale * ss, vy * scale * ss) for vx, vy in verts]
        draw.polygon(pts, fill=color, outline=color)
    if ss > 1:
        img = img.resize((w * scale, h * scale), Image.BILINEAR)
    return np.asarray(img)


def depixelize(image, scale: int = 10) -> np.ndarray:
    """Full pipeline: PIL image / path / uint8 array -> upscaled vector raster."""
    from PIL import Image

    if isinstance(image, (str, Path)):
        image = Image.open(str(image))
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    image = image.convert("RGB")
    rgb = np.asarray(image)
    yuv = np.asarray(image.convert("YCbCr"))
    h, w, _ = rgb.shape

    edges = similarity_edges(yuv)
    graph = _Graph(edges, h, w)
    resolve_diagonals(graph, w, h)
    cells = voronoi_cells(graph, w, h)
    cells = prune_valency2(cells, w, h)
    cells = smooth_cells(cells, yuv)
    return render_cells(cells, rgb, scale)


def vectorization(
    selected_image="input/pixel_art/smw_dolphin_input.png",
    output_png_path="pixel_art/outputs/vectorized_output",
    scale: int = 10,
) -> str:
    """CLI parity with pixel_art/utils.py:331-361. Returns the png path."""
    from PIL import Image

    out = depixelize(selected_image, scale)
    png_path = f"{output_png_path}.png"
    Path(png_path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(out).save(png_path)
    return png_path


def depixelize_and_stylize(
    image,
    style_image,
    scale: int = 10,
    use_depth: bool = True,
    depth_offset: float = 0.5,
    depth_prominence: float = 20.0,
    output: str = "output",
    file_name: str = "depixelized_stylized",
    method: str = "adain",
    magenta_params=None,
    device=None,
):
    """Depixelize then style-transfer the vector raster
    (gui/second_page.py:386-619 Depixelize_pipeline parity). ``method``
    selects the AdaIN-depth branch (:491; fp32, the depth proxy) or the fast
    feed-forward stylizer branch (:504-507, TF-Hub magenta in the reference —
    ``models.magenta`` here, from ``magenta_params`` or seed 0's init).
    Returns the stylized image path."""
    dev = resolve_device(device)
    vector_raster = depixelize(image, scale)

    if method == "fast":
        from PIL import Image as PILImage

        from aip_tpu_torch.models.magenta import make_fast_stylizer
        from aip_tpu_torch.ops.image import resize_bilinear
        from aip_tpu_torch.pipelines.adain_infer import _to_array

        content = torch.from_numpy(_to_array(vector_raster)).to(dev)
        style = torch.from_numpy(_to_array(style_image)).to(dev)
        # The hub module consumes a 256px style (gui/second_page.py:505).
        style = resize_bilinear(style, (256, 256), antialias=True)
        h = content.shape[0] // 4 * 4
        w = content.shape[1] // 4 * 4
        out = make_fast_stylizer(magenta_params, device=dev)(content[None, :h, :w], style)[0]
        out_dir = Path(output)
        out_dir.mkdir(parents=True, exist_ok=True)
        p = out_dir / f"{file_name}.jpg"
        PILImage.fromarray(
            (np.clip(out.cpu().numpy(), 0, 1) * 255).astype(np.uint8)).save(p)
        return p

    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    return adain_inference(
        content_img=vector_raster, style_img=style_image,
        use_depth=use_depth, depth_offset=depth_offset,
        depth_prominence=depth_prominence,
        output=output, file_name=file_name, device=dev,
    )


# ---------------------------------------------------------------------------
# Palette pixelization (gui/second_page.py Pixelize parity)
# ---------------------------------------------------------------------------

LOSPEC_PALETTES = Path(__file__).resolve().parents[2] / "assets" / "lospec-palettes.json"


def load_lospec_palettes(path=None) -> dict:
    """Load the bundled Lospec palette JSON ({name: [hex, ...]}); the default
    path lies in the repository, whatever the working directory."""
    with open(LOSPEC_PALETTES if path is None else path) as f:
        return json.load(f)


def hex_palette_to_rgb(hex_colors) -> np.ndarray:
    return np.asarray(
        [[int(h.lstrip("#")[i : i + 2], 16) for i in (0, 2, 4)] for h in hex_colors],
        np.uint8,
    )


def pixelize(
    image,
    downsampling_factor: int = 1,
    grayscale: bool = False,
    brightness: float = 0.0,
    contrast: float = 0.0,
    palette=None,
    method: str = "RGB",
    device=None,
) -> np.ndarray:
    """_convert_image parity (second_page.py:176-192). Resizing and the
    grayscale conversion run in PIL on the host, the palette ops on
    ``device``. Returns uint8 HWC."""
    from PIL import Image

    from aip_tpu_torch.ops.palette import (
        adjust_brightness_contrast,
        floyd_steinberg,
        recolor_lab,
        recolor_rgb,
    )

    dev = resolve_device(device)
    if isinstance(image, (str, Path)):
        image = Image.open(str(image))
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    image = image.convert("RGB")
    if downsampling_factor > 1:
        image = image.resize(
            (image.width // downsampling_factor, image.height // downsampling_factor)
        )
    if grayscale:
        image = image.convert("L").convert("RGB")
    arr = np.asarray(image, np.uint8)
    if brightness != 0 or contrast != 0:
        x = torch.from_numpy(np.array(arr, np.float32)).to(dev) / 255.0
        arr01 = adjust_brightness_contrast(x, brightness, contrast).cpu().numpy()
        arr = (arr01 * 255).astype(np.uint8)
    if palette is not None:
        pal = palette if isinstance(palette, np.ndarray) else hex_palette_to_rgb(palette)
        fn = {"RGB": recolor_rgb, "kd-tree": recolor_rgb, "LAB": recolor_lab,
              "Floyd-Steinberg": floyd_steinberg}[method]
        arr = fn(torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
                 torch.from_numpy(np.asarray(pal, np.uint8)).to(dev)).cpu().numpy()
    return arr
