"""Stylized 3D Gaussian Splatting, inference: port of ``aip_tpu.gs``.

Scene IO (Blender / COLMAP readers, cameras; host numpy, copied), the
compressed model loader, the neural colour field, the rasterizer with the
two macro-block CUDA compositors, the render wrappers and
``pipeline.run_3dgs_rendering``. Training, the save path and the other
renderers come with later slices (ROADMAP queue 1).
"""
