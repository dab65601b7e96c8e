"""Stylized 3D Gaussian Splatting: port of ``aip_tpu.gs``.

Scene IO (Blender / COLMAP readers, cameras, novel-view pose paths; host
numpy, copied), the compressed model's load and save paths, the neural
colour field, the rasterizer with its five CUDA compositors, the render
wrappers, training, ``pipeline.run_3dgs_rendering``, the novel-view
video renderer (``render_video``) and the scene evaluation
(``metrics_cli.evaluate``, ``full_eval.run_full_eval``). Multi-GPU
rendering and training come with a later slice (ROADMAP queue 1).
"""
