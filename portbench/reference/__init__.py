"""Plain references in PyTorch and NumPy. Nothing here imports the program
(``aip_tpu_torch``), the JAX package or JAX."""
