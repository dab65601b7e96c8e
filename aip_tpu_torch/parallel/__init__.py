"""Training steps (port of ``aip_tpu.parallel``).

``train``: the AdaIN decoder's train step on one device. The JAX package's
meshes, shardings and multi-device inference and 3DGS (``mesh``,
``sharding``, ``infer``, ``gs``) are the multi-GPU slice of the port
(ROADMAP queue 1 item 9); until then a mesh of more than one device raises
``NotImplementedError``.
"""
