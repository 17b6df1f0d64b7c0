"""Z-buffered triangle rasterizer, forward only.

  * ``forward_cuda.py`` — the shaded forward: per-face records and tile
    binning in PyTorch, then one hand-written CUDA kernel
    (``csrc/forward_shaded.cu``) for the z-buffer, winner attributes and K4
    texture shading; on a CPU tensor its plain version;
  * ``forward_dense.py`` — the dense argmin-z oracle (the plain version's
    core, counterpart of the JAX package's ``forward_xla.py``);
  * ``texture.py`` — K4 texture sampling;
  * ``core.py`` / ``api.py`` — background composite, anti-aliasing, flip,
    and the reference's public entry points.

The approximate backward (K5/K6/K7) is not ported yet.
"""
