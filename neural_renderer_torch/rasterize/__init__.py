"""Z-buffered triangle rasterizer and its approximate backward.

  * ``forward_cuda.py`` — the forward: per-face records and tile binning
    on the card (``csrc/bin_faces.cu``), then ``csrc/forward_shaded.cu``
    (z-buffer, winner attributes, K4 texture shading) or
    ``csrc/forward_index.cu`` (face index and raw depth only), all
    hand-written CUDA kernels; on a CPU tensor their plain versions.
    Also the JAX package's scene counters (``binning_overflow``,
    ``chunks_needed``, ``csr_rows_needed``);
  * ``forward_dense.py`` — the dense argmin-z oracle (the plain versions'
    core, counterpart of the JAX package's ``forward_xla.py``);
  * ``texture.py`` — K4 texture sampling and the K6 texture gradient;
  * ``backward.py`` / ``backward_cuda.py`` — the K5 sweeps, K7 depth
    channels, the per-face reduction, and the out-sweep counters
    (``out_sweep_stats``, ``count_out_crossings``, ``max_out_offset``);
  * ``composite_pool.py`` — the output pass: background composite,
    vertical flip and 2x2 mean pool in plain PyTorch, and the hand-written
    kernel ``csrc/composite_pool.cu`` that does all three in one pass
    where no gradient flows;
  * ``core.py`` / ``api.py`` — the forward's maps, anti-aliasing, the
    autograd function, and the reference's public entry points.
"""
