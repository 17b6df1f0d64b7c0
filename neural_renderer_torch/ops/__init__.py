"""Differentiable math ops in PyTorch: camera transforms, lighting, gathers.

Counterparts of the JAX package's ``ops/`` (reference
``neural_renderer/{cross,look,look_at,perspective,lighting,
vertices_to_faces,get_points_from_angles}.py``).
"""
