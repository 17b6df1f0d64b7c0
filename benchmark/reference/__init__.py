"""The benchmark's plain reference of the Neural 3D Mesh Renderer.

Plain PyTorch, written from the reference implementation's semantics
(``hiroharu-kato/neural_renderer``).  It imports nothing of the program
under test and takes nothing the program made: the benchmark hands both
the same vertices, faces, textures and eyes, and this package works out
the rest again (camera, lighting, z-buffer, sampling, the approximate
backward and the vertex scatter).
"""
