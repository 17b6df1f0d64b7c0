"""The Renderer scene object.

Field-for-field mirror of the reference ``Renderer`` (renderer.py:9-33) and of
the JAX package's ``scene/renderer.py``: mutable attributes holding camera /
light / raster configuration, with the entry points ``render_silhouettes`` /
``render_depth`` / ``render`` / ``render_rgbad``.  Images lie on the device of
``vertices``; ``faces`` and ``textures`` follow it.
"""

import math

import torch

from neural_renderer_torch.ops.lighting import lighting
from neural_renderer_torch.ops.transforms import look, look_at, perspective
from neural_renderer_torch.ops.vertices_to_faces import vertices_to_faces
from neural_renderer_torch.rasterize.api import (
    _as_tensor,
    rasterize,
    rasterize_depth,
    rasterize_rgbad,
    rasterize_silhouettes,
)


class Renderer(object):
    def __init__(self):
        # rendering
        self.image_size = 256
        # True = the reference's 2x supersample + mean-pool; False = none;
        # 'approx' = the values of True with the gradient of a 1x render.
        self.anti_aliasing = True
        self.background_color = [0, 0, 0]
        self.fill_back = True

        # camera
        self.perspective = True
        self.viewing_angle = 30
        self.eye = [0, 0,
                    -(1.0 / math.tan(math.radians(self.viewing_angle)) + 1)]
        self.camera_mode = 'look_at'
        self.camera_direction = [0, 0, 1]
        self.near = 0.1
        self.far = 100

        # light
        self.light_intensity_ambient = 0.5
        self.light_intensity_directional = 0.5
        self.light_color_ambient = [1, 1, 1]      # white
        self.light_color_directional = [1, 1, 1]  # white
        self.light_direction = [0, 1, 0]          # up-to-down

        # rasterization
        self.rasterizer_eps = 1e-3

        # the capacities ``tune`` measured, kept as the JAX package keeps
        # them; nothing here reads them: no kernel of the port has a
        # capacity, so every render is exact and none needs tuning
        self.perf_overrides = {}

    # ------------------------------------------------------------------
    def _transform(self, vertices):
        """Viewpoint + perspective transform (renderer.py:39-48,92-100)."""
        if self.camera_mode == 'look_at':
            vertices = look_at(vertices, self.eye)
        elif self.camera_mode == 'look':
            vertices = look(vertices, self.eye, self.camera_direction)
        if self.perspective:
            vertices = perspective(vertices, angle=self.viewing_angle)
        return vertices

    def _transform_faces(self, face_coords):
        """_transform applied to gathered face coords [bs, nf, 3, 3] —
        pointwise-identical to transforming the vertices first."""
        bs, nf = face_coords.shape[:2]
        flat = self._transform(face_coords.reshape(bs, nf * 3, 3))
        return flat.reshape(bs, nf, 3, 3)

    @staticmethod
    def _fill_back_faces(faces):
        """Duplicate every face back-to-front (renderer.py:37,57,77)."""
        return torch.cat([faces, torch.flip(faces, dims=[2])], dim=1)

    @staticmethod
    def _fill_back_textures(textures):
        """Texture-cube counterpart (renderer.py:79)."""
        return torch.cat([textures, textures.permute(0, 1, 4, 3, 2, 5)],
                         dim=1)

    @staticmethod
    def _mesh(vertices, faces, textures=None):
        vertices = _as_tensor(vertices)
        faces = _as_tensor(faces, torch.int64, vertices.device)
        if textures is not None:
            textures = _as_tensor(textures, device=vertices.device)
        return vertices, faces, textures

    # ------------------------------------------------------------------
    def render_silhouettes(self, vertices, faces):
        vertices, faces, _ = self._mesh(vertices, faces)
        if self.fill_back:
            faces = self._fill_back_faces(faces)
        face_coords = vertices_to_faces(self._transform(vertices), faces)
        return rasterize_silhouettes(face_coords, self.image_size,
                                     self.anti_aliasing)

    def render_depth(self, vertices, faces):
        vertices, faces, _ = self._mesh(vertices, faces)
        if self.fill_back:
            faces = self._fill_back_faces(faces)
        face_coords = vertices_to_faces(self._transform(vertices), faces)
        return rasterize_depth(face_coords, self.image_size,
                               self.anti_aliasing)

    def _lit_faces(self, vertices, faces, textures):
        """fill_back, lighting on world-space face coords
        (renderer.py:82-90), then the camera transform of the gathered
        coords (pointwise, so exact)."""
        vertices, faces, textures = self._mesh(vertices, faces, textures)
        if self.fill_back:
            faces = self._fill_back_faces(faces)
            textures = self._fill_back_textures(textures)
        faces_lighting = vertices_to_faces(vertices, faces)
        textures = lighting(
            faces_lighting,
            textures,
            self.light_intensity_ambient,
            self.light_intensity_directional,
            self.light_color_ambient,
            self.light_color_directional,
            self.light_direction)
        return self._transform_faces(faces_lighting), textures

    def render(self, vertices, faces, textures):
        face_coords, textures = self._lit_faces(vertices, faces, textures)
        return rasterize(
            face_coords, textures, self.image_size, self.anti_aliasing,
            self.near, self.far, self.rasterizer_eps, self.background_color)

    def render_rgbad(self, vertices, faces, textures):
        """All three channels in one pass (no reference Renderer method, but
        rasterize_rgbad exists there; exposed for the batched multi-view
        workload)."""
        face_coords, textures = self._lit_faces(vertices, faces, textures)
        return rasterize_rgbad(
            face_coords, textures, self.image_size, self.anti_aliasing,
            self.near, self.far, self.rasterizer_eps, self.background_color,
            True, True, True)
