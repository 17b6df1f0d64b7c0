"""The Renderer scene object.

Field-for-field mirror of the reference ``Renderer`` (renderer.py:9-33) and of
the JAX package's ``scene/renderer.py``: mutable attributes holding camera /
light / raster configuration, with the entry points ``render_silhouettes`` /
``render_depth`` / ``render`` / ``render_rgbad``.  Images lie on the device of
``vertices``; ``faces`` and ``textures`` follow it.
"""

import math

import torch

from neural_renderer_torch import tracing
from neural_renderer_torch.ops.lighting import face_light, light_cubes
from neural_renderer_torch.ops.transforms import look, look_at, perspective
from neural_renderer_torch.ops.vertices_to_faces import (
    fill_back_faces,
    vertices_to_faces,
)
from neural_renderer_torch.rasterize.api import (
    rasterize,
    rasterize_depth,
    rasterize_rgbad,
    rasterize_silhouettes,
)
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import place


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
        # a torch.distributed process group over which the face list is
        # sharded (parallel.make_face_sharded_render), or None
        self.face_group = None

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

    _fill_back_faces = staticmethod(fill_back_faces)

    @staticmethod
    def _fill_back_textures(textures):
        """Texture-cube counterpart (renderer.py:79)."""
        return torch.cat([textures, textures.permute(0, 1, 4, 3, 2, 5)],
                         dim=1)

    @staticmethod
    def _mesh(vertices, faces, textures=None):
        """vertices and textures as f32 tensors on the vertices' device;
        faces as a tensor (a caller's tensor is passed on as it is, so the
        vertex scatter keeps its sort, ``ops/vertices_to_faces.py``)."""
        vertices = place(vertices, site='renderer.vertices')
        if not isinstance(faces, torch.Tensor):
            faces = place(faces, vertices.device, torch.int64,
                          site='renderer.faces')
        if textures is not None:
            textures = place(textures, vertices.device,
                             site='renderer.textures')
        return vertices, faces, textures

    # ------------------------------------------------------------------
    def _camera_faces(self, vertices, faces):
        """The camera transform of the vertices, gathered per face (the
        scene of the untextured entry points)."""
        with tracing.span('scene'):
            vertices, faces, _ = self._mesh(vertices, faces)
            with tracing.span('scene.camera'):
                vertices = tracing.backward('camera', self._transform,
                                            vertices)
            with tracing.span('scene.gather'):
                return vertices_to_faces(vertices, faces, self.face_group,
                                         self.fill_back)

    def render_silhouettes(self, vertices, faces):
        with tracing.span('render_silhouettes'):
            return tracing.backward(None, self._silhouettes, vertices, faces)

    def _silhouettes(self, vertices, faces):
        return rasterize_silhouettes(
            self._camera_faces(vertices, faces), self.image_size,
            self.anti_aliasing, face_group=self.face_group)

    def render_depth(self, vertices, faces):
        with tracing.span('render_depth'):
            return tracing.backward(None, self._depth, vertices, faces)

    def _depth(self, vertices, faces):
        return rasterize_depth(
            self._camera_faces(vertices, faces), self.image_size,
            self.anti_aliasing, face_group=self.face_group)

    def _shaded_faces(self, vertices, faces, textures):
        """fill_back, lighting on world-space face coords
        (renderer.py:82-90), then the camera transform of the gathered
        coords (pointwise, so exact): (face coords, textures, light) as
        ``_light`` hands them on."""
        with tracing.span('scene'):
            vertices, faces, textures = self._mesh(vertices, faces, textures)
            with tracing.span('scene.gather'):
                faces_lighting = vertices_to_faces(
                    vertices, faces, self.face_group, self.fill_back)
            with tracing.span('scene.lighting'):
                textures, light = tracing.backward(
                    'lighting', self._light, faces_lighting, textures)
            with tracing.span('scene.camera'):
                return tracing.backward('camera', self._transform_faces,
                                        faces_lighting), textures, light

    def _lit_faces(self, vertices, faces, textures):
        """(face coords, lit texture cubes): the scene as ``rasterize``
        takes it without a light, at every ts."""
        face_coords, textures, light = self._shaded_faces(vertices, faces,
                                                          textures)
        if light is not None:
            textures = light_cubes(textures, light)
        return face_coords, textures

    def _light(self, faces_lighting, textures):
        """fill_back of the texture cubes, then the per-face light:
        (cubes, light).  Where the rasterizer samples the cubes in plain
        torch (ts above ``forward_cuda.MAX_FUSED_TS``) the cubes stay unlit
        and the light ``[bs, nf', 3]`` goes on to the rasterizer, which
        applies it per texel read and per term of the texture gradient, so
        no lit cube is made; smaller cubes, which the fused forward and
        the reduction's K6 read lit, come back lit, the light None."""
        if self.fill_back:
            textures = self._fill_back_textures(textures)
        light = face_light(
            faces_lighting,
            self.light_intensity_ambient,
            self.light_intensity_directional,
            self.light_color_ambient,
            self.light_color_directional,
            self.light_direction)
        if textures.shape[2] > forward_cuda.MAX_FUSED_TS:
            return textures, light
        return light_cubes(textures, light), None

    def render(self, vertices, faces, textures):
        with tracing.span('render'):
            return tracing.backward(None, self._rgb, vertices, faces,
                                    textures)

    def _rgb(self, vertices, faces, textures):
        face_coords, textures, light = self._shaded_faces(vertices, faces,
                                                          textures)
        return rasterize(
            face_coords, textures, self.image_size, self.anti_aliasing,
            self.near, self.far, self.rasterizer_eps,
            self.background_color, self.face_group, light)

    def render_rgbad(self, vertices, faces, textures):
        """All three channels in one pass (no reference Renderer method, but
        rasterize_rgbad exists there; exposed for the batched multi-view
        workload)."""
        with tracing.span('render_rgbad'):
            return tracing.backward(None, self._rgbad, vertices, faces,
                                    textures)

    def _rgbad(self, vertices, faces, textures):
        face_coords, textures, light = self._shaded_faces(vertices, faces,
                                                          textures)
        return rasterize_rgbad(
            face_coords, textures, self.image_size, self.anti_aliasing,
            self.near, self.far, self.rasterizer_eps,
            self.background_color, True, True, True, self.face_group, light)
