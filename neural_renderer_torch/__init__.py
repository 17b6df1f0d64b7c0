"""neural_renderer_torch — the PyTorch / CUDA port of neural_renderer_tpu.

A differentiable 3D mesh renderer after the Neural 3D Mesh Renderer (Kato,
Ushiku, Harada — CVPR 2018; reference implementation
``hiroharu-kato/neural_renderer``), ported from the JAX package beside it to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

Ported so far: the forward render (camera transforms, lighting, the binned
z-buffer with fused texture shading, ``csrc/forward_shaded.cu``, background
composite and anti-aliasing, ``'approx'`` included) and its approximate
backward through ``torch.autograd`` (the K5 sweeps,
``csrc/backward_sweeps.cu``; the per-face reduction with the K6 texture
cells, ``csrc/face_reduce.cu``; K7 depth and the exact background
gradient), behind the reference's flat API, plus the trainable ``Mesh``, the
custom ``Adam`` and its functional ``adam``, ``measure_scene`` / ``tune``
over the index-and-depth z-buffer ``csrc/forward_index.cu``, batch and
face-axis parallelism over ``torch.distributed`` (``parallel``), spatial
face order, OBJ loading (with the native parser) and saving, and the image
helpers.  The examples are not ported yet (ROADMAP.md).  The
package imports no JAX;
``convert`` carries a JAX ``Renderer``'s settings, a JAX ``Mesh`` and numpy
mesh arrays over.

Everything runs on the card unless asked for the CPU: entry points (the
camera helpers ``cross`` and ``get_points_from_angles`` too) put
non-tensor inputs, ``Mesh`` its parameters and ``convert`` its tensors on
the CUDA device, and raise where there is none; pass ``device='cpu'`` or CPU
tensors to run the kernels' plain PyTorch versions on the CPU.
"""

from neural_renderer_torch.ops.cross import cross
from neural_renderer_torch.ops.transforms import (
    get_points_from_angles,
    look,
    look_at,
    perspective,
)
from neural_renderer_torch.ops.lighting import lighting
from neural_renderer_torch.ops.vertices_to_faces import vertices_to_faces
from neural_renderer_torch.ops.spatial import face_spatial_order, spatial_sort
from neural_renderer_torch.rasterize.config import (
    DEFAULT_ANTI_ALIASING,
    DEFAULT_BACKGROUND_COLOR,
    DEFAULT_EPS,
    DEFAULT_FAR,
    DEFAULT_IMAGE_SIZE,
    DEFAULT_NEAR,
    RasterizeSettings,
)
from neural_renderer_torch.rasterize.api import (
    Rasterize,
    rasterize,
    rasterize_depth,
    rasterize_rgbad,
    rasterize_silhouettes,
    use_unsafe_rasterizer,
)
from neural_renderer_torch.scene.mesh import Mesh
from neural_renderer_torch.scene.renderer import Renderer
from neural_renderer_torch.optim import Adam, adam
from neural_renderer_torch.tune import measure_scene, tune
from neural_renderer_torch.io.obj import (
    create_texture_image,
    load_mtl,
    load_obj,
    save_obj,
)
from neural_renderer_torch.convert import (
    arrays_from_numpy,
    mesh_from_jax,
    renderer_from_jax,
)

__version__ = '0.1.0'

__all__ = [
    'cross', 'get_points_from_angles', 'look', 'look_at', 'perspective',
    'lighting', 'vertices_to_faces', 'face_spatial_order', 'spatial_sort',
    'RasterizeSettings', 'Rasterize', 'rasterize', 'rasterize_depth',
    'rasterize_rgbad', 'rasterize_silhouettes', 'use_unsafe_rasterizer',
    'DEFAULT_IMAGE_SIZE', 'DEFAULT_ANTI_ALIASING', 'DEFAULT_NEAR',
    'DEFAULT_FAR', 'DEFAULT_EPS', 'DEFAULT_BACKGROUND_COLOR',
    'Mesh', 'Renderer', 'Adam', 'adam', 'tune', 'measure_scene',
    'load_obj', 'load_mtl', 'save_obj', 'create_texture_image',
    'renderer_from_jax', 'arrays_from_numpy', 'mesh_from_jax',
]
