"""hikari_tpu_torch: the PyTorch + CUDA port of hikari_tpu, a realtime
deferred hybrid path tracer, for NVIDIA Hopper (H100).

The port renders every TPU kernel's path of hikari_tpu on the card: the
flagship frame with and without ReSTIR reuse, the post chain (TAA, SMAA
TU4X at ratio 2), checkerboard lighting, large scenes over a BVH walk
with their on-device refit, and textured scenes. Each TPU kernel is a
CUDA kernel written by hand (hikari_tpu_torch/csrc/) beside a plain
PyTorch version of the same function. Kernels build with nvcc on first
use into build/hikari_tpu_torch/. A Renderer runs on CUDA unless the
caller passes device="cpu", where the plain versions run instead.
"""

from hikari_tpu_torch.camera import Camera, PerspectiveProjection, look_at
from hikari_tpu_torch.config import (HikariSettings,
                                     HikariUniversalSettings, Taa, Upscale,
                                     UpscaleMode)
from hikari_tpu_torch.models.material import StandardMaterial
from hikari_tpu_torch.models.mesh import Mesh
from hikari_tpu_torch.models.scene import (AmbientLight, DirectionalLight,
                                           Scene, scene_from_arrays)
from hikari_tpu_torch.renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "HikariSettings",
    "HikariUniversalSettings",
    "Taa",
    "Upscale",
    "UpscaleMode",
    "Camera",
    "PerspectiveProjection",
    "look_at",
    "StandardMaterial",
    "Mesh",
    "Scene",
    "DirectionalLight",
    "AmbientLight",
    "Renderer",
    "scene_from_arrays",
]
