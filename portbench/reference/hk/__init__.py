"""The benchmark's plain reference renderer: a frozen copy of
hikari_tpu_torch's plain path, taken when the benchmark was written. Every
kernel wrapper runs its plain PyTorch version (on the CPU and on CUDA
alike); the Renderer runs its frames eagerly, with no CUDA graph; the
scene compile builds every BVH as a numpy LBVH. It imports nothing of
hikari_tpu_torch, so a later change to the port is held against the
port's behaviour as it was, not against itself."""

from portbench.reference.hk.camera import Camera
from portbench.reference.hk.config import HikariSettings
from portbench.reference.hk.models.material import StandardMaterial
from portbench.reference.hk.models.mesh import Mesh
from portbench.reference.hk.models.scene import DirectionalLight, Scene
from portbench.reference.hk.renderer import Renderer

__all__ = ["Camera", "DirectionalLight", "HikariSettings", "Mesh",
           "Renderer", "Scene", "StandardMaterial"]
