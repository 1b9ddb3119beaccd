"""Top-level Renderer: owns the device scene, its tracer, the frame
function for the current settings, and the frame carry (the port of
hikari_tpu/renderer.py for the ported slices: no reuse, temporal reuse,
temporal + spatial reuse, the post chain of SMAA TU4X at ratio 2 and TAA
Jasmine, so HikariSettings() itself, and checkerboard lighting with and
without temporal reuse)."""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional, Union

import numpy as np
import torch

from hikari_tpu_torch.camera import Camera, view_to_device
from hikari_tpu_torch.config import HikariSettings, make_frame_uniform
from hikari_tpu_torch.frame import build_render_frame, init_carry
from hikari_tpu_torch.models.scene import GpuScene, Scene
from hikari_tpu_torch.ops.noise import noise_constant
from hikari_tpu_torch.ops.post import overlay_compose
from hikari_tpu_torch.ops.trace import make_tracer
from hikari_tpu_torch.utils.math import reinhard_luminance


def _tree_map(fn, tree):
    """fn over the leaves of a carry (a dict of tensors and dicts)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when none is given; never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hikari_tpu_torch renders on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class Renderer:
    """Renders a scene from a camera at the given settings, on `device`
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, scene: Union[Scene, GpuScene], camera: Camera,
                 settings: Optional[HikariSettings] = None, device=None):
        self.device = resolve_device(device)
        self.settings = settings or HikariSettings()
        self.camera = camera
        self.gpu_scene = scene.compile() if isinstance(scene, Scene) else scene
        self.scene_dev = self.gpu_scene.as_pytree(self.device)
        self.noise = noise_constant(self.device)
        self.full_size = (camera.height, camera.width)
        # the ray tracer of the modular lighting path, once per scene
        self.tracer = make_tracer(self.gpu_scene.num_triangles)
        self._frame_fn = self._build()
        self.reset()

    def _build(self):
        return build_render_frame(
            self.settings, self.full_size, self.scene_dev,
            self.gpu_scene.num_textures == 0,
            num_emissives=self.gpu_scene.num_emissives,
            has_sun=self.gpu_scene.has_sun, tracer=self.tracer)

    def _views(self):
        """The camera's view uniform on the device, cached on the pose."""
        cam = self.camera
        key = (cam.transform.tobytes(), cam.width, cam.height,
               cam.projection.fov_y, cam.projection.near)
        if getattr(self, "_view_key", None) != key:
            self._view = view_to_device(cam.view_uniform(), self.device)
            self._view_key = key
        return self._view

    def reset(self):
        self.carry = init_carry(self.full_size, self.settings, self.device)
        self._frame_index = 0
        self._prev_view_initialized = False

    def update_settings(self, **changes):
        """Change settings; a change of a static-key field rebuilds the
        frame function and resets the carry."""
        old_key = self.settings.static_key()
        settings = dataclasses.replace(self.settings, **changes)
        if settings.static_key() != old_key:
            old = self.settings
            self.settings = settings
            try:
                self._frame_fn = self._build()
            except NotImplementedError:
                self.settings = old
                raise
            self.reset()
        else:
            self.settings = settings

    def render_frame(self) -> torch.Tensor:
        """Render one frame; returns the final [H,W,4] image on the device.
        The first frame seeds the previous view with the current one (zero
        velocity)."""
        view = self._views()
        if not self._prev_view_initialized:
            self.carry["prev_view_proj"] = view["view_proj"].clone()
            self.carry["prev_inverse_view_proj"] = (
                view["inverse_view_proj"].clone())
            self._prev_view_initialized = True
        frame = make_frame_uniform(self.settings, self._frame_index)
        image, albedo, self.carry = self._frame_fn(
            self.scene_dev, view, frame, self.noise, self.carry)
        self._frame_index += 1
        out = overlay_compose(image, albedo, self.camera.hdr)
        if self.camera.hdr:
            out = torch.cat([reinhard_luminance(out[..., :3]), out[..., 3:4]],
                            -1)
        return out

    def render(self, frames: int = 1) -> np.ndarray:
        """Render `frames` frames, return the last as [H,W,4] numpy."""
        img = None
        for _ in range(frames):
            img = self.render_frame()
        return img.cpu().numpy()

    def save_state(self, path: str):
        """Write the frame carry (view matrices, reservoir planes and the
        post chain's history, bit for bit) and the frame index to a
        pickle."""
        state = {
            "carry": _tree_map(lambda v: v.cpu().numpy(), self.carry),
            "frame_index": self._frame_index,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_state(self, path: str):
        """Load a state written by save_state (a pickle: load only files
        this program wrote)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.carry = _tree_map(
            lambda v: torch.as_tensor(v, device=self.device), state["carry"])
        self._frame_index = state["frame_index"]
        self._prev_view_initialized = True
