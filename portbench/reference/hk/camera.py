"""Camera, projection and per-view uniforms (the port of
hikari_tpu/camera.py).

Bevy conventions: right-handed, camera looks down -Z, +Y up; infinite
reverse-Z perspective projection; `view_proj = projection *
inverse(camera_transform)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def perspective_infinite_reverse_rh(fov_y: float, aspect: float,
                                    near: float) -> np.ndarray:
    """Infinite reverse-Z RH projection (glam's
    Mat4::perspective_infinite_reverse_rh)."""
    f = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = 0.0
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass(frozen=True)
class PerspectiveProjection:
    """Bevy default: fov pi/4, near 0.1."""

    fov_y: float = np.pi / 4.0
    near: float = 0.1

    def matrix(self, width: int, height: int) -> np.ndarray:
        return perspective_infinite_reverse_rh(self.fov_y, width / height,
                                               self.near)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix, looking from eye at target (RH, -Z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m


@dataclasses.dataclass
class Camera:
    """A camera: world transform + projection + output resolution."""

    transform: np.ndarray  # camera-to-world 4x4
    projection: PerspectiveProjection = dataclasses.field(
        default_factory=PerspectiveProjection)
    width: int = 1280
    height: int = 720
    hdr: bool = False

    @staticmethod
    def from_look_at(eye, target, up=(0.0, 1.0, 0.0), **kw) -> "Camera":
        return Camera(transform=look_at(eye, target, up), **kw)

    def view_uniform(self) -> dict:
        """Per-view matrices as float32 numpy arrays."""
        proj = self.projection.matrix(self.width, self.height)
        world_from_view = self.transform
        view_from_world = np.linalg.inv(world_from_view)
        view_proj = proj @ view_from_world
        return {
            "view_proj": view_proj.astype(np.float32),
            "inverse_view_proj": np.linalg.inv(view_proj).astype(np.float32),
            "projection": proj.astype(np.float32),
            "inverse_projection": np.linalg.pinv(proj).astype(np.float32),
            "view": world_from_view.astype(np.float32),
            "inverse_view": view_from_world.astype(np.float32),
            "world_position": world_from_view[:3, 3].astype(np.float32),
            "viewport": np.array([0.0, 0.0, self.width, self.height],
                                 dtype=np.float32),
        }


# the view uniform as one vector of words (view_words), each entry at a
# multiple of 4 words: name, shape, offset
VIEW_LAYOUT = (("view_proj", (4, 4), 0), ("inverse_view_proj", (4, 4), 16),
               ("projection", (4, 4), 32), ("inverse_projection", (4, 4), 48),
               ("view", (4, 4), 64), ("inverse_view", (4, 4), 80),
               ("world_position", (3,), 96), ("viewport", (4,), 100))
VIEW_WORDS = 104


def view_words(view: dict) -> np.ndarray:
    """A view-uniform dict (numpy) as [VIEW_WORDS] float32 words."""
    out = np.zeros(VIEW_WORDS, np.float32)
    for k, shape, at in VIEW_LAYOUT:
        out[at:at + int(np.prod(shape))] = np.asarray(
            view[k], np.float32).reshape(-1)
    return out


def view_from_words(words: torch.Tensor) -> dict:
    """The view-uniform dict as views of [VIEW_WORDS] device words (a
    static buffer that the renderer rewrites each frame)."""
    return {k: words[at:at + int(np.prod(shape))].view(shape)
            for k, shape, at in VIEW_LAYOUT}


