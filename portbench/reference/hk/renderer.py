"""The frozen copy's Renderer: the port's Renderer at the time the
benchmark was written, run eagerly (no CUDA graph, no staging buffer) with
the plain PyTorch version of every kernel, on the CPU or on CUDA. It keeps
the port's frame, carry, refit and post-overlay code paths, so that its
frames are what the port's frames should be."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from portbench.reference.hk.camera import (VIEW_WORDS, Camera, view_from_words,
                                     view_words)
from portbench.reference.hk.config import HikariSettings, make_frame_uniform
from portbench.reference.hk.frame import (
    build_render_frame,
    init_carry,
    with_words)
from portbench.reference.hk.models.refit_device import DeviceRefitter
from portbench.reference.hk.models.scene import GpuScene, Scene, upload
from portbench.reference.hk.ops.bloom import bloom
from portbench.reference.hk.ops.fxaa import fxaa as fxaa_op
from portbench.reference.hk.ops.noise import noise_constant
from portbench.reference.hk.ops.post import overlay_compose
from portbench.reference.hk.ops.trace import make_tracer
from portbench.reference.hk.utils.math import reinhard_luminance

# above this many emissives a fast update_scene takes the host refit, as
# hikari_tpu's does: it rebuilds the emissive BVH, so the emissive walk's
# leaf order (em_leaf_order) stays the reference's
SMALL_EMISSIVE_MAX = 8

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def commit(static: dict, new: dict):
    """Writes the tree `new` into the tree of tensors `static` in place,
    leaf by leaf (the carry's donation)."""
    dst = dict(_leaves(static))
    for k, t in _leaves(new):
        if t is not dst[k]:
            dst[k].copy_(t)


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when none is given; never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "portbench.reference.hk renders on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class Renderer:
    """Renders a scene from a camera at the given settings, on `device`
    (CUDA unless the caller asks for the CPU). The tracer of the
    non-fused passes is brute force (kernels 5-7) for scenes of at most
    `brute_force_max` triangles (768 when None), else kernel 13.

    After the frame's overlay comes the reference graph's tail (OVERLAY ->
    BLOOM -> TONEMAPPING -> FXAA, lib.rs:342-365): on an HDR camera bloom
    (with `bloom_settings`, ops/bloom.py) and the Reinhard tone map, then
    FXAA when `fxaa` is set (ops/fxaa.py)."""

    def __init__(self, scene: Union[Scene, GpuScene], camera: Camera,
                 settings: Optional[HikariSettings] = None,
                 brute_force_max: Optional[int] = None, device=None, *,
                 bloom_settings=None, fxaa: bool = False):
        self.device = resolve_device(device)
        self.settings = settings or HikariSettings()
        self.camera = camera
        self.bloom_settings = bloom_settings
        self.fxaa = fxaa
        self.gpu_scene = scene.compile() if isinstance(scene, Scene) else scene
        self.scene_dev = self.gpu_scene.as_pytree(self.device)
        self.noise = noise_constant(self.device)
        self.full_size = (camera.height, camera.width)
        # the ray tracer of the non-fused passes, once per compiled scene:
        # brute force up to brute_force_max triangles (make_tracer's
        # default when None), else kernel 13's BVH walk
        self._tracer_kw = ({} if brute_force_max is None
                           else dict(brute_force_max=brute_force_max))
        self.tracer = make_tracer(self.gpu_scene.num_triangles,
                                  **self._tracer_kw)
        self._refitter = None
        self._frame_fn = self._build()
        # the dissection's frame function, made at its first call
        self._debug_fn = None
        self._view_key = None
        self.albedo = None
        self.reset()

    def _build(self, debug: bool = False):
        return build_render_frame(
            self.settings, self.full_size, self.scene_dev, self.tracer,
            self.gpu_scene.num_textures == 0,
            num_emissives=self.gpu_scene.num_emissives,
            has_sun=self.gpu_scene.has_sun, debug=debug)

    def _view_words(self) -> np.ndarray:
        """The camera's view uniform as words, cached on the pose."""
        cam = self.camera
        key = (cam.transform.tobytes(), cam.width, cam.height,
               cam.projection.fov_y, cam.projection.near)
        if self._view_key != key:
            self._view_np = view_words(cam.view_uniform())
            self._view_key = key
        return self._view_np

    @property
    def carry(self) -> dict:
        """The frame carry: tensors that each frame rewrites in place."""
        return self._carry

    @carry.setter
    def carry(self, value: dict):
        self._carry = value

    def reset(self):
        self.carry = init_carry(self.full_size, self.settings, self.device)
        self._frame_index = 0
        self._prev_view_initialized = False

    def update_settings(self, **changes):
        """Change settings. The dynamic fields (validation intervals, reuse
        caps, lifetime, solar angle, indirect clamp, clear colour) apply
        from the next frame with the frame function, the carry and the
        frame index kept: they reach the frame as device words
        (frame.frame_words), and the intervals pick its key. A change of a
        static-key field (the upscale mode and ratio among them) rebuilds
        the frame function and resets the carry at the new sizes."""
        old_key = self.settings.static_key()
        settings = dataclasses.replace(self.settings, **changes)
        self.settings = settings
        if settings.static_key() != old_key:
            self._frame_fn = self._build()
            self._debug_fn = None
            self.reset()

    def update_scene(self, scene: Scene, fast: bool = False,
                     device: bool = True):
        """Refresh the device scene. fast=False recompiles the scene and
        rebuilds its tracer and the frame function (a change of topology,
        such as the city's waves). fast=True keeps the topology and moves
        the instances to their new transforms: with device=True on the
        device (models/refit_device.py: triangles, normals, BVH boxes,
        instance boxes, motion and emissive tables; the atlas and the
        materials stay), with device=False on the host
        (GpuScene.update_transforms), and on the host too above
        SMALL_EMISSIVE_MAX emissives, since the device refit keeps the
        emissive BVH and the host refit rebuilds it in another leaf order
        (hikari_tpu's rule). The host refit re-uploads only the arrays it
        replaced. A fast update writes the scene's device tensors in place
        (one whose size changed is replaced)."""
        if not fast:
            gpu = scene.compile()
            self.gpu_scene = gpu
            self.tracer = make_tracer(gpu.num_triangles, **self._tracer_kw)
            self.scene_dev = gpu.as_pytree(self.device)
            self._frame_fn = self._build()
            self._debug_fn = None
            self._refitter = None
            return
        visible = [i for i in scene.instances if i.visible]
        if len(visible) != self.gpu_scene.num_instances:
            raise ValueError("the scene's topology changed: use "
                             "update_scene(scene, fast=False)")
        if not device or self.gpu_scene.num_emissives > SMALL_EMISSIVE_MAX:
            old = self.gpu_scene.arrays
            self.gpu_scene = self.gpu_scene.update_transforms(scene)
            fresh = {k: v for k, v in self.gpu_scene.arrays.items()
                     if old.get(k) is not v}
            self._write_scene(upload(fresh, self.device))
            return
        n = len(visible)
        if self._refitter is None:
            self._refitter = DeviceRefitter(self.gpu_scene, self.device)
        mats = torch.from_numpy(np.stack(
            [np.asarray(i.transform, np.float32) for i in visible]
            + [np.asarray(i.transform if i.prev_transform is None
                          else i.prev_transform, np.float32)
               for i in visible])).to(self.device)
        self._write_scene(self._refitter.update(mats[:n], mats[n:]))

    def _write_scene(self, tensors: dict):
        """Writes updated scene tensors into the scene's device tensors in
        place; a tensor whose size or dtype changed replaces the old one."""
        for k, v in tensors.items():
            dst = self.scene_dev.get(k)
            if (dst is not None and dst.dtype == v.dtype
                    and dst.numel() == v.numel()):
                dst.copy_(v.reshape(dst.shape))
            else:
                self.scene_dev[k] = v

    def _frame_inputs(self):
        """The view uniform and the frame's words of the next frame (its
        number's and the current settings' dynamic values) as one device
        tensor, and (view, frame) over it; the first frame seeds the
        previous view with the current one (zero velocity)."""
        uniform = make_frame_uniform(self.settings, self._frame_index)
        words = torch.from_numpy(np.concatenate(
            [self._view_words(), self._frame_fn.words(uniform)]).astype(
                np.float32)).to(self.device)
        view = view_from_words(words[:VIEW_WORDS])
        if not self._prev_view_initialized:
            self.carry["prev_view_proj"].copy_(view["view_proj"])
            self.carry["prev_inverse_view_proj"].copy_(
                view["inverse_view_proj"])
            self._prev_view_initialized = True
        frame = with_words(uniform, words[VIEW_WORDS:])
        return view, frame


    def frame_key(self, number: int) -> tuple:
        """The key of frame `number` at the current settings: its branches
        (frame.py render_frame.key of its frame uniform)."""
        return self._frame_fn.key(make_frame_uniform(self.settings, number))

    def render_frame(self) -> torch.Tensor:
        """Render one frame; returns the final [H,W,4] image on the
        device. The new carry is written into the carry's tensors in
        place."""
        view, frame = self._frame_inputs()
        image, self.albedo, carry = self._frame_fn(
            self.scene_dev, view, frame, self.noise, self.carry)
        commit(self.carry, carry)
        self._frame_index += 1
        return self._post_overlay(image, self.albedo)

    def _post_overlay(self, image, albedo):
        """The overlay, then on an HDR camera bloom (if set) and the
        Reinhard tone map, then FXAA (if set)."""
        out = overlay_compose(image, albedo, self.camera.hdr)
        if self.camera.hdr:
            if self.bloom_settings is not None:
                out = bloom(out, self.bloom_settings)
            out = torch.cat([reinhard_luminance(out[..., :3]), out[..., 3:4]],
                            -1)
        if self.fxaa:
            out = fxaa_op(out)
        return out

