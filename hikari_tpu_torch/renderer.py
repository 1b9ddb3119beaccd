"""Top-level Renderer: owns the device scene, its tracer, the frame
function for the current settings, and the frame carry (the port of
hikari_tpu/renderer.py: no reuse, temporal reuse, temporal + spatial
reuse, the post chain of TAA Jasmine, SMAA TU4X and FSR 1.0 at every
upscale ratio in [1, 2], so HikariSettings() itself, checkerboard
lighting with and without temporal reuse, scenes beyond the fused
kernels' caps, such as the city, with their per-frame refit on the device
or on the host, scenes of any emissive count, textured scenes, the
post-overlay tail of bloom and FXAA, the tracer's `brute_force_max`, the
per-pass dissection and PNG output).

On CUDA the frame and its post-overlay run as captured CUDA graphs
(compiled.py), one per key of the frame's branches (frame.py
`render_frame.key`), and so do the dissection (one graph per key of the
debug frame) and the device refit: the counterpart of hikari_tpu's
jitted frame (its carry donated), debug frame, post-overlay and refit.
Everything that changes from frame to frame, and the settings' dynamic
values, reach them through static device buffers (the view uniform,
frame.frame_words, the transforms), written before each replay by one
copy; the carry and the scene are written in place. So
`update_settings` of dynamic fields only keeps the graphs, as
hikari_tpu keeps its jitted frame; a change of a static-key field,
`update_scene(fast=False)`, `reset` and an assignment to `carry` drop
them: the next frame captures again. The CPU, a frame under a row mesh
and frames inside `compiled.eager()` run eagerly."""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Union

import numpy as np
import torch

from hikari_tpu_torch import compiled
from hikari_tpu_torch.camera import (VIEW_WORDS, Camera, view_from_words,
                                     view_words)
from hikari_tpu_torch.compiled import eager  # noqa: F401 (the eager route)
from hikari_tpu_torch.config import HikariSettings, make_frame_uniform
from hikari_tpu_torch.frame import (FRAME_WORDS, build_render_frame,
                                    init_carry, with_words)
from hikari_tpu_torch.models.refit_device import DeviceRefitter
from hikari_tpu_torch.models.scene import GpuScene, Scene, upload
from hikari_tpu_torch.ops.bloom import bloom
from hikari_tpu_torch.ops.fxaa import fxaa as fxaa_op
from hikari_tpu_torch.ops.noise import noise_constant
from hikari_tpu_torch.ops.post import overlay_compose
from hikari_tpu_torch.ops.trace import make_tracer
from hikari_tpu_torch.parallel import shard as _sh
from hikari_tpu_torch.utils.image import save_png
from hikari_tpu_torch.utils.math import reinhard_luminance

# above this many emissives a fast update_scene takes the host refit, as
# hikari_tpu's does: it rebuilds the emissive BVH, so the emissive walk's
# leaf order (em_leaf_order) stays the reference's
SMALL_EMISSIVE_MAX = 8

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
        # the static inputs: the view uniform and the frame's words
        self._inputs = compiled.StaticInputs(VIEW_WORDS + FRAME_WORDS,
                                             self.device)
        self._view = view_from_words(self._inputs.dev[:VIEW_WORDS])
        self._view_key = None
        self._graphs = (compiled.Graphs(self.device)
                        if self.device.type == "cuda" else None)
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
        """The frame carry: static tensors that each frame rewrites in
        place. Assigning a new carry drops the graphs."""
        return self._carry

    @carry.setter
    def carry(self, value: dict):
        self._carry = value
        self._drop_graphs()

    def _drop_graphs(self):
        if self._graphs is not None:
            self._graphs.clear()

    def _graphed(self) -> bool:
        """The frame, post-overlay, dissection and refit replay graphs: on
        CUDA, outside compiled.eager() and a row mesh."""
        return (self._graphs is not None and not compiled.eager_active()
                and _sh.active_mesh() is None)

    def graph_keys(self) -> list:
        """The keys of the captured graphs (frame keys, ("dissection",) +
        a debug frame's key, and "refit"), in capture order."""
        return [] if self._graphs is None else self._graphs.keys()

    def reset(self):
        self.carry = init_carry(self.full_size, self.settings, self.device)
        self._frame_index = 0
        self._prev_view_initialized = False

    def update_settings(self, **changes):
        """Change settings. The dynamic fields (validation intervals, reuse
        caps, lifetime, solar angle, indirect clamp, clear colour) apply
        from the next frame with the graphs, the frame function, the carry
        and the frame index kept: they reach the frame as device words
        (frame.frame_words), and the intervals pick its key. A change of a
        static-key field (the upscale mode and ratio among them) rebuilds
        the frame function, resets the carry at the new sizes and drops
        the graphs."""
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
        (hikari_tpu's rule). The host refit re-uploads only the arrays it replaced, and kernel 13's
        tables. A fast update writes the scene's device tensors in place
        (a captured frame keeps reading them; one whose size changed is
        replaced, and the graphs dropped); the device refit reads the
        transforms from a static buffer and, on CUDA, replays a graph of
        its own. fast=False drops the graphs."""
        if not fast:
            gpu = scene.compile()
            self.gpu_scene = gpu
            self.tracer = make_tracer(gpu.num_triangles, **self._tracer_kw)
            self.scene_dev = gpu.as_pytree(self.device)
            self._frame_fn = self._build()
            self._debug_fn = None
            self._refitter = None
            self._drop_graphs()
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
            self._write_scene(upload(
                {**fresh, **self.gpu_scene.kernel_tables()}, self.device))
            return
        n = len(visible)
        if self._refitter is None:
            self._refitter = DeviceRefitter(self.gpu_scene, self.device)
            self._mats = compiled.StaticInputs(2 * n * 16, self.device)
        self._mats.write(np.stack(
            [np.asarray(i.transform, np.float32) for i in visible]
            + [np.asarray(i.transform if i.prev_transform is None
                          else i.prev_transform, np.float32)
               for i in visible]).reshape(-1))
        mats = self._mats.dev.view(2 * n, 4, 4)

        def refit(commit):
            out = self._refitter.update(mats[:n], mats[n:])
            if commit:
                self._write_scene(out)

        if self._graphed():
            self._graphs.run("refit", refit)
        else:
            refit(True)

    def _write_scene(self, tensors: dict):
        """Writes updated scene tensors into the scene's device tensors in
        place; a tensor whose size or dtype changed replaces the old one
        and drops the graphs."""
        for k, v in tensors.items():
            dst = self.scene_dev.get(k)
            if (dst is not None and dst.dtype == v.dtype
                    and dst.numel() == v.numel()):
                dst.copy_(v.reshape(dst.shape))
            else:
                self.scene_dev[k] = v
                self._drop_graphs()

    def _frame_inputs(self):
        """Stages the view uniform and the frame's words of the next frame
        (its number's and the current settings' dynamic values) into the
        static inputs (one copy) and returns (view, frame) over them; the
        first frame seeds the previous view with the current one (zero
        velocity)."""
        uniform = make_frame_uniform(self.settings, self._frame_index)
        self._inputs.write(np.concatenate(
            [self._view_words(), self._frame_fn.words(uniform)]))
        view = self._view
        if not self._prev_view_initialized:
            self.carry["prev_view_proj"].copy_(view["view_proj"])
            self.carry["prev_inverse_view_proj"].copy_(
                view["inverse_view_proj"])
            self._prev_view_initialized = True
        frame = with_words(uniform, self._inputs.dev[VIEW_WORDS:])
        return view, frame

    def _frame_program(self, view, frame, commit: bool):
        """The frame and its post-overlay: (final image, albedo); with
        `commit` the new carry is written into the carry's tensors in
        place."""
        image, albedo, carry = self._frame_fn(
            self.scene_dev, view, frame, self.noise, self.carry)
        if commit:
            compiled.commit(self.carry, carry)
        return self._post_overlay(image, albedo), albedo

    def frame_key(self, number: int) -> tuple:
        """The key of frame `number` at the current settings: its branches
        (frame.py render_frame.key of its frame uniform)."""
        return self._frame_fn.key(make_frame_uniform(self.settings, number))

    def render_frame(self) -> torch.Tensor:
        """Render one frame; returns the final [H,W,4] image on the
        device, a tensor of its own (on CUDA a clone of the graph's
        output). `albedo` then holds the frame's [H,W,4] albedo (on CUDA
        the graph's own output, which the next frame overwrites)."""
        view, frame = self._frame_inputs()
        if self._graphed():
            image, self.albedo = self._graphs.run(
                self._frame_fn.key(frame),
                lambda commit: self._frame_program(view, frame, commit))
            image = image.clone()
        else:
            image, self.albedo = self._frame_program(view, frame, True)
        self._frame_index += 1
        return image

    def _dissection_program(self, view, frame, commit: bool):
        """The debug frame and its post-overlay: ({DEBUG_KEYS: plane,
        "final": image}); with `commit` the new carry is written into the
        carry's tensors in place."""
        image, albedo, carry, dbg = self._debug_fn(
            self.scene_dev, view, frame, self.noise, self.carry)
        if commit:
            compiled.commit(self.carry, carry)
        return {**dbg, "final": self._post_overlay(image, albedo)}

    def render_dissection(self, out_dir: Optional[str] = None) -> dict:
        """Render one frame through the debug frame (frame.py
        build_render_frame(debug=True): the modular lighting and spatial
        paths) and return its per-pass planes (frame.DEBUG_KEYS) and the
        final image under "final", as numpy arrays (the analog of the
        reference's assets/screenshots/dissection images). On CUDA it
        replays one graph per key of the debug frame ("dissection", key),
        captured at the key's first use in the frame's pool, and then
        copies the planes to the host. The frame advances the carry and the
        frame index as render_frame does. With `out_dir`, each plane is
        also written to out_dir/<key>.png as hikari_tpu writes it:
        one-channel planes grey, scaled by their maximum, normals mapped
        from [-1, 1] to [0, 1]."""
        if self._debug_fn is None:
            self._debug_fn = self._build(debug=True)
        view, frame = self._frame_inputs()
        if self._graphed():
            dbg = self._graphs.run(
                ("dissection",) + self._debug_fn.key(frame),
                lambda commit: self._dissection_program(view, frame, commit))
        else:
            dbg = self._dissection_program(view, frame, True)
        self._frame_index += 1
        dbg = {k: v.cpu().numpy() for k, v in dbg.items()}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for k, v in dbg.items():
                if v.ndim == 2:
                    v = np.repeat(v[..., None], 3, axis=-1) / max(v.max(),
                                                                  1e-6)
                if "normal" in k:
                    v = v * 0.5 + 0.5
                save_png(os.path.join(out_dir, f"{k}.png"), v)
        return dbg

    @staticmethod
    def to_srgb_u8(img: np.ndarray) -> np.ndarray:
        """[..., >= 3] linear RGB in [0, 1] (clipped) as sRGB bytes."""
        rgb = np.clip(img[..., :3], 0.0, 1.0)
        srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                        1.055 * rgb ** (1 / 2.4) - 0.055)
        return (srgb * 255.0 + 0.5).astype(np.uint8)

    def save_png(self, path: str, img: Optional[np.ndarray] = None):
        """Write `img` ([H,W,>=3] linear, numpy or a tensor; the next frame
        when None) as an sRGB PNG."""
        from PIL import Image

        if img is None:
            img = self.render_frame()
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        Image.fromarray(self.to_srgb_u8(np.asarray(img))).save(path)

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
            lambda v: torch.as_tensor(v, device=self.device).clone(),
            state["carry"])
        self._frame_index = state["frame_index"]
        self._prev_view_initialized = True
