"""A renderer driven by a cell's traffic, frame by frame. The same class
serves the timed path (hikari_tpu_torch) and the reference (the frozen
copy portbench.reference.hk): both take the scene through the same public
API, the same settings from the configuration, and get the same camera
poses and instance transforms.

A configuration's `settings` is a dict of HikariSettings field overrides
as JSON: an enum by its member's name ("taa": "JASMINE"), a nested
settings dataclass as a dict of its own fields ("upscale": {"mode":
"FSR1", "ratio": 1.5}), a tuple as a list. Its `post` gives the
Renderer's post arguments: "bloom" (a dict of BloomSettings fields, {}
for the defaults; absent or null: no bloom) and "fxaa" (a bool)."""

from __future__ import annotations

import dataclasses
import enum
import importlib
import math

import numpy as np
import torch

from portbench.harness.scenes import move_instances, to_scene


def _value(default, v):
    """A JSON value as the type of the field's default."""
    if isinstance(default, enum.Enum):
        return type(default)[v]
    if dataclasses.is_dataclass(default):
        return replaced(default, v)
    if isinstance(default, tuple):
        return tuple(v)
    if isinstance(default, bool):
        return bool(v)
    if isinstance(default, int):
        return int(v)
    if isinstance(default, float):
        return float(v)
    return v


def replaced(obj, changes: dict):
    """The dataclass instance `obj` with the fields in `changes` set from
    their JSON values; an unknown field raises."""
    names = {f.name for f in dataclasses.fields(obj)}
    unknown = sorted(set(changes) - names)
    if unknown:
        raise KeyError(f"{type(obj).__name__} has no field {unknown}")
    return dataclasses.replace(obj, **{k: _value(getattr(obj, k), v)
                                       for k, v in changes.items()})


def settings_of(api, config: dict):
    """The configuration's HikariSettings of the renderer package `api`."""
    return replaced(api.HikariSettings(), config.get("settings", {}))


def post_of(api, config: dict) -> dict:
    """The Renderer's post keyword arguments of the configuration."""
    post = config.get("post", {})
    unknown = sorted(set(post) - {"bloom", "fxaa"})
    if unknown:
        raise KeyError(f"post has no argument {unknown}")
    kw = {}
    if post.get("bloom") is not None:
        bloom = importlib.import_module(f"{api.__name__}.ops.bloom")
        kw["bloom_settings"] = replaced(bloom.BloomSettings(), post["bloom"])
    if post.get("fxaa"):
        kw["fxaa"] = True
    return kw


class Frames:
    """`api`: a renderer package exporting Scene, Mesh, StandardMaterial,
    DirectionalLight, Camera, HikariSettings and Renderer. `device`: the
    Renderer's device argument (None: the package takes none)."""

    def __init__(self, api, config: dict, desc, traffic, device):
        self.api = api
        self.config = config
        self.traffic = traffic
        tf = traffic.transforms(0) if traffic.update_scene else (None, None)
        self.scene = to_scene(desc, api, *tf)
        kw = post_of(api, config)
        if device is not None:
            kw["device"] = device
        self.renderer = api.Renderer(self.scene, self.camera(0),
                                     settings_of(api, config), **kw)
        self._host = {}

    def camera(self, f: int):
        eye, target = self.traffic.eye(f)
        c = self.config
        return self.api.Camera.from_look_at(eye, target, width=c["width"],
                                            height=c["height"], hdr=c["hdr"])

    def pose(self, f: int):
        """Sets frame f's camera (the first half of a frame's dispatch)."""
        self.renderer.camera = self.camera(f)

    def move(self, f: int):
        """Frame f's scene motion through update_scene(fast=True), where
        the traffic moves the scene."""
        if self.traffic.update_scene:
            move_instances(self.scene, *self.traffic.transforms(f))
            self.renderer.update_scene(self.scene, fast=True)

    def render(self, f: int):
        """Frame f's image; where the traffic reads frames back, also
        copied into host memory without waiting for the copy (pinned
        buffers on CUDA, one for each frame in flight, made in the
        warm-up): the frame's completion event comes after the copy."""
        img = self.renderer.render_frame()
        if self.traffic.readback:
            slot = f % self.traffic.in_flight
            host = self._host.get(slot)
            if host is None or host.shape != img.shape:
                host = torch.empty(img.shape, dtype=img.dtype,
                                   pin_memory=img.is_cuda)
                self._host[slot] = host
            host.copy_(img, non_blocking=True)
        return img

    def frame(self, f: int):
        self.pose(f)
        self.move(f)
        return self.render(f)

    def warmup_frames(self) -> int:
        """Frames 0 .. W - 1 hold every frame key of the cycle (the
        parity and both validation intervals): W."""
        s = self.renderer.settings
        cycle = math.lcm(2, max(int(s.direct_validate_interval), 1),
                         max(int(s.emissive_validate_interval), 1))
        first = {}
        for n in range(cycle):
            first.setdefault(self.renderer.frame_key(n), n)
        return max(first.values()) + 1


def to_numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img, np.float32)
