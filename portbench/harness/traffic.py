"""The one traffic generator: a traffic mix (portbench/traffic/<name>.json)
is the camera's path and the scene's motion, as parameters. Everything is a
function of the frame number and the seed, never of the clock, so the
reference replays the same frames.

* camera: an orbit about `target` at `radius` and `height`, `degrees_per_
  frame` a frame, from a start angle drawn uniform from the seed;
* motions: `spin_y` turns one instance about the vertical axis through its
  own origin, `radians_per_frame` a frame, from a frame offset drawn from
  the seed in [0, max_offset_frames): its angle in frame f is
  rate * (f + 1 + offset), its previous transform frame f - 1's;
* in_flight: the most frames dispatched and not yet complete;
* update_scene: whether each frame moves the scene (update_scene(fast=
  True)); readback (optional, false): whether each frame's image is
  copied to host memory, inside the frame (before its completion event);
* compare: which frames of the window the check compares: `count` of the
  window's `first` frames, drawn from the seed."""

from __future__ import annotations

import numpy as np

from portbench.harness.scenes import SceneDesc, rot_y


class Traffic:
    def __init__(self, spec: dict, seed: int, desc: SceneDesc):
        self.spec = spec
        self.desc = desc
        rng = np.random.default_rng(abs(int(seed)))
        cam = spec["camera"]
        self.target = np.asarray(cam["target"], np.float64)
        self.radius = float(cam["radius"])
        self.height = float(cam["height"])
        self.step = np.deg2rad(float(cam["degrees_per_frame"]))
        self.start = float(rng.uniform(0.0, 2.0 * np.pi))
        self.offsets = [int(rng.integers(0, max(1, m["max_offset_frames"])))
                        for m in spec["motions"]]
        self.pick = np.random.default_rng([abs(int(seed)), 1])
        self.in_flight = int(spec["in_flight"])
        self.update_scene = bool(spec["update_scene"])
        self.readback = bool(spec.get("readback", False))

    def eye(self, f: int):
        """(eye, target) of frame f."""
        a = self.start + f * self.step
        eye = self.target + np.array([self.radius * np.sin(a), self.height,
                                      self.radius * np.cos(a)])
        return tuple(float(v) for v in eye), tuple(float(v)
                                                    for v in self.target)

    def _transforms_at(self, f: int):
        out = [np.array(tf, np.float64) for _, _, tf in self.desc.instances]
        for m, off in zip(self.spec["motions"], self.offsets):
            if m["kind"] != "spin_y":
                raise ValueError(f"unknown motion {m['kind']!r}")
            i = int(m["instance"])
            base = out[i]
            angle = float(m["radians_per_frame"]) * (f + 1 + off)
            tf = base.copy()
            tf[:3, :3] = rot_y(angle) @ base[:3, :3]
            out[i] = tf
        return out

    def transforms(self, f: int):
        """(transforms, previous transforms) of every instance in frame f."""
        return self._transforms_at(f), self._transforms_at(f - 1)

    def compared(self, first_window_frame: int) -> list:
        """The frame numbers of the window that the check compares."""
        c = self.spec["compare"]
        js = self.pick.choice(int(c["first"]), int(c["count"]),
                              replace=False)
        return sorted(first_window_frame + int(j) for j in js)
