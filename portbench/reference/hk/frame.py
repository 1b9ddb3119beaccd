"""Frame pipeline: the branches of hikari_tpu/frame.py the port serves.

One frame: the G-buffer prepass -> blue noise -> lighting -> a-trous
denoise (kernel C, four levels) at the render size -> tone mapping -> the
post chain (SMAA TU4X, TAA Jasmine; kernels 11 and 12). The gates are
hikari_tpu's own predicates (`prepass_fused_eligible`, `fused_eligible`,
`spatial_fused_active`), on the tracer's kind and the kernels' caps:

* prepass: kernel A for scenes within its gate (where the output is
  exactly twice the render size, upscale ratio 2 at an even size, the
  render-size G-buffer is its strided planes and SMAA's parity quads are
  kernel 8's copies of its planes at the four parities; at any other
  ratio or size its full-size planes go through the generic resample, as
  in hikari_tpu/frame.py:160-191); otherwise the tracer's primary rays
  (ops/prepass.py: prepass), the full-screen albedo and the resample at
  the ratio; SMAA reads the G-buffer through smaa.parity_context;
* lighting through the fused kernels where their gate holds: kernel B
  without reuse; with temporal reuse one reprojection gather (kernel 9) of
  every active channel's previous reservoirs, then kernel 4; with spatial
  reuse the same gather fetches the previous spatial reservoirs, kernel 4
  emits the flags and scatter reservoirs, and kernel 10 runs once per
  spatial channel after the scatter-replace;
* otherwise the modular lighting path (ops/restir.py direct_lit /
  indirect_lit_ambient, whose rays go through the scene's tracer: kernels
  5, 6, 7 or kernel 13): with temporal reuse on the gathered reservoirs,
  without it on the empty reservoir (hikari_tpu's no-reuse
  specializations where no channel tracks spatial reuse), with the spatial
  tracking scatters and ops/restir.py spatial_reuse at the render size
  (its per-pixel tap scramble under HikariSettings.spatial_tap_scramble,
  which keeps kernel 10 out).

A textured scene takes neither fused kernel (they have no texture
fetches): the non-fused prepass and the modular lighting path, as
hikari_tpu does. Its primary surface is retrieved once per G-buffer
domain (the full-size one for the albedo, the lighting domain for the
channels), with the textures sampled through kernel 14
(ops/texture_pallas.py) in the slots some material textures.

Checkerboard lighting (at an even render width) lights half the pixels,
(x + y + frame) % 2 == 0, on the compressed [h, w/2] domain
(ops/checkerboard.py), and reconstructs the other half of every channel
in one shared pass before the denoiser: without reuse kernel B runs over
the compressed domain; with temporal reuse the frame takes the modular
path, the gather runs at the full render size, its fields are compressed,
the new reservoirs of the lit pixels are merged into the full-size carry,
and spatial reuse runs at the full render size on the merged planes.

The carry holds the previous view matrices (velocity); with temporal
reuse the [h,16,w] temporal reservoir planes at the render size; with
spatial reuse (with or without temporal reuse) the spatial ones; with
SMAA or TAA the previous full-res G-buffer; with SMAA the previous tone
image (render size); with TAA the previous TAA output (post size: twice
the render size with SMAA, else the render size, FSR included).

The debug frame (`debug=True`, behind Renderer.render_dissection) takes
the modular lighting and spatial paths whatever the gates say, on the
same carries, and also returns the per-pass planes (DEBUG_KEYS).

Every upscale hikari_tpu accepts renders: none, SMAA TU4X and FSR 1.0
(ops/post.py) at any ratio in [1, 2] and any output size, and
checkerboard lighting at any ratio. Scenes of any emissive count render
(ops/sampling.py walk_emissive_bvh).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.hk.config import (DYNAMIC_WORDS, HikariSettings, Taa,
                                     UpscaleMode, dynamic_words,
                                     frame_parity, validates)
from portbench.reference.hk.ops import checkerboard as ckb_ops
from portbench.reference.hk.ops import light_fused as _lf
from portbench.reference.hk.ops import prepass_fused as _pf
from portbench.reference.hk.ops import reservoir as rsv
from portbench.reference.hk.ops import restir
from portbench.reference.hk.ops import spatial_fused as _sf
from portbench.reference.hk.ops._kernel import dynamic
from portbench.reference.hk.ops.denoise import denoise_channels
from portbench.reference.hk.ops.noise import (frame_advance, noise_index,
                                        sample_blue_noise)
from portbench.reference.hk.ops.post import post_chain, post_sizes
from portbench.reference.hk.ops.prepass import frame_jitter, prepass
from portbench.reference.hk.ops.reproj_gather import reproj_gather
from portbench.reference.hk.ops.shading import used_slots
from portbench.reference.hk.ops.smaa import parity_context
from portbench.reference.hk.ops.tonemap import tone_mapping
from portbench.reference.hk.utils.math import F32_EPSILON

TEMPORAL_KEYS = ("direct_temporal", "emissive_temporal", "indirect_temporal")
SPATIAL_KEYS = ("spatial_de", "spatial_indirect")
# the G-buffer planes the lighting reads (compressed under checkerboard)
LIGHT_KEYS = ("position", "normal", "instance_material", "velocity_uv")
# the planes of the previous full-res G-buffer the post chain carries
PREV_GBUFFER_KEYS = ("position", "normal", "instance_material",
                     "velocity_uv")


# the frame's words (frame_words): what changes from frame to frame or with
# a retune of the settings, on the device, so that one captured frame
# (renderer.py) serves every number and every value of the dynamic settings
W_JITTER = 0      # the camera's sub-pixel jitter x, y (prepass.frame_jitter)
W_ADVANCE = 2     # frame * GOLDEN_RATIO (noise.frame_advance)
W_NOISE = 3       # the blue noise's texture and shift (noise.noise_index)
W_TAPS_E = 8      # the emissive channel's spiral taps (spatial_fused.
#                   tap_table: 8 rows), then the indirect channel's (16)
W_TAPS_I = W_TAPS_E + 8 * _sf._TAP_STRIDE
W_DYNAMIC = W_TAPS_I + 16 * _sf._TAP_STRIDE   # config.DYNAMIC_LAYOUT
FRAME_WORDS = W_DYNAMIC + DYNAMIC_WORDS


def frame_words(settings: HikariSettings, frame: dict) -> np.ndarray:
    """[FRAME_WORDS] float32 host words of the frame uniform `frame`
    (config.make_frame_uniform): from its number the jitter, the advance,
    the noise's texture and shift, and the spiral taps of the spatial
    channels the settings track (zeros otherwise); from its entries the
    settings' dynamic values (config.dynamic_words). `settings` gives the
    static fields only."""
    number = frame["number"]
    w = np.zeros(FRAME_WORDS, np.float32)
    w[W_JITTER:W_JITTER + 2] = frame_jitter(number, settings.taa,
                                            settings.upscale.mode)
    w[W_ADVANCE] = frame_advance(number)
    w[W_NOISE:W_NOISE + 2] = noise_index(number)
    for on, at, lit in zip(_tracks(settings), (W_TAPS_E, W_TAPS_I),
                           (True, False)):
        if on:
            n, reuse_range = _sf.channel_taps(lit)
            w[at:at + n * _sf._TAP_STRIDE] = _sf.tap_table(
                n, reuse_range, number).reshape(-1)
    w[W_DYNAMIC:] = dynamic_words(frame)
    return w


def with_words(frame: dict, words: torch.Tensor) -> dict:
    """The frame dict with its device words (`words`, [FRAME_WORDS] float32
    on the device) and views of them under the names the ops read:
    jitter [2], advance [1], noise_index [2], taps_e [8, 18], taps_i
    [16, 18], dynamic [DYNAMIC_WORDS] (read through _kernel.dynamic)."""
    stride = _sf._TAP_STRIDE
    return {**frame, "words": words,
            "jitter": words[W_JITTER:W_JITTER + 2],
            "advance": words[W_ADVANCE:W_ADVANCE + 1],
            "noise_index": words[W_NOISE:W_NOISE + 2],
            "taps_e": words[W_TAPS_E:W_TAPS_I].view(-1, stride),
            "taps_i": words[W_TAPS_I:W_DYNAMIC].view(-1, stride),
            "dynamic": words[W_DYNAMIC:FRAME_WORDS]}


def scaled_size(full_size, ratio: float):
    """ceil(size / ratio) (post_process.rs:1172-1174)."""
    h, w = full_size
    return (max(1, math.ceil(h / ratio)), max(1, math.ceil(w / ratio)))


def _smaa(settings: HikariSettings) -> bool:
    return settings.upscale.mode == UpscaleMode.SMAA_TU4X


def _taa(settings: HikariSettings) -> bool:
    return settings.taa == Taa.JASMINE


def _tracks(settings: HikariSettings):
    """(track_de, track_ind): which spatial channels the settings ask for."""
    return (settings.emissive_spatial_reuse,
            settings.indirect_spatial_reuse and settings.indirect_bounces > 0)


def checkerboard_active(settings: HikariSettings, full_size) -> bool:
    """Checkerboard lighting runs: asked for, at an even render width
    (hikari_tpu/frame.py:142); at an odd width the frame lights every
    pixel."""
    render_size = scaled_size(full_size, settings.upscale_ratio)
    return settings.checkerboard_lighting and render_size[1] % 2 == 0


def prepass_fused_eligible(scene, *, no_texture: bool,
                           tracer_kind: str) -> bool:
    """Kernel A serves the prepass: no textures, the small-scene tracer and
    a scene within its triangle, material and instance caps
    (hikari_tpu/ops/prepass_fused.py:63-75)."""
    return (no_texture and tracer_kind == "brute_force_pallas"
            and _pf.prepass_caps_error(scene) is None)


def fused_eligible(scene, *, no_texture: bool, num_emissives: int,
                   temporal_reuse: bool, track_de: bool, track_ind: bool,
                   tracer_kind: str, has_sun: bool, bounces: int,
                   ckb: bool) -> bool:
    """Kernel B / 4 serves the lighting (hikari_tpu/ops/light_fused.py:
    87-118): no spatial tracking outside the fused spatial path, no
    textures (the kernel fetches none), not temporal reuse under
    checkerboard (the carries live at the full render size), a channel to
    light, the small-scene tracer and a scene within the kernel's caps."""
    if track_de or track_ind or not no_texture:
        return False
    if temporal_reuse and ckb:
        return False
    if not (has_sun or num_emissives > 0 or bounces > 0):
        return False
    if tracer_kind != "brute_force_pallas":
        return False
    return _lf.lighting_caps_error(scene, num_emissives) is None


def spatial_fused_active(scene, settings: HikariSettings, tracer_kind: str,
                         no_texture: bool, num_emissives: int, has_sun: bool,
                         full_size) -> bool:
    """Kernel 10 serves spatial reuse (hikari_tpu/frame.py:44-76): spatial
    and temporal reuse on the fused temporal path (kernel 4), without
    checkerboard lighting or the tap scramble, in a scene without textures
    within kernel 10's material cap."""
    if not (any(_tracks(settings)) and settings.temporal_reuse):
        return False
    if (checkerboard_active(settings, full_size)
            or settings.spatial_tap_scramble):
        return False
    if not no_texture or not _sf.spatial_fused_eligible(scene):
        return False
    return fused_eligible(scene, no_texture=no_texture,
                          num_emissives=num_emissives,
                          temporal_reuse=True, track_de=False,
                          track_ind=False, tracer_kind=tracer_kind,
                          has_sun=has_sun,
                          bounces=settings.indirect_bounces, ckb=False)


def carry_keys(settings: HikariSettings):
    """The reservoir carries the frame of these settings reads: the
    temporal ones with temporal reuse, the spatial ones with spatial reuse
    (hikari_tpu carries them across frames without temporal reuse too)."""
    return ((TEMPORAL_KEYS if settings.temporal_reuse else ())
            + (SPATIAL_KEYS if any(_tracks(settings)) else ()))


def post_carry_shapes(full_size, settings: HikariSettings) -> dict:
    """The post chain's carries the frame of these settings reads, with
    their shapes (hikari_tpu/frame.py:103-116): the previous G-buffer at
    full size for SMAA or TAA, the previous tone image (render size) for
    SMAA, the previous TAA output (post size) for TAA. hikari_tpu's
    prev_upscale, which its post chain writes and nothing reads
    (hikari_tpu/ops/post.py:110), has no counterpart."""
    h, w = full_size
    render_size = scaled_size(full_size, settings.upscale_ratio)
    shapes = {}
    if _smaa(settings) or _taa(settings):
        shapes["prev_gbuffer"] = {"position": (h, w, 4), "normal": (h, w, 3),
                                  "instance_material": (h, w, 2),
                                  "velocity_uv": (h, w, 4)}
    if _smaa(settings):
        shapes["prev_tone"] = tuple(render_size) + (4,)
    if _taa(settings):
        shapes["prev_taa"] = post_sizes(settings, render_size) + (4,)
    return shapes


def init_carry(full_size, settings: HikariSettings, device) -> dict:
    """Persistent frame state: the previous view matrices; the [h,16,w]
    reservoir carries of carry_keys at the render size; and the post
    chain's history (post_carry_shapes). All zero: no history."""
    eye = torch.eye(4, dtype=torch.float32, device=device)
    carry = {"prev_view_proj": eye, "prev_inverse_view_proj": eye.clone()}
    h, w = scaled_size(full_size, settings.upscale_ratio)
    for k in carry_keys(settings):
        carry[k] = torch.zeros((h, rsv.PACKED_WIDTH, w), dtype=torch.float32,
                               device=device)

    def zeros(shape):
        if isinstance(shape, dict):
            return {k: zeros(v) for k, v in shape.items()}
        return torch.zeros(shape, dtype=torch.float32, device=device)

    carry.update(zeros(post_carry_shapes(full_size, settings)))
    return carry


def _prev_fields(planes, par):
    """A gathered full-size [h,16,w] reservoir as the structured reservoir
    the modular channels take, compressed to the lit pixels under
    checkerboard (par not None; a selection, so compressing before the
    per-pixel unpack equals hikari_tpu's unpack-then-compress bit for bit),
    with visible instance -1 where the count is 0 (the packed empty
    reservoir decodes instance 0, which would match instance 0 in the
    temporal gates)."""
    if par is not None:
        planes = ckb_ops.compress_planes(planes, par)
    r = rsv.unpack_reservoir_planes(planes)
    r["visible_instance"] = torch.where(r["count"] > 0.0,
                                        r["visible_instance"], -1)
    return r


def _zero_planes_where(mask, planes):
    return torch.where(mask[:, None, :], 0.0, planes)


DEBUG_KEYS = ("gbuffer_position", "gbuffer_normal", "gbuffer_depth_gradient",
              "gbuffer_velocity_uv", "albedo", "direct_raw", "emissive_raw",
              "indirect_raw", "direct_denoised", "emissive_denoised",
              "indirect_denoised", "direct_variance", "emissive_variance",
              "indirect_variance", "tone_mapping")


def build_render_frame(settings: HikariSettings, full_size, scene, tracer,
                       no_texture: bool, num_emissives: int = 1,
                       has_sun: bool = True, debug: bool = False):
    """Returns render_frame(scene, view, frame, noise, carry) -> (image
    [H,W,4], albedo [H,W,4], carry), specialized on the static settings
    and scene facts (emissive count, sun presence) and on the scene's
    tracer (ops/trace.py), which serves the non-fused prepass and the
    modular lighting path.

    render_frame reads what changes from frame to frame, and the settings'
    dynamic values, from the frame dict's device words (with_words; fresh
    ones from the frame's entries when it has none, render_frame.words)
    and takes Python branches on the frame number and the validation
    intervals only where render_frame.key(frame) says: frames of one key
    dispatch the same operations, so one captured CUDA graph per key
    (renderer.py) serves them all, whatever the number
    and the dynamic values.

    debug=True (the per-pass dissection, hikari_tpu/frame.py:610-627):
    the lighting takes the modular path and the spatial passes the
    modular ones (never kernel B, 4 or 10), over the same [h,16,w]
    carries, and render_frame also returns a fourth value, the dict of
    DEBUG_KEYS: the full-size G-buffer planes and albedo, each channel's
    raw render on the lighting domain (direct_variance too), its variance
    and its render before tone mapping at the render size, and the tone
    mapped image."""
    full_size = tuple(full_size)
    ratio = settings.upscale_ratio
    render_size = scaled_size(full_size, ratio)
    # kernel A's decimated planes and kernel 8's quads serve an exact half
    # only (hikari_tpu/frame.py:162-164)
    exact_half = (ratio == 2.0 and full_size == (2 * render_size[0],
                                                 2 * render_size[1]))
    post_history = _smaa(settings) or _taa(settings)
    bounces = settings.indirect_bounces
    reuse = settings.temporal_reuse
    track_de, track_ind = _tracks(settings)
    # channels that trace rays this configuration
    active = (has_sun, num_emissives > 0, bounces > 0)
    any_active = any(active)
    ckb = checkerboard_active(settings, full_size)
    kind = tracer.kind
    fused_pre = prepass_fused_eligible(scene, no_texture=no_texture,
                                       tracer_kind=kind)
    fused_sp = not debug and spatial_fused_active(
        scene, settings, kind, no_texture, num_emissives, has_sun, full_size)
    use_fused = any_active and not debug and fused_eligible(
        scene, no_texture=no_texture, num_emissives=num_emissives,
        temporal_reuse=reuse,
        track_de=track_de and not fused_sp,
        track_ind=track_ind and not fused_sp, tracer_kind=kind,
        has_sun=has_sun, bounces=bounces, ckb=ckb)
    modular = any_active and not use_fused
    scramble = settings.spatial_tap_scramble
    # the primary surface of the full-size G-buffer serves the lighting
    # domain where the two are one (resample_deferred's identity): one
    # kernel-14 launch
    same_domain = (not ckb and ratio == 1.0
                   and tuple(render_size) == full_size)
    light_size = (render_size[0], render_size[1] // 2) if ckb else render_size
    # the texture slots some material textures: the primary surfaces
    # sample only those (kernel 14 launches once per slot and domain)
    tex_slots = used_slots(scene)
    sp_sources = []
    if fused_sp:
        if track_de and num_emissives > 0:
            sp_sources.append("spatial_de")
        if track_ind:
            sp_sources.append("spatial_indirect")

    # the empty reservoir's planes, broadcast over [h,16,w]
    empty = rsv.pack_reservoir_planes(
        rsv.empty_reservoir((1, 1), scene["tri_pos_flat"].device))

    def apply_scatters(fl, reproj, prev_p, slots):
        """The spatial-buffer invalidation scatters of the modular path
        (restir.py:267-271, 414-417) as a per-pixel replace: they target
        the coordinates the gather just read."""
        in_loose = reproj["in_loose"]
        for slot in slots:
            flags = fl[f"{slot}_flags"]
            gate_m = (torch.fmod(flags, 2.0) >= 1.0) & in_loose
            prev_p = torch.where(gate_m[:, None, :], empty, prev_p)
            if f"{slot}_scatter" in fl:
                val_m = (flags >= 2.0) & in_loose
                prev_p = torch.where(val_m[:, None, :],
                                     fl[f"{slot}_scatter"], prev_p)
        return prev_p

    def modular_lighting(scene, g, g_l, view, frame, rand, rand_l, reproj,
                         gathered, carry, par, surf_l, surf_r):
        """direct_lit / indirect_lit_ambient of the active channels on the
        lighting domain, with the spatial tracking scatters and the spatial
        passes at the render size (hikari_tpu/frame.py:412-532), on the
        primary surfaces of the lighting domain (surf_l) and of the render
        size (surf_r); without temporal reuse on the empty reservoir
        (hikari_tpu/frame.py:247). Returns
        ({slot: (render, variance)} on the lighting domain, the new
        reservoir carries, {slot: spatial pass result})."""
        slots = [slot for c, slot in enumerate("dei") if active[c]]
        if reuse:
            prev = {slot: _prev_fields(p, par)
                    for slot, p in zip(slots, gathered)}
        else:
            prev = {slot: rsv.empty_reservoir(light_size, rand.device)
                    for slot in slots}
        reproj_l = (reproj if par is None or reproj is None
                    else restir.reprojection_ckb(g_l, render_size, par))
        kw = dict(temporal_reuse=reuse, no_texture=no_texture,
                  render_size=light_size, surface=surf_l, reproj=reproj_l)
        buf = {"spatial_de": carry.get("spatial_de"),
               "spatial_indirect": carry.get("spatial_indirect")}
        out = {}
        if has_sun:
            out["d"] = restir.direct_lit(
                scene, tracer, g_l, view, frame, rand_l, prev["d"],
                emissive_lit=False, prev_spatial=buf["spatial_de"],
                track_spatial=track_de, **kw)
            buf["spatial_de"] = out["d"]["prev_spatial"]
        if num_emissives > 0:
            out["e"] = restir.direct_lit(
                scene, tracer, g_l, view, frame, rand_l, prev["e"],
                emissive_lit=True, prev_spatial=buf["spatial_de"],
                track_spatial=track_de, **kw)
            buf["spatial_de"] = out["e"]["prev_spatial"]
        if bounces > 0:
            out["i"] = restir.indirect_lit_ambient(
                scene, tracer, g_l, view, frame, rand_l, prev["i"],
                bounces=bounces, prev_spatial=buf["spatial_indirect"],
                track_spatial=track_ind, **kw)
            buf["spatial_indirect"] = out["i"]["prev_spatial"]
        carries, merged = {}, {}
        for c, slot in enumerate("dei"):
            if slot not in out:
                continue
            key = TEMPORAL_KEYS[c]
            if reuse:
                planes = rsv.pack_reservoir_planes(out[slot]["temporal"])
                if par is not None:
                    planes = ckb_ops.merge_packed_planes(planes, carry[key],
                                                         par)
                carries[key] = merged[slot] = planes
            elif par is not None and (track_de if slot == "e"
                                      else slot == "i" and track_ind):
                # the spatial pass's full-size field: the new lit pixels
                # over hikari_tpu's never-written (zero) temporal carry
                planes = rsv.pack_reservoir_planes(out[slot]["temporal"])
                merged[slot] = ckb_ops.merge_packed_planes(
                    planes, torch.zeros((render_size[0], rsv.PACKED_WIDTH,
                                         render_size[1]),
                                        device=planes.device), par)
        spatial = {}
        valid = g["position"][..., 3] >= F32_EPSILON
        for slot, key, on in (("e", "spatial_de", track_de),
                              ("i", "spatial_indirect", track_ind)):
            if not on:
                continue
            carries[key] = buf[key]
            if slot not in out:
                continue
            # the spatial pass runs at the render size: under checkerboard
            # on the merged planes (new lit pixels, carried unlit ones)
            temporal_r = (out[slot]["temporal"] if par is None else
                          rsv.unpack_reservoir_planes(merged[slot]))
            # the blue noise's fourth (emissive) or third (indirect)
            # channel picks each pixel's rotation (hikari_tpu/frame.py:488,
            # 527)
            bits = (None if not scramble else
                    (rand[..., 3 if slot == "e" else 2] * 4.0).to(torch.int32)
                    & 3)
            res = restir.spatial_reuse(
                scene, g, view, frame, temporal_r, buf[key], reproj,
                emissive_lit=slot == "e", no_texture=no_texture,
                render_size=render_size, scramble_bits=bits, surface=surf_r)
            carries[key] = _zero_planes_where(
                ~valid, rsv.pack_reservoir_planes(res["spatial"]))
            spatial[slot] = res
        return ({k: (v["render"], v["variance"]) for k, v in out.items()},
                carries, spatial)

    def to_full(lit, par, g):
        """Every lit channel's (render, variance) from the compressed
        domain to the render size in one reconstruction (the neighbour
        gates are shared)."""
        cat = torch.cat([torch.cat([r, v[..., None]], -1)
                         for r, v in lit.values()], -1)
        amask = ckb_ops.active_mask(par, render_size, cat.device)
        bf = ckb_ops.reconstruct(ckb_ops.expand(cat, par), amask,
                                 g["position"][..., 3], g["normal"])
        return {slot: (bf[..., 5 * i:5 * i + 4], bf[..., 5 * i + 4])
                for i, slot in enumerate(lit)}

    # the frame number and the frame's validation intervals pick these
    # branches only (the values are the frame's device words): the parity
    # of the decimation, the deferred lookup, SMAA and the checkerboard,
    # and each traced channel's validation (hikari_tpu's lax.cond)
    uses_parity = (ckb or _smaa(settings)
                   or not (ratio == 1.0 and tuple(render_size) == full_size))
    validating = any_active and (reuse if use_fused
                                 else modular and (reuse or track_de))

    def key(frame: dict) -> tuple:
        """The branches of the frame uniform `frame`: (parity, direct
        validation, emissive validation), None where the configuration
        takes no such branch, from the frame's own number and intervals by
        the calls the frame makes (config.frame_parity, validates). Frames
        of one key run the same launches on the same shapes."""
        number = frame["number"]
        return (frame_parity(number) if uses_parity else None,
                validates(number, frame["direct_validate_interval"])
                if validating and has_sun else None,
                validates(number, frame["emissive_validate_interval"])
                if validating and num_emissives > 0 else None)

    def words(frame: dict) -> np.ndarray:
        """The frame's device words for the frame uniform `frame` (to
        stage before a replay)."""
        return frame_words(settings, frame)

    def render_frame(scene, view, frame, noise, carry):
        if "words" not in frame:
            # a caller outside the frame program: fresh device words
            frame = with_words(frame, torch.from_numpy(
                words(frame)).to(noise.device))
        prev_view = {"view_proj": carry["prev_view_proj"],
                     "inverse_view_proj": carry["prev_inverse_view_proj"]}
        number = frame["number"]
        jit = frame["jitter"]
        albedo_r = smaa_quads = surf_full = None
        if fused_pre and exact_half:
            # the render-size G-buffer: kernel A's strided planes
            gbuf, albedo, g, albedo_r = _pf.prepass_fused(
                scene, view, prev_view, jit, full_size,
                dec_parity=frame_parity(number))
        elif fused_pre:
            gbuf, albedo = _pf.prepass_fused(scene, view, prev_view, jit,
                                             full_size)
        else:
            gbuf = prepass(scene, tracer, view, prev_view, jit, full_size)
            surf_full = restir.primary_surface(scene, gbuf, no_texture,
                                               tex_slots)
            albedo = restir.full_screen_albedo(scene, gbuf, view, no_texture,
                                               surface=surf_full)
        if not (fused_pre and exact_half):
            g = restir.resample_gbuffer(gbuf, render_size, number, ratio)
        if _smaa(settings):
            smaa_quads = (_pf.prepass_fused_quads(gbuf)
                          if fused_pre and exact_half
                          else parity_context(gbuf, render_size))
        rand = sample_blue_noise(noise, frame, render_size)
        par = None
        g_l, rand_l = g, rand
        if ckb:
            # the lighting domain: this frame's lit pixels, compressed
            par = frame_parity(number)
            g_l = {k: ckb_ops.compress(g[k], par) for k in LIGHT_KEYS}
            rand_l = ckb_ops.compress(rand, par)
        dev = albedo.device
        zero_render = torch.zeros(render_size + (4,), device=dev)
        zero_var = torch.zeros(render_size, device=dev)
        new_carry = {
            "prev_view_proj": view["view_proj"],
            "prev_inverse_view_proj": view["inverse_view_proj"],
        }

        gathered, sp_gathered, reproj = [], {}, None
        if any_active and (reuse or track_de or track_ind):
            reproj = restir.reprojection(g, render_size)
        if reuse and any_active:
            # one gather launch for every active temporal channel and
            # spatial source, at the render size (under checkerboard too);
            # pixels outside the strict unit box read -1
            piy_m = torch.where(reproj["in_strict"], reproj["piy"],
                                -1).to(torch.int32).contiguous()
            keys = [TEMPORAL_KEYS[c] for c in range(3) if active[c]]
            outs = reproj_gather([carry[k] for k in keys + sp_sources],
                                 piy_m, reproj["pix"].contiguous())
            gathered = outs[:len(keys)]
            sp_gathered = dict(zip(sp_sources, outs[len(keys):]))
        for k in TEMPORAL_KEYS + SPATIAL_KEYS:
            if k in carry:
                new_carry[k] = carry[k]

        # {slot: (render, variance)} of the channels that trace rays, on
        # the lighting domain
        lit, fl, spatial, raw = {}, {}, {}, {}
        surf_r = None
        if modular:
            # one primary surface per G-buffer domain, shared by every
            # channel (hikari_tpu/frame.py:421-429)
            surf_l = (surf_full if same_domain and surf_full is not None
                      else restir.primary_surface(scene, g_l, no_texture,
                                                  tex_slots))
            if par is None:
                surf_r = surf_l
            elif not has_sun or (track_de and active[1]) or track_ind:
                surf_r = restir.primary_surface(scene, g, no_texture,
                                                tex_slots)
            lit, carries, spatial = modular_lighting(
                scene, g, g_l, view, frame, rand, rand_l, reproj, gathered,
                carry, par, surf_l, surf_r)
            raw = dict(lit)
            new_carry.update(carries)
        elif any_active:
            fl = _lf.fused_lighting(
                scene, g_l, view, frame, rand_l, has_sun=has_sun,
                num_emissives=num_emissives, bounces=bounces,
                render_size=light_size, temporal=reuse,
                prev_planes=gathered, track_de=track_de and fused_sp,
                track_ind=track_ind and fused_sp)
            zero_l = torch.zeros(light_size, device=dev)
            for c, slot in enumerate("dei"):
                if active[c]:
                    lit[slot] = (fl[f"{slot}_render"],
                                 fl[f"{slot}_var"] if reuse else zero_l)
                    if reuse:
                        new_carry[TEMPORAL_KEYS[c]] = fl[f"{slot}_packed"]
        if ckb and lit:
            lit = to_full(lit, par, g)
        # the modular spatial passes' renders, their variances where set
        for slot, res in spatial.items():
            lit[slot] = (res["render"],
                         torch.where(torch.isnan(res["variance"]),
                                     lit[slot][1], res["variance"]))

        if has_sun:
            d_render, d_var = lit["d"]
        else:
            # the deterministic surface-emission term (no rays), at the
            # render size
            d = restir.emissive_surface_channel(scene, g, no_texture,
                                                render_size, surface=surf_r)
            d_render, d_var = d["render"], d["variance"]
            raw["d"] = (d_render, d_var)
        e_render, e_var = lit.get("e", (zero_render, zero_var))
        i_render, i_var = lit.get("i", (zero_render, zero_var))

        if "spatial_de" in sp_gathered:
            prev_de = apply_scatters(
                fl, reproj, sp_gathered["spatial_de"],
                [s for s, on in (("d", has_sun), ("e", True)) if on])
            sp = _sf.spatial_fused(scene, g, view, frame, fl["e_packed"],
                                   prev_de, emissive_lit=True,
                                   render_size=render_size)
            new_carry["spatial_de"] = sp["spatial_planes"]
            e_render = sp["render"]
            e_var = torch.where(torch.isnan(sp["variance"]), e_var,
                                sp["variance"])
        if "spatial_indirect" in sp_gathered:
            prev_ind = apply_scatters(fl, reproj,
                                      sp_gathered["spatial_indirect"], ["i"])
            sp = _sf.spatial_fused(scene, g, view, frame, fl["i_packed"],
                                   prev_ind, emissive_lit=False,
                                   render_size=render_size)
            new_carry["spatial_indirect"] = sp["spatial_planes"]
            i_render = sp["render"]
            i_var = torch.where(torch.isnan(sp["variance"]), i_var,
                                sp["variance"])

        if settings.denoise:
            # firefly filtering off for direct, on for emissive/indirect;
            # the sun-less direct term has zero variance and is left as is
            dn_in, slots = [], []
            if has_sun:
                dn_in.append((d_render, d_var, False))
                slots.append("d")
            if active[1]:
                dn_in.append((e_render, e_var, True))
                slots.append("e")
            if active[2]:
                dn_in.append((i_render, i_var, True))
                slots.append("i")
            if dn_in:
                outs = dict(zip(slots, denoise_channels(
                    g, albedo, dn_in, frame, render_size, ratio,
                    albedo_r=albedo_r)))
                d_render = outs.get("d", d_render)
                e_render = outs.get("e", e_render)
                i_render = outs.get("i", i_render)

        tone = tone_mapping(d_render, e_render, i_render,
                            dynamic(frame, "clear_color", dev))
        image, post_carry = post_chain(gbuf, carry, tone, frame, settings,
                                       full_size, render_size, smaa_quads)
        new_carry.update(post_carry)
        if post_history:
            new_carry["prev_gbuffer"] = {k: gbuf[k]
                                         for k in PREV_GBUFFER_KEYS}
        if debug:
            # a channel that traces nothing: hikari_tpu's zeros, at the
            # render size (emissive) or the lighting domain (indirect)
            e_raw = raw.get("e", (zero_render, zero_var))
            i_raw = raw.get("i", (torch.zeros(light_size + (4,), device=dev),
                                  None))
            vals = (gbuf["position"], gbuf["normal"], gbuf["depth_gradient"],
                    gbuf["velocity_uv"], albedo, raw["d"][0], e_raw[0],
                    i_raw[0], d_render, e_render, i_render, raw["d"][1],
                    e_var, i_var, tone)
            return image, albedo, new_carry, dict(zip(DEBUG_KEYS, vals))
        return image, albedo, new_carry

    render_frame.key = key
    render_frame.words = words
    return render_frame
