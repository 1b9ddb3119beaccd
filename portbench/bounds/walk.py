"""Kernel 13 (csrc/trace_bvh.cu, the BVH walk), bytes only: the world
walk's tables (bvh_packed, tri_pos_flat and, in full mode, tri_attr) read
once, 36 B a ray in (origin, direction, max_t, exclude, include) and 20,
36 or 8 B a ray out (hit, full, shadow). Its operations depend on the
slab and triangle tests each ray makes, which are data and not counted,
so a share of this bound is a lower estimate of the share of the true
bound.

The calls a frame makes are a configuration's table,
portbench/bounds/walk_calls/<config>.json: each call's mode, domain
("output" or "render" pixels) and when it runs ("always", or on a
"direct_validation" or "emissive_validation" frame)."""

import json
import os

from portbench.bounds.peaks import bound_ms

RAY_IN = 36
RAY_OUT = {"hit": 4 * 5, "full": 4 * (1 + 1 + 3 + 2 + 1 + 1),
           "shadow": 4 * 2}
TABLES = {"hit": ("bvh_packed", "tri_pos_flat"),
          "full": ("bvh_packed", "tri_pos_flat", "tri_attr"),
          "shadow": ("bvh_packed", "tri_pos_flat")}
CALLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "walk_calls")


def calls_of(config: str):
    """The configuration's table of kernel 13's calls, or None where it
    has none."""
    path = os.path.join(CALLS_DIR, f"{config}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["calls"]


def call_bytes(mode: str, rays: int, table_words: dict) -> float:
    """Bytes of one call of `rays` rays; table_words: numel of each table."""
    tables = sum(table_words[k] for k in TABLES[mode]) * 4
    return tables + rays * (RAY_IN + RAY_OUT[mode])


def call_bound_ms(mode: str, rays: int, table_words: dict) -> float:
    return bound_ms(call_bytes(mode, rays, table_words), 0.0)[0]


def frame_calls(calls: list, number: int, direct_interval: int,
                emissive_interval: int, domains: dict) -> list:
    """(mode, rays) of the calls frame `number` makes, from a configuration's
    table (mode, domain, when) and the domains' pixel counts."""
    when = {"always": True,
            "direct_validation": number % max(direct_interval, 1) == 0,
            "emissive_validation": number % max(emissive_interval, 1) == 0}
    return [(c["mode"], domains[c["domain"]]) for c in calls
            if when[c["when"]]]
