"""Kernel 4's plain version against hikari_tpu's temporal Pallas lighting
on the scene with both a sun and an emitter (all three channels, both
validation retraces); see test_torch_light_temporal.py for the method."""

from __future__ import annotations

import pytest

from tests.test_torch_light_temporal import TEST_FRAMES, check_case
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("number", TEST_FRAMES)
def test_temporal_lighting_matches_pallas_sun_and_emitter(number, track):
    check_case("emissive_and_sun", number, track)
