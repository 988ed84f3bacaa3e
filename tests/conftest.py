"""Test environment: force an 8-device virtual CPU mesh before JAX loads.

Multi-device sharding is validated on virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count), the way
dryrun_multichip exercises the sharded path without several cards.

MCMTT_TEST_PLATFORM=gpu leaves the GPU as JAX's default device (the CPU
stays available for comparisons) for the tests marked `gpu`; they skip
everywhere else.
"""

import os

_ON_GPU = os.environ.get("MCMTT_TEST_PLATFORM") == "gpu"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _ON_GPU else "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

# the config update pins the platform even when jax was imported before
# this file set the environment
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def gpu():
    """The GPU, for tests that need the card; skips when there is none.
    Decided here, at run time, so that every xdist worker collects the
    same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (MCMTT_TEST_PLATFORM=gpu on the card)")
    return dev


@pytest.fixture(scope="session")
def small_2d_scene():
    """(EngineConfig, scenario, uint8 frames): 2 cameras at 256x192 over 5
    frames, for the 2D step's comparisons."""
    from mcmtt_opticalflow_tpu.config import EngineConfig, Tracker2DConfig
    from mcmtt_opticalflow_tpu.data import make_scenario

    cfg = EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=Tracker2DConfig(max_detections=16, max_trackers=32,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=6))
    sc = make_scenario(num_cameras=2, num_frames=5, num_people=4,
                       image_size=(256, 192), arena=3000.0, seed=3)
    frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
              .astype(np.uint8) for t in range(5)]
    return cfg, sc, frames
