"""The LK level as the engine runs it: single-camera and camera-batched
(jax.vmap, as the 2D tracker calls it), on smooth random textures with a
known subpixel shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmtt_opticalflow_tpu.ops.lk import lk_track_prebuilt

SHIFTS = [(2.3, -1.6), (0.4, 0.9), (-3.1, 2.2)]


def _scene(rng, h=64, w=256, shift=(2.3, -1.6)):
    """Smooth random texture and a subpixel-shifted copy."""
    base = rng.rand(h + 8, w + 8).astype(np.float32)
    for _ in range(3):  # cheap smoothing for differentiable texture
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 0) + np.roll(base, -1, 1)) / 5.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def sample(img, y, x):
        iy, ix = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - iy, x - ix
        return (img[iy, ix] * (1 - fy) * (1 - fx)
                + img[iy, ix + 1] * (1 - fy) * fx
                + img[iy + 1, ix] * fy * (1 - fx)
                + img[iy + 1, ix + 1] * fy * fx)

    prev = sample(base, ys + 2, xs + 2)
    nxt = sample(base, ys + 2 + shift[1], xs + 2 + shift[0])
    return prev, nxt


def _points(rng, h, w, n=16):
    return np.stack([rng.uniform(32, w - 32, n),
                     rng.uniform(24, h - 24, n)], -1).astype(np.float32)


def _level(prev, nxt, pts, act):
    """One pyramid level, 16-px window, 8 Newton iterations."""
    return lk_track_prebuilt([prev], [nxt], pts, window=16, iterations=8,
                             max_residual=1.0, active=act)


def _recovers(flow, shift):
    # sampling base at +shift moves the scene content by -shift; a couple
    # of features on a weakly-textured spot may stall at a single level
    good = ((np.abs(flow[:, 0] + shift[0]) < 0.3)
            & (np.abs(flow[:, 1] + shift[1]) < 0.3))
    return good.mean()


@pytest.mark.parametrize("variant", ["single", "batched"])
@pytest.mark.parametrize("shift", SHIFTS)
def test_lk_level_recovers_shift(shift, variant):
    rng = np.random.RandomState(42)   # scene must not depend on
    #                                   which tests ran before
    prev, nxt = _scene(rng, shift=shift)
    pts = _points(rng, *prev.shape)
    act = np.ones(len(pts), bool)
    act[-3:] = False
    single = [np.asarray(a) for a in jax.jit(_level)(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
        jnp.asarray(act))]
    if variant == "single":
        tracked, ok, _ = single
    else:
        # camera 1 holds another scene; camera 0 must match the
        # single-camera call
        rng2 = np.random.RandomState(7)
        prev2, nxt2 = _scene(rng2, shift=SHIFTS[0])
        stack = lambda a, b: jnp.asarray(np.stack([a, b]))  # noqa: E731
        out = [np.asarray(a) for a in jax.jit(jax.vmap(_level))(
            stack(prev, prev2), stack(nxt, nxt2), stack(pts, pts),
            stack(act, act))]
        tracked, ok, _ = (a[0] for a in out)
        np.testing.assert_allclose(tracked, single[0], atol=1e-4)
        np.testing.assert_array_equal(ok, single[1])
        flow2 = out[0][1] - pts
        assert _recovers(flow2[out[1][1]], SHIFTS[0]) >= 0.8
    assert not ok[-3:].any(), "inactive features must report invalid"
    live = ok[:-3]
    assert live.sum() >= len(pts) - 6, ok
    flow = tracked[:-3][live] - pts[:-3][live]
    assert _recovers(flow, shift) >= 0.8, flow
