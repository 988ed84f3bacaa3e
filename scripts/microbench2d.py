#!/usr/bin/env python
"""Microbenchmark the 2D-stage building blocks at bench.py shapes."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def bench(name, fn, *args, n=10):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    print(f"{name:34s} med={np.median(ts)*1e3:8.2f}ms "
          f"min={min(ts)*1e3:8.2f}ms", flush=True)


def main():
    from mcmtt_opticalflow_tpu.ops.lk import lk_track_pyramid
    from mcmtt_opticalflow_tpu.ops.features import detect_grid_features
    from mcmtt_opticalflow_tpu.ops.hungarian import solve_assignment

    rng = np.random.RandomState(0)
    h, w = 576, 768
    img = rng.rand(4, h, w).astype(np.float32)
    img2 = np.roll(img, 2, axis=2)
    prev = jnp.asarray(img)
    nxt = jnp.asarray(img2)

    # camera-vmapped LK at tracker shapes: backward 2048/cam, forward 4096/cam
    for npts, tag in ((2048, "backward"), (4096, "forward")):
        pts = jnp.asarray(rng.rand(4, npts, 2).astype(np.float32)
                          * [w - 64, h - 64] + 32)
        act = jnp.ones((4, npts), bool)

        @jax.jit
        def run(p, q, x, a):
            f = jax.vmap(lambda pi, qi, xi, ai: lk_track_pyramid(
                pi, qi, xi, levels=2, window=16, iterations=8,
                active=ai))
            return f(p, q, x, a)

        bench(f"lk[{tag} {npts}x4cam]", run, prev, nxt, pts, act)

    # grid features at detection shapes
    boxes = jnp.asarray(rng.rand(4, 32, 4).astype(np.float32)
                        * [600, 400, 60, 120] + [20, 20, 20, 40])
    bmask = jnp.ones((4, 32), bool)

    @jax.jit
    def feats(g, b, m):
        return jax.vmap(lambda gi, bi, mi: detect_grid_features(
            gi, bi, mi, grid=8, sub=2, quality=0.01))(g, b, m)

    bench("detect_grid_features[32x4cam]", feats, prev, boxes, bmask)

    # assignment at cost-matrix shapes
    cost = jnp.asarray(rng.rand(4, 32, 64).astype(np.float32))
    rv = jnp.ones((4, 32), bool)
    cv = jnp.ones((4, 64), bool)

    @jax.jit
    def assign(c, r, cc):
        return jax.vmap(solve_assignment)(c, r, cc)

    bench("solve_assignment[32x64 x4cam]", assign, cost, rv, cv)


if __name__ == "__main__":
    main()
