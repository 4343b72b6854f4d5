"""Pose extraction at the reference's own scale: BODY_25 @ 368x368.

The reference publishes two hard stage numbers (BASELINE.md):
resize+merge ~5 ms GPU / ~20 ms CPU (poseExtractorCaffe.cpp:294) and
NMS ~2 ms GPU / ~7 ms CPU (:308), both on the authors' CUDA build at
net resolution 368x368 with the BODY_25 topology. This bench runs OUR
pipeline at exactly that shape (randomly initialized weights — stage
cost is weight-independent) and times the same two stages standalone
plus the full image->People extraction, single frame and batch 8.

Run: python -m benchmarks.pose_bench
"""

from __future__ import annotations

import json
import time


def run(net_hw=(368, 368), topology: str = "BODY_25", batch: int = 8,
        reps: int = 30) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from perception.models.pose import (
        PoseNet,
        extract_people,
        lookup_topology,
    )
    from perception.ops.heatmap import nms_heatmap, resize_and_merge

    parts, pairs = lookup_topology(topology)
    P, L = len(parts), len(pairs)
    net = PoseNet(num_parts=P, num_limbs=L)
    key = jax.random.key(0)
    params = net.init(key, jnp.zeros((1,) + tuple(net_hw) + (3,)))
    img = jax.random.uniform(jax.random.key(1), tuple(net_hw) + (3,))
    imgs = jax.random.uniform(jax.random.key(2), (batch,) + tuple(net_hw) + (3,))

    def timed(f, *a, probe=None, n=reps):
        out = f(*a)
        jax.block_until_ready(probe(out) if probe else out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = f(*a)
        jax.block_until_ready(probe(out) if probe else out)
        return 1000.0 * (time.perf_counter() - t0) / n

    # Stage 1: resize+merge at the reference's published shape — the
    # stride-8 maps ((P+1) @ 46x46) up to net resolution.
    maps = jax.random.uniform(jax.random.key(3), (P + 1, net_hw[0] // 8, net_hw[1] // 8))
    merge = jax.jit(lambda m: resize_and_merge(m[None], tuple(net_hw)))
    resize_merge_ms = timed(merge, maps)

    # Stage 2: NMS at net resolution (the reference's writeResultKernel
    # shape), 25 part channels.
    hms = jax.random.uniform(jax.random.key(4), (P,) + tuple(net_hw))
    nms = jax.jit(lambda h: nms_heatmap(h, threshold=0.1, max_peaks=32))
    nms_ms = timed(nms, hms, probe=lambda o: o.xy)

    # Full extraction image -> People, single and batched.
    single = jax.jit(
        lambda p, x: extract_people(p, x, topology, net_hw=net_hw, net=net)
    )
    single_ms = timed(single, params, img, probe=lambda o: o.keypoints)
    batched = jax.jit(
        jax.vmap(
            lambda x, p: extract_people(p, x, topology, net_hw=net_hw, net=net),
            in_axes=(0, None),
        ),
        static_argnums=(),
    )
    batch_ms = timed(
        lambda p, x: batched(x, p), params, imgs, probe=lambda o: o.keypoints
    )

    return {
        "topology": topology,
        "net_hw": list(net_hw),
        "resize_merge_ms": round(resize_merge_ms, 3),
        "nms_ms": round(nms_ms, 3),
        "extract_ms_batch1": round(single_ms, 3),
        "extract_fps_batch1": round(1000.0 / single_ms, 1),
        "batch": batch,
        "extract_ms_per_frame_batch": round(batch_ms / batch, 3),
        "extract_fps_batch": round(1000.0 * batch / batch_ms, 1),
        "reference_gpu_ms": {"resize_merge": 5.0, "nms": 2.0,
                             "note": "1080 Ti CUDA, poseExtractorCaffe.cpp:294,308"},
    }


if __name__ == "__main__":
    print(json.dumps(run()))
