"""Multi-person 2-D pose estimation: CNN + heatmap/PAF decode.

The OpenPose capability family (reference layers L2/L3, SURVEY.md §2.5)
rebuilt for fixed shapes:

  * **topology zoo** — BODY_25, COCO_18, MPI_15, CAR_12 part maps + pairs
    (the *what* of ``poseParameters.cpp:7-591``, re-declared from the
    public OpenPose part naming);
  * **PoseNet** — a flax two-branch CNN in the CMU style: VGG-ish
    backbone then iterative refinement stages, each emitting part
    affinity fields (2 per limb) and part heatmaps (+1 background).
    NHWC, bf16-ready; weights train/load via standard flax checkpoints
    (no pretrained weights ship — the reference downloads .caffemodel
    at build time, which a zero-egress build cannot);
  * **extract_people** — the full decode: multi-scale resize+merge ->
    heatmap NMS -> PAF pair scoring -> greedy matching -> skeleton
    assembly (ops/heatmap.py + ops/paf.py), one jitted call.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from perception.ops.heatmap import nms_heatmap, resize_and_merge
from perception.ops.paf import (
    People,
    assemble_people,
    greedy_match,
    paf_pair_scores,
)

# --- topology zoo ----------------------------------------------------------

BODY_25_PARTS = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
]

BODY_25_PAIRS = np.array(
    [
        (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
        (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
        (15, 17), (0, 16), (16, 18), (14, 19), (19, 20), (14, 21), (11, 22),
        (22, 23), (11, 24),
    ],
    np.int32,
)

COCO_18_PARTS = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye",
    "LEye", "REar", "LEar",
]

COCO_18_PAIRS = np.array(
    [
        (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
        (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
        (0, 15), (15, 17),
    ],
    np.int32,
)

MPI_15_PARTS = [
    "Head", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "Chest",
]

MPI_15_PAIRS = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 14),
        (14, 8), (8, 9), (9, 10), (14, 11), (11, 12), (12, 13),
    ],
    np.int32,
)

# Vehicle keypoints (CAR_12 of poseParameters.cpp): 4 wheels, 4 lights,
# 4 roof corners; limbs outline the wheelbase, light bar, and roof.
CAR_12_PARTS = [
    "FRWheel", "FLWheel", "BRWheel", "BLWheel", "FRLight", "FLLight",
    "BRLight", "BLLight", "FRTop", "FLTop", "BRTop", "BLTop",
]

CAR_12_PAIRS = np.array(
    [
        (4, 5), (4, 6), (5, 7), (6, 7), (4, 0), (0, 2), (6, 2), (5, 1),
        (1, 3), (7, 3), (8, 9), (8, 10), (9, 11), (10, 11), (4, 8), (5, 9),
        (6, 10), (7, 11),
    ],
    np.int32,
)

TOPOLOGIES = {
    "BODY_25": (BODY_25_PARTS, BODY_25_PAIRS),
    "COCO_18": (COCO_18_PARTS, COCO_18_PAIRS),
    "MPI_15": (MPI_15_PARTS, MPI_15_PAIRS),
    "CAR_12": (CAR_12_PARTS, CAR_12_PAIRS),
}


def lookup_topology(name: str):
    """Resolve a topology by name — the four core ones here, the full
    zoo (BODY_135, CAR_22, BODY_19/23/25B/25D/25E) in models/topologies."""
    if name in TOPOLOGIES:
        return TOPOLOGIES[name]
    from perception.models.topologies import FULL_ZOO

    return FULL_ZOO[name]


# --- network ---------------------------------------------------------------

class ConvBlock(nn.Module):
    features: int
    layers: int = 2

    @nn.compact
    def __call__(self, x):
        for _ in range(self.layers):
            x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
            x = nn.relu(x)
        return x


class Stage(nn.Module):
    """One refinement stage: concat(features, prev outputs) -> two heads."""

    paf_channels: int
    hm_channels: int
    width: int = 96
    depth: int = 4

    @nn.compact
    def __call__(self, x):
        h = x
        for _ in range(self.depth):
            h = nn.Conv(self.width, (3, 3), padding="SAME")(h)
            h = nn.relu(h)
        h = nn.Conv(self.width, (1, 1))(h)
        h = nn.relu(h)
        paf = nn.Conv(self.paf_channels, (1, 1))(h)
        hm = nn.Conv(self.hm_channels, (1, 1))(h)
        return paf, hm


class PoseNet(nn.Module):
    """Two-branch multi-stage pose CNN (CMU architecture shape).

    Input NHWC float in [0, 1]; outputs at stride 8:
    (pafs (N, H/8, W/8, 2*L), heatmaps (N, H/8, W/8, P+1)).
    """

    num_parts: int = 25
    num_limbs: int = 24
    num_stages: int = 3
    backbone_widths: Sequence[int] = (32, 64, 128)
    stage_width: int = 96
    stage_depth: int = 4

    @nn.compact
    def __call__(self, x):
        # VGG-style backbone, 3 pools -> stride 8.
        for w in self.backbone_widths:
            x = ConvBlock(w)(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        feats = ConvBlock(self.backbone_widths[-1])(x)

        paf_c = 2 * self.num_limbs
        hm_c = self.num_parts + 1  # + background
        paf, hm = Stage(paf_c, hm_c, self.stage_width, self.stage_depth)(feats)
        for _ in range(self.num_stages - 1):
            inp = jnp.concatenate([feats, paf, hm], axis=-1)
            paf, hm = Stage(paf_c, hm_c, self.stage_width, self.stage_depth)(inp)
        return paf, hm


# --- extraction ------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("num_parts", "max_peaks", "max_people", "min_person_parts"),
)
def decode_people(
    pafs: jax.Array,       # (2L, H, W) channel-first merged fields
    heatmaps: jax.Array,   # (P, H, W) merged part heatmaps (no background)
    limb_pairs: jax.Array, # (L, 2)
    num_parts: int,
    max_peaks: int = 32,
    max_people: int = 16,
    peak_threshold: float = 0.1,
    min_person_parts: int = 3,
    paf_stride: float = 1.0,
) -> People:
    """Heatmaps+PAFs -> assembled skeletons (the post-CNN pipeline).

    ``paf_stride``: the PAF grid's stride relative to the peak
    coordinate frame. Passing the stride-8 fields with paf_stride=8
    is numerically equivalent to sampling their bilinear upsample
    (bilinear-of-bilinear ~= bilinear at scaled coords — the upsample
    adds no information) but shrinks the matmul sampler's contraction by
    the stride on each spatial axis (64x fewer line-integral terms at
    stride 8).
    """
    peaks = nms_heatmap(heatmaps, threshold=peak_threshold, max_peaks=max_peaks)

    L = limb_pairs.shape[0]

    def to_paf(xy):
        # Half-pixel-center alignment (jax.image.resize convention):
        # full-res coord x sits at stride-grid coord (x + .5)/s - .5.
        return (xy + 0.5) / paf_stride - 0.5

    def score_limb(l):
        a = limb_pairs[l, 0]
        b = limb_pairs[l, 1]
        return paf_pair_scores(
            pafs[2 * l], pafs[2 * l + 1],
            to_paf(peaks.xy[a]), peaks.mask[a],
            to_paf(peaks.xy[b]), peaks.mask[b],
        )

    scores = jax.vmap(score_limb)(jnp.arange(L))  # (L, K, K)
    matches = jax.vmap(greedy_match)(scores)      # LimbMatches batched over L

    return assemble_people(
        limb_pairs,
        matches.a_idx, matches.b_idx, matches.score, matches.mask,
        peaks.xy, peaks.score, peaks.mask,
        num_parts=num_parts,
        max_peaks=max_peaks,
        max_people=max_people,
        min_person_parts=min_person_parts,
    )


def extract_people(
    params,
    image: jax.Array,
    topology: str = "BODY_25",
    scales: Sequence[float] = (1.0,),
    net_hw: Tuple[int, int] = (368, 368),
    net: "PoseNet | None" = None,
    **decode_kwargs,
) -> People:
    """Full forward pass: image (H, W, 3) [0,1] -> People.

    Multi-scale: the image is resized to ``scale * net_hw`` per scale,
    run through the net, and the maps are merged at net resolution
    (PoseExtractorCaffe::forwardPass structure, poseExtractorCaffe.cpp:202-340).
    ``net`` overrides the default-config PoseNet (e.g. a small trained
    variant); its head sizes must match the topology.
    """
    parts, pairs = lookup_topology(topology)
    P = len(parts)
    L = len(pairs)
    if net is None:
        net = PoseNet(num_parts=P, num_limbs=L)

    paf_scales, hm_scales = [], []
    for s in scales:
        h = int(net_hw[0] * s) // 8 * 8
        w = int(net_hw[1] * s) // 8 * 8
        img_s = jax.image.resize(image, (h, w, 3), method="bilinear")
        paf, hm = net.apply(params, img_s[None])
        paf_scales.append(jnp.transpose(paf[0], (2, 0, 1)))  # (2L, h/8, w/8)
        hm_scales.append(jnp.transpose(hm[0], (2, 0, 1)))    # (P+1, h/8, w/8)

    out_hw = (net_hw[0] // 8 * 8, net_hw[1] // 8 * 8)
    # Heatmaps merge at net resolution (NMS wants fine peaks + subpixel
    # refine, poseExtractorCaffe.cpp:294); PAFs merge at the common
    # stride-8 grid and are sampled there — the bilinear upsample adds
    # no information to a line integral that itself interpolates, and
    # skipping it cuts the matmul sampler's contraction 64x (see
    # decode_people.paf_stride).
    s8_hw = (out_hw[0] // 8, out_hw[1] // 8)
    pafs = _merge(paf_scales, s8_hw)
    hms = _merge(hm_scales, out_hw)[:P]  # drop background

    return decode_people(
        pafs, hms, jnp.asarray(pairs), num_parts=P, paf_stride=8.0,
        **decode_kwargs
    )


def _merge(channel_first_maps, out_hw):
    stacked = jnp.stack(
        [jax.image.resize(m, (m.shape[0],) + tuple(out_hw), "bilinear") for m in channel_first_maps]
    )
    return jnp.mean(stacked, axis=0)


def init_posenet(key, topology: str = "BODY_25", net_hw=(368, 368)):
    parts, pairs = lookup_topology(topology)
    net = PoseNet(num_parts=len(parts), num_limbs=len(pairs))
    dummy = jnp.zeros((1, net_hw[0], net_hw[1], 3))
    return net.init(key, dummy)
