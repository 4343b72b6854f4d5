"""Part-affinity-field scoring and people assembly.

Rebuild of OpenPose's body-part connector (SURVEY.md §2.5):

  * pair scoring — the line integral of the PAF along each candidate
    limb (``pafScoreKernel``, ``bodyPartConnectorBase.cu:107``):
    sample the 2-channel field at T points on the A->B segment,
    dot with the unit direction, demand a success ratio of samples
    above threshold. Here all (peak_a, peak_b) pairs of all limbs are
    scored in one batched bilinear gather;
  * greedy matching — the reference sorts pairs by score and accepts
    greedily (``pafPtrIntoVector``/``pafVectorIntoPeopleVector``,
    ``bodyPartConnectorBase.cpp:379-449+``): a sequential CPU loop.
    Reformulated as a fixed-trip masked argmax loop per limb (accept
    global best, kill its row/col) — identical result for the
    one-to-one assignment, fully on the device;
  * people grouping — limbs sharing a peak merge into skeletons:
    min-label propagation over the accepted-limb edge list (the same
    connected-components machinery as Euclidean clustering).

Everything is fixed-capacity: P parts x K peaks per part, E_l accepted
connections per limb, ``max_people`` output rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def _bilinear(field: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sample (H, W) field at float coords; clamped borders."""
    H, W = field.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = field[y0, x0]
    v01 = field[y0, x0 + 1]
    v10 = field[y0 + 1, x0]
    v11 = field[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _bilinear_matmul(fields: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sample C fields (C, H, W) at S float coords -> (C, S).

    Bilinear interpolation expressed as two weighted one-hot
    contractions instead of per-point gathers: the row matrix carries
    (1-fy, fy) at (y0, y0+1) and contracts over H as a matmul; the
    column weights then reduce over W. The matmul form streams the
    fields once instead of gathering per point. HIGHEST precision
    keeps the 4-term interpolation at f32 accuracy.
    """
    C, H, W = fields.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0).astype(fields.dtype)
    fy = (y - y0).astype(fields.dtype)
    hh = jnp.arange(H, dtype=jnp.int32)[None, :]
    ww = jnp.arange(W, dtype=jnp.int32)[None, :]
    rowm = (
        (hh == y0[:, None]).astype(fields.dtype) * (1 - fy)[:, None]
        + (hh == (y0 + 1)[:, None]).astype(fields.dtype) * fy[:, None]
    )  # (S, H)
    colm = (
        (ww == x0[:, None]).astype(fields.dtype) * (1 - fx)[:, None]
        + (ww == (x0 + 1)[:, None]).astype(fields.dtype) * fx[:, None]
    )  # (S, W)
    rows = jnp.einsum(
        "sh,chw->csw", rowm, fields, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "csw,sw->cs", rows, colm, precision=jax.lax.Precision.HIGHEST
    )


def paf_pair_scores(
    paf_x: jax.Array,
    paf_y: jax.Array,
    a_xy: jax.Array,
    a_mask: jax.Array,
    b_xy: jax.Array,
    b_mask: jax.Array,
    num_samples: int = 10,
    sample_threshold: float = 0.05,
    min_success_ratio: float = 0.8,
) -> jax.Array:
    """Score all (Ka, Kb) candidate limbs of one limb type.

    paf_x/paf_y: (H, W) affinity field; a_xy (Ka, 2), b_xy (Kb, 2).
    Returns (Ka, Kb) scores; invalid pairs get -1.
    """
    Ka, Kb = a_xy.shape[0], b_xy.shape[0]
    d = b_xy[None, :, :] - a_xy[:, None, :]  # (Ka, Kb, 2)
    norm = jnp.linalg.norm(d, axis=-1)
    u = d / jnp.maximum(norm[..., None], 1e-6)

    ts = jnp.linspace(0.0, 1.0, num_samples)
    # (Ka, Kb, T, 2) sample positions.
    pos = a_xy[:, None, None, :] + ts[None, None, :, None] * d[:, :, None, :]
    both = _bilinear_matmul(
        jnp.stack([paf_x, paf_y]),
        pos[..., 0].reshape(-1),
        pos[..., 1].reshape(-1),
    )
    sx = both[0].reshape(Ka, Kb, num_samples)
    sy = both[1].reshape(Ka, Kb, num_samples)
    dots = sx * u[..., 0:1] + sy * u[..., 1:2]  # (Ka, Kb, T)

    success = jnp.mean((dots > sample_threshold).astype(jnp.float32), axis=-1)
    score = jnp.mean(dots, axis=-1)
    ok = (
        (success >= min_success_ratio)
        & (norm > 1e-3)
        & a_mask[:, None]
        & b_mask[None, :]
    )
    return jnp.where(ok, score, -1.0)


class LimbMatches(NamedTuple):
    a_idx: jax.Array  # (E,) peak index at part A
    b_idx: jax.Array  # (E,) peak index at part B
    score: jax.Array  # (E,)
    mask: jax.Array   # (E,)


@functools.partial(jax.jit, static_argnames=("max_connections",))
def greedy_match(scores: jax.Array, max_connections: int = 16) -> LimbMatches:
    """One-to-one greedy assignment on a (Ka, Kb) score matrix —
    equivalent to sort-by-score-and-accept (the reference's greedy)."""
    Ka, Kb = scores.shape
    E = min(max_connections, min(Ka, Kb))

    def body(carry, _):
        s = carry
        flat = s.reshape(-1)
        best = jnp.argmax(flat)
        val = flat[best]
        ai = best // Kb
        bi = best % Kb
        ok = val > 0
        # Kill row + col.
        s = jnp.where(
            (jnp.arange(Ka)[:, None] == ai) | (jnp.arange(Kb)[None, :] == bi),
            -1.0,
            s,
        )
        return s, (ai.astype(jnp.int32), bi.astype(jnp.int32), val, ok)

    _, (ais, bis, vals, oks) = jax.lax.scan(body, scores, None, length=E)
    pad = max_connections - E
    return LimbMatches(
        a_idx=jnp.pad(ais, (0, pad)),
        b_idx=jnp.pad(bis, (0, pad)),
        score=jnp.pad(vals, (0, pad)),
        mask=jnp.pad(oks, (0, pad)),
    )


class People(NamedTuple):
    keypoints: jax.Array  # (Pmax, P, 3) (x, y, score); 0 where absent
    num_parts: jax.Array  # (Pmax,) parts found per person
    score: jax.Array      # (Pmax,) mean limb score
    mask: jax.Array       # (Pmax,) person valid


@functools.partial(jax.jit, static_argnames=("num_parts", "max_peaks", "max_people", "min_person_parts"))
def assemble_people(
    limb_pairs: jax.Array,       # (Lb, 2) int32 part indices per limb type
    matches_a: jax.Array,        # (Lb, E) peak idx at part pair[0]
    matches_b: jax.Array,        # (Lb, E)
    matches_score: jax.Array,    # (Lb, E)
    matches_mask: jax.Array,     # (Lb, E)
    peaks_xy: jax.Array,         # (P, K, 2)
    peaks_score: jax.Array,      # (P, K)
    peaks_mask: jax.Array,       # (P, K)
    num_parts: int,
    max_peaks: int,
    max_people: int = 16,
    min_person_parts: int = 3,
) -> People:
    """Union accepted limbs into skeletons via min-label propagation."""
    P, K = num_parts, max_peaks
    N = P * K
    node_ids = jnp.where(peaks_mask.reshape(-1), jnp.arange(N, dtype=jnp.int32), N)

    # Edge endpoints as node indices.
    na = (limb_pairs[:, 0:1] * K + matches_a).reshape(-1)  # (Lb*E,)
    nb = (limb_pairs[:, 1:2] * K + matches_b).reshape(-1)
    em = matches_mask.reshape(-1)
    na = jnp.where(em, na, N)
    nb = jnp.where(em, nb, N)

    def prop(ids, _):
        ia = ids[jnp.clip(na, 0, N - 1)]
        ib = ids[jnp.clip(nb, 0, N - 1)]
        m = jnp.minimum(ia, ib)
        ids = ids.at[jnp.clip(na, 0, N - 1)].min(jnp.where(em, m, N))
        ids = ids.at[jnp.clip(nb, 0, N - 1)].min(jnp.where(em, m, N))
        # Pointer jumping.
        ids = jnp.minimum(ids, ids[jnp.clip(ids, 0, N - 1)])
        return ids, None

    node_ids, _ = jax.lax.scan(prop, node_ids, None, length=16)

    # Person roots ranked by part count.
    counts = jax.ops.segment_sum(
        (node_ids < N).astype(jnp.int32), jnp.clip(node_ids, 0, N), num_segments=N + 1
    )[:N]
    # Sum of limb scores per root (score attributed to node A's root).
    root_of_a = node_ids[jnp.clip(na, 0, N - 1)]
    limb_scores = jax.ops.segment_sum(
        jnp.where(em, matches_score.reshape(-1), 0.0),
        jnp.clip(jnp.where(em, root_of_a, N), 0, N),
        num_segments=N + 1,
    )[:N]
    limb_counts = jax.ops.segment_sum(
        em.astype(jnp.float32), jnp.clip(jnp.where(em, root_of_a, N), 0, N), num_segments=N + 1
    )[:N]

    ok_root = counts >= min_person_parts
    rank_score = jnp.where(ok_root, counts, -1)
    top_counts, roots = jax.lax.top_k(rank_score, max_people)
    person_valid = top_counts >= min_person_parts

    # person_of_root lookup.
    person_of_root = jnp.full((N + 1,), -1, jnp.int32)
    person_of_root = person_of_root.at[jnp.where(person_valid, roots, N)].set(
        jnp.where(person_valid, jnp.arange(max_people, dtype=jnp.int32), -1)
    )
    node_person = person_of_root[jnp.clip(node_ids, 0, N)]  # (N,)

    # Scatter keypoints into (max_people, P, 3).
    part_of_node = jnp.arange(N, dtype=jnp.int32) // K
    xy_flat = peaks_xy.reshape(N, 2)
    sc_flat = peaks_score.reshape(N)
    write = (node_person >= 0) & peaks_mask.reshape(-1)
    tgt = jnp.where(write, node_person * P + part_of_node, max_people * P)
    kp = jnp.zeros((max_people * P + 1, 3))
    vals = jnp.concatenate([xy_flat, sc_flat[:, None]], axis=1)
    # max-combine so the strongest peak wins a duplicated (person, part).
    kp = kp.at[tgt].max(jnp.where(write[:, None], vals, -jnp.inf))
    kp = jnp.where(jnp.isfinite(kp), kp, 0.0)[: max_people * P].reshape(max_people, P, 3)

    mean_scores = limb_scores[roots] / jnp.maximum(limb_counts[roots], 1.0)
    return People(
        keypoints=kp,
        num_parts=jnp.where(person_valid, top_counts, 0),
        score=jnp.where(person_valid, mean_scores, 0.0),
        mask=person_valid,
    )
