"""Matrix products in full f32 for the geometric paths.

An f32 dot at default precision may run in TF32 on the GPU, which keeps
about three decimal digits: at room-scale coordinates (1-5 m) that is
millimetres of error in a transformed point and more than the map-mode
correspondence radius in a ``|q|^2 - 2 q.r + |r|^2`` distance. Point,
pose and normal-equation code calls these helpers instead of ``@``,
``jnp.dot`` and ``jnp.einsum``. The pose, face and hand CNNs keep the
default precision: their convolutions tolerate TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def dot(a, b):
    return jnp.dot(a, b, precision=HIGHEST)


def einsum(spec: str, *operands):
    return jnp.einsum(spec, *operands, precision=HIGHEST)
