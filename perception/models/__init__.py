"""Pipelines and networks built from ``perception.ops``.

Submodules are imported on demand: the geometric pipelines (``cuboid``,
``objects``, ``object_tracking``, ``slam``) need only jax, numpy and
scipy, while the CNN stack (``pose``, ``face``, ``hand``, ``train``,
``viz``) also needs flax, optax, orbax or cv2.
"""
