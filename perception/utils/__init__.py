from perception.utils import checkpoint, metrics, profiler  # noqa: F401
