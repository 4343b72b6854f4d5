from perception.geometry import se3, camera  # noqa: F401
