from perception.models.slam import odometry, backend, system  # noqa: F401
