from perception.parallel import mesh, icp_dist  # noqa: F401
