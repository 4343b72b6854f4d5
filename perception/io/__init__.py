from perception.io import (  # noqa: F401
    bvh,
    camera_params,
    imgcodec,
    pcd,
    producers,
    savers,
    templates,
    tum,
)
