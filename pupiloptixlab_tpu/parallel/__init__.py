from pupiloptixlab_tpu.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_frame_sharded,
    shard_scene,
)
