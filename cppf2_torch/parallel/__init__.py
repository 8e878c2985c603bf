from cppf2_torch.parallel.mesh import (
    ImageVotes,
    image_sharded_tuple_vote,
    make_mesh,
    make_slice_mesh,
    rank_device,
    replicate,
    shard_batch,
    tuple_sharded_sphere_vote,
)

__all__ = [
    "ImageVotes",
    "image_sharded_tuple_vote",
    "make_mesh",
    "make_slice_mesh",
    "rank_device",
    "replicate",
    "shard_batch",
    "tuple_sharded_sphere_vote",
]
