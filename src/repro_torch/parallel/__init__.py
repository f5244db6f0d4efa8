from repro_torch.parallel.sharding import (  # noqa: F401
    LOGICAL_RULES,
    active_mesh,
    logical_to_spec,
    shard,
    use_mesh_rules,
)
