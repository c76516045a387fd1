"""Parallelism: logical-axis sharding over a ``DeviceMesh``, the
error-feedback int8 mean, GPipe over point-to-point sends — the
reference's ``repro.parallel``."""

from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    logical_sharding,
    shard_act,
    sharding_context,
    tree_shardings,
)
