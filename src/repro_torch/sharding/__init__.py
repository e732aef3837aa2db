"""How the port splits its state across devices: the reference's
``sharding/policy`` (parameter specs and placements on a device mesh, and
the corpus row half: ``ShardPlan``, ``plan_shards``, ``shard_route``)."""
