"""How the port splits its state across shards: the corpus row half of
the reference's ``sharding/policy`` (``ShardPlan``, ``plan_shards``,
``shard_route``)."""
