"""The dry run's sharding: the name-based parameter, input and cache
rules (:mod:`.sharding`) and the activation constraints of a traced
step (:mod:`.act_shard`)."""
