"""Sharded embedding tables (counterpart of ``mxnet_tpu/embedding``):
``ShardedEmbedding`` row-shards one logical table over parameter
servers, pulls only a step's rows and pushes row-sparse gradients
(optionally 2-bit compressed) through the kvstore's wire, with
checkpoints portable across shard counts; ``EmbeddingLookupCache`` is
the serving side's LRU in front of it."""
from .sharded import ShardedEmbedding, num_shards_env
from .cache import EmbeddingLookupCache

__all__ = ["ShardedEmbedding", "EmbeddingLookupCache", "num_shards_env"]
