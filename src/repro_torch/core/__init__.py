"""Paper core of the port: Lloyd, K-means++, Big-means, objective."""
from repro_torch.core.bigmeans import (
    BigMeansState, ChunkInfo, big_means, big_means_batched, big_means_sharded,
    broadcast_state, chunk_step, chunk_step_batched, init_state, reduce_state,
    sample_chunk,
)
from repro_torch.core.kmeans import KMeansResult, lloyd, lloyd_batched
from repro_torch.core.kmeanspp import seed, seed_batched
from repro_torch.core.objective import (
    chunk_objective, full_assignment, full_objective,
)

__all__ = [
    "BigMeansState", "ChunkInfo", "KMeansResult", "big_means",
    "big_means_batched", "big_means_sharded", "broadcast_state", "chunk_step",
    "chunk_step_batched", "chunk_objective", "full_assignment",
    "full_objective", "init_state", "lloyd", "lloyd_batched",
    "reduce_state", "sample_chunk", "seed", "seed_batched",
]
