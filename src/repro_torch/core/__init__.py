"""Paper core of the port: Lloyd, K-means++, Big-means, objective."""
from repro_torch.core.bigmeans import (
    BigMeansState, ChunkInfo, big_means, chunk_step, init_state, sample_chunk,
)
from repro_torch.core.kmeans import KMeansResult, lloyd
from repro_torch.core.kmeanspp import seed
from repro_torch.core.objective import (
    chunk_objective, full_assignment, full_objective,
)

__all__ = [
    "BigMeansState", "ChunkInfo", "KMeansResult", "big_means", "chunk_step",
    "chunk_objective", "full_assignment", "full_objective", "init_state",
    "lloyd", "sample_chunk", "seed",
]
