"""fleet.meta_parallel: the model-parallel layers (``parallel_layers``) at
model-parallel degree 1."""
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              ParallelCrossEntropy, RowParallelLinear,
                              VocabParallelEmbedding)
