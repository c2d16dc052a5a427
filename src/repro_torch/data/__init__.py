"""The port's data pipelines: the LM token pipeline, the GNN and recsys
batch builders and the neighbour sampler (numpy copies of the
reference's, equal bit for bit for the same seed)."""
from repro_torch.data.graphs import (FullGraphBatch, MoleculeBatch,
                                     full_graph_batch, molecule_batch,
                                     recsys_batch)
from repro_torch.data.sampler import NeighborSampler, SampledBatch
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

__all__ = ["FullGraphBatch", "MoleculeBatch", "NeighborSampler",
           "SampledBatch", "TokenPipeline", "TokenPipelineConfig",
           "full_graph_batch", "molecule_batch", "recsys_batch"]
