"""The port's data pipelines: the LM token pipeline (the graph and
recsys batches and the neighbour sampler are ROADMAP.md queue 1 item
13d)."""
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

__all__ = ["TokenPipeline", "TokenPipelineConfig"]
