"""The LM tier's models, the port of ``repro/models`` (the transformer
with GQA or MLA, dense or MoE FFNs and the MTP head; the GNN and recsys
models are ROADMAP.md queue 1 item 13d)."""
from repro_torch.models import transformer
from repro_torch.models.layers import LMConfig, MoEConfig

__all__ = ["LMConfig", "MoEConfig", "transformer"]
