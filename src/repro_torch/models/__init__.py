"""The port's models, of ``repro/models``: the transformer LM (GQA or
MLA, dense or MoE FFNs, the MTP head), the GNNs (GIN and EGNN in
``gnn``, ``nequip``, ``dimenet``) and the FM recommender (``fm``)."""
from repro_torch.models import dimenet, fm, gnn, nequip, transformer
from repro_torch.models.dimenet import DimeNetConfig
from repro_torch.models.fm import FMConfig
from repro_torch.models.gnn import EGNNConfig, GNNConfig
from repro_torch.models.layers import LMConfig, MoEConfig
from repro_torch.models.nequip import NequIPConfig

__all__ = ["DimeNetConfig", "EGNNConfig", "FMConfig", "GNNConfig",
           "LMConfig", "MoEConfig", "NequIPConfig", "dimenet", "fm", "gnn",
           "nequip", "transformer"]
