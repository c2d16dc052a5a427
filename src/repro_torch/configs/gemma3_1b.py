"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 26L d_model=1152 4H (GQA kv=1)
head_dim=256, d_ff=6912, vocab=262144, 5 local (w=512) : 1 global."""
from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.layers import LMConfig

ARCH = ArchSpec(
    id="gemma3-1b",
    family="lm",
    model_cfg=LMConfig(
        name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_head=256, d_ff=6912, vocab=262144, window=512, local_global=(5, 1),
        rope_theta=1_000_000.0, tie_embeddings=True),
    smoke_cfg=LMConfig(
        name="gemma3-smoke", n_layers=3, d_model=64, n_heads=2, n_kv_heads=1,
        d_head=32, d_ff=128, vocab=256, window=8, local_global=(2, 1)),
    shapes=dict(LM_SHAPES),
    # 5:1 local:global bounds the local-layer KV -> long_500k runs
    skip_shapes={},
    param_rules={"embed": None, "heads": None, "kv_heads": None,
                 "head_dim": None, "ffn": "model", "vocab": "model",
                 "layers": None},
)
