"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family]: 28L d_model=1024 16H (GQA kv=8)
head_dim=128, d_ff=3072, vocab=151936, qk-norm, tied embeddings."""
from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.layers import LMConfig

ARCH = ArchSpec(
    id="qwen3-0.6b",
    family="lm",
    model_cfg=LMConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=3072, vocab=151936, qk_norm=True,
        rope_theta=1_000_000.0, tie_embeddings=True),
    smoke_cfg=LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=256, qk_norm=True),
    shapes=dict(LM_SHAPES),
    skip_shapes={"long_500k": "pure full-attention GQA (no sub-quadratic "
                              "mechanism); skipped per assignment"},
    param_rules={"embed": None, "heads": "model", "kv_heads": "model",
                 "head_dim": None, "ffn": "model", "vocab": "model",
                 "layers": None},
)
