"""OLMoE-1B-7B [arXiv:2409.02060]: 16L d_model=2048 16H (GQA kv=16)
d_ff(expert)=1024, vocab=50304, MoE 64 experts top-8, qk-norm."""
from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.layers import LMConfig, MoEConfig

ARCH = ArchSpec(
    id="olmoe-1b-7b",
    family="lm",
    model_cfg=LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=1024, vocab=50304, qk_norm=True,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024)),
    smoke_cfg=LMConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=32, vocab=256, qk_norm=True, tie_embeddings=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32)),
    shapes=dict(LM_SHAPES),
    skip_shapes={"long_500k": "pure full-attention GQA (no sub-quadratic "
                              "mechanism); skipped per assignment"},
    param_rules={"embed": None, "heads": "model", "kv_heads": "model",
                 "head_dim": None, "ffn": None, "vocab": "model",
                 "experts": "model", "layers": None},
    accum_steps=4,   # bounds MoE dispatch buffers (~0.7 GB/device)
    param_dtype="bfloat16",    # + bf16 Adam moments: fits 16 GB/chip
    moment_dtype="bfloat16",
)
