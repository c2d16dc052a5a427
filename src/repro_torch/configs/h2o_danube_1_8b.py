"""h2o-danube-1.8b [arXiv:2401.16818]: 24L d_model=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000, llama+mistral mix with sliding-window attention."""
from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.layers import LMConfig

ARCH = ArchSpec(
    id="h2o-danube-1.8b",
    family="lm",
    model_cfg=LMConfig(
        name="h2o-danube-1.8b", n_layers=24, d_model=2560, n_heads=32,
        n_kv_heads=8, d_head=80, d_ff=6912, vocab=32000, window=4096,
        local_global=(1, 0), tie_embeddings=False),
    smoke_cfg=LMConfig(
        name="danube-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=256, window=16, local_global=(1, 0)),
    shapes=dict(LM_SHAPES),
    # SWA bounds every layer's KV to the window -> long_500k runs
    skip_shapes={},
    param_rules={"embed": None, "heads": "model", "kv_heads": "model",
                 "head_dim": None, "ffn": "model", "vocab": "model",
                 "layers": None},
)
