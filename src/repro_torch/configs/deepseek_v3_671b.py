"""DeepSeek-V3-671B [arXiv:2412.19437]: 61L d_model=7168 128H, MLA,
1 shared + 256 routed experts top-8 (d_expert=2048), MTP, vocab=129280.
First 3 layers dense (d_ff=18432).  bf16 params + bf16 Adam moments
(the DeepSeek-V3 recipe) + FSDP(embed/q_lora/kv_lora over data) x
TP/EP(heads/experts over model) to fit 16 GB/chip."""
from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.layers import LMConfig, MoEConfig

ARCH = ArchSpec(
    id="deepseek-v3-671b",
    family="lm",
    model_cfg=LMConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_head=192, d_ff=2048, vocab=129280, attn="mla",
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, tie_embeddings=False,
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      router="sigmoid_ds3", routed_scale=2.5),
        n_dense_layers=3, dense_d_ff=18432, mtp=True),
    smoke_cfg=LMConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=24, d_ff=48, vocab=256, attn="mla",
        q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, tie_embeddings=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=1,
                      router="sigmoid_ds3"),
        n_dense_layers=1, dense_d_ff=96, mtp=True),
    shapes=dict(LM_SHAPES),
    # MLA latent KV (576 B/token/layer) => 512K-token cache fits: run it
    skip_shapes={},
    param_rules={"embed": "data", "heads": "model", "kv_heads": "model",
                 "head_dim": None, "ffn": None, "vocab": "model",
                 "experts": "model", "q_lora": "data", "kv_lora": "data",
                 "layers": None},
    moment_dtype="bfloat16",
    param_dtype="bfloat16",
    accum_steps=16,  # 4096 tokens/device/micro: dispatch buffers ~0.6 GB
    notes="FSDP x TP/EP; bf16 moments per DeepSeek-V3 paper",
)
