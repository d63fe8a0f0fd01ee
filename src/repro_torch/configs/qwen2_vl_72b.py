"""Qwen2-VL 72B [arXiv:2409.12191]: 80L d=8192, 64H (GQA kv=8, head_dim 128),
SwiGLU d_ff=29568, vocab 152064, M-RoPE (sections t/h/w = 16/24/24 over
head_dim/2), QKV bias.  The vision patch frontend is a stub: the caller
gives precomputed patch/text embeddings [B, S, d] and 3-D M-RoPE position
ids (``transformer.forward(embeddings=, mrope_positions=)``)."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=29568, vocab=152064, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_mode="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0, frontend="vision", quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_mode="mrope", mrope_sections=(2, 3, 3),
        rope_theta=1_000_000.0, frontend="vision", quant=quant, remat="none",
    )
