"""Qwen2-7B [arXiv:2407.10671]: 28L d=3584, 28H (GQA kv=4, head_dim 128),
SwiGLU d_ff=18944, QKV bias, vocab 152064, rope theta 1e6."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "qwen2-7b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
        d_ff=18944, vocab=152064, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=1_000_000.0, quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=1_000_000.0, quant=quant, remat="none",
    )
