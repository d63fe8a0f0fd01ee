"""Phi-3-medium 14B [arXiv:2404.14219]: 40L d=5120, 40H (GQA kv=10,
head_dim 128), SwiGLU d_ff=17920, RoPE, vocab 100352."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "phi3-medium-14b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv=10, head_dim=128,
        d_ff=17920, vocab=100352,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant, remat="none",
    )
