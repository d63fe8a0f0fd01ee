"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: 24L d=2048, attention-free,
data-dependent decay, channel-mix d_ff=7168, vocab 65536."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "rwkv6-1.6b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
        d_ff=7168, vocab=65536,
        pattern=(BlockSpec(kind="rwkv6", mlp="rwkv_cm"),),
        rwkv_heads=32, rope_mode="none", norm="layernorm",
        tie_embeddings=False, quant=quant,
        long_context_ok=True,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="rwkv6", mlp="rwkv_cm"),),
        rwkv_heads=4, rope_mode="none", norm="layernorm",
        tie_embeddings=False, quant=quant, remat="none",
        long_context_ok=True,
    )
