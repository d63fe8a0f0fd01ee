"""Zamba2 2.7B [arXiv:2411.15242]: 54 Mamba2 blocks d=2560 (state 64) with a
shared attention(+MLP d_ff=10240) block applied every 6 blocks, 32H kv=32,
vocab 32000."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "zamba2-2.7b"


def config(quant: str = "none") -> ModelConfig:
    mamba = BlockSpec(kind="mamba2", mlp="none")
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv=32, head_dim=80,
        d_ff=10240, vocab=32000,
        pattern=(BlockSpec(kind="mamba2", mlp="none", shared_attn=True),
                 mamba, mamba, mamba, mamba, mamba),
        d_inner=5120, d_state=64, ssm_heads=80,
        rope_theta=10000.0, quant=quant,
        long_context_ok=True,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    mamba = BlockSpec(kind="mamba2", mlp="none")
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="mamba2", mlp="none", shared_attn=True),
                 mamba),
        d_inner=128, d_state=16, ssm_heads=4,
        rope_theta=10000.0, quant=quant, remat="none",
        long_context_ok=True,
    )
