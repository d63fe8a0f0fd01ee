"""Mixtral 8x22B [arXiv:2401.04088]: 56L d=6144, 48H (GQA kv=8, head_dim
128), 8 experts top-2 (expert d_ff=16384), sliding-window attention (4096,
rolling cache), vocab 32768."""
from repro_torch.configs import BlockSpec, ModelConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "mixtral-8x22b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
        d_ff=16384, vocab=32768,
        pattern=(BlockSpec(kind="attn", attn_type="local", mlp="moe"),),
        window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, norm_topk=True),
        rope_theta=1_000_000.0, quant=quant,
        long_context_ok=True,    # SWA: the rolling 4096 cache bounds decode
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=64, vocab=512,
        pattern=(BlockSpec(kind="attn", attn_type="local", mlp="moe"),),
        window=8,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, norm_topk=True,
                      capacity_factor=2.0),
        rope_theta=1_000_000.0, quant=quant, remat="none",
        long_context_ok=True,
    )
