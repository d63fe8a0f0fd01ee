"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048, 16H (kv=16,
head_dim 128), MoE: 60 routed experts top-4 (expert d_ff=1408) + shared
expert (d_ff 5632, sigmoid gate), vocab 151936, QKV bias."""
from repro_torch.configs import BlockSpec, ModelConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "qwen2-moe-a2.7b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=151936, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="moe"),),
        moe=MoEConfig(n_experts=60, top_k=4, d_ff=1408, shared_ff=5632,
                      norm_topk=False, dispatch="global"),
        rope_theta=1_000_000.0, quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=32, vocab=512, qkv_bias=True,
        pattern=(BlockSpec(kind="attn", mlp="moe"),),
        # capacity 2.0 = E/top_k: drop-free; the full config keeps the
        # GShard 1.25, which drops
        moe=MoEConfig(n_experts=8, top_k=4, d_ff=32, shared_ff=64,
                      norm_topk=False, capacity_factor=2.0),
        rope_theta=1_000_000.0, quant=quant, remat="none",
    )
