"""BitNet-b1.58 3B [arXiv:2402.17764]: LLaMA-shaped ternary-weight LM, 26L
d=3200, 32H (MHA, head_dim 100), SwiGLU d_ff=8640, vocab 32000, rope theta
1e4, no QKV bias.  Weights are {-1, 0, +1} with per-channel mean-|w|
scales, activations int8 per token: the ``ternary_a8_tmac`` serving mode
(two bitplanes through the T-MAC kernel at g = 1)."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "bitnet-3b"


def config(quant: str = "ternary_a8_tmac") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=26, d_model=3200, n_heads=32, n_kv=32, head_dim=100,
        d_ff=8640, vocab=32000,
        pattern=(BlockSpec(kind="attn", attn_type="global", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant,
    )


def smoke_config(quant: str = "ternary_a8_tmac") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="attn", attn_type="global", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant, remat="none",
    )
