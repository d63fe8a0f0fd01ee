"""Gemma-2 2B [arXiv:2408.00118]: 26L d=2304, 8H (GQA kv=4, head_dim 256),
GeGLU d_ff=9216, vocab 256000, alternating local (sliding window 4096) and
global attention, attention soft-cap 50 and final soft-cap 30, tied
embeddings scaled by sqrt(d_model), pre and post RMSNorm with
zero-centered scales."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "gemma2-2b"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv=4, head_dim=256,
        d_ff=9216, vocab=256000,
        pattern=(BlockSpec(kind="attn", attn_type="local", mlp="geglu"),
                 BlockSpec(kind="attn", attn_type="global", mlp="geglu")),
        window=4096, attn_softcap=50.0, final_softcap=30.0,
        gemma_norms=True, tie_embeddings=True, embed_scale=True,
        rope_theta=10000.0, quant=quant,
        long_context_ok=True,   # local layers bounded; global layers B=1 full KV
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="attn", attn_type="local", mlp="geglu"),
                 BlockSpec(kind="attn", attn_type="global", mlp="geglu")),
        window=8, attn_softcap=50.0, final_softcap=30.0,
        gemma_norms=True, tie_embeddings=True, embed_scale=True,
        rope_theta=10000.0, quant=quant, remat="none",
        long_context_ok=True,
    )
