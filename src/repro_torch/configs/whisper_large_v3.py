"""Whisper large-v3 [arXiv:2212.04356]: enc-dec, 32+32L d=1280, 20H
(head_dim 64), GELU d_ff=5120, vocab 51866, LayerNorm, sinusoidal positions.
The conv/mel frontend is a stub: the caller gives precomputed frame
embeddings [B, 1500, 1280] (``models.encdec``)."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "whisper-large-v3"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv=20, head_dim=64,
        d_ff=5120, vocab=51866,
        pattern=(BlockSpec(kind="attn", mlp="gelu"),),
        norm="layernorm", rope_mode="none", qkv_bias=True,
        enc_dec=True, n_enc_layers=32, enc_seq=1500, frontend="audio",
        tie_embeddings=True, quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(BlockSpec(kind="attn", mlp="gelu"),),
        norm="layernorm", rope_mode="none", qkv_bias=True,
        enc_dec=True, n_enc_layers=2, enc_seq=32, frontend="audio",
        tie_embeddings=True, quant=quant, remat="none",
    )
