"""MiniCPM 2B [arXiv:2404.06395]: 40L d=2304, 36H (kv=36, head_dim 64),
SwiGLU d_ff=5760, vocab 122753, tied embeddings.  It is trained with the
warmup-stable-decay schedule (``TRAIN_SCHEDULE``), which
``train.step.TrainConfig(schedule="wsd")`` selects."""
from repro_torch.configs import BlockSpec, ModelConfig

ARCH_ID = "minicpm-2b"
TRAIN_SCHEDULE = "wsd"


def config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv=36, head_dim=64,
        d_ff=5760, vocab=122753, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant,
        long_context_ok=False,
    )


def smoke_config(quant: str = "none") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512, tie_embeddings=True,
        pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
        rope_theta=10000.0, quant=quant, remat="none",
    )
