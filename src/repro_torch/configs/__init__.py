"""Model configuration (port-side copy of ``repro.models.transformer``'s
``ModelConfig``/``BlockSpec``, field for field) and the architectures the
port runs so far (``mobilenetv2`` returns ``models.mobilenet``'s
``MobileNetConfig``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"              # attn | mamba2 | rwkv6
    attn_type: str = "global"       # global | local
    mlp: str = "swiglu"             # swiglu | geglu | gelu | moe | rwkv_cm | none
    shared_attn: bool = False       # prepend the shared attention block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rope_mode: str = "rope"         # rope | mrope | none
    mrope_sections: tuple[int, ...] = ()
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    gemma_norms: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    moe: Optional[object] = None   # models.moe.MoEConfig
    d_inner: int = 0
    d_state: int = 0
    ssm_heads: int = 0
    rwkv_heads: int = 0
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500
    frontend: str = "none"
    quant: str = "none"             # none | w4a4_lut | w4a4_mxu | w8a8 | tmac
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"
    kv_block: int = 1024
    split_head_params: bool = False
    rwkv_chunk: int = 32
    kv_quant: str = "none"
    unroll_groups: bool = False
    long_context_ok: bool = False

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0
        return self.n_layers // len(self.pattern)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


ALIASES = {"qwen2-7b": "qwen2_7b", "bitnet-3b": "bitnet_3b",
           "gemma2-2b": "gemma2_2b", "phi3-medium-14b": "phi3_medium_14b",
           "minicpm-2b": "minicpm_2b", "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
           "mixtral-8x22b": "mixtral_8x22b", "rwkv6-1.6b": "rwkv6_1p6b",
           "zamba2-2.7b": "zamba2_2p7b",
           "whisper-large-v3": "whisper_large_v3",
           "qwen2-vl-72b": "qwen2_vl_72b", "mobilenetv2": "mobilenetv2"}


def get_config(arch: str, smoke: bool = False, **kw):
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(arch, arch)}")
    return mod.smoke_config(**kw) if smoke else mod.config(**kw)
