"""Offline weight quantization for serving (port of ``repro.serve.quantize``,
nibble/int8 part): projection weights become integer codes + per-channel
scales, exactly what the kernels consume::

    {"w_q": uint8 [K//2, N] (packed int4)  or  int8 [K, N],
     "w_scale": float32 [1, N]}

Inner projections take the mode's codes; the untied lm_head is always w8a8
(the paper's first/last-layer rule).
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.lut import unpack_int4
from repro_torch.kernels.lutmul import ops as lut_ops

# projection leaves eligible for low-bit quantization (trailing ['w'])
_INNER_W = re.compile(
    r"\['(wq|wk|wv|wo|wi|wg|wr|in_proj|out_proj)'\]\['w'\]$")
_HEAD_W = re.compile(r"\['lm_head'\]\['w'\]$")


def quantize_leaf(w: torch.Tensor, bits: int) -> dict:
    """Float weight [..., K, N] -> {"w_q", "w_scale"} serving codes: the
    per-channel quantizer ``ops.quantize_weights``, nibble-packed at 4
    bits."""
    w_q, w_scale = lut_ops.quantize_weights(w.to(torch.float32), bits,
                                            pack=bits == 4)
    return {"w_q": w_q.contiguous(), "w_scale": w_scale}


def quantize_leaf_mode(w: torch.Tensor, mode: str) -> dict:
    """Mode-aware leaf quantizer: the nibble leaf for w4a4 modes, the int8
    leaf for a8 modes (tmac bitplane leaves are not ported yet)."""
    form, wspec, abits = lut_ops.parse_mode(mode)
    if form == "int":
        return quantize_leaf(w, 8 if abits >= 8 else 4)
    if form == "onehot" and wspec == 4:
        return quantize_leaf(w, 4)
    raise NotImplementedError(
        f"quant mode {mode!r} needs the tmac bitplane format, which is not "
        "ported yet")


def quantize_params_for_serving(params, mode: str = "w4a4_mxu"):
    """Replace eligible projection weights with integer codes + scales
    (through ``models.layers.QuantizedLinear``: quantize + pack once).

    mode: w4a4_lut | w4a4_mxu -> int4 inner, int8 head; w8a8 -> int8 all.
    Walk paths are the reference's ``"['blocks'][i]['attn']['wq']['w']"``
    strings, so the same rules pick the same leaves.
    """
    from repro_torch.models.layers import QuantizedLinear

    def codes(leaf: dict, leaf_mode: str) -> dict:
        return QuantizedLinear(leaf, mode=leaf_mode).params

    def walk(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                sub = f"{path}['{k}']"
                if isinstance(v, dict) and "w" in v and _INNER_W.search(
                        sub + "['w']") and v["w"].dim() >= 2:
                    out[k] = codes(v, mode)
                elif isinstance(v, dict) and "w" in v and _HEAD_W.search(
                        sub + "['w']"):
                    out[k] = codes(v, "w8a8")     # paper: last layer 8-bit
                else:
                    out[k] = walk(v, sub)
            return out
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, f"{path}[{i}]")
                              for i, v in enumerate(tree))
        return tree

    return walk(params)


def dequantize_weight(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Reassemble a float weight from codes (tests)."""
    q = p["w_q"]
    if q.dtype == torch.uint8:                     # packed int4
        q = unpack_int4(q.transpose(-1, -2), signed=True).transpose(-1, -2)
    return (q.to(torch.float32) * p["w_scale"]).to(dtype)
