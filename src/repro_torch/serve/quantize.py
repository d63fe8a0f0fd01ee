"""Offline weight quantization for serving (port of ``repro.serve.quantize``):
projection weights become integer codes + per-channel scales, exactly what
the kernels consume::

    {"w_q": uint8 [K//2, N] (packed int4)  or  int8 [K, N],
     "w_scale": float32 [1, N]}

or, for the T-MAC bitplane family (w1/w2/w3/w4/ternary weights)::

    {"w_q": uint8 [P, K//8, N] (packed bitplanes, P = plane count),
     "w_scale": float32 [1, N],
     "w_tmac": uint8 [0],          # zero-size formulation marker
     "w_tern": uint8 [0]}          # present iff ternary (P = 2 is ambiguous)

Inner projections take the mode's codes; the untied lm_head is always w8a8
(the paper's first/last-layer rule).  MoE expert banks (``['moe']['wi' |
'wg' | 'wo']``, [E, K, N]) become stacks of the legacy format, ``w_q``
[E, K//2, N] nibbles (or [E, K, N] int8) and ``w_scale`` [E, 1, N]: a tmac
mode is coerced to ``w4a4_mxu`` (``w8a8`` at a8), since
``models.moe.expert_matmul`` consumes nibble or int8 stacks; the router and
the shared expert's gate stay float.  An encoder-decoder tree (whisper)
walks the same way: every ``wq``/``wk``/``wv``/``wo``/``wi`` of the
encoder, the decoder's self- and cross-attention and both MLPs takes the
mode's codes, and the tied embedding stays float (no head to quantize).
A ``bits_plan`` ({path: mode}, ``roofline.analysis.plan_mixed_bits``)
gives single leaves widths of their own.  ``draft_params_view`` is the
self-speculative drafter: the top planes of every draftable bitplane
leaf.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from repro_torch.core.lut import (decode_planes, pack_int4, unpack_bitplanes,
                                  unpack_int4, weight_bits)
from repro_torch.kernels.lutmul import ops as lut_ops

# projection leaves eligible for low-bit quantization (trailing ['w'])
_INNER_W = re.compile(
    r"\['(wq|wk|wv|wo|wi|wg|wr|in_proj|out_proj)'\]\['w'\]$")
_MOE_W = re.compile(r"\['moe'\]\['w[igo]'\]$")
_HEAD_W = re.compile(r"\['lm_head'\]\['w'\]$")


def quantize_leaf(w: torch.Tensor, bits: int) -> dict:
    """Float weight [..., K, N] -> {"w_q", "w_scale"} serving codes: the
    per-channel quantizer ``ops.quantize_weights``, nibble-packed at 4
    bits."""
    w_q, w_scale = lut_ops.quantize_weights(w.to(torch.float32), bits,
                                            pack=bits == 4)
    return {"w_q": w_q.contiguous(), "w_scale": w_scale}


def quantize_leaf_mode(w: torch.Tensor, mode: str) -> dict:
    """Mode-aware leaf quantizer: the nibble/int8 leaf for the legacy modes,
    the bitplane leaf with its markers for the tmac family.  A suffix-free
    mode ("w2a4") takes ``ops.pick_formulation``'s choice for the leaf's
    shape and stores that formulation's format: the stored leaf is the
    choice.  A sub-4-bit width stored for one-hot is quantized at its own
    width and its codes (valid 4-bit codes) nibble-packed."""
    form, wspec, abits = lut_ops.parse_mode(mode)
    if form == "int":
        return quantize_leaf(w, 8 if abits >= 8 else 4)
    if form == "auto":
        form = lut_ops.pick_formulation(wspec, abits, w.shape[-2],
                                        w.shape[-1])
    if form == "onehot":
        if weight_bits(wspec) < 4:
            planes, scale = lut_ops.quantize_weights_planes(w, wspec)
            q = decode_planes(unpack_bitplanes(planes), wspec) \
                .to(torch.int8)
            q = pack_int4(q.transpose(-1, -2)).transpose(-1, -2)
            return {"w_q": q.contiguous(), "w_scale": scale.to(torch.float32)}
        return quantize_leaf(w, 4)
    planes, scale = lut_ops.quantize_weights_planes(w, wspec)
    marker = torch.zeros(planes.shape[:-3] + (0,), dtype=torch.uint8,
                         device=planes.device)
    leaf = {"w_q": planes.contiguous(), "w_scale": scale.to(torch.float32),
            "w_tmac": marker}
    if wspec == "ternary":
        leaf["w_tern"] = marker
    return leaf


def legacy_mode(mode: str) -> str:
    """The mode of a MoE expert bank: ``mode`` itself where it stores
    nibbles or int8, else (tmac family) ``w4a4_mxu``, or ``w8a8`` at a8."""
    form, _, abits = lut_ops.parse_mode(mode)
    if form in ("int", "onehot"):
        return mode
    return "w8a8" if abits >= 8 else "w4a4_mxu"


def quantize_params_for_serving(params, mode: str = "w4a4_mxu",
                                bits_plan: Optional[dict] = None,
                                path: str = ""):
    """Replace eligible projection weights with integer codes + scales
    (through ``models.layers.QuantizedLinear``: quantize + pack once).

    mode: w4a4_lut | w4a4_mxu -> int4 inner, int8 head; w8a8 -> int8 all;
    tmac family (``w{1,2,3,4}a{4,8}[_tmac]``, ``ternary_a{4,8}[_tmac]``) ->
    bitplane leaves, int8 head; MoE expert banks in :func:`legacy_mode`.
    Walk paths are the reference's strings with one index a layer
    (``"['blocks'][i]['attn']['wq']['w']"``); ``path`` is the subtree's own
    (``"['blocks'][3]"`` for one layer's parameters).  ``bits_plan``
    ({path: mode}, ``roofline.analysis.plan_mixed_bits``) gives a leaf at
    one of its paths its own mode, an expert bank ``legacy_mode`` of its
    own; every other leaf follows ``mode``, and the head stays w8a8.
    Leaves that are codes already stay as they are.
    """
    from repro_torch.models.layers import QuantizedLinear

    plan = bits_plan or {}

    def codes(leaf: dict, leaf_mode: str) -> dict:
        return QuantizedLinear(leaf, mode=leaf_mode).params

    def walk(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                sub = f"{path}['{k}']"
                if isinstance(v, dict) and "w" in v and _INNER_W.search(
                        sub + "['w']") and v["w"].dim() >= 2:
                    out[k] = codes(v, plan.get(sub + "['w']", mode))
                elif _MOE_W.search(sub) and not isinstance(v, dict):
                    out[k] = codes({"w": v}, legacy_mode(plan.get(sub, mode)))
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

    return walk(params, path)


def init_served_params(cfg, mode: str, seed: int = 0, device=None,
                       bits_plan: Optional[dict] = None) -> dict:
    """``quantize_params_for_serving(transformer.init_params(cfg, seed,
    device), mode, bits_plan)`` (``encdec.init_params`` for an enc-dec
    config), bit for bit, with each layer quantized as soon as it is made:
    the device holds the served tree plus one float layer (and the float
    head until the end), never the whole float tree."""
    from repro_torch.models import encdec, transformer
    if cfg.enc_dec:
        params = encdec.init_params(
            cfg, seed, device, block_hook=lambda stack, i, bp:
            quantize_params_for_serving(bp, mode, bits_plan,
                                        path=f"['{stack}'][{i}]"))
        return quantize_params_for_serving(params, mode, bits_plan)
    params = transformer.init_params(
        cfg, seed, device, block_hook=lambda i, bp:
        quantize_params_for_serving(bp, mode, bits_plan,
                                    path=f"['blocks'][{i}]"))
    return quantize_params_for_serving(params, mode, bits_plan)


def _draftable(leaf, draft_planes: int) -> bool:
    """True for tmac leaves whose positional int planes truncate to
    ``draft_planes`` (not ternary or w1, not leaves at or below the draft
    width, not nibble/int8 leaves)."""
    return (isinstance(leaf, dict) and "w_tmac" in leaf
            and "w_tern" not in leaf and leaf["w_q"].dim() >= 3
            and leaf["w_q"].shape[-3] > draft_planes >= 2)


def draft_params_view(params, draft_planes: int):
    """Truncated-plane drafter view of quantized serving params: every
    draftable leaf keeps its top ``draft_planes`` planes (a view of the
    target's bytes) with ``2^(B - draft_planes)`` folded into ``w_scale``
    (exact: a power of two); every other leaf is the target's own object."""
    def walk(tree):
        if isinstance(tree, dict):
            if _draftable(tree, draft_planes):
                wbits = int(tree["w_q"].shape[-3])
                sliced, _, mult = lut_ops.truncate_planes(
                    tree["w_q"], wbits, draft_planes)
                out = dict(tree)
                out["w_q"] = sliced
                out["w_scale"] = tree["w_scale"] * float(mult)
                return out
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(params)


def count_draftable_leaves(params, draft_planes: int) -> int:
    """How many leaves :func:`draft_params_view` would truncate."""
    if isinstance(params, dict):
        if _draftable(params, draft_planes):
            return 1
        return sum(count_draftable_leaves(v, draft_planes)
                   for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_draftable_leaves(v, draft_planes) for v in params)
    return 0


def dequantize_weight(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Reassemble a float weight from codes (tests)."""
    q = p["w_q"]
    if "w_tmac" in p:                              # packed bitplanes
        spec = "ternary" if "w_tern" in p else int(q.shape[-3])
        q = decode_planes(unpack_bitplanes(q), spec)
    elif q.dtype == torch.uint8:                   # packed int4
        q = unpack_int4(q.transpose(-1, -2), signed=True).transpose(-1, -2)
    return (q.to(torch.float32) * p["w_scale"]).to(dtype)
