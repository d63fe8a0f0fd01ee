"""Batched serving engine (port of ``repro.serve.engine``: dense KV, one
device, chunked prefill; no paging, speculation or fault injection).

``Engine.step`` is one unified serving round: a chunk lane of prompt-token
iterations (each a full-batch ``decode_step`` with the target slot's
(token, position) substituted in, sampling a request's first output token
when its last prompt token lands) followed by ``chunk`` decode iterations
over every slot.  The reference compiles both lanes into one ``lax.scan``
dispatch; here they are a Python loop over ``decode_step``, and the pad
entries of a short chunk lane — full-batch no-ops whose only effect is
rewriting every row's held KV with the same bits — are skipped.

``generate`` is the static-batch oracle: prefill, then a per-token loop.
Positions are per-sequence ``pos: [B]`` int32; a negative position is the
free-slot sentinel (every key of the row masked, writes inside its row).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    quant: Optional[str] = None   # convert weights to serving codes at load
    # prompt tokens processed per unified round (None = 8)
    prefill_chunk: Optional[int] = None

    def __post_init__(self):
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{self.prefill_chunk}")
            if self.prefill_chunk > self.max_len:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) cannot exceed "
                    f"max_len ({self.max_len}) — no prompt is longer")

    @property
    def chunk_tokens(self) -> int:
        return 8 if self.prefill_chunk is None else self.prefill_chunk


def sample_logits(logits: torch.Tensor,
                  temperature: float = 0.0) -> torch.Tensor:
    """Greedy decoding: the per-row argmax (first index on ties), as the
    reference's ``sample_logits`` at temperature <= 0.  Sampling at a
    positive temperature is not ported yet and raises."""
    if temperature > 0.0:
        raise NotImplementedError(
            f"temperature={temperature}: sampling is not ported yet")
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def _to_device(params, device):
    """Every tensor of a parameter tree on ``device``."""
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_to_device(v, device) for v in params)
    return params.to(device) if isinstance(params, torch.Tensor) else params


class Engine:
    def __init__(self, cfg, params, scfg: ServeConfig = ServeConfig(), *,
                 device=None):
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        params = _to_device(params, self.device)
        if scfg.quant:
            # quantize + pack weight codes ONCE at construction; every
            # decode step then reads integer codes
            from repro_torch.serve.quantize import quantize_params_for_serving
            params = quantize_params_for_serving(params, mode=scfg.quant)
        self.params = params
        self.scfg = scfg
        self.decode_steps = 0         # decode_step calls (both lanes)

    # -- scheduler-facing API ------------------------------------------------

    @property
    def prefill_chunk(self) -> int:
        """Prompt tokens carried by the chunk lane of one unified round."""
        return self.scfg.chunk_tokens

    def init_cache(self, batch: int) -> list:
        return transformer.init_cache(self.cfg, batch, self.scfg.max_len,
                                      self.device)

    def _decode(self, tok, cache, pos):
        self.decode_steps += 1
        return transformer.decode_step(self.params, self.cfg, tok, cache, pos)

    def step(self, cache, entries, tok, pos, done, eos, chunk: int):
        """ONE unified serving round: the chunk lane (when ``entries`` is
        not None) then ``chunk`` (>= 1) decode iterations over every slot.

        ``entries``: dict of [prefill_chunk] host lists — ``slot`` (target
        row, -1 = pad), ``tok``/``pos`` (prompt token and its position),
        ``first`` (the prompt's last token: sample the first output) and
        ``budget_one`` (with ``first``: that token is the whole budget).
        Non-target rows re-run their held (token, position); finished and
        free slots (done=True) hold token and position throughout.

        Returns (cache, tok, pos, done, tok0, done0, tokens [B, chunk],
        dones [B, chunk], ok [B]) — tok0/done0 are the first tokens and
        immediately-finished flags of rows whose ``first`` entry fired; ok
        is the per-slot finite-logits guard.
        """
        C = self.prefill_chunk if entries is not None else 0
        ok = torch.ones_like(done)
        tok0, done0 = tok, done
        if C:
            rows = torch.arange(tok.shape[0], dtype=torch.int32,
                                device=tok.device)
            for i in range(C):
                s = int(entries["slot"][i])
                if s < 0:
                    continue              # pad entry: a full-batch no-op
                t, p = int(entries["tok"][i]), int(entries["pos"][i])
                first = bool(entries["first"][i])
                b1 = bool(entries["budget_one"][i])
                target = rows == s
                tok_in = torch.where(target, t, tok)
                pos_in = torch.where(target, p, pos)
                logits, cache = self._decode(tok_in, cache, pos_in)
                if first:
                    fire = target
                    ok = ok & (torch.isfinite(logits).all(-1) | ~fire)
                    nxt = sample_logits(logits)
                    nd = ((nxt == eos) & (eos >= 0)) | b1
                    tok = torch.where(fire, nxt, tok_in)
                    pos = torch.where(fire, p + 1, pos_in)
                    done = torch.where(fire, nd, done)
                    tok0 = torch.where(fire, nxt, tok0)
                    done0 = torch.where(fire, nd, done0)
                else:                     # the target parks on (t, p)
                    tok, pos = tok_in, pos_in
        toks, dones = [], []
        for j in range(chunk):
            logits, cache = self._decode(tok, cache, pos)
            # rows done before this step never sample these logits
            ok = ok & (torch.isfinite(logits).all(-1) | done)
            nxt = sample_logits(logits)
            nxt = torch.where(done, tok, nxt)
            pos = torch.where(done, pos, pos + 1)
            done = done | ((nxt == eos) & (eos >= 0))
            tok = nxt
            toks.append(nxt)
            dones.append(done)
        return (cache, tok, pos, done, tok0, done0, torch.stack(toks, 1),
                torch.stack(dones, 1), ok)

    # -- static-batch oracle -------------------------------------------------

    def _grow_cache(self, cache: list) -> list:
        """Pad prefill caches (length S) into max_len buffers."""
        M = self.scfg.max_len
        out = []
        for c in cache:
            g = {}
            for key, t in c.items():
                buf = torch.zeros((t.shape[0], M) + tuple(t.shape[2:]),
                                  dtype=t.dtype, device=t.device)
                buf[:, :t.shape[1]] = t
                g[key] = buf
            out.append(g)
        return out

    def generate(self, prompts: torch.Tensor,
                 max_new_tokens: int) -> torch.Tensor:
        """prompts [B, S] int -> [B, S + max_new_tokens]: the static-batch
        oracle (prefill, then a greedy per-token loop)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape
        logits, cache = transformer.prefill(self.params, self.cfg, prompts)
        cache = self._grow_cache(cache)
        tok = sample_logits(logits)
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        toks = [tok]
        for i in range(1, max_new_tokens):
            logits, cache = self._decode(tok, cache, pos)
            tok = sample_logits(logits)
            toks.append(tok)
            pos = pos + 1
        return torch.cat([prompts, torch.stack(toks, 1).to(prompts.dtype)],
                         1)
