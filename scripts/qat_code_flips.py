#!/usr/bin/env python3
"""Count the A4 activation codes on which the port's QAT forward and the
reference's part (CPU, float32 compute).

    PYTHONPATH=src python scripts/qat_code_flips.py [--arch minicpm-2b]

Both packages run the smoke config's QAT forward from the same weights
(the reference's ``init_params`` under ``jax.jit``, seed 0, converted by
``convert.params_from_jax``) on the ``tests/test_torch_train.py`` batch;
the reference runs op by op (``jax.disable_jit``, layers unrolled) so
that every ``layers.linear`` call can be recorded.  For each ``"qat"``
projection the script quantizes the positive part of its input as that
package's ``fake_quant`` does (per-channel uint4 over the batch and
sequence) and prints, by call, the codes that differ, then the share of
all codes.  A code differs where the float32 sums before it, taken in
another order by XLA and ATen, fall on the other side of a rounding
boundary; downstream calls inherit the change.
"""
import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro import configs as jconfigs  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels.lutmul import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    args = ap.parse_args()
    ops.set_backend("ref")
    jc = dataclasses.replace(jconfigs.get_config(args.arch, smoke=True,
                                                 quant="qat"),
                             compute_dtype="float32", unroll_groups=True)
    tc = dataclasses.replace(tconfigs.get_config(args.arch, smoke=True,
                                                 quant="qat"),
                             compute_dtype="float32")
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jc)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                         device="cpu")
    b = jpipe.lm_batch(jpipe.DataConfig(seed=3, vocab=jc.vocab, seq_len=16,
                                        global_batch=2), 0)
    rec_j, rec_t = [], []
    lin_j, lin_t = JL.linear, TL.linear

    def hook_j(p, x, quant="none", compute_dtype=jnp.bfloat16):
        if quant == "qat":
            pos = jax.nn.relu(x.astype(jnp.float32))
            rec_j.append(np.asarray(jq.quantize(
                pos, jq.compute_scale(pos, jq.A4), 0, jq.A4)))
        return lin_j(p, x, quant, compute_dtype)

    def hook_t(p, x, quant="none", compute_dtype=torch.bfloat16):
        if quant == "qat":
            pos = torch.relu(x.to(torch.float32))
            rec_t.append(tq.quantize(pos, tq.compute_scale(pos, tq.A4), 0,
                                     tq.A4).detach().numpy())
        return lin_t(p, x, quant, compute_dtype)

    JL.linear = JA.linear = hook_j
    TL.linear = TA.linear = hook_t
    with jax.disable_jit():
        jl = float(JT.loss_fn(jp, jc, {k: jnp.asarray(v)
                                       for k, v in b.items()}))
    with torch.no_grad():
        tl = float(TS.loss_for(tc)(tp, TS.to_device(b, "cpu")))
    assert len(rec_j) == len(rec_t) > 0
    total = flipped = 0
    for i, (a, c) in enumerate(zip(rec_j, rec_t)):
        n = int((a != c).sum())
        total += a.size
        flipped += n
        print(f"call {i:3d} shape {tuple(a.shape)}: {n} of {a.size} codes "
              f"differ")
    print(f"{args.arch} smoke QAT: loss reference {jl!r} port {tl!r}; "
          f"{flipped} of {total} A4 codes differ (share "
          f"{flipped / total!r})")


if __name__ == "__main__":
    main()
