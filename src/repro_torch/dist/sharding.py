"""Named sharding rules and the model's constraint points (port of
``repro.dist.sharding``).

A ``Rules`` table maps *logical* axis names ("batch", "heads", "vocab",
...) to mesh-axis names (or None for replicated, or a tuple of mesh
axes).  Model code never names a mesh axis: it calls ``constrain(x,
"batch", "seq", None)`` and the active rules (installed by
:func:`use_rules`) decide the placement.  A spec is a tuple of mesh-axis
entries, one a dimension, where the reference builds a ``PartitionSpec``.

The reference's ``make_mesh`` builds a device mesh; the port's mesh is the
process-group layout of ``dist.mesh.ServingMesh`` (axes ``"data"`` and
``"model"``).  In a torch process group every rank already holds its own shard
of a tensor, so :func:`constrain` places nothing: outside ``use_rules``
it is the identity, inside it checks the tensor against the spec and the
mesh and returns it unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


class Rules(dict):
    """Logical-axis -> mesh-axis table (plain dict with a type name)."""


def production_rules(multi_pod: bool = False) -> Rules:
    """Default rule table for the (data, model) production meshes.

    ``fsdp``/``expert``/``expert_mlp``/``seq_kv`` are filled in per cell
    (the reference's ``launch.mesh.rules_for``); their defaults here are
    the serving-friendly replicated choices."""
    return Rules(
        batch=("pod", "data") if multi_pod else "data",
        seq=None,                 # activations keep full sequence per shard
        seq_kv=None,              # long-context cells shard KV time instead
        vocab="model",
        heads="model",
        kv_heads="model",
        mlp="model",
        expert=None,
        expert_mlp=None,
        moe_capacity=None,
        fsdp=None,
    )


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``ServingMesh``."""
    return {"data": mesh.n_data, "model": mesh.n_model}


# -- active-rules context ----------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules: Rules, mesh=None):
    """Install ``rules`` (and optionally a ``ServingMesh``) for
    ``constrain``."""
    _ACTIVE.append((rules, mesh))
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def current_rules() -> Optional[tuple]:
    """The innermost ``(rules, mesh)`` installed, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def spec_entry(entry):
    """An entry as ``PartitionSpec`` keeps it: a one-axis tuple is that
    axis's name."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def spec_for(rules: Rules, *axes) -> tuple:
    """Spec from logical axis names (None entries stay None; a tuple is
    already mesh axes)."""
    entries = []
    for a in axes:
        if a is None:
            entries.append(None)
        elif isinstance(a, str):
            entries.append(spec_entry(rules.get(a)))
        else:
            entries.append(spec_entry(a))
    return tuple(entries)


def entry_axes(entry) -> tuple:
    """The mesh axes one spec entry names (``()`` when replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axis name:
    the identity outside ``use_rules``; inside it, ``x`` is returned
    unchanged after checking that the spec fits its rank and, with a mesh
    installed, that every mesh axis it names is one of the mesh's."""
    ctx = current_rules()
    if ctx is None:
        return x
    rules, mesh = ctx
    spec = spec_for(rules, *axes)
    if all(e is None for e in spec):
        return x
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"tensor of rank {x.dim()}")
    if mesh is not None:
        sizes = mesh_axes(mesh)
        for e in spec:
            for a in entry_axes(e):
                if a not in sizes:
                    raise ValueError(f"spec {spec} names mesh axis {a!r}; "
                                     f"the mesh has {sorted(sizes)}")
    return x
