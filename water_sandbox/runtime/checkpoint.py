"""Checkpoint save/restore — persistence the reference lacks entirely
(SURVEY.md §5: its only 'reset' is in-memory initial positions restored on
Space, src/fluid_compute.rs:505-525).

A checkpoint is one .npz holding every FluidState field plus the flattened
SimParams leaves and enough SimConfig to rebuild. Pure numpy container — no
orbax dependency needed for pytrees this small; loads anywhere.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np

from ..core.params import SimConfig, SimParams
from ..core.state import FluidState

_STATE_PREFIX = "state."
_PARAM_PREFIX = "param."

# SimConfig fields of older checkpoints that only shaped since-removed
# kernels (layout choices, not physics): dropped on load.
_REMOVED_CONFIG_FIELDS = (
    "incremental_rebuild", "mover_capacity", "sorted_state", "tile_override",
    "build_scatter", "density_gate", "force_gate", "dma_prefetch",
    "flush_gated")
# neighbor modes of older checkpoints that ran the bucket grid
_LEGACY_NEIGHBOR_MODES = ("pallas", "auto")


def _config_from_json(text: str) -> SimConfig:
    saved = json.loads(text)
    for name in _REMOVED_CONFIG_FIELDS:
        saved.pop(name, None)
    if saved.get("neighbor_mode") in _LEGACY_NEIGHBOR_MODES:
        saved["neighbor_mode"] = "bucket_grid"
    return SimConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in saved.items()})


def save(path: str, state: FluidState, params: SimParams,
         cfg: SimConfig) -> None:
    payload = {}
    for f in dataclasses.fields(state):
        payload[_STATE_PREFIX + f.name] = np.asarray(getattr(state, f.name))
    leaves, treedef = jax.tree.flatten(params)
    for i, leaf in enumerate(leaves):
        payload[f"{_PARAM_PREFIX}{i}"] = np.asarray(leaf)
    payload["config_json"] = np.asarray(
        json.dumps(dataclasses.asdict(cfg)))
    payload["num_param_leaves"] = np.asarray(len(leaves))
    np.savez_compressed(path, **payload)


def load(path: str, params_like: SimParams | None = None):
    """Returns (state, params, cfg). ``params_like`` supplies the params
    treedef; if omitted, a default SimParams of the right dim is used as
    template."""
    data = np.load(path, allow_pickle=False)
    cfg = _config_from_json(str(data["config_json"]))
    state_kw = {}
    for f in dataclasses.fields(FluidState):
        key = _STATE_PREFIX + f.name
        if f.name == "ids" and key not in data:
            # pre-ids checkpoints: rows were implicitly identity-ordered
            n = data[_STATE_PREFIX + "pos"].shape[0]
            state_kw["ids"] = jax.numpy.arange(n, dtype=jax.numpy.int32)
            continue
        state_kw[f.name] = jax.numpy.asarray(data[key])
    state = FluidState(**state_kw)

    if params_like is None:
        params_like = SimParams.create(dim=cfg.dim)
    treedef = jax.tree.structure(params_like)
    n_leaves = int(data["num_param_leaves"])
    leaves = [jax.numpy.asarray(data[f"{_PARAM_PREFIX}{i}"])
              for i in range(n_leaves)]
    params = jax.tree.unflatten(treedef, leaves)
    return state, params, cfg
