"""Checkpoint and resume of the full simulation state (counterpart of
metropolismontecarlo_tpu/io/checkpoint.py).

One .npz holds every state field under the JAX package's field names,
the metadata as meta_<name>, and the state of the torch.Generator behind
the run's draws under GENERATOR_KEY: a resumed run sets its generator
from it and continues the exact trajectory.  A checkpoint the JAX package
wrote loads too (its per-chain `key` is ignored and it holds no generator
state: the caller seeds its generator afresh).  A generator's state
belongs to its device type: a checkpoint written on the card resumes on
the card.
"""

import dataclasses

import numpy as np
import torch

from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.models.system import SimState

GENERATOR_KEY = "torch_generator_state"


def _arrays(state, metadata, generator):
    arrays = {f.name: getattr(state, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(state)}
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    for k, v in (metadata or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    return arrays


def _read(path, names, dtype):
    """(arrays of `names`, meta, generator state or None) from an npz;
    float arrays cast to dtype (a torch dtype) when given."""
    np_dtype = None if dtype is None else \
        torch.empty((), dtype=dtype).numpy().dtype
    with np.load(path) as data:
        arrays = {}
        for f in names:
            arr = data[f]
            if np_dtype is not None and arr.dtype.kind == "f":
                arr = arr.astype(np_dtype)
            arrays[f] = arr
        meta = {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
        gen = torch.from_numpy(np.array(data[GENERATOR_KEY])) \
            if GENERATOR_KEY in data.files else None
        kind = str(data["state_kind"]) if "state_kind" in data.files \
            else None
    return arrays, meta, gen, kind


def save_state(path, state, metadata=None, generator=None):
    """Write a SimState (and the generator's state, when given)."""
    np.savez_compressed(path, **_arrays(state, metadata, generator))


def load_state(path, device="cuda", dtype=None):
    """(SimState on device, meta dict, generator state or None) from a
    save_state checkpoint of either package."""
    names = [f.name for f in dataclasses.fields(SimState)]
    arrays, meta, gen, _ = _read(path, names, dtype)
    return bridge.state_from_numpy(arrays, device), meta, gen


def save_ensemble_state(path, state, metadata=None, generator=None):
    """Write any ensemble state (GCMCState, MolGCMCState, GibbsState,
    MolGibbsState, SemigrandState, BinaryGCMCState) with its class name
    under "state_kind", as the JAX package does."""
    arrays = _arrays(state, metadata, generator)
    arrays["state_kind"] = np.asarray(type(state).__name__)
    np.savez_compressed(path, **arrays)


def load_ensemble_state(path, state_cls, device="cuda", dtype=None):
    """(state_cls on device, meta, generator state or None) from a
    save_ensemble_state checkpoint of either package; a checkpoint of
    another state class raises."""
    names = [f.name for f in dataclasses.fields(state_cls)]
    arrays, meta, gen, kind = _read(path, names, dtype)
    if kind != state_cls.__name__:
        raise ValueError(f"checkpoint holds a {kind}, not a "
                         f"{state_cls.__name__}")
    return bridge.ensemble_state_from_numpy(state_cls, arrays, device), \
        meta, gen
