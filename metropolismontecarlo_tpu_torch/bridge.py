"""Numpy bridge between this package and the JAX package.

Both packages describe a system and a state with the same fields and
shapes, so a test can build one side, pass numpy arrays across, and run
the same computation on both.  This module imports no JAX: the caller
turns the JAX objects into plain dicts of numpy arrays.
"""

import dataclasses

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMCState
from metropolismontecarlo_tpu_torch.models.system import SimState, System

_SYSTEM_FIELDS = tuple(f.name for f in dataclasses.fields(System))
_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_GCMC_FIELDS = tuple(f.name for f in dataclasses.fields(MolGCMCState))


def system_from_numpy(fields):
    """System from the JAX System's dataclass fields (a mapping of field
    name to numpy array or plain value)."""
    kw = {}
    for name in _SYSTEM_FIELDS:
        if name not in fields:
            continue
        v = fields[name]
        kw[name] = np.array(v) if isinstance(v, np.ndarray) else v
    return System(**kw)


def state_from_numpy(arrays, device):
    """SimState on `device` from a mapping of field name to numpy array
    (the JAX SimState's fields; its `key` is ignored).  dtypes are
    kept."""
    missing = [f for f in _STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state arrays lack fields {missing}")
    return SimState(**{f: torch.as_tensor(np.array(arrays[f]), device=device)
                       for f in _STATE_FIELDS})


def state_to_numpy(state):
    """{field: numpy array} for every SimState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _STATE_FIELDS}


def gcmc_state_from_numpy(arrays, device):
    """MolGCMCState on `device` from a mapping of field name to numpy
    array (the JAX MolGCMCState's fields; its `key` is ignored).  dtypes
    are kept."""
    missing = [f for f in _GCMC_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state arrays lack fields {missing}")
    return MolGCMCState(**{
        f: torch.as_tensor(np.array(arrays[f]), device=device)
        for f in _GCMC_FIELDS})


def gcmc_state_to_numpy(state):
    """{field: numpy array} for every MolGCMCState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _GCMC_FIELDS}
