"""Numpy bridge between this package and the JAX package.

Both packages describe a system and a state with the same fields and
shapes, so a test can build one side, pass numpy arrays across, and run
the same computation on both.  This module imports no JAX: the caller
turns the JAX objects into plain dicts of numpy arrays.
"""

import dataclasses

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc import GCMCState
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMCState
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMCState
from metropolismontecarlo_tpu_torch.mc.gcmc_osmotic import OsmoticState
from metropolismontecarlo_tpu_torch.mc.gibbs import GibbsState
from metropolismontecarlo_tpu_torch.mc.gibbs_binary import BinaryGibbsState
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsState
from metropolismontecarlo_tpu_torch.mc.semigrand import SemigrandState
from metropolismontecarlo_tpu_torch.models.system import SimState, System

_SYSTEM_FIELDS = tuple(f.name for f in dataclasses.fields(System))
_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_GCMC_FIELDS = tuple(f.name for f in dataclasses.fields(MolGCMCState))
_MONO_FIELDS = tuple(f.name for f in dataclasses.fields(GCMCState))
_GIBBS_FIELDS = tuple(f.name for f in dataclasses.fields(GibbsState))
_MOL_GIBBS_FIELDS = tuple(f.name for f in dataclasses.fields(MolGibbsState))
_SEMIGRAND_FIELDS = tuple(f.name for f in dataclasses.fields(SemigrandState))
_BINARY_FIELDS = tuple(f.name for f in dataclasses.fields(BinaryGCMCState))
_OSMOTIC_FIELDS = tuple(f.name for f in dataclasses.fields(OsmoticState))
_BINARY_GIBBS_FIELDS = tuple(f.name
                             for f in dataclasses.fields(BinaryGibbsState))
_TMMC_FIELDS = ("cmat", "uhist", "eta")


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


def _from_numpy(cls, fields, arrays, device):
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"state arrays lack fields {missing}")
    return cls(**{f: torch.as_tensor(np.array(arrays[f]), device=device)
                  for f in fields})


def state_from_numpy(arrays, device):
    """SimState on `device` from a mapping of field name to numpy array
    (the JAX SimState's fields; its `key` is ignored).  dtypes are
    kept."""
    return _from_numpy(SimState, _STATE_FIELDS, arrays, device)


def state_to_numpy(state):
    """{field: numpy array} for every SimState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _STATE_FIELDS}


def gcmc_state_from_numpy(arrays, device):
    """MolGCMCState on `device` from a mapping of field name to numpy
    array (the JAX MolGCMCState's fields; its `key` is ignored).  dtypes
    are kept."""
    return _from_numpy(MolGCMCState, _GCMC_FIELDS, arrays, device)


def gcmc_state_to_numpy(state):
    """{field: numpy array} for every MolGCMCState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _GCMC_FIELDS}


def mono_gcmc_state_from_numpy(arrays, device):
    """Monatomic GCMCState on `device` from a mapping of field name to
    numpy array (the JAX GCMCState's fields; its `key` is ignored).
    dtypes are kept."""
    return _from_numpy(GCMCState, _MONO_FIELDS, arrays, device)


def mono_gcmc_state_to_numpy(state):
    """{field: numpy array} for every monatomic GCMCState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _MONO_FIELDS}


def gibbs_state_from_numpy(arrays, device):
    """Monatomic GibbsState on `device` from a mapping of field name to
    numpy array (the JAX GibbsState's fields; its `key` is ignored).
    dtypes are kept."""
    return _from_numpy(GibbsState, _GIBBS_FIELDS, arrays, device)


def gibbs_state_to_numpy(state):
    """{field: numpy array} for every monatomic GibbsState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _GIBBS_FIELDS}


def mol_gibbs_state_from_numpy(arrays, device):
    """MolGibbsState on `device` from a mapping of field name to numpy
    array (the JAX MolGibbsState's fields; its `key` is ignored).  dtypes
    are kept."""
    return _from_numpy(MolGibbsState, _MOL_GIBBS_FIELDS, arrays, device)


def mol_gibbs_state_to_numpy(state):
    """{field: numpy array} for every MolGibbsState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _MOL_GIBBS_FIELDS}


def semigrand_state_from_numpy(arrays, device):
    """SemigrandState on `device` from a mapping of field name to numpy
    array (the JAX SemigrandState's fields; its `key` is ignored).  dtypes
    are kept."""
    return _from_numpy(SemigrandState, _SEMIGRAND_FIELDS, arrays, device)


def semigrand_state_to_numpy(state):
    """{field: numpy array} for every SemigrandState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _SEMIGRAND_FIELDS}


def binary_gcmc_state_from_numpy(arrays, device):
    """BinaryGCMCState on `device` from a mapping of field name to numpy
    array (the JAX BinaryGCMCState's fields; its `key` is ignored).  dtypes
    are kept."""
    return _from_numpy(BinaryGCMCState, _BINARY_FIELDS, arrays, device)


def binary_gcmc_state_to_numpy(state):
    """{field: numpy array} for every BinaryGCMCState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _BINARY_FIELDS}


def osmotic_state_from_numpy(arrays, device):
    """OsmoticState on `device` from a mapping of field name to numpy array
    (the JAX OsmoticState's fields; its `key` is ignored).  dtypes are
    kept."""
    return _from_numpy(OsmoticState, _OSMOTIC_FIELDS, arrays, device)


def osmotic_state_to_numpy(state):
    """{field: numpy array} for every OsmoticState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _OSMOTIC_FIELDS}


def binary_gibbs_state_from_numpy(arrays, device):
    """BinaryGibbsState on `device` from a mapping of field name to numpy
    array (the JAX BinaryGibbsState's fields; its `key` is ignored).
    dtypes are kept."""
    return _from_numpy(BinaryGibbsState, _BINARY_GIBBS_FIELDS, arrays,
                       device)


def binary_gibbs_state_to_numpy(state):
    """{field: numpy array} for every BinaryGibbsState field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _BINARY_GIBBS_FIELDS}


def ensemble_state_from_numpy(state_cls, arrays, device):
    """Any ensemble state of this package (GCMCState, MolGCMCState,
    GibbsState, MolGibbsState, SemigrandState, BinaryGCMCState,
    OsmoticState, BinaryGibbsState) as
    state_cls on `device`, from a mapping of field name to numpy array (a
    JAX state's `key` is ignored).  dtypes are kept."""
    names = tuple(f.name for f in dataclasses.fields(state_cls))
    return _from_numpy(state_cls, names, arrays, device)


def ensemble_state_to_numpy(state):
    """{field: numpy array} for every field of an ensemble state."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def tmmc_estimator_to_numpy(t):
    """{cmat, uhist, eta}: the pooled float64 estimator state of a TMMC or
    TMMCMol object (of either package: both keep numpy arrays)."""
    return {f: np.array(getattr(t, f), np.float64) for f in _TMMC_FIELDS}


def tmmc_estimator_from_numpy(t, arrays):
    """Set a TMMC or TMMCMol object's cmat (cap + 1, 3), uhist (cap + 1, 3)
    and eta (cap + 1,) from numpy arrays, checking their shapes."""
    for f in _TMMC_FIELDS:
        v = np.array(arrays[f], np.float64)
        if v.shape != getattr(t, f).shape:
            raise ValueError(f"{f}: shape {v.shape} != "
                             f"{getattr(t, f).shape}")
        setattr(t, f, v)
