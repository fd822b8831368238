"""Debug-mode state validation (counterpart of
metropolismontecarlo_tpu/utils/validate.py): the runtime invariants of a
SimState as one host-side call, cheap enough for block boundaries."""

import numpy as np


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def validate_state(state, system, params, strict=True):
    """The list of violations (empty when healthy): finite energies and
    coordinates, COMs inside the box, unit quaternions, r_cut < box / 2
    and charge neutrality.  strict raises AssertionError on any."""
    problems = []
    coords = _np(state.coords)
    com = _np(state.com)
    quat = _np(state.quat)
    box = _np(state.box)
    energy = _np(state.energy)
    if not np.all(np.isfinite(energy)):
        problems.append(f"non-finite energies in "
                        f"{np.sum(~np.isfinite(energy))} chains")
    if not np.all(np.isfinite(coords[:, :, :system.n_atoms])):
        problems.append("non-finite coordinates")
    if np.any(com < -1e-6) or np.any(com > box[:, None, None] + 1e-6):
        problems.append("molecule COM outside the box")
    norms = np.linalg.norm(quat, axis=-1)
    if np.max(np.abs(norms - 1.0)) > 1e-3:
        problems.append(f"quaternion norm drift "
                        f"{np.max(np.abs(norms - 1.0)):.2e}")
    if np.any(params.r_cut >= box / 2.0 + 1e-9):
        problems.append("r_cut >= box/2 (minimum image invalid)")
    qtot = float(np.sum(system.charges))
    if abs(qtot) > 1e-6:
        problems.append(f"system not charge neutral: {qtot:.3e}")
    if strict and problems:
        raise AssertionError("; ".join(problems))
    return problems
