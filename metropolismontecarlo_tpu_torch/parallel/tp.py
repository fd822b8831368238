"""Tensor parallelism for very large systems: the atom axis of the
full-energy recompute split over ranks (counterpart of
metropolismontecarlo_tpu/parallel/tp.py).

Chain parallelism (parallel/mesh.py) scales throughput.  For one system
far beyond 10^4 atoms the costly objects are the O(A^2) pair tiles and
the O(K A) reciprocal contractions of the full recompute (drift check,
resync, pressure, NPT trial energies).  This module splits exactly that
work over a second mesh axis:

* a 2-D DeviceMesh over ("chains", "atoms"): chains shard as in
  parallel/mesh.py, and each chain's recompute row blocks and S(k) /
  reciprocal-virial contractions split over the atoms axis, summed by
  all_reduce over that axis's group (models/energy.py
  energy_breakdown_tiled, row_shard);
* the sweep stays chain-local by design: the ranks of one atoms group
  hold the same chains and sweep them alike (chain-global draws, see
  utils/shard.py); a per-move collective would serialise every move on
  the link's latency.

Results match the unsharded recompute to rounding.
"""

from metropolismontecarlo_tpu_torch.models.energy import (
    ROW_BLOCK,
    energy_breakdown_tiled,
)
from metropolismontecarlo_tpu_torch.parallel.mesh import (
    CHAINS,
    init_mesh,
    mesh_axis,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map

ATOMS = "atoms"


def make_mesh_2d(n_chain_shards, n_atom_shards, device="cuda", backend=None):
    """(chains x atoms) mesh over the initialised world of n_chain_shards x
    n_atom_shards ranks, row-major: ranks r and r + 1 of one chains index
    are neighbours along the atoms axis (on one host the recompute's
    all_reduces then join adjacent ranks)."""
    return init_mesh((n_chain_shards, n_atom_shards), (CHAINS, ATOMS),
                     device, backend)


def tp_full_energy_fn(system, params, mesh, kvecs=None, kweights=None,
                      recompute_chunk=1, row_block=ROW_BLOCK):
    """f(coords (L, 3, A_pad), com (L, M, 3), box (L,)) -> (e, w, sfac) of
    this rank's L chains, each chain's pair and reciprocal work split over
    the mesh's atoms axis; every rank of an atoms group calls it on the
    same chains, in chunks of recompute_chunk.  A drop-in for
    MonteCarlo.full_energy on a 2-D mesh (site cutoff only)."""
    group = mesh.get_group(ATOMS)
    n_tp = mesh_axis(mesh, ATOMS)[1]
    A = system.n_atoms

    def one(coords_t, com, box):
        out = energy_breakdown_tiled(
            system, params, coords_t[:, :, :A].transpose(1, 2), com, box,
            kvecs, kweights, row_block=row_block, row_shard=(group, n_tp))
        return out["total"], out["w"], out["sfac"]

    def fn(coords, com, box):
        return chunked_map(one, recompute_chunk, coords, com, box)

    return fn
