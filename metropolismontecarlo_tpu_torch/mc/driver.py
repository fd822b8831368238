"""Chain-parallel MC driver (counterpart of
metropolismontecarlo_tpu/mc/driver.py).

C independent chains advance in lockstep.  `sweep` moves every molecule
once, in storage order, by one of three routes (the JAX package's
"mega", "tpu" and jnp routes):

* "sweep": one whole-sweep kernel launch per species block;
* "move": one delta-energy kernel launch per molecule move, on the card
  each sweep's moves as one replayed CUDA graph (capture_sweep);
* "plain": per-move plain tensor code, for the conventions neither kernel
  runs (com/first cutoffs, the linear shift with several templates per
  block, the Ewald surface term, float64).

On the card the kernels run; on the CPU the same route runs their plain
versions.  On the whole-sweep route init_state sizes sorted-slab windows
from the box and chain 0's z where slab_config finds them profitable
(`retune_slabs` re-sizes them from the current state).  `run_steps`
loops sweeps with optional step-size adaptation and, under NPT, a volume
move every round(1/p_volume) sweeps (mc/npt.py); `run_block` adds the
block-end recompute that checks the accumulated energy's drift (and the
slab windows' coverage) and resynchronises energy, virial and S(k).
`pressure_fd` is the finite-difference pressure, `quench` a
near-zero-temperature descent.

Every full-energy recompute (init, the block end, resync, the NPT volume
move) runs as one launch of the recompute kernel over all chains
(ops/cuda/recompute_kernel.py) where mc/moves.py
recompute_kernel_supported admits the run (the card, float32, site
cutoff, none/linear LJ shift, Ewald or no Coulomb, no surface term, the
dense route's atom counts, no tp_mesh); elsewhere models/energy.py
energy_breakdown runs in chunks of recompute_chunk chains.

`widom` samples ghost insertions in plain tensor code, `widom_mega` runs
a sweep and the ghosts inside one sweep-kernel launch (mc/widom.py).

Verlet neighbour lists (params.nlist_width > 0, off by default) run on
the "plain" route, as the JAX package runs them on its jnp path only:
every sweep first rebuilds each chain's lists (mc/moves.py
rebuild_nlist) and folds the width they needed into state.nbr_needed;
adaptation caps dr_max at nlist_skin / 2, and run_block raises when a
block needed more than nlist_width.

With tp_mesh (parallel/tp.py make_mesh_2d) every state is this rank's
shard of the chains, and every full-energy recompute (init, the drift
check and resync, the NPT volume move, pressure_fd) goes through the
tensor-parallel row-sharded route, split over the mesh's atoms axis; the
sweeps stay chain-local, on chain-global draws (utils/shard.py), so the
ranks of one atoms group sweep their shared chains alike.
"""

import contextlib
import dataclasses
import math
import warnings

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.adjust import adjust_dmax
from metropolismontecarlo_tpu_torch.mc.moves import (
    MoveSweepGraph,
    delta_kernel_supported,
    draw_uniforms,
    make_mega_sweep_fn,
    make_sweep_fn,
    mega_supported,
    move_graph_key,
    nlist_radius,
    rebuild_nlist,
    recompute_kernel_supported,
    slab_config,
)
from metropolismontecarlo_tpu_torch.mc.npt import make_volume_move_fn
from metropolismontecarlo_tpu_torch.mc.widom import (
    make_mega_widom_fn,
    make_widom_fn,
    mu_excess,
)
from metropolismontecarlo_tpu_torch.models.energy import (
    DENSE_MAX_ATOMS,
    ROW_BLOCK,
    energy_breakdown,
)
from metropolismontecarlo_tpu_torch.models.system import SimState
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.cuda import (
    recompute_kernel as recompute_op,
)
from metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel import N_UNIFORMS
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    fit_quaternions,
    rotate_vectors,
    shoemake_quaternion,
)
from metropolismontecarlo_tpu_torch.parallel.mesh import chain_shard
from metropolismontecarlo_tpu_torch.parallel.tp import tp_full_energy_fn
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.profiling import span
from metropolismontecarlo_tpu_torch.utils.shard import (
    current_shard,
    rand_chains,
)


def _auto_recompute_chunk(system, dtype, n_k=0, budget_bytes=8 << 30):
    """Chains per chunk of the full-energy recompute against a fixed
    memory budget, clamped to [1, 64] (the JAX driver's model with this
    port's counts): up to DENSE_MAX_ATOMS ~48 live (A, A) temporaries per
    chain (the (A, A, 3) displacement grids count three each); above it
    as many (B, A) row tiles plus ~8 (A, K) grids of the structure factor
    and the reciprocal virial, n_k the Ewald k-vectors."""
    A = system.n_atoms_padded
    item = torch.finfo(dtype).bits // 8
    if system.n_atoms > DENSE_MAX_ATOMS:
        per_chain = item * A * (48 * ROW_BLOCK + 8 * n_k)
    else:
        per_chain = 48 * A * A * item
    return int(max(1, min(64, budget_bytes // per_chain)))


ROUTES = ("auto", "sweep", "move", "plain")


def choose_route(system, params, dtype, kernel):
    """The sweep route for `kernel` ("auto" | "sweep" | "move" | "plain"),
    as the JAX driver picks between "mega", "tpu" and jnp: "auto" takes
    the whole sweep for species-uniform systems, else the per-move kernel
    where it runs the conventions, else plain.  A forced kernel route that
    cannot run the configuration raises.  Neighbour lists run on the
    plain route only."""
    if params.nlist_width > 0:
        if kernel not in ("auto", "plain"):
            raise ValueError(
                "neighbor lists run on the jnp move path; they cannot be "
                "combined with an explicitly requested Pallas mode")
        return "plain"
    sweep_ok = mega_supported(system, params, dtype)
    move_ok = delta_kernel_supported(params, dtype)
    if kernel == "auto":
        return "sweep" if sweep_ok else "move" if move_ok else "plain"
    if kernel == "sweep" and not sweep_ok:
        raise ValueError("the whole-sweep route requires a species-uniform "
                         "system, site cutoff, none/linear LJ shift, "
                         "float32 and no Ewald surface term")
    if kernel == "move" and not move_ok:
        raise ValueError("the per-move kernel route requires site cutoff, "
                         "unshifted LJ, float32 and no Ewald surface term")
    if kernel not in ROUTES:
        raise ValueError(f"kernel must be one of {ROUTES}, got {kernel!r}")
    return kernel


class MonteCarlo:
    """System + RunParams bundled into the chain-parallel NVT loop.

    Usage:
        mc = MonteCarlo(system, params, generator=gen)   # on the card
        state = mc.init_state(com0, box=box0, n_chains=2048)
        state, metrics = mc.run_block(state, n_steps=100, adjust=True)
    """

    def __init__(self, system, params, device="cuda", generator=None,
                 dtype=torch.float32, recompute_chunk="auto", tp_mesh=None,
                 kernel="auto", pressure_ladder=None):
        """device: where state and kernels live, the card unless the
        caller passes "cpu" (then every kernel runs its plain version);
        without a CUDA device a "cuda" request raises.  generator: the
        torch.Generator (on `device`) behind every random draw; a fresh
        one seeded 0 when None.  recompute_chunk: chains per step of the
        chunked full-energy recompute where it runs plain (energy_breakdown;
        "auto": from a memory model); the recompute kernel takes every
        chain in one launch.
        tp_mesh: a 2-D ("chains", "atoms") DeviceMesh (parallel/tp.py
        make_mesh_2d) over the initialised world: states are then this
        rank's shard of the chains (init_state's n_chains counts the
        rank's own), and every full recompute is split over the atoms
        axis (site cutoff only).
        kernel: the sweep route, see choose_route; self.route holds the
        choice.  The kernel routes run float32; "plain" also float64.
        pressure_ladder: (n_chains,) per-chain pressures for NPT, every
        chain on its own isobar; needs params.p_volume > 0 (then
        params.pressure may be None)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: MonteCarlo runs on the GPU by default; pass "
                "device='cpu' to run the kernels' plain versions on the CPU")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, state on "
                             f"{self.device}")
        self.generator = generator
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: float32 or float64")
        if tp_mesh is not None and params.cutoff_mode != "site":
            raise NotImplementedError("the tensor-parallel recompute "
                                      "supports site cutoff only")
        if pressure_ladder is not None and params.p_volume <= 0.0:
            raise ValueError(
                "pressure_ladder requires params.p_volume > 0: with no "
                "volume moves every chain would sample the same fixed-V "
                "ensemble instead of its isobar")
        self.system = system
        self.params = params
        self.dtype = dtype
        if params.coulomb == "ewald":
            self.kvecs, self.kweights = ewald_ops.make_kvectors(
                params.nk, params.ksq_max, strict=True)
        else:
            self.kvecs, self.kweights = None, None
        if recompute_chunk in ("auto", None):
            recompute_chunk = _auto_recompute_chunk(
                system, dtype, 0 if self.kvecs is None else len(self.kvecs))
        self.recompute_chunk = recompute_chunk
        self.tp_mesh = tp_mesh
        self._tp_fe = None
        if tp_mesh is not None:
            self._tp_fe = tp_full_energy_fn(
                system, params, tp_mesh, self.kvecs, self.kweights,
                recompute_chunk=recompute_chunk)
        # the full-energy recompute's kernel tables, uploaded once, where
        # the gate admits the run (else the chunked energy_breakdown)
        self._recompute_tables = None
        if recompute_kernel_supported(system, params, dtype, self.device,
                                      tp_mesh):
            self._recompute_tables = recompute_op.recompute_tables(
                system, params, self.kvecs, self.kweights, self.device)
        self._widom_fns, self._widom_mega_fn, self._widom_mega_n = \
            {}, None, None
        self.route = choose_route(system, params, dtype, kernel)
        self._slab_cfg = None
        if self.route == "sweep":
            self._sweep_full = make_mega_sweep_fn(
                system, params, self.kvecs, self.kweights, self.device)
            self.tables = self._sweep_full.tables
            self.move_bodies = ()
        else:
            # one body per species block: each has its own static atom
            # count and offset, so a ragged mixture pays per-move work
            # proportional to that species' size
            self._sweep_full, self.tables = None, ()
            self.move_bodies = tuple(
                (sl[1], sl[2],
                 make_sweep_fn(system, params, self.kvecs, self.kweights,
                               self.device, dtype, self.route == "move", sl))
                for sl in system.species_slices)
        self._move_graphs = {}
        self._volume_move = None
        if (params.pressure is not None or pressure_ladder is not None) \
                and params.p_volume > 0.0:
            self._volume_move = make_volume_move_fn(
                system, params, self._energies, self.build_coords,
                pressure=pressure_ladder)

    def _maybe_slab_mega(self, box_hint, z_hint=None):
        """Rebuild the whole-sweep route with sorted-slab windows sized
        for this box and configuration where slab_config finds them
        profitable (a no-op on other routes or when the window is
        unchanged)."""
        if self.route != "sweep":
            return
        cfg = slab_config(self.system, self.params, box_hint, z_hint)
        key = None if cfg is None else (cfg["W"], cfg["A_store"])
        cur = None if self._slab_cfg is None else (
            self._slab_cfg["W"], self._slab_cfg["A_store"])
        if key == cur:
            return
        self._slab_cfg = cfg
        self._sweep_full = make_mega_sweep_fn(
            self.system, self.params, self.kvecs, self.kweights, self.device,
            box_hint=box_hint if cfg is not None else None, z_hint=z_hint)
        self.tables = self._sweep_full.tables

    def retune_slabs(self, state):
        """Re-size the sorted-slab windows from the current configuration
        (after equilibrating away a lattice start, whose z-plane clumps
        force wide windows at init); resets the coverage counter."""
        self._maybe_slab_mega(float(torch.min(state.box)),
                              state.com[0, :, 2].double().cpu().numpy())
        return dataclasses.replace(
            state, nbr_needed=torch.zeros_like(state.nbr_needed))

    def _chain_shard(self, n_local):
        """With tp_mesh, the shard context of this rank's n_local chains
        (unless the caller set one): chain-global draws for the ranks of
        an atoms group, which hold the same chains."""
        if self.tp_mesh is None or current_shard() is not None:
            return contextlib.nullcontext()
        return chain_shard(self.tp_mesh, n_local)

    def _check_min_image(self, box):
        """r_cut <= box/2, else pair sums silently miss second images;
        params.strict_min_image=False downgrades to a warning."""
        max_cut = float(max(self.params.r_cut, self.params.qq_cut))
        bmin = float(torch.min(box))
        if bmin + 1e-6 < 2.0 * max_cut:
            msg = (f"minimum image violated: box {bmin:.4f} < 2 * cutoff "
                   f"{max_cut} - enlarge the system or shrink "
                   f"r_cut/qq_r_cut (or set strict_min_image=False to "
                   f"sample the truncated-nearest-image model)")
            if self.params.strict_min_image:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=3)

    # ---------------- state construction ----------------

    def build_coords(self, com, quat):
        """Atoms r = com + R(q) b: com (..., M, 3), quat (..., M, 4) ->
        (..., 3, A_pad) with zero lane padding."""
        body = torch.tensor(np.array(self.system.body), dtype=com.dtype,
                            device=com.device)
        atoms = com[..., :, None, :] + rotate_vectors(quat, body)
        if self.system.uniform_width:
            flat = atoms.reshape(atoms.shape[:-3] + (self.system.n_atoms, 3))
        else:
            mol, slot = self.system.atom_mol_slot
            flat = atoms[..., mol, slot, :]
        out = flat.transpose(-1, -2)
        pad = self.system.n_atoms_padded - self.system.n_atoms
        return torch.nn.functional.pad(out, (0, pad)).contiguous()

    def _new_state(self, com, quat, box):
        C = com.shape[0]
        p, dev, dt = self.params, self.device, self.dtype

        def full(v):
            return torch.full((C,), v, dtype=dt, device=dev)

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return SimState(
            com=com, quat=quat, coords=self.build_coords(com, quat), box=box,
            sfac=zeros(C, 1, 2), energy=zeros(C), virial=zeros(C),
            temp=full(p.temperature),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            dr_max=full(p.dr_max), dphi_max=full(p.dphi_max),
            dv_max=full(p.dv_max), acc=zeros(C, 3, dtype=torch.int32),
            att=zeros(C, 3, dtype=torch.int32),
            nbr=self._init_nbr(C), nbr_needed=zeros(C, dtype=torch.int32))

    def _init_nbr(self, n_chains):
        """The neighbour-list buffer (C, M, NB), rebuilt at every sweep;
        (C, 1, 1) without lists."""
        nb = self.params.nlist_width
        shape = (n_chains, self.system.n_mol, nb) if nb > 0 \
            else (n_chains, 1, 1)
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def init_state(self, com, quat=None, box=None, n_chains=None):
        """SimState from com (M, 3) or (C, M, 3); quat likewise, or None
        for random orientations drawn from the driver's generator; box a
        scalar or (C,)."""
        M = self.system.n_mol
        com = torch.as_tensor(np.asarray(com), dtype=self.dtype,
                              device=self.device)
        if com.dim() == 2:
            if n_chains is None:
                raise ValueError("n_chains required when replicating one "
                                 "config")
            com = com[None].expand(n_chains, M, 3)
        com = com.contiguous()
        C = com.shape[0]
        if quat is None:
            # chain-global under a shard context (utils/shard.py)
            with self._chain_shard(C):
                quat = shoemake_quaternion(rand_chains(
                    (C, M, 3), self.generator, self.dtype, self.device))
        else:
            quat = torch.as_tensor(np.asarray(quat), dtype=self.dtype,
                                   device=self.device)
            if quat.dim() == 2:
                quat = quat[None].expand(C, M, 4)
            quat = quat.contiguous()
        box = torch.as_tensor(np.asarray(box), dtype=self.dtype,
                              device=self.device)
        box = torch.broadcast_to(box.reshape(-1), (C,)).contiguous()
        self._check_min_image(box)
        self._maybe_slab_mega(float(torch.min(box)),
                              com[0, :, 2].double().cpu().numpy())
        return self.resync(self._new_state(com, quat, box))

    def init_from_coords(self, coords, com, box, n_chains):
        """Replicate one explicit atom configuration across chains, with
        per-molecule quaternions Kabsch-fitted to the body template and
        the atoms rebuilt as com + R(q) body."""
        M = self.system.n_mol
        coords_np = np.asarray(coords, np.float64).reshape(
            self.system.n_atoms, 3)
        com_np = np.asarray(com, np.float64)
        box_np = float(np.asarray(box).reshape(-1)[0])
        body_np = np.asarray(self.system.body, np.float64)
        quat_np = np.zeros((M, 4))
        for _, m0, m1, p, a0 in self.system.species_slices:
            c = coords_np[a0:a0 + (m1 - m0) * p].reshape(m1 - m0, p, 3)
            rel = c - com_np[m0:m1, None, :]
            rel -= box_np * np.round(rel / box_np)  # heal PBC-split molecules
            quat_np[m0:m1] = fit_quaternions(body_np[m0:m1, :p], rel)
        return self.init_state(com_np, quat_np, box_np, n_chains)

    # ---------------- full recompute / resync ----------------

    def _energies(self, coords, com, box):
        """Full-system energy of coords (C, 3, A_pad), com (C, M, 3), box
        (C,): (C,) totals, virials and (C, K, 2) structure factors ((C, 1,
        2) zeros without Ewald).  Where recompute_kernel_supported admitted
        the run, one launch of the recompute kernel over all chains
        (ops/cuda/recompute_kernel.py); with tp_mesh split over the atoms
        axis (parallel/tp.py); else energy_breakdown in chunks of
        recompute_chunk chains.  One `recompute` span of the chains
        (utils/profiling.py), the kernel's launch in a `recompute.kernel`
        span inside it."""
        C = coords.shape[0]
        with span("recompute", C):
            if self._recompute_tables is not None:
                with span("recompute.kernel", C, sync=False):
                    return recompute_op.recompute_kernel(
                        self._recompute_tables, coords, com, box)
            if self._tp_fe is not None:
                return self._tp_fe(coords, com, box)
            A = self.system.n_atoms

            def one(coords_t, com, box):
                out = energy_breakdown(self.system, self.params,
                                       coords_t[:, :, :A].transpose(1, 2),
                                       com, box, self.kvecs, self.kweights)
                return out["total"], out["w"], out["sfac"]

            return chunked_map(one, self.recompute_chunk, coords, com, box)

    def full_energy(self, state):
        """Full-system energy over chains (_energies): (C,) totals,
        virials and (C, K, 2) structure factors ((C, 1, 2) zeros without
        Ewald)."""
        return self._energies(state.coords, state.com, state.box)

    def resync(self, state):
        """Replace the carried energy/virial/S(k) with a recompute."""
        e, w, sfac = self.full_energy(state)
        if self.params.coulomb != "ewald":
            sfac = state.sfac
        return dataclasses.replace(state, energy=e, virial=w, sfac=sfac)

    # ---------------- sweeps ----------------

    def sweep(self, state):
        """One sweep: every molecule attempted once, in storage order, on
        uniforms (C, M, 10) drawn once from the generator (the per-move
        routes hand molecule m its row u[:, m]); under NPT then a volume
        move of every chain on every round(1/p_volume)-th sweep (step is
        a pure molecule-move counter, so step // n_mol is the 1-based
        sweep index).  With neighbour lists every sweep first rebuilds
        them and folds the width they needed into state.nbr_needed (a
        running maximum, checked by run_block)."""
        with self._chain_shard(state.com.shape[0]):
            return self._sweep(state)

    def _sweep(self, state):
        if self.params.nlist_width > 0:
            nbr, needed = rebuild_nlist(
                state.com, state.box, self.params,
                nlist_radius(self.system, self.params))
            state = dataclasses.replace(
                state, nbr=nbr,
                nbr_needed=torch.maximum(state.nbr_needed, needed))
        state = self._sweep_moves(state)
        if self._volume_move is not None:
            period = max(1, int(round(1.0 / self.params.p_volume)))
            if (int(state.step) // self.system.n_mol) % period == 0:
                state = self._volume_move(state, self.generator)
        return state

    def _sweep_moves(self, state):
        if self.route == "sweep":
            return self._sweep_full(state, self.generator)
        C, M = state.com.shape[:2]
        u = draw_uniforms(C, M, self.generator, state.com.device).to(
            self.dtype)
        return self.move_sweep(state, u)

    def move_sweep(self, state, u):
        """The per-move routes' moves of one sweep on uniforms u (C, M, 10),
        through the static buffers kept for states of this shape and dtype
        (mc/moves.py MoveSweepGraph): on the "move" route on the card one
        replay of the sweep's CUDA graph (capture_sweep), else every body
        in turn on those buffers."""
        return self._move_sweeper(state)(state, u)

    def capture_sweep(self, state):
        """The "move" route's sweep graph for states shaped like `state`,
        captured on the first call for each shape and dtype; sweeps
        capture it on their own, so calling this first only takes the
        capture (and its warm-up launches) out of the first sweep."""
        if self.route != "move" or self.device.type != "cuda":
            raise ValueError("sweep graphs are captured for the \"move\" "
                             "route on the card")
        return self._move_sweeper(state)

    def _move_sweeper(self, state):
        key = move_graph_key(state)
        sweeper = self._move_graphs.get(key)
        if sweeper is None:
            C, M = state.com.shape[:2]
            u = torch.zeros((C, M, N_UNIFORMS), dtype=self.dtype,
                            device=state.com.device)
            sweeper = MoveSweepGraph(
                self.move_bodies, state, u,
                graph=self.route == "move" and self.device.type == "cuda",
                nlist=self.params.nlist_width > 0)
            self._move_graphs[key] = sweeper
        return sweeper

    def run_steps(self, state, n_steps, adjust=False):
        """n_steps sweeps; with adjust, steer the step sizes toward the
        target acceptance after every sweep and reset the counters."""
        p = self.params
        for _ in range(n_steps):
            state = self.sweep(state)
            if adjust:
                # exact lists need dr_max <= nlist_skin / 2 (proposals
                # move +-dr_max / 2 per axis), sorted-slab windows
                # dr_max <= slab_skin
                dr_hi = state.box / 2.0
                if p.nlist_width > 0:
                    dr_hi = torch.clamp_max(dr_hi, p.nlist_skin / 2.0)
                if self._slab_cfg is not None:
                    dr_hi = torch.clamp_max(dr_hi, p.slab_skin)
                dr = adjust_dmax(state.dr_max, state.acc[:, 0],
                                 state.att[:, 0], p.move_accept, dr_hi)
                dphi = adjust_dmax(state.dphi_max, state.acc[:, 1],
                                   state.att[:, 1], p.move_accept, math.pi)
                dv = adjust_dmax(state.dv_max, state.acc[:, 2],
                                 state.att[:, 2], p.move_accept, 1.0)
                state = dataclasses.replace(
                    state, dr_max=dr, dphi_max=dphi, dv_max=dv,
                    acc=torch.zeros_like(state.acc),
                    att=torch.zeros_like(state.att))
        return state

    def pressure_fd(self, state, rel_eps=1e-4):
        """The pressure by a central finite difference of the total energy
        under isotropic COM scaling, P = M T / V - dU/dV at rigid
        molecules (two chunked full recomputes): the independent check of
        the closed-form virial carried in state.virial.  Returns (C,)
        pressures in K/A^3.  The difference of two energies needs the
        precision of the state's dtype: use float64."""
        def energy_at(scale):
            com = state.com * scale
            return self._energies(self.build_coords(com, state.quat), com,
                                  state.box * scale)[0]

        sp = (1.0 + rel_eps) ** (1.0 / 3.0)
        sm = (1.0 - rel_eps) ** (1.0 / 3.0)
        vol = state.box ** 3
        du_dv = (energy_at(sp) - energy_at(sm)) / (2.0 * rel_eps * vol)
        return self.system.n_mol * state.temp / vol - du_dv

    def quench(self, state, n_steps=20, temp=1e-6):
        """Descent at a near-zero temperature: n_steps sweeps in which only
        downhill moves are accepted (the reference's EnergyMinimize
        counterpart), then the original temperatures back and a resync."""
        t0 = state.temp
        state = dataclasses.replace(state, temp=torch.full_like(t0, temp))
        state = self.run_steps(state, n_steps, False)
        return self.resync(dataclasses.replace(state, temp=t0))

    def widom(self, state, n_insertions=64, species=0, generator=None):
        """Widom test-particle insertion (mc/widom.py): n_insertions
        uniform ghost poses of the given species per chain, drawn from
        `generator` (this object's when None).  Returns a dict with
        boltzmann_mean (C,), <exp(-beta dU)> over this sample (the
        quantity to average over a run, then pass to mu_excess), and mu_ex
        (C,), -kT ln of this sample's mean (diagnostic: the log of a noisy
        mean is biased)."""
        entry = self._widom_fns.get(species)
        if entry is None:
            _, entry = make_widom_fn(
                self.system, self.params, self.kvecs, self.kweights,
                self.device, dtype=self.dtype, species=species,
                chunk=self.recompute_chunk)
            self._widom_fns[species] = entry
        b = entry(state, self.generator if generator is None else generator,
                  int(n_insertions))
        return {"boltzmann_mean": b, "mu_ex": mu_excess(b, state.temp)}

    def widom_mega(self, state, n_per_sweep=64):
        """Widom sampling inside the sweep kernel: advances the state by
        one whole sweep and evaluates n_per_sweep ghost insertions in the
        same launch (mc/widom.py make_mega_widom_fn; needs the "sweep"
        route and one species).  Returns (state', dict) with widom()'s
        keys; the sweep and the Boltzmann factors use
        params.temperature."""
        if self.route != "sweep":
            raise ValueError(
                "widom_mega requires the whole-sweep route (this MonteCarlo "
                f"runs route {self.route!r}); use widom() for the plain "
                "path")
        n = int(n_per_sweep)
        if self._widom_mega_fn is None or self._widom_mega_n != n:
            self._widom_mega_fn = make_mega_widom_fn(
                self.system, self.params, self.kvecs, self.kweights, n,
                self.device)
            self._widom_mega_n = n
        state2, b = self._widom_mega_fn(state, self.generator)
        return state2, {"boltzmann_mean": b,
                        "mu_ex": mu_excess(b, self.params.temperature)}

    # ---------------- blocks ----------------

    def run_block(self, state, n_steps, adjust=False, drift_tol=None):
        """n_steps sweeps, then the recompute-vs-accumulated drift check
        and resync.  Returns (state, metrics dict of host floats)."""
        acc0, att0 = state.acc, state.att
        state = self.run_steps(state, n_steps, adjust)
        e, w, sfac = self.full_energy(state)
        drift = torch.max(torch.abs(e - state.energy)
                          / torch.clamp_min(torch.abs(e), 1.0))
        if self.params.nlist_width > 0:
            needed = int(torch.max(state.nbr_needed))
            if needed > self.params.nlist_width:
                raise RuntimeError(
                    f"neighbor-list overflow: up to {needed} molecules fell "
                    f"within the list radius during this block but "
                    f"nlist_width={self.params.nlist_width}; increase it")
        if self._slab_cfg is not None:
            needed = int(torch.max(state.nbr_needed))
            if needed > self._slab_cfg["W"]:
                raise RuntimeError(
                    f"sorted-slab window overflow: a molecule's "
                    f"z-neighbourhood needed {needed} columns but the "
                    f"window is W={self._slab_cfg['W']}; density "
                    f"fluctuations exceeded the sizing margin: set "
                    f"MMC_SLAB_W higher or slab_mode='off'")
        metrics = {
            "energy_mean": float(torch.mean(e)),
            "energy_min": float(torch.min(e)),
            "energy_max": float(torch.max(e)),
            "virial_mean": float(torch.mean(w)),
            "drift_max_rel": float(drift),
            "dr_max_mean": float(torch.mean(state.dr_max)),
            "dphi_max_mean": float(torch.mean(state.dphi_max)),
        }
        if not adjust:
            ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
            metrics["acc_trans"] = float(torch.mean(ratio[:, 0]))
            metrics["acc_rot"] = float(torch.mean(ratio[:, 1]))
            metrics["acc_vol"] = float(torch.mean(ratio[:, 2]))
        if self.params.coulomb != "ewald":
            sfac = state.sfac
        state = dataclasses.replace(state, energy=e, virial=w, sfac=sfac)
        if drift_tol is not None and metrics["drift_max_rel"] > drift_tol:
            raise RuntimeError(
                f"energy drift {metrics['drift_max_rel']:.3e} exceeds "
                f"{drift_tol}")
        return state, metrics
