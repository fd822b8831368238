"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  require CUDA; print the card's name and power limit.
Phase 1  build csrc/sweep_kernel.cu, csrc/delta_energy.cu,
         csrc/gibbs_kernel.cu, csrc/flip_kernel.cu and
         csrc/recompute_kernel.cu with nvcc for sm_90a,
         all at once (cached by a hash of each source under
         metropolismontecarlo_tpu_torch/_build); ptxas registers and spills
         of each instantiation (a spill of any instantiation of any kernel
         fails the run) and nvcc's seconds per source; the sweep kernel's
         blocks per SM at the main paths' shapes, and the delta-energy
         kernel's registers, local memory and blocks per SM at the
         per-move path's; registers, local memory and blocks per SM of
         every layout of the sweep, Gibbs and flip kernels (the global
         layouts at phase 24's shapes), each kernel's byte count held to
         its wrapper's.
Phase 2  each kernel against its plain PyTorch version on the card, on the
         same inputs.  The sweep kernel, one sweep on shared uniforms:
         SPC/E-64 (ewald, wolf, none; p_translate 0.5 and 0.0), LJ-256,
         the linear-shift triatomic-256, a two-block CO2/N2 mixture
         (32 + 32) and a ragged mixture (16 SPC/E + 16 one-site CH4, where
         a block's first atom column differs from m_start * P).  The
         delta-energy kernel on CO2/N2 mixtures' proposals, for every
         Coulomb style, at 32 + 32 (A_pad 256) and 160 + 40 (A_pad 768),
         and on its stress cases (`phase2_delta_stress`, 64 chains, states
         drawn on the CPU): every lane within reach and inside the
         cutoff, a dilute box, split cutoffs, SPC/E's H rows without LJ,
         one-site LJ (P = 1) and a 16-site ring (R = 32); a misaligned
         plane, which the wrapper and the launcher must refuse.
Phase 3  the flagship main path: 750 SPC/E waters, Ewald, 2048 chains
         through MonteCarlo.init_state and three run_blocks (one sweep
         kernel launch per sweep), the drift gate and sane acceptance
         checked; then the kernel against sweep_plain at this shape, and
         both timed.
Phase 4  the mixture main path: 600 CO2 + 150 N2 (TraPPE), Ewald, 37 A,
         2048 chains from a cubic lattice with every molecule along the
         cube diagonal, the whole-sweep route (two launches per sweep, one
         per species block) through three run_blocks; the same checks,
         the kernel against sweep_plain, one sweep of both timed.
Phase 5  the per-move route: the same mixture as one block of differing
         templates (species=None, which "auto" sends to the delta-energy
         kernel), from phase 4's end state: one eager sweep under
         torch.profiler (device time by kernel, busy time and idle gaps,
         wall time per move); the sweep's CUDA graph captured alone
         (time, launches recorded, device memory held); two run_blocks of
         one sweep on a fresh MonteCarlo, the first capturing the graph
         inside its sweep, the second replaying it, with M delta-energy
         launches per sweep (plus the capture's warm-up launches) and the
         drift gate; one graph sweep against one eager sweep on the same
         uniforms and state (coords, com, quat, sfac, energy, step, att
         and acc equal bit for bit), both timed, and the sweeps after
         which the capture has paid for itself; the eager sweep against
         one whole-sweep-route sweep on the same uniforms; delta_energy
         against its plain version on the main path's arguments (2048
         chains x 2304 lanes x 8 rows), one wrapper call (host time
         included: the kernels line's ms), one launch's device time
         (launches replayed from a graph: device_ms) and one plain call
         timed.

Phase 2 also holds the kernel's activity, exchange and Widom arguments
against sweep_plain (64 chains, shared uniforms and Philox scores): the
activity mask alone with about half the slots inactive; exchange attempts
for SPC/E/Ewald (with ghosts), the linear-shift triatomic, one-site LJ
with the tail correction (wc != 0), SPC/E with both Wolf styles, a full
and an empty chain among each; the two-block CO2/N2 case with (3, 2)
attempts; ghosts alone for SPC/E/Ewald and LJ.  And the tmmc deposits
(`phase2_tmmc`): SPC/E/Ewald, one-site LJ with the tail and SPC/E/Wolf,
each with the bias 0.35 N, against sweep_plain (cmat within 1e-4 of a
row's deposit count plus 1e-5 of its energy scale, beta pa x the
attempts' term magnitudes; equal counts; sum E and sum E^2 within 1e-5
of their scales), then with eta = 0 against the n_exch instantiation:
every decision, coordinate and S(k) equal.
Phase 6  the muVT main path: capacity-512 SPC/E, Ewald, 25 A, T = 500 K,
         z = 2.2e-4, p_exchange 0.3, 256 molecules at the start, 2048
         chains through MolGCMC(mega="full").run_block: one launch per
         cycle of 512 moves + 219 exchange attempts; the S(k) and drift
         gates, both exchange acceptances in (0, 1); then mega=True (kernel
         sweeps with the activity mask + plain exchange steps) from the same
         start, whose chain-mean N must agree with the full route's; one
         cycle and one masked sweep against sweep_plain, and timed.
Phase 7  a closed form through the kernel: the ideal rigid rotor (eps = q =
         0), capacity 64, box 8, z = 0.039: N is Poisson(z V = 19.97).
Phase 8  Widom: 256 SPC/E at phase 6's density and temperature, NVT;
         widom_mega(64) (a sweep and 64 ghosts per launch) against widom()
         on the same states; drift gate and attempt count after it.
Phase 9  the TMMC main path: capacity-512 SPC/E at phase 6's state point,
         2048 walkers stratified over N = 1..448, a fixed-N melt
         (MolGCMC p_exchange 0, mega=True, 2 x 1 sweep), then
         TMMCMol(mega="full") 3 x 2 cycles with the bias refreshed per
         block (one launch per cycle of 512 moves + 219 two-branch
         attempts): S(k), drift and acceptance gates, cmat rows filled on
         90% of N = 1..448; the hybrid route with eta = 0 against
         MolGCMC(mega=True) from one state and seed (256 chains, one
         cycle, every field equal); one cycle against sweep_plain; the
         cycle timed beside an n_exch launch on the same state.
Phase 10 closed forms and coexistence on the tmmc kernel: the ideal gas
         (TMMC, cap 48, box 5, z 0.08) and the ideal rigid rotor (TMMCMol,
         cap 64, box 8, z 0.039), ln Pi = N ln(zV) - ln N! within 1e-3;
         SPC/E vapour-liquid coexistence at 500 K by
         docs/validation_torch/run_tmmc_water.py's coexistence_run (the
         JAX script's protocol and gates: cap 80, box 13 A, 128 walkers,
         10 melt + 60 TMMC blocks of 2500 steps);
         cut LJ at T = 1.0 by the TMMC side of
         docs/validation/run_tmmc_coexistence.py (cap 192, box 6, 256
         walkers, 48 x 5000 steps) against the recorded Gibbs densities;
         one GCMC(mega="full") block of that LJ with its drift gate.
Phase 11 the large-system NVT main path: 6859 SPC/E waters (20577
         atoms, A_pad 20736) on a 19^3 lattice at the flagship's density,
         Ewald kappa L 11.711, nk 11, |k|^2 < 118 (K = 2874), slab_mode
         "auto" (W 12800 of 20577 columns at the start), 256 chains:
         init_state through the row-tiled recompute, a 2-sweep melt with
         adaptation, retune_slabs, a 2-sweep block with the drift gate and
         the window-coverage check (one global-layout launch per sweep);
         one sweep timed on the slab route and on the dense global layout
         (slab_mode "off") from the same state and uniforms; both against
         sweep_plain over the first 512 molecules of every chain; one
         sweep of the dense global route through run_block.
Phase 12 NPT at bench.py's "npt" parameters on the flagship lattice (750
         SPC/E, 1 bar, p_volume 0.05, dv_max 0.01), 2048 chains: a 20-sweep
         melt with adaptation and two 20-sweep blocks (drift gate, one
         volume attempt per chain per block, acc_vol in (0, 1)), <V>; then
         pressure_fd (float64, eps 1e-9) against the virial pressure
         M T / V + W / (3 V) of the final state: within 1 bar on >= 98%
         of chains, and their mean within the virial's chain-to-chain
         standard error.

Phase 13 the Gibbs main path at bench.py's "gibbs" configuration: SPC/E
         cap 128 x 2 (T 450 K, boxes 14.711 / 18.0 A with 85 + 21
         molecules, r_cut 6.620 A, Ewald tuned at 20.813 A: kappa L 8.263,
         nk 7, K 783, p_transfer 0.3, p_volume 0.002, dv_max 0.03), 1024
         chains through MolGibbsEnsemble(mega="full"): init, a 2-cycle
         melt block, two 2-cycle blocks (one Gibbs-kernel launch of 256
         moves + 110 transfers and one volume move per cycle; drift < 2e-3,
         S(k) error < 1e-4, N conserved on every chain, acc_transfer > 0,
         acc_vol in (0, 1)); one cycle on the main path's arguments against
         sweep_gibbs_plain (>= 98% of chains agree) and timed beside it and
         the bound, and at 128 and 512 threads per block; the volume
         move's share of a cycle (p_volume 0 against
         0.01, 512 chains, 8 cycles: scripts/probe_gibbs_volume_cost.py's
         protocol).
Phase 14 the physics gates of docs/validation/run_gibbs_kernel_exchange.py:
         [0] the ideal single-species Binomial partition through the
         kernel's transfers (cap 96, 64 molecules, boxes 8 / 11, 2048
         chains; mean and variance within 4 sigma); [2] SPC/E at 500 K,
         mega="full" against mega=True on <N_liq> (cap 48, boxes 12 / 16,
         256 chains) at the protocol's depth and gates.

Phase 15 the semigrand main path at bench.py's "semigrand" configuration:
         identical SPC/E blocks cap 64 + 64 (600 K, r_cut 8, box 20, the
         flagship Ewald), 32 + 32 molecules, xi 2, p_flip 0.3, 1024 chains
         through Semigrand(mega="full"): init, a 2-cycle melt and two
         2-cycle blocks (per cycle two sweep launches of 64 moves and one
         flip launch of 55 flips; drift < 2e-3, S(k) error < 1e-4, N_tot
         conserved on every chain, both flip acceptances in (0, 1));
         mega=True from the same start, whose <N_B> must agree within 4
         combined standard errors; one flip launch on the main path's own
         arguments against flip_plain (>= 98% of chains agree), timed beside
         it, the bound and a whole cycle.
Phase 16 the in-kernel segment of docs/validation/run_semigrand_binomial.py
         (identical SPC/E blocks cap 24 + 24, N_tot 16, xi 2, p_flip 0.5,
         256 chains, 3 + 8 blocks of 1200 steps): <N_B> within max(3%, 5
         s.e.) of 10.667, the variance within 20% of 3.556, drift < 2e-3.
Phase 17 docs/validation/run_binary_co2_n2.py through
         BinaryGCMC(mega="full") at the protocol's parameters (CO2/N2 caps
         96 + 96, 26 A, 300 K, z = (5e-4, 8e-4), p_exchange 0.4, 256
         chains, 8 + 8 blocks of 1500 steps), then NVT at the sampled
         composition with per-species MonteCarlo.widom: |beta mu_ex
         difference| < 0.1 per species, selectivity S > 1, S(k) error <
         1e-4, drift < 1e-2 and full fractions < 0.02 on every production
         block.
Phase 18 the run surface: main() of the port's run.py on the card, on
         three committed configs written to a temporary directory with
         their depth cut: configs/spce_750.json at full width (750 SPC/E,
         Ewald K 337, 512 chains) from a lattice start at its box 28.24 A
         (the NIST file is not in the repo), 3 blocks of 10 sweeps (1 of
         them equilibration) with a checkpoint every block and the O-O
         RDF, then a fourth block resumed from checkpoint.npz;
         configs/gcmc_spce_mega.json (1024 chains, cap 128, 2 blocks) and
         configs/gibbs_spce_mega.json (512 chains, 2 blocks).  Each run
         timed; its metrics.jsonl (one line per block, finite values,
         drift <= 2e-3, sfac_err_max < 1e-4 on the muVT and Gibbs lines,
         the flagship's carried S(k) within 1e-4 of each chain's S(k)
         norm, acceptances in (0.05, 0.95) after adjustment, insert,
         delete and transfer acceptances above 0), its output files and
         its kernel's launch count (above 0) checked.
Phase 19 `python -m metropolismontecarlo_tpu_torch.bench` for BENCH_CONFIG
         spce and gcmc at their defaults, each in a subprocess: the last
         line is JSON with bench.py's fields (read from bench.py), the line
         before it the run_block wall; both printed.

Phase 20 binary Gibbs CO2/N2 at docs/validation/run_gibbs_co2_n2.py's
         model and state point (co2_n2_system(96, 16), boxes 17 / 28 A,
         72 + 18 CO2 and 2 + 8 N2, 240 K, r_cut 7.5, no tail, Ewald tuned
         at 33 A to 5e-3: kappa L 10.13, nk 8, K 1152; p_transfer 0.35,
         p_volume 0.01, dv_max 0.04), 1024 chains through
         BinaryGibbsEnsemble(mega="full"): a 2-cycle warm-up and two
         2-cycle blocks (per cycle one Gibbs launch per species block, 224
         moves + 2 x 60 transfers, and 3 volume moves; drift < 2e-3, S(k)
         error < 1e-4, each species' N conserved on every chain, transfers
         of both species attempted with acceptances in (0, 1), acc_vol in
         (0, 1)); one cycle on the main path's arguments against
         sweep_gibbs_plain, each species launch timed and bounded; the
         volume attempt timed with the eik-recurrence S(k) and with the
         direct sum, and its share of a whole cycle; then one NPT-Gibbs
         cycle at run_gibbs_npt_co2_n2.py's bath (27.3 bar) and Ewald
         (kappa L 13.25, nk 12, K 3796) from the end state (drift gate,
         acc_vol > 0) with the kernel's occupancy at that shape.
Phase 21 osmotic MC at configs/osmotic_mea.json's state point with the MEA
         solute replaced by TraPPE CH4 (the topology is not in the repo):
         spce_methane_system(240, 16), 19.5 A, 313.15 K, r_cut 9, Ewald
         (K 337), z 1e-4, p_exchange 0.3, 4 solutes at the start, 1024
         chains through OsmoticGCMC(mega="full"): two 2-cycle blocks (the
         solvent block's sweep launch and the solute block's launch with
         110 exchange attempts per cycle; drift, S(k), every acceptance
         in (0, 1)), then one mega=True block from the end state; one full cycle on the main path's arguments against
         sweep_plain with the solvent plane unchanged, each launch timed.
Phases 20 and 21 print their launches on lines of their own (the kernels
line keeps phase 13's Gibbs row and the earlier sweep rows).  Phase 13
also times one volume attempt on its main path's state with the
eik-recurrence S(k) and with the direct sum in its place.

Phase 22 TIP4P/2005 (four sites, a massless, LJ-free, charged M site) at
         full width: tip4p2005_system(750) at the flagship's box 28.24 A,
         298.15 K, r_cut 10, Ewald (K 337), 2048 chains on the whole-sweep
         route: 10 sweeps with step-size adaptation and run_block(2)
         (drift <= 2e-3, carried S(k) within 1e-4 of each chain's norm,
         acceptance in (0.05, 0.95)), the kernel against sweep_plain
         (timed), one sweep timed beside its bound with A_pad, shared
         bytes and blocks per SM; one block of the per-move route at P = 4 on its CUDA
         graph (750 delta_energy launches of R = 8 rows per sweep) and
         delta_energy on its main-path arguments against its plain
         version, timed; docs/validation/run_tip4p_density.py's state
         point (216 waters, 128 chains, 1 bar, r_cut 9, p_volume 0.2),
         melted at fixed volume (500 sweeps at 600 K, 500 at 298.15 K),
         for 5 adjusting and 5 production blocks of 50 sweeps: the production
         density within 0.97-1.03 g/cc (loose: it catches a misplaced M
         charge, not a converged number), acc_vol in (0, 1); the CLI on a
         tip4p2005 config (216 waters, 64 chains, 2 blocks).
Phase 23 the topology front end on stand-in files that the phase writes
         (write_topology_files: TIP3P from the port's constants in an
         #include'd .itp with its [settles] branch, TraPPE-UA CH4 as a
         one-site MEA_DUMMY; the reference's topol.top, mea.pdb and
         tip3p.pdb are not in the repo): the CLI on configs/mea_tip3p.json's
         model and run sections with those paths (100 + 1900 molecules,
         64 chains, 2 blocks of 4 sweeps after 2 quench sweeps);
         bench.py's "mixture" setup with bench.REF pointed at them (256
         chains, 5800 atoms, two species-block launches per sweep): the
         layout, an adjust block and run_block(2) with the drift and S(k)
         gates, the sweep against sweep_plain (timed), each species-block
         launch timed, the sweep beside its bound, its System
         equal field by field to the config kind's from the same files;
         Verlet neighbour lists on 64 chains of that state: one block of
         one sweep on the list route (plain tensor code) against one on
         the dense plain route on the same uniforms (walls, the needed
         width, >= 98% of chains with equal decisions, energies within
         1e-5, drift), then nlist_width 2, which must raise RuntimeError.

Phase 2 also runs every kernel at P = 4 (`phase2_tip4p`, TIP4P/2005, 64
chains, the gates above): the sweep kernel's fixed-N instantiation
(translations and rotations), its activity instantiation with 8 exchange
attempts and 4 ghosts, its tmmc instantiation (and eta = 0 against
n_exch); delta_energy at R = 8 rows; one Gibbs cycle of TIP4P/2005 cap 48
x 2 (K 1152); one flip launch between a TIP4P/2005 and a TIP4P/Ice block
(32 + 32).  The Gibbs cycle and the flip launch are then timed at 1024
chains beside their plain versions and bounds, with their registers,
local memory and blocks per SM.

Phase 2 also holds the sweep kernel's queues of live pair terms against
sweep_plain (`phase2_compaction`, 64 chains, the gates above): SPC/E-64
with Wolf at r_cut above L sqrt(3) / 2 (every site pair inside the
cutoff, every queue full on every chunk), a dilute SPC/E-64 box with no
pair inside the cutoff, split LJ and Coulomb cutoffs (4.5 / 6 A),
alternating active and inactive slots with 4 exchange attempts and 2
ghosts, and SPC/E-33 (99 atoms in A_pad 128: a warp's chunk ends inside
the atoms and four warps scan nothing).

Phase 2 also holds the flip kernel against flip_plain (`phase2_flip`, 64
chains, 24 flips, shared uniforms and Philox scores, chain 0 with no
molecule and chain 1 with both blocks full): identical SPC/E blocks 32 +
32 under Ewald, Wolf, reference Wolf and bare Coulomb, and the ragged
one-site LJ + bent-triatomic blocks with unequal eps and the LJ tail; at most 2 of 64
chains may differ, energies within 1e-5 of the flips' term magnitudes,
S(k) within 1e-5 of its norm, N conserved, chains 0 and 1 unchanged.

Phase 2 also holds the Gibbs kernel against sweep_gibbs_plain
(`phase2_gibbs`, 64 chains, unequal boxes, shared uniforms and Philox
scores, one chain with an empty source box and one with a full
destination box): SPC/E cap 32 with Ewald and with Wolf, the
linear-shift triatomic cap 16 without charges, LJ cap 64, a two-block
CO2/N2 case (24 + 8) through m_start / a_start, and SPC/E cap 32 with the
linear LJ shift under Ewald and Wolf and with bare Coulomb with and
without it (every instantiation of the kernel runs); at most 2 of 64 chains
may differ, energies within 1e-5 of the cycle's term magnitudes, S(k)
within 1e-5 of its norm, N conserved on every chain.  And one binary
cycle through mc/moves.make_mega_gibbs_binary_fn (`phase2_gibbs_binary`,
CO2/N2 24 + 8, one launch per species block with the planes threaded)
against the same cycle with sweep_gibbs_plain, by the same gates.

Phase 2 also holds both kernels against their twins on stress cases
(`phase2_gibbs_stress`, `phase2_flip_stress`, 64 chains each, the gates
above; the states are drawn on the CPU and moved to the card, so the CPU
tests check the same ones): every site pair inside the cutoff, none inside
it, split LJ and Coulomb cutoffs, a Gibbs box whose reach ring holds every
atom, one active slot in a Gibbs box and in a flip species block.

Phase 2 also holds the global layout (`phase2_global`): on SPC/E-64,
LJ-256 and the two-block CO2/N2 case the global-layout launch against the
shared-layout launch (every output compared bit for bit; the count of
chains that differ is printed) and against sweep_plain; forced sorted
slabs against sweep_plain with slabs, with the ghost halo checked after
the sweep: LJ-640 in a 32 box from a stratified start (W 512 < 640),
SPC/E-512 at r_cut 4.5 from a z-sheared lattice and CO2 + N2 64 + 576 with
the N2 block sorted.

Phase 2 also holds the global layouts against the shared one
(`phase2_layouts`, 64 chains, forced layouts, every output compared bit
for bit, each launch timed in each layout in turns): the sweep kernel's
activity, exchange and Widom cases above, its tmmc cases (SPC/E and LJ,
eta 0.35 N and 0, cmat and uhist included; and eta = 0 against the n_exch
instantiation on each global layout), the Gibbs kernel on bench's cap-128
x 2 shape and the TIP4P/2005 cap 48 x 2 case, the flip kernel on bench's
64 + 64 shape and the TIP4P/2005 + TIP4P/Ice 32 + 32 case; and
`phase2_global` compares global_k with the shared layout (fixed N) and
with the global layout (slabs).  Phase 20 times the NPT-Gibbs cycle's two
launches (K 3796) in each layout, in turns, with the same bit-for-bit
check.

Phase 24 the states that fit no shared layout (the JAX kernels run them),
         each through its driver's entry point with mega="full", each
         block gated (drift <= 2e-3, the carried S(k) within 1e-4 of the
         smallest chain S(k) norm, move acceptance in (0.05, 0.95),
         exchange, transfer, volume and flip acceptance in (0, 1)), one
         launch held to its plain version (>= 98% of chains with its
         decisions) and timed beside it and its bound, the whole-width
         launch timed with its bound.  The held launches: (a), (b) all
         moves and 219 attempts on the first 128 chains (the plain
         version steps through every slot and attempt: ~16-18 s so),
         (c) the whole cycle and (d) the whole launch on the
         first 128 chains, (e) the first 512 moves of every chain,
         Widom the first 512 moves and 64 ghosts of every chain:
         (a) capacity-4096 SPC/E muVT, 50 A, 500 K, z 2.2e-4, r_cut 10,
         Ewald to 1e-3 (kappa L 13.14, nk 11, K 2975), p_exchange 0.3
         (1755 attempts per cycle), 1024 molecules at the start, 256
         chains through MolGCMC: a melt cycle and two 1-cycle blocks on
         the activity instantiation's global layout; one
         MonteCarlo.widom_mega(state, 64) on 4096 waters from a lattice in
         the same box (64 chains) and its drift;  (b) TMMCMol at (a)'s shape, one block of one cycle on
         the tmmc global layout, every attempt deposited;  (c) bench's
         Gibbs recipe at cap 1024 (682 + 170 molecules, 29.45 / 36.0 A,
         450 K, r_cut 7.5, Ewald to 1e-3 at 41.64 A: nk 13, K 4849,
         p_transfer 0.3, p_volume 0.002), 256 chains through
         MolGibbsEnsemble, two 1-cycle blocks on the Gibbs global layout,
         N conserved;  (d) bench's semigrand recipe at 16x the volume
         (1024 + 1024 slots, 512 + 512 molecules, 50.4 A, 600 K, r_cut 8,
         Ewald to 1e-3: nk 14, K 6062), xi 2, p_flip 0.3, 256 chains
         through Semigrand, two 1-cycle blocks (the flips on the flip
         global layout, the sweeps on the activity global layout);  (e)
         phase 11's 6859 waters at tol 1e-5 (kappa L 20.04, nk 22, K
         22,994), slabs on, 64 chains through MonteCarlo (recompute_chunk
         2), one block of one sweep on the fixed-N global_k layout.  The
         kernels line gains a row per new layout.
Phase 25 the parallel layer (parallel/), its ranks gloo processes on this
         one card (NCCL refuses two ranks on one device), started by
         parallel/mesh.py run_world after phase 1 built the kernels:
         (a) the flagship (750 SPC/E, Ewald, 2048 chains) split over 2
         ranks: a sharded init_state, sharded_run_steps of 2 sweeps on the
         whole-sweep kernel, then replica exchange every sweep over a
         250-400 K ladder for 2 rounds; every element of coords, com,
         quat, S(k), energy, acc and att equal to the unsharded run of the
         same 2048 chains (init_state, run_steps, run_steps(1) + exchange
         with phases 0 and 1) and the swap fractions equal and in (0, 1);
         (b) the sweep kernel with 8 exchange attempts, the Gibbs kernel
         and the flip kernel at phase 2's shapes (SPC/E-64 Ewald, cap 32
         x 2, 32 + 32; 64 chains): a launch on rows [32, 64) with chain0 =
         32 equals those rows of the whole launch bit for bit, with
         chain0 = 0 it differs, and the offset launch holds to its plain
         version as in phase 2;  (c) the tensor-parallel recompute on a
         2 x 2 (chains x atoms) mesh of 4 ranks at the flagship's width
         (64 chains, recompute chunk 8): energies within 1e-5 (relative,
         f32) of the unsharded recompute, MonteCarlo(tp_mesh=...)
         .run_block(1) within the drift gate;  (d) (a) at 512 chains and
         one TP recompute (1 x 1 mesh, 64 chains) in a world of one NCCL
         rank;  (e) the ensemble drivers, 256 chains over 2 ranks: muVT
         (mega "full" and True) and TMMC ("full", per-chain starts) at
         phase 6's shape, bench's Gibbs with a volume move per cycle, its
         semigrand and phase 17's CO2/N2 muVT ("full"), each init under
         pm.chain_shard and run by pm.sharded_call: every element of every
         state field (and TMMC's cmat and uhist) equal to the unsharded
         run's, the kernels launched with chain0 = the rank's first
         chain.  Each part prints its wall time, per-rank sweep, cycle,
         exchange round and recompute times; the card's name and power
         limit.
Phase 26 the two-particle Boltzmann density through the sweep kernel
         (docs/validation_torch/run_mega_boltzmann.py's protocol: two LJ
         particles, T 1.2, box 8, rc 3.9, 512 chains, 100 + 80 x 5
         sweeps, the kernel route and the plain route on the card): the
         pair-distance histogram against the analytic r^2 exp(-u/T)
         (chi^2 per bin < 9, peak bin within 3), the two routes'
         acceptance within 0.02, every run_steps call on fresh uniforms;
         the phase's wall time.
Phase 27 the staged-FEP path (mc/fep.py) at
         docs/validation_torch/run_bar_water.py's state point: the tagged
         system tag_last_molecule(spce_system(217), 0.4, 0), whose last
         water is a one-molecule species block, box 18.644 A, r_cut 8.4
         A + LRC, 256 chains: init_state and one run_block of 5 sweeps
         (route and launches printed, the drift gate); the kernel against
         sweep_plain on shared uniforms at 64 chains (the one-molecule
         block's launch, phase 2's gates); make_deletion_fn at the four
         lambda-basis systems and at the rung's own, the basis identity
         lambda_work(0.4, 0, *lambda_basis(...)) = the direct work within
         1e-5 of the terms' magnitude; one make_decoupled_insertion_fn
         call at lambda 0 on the same configurations, finite works
         outside its overlap mask; the phase's wall time.
Phase 28 the full-energy recompute kernel (csrc/recompute_kernel.cu) at
         the benchmark's flagship (750 SPC/E, 2048 chains) and
         TIP4P/2005-750 (1024 chains) shapes, chains at boxes 0.99-1.01
         of 28.24 A: one launch per recompute, the kernel and the chunked
         plain route timed on the same states, both against
         energy_breakdown in float64 on 16 chains (energy and virial
         within 2e-5 of max(|E|, |E_self|), S(k) within 1e-4 of the sum of
         |q|, for the kernel), the kernel against the plain float32 route
         on every chain (twice those limits), registers, shared bytes,
         blocks per SM and its share of recompute_bound; a run_block of
         one sweep whose recompute is one launch, counted from zero.

Tolerances.  Sweep kernel vs plain (and the per-move route vs the whole
sweep): at least 98% of chains take identical accept decisions, judged
by equal acc/att counts and an equal decision fingerprint (the sum of
accepted global move indices + 1): one f32-borderline decision makes a
chain diverge, so divergent chains are counted, not compared.  On the
other chains coordinates and COMs agree within 1e-3 A, the summed energy
delta within 1e-5 of the sweep's energy scale (sweep_plain's magnitude
column: the summed magnitudes of the terms the accepted moves' deltas
add up, which f32 rounds), and S(k) within 1e-4 of its norm (floored
at 1 e, a molecule's charge scale: a muVT chain that emptied holds only
the rounding residue of its exchanges' S(k) rows).
Delta-energy kernel vs plain: the move's energy change (new rows - old
rows) within 1e-5 of the move's energy scale (the rows' |LJ| sums plus
their Coulomb term magnitudes), each row's e_coul within 1e-5 of its
term magnitudes (CUDA's erfcf against torch's erfc, f32), overlap counts
equal.  With exchanges and ghosts the same rule holds, the decision
counts including the exchange counters; matched chains also have equal
activity planes, quaternions within 1e-3 and Widom sums within 1e-3
(relative: w = exp(-du / T) turns an error of du into that error over T
of w; measured ~3e-5 for water at 500 K).  Every
phase raises on failure, so the script exits non-zero; the
line before the last lists every kernel with its launches on its main
path, error, time, plain time and bound (delta_energy's time is a wrapper
call's, host time included; its device_ms is a launch's device time); the
last line of a passing run is the device JSON.
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

MATCH_FRACTION = 0.98
POS_TOL = 1e-3
ENERGY_REL_TOL = 1e-5      # of the energy scale of a move or a sweep
SFAC_REL_TOL = 1e-4
SFAC_ABS_TOL = 1e-4        # carried S(k) against its recompute, muVT blocks
SFAC_NORM_FLOOR = 1.0      # e; the least S(k) norm SFAC_REL_TOL scales by
DRIFT_TOL = 2e-3

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations counted per distance and per pair term, from the kernels'
# code: a minimum-image distance (3 sub, 3 x mul/rint/fma, 5 for d^2,
# floor, rsqrt, cutoff test) once per (atom lane, pose) to the pose's
# centre and once per (atom lane, site) for the atoms within the pose's
# reach (_reach_fraction: the others cannot hold a pair inside the
# cutoff); the LJ term (1/d^2, s^2, s^6, s^12 - s^6, eps, accumulate) and
# the Coulomb term (r, kappa r, erfc as ~12, / r, q q, accumulate) for
# pairs inside the cutoff only
OPS_GEOMETRY, OPS_LJ, OPS_COULOMB = 20, 8, 17
# k-space by per-site eik tables (the Gibbs and flip kernels' algorithm;
# structure_factor's eikx/eiky/eikz): per charged site of a pose three rows
# e^{i 2 pi n x / L}, |n| <= nk, each one sincos (the phase and its
# reduction 5, sincospif ~8) and nk complex products (4 each); per
# k-vector and charged site two complex products and the accumulation (8);
# per k-vector and move the energy cross term (8)
OPS_SINCOS, OPS_CMUL, OPS_K_SITE, OPS_K_MOVE = 13, 4, 8, 8
# per candidate slot of a deletion pick: 10 Philox rounds of two 32 x 32
# products (high and low words), three xors and two key additions
OPS_PHILOX = 90
WIDOM_REL_TOL = 1e-3
DEPOSIT_TOL = 1e-4         # cmat, of the row's deposit count (+ its
#   energy scale's ENERGY_REL_TOL: the f32 error of a deposit exp(ln_acc)
#   is beta pa x the error of du, which the terms' magnitudes set)

STRESS_CHAINS = 64         # chains of each phase 2 stress case
SRC = "metropolismontecarlo_tpu_torch/csrc"
PALLAS = "metropolismontecarlo_tpu/ops/pallas"


def phase0():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase0 device: {name}")
    print(f"phase0 nvidia-smi: {smi}")
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return name, smi


def phase1():
    from metropolismontecarlo_tpu_torch.ops.cuda import (
        build,
        delta_energy,
        flip_kernel,
        gibbs_kernel,
        recompute_kernel,
        sweep_kernel,
    )

    names = ("sweep_kernel", "delta_energy", "gibbs_kernel", "flip_kernel",
             "recompute_kernel")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
    # the sweep kernel's template instantiations <kAct, kTmmc, kLayout> by
    # mangled name (the template's arguments end in "EE")
    labels = {}
    for a, t, kind in ((0, 0, "fixed N"), (1, 0, "activity"),
                       (1, 1, "tmmc")):
        for lay, layout in enumerate(sweep_kernel.LAYOUTS):
            labels[f"ILb{a}ELb{t}ELi{lay}EE"] = \
                f"<{bool(a)}, {bool(t)}, {layout}> {kind}".lower()
    # the Gibbs kernel's <Coulomb form, linear LJ shift, global> and the
    # flip kernel's <Coulomb form, global> instantiations (the global ones
    # serve the global and global_k layouts), and the delta-energy
    # kernel's <Coulomb form>
    for q, form in enumerate(("none", "erfc", "wolf", "bare")):
        for g, where in ((0, ""), (1, ", global")):
            labels[f"12gibbs_kernelILi{q}ELb0ELb{g}EE"] = \
                f"two-box Gibbs <{form}{where}>"
            labels[f"12gibbs_kernelILi{q}ELb1ELb{g}EE"] = \
                f"two-box Gibbs <{form}, linear LJ{where}>"
            labels[f"11flip_kernelILi{q}ELb{g}EE"] = \
                f"semigrand flips <{form}{where}>"
        labels[f"19delta_energy_kernelILi{q}E"] = f"delta energy <{form}>"
    # the recompute kernel's <Ewald, linear LJ shift>
    for e in (0, 1):
        for lin in (0, 1):
            labels[f"16recompute_kernelILb{e}ELb{lin}EE"] = \
                f"recompute <{'ewald' if e else 'none'}" \
                f"{', linear LJ' if lin else ''}>"
    spills = []
    for name, (path, seconds, log) in zip(names, builds):
        print(f"phase1 built {path.name} in {seconds:.2f} s (nvcc, all "
              f"five sources at once)")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = next((v for k, v in labels.items() if k in line),
                             line.split("'")[1] if "'" in line else "")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"phase1 ptxas {name} {entry}: {line.strip()}")
            if "spill" in line and not ("0 bytes spill stores" in line
                                        and "0 bytes spill loads" in line):
                spills.append(f"{name} {entry}: {line.strip()}")
    sweep_kernel._library()
    delta_energy._library()
    gibbs_kernel._library()
    flip_kernel._library()
    recompute_kernel._library()
    # the delta-energy kernel at the per-move main path's shape (R 8 rows,
    # T 4 types) as the runtime reports it
    threads = delta_energy.THREADS
    smem = delta_energy._library().mmc_delta_smem_bytes(8, 4, threads)
    for style in ("none", "ewald", "wolf", "bare"):
        regs, local, blocks = delta_energy.occupancy(style, 8, 4)
        print(f"phase1 occupancy delta_energy <{style}> {threads} threads: "
              f"{regs} registers, {local} B local, {smem} B of shared "
              f"memory, {blocks} blocks per SM")
    # blocks per SM of the sweep kernel at the main paths' shapes (the
    # flagship, capacity-512 muVT and TMMC, the 6859-water global layout),
    # and the shared-memory layout as the kernel counts it against
    # smem_bytes, which choose_layout decides from
    for tag, shape in (
            ("flagship fixed N", (750, 3, 2304, 337, 2, False, False,
                                  "shared")),
            ("muVT cap 512", (512, 3, 1536, 337, 2, True, False, "shared")),
            ("tmmc cap 512", (512, 3, 1536, 337, 2, True, True, "shared")),
            ("6859 waters global", (6859, 3, 33408, 2874, 2, False, False,
                                    "global")),
            ("tip4p2005-750 fixed N (P 4)", (750, 4, 3072, 337, 2, False,
                                             False, "shared")),
            ("tip4p2005-64 tmmc (P 4)", (64, 4, 256, 337, 2, True, True,
                                        "shared")),
            ("topology mixture 100 + 1900", (2000, 3, 5888, 337, 4, False,
                                             False, "shared"))):
        nbytes = sweep_kernel.smem_bytes(*shape)
        print(f"phase1 occupancy sweep_kernel {tag}: {nbytes} B of shared "
              f"memory, {sweep_kernel.blocks_per_sm(*shape)} blocks per SM")
        M, P, A_pad, K, T, use_act, tmmc, layout = shape
        kernel_bytes = sweep_kernel._library().mmc_sweep_smem_bytes(
            M, P, A_pad, K, T, int(use_act), int(tmmc),
            sweep_kernel.LAYOUT_CODES[layout])
        if kernel_bytes != nbytes:
            raise AssertionError(f"{tag}: csrc/sweep_kernel.cu counts "
                                 f"{kernel_bytes} B, smem_bytes {nbytes} B")
    phase1_layouts()
    if spills:
        raise AssertionError(f"a kernel instantiation spills: {spills}")


# phase 24's states: capacity-4096 SPC/E muVT and TMMC in a 50 A box
# (r_cut 10, Ewald to 1e-3), 6859 waters at tol 1e-5, bench's Gibbs recipe
# at cap 1024 (tuned at the 41.64 A box a volume move reaches), its
# semigrand recipe at 16x the volume (50.4 A, r_cut 8)
BIG_EWALD = {"muvt": (50.0, 10.0, 1e-3), "bulk": (59.056, 10.0, 1e-5),
             "gibbs": (41.64, 7.5, 1e-3), "semigrand": (50.4, 8.0, 1e-3)}


def big_k(name):
    """(kappa_L, nk, ksq_max, K) of a BIG_EWALD state."""
    from metropolismontecarlo_tpu_torch.ops.ewald import (
        make_kvectors,
        tune_parameters,
    )

    kl, nk, ksq = tune_parameters(*BIG_EWALD[name])
    return kl, nk, ksq, len(make_kvectors(nk, ksq)[0])


def phase1_layouts():
    """Registers, local memory and blocks per SM of every layout of the
    sweep, Gibbs and flip kernels, at phase 24's shapes for the global
    layouts (and forced global_k at the same shapes) and phase 2's for the
    shared ones, the byte counts of the kernels against the wrappers'."""
    from metropolismontecarlo_tpu_torch.ops.cuda import (
        flip_kernel,
        gibbs_kernel,
        sweep_kernel,
    )

    K_m, K_b = big_k("muvt")[3], big_k("bulk")[3]
    _, nk_g, _, K_g = big_k("gibbs")
    _, nk_s, _, K_s = big_k("semigrand")
    for kind, use_act, tmmc in (("fixed N", False, False),
                                ("activity", True, False),
                                ("tmmc", True, True)):
        for layout in sweep_kernel.LAYOUTS:
            shape = (750, 3, 2304, 337, 2) if layout == "shared" else \
                (6859, 3, 33408, K_b if layout == "global_k" else 2874, 2) \
                if kind == "fixed N" else (4096, 3, 12288, K_m, 2)
            if layout == "shared" and use_act:
                shape = (512, 3, 1536, 337, 2)
            regs, local, per_sm = sweep_kernel.occupancy(
                *shape, use_act, tmmc, layout)
            nbytes = sweep_kernel.smem_bytes(*shape, use_act, tmmc, layout)
            print(f"phase1 occupancy sweep_kernel <{kind}, {layout}> at "
                  f"M {shape[0]}, A_pad {shape[2]}, K {shape[3]}: {regs} "
                  f"registers, {local} B local, {nbytes} B of shared "
                  f"memory, {per_sm} blocks per SM")
    out = (ctypes.c_int * 3)()
    for q, form in ((0, "none"), (1, "ewald"), (2, "wolf"), (4, "bare")):
        for lin in (0, 1):
            for layout in gibbs_kernel.LAYOUTS:
                shape = (128, 3, 512, 783, 2, 7) if layout == "shared" \
                    else (1024, 3, 3072, K_g, 2, nk_g)
                err = gibbs_kernel._library().mmc_gibbs_occupancy(
                    q, lin, *shape, gibbs_kernel.LAYOUT_CODES[layout], out)
                nbytes = gibbs_kernel.gibbs_smem_bytes(*shape, layout)
                if err or gibbs_kernel._library().mmc_gibbs_smem_bytes(
                        *shape, gibbs_kernel.LAYOUT_CODES[layout]) != nbytes:
                    raise AssertionError(f"gibbs occupancy query: error "
                                         f"{err} or a byte count differs")
                print(f"phase1 occupancy gibbs_kernel <{form}"
                      f"{', linear LJ' if lin else ''}, {layout}> at m_off "
                      f"{shape[0]}, K {shape[3]}: {out[0]} registers, "
                      f"{out[1]} B local, {nbytes} B of shared memory, "
                      f"{out[2]} blocks per SM")
        for layout in flip_kernel.LAYOUTS:
            shape = (128, 3, 3, 512, 337, 2, 5) if layout == "shared" \
                else (2048, 3, 3, 6144, K_s, 2, nk_s)
            err = flip_kernel._library().mmc_flip_occupancy(
                q, *shape, flip_kernel.LAYOUT_CODES[layout], out)
            nbytes = flip_kernel.flip_smem_bytes(*shape, layout)
            if err or flip_kernel._library().mmc_flip_smem_bytes(
                    *shape, flip_kernel.LAYOUT_CODES[layout]) != nbytes:
                raise AssertionError(f"flip occupancy query: error {err} "
                                     f"or a byte count differs")
            print(f"phase1 occupancy flip_kernel <{form}, {layout}> at M "
                  f"{shape[0]}, K {shape[4]}: {out[0]} registers, {out[1]} "
                  f"B local, {nbytes} B of shared memory, {out[2]} blocks "
                  f"per SM")


def _sweep_args(state, u):
    f32 = torch.float32
    return [x.to(f32).contiguous() for x in (
        state.coords, state.com, state.quat, state.sfac, state.box,
        state.temp, state.dr_max, state.dphi_max)] + [u]


def _check_match(tag, C, same, k, p, e_scale):
    """The shared tolerance test of two one-sweep results k and p, each
    (coords, com, sfac, stats (C, >= 1) with the energy delta first) on
    the chains `same` that took identical decisions; e_scale (C,) is the
    sweep's energy scale (sweep_plain's magnitude column)."""
    n_diff = int((~same).sum())
    if float(same.float().mean()) < MATCH_FRACTION:
        raise AssertionError(f"{tag}: {n_diff}/{C} chains took different "
                             f"decisions")
    pos = max(float((k[0] - p[0])[same].abs().max()),
              float((k[1] - p[1])[same].abs().max()))
    e_rel = float(((k[3][:, 0] - p[3][:, 0]).abs()
                   / e_scale.clamp_min(1.0))[same].max())
    # floored at 1 e, a molecule's charge scale: a chain that emptied
    # carries only the rounding residue of its exchanges' rows
    s_norm = torch.clamp_min(torch.linalg.vector_norm(
        p[2].flatten(1), dim=1), SFAC_NORM_FLOOR)
    s_rel = float(((k[2] - p[2]).flatten(1).abs().max(dim=1).values
                   / s_norm)[same].max())
    finite = all(bool(torch.isfinite(x).all()) for x in k)
    print(f"phase {tag}: chains {C}, differing {n_diff}, coord/com err "
          f"{pos:.3e} A, energy err {e_rel:.3e} of the sweep's energy "
          f"scale, S(k) rel err {s_rel:.3e}")
    if not (finite and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= SFAC_REL_TOL):
        raise AssertionError(f"{tag}: the two disagree")
    return pos


def compare(tag, mc, state, gen):
    """One sweep of the kernel and of sweep_plain on the same uniforms,
    one launch per species block; returns the largest coordinate
    difference on matched chains."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = state.com.shape[:2]
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    k = sweep_blocks(op.sweep, *args, mc.tables)
    p = sweep_blocks(functools.partial(op.sweep_plain, magnitude=True),
                     *args, mc.tables)
    torch.cuda.synchronize()
    same = (k[4][:, 1:] == p[4][:, 1:op.N_STATS]).all(dim=1)
    print(f"phase {tag}: acc/att {k[4][:, 1:5].sum(0).tolist()}")
    return _check_match(tag, C, same, (k[0], k[1], k[3], k[4]),
                        (p[0], p[1], p[3], p[4]), p[4][:, op.N_STATS])


def _exchange_consts(system, params, kvecs, kweights, box):
    """Per species block (si, wc): the self + intra constant and the
    quadratic-in-N coefficient (reference Wolf c Q^2 plus the LJ tail) of
    the exchange energy, each (C,)."""
    from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval

    out = []
    for b in range(len(system.species_slices)):
        ev = make_pose_eval(system, params, kvecs, kweights, box.device,
                            torch.float32, species=b)
        out.append((ev.self_intra(box).contiguous(),
                    (ev.wolf_const_coeff(box) * ev.q_t_tot ** 2
                     + ev.lrc_self_coeff(box)).contiguous()))
    return out


def run_variant(op_fn, args, tables, act, actm, n_exchs, n_widoms, uxs, z,
                consts, seed, tmmc=None, chain0=0):
    """One launch per species block of the sweep op `op_fn` with the
    activity planes and each block's attempts, threading the state; returns
    (coords, com, quat, sfac, stats summed, act, actm, wid (C, blocks, 2));
    with tmmc = (eta, e_in) (one block) the attempts deposit, and the op's
    (cmat, uhist[, umag]) follow.  chain0: the Philox scores' global index
    of chain 0."""
    args = list(args)
    stats, wids, deposits = None, [], ()
    for b, t in enumerate(tables):
        extra = {}
        if n_exchs[b] or n_widoms[b]:
            extra = dict(n_exch=n_exchs[b], n_widom=n_widoms[b], ux=uxs[b],
                         z=z, si=consts[b][0], wc=consts[b][1], seed=seed + b,
                         chain0=chain0)
            if tmmc is not None:
                extra.update(tmmc=True, eta=tmmc[0], e_in=tmmc[1])
        out = op_fn(*args, t, act=act, actm=actm, **extra)
        args[:4], (st, act, actm, wid) = out[:4], out[4:8]
        deposits = out[8:]
        stats = st if stats is None else stats + st
        wids.append(wid)
    return tuple(args[:4]) + (stats, act, actm,
                              torch.stack(wids, 1)) + deposits


def compare_variant(tag, system, args, tables, act, actm, n_exchs, n_widoms,
                    uxs, z, consts, seed, tmmc=None, plain_ms=None, chain0=0):
    """The kernel against sweep_plain on the same arguments with activity
    planes, exchange attempts and ghosts (and with tmmc = (eta, e_in) the
    deposits); returns the largest coordinate difference on matched
    chains.  plain_ms: a list that receives the plain call's ms."""
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    rest = (tables, act, actm, n_exchs, n_widoms, uxs, z, consts, seed)
    k = run_variant(op.sweep, args, *rest, tmmc=tmmc, chain0=chain0)
    out = []
    ms = _time_ms(lambda: out.append(run_variant(
        functools.partial(op.sweep_plain, magnitude=True), args, *rest,
        tmmc=tmmc, chain0=chain0)), 1)
    p = out[0]
    if plain_ms is not None:
        plain_ms.append(ms)
    torch.cuda.synchronize()
    C = act.shape[0]
    same = (k[4][:, 1:] == p[4][:, 1:op.N_STATS]).all(dim=1)
    print(f"phase {tag}: acc/att moves {k[4][:, 1:5].sum(0).tolist()}, "
          f"acc ins/del, att ins {k[4][:, 5:8].sum(0).tolist()}, "
          f"N {actm.sum(1).mean().item():.2f} -> "
          f"{k[6].sum(1).mean().item():.2f}")
    # inactive slots hold stale coordinates on both sides: compared too
    pos = _check_match(tag, C, same, (k[0], k[1], k[3], k[4]),
                       (p[0], p[1], p[3], p[4]), p[4][:, op.N_STATS])
    q_err = float((k[2] - p[2])[same].abs().max())
    planes_equal = torch.equal(k[5][same], p[5][same]) \
        and torch.equal(k[6][same], p[6][same])
    w_rel = float(((k[7] - p[7]).abs()
                   / p[7].abs().clamp_min(1e-30))[same].max())
    print(f"phase {tag}: quat err {q_err:.3e}, activity planes equal "
          f"{planes_equal}, Widom sums rel err {w_rel:.3e} (largest sum "
          f"{float(p[7].max()):.3e})")
    if not (q_err <= POS_TOL and planes_equal and w_rel <= WIDOM_REL_TOL
            and bool(torch.isfinite(k[7]).all())):
        raise AssertionError(f"{tag}: the two disagree")
    if tmmc is not None:
        check_deposits(tag, same, k[8:10], p[8:11])
    return pos


def check_deposits(tag, same, k, p):
    """The kernel's (cmat, uhist) against the plain version's (cmat,
    uhist, umag) on the matched chains: equal deposit counts, cmat within
    DEPOSIT_TOL of each row's count plus ENERGY_REL_TOL of its energy
    scale (umag: how far a relative error of the attempts' energy terms
    moves the deposits, beta pa x the terms' magnitudes), sum E and sum
    E^2 within ENERGY_REL_TOL of their scales."""
    (cm_k, uh_k), (cm_p, uh_p, umag) = k, p
    count = uh_p[..., 0]
    counts_equal = torch.equal(uh_k[..., 0][same], count[same])
    cm_tol = DEPOSIT_TOL * count + ENERGY_REL_TOL * umag[..., 2]
    cm_diff = (cm_k - cm_p).abs().amax(-1)
    cm_rel = float((cm_diff / cm_tol.clamp_min(1e-30))[same].max())
    cm_err = float((cm_diff / count.clamp_min(1.0))[same].max())
    e_err = [float(((uh_k[..., i] - uh_p[..., i]).abs()
                    / umag[..., i - 1].clamp_min(1e-30))[same].max())
             for i in (1, 2)]
    print(f"phase {tag}: deposits {float(count.sum()):.0f}, counts equal "
          f"{counts_equal}, cmat err {cm_err:.3e} of the row's count "
          f"({cm_rel:.3f} of its tolerance), sum E err {e_err[0]:.3e}, sum "
          f"E^2 err {e_err[1]:.3e} of their scales; up "
          f"{float(cm_k[..., 1].sum()):.3f}, down "
          f"{float(cm_k[..., 2].sum()):.3f}")
    if not (counts_equal and cm_rel <= 1.0
            and max(e_err) <= ENERGY_REL_TOL
            and all(bool(torch.isfinite(x).all()) for x in k)):
        raise AssertionError(f"{tag}: the deposits disagree")


def _variant_params():
    """(box_w, box_lj, water(**kw), lj): phase 2's muVT boxes and params:
    SPC/E at phase 6's slot density, LJ-256 at rho 0.4 with the tail."""
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    def water(**kw):
        return RunParams(**dict(dict(
            temperature=500.0, r_cut=6.0, coulomb="ewald", p_translate=0.5,
            dr_max=0.4, dphi_max=0.4, use_lrc=False), **kw))

    lj = RunParams(temperature=1.2, r_cut=2.5, coulomb="none",
                   p_translate=1.0, dr_max=0.3, use_lrc=True,
                   slab_mode="off")
    return (25.0 * (64 / 512) ** (1 / 3), lj_box_for_density(256, 0.4),
            water, lj)


def _variant_inputs(dev, seed, tag, system, box, params, n_exchs, n_widoms,
                    C=64, active=None):
    """A lattice state of `system` with about half the slots active (each
    chain its own mask; chain 0 full, chain 1 empty; or the (M,) bool
    pattern `active` on every chain), its S(k), shared
    uniforms, the exchange constants and an activity near (N / V)
    exp(si / T), which accepts insertions and deletions alike.  Returns
    (mc, state, args, act, actm, uxs, z, consts)."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
    )
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops

    gen = torch.Generator(device=dev).manual_seed(seed)
    mc = MonteCarlo(system, params, device=dev, generator=gen,
                    kernel="sweep")
    M = system.n_mol
    quat = diagonal_quats(M) if "co2" in tag else None
    state = mc.init_state(cubic_lattice(M, box), quat=quat, box=box,
                          n_chains=C)
    if active is None:
        active = torch.rand((C, M), generator=gen, device=dev) < 0.5
        active[0], active[1] = True, False
    else:
        active = active.to(dev).expand(C, M).clone()
    act, actm = activity_planes(system, active)
    sfac = state.sfac
    if params.coulomb == "ewald":
        kv = torch.tensor(mc.kvecs, dtype=torch.int32, device=dev)
        q = mc.tables[0].q_row[None, :] * act
        sfac = ewald_ops.structure_factor(
            state.coords.transpose(1, 2), q, kv, state.box)
    u = draw_uniforms(C, M, gen, dev)
    uxs = [draw_exchange_uniforms(C, ne + nw, gen, dev)
           for ne, nw in zip(n_exchs, n_widoms)]
    args = _sweep_args(dataclasses.replace(state, sfac=sfac), u)
    consts = _exchange_consts(system, params, mc.kvecs, mc.kweights,
                              state.box)
    z = 0.5 * M / len(mc.tables) / box ** 3 \
        * torch.exp(consts[0][0] / params.temperature)
    return mc, state, args, act, actm, uxs, z.contiguous(), consts


def variant_cases():
    """Phase 2's muVT cases: (tag, system, box, params, n_exch per block,
    n_widom per block)."""
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        mossa_params,
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    box_w, box_lj, water, lj = _variant_params()
    box_tri = (256 / 0.15) ** (1 / 3)
    box_mix = 37.0 * (64 / 750) ** (1 / 3)
    tri = dataclasses.replace(mossa_params(), temperature=1.5)
    # (tag, system, box, params, n_exch, n_widom per block)
    cases = [
        ("use_act spce64 ewald", spce_system(64), box_w, water(), (0,), (0,)),
        ("n_exch+n_widom spce64 ewald", spce_system(64), box_w, water(),
         (8,), (4,)),
        ("n_exch triatomic256 linear", triatomic_system(256), box_tri, tri,
         (8,), (0,)),
        ("n_exch+n_widom lj256 lrc", lj_system(256), box_lj, lj, (8,), (4,)),
        # Wolf's self term makes a molecule ~45,000 K cheaper: 5000 K keeps
        # the activity that balances it inside f32
        ("n_exch spce64 wolf", spce_system(64), box_w,
         water(coulomb="wolf", temperature=5000.0), (8,), (0,)),
        ("n_exch spce64 wolf ref", spce_system(64), box_w,
         water(coulomb="wolf", wolf_style="ref", temperature=5000.0), (8,),
         (0,)),
        ("n_exch co2/n2 32+32 two blocks", co2_n2_system(32, 32), box_mix,
         mixture_params(r_cut=7.0, temperature=400.0), (3, 2), (0, 0)),
        ("n_widom spce64 ewald", spce_system(64), box_w, water(), (0,), (6,)),
        ("n_widom lj256 lrc", lj_system(256), box_lj, lj, (0,), (6,)),
    ]
    return cases


def phase2_variants(dev):
    """The activity, exchange and Widom arguments of the sweep kernel
    against sweep_plain, 64 chains each."""
    err = 0.0
    for i, (tag, system, box, params, n_exchs, n_widoms) in enumerate(
            variant_cases()):
        mc, _, args, act, actm, uxs, z, consts = _variant_inputs(
            dev, 300 + i, tag, system, box, params, n_exchs, n_widoms)
        err = max(err, compare_variant(
            f"2 {tag}", system, args, mc.tables, act, actm, n_exchs,
            n_widoms, uxs, z, consts, 1000 + i))
    return err


def compaction_cases():
    """Phase 2's cases for the kernel's queues of live pair terms: (tag,
    system, box, params, active pattern or None).  Every site pair inside
    the cutoff (r_cut above L sqrt(3) / 2: every queue fills on every
    chunk); a dilute box with no pair inside it (no live term at all);
    split LJ and Coulomb cutoffs; alternating active and inactive slots;
    33 waters, whose 99 atoms fill three warps and three lanes of a
    fourth, the other four warps scanning nothing."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    water = dict(temperature=298.15, coulomb="ewald", p_translate=0.5,
                 dr_max=0.3, dphi_max=0.3, slab_mode="off")
    alternate = torch.arange(64) % 2 == 0
    return [
        ("all pairs in cutoff spce64 wolf", spce_system(64), box_w,
         RunParams(**dict(water, coulomb="wolf",
                          r_cut=box_w * 3 ** 0.5 / 2 + 0.1,
                          strict_min_image=False)), None),
        ("dilute spce64 ewald", spce_system(64), 40.0,
         RunParams(r_cut=6.0, **water), None),
        ("split cutoff spce64 ewald", spce_system(64), box_w,
         RunParams(r_cut=4.5, qq_r_cut=6.0, **water), None),
        ("alternating activity spce64 ewald", spce_system(64), box_w,
         RunParams(r_cut=6.0, **water), alternate),
        ("partial chunk spce33 ewald", spce_system(33),
         28.24 * (33 / 750) ** (1 / 3), RunParams(r_cut=4.9, **water), None),
    ]


def phase2_compaction(dev, chains=64):
    """compaction_cases against sweep_plain at the present gates; the
    activity case with 4 exchange attempts and 2 ghosts.  Returns the
    largest coordinate difference on matched chains."""
    import warnings

    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo

    err = 0.0
    for i, (tag, system, box, params, active) in enumerate(
            compaction_cases()):
        with warnings.catch_warnings():
            # the all-pairs case samples the truncated nearest image
            warnings.simplefilter("ignore")
            if active is not None:
                mc, _, args, act, actm, uxs, z, consts = _variant_inputs(
                    dev, 500 + i, tag, system, box, params, (4,), (2,),
                    C=chains, active=active)
                err = max(err, compare_variant(
                    f"2 {tag}", system, args, mc.tables, act, actm, (4,),
                    (2,), uxs, z, consts, 1200 + i))
                continue
            gen = torch.Generator(device=dev).manual_seed(500 + i)
            mc = MonteCarlo(system, params, device=dev, generator=gen,
                            kernel="sweep")
            state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                                  n_chains=chains)
        frac = _cutoff_fraction(system, state, params.qq_cut)
        print(f"phase 2 {tag}: {frac:.4f} of site pairs within "
              f"{params.qq_cut:.3f} A, A_pad {state.coords.shape[-1]}")
        err = max(err, compare(f"2 {tag}", mc, state, gen))
    return err


def tmmc_identity(tag, args, tables, act, actm, n_exch, ux, z, consts,
                  seed, e_in):
    """The tmmc instantiation with eta = 0 against the n_exch
    instantiation on the same arguments: the same decisions on every
    chain, coordinates, COMs and S(k) equal.  Returns the largest
    difference of the summed energy deltas (K)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    eta0 = torch.zeros(tables[0].M + 1, device=e_in.device)
    rest = (tables, act, actm, (n_exch,), (0,), [ux], z, consts, seed)
    a = run_variant(op.sweep, args, *rest)
    b = run_variant(op.sweep, args, *rest, tmmc=(eta0, e_in))
    torch.cuda.synchronize()
    n_diff = int((~(a[4][:, 1:] == b[4][:, 1:]).all(dim=1)).sum())
    diffs = [float((x - y).abs().max()) for x, y in zip(a[:4], b[:4])]
    d_e = float((a[4][:, 0] - b[4][:, 0]).abs().max())
    equal = all(torch.equal(x, y) for x, y in zip(a[:8], b[:8]))
    print(f"phase {tag}: eta = 0 tmmc vs n_exch instantiation: "
          f"{n_diff}/{act.shape[0]} chains differing, largest difference "
          f"coords {diffs[0]:.3e}, com {diffs[1]:.3e}, quat {diffs[2]:.3e}, "
          f"S(k) {diffs[3]:.3e}, energy {d_e:.3e} K; every output equal "
          f"{equal}")
    if n_diff or max(diffs) != 0.0 or not all(
            torch.equal(x, y) for x, y in zip(a[5:7], b[5:7])):
        raise AssertionError(f"{tag}: eta = 0 changed the trajectory")
    return d_e


def phase2_tmmc(dev):
    """The tmmc instantiation against sweep_plain (64 chains, shared
    uniforms and Philox scores, a non-zero bias 0.35 N), and with eta = 0
    against the n_exch instantiation.  Returns (largest coordinate
    difference, largest eta = 0 energy difference)."""
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    box_w, box_lj, water, lj = _variant_params()
    cases = [
        ("tmmc spce64 ewald", spce_system(64), box_w, water()),
        ("tmmc lj256 lrc", lj_system(256), box_lj, lj),
        ("tmmc spce64 wolf", spce_system(64), box_w,
         water(coulomb="wolf", temperature=5000.0)),
    ]
    n_exch = 16
    err, d_e = 0.0, 0.0
    for i, (tag, system, box, params) in enumerate(cases):
        mc, state, args, act, actm, uxs, z, consts = _variant_inputs(
            dev, 400 + i, tag, system, box, params, (n_exch,), (0,))
        M = system.n_mol
        eta = 0.35 * torch.arange(M + 1, dtype=torch.float32, device=dev)
        e_in = state.energy.float().contiguous()
        err = max(err, compare_variant(
            f"2 {tag}", system, args, mc.tables, act, actm, (n_exch,), (0,),
            uxs, z, consts, 1100 + i, tmmc=(eta, e_in)))
        d_e = max(d_e, tmmc_identity(f"2 {tag}", args, mc.tables, act, actm,
                                     n_exch, uxs[0], z, consts, 1100 + i,
                                     e_in))
    return err, d_e


def diagonal_quats(n_mol):
    """(n_mol, 4) quaternions turning the body z axis (the axis of the
    linear CO2 and N2 templates) onto the cube diagonal: on a simple-cubic
    lattice of 3.7 A no two neighbours' sites then come closer than ~3 A,
    where random orientations overlap (E/N ~ +4e4 K instead of -2.5e3 K
    for the phase 4 mixture)."""
    n = np.ones(3) / math.sqrt(3.0)
    axis = np.cross([0.0, 0.0, 1.0], n)
    axis /= np.linalg.norm(axis)
    half = 0.5 * math.acos(n[2])
    q = np.concatenate([[math.cos(half)], math.sin(half) * axis])
    return np.tile(q, (n_mol, 1))


def mixture_params(**kw):
    """The CO2/N2 runs' RunParams: 240 K, site cutoff 10 A, Ewald with
    kappa L = 5.6 and |k|^2 < 27."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    return RunParams(**dict(dict(
        temperature=240.0, r_cut=10.0, cutoff_mode="site", coulomb="ewald",
        kappa_L=5.6, nk=5, ksq_max=27, p_translate=0.5, dr_max=0.3,
        dphi_max=0.3), **kw))


def check_delta(tag, args, P):
    """delta_energy against delta_energy_plain on the same arguments (a
    per-move body's delta_args for one move, P sites per molecule);
    returns the largest |d_e| difference (K)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

    k = dop.delta_energy(*args)
    p = dop.delta_energy_plain(*args)
    a = list(args)
    a[10], a[15] = args[10].abs(), args[15].abs()       # |q8|, |q_row|
    q_scale = dop.delta_energy_plain(*a)[1]
    torch.cuda.synchronize()
    err_q = float(((k[1] - p[1]).abs() / q_scale.clamp_min(1e-30)).max())
    sign = torch.zeros(k[0].shape[1], device=k[0].device)
    sign[:P], sign[P:2 * P] = -1.0, 1.0
    d_e = ((k[0] - p[0]) + COULOMB_FACTOR * (k[1] - p[1])) @ sign
    # the move's energy scale: its rows' LJ sums and Coulomb magnitudes
    mag = (p[0].abs() + COULOMB_FACTOR * q_scale).sum(1)
    err = float(d_e.abs().max())
    err_rel = float((d_e.abs() / mag.clamp_min(1.0)).max())
    n_ovr = int(k[2][:, P:2 * P].sum())
    print(f"phase {tag}: {args[0].shape[0]} chains x {args[0].shape[1]} "
          f"lanes: d_e abs err {err:.3e} K ({err_rel:.3e} of the move's "
          f"energy scale), e_coul rel err {err_q:.3e} (of the row's term "
          f"magnitudes), overlaps {n_ovr}")
    if not (err_rel <= ENERGY_REL_TOL and err_q <= ENERGY_REL_TOL
            and torch.equal(k[2], p[2])
            and all(bool(torch.isfinite(x).all()) for x in k)):
        raise AssertionError(f"{tag}: delta_energy and its plain version "
                             f"disagree")
    return err


def delta_compare(tag, body, state, gen, m):
    """check_delta on the move of molecule m proposed from `state`."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms

    C = state.com.shape[0]
    u = draw_uniforms(C, 1, gen, state.com.device)[:, 0]
    pr = body.propose(state.com, state.quat, state.coords, state.box, u,
                      state.dr_max, state.dphi_max, m)
    return check_delta(tag, body.delta_args(pr, state.coords, state.box, m),
                       body.P)


def phase2(dev, chains=2048):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import make_sweep_fn
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        mossa_params,
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_methane_system,
        spce_system,
    )

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    box_lj = lj_box_for_density(256, 0.75)
    box_tri = (256 / 0.30533) ** (1 / 3)
    box_mix = 37.0 * (64 / 750) ** (1 / 3)     # phase 4's density
    cases = [(f"2 spce64 {c} pt={pt}", spce_system(64), box_w,
              RunParams(temperature=298.15, r_cut=6.0, coulomb=c,
                        p_translate=pt, dr_max=0.3, dphi_max=0.3))
             for c in ("ewald", "wolf", "none") for pt in (0.5, 0.0)]
    cases.append(("2 lj256", lj_system(256), box_lj,
                  RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                            p_translate=1.0, dr_max=box_lj / 30)))
    cases.append(("2 triatomic256 linear", triatomic_system(256), box_tri,
                  mossa_params()))
    cases.append(("2 co2/n2 32+32 two blocks", co2_n2_system(32, 32),
                  box_mix, mixture_params(r_cut=7.0)))
    cases.append(("2 spce16+ch4x16 ragged", spce_methane_system(16, 16),
                  12.0, RunParams(temperature=298.15, r_cut=5.5,
                                  coulomb="ewald", p_translate=0.5,
                                  dr_max=0.3, dphi_max=0.3)))
    err = 0.0
    for i, (tag, system, box, params) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        mc = MonteCarlo(system, params, device=dev, generator=gen,
                        kernel="sweep")
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=64)
        err = max(err, compare(tag, mc, state, gen))
    # the linear-shift variant runs on no main path: time one sweep of it
    # at the triatomic-256 shape with the main paths' 2048 chains
    tri = triatomic_system(256)
    gen = torch.Generator(device=dev).manual_seed(150)
    mc = MonteCarlo(tri, mossa_params(), device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(256, box_tri), box=box_tri,
                          n_chains=chains)
    time_sweep("2 triatomic256 linear", mc, state, gen, tri)

    err_d = 0.0
    styles = {"ewald": {}, "wolf": dict(coulomb="wolf"),
              "wolf_ref": dict(coulomb="wolf", wolf_style="ref"),
              "bare": dict(coulomb="bare"), "none": dict(coulomb="none")}
    # A_pad 256 gives each of the kernel's 256 threads one lane; A_pad 768
    # gives each three passes of its lane loop
    for n_co2, n_n2 in ((32, 32), (160, 40)):
        M = n_co2 + n_n2
        mix = dataclasses.replace(co2_n2_system(n_co2, n_n2), species=None)
        box = 37.0 * (M / 750) ** (1 / 3)
        for i, (style, kw) in enumerate(styles.items()):
            params = mixture_params(r_cut=7.0, **kw)
            gen = torch.Generator(device=dev).manual_seed(200 + M + i)
            mc = MonteCarlo(mix, params, device=dev, generator=gen)
            state = mc.init_state(cubic_lattice(M, box), box=box,
                                  n_chains=64)
            body = make_sweep_fn(mix, params, mc.kvecs, mc.kweights, dev,
                                 use_kernel=True)
            for m in (0, M - 24):
                err_d = max(err_d, delta_compare(
                    f"2 delta_energy {style} M={M} m={m}", body, state, gen,
                    m))
    return err, err_d


def ring16_system(n_mol):
    """A rigid ring of 16 sites (radius 2.5 A) as one species: even sites
    with LJ (eps 50 K, sigma 3 A) and charge -0.25 e, odd sites with
    charge +0.25 e and no LJ.  The port's molecule builders give at most 3
    sites (R = 8 rows); this ring gives R = 32, the kernel's largest."""
    from metropolismontecarlo_tpu_torch.models.system import System

    ang = 2.0 * np.pi * np.arange(16) / 16
    body = np.stack([2.5 * np.cos(ang), 2.5 * np.sin(ang), np.zeros(16)], -1)
    odd = np.arange(16) % 2
    return System(n_mol=n_mol, atoms_per_mol=16,
                  body=np.tile(body, (n_mol, 1, 1)),
                  masses=np.ones((n_mol, 16)),
                  charges=np.tile(np.where(odd, 0.25, -0.25), (n_mol, 1)),
                  type_ids=np.tile(odd, (n_mol, 1)).astype(np.int32),
                  eps_table=np.array([[50.0, 0.0], [0.0, 0.0]]),
                  sig_table=np.array([[3.0, 2.0], [2.0, 1.0]]),
                  name="ring16")


def delta_stress_cases():
    """Phase 2's stress cases for the delta-energy kernel's compaction and
    rows: (tag, system, box, params, moved molecule).  Every atom lane
    within the moved rows' reach and every site pair inside the cutoff
    (r_cut above L sqrt(3) / 2); a dilute box with no lane within reach;
    split LJ and Coulomb cutoffs (4.5 / 6 A); SPC/E, whose H rows have
    charge and no LJ; one-site LJ (P = 1: a pose of radius 0); the
    16-site ring (R = 32 rows)."""
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    box_lj = lj_box_for_density(256, 0.75)
    water = dict(temperature=298.15, coulomb="ewald", p_translate=0.5,
                 dr_max=0.3, dphi_max=0.3)
    mix = dataclasses.replace(co2_n2_system(32, 32), species=None)
    return [
        ("every lane in reach and cutoff spce64 wolf", spce_system(64), box_w,
         RunParams(**dict(water, coulomb="wolf",
                          r_cut=box_w * 3 ** 0.5 / 2 + 0.1,
                          strict_min_image=False)), 17),
        ("dilute spce64 ewald", spce_system(64), 40.0,
         RunParams(r_cut=6.0, **water), 17),
        ("split cutoff co2/n2 32+32 ewald", mix, 37.0 * (64 / 750) ** (1 / 3),
         mixture_params(r_cut=4.5, qq_r_cut=6.0), 40),
        ("rows without LJ spce64 ewald", spce_system(64), box_w,
         RunParams(r_cut=6.0, **water), 17),
        ("P = 1 lj256", lj_system(256), box_lj,
         RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                   p_translate=1.0, dr_max=box_lj / 30), 100),
        ("R = 32 ring16x27 ewald", ring16_system(27), 24.0,
         mixture_params(r_cut=7.0), 13),
    ]


def delta_stress_inputs(dev, i, chains=STRESS_CHAINS):
    """Delta stress case i (delta_stress_cases) at seed 3250 + i, drawn on
    the CPU and moved to dev: (case, state, delta_energy's arguments for
    the move of the case's molecule, P).  The state is a lattice start
    (the CO2/N2 case along the cube diagonal, the others in random
    orientations) without an energy recompute."""
    import warnings

    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms
    from metropolismontecarlo_tpu_torch.ops.quaternions import (
        random_quaternion,
    )

    case = delta_stress_cases()[i]
    _, system, box, params, m = case
    gen = torch.Generator().manual_seed(3250 + i)
    with warnings.catch_warnings():
        # the every-lane case samples the truncated nearest image
        warnings.simplefilter("ignore")
        mc = MonteCarlo(system, params, device="cpu", generator=gen,
                        kernel="move")
    M = system.n_mol
    com = torch.as_tensor(cubic_lattice(M, box), dtype=torch.float32)
    com = com[None].expand(chains, M, 3).contiguous()
    if system.name == "co2+n2":
        quat = torch.as_tensor(diagonal_quats(M), dtype=torch.float32)
        quat = quat[None].expand(chains, M, 4).contiguous()
    else:
        quat = random_quaternion(gen, (chains, M), dtype=torch.float32)
    state = mc._new_state(com, quat, torch.full((chains,), float(box)))
    body = next(b for m0, m1, b in mc.move_bodies if m0 <= m < m1)
    u = draw_uniforms(chains, 1, gen, "cpu")[:, 0]
    pr = body.propose(state.com, state.quat, state.coords, state.box, u,
                      state.dr_max, state.dphi_max, m)
    args = body.delta_args(pr, state.coords, state.box, m)
    return case, _to_device(state, dev), _to_device(args, dev), body.P


def misaligned_planes(args):
    """delta_energy's arguments with the coordinate planes copied into a
    buffer one float past a 16-byte boundary."""
    x = args[0]
    C, A_pad = x.shape
    buf = torch.empty(C * 3 * A_pad + 1, dtype=x.dtype, device=x.device)
    planes = buf[1:].view(C, 3, A_pad)
    for d in range(3):
        planes[:, d] = args[d]
    return (planes[:, 0], planes[:, 1], planes[:, 2]) + tuple(args[3:])


def phase2_delta_stress(dev):
    """delta_stress_cases against delta_energy_plain (check_delta's gates);
    then a misaligned plane, which the wrapper and the launcher must both
    refuse.  Returns the largest |d_e| difference (K)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop

    t0 = time.perf_counter()
    err = 0.0
    for i in range(len(delta_stress_cases())):
        (tag, system, _, params, m), state, args, P = \
            delta_stress_inputs(dev, i)
        r_cut = max(params.r_cut, params.qq_cut)
        near = _reach_fraction(state.coords, state.com,
                               system.atom_mol_slot[0], state.box, r_cut,
                               m_ranges=[(m, 1)])[0]
        frac = _cutoff_fraction(system, state, r_cut)
        print(f"phase 2e {tag}: R {args[3].shape[1]}, P {P}, A_pad "
              f"{args[0].shape[1]}, {near:.4f} of atoms within molecule "
              f"{m}'s reach, {frac:.4f} of site pairs within {r_cut:.3f} A")
        err = max(err, check_delta(f"2e delta_energy {tag}", args, P))
    bad = misaligned_planes(args)
    try:
        dop.delta_energy(*bad)
    except ValueError as e:
        print(f"phase 2e misaligned plane: the wrapper refuses it ({e})")
    else:
        raise AssertionError("delta_energy took a misaligned plane")
    C, R = args[3].shape
    outs = tuple(torch.empty((C, R), device=dev) for _ in range(3))
    tensors = tuple(bad[:7]) + tuple(bad[8:16])
    try:
        dop._launch(tensors, bad[7], bad[16], outs)
    except RuntimeError as e:
        print(f"phase 2e misaligned plane: the launcher refuses it ({e})")
    else:
        raise AssertionError("the delta_energy launcher took a misaligned "
                             "plane")
    torch.cuda.synchronize()
    print(f"phase 2 delta_energy stress cases: {time.perf_counter() - t0:.1f}"
          f" s")
    return err


# ---------------- the global layout and sorted slabs -------------------


def _stratified_com(n, box, side=26):
    """xy grid + scrambled stratified z: exactly uniform z-occupancy and
    no close pairs (the JAX package's tests/test_slabs.py start)."""
    i = np.arange(n)
    return np.stack([(i % side + 0.5) * box / side,
                     (i // side + 0.5) * box / side,
                     ((i * 997) % n + 0.5) * box / n], axis=1)


def _sheared_lattice(n, box):
    """A simple cubic lattice whose (x, y) columns are shifted in z by up
    to one spacing: no close pairs and no z-planes to clump the windows."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice

    com = np.asarray(cubic_lattice(n, box), np.float64)
    side = int(np.ceil(n ** (1 / 3)))
    a = box / side
    ix, iy = np.floor(com[:, 0] / a), np.floor(com[:, 1] / a)
    com[:, 2] = (com[:, 2] + (ix + side * iy) / side ** 2 * a) % box
    return com


def _slab_args(mc, state, u):
    """The resorted state's kernel arguments on the slab planes (ghost
    halo filled), as the whole-sweep route builds them."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        make_slab_resort_fn,
        with_halo,
    )

    state = make_slab_resort_fn(mc.system, mc.params, mc._slab_cfg)(state)
    args = _sweep_args(state, u)
    args[0] = with_halo(args[0], mc.system, mc._slab_cfg).contiguous()
    return state, args


def compare_tables(tag, args, tables, layout="auto"):
    """One launch per table of the kernel and of sweep_plain on the same
    arguments; the shared tolerance test.  Returns (largest coordinate
    difference on matched chains, kernel outputs, ms of the sweep_plain
    calls, with their magnitude column)."""
    from metropolismontecarlo_tpu_torch.mc.moves import sweep_blocks
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C = args[0].shape[0]
    k = sweep_blocks(functools.partial(op.sweep, layout=layout), *args,
                     tables)
    out = []
    plain_ms = _time_ms(lambda: out.append(sweep_blocks(
        functools.partial(op.sweep_plain, magnitude=True), *args, tables)),
        1)
    p = out[0]
    same = (k[4][:, 1:] == p[4][:, 1:op.N_STATS]).all(dim=1)
    print(f"phase {tag}: acc/att {k[4][:, 1:5].sum(0).tolist()}")
    err = _check_match(tag, C, same, (k[0], k[1], k[3], k[4]),
                       (p[0], p[1], p[3], p[4]), p[4][:, op.N_STATS])
    return err, k, plain_ms


def check_halo(tag, planes, system, cfg):
    """The ghost twins kept up with their head molecules: the halo equals
    the sorted block's first W columns, bit for bit."""
    A, a0, W = system.n_atoms, cfg["a0"], cfg["W"]
    if not torch.equal(planes[:, :, A:A + W], planes[:, :, a0:a0 + W]):
        raise AssertionError(f"{tag}: ghost halo differs from its head "
                             f"columns")
    print(f"phase {tag}: ghost halo equals its {W} head columns")


def phase2_global(dev, chains=64):
    """(a) The global layout against the shared layout on systems that fit
    both: every output compared bit for bit, and the global layout held
    against sweep_plain; (b)-(d) forced sorted slabs against sweep_plain
    with slabs (LJ-640 from a stratified start, W 512 < 640; SPC/E-512; a
    CO2 + N2 mixture whose N2 block is sorted)."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    box_w = 28.24 * (64 / 750) ** (1 / 3)
    box_lj = lj_box_for_density(256, 0.75)
    box_mix = 37.0 * (64 / 750) ** (1 / 3)
    ident = [("2a spce64 ewald", spce_system(64), box_w,
              RunParams(temperature=298.15, r_cut=6.0, coulomb="ewald",
                        p_translate=0.5, dr_max=0.3, dphi_max=0.3)),
             ("2a lj256", lj_system(256), box_lj,
              RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                        p_translate=1.0, dr_max=box_lj / 30)),
             ("2a co2/n2 32+32", co2_n2_system(32, 32), box_mix,
              mixture_params(r_cut=7.0))]
    err = 0.0
    n_unequal = 0
    for i, (tag, system, box, params) in enumerate(ident):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        mc = MonteCarlo(system, params, device=dev, generator=gen,
                        kernel="sweep")
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=chains)
        u = draw_uniforms(chains, system.n_mol, gen, dev)
        args = _sweep_args(state, u)
        ks = sweep_blocks(functools.partial(op.sweep, layout="shared"),
                          *args, mc.tables)
        e, kg, _ = compare_tables(tag + " global", args, mc.tables,
                               layout="global")
        err = max(err, e)
        kk = sweep_blocks(functools.partial(op.sweep, layout="global_k"),
                          *args, mc.tables)
        for name, out in (("global", kg), ("global_k", kk)):
            n, big = _differing(out, ks)
            n_unequal += n
            print(f"phase {tag}: {name} vs shared layout: {n} of {chains} "
                  f"chains differ in any output, largest difference "
                  f"{big:.3e}")

    mix = dict(temperature=240.0, r_cut=7.0, coulomb="ewald", nk=5,
               ksq_max=27, p_translate=0.5, dr_max=0.3, dphi_max=0.3,
               slab_mode="force", slab_skin=0.5)
    box_m = 37.0 * (640 / 750) ** (1 / 3)
    slabs = [("2b lj640 slab", lj_system(640), 32.0,
              RunParams(temperature=1.5, r_cut=3.0, coulomb="none",
                        p_translate=1.0, dr_max=0.4, use_lrc=False,
                        slab_mode="force", slab_skin=1.0),
              _stratified_com(640, 32.0)),
             ("2c spce512 slab", spce_system(512), 24.83,
              RunParams(temperature=298.15, r_cut=4.5, coulomb="ewald",
                        nk=5, ksq_max=27, p_translate=0.5, dr_max=0.3,
                        dphi_max=0.3, slab_mode="force", slab_skin=0.3),
              _sheared_lattice(512, 24.83)),
             ("2d co2/n2 64+576 slab", co2_n2_system(64, 576), box_m,
              RunParams(**mix), cubic_lattice(640, box_m))]
    for i, (tag, system, box, params, com) in enumerate(slabs):
        gen = torch.Generator(device=dev).manual_seed(320 + i)
        mc = MonteCarlo(system, params, device=dev, generator=gen)
        state = mc.init_state(com, box=box, n_chains=chains)
        cfg = mc._slab_cfg
        if cfg is None or not cfg["W"] < cfg["A_blk"]:
            raise AssertionError(f"{tag}: slab configuration {cfg}")
        print(f"phase {tag}: W {cfg['W']} of A_blk {cfg['A_blk']}, "
              f"A_store {cfg['A_store']}, {len(mc.tables)} launches")
        u = draw_uniforms(chains, system.n_mol, gen, dev)
        state, args = _slab_args(mc, state, u)
        e, k, _ = compare_tables(tag, args, mc.tables)
        check_halo(tag, k[0], system, cfg)
        err = max(err, e)
        kk = sweep_blocks(functools.partial(op.sweep, layout="global_k"),
                          *args, mc.tables)
        n, big = _differing(kk, k)
        n_unequal += n
        print(f"phase {tag}: slabs on the global_k layout vs the global "
              f"layout: {n} of {chains} chains differ in any output, "
              f"largest difference {big:.3e}")
    if n_unequal:
        raise AssertionError(f"the layouts differ on {n_unequal} chains")
    return err, n_unequal


def _differing(a, b):
    """(chains that differ in any output, largest difference) of two
    tuples of per-chain outputs (chain axis first)."""
    diff = torch.zeros(a[0].shape[0], dtype=torch.bool, device=a[0].device)
    big = 0.0
    for x, y in zip(a, b):
        diff |= (x != y).flatten(1).any(dim=1)
        big = max(big, float((x - y).abs().max()))
    return int(diff.sum()), big


def layouts_equal(tag, run):
    """run(layout) -> per-chain outputs, for each of LAYOUTS: the global
    layouts against the shared one, every output bit for bit (raises on a
    difference), and each layout's launch timed with CUDA events in turns
    (shared, global, global_k, global_k, global, shared).  Returns
    {layout: ms}."""
    from metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel import LAYOUTS

    outs = {lay: run(lay) for lay in LAYOUTS}
    times = {lay: [] for lay in LAYOUTS}
    for lay in LAYOUTS + LAYOUTS[::-1]:
        times[lay].append(_time_ms(lambda: run(lay), 1))
    ms = {lay: sum(v) / len(v) for lay, v in times.items()}
    bad = 0
    for lay in LAYOUTS[1:]:
        n, big = _differing(outs[lay], outs["shared"])
        bad += n
        print(f"phase {tag}: {lay} vs shared layout: {n} of "
              f"{outs['shared'][0].shape[0]} chains differ in any output, "
              f"largest difference {big:.3e}")
    print(f"phase {tag}: launch ms shared {ms['shared']:.3f}, global "
          f"{ms['global']:.3f} ({ms['global'] / ms['shared'] - 1:+.1%}), "
          f"global_k {ms['global_k']:.3f} "
          f"({ms['global_k'] / ms['shared'] - 1:+.1%})")
    if bad:
        raise AssertionError(f"{tag}: the layouts differ")
    return ms


def phase2_layouts(dev, chains=64):
    """The global layouts against the shared one on states that fit all
    three, with forced layouts, every output compared bit for bit (layouts
    differ only in where the words live): the sweep kernel's activity,
    exchange and Widom cases of phase2_variants; its tmmc cases (cmat and
    uhist included; and eta = 0 against the n_exch instantiation on each
    global layout); the Gibbs kernel on bench's cap-128 x 2 shape and the
    TIP4P/2005 cap 48 x 2 case; the flip kernel on bench's 64 + 64 shape
    and the TIP4P/2005 + TIP4P/Ice 32 + 32 case.  Each launch is timed in
    each layout.  Returns {case: {layout: ms}}."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_exchange_uniforms
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_system,
        spce_two_blocks,
        tip4p2005_system,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as fop
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t0 = time.perf_counter()
    times = {}
    for i, (tag, system, box, params, n_exchs, n_widoms) in enumerate(
            variant_cases()):
        mc, _, args, act, actm, uxs, z, consts = _variant_inputs(
            dev, 600 + i, tag, system, box, params, n_exchs, n_widoms,
            C=chains)
        times[tag] = layouts_equal(f"2l {tag}", lambda lay: run_variant(
            functools.partial(op.sweep, layout=lay), args, mc.tables, act,
            actm, n_exchs, n_widoms, uxs, z, consts, 1600 + i))
    box_w, box_lj, water, lj = _variant_params()
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    for i, (tag, system, box, params) in enumerate((
            ("tmmc spce64 ewald", spce_system(64), box_w, water()),
            ("tmmc lj256 lrc", lj_system(256), box_lj, lj))):
        mc, state, args, act, actm, uxs, z, consts = _variant_inputs(
            dev, 700 + i, tag, system, box, params, (16,), (0,), C=chains)
        e_in = state.energy.float().contiguous()
        rest = (mc.tables, act, actm, (16,), (0,), uxs, z, consts, 1700 + i)
        for eta, what in ((0.35 * torch.arange(system.n_mol + 1,
                                               dtype=torch.float32,
                                               device=dev), "eta 0.35 N"),
                          (torch.zeros(system.n_mol + 1, device=dev),
                           "eta 0")):
            times[f"{tag} {what}"] = layouts_equal(
                f"2l {tag} {what}", lambda lay: run_variant(
                    functools.partial(op.sweep, layout=lay), args, *rest,
                    tmmc=(eta, e_in)))
        # eta = 0 takes the n_exch instantiation's decisions, layout by
        # layout
        for lay in op.LAYOUTS[1:]:
            fn = functools.partial(op.sweep, layout=lay)
            a = run_variant(fn, args, *rest)
            b = run_variant(fn, args, *rest, tmmc=(eta, e_in))
            n, big = _differing(a[:8], b[:8])
            print(f"phase 2l {tag}: eta = 0 tmmc vs n_exch, {lay} layout: "
                  f"{n} of {chains} chains differ, largest difference "
                  f"{big:.3e}")
            if n:
                raise AssertionError(f"{tag}: eta = 0 changed the "
                                     f"trajectory on the {lay} layout")
    params, boxes, _ = _gibbs_flagship(cap=128)
    for i, (tag, system, gparams, gboxes, n_exch) in enumerate((
            ("gibbs spce cap 128x2", spce_system(128), params, boxes, 110),
            ("gibbs tip4p2005 cap 48x2", tip4p2005_system(48),
             _tip4p_gibbs_params(), (12.0, 16.0), 24))):
        inputs = _gibbs_case(dev, system, gparams, gboxes, chains, 800 + i,
                             n_exch)
        times[tag] = layouts_equal(f"2l {tag}", lambda lay: run_gibbs(
            functools.partial(gop.sweep_gibbs, layout=lay), *inputs,
            1800 + i))
    for i, (tag, system, fparams, box, cap, n_flip) in enumerate((
            ("flip spce 64+64", spce_two_blocks(64, 64), _semigrand_water(),
             20.0, 64, 55),
            ("flip tip4p2005+tip4pice 32+32", tip4p_two_blocks(32, 32),
             _semigrand_water(r_cut=6.0), 16.0, 32, 24))):
        gen = torch.Generator(device=dev).manual_seed(900 + i)
        rng = np.random.default_rng(900 + i)
        n_act = rng.integers(0, cap + 1, (chains, 2))
        fargs, ftables, si2, lrc3 = flip_inputs(
            system, fparams, box, 2.0, torch.tensor(n_act), gen, dev)
        ux = draw_exchange_uniforms(chains, n_flip, gen, dev)
        times[tag] = layouts_equal(f"2l {tag}", lambda lay: fop.flip(
            *fargs, ux, ftables, si2, lrc3, seed=1900 + i, layout=lay))
    print(f"phase 2 layout cases: {time.perf_counter() - t0:.1f} s")
    return times


def _cutoff_fraction_tiled(system, state, r_cut, rows=512):
    """_cutoff_fraction of chain 0 for systems too large for an (A, A)
    grid, one block of rows at a time."""
    A = system.n_atoms
    x = state.coords[0, :, :A].T                                   # (A, 3)
    box = state.box[0]
    mol = torch.as_tensor(system.atom_mol_slot[0], device=x.device)
    inside = total = 0
    for i0 in range(0, A, rows):
        d = x[i0:i0 + rows, None, :] - x[None, :, :]
        d = d - box * torch.round(d / box)
        other = mol[i0:i0 + rows, None] != mol[None, :]
        inside += int(((d * d).sum(-1) < r_cut ** 2)[other].sum())
        total += int(other.sum())
    return inside / total


def slab_lanes(system, t):
    """The mean number of atom lanes a move of table t scans: the other
    blocks' segments and its window (above the sorted block's first
    column), less its own columns and their ghost twin."""
    wst = t.wst.cpu().numpy()
    segs = t.segs.cpu().numpy().reshape(-1, 2)
    lanes = []
    for m in range(t.m_start, t.m_start + t.M):
        a0 = t.a_start + (m - t.m_start) * t.P
        n = int(segs[:, 1].sum())
        lo, hi = max(int(wst[m]), t.a0_w), int(wst[m]) + t.W
        n += hi - lo
        own = [a0 + p for p in range(t.P)]
        if a0 >= t.a0_w:
            own += [c + t.A_blk for c in own]
        lanes.append(n - sum(1 for c in own if lo <= c < hi
                             or any(b <= c < b + w for b, w in segs)))
    return float(np.mean(lanes))


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _cutoff_fraction(system, state, r_cut, n=4):
    """Share of the atom pairs of different molecules within r_cut, from
    the first n chains of `state` (what the bound counts potential terms
    for)."""
    A = system.n_atoms
    x = state.coords[:n, :, :A].transpose(1, 2)                   # (n, A, 3)
    box = state.box[:n, None, None, None]
    d = x[:, :, None, :] - x[:, None, :, :]
    d = d - box * torch.round(d / box)
    d2 = (d * d).sum(-1)
    mol = torch.as_tensor(system.atom_mol_slot[0], device=x.device)
    other = mol[:, None] != mol[None, :]
    return float((d2 < r_cut ** 2)[:, other].float().mean())


def _reach_fraction(coords, com, mol, box, r_cut, active=None, n=4,
                    m_ranges=None, rows=256):
    """Share of the pairs (molecule m, atom j of another molecule), both
    active, whose minimum-image distance from m's centre com[m] is below
    m's reach: r_cut (the largest cutoff) plus the largest distance of m's
    atoms from that centre.  Only these atoms can hold a site pair inside
    the cutoff (the minimum image obeys the triangle inequality), so only
    they need their site distances; every other atom needs one distance
    to the centre.  coords (C, 3, A_pad), com (C, M, 3), mol (A,) the
    molecule of each of the first A atom columns, box (C,), active (C, M)
    or None (all active); from n chains spread over the chain axis, rows
    molecules at a time.  One share per (first molecule, count) of
    m_ranges (default: every molecule)."""
    C, M = com.shape[:2]
    mol = torch.as_tensor(mol, dtype=torch.long, device=com.device)
    A = mol.numel()
    ranges = [(0, M)] if m_ranges is None else list(m_ranges)
    inside = torch.zeros(M, dtype=torch.float64, device=com.device)
    total = torch.zeros_like(inside)
    for c in sorted({round(i * (C - 1) / max(n - 1, 1)) for i in range(n)}):
        on_m = torch.ones(M, dtype=torch.bool, device=com.device) \
            if active is None else active[c].bool()
        on_a = on_m[mol]
        x, L = coords[c, :, :A].T.to(com.dtype), box[c]
        d = x - com[c, mol]
        d = d - L * torch.round(d / L)
        rad = torch.zeros(M, dtype=com.dtype, device=com.device) \
            .scatter_reduce(0, mol, d.norm(dim=1), "amax")
        for m0 in range(0, M, rows):
            m1 = min(m0 + rows, M)
            d = x[None, :, :] - com[c, m0:m1, None, :]
            d = d - L * torch.round(d / L)
            near = (d * d).sum(-1) < ((r_cut + rad[m0:m1]) ** 2)[:, None]
            ids = torch.arange(m0, m1, device=com.device)
            pair = on_m[m0:m1, None] & on_a[None, :] \
                & (mol[None, :] != ids[:, None])
            inside[m0:m1] += (near & pair).sum(1).double()
            total[m0:m1] += pair.sum(1).double()
    return [float(inside[a:a + k].sum() / total[a:a + k].sum().clamp_min(1))
            for a, k in ranges]


def _system_reach(system, params, state, tables, active=None, n=4):
    """_reach_fraction of each species block of `tables` in a state of
    `system` (SimState or MolGCMCState-like, slots in system order), at
    the larger of the LJ and Coulomb cutoffs."""
    return _reach_fraction(
        state.coords, state.com, system.atom_mol_slot[0], state.box,
        max(params.r_cut, params.qq_cut), active, n,
        [(t.m_start, t.M) for t in tables])


def sweep_bound(system, tables, state, frac, near, n_active=None,
                n_exchs=None, n_widoms=None, n_del=0.0, tmmc=False,
                n_sq=None, lanes=None, A_plane=None):
    """The least time (ms) one sweep could take on this card, and what
    sets it: each input and output moved once against the operations the
    pair and k-space sums need (see OPS_*; a pose's S(k) row by k_pose_ops,
    from per-site eik tables, which this kernel does not build: it takes
    a sincos per k-vector and site): per atom lane and pose one
    distance to the pose's centre, the site distances for the share
    near[b] of block b's lanes within the pose's reach (_reach_fraction
    of the moved molecules, which stands for the exchange and ghost poses
    too) and the terms for the share frac inside the cutoff.  With an
    activity mask,
    n_active[b] is the mean number of active molecules of block b: only
    they move and only their atoms are neighbours.  n_exchs[b] / n_widoms[b]
    attempts and ghosts each sum one pose against the active atoms and
    every k-vector (a tmmc attempt two poses, and it reads eta and e_in and
    writes cmat and uhist); n_del attempts per chain (this run's deletions;
    with tmmc every attempt) each score the active slots with Philox.
    n_sq (one block): the mean over chains of n_c^2, for chains whose
    active counts differ (chain c's moves each sum over its own n_c P
    atoms, so the move work goes with the mean of n_c (n_c - 1)).
    lanes[b] (sorted slabs): the mean atom lanes a move of block b scans
    (slab_lanes), each with its centre distance; the atoms within reach
    and the in-cutoff terms are those of all A atoms, which the window
    covers; A_plane: the planes' width (A_store)."""
    C, M = state.com.shape[:2]
    A, K = system.n_atoms, state.sfac.shape[1]
    A_pad = state.coords.shape[-1] if A_plane is None else A_plane
    nbytes = 4 * C * (2 * 3 * A_pad + 2 * 7 * M + 2 * 2 * K + 10 * M + 10)
    if n_active is not None:
        n_att = sum(n_exchs) + sum(n_widoms)
        nbytes += 4 * C * (2 * (A_pad + M) + 8 * n_att + 5)
        if tmmc:
            nbytes += 4 * (C * (2 * 3 * (M + 1) + 1) + M + 1)
        A = sum(n * t.P for n, t in zip(n_active, tables))
    ops = 0.0
    for b, t in enumerate(tables):
        lj = t.has_lj.sum().item()
        qf = t.has_q.sum().item() if t.coulomb != "none" else 0
        sites = near[b] * t.P * OPS_GEOMETRY + frac * (lj * OPS_LJ
                                                        + qf * OPS_COULOMB)
        c_pair = OPS_GEOMETRY + sites
        per_pose = (A - t.P) * c_pair
        if lanes is not None:
            per_pose = lanes[b] * OPS_GEOMETRY + (A - t.P) * sites
        ewald = t.coulomb == "ewald"
        k_pose = k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
        k_move = 2 * k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
        if n_active is None:
            ops += C * t.M * (2 * per_pose + k_move)
        else:
            pairs = n_active[b] * per_pose if n_sq is None \
                else (n_sq - n_active[b]) * t.P * c_pair
            ops += C * (2 * pairs + n_active[b] * k_move)
            poses = n_exchs[b] * (2 if tmmc else 1) + n_widoms[b]
            ops += C * poses * (per_pose + k_pose)
    if n_active is not None:
        ops += C * n_del * sum(n_active) * OPS_PHILOX
    return _bound(nbytes, ops)


def delta_bound(args, P, frac, near):
    """The least time (ms) of one delta_energy launch: the planes, rows
    and outputs moved once against the pair operations of the live rows
    (per lane the old and the new pose's centre distance, the rows'
    distances for the share `near` within reach, the terms for the share
    frac inside the cutoff)."""
    x, R = args[0], args[3].shape[1]
    C, A_pad = x.shape
    has_lj, has_q = args[11].sum().item(), args[12].sum().item()
    if args[16].coulomb == "none":
        has_q = 0
    nbytes = 4 * C * (3 * A_pad + 6 * R)
    rows = int(((args[11] != 0) | (args[12] != 0)).sum())
    ops = C * (int((args[14] >= 0).sum()) - P) * (
        2 * OPS_GEOMETRY + near * rows * OPS_GEOMETRY
        + frac * (has_lj * OPS_LJ + has_q * OPS_COULOMB))
    return _bound(nbytes, ops)


def k_pose_ops(K, nk, sites):
    """The operations of one pose's S(k) row over K k-vectors from its
    charged sites' eik tables (OPS_SINCOS, OPS_CMUL, OPS_K_SITE): per site
    three table rows, then per k-vector and site two complex products."""
    return sites * (3 * (OPS_SINCOS + nk * OPS_CMUL) + K * OPS_K_SITE)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def main_path(tag, mc, state, blocks, launches_per_sweep, counter,
              reset=True, extra=0):
    """run_blocks with the launch count, drift gate and acceptance
    checked; `counter` is the wrapper whose .launches counts the path's
    kernel (set to 0 first unless reset is False: the launch check then
    counts from the caller's reset), `extra` the launches expected beyond
    launches_per_sweep per sweep.  Returns (state, launches)."""
    if reset:
        counter.launches = 0
    launches0 = counter.launches
    sweeps = 0
    for n_steps, adjust in blocks:
        t0 = time.perf_counter()
        state, m = mc.run_block(state, n_steps, adjust=adjust)
        torch.cuda.synchronize()
        sweeps += n_steps
        print(f"phase{tag} run_block({n_steps}, adjust={adjust}): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v:.6g}" for k, v in m.items()))
        if not m["drift_max_rel"] <= DRIFT_TOL:
            raise AssertionError(f"drift {m['drift_max_rel']} > {DRIFT_TOL}")
        if not all(math.isfinite(m[k]) for k in ("energy_mean", "energy_min",
                                                 "energy_max")):
            raise AssertionError(f"non-finite energies: {m}")
        if not adjust and not (0.05 < m["acc_trans"] < 0.95
                               and 0.05 < m["acc_rot"] < 0.95):
            raise AssertionError(f"acceptance out of range: {m}")
    launches = counter.launches
    if launches - launches0 != launches_per_sweep * sweeps + extra:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{sweeps} sweeps, {launches_per_sweep} each "
                             f"and {extra} more")
    if not bool(torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite chain energies")
    print(f"phase{tag} main path: {sweeps} sweeps, "
          f"{launches - launches0} kernel launches")
    return state, launches


def time_sweep(tag, mc, state, gen, system, plain_ms=None):
    """One sweep of the kernel (all blocks) and of sweep_plain, timed on
    the same uniforms, with the bound of the work; plain_ms: the plain
    version's time already taken on this state (compare_tables), which
    is then not taken again."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = state.com.shape[:2]
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    sweep_blocks(op.sweep, *args, mc.tables)                    # warm
    ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, mc.tables), 3)
    if plain_ms is None:
        plain_ms = _time_ms(
            lambda: sweep_blocks(op.sweep_plain, *args, mc.tables), 1)
    frac = _cutoff_fraction(system, state, mc.params.r_cut)
    near = _system_reach(system, mc.params, state, mc.tables)
    bound_ms, bound_by = sweep_bound(system, mc.tables, state, frac, near)
    print(f"phase{tag} one sweep of {C} chains x {M} moves "
          f"({len(mc.tables)} launches): kernel {ms:.3f} ms, sweep_plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{frac:.4f} of pairs within the cutoff, "
          f"{' / '.join(f'{v:.4f}' for v in near)} of atoms within a "
          f"pose's reach)")
    return ms, plain_ms, bound_ms, bound_by


def phase3(dev, n_mol=750, box=28.24, chains=2048, r_cut=10.0,
           blocks=((10, True), (5, False), (5, False))):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(2026)
    system = spce_system(n_mol)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase3 init_state: {time.perf_counter() - t0:.2f} s, "
          f"K={mc.tables[0].kvec.shape[0]}, A_pad={state.coords.shape[-1]}, "
          f"E/N mean {float(state.energy.mean()) / n_mol:.2f} K")
    # the lattice start relaxes through E = 0 during the first sweeps; a
    # 10-sweep adjust block ends every chain far from zero energy, where
    # the relative drift gate is meaningful
    state, launches = main_path("3", mc, state, blocks, 1, op.sweep)
    err = compare("3 flagship kernel vs plain", mc, state, gen)
    return (launches, err) + time_sweep("3", mc, state, gen, system)


def phase4(dev, n_co2=600, n_n2=150, box=37.0, chains=2048, r_cut=10.0,
           blocks=((10, True), (5, False), (5, False))):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    system = co2_n2_system(n_co2, n_n2)
    params = mixture_params(r_cut=r_cut)
    gen = torch.Generator(device=dev).manual_seed(2027)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    if mc.route != "sweep" or len(mc.tables) != 2:
        raise AssertionError(f"mixture route {mc.route}, {len(mc.tables)} "
                             f"blocks")
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(system.n_mol, box),
                          quat=diagonal_quats(system.n_mol), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase4 init_state: {time.perf_counter() - t0:.2f} s, "
          f"M={system.n_mol}, A_pad={state.coords.shape[-1]}, "
          f"K={state.sfac.shape[1]}, blocks "
          f"{[(t.m_start, t.M, t.a_start, t.P) for t in mc.tables]}, "
          f"E/N mean {float(state.energy.mean()) / system.n_mol:.2f} K")
    state, launches = main_path("4", mc, state, blocks, 2, op.sweep)
    err = compare("4 mixture kernel vs plain", mc, state, gen)
    timing = time_sweep("4", mc, state, gen, system)
    return (launches, err) + timing + (mc, state)


def _graph_ms(fn, reps):
    """Device time (ms) of one fn() call: reps calls captured in one CUDA
    graph, replayed once to warm and once timed, so no host enqueue time
    enters (fn must be capturable)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _time_ms(graph.replay, 1) / reps


def profile_moves(tag, mc, state, u, top=12):
    """One eager per-move sweep (mc/moves.py run_moves on copies of the
    state, on uniforms u) under torch.profiler (device activity): the
    device time by kernel, the device's busy time (the union of its
    kernel, copy and set intervals) and the idle gaps between them, and
    the wall time per move."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metropolismontecarlo_tpu_torch.mc.moves import run_moves

    s = dataclasses.replace(state, com=state.com.clone(),
                            quat=state.quat.clone(),
                            coords=state.coords.clone())
    M = u.shape[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_moves(mc.move_bodies, s, u)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        raise AssertionError(f"{tag}: the profiler traced no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, idle, end = 0.0, 0.0, spans[0][0]
    for a, b in spans:
        if a > end:
            idle += a - end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in dev_events:
        n = e.name if len(e.name) <= 90 else e.name[:87] + "..."
        t, k = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e.time_range.end - e.time_range.start, k + 1)
    print(f"phase{tag} profiled eager per-move sweep: {wall:.3f} s for {M} "
          f"moves under the profiler ({1e3 * wall / M:.3f} ms per move); "
          f"device busy {busy / 1e6:.4f} s ({busy / M:.2f} us per move), "
          f"idle gaps {idle / 1e6:.4f} s ({idle / M:.2f} us per move, "
          f"{idle / (busy + idle):.4f} of the span), {len(dev_events)} "
          f"device events")
    for n, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"phase{tag} device time by kernel: {t / 1e3:10.3f} ms, {k:6d}"
              f" x, {t / M:8.3f} us per move: {n}")
    print(f"phase{tag} profile processed in {time.perf_counter() - t1:.1f} "
          f"s")


def phase5(dev, mc4, state4, blocks=((2, False),)):
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t_phase = time.perf_counter()
    system = dataclasses.replace(mc4.system, species=None)
    gen = torch.Generator(device=dev).manual_seed(2028)
    mc = MonteCarlo(system, mc4.params, device=dev, generator=gen)
    if mc.route != "move":
        raise AssertionError(f"species=None mixture took route {mc.route}")
    M = system.n_mol
    C = state4.com.shape[0]

    # where an eager per-move sweep's time goes, before the graph
    u = draw_uniforms(C, M, torch.Generator(device=dev).manual_seed(2029),
                      dev)
    profile_moves("5", mc, state4, u)

    # the sweep graph's capture alone, on a MonteCarlo of its own: its time
    # and the device memory it holds, its private pool (the allocator's
    # segments of that pool) and its static buffers
    mc_g = MonteCarlo(system, mc4.params, device=dev, generator=gen)
    t0 = time.perf_counter()
    graph = mc_g.capture_sweep(state4)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_id = tuple(graph.graph.pool())
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool_id)
    buffers = sum(t.nbytes for t in graph.static.values()) + graph.u.nbytes
    print(f"phase5 sweep graph: captured in {capture_s:.3f} s (warm-up "
          f"included), {graph.launches} delta_energy launches recorded; "
          f"graph pool {pool} B ({pool / 2 ** 30:.3f} GiB), static buffers "
          f"{buffers} B")
    if graph.launches != M:
        raise AssertionError(f"the sweep graph recorded {graph.launches} "
                             f"launches, not {M}")
    if not 0 < pool <= 4 * 2 ** 30:
        raise AssertionError(f"the sweep graph's pool is {pool} B, not in "
                             f"(0, 4 GiB]")
    del mc_g, graph

    # the main path on a fresh MonteCarlo: the first run_block captures
    # the sweep graph inside its sweep (the warm-up's one counted launch
    # per body is the `extra`), the second only replays it.  On the graph
    # the count is the launches the capture recorded times the replays
    print("phase5 the first run_block below captures the sweep graph (a "
          "fresh MonteCarlo), the second replays it")
    state, launches = main_path("5", mc, state4, blocks, M, dop.delta_energy,
                                extra=len(mc.move_bodies))

    # one sweep of each route on the same uniforms; sweep_plain gives the
    # sweep's energy scale
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    k = sweep_blocks(op.sweep, *args, mc4.tables)
    plain = functools.partial(op.sweep_plain, magnitude=True)
    e_scale = sweep_blocks(plain, *args, mc4.tables)[4][:, op.N_STATS]
    s = dataclasses.replace(state, com=state.com.clone(),
                            quat=state.quat.clone(),
                            coords=state.coords.clone())
    fp = torch.zeros(C, device=state.com.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m0, m1, body in mc.move_bodies:
        for m in range(m0, m1):
            s, accept = body(s, m, u[:, m])
            fp += accept.float() * (m + 1)
    torch.cuda.synchronize()
    move_sweep_s = time.perf_counter() - t0
    graph_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = mc.move_sweep(state, u)
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
    replay_ms = _time_ms(mc.capture_sweep(state).graph.replay, 3)
    print(f"phase5 per-move sweep: {move_sweep_s:.3f} s for {M} moves eager"
          f"; on the graph {' / '.join(f'{t:.4f}' for t in graph_s)} s "
          f"(replay alone {replay_ms:.3f} ms); capture {capture_s:.3f} s, "
          f"paid for after {capture_s / (move_sweep_s - min(graph_s)):.2f} "
          f"sweeps")
    fields = ("coords", "com", "quat", "sfac", "energy", "step", "att",
              "acc")
    diffs = {f: float((getattr(g, f).double() - getattr(s, f).double())
                      .abs().max()) for f in fields}
    print(f"phase5 graph sweep vs eager sweep on the same uniforms: largest "
          f"differences {diffs}")
    if not all(torch.equal(getattr(g, f), getattr(s, f)) for f in fields):
        raise AssertionError("the graph sweep and the eager sweep differ")
    acc, att = (s.acc - state.acc).float(), (s.att - state.att).float()
    mv = torch.cat([acc[:, :2], att[:, :2], fp[:, None]], 1)
    same = (mv == k[4][:, [1, 2, 3, 4, op.N_STATS - 1]]).all(dim=1)
    print(f"phase5 acc/att {mv[:, :4].sum(0).tolist()} vs whole sweep "
          f"{k[4][:, 1:5].sum(0).tolist()}")
    d_e = (s.energy - state.energy)[:, None]
    err = _check_match("5 per-move vs whole-sweep route", C, same,
                       (s.coords, s.com, s.sfac, d_e),
                       (k[0], k[1], k[3], k[4]), e_scale)

    # delta_energy against its plain version on the arguments the main
    # path gives it, then one wrapper call (host time included: the
    # kernels line's ms), one launch's device time (launches replayed
    # from a graph, so no host time enters: device_ms) and one plain call
    _, _, body = mc.move_bodies[0]
    m = M // 2
    pr = body.propose(state.com, state.quat, state.coords, state.box,
                      u[:, m], state.dr_max, state.dphi_max, m)
    args = body.delta_args(pr, state.coords, state.box, m)
    err_d = check_delta(f"5 delta_energy main path m={m}", args, body.P)
    R = args[3].shape[1]
    tensors = tuple(args[:7]) + tuple(args[8:16])
    outs = tuple(torch.empty((C, R), device=dev) for _ in range(3))

    device_ms = _graph_ms(lambda: dop._launch(tensors, m, args[16], outs),
                          20)
    ms = _time_ms(lambda: dop.delta_energy(*args), 20)
    plain_ms = _time_ms(lambda: dop.delta_energy_plain(*args), 3)
    frac = _cutoff_fraction(system, state, mc.params.r_cut)
    near = _reach_fraction(state.coords, state.com, system.atom_mol_slot[0],
                           state.box, max(mc.params.r_cut, mc.params.qq_cut),
                           n=64, m_ranges=[(m, 1)])[0]
    bound_ms, bound_by = delta_bound(args, body.P, frac, near)
    print(f"phase5 one delta_energy launch, {C} chains x "
          f"{args[0].shape[1]} lanes x {R} rows ({dop.THREADS} threads): "
          f"wrapper call with its host time {ms * 1e3:.3f} us, device time "
          f"{device_ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}; {near:.4f} of atoms within "
          f"the moved molecule's reach)")
    print(f"phase5: {time.perf_counter() - t_phase:.1f} s")
    return launches, err, err_d, ms, device_ms, plain_ms, bound_ms, bound_by


def _n_stats(state):
    """(mean, standard error over chains) of the chains' molecule count."""
    n = state.active.sum(1).double()
    return float(n.mean()), float(n.std() / math.sqrt(n.numel()))


def _active_cutoff_fraction(state, P, r_cut, n=8):
    """Share of the pairs of active atoms of different molecules within
    r_cut, from n chains spread evenly over the chain axis (TMMC walkers
    are stratified in N along it)."""
    fr = []
    C = state.active.shape[0]
    for c in sorted({round(i * (C - 1) / max(n - 1, 1)) for i in range(n)}):
        on = state.active[c].repeat_interleave(P)
        x = state.coords[c, :, :on.numel()][:, on].T                # (a, 3)
        d = x[:, None, :] - x[None, :, :]
        d = d - state.box[c] * torch.round(d / state.box[c])
        mol = torch.arange(state.active.shape[1],
                           device=x.device).repeat_interleave(P)[on]
        other = mol[:, None] != mol[None, :]
        if bool(other.any()):
            fr.append(float(((d * d).sum(-1) < r_cut ** 2)[other].float()
                            .mean()))
    return sum(fr) / max(len(fr), 1)


def muvt_blocks(tag, g, st, cycles, apc, launches_per_cycle):
    """run_blocks of a muVT app (MolGCMC, OsmoticGCMC) with the S(k),
    drift and acceptance gates and the launch count; returns (state,
    launches, [(N mean, s.e.)])."""
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    op.sweep.launches = 0
    trace = []
    for n_cyc in cycles:
        t0 = time.perf_counter()
        st, stats = g.run_block(st, n_cyc * apc)
        torch.cuda.synchronize()
        print(f"phase{tag} run_block({n_cyc} cycles): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v:.6g}" for k, v in stats.items()))
        if not stats["sfac_err_max"] < SFAC_ABS_TOL:
            raise AssertionError(f"S(k) error {stats['sfac_err_max']}")
        if not stats["drift_max_rel"] < DRIFT_TOL:
            raise AssertionError(f"drift {stats['drift_max_rel']}")
        for k in ("acc_trans", "acc_rot", "acc_insert", "acc_delete"):
            if not 0.0 < stats[k] < 1.0:
                raise AssertionError(f"{k} = {stats[k]}")
        trace.append(_n_stats(st))
    launches = op.sweep.launches
    if launches != launches_per_cycle * sum(cycles):
        raise AssertionError(f"{launches} launches for {sum(cycles)} cycles")
    print(f"phase{tag} main path: {sum(cycles)} cycles, {launches} kernel "
          f"launches, N " + ", ".join(f"{m:.3f} +- {e:.3f}"
                                      for m, e in trace))
    return st, launches, trace


def time_variant(tag, system, params, mc_tables, st, gen, n_exch, n_widom,
                 z_val, consts, tmmc=None, plain=True):
    """One launch of the sweep kernel per species block of `mc_tables` with
    the activity planes of `st` (a MolGCMCState, a SimState with every
    slot active, or any object with those fields and `active` (C, M)) and
    n_exch attempts and n_widom ghosts (ints, or one count per block; with
    tmmc = (eta, e_in) depositing): held against sweep_plain (the plain
    call timed), then the kernel timed, with the bound of this run's
    work.  plain=False times the kernel alone and returns (None, ms,
    None, bound ms, bound_by)."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = st.com.shape[:2]
    dev = st.com.device
    active = getattr(st, "active", None)
    if active is None:
        active = torch.ones((C, M), dtype=torch.bool, device=dev)
    act, actm = activity_planes(system, active)
    ones = torch.ones((C,), device=dev)
    f32 = torch.float32
    args = [x.to(f32).contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        params.temperature * ones, params.dr_max * ones,
        params.dphi_max * ones, draw_uniforms(C, M, gen, dev)]
    nb = len(mc_tables)
    n_exchs = tuple(n_exch) if isinstance(n_exch, tuple) else (n_exch,) * nb
    n_widoms = tuple(n_widom) if isinstance(n_widom, tuple) \
        else (n_widom,) * nb
    uxs = [draw_exchange_uniforms(C, x + w, gen, dev)
           for x, w in zip(n_exchs, n_widoms)]
    rest = (mc_tables, act, actm, n_exchs, n_widoms, uxs, z_val * ones,
            consts, 77)
    err = plain_ms = None
    if plain:
        held = []
        err = compare_variant(f"{tag} kernel vs plain", system, args, *rest,
                              tmmc=tmmc, plain_ms=held)
        plain_ms = held[0]
    out = run_variant(op.sweep, args, *rest, tmmc=tmmc)             # warm
    ms = _time_ms(lambda: run_variant(op.sweep, args, *rest, tmmc=tmmc), 3)
    n_del = sum(n_exchs) - float(out[4][:, 7].mean())
    view = SimpleNamespace(active=active, coords=st.coords, box=st.box,
                           com=st.com, sfac=st.sfac)
    frac = _active_cutoff_fraction(view, mc_tables[0].P, params.r_cut)
    near = _system_reach(system, params, view, mc_tables, active, n=8)
    n_acts = tuple(float(actm[:, t.m_start:t.m_start + t.M].sum(1).mean())
                   for t in mc_tables)
    n_act = sum(n_acts)
    bound_ms, bound_by = sweep_bound(
        system, mc_tables, view, frac, near, n_acts, n_exchs, n_widoms,
        sum(n_exchs) if tmmc is not None else n_del, tmmc=tmmc is not None,
        n_sq=float((actm.sum(1) ** 2).mean()) if nb == 1 else None)
    plain_txt = f"{plain_ms:.3f} ms" if plain else "not run"
    print(f"phase{tag} one launch{' (tmmc)' if tmmc is not None else ''}"
          f"{' per species block' if nb > 1 else ''}, "
          f"{C} chains, {n_act:.1f} of {M} slots active, {M} moves + "
          f"{sum(n_exchs)} attempts ({n_del:.1f} deletions) + "
          f"{sum(n_widoms)} ghosts: "
          f"kernel {ms:.3f} ms, sweep_plain {plain_txt}, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {frac:.4f} of active pairs "
          f"within the cutoff, {near[0]:.4f} of active atoms within a "
          f"pose's reach)")
    return err, ms, plain_ms, bound_ms, bound_by


def attempt_costs(system, params, tables, st, gen, n_exch, consts):
    """What an exchange attempt and its Philox scores cost: the kernel
    timed on one state with every attempt an insertion (no scores drawn)
    and with every attempt a deletion (one Philox word per active slot),
    all refused (an extreme activity at a temperature that switches the
    energies off) so that N stays put, against the masked sweep alone."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = st.com.shape[:2]
    dev = st.com.device
    act, actm = activity_planes(system, st.active)
    ones = torch.ones((C,), device=dev)
    # T = 1e9 K: beta du vanishes, so ln(z V) = -73 (insertions) or +86
    # (deletions) decides against ln u = -1e-6, whatever the pose; every
    # move is accepted, in all three launches alike
    args = [x.float().contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        1e9 * ones, params.dr_max * ones, params.dphi_max * ones,
        draw_uniforms(C, M, gen, dev)]
    ux = draw_exchange_uniforms(C, n_exch, gen, dev)
    ms = {}
    for name, kind, z_val, n in (("moves", 0.0, 1.0, 0),
                                 ("insert", 0.1, 1e-36, n_exch),
                                 ("delete", 0.9, 1e33, n_exch)):
        ux_k = ux.clone()
        ux_k[:, :, 0] = kind
        ux_k[:, :, 7] = 0.999999
        rest = (tables, act, actm, (n,), (0,), [ux_k], z_val * ones, consts,
                78)
        out = run_variant(op.sweep, args, *rest)                    # warm
        if float(out[4][:, 5:7].sum()) != 0.0:
            raise AssertionError(f"{name}: an attempt was accepted")
        ms[name] = _time_ms(lambda: run_variant(op.sweep, args, *rest), 3)
    n_act = float(actm.sum(1).mean())
    per_ins = (ms["insert"] - ms["moves"]) / n_exch
    per_del = (ms["delete"] - ms["moves"]) / n_exch
    print(f"phase6 attempt costs at {n_act:.1f} active slots, {C} chains: "
          f"moves alone {ms['moves']:.3f} ms, + {n_exch} refused insertions "
          f"{ms['insert']:.3f} ms ({1e3 * per_ins:.2f} us each), + {n_exch} "
          f"refused deletions {ms['delete']:.3f} ms ({1e3 * per_del:.2f} us "
          f"each): a deletion's slot scores (Philox) and old-pose read cost "
          f"{1e3 * (per_del - per_ins):+.2f} us against an insertion's "
          f"trial pose")


def phase6(dev, cap=512, box=25.0, chains=2048, n_init=256, r_cut=10.0,
           cycles=(2, 2, 2), chunk=16):
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    z, px = 2.2e-4, 0.3
    params = RunParams(temperature=500.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", nk=5, ksq_max=27, p_translate=0.5,
                       dr_max=0.4, dphi_max=0.4, use_lrc=False)
    system = spce_system(cap)
    x_per = max(1, int(round(cap * px / (1.0 - px))))
    apc = cap + x_per

    def build(mega, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return gen, MolGCMC(system, params, activity=z, p_exchange=px,
                            dtype=torch.float32, chunk=chunk, mega=mega,
                            device=dev, generator=gen)

    gen, g = build("full", 2029)
    t0 = time.perf_counter()
    st0 = g.init(box=box, n_init=n_init, n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase6 init: {time.perf_counter() - t0:.2f} s, capacity {cap}, "
          f"A_pad={st0.coords.shape[-1]}, K={st0.sfac.shape[1]}, x_per="
          f"{x_per}, E/N mean {float(st0.energy.mean()) / n_init:.2f} K")
    st, launches, n_full = muvt_blocks("6 full", g, st0, cycles, apc, 1)

    # the hybrid composition from the same start: the same Markov kernel
    # in distribution, so N after the same number of cycles must agree
    _, g_h = build(True, 2030)
    _, launches_h, n_hyb = muvt_blocks("6 hybrid", g_h, st0, cycles, apc, 1)
    for (m_f, e_f), (m_h, e_h) in zip(n_full, n_hyb):
        tol = 4.0 * math.hypot(e_f, e_h)
        print(f"phase6 N full {m_f:.3f} vs hybrid {m_h:.3f}: difference "
              f"{m_f - m_h:+.3f}, 4 combined standard errors {tol:.3f}")
        if not abs(m_f - m_h) < tol:
            raise AssertionError("full and hybrid N disagree")

    kv, kw = make_kvectors(params.nk, params.ksq_max)
    tables = sweep_tables(system, params, kv, kw, dev)
    consts = _exchange_consts(system, params, kv, kw, st.box)
    # N falls from the start's 256 during the blocks: the cycle is timed at
    # both ends, the path's last state going into the result line
    time_variant("6 full cycle at the start", system, params, tables, st0,
                 gen, x_per, 0, z, consts)
    attempt_costs(system, params, tables, st0, gen, x_per, consts)
    full = time_variant("6 full cycle", system, params, tables, st, gen,
                        x_per, 0, z, consts)
    masked = time_variant("6 masked sweep", system, params, tables, st, gen,
                          0, 0, z, consts)
    return (launches,) + full, (launches_h,) + masked


def phase7(dev, cap=64, box=8.0, z=0.039, chains=512, blocks=8, cycles=10):
    """The ideal rigid rotor through the in-kernel exchanges: N is
    Poisson(z V).  Gates from the sample count: blocks x chains samples
    count as a quarter as many independent ones (blocks are `cycles`
    cycles apart); the mean within 4 standard errors of z V, var/mean
    within 4 sqrt(2 / n_eff) of 1."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    params = RunParams(temperature=1.5, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=0.5, dr_max=1.0,
                       dphi_max=1.0, use_lrc=False, strict_min_image=False)
    gen = torch.Generator(device=dev).manual_seed(2031)
    g = MolGCMC(triatomic_system(cap, eps=0.0), params, activity=z,
                p_exchange=0.5, dtype=torch.float32, mega="full", device=dev,
                generator=gen)
    st = g.init(box=box, n_init=10, n_chains=chains)
    apc = cap + max(1, round(cap * 0.5 / 0.5))
    op.sweep.launches = 0
    st, _ = g.run_block(st, cycles * apc)                     # equilibrate
    ns = []
    for _ in range(blocks):
        st, stats = g.run_block(st, cycles * apc, drift_tol=1e-3)
        if stats["full_frac"] != 0.0:
            raise AssertionError("a chain reached capacity")
        ns.append(st.active.sum(1).double())
    if op.sweep.launches != (blocks + 1) * cycles:
        raise AssertionError(f"{op.sweep.launches} launches")
    ns = torch.cat(ns)
    zv = z * box ** 3
    n_eff = ns.numel() / 4.0
    mean, var = float(ns.mean()), float(ns.var())
    sem = math.sqrt(var / n_eff)
    ratio_tol = 4.0 * math.sqrt(2.0 / n_eff)
    print(f"phase7 ideal rotor: z V = {zv:.3f}, {ns.numel()} samples: <N> = "
          f"{mean:.3f} +- {sem:.3f} (gate 4 s.e. = {4 * sem:.3f}), var/mean "
          f"= {var / mean:.4f} (gate 1 +- {ratio_tol:.4f})")
    if not (abs(mean - zv) < 4.0 * sem
            and abs(var / mean - 1.0) < ratio_tol):
        raise AssertionError("N is not Poisson(z V)")
    return op.sweep.launches


def phase8(dev, n_mol=256, box=25.0, chains=2048, r_cut=10.0, calls=6,
           n_per_sweep=64):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    params = RunParams(temperature=500.0, r_cut=r_cut, coulomb="ewald",
                       nk=5, ksq_max=27, p_translate=0.5, dr_max=0.4,
                       dphi_max=0.4, use_lrc=False)
    system = spce_system(n_mol)
    gen = torch.Generator(device=dev).manual_seed(2032)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(n_mol, box), box=box, n_chains=chains)
    state, m = mc.run_block(state, 10)
    print(f"phase8 equilibration: drift {m['drift_max_rel']:.3e}, acc "
          f"{m['acc_trans']:.3f}/{m['acc_rot']:.3f}, E/N "
          f"{m['energy_mean'] / n_mol:.2f} K")
    op.sweep.launches = 0
    b_k, b_p = [], []
    for _ in range(calls):
        att0 = state.att.clone()
        state, out = mc.widom_mega(state, n_per_sweep=n_per_sweep)
        if not bool(((state.att - att0).sum(1) == n_mol).all()):
            raise AssertionError("att did not grow by M")
        b_k.append(out["boltzmann_mean"].double())
        b_p.append(mc.widom(state, n_per_sweep)["boltzmann_mean"].double())
    launches = op.sweep.launches
    if launches != calls:
        raise AssertionError(f"{launches} launches for {calls} calls")
    state, m = mc.run_block(state, 0)
    if not m["drift_max_rel"] <= DRIFT_TOL:
        raise AssertionError(f"drift {m['drift_max_rel']} after widom_mega")

    def beta_mu(bs):
        b = torch.stack(bs).mean(0)                  # per chain, over calls
        mean = float(b.mean())
        se = float(b.std() / math.sqrt(b.numel()))
        return -math.log(mean), se / mean

    (mu_k, se_k), (mu_p, se_p) = beta_mu(b_k), beta_mu(b_p)
    tol = 4.0 * math.hypot(se_k, se_p)
    print(f"phase8 beta mu_ex: widom_mega {mu_k:.4f} +- {se_k:.4f}, widom "
          f"{mu_p:.4f} +- {se_p:.4f} ({calls} x {n_per_sweep} ghosts x "
          f"{chains} chains each), difference {mu_k - mu_p:+.4f}, 4 combined "
          f"standard errors {tol:.4f}; drift after {m['drift_max_rel']:.3e}")
    if not (math.isfinite(mu_k) and abs(mu_k - mu_p) < tol):
        raise AssertionError("widom_mega and widom disagree")
    consts = _exchange_consts(system, params, mc.kvecs, mc.kweights,
                              state.box)
    timing = time_variant("8 sweep + ghosts", system, params, mc.tables,
                          state, gen, 0, n_per_sweep, 1.0, consts)
    return (launches,) + timing


def _first_chains(st, n):
    """The first n chains of a muVT state."""
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[:n]
                                      for f in dataclasses.fields(st)})


def _muvt_params(**kw):
    """Phase 6's state point: SPC/E at 500 K, r_cut 10 A, the flagship's
    Ewald (kappa L 5.6, nk 5, |k|^2 < 27), no tail."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    return RunParams(**dict(dict(
        temperature=500.0, r_cut=10.0, cutoff_mode="site", coulomb="ewald",
        nk=5, ksq_max=27, p_translate=0.5, dr_max=0.4, dphi_max=0.4,
        use_lrc=False), **kw))


def phase9(dev, cap=512, box=25.0, chains=2048, r_cut=10.0, melt=(1, 1),
           blocks=(2, 2, 2), chunk=16, hyb_chains=256):
    """The TMMC main path at full width: capacity-512 SPC/E, 2048 walkers
    stratified over N = 1..(7/8) cap, a fixed-N melt (MolGCMC p_exchange
    0, mega=True), then TMMCMol(mega="full") blocks with the bias
    refreshed per block (one launch per cycle of cap moves + x_per
    two-branch attempts).  Then the hybrid route with eta = 0 against
    MolGCMC(mega=True) from one state and one seed, one cycle against
    sweep_plain, and the cycle timed beside an n_exch launch."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import (
        MolGCMC,
        make_gcmc_mol,
    )
    from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    z, px = 2.2e-4, 0.3
    params = _muvt_params(r_cut=r_cut)
    system = spce_system(cap)
    x_per = max(1, int(round(cap * px / (1.0 - px))))
    apc = cap + x_per
    f32 = torch.float32
    n_init = np.linspace(1, cap * 7 // 8, chains).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(2033)
    g = MolGCMC(system, params, activity=z, p_exchange=0.0, dtype=f32,
                chunk=chunk, mega=True, device=dev, generator=gen)
    t0 = time.perf_counter()
    st = g.init(box=box, n_init=n_init, n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase9 init: {time.perf_counter() - t0:.2f} s, capacity {cap}, "
          f"{chains} walkers over N = {n_init[0]}..{n_init[-1]}, x_per "
          f"{x_per}")
    op.sweep.launches = 0
    for n_sw in melt:
        t0 = time.perf_counter()
        st, stats = g.run_block(st, n_sw * cap)
        torch.cuda.synchronize()
        print(f"phase9 melt run_block({n_sw} sweeps): "
              f"{time.perf_counter() - t0:.2f} s, drift "
              f"{stats['drift_max_rel']:.3e}, sfac err "
              f"{stats['sfac_err_max']:.3e}, acc {stats['acc_trans']:.3f}/"
              f"{stats['acc_rot']:.3f}")
        if not (stats["drift_max_rel"] < DRIFT_TOL
                and stats["sfac_err_max"] < SFAC_ABS_TOL):
            raise AssertionError(f"melt block failed its gates: {stats}")
    l_melt = op.sweep.launches
    if l_melt != sum(melt):
        raise AssertionError(f"{l_melt} melt launches")

    t = TMMCMol(system, params, activity=z, p_exchange=px, dtype=f32,
                chunk=chunk, mega="full", device=dev, generator=gen)
    op.sweep.launches = 0
    for n_cyc in blocks:
        t0 = time.perf_counter()
        st, stats = t.run_block(st, n_cyc * apc)
        torch.cuda.synchronize()
        print(f"phase9 tmmc run_block({n_cyc} cycles): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v:.6g}" for k, v in stats.items()))
        if not stats["sfac_err_max"] < SFAC_ABS_TOL:
            raise AssertionError(f"S(k) error {stats['sfac_err_max']}")
        if not stats["drift_max_rel"] < DRIFT_TOL:
            raise AssertionError(f"drift {stats['drift_max_rel']}")
        for k in ("acc_insert", "acc_delete"):
            if not 0.0 < stats[k] < 1.0:
                raise AssertionError(f"{k} = {stats[k]}")
    launches = op.sweep.launches
    if launches != sum(blocks):
        raise AssertionError(f"{launches} launches for {sum(blocks)} cycles")
    rows = t.cmat.sum(axis=1)[1:n_init[-1] + 1]
    cover = float(np.mean(rows > 0))
    lnpi = t.lnpi()
    print(f"phase9 main path: {sum(blocks)} cycles, {launches} kernel "
          f"launches; cmat rows with deposits {cover:.4f} of N = "
          f"1..{n_init[-1]}, {float(t.cmat.sum()):.0f} deposits, ln Pi "
          f"finite on {int(np.isfinite(lnpi).sum())} of {cap + 1} states")
    if not cover >= 0.9:
        raise AssertionError(f"cmat covers {cover} of the N range")

    # the hybrid route with eta = 0 is the muVT hybrid, chain for chain
    sub = _first_chains(st, hyb_chains)
    runs = []
    for tmmc in (True, False):
        g_h = torch.Generator(device=dev).manual_seed(2034)
        _, run, _ = make_gcmc_mol(system, params, z, px, f32, chunk,
                                  tmmc=tmmc, mega=True, device=dev,
                                  generator=g_h)
        t0 = time.perf_counter()
        runs.append(run(sub, np.zeros(cap + 1), apc)[0] if tmmc
                    else run(sub, apc))
        torch.cuda.synchronize()
        print(f"phase9 hybrid cycle (tmmc {tmmc}), {hyb_chains} chains: "
              f"{time.perf_counter() - t0:.2f} s")
    diff = [f.name for f in dataclasses.fields(sub)
            if not torch.equal(getattr(runs[0], f.name),
                               getattr(runs[1], f.name))]
    d_e = float((runs[0].energy - runs[1].energy).abs().max())
    print(f"phase9 hybrid eta = 0 vs MolGCMC(mega=True): fields differing "
          f"{diff}, largest energy difference {d_e:.3e} K, insertions "
          f"{int(runs[0].acc[:, 2].sum())}, deletions "
          f"{int(runs[0].acc[:, 3].sum())}")
    if diff:
        raise AssertionError(f"eta = 0 hybrid differs in {diff}")

    kv, kw = make_kvectors(params.nk, params.ksq_max)
    tables = sweep_tables(system, params, kv, kw, dev)
    consts = _exchange_consts(system, params, kv, kw, st.box)
    tm = (torch.tensor(t.eta, dtype=f32, device=dev),
          st.energy.float().contiguous())
    res = time_variant("9 tmmc cycle", system, params, tables, st, gen,
                       x_per, 0, z, consts, tmmc=tm)
    ms_x = time_variant("9 n_exch cycle, same state", system, params, tables,
                        st, gen, x_per, 0, z, consts, plain=False)[1]
    print(f"phase9 the second branch: tmmc cycle {res[1]:.3f} ms against the "
          f"n_exch cycle's {ms_x:.3f} ms on the same state "
          f"({res[1] - ms_x:+.3f} ms, {1e3 * (res[1] - ms_x) / x_per:.2f} us "
          f"per attempt)")
    return (launches,) + res, l_melt


def _ideal_lnpi_error(t, zv, tag):
    """Largest deviation of t's ln Pi from N ln(zV) - ln N! on its visited
    range (both gauged at its first state) and the range's size."""
    lnpi = t.lnpi()
    fin = np.where(np.isfinite(lnpi))[0]
    n = fin.astype(np.float64)
    exact = n * math.log(zv) - np.array([math.lgamma(x + 1.0) for x in n])
    dev_ = float(np.max(np.abs((lnpi[fin] - lnpi[fin[0]])
                               - (exact - exact[0]))))
    print(f"phase10 {tag}: ln Pi exact within {dev_:.3e} on N = "
          f"{fin[0]}..{fin[-1]} ({fin.size} states), z V = {zv:.3f}")
    if not (dev_ < 1e-3 and fin.size >= 8):
        raise AssertionError(f"{tag}: ln Pi is not the closed form")
    return dev_


def phase10_ideal(dev, chains=256, blocks=2, cycles=2):
    """Closed forms through the tmmc kernel: the ideal gas (monatomic,
    capacity 48, box 5, z = 0.08) and the ideal rigid rotor (capacity 64,
    box 8, z = 0.039); returns their launches."""
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMC, TMMCMol
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(2035)
    op.sweep.launches = 0
    gas = RunParams(strict_min_image=False, temperature=1.2, r_cut=2.5,
                    cutoff_mode="site", coulomb="none", p_translate=0.4,
                    dr_max=0.4, use_lrc=False)
    t = TMMC(lj_system(1, eps=0.0), gas, activity=0.08, capacity=48,
             dtype=f32, mega="full", device=dev, generator=gen)
    st = t.init(5.0, np.linspace(0, 48, chains).astype(np.int64), chains)
    for _ in range(blocks):
        st, _ = t.run_block(st, cycles * (48 + 72), drift_tol=1e-6)
    _ideal_lnpi_error(t, 0.08 * 5.0 ** 3, "ideal gas (TMMC, cap 48)")
    rotor = RunParams(temperature=1.5, r_cut=2.5, cutoff_mode="site",
                      coulomb="none", p_translate=0.5, dr_max=1.0,
                      dphi_max=1.0, use_lrc=False, strict_min_image=False)
    t = TMMCMol(triatomic_system(64, eps=0.0), rotor, activity=0.039,
                p_exchange=0.5, dtype=f32, mega="full", device=dev,
                generator=gen)
    st = t.init(8.0, np.linspace(0, 64, chains).astype(np.int64), chains)
    for _ in range(blocks):
        st, _ = t.run_block(st, cycles * (64 + 64), drift_tol=1e-6)
    _ideal_lnpi_error(t, 0.039 * 8.0 ** 3, "ideal rotor (TMMCMol, cap 64)")
    return op.sweep.launches


G_CC = 18.01528 * 1.66053907      # water molecules per A^3 -> g/cc


def phase10_spce(dev, cap=80, box=13.0, chains=128, melt=10, blocks=60,
                 steps=2500):
    """SPC/E vapour-liquid coexistence at 500 K by the protocol of
    docs/validation_torch/run_tmmc_water.py (its coexistence_run: the
    configs/tmmc_spce.json state point, n_orient 1): a fixed-N melt of
    stratified walkers, then TMMC blocks on the kernel route with a
    quarter discarded, and that script's gates.  Returns (tmmc launches,
    melt launches, results)."""
    if VALIDATION_DIR not in sys.path:
        sys.path.insert(0, VALIDATION_DIR)
    import run_tmmc_water

    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    counts = {}

    def mark(stage):
        # the launches since the last mark, then the count from 0 again
        counts[stage] = op.sweep.launches
        op.sweep.launches = 0

    t0 = time.perf_counter()
    r = run_tmmc_water.coexistence_run(
        dev, cap=cap, box=box, chains=chains, melt=melt, blocks=blocks,
        steps=steps, seed=2036, mark=mark, tag="phase10 spce ")
    l_melt, launches = counts["tmmc"], counts["end"]
    print(f"phase10 spce melt: {melt} blocks, {l_melt} launches, "
          f"{r['melt_s']:.1f} s, <E> {r['melt_energy']:.0f} K, acc "
          f"{r['melt_acc']:.3f}")
    ext, ok = r["ext"], r["ok"]
    print(f"phase10 spce coexistence (cap {cap}, box {box} A, {chains} "
          f"walkers, {melt} + {blocks} x {steps} steps, {launches} tmmc "
          f"launches, {time.perf_counter() - t0:.1f} s): z* = "
          f"{r['z_coex']:.4e} A^-3, rho_v = {r['rho_v']:.4f} g/cc, rho_l = "
          f"{r['rho_l']:.4f} g/cc, gamma = {r['gamma']:.1f} mN/m, coverage "
          f"{r['cover']:.2f}, residual {r['dlnw']:.1e}, max drift "
          f"{r['max_drift']:.1e}, max sfac err {r['max_sfac']:.1e}; 480 K: "
          f"rho_v {ext[480.0][1]:.4f} rho_l {ext[480.0][2]:.4f}, 520 K: "
          f"rho_v {ext[520.0][1]:.4f} rho_l {ext[520.0][2]:.4f}; gates {ok}")
    if not all(ok.values()):
        raise AssertionError(f"SPC/E coexistence gates failed: {ok}")
    return launches, l_melt, {k: r[k] for k in ("z_coex", "rho_v", "rho_l",
                                                "gamma")}


# the Gibbs-ensemble densities of docs/validation/tmmc_coexistence.txt and
# that validation's bands
GIBBS_RHO_V, GIBBS_RHO_L = 0.0548, 0.6350


def phase10_lj(dev, cap=192, box=6.0, chains=256, blocks=48, steps=5000):
    """Cut LJ at T = 1.0 by the TMMC side of
    docs/validation/run_tmmc_coexistence.py on the kernel route, held to
    the Gibbs densities recorded there; then one GCMC(mega="full") block
    of the same model with its drift gate.  Returns (tmmc launches, gcmc
    launches, results)."""
    from metropolismontecarlo_tpu_torch.mc.gcmc import GCMC
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMC, coexistence
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    z0 = 0.03
    f32 = torch.float32
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.4,
                       dr_max=0.35, use_lrc=False)
    gen = torch.Generator(device=dev).manual_seed(2037)
    t = TMMC(lj_system(1), params, activity=z0, capacity=cap, dtype=f32,
             mega="full", device=dev, generator=gen)
    st = t.init(box, cap // 2, chains)
    t0 = time.perf_counter()
    op.sweep.launches = 0
    for b in range(blocks):
        st, stats = t.run_block(st, steps, drift_tol=1e-3)
        if b % 8 == 7:
            print(f"phase10 lj block {b}: N [{stats['n_min']},"
                  f"{stats['n_max']}] visited {stats['visited_frac']:.2f} "
                  f"drift {stats['drift_max_rel']:.1e} "
                  f"({time.perf_counter() - t0:.0f} s)")
    launches = op.sweep.launches
    res = coexistence(t.lnpi(), z0, box ** 3)
    d_v = abs(res["rho_vap"] - GIBBS_RHO_V)
    d_l = abs(res["rho_liq"] - GIBBS_RHO_L)
    print(f"phase10 lj coexistence (cap {cap}, box {box}, {chains} walkers,"
          f" {blocks} x {steps} steps, {launches} tmmc launches, "
          f"{time.perf_counter() - t0:.1f} s): z* = {res['z_coex']:.5f}, "
          f"rho_v = {res['rho_vap']:.4f} (Gibbs {GIBBS_RHO_V}, |d| "
          f"{d_v:.4f} < 0.02), rho_l = {res['rho_liq']:.4f} (Gibbs "
          f"{GIBBS_RHO_L}, |d| {d_l:.4f} < 0.05), visited "
          f"{stats['visited_frac']:.2f}, residual {res['dlnw']:.1e}")
    if not (d_v < 0.02 and d_l < 0.05):
        raise AssertionError("LJ coexistence densities off the Gibbs ones")

    g = GCMC(lj_system(1), params, activity=z0, capacity=cap, dtype=f32,
             mega="full", device=dev, generator=gen)
    sg = g.init(box, cap // 2, chains)
    op.sweep.launches = 0
    sg, stats = g.run_block(sg, steps, drift_tol=1e-3)
    l_gcmc = op.sweep.launches
    print(f"phase10 lj GCMC(mega='full') block: {l_gcmc} launches, " +
          ", ".join(f"{k} {v:.6g}" for k, v in stats.items()))
    if not (0.0 < stats["acc_insert"] < 1.0 and 0.0 < stats["acc_delete"]
            < 1.0):
        raise AssertionError(f"GCMC acceptances {stats}")
    return launches, l_gcmc, dict(z_coex=res["z_coex"],
                                  rho_v=res["rho_vap"], rho_l=res["rho_liq"])


def phase11(dev, n_mol=6859, box=59.056, chains=256, r_cut=10.0, nk=11,
            ksq_max=118, melt=2, blocks=2, twin_moves=512):
    """The large-system NVT main path: 6859 SPC/E waters (20577 atoms) on
    a 19^3 lattice at the flagship's density with random orientations,
    the flagship's Ewald truncation carried to the larger box (kappa L
    11.711, nk 11, |k|^2 < 118: K = 2874), slab_mode "auto", 256 chains:
    init_state (the row-tiled recompute), a melt block with adaptation,
    retune_slabs, a measured block; one sweep timed on the slab route and
    on the dense global layout (slab_mode "off") from the same state and
    uniforms; the kernel against sweep_plain over the first twin_moves
    molecules of every chain, slab and dense; a one-sweep block on the
    dense global route as its main path."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t_phase = time.perf_counter()
    system = spce_system(n_mol)
    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       kappa_L=5.6 * box / 28.24, nk=nk, ksq_max=ksq_max,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(2031)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    op.sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cfg = mc._slab_cfg
    K = state.sfac.shape[1]
    if cfg is None or not cfg["W"] < cfg["A_blk"]:
        raise AssertionError(f"slab configuration {cfg}")
    w_init = cfg["W"]
    print(f"phase11 init_state: {t_init:.2f} s (the row-tiled recompute of "
          f"{chains} chains in chunks of {mc.recompute_chunk}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB), "
          f"A {system.n_atoms}, A_pad {system.n_atoms_padded}, K {K}, "
          f"W {cfg['W']} of A_blk {cfg['A_blk']}, A_store {cfg['A_store']}, "
          f"E/N mean {float(state.energy.mean()) / n_mol:.2f} K")
    # the melt: the lattice start's energy crosses zero in its first
    # sweeps, where a relative drift says nothing, so this block's drift is
    # printed, not gated
    t0 = time.perf_counter()
    state, m = mc.run_block(state, melt, adjust=True)
    torch.cuda.synchronize()
    print(f"phase11 melt run_block({melt}, adjust=True): "
          f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
              f"{k} {v:.6g}" for k, v in m.items()))
    needed = int(state.nbr_needed.max())
    state = mc.retune_slabs(state)
    cfg = mc._slab_cfg
    if cfg is None or not cfg["W"] < cfg["A_blk"]:
        raise AssertionError(f"slab configuration after retune {cfg}")
    print(f"phase11 retune_slabs: W {w_init} -> {cfg['W']} (A_store "
          f"{cfg['A_store']}); max nbr_needed over the melt {needed}")
    state, launches = main_path("11", mc, state, ((blocks, False),), 1,
                                op.sweep, reset=False)
    needed = int(state.nbr_needed.max())
    print(f"phase11 main path: {launches} slab launches; max nbr_needed "
          f"{needed} of W {cfg['W']}; {time.perf_counter() - t_phase:.1f} s "
          f"so far")

    # one sweep on the slab route and on the dense global layout, from the
    # same resorted state and uniforms
    u = draw_uniforms(chains, n_mol, gen, dev)
    state_s, args = _slab_args(mc, state, u)
    dense = sweep_tables(system, params, mc.kvecs, mc.kweights, dev)
    args_d = _sweep_args(state_s, u)
    ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, mc.tables), 1)
    ms_d = _time_ms(lambda: sweep_blocks(op.sweep, *args_d, dense), 1)
    frac = _cutoff_fraction_tiled(system, state_s, params.r_cut)
    near = _system_reach(system, params, state_s, mc.tables, n=1)
    lanes = [slab_lanes(system, t) for t in mc.tables]
    bound, by = sweep_bound(system, mc.tables, state_s, frac, near,
                            lanes=lanes, A_plane=cfg["A_store"])
    bound_d, by_d = sweep_bound(system, dense, state_s, frac, near)
    print(f"phase11 one sweep of {chains} chains x {n_mol} moves: slab "
          f"{ms:.3f} ms (bound {bound:.3f} ms, {by}; {lanes[0]:.1f} lanes "
          f"per move), dense global {ms_d:.3f} ms (bound {bound_d:.3f} ms, "
          f"{by_d}; {system.n_atoms - 3} lanes), dense / slab "
          f"{ms_d / ms:.3f}; {frac:.5f} of pairs within the cutoff, "
          f"{near[0]:.5f} of atoms within a pose's reach")

    # the kernel against its twin over the first twin_moves molecules
    # (their windows wrap through the ghost halo)
    part = [dataclasses.replace(t, M=twin_moves) for t in mc.tables]
    part_d = [dataclasses.replace(t, M=twin_moves) for t in dense]
    err, k, _ = compare_tables("11 slab kernel vs plain", args, part)
    check_halo("11", k[0], system, cfg)
    err_d, _, _ = compare_tables("11 dense global kernel vs plain", args_d,
                              part_d)
    t_ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, part), 1)
    t_plain = _time_ms(lambda: sweep_blocks(op.sweep_plain, *args, part), 1)
    td_ms = _time_ms(lambda: sweep_blocks(op.sweep, *args_d, part_d), 1)
    td_plain = _time_ms(lambda: sweep_blocks(op.sweep_plain, *args_d,
                                             part_d), 1)
    p_bound = sweep_bound(system, part, state_s, frac, near, lanes=[
        slab_lanes(system, t) for t in part], A_plane=cfg["A_store"])
    pd_bound = sweep_bound(system, part_d, state_s, frac, near)
    print(f"phase11 {twin_moves} moves x {chains} chains: slab kernel "
          f"{t_ms:.3f} ms, sweep_plain {t_plain:.3f} ms, bound "
          f"{p_bound[0]:.3f} ms; dense global kernel {td_ms:.3f} ms, "
          f"sweep_plain {td_plain:.3f} ms, bound {pd_bound[0]:.3f} ms")

    # the dense global layout's main path: slab_mode "off"
    gen_off = torch.Generator(device=dev).manual_seed(2032)
    mc_off = MonteCarlo(system, dataclasses.replace(params, slab_mode="off"),
                        device=dev, generator=gen_off)
    _, launches_d = main_path("11 dense", mc_off, state_s, ((1, False),),
                              1, op.sweep)
    print(f"phase11 total {time.perf_counter() - t_phase:.1f} s")
    return ((launches, err, t_ms, t_plain) + p_bound,
            (launches_d, err_d, td_ms, td_plain) + pd_bound)


P_BAR = 1.0e5 / 1.380649e-23 * 1e-30      # 1 bar in K / A^3


def phase12(dev, n_mol=750, box=28.24, chains=2048, r_cut=10.0,
            blocks=((20, True), (20, False), (20, False))):
    """NPT at bench.py's "npt" parameters on the flagship lattice (750
    SPC/E waters, Ewald, 1 bar, p_volume 0.05, dv_max 0.01), 2048 chains:
    a melt block with adaptation and two measured blocks (one volume
    attempt per chain per block), <V>; then pressure_fd (float64) against
    the virial pressure M T / V + W / (3 V) of the final state, chain by
    chain."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t_phase = time.perf_counter()
    system = spce_system(n_mol)
    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3,
                       pressure=P_BAR, p_volume=0.05, dv_max=0.01)
    gen = torch.Generator(device=dev).manual_seed(2033)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    op.sweep.launches = 0
    vols = []
    for i, block in enumerate(blocks):
        state, _ = main_path("12", mc, state, (block,), 1, op.sweep,
                             reset=False)
        if not block[1]:
            acc_vol = float(((state.acc[:, 2]).float()
                             / state.att[:, 2].clamp_min(1)).mean())
            vols.append(float((state.box ** 3).mean()))
            print(f"phase12 block {i}: acc_vol {acc_vol:.4f} (one attempt "
                  f"per chain per 20 sweeps), <V> {vols[-1]:.2f} A^3")
    launches = op.sweep.launches
    att = int(state.att[:, 2].sum())
    if att != chains * 2 or not 0.0 < acc_vol < 1.0:
        raise AssertionError(f"volume attempts {att}, acc_vol {acc_vol}")
    vol = state.box.double() ** 3
    p_vir = (n_mol * state.temp.double() / vol
             + state.virial.double() / (3.0 * vol))
    # pressure_fd differentiates the sampled energy, whose truncation at
    # r_cut jumps where a site pair crosses the cutoff: an eps that moves
    # pairs by ~1e-4 A crosses dozens per chain and adds their impulse
    # (~1e2 bar at 750 waters) and noise (~1e3 bar per chain) that the
    # virial has not.  A float64 difference at eps 1e-9 moves pairs by
    # ~3e-9 A: a chain crosses a pair with probability ~5e-4, and the
    # other chains' pressure_fd is the virial's to f64 precision.
    mc64 = MonteCarlo(system, params, device=dev, dtype=torch.float64,
                      kernel="plain")
    f64 = {f.name: getattr(state, f.name).double()
           for f in dataclasses.fields(state)
           if getattr(state, f.name).is_floating_point()}
    t0 = time.perf_counter()
    p_fd = mc64.pressure_fd(dataclasses.replace(state, **f64),
                            rel_eps=1e-9)
    torch.cuda.synchronize()
    agree = (p_fd - p_vir).abs() < P_BAR
    se = math.sqrt(float(p_vir.var()) / chains)
    gap = abs(float(p_fd[agree].mean()) - float(p_vir.mean()))
    print(f"phase12 pressure: virial {float(p_vir.mean()) / P_BAR:.3f} bar "
          f"+- {se / P_BAR:.3f} (chain-to-chain standard error); "
          f"pressure_fd within 1 bar of it on {int(agree.sum())} of "
          f"{chains} chains (median difference "
          f"{float((p_fd - p_vir).abs().median()) / P_BAR:.2e} bar), whose "
          f"mean {float(p_fd[agree].mean()) / P_BAR:.3f} bar is "
          f"{gap / P_BAR:.3f} bar from the virial mean (pressure_fd in "
          f"float64, eps 1e-9: {time.perf_counter() - t0:.2f} s)")
    if not (float(agree.float().mean()) >= MATCH_FRACTION and gap <= se):
        raise AssertionError("pressure_fd and the virial pressure disagree")
    print(f"phase12 main path: {launches} kernel launches, mean box "
          f"{float(state.box.mean()):.4f} A; total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------- the Gibbs ensemble ----------------------------------------

GIBBS_MAX_DIFFERING = 2     # of 64 chains, phase 2's Gibbs cases
GIBBS_SFAC_TOL = 1e-5       # S(k) against the twin, of the chain's S(k) norm


def gibbs_planes(system, boxes, n_act, gen, dev, kvecs):
    """A two-box f32 state of `system` (one box's contents) in the Gibbs
    op's layout: lattice COMs, random orientations, the first
    n_act[c, b, s] slots of species block s active in box b of chain c,
    S(k) of the active charges (one zero row without k-vectors).
    Returns (coords, com, quat, sfac, box2, act, actm)."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.moves import activity_planes
    from metropolismontecarlo_tpu_torch.ops.ewald import structure_factor
    from metropolismontecarlo_tpu_torch.ops.quaternions import (
        random_quaternion,
        rotate_vectors,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    C, M = n_act.shape[0], system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    com = torch.stack([torch.tensor(cubic_lattice(M, b), **f32)
                       for b in boxes])[None].expand(C, 2, M, 3)
    quat = random_quaternion(gen, (C, 2, M))
    ra = com[..., None, :] + rotate_vectors(
        quat, torch.tensor(np.asarray(system.body), **f32))
    mol, slot = system.atom_mol_slot
    coords = torch.zeros((C, 2, 3, A_pad), **f32)
    coords[..., :A] = ra[:, :, mol, slot].transpose(2, 3)
    active = torch.zeros((C, 2, M), dtype=torch.bool, device=dev)
    j = torch.arange(M, device=dev)
    for s, (_, m0, m1, _, _) in enumerate(system.species_slices):
        blk = (j >= m0) & (j < m1)
        active |= blk & (j - m0 < n_act[:, :, s, None].to(dev))
    act, actm = activity_planes(system, active.reshape(2 * C, M))
    act, actm = act.reshape(C, 2, A_pad), actm.reshape(C, 2, M)
    box2 = torch.tensor(boxes, **f32)[None].expand(C, 2).contiguous()
    if kvecs is None:
        sfac = torch.zeros((C, 2, 1, 2), **f32)
    else:
        q = torch.zeros(A_pad, **f32)
        q[:A] = torch.tensor(system.flat(system.charges), **f32)
        sfac = structure_factor(coords.transpose(2, 3), q * act,
                                torch.tensor(kvecs, device=dev), box2)
    return (coords.contiguous(), com.contiguous(), quat.contiguous(),
            sfac.contiguous(), box2, act.contiguous(), actm.contiguous())


def gibbs_consts(system, params, kvecs, kweights, box2):
    """Per species block (si2, wc2), each (C, 2): the exchange constants
    of each box."""
    C = box2.shape[0]
    return [(si.reshape(C, 2), wc.reshape(C, 2)) for si, wc in
            _exchange_consts(system, params, kvecs, kweights,
                             box2.reshape(-1))]


def run_gibbs(op_fn, args, us, tables, act, actm, n_exchs, uxs, consts,
              seed, chain0=0):
    """One Gibbs call per species block of `op_fn` (sweep_gibbs or
    sweep_gibbs_plain), threading the state and the activity planes;
    returns (coords, com, quat, sfac, stats summed, act, actm).  chain0:
    the Philox scores' global index of chain 0."""
    args, stats = list(args), None
    for b, t in enumerate(tables):
        out = op_fn(*args, us[b], t, act, actm, n_exch=n_exchs[b],
                    ux=uxs[b], si2=consts[b][0], wc2=consts[b][1],
                    seed=seed + b, chain0=chain0)
        args[:4], (st, act, actm) = list(out[:4]), out[4:]
        stats = st if stats is None else stats + st
    return tuple(args[:4]) + (stats, act, actm)


def compare_gibbs(tag, args, us, tables, act, actm, n_exchs, uxs, consts,
                  seed, max_differing=None, plain_ms=None, chain0=0):
    """The Gibbs kernel against sweep_gibbs_plain on the same arguments:
    chains with identical decisions (equal acc/att counts, transfers and
    fingerprint) are compared field by field; N is conserved on every
    chain of both.  max_differing: the most chains allowed to differ
    (default: MATCH_FRACTION of them must agree).  Returns the largest
    absolute difference of the matched chains' outputs (A, and the
    energy's and S(k)'s relative errors).  plain_ms: a list that receives
    the plain call's ms."""
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op

    rest = (us, tables, act, actm, n_exchs, uxs, consts, seed)
    k = run_gibbs(op.sweep_gibbs, args, *rest, chain0=chain0)
    out = []
    ms = _time_ms(lambda: out.append(run_gibbs(functools.partial(
        op.sweep_gibbs_plain, magnitude=True), args, *rest,
        chain0=chain0)), 1)
    p = out[0]
    if plain_ms is not None:
        plain_ms.append(ms)
    torch.cuda.synchronize()
    C = act.shape[0]
    same = (k[4][:, 2:8] == p[4][:, 2:op.N_STATS]).all(dim=1)
    n_diff = int((~same).sum())
    n_in = actm.sum((1, 2))
    conserved = torch.equal(k[6].sum((1, 2)), n_in) \
        and torch.equal(p[6].sum((1, 2)), n_in)
    pos = max(float((k[i] - p[i])[same].abs().max()) for i in (0, 1, 2))
    mag = p[4][:, op.N_STATS].clamp_min(1.0)
    e_rel = float(((k[4][:, :2] - p[4][:, :2]).abs()
                   / mag[:, None])[same].max())
    s_norm = torch.clamp_min(torch.linalg.vector_norm(
        p[3].flatten(2), dim=2), SFAC_NORM_FLOOR)                 # (C, 2)
    s_rel = float(((k[3] - p[3]).flatten(2).abs().max(dim=2).values
                   / s_norm)[same].max())
    planes = torch.equal(k[5][same], p[5][same]) \
        and torch.equal(k[6][same], p[6][same])
    finite = all(bool(torch.isfinite(x).all()) for x in k)
    print(f"phase {tag}: chains {C}, differing {n_diff}, acc/att moves "
          f"{k[4][:, 2:6].sum(0).tolist()}, transfers accepted "
          f"{float(k[4][:, 6].sum()):.0f} of {C * sum(n_exchs)}, N box 0 "
          f"{float(actm[:, 0].sum(1).float().mean()):.2f} -> "
          f"{float(k[6][:, 0].sum(1).float().mean()):.2f}; coord/com/quat "
          f"err {pos:.3e}, energy err {e_rel:.3e} of the cycle's energy "
          f"scale, S(k) err {s_rel:.3e} of its norm, activity planes equal "
          f"{planes}, N conserved {conserved}")
    allowed = max_differing if max_differing is not None \
        else (1.0 - MATCH_FRACTION) * C
    if not (n_diff <= allowed and conserved and finite and planes
            and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= GIBBS_SFAC_TOL):
        raise AssertionError(f"{tag}: the Gibbs kernel and its plain "
                             f"version disagree")
    return max(pos, e_rel, s_rel), k


def _gibbs_case(dev, system, params, boxes, chains, seed, n_exch,
                one_in_box0=False):
    """Phase 2 inputs of one Gibbs case: random N per chain and box, chain
    0 with box 1 empty and chain 1 with box 0 full, each of their attempts
    directed box 1 -> 0 (an empty source, a full destination).  With
    one_in_box0 (one species block), every chain's box 0 holds one active
    slot and box 1 at least one."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_exchange_uniforms,
        draw_uniforms,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    gen = torch.Generator(device=dev).manual_seed(seed)
    kv, kw = make_kvectors(params.nk, params.ksq_max) \
        if params.coulomb == "ewald" else (None, None)
    tables = sweep_tables(system, params, kv, kw, dev)
    caps = [t.M for t in tables]
    rng = np.random.default_rng(seed)
    n_act = np.stack([rng.integers(0, cap + 1, (chains, 2))
                      for cap in caps], axis=2)                   # (C, 2, S)
    if one_in_box0:
        n_act[:, 0] = 1
        n_act[:, 1] = np.maximum(n_act[:, 1], 1)
    else:
        n_act[0, 1] = 0
        n_act[0, 0] = caps
        n_act[1, 0] = caps
    n_act = torch.tensor(n_act)
    coords, com, quat, sfac, box2, act, actm = gibbs_planes(
        system, boxes, n_act, gen, dev, kv)
    ones = torch.ones((chains,), device=dev)
    args = [coords, com, quat, sfac, box2, params.temperature * ones,
            params.dr_max * ones, params.dphi_max * ones]
    us = [draw_uniforms(chains, 2 * t.M, gen, dev) for t in tables]
    uxs = []
    for _ in tables:
        ux = draw_exchange_uniforms(chains, n_exch, gen, dev)
        if not one_in_box0:
            ux[:2, :, 0] = 0.9
        uxs.append(ux)
    consts = gibbs_consts(system, params, kv, kw, box2)
    return args, us, tables, act, actm, [n_exch] * len(tables), uxs, consts


def gibbs_water():
    """Phase 2's Gibbs SPC/E RunParams keywords: 500 K, site cutoff 5 A,
    Ewald tuned to 1e-3 at the larger box (14 A)."""
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    kl, nk, ksq = tune_parameters(14.0, 5.0, 1e-3)
    return dict(temperature=500.0, r_cut=5.0, cutoff_mode="site",
                coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                p_translate=0.5, dr_max=0.3, dphi_max=0.4, use_lrc=False,
                strict_min_image=False)


def phase2_gibbs(dev, chains=64):
    """The Gibbs kernel against sweep_gibbs_plain on shared uniforms and
    Philox scores, unequal boxes, 64 chains (one with an empty source box,
    one with a full destination box): SPC/E cap 32 with Ewald and with
    Wolf, the linear-shift triatomic cap 16 without charges, LJ cap 64,
    a two-block CO2/N2 case through m_start / a_start, and SPC/E cap 32
    with the linear LJ shift under Ewald and Wolf and with bare Coulomb
    with and without it: every <Coulomb form, linear LJ> instantiation
    of the kernel runs."""
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    t0 = time.perf_counter()
    water = gibbs_water()
    kl2, nk2, ksq2 = tune_parameters(24.0, 7.0, 1e-3)
    cases = (
        ("spce-32 ewald", spce_system(32), RunParams(**water),
         (10.5, 14.0), 24),
        ("spce-32 wolf", spce_system(32),
         RunParams(**dict(water, coulomb="wolf", kappa_L=2.0)),
         (10.5, 14.0), 24),
        ("triatomic-16 none linear", triatomic_system(16),
         RunParams(**dict(water, temperature=2.0, r_cut=2.5,
                          coulomb="none", lj_shift="linear",
                          dphi_max=0.5)), (4.5, 6.0), 12),
        ("lj-64", lj_system(64),
         RunParams(**dict(water, temperature=1.5, r_cut=2.5,
                          coulomb="none", p_translate=1.0)), (5.0, 6.5),
         40),
        ("co2/n2 24+8", co2_n2_system(24, 8),
         RunParams(**dict(water, temperature=300.0, r_cut=7.0, kappa_L=kl2,
                          nk=nk2, ksq_max=ksq2, dr_max=0.5)), (18.0, 24.0),
         10),
        ("spce-32 ewald linear", spce_system(32),
         RunParams(**dict(water, lj_shift="linear")), (10.5, 14.0), 24),
        ("spce-32 wolf linear", spce_system(32),
         RunParams(**dict(water, coulomb="wolf", kappa_L=2.0,
                          lj_shift="linear")), (10.5, 14.0), 24),
        ("spce-32 bare", spce_system(32),
         RunParams(**dict(water, coulomb="bare")), (10.5, 14.0), 24),
        ("spce-32 bare linear", spce_system(32),
         RunParams(**dict(water, coulomb="bare", lj_shift="linear")),
         (10.5, 14.0), 24),
    )
    err = 0.0
    for i, (tag, system, params, boxes, n_exch) in enumerate(cases):
        inputs = _gibbs_case(dev, system, params, boxes, chains, 3100 + i,
                             n_exch)
        e, _ = compare_gibbs(f"2g {tag}", *inputs, seed=91 + i,
                             max_differing=GIBBS_MAX_DIFFERING)
        err = max(err, e)
    print(f"phase 2 Gibbs cases: {time.perf_counter() - t0:.1f} s")
    return err


def gibbs_stress_cases():
    """Phase 2's stress cases for the Gibbs kernel's queues, reach ring and
    move skips, SPC/E cap 32 per box: (tag, system, params, boxes, n_exch,
    one_in_box0).  Every site pair inside the cutoff in both boxes (r_cut
    above L sqrt(3) / 2 of the larger box: every queue fills on every
    chunk); dilute boxes with no pair inside it; split LJ and Coulomb
    cutoffs; a box 0 whose every atom lies within every pose's reach (r_cut
    + the pose's radius above its L sqrt(3) / 2, r_cut below it: the near
    ring holds every lane, not every pair is live); box 0 with one active
    slot of 32 (31 null moves skipped, its one molecule transferred out)."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    water = gibbs_water()
    kl16, nk16, ksq16 = tune_parameters(16.0, 8.0, 1e-3)
    box_w = 28.24 * (32 / 750) ** (1 / 3)      # the flagship's density
    return [
        ("all pairs in cutoff spce32 wolf", spce_system(32),
         RunParams(**dict(water, coulomb="wolf", kappa_L=2.0,
                          r_cut=11.0 * 3 ** 0.5 / 2 + 0.1)), (10.0, 11.0),
         24, False),
        ("dilute spce32 ewald", spce_system(32),
         RunParams(**dict(water, r_cut=6.0)), (40.0, 44.0), 24, False),
        ("split cutoff spce32 ewald", spce_system(32),
         RunParams(**dict(water, r_cut=4.5, qq_r_cut=6.0)), (10.5, 14.0),
         24, False),
        ("reach holds every atom spce32 ewald", spce_system(32),
         RunParams(**dict(water, r_cut=8.0, kappa_L=kl16, nk=nk16,
                          ksq_max=ksq16)), (box_w, 16.0), 24, False),
        ("one active slot spce32 ewald", spce_system(32), RunParams(**water),
         (10.5, 14.0), 24, True),
    ]


def _to_device(x, dev):
    """x with every tensor in it (in lists, tuples and the kernels' table
    dataclasses) moved to dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def gibbs_stress_inputs(dev, i, chains=STRESS_CHAINS):
    """Gibbs stress case i (gibbs_stress_cases) and its inputs (as
    _gibbs_case's) at seed 3150 + i, drawn on the CPU and moved to dev: a
    run on the CPU builds the states that the card compares."""
    import warnings

    case = gibbs_stress_cases()[i]
    _, system, params, boxes, n_exch, one = case
    with warnings.catch_warnings():
        # the all-pairs case samples the truncated nearest image
        warnings.simplefilter("ignore")
        inputs = _gibbs_case("cpu", system, params, boxes, chains, 3150 + i,
                             n_exch, one_in_box0=one)
    return case, _to_device(inputs, dev)


def phase2_gibbs_stress(dev):
    """gibbs_stress_cases against sweep_gibbs_plain at the phase 2 Gibbs
    gates.  Returns the largest error of the matched chains."""
    t0 = time.perf_counter()
    err = 0.0
    for i in range(len(gibbs_stress_cases())):
        (tag, system, params, *_), inputs = gibbs_stress_inputs(dev, i)
        args, actm = inputs[0], inputs[4]
        frac = _gibbs_cutoff_fraction(system, args[0], actm > 0.5, args[4],
                                      max(params.r_cut, params.qq_cut))
        print(f"phase 2g {tag}: {frac[0]:.4f} / {frac[1]:.4f} of active "
              f"pairs within {max(params.r_cut, params.qq_cut):.3f} A, "
              f"N box 0 {float(inputs[4][:, 0].sum(1).mean()):.2f}")
        e, _ = compare_gibbs(f"2g {tag}", *inputs, seed=150 + i,
                             max_differing=GIBBS_MAX_DIFFERING)
        err = max(err, e)
    print(f"phase 2 Gibbs stress cases: {time.perf_counter() - t0:.1f} s")
    return err


def _gibbs_flagship(p_volume=0.002, cap=128):
    """bench.py's "gibbs" configuration: SPC/E, cap 128 per box, T 450 K,
    the liquid box at 0.0267 /A^3 with 2 cap / 3 molecules, an 18 A vapour
    box with cap / 6, r_cut min(7.5, 0.45 L), Ewald tuned at the largest
    box a volume exchange can reach, p_transfer 0.3, dv_max 0.03."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    n_l, n_v = (2 * cap) // 3, cap // 6
    box_l = (n_l / 0.0267) ** (1.0 / 3.0)
    box_v = 18.0
    r_cut = min(7.5, 0.45 * box_l)
    box_max = (box_l ** 3 + box_v ** 3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(box_max, r_cut, 1e-3)
    params = RunParams(temperature=450.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.4,
                       p_volume=p_volume, use_lrc=False,
                       strict_min_image=False)
    return params, (box_l, box_v), (n_l, n_v)


def _gibbs_cutoff_fraction(system, coords, active, box2, r_cut, n=4):
    """Per box, the share of active atom pairs of different molecules
    within r_cut, from the first n chains."""
    A = system.n_atoms
    mol = torch.as_tensor(system.atom_mol_slot[0], device=coords.device)
    out = []
    for b in range(2):
        x = coords[:n, b, :, :A].transpose(1, 2)
        L = box2[:n, b, None, None, None]
        d = x[:, :, None, :] - x[:, None, :, :]
        d = d - L * torch.round(d / L)
        d2 = (d * d).sum(-1)
        on = active[:n, b][:, mol]
        pair = on[:, :, None] & on[:, None, :] & (mol[:, None]
                                                  != mol[None, :])
        out.append(float((d2 < r_cut ** 2)[pair].float().mean())
                   if bool(pair.any()) else 0.0)
    return out


def gibbs_bound(t, C, A_off, m_off, K, n_box, frac, near, n_exch,
                n_move=None):
    """The least time (ms) of one Gibbs launch, and what sets it: the
    chain state in and out once, the uniforms and constants read once,
    against the operations the pair and k-space sums need (OPS_*): each
    active slot of box b moves once, its old and new poses summed against
    the other active atoms of box b and every k-vector (k_pose_ops: from
    the charged sites' eik tables); each transfer sums one pose against
    each box (the source without the candidate) with two S(k) rows, and
    scores the source's active slots with Philox.
    Per atom lane and pose one centre distance, the site distances for the
    share near[b] within reach (_reach_fraction) and the terms for the
    share frac[b] inside the cutoff.  n_box (C, 2) this run's active
    counts; n_move (C, 2) those of the launch's species block when the
    boxes hold other species too (default n_box): its slots move and are
    the transfer candidates, every active atom is a partner."""
    lj = t.has_lj.sum().item()
    qf = t.has_q.sum().item() if t.coulomb != "none" else 0
    ewald = t.coulomb == "ewald"
    # per chain: x, y, z and activity of both boxes' atoms, COM (3),
    # quaternion (4) and activity of both boxes' slots, both S(k) rows
    state = 8 * A_off + 16 * m_off + 4 * K
    nbytes = 4 * C * (2 * state + 2 * t.M * 10 + 8 * n_exch + 4 + 4 + 8)
    n = n_box.double()
    nm = n if n_move is None else n_move.double()
    ops = 0.0
    for b in range(2):
        c_pair = OPS_GEOMETRY + near[b] * t.P * OPS_GEOMETRY + frac[b] * (
            lj * OPS_LJ + qf * OPS_COULOMB)
        pairs = float((nm[:, b] * (n[:, b] - 1.0)).sum()) * t.P * c_pair
        k_move = 2 * k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald \
            else 0
        ops += 2 * pairs + float(nm[:, b].sum()) * k_move
    f_mix, n_mix = 0.5 * (frac[0] + frac[1]), 0.5 * (near[0] + near[1])
    c_pair = OPS_GEOMETRY + n_mix * t.P * OPS_GEOMETRY + f_mix * (
        lj * OPS_LJ + qf * OPS_COULOMB)
    k_pose = k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
    n_tot = float(n.sum(1).mean())
    ops += C * n_exch * ((n_tot - 1.0) * t.P * c_pair + 2 * k_pose
                         + 0.5 * float(nm.sum(1).mean()) * OPS_PHILOX)
    return _bound(nbytes, ops)


def gibbs_blocks(tag, g, st, blocks, launches_per_cycle, att_pc, n_tot,
                 gated=True):
    """MolGibbsEnsemble.run_blocks of `blocks` cycles each with the drift,
    S(k), N-conservation and acceptance gates (gated=False: printed
    only) and the launch count; returns (state, launches)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op

    launches0 = op.sweep_gibbs.launches
    for n_cyc in blocks:
        t0 = time.perf_counter()
        st, stats = g.run_block(st, n_cyc * att_pc)
        torch.cuda.synchronize()
        print(f"phase{tag} run_block({n_cyc} cycles): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v}" if isinstance(v, list) else f"{k} {v:.6g}"
                  for k, v in stats.items()))
        n_chain = st.active.sum((1, 2))
        if not bool((n_chain == n_tot).all()):
            raise AssertionError(f"N not conserved: {n_chain.unique()}")
        if gated and not (stats["drift_max_rel"] < DRIFT_TOL
                          and stats["sfac_err_max"] < SFAC_ABS_TOL
                          and stats["acc_transfer"] > 0.0
                          and 0.0 < stats["acc_vol"] < 1.0):
            raise AssertionError(f"phase{tag}: a gate failed: {stats}")
    launches = op.sweep_gibbs.launches - launches0
    if launches != launches_per_cycle * sum(blocks):
        raise AssertionError(f"{launches} launches for {sum(blocks)} cycles")
    return st, launches


def phase13(dev, chains=1024, blocks=(2, 2), melt=2, chunk=128,
            vol_chains=512, vol_cycles=8, twin_chains=None):
    """The Gibbs main path at bench.py's "gibbs" configuration: SPC/E cap
    128 x 2, 1024 chains through MolGibbsEnsemble(mega="full"): init, a
    melt block, measured blocks (one Gibbs launch and one volume move per
    cycle of 256 moves + 110 transfers); one cycle's launch timed beside
    its plain version and the bound; one cycle against sweep_gibbs_plain on
    the main path's own arguments; the volume move's share of a cycle
    (p_volume 0 against 0.01, 512 chains, 8 cycles)."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t_phase = time.perf_counter()
    cap, px = 128, 0.3
    params, boxes, n_init = _gibbs_flagship(cap=cap)
    system = spce_system(cap)
    gen = torch.Generator(device=dev).manual_seed(2041)
    g = MolGibbsEnsemble(system, params, dv_max=0.03, p_transfer=px,
                         dtype=torch.float32, chunk=chunk, mega="full",
                         device=dev, generator=gen)
    x_per = g.run_steps.x_per
    att_pc = 2 * cap + x_per
    t0 = time.perf_counter()
    st = g.init(boxes=boxes, n_init=n_init, n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase13 init: {time.perf_counter() - t0:.2f} s; boxes "
          f"{boxes[0]:.3f} / {boxes[1]:.3f} A, r_cut {params.r_cut:.3f}, "
          f"kappa_L {params.kappa_L:.3f}, nk {params.nk}, ksq_max "
          f"{params.ksq_max}, K {st.sfac.shape[2]}, A_pad "
          f"{st.coords.shape[-1]}, x_per {x_per} (a cycle: {2 * cap} moves "
          f"+ {x_per} transfers), {chains} chains")
    op.sweep_gibbs.launches = 0
    st, _ = gibbs_blocks("13 melt", g, st, (melt,), 1, att_pc, sum(n_init),
                         gated=False)
    st, _ = gibbs_blocks("13", g, st, blocks, 1, att_pc, sum(n_init))
    launches = op.sweep_gibbs.launches
    print(f"phase13 main path: {melt + sum(blocks)} cycles, {launches} "
          f"Gibbs kernel launches")

    # one cycle on the main path's arguments: timed, and held to the twin
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    (t,) = sweep_tables(system, params, kv, kw, dev)
    A_off, K = st.coords.shape[-1], st.sfac.shape[2]
    regs, local, per_sm = op.occupancy(t, cap, A_off, K)
    print(f"phase13 gibbs_kernel registers: {regs} per thread")
    print(f"phase13 gibbs_kernel local memory (stack frame and spills): "
          f"{local} B per thread")
    print(f"phase13 gibbs_kernel blocks per SM: {per_sm} "
          f"({op.gibbs_smem_bytes(cap, t.P, A_off, K, t.eps.shape[1], t.nk)}"
          f" B of shared memory per block)")
    C = chains if twin_chains is None else twin_chains
    act, actm = activity_planes(system, st.active[:C].reshape(2 * C, cap))
    ones = torch.ones((C,), device=dev)
    args = [x[:C].float().contiguous() for x in (st.coords, st.com, st.quat,
                                                 st.sfac, st.box)] + [
        params.temperature * ones, params.dr_max * ones,
        params.dphi_max * ones]
    us = [draw_uniforms(C, 2 * cap, gen, dev)]
    uxs = [draw_exchange_uniforms(C, x_per, gen, dev)]
    consts = gibbs_consts(system, params, kv, kw, args[4])
    rest = (us, [t], act.reshape(C, 2, -1), actm.reshape(C, 2, cap),
            [x_per], uxs, consts, 97)
    err, out = compare_gibbs("13 cycle vs plain", args, *rest)
    ms = _time_ms(lambda: run_gibbs(op.sweep_gibbs, args, *rest), 3)
    plain_ms = _time_ms(lambda: run_gibbs(op.sweep_gibbs_plain, args,
                                          *rest), 1)
    frac = _gibbs_cutoff_fraction(system, st.coords, st.active, st.box,
                                  params.r_cut)
    near = [_reach_fraction(st.coords[:, b], st.com[:, b],
                            system.atom_mol_slot[0], st.box[:, b],
                            max(params.r_cut, params.qq_cut),
                            st.active[:, b])[0] for b in range(2)]
    n_box = st.active[:C].sum(2)
    bound_ms, bound_by = gibbs_bound(t, C, st.coords.shape[-1], cap,
                                     st.sfac.shape[2], n_box, frac, near,
                                     x_per)
    print(f"phase13 one cycle, {C} chains, N per box "
          f"{float(n_box[:, 0].float().mean()):.1f} / "
          f"{float(n_box[:, 1].float().mean()):.1f}, {2 * cap} moves + "
          f"{x_per} transfers ({float(out[4][:, 6].mean()):.2f} accepted): "
          f"kernel {ms:.3f} ms, sweep_gibbs_plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {frac[0]:.4f} / {frac[1]:.4f} "
          f"of active pairs within the cutoff, {near[0]:.4f} / "
          f"{near[1]:.4f} of active atoms within a pose's reach)")

    # one volume attempt, with the eik recurrence and with the direct sum
    g_p = MolGibbsEnsemble(system, params, dv_max=0.03, p_transfer=px,
                           dtype=torch.float32, chunk=chunk, device=dev,
                           generator=gen)
    volume_attempt_ms("13", lambda s, a, b, _: g_p.run_steps.volume_step(
        s, a, b), st, gen)

    # the volume move's share of a cycle
    walls = {}
    for p_v in (0.0, 0.01):
        params_v, _, _ = _gibbs_flagship(p_volume=p_v, cap=cap)
        gen_v = torch.Generator(device=dev).manual_seed(2042)
        g_v = MolGibbsEnsemble(system, params_v, dv_max=0.03, p_transfer=px,
                               dtype=torch.float32, chunk=chunk, mega="full",
                               device=dev, generator=gen_v)
        sv = dataclasses.replace(st, **{f.name: getattr(st, f.name)[
            :vol_chains] for f in dataclasses.fields(st)})
        sv = g_v.run_steps(sv, att_pc)                           # warm
        torch.cuda.synchronize()
        att0 = sv.att[:, 2].clone()
        t0 = time.perf_counter()
        sv = g_v.run_steps(sv, vol_cycles * att_pc)
        torch.cuda.synchronize()
        walls[p_v] = time.perf_counter() - t0
        print(f"phase13 p_volume {p_v}: {vol_cycles} cycles of "
              f"{vol_chains} chains in {walls[p_v]:.3f} s "
              f"({1e3 * walls[p_v] / vol_cycles:.2f} ms per cycle; "
              f"{int((sv.att[:, 2] - att0).sum()) // vol_chains} volume "
              f"attempts per chain)")
    share = (walls[0.01] - walls[0.0]) / walls[0.01]
    print(f"phase13 volume-move share of a cycle at p_volume 0.01: "
          f"{100.0 * share:.1f}% ({vol_chains} chains, {vol_cycles} cycles; "
          f"phase total {time.perf_counter() - t_phase:.1f} s)")
    return launches, err, ms, plain_ms, bound_ms, bound_by


def _zgate(name, measured, sem, exact, tol_sig=4.0):
    z = abs(measured - exact) / max(sem, 1e-12)
    print(f"phase14 {name}: {measured:.4f} +- {sem:.4f} vs exact "
          f"{exact:.4f} (z = {z:.2f}, gate {tol_sig})")
    return z < tol_sig


def phase14_ideal(dev, chains=2048, eq_steps=3000, steps=800, samples=4):
    """docs/validation/run_gibbs_kernel_exchange.py [0]: the ideal
    single-species Gibbs partition through the kernel's transfers (eps =
    0, cap 96, 64 molecules, boxes 8 / 11, fixed volumes): N_box0 ~
    Binomial(64, V0 / (V0 + V1)), mean and variance within 4 sigma."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op

    t0 = time.perf_counter()
    cap, n_tot, b0, b1 = 96, 64, 8.0, 11.0
    p0 = b0 ** 3 / (b0 ** 3 + b1 ** 3)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.5,
                       p_volume=0.0, use_lrc=False, strict_min_image=False)
    gen = torch.Generator(device=dev).manual_seed(2043)
    g = MolGibbsEnsemble(lj_system(cap, eps=0.0), params, p_transfer=0.5,
                         dtype=torch.float32, mega="full", device=dev,
                         generator=gen)
    st = g.init(boxes=(b0, b1), n_init=(n_tot // 2, n_tot - n_tot // 2),
                n_chains=chains)
    l0 = op.sweep_gibbs.launches
    st = g.run_steps(st, eq_steps)
    n0 = []
    for _ in range(samples):
        st = g.run_steps(st, steps)
        n0.append(st.active[:, 0].sum(1).double().cpu().numpy())
    torch.cuda.synchronize()
    launches = op.sweep_gibbs.launches - l0
    n0 = np.concatenate(n0)
    n_eff = len(n0)
    ok = _zgate("[0] <N_box0>", n0.mean(), n0.std() / np.sqrt(n_eff),
                n_tot * p0)
    ok &= _zgate("[0] Var[N_box0]", n0.var(),
                 n0.var() * np.sqrt(2.0 / n_eff), n_tot * p0 * (1 - p0))
    conserved = bool((st.active.sum((1, 2)) == n_tot).all())
    print(f"phase14 [0] N conserved on all {chains} chains: {conserved}; "
          f"{launches} Gibbs launches; {time.perf_counter() - t0:.1f} s")
    if not (ok and conserved):
        raise AssertionError("phase14 [0]: the Binomial gates failed")
    return launches


def phase14_water(dev, chains=256, eq_steps=4000, steps=1200, blocks=3):
    """docs/validation/run_gibbs_kernel_exchange.py [2]: SPC/E at 500 K,
    cap 48, boxes 12 / 16, mega="full" against mega=True (kernel sweeps +
    plain transfers, n_orient 1) on <N_liq>: the gap within 4 combined
    standard errors + 2%; every block's S(k) error < 1e-3 and drift <
    2e-2 (the protocol's)."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    t0 = time.perf_counter()
    cap, r_cut = 48, 5.0
    kl, nk, ksq = tune_parameters(16.5, r_cut, 1e-3)
    params = RunParams(temperature=500.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.35, dphi_max=0.5,
                       p_volume=0.0, use_lrc=False, strict_min_image=False)
    res, launches = {}, 0
    for label, mega, seed in (("full", "full", 2044), ("hybrid", True, 2045)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        g = MolGibbsEnsemble(spce_system(cap), params, p_transfer=0.3,
                             dtype=torch.float32, chunk=chains, mega=mega,
                             device=dev, generator=gen)
        st = g.init(boxes=(12.0, 16.0), n_init=(30, 8), n_chains=chains)
        l0 = op.sweep_gibbs.launches
        st = g.run_steps(st, eq_steps)
        drift = sferr = 0.0
        worst = ""
        nl = []
        for _ in range(blocks):
            # the protocol's block-end resync: drift of the carried energy
            # against the recompute, scaled by the recompute (floored at 1)
            st = g.run_steps(st, steps)
            e, sf = g.full_energy(st)
            rel = (e - st.energy).abs() / e.abs().clamp_min(1.0)
            if float(rel.max()) > drift:
                c, b = divmod(int(rel.argmax()), 2)
                drift = float(rel.max())
                worst = (f"chain {c} box {b}: N {int(st.active[c, b].sum())}"
                         f", E {float(e[c, b]):.4f} K recomputed against "
                         f"{float(st.energy[c, b]):.4f} K carried")
            sferr = max(sferr, float((sf - st.sfac).abs().max()))
            st = dataclasses.replace(st, energy=e, sfac=sf)
            nl.append(st.active.sum(2).max(1).values.double().cpu().numpy())
        torch.cuda.synchronize()
        launches += op.sweep_gibbs.launches - l0
        nl = np.concatenate(nl)
        res[label] = (nl.mean(), nl.std() / np.sqrt(len(nl)))
        print(f"phase14 [2] {label}: <N_liq> {nl.mean():.3f} +- "
              f"{res[label][1]:.3f}, worst block drift {drift:.2e} ({worst})"
              f", S(k) err {sferr:.2e}; {time.perf_counter() - t0:.1f} s")
        if not (sferr < 1e-3 and drift < 2e-2):
            raise AssertionError(f"phase14 [2] {label}: drift or S(k)")
    (mf, sf_), (mh, sh) = res["full"], res["hybrid"]
    tol = 4.0 * math.hypot(sf_, sh) + 0.02 * mh
    print(f"phase14 [2] |gap| {abs(mf - mh):.3f} < {tol:.3f}: "
          f"{abs(mf - mh) < tol}")
    if not abs(mf - mh) < tol:
        raise AssertionError("phase14 [2]: full and hybrid <N_liq> differ")
    return launches


FLIP_MAX_DIFFERING = 2      # of 64 chains, phase 2's flip cases
FLIP_SFAC_TOL = 1e-5        # S(k) against the twin, of the chain's S(k) norm


def flip_inputs(system, params, box, xi, n_act, gen, dev):
    """A two-block f32 state in the flip op's layout: every slot on one
    lattice in a random orientation, the first n_act[c, s] slots of block s
    active in chain c, S(k) of the active charges; with the flip tables,
    each species' constant si2 (C, 2) and the tail's lrc3 (C, 3) or None.
    Returns (args, tables, si2, lrc3)."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_binary import (
        make_binary_slots,
    )
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda.flip_kernel import (
        FlipTables,
    )
    from metropolismontecarlo_tpu_torch.ops.ewald import structure_factor

    ms = make_binary_slots(system, params, dev, torch.float32, neutral=False)
    C = n_act.shape[0]
    com, quat, coords = ms.pose_lattice_init(gen, box, C)
    j = torch.arange(ms.M, device=dev)
    active = torch.zeros((C, ms.M), dtype=torch.bool, device=dev)
    for s in range(2):
        blk = (j >= ms.m0s[s]) & (j < ms.m0s[s] + ms.caps[s])
        active |= blk & (j - ms.m0s[s] < n_act[:, s, None].to(dev))
    act, actm = activity_planes(system, active)
    boxc = torch.full((C,), float(box), device=dev)
    if ms.use_ewald:
        sfac = structure_factor(coords.transpose(1, 2),
                                ms.evs[0].charges_flat * act, ms.kv, boxc)
    else:
        sfac = torch.zeros((C, 1, 2), device=dev)
    si2 = torch.stack([ev.self_intra(boxc) for ev in ms.evs], 1)
    lrc3 = None
    if ms.use_lrc:
        g = ms.lrc_gmat(boxc)
        lrc3 = torch.stack([g[:, 0, 0], g[:, 0, 1], g[:, 1, 1]], 1) \
            .contiguous()
    t_a, t_b = sweep_tables(system, params, ms.kvecs, ms.kweights, dev)
    args = [coords, com, quat, sfac.contiguous(), boxc,
            params.temperature * torch.ones((C,), device=dev), act, actm]
    return ([x.contiguous() for x in args],
            FlipTables(a=t_a, b=t_b, ln_xi=math.log(xi)),
            si2.contiguous(), lrc3)


def compare_flip(tag, args, ux, tables, si2, lrc3, seed, max_differing=None,
                 plain_ms=None, chain0=0):
    """The flip kernel against flip_plain on the same arguments: chains
    with identical decisions (equal acc/att counts and fingerprint) are
    compared field by field; N is conserved on every chain of both.
    max_differing: the most chains allowed to differ (default:
    MATCH_FRACTION of them must agree).  Returns (the largest of the
    matched chains' coordinate difference (A) and energy and S(k) relative
    errors, the kernel's outputs, the chains that agree).  plain_ms: a
    list that receives the plain call's ms."""
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as op

    k = op.flip(*args, ux, tables, si2, lrc3, seed=seed, chain0=chain0)
    out = []
    ms = _time_ms(lambda: out.append(op.flip_plain(
        *args, ux, tables, si2, lrc3, seed=seed, magnitude=True,
        chain0=chain0)), 1)
    p = out[0]
    if plain_ms is not None:
        plain_ms.append(ms)
    torch.cuda.synchronize()
    C = args[0].shape[0]
    same = (k[4][:, 1:6] == p[4][:, 1:6]).all(dim=1)
    n_diff = int((~same).sum())
    n_in = args[7].sum(1)
    conserved = torch.equal(k[6].sum(1), n_in) \
        and torch.equal(p[6].sum(1), n_in)
    pos = max(float((k[i] - p[i])[same].abs().max()) for i in (0, 1, 2))
    mag = p[4][:, op.N_STATS].clamp_min(1.0)
    e_rel = float(((k[4][:, 0] - p[4][:, 0]).abs() / mag)[same].max())
    s_norm = torch.clamp_min(torch.linalg.vector_norm(p[3].flatten(1), dim=1),
                             SFAC_NORM_FLOOR)
    s_rel = float(((k[3] - p[3]).flatten(1).abs().max(dim=1).values
                   / s_norm)[same].max())
    planes = torch.equal(k[5][same], p[5][same]) \
        and torch.equal(k[6][same], p[6][same])
    finite = all(bool(torch.isfinite(x).all()) for x in k)
    att = k[4][:, 3:5].sum(0)
    print(f"phase {tag}: chains {C}, differing {n_diff}, flips A->B "
          f"{float(k[4][:, 1].sum()):.0f} of {float(att[0]):.0f}, B->A "
          f"{float(k[4][:, 2].sum()):.0f} of {float(att[1]):.0f}; coord/com/"
          f"quat err {pos:.3e}, energy err {e_rel:.3e} of the flips' energy "
          f"scale, S(k) err {s_rel:.3e} of its norm, activity planes equal "
          f"{planes}, N conserved {conserved}")
    allowed = max_differing if max_differing is not None \
        else (1.0 - MATCH_FRACTION) * C
    if not (n_diff <= allowed and conserved and finite and planes
            and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= FLIP_SFAC_TOL):
        raise AssertionError(f"{tag}: the flip kernel and its plain version "
                             f"disagree")
    return max(pos, e_rel, s_rel), k, same


def _semigrand_water(**kw):
    """bench.py's "semigrand" conventions: SPC/E at 600 K, r_cut 8, the
    flagship Ewald (kappa L 5.6, nk 5, |k|^2 < 27)."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    d = dict(temperature=600.0, r_cut=8.0, cutoff_mode="site",
             coulomb="ewald", use_lrc=False, p_translate=0.5, dr_max=1.0,
             dphi_max=0.7, strict_min_image=False)
    d.update(kw)
    return RunParams(**d)


def phase2_flip(dev, chains=64, n_flip=24):
    """The flip kernel against flip_plain on shared uniforms and Philox
    scores, 64 chains (chain 0 with no molecule, chain 1 with both blocks
    full, so no attempt of it has a free target): identical SPC/E blocks
    32 + 32 under Ewald, Wolf, reference Wolf and bare Coulomb (every
    <Coulomb form> instantiation of the kernel); the ragged one-site LJ +
    bent-triatomic blocks with unequal eps and the LJ tail."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_exchange_uniforms
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        lj_trimer_blocks,
    )
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks

    t0 = time.perf_counter()
    water = spce_two_blocks(32, 32)
    cases = (
        ("spce 32+32 ewald", water, _semigrand_water(), 20.0, 2.0),
        ("spce 32+32 wolf", water,
         _semigrand_water(coulomb="wolf", kappa_L=2.0), 20.0, 2.0),
        ("spce 32+32 wolf_ref", water,
         _semigrand_water(coulomb="wolf", wolf_style="ref", kappa_L=2.0),
         20.0, 2.0),
        ("lj+trimer 32+32 lrc", lj_trimer_blocks(32, 32, eps_a=1.0,
                                                  eps_b=0.6),
         _semigrand_water(temperature=2.0, r_cut=2.5, coulomb="none",
                          use_lrc=True), 9.0, 1.5),
        ("spce 32+32 bare", water, _semigrand_water(coulomb="bare"), 20.0,
         2.0),
    )
    err = 0.0
    for i, (tag, system, params, box, xi) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(3200 + i)
        rng = np.random.default_rng(3200 + i)
        n_act = rng.integers(0, 33, (chains, 2))
        n_act[0], n_act[1] = 0, 32
        args, tables, si2, lrc3 = flip_inputs(
            system, params, box, xi, torch.tensor(n_act), gen, dev)
        ux = draw_exchange_uniforms(chains, n_flip, gen, dev)
        e, k, _ = compare_flip(f"2f {tag}", args, ux, tables, si2, lrc3,
                               seed=71 + i, max_differing=FLIP_MAX_DIFFERING)
        err = max(err, e)
        # the empty chain and the chain without a free target: unchanged
        for c in (0, 1):
            for x, ref in zip(k[:4] + k[5:], args[:4] + args[6:]):
                if not torch.equal(x[c], ref[c]):
                    raise AssertionError(f"2f {tag}: chain {c} changed")
        if not (float(k[4][0, 3]) == n_flip and float(k[4][:2, 1:3].sum())
                == 0.0 and float(k[4][1, 3:5].sum()) == n_flip):
            raise AssertionError(f"2f {tag}: refused attempts miscounted: "
                                 f"{k[4][:2].tolist()}")
    print(f"phase 2 flip cases: {time.perf_counter() - t0:.1f} s")
    return err


def tip4p_two_blocks(cap_a, cap_b):
    """Two TIP4P-shaped species blocks, cap_a TIP4P/2005 then cap_b
    TIP4P/Ice slots (four sites each, their own O-O LJ, charges and M
    site; Lorentz-Berthelot O-O cross terms): phase 2's flip case at
    P = 4."""
    from metropolismontecarlo_tpu_torch.models.system import System
    from metropolismontecarlo_tpu_torch.models.water import (
        tip4p2005_system,
        tip4pice_system,
    )

    a, b = tip4p2005_system(cap_a), tip4pice_system(cap_b)
    eps = np.array([a.eps_table[0, 0], 0.0, b.eps_table[0, 0]])
    sig = np.array([a.sig_table[0, 0], 1.0, b.sig_table[0, 0]])
    eps_t = np.sqrt(eps[:, None] * eps[None, :])
    sig_t = np.where(eps_t > 0.0, 0.5 * (sig[:, None] + sig[None, :]), 1.0)
    tb = np.array(b.type_ids)
    tb[:, 0] = 2
    return System(
        n_mol=cap_a + cap_b, atoms_per_mol=4,
        body=np.concatenate([a.body, b.body]),
        masses=np.concatenate([a.masses, b.masses]),
        charges=np.concatenate([a.charges, b.charges]),
        type_ids=np.concatenate([a.type_ids, tb]), eps_table=eps_t,
        sig_table=sig_t, name="tip4p2005+tip4pice",
        species=(("tip4p2005", cap_a, 4), ("tip4pice", cap_b, 4)))


def _tip4p_gibbs_params():
    """Phase 2's TIP4P/2005 Gibbs case: cap 48 x 2 at 500 K in boxes of 12
    and 16 A (phase 14's [2] shape), r_cut 5 A, Ewald tuned at 16 A."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    kl, nk, ksq = tune_parameters(16.0, 5.0, 1e-3)
    return RunParams(temperature=500.0, r_cut=5.0, cutoff_mode="site",
                     coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                     p_translate=0.5, dr_max=0.3, dphi_max=0.4,
                     use_lrc=False, strict_min_image=False)


def phase2_tip4p(dev, chains=64, timed_chains=1024):
    """Every kernel at P = 4 (TIP4P/2005: a massless, LJ-free, charged M
    site) against its plain version, 64 chains each, at the gates above:
    the sweep kernel's fixed-N instantiation (translations, and
    rotations), its activity instantiation with exchange attempts and
    ghosts, its tmmc instantiation (and eta = 0 against n_exch);
    delta_energy at R = 8 rows (2 P, no padding rows); one Gibbs cycle of
    TIP4P/2005 cap 48 x 2; one flip launch between a TIP4P/2005 and a
    TIP4P/Ice block (32 + 32).  The Gibbs cycle and the flip launch are
    then timed at 1024 chains of the same shapes beside their plain
    versions and bounds, with their occupancy.  Returns (sweep err,
    delta err, Gibbs (err, ms, plain_ms, bound_ms, bound_by), flip (err,
    ms, plain_ms, bound_ms, bound_by))."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_exchange_uniforms,
        make_sweep_fn,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import tip4p2005_system
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as fop
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gop

    t0 = time.perf_counter()
    water = tip4p2005_system(64)
    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    err = 0.0
    for i, pt in enumerate((0.5, 0.0)):
        params = RunParams(temperature=298.15, r_cut=6.0, coulomb="ewald",
                           p_translate=pt, dr_max=0.3, dphi_max=0.3)
        gen = torch.Generator(device=dev).manual_seed(5100 + i)
        mc = MonteCarlo(water, params, device=dev, generator=gen,
                        kernel="sweep")
        state = mc.init_state(cubic_lattice(64, box_w), box=box_w,
                              n_chains=chains)
        err = max(err, compare(f"2 tip4p2005-64 ewald pt={pt}", mc, state,
                               gen))
    box_v, _, wparams, _ = _variant_params()
    mc, state, args, act, actm, uxs, z, consts = _variant_inputs(
        dev, 5110, "n_exch+n_widom tip4p2005-64", water, box_v, wparams(),
        (8,), (4,), C=chains)
    err = max(err, compare_variant(
        "2 n_exch+n_widom tip4p2005-64 ewald", water, args, mc.tables, act,
        actm, (8,), (4,), uxs, z, consts, 5111))
    mc, state, args, act, actm, uxs, z, consts = _variant_inputs(
        dev, 5112, "tmmc tip4p2005-64", water, box_v, wparams(), (16,),
        (0,), C=chains)
    eta = 0.35 * torch.arange(65, dtype=torch.float32, device=dev)
    e_in = state.energy.float().contiguous()
    err = max(err, compare_variant(
        "2 tmmc tip4p2005-64 ewald", water, args, mc.tables, act, actm,
        (16,), (0,), uxs, z, consts, 5113, tmmc=(eta, e_in)))
    tmmc_identity("2 tmmc tip4p2005-64 ewald", args, mc.tables, act, actm,
                  16, uxs[0], z, consts, 5113, e_in)

    # delta_energy at R = 2 P = 8 rows: no padding row
    params = RunParams(temperature=298.15, r_cut=6.0, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(5120)
    mc = MonteCarlo(water, params, device=dev, generator=gen, kernel="move")
    state = mc.init_state(cubic_lattice(64, box_w), box=box_w,
                          n_chains=chains)
    body = make_sweep_fn(water, params, mc.kvecs, mc.kweights, dev,
                         use_kernel=True)
    if body.n_rows != 8:
        raise AssertionError(f"TIP4P delta_energy rows {body.n_rows}, not 8")
    err_d = 0.0
    for m in (0, 63):
        err_d = max(err_d, delta_compare(
            f"2 delta_energy tip4p2005-64 R=8 m={m}", body, state, gen, m))
    for style in ("ewald", "wolf"):
        regs, local, blocks = dop.occupancy(style, 8, 2)
        print(f"phase2 tip4p occupancy delta_energy <{style}> R 8, T 2: "
              f"{regs} registers, {local} B local, "
              f"{dop._library().mmc_delta_smem_bytes(8, 2, dop.THREADS)} B "
              f"of shared memory, {blocks} blocks per SM")

    # one Gibbs cycle of TIP4P/2005 cap 48 x 2, then timed at 1024 chains
    gparams, boxes, n_exch = _tip4p_gibbs_params(), (12.0, 16.0), 24
    cap = 48
    system = tip4p2005_system(cap)
    inputs = _gibbs_case(dev, system, gparams, boxes, chains, 5130, n_exch)
    e_g, _ = compare_gibbs("2g tip4p2005 cap 48x2 ewald", *inputs, seed=93,
                           max_differing=GIBBS_MAX_DIFFERING)
    args, us, tables, act, actm, n_exchs, uxs, consts = _gibbs_case(
        dev, system, gparams, boxes, timed_chains, 5131, n_exch)
    rest = (us, tables, act, actm, n_exchs, uxs, consts, 94)
    (t,) = tables
    A_off, K = args[0].shape[-1], args[3].shape[2]
    regs, local, per_sm = gop.occupancy(t, cap, A_off, K)
    nbytes = gop.gibbs_smem_bytes(cap, t.P, A_off, K, t.eps.shape[1], t.nk)
    run_gibbs(gop.sweep_gibbs, args, *rest)                      # warm
    g_ms = _time_ms(lambda: run_gibbs(gop.sweep_gibbs, args, *rest), 3)
    g_plain = _time_ms(lambda: run_gibbs(gop.sweep_gibbs_plain, args,
                                         *rest), 1)
    active = actm > 0.0
    frac = _gibbs_cutoff_fraction(system, args[0], active, args[4],
                                  gparams.r_cut)
    near = [_reach_fraction(args[0][:, b], args[1][:, b],
                            system.atom_mol_slot[0], args[4][:, b],
                            gparams.qq_cut, active[:, b])[0]
            for b in range(2)]
    g_bound, g_by = gibbs_bound(t, timed_chains, A_off, cap, K,
                                active.sum(2), frac, near, n_exch)
    print(f"phase2 tip4p gibbs_kernel cap {cap} x 2 at P 4, K {K}: {regs} "
          f"registers, {local} B local, {per_sm} blocks per SM ({nbytes} B "
          f"of shared memory); one cycle of {timed_chains} chains "
          f"({2 * cap} moves + {n_exch} transfers): kernel {g_ms:.3f} ms, "
          f"sweep_gibbs_plain {g_plain:.3f} ms, bound {g_bound:.3f} ms "
          f"({g_by})")

    # one flip launch between a TIP4P/2005 and a TIP4P/Ice block
    fsys = tip4p_two_blocks(32, 32)
    fparams = _semigrand_water(r_cut=6.0)
    f_err, f_times = 0.0, None
    for c, timed in ((chains, False), (timed_chains, True)):
        gen = torch.Generator(device=dev).manual_seed(5140 + c)
        rng = np.random.default_rng(5140 + c)
        n_act = rng.integers(0, 33, (c, 2))
        n_act[0], n_act[1] = 0, 32
        fargs, ftables, si2, lrc3 = flip_inputs(
            fsys, fparams, 16.0, 2.0, torch.tensor(n_act), gen, dev)
        ux = draw_exchange_uniforms(c, 24, gen, dev)
        if not timed:
            f_err, _, _ = compare_flip(
                "2f tip4p2005+tip4pice 32+32 ewald", fargs, ux, ftables,
                si2, lrc3, seed=75, max_differing=FLIP_MAX_DIFFERING)
            continue
        A_pad, K = fargs[0].shape[-1], fargs[3].shape[1]
        regs, local, per_sm = fop.occupancy(ftables, 64, A_pad, K)
        nbytes = fop.flip_smem_bytes(64, 4, 4, A_pad, K,
                                     ftables.a.eps.shape[1], ftables.a.nk)
        fop.flip(*fargs, ux, ftables, si2, lrc3, seed=75)        # warm
        f_ms = _time_ms(lambda: fop.flip(*fargs, ux, ftables, si2, lrc3,
                                         seed=75), 5)
        f_plain = _time_ms(lambda: fop.flip_plain(*fargs, ux, ftables, si2,
                                                  lrc3, seed=75), 1)
        view = SimpleNamespace(active=fargs[7] > 0.0, coords=fargs[0],
                               box=fargs[4], com=fargs[1])
        frac = _active_cutoff_fraction(view, 4, fparams.r_cut)
        near = _reach_fraction(fargs[0], fargs[1], fsys.atom_mol_slot[0],
                               fargs[4], fparams.qq_cut, view.active,
                               n=8)[0]
        f_bound, f_by = flip_bound(ftables, c, A_pad, 64, K,
                                   view.active.sum(1), frac, near, 24)
        f_times = (f_ms, f_plain, f_bound, f_by)
        print(f"phase2 tip4p flip_kernel 32 + 32 at P 4: {regs} registers, "
              f"{local} B local, {per_sm} blocks per SM ({nbytes} B of "
              f"shared memory); one launch of {c} chains x 24 flips: kernel "
              f"{f_ms:.3f} ms, flip_plain {f_plain:.3f} ms, bound "
              f"{f_bound:.3f} ms ({f_by})")
    print(f"phase 2 TIP4P (P = 4) cases: {time.perf_counter() - t0:.1f} s")
    return (err, err_d, (e_g, g_ms, g_plain, g_bound, g_by),
            (f_err,) + f_times)


def flip_stress_cases():
    """Phase 2's stress cases for the flip kernel's queues and picks,
    identical SPC/E blocks 32 + 32: (tag, system, params, box, xi,
    one_in_a).  Every site pair inside the cutoff (r_cut above L sqrt(3) /
    2); a dilute box with no pair inside it; split LJ and Coulomb cutoffs;
    species A with one active slot in every chain (its flips empty the
    block)."""
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    water = spce_two_blocks(32, 32)
    return [
        ("all pairs in cutoff spce 32+32 wolf", water,
         _semigrand_water(coulomb="wolf", kappa_L=2.0,
                          r_cut=box_w * 3 ** 0.5 / 2 + 0.1), box_w, 2.0,
         False),
        ("dilute spce 32+32 ewald", water, _semigrand_water(r_cut=6.0), 40.0,
         2.0, False),
        ("split cutoff spce 32+32 ewald", water,
         _semigrand_water(r_cut=4.5, qq_r_cut=6.0), 20.0, 2.0, False),
        ("one active A slot spce 32+32 ewald", water, _semigrand_water(),
         20.0, 0.5, True),
    ]


def flip_stress_inputs(dev, i, chains=STRESS_CHAINS, n_flip=24):
    """Flip stress case i (flip_stress_cases) and its inputs at seed 3250 +
    i, drawn on the CPU and moved to dev (a run on the CPU builds the
    states that the card compares): random N per chain and block (A at one
    slot with one_in_a), the attempts' uniforms.  Returns (case, (args,
    tables, si2, lrc3, ux))."""
    import warnings

    from metropolismontecarlo_tpu_torch.mc.moves import draw_exchange_uniforms

    case = flip_stress_cases()[i]
    _, system, params, box, xi, one = case
    seed = 3250 + i
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_act = rng.integers(0, 33, (chains, 2))
    if one:
        n_act[:, 0] = 1
    with warnings.catch_warnings():
        # the all-pairs case samples the truncated nearest image
        warnings.simplefilter("ignore")
        args, tables, si2, lrc3 = flip_inputs(
            system, params, box, xi, torch.tensor(n_act), gen, "cpu")
    ux = draw_exchange_uniforms(chains, n_flip, gen, "cpu")
    return case, _to_device((args, tables, si2, lrc3, ux), dev)


def phase2_flip_stress(dev):
    """flip_stress_cases against flip_plain at the phase 2 flip gates.
    Returns the largest error of the matched chains."""
    t0 = time.perf_counter()
    err = 0.0
    for i in range(len(flip_stress_cases())):
        (tag, *_), (args, tables, si2, lrc3, ux) = flip_stress_inputs(dev, i)
        e, _, _ = compare_flip(f"2f {tag}", args, ux, tables, si2, lrc3,
                               seed=170 + i, max_differing=FLIP_MAX_DIFFERING)
        err = max(err, e)
    print(f"phase 2 flip stress cases: {time.perf_counter() - t0:.1f} s")
    return err


def flip_bound(t, C, A_pad, M, K, n_tot, frac, near, n_flip):
    """The least time (ms) of one flip launch, and what sets it: the chain
    state in and out once, the uniforms and constants read once, against
    the operations the attempts need (OPS_*): each attempt scores the
    active slots with Philox, sums the old and the new pose against the
    other active atoms and builds one dS row over the k-vectors from the
    two poses' charged sites' eik tables (k_pose_ops): per atom
    lane and pose one centre distance, the site distances for the share
    near within reach (_reach_fraction) and the terms for the share frac
    inside the cutoff.  n_tot (C,) this run's active counts; both
    species' tables of t count."""
    ewald = t.a.coulomb == "ewald"
    lj = t.a.has_lj.sum().item() + t.b.has_lj.sum().item()
    qf = (t.a.has_q.sum().item() + t.b.has_q.sum().item()) \
        if t.a.coulomb != "none" else 0
    p_avg = 0.5 * (t.a.P + t.b.P)
    state = 4 * A_pad + 8 * M + 2 * K
    nbytes = 4 * C * (2 * state + 8 * n_flip + 2 + 2 + 8)
    n = float(n_tot.double().mean())
    c_pair = 2 * OPS_GEOMETRY + near * 2 * p_avg * OPS_GEOMETRY + frac * (
        lj * OPS_LJ + qf * OPS_COULOMB)
    k_flip = k_pose_ops(K, t.a.nk, qf) + K * OPS_K_MOVE if ewald else 0
    ops = C * n_flip * ((n - 1.0) * p_avg * c_pair + k_flip
                        + n * OPS_PHILOX)
    return _bound(nbytes, ops)


def semigrand_blocks(tag, g, st, blocks, apc, n_tot):
    """Semigrand.run_blocks of `blocks` cycles each with the drift, S(k),
    N_tot-conservation and flip-acceptance gates; returns (state,
    [(<N_B>, s.e.)])."""
    trace = []
    for n_cyc in blocks:
        t0 = time.perf_counter()
        st, stats = g.run_block(st, n_cyc * apc)
        torch.cuda.synchronize()
        print(f"phase{tag} run_block({n_cyc} cycles): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v:.6g}" for k, v in stats.items()))
        n_chain = st.active.sum(1)
        if not bool((n_chain == n_tot).all()):
            raise AssertionError(f"N_tot not conserved: {n_chain.unique()}")
        if not (stats["drift_max_rel"] < DRIFT_TOL
                and stats["sfac_err_max"] < SFAC_ABS_TOL
                and 0.0 < stats["acc_flip_ab"] < 1.0
                and 0.0 < stats["acc_flip_ba"] < 1.0):
            raise AssertionError(f"phase{tag}: a gate failed: {stats}")
        n_b = st.active[:, g.cap_a:].sum(1).double()
        trace.append((float(n_b.mean()),
                      float(n_b.std() / math.sqrt(n_b.numel()))))
    return st, trace


def phase15(dev, chains=1024, melt=2, blocks=(2, 2), chunk=128):
    """The semigrand main path at bench.py's "semigrand" configuration:
    identical SPC/E blocks cap 64 + 64, Ewald, 600 K, r_cut 8, box 20, 32 +
    32 molecules, xi 2, p_flip 0.3 (x_per 55), 1024 chains through
    Semigrand(mega="full"): init, a melt block and two measured blocks (per
    cycle two sweep launches of 64 moves and one flip launch of 55 flips);
    mega=True from the same start (<N_B> within 4 combined standard
    errors); one flip launch on the main path's own arguments against
    flip_plain, timed beside it, the bound and a whole cycle."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        make_mega_flip_fn,
    )
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as op
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sw
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t_phase = time.perf_counter()
    cap, px, xi, n_a, n_b, box = 64, 0.3, 2.0, 32, 32, 20.0
    system, params = spce_two_blocks(cap, cap), _semigrand_water()

    def build(mega, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return gen, Semigrand(system, params, fugacity_ratio=xi, p_flip=px,
                              dtype=torch.float32, chunk=chunk, mega=mega,
                              device=dev, generator=gen)

    gen, g = build("full", 2051)
    x_per = g.run_steps.x_per
    apc = 2 * cap + x_per
    t0 = time.perf_counter()
    st0 = g.init(box=box, n_a=n_a, n_b=n_b, n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase15 init: {time.perf_counter() - t0:.2f} s; caps {cap} + "
          f"{cap}, A_pad {st0.coords.shape[-1]}, K {st0.sfac.shape[1]}, "
          f"x_per {x_per} (a cycle: {2 * cap} moves + {x_per} flips), "
          f"{chains} chains, E mean {float(st0.energy.mean()):.1f} K")
    op.flip.launches = 0
    sw.sweep.launches = 0
    st, trace = semigrand_blocks("15", g, st0, (melt,) + tuple(blocks), apc,
                                 n_a + n_b)
    launches, sweeps = op.flip.launches, sw.sweep.launches
    n_cyc = melt + sum(blocks)
    print(f"phase15 main path: {n_cyc} cycles, {launches} flip launches, "
          f"{sweeps} sweep launches; <N_B> " + ", ".join(
              f"{m:.3f} +- {e:.3f}" for m, e in trace))
    if launches != n_cyc or sweeps != 2 * n_cyc:
        raise AssertionError(f"{launches} flip and {sweeps} sweep launches "
                             f"for {n_cyc} cycles")

    # the hybrid composition from the same start
    _, g_h = build(True, 2052)
    t0 = time.perf_counter()
    _, trace_h = semigrand_blocks("15 hybrid", g_h, st0,
                                  (melt,) + tuple(blocks), apc, n_a + n_b)
    print(f"phase15 hybrid blocks: {time.perf_counter() - t0:.2f} s")
    for (m_f, e_f), (m_h, e_h) in zip(trace, trace_h):
        tol = 4.0 * math.hypot(e_f, e_h)
        print(f"phase15 <N_B> full {m_f:.3f} vs hybrid {m_h:.3f}: "
              f"difference {m_f - m_h:+.3f}, 4 combined standard errors "
              f"{tol:.3f}")
        if not abs(m_f - m_h) < tol:
            raise AssertionError("full and hybrid <N_B> disagree")

    # one flip launch on the main path's arguments: held to the twin, timed
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    tables = make_mega_flip_fn(system, params, kv, kw, dev, xi).tables
    A_pad, K = st.coords.shape[-1], st.sfac.shape[1]
    regs, local, per_sm = op.occupancy(tables, 2 * cap, A_pad, K)
    print(f"phase15 flip_kernel registers: {regs} per thread")
    print(f"phase15 flip_kernel local memory (stack frame and spills): "
          f"{local} B per thread")
    nbytes = op.flip_smem_bytes(2 * cap, tables.a.P, tables.b.P, A_pad, K,
                                tables.a.eps.shape[1], tables.a.nk)
    print(f"phase15 flip_kernel blocks per SM: {per_sm} ({nbytes} B of "
          f"shared memory per block)")
    act, actm = activity_planes(system, st.active)
    ones = torch.ones((chains,), device=dev)
    args = [x.float().contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        params.temperature * ones, act, actm]
    si2 = torch.stack([make_pose_eval(system, params, kv, kw, dev,
                                      torch.float32, species=s)
                       .self_intra(st.box) for s in (0, 1)], 1).contiguous()
    ux = draw_exchange_uniforms(chains, x_per, gen, dev)
    err, out, _ = compare_flip("15 flip vs plain", args, ux, tables, si2,
                               None, seed=97)
    ms = _time_ms(lambda: op.flip(*args, ux, tables, si2, None, seed=97), 5)
    plain_ms = _time_ms(lambda: op.flip_plain(*args, ux, tables, si2, None,
                                              seed=97), 1)
    cycle_ms = _time_ms(lambda: g.run_steps(st, apc), 3)
    frac = _active_cutoff_fraction(st, 3, params.r_cut)
    near = _reach_fraction(st.coords, st.com, system.atom_mol_slot[0],
                           st.box, max(params.r_cut, params.qq_cut),
                           st.active, n=8)[0]
    bound_ms, bound_by = flip_bound(tables, chains, st.coords.shape[-1],
                                    2 * cap, st.sfac.shape[1],
                                    st.active.sum(1), frac, near, x_per)
    print(f"phase15 one flip launch, {chains} chains, {x_per} flips "
          f"({float(out[4][:, 1:3].sum(1).mean()):.2f} accepted): kernel "
          f"{ms:.3f} ms, flip_plain {plain_ms:.3f} ms, bound {bound_ms:.3f} "
          f"ms ({bound_by}; {frac:.4f} of active pairs within the cutoff, "
          f"{near:.4f} of active atoms within a pose's reach); "
          f"a whole cycle {cycle_ms:.3f} ms, the flip launch "
          f"{100.0 * ms / cycle_ms:.1f}% of it; phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, err, ms, plain_ms, bound_ms, bound_by


def phase16(dev, chains=256, equil=3, prod=8, steps=1200):
    """The in-kernel segment of docs/validation/run_semigrand_binomial.py,
    uncut: identical SPC/E blocks cap 24 + 24, N_tot 16, box 20, 600 K,
    Ewald, xi 2, p_flip 0.5, 256 chains, 3 + 8 blocks of 1200 steps through
    Semigrand(mega="full"): N_B ~ Binomial(16, 2/3), mean within max(3%,
    5 s.e.) of 10.667 and variance within 20% of 3.556; every production
    block's drift < 2e-3."""
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as op

    t0 = time.perf_counter()
    n_tot, xi = 16, 2.0
    gen = torch.Generator(device=dev).manual_seed(2053)
    g = Semigrand(spce_two_blocks(24, 24),
                  _semigrand_water(strict_min_image=True), fugacity_ratio=xi,
                  p_flip=0.5, dtype=torch.float32, chunk=chains, mega="full",
                  device=dev, generator=gen)
    st = g.init(box=20.0, n_a=8, n_b=8, n_chains=chains)
    l0 = op.flip.launches
    for _ in range(equil):
        st, _ = g.run_block(st, steps)
    means, varis, worst = [], [], 0.0
    for _ in range(prod):
        st, stats = g.run_block(st, steps)
        worst = max(worst, stats["drift_max_rel"])
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
        if not stats["drift_max_rel"] < DRIFT_TOL:
            raise AssertionError(f"phase16 drift: {stats}")
    torch.cuda.synchronize()
    launches = op.flip.launches - l0
    p = xi / (1.0 + xi)
    mean, var = float(np.mean(means)), float(np.mean(varis))
    sem = float(np.std(means) / np.sqrt(len(means)))
    ok = abs(mean - n_tot * p) < max(0.03 * n_tot * p, 5 * sem) \
        and abs(var - n_tot * p * (1 - p)) < 0.2 * n_tot * p * (1 - p)
    print(f"phase16 <N_B> {mean:.3f} +- {sem:.3f} (exact {n_tot * p:.3f}), "
          f"var {var:.3f} (exact {n_tot * p * (1 - p):.3f}), worst drift "
          f"{worst:.2e}, N_tot conserved "
          f"{bool((st.active.sum(1) == n_tot).all())}; {launches} flip "
          f"launches (not in the kernels line); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (ok and bool((st.active.sum(1) == n_tot).all())):
        raise AssertionError("phase16: the Binomial gates failed")
    return launches


def phase17(dev, chains=256, equil=8, prod=8, steps=1500, nvt_chains=256):
    """docs/validation/run_binary_co2_n2.py with BinaryGCMC(mega="full") at
    the protocol's own parameters: TraPPE CO2/N2, caps 96 + 96, box 26 A,
    300 K, z = (5e-4, 8e-4) /A^3, p_exchange 0.4, 256 chains, 8 + 8 blocks
    of 1500 steps (one sweep launch per species block per cycle, each with
    its species' 64 exchange attempts); then NVT at the sampled composition
    with per-species MonteCarlo.widom.  Gates: |beta mu_ex(muVT) - beta
    mu_ex(Widom)| < 0.1 per species, selectivity S > 1, every production
    block's S(k) error < 1e-4, drift < 1e-2 and full fractions < 0.02."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sw

    t0 = time.perf_counter()
    temp, box, z, caps = 300.0, 26.0, (5e-4, 8e-4), (96, 96)
    params = RunParams(temperature=temp, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.5, dphi_max=1.0)
    gen = torch.Generator(device=dev).manual_seed(2054)
    g = BinaryGCMC(co2_n2_system(*caps), params, activities=z,
                   p_exchange=0.4, dtype=torch.float32, chunk=64,
                   mega="full", device=dev, generator=gen)
    st = g.init(box=box, n_init=(12, 14), n_chains=chains)
    l0 = sw.sweep.launches
    for b in range(equil):
        st, stats = g.run_block(st, steps)
    n0 = n1 = 0.0
    for b in range(prod):
        st, stats = g.run_block(st, steps)
        print(f"phase17 prod {b}: <N0> {stats['n0_mean']:.2f} <N1> "
              f"{stats['n1_mean']:.2f}, acc ins/del {stats['acc_insert0']:.3f}"
              f"/{stats['acc_delete0']:.3f} {stats['acc_insert1']:.3f}/"
              f"{stats['acc_delete1']:.3f}, drift "
              f"{stats['drift_max_rel']:.2e}, S(k) err "
              f"{stats['sfac_err_max']:.2e}")
        if not (stats["drift_max_rel"] < 1e-2
                and stats["sfac_err_max"] < SFAC_ABS_TOL
                and stats["full_frac0"] < 0.02
                and stats["full_frac1"] < 0.02):
            raise AssertionError(f"phase17: a block gate failed: {stats}")
        n0 += stats["n0_mean"] / prod
        n1 += stats["n1_mean"] / prod
    launches = sw.sweep.launches - l0
    vol = box ** 3
    bmu = [math.log(z[s] / (n / vol)) for s, n in ((0, n0), (1, n1))]
    sel = (n0 / n1) / (z[0] / z[1])
    print(f"phase17 muVT: <N_CO2> {n0:.2f}, <N_N2> {n1:.2f}, beta mu_ex "
          f"{bmu[0]:+.4f} / {bmu[1]:+.4f}, selectivity {sel:.3f}; {launches} "
          f"sweep launches (not in the kernels line); "
          f"{time.perf_counter() - t0:.1f} s")

    # NVT + per-species Widom at the sampled composition
    nc, nn = int(round(n0)), int(round(n1))
    gen2 = torch.Generator(device=dev).manual_seed(2055)
    mc = MonteCarlo(co2_n2_system(nc, nn), params, device=dev,
                    generator=gen2)
    state = mc.init_state(cubic_lattice(nc + nn, box), box=box,
                          n_chains=nvt_chains)
    for _ in range(4):
        state, _ = mc.run_block(state, 100, adjust=True)
    bsum, cnt = [0.0, 0.0], 0
    for _ in range(6):
        state, bstats = mc.run_block(state, 50)
        for s in (0, 1):
            w = mc.widom(state, n_insertions=128, species=s)
            bsum[s] += float(w["boltzmann_mean"].mean())
        cnt += 1
    bmu_w = [-math.log(b / cnt) for b in bsum]
    d = [bmu[s] - bmu_w[s] for s in (0, 1)]
    ok = all(abs(x) < 0.1 for x in d) and sel > 1.0
    print(f"phase17 NVT ({nc}, {nn}): Widom beta mu_ex {bmu_w[0]:+.4f} / "
          f"{bmu_w[1]:+.4f} (drift {bstats['drift_max_rel']:.1e}); "
          f"differences {d[0]:+.4f} / {d[1]:+.4f} kT (bound 0.1), S > 1 "
          f"{sel > 1.0}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("phase17: the binary muVT cross-check failed")
    return launches


# ---------------- the run surface: the CLI and the benchmark ----------------

REPO = os.path.dirname(os.path.abspath(__file__))


def _cli_config(tmp, name, run=None, output=None, ensemble=None, **top):
    """configs/<name>.json with entries of its run section (and of run's
    output and ensemble sections) replaced, written into tmp; returns the
    path."""
    with open(os.path.join(REPO, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(top)
    cfg["run"].update(run or {})
    cfg["run"]["output"] = dict(cfg["run"].get("output", {}), **(output or {}))
    if ensemble:
        cfg["run"]["ensemble"].update(ensemble)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _n_blocks(path):
    with open(path) as f:
        return json.load(f)["run"]["n_blocks"]


class _SfacProbe:
    """Records, inside MonteCarlo.run_block, the difference between the
    carried S(k) and the block-end recompute (the NVT path reports no
    sfac_err_max; the muVT and Gibbs apps do): per block the largest
    absolute difference (errs) and the largest per chain relative to the
    chain's S(k) norm floored at SFAC_NORM_FLOOR (rel), phase 2's rule."""

    def __init__(self):
        from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo

        self.errs, self.rel, self._cls = [], [], MonteCarlo
        self._fe, self._rb = MonteCarlo.full_energy, MonteCarlo.run_block
        probe = self

        def full_energy(mc, state):
            e, w, sfac = probe._fe(mc, state)
            if getattr(mc, "_probe_in_block", False):
                d = (sfac - state.sfac).abs().amax(dim=(1, 2))
                norm = torch.linalg.vector_norm(sfac, dim=(1, 2))
                probe.errs.append(float(d.max()))
                probe.rel.append(float(
                    (d / norm.clamp_min(SFAC_NORM_FLOOR)).max()))
            return e, w, sfac

        def run_block(mc, *a, **k):
            mc._probe_in_block = True
            try:
                return probe._rb(mc, *a, **k)
            finally:
                mc._probe_in_block = False

        MonteCarlo.full_energy, MonteCarlo.run_block = full_energy, run_block

    def close(self):
        self._cls.full_energy, self._cls.run_block = self._fe, self._rb


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cli_run(tag, dev, path, counter, n_lines, files, resume=None,
            acc_keys=(), positive_keys=(), phase="18"):
    """main() of the port's run.py on a config file, timed; then its
    metrics.jsonl (n_lines lines, every float finite, the drift and S(k)
    gates on each, acc_keys in (0.05, 0.95) on production lines,
    positive_keys above 0), its output files and the launch counter.
    Returns (launches, seconds, lines)."""
    from metropolismontecarlo_tpu_torch.run import main

    with open(path) as f:
        out = json.load(f)["run"]["output"]["dir"]
    argv = [path, "--quiet"] + (["--resume", resume] if resume else [])
    counter.launches = 0
    t0 = time.perf_counter()
    main(argv, device=dev)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = counter.launches
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    for i, ln in enumerate(lines):
        print(f"phase{phase} {tag} line {i}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in ln.items() if k != "t"))
    if len(lines) != n_lines:
        raise AssertionError(f"{tag}: {len(lines)} metrics lines, expected "
                             f"{n_lines}")
    for ln in lines:
        bad = [k for k, v in ln.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: non-finite {bad}: {ln}")
        if not ln["drift_max_rel"] <= DRIFT_TOL:
            raise AssertionError(f"{tag}: drift {ln['drift_max_rel']}")
        if not ln.get("sfac_err_max", 0.0) < SFAC_ABS_TOL:
            raise AssertionError(f"{tag}: S(k) error {ln['sfac_err_max']}")
        if ln.get("phase") == "prod":
            for k in acc_keys:
                if not 0.05 < ln[k] < 0.95:
                    raise AssertionError(f"{tag}: {k} = {ln[k]}")
        for k in positive_keys:
            if not ln[k] > 0.0:
                raise AssertionError(f"{tag}: {k} = {ln[k]}")
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing:
        raise AssertionError(f"{tag}: output files {missing} missing")
    if launches <= 0:
        raise AssertionError(f"{tag}: the kernel was not launched")
    print(f"phase{phase} {tag}: {seconds:.1f} s, {launches} kernel launches, "
          f"files {sorted(os.listdir(out))}")
    return launches, seconds, lines


def phase18(dev, flagship=None, gcmc=None, gibbs=None):
    """The CLI, main() of run.py, on three committed configs with their
    depth cut (each dict updates the run section):
    configs/spce_750.json at full width (750 SPC/E, Ewald K 337, its 512
    chains) from a lattice start at its box 28.24 A (the NIST file is not
    in the repo): 3 blocks of 10 sweeps, 1 of them equilibration, a
    checkpoint every block and the O-O RDF, then a resume from
    checkpoint.npz for a fourth block; configs/gcmc_spce_mega.json (1024
    chains, cap 128, 2 blocks) and configs/gibbs_spce_mega.json (512
    chains, 2 blocks).  Gates: drift <= 2e-3 and the carried S(k) against
    its recompute on every block (sfac_err_max < 1e-4 on the muVT and Gibbs
    lines; on the flagship, which reports none, within 1e-4 of each
    chain's S(k) norm), acceptances after adjustment in
    (0.05, 0.95), insert, delete and transfer acceptances above 0, one
    metrics line per block with finite values, every output file, and
    the kernel launched on each run.  Returns the launches of each run."""
    import tempfile

    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "spce_750")
        run = dict(dict(n_blocks=3, n_steps=10, equil_blocks=1,
                        start={"kind": "lattice", "box": 28.24}),
                   **(flagship or {}))
        path = _cli_config(tmp, "spce_750", run=run,
                           output={"dir": out, "checkpoint_every": 1})
        n = run["n_blocks"]
        probe = _SfacProbe()
        try:
            l1, s1, _ = cli_run(
                "spce_750", dev, path, op.sweep, n,
                ("metrics.jsonl", "rdf.txt", "checkpoint.npz", "final.npz"),
                acc_keys=("acc_trans", "acc_rot"))
            run["n_blocks"] = n + 1
            path = _cli_config(tmp, "spce_750", run=run,
                               output={"dir": out, "checkpoint_every": 1})
            l2, s2, _ = cli_run(
                "spce_750 resumed", dev, path, op.sweep, n + 1,
                ("metrics.jsonl", "rdf.txt", "checkpoint.npz", "final.npz"),
                resume=os.path.join(out, "checkpoint.npz"),
                acc_keys=("acc_trans", "acc_rot"))
        finally:
            probe.close()
        print(f"phase18 spce_750 carried S(k) against the recompute, "
              f"{len(probe.errs)} blocks: largest difference "
              + ", ".join(f"{e:.3e}" for e in probe.errs)
              + "; of the chain's S(k) norm "
              + ", ".join(f"{e:.3e}" for e in probe.rel))
        # the f32 sum of ~3,750 accepted moves' rows per 10-sweep block
        # carries ~1e-4 of absolute residue on components of ~10 (7-9e-5
        # with the plain twin on 4 chains on the CPU): held, as phase 2
        # holds the kernel, to SFAC_REL_TOL of the chain's S(k) norm
        # (~50-80 here)
        if len(probe.rel) != n + 1 or not max(probe.rel) < SFAC_REL_TOL:
            raise AssertionError(f"spce_750 S(k) errors {probe.rel}")
        g = np.loadtxt(os.path.join(out, "rdf.txt"))
        peak = float(g[np.argmax(g[:, 1]), 0])
        print(f"phase18 spce_750 O-O g(r): peak {g[:, 1].max():.3f} at "
              f"{peak:.3f} A")
        res["spce_750"] = (l1 + l2, s1, s2)

        out = os.path.join(tmp, "gcmc")
        path = _cli_config(
            tmp, "gcmc_spce_mega",
            run=dict(dict(n_blocks=2, equil_blocks=1), **(gcmc or {})),
            output={"dir": out, "checkpoint_every": 1})
        res["gcmc_spce_mega"] = cli_run(
            "gcmc_spce_mega", dev, path, op.sweep, _n_blocks(path),
            ("metrics.jsonl", "checkpoint.npz"),
            positive_keys=("acc_insert", "acc_delete"))[:2]

        out = os.path.join(tmp, "gibbs")
        path = _cli_config(
            tmp, "gibbs_spce_mega",
            run=dict(dict(n_blocks=2, equil_blocks=1), **(gibbs or {})),
            output={"dir": out, "checkpoint_every": 1})
        res["gibbs_spce_mega"] = cli_run(
            "gibbs_spce_mega", dev, path, gibbs_kernel.sweep_gibbs,
            _n_blocks(path),
            ("metrics.jsonl", "checkpoint.npz"),
            positive_keys=("acc_transfer",))[:2]
    print(f"phase18 CLI: {time.perf_counter() - t_phase:.1f} s")
    return res


def _bench_fields():
    """The keys of the result record the repo's bench.py prints."""
    import ast

    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec"
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result record in bench.py")


def phase19(configs=("spce", "gcmc"), env=None):
    """`python -m metropolismontecarlo_tpu_torch.bench` for BENCH_CONFIG
    spce and gcmc at their defaults, each in a subprocess: its last line
    is the result JSON with bench.py's fields (and mega for the ensemble
    configs), the line before it the run_block wall."""
    t_phase = time.perf_counter()
    fields = _bench_fields()
    lines = {}
    for config in configs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "metropolismontecarlo_tpu_torch.bench"],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, BENCH_CONFIG=config, **(env or {})))
        out = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(out) < 2:
            raise AssertionError(f"bench {config}: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr[-4000:]}")
        rec, wall = json.loads(out[-1]), json.loads(out[-2])
        want = fields | ({"mega"} if config in ("gcmc", "tmmc", "gibbs",
                                                "semigrand") else set())
        if set(rec) != want or rec["config"] != config \
                or not rec["value"] > 0.0:
            raise AssertionError(f"bench {config}: {rec} (fields {want})")
        print(f"phase19 bench {config} ({time.perf_counter() - t0:.1f} s "
              f"with the process start): {out[-2]}")
        print(f"phase19 bench {config}: {out[-1]}")
        lines[config] = (rec, wall)
    print(f"phase19 bench: {time.perf_counter() - t_phase:.1f} s")
    return lines


# ---------------- binary Gibbs, osmotic ------------------------------------

GIBBS_CO2_N2 = dict(T=240.0, boxes=(17.0, 28.0), caps=(96, 16),
                    n_init=[[72, 18], [2, 8]], r_cut=7.5, p_transfer=0.35,
                    dv_max=0.04, p_bath_bar=27.3)


def _co2_n2_params(tune_box, tol, p_volume=0.01):
    """docs/validation/run_gibbs_co2_n2.py's model parameters (TraPPE, 240
    K, r_cut 7.5 A, site cutoff, no tail), the Ewald parameters tuned at
    tune_box to tol."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    kl, nk, ksq = tune_parameters(tune_box, GIBBS_CO2_N2["r_cut"], tol)
    return RunParams(strict_min_image=False,
                     temperature=GIBBS_CO2_N2["T"],
                     r_cut=GIBBS_CO2_N2["r_cut"], cutoff_mode="site",
                     coulomb="ewald", use_lrc=False, p_translate=0.5,
                     dr_max=0.9, dphi_max=0.9, p_volume=p_volume,
                     kappa_L=kl, nk=nk, ksq_max=ksq)


def phase2_gibbs_binary(dev, chains=64, n_exch=10):
    """One binary Gibbs cycle through mc/moves.make_mega_gibbs_binary_fn
    (CO2/N2 24 + 8 slots per box, one Gibbs launch per species block, the
    state and activity planes of the first feeding the second) with the
    kernel against the same cycle with sweep_gibbs_plain in the op's
    place, on shared uniforms and Philox scores (one generator seed, a
    fresh launch counter each): at most GIBBS_MAX_DIFFERING chains differ;
    on the others positions within POS_TOL, energies within
    ENERGY_REL_TOL of the cycle's term magnitudes, S(k) within
    GIBBS_SFAC_TOL of its norm, equal activities; each species' N
    conserved on every chain."""
    from metropolismontecarlo_tpu_torch.mc import moves
    from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
        BinaryGibbsEnsemble,
    )
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t0 = time.perf_counter()
    system = co2_n2_system(24, 8)
    params = dataclasses.replace(_co2_n2_params(24.0, 1e-3), dr_max=0.5,
                                 dphi_max=0.4, temperature=300.0)
    gen = torch.Generator(device=dev).manual_seed(3300)
    g = BinaryGibbsEnsemble(system, params, p_transfer=0.3,
                            dtype=torch.float32, mega="full", device=dev,
                            generator=gen)
    st = g.init(boxes=(18.0, 24.0), n_init=[[16, 6], [3, 2]],
                n_chains=chains)
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    consts = gibbs_consts(system, params, kv, kw, st.box.float())
    si2s, wc2s = tuple(c[0] for c in consts), tuple(c[1] for c in consts)

    def cycle(op_fn):
        fn = moves.make_mega_gibbs_binary_fn(system, params, kv, kw, dev,
                                             n_exch=(n_exch, n_exch))
        stats = []

        def spy(*a, **k):
            out = op_fn(*a, **k)
            stats.append(out[4])
            return out

        # the cycle reaches the op through moves.gibbs_op: a stand-in
        # module there leaves the op's own launch counter in place
        moves.gibbs_op = SimpleNamespace(sweep_gibbs=spy)
        try:
            out = fn(st.com, st.quat, st.coords, st.active0, st.active1,
                     st.box, st.sfac,
                     torch.Generator(device=dev).manual_seed(77), si2s,
                     wc2s)
        finally:
            moves.gibbs_op = op
        return out, stats

    k, st_k = cycle(op.sweep_gibbs)
    p, st_p = cycle(functools.partial(op.sweep_gibbs_plain, magnitude=True))
    torch.cuda.synchronize()
    same = torch.stack([(a[:, 2:8] == b[:, 2:8]).all(1)
                        for a, b in zip(st_k, st_p)]).all(0)
    n_diff = int((~same).sum())
    mag = sum(x[:, op.N_STATS] for x in st_p).clamp_min(1.0)
    pos = max(float((k[i] - p[i])[same].abs().max()) for i in (0, 1, 2))
    e_rel = float(((k[6] - p[6]).abs() / mag[:, None])[same].max())
    s_norm = torch.clamp_min(torch.linalg.vector_norm(p[5].flatten(2),
                                                      dim=2),
                             SFAC_NORM_FLOOR)
    s_rel = float(((k[5] - p[5]).flatten(2).abs().max(dim=2).values
                   / s_norm)[same].max())
    acts = all(torch.equal(k[i][same], p[i][same]) for i in (3, 4))
    conserved = all(torch.equal(out[3 + s].sum((1, 2)),
                                a.sum((1, 2)))
                    for out in (k, p)
                    for s, a in enumerate((st.active0, st.active1)))
    print(f"phase 2g binary cycle co2/n2 24+8 (make_mega_gibbs_binary_fn, "
          f"2 launches): chains {chains}, differing {n_diff}, acc/att "
          f"moves {k[7][:, :2].sum(0).tolist()}/"
          f"{k[8][:, :2].sum(0).tolist()}, transfers accepted "
          f"{k[7][:, 2:].sum(0).tolist()} of {chains * n_exch} each; "
          f"coord/com/quat err {pos:.3e}, energy err {e_rel:.3e} of the "
          f"cycle's energy scale, S(k) err {s_rel:.3e} of its norm, "
          f"activities equal {acts}, N conserved {conserved}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not (n_diff <= GIBBS_MAX_DIFFERING and conserved and acts
            and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= GIBBS_SFAC_TOL
            and all(bool(torch.isfinite(x).all()) for x in k)):
        raise AssertionError("binary cycle: the kernel and its plain "
                             "version disagree")
    return max(pos, e_rel, s_rel)


def volume_attempt_ms(tag, vol_step, st, gen, reps=3):
    """ms per volume attempt of vol_step(st, u_dv, u_acc, bit) (every
    chain, both boxes recomputed) on the main path's state, with every
    ops/ewald.structure_factor call sent to the eik recurrence
    (structure_factor_recurrence) and to the direct sum
    (structure_factor_direct), in turns (recurrence, direct, direct,
    recurrence; reps attempts each, the host clock varies between calls);
    the two take the same decisions on >= 98% of chains, on which their
    S(k) rows agree within SFAC_REL_TOL of the row's largest |S(k)| and
    their box energies within DRIFT_TOL of max(|E|, 1), the drift gate's
    scale (two float32 routes: a near-empty box's energy is a small
    remainder of large terms).  Returns the means (recurrence ms, direct
    ms, the ms of the route structure_factor takes at this K by
    itself)."""
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops

    C, K = st.box.shape[0], st.sfac.shape[2]
    u = torch.rand((3, C), generator=gen, device=st.box.device,
                   dtype=st.box.dtype)
    real = ewald_ops.structure_factor

    def direct(coords, charges, kvecs, box, bounds=None):
        return ewald_ops.structure_factor_direct(coords, charges, kvecs, box)

    def call():
        return vol_step(st, u[0], u[1], u[2] < 0.5)

    def timed(sfac_fn):
        ewald_ops.structure_factor = sfac_fn
        try:
            return call(), _time_ms(call, reps)
        finally:
            ewald_ops.structure_factor = real

    rec = ewald_ops.structure_factor_recurrence
    timed(rec)                                                      # warm
    turns = [timed(fn) for fn in (rec, direct, direct, rec)]
    out, out_d = turns[0][0], turns[1][0]
    ms = 0.5 * (turns[0][1] + turns[3][1])
    ms_d = 0.5 * (turns[1][1] + turns[2][1])
    same = (out.acc == out_d.acc).all(1)
    rel = float(((out.energy - out_d.energy).abs()
                 / out.energy.abs().clamp_min(1.0))[same].max())
    s_rel = float(((out.sfac - out_d.sfac).abs().amax((-1, -2))
                   / out_d.sfac.abs().amax((-1, -2)).clamp_min(
                       SFAC_NORM_FLOOR))[same].max())
    frac = float(same.float().mean())
    use_rec = K >= ewald_ops.RECURRENCE_MIN_K
    print(f"phase{tag} volume attempt ({C} chains, K {K}): {ms:.3f} ms with "
          f"the eik recurrence, {ms_d:.3f} ms with the direct sum (in "
          f"turns: " + ", ".join(f"{t[1]:.3f}" for t in turns)
          + f"); structure_factor takes the "
          f"{'recurrence' if use_rec else 'direct sum'} at this K; same "
          f"decision on {frac:.4f} of chains, energies within {rel:.2e}, "
          f"S(k) within {s_rel:.2e}")
    if not (frac >= MATCH_FRACTION and rel <= DRIFT_TOL
            and s_rel <= SFAC_REL_TOL):
        raise AssertionError(f"{tag}: the recurrence and the direct sum "
                             f"disagree")
    return ms, ms_d, (ms if use_rec else ms_d)


def binary_gibbs_blocks(tag, g, st, blocks, att_pc, n_tot, gated=True,
                        gate_vol="both"):
    """BinaryGibbsEnsemble.run_blocks of `blocks` cycles each with the
    drift, S(k), per-species N conservation (n_tot per species) and
    transfer gates (both species attempted, both acceptances in (0, 1);
    gate_vol "both": acc_vol in (0, 1), "positive": acc_vol > 0) and the
    launch count, one Gibbs launch per species block per cycle; gated=False
    prints only.  Returns (state, launches)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op

    launches0 = op.sweep_gibbs.launches
    for n_cyc in blocks:
        att0 = st.att.clone()
        t0 = time.perf_counter()
        st, stats = g.run_block(st, n_cyc * att_pc)
        torch.cuda.synchronize()
        print(f"phase{tag} run_block({n_cyc} cycles): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v}" if isinstance(v, list) else f"{k} {v:.6g}"
                  for k, v in stats.items()))
        for s, a in enumerate((st.active0, st.active1)):
            n_chain = a.sum((1, 2))
            if not bool((n_chain == n_tot[s]).all()):
                raise AssertionError(f"species {s}: N not conserved: "
                                     f"{n_chain.unique()}")
        att = (st.att - att0).sum(0)
        vol_ok = 0.0 < stats["acc_vol"] < 1.0 if gate_vol == "both" \
            else stats["acc_vol"] > 0.0
        if gated and not (stats["drift_max_rel"] < DRIFT_TOL
                          and stats["sfac_err_max"] < SFAC_ABS_TOL
                          and int(att[3]) > 0 and int(att[4]) > 0
                          and 0.0 < stats["acc_transfer0"] < 1.0
                          and 0.0 < stats["acc_transfer1"] < 1.0
                          and vol_ok):
            raise AssertionError(f"phase{tag}: a gate failed: {stats}")
    launches = op.sweep_gibbs.launches - launches0
    if launches != 2 * sum(blocks):
        raise AssertionError(f"{launches} launches for {sum(blocks)} cycles")
    return st, launches


def phase20(dev, chains=1024, warm=2, blocks=(2, 2), chunk=128,
            npt_cycles=1):
    """Binary Gibbs CO2/N2 at docs/validation/run_gibbs_co2_n2.py's model
    and state point (caps 96 + 16 per box, boxes 17 / 28 A, 72 + 18 CO2
    and 2 + 8 N2, 240 K, Ewald tuned at 33 A to 5e-3, p_transfer 0.35,
    p_volume 0.01, dv_max 0.04), 1024 chains through
    BinaryGibbsEnsemble(mega="full"): a 2-cycle warm-up and two 2-cycle
    blocks (two Gibbs launches per cycle, one per species block, and 3
    volume moves); one cycle on the main path's arguments against
    sweep_gibbs_plain and each species launch timed; the volume attempt
    timed with the eik recurrence and with the direct sum, and its share
    of a cycle on the route structure_factor takes by itself; then one
    NPT-Gibbs block at run_gibbs_npt_co2_n2.py's bath (27.3 bar) and
    Ewald (tuned at 37.8 A to 1e-3) from the end state, with the kernel's
    occupancy and the volume attempt's two routes at that shape.  Returns
    the launches."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
        BinaryGibbsEnsemble,
    )
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t_phase = time.perf_counter()
    cfg = GIBBS_CO2_N2
    system = co2_n2_system(*cfg["caps"])
    M = system.n_mol
    params = _co2_n2_params(33.0, 5e-3)
    gen = torch.Generator(device=dev).manual_seed(2020)
    common = dict(dv_max=cfg["dv_max"], p_transfer=cfg["p_transfer"],
                  dtype=torch.float32, chunk=chunk, device=dev,
                  generator=gen)
    g = BinaryGibbsEnsemble(system, params, mega="full", **common)
    x_half = g.run_steps.x_half
    att_pc = 2 * M + 2 * x_half
    k_vol = max(1, int(round(params.p_volume * att_pc)))
    n_tot = [sum(row) for row in cfg["n_init"]]
    t0 = time.perf_counter()
    st = g.init(boxes=cfg["boxes"], n_init=cfg["n_init"], n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase20 init: {time.perf_counter() - t0:.2f} s; co2_n2_system"
          f"{cfg['caps']}, boxes {cfg['boxes']}, n_init {cfg['n_init']}, "
          f"kappa_L {params.kappa_L:.2f}, nk {params.nk}, ksq_max "
          f"{params.ksq_max}, K {st.sfac.shape[2]}, A_pad "
          f"{st.coords.shape[-1]}, x_half {x_half} (a cycle: {2 * M} moves "
          f"+ 2 x {x_half} transfers, {k_vol} volume moves), {chains} chains")
    op.sweep_gibbs.launches = 0
    st, _ = binary_gibbs_blocks("20 warm-up", g, st, (warm,), att_pc, n_tot,
                                gated=False)
    st, _ = binary_gibbs_blocks("20", g, st, blocks, att_pc, n_tot)
    launches = op.sweep_gibbs.launches
    print(f"phase20 sweep_gibbs_kernel launches on the binary Gibbs main "
          f"path: {launches} ({warm + sum(blocks)} cycles, 2 per cycle)")

    # one cycle on the main path's arguments, held to the twin and timed
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    tables = sweep_tables(system, params, kv, kw, dev)
    A_off, K = st.coords.shape[-1], st.sfac.shape[2]
    t0_ = tables[0]
    regs, local, per_sm = op.occupancy(t0_, M, A_off, K)
    smem = op.gibbs_smem_bytes(M, t0_.P, A_off, K, t0_.eps.shape[1], t0_.nk)
    print(f"phase20 gibbs_kernel at K {K}: {regs} registers, {local} B "
          f"local, {per_sm} blocks per SM ({smem} B of shared memory)")
    active = torch.cat([st.active0, st.active1], 2)
    act, actm = activity_planes(system, active.reshape(2 * chains, M))
    act, actm = act.reshape(chains, 2, -1), actm.reshape(chains, 2, M)
    ones = torch.ones((chains,), device=dev)
    args = [x.float().contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        params.temperature * ones, params.dr_max * ones,
        params.dphi_max * ones]
    us = [draw_uniforms(chains, 2 * t.M, gen, dev) for t in tables]
    uxs = [draw_exchange_uniforms(chains, x_half, gen, dev) for _ in tables]
    consts = gibbs_consts(system, params, kv, kw, args[4])
    rest = (us, tables, act, actm, [x_half] * 2, uxs, consts, 97)
    err, out = compare_gibbs("20 cycle vs plain", args, *rest)
    ms_blk = [_time_ms(lambda b=b: run_gibbs(
        op.sweep_gibbs, args, [us[b]], [tables[b]], act, actm, [x_half],
        [uxs[b]], [consts[b]], 97 + b), 3) for b in range(2)]
    ms = _time_ms(lambda: run_gibbs(op.sweep_gibbs, args, *rest), 3)
    plain_ms = _time_ms(lambda: run_gibbs(op.sweep_gibbs_plain, args,
                                          *rest), 1)
    frac = _gibbs_cutoff_fraction(system, st.coords, active, st.box,
                                  params.r_cut)
    ranges = [(t.m_start, t.M) for t in tables]
    near = [_reach_fraction(st.coords[:, b], st.com[:, b],
                            system.atom_mol_slot[0], st.box[:, b],
                            params.r_cut, active[:, b], m_ranges=ranges)
            for b in range(2)]
    n_box = active.sum(2)
    bounds = [gibbs_bound(t, chains, A_off, M, K, n_box, frac,
                          [near[0][s], near[1][s]], x_half,
                          n_move=a.sum(2))
              for s, (t, a) in enumerate(zip(tables, (st.active0,
                                                      st.active1)))]
    print(f"phase20 one cycle, {chains} chains, N per box "
          f"{float(n_box[:, 0].float().mean()):.1f} / "
          f"{float(n_box[:, 1].float().mean()):.1f}: CO2 launch "
          f"{ms_blk[0]:.3f} ms ({2 * tables[0].M} moves + {x_half} "
          f"transfers; bound {bounds[0][0]:.3f} ms, {bounds[0][1]}), N2 "
          f"launch {ms_blk[1]:.3f} ms ({2 * tables[1].M} moves + {x_half} "
          f"transfers; bound {bounds[1][0]:.3f} ms, {bounds[1][1]}), both "
          f"{ms:.3f} ms, sweep_gibbs_plain {plain_ms:.3f} ms; "
          f"{frac[0]:.4f} / {frac[1]:.4f} of active pairs within the "
          f"cutoff")

    # the volume attempt, with the recurrence and with the direct sum
    g_p = BinaryGibbsEnsemble(system, params, **common)
    vol_ms = volume_attempt_ms("20", g_p.run_steps.volume_step, st, gen)[2]
    cyc = ms + k_vol * vol_ms
    print(f"phase20 a cycle, the two launches and {k_vol} volume attempts: "
          f"{cyc:.3f} ms, the volume attempts' share "
          f"{100.0 * k_vol * vol_ms / cyc:.1f}%")

    # NPT-Gibbs at the measured bubble pressure, from the end state
    params_n = _co2_n2_params(1.35 * max(cfg["boxes"]), 1e-3)
    g_n = BinaryGibbsEnsemble(system, params_n, mega="full",
                              npt_pressure=cfg["p_bath_bar"] * P_BAR,
                              **common)
    st_n = dataclasses.replace(st, sfac=torch.zeros(
        (chains, 2, len(make_kvectors(params_n.nk, params_n.ksq_max)[0]), 2),
        device=dev))
    e_n, sf_n = g_n.full_energy(st_n)
    st_n = dataclasses.replace(st_n, energy=e_n, sfac=sf_n)
    t_n = sweep_tables(system, params_n, *make_kvectors(params_n.nk,
                                                        params_n.ksq_max),
                       dev)[0]
    K_n = st_n.sfac.shape[2]
    regs, local, per_sm = op.occupancy(t_n, M, A_off, K_n)
    print(f"phase20 NPT-Gibbs: P_bath {cfg['p_bath_bar']} bar, kappa_L "
          f"{params_n.kappa_L:.2f}, nk {params_n.nk}, ksq_max "
          f"{params_n.ksq_max}, K {K_n}; gibbs_kernel {regs} registers, "
          f"{local} B local, {per_sm} blocks per SM "
          f"({op.gibbs_smem_bytes(M, t_n.P, A_off, K_n, t_n.eps.shape[1],
                                   t_n.nk)} B of shared memory)")
    st_n, l_n = binary_gibbs_blocks("20 npt", g_n, st_n, (npt_cycles,),
                                    att_pc, n_tot, gate_vol="positive")
    # the NPT-Gibbs cycle's two launches (K 3796: one block per SM in the
    # shared layout) in each layout, in turns: data for when a global
    # layout should replace a shared one
    active_n = torch.cat([st_n.active0, st_n.active1], 2)
    act_n, actm_n = activity_planes(system, active_n.reshape(2 * chains, M))
    args_n = [x.float().contiguous() for x in (
        st_n.coords, st_n.com, st_n.quat, st_n.sfac, st_n.box)] + [
        params_n.temperature * ones, params_n.dr_max * ones,
        params_n.dphi_max * ones]
    kv_n, kw_n = make_kvectors(params_n.nk, params_n.ksq_max)
    tables_n = sweep_tables(system, params_n, kv_n, kw_n, dev)
    rest_n = ([draw_uniforms(chains, 2 * t.M, gen, dev) for t in tables_n],
              tables_n, act_n.reshape(chains, 2, -1),
              actm_n.reshape(chains, 2, M), [x_half] * 2,
              [draw_exchange_uniforms(chains, x_half, gen, dev)
               for _ in tables_n],
              gibbs_consts(system, params_n, kv_n, kw_n, args_n[4]), 95)
    for i, t in enumerate(tables_n):
        print(f"phase20 NPT-Gibbs launch {i}: blocks per SM "
              + ", ".join(f"{lay} {op.occupancy(t, M, A_off, K_n, lay)[2]}"
                          for lay in op.LAYOUTS))
    layouts_equal("20 NPT-Gibbs cycle, both launches", lambda lay: run_gibbs(
        functools.partial(op.sweep_gibbs, layout=lay), args_n, *rest_n))
    g_np = BinaryGibbsEnsemble(system, params_n,
                               npt_pressure=cfg["p_bath_bar"] * P_BAR,
                               **common)
    volume_attempt_ms("20 NPT-Gibbs", g_np.run_steps.volume_step, st_n, gen)
    print(f"phase20 sweep_gibbs_kernel launches on the NPT-Gibbs path: "
          f"{l_n}; boxes {st_n.box.mean(0).tolist()} A; phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches + l_n, err, ms, plain_ms


def phase21(dev, chains=1024, blocks=(2, 2), hybrid_cycles=1, chunk=64):
    """Osmotic MC at configs/osmotic_mea.json's state point with the MEA
    solute replaced by TraPPE CH4 (MEA needs the absent topology):
    spce_methane_system(240, 16), box 19.5 A, 313.15 K, r_cut 9, Ewald
    (kappa L 5.6, nk 5, K 337), no tail, activity 1e-4, p_exchange 0.3,
    4 solutes at the start; 1024 chains through OsmoticGCMC(mega="full"):
    two 2-cycle blocks (per cycle the solvent block's sweep launch and the
    solute block's launch with 110 exchange attempts), then one mega=True
    block (both sweep launches + 110 plain exchange steps per cycle) from
    the end state.  Gates (muvt_blocks): drift, S(k), every acceptance
    in (0, 1); one full cycle on the main path's arguments against
    sweep_plain, its solvent plane unchanged, each launch timed.  Returns
    the launches."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_osmotic import OsmoticGCMC
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_methane_system,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t_phase = time.perf_counter()
    z, px, ns = 1e-4, 0.3, 240
    params = RunParams(temperature=313.15, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.3,
                       dphi_max=0.3, use_lrc=False)
    system = spce_methane_system(ns, 16)
    M = system.n_mol
    gen = torch.Generator(device=dev).manual_seed(2121)

    def build(mega):
        return OsmoticGCMC(system, params, activity=z, p_exchange=px,
                           dtype=torch.float32, chunk=chunk, mega=mega,
                           device=dev, generator=gen)

    g = build("full")
    x_per = g.run_steps.x_per
    apc = M + x_per
    t0 = time.perf_counter()
    st = g.init(box=19.5, n_init=4, n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase21 init: {time.perf_counter() - t0:.2f} s; "
          f"spce_methane_system({ns}, 16), 19.5 A, A_pad "
          f"{st.coords.shape[-1]}, K {st.sfac.shape[1]}, x_per {x_per} (a "
          f"cycle: {M} moves + {x_per} solute attempts), {chains} chains")

    st, l_full, _ = muvt_blocks("21 full", g, st, blocks, apc, 2)
    _, l_hyb, _ = muvt_blocks("21 hybrid", build(True), st,
                              (hybrid_cycles,), apc, 2)
    print(f"phase21 sweep_kernel launches on the osmotic paths: {l_full} "
          f"full, {l_hyb} hybrid (2 per cycle)")

    # one full cycle on the main path's arguments against the twin, timed
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    tables = sweep_tables(system, params, kv, kw, dev)
    consts = _exchange_consts(system, params, kv, kw, st.box.float())
    full = torch.cat([torch.ones((chains, ns), dtype=torch.bool,
                                 device=dev), st.active], 1)
    view = SimpleNamespace(com=st.com, quat=st.quat, coords=st.coords,
                           sfac=st.sfac, box=st.box, active=full)
    err, ms, plain_ms, bound_ms, bound_by = time_variant(
        "21 full cycle", system, params, tables, view, gen, (0, x_per),
        (0, 0), z, consts)
    act, actm = activity_planes(system, full)
    ones = torch.ones((chains,), device=dev)
    args = [x.float().contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        params.temperature * ones, params.dr_max * ones,
        params.dphi_max * ones, draw_uniforms(chains, M, gen, dev)]
    uxs = [draw_exchange_uniforms(chains, n, gen, dev) for n in (0, x_per)]
    rest = (act, actm, (0, x_per), (0, 0), uxs, z * ones, consts, 79)
    out = run_variant(op.sweep, args, tables, *rest)
    solvent_on = bool((out[6][:, :ns] == 1.0).all())
    ms_blk = [_time_ms(lambda b=b: run_variant(
        op.sweep, args, [tables[b]], act, actm, (rest[2][b],), (0,),
        [uxs[b]], z * ones, [consts[b]], 79), 3) for b in range(2)]
    print(f"phase21 the solvent launch ({ns} moves) {ms_blk[0]:.3f} ms, the "
          f"solute launch (16 moves + {x_per} attempts) {ms_blk[1]:.3f} ms; "
          f"solvent plane unchanged {solvent_on}; phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not solvent_on:
        raise AssertionError("phase21: a solvent slot changed activity")
    return l_full + l_hyb, err, ms, plain_ms, bound_ms, bound_by

# ---------------- phases 22-23: TIP4P and the topology front end --------


def _pdb_atom(i, name, res, xyz):
    """One ATOM record in the PDB columns io/pdb.py read_pdb reads."""
    return (f"ATOM  {i:5d} {name:<4s} {res:<3s} A{1:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00\n")


def write_topology_files(directory, comb_rule=2):
    """A stand-in for the reference's MEA/TIP3P input (topol.top, mea.pdb,
    tip3p.pdb, which the repo does not hold), written into `directory`
    from the port's own constants: TIP3P (models/water.py) as the
    moleculetype SOL in an #include'd tip3p.itp whose #ifdef FLEXIBLE
    branch holds bonds and angles and whose #else branch the rigid
    [settles] and [exclusions], and TraPPE-UA CH4 as a one-site
    MEA_DUMMY.  comb_rule 2 (Lorentz-Berthelot) or 3 (geometric).
    Returns {"top", "mea", "tip3p"} -> path."""
    from metropolismontecarlo_tpu_torch.models import water
    from metropolismontecarlo_tpu_torch.utils.constants import (
        KJ_PER_MOL_TO_K,
    )

    def kj(eps_k):
        return repr(eps_k / KJ_PER_MOL_TO_K)

    def nm(sig_a):
        return repr(sig_a / 10.0)

    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("top", "topol.top"), ("mea", "mea.pdb"), ("tip3p", "tip3p.pdb"))}
    q_o, q_h = water.TIP3P_Q_O, water.TIP3P_Q_H
    with open(os.path.join(directory, "tip3p.itp"), "w") as f:
        f.write(f"""; TIP3P water, rigid unless FLEXIBLE is defined
[ moleculetype ]
; molname  nrexcl
SOL        2

[ atoms ]
; nr type resnr residue atom cgnr charge mass
1  OW  1  SOL  OW   1  {q_o!r}  {water.MASS_O!r}
2  HW  1  SOL  HW1  1  {q_h!r}  {water.MASS_H!r}
3  HW  1  SOL  HW2  1  {q_h!r}  {water.MASS_H!r}

#ifdef FLEXIBLE
[ bonds ]
1  2  1  0.09572  502416.0
1  3  1  0.09572  502416.0

[ angles ]
2  1  3  1  104.52  628.02
#else
[ settles ]
; OW  funct  doh  dhh
1  1  0.09572  0.15139

[ exclusions ]
1  2  3
2  1  3
3  1  2
#endif
""")
    atomtypes = "\n".join(
        f"{name}  {num}  {mass!r}  0.0  A  {sig}  {eps}"
        for name, num, mass, sig, eps in (
            ("OW", 8, water.MASS_O, nm(water.TIP3P_SIGMA_OO),
             kj(water.TIP3P_EPS_OO)),
            ("HW", 1, water.MASS_H, "0.0", "0.0"),
            ("CH4", 6, water.MASS_CH4, nm(water.CH4_SIGMA),
             kj(water.CH4_EPS))))
    with open(paths["top"], "w") as f:
        f.write(f"""; stand-in MEA/TIP3P topology: TIP3P water and TraPPE-UA
; methane in the place of MEA
[ defaults ]
; nbfunc  comb-rule  gen-pairs  fudgeLJ  fudgeQQ
1  {comb_rule}  yes  0.5  0.8333

[ atomtypes ]
; name  at.num  mass  charge  ptype  sigma  epsilon
{atomtypes}

#include "tip3p.itp"

[ moleculetype ]
MEA_DUMMY  3

[ atoms ]
1  CH4  1  MEA  C1  1  0.0  {water.MASS_CH4!r}

[ system ]
MEA in water (stand-in)

[ molecules ]
MEA_DUMMY  1
SOL        1000
""")
    body = water.water_body_frame(water.TIP3P_R_OH, water.TIP3P_THETA)
    with open(paths["tip3p"], "w") as f:
        for i, (name, xyz) in enumerate(zip(("OW", "HW1", "HW2"),
                                            body + 1.5), start=1):
            f.write(_pdb_atom(i, name, "SOL", xyz))
        f.write("END\n")
    with open(paths["mea"], "w") as f:
        f.write("CRYST1   28.650   28.650   28.650  90.00  90.00  90.00 "
                "P 1           1\n")
        f.write(_pdb_atom(1, "C1", "MEA", (14.325, 14.325, 14.325)))
        f.write("END\n")
    return paths


def phase22(dev, n_mol=750, box=28.24, chains=2048, r_cut=10.0,
            adjust=10, steps=2, density=(216, 128, 10, 50), melt=500,
            cli_chains=64):
    """TIP4P/2005 at full width.  tip4p2005_system(750) at the flagship's
    box (28.24 A), 298.15 K, r_cut 10, Ewald (K 337), 2048 chains on the
    whole-sweep route: `adjust` sweeps with step-size adaptation and
    run_block(steps) (drift <= 2e-3 of the energy carried since init, the
    carried S(k) within 1e-4 of each chain's norm, acceptance in (0.05,
    0.95)); the kernel against sweep_plain (its time is the plain
    version's); one sweep timed beside its bound, with A_pad, shared
    bytes and blocks per SM.
    Then one block of the per-move route at P = 4 on its CUDA graph (750
    delta_energy launches of R = 8 rows per sweep) from that state, and
    delta_energy on its arguments against its plain version, timed.  Then
    docs/validation/run_tip4p_density.py's state point (216 waters, 128
    chains, 1 bar, r_cut 9, p_volume 0.2, dv_max 0.02), melted at the
    start's volume (`melt` sweeps at 600 K, then at 298.15 K), for
    `density`[2] blocks of [3] sweeps, half of them adjusting: the
    density of the last half within 0.97-1.03 g/cc (a loose gate: a
    misplaced M charge moves it far; not a converged number).  Then the CLI on a tip4p2005 config
    (64 chains, 2 blocks).  Returns ((launches, err, ms, plain_ms,
    bound_ms, bound_by) of the sweep kernel, (launches, err, ms,
    device_ms, plain_ms, bound_ms, bound_by) of delta_energy)."""
    import tempfile

    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import tip4p2005_system
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t_phase = time.perf_counter()
    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    system = tip4p2005_system(n_mol)
    gen = torch.Generator(device=dev).manual_seed(2222)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    if mc.route != "sweep":
        raise AssertionError(f"TIP4P took route {mc.route}")
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    A_pad, K = state.coords.shape[-1], state.sfac.shape[1]
    shape = (n_mol, 4, A_pad, K, system.eps_table.shape[0])
    print(f"phase22 init_state: {time.perf_counter() - t0:.2f} s, P 4, "
          f"A_pad {A_pad}, K {K}, {op.smem_bytes(*shape)} B of shared "
          f"memory, {op.blocks_per_sm(*shape)} blocks per SM, layout "
          f"{op.choose_layout(*shape)}")
    # the adjust sweeps without a block-end recompute (~9 s here): the
    # run_block after them checks the energy carried since init_state
    t0 = time.perf_counter()
    state = mc.run_steps(state, adjust, adjust=True)
    torch.cuda.synchronize()
    print(f"phase22 run_steps({adjust}, adjust=True): "
          f"{time.perf_counter() - t0:.2f} s")
    probe = _SfacProbe()
    try:
        state, launches = main_path("22", mc, state, ((steps, False),), 1,
                                    op.sweep)
    finally:
        probe.close()
    print(f"phase22 carried S(k) against the recompute: "
          + ", ".join(f"{e:.3e}" for e in probe.rel) + " of the chain's norm")
    if not max(probe.rel) < SFAC_REL_TOL:
        raise AssertionError(f"TIP4P S(k) errors {probe.rel}")
    C, M = state.com.shape[:2]
    args = _sweep_args(state, draw_uniforms(C, M, gen, dev))
    err, _, plain_ms = compare_tables("22 tip4p2005-750 kernel vs plain",
                                      args, mc.tables)
    sweep_row = (launches, err) + time_sweep("22", mc, state, gen, system,
                                             plain_ms=plain_ms)

    # the per-move route at P = 4: the first run_block captures the sweep
    # graph (one warm-up launch), the sweep replays it
    mc_m = MonteCarlo(system, params, device=dev, generator=gen,
                      kernel="move")
    t0 = time.perf_counter()
    state_m, l_m = main_path("22 per-move", mc_m, state, ((1, False),),
                             n_mol, dop.delta_energy,
                             extra=len(mc_m.move_bodies))
    print(f"phase22 per-move block on the sweep graph (capture included): "
          f"{time.perf_counter() - t0:.2f} s")
    _, _, body = mc_m.move_bodies[0]
    m = n_mol // 2
    u = draw_uniforms(chains, 1, gen, dev)[:, 0]
    pr = body.propose(state_m.com, state_m.quat, state_m.coords,
                      state_m.box, u, state_m.dr_max, state_m.dphi_max, m)
    args = body.delta_args(pr, state_m.coords, state_m.box, m)
    err_d = check_delta(f"22 delta_energy R=8 main path m={m}", args,
                        body.P)
    R = args[3].shape[1]
    tensors = tuple(args[:7]) + tuple(args[8:16])
    outs = tuple(torch.empty((chains, R), device=dev) for _ in range(3))
    d_dev = _graph_ms(lambda: dop._launch(tensors, m, args[16], outs), 20)
    d_ms = _time_ms(lambda: dop.delta_energy(*args), 20)
    d_plain = _time_ms(lambda: dop.delta_energy_plain(*args), 3)
    frac = _cutoff_fraction(system, state_m, r_cut)
    near = _reach_fraction(state_m.coords, state_m.com,
                           system.atom_mol_slot[0], state_m.box, r_cut,
                           n=64, m_ranges=[(m, 1)])[0]
    d_bound, d_by = delta_bound(args, body.P, frac, near)
    print(f"phase22 one delta_energy launch, {chains} chains x {A_pad} "
          f"lanes x {R} rows: wrapper call {d_ms * 1e3:.3f} us, device time "
          f"{d_dev * 1e3:.3f} us, plain {d_plain * 1e3:.3f} us, bound "
          f"{d_bound * 1e3:.3f} us ({d_by}; {near:.4f} of atoms within the "
          f"moved molecule's reach)")
    delta_row = (l_m, err_d, d_ms, d_dev, d_plain, d_bound, d_by)

    # run_tip4p_density.py's state point, at reduced depth
    n_d, c_d, n_blocks, sweeps = density
    box0 = (n_d / 0.0334) ** (1.0 / 3.0)
    params_d = RunParams(temperature=298.15, r_cut=9.0, coulomb="ewald",
                         p_translate=0.5, dr_max=0.25, dphi_max=0.3,
                         pressure=P_BAR, p_volume=0.2, dv_max=0.02)
    gen_d = torch.Generator(device=dev).manual_seed(42)
    mc_d = MonteCarlo(tip4p2005_system(n_d), params_d, device=dev,
                      generator=gen_d)
    t0 = time.perf_counter()
    st = mc_d.init_state(cubic_lattice(n_d, box0), box=box0, n_chains=c_d)
    # under NPT the lattice start collapses to ~1.04 g/cc within 500
    # sweeps and relaxes back over ~1e4 (PERF.md §6): melt it at the
    # start's volume first, at 600 K and then at 298.15 K
    for temp_k in (600.0, 298.15):
        p_melt = dataclasses.replace(params_d, temperature=temp_k,
                                     pressure=None, p_volume=0.0)
        mc_melt = MonteCarlo(tip4p2005_system(n_d), p_melt, device=dev,
                             generator=gen_d)
        st = dataclasses.replace(st, temp=torch.full_like(st.temp, temp_k))
        st, m_d = mc_melt.run_block(st, melt, adjust=True)
        print(f"phase22 density melt at {temp_k} K, {melt} sweeps at "
              f"fixed V: drift {m_d['drift_max_rel']:.2e}")
    rhos, acc_vol, worst = [], [], 0.0
    for b in range(n_blocks):
        adjust = b < n_blocks // 2
        st, m_d = mc_d.run_block(st, sweeps, adjust=adjust)
        worst = max(worst, m_d["drift_max_rel"])
        rho = float((G_CC * n_d / st.box.double() ** 3).mean())
        if not adjust:
            rhos.append(rho)
            acc_vol.append(m_d["acc_vol"])
        print(f"phase22 density block {b} ({'adjust' if adjust else 'prod'})"
              f": rho {rho:.4f} g/cc, drift {m_d['drift_max_rel']:.2e}"
              + (f", acc_vol {m_d['acc_vol']:.3f}" if not adjust else ""))
    rho = sum(rhos) / len(rhos)
    print(f"phase22 TIP4P/2005 216 x {c_d} chains at 1 bar: rho {rho:.4f} "
          f"g/cc over the last {len(rhos)} blocks of {sweeps} sweeps, "
          f"acc_vol {sum(acc_vol) / len(acc_vol):.3f}, worst drift "
          f"{worst:.2e}, {time.perf_counter() - t0:.1f} s (the JAX record "
          f"on a TPU v5 lite, 50 + 40 blocks of 250 sweeps: 0.9987)")
    if not (0.97 < rho < 1.03 and worst <= DRIFT_TOL
            and 0.0 < min(acc_vol) and max(acc_vol) < 1.0):
        raise AssertionError(f"TIP4P density {rho} g/cc, drift {worst}, "
                             f"acc_vol {acc_vol}")

    # the CLI on a tip4p2005 config
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tip4p")
        cfg = {"model": {"kind": "tip4p2005", "n_mol": n_d},
               "params": {"temperature": 298.15, "r_cut": 9.0,
                          "cutoff_mode": "site", "coulomb": "ewald",
                          "p_translate": 0.5, "dr_max": 0.25,
                          "dphi_max": 0.3},
               "run": {"n_chains": cli_chains, "n_blocks": 2, "n_steps": 10,
                       "equil_blocks": 1, "seed": 0, "dtype": "float32",
                       "start": {"kind": "lattice", "density": 0.0334},
                       "output": {"dir": out}}}
        path = os.path.join(tmp, "tip4p2005.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        cli_run("tip4p2005", dev, path, op.sweep, 2, ("metrics.jsonl",),
                acc_keys=("acc_trans", "acc_rot"), phase="22")
    print(f"phase22: {time.perf_counter() - t_phase:.1f} s")
    return sweep_row, delta_row


def phase23(dev, cli=(64, 2, 4, 2), bench_chains=256, nlist_chains=64,
            nlist_width=96):
    """The topology front end on stand-in files (write_topology_files):
    the CLI on configs/mea_tip3p.json's model and run sections with those
    paths (100 MEA_DUMMY + 1900 SOL, `cli` = (chains, blocks, sweeps per
    block, quench sweeps)); bench.py's "mixture" setup with bench.REF
    pointed at them (256 chains, two species-block launches per sweep):
    the layout, run_block(2) with the drift and S(k) gates, each
    species-block launch timed, the sweep against sweep_plain and its
    bound; its System equal field by field to the one the config kind
    builds from the same files.  Then Verlet neighbour lists on 64 chains
    of the bench state: one sweep on the list route (plain tensor code)
    against one on the dense plain route from the same state and
    uniforms (walls, needed width, drift), and nlist_width 2, which must
    raise RuntimeError at the block's end.  Returns (launches, err, ms,
    plain_ms, bound_ms, bound_by) of the mixture's main path."""
    import tempfile

    from metropolismontecarlo_tpu_torch import bench
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        nlist_radius,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.utils import config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_topology_files(tmp)
        out = os.path.join(tmp, "mea_tip3p")
        chains, n_blocks, n_steps, quench = cli
        model = {"kind": "topology", "top": paths["top"],
                 "templates": {"MEA_DUMMY": paths["mea"],
                               "SOL": paths["tip3p"]},
                 "molecules": [["MEA_DUMMY", 100], ["SOL", 1900]]}
        path = _cli_config(tmp, "mea_tip3p", model=model,
                           run={"n_chains": chains, "n_blocks": n_blocks,
                                "n_steps": n_steps, "equil_blocks": 1,
                                "quench_steps": quench},
                           output={"dir": out, "checkpoint_every": 1})
        cli_run("mea_tip3p", dev, path, op.sweep, n_blocks,
                ("metrics.jsonl", "checkpoint.npz", "final.npz"),
                phase="23")

        old_ref = bench.REF
        bench.REF = tmp
        try:
            gen = torch.Generator(device=dev).manual_seed(2323)
            t0 = time.perf_counter()
            mc, state, label, _ = bench._setup_nvt("mixture", bench_chains,
                                                   dev, gen)
            torch.cuda.synchronize()
        finally:
            bench.REF = old_ref
        system = mc.system
        built = config.build_system({"model": model})
        for f in dataclasses.fields(system):
            a, b = getattr(system, f.name), getattr(built, f.name)
            same = np.array_equal(a, b) if isinstance(a, np.ndarray) \
                else a == b
            if not same:
                raise AssertionError(f"bench's mixture System and the "
                                     f"config kind's differ in {f.name}")
    layout = "slabs" if mc._slab_cfg is not None else op.choose_layout(
        system.n_mol, system.atoms_per_mol, state.coords.shape[-1],
        state.sfac.shape[1], system.eps_table.shape[0])
    print(f"phase23 bench mixture ({label}): setup {time.perf_counter() - t0:.2f}"
          f" s, {system.n_atoms} atoms, A_pad {state.coords.shape[-1]}, K "
          f"{state.sfac.shape[1]}, route {mc.route}, layout {layout}, blocks "
          f"{[(t.m_start, t.M, t.a_start, t.P) for t in mc.tables]}, "
          f"System equal to the config kind's")
    if mc.route != "sweep" or len(mc.tables) != 2:
        raise AssertionError(f"mixture route {mc.route}, {len(mc.tables)} "
                             f"blocks")
    probe = _SfacProbe()
    try:
        t0 = time.perf_counter()
        state, launches = main_path("23", mc, state, ((2, True), (2, False)),
                                    2, op.sweep)
        print(f"phase23 bench mixture run_blocks: "
              f"{time.perf_counter() - t0:.2f} s")
    finally:
        probe.close()
    print(f"phase23 carried S(k) against the recompute: "
          + ", ".join(f"{e:.3e}" for e in probe.rel) + " of the chain's norm")
    if not max(probe.rel) < SFAC_REL_TOL:
        raise AssertionError(f"mixture S(k) errors {probe.rel}")
    # one sweep on the main path's arguments (the sorted, halo-filled
    # planes where the route took slabs): against sweep_plain, each
    # species-block launch timed, both together beside the plain version
    # and the bound
    C, M = state.com.shape[:2]
    u = draw_uniforms(C, M, gen, dev)
    cfg = mc._slab_cfg
    if cfg is not None:
        state_s, args = _slab_args(mc, state, u)
    else:
        state_s, args = state, _sweep_args(state, u)
    err, _, plain_ms = compare_tables("23 mixture kernel vs plain", args,
                                      mc.tables)
    for t in mc.tables:
        sweep_blocks(op.sweep, *args, [t])                       # warm
        t_ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, [t]), 3)
        print(f"phase23 species block {t.m_start}..{t.m_start + t.M} (P "
              f"{t.P}, W {t.W}): one launch {t_ms:.3f} ms")
    ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, mc.tables), 3)
    frac = _cutoff_fraction_tiled(system, state_s, mc.params.r_cut)
    near = _system_reach(system, mc.params, state_s, mc.tables, n=1)
    kw = {} if cfg is None else dict(
        lanes=[slab_lanes(system, t) for t in mc.tables],
        A_plane=cfg["A_store"])
    bound_ms, bound_by = sweep_bound(system, mc.tables, state_s, frac, near,
                                     **kw)
    print(f"phase23 one sweep of {C} chains x {M} moves (2 launches): "
          f"kernel {ms:.3f} ms, sweep_plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {frac:.5f} of pairs within the "
          f"cutoff, {' / '.join(f'{v:.4f}' for v in near)} of atoms within "
          f"a pose's reach)")

    # Verlet neighbour lists on the first nlist_chains chains (the slab
    # windows' coverage count, which shares nbr_needed, starts afresh)
    sub = dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[:nlist_chains].contiguous()
        for f in dataclasses.fields(state) if f.name != "step"})
    sub = dataclasses.replace(sub, nbr_needed=torch.zeros_like(
        sub.nbr_needed))
    runs = {}
    for width in (nlist_width, 0):
        p = dataclasses.replace(mc.params, nlist_width=width)
        mc_p = MonteCarlo(system, p, device=dev, kernel="plain",
                          generator=torch.Generator(device=dev)
                          .manual_seed(2324))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_p, m_p = mc_p.run_block(sub, 1)
        torch.cuda.synchronize()
        runs[width] = (s_p, m_p, time.perf_counter() - t0)
    (s_l, m_l, w_l), (s_d, m_d, w_d) = runs[nlist_width], runs[0]
    r_list = nlist_radius(system, dataclasses.replace(
        mc.params, nlist_width=nlist_width))
    same = (s_l.acc == s_d.acc).all(dim=1)
    pos = float((s_l.com - s_d.com)[same].abs().max())
    e_rel = float(((s_l.energy - s_d.energy).abs()
                   / s_d.energy.abs().clamp_min(1.0))[same].max())
    print(f"phase23 one sweep of {nlist_chains} chains x {M} moves on the "
          f"plain route: with lists (width {nlist_width}, needed "
          f"{int(s_l.nbr_needed.max())} within {r_list:.2f} A) "
          f"{w_l:.2f} s, dense {w_d:.2f} s (block walls, recompute "
          f"included); {int((~same).sum())} chains differ; on the others "
          f"COMs {pos:.3e} A and recomputed energies {e_rel:.3e} apart; "
          f"drift {m_l['drift_max_rel']:.2e} / {m_d['drift_max_rel']:.2e}")
    if not (float(same.float().mean()) >= MATCH_FRACTION
            and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and m_l["drift_max_rel"] <= DRIFT_TOL
            and int(s_l.nbr_needed.max()) <= nlist_width):
        raise AssertionError("the list route and the dense route disagree")
    p = dataclasses.replace(mc.params, nlist_width=2)
    mc_o = MonteCarlo(system, p, device=dev, kernel="plain")
    small = dataclasses.replace(sub, **{
        f.name: getattr(sub, f.name)[:4].contiguous()
        for f in dataclasses.fields(sub) if f.name != "step"})
    try:
        mc_o.run_block(small, 1)
    except RuntimeError as exc:
        print(f"phase23 nlist_width 2 raised as it must: {exc}")
    else:
        raise AssertionError("nlist_width 2 did not raise")
    print(f"phase23: {time.perf_counter() - t_phase:.1f} s")
    return launches, err, ms, plain_ms, bound_ms, bound_by


# ---------------- phase 24: states over a block's shared memory -------


def big_block(tag, app, st, n_steps, moves, others):
    """One run_block of a phase 24 app with its gates: drift <= DRIFT_TOL,
    the carried S(k) within SFAC_REL_TOL of the smallest chain S(k) norm
    (sfac_err_max, the largest error over chains, over that norm), the
    move acceptances `moves` in (0.05, 0.95) and the attempt acceptances
    `others` in (0, 1).  Returns (state, stats)."""
    t0 = time.perf_counter()
    st, stats = app.run_block(st, n_steps)
    torch.cuda.synchronize()
    norm = torch.linalg.vector_norm(st.sfac.flatten(1).double(), dim=1)
    s_rel = stats["sfac_err_max"] / float(norm.min().clamp_min(
        SFAC_NORM_FLOOR))
    print(f"phase24 {tag} run_block({n_steps}): "
          f"{time.perf_counter() - t0:.2f} s, S(k) err {s_rel:.3e} of the "
          f"smallest chain norm, " + ", ".join(
              f"{k} {v}" if isinstance(v, list) else f"{k} {v:.6g}"
              for k, v in stats.items()))
    bad = [k for k in moves if not 0.05 < stats[k] < 0.95]
    bad += [k for k in others if not 0.0 < stats[k] < 1.0]
    if bad or not (stats["drift_max_rel"] <= DRIFT_TOL
                   and s_rel < SFAC_REL_TOL):
        raise AssertionError(f"phase24 {tag}: a gate failed {bad}: {stats}")
    return st, stats


def _layout_line(tag, layout, shape, occ, nbytes):
    print(f"phase24 {tag}: layout {layout} ({nbytes} B of shared memory, "
          f"{occ[0]} registers, {occ[1]} B local, {occ[2]} blocks per SM; "
          f"{shape})")


def phase24_muvt(dev, chains, n_twin, cap=4096, box=50.0, n_init=1024,
                 widom_chains=64, widom_moves=512, x_held=219,
                 expect="global"):
    """(a) Capacity-4096 SPC/E muVT (50 A, 500 K, z 2.2e-4, r_cut 10,
    Ewald to 1e-3, p_exchange 0.3: x_per 1755) through MolGCMC(mega="full")
    from n_init molecules: a melt cycle and two 1-cycle blocks, one launch
    each; one launch of cap moves and x_held attempts held to sweep_plain
    on the first n_twin chains and timed (the plain version steps through
    every slot and attempt, ~4 ms each), the whole-width cycle timed with
    its bound; then one
    MonteCarlo.widom_mega(state, 64) on 4096 waters from a lattice in the
    same box (a fixed-N state on the activity instantiation) and its
    drift, a launch of its first widom_moves moves and 64 ghosts held to
    sweep_plain (a whole sweep of a liquid from a lattice flips ~2% of
    the chains' decisions by f32 rounding alone).  Returns
    ((launches, err, ms, plain_ms, bound_ms, bound_by), widom launches,
    widom err)."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t0 = time.perf_counter()
    z, px = 2.2e-4, 0.3
    kl, nk, ksq, K = big_k("muvt")
    params = _muvt_params(r_cut=BIG_EWALD["muvt"][1], kappa_L=kl, nk=nk,
                           ksq_max=ksq)
    system = spce_system(cap)
    gen = torch.Generator(device=dev).manual_seed(2401)
    g = MolGCMC(system, params, activity=z, p_exchange=px,
                dtype=torch.float32, chunk=2, mega="full", device=dev,
                generator=gen)
    x_per = max(1, int(round(cap * px / (1.0 - px))))
    apc = cap + x_per
    st = g.init(box=box, n_init=n_init, n_chains=chains)
    torch.cuda.synchronize()
    shape = (cap, 3, st.coords.shape[-1], K, 2)
    layout = op.choose_layout(*shape, use_act=True)
    _layout_line("(a) muVT", layout, shape, op.occupancy(
        *shape, True, False, layout), op.smem_bytes(*shape, True, False,
                                                     layout))
    if layout != expect:
        raise AssertionError(f"(a) took the {layout} layout")
    print(f"phase24 (a) init: {time.perf_counter() - t0:.2f} s; capacity "
          f"{cap}, box {box} A, kappa_L {kl:.3f}, nk {nk}, K {K}, x_per "
          f"{x_per} (a cycle: {cap} moves + {x_per} attempts), {n_init} "
          f"molecules at the start, {chains} chains")
    keys = ("acc_trans", "acc_rot"), ("acc_insert", "acc_delete")
    op.sweep.launches = 0
    for tag in ("(a) melt", "(a)", "(a)"):
        st, _ = big_block(tag, g, st, apc, *keys)
    launches = op.sweep.launches
    if launches != 3:
        raise AssertionError(f"(a): {launches} launches for 3 cycles")
    kv, kw = make_kvectors(nk, ksq)
    tables = sweep_tables(system, params, kv, kw, dev)
    sub = _first_chains(st, n_twin)
    consts = _exchange_consts(system, params, kv, kw, sub.box)
    row = time_variant(f"24 (a) muVT launch ({x_held} attempts)", system,
                       params, tables, sub, gen, x_held, 0, z, consts)
    consts = _exchange_consts(system, params, kv, kw, st.box)
    full = time_variant("24 (a) muVT cycle, whole width", system, params,
                        tables, st, gen, x_per, 0, z, consts, plain=False)

    # Widom on a fixed-N state over the shared limit
    mc = MonteCarlo(system, params, device=dev, generator=gen,
                    kernel="sweep")
    sw = mc.init_state(cubic_lattice(cap, box), box=box,
                       n_chains=widom_chains)
    op.sweep.launches = 0
    att0 = sw.att.clone()
    sw, out = mc.widom_mega(sw, n_per_sweep=64)
    w_launches = op.sweep.launches
    if w_launches != 1 or not bool(((sw.att - att0).sum(1) == cap).all()):
        raise AssertionError(f"widom_mega: {w_launches} launches")
    b = out["boltzmann_mean"]
    sw, m = mc.run_block(sw, 0)
    print(f"phase24 (a) widom_mega(64) on {cap} waters, {widom_chains} "
          f"chains: 1 launch, beta mu_ex {float(-torch.log(b.mean())):.4f}, "
          f"Boltzmann factors finite {bool(torch.isfinite(b).all())}, "
          f"drift after {m['drift_max_rel']:.3e}")
    if not (m["drift_max_rel"] <= DRIFT_TOL and bool(torch.isfinite(b).all())
            and float(b.mean()) > 0.0):
        raise AssertionError(f"widom_mega: {m}")
    w_consts = _exchange_consts(system, params, kv, kw, sw.box)
    w_err = time_variant(f"24 (a) widom launch ({widom_moves} moves)",
                         system, params, [dataclasses.replace(
                             t, M=widom_moves) for t in tables], sw, gen, 0,
                         64, 1.0, w_consts)[0]
    print(f"phase24 (a) total {time.perf_counter() - t0:.1f} s; the cycle "
          f"at {chains} chains {full[1]:.3f} ms (bound {full[3]:.3f} ms, "
          f"{full[4]})")
    return (launches,) + row, w_launches, w_err, full


def phase24_tmmc(dev, chains, n_twin, cap=4096, box=50.0, n_init=1024,
                 x_held=219, expect="global"):
    """(b) TMMC at (a)'s shape: TMMCMol(mega="full") from n_init
    molecules, one block of one cycle (one launch of cap moves and x_per
    two-branch attempts): the gates, every attempt deposited (the cmat
    rows sum to chains x x_per, as do the uhist counts); one launch of cap
    moves and x_held attempts held to sweep_plain on the first n_twin
    chains and timed (as in (a)), the whole-width cycle timed."""
    from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t0 = time.perf_counter()
    z, px = 2.2e-4, 0.3
    kl, nk, ksq, K = big_k("muvt")
    params = _muvt_params(r_cut=BIG_EWALD["muvt"][1], kappa_L=kl, nk=nk,
                           ksq_max=ksq)
    system = spce_system(cap)
    gen = torch.Generator(device=dev).manual_seed(2402)
    t = TMMCMol(system, params, activity=z, p_exchange=px,
                dtype=torch.float32, chunk=2, mega="full", device=dev,
                generator=gen)
    x_per = max(1, int(round(cap * px / (1.0 - px))))
    st = t.init(box, n_init, chains)
    torch.cuda.synchronize()
    shape = (cap, 3, st.coords.shape[-1], K, 2)
    layout = op.choose_layout(*shape, use_act=True, tmmc=True)
    _layout_line("(b) TMMC", layout, shape, op.occupancy(
        *shape, True, True, layout), op.smem_bytes(*shape, True, True,
                                                   layout))
    if layout != expect:
        raise AssertionError(f"(b) took the {layout} layout")
    op.sweep.launches = 0
    st, _ = big_block("(b)", t, st, cap + x_per, ("acc_trans", "acc_rot"),
                      ("acc_insert", "acc_delete"))
    launches = op.sweep.launches
    deposits, counts = float(t.cmat.sum()), float(t.uhist[:, 0].sum())
    print(f"phase24 (b) {launches} launch; cmat deposits {deposits:.1f}, "
          f"uhist counts {counts:.0f}, attempts {chains * x_per}")
    if launches != 1 or counts != chains * x_per \
            or abs(deposits - chains * x_per) > 1e-3 * chains * x_per:
        raise AssertionError("(b): the deposits do not count every attempt")
    kv, kw = make_kvectors(nk, ksq)
    tables = sweep_tables(system, params, kv, kw, dev)
    sub = _first_chains(st, n_twin)
    consts = _exchange_consts(system, params, kv, kw, sub.box)
    eta = torch.tensor(t.eta, dtype=torch.float32, device=dev)
    row = time_variant(f"24 (b) TMMC launch ({x_held} attempts)", system,
                       params, tables, sub, gen, x_held, 0, z, consts,
                       tmmc=(eta, sub.energy.float().contiguous()))
    consts = _exchange_consts(system, params, kv, kw, st.box)
    full = time_variant("24 (b) TMMC cycle, whole width", system, params,
                        tables, st, gen, x_per, 0, z, consts, plain=False,
                        tmmc=(eta, st.energy.float().contiguous()))
    print(f"phase24 (b) total {time.perf_counter() - t0:.1f} s; the cycle "
          f"at {chains} chains {full[1]:.3f} ms (bound {full[3]:.3f} ms, "
          f"{full[4]})")
    return (launches,) + row, full


def phase24_gibbs(dev, chains, n_twin, cap=1024, blocks=2,
                  expect="global"):
    """(c) bench.py's Gibbs recipe at cap 1024: SPC/E, 682 + 170
    molecules in boxes of 29.45 / 36.0 A (the vapour box scaled with the
    cap), 450 K, r_cut 7.5, Ewald to 1e-3 at the 41.64 A box a volume move
    can reach, p_transfer 0.3, p_volume 0.002, dv_max 0.03, through
    MolGibbsEnsemble(mega="full"): `blocks` blocks of one cycle (one Gibbs
    launch of 2 cap moves + x_per transfers, and the volume moves); one
    cycle held to sweep_gibbs_plain on the first n_twin chains and timed,
    the whole-width cycle timed with its bound."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        draw_uniforms,
        sweep_tables,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as op
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t0 = time.perf_counter()
    px = 0.3
    n_l, n_v = (2 * cap) // 3, cap // 6
    box_l = (n_l / 0.0267) ** (1.0 / 3.0)
    box_v = 18.0 * (cap / 128) ** (1.0 / 3.0)
    kl, nk, ksq, K = big_k("gibbs")
    params = RunParams(temperature=450.0, r_cut=min(7.5, 0.45 * box_l),
                       cutoff_mode="site", coulomb="ewald", kappa_L=kl,
                       nk=nk, ksq_max=ksq, p_translate=0.5, dr_max=0.3,
                       dphi_max=0.4, p_volume=0.002, use_lrc=False,
                       strict_min_image=False)
    system = spce_system(cap)
    gen = torch.Generator(device=dev).manual_seed(2403)
    g = MolGibbsEnsemble(system, params, dv_max=0.03, p_transfer=px,
                         dtype=torch.float32, chunk=16, mega="full",
                         device=dev, generator=gen)
    x_per = g.run_steps.x_per
    att_pc = 2 * cap + x_per
    st = g.init(boxes=(box_l, box_v), n_init=(n_l, n_v), n_chains=chains)
    torch.cuda.synchronize()
    (t,) = sweep_tables(system, params, *make_kvectors(nk, ksq), dev)
    A_off = st.coords.shape[-1]
    layout = op.choose_layout(cap, t.P, A_off, K, t.eps.shape[1], nk)
    _layout_line("(c) Gibbs", layout, (cap, t.P, A_off, K, nk),
                 op.occupancy(t, cap, A_off, K, layout),
                 op.gibbs_smem_bytes(cap, t.P, A_off, K, t.eps.shape[1], nk,
                                     layout))
    if layout != expect:
        raise AssertionError(f"(c) took the {layout} layout")
    print(f"phase24 (c) init: {time.perf_counter() - t0:.2f} s; boxes "
          f"{box_l:.2f} / {box_v:.2f} A, {n_l} + {n_v} molecules, r_cut "
          f"{params.r_cut}, kappa_L {kl:.3f}, nk {nk}, K {K}, x_per {x_per} "
          f"(a cycle: {2 * cap} moves + {x_per} transfers), {chains} "
          f"chains")
    op.sweep_gibbs.launches = 0
    for _ in range(blocks):
        st, _ = big_block("(c)", g, st, att_pc, ("acc_disp", "acc_rot"),
                          ("acc_transfer", "acc_vol"))
        if not bool((st.active.sum((1, 2)) == n_l + n_v).all()):
            raise AssertionError("(c): N not conserved")
    launches = op.sweep_gibbs.launches
    if launches != blocks:
        raise AssertionError(f"(c): {launches} launches for {blocks} cycles")
    kv, kw = make_kvectors(nk, ksq)

    def cycle_args(C):
        act, actm = activity_planes(system, st.active[:C].reshape(2 * C, cap))
        ones = torch.ones((C,), device=dev)
        args = [x[:C].float().contiguous() for x in (
            st.coords, st.com, st.quat, st.sfac, st.box)] + [
            params.temperature * ones, params.dr_max * ones,
            params.dphi_max * ones]
        rest = ([draw_uniforms(C, 2 * cap, gen, dev)], [t],
                act.reshape(C, 2, -1), actm.reshape(C, 2, cap), [x_per],
                [draw_exchange_uniforms(C, x_per, gen, dev)],
                gibbs_consts(system, params, kv, kw, args[4]), 98)
        return args, rest

    def bound(C):
        active = st.active[:C]
        frac = _gibbs_cutoff_fraction(system, st.coords[:C], active,
                                      st.box[:C], params.r_cut)
        near = [_reach_fraction(st.coords[:C, b], st.com[:C, b],
                                system.atom_mol_slot[0], st.box[:C, b],
                                max(params.r_cut, params.qq_cut),
                                active[:, b])[0] for b in range(2)]
        return gibbs_bound(t, C, A_off, cap, K, active.sum(2), frac, near,
                           x_per)

    args, rest = cycle_args(n_twin)
    held = []
    err, _ = compare_gibbs("24 (c) Gibbs cycle vs plain", args, *rest,
                           plain_ms=held)
    run_gibbs(op.sweep_gibbs, args, *rest)                         # warm
    ms = _time_ms(lambda: run_gibbs(op.sweep_gibbs, args, *rest), 3)
    b_ms, b_by = bound(n_twin)
    ms_f, bf_ms, bf_by = ms, b_ms, b_by
    if n_twin != chains:
        args_f, rest_f = cycle_args(chains)
        run_gibbs(op.sweep_gibbs, args_f, *rest_f)                 # warm
        ms_f = _time_ms(lambda: run_gibbs(op.sweep_gibbs, args_f, *rest_f),
                        3)
        bf_ms, bf_by = bound(chains)
    print(f"phase24 (c) one cycle, N per box "
          f"{float(st.active[:, 0].sum(1).float().mean()):.1f} / "
          f"{float(st.active[:, 1].sum(1).float().mean()):.1f}: {n_twin} "
          f"chains kernel {ms:.3f} ms, sweep_gibbs_plain {held[0]:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}); {chains} chains kernel "
          f"{ms_f:.3f} ms, bound {bf_ms:.3f} ms ({bf_by}); total "
          f"{time.perf_counter() - t0:.1f} s")
    return (launches, err, ms, held[0], b_ms, b_by), (None, ms_f, None,
                                                      bf_ms, bf_by)


def phase24_semigrand(dev, chains, n_twin, cap=1024, box=50.4, blocks=2,
                      expect="global"):
    """(d) bench.py's semigrand recipe at 16x the volume: identical SPC/E
    blocks cap 1024 + 1024 with 512 + 512 molecules in 50.4 A, 600 K,
    r_cut 8, Ewald to 1e-3, xi 2, p_flip 0.3, through
    Semigrand(mega="full"): `blocks` blocks of one cycle (two sweep
    launches of 1024 moves, on the sweep kernel's activity instantiation,
    and one flip launch of x_per flips); one flip launch held to
    flip_plain on the first n_twin chains and timed, the whole-width launch
    timed with its bound.  Returns (flip row, whole width, sweep
    launches)."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        activity_planes,
        draw_exchange_uniforms,
        make_mega_flip_fn,
    )
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as op
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sw
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    t0 = time.perf_counter()
    px, xi = 0.3, 2.0
    kl, nk, ksq, K = big_k("semigrand")
    params = _semigrand_water(r_cut=BIG_EWALD["semigrand"][1], kappa_L=kl,
                              nk=nk, ksq_max=ksq)
    system = spce_two_blocks(cap, cap)
    gen = torch.Generator(device=dev).manual_seed(2404)
    g = Semigrand(system, params, fugacity_ratio=xi, p_flip=px,
                  dtype=torch.float32, chunk=8, mega="full", device=dev,
                  generator=gen)
    x_per = g.run_steps.x_per
    apc = 2 * cap + x_per
    st = g.init(box=box, n_a=cap // 2, n_b=cap // 2, n_chains=chains)
    torch.cuda.synchronize()
    kv, kw = make_kvectors(nk, ksq)
    tables = make_mega_flip_fn(system, params, kv, kw, dev, xi).tables
    A_pad = st.coords.shape[-1]
    T = tables.a.eps.shape[1]
    layout = op.choose_layout(2 * cap, 3, 3, A_pad, K, T, nk)
    _layout_line("(d) semigrand flips", layout, (2 * cap, A_pad, K, nk),
                 op.occupancy(tables, 2 * cap, A_pad, K, layout),
                 op.flip_smem_bytes(2 * cap, 3, 3, A_pad, K, T, nk, layout))
    if layout != expect:
        raise AssertionError(f"(d) took the {layout} layout")
    sweep_layout = sw.choose_layout(2 * cap, 3, A_pad, K, T, use_act=True)
    if sweep_layout != expect:
        raise AssertionError(f"(d): the sweeps took the {sweep_layout} "
                             f"layout")
    print(f"phase24 (d) init: {time.perf_counter() - t0:.2f} s; caps {cap} "
          f"+ {cap}, box {box} A, kappa_L {kl:.3f}, nk {nk}, K {K}, A_pad "
          f"{A_pad}, x_per {x_per} (a cycle: {2 * cap} moves + {x_per} "
          f"flips), {chains} chains; the sweeps take the {sweep_layout} "
          f"layout")
    op.flip.launches = 0
    sw.sweep.launches = 0
    for _ in range(blocks):
        st, _ = big_block("(d)", g, st, apc, ("acc_trans", "acc_rot"),
                          ("acc_flip_ab", "acc_flip_ba"))
        if not bool((st.active.sum(1) == cap).all()):
            raise AssertionError("(d): N_tot not conserved")
    launches, sweeps = op.flip.launches, sw.sweep.launches
    if launches != blocks or sweeps != 2 * blocks:
        raise AssertionError(f"(d): {launches} flip and {sweeps} sweep "
                             f"launches for {blocks} cycles")

    def launch_args(C):
        act, actm = activity_planes(system, st.active[:C])
        ones = torch.ones((C,), device=dev)
        args = [x[:C].float().contiguous() for x in (
            st.coords, st.com, st.quat, st.sfac, st.box)] + [
            params.temperature * ones, act, actm]
        si2 = torch.stack([make_pose_eval(system, params, kv, kw, dev,
                                          torch.float32, species=s)
                           .self_intra(args[4]) for s in (0, 1)], 1)
        return args, si2.contiguous(), draw_exchange_uniforms(C, x_per,
                                                              gen, dev)

    def bound(C):
        sub = _first_chains(st, C)
        frac = _active_cutoff_fraction(sub, 3, params.r_cut)
        near = _reach_fraction(sub.coords, sub.com, system.atom_mol_slot[0],
                               sub.box, max(params.r_cut, params.qq_cut),
                               sub.active, n=8)[0]
        return flip_bound(tables, C, A_pad, 2 * cap, K, sub.active.sum(1),
                          frac, near, x_per)

    args, si2, ux = launch_args(n_twin)
    held = []
    err, _, _ = compare_flip("24 (d) flips vs plain", args, ux, tables, si2,
                             None, seed=99, plain_ms=held)
    ms = _time_ms(lambda: op.flip(*args, ux, tables, si2, None, seed=99), 3)
    b_ms, b_by = bound(n_twin)
    args_f, si2_f, ux_f = launch_args(chains)
    op.flip(*args_f, ux_f, tables, si2_f, None, seed=99)           # warm
    ms_f = _time_ms(lambda: op.flip(*args_f, ux_f, tables, si2_f, None,
                                    seed=99), 3)
    bf_ms, bf_by = bound(chains)
    print(f"phase24 (d) one flip launch of {x_per} flips: {n_twin} chains "
          f"kernel {ms:.3f} ms, flip_plain {held[0]:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}); {chains} chains kernel {ms_f:.3f} ms, "
          f"bound {bf_ms:.3f} ms ({bf_by}); total "
          f"{time.perf_counter() - t0:.1f} s")
    return (launches, err, ms, held[0], b_ms, b_by), (None, ms_f, None,
                                                      bf_ms, bf_by), sweeps


def phase24_bulk(dev, chains, n_mol=6859, box=59.056, twin_moves=512,
                 expect="global_k", **params_kw):
    """(e) phase 11's 6859 SPC/E waters at tol 1e-5 (Ewald to 1e-5 at
    r_cut 10: kappa L 20.04, nk 22, K 22,994), slabs on, through
    MonteCarlo with recompute_chunk 2 (the reciprocal virial's (A, K)
    grids take ~15 GB per chain): init_state, one block of one sweep (one
    launch on the global_k layout) with the drift gate, the carried S(k)
    against the recompute, acceptance in (0.05, 0.95); the kernel held to
    sweep_plain over the first twin_moves molecules of every chain, both
    timed with their bound; the whole sweep timed with its bound."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    t0 = time.perf_counter()
    kl, nk, ksq, K = big_k("bulk")
    system = spce_system(n_mol)
    params = RunParams(temperature=298.15, r_cut=BIG_EWALD["bulk"][1],
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3,
                       **params_kw)
    gen = torch.Generator(device=dev).manual_seed(2405)
    mc = MonteCarlo(system, params, device=dev, generator=gen,
                    recompute_chunk=2)
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    cfg = mc._slab_cfg
    if cfg is None:
        raise AssertionError("(e): the route did not take slabs")
    shape = (n_mol, 3, cfg["A_store"], K, system.eps_table.shape[0])
    layout = op.choose_layout(*shape, slab=True)
    _layout_line("(e) bulk water", layout, shape, op.occupancy(
        *shape, False, False, layout), op.smem_bytes(*shape, False, False,
                                                     layout))
    if layout != expect:
        raise AssertionError(f"(e) took the {layout} layout")
    print(f"phase24 (e) init_state: {time.perf_counter() - t0:.2f} s; "
          f"kappa_L {kl:.3f}, nk {nk}, K {K}, W {cfg['W']} of A_blk "
          f"{cfg['A_blk']}, A_store {cfg['A_store']}, {chains} chains")
    probe = _SfacProbe()
    try:
        state, launches = main_path("24 (e)", mc, state, ((1, False),), 1,
                                    op.sweep)
    finally:
        probe.close()
    print(f"phase24 (e) carried S(k) against the recompute: "
          f"{probe.rel[-1]:.3e} of the chain's norm")
    if not probe.rel[-1] < SFAC_REL_TOL:
        raise AssertionError(f"(e): S(k) error {probe.rel}")
    u = draw_uniforms(chains, n_mol, gen, dev)
    state_s, args = _slab_args(mc, state, u)
    part = [dataclasses.replace(t, M=twin_moves) for t in mc.tables]
    err, _, plain_ms = compare_tables("24 (e) kernel vs plain", args, part)
    sweep_blocks(op.sweep, *args, part)                            # warm
    ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, part), 3)
    ms_f = _time_ms(lambda: sweep_blocks(op.sweep, *args, mc.tables), 1)
    frac = _cutoff_fraction_tiled(system, state_s, params.r_cut)
    near = _system_reach(system, params, state_s, mc.tables, n=1)
    b_ms, b_by = sweep_bound(system, part, state_s, frac, near, lanes=[
        slab_lanes(system, t) for t in part], A_plane=cfg["A_store"])
    bf_ms, bf_by = sweep_bound(system, mc.tables, state_s, frac, near,
                               lanes=[slab_lanes(system, t)
                                      for t in mc.tables],
                               A_plane=cfg["A_store"])
    print(f"phase24 (e) {twin_moves} moves x {chains} chains: kernel "
          f"{ms:.3f} ms, sweep_plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}); one sweep of {n_mol} moves {ms_f:.3f} ms, bound "
          f"{bf_ms:.3f} ms ({bf_by}); total "
          f"{time.perf_counter() - t0:.1f} s")
    return (launches, err, ms, plain_ms, b_ms, b_by), (None, ms_f, None,
                                                       bf_ms, bf_by)


def phase24(dev, chains=256, n_twin=128, bulk_chains=64):
    """Phase 24: full-width states that fit no shared layout, each through
    its driver's normal entry point with mega="full" (module docstring).
    Returns {row: (launches, err, ms, plain_ms, bound_ms, bound_by)} for
    the kernels line, the launch counts taken on the main path with the
    counters set to 0 just before it.  The held launches run on n_twin
    chains: f32 rounding alone flips a decision of ~1 in 64 TMMC chains
    over a launch, and on 128 the 98% gate leaves room for two."""
    t0 = time.perf_counter()
    rows = {}
    (rows["use_act global"], w_launches, w_err,
     _) = phase24_muvt(dev, chains, n_twin)
    rows["tmmc global"], _ = phase24_tmmc(dev, chains, n_twin)
    rows["gibbs global"], _ = phase24_gibbs(dev, chains, n_twin)
    rows["flip global"], _, sweeps = phase24_semigrand(dev, chains, n_twin)
    rows["k rows global"], _ = phase24_bulk(dev, bulk_chains)
    row = rows["use_act global"]
    rows["use_act global"] = (row[0] + w_launches + sweeps,
                              max(row[1], w_err)) + row[2:]
    print(f"phase24 total {time.perf_counter() - t0:.1f} s")
    return rows


# phase 25: the parallel layer.  (a) the flagship split over two gloo
# ranks on the card, (b) the kernels' chain offset in one process, (c) the
# tensor-parallel recompute on a 2 x 2 gloo mesh, (d) a world of one NCCL
# rank.  The ranks are fresh processes (parallel/mesh.py run_world) that
# find the kernels phase 1 built; each checks its own gates and raises.
FLAGSHIP_SEED = 2525
REMC_SEED = 2526
REMC_LADDER = (250.0, 400.0)
TP_REL_TOL = 1e-5          # the TP recompute against the unsharded one, f32
OFFSET_KINDS = ("sweep", "gibbs", "flip")


FLAGSHIP = (750, 28.24, 10.0)   # waters, box (A), r_cut (A)


def flagship_mc(dev, shape=FLAGSHIP, tp_mesh=None, recompute_chunk="auto"):
    """Phase 3's flagship MonteCarlo (SPC/E, Ewald, the whole-sweep route)
    at shape = (waters, box, r_cut), its generator seeded
    FLAGSHIP_SEED."""
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    params = RunParams(temperature=298.15, r_cut=shape[2], coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(FLAGSHIP_SEED)
    return MonteCarlo(spce_system(shape[0]), params, device=dev,
                      generator=gen, kernel="sweep", tp_mesh=tp_mesh,
                      recompute_chunk=recompute_chunk)


def flagship_init(mc, n_chains, shape=FLAGSHIP):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice

    return mc.init_state(cubic_lattice(shape[0], shape[1]), box=shape[1],
                         n_chains=n_chains)


def _rank_device(device):
    return torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)


def _state_differences(tag, out, ref, fields):
    """Elements of each field that differ between two states, printed;
    returns their sum."""
    bad = {f: int((getattr(out, f) != getattr(ref, f)).sum()) for f in fields}
    print(f"phase25 {tag}: differing elements " + ", ".join(
        f"{f} {n}" for f, n in bad.items()), flush=True)
    return sum(bad.values())


def _rank_line(rank, text):
    print(f"phase25 rank {rank}: {text}", flush=True)


def phase25_sharded_rank(rank, chains, steps, device="cuda",
                         shape=FLAGSHIP):
    """(a) and (d): this rank's shard of `chains` flagship chains, a
    sharded init (each rank draws its rows of the chain-global
    orientations), sharded_run_steps of `steps` sweeps, then REMC every
    sweep over the ladder for 2 rounds; rank 0 then runs the unsharded
    MonteCarlo from the same seed (init_state, run_steps, run_steps(1) +
    exchange with phases 0 and 1) and counts the elements that differ;
    last, every rank checks its sweep kernel launches.  Returns rank 0's
    numbers."""
    import torch.distributed as dist

    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.parallel import mesh as pm
    from metropolismontecarlo_tpu_torch.parallel.remc import (
        exchange_shardlocal,
        temperature_ladder,
    )
    from metropolismontecarlo_tpu_torch.utils.shard import shard_context

    dev = _rank_device(device)
    mesh = pm.make_mesh(device=dev.type, backend=dist.get_backend())
    n = dist.get_world_size()
    L = chains // n
    mc = flagship_mc(dev, shape)
    t0 = time.perf_counter()
    with shard_context(rank * L, chains):
        local = flagship_init(mc, L, shape)
    _sync(dev)
    t_init = time.perf_counter() - t0
    init = pm.gather_state(local, mesh)
    op.sweep.launches = 0
    t0 = time.perf_counter()
    local = pm.sharded_run_steps(mc, local, mesh, steps)
    _sync(dev)
    t_sweep = (time.perf_counter() - t0) / steps
    nvt = pm.gather_state(local, mesh)
    ladder = temperature_ladder(*REMC_LADDER, chains, device=dev)
    local = dataclasses.replace(local, temp=ladder[rank * L:(rank + 1) * L])
    gen = torch.Generator(device=dev).manual_seed(REMC_SEED)
    t0 = time.perf_counter()
    local, fracs = pm.sharded_run_steps(mc, local, mesh, 2, remc_every=1,
                                        remc_generator=gen)
    _sync(dev)
    t_remc = time.perf_counter() - t0
    launches = op.sweep.launches
    # one exchange round alone, on a throwaway generator
    t0 = time.perf_counter()
    exchange_shardlocal(local, torch.Generator(device=dev).manual_seed(1), 0,
                        mesh)
    _sync(dev)
    t_round = time.perf_counter() - t0
    remc = pm.gather_state(local, mesh)
    mean_e = float(pm.pooled_mean(local.energy, mesh))
    _rank_line(rank, f"{dist.get_backend()} world of {n}, {L} of {chains} "
               f"chains: sharded init {t_init:.2f} s, {steps} sweeps "
               f"{t_sweep * 1e3:.3f} ms per sweep ({launches} sweep kernel "
               f"launches), 2 REMC rounds with their sweeps {t_remc:.3f} s, "
               f"one exchange round {t_round * 1e3:.3f} ms, swap fractions "
               f"{fracs.tolist()}, pooled mean energy {mean_e:.6g}")
    out = None
    if rank == 0:
        out = _phase25_unsharded(dev, shape, chains, steps, init, nvt, remc,
                                 fracs, ladder)
        out.update(sweep_ms=t_sweep * 1e3, round_ms=t_round * 1e3)
    if launches != steps + 2:
        raise AssertionError(f"rank {rank}: {launches} sweep kernel launches "
                             f"for {steps + 2} sweeps")
    return out


def _phase25_unsharded(dev, shape, chains, steps, init, nvt, remc, fracs,
                       ladder):
    """(a)'s reference in rank 0: the unsharded MonteCarlo from the same
    seed; raises unless every compared element is equal."""
    from metropolismontecarlo_tpu_torch.parallel.remc import exchange

    ref_mc = flagship_mc(dev, shape)
    t0 = time.perf_counter()
    ref = flagship_init(ref_mc, chains, shape)
    _sync(dev)
    t_ref_init = time.perf_counter() - t0
    bad = _state_differences("init", init, ref,
                             ("quat", "coords", "sfac", "energy"))
    t0 = time.perf_counter()
    ref = ref_mc.run_steps(ref, steps)
    _sync(dev)
    t_ref_sweep = (time.perf_counter() - t0) / steps
    fields = ("coords", "com", "quat", "sfac", "energy", "acc", "att")
    bad += _state_differences(f"{steps} sweeps", nvt, ref, fields)
    ref = dataclasses.replace(ref, temp=ladder)
    gen = torch.Generator(device=dev).manual_seed(REMC_SEED)
    ref_fracs = []
    t0 = time.perf_counter()
    for phase in (0, 1):
        ref = ref_mc.run_steps(ref, 1)
        ref, frac = exchange(ref, gen, phase)
        ref_fracs.append(frac)
    _sync(dev)
    t_ref_remc = time.perf_counter() - t0
    bad += _state_differences("REMC", remc, ref, fields + ("temp",))
    ref_fracs = torch.stack(ref_fracs)
    _rank_line(0, f"unsharded {chains} chains: init {t_ref_init:.2f} s, "
               f"{t_ref_sweep * 1e3:.3f} ms per sweep, 2 REMC rounds with "
               f"their sweeps {t_ref_remc:.3f} s, swap fractions "
               f"{ref_fracs.tolist()}")
    if bad or not torch.equal(fracs, ref_fracs) \
            or not bool(((fracs > 0.0) & (fracs < 1.0)).all()):
        raise AssertionError("the sharded run is not the unsharded one, or "
                             "the swap fraction does not lie in (0, 1)")
    return dict(ref_sweep_ms=t_ref_sweep * 1e3, fracs=fracs.tolist())


def phase25_tp_rank(rank, n_chain_shards, n_atom_shards, chains, chunk,
                    device="cuda", shape=FLAGSHIP):
    """(c) and (d): the flagship's tensor-parallel recompute on a
    (chains x atoms) mesh against the unsharded recompute, then
    MonteCarlo(tp_mesh=...).run_block(1) with the drift gate; last, the
    sweep kernel's launch."""
    import torch.distributed as dist

    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.parallel import mesh as pm
    from metropolismontecarlo_tpu_torch.parallel.tp import make_mesh_2d

    dev = _rank_device(device)
    mesh = make_mesh_2d(n_chain_shards, n_atom_shards, device=dev.type,
                        backend=dist.get_backend())
    L = chains // n_chain_shards
    mc = flagship_mc(dev, shape, tp_mesh=mesh, recompute_chunk=chunk)
    local = flagship_init(mc, L, shape)
    t0 = time.perf_counter()
    e, _, _ = mc.full_energy(local)
    _sync(dev)
    t_tp = time.perf_counter() - t0
    e_tp = pm.gather_state(dataclasses.replace(local, energy=e), mesh)
    op.sweep.launches = 0
    t0 = time.perf_counter()
    _, m = mc.run_block(local, 1)
    _sync(dev)
    t_block = time.perf_counter() - t0
    launches = op.sweep.launches
    _rank_line(rank, f"{dist.get_backend()} {n_chain_shards} x "
               f"{n_atom_shards} mesh, {L} of {chains} chains: TP recompute "
               f"{t_tp:.3f} s (chunk {chunk}), run_block(1) {t_block:.3f} s "
               f"({launches} sweep kernel launch), drift "
               f"{m['drift_max_rel']:.3e}")
    if not m["drift_max_rel"] <= DRIFT_TOL:
        raise AssertionError(f"rank {rank}: drift {m['drift_max_rel']}")
    out = None
    if rank == 0:
        out = _phase25_tp_reference(dev, shape, chains, e_tp)
        out.update(tp_s=t_tp, drift=m["drift_max_rel"])
    if launches != 1:
        raise AssertionError(f"rank {rank}: {launches} sweep kernel launches "
                             f"for one sweep")
    return out


def _phase25_tp_reference(dev, shape, chains, e_tp):
    """(c)'s reference in rank 0: the unsharded recompute of the same
    states (the same orientations: chain-global draws) on the plain dense
    route, whose arithmetic the TP route's row tiles share (the recompute
    kernel's sums round otherwise: phase 28)."""
    ref_mc = flagship_mc(dev, shape)
    ref = flagship_init(ref_mc, chains, shape)
    ref_mc._recompute_tables = None
    t0 = time.perf_counter()
    e_ref, _, _ = ref_mc.full_energy(ref)
    _sync(dev)
    t_ref = time.perf_counter() - t0
    rel = float(((e_tp.energy - e_ref).abs()
                 / e_ref.abs().clamp_min(1.0)).max())
    same_quat = torch.equal(e_tp.quat, ref.quat)
    _rank_line(0, f"unsharded recompute of {chains} chains {t_ref:.3f} s "
               f"(chunk {ref_mc.recompute_chunk}, dense); TP energies rel "
               f"err {rel:.3e} (gate {TP_REL_TOL}), orientations equal "
               f"{same_quat}")
    if not (rel < TP_REL_TOL and same_quat):
        raise AssertionError("the TP recompute disagrees with the unsharded "
                             "one")
    return dict(ref_s=t_ref, rel=rel)


def phase25_nccl_rank(rank, chains, steps, tp_chains, chunk, device="cuda",
                      shape=FLAGSHIP):
    """(d): (a)'s calls and one TP recompute in a world of one NCCL rank."""
    return (phase25_sharded_rank(rank, chains, steps, device, shape),
            phase25_tp_rank(rank, 1, 1, tp_chains, chunk, device, shape))


def _rows(x, sl):
    """The rows `sl` of x (a tensor, or a list or tuple of them; None
    stays None)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_rows(v, sl) for v in x)
    return x[sl].contiguous()


def offset_case(dev, kind, chains=64):
    """(b)'s inputs at phase 2's shapes for one Philox-scored op: "sweep"
    (SPC/E-64 Ewald with 8 exchange attempts), "gibbs" (SPC/E cap 32 x 2,
    24 transfers), "flip" (SPC/E 32 + 32, 24 flips).  Returns (call,
    compare): call(rows, chain0, plain=False) runs the op (its plain
    version with plain) on those rows of every per-chain input with the
    scores keyed from chain0, compare(rows, chain0, tag) holds the kernel
    to its plain version there as phase 2 does."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_exchange_uniforms
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_system,
        spce_two_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as fop
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    if kind == "sweep":
        box_w, _, water, _ = _variant_params()
        system = spce_system(64)
        mc, _, args, act, actm, uxs, z, consts = _variant_inputs(
            dev, 2501, "n_exch spce64 ewald", system, box_w, water(), (8,),
            (0,), C=chains)
        ins = (args, act, actm, uxs, z, consts)

        def call(sl, chain0, plain=False):
            a, ac, am, ux, zz, cs = _rows(ins, sl)
            return run_variant(op.sweep_plain if plain else op.sweep, a,
                               mc.tables, ac, am, (8,), (0,), ux, zz, cs,
                               77, chain0=chain0)

        def compare(sl, chain0, tag):
            a, ac, am, ux, zz, cs = _rows(ins, sl)
            return compare_variant(tag, system, a, mc.tables, ac, am, (8,),
                                   (0,), ux, zz, cs, 77, chain0=chain0)
    elif kind == "gibbs":
        args, us, tables, act, actm, n_exchs, uxs, consts = _gibbs_case(
            dev, spce_system(32), RunParams(**gibbs_water()), (10.5, 14.0),
            chains, 2502, 24)
        ins = (args, us, act, actm, uxs, consts)

        def call(sl, chain0, plain=False):
            a, u, ac, am, ux, cs = _rows(ins, sl)
            return run_gibbs(gop.sweep_gibbs_plain if plain
                             else gop.sweep_gibbs, a, u, tables, ac, am,
                             n_exchs, ux, cs, 91, chain0=chain0)

        def compare(sl, chain0, tag):
            a, u, ac, am, ux, cs = _rows(ins, sl)
            return compare_gibbs(tag, a, u, tables, ac, am, n_exchs, ux, cs,
                                 91, max_differing=GIBBS_MAX_DIFFERING,
                                 chain0=chain0)[0]
    else:
        gen = torch.Generator(device=dev).manual_seed(2503)
        n_act = np.random.default_rng(2503).integers(0, 33, (chains, 2))
        args, tables, si2, lrc3 = flip_inputs(
            spce_two_blocks(32, 32), _semigrand_water(), 20.0, 2.0,
            torch.tensor(n_act), gen, dev)
        ins = (args, draw_exchange_uniforms(chains, 24, gen, dev), si2, lrc3)

        def call(sl, chain0, plain=False):
            a, ux, s2, l3 = _rows(ins, sl)
            return (fop.flip_plain if plain else fop.flip)(
                *a, ux, tables, s2, l3, seed=71, chain0=chain0)

        def compare(sl, chain0, tag):
            a, ux, s2, l3 = _rows(ins, sl)
            return compare_flip(tag, a, ux, tables, s2, l3, 71,
                                max_differing=FLIP_MAX_DIFFERING,
                                chain0=chain0)[0]
    return call, compare


def phase25_offsets(dev, chains=64):
    """(b) For the sweep kernel with exchange attempts, the Gibbs kernel
    and the flip kernel: a launch on rows [c0, c0 + L) with chain0 = c0
    equals those rows of the whole launch bit for bit, the same launch
    with chain0 = 0 differs, and the offset launch holds to its plain
    version with the same offset.  Returns the largest error of the three
    comparisons."""
    c0 = L = chains // 2
    rows = slice(c0, c0 + L)
    err = 0.0
    for kind in OFFSET_KINDS:
        call, compare = offset_case(dev, kind, chains)
        full = call(slice(0, chains), 0)
        part = call(rows, c0)
        unkeyed = call(rows, 0)
        _sync(dev)
        n_diff = sum(int((f[rows] != p).sum()) for f, p in zip(full, part))
        n_live = sum(int((u != p).sum()) for u, p in zip(unkeyed, part))
        print(f"phase25 (b) {kind}: rows {c0}:{c0 + L} with chain0 {c0} "
              f"against those rows of the whole launch: {n_diff} differing "
              f"elements; with chain0 0: {n_live} differing elements")
        if n_diff or not n_live:
            raise AssertionError(f"(b) {kind}: the chain offset is not the "
                                 f"rows' global index")
        err = max(err, compare(rows, c0, f"25b {kind} rows {c0}:{c0 + L} "
                                         f"chain0 {c0} vs plain"))
    return err


# (e): the ensemble drivers chain-sharded at PERF.md section 4's shapes
ENSEMBLE_SEED = 2527
ENSEMBLE_CASES = ("muvt full", "muvt hybrid", "tmmc full", "gibbs full",
                  "semigrand full", "binary full")
# the kernels each case launches (ops/cuda wrapper names)
ENSEMBLE_KERNELS = {"muvt full": ("sweep",), "muvt hybrid": ("sweep",),
                    "tmmc full": ("sweep",), "gibbs full": ("sweep_gibbs",),
                    "semigrand full": ("sweep", "flip"),
                    "binary full": ("sweep",)}


def ensemble_case(name, dev, n_chains, n_global, chunk, shard, call):
    """(e)'s case `name`: a fresh ensemble on n_chains of n_global chains
    at its shape, its generator seeded ENSEMBLE_SEED, the init inside shard()
    and the run through call(fn, state, *args); muVT and TMMC at phase
    6's SPC/E cap 512 (25 A, 500 K, z 2.2e-4; "full" 2 cycles, the hybrid
    1), TMMC from per-chain starts 1..448 with a linear bias, bench's
    Gibbs (cap 128 x 2, K 783, p_volume 0.002: one volume move per
    cycle), its semigrand (64 + 64, 20 A, 600 K) and phase 17's CO2/N2
    muVT, 2 cycles each.  Returns (rows: every state field and TMMC's
    cmat / uhist, cycles, seconds of the run after a synchronize)."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_system,
        spce_two_blocks,
    )

    gen = torch.Generator(device=dev).manual_seed(ENSEMBLE_SEED)
    f32, extra = torch.float32, ()
    if name in ("muvt full", "muvt hybrid", "tmmc full"):
        cap, px = 512, 0.3
        x_per = max(1, int(round(cap * px / (1.0 - px))))
        if name == "tmmc full":
            t = TMMCMol(spce_system(cap), _muvt_params(), activity=2.2e-4,
                        p_exchange=px, dtype=f32, chunk=chunk, mega="full",
                        device=dev, generator=gen)
            init, run = t.init, t._run_steps
            # per-chain starts of the global length: init takes its rows
            n_init = np.linspace(1, 7 * cap // 8, n_global).astype(int)
            extra = (np.linspace(0.0, 2.0, cap + 1),)
        else:
            g = MolGCMC(spce_system(cap), _muvt_params(), activity=2.2e-4,
                        p_exchange=px, dtype=f32, chunk=chunk,
                        mega=True if name == "muvt hybrid" else "full",
                        device=dev, generator=gen)
            init, run, n_init = g.init, g.run_steps, 256
        cycles = 1 if name == "muvt hybrid" else 2
        steps = cycles * (cap + x_per)
        init_args = (25.0, n_init, n_chains)
    elif name == "gibbs full":
        params, boxes, n0 = _gibbs_flagship(p_volume=0.002)
        g = MolGibbsEnsemble(spce_system(128), params, dv_max=0.03,
                             p_transfer=0.3, dtype=f32, chunk=chunk,
                             mega="full", device=dev, generator=gen)
        init, run, cycles = g.init, g.run_steps, 2
        steps, init_args = cycles * (256 + g.run_steps.x_per), \
            (boxes, n0, n_chains)
    elif name == "semigrand full":
        g = Semigrand(spce_two_blocks(64, 64), _semigrand_water(),
                      fugacity_ratio=2.0, p_flip=0.3, dtype=f32, chunk=chunk,
                      mega="full", device=dev, generator=gen)
        init, run, cycles = g.init, g.run_steps, 2
        steps = cycles * (128 + g.run_steps.x_per)
        init_args = (20.0, 32, 32, n_chains)
    else:
        params = RunParams(temperature=300.0, r_cut=10.0, cutoff_mode="site",
                           coulomb="ewald", use_lrc=False, p_translate=0.5,
                           dr_max=1.5, dphi_max=1.0)
        g = BinaryGCMC(co2_n2_system(96, 96), params, activities=(5e-4, 8e-4),
                       p_exchange=0.4, dtype=f32, chunk=chunk, mega="full",
                       device=dev, generator=gen)
        init, run, cycles = g.init, g.run_steps, 2
        steps, init_args = cycles * (192 + g.run_steps.x_per), \
            (26.0, (12, 14), n_chains)
    with shard():
        st = init(*init_args)
    _sync(dev)
    t0 = time.perf_counter()
    out = call(run, st, *extra, steps)
    _sync(dev)
    secs = time.perf_counter() - t0
    st, tm = (out[0], dict(cmat=out[1], uhist=out[2])) \
        if isinstance(out, tuple) else (out, {})
    rows = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    rows.update(tm)
    return rows, cycles, secs


def _record_chain0():
    """Wrap the three Philox-scored wrappers (ops/cuda sweep, sweep_gibbs,
    flip) in this process so that every call records its chain0.  Each
    module's launcher counts its launches on the module's name, so the
    counter (.launches) moves to the wrapper.  Returns (seen: wrapper
    name -> set of chain0 values, wrappers: name -> the wrapper)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as fop
    from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    seen, wrappers = {}, {}
    for mod, name in ((op, "sweep"), (gop, "sweep_gibbs"), (fop, "flip")):
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            if "chain0" in kw:
                seen.setdefault(_name, set()).add(int(kw["chain0"]))
            return _fn(*args, **kw)

        wrapped.launches = fn.launches
        setattr(mod, name, wrapped)
        wrappers[name] = wrapped
    return seen, wrappers


def _rows_differences(tag, out, ref):
    """_state_differences for dicts of per-chain rows."""
    bad = {k: int((out[k] != v).sum()) if out[k].shape == v.shape
           else v.numel() for k, v in ref.items()}
    print(f"phase25 {tag}: differing elements " + ", ".join(
        f"{k} {n}" for k, n in bad.items()), flush=True)
    return sum(bad.values())


def phase25_ensembles_rank(rank, chains, chunk, device="cuda",
                           cases=ENSEMBLE_CASES):
    """(e): this rank's shard of `chains` chains of every ensemble case
    (the init under pm.chain_shard, the run through pm.sharded_call), the
    chain0 of every Philox-scored wrapper call recorded; one chain-global
    draw timed against the plain draw of the rank's rows; rank 0 then runs
    each case unsharded from the same seed and counts each field's
    differing elements.  Last, every rank checks that each case launched
    its kernels, with chain0 = its first chain.  Returns the rank's ms
    per cycle (rank 0: also the unsharded ones)."""
    import torch.distributed as dist

    from metropolismontecarlo_tpu_torch.parallel import mesh as pm
    from metropolismontecarlo_tpu_torch.utils.shard import rand_chains

    dev = _rank_device(device)
    mesh = pm.make_mesh(device=dev.type, backend=dist.get_backend())
    L = chains // dist.get_world_size()
    seen, counters = _record_chain0()
    rank_ms, gathered, faults = {}, {}, []
    for name in cases:
        seen.clear()
        before = {k: f.launches for k, f in counters.items()}
        rows, cycles, secs = ensemble_case(
            name, dev, L, chains, chunk, lambda: pm.chain_shard(mesh, L),
            lambda fn, st, *args: pm.sharded_call(fn, st, mesh, *args))
        launches = {k: counters[k].launches - before[k]
                    for k in ENSEMBLE_KERNELS[name]}
        rank_ms[name] = secs / cycles * 1e3
        gathered[name] = {k: pm.gather_chains(v, mesh)
                          for k, v in rows.items()}
        c0s = sorted(set().union(*seen.values())) if seen else []
        _rank_line(rank, f"(e) {name}: {L} of {chains} chains, "
                   f"{rank_ms[name]:.3f} ms per cycle over {cycles} "
                   f"cycle(s), launches {launches}, chain0 {c0s}")
        if any(n < cycles for n in launches.values()):
            faults.append(f"{name}: launches {launches} for {cycles} cycles")
        if c0s != ([] if name == "muvt hybrid" else [rank * L]):
            faults.append(f"{name}: chain0 {c0s}, not [{rank * L}]")
    # the draws' cost: the chain-global (chains, 4) draw keeps L rows
    gen = torch.Generator(device=dev).manual_seed(1)
    draw = {}
    for tag, ctx in (("plain", contextlib.nullcontext),
                     ("chain-global", lambda: pm.chain_shard(mesh, L))):
        with ctx():
            rand_chains((L, 4), gen, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(200):
                rand_chains((L, 4), gen, device=dev)
            _sync(dev)
        draw[tag] = (time.perf_counter() - t0) / 200 * 1e6
    _rank_line(rank, f"(e) one ({L}, 4) uniform draw: {draw['plain']:.2f} "
               f"us plain, {draw['chain-global']:.2f} us chain-global "
               f"({chains} rows drawn)")
    out = dict(rank_ms=rank_ms, draw_us=draw)
    if rank == 0:
        out["ref_ms"] = _phase25_ensembles_unsharded(dev, chains, chunk,
                                                     gathered, cases)
    dist.barrier()          # the launch gates after the comparisons print
    if faults:
        raise AssertionError(f"rank {rank}: " + "; ".join(faults))
    return out


def _phase25_ensembles_unsharded(dev, chains, chunk, gathered, cases):
    """(e)'s reference in rank 0: each case unsharded from the same seed;
    raises unless every compared element is equal.  Returns its ms per
    cycle."""
    ref_ms, bad = {}, 0
    for name in cases:
        rows, cycles, secs = ensemble_case(
            name, dev, chains, chains, chunk, contextlib.nullcontext,
            lambda fn, st, *args: fn(st, *args))
        ref_ms[name] = secs / cycles * 1e3
        bad += _rows_differences(f"(e) {name}", gathered[name], rows)
        _rank_line(0, f"(e) {name} unsharded, {chains} chains: "
                   f"{ref_ms[name]:.3f} ms per cycle")
        if name == "gibbs full":
            n_vol = rows["att"][:, 2]       # [disp, rot, vol, transfer]
            _rank_line(0, f"(e) gibbs full: {int(n_vol.min())} volume "
                       f"moves per chain, {int(rows['acc'][:, 2].sum())} "
                       f"accepted")
            bad += int((n_vol == 0).sum())
    if bad:
        raise AssertionError("(e): a sharded ensemble run is not the "
                             "unsharded one")
    return ref_ms


def phase25(dev, smi, chains=2048, steps=2, tp_chains=64, tp_chunk=8,
            nccl_chains=512, ens_chains=256, ens_chunk=16):
    """The parallel layer on the card (the ranks are gloo processes on one
    shared H100, not a multi-GPU measurement): (a) the flagship, `chains`
    chains, over 2 gloo ranks, bit for bit against the unsharded run; (b)
    the chain offset of the three Philox-scored kernels; (c) the TP
    recompute on a 2 x 2 gloo mesh at tp_chains chains; (d) (a) and one
    TP recompute in a world of one NCCL rank; (e) every ensemble case of
    ENSEMBLE_CASES, ens_chains chains over 2 gloo ranks (recompute chunks
    of ens_chunk, a divisor of a rank's chains), init and run bit for bit
    against the unsharded run."""
    from metropolismontecarlo_tpu_torch.parallel.mesh import run_world

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a = run_world(phase25_sharded_rank, 2, (chains, steps), device="cuda",
                  backend="gloo", timeout=600)[0]
    print(f"phase25 (a) {time.perf_counter() - t0:.1f} s: per-rank sweep "
          f"{a['sweep_ms']:.3f} ms (2 ranks at once) against "
          f"{a['ref_sweep_ms']:.3f} ms unsharded, exchange round "
          f"{a['round_ms']:.3f} ms, swap fractions {a['fracs']}")
    t1 = time.perf_counter()
    err = phase25_offsets(dev)
    print(f"phase25 (b) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    c = run_world(phase25_tp_rank, 4, (2, 2, tp_chains, tp_chunk),
                  device="cuda", backend="gloo", timeout=600)[0]
    print(f"phase25 (c) {time.perf_counter() - t1:.1f} s: TP recompute "
          f"{c['tp_s']:.3f} s per rank (4 ranks at once) against "
          f"{c['ref_s']:.3f} s unsharded, rel err {c['rel']:.3e}, drift "
          f"{c['drift']:.3e}")
    t1 = time.perf_counter()
    run_world(phase25_nccl_rank, 1, (nccl_chains, steps, tp_chains,
                                     tp_chunk), device="cuda", timeout=600)
    print(f"phase25 (d) {time.perf_counter() - t1:.1f} s (nccl)")
    t1 = time.perf_counter()
    e = run_world(phase25_ensembles_rank, 2, (ens_chains, ens_chunk),
                  device="cuda", backend="gloo", timeout=600)
    for name in ENSEMBLE_CASES:
        print(f"phase25 (e) {name}: per-rank cycle "
              f"{e[0]['rank_ms'][name]:.3f} / {e[1]['rank_ms'][name]:.3f} ms "
              f"(2 ranks at once) against {e[0]['ref_ms'][name]:.3f} ms "
              f"unsharded; card: {smi}")
    print(f"phase25 (e) {time.perf_counter() - t1:.1f} s: 0 differing "
          f"elements in {len(ENSEMBLE_CASES)} ensemble runs")
    print(f"phase25 total {time.perf_counter() - t0:.1f} s; card: {smi}")
    return err


# ---------------- phase 26: the two-particle Boltzmann density ----------

VALIDATION_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "docs", "validation_torch")


def phase26(dev, smi, **depth):
    """run_mega_boltzmann.py's protocol and gates (depth: its
    sample_histogram's chains, rounds, gap, decorrelate; the protocol's
    when empty): the sweep kernel's pair-distance histogram against the
    analytic density, both routes' acceptance, fresh uniforms per
    run_steps call.  Raises on a failed gate."""
    if VALIDATION_DIR not in sys.path:
        sys.path.insert(0, VALIDATION_DIR)
    import run_mega_boltzmann as mb

    t0 = time.perf_counter()
    hist, edges, acc_k, route, (n_dist, n_draw) = mb.sample_histogram(
        "sweep", dev, **depth)
    _, _, acc_p, route_p, (n_dist_p, n_draw_p) = mb.sample_histogram(
        "plain", dev, **depth)
    chi2, zmax, peak_off, ok, *_ = mb.gates(hist, edges, acc_k, acc_p)
    fresh = n_dist == n_draw and n_dist_p == n_draw_p
    print(f"phase26: routes {route} / {route_p}, {int(hist.sum())} samples, "
          f"chi2/bin {chi2:.3f} (bound 9), max |z| {zmax:.2f}, peak-bin "
          f"offset {peak_off} (bound 3), acceptance {acc_k:.4f} kernel vs "
          f"{acc_p:.4f} plain (bound 0.02), {n_dist} of {n_draw} / "
          f"{n_dist_p} of {n_draw_p} uniform draws distinct; "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    if not (ok and fresh and route == "sweep" and route_p == "plain"):
        raise AssertionError("phase26: the two-particle Boltzmann gates "
                             "failed")


# ---------------- phase 27: the staged-FEP path ----------------

FEP_RUNG = (0.4, 0.0)
# the lambda-work basis systems of run_bar_water.py
FEP_BASIS = ((0.5, 0.0), (1.0, 0.0), (1.0, 0.5), (1.0, 1.0))


def fep_state_point(n):
    """run_bar_water.py's RunParams and box for n rest waters (+ the tag):
    0.997 g/cc, 298.15 K, Ewald, r_cut min(9, 0.45 box) + LRC."""
    if VALIDATION_DIR not in sys.path:
        sys.path.insert(0, VALIDATION_DIR)
    import run_bar_water as bw

    from metropolismontecarlo_tpu_torch.models.system import RunParams

    box = bw.box_edge(n)
    params = RunParams(temperature=bw.T, r_cut=min(9.0, 0.45 * box),
                       cutoff_mode="site", coulomb="ewald", use_lrc=True,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3,
                       strict_min_image=n >= 100)
    return params, box


def fep_basis_identity(mc, state, dtype, chunk=64, rung=FEP_RUNG):
    """The lambda-basis identity on samples of the rung `rung` (mc's
    tagged system): the deletion works at the four basis systems (the
    state's carried S(k) stripped of the tag at the rung's charges) give,
    through lambda_basis / lambda_work, the rung's own deletion work.
    Returns (the four basis works, the rung's direct work, the
    reconstruction, the terms' magnitude), host float64 (C, 1) each; the
    magnitude is sum_i |c_i| |w_i| + |direct| over the reconstruction's
    coefficients c_i, the scale of its round-off."""
    from metropolismontecarlo_tpu_torch.mc.fep import (
        lambda_basis,
        lambda_work,
        make_deletion_fn,
        tag_last_molecule,
    )
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    n_mol = mc.system.n_mol

    def work(system, state_system):
        return make_deletion_fn(
            system, mc.params, mc.kvecs, mc.kweights, device=mc.device,
            dtype=dtype, chunk=chunk, species=-1,
            state_system=state_system)(state)[0].double().cpu().numpy()

    works = [work(tag_last_molecule(spce_system(n_mol), lj, q), mc.system)
             for lj, q in FEP_BASIS]
    direct = work(mc.system, None)
    recon = lambda_work(*rung, *lambda_basis(*works))
    # the reconstruction's coefficient of each basis work, from a unit
    # impulse through the same two functions
    coef = [abs(float(lambda_work(*rung, *lambda_basis(
        *[np.float64(i == j) for j in range(4)])))) for i in range(4)]
    mag = sum(c * np.abs(w) for c, w in zip(coef, works)) + np.abs(direct)
    return works, direct, recon, mag


def _sim_rows(st, n):
    """The first n chains of a SimState (the step counter is shared)."""
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name)[:n] for f in dataclasses.fields(st)
        if getattr(st, f.name).dim() > 0})


def phase27(dev, smi, n=216, chains=256, twin_chains=64, sweeps=5,
            n_ghost=16, chunk=64, dtype=torch.float32):
    """The staged-FEP path of docs/validation_torch/run_bar_water.py at its
    state point (mc/fep.py; PERF.md §4): tag_last_molecule(spce_system(n +
    1), 0.4, 0), whose last water is a species block of its own, box
    18.644 A, r_cut 8.4 A + LRC, `chains` chains.  (a) init_state and one
    run_block of `sweeps` sweeps on the route choose_route gives it (the
    whole-sweep kernel: one launch per species block per sweep) with the
    drift gate; (b) one sweep of the kernel against sweep_plain on shared
    uniforms at twin_chains chains, the one-molecule block's launch among
    them, under phase 2's gates; (c) make_deletion_fn at the four basis
    systems and at the rung's own: lambda_work(0.4, 0, *lambda_basis(...))
    equals the direct work within ENERGY_REL_TOL of the terms' magnitude;
    (d) one make_decoupled_insertion_fn call of n_ghost poses per chain on
    the same configurations at lambda = 0: finite works outside its
    overlap mask.  Raises on a failed gate."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.fep import (
        make_decoupled_insertion_fn,
        tag_last_molecule,
    )
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op
    from metropolismontecarlo_tpu_torch.ops.quaternions import (
        random_quaternion,
    )

    t0 = time.perf_counter()
    params, box = fep_state_point(n)
    system = tag_last_molecule(spce_system(n + 1), *FEP_RUNG)
    gen = torch.Generator(device=dev).manual_seed(2071)
    mc = MonteCarlo(system, params, device=dev, generator=gen, dtype=dtype)
    state = mc.init_state(cubic_lattice(n + 1, box), box=box,
                          n_chains=chains)
    blocks = [b[1] for b in system.species]
    op.sweep.launches = 0
    state, stats = mc.run_block(state, sweeps, drift_tol=DRIFT_TOL)
    launches = op.sweep.launches
    print(f"phase27 (a) tagged SPC/E {n}+1 at lambda {FEP_RUNG}, box "
          f"{box:.3f} A, r_cut {params.r_cut:.2f} A + LRC, {chains} chains: "
          f"route {mc.route!r}, species blocks {blocks}, {launches} sweep "
          f"launches in {sweeps} sweeps, drift {stats['drift_max_rel']:.2e},"
          f" <E>/N {stats['energy_mean'] / n:.1f} K, acceptance "
          f"{stats['acc_trans']:.3f} / {stats['acc_rot']:.3f}")
    if mc.route == "sweep" and dev.type == "cuda" \
            and launches != sweeps * len(blocks):
        raise AssertionError(f"phase27: {launches} launches, not one per "
                             "species block and sweep")
    err = compare(f"27 (b) tagged spce{n}+1 {FEP_RUNG}", mc,
                  _sim_rows(state, twin_chains), gen)
    works, direct, recon, mag = fep_basis_identity(mc, state, dtype, chunk)
    rel = float(np.max(np.abs(recon - direct) / np.maximum(mag, 1.0)))
    print(f"phase27 (c) lambda basis at {FEP_RUNG} on {chains} chains: "
          f"direct work {float(direct.mean()):+.4f} K (chain mean), largest "
          f"|basis - direct| {float(np.abs(recon - direct).max()):.3e} K, "
          f"{rel:.3e} of the terms' magnitude (bound {ENERGY_REL_TOL}); "
          "basis works (chain means) " + ", ".join(
              f"{lam}: {float(w.mean()):+.2f} K"
              for lam, w in zip(FEP_BASIS, works)))
    mc0 = MonteCarlo(tag_last_molecule(spce_system(n + 1), 0.0, 0.0),
                     params, device=dev, generator=gen, dtype=dtype)
    st0 = mc0.resync(state)
    ghost = make_decoupled_insertion_fn(system, params, mc0.kvecs,
                                        mc0.kweights, device=dev,
                                        dtype=dtype, chunk=chunk)
    com_t = torch.rand((chains, n_ghost, 3), generator=gen, dtype=dtype,
                       device=dev) * st0.box[:, None, None]
    du, overlap = ghost(st0, com_t, random_quaternion(gen, (chains, n_ghost),
                                                      dtype))
    free = ~overlap
    finite = bool(torch.isfinite(du[free]).all())
    print(f"phase27 (d) decoupled insertions: {n_ghost} ghosts x {chains} "
          f"chains, {int(free.sum())} outside the overlap mask, all finite "
          f"{finite}, min {float(du[free].min()):.1f} K; "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    if not (rel <= ENERGY_REL_TOL and finite and int(free.sum()) > 0):
        raise AssertionError("phase27: the staged-FEP gates failed")
    return launches, err


# phase 28's shapes: (tag, builder, waters, box, r_cut, chains), the
# benchmark's flagship and TIP4P/2005-750 cells
RECOMPUTE_SHAPES = (("flagship SPC/E-750", "spce_system", 750, 28.24, 10.0,
                     2048),
                    ("TIP4P/2005-750", "tip4p2005_system", 750, 28.24, 10.0,
                     1024))
RECOMPUTE_TOL = 2e-5       # energy and virial over max(|E|, |E_self|)
RECOMPUTE_SK_TOL = 1e-4    # S(k) over the sum of |q|
RECOMPUTE_REF_CHAINS = 16  # chains of the float64 reference
# the kernel against the plain float32 route on every chain: each route
# within its own limit of the float64 reference, so twice the limits
RECOMPUTE_PAIR_TOL, RECOMPUTE_PAIR_SK_TOL = 2 * RECOMPUTE_TOL, \
    2 * RECOMPUTE_SK_TOL


class _SpanNames:
    """A span sink (utils/profiling.py) that keeps the names it sees."""

    def __init__(self):
        self.names = []

    def span(self, name, units, sync):
        self.names.append(name)
        return contextlib.nullcontext()


def recompute_bound(system, params, chains, frac, K):
    """The least time (ms) of one recompute of `chains` chains of `system`
    and what sets it: per chain each unordered pair of sites of different
    molecules one distance and, for the share frac inside the cutoff, its
    terms (LJ between LJ sites, Coulomb between charged ones); with Ewald
    per molecule its S(k) row (k_pose_ops) and per chain the reciprocal
    sum over the K k-vectors; each chain's atoms read and its energy and
    S(k) written once."""
    P, M, A = system.atoms_per_mol, system.n_mol, system.n_atoms
    sites = np.asarray(system.type_ids[0])
    n_lj = int(np.sum(np.any(np.asarray(system.eps_table) != 0, 1)[sites]))
    ewald = params.coulomb == "ewald"
    n_q = int(np.sum(np.asarray(system.charges[0]) != 0)) if ewald else 0
    terms = frac * ((n_lj / P) ** 2 * OPS_LJ + (n_q / P) ** 2 * OPS_COULOMB)
    ops = chains * A * (A - P) / 2.0 * (OPS_GEOMETRY + terms)
    if ewald:
        ops += chains * (M * k_pose_ops(K, params.nk, n_q) + K * OPS_K_MOVE)
    return _bound(4.0 * chains * (3 * A + 1 + 2 * K), ops)


def recompute_case(dev, tag, builder, n_mol, box, r_cut, chains, reps=5):
    """One shape of phase 28; returns its numbers."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models import water
    from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
    from metropolismontecarlo_tpu_torch.ops.cuda import recompute_kernel as rop
    from metropolismontecarlo_tpu_torch.utils import profiling
    from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map

    system = getattr(water, builder)(n_mol)
    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(FLAGSHIP_SEED)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    t = mc._recompute_tables
    if t is None:
        raise AssertionError(f"{tag}: the gate refused the recompute kernel")
    n0 = rop.recompute_kernel.launches
    st = mc.init_state(cubic_lattice(n_mol, box), box=box, n_chains=chains)
    # chains at boxes 0.99-1.01 of the lattice's, as after volume moves
    scale = torch.linspace(0.99, 1.01, chains, device=dev)
    com = st.com * scale[:, None, None]
    coords = mc.build_coords(com, st.quat)
    boxes = st.box * scale
    args = (coords, com, boxes)
    e, w, sk = mc._energies(*args)
    torch.cuda.synchronize()
    if rop.recompute_kernel.launches != n0 + 2:
        raise AssertionError(f"{tag}: {rop.recompute_kernel.launches - n0} "
                             f"kernel launches for 2 recomputes")
    call_ms = _time_ms(lambda: mc._energies(*args), reps)
    kernel_ms = _time_ms(lambda: rop._launch(t, *args), reps)
    if rop.recompute_kernel.launches != n0 + 2 + 2 * reps:
        raise AssertionError(f"{tag}: the launch counter missed a launch")
    # the chunked plain route on the same states: the tables set aside
    mc._recompute_tables = None
    try:
        e_p, w_p, sk_p = mc._energies(*args)
        plain_ms = _time_ms(lambda: mc._energies(*args), 1)
    finally:
        mc._recompute_tables = t
    # both against energy_breakdown in float64 on the first chains
    n = min(RECOMPUTE_REF_CHAINS, chains)
    A = system.n_atoms
    cols = chunked_map(
        lambda c, m, b: tuple(energy_breakdown(
            system, params, c[:, :, :A].transpose(1, 2).double(), m.double(),
            b.double(), mc.kvecs, mc.kweights)[key]
            for key in ("total", "w", "sfac", "coul_self")),
        2, coords[:n], com[:n], boxes[:n])
    ref = dict(zip(("total", "w", "sfac", "coul_self"), cols))
    scale_e = torch.maximum(ref["total"].abs(), ref["coul_self"].abs())
    qsum = float(np.abs(system.flat(system.charges)).sum())

    def err(e_, w_, s_):
        return (float(((e_[:n].double() - ref["total"]).abs()
                       / scale_e).max()),
                float(((w_[:n].double() - ref["w"]).abs() / scale_e).max()),
                float((s_[:n].double() - ref["sfac"]).abs().max()) / qsum)

    k_err, p_err = err(e, w, sk), err(e_p, w_p, sk_p)
    # every chain: the kernel against the plain float32 route
    scale_all = torch.maximum(
        e_p.double().abs(),
        ewald_ops.ewald_self(t.q.double(), t.kappa_l / boxes.double()).abs())
    vs_plain = (float(((e - e_p).double().abs() / scale_all).max()),
                float(((w - w_p).double().abs() / scale_all).max()),
                float((sk - sk_p).abs().max()) / qsum)
    regs, local, blocks, smem, tile = rop.occupancy(t)
    frac = _cutoff_fraction(system, SimpleNamespace(
        coords=coords, box=boxes), r_cut, n=8)
    bound_ms, bound_by = recompute_bound(system, params, chains, frac, t.K)
    print(f"phase28 {tag}, {chains} chains, A {A}, K {t.K}: kernel "
          f"{kernel_ms:.3f} ms a launch, {call_ms:.3f} ms a recompute with "
          f"the tail; chunked plain route {plain_ms:.1f} ms "
          f"({mc.recompute_chunk} chains a chunk); {regs} registers, {local} "
          f"B local, {smem} B shared, {blocks} blocks per SM, eik tiles of "
          f"{tile} sites; bound {bound_ms:.3f} ms ({bound_by}, cutoff "
          f"fraction {frac:.4f}), share {100.0 * bound_ms / kernel_ms:.2f}%")
    print(f"phase28 {tag} against float64 energy_breakdown ({n} chains; "
          f"energy, virial over max(|E|, |E_self|), S(k) over sum |q| = "
          f"{qsum:.1f}): kernel {k_err[0]:.3e} {k_err[1]:.3e} "
          f"{k_err[2]:.3e}; plain f32 {p_err[0]:.3e} {p_err[1]:.3e} "
          f"{p_err[2]:.3e}; kernel against plain f32 on all {chains} chains "
          f"{vs_plain[0]:.3e} {vs_plain[1]:.3e} {vs_plain[2]:.3e}")
    if not (k_err[0] <= RECOMPUTE_TOL and k_err[1] <= RECOMPUTE_TOL
            and k_err[2] <= RECOMPUTE_SK_TOL):
        raise AssertionError(f"{tag}: the recompute kernel is off the "
                             f"float64 reference: {k_err}")
    if not (vs_plain[0] <= RECOMPUTE_PAIR_TOL
            and vs_plain[1] <= RECOMPUTE_PAIR_TOL
            and vs_plain[2] <= RECOMPUTE_PAIR_SK_TOL):
        raise AssertionError(f"{tag}: the recompute kernel is off the plain "
                             f"float32 route: {vs_plain}")
    if local:
        raise AssertionError(f"{tag}: the recompute kernel spills "
                             f"({local} B local)")
    # a run_block of one sweep, the main path: its recompute is one kernel
    # launch, counted from zero, with no chunk and no energy phase inside it
    names = _SpanNames()
    rop.recompute_kernel.launches = 0
    profiling.attach(names)
    try:
        mc.run_block(st, 1)
    finally:
        profiling.detach()
    inner = [n for n in names.names if n not in ("recompute",
                                                 "recompute.kernel")]
    launches = rop.recompute_kernel.launches
    print(f"phase28 {tag} run_block(1): spans {names.names}, {launches} "
          f"kernel launch")
    if launches != 1 or inner \
            or names.names != ["recompute", "recompute.kernel"]:
        raise AssertionError(f"{tag}: run_block's recompute is not one "
                             f"kernel launch")
    return dict(ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
                err=max(k_err), bound_ms=bound_ms, bound_by=bound_by,
                launches=launches)


def phase28(dev):
    """The recompute kernel at the benchmark's flagship (750 SPC/E, 2048
    chains) and TIP4P/2005-750 (1024 chains) shapes from a lattice start
    with random orientations, chains at boxes 0.99-1.01 of 28.24 A: one
    kernel launch per recompute (the launch counter read after each),
    the kernel's time (CUDA events, 5 launches) and the recompute's with
    its O(C) tail, the chunked plain route's on the same states; both
    against energy_breakdown in float64 on the first 16 chains (energy
    and virial within 2e-5 of max(|E|, |E_self|), S(k) within 1e-4 of
    the sum of |q|, for the kernel), the kernel against the plain float32
    route on every chain within twice those limits; registers, shared
    bytes, blocks per SM; recompute_bound at the states' cutoff fraction
    and the kernel's share of it; last a run_block of one sweep whose
    recompute must be one launch (the counter set to zero before it)
    inside its `recompute` span, with no chunk."""
    t0 = time.perf_counter()
    out = {tag: recompute_case(dev, tag, *rest)
           for tag, *rest in RECOMPUTE_SHAPES}
    print(f"phase28: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default=",".join(str(i) for i in range(2, 29)),
                    help="comma-separated phases to run after 0 and 1 "
                         "(default: all; the result lines are printed only "
                         "when all ran)")
    want = {int(x) for x in ap.parse_args().phases.split(",") if x}
    name, smi = phase0()
    t_start = time.perf_counter()
    phase1()
    dev = torch.device("cuda", 0)
    if 2 in want:
        err2, err_d = phase2(dev)
        err_d = max(err_d, phase2_delta_stress(dev))
        err2x = phase2_variants(dev)
        err2c = phase2_compaction(dev)
        err2t, _ = phase2_tmmc(dev)
        t0 = time.perf_counter()
        err2g, _ = phase2_global(dev)
        print(f"phase 2 global layout and slab cases: "
              f"{time.perf_counter() - t0:.1f} s")
        err2gb = max(phase2_gibbs(dev), phase2_gibbs_stress(dev),
                     phase2_gibbs_binary(dev))
        err2f = max(phase2_flip(dev), phase2_flip_stress(dev))
        err2p4, err_d4, _, _ = phase2_tip4p(dev)
        phase2_layouts(dev)
    if 3 in want:
        # earlier main paths at reduced depth: the script's time goes to
        # the new phases (phase 3 keeps its 10-sweep adjust block, which
        # takes the lattice start away from E = 0)
        l3, err3, ms3, plain3, bound3, by3 = phase3(
            dev, blocks=((10, True), (2, False), (2, False)))
    if want & {4, 5}:
        l4, err4, ms4, plain4, bound4, by4, mc4, state4 = phase4(
            dev, blocks=((4, True), (2, False), (2, False)))
    if 5 in want:
        l5, err5, err_d5, ms5, dev_ms5, plain5, bound5, by5 = phase5(
            dev, mc4, state4, blocks=((1, False), (1, False)))
    if 6 in want:
        ((l6, err6, ms6, plain6, bound6, by6),
         (l6h, err6h, ms6h, plain6h, bound6h, by6h)) = phase6(dev)
    if 7 in want:
        l7 = phase7(dev)
    if 8 in want:
        l8, err8, ms8, plain8, bound8, by8 = phase8(dev)
    if 9 in want:
        (l9, err9, ms9, plain9, bound9, by9), l9m = phase9(dev)
    if 10 in want:
        l10 = phase10_ideal(dev)
        l10s, l10m, _ = phase10_spce(dev)
        l10l, l10g, _ = phase10_lj(dev)
    if 11 in want:
        ((l11, err11, ms11, plain11, bound11, by11),
         (l11d, err11d, ms11d, plain11d, bound11d, by11d)) = phase11(dev)
    if 12 in want:
        l12 = phase12(dev)
    if 13 in want:
        l13, err13, ms13, plain13, bound13, by13 = phase13(dev)
    if 14 in want:
        t0 = time.perf_counter()
        l14 = phase14_ideal(dev) + phase14_water(dev)
        print(f"phase14: {l14} Gibbs kernel launches (not in the kernels "
              f"line); {time.perf_counter() - t0:.1f} s")
    if 15 in want:
        l15, err15, ms15, plain15, bound15, by15 = phase15(dev)
    if 16 in want:
        phase16(dev)
    if 17 in want:
        phase17(dev)
    if 18 in want:
        cli = phase18(dev)
    if 19 in want:
        phase19()
    if 20 in want:
        t0 = time.perf_counter()
        l20 = phase20(dev)[0]
        print(f"phase20: {l20} Gibbs kernel launches on the binary and "
              f"NPT-Gibbs paths (not in the kernels line); "
              f"{time.perf_counter() - t0:.1f} s")
    if 21 in want:
        t0 = time.perf_counter()
        l21 = phase21(dev)[0]
        print(f"phase21: {l21} sweep kernel launches on the osmotic paths "
              f"(not in the kernels line); {time.perf_counter() - t0:.1f} s")
    if 22 in want:
        ((l22, err22, ms22, plain22, bound22, by22),
         (l22d, err22d, ms22d, dev_ms22d, plain22d, bound22d,
          by22d)) = phase22(dev)
    if 23 in want:
        l23, err23, ms23, plain23, bound23, by23 = phase23(dev)
    if 24 in want:
        rows24 = phase24(dev)
    if 25 in want:
        phase25(dev, smi)
    if 26 in want:
        phase26(dev, smi)
    if 27 in want:
        phase27(dev, smi)
    if 28 in want:
        rec28 = phase28(dev)
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    if want != set(range(2, 29)):
        print("chip_smoke: a partial run (--phases) prints no result",
              file=sys.stderr)
        sys.exit(1)
    sweep_src = f"{SRC}/sweep_kernel.cu"
    sweep_row = dict(route="cuda", source=sweep_src,
                     replaces=f"{PALLAS}/sweep_kernel.py:903",
                     library_ms=None)
    gibbs_row = dict(route="cuda", source=f"{SRC}/gibbs_kernel.cu",
                     replaces=f"{PALLAS}/gibbs_kernel.py:714",
                     library_ms=None)
    flip_row = dict(route="cuda", source=f"{SRC}/flip_kernel.cu",
                    replaces=f"{PALLAS}/flip_kernel.py:395", library_ms=None)
    print(json.dumps({"kernels": [
        dict(sweep_row, name="sweep_kernel",
             launches=l3 + l12 + cli["spce_750"][0],
             max_abs_err=max(err2, err2c, err3), ms=ms3, plain_ms=plain3,
             bound_ms=bound3, bound_by=by3),
        dict(sweep_row, name="sweep_kernel[species blocks]", launches=l4,
             max_abs_err=max(err2, err4, err5), ms=ms4, plain_ms=plain4,
             bound_ms=bound4, bound_by=by4),
        {"name": "delta_energy", "route": "cuda",
         "source": f"{SRC}/delta_energy.cu",
         "replaces": f"{PALLAS}/delta_energy.py:159", "launches": l5,
         "max_abs_err": max(err_d, err_d5), "ms": ms5, "device_ms": dev_ms5,
         "plain_ms": plain5, "bound_ms": bound5, "bound_by": by5,
         "library_ms": None},
        dict(sweep_row, name="sweep_kernel[use_act]",
             launches=l6h + l9m + l10m, max_abs_err=max(err2x, err6h),
             ms=ms6h, plain_ms=plain6h, bound_ms=bound6h, bound_by=by6h),
        dict(sweep_row, name="sweep_kernel[n_exch]",
             launches=l6 + l7 + l10g + cli["gcmc_spce_mega"][0],
             max_abs_err=max(err2x, err6), ms=ms6, plain_ms=plain6,
             bound_ms=bound6, bound_by=by6),
        dict(sweep_row, name="sweep_kernel[n_widom]", launches=l8,
             max_abs_err=max(err2x, err8), ms=ms8, plain_ms=plain8,
             bound_ms=bound8, bound_by=by8),
        dict(sweep_row, name="sweep_kernel[tmmc]",
             launches=l9 + l10 + l10s + l10l, max_abs_err=max(err2t, err9),
             ms=ms9, plain_ms=plain9, bound_ms=bound9, bound_by=by9),
        # the 6859-water cell, one launch of 512 moves of every chain (a
        # full sweep's time and bound are in the phase 11 line)
        dict(sweep_row, name="sweep_kernel[slab]",
             replaces=f"{PALLAS}/sweep_kernel.py:86", launches=l11,
             max_abs_err=max(err2g, err11), ms=ms11, plain_ms=plain11,
             bound_ms=bound11, bound_by=by11),
        dict(sweep_row, name="sweep_kernel[global layout]", launches=l11d,
             max_abs_err=max(err2g, err11d), ms=ms11d, plain_ms=plain11d,
             bound_ms=bound11d, bound_by=by11d),
        # the cap-128 x 2 SPC/E Gibbs cell: one cycle of 256 moves + 110
        # transfers per launch
        {"name": "sweep_gibbs_kernel", "route": "cuda",
         "source": f"{SRC}/gibbs_kernel.cu",
         "replaces": f"{PALLAS}/gibbs_kernel.py:714",
         "launches": l13 + cli["gibbs_spce_mega"][0],
         "max_abs_err": max(err2gb, err13), "ms": ms13, "plain_ms": plain13,
         "bound_ms": bound13, "bound_by": by13, "library_ms": None},
        # the cap-64 + 64 SPC/E semigrand cell: 55 flips per launch
        {"name": "flip_kernel", "route": "cuda",
         "source": f"{SRC}/flip_kernel.cu",
         "replaces": f"{PALLAS}/flip_kernel.py:395", "launches": l15,
         "max_abs_err": max(err2f, err15), "ms": ms15, "plain_ms": plain15,
         "bound_ms": bound15, "bound_by": by15, "library_ms": None},
        # TIP4P/2005-750 at P = 4, one launch per sweep
        dict(sweep_row, name="sweep_kernel[P=4 tip4p2005]", launches=l22,
             max_abs_err=max(err2p4, err22), ms=ms22, plain_ms=plain22,
             bound_ms=bound22, bound_by=by22),
        # the per-move route at P = 4: R = 8 rows per launch
        {"name": "delta_energy[R=8 tip4p2005]", "route": "cuda",
         "source": f"{SRC}/delta_energy.cu",
         "replaces": f"{PALLAS}/delta_energy.py:159", "launches": l22d,
         "max_abs_err": max(err_d4, err22d), "ms": ms22d,
         "device_ms": dev_ms22d, "plain_ms": plain22d, "bound_ms": bound22d, "bound_by": by22d,
         "library_ms": None},
        # the topology mixture (bench mixture on stand-in files): two
        # species-block launches per sweep
        dict(sweep_row, name="sweep_kernel[topology species blocks]",
             launches=l23, max_abs_err=err23, ms=ms23, plain_ms=plain23,
             bound_ms=bound23, bound_by=by23)] + [
        # phase 24: the states over a block's shared memory; each row's
        # times on the launch held to its plain version (first chains,
        # or the first 512 moves of the bulk water)
        dict(row, name=name, launches=r[0], max_abs_err=max(r[1], e2),
             ms=r[2], plain_ms=r[3], bound_ms=r[4], bound_by=r[5])
        for name, key, row, e2 in (
            ("sweep_kernel[use_act global]", "use_act global", sweep_row,
             err2x),
            ("sweep_kernel[tmmc global]", "tmmc global", sweep_row, err2t),
            ("sweep_kernel[k rows global]", "k rows global", sweep_row,
             err2g),
            ("sweep_gibbs_kernel[global]", "gibbs global", gibbs_row,
             err2gb),
            ("flip_kernel[global]", "flip global", flip_row, err2f))
        for r in (rows24[key],)] + [
        # phase 28: one launch per recompute (no TPU kernel: the JAX
        # package recomputes in plain jnp)
        {"name": f"recompute_kernel[{tag}]", "route": "cuda",
         "source": f"{SRC}/recompute_kernel.cu", "replaces": None,
         "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for tag, r in rec28.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
