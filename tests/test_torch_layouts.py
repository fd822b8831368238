"""Where the port's kernels keep a chain's state -- the "shared", "global"
and "global_k" layouts of ops/cuda/sweep_kernel.py, gibbs_kernel.py and
flip_kernel.py -- on the CPU.

* Each kernel's shared-memory byte model, region by region and layout by
  layout, against the list in its docstring.
* The choosers: shared below a block's limit, the global layouts above it
  for the large states the JAX kernels run (muVT and TMMC at capacity 4096,
  6859 waters at tol 1e-5, Gibbs at capacity 1024, semigrand 1024 + 1024,
  the NPT-Gibbs CO2/N2 launch); a forced layout; a raise, with the byte
  count, only when a forced layout or the part that does not grow with the
  state overflows.
* The smallest over-limit state of each kernel (a few slots, K pushed over
  the limit by a tight Ewald tolerance) through MolGCMC, TMMCMol,
  MolGibbsEnsemble and Semigrand with mega="full" on the CPU, where the
  wrappers run their plain versions, against the JAX package's kernels in
  the TPU interpreter, whose PRNG returns zeros: the port gets zero
  uniforms and zero scores; equal decisions, energies within 2e-5 of the
  term magnitudes, S(k) within 1e-4 of its largest component.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc_mol as gcmc_j
from metropolismontecarlo_tpu.mc import gibbs_mol as gibbs_j
from metropolismontecarlo_tpu.mc import semigrand as sg_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc_mol as gcmc_t
from metropolismontecarlo_tpu_torch.mc import gibbs_mol as gibbs_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc import semigrand as sg_t
from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as flip_op
from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gibbs_op
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.ewald import (
    make_kvectors,
    tune_parameters,
)
from tests.test_semigrand import water_two_blocks

F32 = torch.float32
LAYOUTS = ("shared", "global", "global_k")
LIMIT = sweep_op.MAX_SMEM_BYTES
QUEUES = 2 * 8 * 128            # warp queues: 8 x 128 (key, d^2)
NEAR = 8 * 64                   # the warps' near rings


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- the byte models, region by region ---------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("use_act,tmmc", [(False, False), (True, False),
                                          (True, True)])
def test_sweep_smem_regions(layout, use_act, tmmc):
    M, P, A, K, T = 512, 3, 1536, 337, 2
    words = (64                          # slot-pick row (32 x 8 B)
             + QUEUES + NEAR
             + 4 * P * T                 # eps, sig2, lam1, lam2
             + 2 * (4 * P + 4 * P)       # two proposals: old, new site rows
             + 3 * P + P + P + P + P     # body, charge, 2 flags, cutoff
             + 2 * 16 + 16 + 32 + 16)    # proposals, uniforms, partials,
    #                                      statistics
    if layout == "shared":
        words += 4 * A                   # x, y, z, molecule
        if use_act:
            words += A + M               # atom and slot activity
    if layout != "global_k":
        words += 8 * K                   # S re/im, cfac, dS re/im, kx/ky/kz
        if tmmc:
            words += 2 * K               # the deletion's dS re/im
    if tmmc:
        words += 64 + QUEUES + 4 * P + 32  # pick row, queues, pose, partials
    assert sweep_op.smem_bytes(M, P, A, K, T, use_act, tmmc, layout) \
        == 4 * words
    kws = 5 * K + (2 * K if tmmc else 0)
    assert sweep_op.kws_floats(K, tmmc) == kws


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gibbs_smem_regions(layout):
    m_off, P, A, K, T, nk = 128, 3, 512, 783, 2, 7
    W = 2 * nk + 1
    words = (QUEUES + NEAR
             + 2 * 2 * 4 * P             # two buffers of old/new site rows
             + 2 * 2 * P * 3 * W * 2     # their eik tables (complex rows)
             + 4 * P * T                 # eps, sig2, lam1, lam2
             + 3 * P + 4 * P             # body; charge, 2 flags, cutoff
             + 2 * 16 + 32 + 16 + 8)     # proposals, partials, stats, box
    if layout == "shared":
        words += (4 * 2 * A              # x, y, z, activity, both boxes
                  + A                    # molecule (one box's row)
                  + 2 * m_off            # slot activity, both boxes
                  + 2 * 2 * m_off)       # two rows of Philox scores
    if layout != "global_k":
        words += 2 * 3 * K + 4 * K + K   # S re/im, cfac; two dS; k indices
    assert gibbs_op.gibbs_smem_bytes(m_off, P, A, K, T, nk, layout) \
        == 4 * words
    ws = {"shared": 0, "global": 6 * A + 4 * m_off,
          "global_k": 6 * A + 4 * m_off + 11 * K}[layout]
    assert gibbs_op.ws_floats(m_off, A, K, layout) == ws


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flip_smem_regions(layout):
    M, P0, P1, A, K, T, nk = 128, 1, 3, 384, 337, 2, 5
    W = 2 * nk + 1
    words = (QUEUES
             + 2 * 4 * 3                 # old and new site rows (max P)
             + 2 * 3 * 3 * W * 2         # their eik tables
             + 2 * (3 * (P0 + P1) + 8)   # two proposal buffers
             + 2 * P0 * T + 2 * P1 * T   # eps and sigma^2 tables
             + 7 * P0 + 7 * P1           # site rows
             + 33)                       # partials, statistics, list length
    if layout == "shared":
        words += 6 * A + M + 2 * M       # atom rows; slots; Philox scores
    if layout != "global_k":
        words += 6 * K                   # S re/im, cfac, dS re/im, k indices
    assert flip_op.flip_smem_bytes(M, P0, P1, A, K, T, nk, layout) \
        == 4 * words
    ws = {"shared": 0, "global": 2 * A + 2 * M,
          "global_k": 2 * A + 2 * M + 6 * K}[layout]
    assert flip_op.ws_floats(M, A, K, layout) == ws


# ---------------- the choosers ------------------------------------------


def _nk_k(box, r_cut, tol):
    """(nk, K) of the Ewald parameters tune_parameters gives."""
    _, nk, ksq = tune_parameters(box, r_cut, tol)
    return nk, len(make_kvectors(nk, ksq)[0])


NK_MUVT, K_MUVT = _nk_k(50.0, 10.0, 1e-3)        # K 2975
NK_BULK, K_BULK = _nk_k(59.056, 10.0, 1e-5)      # K 22,994
NK_GIBBS, K_GIBBS = _nk_k(41.64, 7.5, 1e-3)      # K 4849
NK_SG, K_SG = _nk_k(50.4, 8.0, 1e-3)             # K 6062
# (kernel, chooser arguments, keyword arguments, layout): the large states
# the JAX kernels run at cb = 1, and shapes that fit
CHOICES = [
    ("sweep", (750, 3, 2304, 337, 2), {}, "shared"),
    ("sweep", (512, 3, 1536, 337, 2), dict(use_act=True, tmmc=True),
     "shared"),
    # muVT and TMMC: SPC/E cap 4096, 50 A, r_cut 10, tol 1e-3
    ("sweep", (4096, 3, 12288, K_MUVT, 2), dict(use_act=True), "global"),
    ("sweep", (4096, 3, 12288, K_MUVT, 2), dict(use_act=True, tmmc=True),
     "global"),
    # 6859 waters at tol 1e-5: dense and on slabs; at the flagship's Ewald
    ("sweep", (6859, 3, 20736, K_BULK, 2), {}, "global_k"),
    ("sweep", (6859, 3, 33377, K_BULK, 2), dict(slab=True), "global_k"),
    ("sweep", (6859, 3, 33408, 2874, 2), dict(slab=True), "global"),
    # Gibbs: bench's recipe at cap 1024 (boxes 29.45 / 36.0 A, r_cut 7.5,
    # tuned at the 41.64 A box a volume move can reach), the NPT-Gibbs
    # CO2/N2 launch (K 3796, nk 12, 206,404 B: it fits), the flagship
    ("gibbs", (1024, 3, 3072, K_GIBBS, 2, NK_GIBBS), {}, "global"),
    ("gibbs", (112, 3, 512, 3796, 4, 12), {}, "shared"),
    ("gibbs", (128, 3, 384, 783, 2, 7), {}, "shared"),
    ("gibbs", (64, 3, 192, 9000, 2, 16), {}, "global_k"),
    # semigrand: bench's recipe at 16x the volume (50.4 A, r_cut 8)
    ("flip", (2048, 3, 3, 6144, K_SG, 2, NK_SG), {}, "global"),
    ("flip", (128, 3, 3, 384, 337, 2, 5), {}, "shared"),
    ("flip", (64, 3, 3, 192, 12000, 2, 20), {}, "global_k"),
]
CHOOSERS = {"sweep": (sweep_op.choose_layout, sweep_op.smem_bytes),
            "gibbs": (gibbs_op.choose_layout, gibbs_op.gibbs_smem_bytes),
            "flip": (flip_op.choose_layout, flip_op.flip_smem_bytes)}


@pytest.mark.parametrize("kernel,args,kw,want", CHOICES,
                         ids=lambda x: str(x).replace(" ", ""))
def test_choose_layout_takes_the_first_that_fits(kernel, args, kw, want):
    choose, nbytes = CHOOSERS[kernel]
    assert choose(*args, **kw) == want
    size_kw = {k: v for k, v in kw.items() if k != "slab"}
    sizes = [nbytes(*args, **size_kw, layout=lay) for lay in LAYOUTS]
    i = LAYOUTS.index(want)
    first = 1 if kw.get("slab") else 0          # slabs never run shared
    assert sizes[i] <= LIMIT and all(s > LIMIT for s in sizes[first:i])
    # the last layout can be forced; one that does not fit is refused with
    # its byte count
    assert choose(*args, **kw, layout="global_k") == "global_k"
    if i > first:
        with pytest.raises(ValueError, match=rf"needs {sizes[first]} B of "
                                             rf"shared memory"):
            choose(*args, **kw, layout=LAYOUTS[first])


@pytest.mark.parametrize("kernel,args", [
    ("sweep", (10, 16, 160, 10, 1000)),          # the LJ tables alone
    ("gibbs", (8, 16, 128, 10, 2, 127)),         # the eik tables alone
    ("flip", (8, 16, 16, 256, 10, 200, 127)),
])
def test_choose_layout_raises_only_on_the_fixed_part(kernel, args):
    choose, nbytes = CHOOSERS[kernel]
    fixed = nbytes(*args, layout="global_k")
    assert fixed > LIMIT
    with pytest.raises(ValueError, match=rf"needs {fixed} B of shared "
                                         rf"memory in the global_k layout"):
        choose(*args)
    with pytest.raises(ValueError, match="layout must be"):
        choose(*args[:-1], 1, layout="dense")


# ---------------- over-limit states against the TPU interpreter --------

WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", use_lrc=False, p_translate=0.5, dr_max=0.25,
             dphi_max=0.3, strict_min_image=False)
BOX, CAP, N_INIT, C = 10.0, 8, 5, 2


def _tight(box, tol, r_cut=4.5):
    """WATER with the Ewald parameters of `tol` at this box."""
    kl, nk, ksq = tune_parameters(box, r_cut, tol)
    return dict(WATER, r_cut=r_cut, kappa_L=kl, nk=nk, ksq_max=ksq)


def _zero_uniforms(monkeypatch):
    monkeypatch.setattr(
        moves_t, "draw_uniforms",
        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(
        moves_t, "draw_exchange_uniforms",
        lambda c, n, gen, dev: torch.zeros((c, n, 8)))


def _plain_with_zero_scores(monkeypatch, module, name, n_stats, n_score,
                            mags, umags=None):
    """The op's plain version, which its wrapper runs for CPU tensors after
    choosing the layout, with all-zero scores (the interpreter's picks)
    and the terms' magnitudes kept aside."""
    plain = getattr(module, name)

    def twin(*a, **k):
        out = plain(*a, magnitude=True, scores=torch.zeros(n_score(a, k)),
                    **k)
        mags.append(out[4][:, n_stats])
        if umags is not None:
            umags.append(out[10])
            out = out[:10]
        return out[:4] + (out[4][:, :n_stats],) + out[5:]

    monkeypatch.setattr(module, name, twin)


def _sweep_scores(a, k):
    """(C, n_exch, M_total) deletion scores of a sweep_plain call."""
    n_exch = a[12] if len(a) > 12 else k.get("n_exch", 0)
    return a[0].shape[0], n_exch, a[1].shape[1]


def _assert_energies(e_t, e_j, e0, mags, floor=None):
    """The carried energy deltas within 2e-5 of the summed term
    magnitudes (at least `floor`)."""
    mag = torch.stack(mags).sum(0).numpy()
    mag = mag if mag.ndim == e0.ndim else mag[:, None]
    if floor is not None:
        mag = np.maximum(mag, floor)
    d_t, d_j = e_t - e0, e_j - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)


def _assert_sfac(s_t, s_j):
    np.testing.assert_allclose(s_t, s_j, atol=1e-4 * max(1.0, np.abs(s_j)
                                                         .max()))


def test_muvt_over_the_shared_limit_matches_jax(monkeypatch):
    kw = _tight(BOX, 1e-9)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    system = water_t.spce_system(CAP)
    K = len(make_kvectors(params_t.nk, params_t.ksq_max)[0])
    # over the shared limit: today's port refused this state
    assert sweep_op.choose_layout(CAP, 3, system.n_atoms_padded, K, 2,
                                  use_act=True) != "shared"
    g_j = gcmc_j.MolGCMC(water_j.spce_system(CAP), params_j, activity=2e-4,
                         p_exchange=0.3, dtype=jnp.float32,
                         mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(0), box=BOX, n_init=N_INIT,
                    n_chains=C)
    mags = []
    _zero_uniforms(monkeypatch)
    _plain_with_zero_scores(monkeypatch, sweep_op, "sweep_plain",
                            sweep_op.N_STATS, _sweep_scores, mags)
    g_t = gcmc_t.MolGCMC(system, params_t, activity=2e-4, p_exchange=0.3,
                         dtype=F32, mega="full", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    st = bridge.gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 22)
    st2 = g_t.run_steps(st, 22)
    assert len(mags) == 2                        # 2 cycles, one call each
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    assert int(st2.acc[:, 2].sum()) > 0          # insertions were accepted
    _assert_energies(st2.energy.numpy(), np.asarray(st_j2.energy), e0, mags)
    _assert_sfac(st2.sfac.numpy(), np.asarray(st_j2.sfac))
    _, stats = g_t.run_block(st2, 0)
    assert stats["sfac_err_max"] < 1e-4 and stats["drift_max_rel"] < 2e-3


def test_tmmc_over_the_shared_limit_matches_jax(monkeypatch):
    kw = _tight(BOX, 1e-9)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    system = water_t.spce_system(CAP)
    K = len(make_kvectors(params_t.nk, params_t.ksq_max)[0])
    assert sweep_op.choose_layout(CAP, 3, system.n_atoms_padded, K, 2,
                                  use_act=True, tmmc=True) != "shared"
    init_j, run_j, _ = gcmc_j.make_gcmc_mol(
        water_j.spce_system(CAP), params_j, activity=2e-4, p_exchange=0.3,
        dtype=jnp.float32, tmmc=True, mega="interpret_full")
    st_j = init_j(jax.random.PRNGKey(0), box=BOX, n_init=N_INIT, n_chains=C)
    eta = np.zeros(CAP + 1)
    st_j2, cm_j, uh_j = run_j(st_j, eta, 22)
    mags, umags = [], []
    _zero_uniforms(monkeypatch)
    _plain_with_zero_scores(monkeypatch, sweep_op, "sweep_plain",
                            sweep_op.N_STATS, _sweep_scores, mags, umags)
    tm = TMMCMol(system, params_t, activity=2e-4, p_exchange=0.3, dtype=F32,
                 mega="full", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    st = bridge.gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")
    e0 = st.energy.numpy().copy()
    st2, cm, uh = tm._run_steps(st, eta, 22)
    assert len(mags) == 2
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    _assert_energies(st2.energy.numpy(), np.asarray(st_j2.energy), e0, mags)
    _assert_sfac(st2.sfac.numpy(), np.asarray(st_j2.sfac))
    cm_j, uh_j = np.asarray(cm_j, np.float64), np.asarray(uh_j, np.float64)
    cm, uh = cm.double().numpy(), uh.double().numpy()
    count = uh_j[..., 0]
    np.testing.assert_array_equal(uh[..., 0], count)
    assert count.sum() == C * 2 * 3              # x_per = 3 per cycle
    assert (np.abs(cm - cm_j).max(-1) <= 1e-4 * count).all()
    _, stats = tm.run_block(st2, 0, update_bias=False)
    assert stats["sfac_err_max"] < 1e-4 and stats["drift_max_rel"] < 2e-3


def test_gibbs_over_the_shared_limit_matches_jax(monkeypatch):
    boxes = (11.0, 13.0)
    kw = dict(_tight(boxes[1], 1e-6), p_volume=0.0)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    system = water_t.spce_system(CAP)
    K = len(make_kvectors(params_t.nk, params_t.ksq_max)[0])
    assert gibbs_op.choose_layout(CAP, 3, system.n_atoms_padded, K, 2,
                                  params_t.nk) != "shared"
    g_j = gibbs_j.MolGibbsEnsemble(water_j.spce_system(CAP), params_j,
                                   p_transfer=0.4, dtype=jnp.float32,
                                   mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(4), boxes=boxes, n_init=(6, 2),
                    n_chains=C)
    mags = []
    _zero_uniforms(monkeypatch)
    _plain_with_zero_scores(
        monkeypatch, gibbs_op, "sweep_gibbs_plain", gibbs_op.N_STATS,
        lambda a, k: (a[0].shape[0], a[12] if len(a) > 12
                      else k.get("n_exch", 0), 2 * a[1].shape[2]), mags)
    g_t = gibbs_t.MolGibbsEnsemble(system, params_t, p_transfer=0.4,
                                   dtype=F32, mega="full", device="cpu")
    st = bridge.mol_gibbs_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 27)
    st2 = g_t.run_steps(st, 27)
    assert len(mags) == 1                        # one cycle, one launch
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    assert int(st2.acc[:, 3].sum()) > 0          # transfers were accepted
    _assert_energies(st2.energy.numpy(), np.asarray(st_j2.energy), e0, mags)
    _assert_sfac(st2.sfac.numpy(), np.asarray(st_j2.sfac))
    _, stats = g_t.run_block(st2, 0)
    assert stats["sfac_err_max"] < 1e-4 and stats["drift_max_rel"] < 2e-3


def test_semigrand_over_the_shared_limit_matches_jax(monkeypatch):
    kw = _tight(BOX, 1e-11)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    system = water_t.spce_two_blocks(CAP, CAP)
    K = len(make_kvectors(params_t.nk, params_t.ksq_max)[0])
    assert flip_op.choose_layout(2 * CAP, 3, 3, system.n_atoms_padded, K, 2,
                                 params_t.nk) != "shared"
    g_j = sg_j.Semigrand(water_two_blocks(CAP, CAP), params_j,
                         fugacity_ratio=2.0, dtype=jnp.float32,
                         mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(2), box=BOX, n_a=5, n_b=3,
                    n_chains=C)
    mags = []
    _zero_uniforms(monkeypatch)
    _plain_with_zero_scores(
        monkeypatch, flip_op, "flip_plain", flip_op.N_STATS,
        lambda a, k: (a[1].shape[0], a[8].shape[1], a[1].shape[1]), mags)
    g_t = sg_t.Semigrand(system, params_t, fugacity_ratio=2.0, dtype=F32,
                         mega="full", device="cpu")
    st = bridge.semigrand_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 22)
    st2 = g_t.run_steps(st, 22)
    assert len(mags) >= 1
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    assert int(st2.acc[:, 2:].sum()) > 0         # flips were accepted
    # the sweeps' energy terms are of the flips' order at these sizes
    _assert_energies(st2.energy.numpy(), np.asarray(st_j2.energy), e0, mags,
                     floor=np.abs(e0))
    _assert_sfac(st2.sfac.numpy(), np.asarray(st_j2.sfac))
    _, stats = g_t.run_block(st2, 0)
    assert stats["sfac_err_max"] < 1e-4 and stats["drift_max_rel"] < 2e-3
