"""The comparison that decides `correct`.

For every block of the window and a sample of its chains drawn from the
seed, the harness keeps what the timed path produced at the block end:
the configuration (centres of mass, quaternions, boxes, active slots),
the site coordinates the kernels keep, the energy and S(k) the kernels
carried to the block end (and, where a volume move closes the block, into
that move), and the energy and S(k) of the block-end recompute.  The
configuration's plain reference (reference/) rebuilds the sites from the
centres and quaternions and computes energy and S(k) in float64; the
numbers compared are the widest gaps:

  coords      the kept sites against the reference's, Angstrom;
  e_carried   |E carried - E ref| / max(|E ref|, |E self|, 1), E self
              the Ewald self term: the scale of the terms a float32 sum
              carries (a box of few molecules nets a small E ref, on
              which pairs at the cutoff, which float32 and float64 may
              count on either side, would read large);
  sk_carried  max over k of |S carried - S ref| / sqrt(sum q^2) of the
              configuration's charges;
  e_resync, sk_resync   the same for the block-end recompute;
  v_total     (two-box cells) |V_0 + V_1 - V_total| / V_total, the total
              volume of the configuration, which volume exchanges keep;

  acc_trans, acc_rot, acc_vol, acc_xfer   per kind of move (translation,
              rotation, volume, Gibbs transfer): |r / p - 1|, r the share
              of the window's attempts of that kind that all chains
              accepted (the program's counters), p what the acceptance
              reference (the configuration's "acceptance" module) expects
              over the same blocks: for each block the mean of its
              expectation at the sampled chains' states before and after
              the block, then the mean over blocks (each block attempts
              alike);

and exact counts (limit 0): the chains whose attempt counters differ from
the count the harness made of what each block asked for, and (two-box
cells) those whose total number of molecules changed.

The control (`control_numbers`) puts the reference computed in TF32 in
the program's place: its sites, energy and S(k) (and boxes rounded to
TF32) are judged by the same numbers.
"""

import math

import torch

from benchmark import spec
from benchmark.reference.rigid_ewald import Precision

NUMBERS = ("coords", "e_carried", "sk_carried", "e_resync", "sk_resync",
           "v_total", "acc_trans", "acc_rot", "acc_vol", "acc_xfer")


def _gaps(row, ref, q_s):
    """The widest gaps of one captured block against the reference's
    evaluation ref; `row` holds the program's (or the control's) values."""
    act = row["active"]
    site_on = None if act is None else act[:, :, None]
    d = (row["coords"].double() - ref["sites"].double()).abs().amax(-1)
    if site_on is not None:
        d = torch.where(site_on, d, 0.0)
    out = {"coords": float(d.max())}
    e_ref = ref["energy"].double()
    scale_e = torch.maximum(e_ref.abs(), ref["self_energy"].double().abs()) \
        .clamp_min(1.0)
    n_mol = row["com"].shape[1] if act is None else act.sum(1).double()
    q2 = float((q_s.double() ** 2).sum())
    scale_s = torch.sqrt(torch.as_tensor(n_mol * q2, dtype=torch.float64,
                                         device=e_ref.device)).clamp_min(1.0)
    s_ref = ref["sfac"].double()
    for tag in ("carried", "resync"):
        if f"e_{tag}" not in row:
            continue
        e = row[f"e_{tag}"].double()
        out[f"e_{tag}"] = float(((e - e_ref).abs() / scale_e).max())
        ds = torch.linalg.vector_norm(row[f"sk_{tag}"].double() - s_ref,
                                      dim=-1).amax(-1)
        out[f"sk_{tag}"] = float((ds / scale_s).max())
    return out


def _v_total(volumes, v_total):
    """volumes (B, 2) of the two boxes."""
    return float((volumes.double().sum(1) - v_total).abs().max() / v_total)


def _merge(into, part):
    for k, v in part.items():
        into[k] = max(into.get(k, 0.0), v) if math.isfinite(v) \
            else math.inf


def program_numbers(rows, config):
    """The numbers of the program's captured blocks (module docstring)."""
    ref_mod = spec.reference(config["reference"])
    model, params = config["model"], config["params"]
    f64 = Precision("float64")
    q_s = torch.tensor([s["charge"] for s in model["sites"]])
    out = {}
    for row in rows:
        ref = ref_mod.evaluate(row["com"], row["quat"], row["box"],
                               row["active"], model, params, f64)
        _merge(out, _gaps(row, ref, q_s.to(row["com"].device)))
        if "boxes" in row:
            _merge(out, {"v_total": _v_total(row["boxes"].double() ** 3,
                                             _config_volume(config))})
    return out


def control_numbers(rows, config):
    """The same numbers with the reference computed in TF32 in the
    program's place, on the program's configurations."""
    ref_mod = spec.reference(config["reference"])
    model, params = config["model"], config["params"]
    f64, tf32 = Precision("float64"), Precision("tf32")
    q_s = torch.tensor([s["charge"] for s in model["sites"]])
    out = {}
    for row in rows:
        args = (row["com"], row["quat"], row["box"], row["active"], model,
                params)
        ref = ref_mod.evaluate(*args, f64)
        ctl = ref_mod.evaluate(*args, tf32)
        fake = dict(row, coords=ctl["sites"], e_carried=ctl["energy"],
                    sk_carried=ctl["sfac"])
        if "e_resync" in row:
            fake.update(e_resync=ctl["energy"], sk_resync=ctl["sfac"])
        _merge(out, _gaps(fake, ref, q_s.to(row["com"].device)))
        if "boxes" in row:
            b = tf32.r(row["boxes"])
            vol = tf32.r(tf32.r(b * b) * b)
            _merge(out, {"v_total": _v_total(tf32.r(vol[:, 0] + vol[:, 1])
                                             [:, None],
                                             _config_volume(config))})
    return out


def acceptance_numbers(info, config, seed):
    """(numbers, readings) of the acceptance check (module docstring):
    info is the cell's `acceptance()`; readings maps each kind to its
    realized share r, expected share p, and the reading of a sampler that
    accepts every move, |1 / p - 1|."""
    ref = spec.reference(config["acceptance"])
    states = info["states"]
    gen = ref.seeded(seed, states[0]["com"].device)
    per_state = [ref.expected(info["ensemble"], st, config, info["moves"],
                              info["trials"], gen) for st in states]
    numbers, readings = {}, {}
    for kind in per_state[0]:
        p = sum(0.5 * (a[kind] + b[kind]) for a, b in
                zip(per_state[:-1], per_state[1:])) / (len(states) - 1)
        acc, att = info["realized"][kind]
        r = acc / att if att else math.nan
        if p > 0.0:
            numbers[f"acc_{kind}"] = abs(r / p - 1.0)
        else:
            numbers[f"acc_{kind}"] = 0.0 if r == 0.0 else math.inf
        readings[kind] = {"realized": r, "expected": p,
                          "accept_all": abs(1.0 / p - 1.0) if p > 0.0
                          else math.inf}
    return numbers, readings


def _config_volume(config):
    return float(sum(b ** 3 for b in config["boxes"]))


def judge(numbers, exact, limits):
    """(correct, checked): every number within its limit and every exact
    count 0.  checked maps each name to {"value", "limit"}, numbers first,
    then the exact counts summed over blocks."""
    checked, ok = {}, True
    for name in NUMBERS:
        if name not in numbers:
            continue
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in this cell's limits")
        lim = float(limits[name]["limit"])
        v = numbers[name]
        ok = ok and math.isfinite(v) and v <= lim
        checked[name] = {"value": v, "limit": lim}
    for name, per_block in exact.items():
        v = int(sum(per_block))
        ok = ok and v == 0
        checked[name] = {"value": v, "limit": 0}
    return ok, checked
