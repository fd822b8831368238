"""Time the port's two S(k) routes on the card at the shapes its
recomputes call them with: ops/ewald.py structure_factor_recurrence (the
eik recurrence) against structure_factor_direct, chunk by chunk.

    python3 scripts/time_structure_factor.py [--profile]

For each shape it prints the card, the ms per recompute's worth of calls
(every chunk of boxes once; CUDA events around 3 repetitions, in turns:
recurrence, direct, direct, recurrence) of both routes, and each route's
float32 error against the float64 direct sum on the first chunk, as a
fraction of that chunk's largest |S(k)|.  The shapes: the flagship's
block-end recompute (750 SPC/E, 2250 atoms, K 337, 2048 chains in
MonteCarlo's recompute chunks of 8), chip_smoke.py phase 13 (SPC/E cap
128: 384 atoms, K 783, 2048 boxes in chunks of 128), and at phase 20's
CO2/N2 96 + 16 (A_pad 512, 2048 boxes in chunks of 64) every nk from 8
(K 1152, the NVT Ewald) to 12 (K 3796, the NPT-Gibbs Ewald):
ops/ewald.py RECURRENCE_MIN_K is set from where the two cross.  With
--profile it also prints torch.profiler's device time by operator of
one chunk's call of each route at phase 13's shape.
"""

import argparse
import functools
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from metropolismontecarlo_tpu_torch.ops import ewald  # noqa: E402

SHAPES = (("phase 3 flagship (750 SPC/E)", 2250, 28.24, 5, 27, 2048, 8),
          ("phase 13 (SPC/E cap 128)", 384, 20.813, 7, 50, 2048, 128)) \
    + tuple((f"phase 20 CO2/N2 96 + 16, nk {nk}", 512, 37.8, nk,
             nk * nk + 1, 2048, 64) for nk in range(8, 13))


def _ms(fn, reps=3):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_chunk(kv, coords, q, b, bounds):
    from torch.profiler import ProfilerActivity, profile

    for fn in (functools.partial(ewald.structure_factor_recurrence,
                                 bounds=bounds),
               ewald.structure_factor_direct):
        fn(coords, q, kv, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(coords, q, kv, b)
            torch.cuda.synchronize()
        print(f"{getattr(fn, 'func', fn).__name__}, one chunk of {coords.shape[0]} boxes:")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=14))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_structure_factor: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, A, box, nk, ksq, boxes, chunk in SHAPES:
        kv_host = ewald.make_kvectors(nk, ksq)[0]
        kv = torch.tensor(kv_host, device=dev)
        bounds = ewald.k_bounds(kv_host)
        coords = torch.rand((boxes, A, 3), generator=gen, device=dev) * box
        q = torch.randn((A,), generator=gen, device=dev)
        b = torch.full((boxes,), box, device=dev)

        def run(fn):
            for c0 in range(0, boxes, chunk):
                fn(coords[c0:c0 + chunk], q, kv, b[c0:c0 + chunk])

        direct = ewald.structure_factor_direct

        def rec(*a):
            return ewald.structure_factor_recurrence(*a, bounds)

        turns = [_ms(lambda: run(fn)) for fn in (rec, direct, direct, rec)]
        ms_rec, ms_dir = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        ref = direct(coords[:chunk].double(), q.double(), kv,
                     b[:chunk].double())
        err = [float((fn(coords[:chunk], q, kv, b[:chunk]).double() - ref)
                     .abs().max() / ref.abs().max()) for fn in (rec, direct)]
        print(f"{name}: A {A}, K {len(kv)}, {boxes} boxes in chunks of "
              f"{chunk}: recurrence {ms_rec:.3f} ms, direct {ms_dir:.3f} "
              f"ms (in turns: {', '.join(f'{t:.3f}' for t in turns)}); "
              f"f32 error {err[0]:.2e} (recurrence), {err[1]:.2e} (direct) "
              f"of the largest |S(k)|")
        if args.profile and name == SHAPES[1][0]:
            profile_chunk(kv, coords[:chunk], q, b[:chunk], bounds)


if __name__ == "__main__":
    main()
