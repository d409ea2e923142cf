"""Refit saved stage-2 shared-DOF traces with both packages' ``fit_expfit``.

    python scripts/c2_refit_witness.py TRACES.npz [--perturb 1e-15] [--seeds 4]

``TRACES.npz`` is what ``chip_smoke.py --keep-traces DIR`` saves: the
stage-2 traces of the rank whose comm-free rel-L2 departs most and of the
median rank, with the fit's settings. Each trace goes through stage 3's
fit as both packages run it (modal basis of the training rows, then
``fit_expfit`` on the modal coefficients) in float64 on the CPU, plainly
and with the trace perturbed by a seeded relative noise of ``--perturb``.
Printed per rank, as one JSON line each:

- ``packages``: savtpu against savtpu_torch on the same trace: the
  largest relative difference of the fitted poles and amplitudes, and of
  the model's extrapolation over the rows after the training cut;
- ``perturbed_<package>``: the same readings between the plain fit and
  each perturbed fit of one package (the worst over the seeds);
- ``extrapolation_rel_err``: the plain fit's extrapolation against the
  trace itself over those rows.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from savtpu.models import expfit as j_expfit  # noqa: E402
from savtpu.models import modal as j_modal  # noqa: E402
from savtpu_torch.models import expfit as t_expfit  # noqa: E402
from savtpu_torch.models import modal as t_modal  # noqa: E402

PACKAGES = {"savtpu": (j_expfit, j_modal), "savtpu_torch": (t_expfit, t_modal)}


def fit(pkg, trace, meta):
    """Stage 3's fit of one rank's (D, T) trace; returns (params, the
    model's rows after the cut, the modal rows after the cut)."""
    expfit, modal = PACKAGES[pkg]
    tr = np.asarray(trace, np.float64).T            # (T, D)
    T = tr.shape[0]
    cut = int(meta["cut_off"] * T)
    co = tr
    if meta["modal_dim"]:
        mu, basis = modal.modal_basis(tr[:cut], int(meta["modal_dim"]))
        co = modal.to_modal(tr, mu, basis)
    se = max(int(meta["save_every"]), 1)
    ramp_s = float(meta["expfit_ramp_s"])
    ramp_end_row = ramp_s / (float(meta["dt"]) * se) if ramp_s > 0 else 0.0
    params, _ = expfit.fit_expfit(co[:cut], ramp_end_row,
                                  order=int(meta["expfit_order"]))
    rows = np.arange(cut, T, dtype=float)
    return params, expfit.eval_expfit(params, rows, ramp_end_row), co[cut:]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def compare(fa, fb):
    """Largest relative difference of the params (by key) and of the
    extrapolated rows."""
    pa, ya, _ = fa
    pb, yb, _ = fb
    return {"params_max_rel": max(rel(pa[k], pb[k]) for k in pb),
            "extrapolation_rel_l2": float(np.linalg.norm(ya - yb)
                                          / max(np.linalg.norm(yb), 1e-300))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", type=Path)
    ap.add_argument("--perturb", type=float, default=1e-15)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    z = np.load(args.traces)
    meta = {k: z[k].item() for k in ("dt", "save_every", "expfit_ramp_s",
                                     "cut_off", "modal_dim", "expfit_order")}
    for which in ("departing", "median"):
        trace = z[f"trace_{which}"]
        plain = {pkg: fit(pkg, trace, meta) for pkg in PACKAGES}
        out = {"rank": int(z[f"rank_{which}"]), "which": which,
               "trace_shape": list(trace.shape),
               "packages": compare(plain["savtpu"], plain["savtpu_torch"])}
        _, y, truth = plain["savtpu_torch"]
        out["extrapolation_rel_err"] = float(
            np.linalg.norm(y - truth) / max(np.linalg.norm(truth), 1e-300))
        for pkg in PACKAGES:
            worst = {"params_max_rel": 0.0, "extrapolation_rel_l2": 0.0}
            for seed in range(args.seeds):
                rng = np.random.default_rng(seed)
                noisy = trace * (1.0 + args.perturb
                                 * rng.standard_normal(trace.shape))
                c = compare(fit(pkg, noisy, meta), plain[pkg])
                worst = {k: max(worst[k], c[k]) for k in worst}
            out[f"perturbed_{pkg}"] = worst
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
