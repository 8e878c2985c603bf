"""Paired per-frame analysis of an ensemble_benchmark --compare run.

The port's copy of `scripts/ablation_analysis.py` (numpy only; its printed
output is the JAX script's, character for character). Reads the per-variant
arrays `errs__<variant>` / `picks__<variant>` that
`cppf2_torch/scripts/ensemble_benchmark.py` (and the JAX package's) saves in
`errors_<category>.npz` and reports,
for a pair of variants, which frames changed bucket: fixed / broken /
unchanged, split by error regime (near-miss 5-8deg, gross >30deg) and by
handle visibility — the diagnostic view used for the round-4 mug yaw-sweep
ablation.

    python -m cppf2_torch.scripts.ablation_analysis benchmarks/r4_yaw_mug/errors_mug.npz \
        [--a yaw_sweep_True --b yaw_sweep_False]
"""

import argparse

import numpy as np


def bucket(deg, cm):
    if deg < 5 and cm < 5:
        return "hit"
    if deg < 5:
        return "trans(cm>5)"   # rotation fine — pure translation failure
    if deg < 8:
        return "near(5-8)"
    if deg < 30:
        return "mid(8-30)"
    return "gross(30+)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--a", default=None, help="variant slug (treatment)")
    ap.add_argument("--b", default=None, help="variant slug (control)")
    args = ap.parse_args(argv)

    d = np.load(args.npz)
    # keep the npz's insertion order == the run's --compare order (sorted()
    # would alphabetize, silently swapping treatment and control for e.g.
    # --compare yaw_sweep=True yaw_sweep=False)
    slugs = [k[len("errs__"):] for k in d.files if k.startswith("errs__")]
    if not slugs:
        raise SystemExit("no per-variant arrays in this npz (single-variant "
                         f"run?). keys: {d.files}")
    a = args.a or slugs[0]
    b = args.b or (slugs[1] if len(slugs) > 1 else slugs[0])
    ea, eb = d[f"errs__{a}"], d[f"errs__{b}"]
    hv = d["handle_visible"] if "handle_visible" in d.files else \
        np.ones(len(ea), np.int64)

    oka = (ea[:, 0] < 5) & (ea[:, 1] < 5)
    okb = (eb[:, 0] < 5) & (eb[:, 1] < 5)
    print(f"treatment {a}: 5d5cm {oka.mean():.2f}  "
          f"(median {np.median(ea[:, 0]):.2f} deg / {np.median(ea[:, 1]):.2f} cm)")
    print(f"control   {b}: 5d5cm {okb.mean():.2f}  "
          f"(median {np.median(eb[:, 0]):.2f} deg / {np.median(eb[:, 1]):.2f} cm)")
    fixed = oka & ~okb
    broke = ~oka & okb
    print(f"\nfixed {fixed.sum()}  broken {broke.sum()}  "
          f"(net {int(fixed.sum()) - int(broke.sum()):+d} frames)")

    for name, sel in (("fixed", fixed), ("broken", broke)):
        if not sel.any():
            continue
        print(f"\n{name} frames (control -> treatment):")
        for i in np.flatnonzero(sel):
            print(f"  #{i:3d}  {eb[i, 0]:7.2f}deg/{eb[i, 1]:5.2f}cm "
                  f"[{bucket(*eb[i])}] -> {ea[i, 0]:7.2f}deg/{ea[i, 1]:5.2f}cm "
                  f"[{bucket(*ea[i])}]  handle_visible={int(hv[i])}")

    # bucket transition matrix
    buckets = ["hit", "trans(cm>5)", "near(5-8)", "mid(8-30)", "gross(30+)"]
    nb = len(buckets)
    mat = np.zeros((nb, nb), int)
    for i in range(len(ea)):
        mat[buckets.index(bucket(*eb[i])), buckets.index(bucket(*ea[i]))] += 1
    print("\ncontrol \\ treatment " + " ".join(f"{s:>11s}" for s in buckets))
    for r, s in enumerate(buckets):
        print(f"{s:>19s} " + " ".join(f"{mat[r, c]:11d}" for c in range(nb)))


if __name__ == "__main__":
    main()
