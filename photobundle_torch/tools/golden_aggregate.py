"""Aggregate the provenance-keyed golden tables of golden logs into the
multi-seed summary.

Twin of tools/golden_aggregate.py, which imports nothing of the JAX
package either; the port keeps its own copy, and it prints the same on
the same logs. The single-row noise floor of chaotic golden
configurations is ~10-19 ATE points, so claims rest on sign consistency
across error realizations, never on single-row margins. This tool parses
the "BASELINE.md table (...)" blocks that `golden_kitti` prints into
every log, groups rows by (provenance, frames, error model), and emits

  * the per-seed ATE-reduction matrix with means, and
  * each config's win/loss sign record against a baseline config
    (default W5_production) across realizations.

    python -m photobundle_torch.tools.golden_aggregate \
        [--logs 'benchlogs/r5g_sharp_*.log'] [--baseline W5_production]
"""

from __future__ import annotations

import argparse
import collections
import glob
import re
import sys

HDR = re.compile(
    r"BASELINE\.md table \((?P<model>\w+) error model(?:, seed "
    r"(?P<seed>\d+))?(?:, (?P<frames>\d+) frames)?, "
    r"init ATE (?P<init_ate>[\d.]+)")
PROV = re.compile(r"provenance (?P<prov>[\w./-]+)")
ROW = re.compile(
    r"^\| (?P<cfg>[-\w+= .]+?) \| (?P<ate>[\d.]+) \| (?P<red>[+-][\d.]+)% "
    r"\| (?P<rpet>[\d.]+) \| (?P<rper>[\d.]+) deg \|")


def parse_logs(paths):
    """Yield dicts {model, seed, frames, prov, cfg, ...} per table row."""
    for path in paths:
        model = seed = prov = frames = None
        with open(path, errors="replace") as fh:
            for line in fh:
                m = HDR.search(line)
                if m:
                    model = m.group("model")
                    seed = m.group("seed") or "99"
                    # Pre-round-5 headers omit the run's frame count;
                    # those logs group under frames='?'.
                    frames = m.group("frames") or "?"
                    prov = None
                    continue
                m = PROV.search(line)
                if m and model is not None and prov is None:
                    prov = m.group("prov")
                    continue
                m = ROW.match(line.strip())
                if m and model is not None:
                    yield dict(model=model, seed=seed, frames=frames,
                               prov=prov or "unkeyed",
                               cfg=m.group("cfg").strip(),
                               ate=float(m.group("ate")),
                               red=float(m.group("red")),
                               rpet=float(m.group("rpet")),
                               rper=float(m.group("rper")), log=path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="golden_aggregate")
    ap.add_argument("--logs", default="benchlogs/r5g_sharp_*.log",
                    help="glob of golden logs to aggregate")
    ap.add_argument("--baseline", default="W5_production",
                    help="config the sign test compares against")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(args.logs))
    if not paths:
        print(f"no logs match {args.logs!r}", file=sys.stderr)
        return 1
    rows = list(parse_logs(paths))
    if not rows:
        print("no golden tables found in the logs", file=sys.stderr)
        return 1

    # group[(prov, frames, model)][cfg][seed] -> the row from the
    # last-parsed log wins (glob order, i.e. lexicographic path order —
    # NOT chronological), and a DIFFERENT value for an already-seen cell
    # is flagged: it means two logs used the same config label for
    # different configurations (e.g. pre-round-5 --set runs, whose
    # overrides were not in the label). Frames is part of the group key
    # because golden_kitti's render-once cache gives a 60-frame and a
    # 100-frame run on the same root the SAME provenance key while their
    # init trajectories (and thus every reduction cell) differ.
    group = collections.defaultdict(
        lambda: collections.defaultdict(dict))
    for r in rows:
        cell = group[(r["prov"], r["frames"], r["model"])][r["cfg"]]
        old = cell.get(r["seed"])
        if old is not None and abs(old["red"] - r["red"]) > 1e-9:
            print(f"WARNING: colliding rows for {r['cfg']} seed "
                  f"{r['seed']} ({r['model']}): {old['red']:+.1f}% "
                  f"[{old['log']}] vs {r['red']:+.1f}% [{r['log']}] — "
                  f"keeping the LAST-PARSED log (lexicographic path "
                  f"order, not run time); disambiguate with a --set-"
                  f"suffixed label or a narrower --logs glob",
                  file=sys.stderr)
        cell[r["seed"]] = r

    for (prov, frames, model), cfgs in sorted(group.items()):
        seeds = sorted({s for c in cfgs.values() for s in c},
                       key=lambda s: int(s))
        logs = sorted({v["log"] for c in cfgs.values()
                       for v in c.values()})
        print(f"\n### {model} error model, {frames} frames — "
              f"provenance {prov} ({len(logs)} logs)")
        head = " | ".join(f"s{s}" for s in seeds)
        print(f"| Config | {head} | mean | vs {args.baseline} |")
        print("|---" * (len(seeds) + 3) + "|")
        base = cfgs.get(args.baseline, {})
        for cfg, per_seed in sorted(cfgs.items()):
            vals = [per_seed.get(s) for s in seeds]
            cells = [f"{v['red']:+.1f}%" if v else "—" for v in vals]
            got = [v["red"] for v in vals if v]
            mean = sum(got) / len(got)
            wins = losses = 0
            for s in seeds:
                if s in per_seed and s in base and cfg != args.baseline:
                    d = per_seed[s]["red"] - base[s]["red"]
                    wins += d > 0
                    losses += d < 0
            sign = ("(baseline)" if cfg == args.baseline
                    else f"{wins}W/{losses}L")
            print(f"| {cfg} | {' | '.join(cells)} | {mean:+.1f}% "
                  f"| {sign} |")
        n = len(seeds)
        print(f"\nSign-consistency bar: {n}/{n} same-direction results "
              f"(p = 1/{2 ** n} per config under symmetric noise); "
              f"single-row margins below ~20 points are inside the "
              f"measured backend-perturbation floor (BASELINE.md "
              f"'Backend A/B').")
    return 0


if __name__ == "__main__":
    sys.exit(main())
