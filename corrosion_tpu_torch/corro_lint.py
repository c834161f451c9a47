"""corro-analyze for the port: run every static-analysis rule
over `corrosion_tpu_torch/`.

The one CLI for the port's AST-based checker suite
(`corrosion_tpu_torch/analysis/`): kernel-purity (host syncs inside the
CUDA-graph bodies and the `DEVICE_ROOTS` tick bodies and stats passes
of ops/), lane-parity, async-blocking, lock-discipline, codec-ext,
capture-parity, finalize-parity, metrics-doc, timeout-discipline,
actuator-discipline and profiler-safety, each scoped to the port's own
modules.  Wired into tier-1 via tests/test_torch_analysis.py, so a NEW
finding — or a STALE baseline entry — fails CI.

Usage (from the repo root; exit 0 clean, 1 findings, 2 unknown rule):
    python -m corrosion_tpu_torch.corro_lint              # every rule
    python -m corrosion_tpu_torch.corro_lint --rules a,b  # a subset
    python -m corrosion_tpu_torch.corro_lint -v           # also list
                                               # grandfathered findings
    python -m corrosion_tpu_torch.corro_lint --baseline   # re-bank
        ANALYSIS_BASELINE_TORCH.json (keeps justifications of surviving
        entries; NEW entries get an UNREVIEWED placeholder you must edit)

Suppression: `# corro: noqa[rule]` on the flagged line.  Baseline: only
for proven-benign findings, one-line justification each.
"""

from __future__ import annotations

import argparse
import sys
import time

from corrosion_tpu_torch.analysis import (
    AnalysisContext,
    all_checkers,
    load_baseline,
    run_analysis,
    save_baseline,
)
from corrosion_tpu_torch.analysis.core import BASELINE_FILE, repo_root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--baseline",
        action="store_true",
        help=f"re-bank current findings into {BASELINE_FILE}",
    )
    ap.add_argument(
        "--rules",
        help="comma-separated rule subset (default: all)",
    )
    ap.add_argument(
        "-v", "--verbose", action="store_true",
        help="also list baselined and suppressed findings",
    )
    args = ap.parse_args(argv)

    ctx = AnalysisContext(repo_root())
    checkers = all_checkers()
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")}
        known = {c.rule for c in checkers}
        unknown = wanted - known
        if unknown:
            print(
                f"corro_lint: unknown rule(s) {sorted(unknown)} — "
                f"available: {sorted(known)}"
            )
            return 2
        checkers = [c for c in checkers if c.rule in wanted]

    t0 = time.monotonic()
    baseline = load_baseline(ctx.root)
    result = run_analysis(ctx, checkers, baseline)
    elapsed = time.monotonic() - t0

    if args.baseline:
        fired = (
            result.new
            + [f for f, _ in result.baselined]
        )
        path = save_baseline(ctx.root, fired, baseline)
        print(
            f"corro_lint: banked {len(fired)} finding(s) to {path} — "
            "replace any UNREVIEWED justification before committing"
        )
        return 0

    for f in result.new:
        print(f"corro_lint: NEW {f.render()}")
    for key in result.stale_keys:
        print(
            f"corro_lint: STALE baseline entry no longer fires: {key} — "
            "run --baseline to shrink the grandfather list"
        )
    if args.verbose:
        for f, why in result.baselined:
            print(f"corro_lint: baselined {f.render()}  [{why}]")
        for f in result.suppressed:
            print(f"corro_lint: noqa'd {f.render()}")

    n_rules = len(checkers)
    if result.ok:
        print(
            f"corro_lint: OK — {n_rules} rule(s) clean in {elapsed:.2f}s "
            f"({len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed)"
        )
        return 0
    print(
        f"corro_lint: {len(result.new)} new finding(s), "
        f"{len(result.stale_keys)} stale baseline entr(ies) "
        f"in {elapsed:.2f}s"
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
