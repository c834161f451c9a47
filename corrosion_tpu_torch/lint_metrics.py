"""The metric-name drift lint over the port's tree: the counterpart of
the JAX package's `scripts/lint_metrics.py`, with the same module API
(`scan_call_sites` / `parse_components_table` / `lint`) over
`corrosion_tpu_torch/` against the COMPONENTS.md observability table.
The rule itself is `metrics-doc` in `corrosion_tpu_torch.analysis`.

Usage:  python -m corrosion_tpu_torch.lint_metrics   (exit 0 clean / 1 drift)
"""

from __future__ import annotations

import sys
from typing import Dict, List, Set, Tuple

from corrosion_tpu_torch.analysis import metricsdoc
from corrosion_tpu_torch.analysis.core import repo_root

REPO = repo_root()


def scan_call_sites() -> Tuple[Dict[str, Set[str]], List[str]]:
    return metricsdoc.scan_call_sites(REPO)


def parse_components_table() -> List[str]:
    return metricsdoc.parse_components_table(REPO)


def lint() -> List[str]:
    return metricsdoc.lint(REPO)


def main() -> None:
    problems = lint()
    if problems:
        for p in problems:
            print(f"lint_metrics: {p}")
        print(f"lint_metrics: {len(problems)} problem(s)")
        sys.exit(1)
    literals, wildcards = scan_call_sites()
    print(
        f"lint_metrics: OK — {len(literals)} literal series + "
        f"{len(wildcards)} wildcard site(s) match the COMPONENTS.md table"
    )
    sys.exit(0)


if __name__ == "__main__":
    main()
