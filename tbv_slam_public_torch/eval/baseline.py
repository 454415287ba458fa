"""Result aggregation across sweep jobs (the 1_baseline analogue).

Collects per-job ``{est,odom}/result.txt`` files under a sweep output tree
(evaluation/1_baseline/1_baseline.py:31-107 semantics) into a tidy table,
prints fixed-width text and LaTeX, and computes the mean row — the Tab I/II
generator of the paper.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from . import kitti

COLUMNS = ("Trans.err.(%)", "Rot.err.(deg/100m)", "ATE(m)", "RPE(m)")


def collect_jobs(root: str, sub: str = "est") -> List[Dict[str, float]]:
    rows = []
    for res in sorted(glob.glob(os.path.join(root, "job_*", sub,
                                             "result.txt"))):
        job = os.path.basename(os.path.dirname(os.path.dirname(res)))
        row = dict(kitti.read_result(res))
        row["job"] = job
        rows.append(row)
    return rows


def summary_table(rows: List[Dict[str, float]],
                  columns=COLUMNS) -> List[List[str]]:
    table = [["job"] + list(columns)]
    for r in rows:
        table.append([str(r.get("job", "?"))] +
                     [f"{r.get(c, float('nan')):.3f}" for c in columns])
    if rows:
        means = [np.nanmean([r.get(c, np.nan) for r in rows])
                 for c in columns]
        table.append(["mean"] + [f"{m:.3f}" for m in means])
    return table


def format_text(table: List[List[str]]) -> str:
    widths = [max(len(row[i]) for row in table) for i in range(len(table[0]))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("-" * (sum(widths) + 2 * (len(widths) - 1)))
    return "\n".join(lines)


def format_latex(table: List[List[str]]) -> str:
    cols = "l" + "r" * (len(table[0]) - 1)
    out = ["\\begin{tabular}{" + cols + "}", "\\toprule",
           " & ".join(table[0]) + " \\\\", "\\midrule"]
    for row in table[1:]:
        out.append(" & ".join(row) + " \\\\")
    out += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(out)


def write_baseline(root: str, out_path: Optional[str] = None) -> str:
    """Aggregate est + odom results under a sweep tree into one report."""
    parts = []
    for sub, label in (("est", "TBV SLAM (est)"), ("odom", "Odometry")):
        rows = collect_jobs(root, sub)
        if not rows:
            continue
        table = summary_table(rows)
        parts.append(f"== {label} ==")
        parts.append(format_text(table))
        parts.append("")
        parts.append(format_latex(table))
        parts.append("")
    report = "\n".join(parts)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(report)
    return report
