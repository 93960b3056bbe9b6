"""The port's own copy of `deeplearning4j_tpu/eval/tools.py` (numpy only;
the port imports nothing of the JAX package).

Evaluation rendering.

Reference: `deeplearning4j-core/evaluation/EvaluationTools.java`
(329 LoC): export ROC and calibration charts as self-contained HTML.
Charts here are inline SVG (no external assets), one file per export.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _svg_curve(xs, ys, *, width=480, height=400, label="", diagonal=True):
    pts = []
    for x, y in zip(xs, ys):
        px = 50 + float(x) * (width - 70)
        py = height - 40 - float(y) * (height - 70)
        pts.append(f"{px:.1f},{py:.1f}")
    diag = ""
    if diagonal:
        diag = (f'<line x1="50" y1="{height - 40}" x2="{width - 20}" y2="30" '
                f'stroke="#bbb" stroke-dasharray="4"/>')
    return (f'<svg width="{width}" height="{height}">'
            f'<rect width="{width}" height="{height}" fill="#fcfcfc" '
            f'stroke="#ddd"/>{diag}'
            f'<polyline fill="none" stroke="#c33" stroke-width="2" '
            f'points="{" ".join(pts)}"/>'
            f'<text x="55" y="20" font-size="13">{label}</text></svg>')


def _page(title: str, body: str) -> str:
    return (f"<!doctype html><html><head><title>{title}</title></head>"
            f"<body style='font-family:sans-serif'><h2>{title}</h2>"
            f"{body}</body></html>")


class EvaluationTools:
    @staticmethod
    def roc_chart_html(roc) -> str:
        """ROC → standalone HTML (reference `rocChartToHtml`)."""
        fpr, tpr = roc.get_roc_curve()
        auc = roc.calculate_auc()
        return _page("ROC curve",
                     _svg_curve(fpr, tpr, label=f"AUC = {auc:.4f}"))

    @staticmethod
    def export_roc_charts_to_html_file(roc, path):
        Path(path).write_text(EvaluationTools.roc_chart_html(roc))

    @staticmethod
    def calibration_chart_html(calibration, num_classes: int) -> str:
        parts = []
        for c in range(num_classes):
            mids, frac = calibration.reliability_diagram(c)
            ece = calibration.expected_calibration_error(c)
            parts.append(f"<h3>Class {c}</h3>")
            parts.append(_svg_curve(mids, frac,
                                    label=f"reliability (ECE {ece:.4f})"))
        return _page("Calibration", "".join(parts))

    @staticmethod
    def export_calibration_to_html_file(calibration, num_classes, path):
        Path(path).write_text(
            EvaluationTools.calibration_chart_html(calibration, num_classes))
