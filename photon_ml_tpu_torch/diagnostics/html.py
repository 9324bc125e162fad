"""Diagnostic report -> self-contained HTML (counterpart of
``photon_ml_tpu/diagnostics/html.py``).

Rebuild of ``diagnostics/reporting/html/*.scala`` (render strategies per
physical-report node) collapsed into one pass: chapters per model, sections
per diagnostic, tables for numbers, and dependency-free inline SVG line
charts for the learning curves (the reference shells out to a JS plotting
library; a report artifact should not need a network).
"""

from __future__ import annotations

import html as html_mod
from typing import Iterable, List, Sequence

from photon_ml_tpu_torch.diagnostics.reports import (
    DiagnosticReport,
    ModelDiagnosticReport,
)


def _esc(x) -> str:
    return html_mod.escape(str(x))


def _table(headers: Sequence[str], rows: Iterable[Sequence[object]]) -> str:
    out = ["<table><thead><tr>"]
    out += [f"<th>{_esc(h)}</th>" for h in headers]
    out.append("</tr></thead><tbody>")
    for row in rows:
        out.append(
            "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
        )
    out.append("</tbody></table>")
    return "".join(out)


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def _svg_lines(
    series: Sequence[tuple],  # (label, xs, ys, color)
    width: int = 560,
    height: int = 280,
    x_label: str = "",
    y_label: str = "",
) -> str:
    """Minimal inline SVG multi-line chart with axis labels."""
    pad = 48
    xs_all = [x for _, xs, _, _ in series for x in xs]
    ys_all = [y for _, _, ys, _ in series for y in ys if y == y]  # drop NaN
    if not xs_all or not ys_all:
        return "<p>(no data)</p>"
    x0, x1 = min(xs_all), max(xs_all)
    y0, y1 = min(ys_all), max(ys_all)
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0

    def sx(x):
        return pad + (x - x0) / (x1 - x0) * (width - 2 * pad)

    def sy(y):
        return height - pad - (y - y0) / (y1 - y0) * (height - 2 * pad)

    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" xmlns="http://www.w3.org/2000/svg">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<line x1="{pad}" y1="{height - pad}" x2="{width - pad}" '
        f'y2="{height - pad}" stroke="#333"/>',
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height - pad}" '
        'stroke="#333"/>',
        f'<text x="{width / 2}" y="{height - 8}" text-anchor="middle" '
        f'font-size="12">{_esc(x_label)}</text>',
        f'<text x="12" y="{height / 2}" text-anchor="middle" font-size="12" '
        f'transform="rotate(-90 12 {height / 2})">{_esc(y_label)}</text>',
        f'<text x="{pad}" y="{height - pad + 16}" font-size="10" '
        f'text-anchor="middle">{_fmt(x0)}</text>',
        f'<text x="{width - pad}" y="{height - pad + 16}" font-size="10" '
        f'text-anchor="middle">{_fmt(x1)}</text>',
        f'<text x="{pad - 4}" y="{height - pad}" font-size="10" '
        f'text-anchor="end">{_fmt(y0)}</text>',
        f'<text x="{pad - 4}" y="{pad}" font-size="10" '
        f'text-anchor="end">{_fmt(y1)}</text>',
    ]
    legend_y = pad
    for label, xs, ys, color in series:
        pts = " ".join(
            f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys) if y == y
        )
        parts.append(
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>'
        )
        parts.append(
            f'<rect x="{width - pad - 110}" y="{legend_y - 8}" width="10" '
            f'height="10" fill="{color}"/>'
            f'<text x="{width - pad - 96}" y="{legend_y}" font-size="11">'
            f"{_esc(label)}</text>"
        )
        legend_y += 16
    parts.append("</svg>")
    return "".join(parts)


_CSS = """
body { font-family: sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { border-bottom: 1px solid #999; margin-top: 2em; }
h3 { margin-top: 1.5em; }
table { border-collapse: collapse; margin: 0.5em 0; }
th, td { border: 1px solid #bbb; padding: 3px 8px; font-size: 13px; }
th { background: #eee; }
pre { background: #f6f6f6; padding: 8px; font-size: 12px; }
.warn { color: #a40; }
"""


def _render_model(m: ModelDiagnosticReport) -> List[str]:
    out = [f"<h2>{_esc(m.model_description)}</h2>"]
    if m.metrics:
        out.append("<h3>Validation metrics</h3>")
        out.append(
            _table(
                ("Metric", "Value"),
                [(k, _fmt(v)) for k, v in sorted(m.metrics.items())],
            )
        )
    if m.hosmer_lemeshow is not None:
        hl = m.hosmer_lemeshow
        out.append("<h3>Hosmer&ndash;Lemeshow goodness-of-fit</h3>")
        out.append(f"<pre>{_esc(hl.binning_msg)}</pre>")
        out.append(
            _table(
                ("Chi^2", "DoF", "P(X^2 <= observed)", "p-value"),
                [
                    (
                        _fmt(hl.chi_square),
                        hl.degrees_of_freedom,
                        _fmt(hl.chi_square_probability),
                        _fmt(hl.p_value),
                    )
                ],
            )
        )
        out.append(
            _table(
                (
                    "Bin", "Observed +", "Expected +",
                    "Observed -", "Expected -",
                ),
                [
                    (
                        f"[{b.lower:.3f}, {b.upper:.3f})",
                        b.observed_pos,
                        b.expected_pos,
                        b.observed_neg,
                        b.expected_neg,
                    )
                    for b in hl.bins
                ],
            )
        )
        out.append("<h4>Chi^2 cutoffs by confidence level</h4>")
        out.append(
            _table(
                ("Confidence", "Cutoff"),
                [(_fmt(c), _fmt(x)) for c, x in hl.cutoffs],
            )
        )
        if hl.chi_square_msg:
            out.append(
                f'<pre class="warn">{_esc(hl.chi_square_msg)}</pre>'
            )
    if m.prediction_error_independence is not None:
        kt = m.prediction_error_independence.kendall_tau
        out.append("<h3>Prediction / error independence (Kendall tau)</h3>")
        out.append(
            _table(
                (
                    "Concordant", "Discordant", "Items", "Pairs",
                    "tau-alpha", "tau-beta", "z", "p",
                ),
                [
                    (
                        kt.num_concordant,
                        kt.num_discordant,
                        kt.num_items,
                        kt.num_pairs,
                        _fmt(kt.tau_alpha),
                        _fmt(kt.tau_beta),
                        _fmt(kt.z_alpha),
                        _fmt(kt.p_value),
                    )
                ],
            )
        )
        if kt.message:
            out.append(f'<pre class="warn">{_esc(kt.message)}</pre>')
    for title, rep in (
        ("Feature importance (inner-product expectation)",
         m.mean_impact_importance),
        ("Feature importance (inner-product variance)",
         m.variance_impact_importance),
    ):
        if rep is None:
            continue
        out.append(f"<h3>{_esc(title)}</h3>")
        out.append(f"<p>{_esc(rep.importance_description)}</p>")
        out.append(
            _table(
                ("Rank", "Name", "Term", "Importance", "Coefficient"),
                [
                    (i + 1, f.name, f.term, _fmt(f.importance),
                     _fmt(f.coefficient))
                    for i, f in enumerate(rep.features)
                ],
            )
        )
    if m.fit_report is not None and m.fit_report.metrics:
        out.append("<h3>Learning curves (fitting diagnostic)</h3>")
        for name, (portions, train, test) in sorted(
            m.fit_report.metrics.items()
        ):
            out.append(f"<h4>{_esc(name)}</h4>")
            out.append(
                _svg_lines(
                    [
                        ("train", list(portions), list(train), "#1f77b4"),
                        ("holdout", list(portions), list(test), "#d62728"),
                    ],
                    x_label="% of training data",
                    y_label=name,
                )
            )
    if m.bootstrap_report is not None:
        br = m.bootstrap_report
        out.append(
            f"<h3>Bootstrap ({br.num_replicas} replicas, "
            f"{br.portion:.0%} samples)</h3>"
        )
        if br.metric_distributions:
            out.append(
                _table(
                    ("Metric", "Min", "Q1", "Median", "Q3", "Max"),
                    [
                        (k, *(_fmt(v) for v in vals))
                        for k, vals in sorted(
                            br.metric_distributions.items()
                        )
                    ],
                )
            )
        out.append("<h4>Important features (coefficient intervals)</h4>")
        out.append(
            _table(
                ("Name", "Term", "Importance", "Min", "Q1", "Median",
                 "Q3", "Max"),
                [
                    (f.name, f.term, _fmt(f.importance), _fmt(f.min),
                     _fmt(f.q1), _fmt(f.median), _fmt(f.q3), _fmt(f.max))
                    for f in br.important_features
                ],
            )
        )
        if br.straddling_zero:
            out.append(
                "<h4>Features whose [Q1, Q3] straddles zero</h4>"
            )
            out.append(
                _table(
                    ("Name", "Term", "Importance", "Q1", "Median", "Q3"),
                    [
                        (f.name, f.term, _fmt(f.importance), _fmt(f.q1),
                         _fmt(f.median), _fmt(f.q3))
                        for f in br.straddling_zero
                    ],
                )
            )
    return out


def render_html(report: DiagnosticReport, title: str = "Model diagnostics") -> str:
    """DiagnosticReport -> one self-contained HTML document
    (``Driver.writeDiagnostics`` / ``HTMLRenderStrategy.scala``)."""
    out = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
        "<h2>System</h2>",
        f"<p>Feature space: {report.system.num_features} columns</p>",
        "<h3>Driver parameters</h3>",
        _table(
            ("Parameter", "Value"),
            sorted(report.system.params.items()),
        ),
    ]
    if report.system.summary_table:
        out.append("<h3>Feature summary</h3>")
        cols = list(report.system.summary_table)
        names = report.system.feature_names or []
        rows = [
            [names[i] if i < len(names) else i]
            + [_fmt(report.system.summary_table[c][i]) for c in cols]
            for i in range(
                len(next(iter(report.system.summary_table.values())))
            )
        ]
        out.append(_table(["Feature"] + cols, rows))
    for m in report.models:
        out.extend(_render_model(m))
    out.append("</body></html>")
    return "".join(out)
