"""Declarative UI component library (counterpart of
`deeplearning4j_tpu/ui/components.py`): charts, tables and text
serialized to JSON, plus self-contained SVG/HTML renderers. Pure
Python: for the same inputs `to_json()` and `render()` give the JAX
package's bytes.

Reference: `deeplearning4j-ui-components` (`components/chart/Chart.java`
and subclasses ChartLine/ChartHistogram/ChartScatter/ChartStackedArea,
`components/table/ComponentTable.java`, `components/text/ComponentText.java`,
`components/component/ComponentDiv.java`, `api/Style.java`): components
are data (JSON) decoupled from rendering. The reference renders with
JS/D3 in the browser; here each component also knows how to render
itself to inline SVG/HTML so the dashboard needs no external assets.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

_COMPONENT_REGISTRY: Dict[str, type] = {}


def register_component(cls):
    _COMPONENT_REGISTRY[cls.component_type] = cls
    return cls


@dataclasses.dataclass
class ChartStyle:
    """Subset of the reference `StyleChart` knobs."""

    width: int = 640
    height: int = 240
    stroke_width: float = 1.5
    series_colors: Sequence[str] = ("#2a6fdb", "#db2a2a", "#2adb7c",
                                    "#db9b2a", "#8b2adb", "#2adbd3")
    background: str = "#fafafa"

    def __post_init__(self):
        self.series_colors = list(self.series_colors)  # JSON-stable form

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return ChartStyle(**d) if d else ChartStyle()


class Component:
    component_type = "component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        """Self-contained HTML/SVG fragment."""
        raise NotImplementedError


def component_from_dict(d: dict) -> Component:
    cls = _COMPONENT_REGISTRY[d["type"]]
    return cls._from_dict(d)


def component_from_json(s: str) -> Component:
    return component_from_dict(json.loads(s))


# ------------------------------------------------------------------ charts
class _BaseChart(Component):
    def __init__(self, title: str = "", style: Optional[ChartStyle] = None):
        self.title = title
        self.style = style or ChartStyle()

    def _frame(self, inner: str) -> str:
        s = self.style
        title = (f'<text x="45" y="16" font-size="12" font-weight="bold">'
                 f'{_html.escape(self.title)}</text>') if self.title else ""
        return (f'<svg width="{s.width}" height="{s.height}" '
                f'xmlns="http://www.w3.org/2000/svg">'
                f'<rect width="{s.width}" height="{s.height}" '
                f'fill="{s.background}"/>{title}{inner}</svg>')

    def _xy_transform(self, all_x, all_y):
        s = self.style
        xmin, xmax = min(all_x), max(all_x)
        ymin, ymax = min(all_y), max(all_y)
        if xmax == xmin:
            xmax = xmin + 1
        if ymax == ymin:
            ymax = ymin + 1

        def tx(x):
            return 45 + (x - xmin) / (xmax - xmin) * (s.width - 65)

        def ty(y):
            return s.height - 28 - (y - ymin) / (ymax - ymin) * (s.height - 52)

        axes = (f'<text x="45" y="{s.height - 10}" font-size="10">'
                f'{xmin:.4g}</text>'
                f'<text x="{s.width - 60}" y="{s.height - 10}" font-size="10">'
                f'{xmax:.4g}</text>'
                f'<text x="4" y="{s.height - 28}" font-size="10">{ymin:.4g}</text>'
                f'<text x="4" y="30" font-size="10">{ymax:.4g}</text>')
        return tx, ty, axes


@register_component
class ChartLine(_BaseChart):
    """Multi-series line chart (reference `ChartLine.java`)."""

    component_type = "chart_line"

    def __init__(self, title: str = "", style: Optional[ChartStyle] = None):
        super().__init__(title, style)
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float]):
        if len(x) != len(y):
            raise ValueError(f"series {name}: len(x) {len(x)} != len(y) {len(y)}")
        self.series.append((name, [float(v) for v in x], [float(v) for v in y]))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    @classmethod
    def _from_dict(cls, d):
        c = cls(d.get("title", ""), ChartStyle.from_dict(d.get("style")))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c

    def render(self):
        if not any(x for _, x, _ in self.series):
            return self._frame("")
        all_x = [v for _, x, _ in self.series for v in x]
        all_y = [v for _, _, y in self.series for v in y]
        tx, ty, axes = self._xy_transform(all_x, all_y)
        parts = [axes]
        for i, (name, x, y) in enumerate(self.series):
            if not y:
                continue
            color = self.style.series_colors[i % len(self.style.series_colors)]
            pts = " ".join(f"{tx(a):.1f},{ty(b):.1f}" for a, b in zip(x, y))
            parts.append(f'<polyline fill="none" stroke="{color}" '
                         f'stroke-width="{self.style.stroke_width}" '
                         f'points="{pts}"/>')
            parts.append(f'<text x="{self.style.width - 120}" y="{30 + 14 * i}" '
                         f'font-size="11" fill="{color}">{_html.escape(name)}'
                         f' ({y[-1]:.5g})</text>')
        return self._frame("".join(parts))


@register_component
class ChartHistogram(_BaseChart):
    """Histogram of pre-binned values (reference `ChartHistogram.java`:
    addBin(lower, upper, yValue))."""

    component_type = "chart_histogram"

    def __init__(self, title: str = "", style: Optional[ChartStyle] = None):
        super().__init__(title, style)
        self.bins: List[Tuple[float, float, float]] = []  # (low, high, y)

    def add_bin(self, lower: float, upper: float, y: float):
        self.bins.append((float(lower), float(upper), float(y)))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "bins": [{"lower": l, "upper": u, "y": y}
                         for l, u, y in self.bins]}

    @classmethod
    def _from_dict(cls, d):
        c = cls(d.get("title", ""), ChartStyle.from_dict(d.get("style")))
        for b in d.get("bins", []):
            c.add_bin(b["lower"], b["upper"], b["y"])
        return c

    def render(self):
        if not self.bins:
            return self._frame("")
        tx, ty, axes = self._xy_transform(
            [b[0] for b in self.bins] + [b[1] for b in self.bins],
            [0.0] + [b[2] for b in self.bins])
        y0 = ty(0.0)
        color = self.style.series_colors[0]
        parts = [axes]
        for low, high, y in self.bins:
            x1, x2 = tx(low), tx(high)
            yy = ty(y)
            parts.append(f'<rect x="{x1:.1f}" y="{min(yy, y0):.1f}" '
                         f'width="{max(x2 - x1 - 1, 1):.1f}" '
                         f'height="{abs(y0 - yy):.1f}" fill="{color}" '
                         f'fill-opacity="0.7"/>')
        return self._frame("".join(parts))


@register_component
class ChartScatter(_BaseChart):
    """Scatter plot (reference `ChartScatter.java`); the t-SNE module's
    workhorse."""

    component_type = "chart_scatter"

    def __init__(self, title: str = "", style: Optional[ChartStyle] = None):
        super().__init__(title, style)
        self.series: List[Tuple[str, List[float], List[float], List[str]]] = []

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float],
                   labels: Optional[Sequence[str]] = None):
        if len(x) != len(y):
            raise ValueError(f"series {name}: len(x) != len(y)")
        labels = [str(l) for l in labels] if labels is not None else []
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y], labels))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "series": [{"name": n, "x": x, "y": y, "labels": ls}
                           for n, x, y, ls in self.series]}

    @classmethod
    def _from_dict(cls, d):
        c = cls(d.get("title", ""), ChartStyle.from_dict(d.get("style")))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"], s.get("labels") or None)
        return c

    def render(self):
        if not any(x for _, x, _, _ in self.series):
            return self._frame("")
        all_x = [v for _, x, _, _ in self.series for v in x]
        all_y = [v for _, _, y, _ in self.series for v in y]
        tx, ty, axes = self._xy_transform(all_x, all_y)
        parts = [axes]
        for i, (name, x, y, labels) in enumerate(self.series):
            color = self.style.series_colors[i % len(self.style.series_colors)]
            for j, (a, b) in enumerate(zip(x, y)):
                parts.append(f'<circle cx="{tx(a):.1f}" cy="{ty(b):.1f}" '
                             f'r="2.5" fill="{color}"/>')
                if j < len(labels):
                    parts.append(f'<text x="{tx(a) + 4:.1f}" '
                                 f'y="{ty(b) - 3:.1f}" font-size="9">'
                                 f'{_html.escape(labels[j])}</text>')
        return self._frame("".join(parts))


# ------------------------------------------------------------- table/text
@register_component
class ComponentTable(Component):
    """Reference `ComponentTable.java`."""

    component_type = "table"

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence[Any]],
                 title: str = ""):
        self.title = title
        self.header = [str(h) for h in header]
        self.rows = [[str(c) for c in row] for row in rows]

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "header": self.header, "rows": self.rows}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["header"], d["rows"], d.get("title", ""))

    def render(self):
        head = "".join(f"<th>{_html.escape(h)}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(c)}</td>" for c in row)
            + "</tr>" for row in self.rows)
        title = f"<h4>{_html.escape(self.title)}</h4>" if self.title else ""
        return (f'{title}<table border="1" cellpadding="4" '
                f'style="border-collapse:collapse">'
                f"<tr>{head}</tr>{body}</table>")


@register_component
class ComponentText(Component):
    component_type = "text"

    def __init__(self, text: str):
        self.text = text

    def to_dict(self):
        return {"type": self.component_type, "text": self.text}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["text"])

    def render(self):
        return f"<p>{_html.escape(self.text)}</p>"


@register_component
class ComponentDiv(Component):
    """Container (reference `ComponentDiv.java`)."""

    component_type = "div"

    def __init__(self, *children: Component):
        self.children = list(children)

    def add(self, c: Component):
        self.children.append(c)
        return self

    def to_dict(self):
        return {"type": self.component_type,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_dict(cls, d):
        return cls(*[component_from_dict(c) for c in d.get("children", [])])

    def render(self):
        return "<div>" + "".join(c.render() for c in self.children) + "</div>"
