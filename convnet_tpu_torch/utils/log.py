"""Logging and results tables: a copy of convnet_tpu/utils/log.py (pure
Python), so the port never imports the JAX package.

The reference's three channels:
1. python ``logging`` to the console and ``results/<save>/log.txt``
   (``setup_logging``),
2. ``ResultsLog``: one row per epoch → CSV and JSON, with optional
   matplotlib PNG plots and self-contained HTML curves,
3. the arguments dumped to JSON (``export_args_namespace``).
"""

from __future__ import annotations

import csv
import json
import logging
import logging.handlers
import os
from typing import Any, Dict, List, Optional


def setup_logging(log_file: Optional[str] = None, level=logging.INFO,
                  resume: bool = False):
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    fmt = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s", "%Y-%m-%d %H:%M:%S")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    root.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, mode="a" if resume else "w")
        fh.setFormatter(fmt)
        root.addHandler(fh)


class ResultsLog:
    """Accumulates one row per epoch; persists CSV + JSON; optional
    matplotlib plots of train-vs-val curves."""

    def __init__(self, path: str = "results", title: str = ""):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.title = title
        self.csv_path = os.path.join(path, "results.csv")
        self.json_path = os.path.join(path, "results.json")
        self.plot_path = os.path.join(path, "results.png")
        self.html_path = os.path.join(path, "results.html")
        self.rows: List[Dict[str, Any]] = []
        self._plots: List[Dict[str, Any]] = []

    def add(self, **kwargs):
        self.rows.append(dict(kwargs))

    def load(self):
        if os.path.exists(self.json_path):
            with open(self.json_path) as f:
                self.rows = json.load(f)
        return self

    def save(self):
        if not self.rows:
            return
        keys: List[str] = []
        for row in self.rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(self.rows)
        with open(self.json_path, "w") as f:
            json.dump(self.rows, f, indent=1, default=str)
        if self._plots:
            self._render_plots()
            self._render_html()

    def plot(self, x: str, y: List[str], title: str = "", ylabel: str = ""):
        """Queue a subplot (rendered on save); mirrors ResultsLog.plot.
        Idempotent per (x, y) so per-epoch re-registration (the CLI
        calls plot() every epoch before save()) doesn't accumulate
        duplicate panels."""
        spec = {"x": x, "y": list(y), "title": title, "ylabel": ylabel}
        for i, existing in enumerate(self._plots):
            if existing["x"] == x and existing["y"] == spec["y"]:
                self._plots[i] = spec
                return
        self._plots.append(spec)

    def _render_plots(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # plots optional
            return
        n = len(self._plots)
        fig, axes = plt.subplots(1, n, figsize=(6 * n, 4), squeeze=False)
        for ax, spec in zip(axes[0], self._plots):
            xs = [r.get(spec["x"]) for r in self.rows]
            for series in spec["y"]:
                ys = [r.get(series) for r in self.rows]
                ax.plot(xs, ys, label=series)
            ax.set_title(spec["title"] or self.title)
            ax.set_xlabel(spec["x"])
            ax.set_ylabel(spec["ylabel"])
            ax.legend()
            ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(self.plot_path, dpi=100)
        plt.close(fig)

    _PALETTE = ["#4477aa", "#ee6677", "#228833", "#ccbb44",
                "#66ccee", "#aa3377"]

    def _render_html(self):
        """Self-contained interactive HTML curves — the reference's
        bokeh output (utils/log.py:~70–250 approx., SURVEY.md §5.5)
        without the bokeh dependency: inline SVG + a few lines of
        hover JS, openable from any browser with no server."""
        W, H, PAD = 560, 320, 48
        panels = []
        for spec in self._plots:
            xs = [r.get(spec["x"]) for r in self.rows]
            xs = [x if isinstance(x, (int, float)) else None for x in xs]
            series = []
            lo, hi = float("inf"), float("-inf")
            for name in spec["y"]:
                ys = [r.get(name) for r in self.rows]
                pts = [(x, y) for x, y in zip(xs, ys)
                       if x is not None and isinstance(y, (int, float))]
                if not pts:
                    continue
                series.append((name, pts))
                lo = min(lo, min(p[1] for p in pts))
                hi = max(hi, max(p[1] for p in pts))
            if not series:
                continue
            x0 = min(p[0] for _, pts in series for p in pts)
            x1 = max(p[0] for _, pts in series for p in pts)
            if hi == lo:
                hi = lo + 1.0
            if x1 == x0:
                x1 = x0 + 1.0

            def sx(v):
                return PAD + (v - x0) / (x1 - x0) * (W - 2 * PAD)

            def sy(v):
                return H - PAD - (v - lo) / (hi - lo) * (H - 2 * PAD)

            elems = [f'<text x="{W//2}" y="18" text-anchor="middle" '
                     f'font-weight="bold">{spec["title"] or self.title}'
                     f'</text>']
            for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
                yv = lo + frac * (hi - lo)
                yy = sy(yv)
                elems.append(
                    f'<line x1="{PAD}" y1="{yy:.1f}" x2="{W-PAD}" '
                    f'y2="{yy:.1f}" stroke="#ddd"/>'
                    f'<text x="{PAD-6}" y="{yy+4:.1f}" text-anchor="end" '
                    f'font-size="10">{yv:.4g}</text>')
            elems.append(
                f'<text x="{W//2}" y="{H-8}" text-anchor="middle" '
                f'font-size="11">{spec["x"]}</text>')
            for si, (name, pts) in enumerate(series):
                color = self._PALETTE[si % len(self._PALETTE)]
                path = " ".join(
                    f"{'M' if i == 0 else 'L'}{sx(px):.1f},{sy(py):.1f}"
                    for i, (px, py) in enumerate(pts))
                elems.append(f'<path d="{path}" fill="none" '
                             f'stroke="{color}" stroke-width="1.5"/>')
                for px, py in pts:
                    elems.append(
                        f'<circle cx="{sx(px):.1f}" cy="{sy(py):.1f}" '
                        f'r="3" fill="{color}" opacity="0.7">'
                        f'<title>{name} @ {spec["x"]}={px:g}: {py:.5g}'
                        f'</title></circle>')
                elems.append(
                    f'<rect x="{W-PAD-130}" y="{PAD+si*16-9}" width="10" '
                    f'height="10" fill="{color}"/>'
                    f'<text x="{W-PAD-116}" y="{PAD+si*16}" '
                    f'font-size="11">{name}</text>')
            panels.append(
                f'<svg width="{W}" height="{H}" font-family="sans-serif" '
                f'font-size="12" style="background:#fff;border:1px solid '
                f'#ccc;margin:4px">{"".join(elems)}</svg>')
        if not panels:
            return
        with open(self.html_path, "w") as f:
            f.write(f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
                    f"<title>{self.title}</title></head><body>"
                    f"<h2 style='font-family:sans-serif'>{self.title}</h2>"
                    f"{''.join(panels)}</body></html>")

    def show(self):
        """Open the HTML results in a browser (bokeh .show() upstream);
        headless environments just keep the file on disk."""
        if os.path.exists(self.html_path):
            import webbrowser
            try:
                webbrowser.open(f"file://{os.path.abspath(self.html_path)}")
            except Exception:
                pass


def export_args_namespace(args, filename: str):
    """args (argparse.Namespace) → json (utils/log.py equivalent)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as f:
        json.dump(vars(args), f, indent=2, default=str)
