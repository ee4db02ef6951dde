"""Shared plotting helpers (reference plots.py:887-1087, C22).

Same capabilities, cleaned up: one save helper instead of six inlined
try/except blocks, and `setup_plot_axis` sets the title once (the reference
sets it twice at plots.py:939-940, the second silently overwriting the
iteration-count title — not replicated).
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

# series colors + light variants for raw-point overlays (plots.py:243-244)
COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b"]
LIGHT_COLORS = ["#a6cee3", "#fdbf6f", "#b2df8a", "#fb9a99", "#cab2d6",
                "#d2b48c"]


def create_figure():
    """2x3 grid with the 5th axis hidden — one panel per metric
    (plots.py:1073-1087)."""
    fig, axes_2d = plt.subplots(2, 3, figsize=(24, 15))
    axes = axes_2d.ravel()
    axes[4].set_visible(False)
    return fig, [axes[0], axes[1], axes[2], axes[3], axes[5]]


def save_figure(fig, full_path: str, dpi: int | None = 300,
                tight: bool = True) -> None:
    """mkdir -p + savefig + close, with the reference's print-and-continue
    error handling (plots.py:45-54 et al.). GA_TPU_PLOT_DPI overrides the
    rendering resolution (tests use a low value to keep rendering cheap)."""
    try:
        directory = os.path.dirname(full_path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        env_dpi = os.environ.get("GA_TPU_PLOT_DPI")
        if env_dpi and dpi:
            dpi = int(env_dpi)
        kw = {"dpi": dpi} if dpi else {}
        if tight:
            kw["bbox_inches"] = "tight"
        fig.savefig(full_path, **kw)
    except Exception as e:
        print(f"Error saving plot: {e}")
        print(f"Parameters: path={full_path}")
    finally:
        plt.close(fig)


def setup_plot_axis(ax, x_axis_label: str, metric: str, metric_label: str,
                    grouping_by_str: str = "p", grouping_by_val=None,
                    num_iterations=None, log_scale: bool = False) -> None:
    """Common axis config (plots.py:912-941)."""
    if log_scale:
        ax.set_xscale("log")
    ax.set_xlabel(x_axis_label, fontsize=16)
    ax.set_ylabel(metric_label, fontsize=16)
    if grouping_by_val is not None and num_iterations is not None:
        ax.set_title(
            f"{metric} vs. {x_axis_label} "
            f"({grouping_by_str}={grouping_by_val}, "
            f"{num_iterations} iterations)", fontsize=22)
    else:
        ax.set_title(f"{metric} vs. {x_axis_label}", fontsize=22)
    ax.grid(True, alpha=0.3)


def add_average_trend_line(ax, all_x, all_y, log_scale: bool = False) -> None:
    """Polyfit trend (degree <= 2) over the pooled points
    (plots.py:944-981); log_scale fits in log1p(x) space."""
    if len(all_x) <= 1:
        return
    order = np.argsort(all_x)
    xs = np.asarray(all_x, dtype=float)[order]
    ys = np.asarray(all_y, dtype=float)[order]
    n_distinct = len(set(map(float, xs)))
    degree = min(2, n_distinct - 1) if n_distinct > 1 else 1
    if degree < 1:
        return
    if log_scale:
        xl = np.log1p(xs)
        trend = np.polyfit(xl, ys, degree)
        xt = np.linspace(xl.min(), xl.max(), 100)
        ax.plot(np.expm1(xt), np.polyval(trend, xt), "k--", linewidth=2,
                label="Average Trend")
    else:
        trend = np.polyfit(xs, ys, degree)
        xt = np.linspace(xs.min(), xs.max(), 100)
        ax.plot(xt, np.polyval(trend, xt), "k--", linewidth=2,
                label="Average Trend")


def generate_x_tick_labels(df, x_key: str, coverage_key: str):
    """x ticks annotated with the coverage they imply (plots.py:984-1007)."""
    x_ticks = sorted(df[x_key].unique())
    x_labels = [
        f"{x}\n(C={df[df[x_key] == x][coverage_key].iloc[0]:.1f}x)"
        for x in x_ticks]
    return x_ticks, x_labels


def check_x_values_boundaries(x_values, lower_bound, upper_bound) -> str:
    """Out-of-bounds annotation for plot titles (plots.py:887-909)."""
    s = ""
    if lower_bound is not None and all(x < lower_bound for x in x_values):
        s += f"(all values lower than {lower_bound}) "
    if upper_bound is not None and all(x > upper_bound for x in x_values):
        s += f"(all values higher than {upper_bound}) "
    return s


def add_boundary_lines(ax, x_values, lower_bound, upper_bound) -> None:
    """Dashed parameter-bound verticals when a bound falls inside the data
    span and near a data point (plots.py:1010-1071)."""
    y_min, y_max = ax.get_ylim()
    gaps = [b - a for a, b in zip(x_values[:-1], x_values[1:])]
    max_gap = max(gaps, default=0)

    def wanted(bound):
        if bound is None or not x_values:
            return False
        within = any(a <= bound <= b
                     for a, b in zip(x_values[:-1], x_values[1:]))
        min_dist = min(abs(x - bound) for x in x_values)
        return within and min_dist < 1.5 * max_gap

    for bound, name in [(lower_bound, "Lower Bound"),
                        (upper_bound, "Upper Bound")]:
        if wanted(bound):
            ax.vlines(bound, y_min, y_max, colors="slategray",
                      linestyles="dashed", label=name, alpha=0.5)
            ax.text(bound, y_min - 0.05 * (y_max - y_min),
                    f"{name}\n({bound})", horizontalalignment="center",
                    verticalalignment="top", color="slategray", fontsize=8)
