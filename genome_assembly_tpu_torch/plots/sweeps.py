"""Sweep-level plot suite (reference plots.py:171-884, C21).

Four entry points with filename/layout parity:
- plot_experiment_results_by_other_values — per-group + combined 5-metric
  grids, raw-overlay variants, optional separator-split x-sets
  (plots.py:171-461);
- plot_const_coverage_results — N-ordered and l-ordered variants at a
  constant coverage target (plots.py:464-713);
- plot_coverage_comparison — cross-experiment metric-vs-C grids
  (plots.py:716-805);
- plot_experiment_results_by_two_values — one line per (p, k) combo
  (plots.py:808-884).

Cleanups vs the reference (not replicated as bugs, SURVEY.md §2.3): the
separator 'smaller-or-equal' x-set is appended once, not twice
(plots.py:222-228), and axis titles are set once (plots.py:939-940).
"""

from __future__ import annotations

import os

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

from ..core.config import METRIC_LABELS, METRIC_NAMES, ParamBounds
from ..persist import create_paths
from .helpers import (
    COLORS,
    LIGHT_COLORS,
    add_average_trend_line,
    check_x_values_boundaries,
    create_figure,
    generate_x_tick_labels,
    save_figure,
    setup_plot_axis,
)

_BOUNDS = ParamBounds()


def _metric_panels():
    return zip(METRIC_NAMES, METRIC_LABELS)


def _x_axis_meta(x_key: str):
    """(axis label, fixed-param label, fixed-param key, bounds)."""
    if x_key == "num_reads":
        return ("N (Number of Reads)", "l (Read Length)", "read_length",
                _BOUNDS.lower_n, _BOUNDS.upper_n)
    if x_key == "read_length":
        return ("l (Read Length)", "N (Number of Reads)", "num_reads",
                _BOUNDS.lower_l, _BOUNDS.upper_l)
    return (x_key, "Parameter", None, None, None)


def _errorbar_with_raw(ax, df_filter, x_key, metric, color, light_color,
                       include_raw, label=None):
    xs = df_filter[x_key].values
    avg = df_filter[f"{metric} avg"].values
    std = df_filter[f"{metric} std"].values
    ax.errorbar(xs, avg, yerr=std, fmt="o-", label=label, color=color,
                capsize=5, markersize=6)
    if include_raw:
        for x, raw_vals in zip(xs, df_filter[f"{metric} raw"].values):
            if raw_vals is None or not np.iterable(raw_vals):
                continue
            ax.scatter([x] * len(raw_vals), raw_vals, alpha=0.7,
                       color=light_color, s=20, marker="o")
    return xs, avg


def plot_experiment_results_by_other_values(
        results: list[dict], x_key: str = "num_reads",
        coverage_key: str = "expected_coverage", path: str = "plots",
        log_scale: bool = False, num_iterations: int = 10, separator=None,
        other_value_key: str = "error_prob") -> None:
    """Grouped sweep plots: one series per `other_value_key` value, one panel
    per metric; combined + per-group figures, each with a raw-overlay
    variant; optional <=/>= separator splits (plots.py:171-461)."""
    df = pd.DataFrame(results)
    group_values = sorted(df[other_value_key].unique())
    x_values = sorted(df[x_key].unique())

    g_str = "p" if other_value_key == "error_prob" else other_value_key
    if other_value_key == "error_prob":
        g_title = f"Error Probability ({g_str})"
    elif other_value_key == "k":
        g_title = f"K-mer Threshold ({g_str})"
    else:
        g_title = g_str

    x_sets = [(x_values, f"{x_key}")]
    if separator is not None:
        le = [x for x in x_values if x <= separator]
        ge = [x for x in x_values if x >= separator]
        if le and le != x_values:
            x_sets.append((le, f"{x_key}_le_{separator}"))
        if ge and ge != x_values:
            x_sets.append((ge, f"{x_key}_ge_{separator}"))

    x_label, fixed_param, fixed_key, lo, hi = _x_axis_meta(x_key)
    fixed_value = None
    if fixed_key and df[fixed_key].nunique() == 1:
        fixed_value = df[fixed_key].iloc[0]

    for plot_x_values, suffix in x_sets:
        oob = check_x_values_boundaries(plot_x_values, lo, hi)
        df_x = df[df[x_key].isin(plot_x_values)]

        # combined figure (all groups), with and without raw overlay
        for include_raw in [False, True]:
            fig, axes = create_figure()
            prefix = (f"Measures for fixed {fixed_param}={fixed_value} for "
                      if fixed_value else "Measures for ")
            fig.suptitle(f"{prefix}different {x_label} {oob}values and "
                         f"different {g_str} values", fontsize=28)
            for ax, (metric, label) in zip(axes, _metric_panels()):
                all_x, all_y = [], []
                for gi, g in enumerate(group_values):
                    df_f = df_x[df_x[other_value_key] == g].sort_values(
                        by=x_key)
                    if df_f.empty:
                        continue
                    xs, avg = _errorbar_with_raw(
                        ax, df_f, x_key, metric, COLORS[gi % len(COLORS)],
                        LIGHT_COLORS[gi % len(LIGHT_COLORS)], include_raw,
                        label=f"{g_str}={g}")
                    all_x.extend(xs)
                    all_y.extend(avg)
                setup_plot_axis(ax, x_label, metric, label, g_str,
                                "combined", num_iterations, log_scale)
                if coverage_key:
                    ticks, labels = generate_x_tick_labels(
                        df_x, x_key, coverage_key)
                    ax.set_xticks(ticks)
                    ax.set_xticklabels(labels, rotation=45)
                    ax.tick_params(axis="both", labelsize=18)
                add_average_trend_line(ax, all_x, all_y, log_scale=log_scale)
                if all_x:
                    fs = 14 if len(g_title) > 20 else 16
                    ax.legend(title=g_title, loc="upper left", fontsize=fs)
            plt.tight_layout(rect=[0, 0, 1, 0.95])
            plt.subplots_adjust(wspace=0.3, hspace=0.45, top=0.90)
            is_raw = "_with_raw" if include_raw else ""
            save_figure(fig, f"{path}/{suffix}/"
                             f"{g_str}_values_combined_{is_raw}.png")

        # per-group figures
        for gi, g in enumerate(group_values):
            df_f = df_x[df_x[other_value_key] == g].sort_values(by=x_key)
            if df_f.empty:
                continue
            for include_raw in [False, True]:
                is_raw = "_with_raw" if include_raw else ""
                fig, axes = create_figure()
                prefix = (f"Measures for fixed {fixed_param}={fixed_value}, "
                          if fixed_value else "Measures for ")
                fig.suptitle(f"{prefix}{g_str}={g} for different {x_label} "
                             f"{oob}values", fontsize=28)
                for ax, (metric, label) in zip(axes, _metric_panels()):
                    xs, avg = _errorbar_with_raw(
                        ax, df_f, x_key, metric, COLORS[gi % len(COLORS)],
                        LIGHT_COLORS[gi % len(LIGHT_COLORS)], include_raw)
                    setup_plot_axis(ax, x_label, metric, label, g_str, g,
                                    num_iterations, log_scale)
                    if coverage_key:
                        labels = [
                            f"{x}\n(C="
                            f"{df_f[df_f[x_key] == x][coverage_key].iloc[0]:.1f}x)"
                            for x in xs]
                        ax.set_xticks(xs)
                        ax.set_xticklabels(labels, rotation=45)
                        ax.tick_params(axis="both", labelsize=18)
                    add_average_trend_line(ax, xs, avg, log_scale)
                    if len(xs) > 1:
                        ax.legend(loc="upper right", fontsize=12)
                plt.tight_layout(rect=[0, 0, 1, 0.95])
                plt.subplots_adjust(wspace=0.3, hspace=0.45, top=0.90)
                save_figure(fig, f"{path}/{suffix}/{g_str}_value_{g}/"
                                 f"ordered_by_{x_key}_{is_raw}.png")


def plot_const_coverage_results(results: list[dict], coverage_target: float,
                                x_axis_var: str = "num_reads",
                                path: str = "plots",
                                num_iterations: int = 10,
                                log_scale: bool = False,
                                grouping_value: str = "error_prob") -> None:
    """Constant-coverage sweep: N-ordered and l-ordered 5-metric grids,
    combined + per-group, each with raw-overlay variants
    (plots.py:464-713)."""
    df = pd.DataFrame(results)
    g_values = sorted(df[grouping_value].unique())
    g_str = "p" if grouping_value == "error_prob" else "k"

    lo = _BOUNDS.lower_l if x_axis_var == "l" else _BOUNDS.lower_n
    hi = _BOUNDS.upper_l if x_axis_var == "l" else _BOUNDS.upper_n
    full_path = create_paths([(path, "summary_plots")])[0]
    os.makedirs(full_path, exist_ok=True)

    def plot_metric_data(x_key, y_key, x_label, y_label):
        # combined
        for include_raw in [False, True]:
            fig, axes = create_figure()
            xs_all = sorted(df[x_key].unique())
            oob = check_x_values_boundaries(xs_all, lo, hi)
            fig.suptitle(f"Measures with constant coverage "
                         f"C={coverage_target:.1f}x, {oob}ordered by "
                         f"{x_label}", fontsize=28)
            for ax, (metric, label) in zip(axes, _metric_panels()):
                all_x, all_y = [], []
                for gi, g in enumerate(g_values):
                    df_f = df[df[grouping_value] == g].sort_values(by=x_key)
                    if df_f.empty:
                        continue
                    xs, avg = _errorbar_with_raw(
                        ax, df_f, x_key, metric, COLORS[gi % len(COLORS)],
                        LIGHT_COLORS[gi % len(LIGHT_COLORS)], include_raw,
                        label=f"{g_str}={g}")
                    all_x.extend(xs)
                    all_y.extend(avg)
                ticks = sorted(df[x_key].unique())
                labels = [
                    f"{x}\n({y_label[0]}="
                    f"{df[df[x_key] == x][y_key].iloc[0]})" for x in ticks]
                ax.set_xticks(ticks)
                ax.set_xticklabels(labels, rotation=45)
                ax.tick_params(axis="both", labelsize=18)
                setup_plot_axis(ax, x_label, metric, label, g_str,
                                "combined", num_iterations, log_scale)
                add_average_trend_line(ax, all_x, all_y, log_scale)
                if all_x:
                    ax.legend(loc="upper right", fontsize=12)
            plt.tight_layout(rect=[0, 0, 1, 0.95])
            plt.subplots_adjust(wspace=0.3, hspace=0.45, top=0.90)
            raw_sfx = "_with_raw" if include_raw else ""
            save_figure(fig, f"{full_path}/ordered_by_{x_axis_var}_"
                             f"{g_str}{raw_sfx}.png")

        # per-group
        for gi, g in enumerate(g_values):
            df_f = df[df[grouping_value] == g].sort_values(by=x_key)
            if df_f.empty:
                continue
            for include_raw in [False, True]:
                fig, axes = create_figure()
                xs_g = sorted(df_f[x_key].unique())
                oob = check_x_values_boundaries(xs_g, lo, hi)
                fig.suptitle(f"Measures with constant coverage "
                             f"C={coverage_target:.1f}x, {g_str}={g}, {oob}"
                             f"ordered by {x_label}", fontsize=28)
                for ax, (metric, label) in zip(axes, _metric_panels()):
                    xs, avg = _errorbar_with_raw(
                        ax, df_f, x_key, metric, COLORS[gi % len(COLORS)],
                        LIGHT_COLORS[gi % len(LIGHT_COLORS)], include_raw)
                    ys = df_f[y_key].values
                    ax.set_xticks(xs)
                    ax.set_xticklabels(
                        [f"{x}\n({y_label[0]}={y})" for x, y in zip(xs, ys)],
                        rotation=45)
                    ax.tick_params(axis="both", labelsize=18)
                    if len(xs) > 1:
                        deg = max(min(len(set(xs)) - 1, 3), 1)
                        trend = np.polyfit(xs, avg, deg)
                        xt = np.linspace(min(xs), max(xs), 100)
                        ax.plot(xt, np.polyval(trend, xt), "k--",
                                linewidth=2, label="Trend Line")
                    setup_plot_axis(ax, x_label, metric, label, g_str, g,
                                    num_iterations, log_scale)
                    if len(xs) > 1:
                        ax.legend(loc="upper right", fontsize=12)
                plt.tight_layout(rect=[0, 0, 1, 0.95])
                plt.subplots_adjust(wspace=0.3, hspace=0.45, top=0.90)
                raw_sfx = "_with_raw" if include_raw else ""
                save_figure(fig, f"{full_path}/ordered_by_{x_axis_var}_"
                                 f"{g_str}_{g}{raw_sfx}.png")

    plot_metric_data("num_reads", "read_length", "N (Number of Reads)",
                     "l (Read Length)")
    plot_metric_data("read_length", "num_reads", "l (Read Length)",
                     "N (Number of Reads)")


def plot_coverage_comparison(all_coverage_results: dict, genome_length: int,
                             path: str = "plots", log_scale: bool = False,
                             grouping_value: str = "error_prob") -> None:
    """Cross-experiment comparison: metric vs coverage level, one series per
    group value, plus a pooled trend figure (plots.py:716-805)."""
    if not all_coverage_results:
        return
    if isinstance(all_coverage_results, (list, tuple)):
        # tolerate list-of-result-lists inputs (keys become list indices)
        all_coverage_results = {i: rows for i, rows
                                in enumerate(all_coverage_results) if rows}
        if not all_coverage_results:
            return
    g_str = "p" if grouping_value == "error_prob" else "k"
    fixed = ("Fixed Error Probability" if g_str == "p"
             else "Fixed K for K-mers")

    # figure 1: per-group series over coverage
    fig, axes = create_figure()
    group_vals = sorted({r[grouping_value]
                         for results in all_coverage_results.values()
                         for r in results})
    for ax, (metric, label) in zip(axes, _metric_panels()):
        for g in group_vals:
            cov_means, cov_stds, cov_vals = [], [], []
            for C, results in all_coverage_results.items():
                rs = [r for r in results if r[grouping_value] == g]
                if rs:
                    cov_means.append(np.mean([r[f"{metric} avg"] for r in rs]))
                    cov_stds.append(np.mean([r[f"{metric} std"] for r in rs]))
                    cov_vals.append(C)
            if cov_vals:
                ax.errorbar(cov_vals, cov_means, yerr=cov_stds,
                            label=f"{g_str} = {g}", marker="o")
        setup_plot_axis(ax, f"Coverage (C times {genome_length})", metric,
                        label, log_scale=log_scale)
        ax.legend(loc="upper right", fontsize=12)
    fig.suptitle(f"Different Coverage for {fixed}", fontsize=28)
    plt.tight_layout(rect=[0, 0, 1, 0.95])
    plt.subplots_adjust(wspace=0.3, hspace=0.4)
    save_figure(fig, f"{path}/coverage_comparison_const_{g_str}.png",
                dpi=None, tight=False)

    # figure 2: pooled trend over coverage
    fig, axes = create_figure()
    for ax, (metric, label) in zip(axes, _metric_panels()):
        xs, ys = [], []
        for C, results in all_coverage_results.items():
            if results:
                xs.append(C)
                ys.append(np.mean([r[f"{metric} avg"] for r in results]))
        ax.scatter(xs, ys, label="Coverage Points")
        add_average_trend_line(ax, xs, ys, log_scale=log_scale)
        setup_plot_axis(ax, f"Coverage (C times {genome_length})", metric,
                        label, log_scale=log_scale)
        ax.legend(loc="upper right", fontsize=12)
    plt.tight_layout(rect=[0, 0, 1, 0.95])
    plt.subplots_adjust(wspace=0.3, hspace=0.4)
    save_figure(fig, f"{path}/coverage_comparison_trend.png", dpi=None,
                tight=False)


def plot_experiment_results_by_two_values(
        results: list[dict], x_key: str = "num_reads",
        group_key_1: str = "error_prob", group_key_2: str = "k",
        coverage_key: str = "expected_coverage", path: str = "plots",
        log_scale: bool = False, num_iterations: int = 1) -> None:
    """One line per (group_key_1, group_key_2) combination
    (plots.py:808-884)."""
    df = pd.DataFrame(results)
    v1_list = sorted(df[group_key_1].unique())
    v2_list = sorted(df[group_key_2].unique())
    x_values = sorted(df[x_key].unique())

    fig, axes = create_figure()
    g1_str = "p" if group_key_1 == "error_prob" else group_key_1
    fig.suptitle(f"Measures for {x_key} by {g1_str} & {group_key_2}",
                 fontsize=28)
    for ax, (metric, label) in zip(axes, _metric_panels()):
        y_avg = np.array([])
        for v1 in v1_list:
            for v2 in v2_list:
                df_sub = df[(df[group_key_1] == v1)
                            & (df[group_key_2] == v2)].sort_values(by=x_key)
                if df_sub.empty:
                    continue
                y_avg = df_sub[f"{metric} avg"].values
                ax.errorbar(df_sub[x_key].values, y_avg,
                            yerr=df_sub[f"{metric} std"].values, fmt="o-",
                            capsize=4, label=f"{g1_str}={v1}, "
                                             f"{group_key_2}={v2}")
        if coverage_key:
            ticks, labels = generate_x_tick_labels(df, x_key, coverage_key)
            ax.set_xticks(ticks)
            ax.set_xticklabels(labels, rotation=45)
            ax.tick_params(axis="both", labelsize=20)
        ax.set_xlabel(x_key)
        ax.set_ylabel(label)
        ax.set_title(f"{label} vs. {x_key}", fontsize=24)
        ax.grid(True, alpha=0.3)
        if log_scale:
            ax.set_xscale("log")
        if len(x_values) > 1 and len(y_avg) > 0:
            add_average_trend_line(ax, x_values[:len(y_avg)], y_avg,
                                   log_scale=log_scale)
        if len(v1_list) > 1:
            ax.legend(fontsize=12)
    plt.tight_layout()
    plt.subplots_adjust(wspace=0.3, hspace=0.45, top=0.90)
    os.makedirs(path, exist_ok=True)
    save_figure(fig, os.path.join(
        path, f"{x_key}_by_two_values_{g1_str}_{group_key_2}.png"),
        tight=False)
