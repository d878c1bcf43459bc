"""Trajectory and convergence plots.

JAX counterpart of the reference Plots.jl recipes
(``src/plots/solver_plots.jl:18-120``): XY trajectories per player and the
log10 violation history shaded per AL outer epoch.  Uses matplotlib when
available (host-side, display/export only — never on the solve path);
figures are returned so callers can save or show them.
"""
from __future__ import annotations

import numpy as np


def plot_trajectory(spec, traj, ax=None, labels=True):
    """XY position traces per player (reference ``recipe_traj``,
    ``solver_plots.jl:18-35``).  Returns the matplotlib Axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    X = np.asarray(traj.x)
    for i in range(spec.p):
        px = np.asarray(spec.px[i])
        ax.plot(X[:, px[0]], X[:, px[1]], marker="o", ms=3,
                label=f"player {i}" if labels else None)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal", adjustable="datalim")
    if labels:
        ax.legend()
    return ax


def plot_violations(stats, ax=None):
    """log10 of the four violation maxima vs inner iteration, with outer
    epochs shaded (reference ``recipe_violation``, ``solver_plots.jl:83-120``).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    it = int(np.asarray(stats.iter))
    eps = 1e-20
    xs = np.arange(it)
    for name, series in (("dyn", stats.dyn_vio), ("con", stats.con_vio),
                         ("sta", stats.sta_vio), ("opt", stats.opt_vio)):
        ax.plot(xs, np.log10(np.asarray(series)[:it] + eps), label=name)
    outer = np.asarray(stats.outer)[:it]
    for k in np.unique(outer):
        sel = np.where(outer == k)[0]
        if len(sel) and k % 2 == 0:
            ax.axvspan(sel[0] - 0.5, sel[-1] + 0.5, alpha=0.08, color="gray")
    ax.set_xlabel("inner iteration")
    ax.set_ylabel("log10 violation")
    ax.legend()
    return ax
