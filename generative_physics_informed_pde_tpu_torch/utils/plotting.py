"""Plotting: 3-D surfaces of nodal fields and trainer diagnostics.

Port of ``generative_physics_informed_pde_tpu/utils/plotting.py``: fields
are nodal vectors on a ``StructuredTriGrid``; the trainer plots read its
monitor (``Trainer._monitor``) and validation analysis.  matplotlib is
imported inside each function, never with the package: a machine without
it runs everything else.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.grid import StructuredTriGrid


def plot_function_2d(grid: StructuredTriGrid, values, ax=None, fig=None,
                     title: Optional[str] = None, cmap: str = "viridis"):
    """3-D trisurf of a nodal field (n_nodes,)."""
    import matplotlib.pyplot as plt

    values = np.asarray(torch.as_tensor(values).detach().cpu()).reshape(-1)
    if values.size != grid.n_nodes:
        raise ValueError(f"{values.size} values for {grid.n_nodes} nodes")
    if ax is None:
        fig = fig or plt.figure()
        ax = fig.add_subplot(projection="3d")
    xy = grid.node_coords
    ax.plot_trisurf(xy[:, 0], xy[:, 1], values,
                    triangles=np.asarray(grid.cells), cmap=cmap,
                    linewidth=0.1)
    if title:
        ax.set_title(title)
    return ax


PlotFunction2D = plot_function_2d


def plot_2d(trainer, indices: Optional[Sequence[int]] = None,
            n_monte_carlo: int = 1024, azim: int = 240, elev: int = 0):
    """Mean prediction against the reference surface for validation
    samples (default 0, 1, 2) -> the figure; the prediction-ensemble
    posterior's samples of sample ``i`` come from a generator seeded
    ``1000 + i`` on the trainer's device."""
    import matplotlib.pyplot as plt

    indices = list(indices) if indices is not None else [0, 1, 2]
    analysis = trainer._analysis
    fom = trainer.physics["fom"]
    Y_val = trainer._data_val["Y"]
    vals = torch.as_tensor(
        trainer.datasets["validation"].get("BCE").constrained_values("fom"),
        device=Y_val.device)

    fig, axes = plt.subplots(len(indices), 2, figsize=(10, 4 * len(indices)),
                             subplot_kw={"projection": "3d"})
    axes = np.atleast_2d(axes)
    for i, ind in enumerate(indices):
        gen = torch.Generator(device=trainer.device).manual_seed(1000 + ind)
        Y_sample = analysis.sample_predictive_y(
            trainer._PE.q, gen, n_monte_carlo, index=ind)
        y_mean = Y_sample.mean(dim=0)
        plot_function_2d(fom.grid, fom.scatter_restricted_solution(
            y_mean, vals[ind]), ax=axes[i, 0])
        plot_function_2d(fom.grid, fom.scatter_restricted_solution(
            Y_val[ind], vals[ind]), ax=axes[i, 1])
        for ax in axes[i]:
            ax.view_init(azim=azim, elev=elev)
        if i == 0:
            axes[i, 0].set_title("Mean Prediction")
            axes[i, 1].set_title("Reference")
    return fig


Plot2D = plot_2d


def plot_elbo(trainer, figsize=(6, 4)):
    """The ELBO at the monitor points."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=figsize)
    plt.plot(trainer._monitor["elbo_iter"], trainer._monitor["elbo"], "-o")
    plt.grid()
    plt.xlabel("Iterations")
    plt.ylabel("ELBO")
    plt.title("ELBO")


def plot_predictive_logscore(trainer, figsize=(6, 4)):
    """The validation analysis's predictive logscore series."""
    import matplotlib.pyplot as plt

    series = trainer._analysis.series["logscore_y"]
    plt.figure(figsize=figsize)
    plt.plot(series.iteration, series.value, "-o")
    plt.grid()
    plt.xlabel("# Iteration")
    plt.ylabel("Logscore")
    plt.title("Predictive Logscore (validation)")
