"""Importance and tree plots (the port of the JAX package's ``plotting.py``;
reference ``python-package/xgboost/plotting.py``): ``plot_importance``,
``to_graphviz`` and ``plot_tree`` over a Booster's (or an estimator's)
``get_score`` and trees. Host code; ``matplotlib`` and ``graphviz`` are
imported when a function needs them, so the package runs without them."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .learner import Booster

__all__ = ["plot_importance", "plot_tree", "to_graphviz"]


def _booster(obj) -> Booster:
    if hasattr(obj, "get_booster"):
        obj = obj.get_booster()
    if not isinstance(obj, Booster):
        raise ValueError("tree must be Booster or XGBModel")
    return obj


def plot_importance(booster, ax: Optional[Any] = None, height: float = 0.2,
                    xlim=None, ylim=None, title: str = "Feature importance",
                    xlabel: str = "Importance score",
                    ylabel: str = "Features", importance_type: str = "weight",
                    max_num_features: Optional[int] = None, grid: bool = True,
                    show_values: bool = True, values_format: str = "{v}",
                    **kwargs: Any):
    """A horizontal bar chart of ``get_score(importance_type)``, smallest
    at the bottom; returns the matplotlib axes."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plot_importance requires matplotlib") from e
    importance = _booster(booster).get_score(importance_type=importance_type)
    if not importance:
        raise ValueError("Booster is empty")
    tuples = sorted(importance.items(), key=lambda x: x[1])
    if max_num_features is not None:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    if show_values:
        for x, y in zip(values, ylocs):
            ax.text(x + 1, y, values_format.format(v=round(x, 2)),
                    va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def to_graphviz(booster, fmap: str = "", num_trees: int = 0,
                rankdir: Optional[str] = None, yes_color: str = "#0000FF",
                no_color: str = "#FF0000",
                condition_node_params: Optional[dict] = None,
                leaf_node_params: Optional[dict] = None, **kwargs: Any):
    """Tree ``num_trees`` as a ``graphviz.Source`` (the JAX package's
    layout: ``f<i><cond`` or ``f<i>:{category}`` boxes, ``leaf=`` ellipses,
    yes / no edges with the missing direction named)."""
    try:
        from graphviz import Source
    except ImportError as e:
        raise ImportError("to_graphviz requires the graphviz package") from e
    tree = _booster(booster)._gbm.model.trees[num_trees]
    cnp = {"shape": "box"} | (condition_node_params or {})
    lnp = {"shape": "ellipse"} | (leaf_node_params or {})

    def attrs(d):
        return " ".join(f'{k}="{v}"' for k, v in d.items())

    lines = ["digraph {"]
    if rankdir:
        lines.append(f"  graph [rankdir={rankdir}]")
    for i in range(tree.num_nodes):
        if tree.left_children[i] == -1:
            lines.append(f'  {i} [label="leaf={tree.split_conditions[i]:.6g}"'
                         f' {attrs(lnp)}]')
            continue
        fname = f"f{tree.split_indices[i]}"
        if tree.split_type is not None and tree.split_type[i] == 1:
            lbl = f"{fname}:{{{int(tree.split_conditions[i])}}}"
        else:
            lbl = f"{fname}<{tree.split_conditions[i]:.6g}"
        lines.append(f'  {i} [label="{lbl}" {attrs(cnp)}]')
        yes, no = tree.left_children[i], tree.right_children[i]
        miss = yes if tree.default_left[i] else no
        ylab = "yes, missing" if miss == yes else "yes"
        nlab = "no, missing" if miss == no else "no"
        lines.append(f'  {i} -> {yes} [label="{ylab}" color="{yes_color}"]')
        lines.append(f'  {i} -> {no} [label="{nlab}" color="{no_color}"]')
    lines.append("}")
    return Source("\n".join(lines))


def plot_tree(booster, fmap: str = "", num_trees: int = 0,
              rankdir: Optional[str] = None, ax: Optional[Any] = None,
              **kwargs: Any):
    """``to_graphviz`` rendered to PNG (needs the Graphviz binaries) and
    shown on matplotlib axes; returns the axes."""
    try:
        import matplotlib.image as mimage
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plot_tree requires matplotlib") from e
    from io import BytesIO

    g = to_graphviz(booster, fmap=fmap, num_trees=num_trees, rankdir=rankdir,
                    **kwargs)
    img = mimage.imread(BytesIO(g.pipe(format="png")))
    if ax is None:
        _, ax = plt.subplots(1, 1)
    ax.imshow(img)
    ax.axis("off")
    return ax
