"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``):
``print_summary`` (a layer table with parameter counts and output
shapes) and ``plot_network``, which returns Graphviz DOT text as the
reference does, so that no graphviz package is needed (pipe it to ``dot
-Tpng`` to render).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as onp

__all__ = ["print_summary", "plot_network"]


def _symbol_nodes(sym):
    import json
    conf = json.loads(sym.tojson())
    return conf["nodes"], conf.get("heads", [])


def print_summary(symbol, shape: Optional[Dict] = None, line_length=98,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer-by-layer summary of a Symbol (as
    visualization.py print_summary)."""
    nodes, _ = _symbol_nodes(symbol)
    shape_dict = {}
    if shape is not None:
        arg_shapes, out_shapes, _ = symbol.infer_shape(**shape)
        for name, s in zip(symbol.list_arguments(), arg_shapes):
            shape_dict[name] = s
        for name, s in zip(symbol.list_outputs(), out_shapes):
            shape_dict[name] = s
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(vals, pos):
        line = ""
        for v, p in zip(vals, pos):
            line += str(v)
            line = line[:p - 1].ljust(p)
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        inputs = [nodes[e[0]]["name"] for e in node.get("inputs", [])]
        n_params = 0
        param_suffixes = ("weight", "bias", "gamma", "beta", "moving_mean",
                          "moving_var", "running_mean", "running_var")
        for e in node.get("inputs", []):
            pnode = nodes[e[0]]
            if (pnode["op"] == "null" and pnode["name"] in shape_dict
                    and pnode["name"].endswith(param_suffixes)):
                n_params += int(onp.prod(shape_dict[pnode["name"]]))
        total_params += n_params
        out_shape = shape_dict.get(name + "_output", "")
        print_row([f"{name} ({op})", out_shape, n_params,
                   ",".join(inputs[:1])], positions)
        print("_" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 hide_weights=True, save_format="dot"):
    """Build a Graphviz DOT description of the symbol graph (as
    visualization.py plot_network; returns the DOT source string)."""
    nodes, _ = _symbol_nodes(symbol)
    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    palette = {"Convolution": "#fb8072", "FullyConnected": "#fb8072",
               "Activation": "#ffffb3", "BatchNorm": "#bebada",
               "Pooling": "#80b1d3", "Concat": "#fdb462",
               "softmax": "#fccde5"}
    keep = set()
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            if hide_weights and (name.endswith("weight")
                                 or name.endswith("bias")
                                 or name.endswith("gamma")
                                 or name.endswith("beta")):
                continue
            label, color = name, "#8dd3c7"
        else:
            p = node.get("attrs", {}) or {}
            label = f"{op}\\n{name}"
            if op == "Convolution" and "kernel" in p:
                label = f"Convolution\\n{p['kernel']}/{p.get('stride', '1')}"
            color = palette.get(op, "#b3de69")
        keep.add(i)
        lines.append(f'  n{i} [label="{label}", style=filled, '
                     f'fillcolor="{color}", shape=box];')
    for i, node in enumerate(nodes):
        if i not in keep:
            continue
        for e in node.get("inputs", []):
            if e[0] in keep:
                lines.append(f"  n{e[0]} -> n{i};")
    lines.append("}")
    return "\n".join(lines)
