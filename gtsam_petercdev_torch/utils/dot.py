"""Graphviz export of factor graphs (reference: gtsam/inference/DotWriter.h
and nonlinear/GraphvizFormatting.h). Variables are ellipses labeled with
their Symbol; factors are black dots connected to their keys. Port of
gtsam_petercdev_tpu/utils/dot.py (host work over the graph's keys)."""

from __future__ import annotations

from typing import Optional

from gtsam_petercdev_torch.core import keys as keymod


def graph_to_dot(graph, values=None, title: Optional[str] = None) -> str:
    """Render a NonlinearFactorGraph as a graphviz dot string."""
    graph._materialize()
    lines = ["graph {", "  size=\"10,10\";"]
    if title:
        lines.append(f'  label="{title}";')
    seen = set()
    fid = 0
    for batch in graph.batches:
        for row in batch.keys:
            fname = f"factor{fid}"
            fid += 1
            lines.append(f'  {fname}[label="", shape=point];')
            for k in row:
                k = int(k)
                vname = f"var{k}"
                if k not in seen:
                    seen.add(k)
                    lines.append(f'  {vname}[label="{keymod.key_to_str(k)}"];')
                lines.append(f"  {vname}--{fname};")
    lines.append("}")
    return "\n".join(lines)


def write_dot(graph, path: str, values=None, title=None):
    with open(path, "w") as f:
        f.write(graph_to_dot(graph, values, title))
