"""ASCII model summary table (port of
``numpy_quant_tpu/utils/summary.py``, the same text for the same graph):
three columns Node | Inputs | Outputs, one row group per node, extra
input/output names continuing on follow-up lines."""
from __future__ import annotations

from itertools import zip_longest


def summarize(model) -> str:
    groups = []
    for node in model.nodes:
        in_names = [v.name for v in node.inputs if v is not None]
        out_names = [v.name for v in node.outputs]
        lines = list(zip_longest([node.name], in_names, out_names,
                                 fillvalue=""))
        if not in_names and not out_names:
            lines = [(node.name, "", "")]
        groups.append(lines)

    widths = [len(h) for h in ("Node", "Inputs", "Outputs")]
    for lines in groups:
        for cells in lines:
            widths = [max(w, len(c)) for w, c in zip(widths, cells)]

    def fmt(cells) -> str:
        return " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + "\n"

    header_sep = "=+=".join("=" * w for w in widths) + "\n"
    group_sep = "-+-".join("-" * w for w in widths) + "\n"

    text = header_sep + fmt(("Node", "Inputs", "Outputs")) + header_sep
    for lines in groups:
        for cells in lines:
            text += fmt(cells)
        text += group_sep
    return text
