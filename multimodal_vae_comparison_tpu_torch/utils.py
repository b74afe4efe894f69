"""Shared host-side utilities: the stats writer and directory helpers
(counterpart of ``utils.py``).

A copy of the JAX package's module, which the port does not import: the
stats file and the summary line it prints are byte-identical to the JAX
writer's, so the two packages' results read alike.
"""
from __future__ import annotations

import os
from typing import Dict, List


def listdirs(rootdir: str) -> List[str]:
    """Immediate subdirectories (reference utils.py:304-318)."""
    return [os.path.join(rootdir, d) for d in sorted(os.listdir(rootdir))
            if os.path.isdir(os.path.join(rootdir, d))]


def last_letter(word: str) -> str:
    return word[::-1]


def print_save_stats(stats_dict: Dict[str, Dict], path: str,
                     dataset_name: str, level: int = 1) -> str:
    """Write eval stats to ``<dataset>_stats.txt`` in the reference's exact
    format (utils.py:34-64), return the final LaTeX-ish summary line."""
    print("Final results:")
    final_line = ""
    out_path = os.path.join(path, f"{dataset_name}_stats.txt")
    with open(out_path, "w") as f:
        for key, value_dict in stats_dict.items():
            if value_dict.get("stdev") is not None:
                if "strict" in key.lower() or "letter" in key.lower():
                    final_line += "{:.0f} ({:.0f}) & ".format(
                        round(value_dict["value"], 0),
                        round(value_dict["stdev"], 0))
                else:
                    final_line += "{:.1f}~({:.1f})/{} & ".format(
                        round(value_dict["value"] * level / 100, 2),
                        round(value_dict["stdev"] * level / 100, 1), level)
                stat = "{}: {:.2f} ({:.2f})".format(
                    key, round(value_dict["value"], 2),
                    round(value_dict["stdev"], 2))
            else:
                stat = "{}: {:.2f}".format(key, round(value_dict["value"], 2))
            print(stat)
            f.write(stat + "\n")
    print(f"\n {dataset_name} statistics printed in {out_path} \n")
    if final_line:
        print(final_line)
    return out_path
