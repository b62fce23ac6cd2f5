"""Re-score every saved TTO result under a tree; the port's counterpart of
evaluate_all.sh: cli.eval_saved_result on each codes+poses.pkl (in sorted
path order), with its folder's cross_eval.pkl where there is one, writing
eval.json beside it.

    python -m supnerf_tpu_torch.cli.evaluate_all [ROOT]     # ROOT default: checkpoints
"""
from __future__ import annotations

import os
import sys

from supnerf_tpu_torch.cli import eval_saved_result


def main(argv=None):
    """Returns {result file: its eval_saved_result summary}."""
    argv = sys.argv[1:] if argv is None else list(argv)
    root = argv[0] if argv else "checkpoints"
    files = sorted(os.path.join(d, "codes+poses.pkl") for d, _, names in os.walk(root)
                   if "codes+poses.pkl" in names)
    done = {}
    for path in files:
        folder = os.path.dirname(path)
        cross = os.path.join(folder, "cross_eval.pkl")
        done[path] = eval_saved_result.main(
            [path, *(["--cross_eval", cross] if os.path.exists(cross) else []),
             "--out", os.path.join(folder, "eval.json")])
    return done


if __name__ == "__main__":
    main()
