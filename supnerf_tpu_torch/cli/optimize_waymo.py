"""Waymo test-time optimization of the port: cli.optimize with the
reference optimize_waymo.py's defaults (the root optimize_waymo.py's):
supnerf.waymo.car.json, --init_rot_err 0.4, --init_trans_err 0.01 and
--dataset waymo, each unless given.

    python -m supnerf_tpu_torch.cli.optimize_waymo [--device cpu]
"""
from __future__ import annotations

import sys

from supnerf_tpu_torch.cli import optimize
from supnerf_tpu_torch.cli.optimize_kitti import with_defaults

DEFAULTS = {"--config_file": "supnerf.waymo.car.json", "--init_rot_err": "0.4",
            "--init_trans_err": "0.01", "--dataset": "waymo"}


def main(argv=None):
    return optimize.main(with_defaults(sys.argv[1:] if argv is None else argv, DEFAULTS))


if __name__ == "__main__":
    main()
