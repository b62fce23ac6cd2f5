"""KITTI test-time optimization of the port: cli.optimize with the
reference optimize_kitti.py's defaults (the root optimize_kitti.py's):
supnerf.kitti.car.json, --init_rot_err 0.4, --init_trans_err 0.01 and
--dataset kitti, each unless given.

    python -m supnerf_tpu_torch.cli.optimize_kitti --add_pose_err 1 [--device cpu]
"""
from __future__ import annotations

import sys

from supnerf_tpu_torch.cli import optimize

DEFAULTS = {"--config_file": "supnerf.kitti.car.json", "--init_rot_err": "0.4",
            "--init_trans_err": "0.01", "--dataset": "kitti"}


def with_defaults(argv, defaults: dict) -> list:
    """argv with each flag of `defaults` appended where argv lacks it."""
    argv = list(argv)
    given = {a.split("=", 1)[0] for a in argv}
    for flag, value in defaults.items():
        if flag not in given:
            argv += [flag, value]
    return argv


def main(argv=None):
    return optimize.main(with_defaults(sys.argv[1:] if argv is None else argv, DEFAULTS))


if __name__ == "__main__":
    main()
